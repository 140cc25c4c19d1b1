"""Build a CUDA source of `csrc/` into a shared library at first use.

nvcc compiles the source (plain C interface, no PyTorch headers) for
sm_90a into `panopticnerf_tpu_torch/_build/<name>_<hash>.so`, keyed on a
hash of the source, the headers of `csrc/` and the flags, and ctypes loads
it. A library that is already built is loaded as it is. The compiler's output (`-Xptxas -v`:
registers, shared memory, spills per kernel) is kept beside it in `.log`. A process's first
`load` of a library is the span `kernels.load`, and each source nvcc compiles adds one to the
counter `kernels.built` (utils/profiling.py).

It is also the one seam between the port and its kernels, which the
`ops/*_cuda.py` wrappers share: `load` sets each entry point's argument
types once, when the library is loaded; `check` validates a tensor before
its pointer is passed and `ptr` gives an optional tensor's pointer; `launch`
calls an entry point on PyTorch's current stream, without synchronising,
raises `"<kernel> kernel launch failed: <why>"` when it refuses, and then
adds one to the wrapper's counter `kernels.launch.<id>`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import Optional

import torch

from panopticnerf_tpu_torch.utils.profiling import count, span

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(PKG, "csrc")
BUILD_DIR = os.path.join(PKG, "_build")

# -fmad=false: no multiply-add contraction, so the kernels round like the
# eager PyTorch ops of their plain versions. Never --use_fast_math.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

TMA_ENCODE_FAILED = 9001  # kTmaEncodeFailed (csrc/hopper.cuh): not a CUDA error code

# argument types of the entry points' signatures; every entry point returns an int
P, I, U, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def library_path(name: str) -> str:
    """Where the build of csrc/<name>.cu lives (keyed on the source, every
    header of csrc/ it may include, and the flags)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for fname in [f"{name}.cu", *headers]:
        with open(os.path.join(CSRC, fname), "rb") as f:
            h.update(fname.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"{name}_{h.hexdigest()[:16]}.so")


def _finish(name: str, so: str, tmp: str, cmd: list, proc: subprocess.Popen) -> None:
    try:
        out, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}) for {name}.cu:\n{out}\n{err}")
        with open(so[:-3] + ".log", "w") as f:
            f.write(" ".join(cmd) + "\n" + out + err)
        os.replace(tmp, so)  # atomic: a concurrent loader never sees half a file
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def build_all(names) -> dict:
    """Compile every csrc/<name>.cu whose keyed build is missing, one nvcc
    process per source, all started together. Returns {name: path}."""
    paths = {name: library_path(name) for name in names}
    todo = [name for name, so in paths.items() if not os.path.exists(so)]
    if todo:
        os.makedirs(BUILD_DIR, exist_ok=True)
    running = []
    try:
        for name in todo:
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
            running.append((name, tmp, cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        while running:
            name, tmp, cmd, proc = running.pop(0)
            _finish(name, paths[name], tmp, cmd, proc)
            count("kernels.built")
    finally:
        for _, tmp, _, proc in running:  # after a failure: stop the rest
            proc.kill()
            proc.wait()
            if os.path.exists(tmp):
                os.remove(tmp)
    return paths


def build(name: str) -> str:
    """Compile csrc/<name>.cu unless its keyed build exists; returns the path."""
    return build_all([name])[name]


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """Build (if needed) and load csrc/<name>.cu; one load per process,
    which declares each entry point of `signatures` ({entry: [argument
    types]}, each returning an int)."""
    if name not in _loaded:
        with span("kernels.load"):
            lib = ctypes.CDLL(build(name))
        for entry, args in signatures.items():
            fn = getattr(lib, entry)
            fn.argtypes, fn.restype = args, I
        _loaded[name] = lib
    return _loaded[name]


def check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple,
          device: torch.device) -> None:
    """Raises unless `t` is a contiguous `dtype` tensor of `shape` on `device`."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    """The pointer of an optional tensor (None: a null pointer)."""
    return None if t is None else t.data_ptr()


def launch_failed(kernel: str, err: int) -> RuntimeError:
    """The error of a launch whose entry point returned `err` (nonzero)."""
    why = ("a TMA descriptor could not be encoded" if err == TMA_ENCODE_FAILED
           else f"CUDA error {err}")
    return RuntimeError(f"{kernel} kernel launch failed: {why}")


def launch(fn, dev: torch.device, *args, kernel: str, counter: Optional[str]) -> None:
    """Calls entry point `fn` on `dev` with `args` and PyTorch's current
    stream last; raises `launch_failed(kernel, ...)` on a nonzero return,
    else adds one to `kernels.launch.<counter>` (None: no counter)."""
    with torch.cuda.device(dev):
        err = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise launch_failed(kernel, err)
    if counter is not None:
        count(f"kernels.launch.{counter}")
