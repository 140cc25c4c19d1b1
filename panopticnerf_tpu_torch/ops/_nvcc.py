"""Build a CUDA source of `csrc/` into a shared library at first use.

nvcc compiles the source (plain C interface, no PyTorch headers) for
sm_90a into `panopticnerf_tpu_torch/_build/<name>_<hash>.so`, keyed on a
hash of the source and the flags, and ctypes loads it. A library that is
already built is loaded as it is. The compiler's output (`-Xptxas -v`:
registers, shared memory, spills per kernel) is kept beside it in `.log`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(PKG, "csrc")
BUILD_DIR = os.path.join(PKG, "_build")

# -fmad=false: no multiply-add contraction, so the kernels round like the
# eager PyTorch ops of their plain versions. Never --use_fast_math.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def library_path(name: str) -> str:
    """Where the build of csrc/<name>.cu lives (keyed on source + flags)."""
    with open(os.path.join(CSRC, f"{name}.cu"), "rb") as f:
        h = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"{name}_{h}.so")


def build(name: str) -> str:
    """Compile csrc/<name>.cu unless its keyed build exists; returns the path."""
    so = library_path(name)
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}) for {name}.cu:\n"
                               f"{res.stdout}\n{res.stderr}")
        with open(so[:-3] + ".log", "w") as f:
            f.write(" ".join(cmd) + "\n" + res.stdout + res.stderr)
        os.replace(tmp, so)  # atomic: a concurrent loader never sees half a file
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return so


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load csrc/<name>.cu; one load per process."""
    if name not in _loaded:
        _loaded[name] = ctypes.CDLL(build(name))
    return _loaded[name]
