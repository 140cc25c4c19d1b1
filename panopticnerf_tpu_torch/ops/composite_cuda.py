"""Wrapper of the CUDA volume compositing (`csrc/composite.cu`, kernel V).

`composite_cuda(sigma, rgb, z, ...)` composites one tile and level of the
evaluation render in one launch: what `ops.composite.composite`,
`ops.intersect.labeled_containment` and `fixed_map_from_weights` compute
together, every field of a `CompositeOut` (rgb, depth, acc, weights,
sem_logits, sem_fixed, inst_mass), in float32 with only the order of the
sums changed. Inputs: sigma (N, S); rgb (N, S, 3); the learned logits
(N, S, C) or None; z (N, S); the keep-M `delta` (N, S) or None; the ray's
intervals `iv` (N, K) or None, with `num_classes` the fixed map's classes;
all float32 but the intervals' int32 semantic and bool mask, contiguous,
on one CUDA device, with S >= 1, K <= 32 and C <= 128 (`takes`). Anything
else raises; nothing falls back. It launches on PyTorch's current stream
and does not synchronise; each launch adds one to the counter
`kernels.launch.V` (utils/profiling.py).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from panopticnerf_tpu_torch.ops import _nvcc
from panopticnerf_tpu_torch.ops.composite import CompositeOut
from panopticnerf_tpu_torch.ops.field_train_cuda import _ptr
from panopticnerf_tpu_torch.ops.intersect import RayIntervals
from panopticnerf_tpu_torch.ops.mlp_train_cuda import _check, _launch_failed, _stream
from panopticnerf_tpu_torch.utils.profiling import count

MAX_INTERVALS = 32   # a lane each
MAX_CLASSES = 128    # four a lane

_P = ctypes.c_void_p
_I = ctypes.c_int


def load() -> ctypes.CDLL:
    """Build (first call only) and load the kernel library."""
    lib = _nvcc.load("composite")
    lib.composite_launch.argtypes = [_P] * 9 + [_I] * 6 + [_P] * 8
    lib.composite_launch.restype = _I
    return lib


def takes(samples: int, intervals: int, classes: int) -> bool:
    """Whether V takes S samples, K intervals (0: none) and C classes (the
    larger of the learned logits' and the fixed map's; 0: neither)."""
    return samples >= 1 and 0 <= intervals <= MAX_INTERVALS and 0 <= classes <= MAX_CLASSES


def composite_cuda(sigma: torch.Tensor, rgb: torch.Tensor, z: torch.Tensor,
                   sem_logits: Optional[torch.Tensor] = None,
                   delta: Optional[torch.Tensor] = None,
                   iv: Optional[RayIntervals] = None, num_classes: int = 0,
                   white_bkgd: bool = False) -> CompositeOut:
    """Kernel V on one tile and level (see the module docstring)."""
    dev, f32 = sigma.device, torch.float32
    if dev.type != "cuda":
        raise ValueError(f"the compositing kernel needs a CUDA device, got {dev}")
    if sigma.dim() != 2:
        raise ValueError(f"sigma has shape {tuple(sigma.shape)}, expected (N, S)")
    n, s = sigma.shape
    c = 0 if sem_logits is None else sem_logits.shape[-1]
    k = 0 if iv is None else iv.t_in.shape[-1]
    c_fixed = num_classes if iv is not None else 0
    if (s < 1 or not takes(s, k, max(c, c_fixed)) or (sem_logits is not None and c < 1)
            or (iv is not None and (k < 1 or c_fixed < 1))):
        raise ValueError(f"V takes S >= 1, 1 <= K <= {MAX_INTERVALS} and C <= {MAX_CLASSES} "
                         f"(1 <= C with intervals), not S {s}, K {k}, C {c} / {c_fixed}")
    _check("sigma", sigma, f32, (n, s), dev)
    _check("rgb", rgb, f32, (n, s, 3), dev)
    _check("z", z, f32, (n, s), dev)
    if sem_logits is not None:
        _check("sem_logits", sem_logits, f32, (n, s, c), dev)
    if delta is not None:
        _check("delta", delta, f32, (n, s), dev)
    if iv is not None:
        _check("t_in", iv.t_in, f32, (n, k), dev)
        _check("t_out", iv.t_out, f32, (n, k), dev)
        _check("semantic", iv.semantic, torch.int32, (n, k), dev)
        _check("mask", iv.mask, torch.bool, (n, k), dev)
    new = lambda *shape: torch.empty(shape, dtype=f32, device=dev)
    out = CompositeOut(rgb=new(n, 3), depth=new(n), acc=new(n), weights=new(n, s),
                       sem_logits=new(n, c) if c else None,
                       sem_fixed=new(n, c_fixed) if iv is not None else None,
                       inst_mass=new(n, k) if iv is not None else None)
    if n:
        ivp = [None] * 4 if iv is None else [iv.t_in, iv.t_out, iv.semantic, iv.mask]
        with torch.cuda.device(dev):
            err = load().composite_launch(
                sigma.data_ptr(), rgb.data_ptr(), _ptr(sem_logits), z.data_ptr(), _ptr(delta),
                *[_ptr(t) for t in ivp], n, s, c, k, c_fixed, int(white_bkgd),
                *[_ptr(t) for t in out[:4]], _ptr(out.sem_logits), _ptr(out.inst_mass),
                _ptr(out.sem_fixed), _stream(dev))
        if err != 0:
            raise _launch_failed("compositing", err)
        count("kernels.launch.V")
    return out
