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
else raises; nothing falls back. It launches through `ops/_nvcc.py`;
counter `kernels.launch.V`.
"""

from __future__ import annotations

from typing import Optional

import torch

from panopticnerf_tpu_torch.ops import _nvcc
from panopticnerf_tpu_torch.ops._nvcc import P, I, check, ptr
from panopticnerf_tpu_torch.ops.composite import CompositeOut
from panopticnerf_tpu_torch.ops.intersect import RayIntervals

MAX_INTERVALS = 32   # a lane each
MAX_CLASSES = 128    # four a lane

SIGNATURES = {"composite_launch": [P] * 9 + [I] * 6 + [P] * 8}


def load():
    """Build (first call only) and load the kernel library."""
    return _nvcc.load("composite", SIGNATURES)


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
    check("sigma", sigma, f32, (n, s), dev)
    check("rgb", rgb, f32, (n, s, 3), dev)
    check("z", z, f32, (n, s), dev)
    if sem_logits is not None:
        check("sem_logits", sem_logits, f32, (n, s, c), dev)
    if delta is not None:
        check("delta", delta, f32, (n, s), dev)
    if iv is not None:
        check("t_in", iv.t_in, f32, (n, k), dev)
        check("t_out", iv.t_out, f32, (n, k), dev)
        check("semantic", iv.semantic, torch.int32, (n, k), dev)
        check("mask", iv.mask, torch.bool, (n, k), dev)
    new = lambda *shape: torch.empty(shape, dtype=f32, device=dev)
    out = CompositeOut(rgb=new(n, 3), depth=new(n), acc=new(n), weights=new(n, s),
                       sem_logits=new(n, c) if c else None,
                       sem_fixed=new(n, c_fixed) if iv is not None else None,
                       inst_mass=new(n, k) if iv is not None else None)
    if n:
        ivp = [None] * 4 if iv is None else [iv.t_in, iv.t_out, iv.semantic, iv.mask]
        _nvcc.launch(
            load().composite_launch, dev,
            sigma.data_ptr(), rgb.data_ptr(), ptr(sem_logits), z.data_ptr(), ptr(delta),
            *[ptr(t) for t in ivp], n, s, c, k, c_fixed, int(white_bkgd),
            *[ptr(t) for t in out[:4]], ptr(out.sem_logits), ptr(out.inst_mass),
            ptr(out.sem_fixed), kernel="compositing", counter="V")
    return out
