"""Wrapper of the CUDA sampling of the evaluation render (`csrc/sample.cu`, kernel Z).

`guided_z_cuda(iv, n_samples, near, far, bg_frac)` is `ops.sampling.guided_z`
without `perturb`: the guided coarse depths of one tile, (N, S) sorted, from
A1's (N, K) intervals. `fine_z_cuda(z, weights, n_importance)` is what the
evaluation render computes from the coarse level without `perturb`:
`sample_pdf` over the coarse midpoints and interior weights, merged with the
coarse depths by `merge_z`, (N, S + n_importance). One launch each, in
float32 with only the order of three sums changed (the cdf of the union
segments, the sum of the weights, the cdf of the pdf; see the kernel's
source). The rows that are the same for every ray without `perturb` are
computed once per device and shape by the plain functions themselves
(`_coarse_rows`, `_fine_positions`). Inputs are float32 but the intervals'
bool mask, contiguous, on one CUDA device, at the shapes `takes_coarse` /
`takes_fine` accept; anything else raises, nothing falls back. It launches
through `ops/_nvcc.py`; counter `kernels.launch.Z`.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from panopticnerf_tpu_torch.ops import _nvcc, sampling
from panopticnerf_tpu_torch.ops._nvcc import F, I, P, check, ptr
from panopticnerf_tpu_torch.ops.intersect import RayIntervals

MAX_INTERVALS = 32  # a lane each
MAX_ROW = 1024      # depths in a merged row
# the plain version's constants as its float32 ops see them
W_PAD = float(np.float32(1e-5))      # sample_pdf's weights + 1e-5
MIN_DENOM = float(np.float32(1e-5))  # sample_pdf's denom rule

SIGNATURES = {"sample_coarse_launch": [P] * 6 + [I] * 4 + [P, P],
              "sample_fine_launch": [P] * 3 + [I] * 3 + [F, F, P, P]}


def load():
    """Build (first call only) and load the kernel library."""
    return _nvcc.load("sample", SIGNATURES)


def takes_coarse(intervals: int, s_in: int, s_bg: int) -> bool:
    """Whether Z takes the guided coarse depths of K intervals, S_in
    in-interval and S_bg background samples (`sampling.guided_split`)."""
    return 1 <= intervals <= MAX_INTERVALS and s_in >= 1 and s_bg >= 0 and s_in + s_bg <= MAX_ROW


def takes_fine(samples: int, n_importance: int) -> bool:
    """Whether Z takes the fine depths of S coarse samples and n_importance fine ones."""
    return samples >= 3 and n_importance >= 1 and samples + n_importance <= MAX_ROW


@functools.lru_cache(maxsize=32)
def _coarse_rows(device: torch.device, s_in: int, s_bg: int, near: float, far: float):
    """guided_z's rows that every ray shares without `perturb`, from its own
    expressions: the fractions (base + jitter) whose product with a ray's
    union length places its samples, the no-hit fallback's depths and the
    background depths."""
    frac = sampling._linspace01(s_in + 1, device)[:-1] + 0.5 / s_in
    z_fallback = sampling.stratified_z(1, s_in, near, far, False, device)[0]
    z_bg = sampling.stratified_z(1, s_bg, near, far, False, device)[0] if s_bg else None
    return frac.contiguous(), z_fallback.contiguous(), z_bg


@functools.lru_cache(maxsize=32)
def _fine_positions(device: torch.device, n_importance: int) -> torch.Tensor:
    """sample_pdf's positions u without `perturb`, from its own expression."""
    return sampling._linspace01(n_importance + 2, device)[1:-1].contiguous()


def _device(t: torch.Tensor) -> torch.device:
    if t.device.type != "cuda":
        raise ValueError(f"the sampling kernel needs a CUDA device, got {t.device}")
    return t.device


def guided_z_cuda(iv: RayIntervals, n_samples: int, near: float, far: float,
                  bg_frac: float = 0.25) -> torch.Tensor:
    """Kernel Z's coarse pass: `sampling.guided_z(iv, n_samples, near, far,
    False, bg_frac)` on one tile (see the module docstring)."""
    if iv.t_in.dim() != 2:
        raise ValueError(f"t_in has shape {tuple(iv.t_in.shape)}, expected (N, K)")
    n, k = iv.t_in.shape
    s_in, s_bg = sampling.guided_split(n_samples, bg_frac)
    if not takes_coarse(k, s_in, s_bg):
        raise ValueError(f"Z takes 1 <= K <= {MAX_INTERVALS}, S_in >= 1 and S <= {MAX_ROW}, "
                         f"not K {k}, S_in {s_in}, S_bg {s_bg}")
    dev = _device(iv.t_in)
    check("t_in", iv.t_in, torch.float32, (n, k), dev)
    check("t_out", iv.t_out, torch.float32, (n, k), dev)
    check("mask", iv.mask, torch.bool, (n, k), dev)
    z = torch.empty((n, n_samples), dtype=torch.float32, device=dev)
    if n:
        frac, z_fallback, z_bg = _coarse_rows(dev, s_in, s_bg, float(near), float(far))
        _nvcc.launch(load().sample_coarse_launch, dev, iv.t_in.data_ptr(),
                     iv.t_out.data_ptr(), iv.mask.data_ptr(), frac.data_ptr(),
                     z_fallback.data_ptr(), ptr(z_bg), n, k, s_in, s_bg, z.data_ptr(),
                     kernel="sampling", counter="Z")
    return z


def fine_z_cuda(z: torch.Tensor, weights: torch.Tensor, n_importance: int) -> torch.Tensor:
    """Kernel Z's fine pass: `merge_z(z, sample_pdf(z_mid, weights[:, 1:-1],
    n_importance, False))` with z_mid the coarse midpoints, on one tile (see
    the module docstring)."""
    if z.dim() != 2:
        raise ValueError(f"z has shape {tuple(z.shape)}, expected (N, S)")
    n, s = z.shape
    if not takes_fine(s, n_importance):
        raise ValueError(f"Z takes S >= 3, n_importance >= 1 and S + n_importance <= "
                         f"{MAX_ROW}, not S {s}, n_importance {n_importance}")
    dev = _device(z)
    check("z", z, torch.float32, (n, s), dev)
    check("weights", weights, torch.float32, (n, s), dev)
    z_all = torch.empty((n, s + n_importance), dtype=torch.float32, device=dev)
    if n:
        u = _fine_positions(dev, n_importance)
        _nvcc.launch(load().sample_fine_launch, dev, z.data_ptr(), weights.data_ptr(),
                     u.data_ptr(), n, s, n_importance, W_PAD, MIN_DENOM, z_all.data_ptr(),
                     kernel="sampling", counter="Z")
    return z_all
