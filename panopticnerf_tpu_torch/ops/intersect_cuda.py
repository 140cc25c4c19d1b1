"""Wrapper of the CUDA intersection kernel (`csrc/intersect.cu`).

Replaces the TPU kernel `intersect_rays_pallas` of
`panopticnerf_tpu/ops/pallas_intersect.py`; same contract as
`ops.intersect.intersect_rays_plain`, its plain version. The library is
built with nvcc on first use (`ops/_nvcc.py`) and bound through ctypes; the
kernel launches on PyTorch's current stream and does not synchronise.
`intersect_rays_cuda.launches` counts the launches.
"""

from __future__ import annotations

import ctypes

import torch

from panopticnerf_tpu_torch.ops import _nvcc
from panopticnerf_tpu_torch.ops.intersect import Primitives, RayIntervals

MAX_K = 32
SMEM_LIMIT = 48 * 1024  # bytes of shared memory without an opt-in attribute

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def load() -> ctypes.CDLL:
    """Build (first call only) and load the kernel library."""
    lib = _nvcc.load("intersect")
    fn = lib.intersect_rays_launch
    fn.argtypes = [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F,
                   _P, _P, _P, _P, _P, _P]
    fn.restype = ctypes.c_int
    return lib


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple,
           device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def intersect_rays_cuda(rays_o: torch.Tensor, rays_d: torch.Tensor,
                        prims: Primitives, near: float, far: float,
                        k: int) -> RayIntervals:
    """(N, 3) CUDA rays x one primitive table -> RayIntervals (N, K)."""
    dev = rays_o.device
    if dev.type != "cuda":
        raise ValueError(f"intersect_rays_cuda needs CUDA tensors, got {dev}")
    n = rays_o.shape[0]
    p = prims.world_to_prim.shape[0]
    f = 0 if prims.cut_planes is None else prims.cut_planes.shape[1]
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k={k} outside [1, {MAX_K}]")
    smem = p * (12 + 4 * f) * 4 + 3 * p * 4
    if smem > SMEM_LIMIT:
        raise ValueError(f"primitive table of P={p}, F={f} needs {smem} bytes "
                         f"of shared memory (> {SMEM_LIMIT})")
    _check("rays_o", rays_o, torch.float32, (n, 3), dev)
    _check("rays_d", rays_d, torch.float32, (n, 3), dev)
    _check("world_to_prim", prims.world_to_prim, torch.float32, (p, 3, 4), dev)
    _check("semantic", prims.semantic, torch.int32, (p,), dev)
    _check("instance", prims.instance, torch.int32, (p,), dev)
    _check("valid", prims.valid, torch.bool, (p,), dev)
    if f:
        _check("cut_planes", prims.cut_planes, torch.float32, (p, f, 4), dev)

    t_in = torch.empty((n, k), dtype=torch.float32, device=dev)
    t_out = torch.empty((n, k), dtype=torch.float32, device=dev)
    sem = torch.empty((n, k), dtype=torch.int32, device=dev)
    inst = torch.empty((n, k), dtype=torch.int32, device=dev)
    mask = torch.empty((n, k), dtype=torch.bool, device=dev)
    lib = load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.intersect_rays_launch(
            rays_o.data_ptr(), rays_d.data_ptr(), prims.world_to_prim.data_ptr(),
            prims.semantic.data_ptr(), prims.instance.data_ptr(),
            prims.valid.data_ptr(), prims.cut_planes.data_ptr() if f else None,
            1, n, p, f, k, float(near), float(far),
            t_in.data_ptr(), t_out.data_ptr(), sem.data_ptr(), inst.data_ptr(),
            mask.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"intersect kernel launch failed: CUDA error {err}")
    intersect_rays_cuda.launches += 1
    return RayIntervals(t_in=t_in, t_out=t_out, semantic=sem, instance=inst, mask=mask)


intersect_rays_cuda.launches = 0
