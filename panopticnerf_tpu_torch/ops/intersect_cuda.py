"""Wrapper of the CUDA intersection kernel (`csrc/intersect.cu`).

Two wrappers over the one kernel, each replacing a TPU kernel of
`panopticnerf_tpu/ops/pallas_intersect.py`:
- `intersect_rays_cuda` (A1, `intersect_rays_pallas`): one table, G = 1;
  plain version `ops.intersect.intersect_rays_plain`;
- `intersect_groups_cuda` (A2, `intersect_groups_pallas`): G view groups,
  one table each (the kernel reads its group's table by `blockIdx.y`);
  plain version `ops.intersect.intersect_groups_plain`.
`intersect_plan` gives a launch's lanes per ray and grid;
`intersect_plan_bytes` the bytes A1 / A2 must move (their byte bound).
The kernel launches through `ops/_nvcc.py`; counters `kernels.launch.A1`
and `kernels.launch.A2`.
"""

from __future__ import annotations

import torch

from panopticnerf_tpu_torch.ops import _nvcc
from panopticnerf_tpu_torch.ops._nvcc import P, I, F, check
from panopticnerf_tpu_torch.ops.intersect import Primitives, RayIntervals

MAX_K = 32
SMEM_LIMIT = 48 * 1024  # bytes of shared memory without an opt-in attribute
THREADS = 256           # threads per block (csrc/intersect.cu kThreads)
BLOCKS_PER_SM = 4       # blocks of all groups together, per SM, that fill the card

SIGNATURES = {"intersect_rays_launch": [P, P, P, P, P, P, P, I, I, I, I, I, F, F,
                                        P, P, P, P, P, I, I, P]}


def load():
    """Build (first call only) and load the kernel library."""
    return _nvcc.load("intersect", SIGNATURES)


def intersect_plan(g: int, m: int, p: int, k: int, sms: int) -> tuple[int, int]:
    """-> (lanes per ray, blocks along each group's M rays) of a launch on
    a card with `sms` SMs: the fewest lanes (4, 8, 16 or 32) that hold K
    entries and one primitive each up to 32; enough blocks of 256 threads
    that the G groups together put BLOCKS_PER_SM blocks on every SM, and
    never more than the group's rays fill."""
    if not (g >= 1 and m >= 1 and p >= 0 and 1 <= k <= MAX_K and sms >= 1):
        raise ValueError(f"no intersection plan for G={g}, M={m}, P={p}, K={k}, SMs={sms}")
    lanes = 4
    while lanes < max(min(p, MAX_K), k):
        lanes *= 2
    rays = THREADS // lanes
    blocks = min(-(-m // rays), max(1, -(-BLOCKS_PER_SM * sms // g)))
    return lanes, blocks


def intersect_plan_bytes(g: int, m: int, p: int, f: int, k: int) -> int:
    """Bytes of device memory A1 / A2 must move, each input read once and
    each output written once: the rays (f32 origin and direction), each
    group's table (f32 affine map, int32 labels, bool valid, f32 cut
    planes) and the (G, M, K) intervals (f32 t_in / t_out, int32 labels,
    bool mask)."""
    return g * (m * 2 * 3 * 4 + p * (12 * 4 + 4 + 4 + 1 + f * 4 * 4) + m * k * (4 + 4 + 4 + 4 + 1))


_sms: dict[int, int] = {}


def _sm_count(dev: torch.device) -> int:
    i = dev.index if dev.index is not None else torch.cuda.current_device()
    if i not in _sms:
        _sms[i] = torch.cuda.get_device_properties(i).multi_processor_count
    return _sms[i]


def _launch(rays_o: torch.Tensor, rays_d: torch.Tensor, prims: Primitives,
            near: float, far: float, k: int, counter: str) -> RayIntervals:
    """rays (G, M, 3), tables with a leading G -> RayIntervals (G, M, K)."""
    dev = rays_o.device
    if dev.type != "cuda":
        raise ValueError(f"the intersection kernel needs CUDA tensors, got {dev}")
    g, m = rays_o.shape[:2]
    p = prims.world_to_prim.shape[1]
    f = 0 if prims.cut_planes is None else prims.cut_planes.shape[2]
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k={k} outside [1, {MAX_K}]")
    smem = p * (12 + 4 * f) * 4 + 3 * p * 4
    if smem > SMEM_LIMIT:
        raise ValueError(f"primitive table of P={p}, F={f} needs {smem} bytes "
                         f"of shared memory (> {SMEM_LIMIT})")
    check("rays_o", rays_o, torch.float32, (g, m, 3), dev)
    check("rays_d", rays_d, torch.float32, (g, m, 3), dev)
    check("world_to_prim", prims.world_to_prim, torch.float32, (g, p, 3, 4), dev)
    check("semantic", prims.semantic, torch.int32, (g, p), dev)
    check("instance", prims.instance, torch.int32, (g, p), dev)
    check("valid", prims.valid, torch.bool, (g, p), dev)
    if f:
        check("cut_planes", prims.cut_planes, torch.float32, (g, p, f, 4), dev)

    t_in = torch.empty((g, m, k), dtype=torch.float32, device=dev)
    t_out = torch.empty((g, m, k), dtype=torch.float32, device=dev)
    sem = torch.empty((g, m, k), dtype=torch.int32, device=dev)
    inst = torch.empty((g, m, k), dtype=torch.int32, device=dev)
    mask = torch.empty((g, m, k), dtype=torch.bool, device=dev)
    lanes, blocks = intersect_plan(g, m, p, k, _sm_count(dev)) if g and m else (MAX_K, 1)
    _nvcc.launch(
        load().intersect_rays_launch, dev,
        rays_o.data_ptr(), rays_d.data_ptr(), prims.world_to_prim.data_ptr(),
        prims.semantic.data_ptr(), prims.instance.data_ptr(),
        prims.valid.data_ptr(), prims.cut_planes.data_ptr() if f else None,
        g, m, p, f, k, float(near), float(far),
        t_in.data_ptr(), t_out.data_ptr(), sem.data_ptr(), inst.data_ptr(),
        mask.data_ptr(), lanes, blocks, kernel="intersect", counter=counter)
    return RayIntervals(t_in=t_in, t_out=t_out, semantic=sem, instance=inst, mask=mask)


def intersect_rays_cuda(rays_o: torch.Tensor, rays_d: torch.Tensor,
                        prims: Primitives, near: float, far: float,
                        k: int) -> RayIntervals:
    """(N, 3) CUDA rays x one primitive table -> RayIntervals (N, K)
    (kernel A1: replaces `intersect_rays_pallas`)."""
    if rays_o.dim() != 2:
        raise ValueError(f"rays_o must be (N, 3), got {tuple(rays_o.shape)}")
    one = Primitives(*[None if a is None else a[None] for a in prims])
    out = _launch(rays_o[None], rays_d[None], one, near, far, k, "A1")
    return RayIntervals(*[x[0] for x in out])


def intersect_groups_cuda(rays_o: torch.Tensor, rays_d: torch.Tensor,
                          prims: Primitives, near: float, far: float,
                          k: int) -> RayIntervals:
    """(G, M, 3) CUDA rays x G primitive tables (grid.y = G) ->
    RayIntervals (G, M, K) (kernel A2: replaces `intersect_groups_pallas`)."""
    if rays_o.dim() != 3:
        raise ValueError(f"rays_o must be (G, M, 3), got {tuple(rays_o.shape)}")
    return _launch(rays_o, rays_d, prims, near, far, k, "A2")
