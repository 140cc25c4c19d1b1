"""Ray / 3D-bounding-primitive interval intersection.

Port of `panopticnerf_tpu/ops/intersect.py`. Every primitive is an affine
map `world_to_prim` (3, 4) taking world points into the primitive's local
frame, where it is the unit cube [-1, 1]^3, optionally refined by F convex
cut planes. A ray keeps its K nearest-entry intervals, each carrying the
primitive's (semantic, instance) ids; misses are t_in = t_out = BIG with
label -1 and mask False.

`intersect_rays` is the entry point. On a CUDA tensor it launches the
hand-written kernel (`ops/intersect_cuda.py`, `csrc/intersect.cu`); on a CPU
tensor it runs `intersect_rays_plain`, the kernel's plain PyTorch version,
written in the kernel's arithmetic order (the kernel is built without FMA
contraction), so that on the card the two agree bit for bit. Any other
device raises.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

BIG = 1e9


class Primitives(NamedTuple):
    """Padded per-view primitive set (all tensors share leading dim P).

    `cut_planes` (optional): F half-spaces n.x <= b per primitive in the
    LOCAL unit-cube frame; all-pass padding is n = 0, b >= 0.
    """

    world_to_prim: torch.Tensor  # (P, 3, 4) float32, world -> unit-cube frame
    semantic: torch.Tensor       # (P,) int32 class id
    instance: torch.Tensor       # (P,) int32 instance id (0 = none/stuff)
    valid: torch.Tensor          # (P,) bool padding mask
    cut_planes: Optional[torch.Tensor] = None  # (P, F, 4) [nx ny nz b]


class RayIntervals(NamedTuple):
    """Per-ray top-K entry-sorted intersection intervals."""

    t_in: torch.Tensor      # (N, K) float32 entry distance (BIG where invalid)
    t_out: torch.Tensor     # (N, K) float32 exit distance (BIG where invalid)
    semantic: torch.Tensor  # (N, K) int32 (-1 where invalid)
    instance: torch.Tensor  # (N, K) int32 (-1 where invalid)
    mask: torch.Tensor      # (N, K) bool


def ray_box_intervals(rays_o, rays_d, prims: Primitives, near: float, far: float):
    """Dense slab test of N rays against P unit-cube primitives.

    Returns (t_in, t_out, hit), each (N, P); t clipped to [near, far];
    misses get t_in = t_out = BIG. The per-axis arithmetic follows the
    kernel: local coordinates as ((x0 r0 + x1 r1) + x2 r2) + t, then
    inv = 1 / d_l, t1 = (-1 - o_l) * inv, t2 = (1 - o_l) * inv.
    """
    n = rays_o.shape[0]
    p = prims.world_to_prim.shape[0]
    A = prims.world_to_prim
    o, d = rays_o, rays_d
    t_lo = torch.full((n, p), -BIG, dtype=torch.float32, device=o.device)
    t_hi = torch.full((n, p), BIG, dtype=torch.float32, device=o.device)
    o_ls, d_ls = [], []
    for i in range(3):
        r0, r1, r2, tr = A[:, i, 0], A[:, i, 1], A[:, i, 2], A[:, i, 3]
        o_l = o[:, 0:1] * r0 + o[:, 1:2] * r1 + o[:, 2:3] * r2 + tr      # (N, P)
        d_l = d[:, 0:1] * r0 + d[:, 1:2] * r1 + d[:, 2:3] * r2
        o_ls.append(o_l)
        d_ls.append(d_l)
        # Axis-parallel rays: divide-safe direction, and a forced miss when
        # the origin lies outside the slab.
        par = d_l.abs() < 1e-9
        safe = torch.where(par, torch.where(d_l >= 0, 1e-9, -1e-9), d_l)
        inv = 1.0 / safe
        t1 = (-1.0 - o_l) * inv
        t2 = (1.0 - o_l) * inv
        par_out = par & (o_l.abs() > 1.0)
        t_lo = torch.maximum(t_lo, torch.where(par_out, BIG, torch.minimum(t1, t2)))
        t_hi = torch.minimum(t_hi, torch.where(par_out, -BIG, torch.maximum(t1, t2)))

    if prims.cut_planes is not None:
        # Convex refinement: along x(s) = o_l + s d_l the plane n.x <= b is
        # a*s <= c with a = n.d_l, c = b - n.o_l. a > 0 caps t_hi, a < 0
        # raises t_lo, a ~ 0 with c < 0 is a hard miss.
        eps = 1e-9
        cp = prims.cut_planes                                    # (P, F, 4)
        n0, n1, n2, b = cp[..., 0], cp[..., 1], cp[..., 2], cp[..., 3]
        dl = [x[..., None] for x in d_ls]                        # (N, P, 1)
        ol = [x[..., None] for x in o_ls]
        a = n0 * dl[0] + n1 * dl[1] + n2 * dl[2]                 # (N, P, F)
        c = b - (n0 * ol[0] + n1 * ol[1] + n2 * ol[2])
        safe_a = torch.where(a.abs() < eps, eps, a)
        t_plane = c / safe_a
        t_lo = torch.maximum(t_lo, torch.where(a < -eps, t_plane, -BIG).amax(-1))
        t_hi = torch.minimum(t_hi, torch.where(a > eps, t_plane, BIG).amin(-1))
        miss = ((a.abs() <= eps) & (c < 0)).any(-1)
        t_hi = torch.where(miss, -BIG, t_hi)

    t_in = torch.clamp(t_lo, min=near)
    t_out = torch.clamp(t_hi, max=far)
    hit = (t_out > t_in) & prims.valid[None, :]
    t_in = torch.where(hit, t_in, BIG)
    t_out = torch.where(hit, t_out, BIG)
    return t_in, t_out, hit


def top_k_intervals(t_in, t_out, hit, prims: Primitives, k: int) -> RayIntervals:
    """Keep the K nearest-entry intervals per ray (entry-sorted).

    A stable sort on t_in keeps the kernel's tie rule: equal entry depths
    keep the lowest primitive index first. With fewer primitives than K
    the tail slots are invalid.
    """
    p = t_in.shape[-1]
    k_eff = min(k, p)
    idx = torch.sort(t_in, dim=-1, stable=True).indices[:, :k_eff]   # (N, k_eff)
    sel_in = torch.gather(t_in, 1, idx)
    sel_out = torch.gather(t_out, 1, idx)
    sel_hit = torch.gather(hit, 1, idx)
    sem = prims.semantic[idx]
    inst = prims.instance[idx]
    if k_eff < k:
        n = t_in.shape[0]
        pad = k - k_eff
        sel_in = torch.cat([sel_in, sel_in.new_full((n, pad), BIG)], 1)
        sel_out = torch.cat([sel_out, sel_out.new_full((n, pad), BIG)], 1)
        sel_hit = torch.cat([sel_hit, sel_hit.new_zeros((n, pad))], 1)
        sem = torch.cat([sem, sem.new_zeros((n, pad))], 1)
        inst = torch.cat([inst, inst.new_zeros((n, pad))], 1)
    return RayIntervals(
        t_in=torch.where(sel_hit, sel_in, BIG),
        t_out=torch.where(sel_hit, sel_out, BIG),
        semantic=torch.where(sel_hit, sem, -1).to(torch.int32),
        instance=torch.where(sel_hit, inst, -1).to(torch.int32),
        mask=sel_hit,
    )


def intersect_rays_plain(rays_o, rays_d, prims: Primitives, near: float,
                         far: float, k: int) -> RayIntervals:
    """Plain PyTorch version of the intersection kernel: dense slab test,
    then the per-ray top-K entry-sorted intervals."""
    t_in, t_out, hit = ray_box_intervals(rays_o, rays_d, prims, near, far)
    return top_k_intervals(t_in, t_out, hit, prims, k)


def intersect_rays(rays_o, rays_d, prims: Primitives, near: float, far: float,
                   k: int) -> RayIntervals:
    """(N, 3) rays x one primitive table -> RayIntervals (N, K).

    CUDA tensors launch the kernel (a failure raises; nothing falls back),
    CPU tensors run the plain version.
    """
    if rays_o.device.type == "cuda":
        from panopticnerf_tpu_torch.ops.intersect_cuda import intersect_rays_cuda

        return intersect_rays_cuda(rays_o, rays_d, prims, near, far, k)
    if rays_o.device.type == "cpu":
        return intersect_rays_plain(rays_o, rays_d, prims, near, far, k)
    raise ValueError(f"intersect_rays: no implementation for device {rays_o.device}")


def samples_in_intervals(z: torch.Tensor, iv: RayIntervals) -> torch.Tensor:
    """z (N, S) sample depths -> bool (N, S, K): sample s of ray n lies in
    kept interval k."""
    z_ = z[..., None]
    return (z_ >= iv.t_in[:, None, :]) & (z_ <= iv.t_out[:, None, :]) & iv.mask[:, None, :]


def labeled_containment(z: torch.Tensor, iv: RayIntervals):
    """Containment against labelled intervals only (semantic >= 0).

    Returns (inside_lab (N, S, K) bool, cnt (N, S) float32 labelled
    primitives per sample).
    """
    inside = samples_in_intervals(z, iv)
    labeled = iv.mask & (iv.semantic >= 0)
    inside_lab = inside & labeled[:, None, :]
    cnt = inside_lab.sum(-1).to(torch.float32)
    return inside_lab, cnt


def fixed_map_from_weights(weights, inside_lab, cnt, iv: RayIntervals,
                           num_classes: int) -> torch.Tensor:
    """Composited fixed-field map (N, C), K-factored: never builds (N, S, C).

    fixed_map[c] = sum_k onehot(sem_k)[c] * sum_s w_s inside_sk / cnt_s.
    """
    inv_cnt = 1.0 / torch.clamp(cnt, min=1.0)
    m = torch.sum((weights * inv_cnt)[..., None] * inside_lab.to(weights.dtype), dim=1)  # (N, K)
    sem = torch.clamp(iv.semantic, 0, num_classes - 1).long()
    labeled = (iv.mask & (iv.semantic >= 0))[..., None]
    onehot = torch.nn.functional.one_hot(sem, num_classes).to(weights.dtype) * labeled
    return torch.sum(m[..., None] * onehot, dim=1)
