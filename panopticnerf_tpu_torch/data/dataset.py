"""Device-resident dataset container (port of `panopticnerf_tpu/data/dataset.py`).

All views — images, poses, pseudo-labels, depth, padded per-view primitive
tables and evaluation ground truth — live as tensors on one device. The
evaluation path reads whole views from it (`view_rays`, `view_primitives`);
the training step draws ray batches from it (`sample_ray_batch`) and
intersects them (`batch_intervals`): grouped batches (`data.views_per_batch`
G > 0) group by group (kernel A2 on the card), fully mixed batches (G = 0)
ray by ray against each ray's own view table. Views of one pool may mix
perspective and MEI fisheye cameras (`cam_model`), and `concat_datasets`
joins the pools of several sequences. A streamed run keeps the pool on the
host and only a window of it here (`data/stream.py`).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from panopticnerf_tpu_torch.ops.intersect import (
    Primitives,
    RayIntervals,
    intersect_groups,
    intersect_groups_plain,
    intersect_rays_per_ray,
)
from panopticnerf_tpu_torch.ops.rays import (
    FisheyeParams,
    gen_rays_perspective,
    pixel_dirs_fisheye,
)


class DeviceDataset(NamedTuple):
    """All-views tensor pack. V = number of views."""

    images: torch.Tensor        # (V, H, W, 3) uint8
    K: torch.Tensor             # (V, 3, 3) float32 intrinsics
    c2w: torch.Tensor           # (V, 3, 4) float32 camera-to-world
    pseudo: torch.Tensor        # (V, H, W) int32 semantic pseudo-labels (255 = ignore)
    depth: torch.Tensor         # (V, H, W) float32 sparse ray-distance depth (<= 0 invalid)
    prim_w2p: torch.Tensor      # (V, P, 3, 4) float32 per-view primitives
    prim_sem: torch.Tensor      # (V, P) int32
    prim_inst: torch.Tensor     # (V, P) int32
    prim_valid: torch.Tensor    # (V, P) bool
    bounds_center: torch.Tensor  # (3,)
    bounds_scale: torch.Tensor   # ()
    gt_sem: Optional[torch.Tensor] = None     # (V, H, W) int32 eval GT (255 ignore)
    gt_inst: Optional[torch.Tensor] = None    # (V, H, W) int32 eval GT instances
    prim_planes: Optional[torch.Tensor] = None  # (V, P, F, 4) local half-spaces
    cam_model: Optional[torch.Tensor] = None  # (V,) int32: 0 = perspective, 1 = fisheye
    fisheye: Optional[torch.Tensor] = None    # (V, 7) [gamma1 gamma2 u0 v0 xi k1 k2]
    valid_mask: Optional[torch.Tensor] = None  # (V, H, W) bool (the fisheye image circle)


class RayBatch(NamedTuple):
    rays_o: torch.Tensor    # (N, 3)
    rays_d: torch.Tensor    # (N, 3)
    rgb: torch.Tensor       # (N, 3) float32 in [0, 1]
    pseudo: torch.Tensor    # (N,) int32
    depth: torch.Tensor     # (N,) float32
    view: torch.Tensor      # (N,) source view index
    valid: torch.Tensor     # (N,) bool


class BatchDraws(NamedTuple):
    """The random indices of one ray batch (for replaying a reference's
    draws): `group` positions in `view_ids`, (G,) one per group or (N,) one
    per ray in a fully mixed batch; `u` / `v` (N,) pixel column / row."""

    group: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor


def sample_ray_batch(ds: DeviceDataset, view_ids: torch.Tensor, n_rays: int,
                     views_per_batch: int,
                     generator: Optional[torch.Generator] = None,
                     draws: Optional[BatchDraws] = None) -> RayBatch:
    """Draw a ray batch on the dataset's device.

    With G = `views_per_batch` > 0, G views are drawn from the pool
    `view_ids` (T,) (with replacement), and each contributes a contiguous
    group of N / G rays; with G = 0 (fully mixed) every ray draws its own
    view. The pixels are drawn uniformly. The indices come from `generator`
    (a generator on the dataset's device), or from `draws`.
    """
    if views_per_batch > 0 and n_rays % views_per_batch:
        raise ValueError(f"data.n_rays={n_rays} must be divisible by "
                         f"data.views_per_batch={views_per_batch}")
    h, w = ds.images.shape[1:3]
    dev = ds.images.device
    g = views_per_batch
    if draws is None:
        group = torch.randint(0, view_ids.shape[0], (g if g > 0 else n_rays,),
                              generator=generator, device=dev)
        u = torch.randint(0, w, (n_rays,), generator=generator, device=dev)
        v = torch.randint(0, h, (n_rays,), generator=generator, device=dev)
    else:
        group, u, v = (x.to(dev, torch.long) for x in draws)
    vi = view_ids.to(dev, torch.long)[group]
    if g > 0:
        vi = torch.repeat_interleave(vi, n_rays // g)

    rgb = ds.images[vi, v, u].to(torch.float32) / 255.0
    pseudo = ds.pseudo[vi, v, u]
    depth = ds.depth[vi, v, u]
    valid = (ds.valid_mask[vi, v, u] if ds.valid_mask is not None
             else torch.ones(n_rays, dtype=torch.bool, device=dev))

    uv = torch.stack([u, v], dim=-1).to(torch.float32) + 0.5
    c2w = ds.c2w[vi]                                           # (N, 3, 4)
    dirs_cam = _pixel_dirs(ds, vi, uv)
    d = torch.sum(c2w[:, :, :3] * dirs_cam[:, None, :], dim=-1)
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    o = c2w[:, :, 3].contiguous()
    return RayBatch(rays_o=o, rays_d=d, rgb=rgb, pseudo=pseudo, depth=depth,
                    view=vi, valid=valid)


def _pixel_dirs(ds: DeviceDataset, vi: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Per-ray camera-frame directions (N, 3): the pinhole model from
    ds.K[vi], or where ds.cam_model[vi] == 1 the MEI unprojection with the
    ray's own fisheye parameters (both computed, then selected)."""
    K = ds.K[vi]                                               # (N, 3, 3)
    x = (uv[:, 0] - K[:, 0, 2]) / K[:, 0, 0]
    y = (uv[:, 1] - K[:, 1, 2]) / K[:, 1, 1]
    persp = torch.stack([x, y, torch.ones_like(x)], dim=-1)
    if ds.cam_model is None:
        return persp
    fe = pixel_dirs_fisheye(uv, FisheyeParams(*ds.fisheye[vi].unbind(-1)))
    return torch.where((ds.cam_model[vi] == 1)[:, None], fe, persp)


def batch_intervals(ds: DeviceDataset, batch: RayBatch, near: float, far: float,
                    k: int, views_per_batch: int, use_kernel: bool = True) -> RayIntervals:
    """Intersect a batch against each ray's view table -> RayIntervals (N, K).

    Grouped (`views_per_batch` G > 0): G tables gathered once, then
    `intersect_groups` (kernel A2 on CUDA tensors), or with `use_kernel`
    False (`render.use_pallas_intersect false`) its plain version on any
    device. Fully mixed (G = 0): a table gathered per ray, then
    `intersect_rays_per_ray` (plain PyTorch on every device, as in the
    reference; `use_kernel` does not apply).
    """
    if views_per_batch <= 0:
        vi = batch.view
        prims = Primitives(
            world_to_prim=ds.prim_w2p[vi], semantic=ds.prim_sem[vi],
            instance=ds.prim_inst[vi], valid=ds.prim_valid[vi],
            cut_planes=ds.prim_planes[vi] if ds.prim_planes is not None else None,
        )
        return intersect_rays_per_ray(batch.rays_o, batch.rays_d, prims, near, far, k)
    g = views_per_batch
    n = batch.rays_o.shape[0]
    gv = batch.view.reshape(g, n // g)[:, 0]                   # (G,) group views
    gprims = Primitives(
        world_to_prim=ds.prim_w2p[gv], semantic=ds.prim_sem[gv],
        instance=ds.prim_inst[gv], valid=ds.prim_valid[gv],
        cut_planes=ds.prim_planes[gv] if ds.prim_planes is not None else None,
    )
    ro = batch.rays_o.reshape(g, n // g, 3)
    rd = batch.rays_d.reshape(g, n // g, 3)
    fn = intersect_groups if use_kernel else intersect_groups_plain
    iv = fn(ro, rd, gprims, near, far, k)
    return RayIntervals(*[x.reshape(n, *x.shape[2:]) for x in iv])


def view_rays(ds: DeviceDataset, view: int):
    """All rays of one view (either camera model) through pixel centres
    (+0.5), in row-major pixel order."""
    h, w = ds.images.shape[1:3]
    dev = ds.images.device
    vv, uu = torch.meshgrid(torch.arange(h, device=dev), torch.arange(w, device=dev),
                            indexing="ij")
    uv = torch.stack([uu.reshape(-1), vv.reshape(-1)], -1).to(torch.float32) + 0.5
    if ds.cam_model is None:
        return gen_rays_perspective(uv, ds.K[view], ds.c2w[view])
    vi = torch.full((uv.shape[0],), view, dtype=torch.long, device=dev)
    dirs_cam = _pixel_dirs(ds, vi, uv)
    c2w = ds.c2w[view]
    d = dirs_cam @ c2w[:, :3].T
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    o = torch.broadcast_to(c2w[:, 3], d.shape).contiguous()
    return o, d


def view_primitives(ds: DeviceDataset, view: int) -> Primitives:
    return Primitives(
        world_to_prim=ds.prim_w2p[view],
        semantic=ds.prim_sem[view],
        instance=ds.prim_inst[view],
        valid=ds.prim_valid[view],
        cut_planes=ds.prim_planes[view] if ds.prim_planes is not None else None,
    )


def concat_datasets(parts: list[DeviceDataset]) -> DeviceDataset:
    """Concatenate datasets along the view axis (multi-sequence pools,
    `data.sequences`). An optional field that some parts carry is filled
    with neutral values in the others (all-pass cut planes, ignore labels,
    perspective cameras, all-valid masks), so perspective-only and fisheye
    sequences mix. Scene bounds: the envelope of the parts' bounds. All
    parts share (H, W) and the primitive padding P."""
    assert parts
    if len(parts) == 1:
        return parts[0]
    h, w = parts[0].images.shape[1:3]
    p = parts[0].prim_w2p.shape[1]
    for d in parts[1:]:
        if d.images.shape[1:3] != (h, w) or d.prim_w2p.shape[1] != p:
            raise ValueError("all sequences must share image size and max_primitives")
    dev = parts[0].images.device
    n_views = lambda d: d.images.shape[0]
    f = next((d.prim_planes.shape[2] for d in parts if d.prim_planes is not None), 1)
    allpass = torch.tensor([0.0, 0.0, 0.0, 1.0], device=dev)
    defaults = {
        "prim_planes": lambda d: allpass.expand(n_views(d), p, f, 4),
        "gt_sem": lambda d: torch.full((n_views(d), h, w), 255, dtype=torch.int32, device=dev),
        "gt_inst": lambda d: torch.zeros((n_views(d), h, w), dtype=torch.int32, device=dev),
        "cam_model": lambda d: torch.zeros((n_views(d),), dtype=torch.int32, device=dev),
        "fisheye": lambda d: torch.tensor([1.0, 1, 0, 0, 0, 0, 0], device=dev).expand(
            n_views(d), 7),
        "valid_mask": lambda d: torch.ones((n_views(d), h, w), dtype=torch.bool, device=dev),
    }

    def cat(field):
        vals = [getattr(d, field) for d in parts]
        if all(v is None for v in vals):
            return None
        if any(v is None for v in vals):
            if field not in defaults:
                raise ValueError(f"mixed None/non-None for {field}")
            vals = [v if v is not None else defaults[field](d) for v, d in zip(vals, parts)]
        return torch.cat(vals, dim=0)

    centers = torch.stack([d.bounds_center for d in parts])
    center = centers.mean(0)
    radii = torch.stack([1.0 / d.bounds_scale + torch.linalg.vector_norm(d.bounds_center - center)
                         for d in parts])
    fields = {k: cat(k) for k in DeviceDataset._fields if k not in ("bounds_center",
                                                                     "bounds_scale")}
    return DeviceDataset(bounds_center=center, bounds_scale=1.0 / radii.max(), **fields)


def train_test_split(num_views: int, test_every: int) -> tuple[np.ndarray, np.ndarray]:
    """Held-out split: every `test_every`-th view is a test view."""
    ids = np.arange(num_views)
    test = ids[ids % test_every == test_every // 2] if test_every > 0 else ids[:0]
    train = np.setdiff1d(ids, test)
    return train, test
