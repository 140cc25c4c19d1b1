"""Device-resident dataset container (port of `panopticnerf_tpu/data/dataset.py`).

All views — images, poses, pseudo-labels, depth, padded per-view primitive
tables and evaluation ground truth — live as tensors on one device. The
evaluation path reads whole views from it (`view_rays`, `view_primitives`);
the train-batch samplers of the reference are not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from panopticnerf_tpu_torch.ops.intersect import Primitives
from panopticnerf_tpu_torch.ops.rays import gen_rays_perspective


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
    fisheye: Optional[torch.Tensor] = None    # (V, 7)
    valid_mask: Optional[torch.Tensor] = None  # (V, H, W) bool


def view_rays(ds: DeviceDataset, view: int):
    """All rays of one perspective view through pixel centres (+0.5), in
    row-major pixel order."""
    if ds.cam_model is not None:
        raise NotImplementedError("fisheye views are not ported yet")
    h, w = ds.images.shape[1:3]
    dev = ds.images.device
    vv, uu = torch.meshgrid(torch.arange(h, device=dev), torch.arange(w, device=dev),
                            indexing="ij")
    uv = torch.stack([uu.reshape(-1), vv.reshape(-1)], -1).to(torch.float32) + 0.5
    return gen_rays_perspective(uv, ds.K[view], ds.c2w[view])


def view_primitives(ds: DeviceDataset, view: int) -> Primitives:
    return Primitives(
        world_to_prim=ds.prim_w2p[view],
        semantic=ds.prim_sem[view],
        instance=ds.prim_inst[view],
        valid=ds.prim_valid[view],
        cut_planes=ds.prim_planes[view] if ds.prim_planes is not None else None,
    )


def train_test_split(num_views: int, test_every: int) -> tuple[np.ndarray, np.ndarray]:
    """Held-out split: every `test_every`-th view is a test view."""
    ids = np.arange(num_views)
    test = ids[ids % test_every == test_every // 2] if test_every > 0 else ids[:0]
    train = np.setdiff1d(ids, test)
    return train, test
