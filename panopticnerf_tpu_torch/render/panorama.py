"""Equirectangular panoramas, the 360-degree label transfer of
PanopticNeRF-360 (port of `panopticnerf_tpu/render/panorama.py`).

Rays of an (H, W) equirect grid from one camera centre: azimuth theta in
[-pi, pi) left to right, elevation phi in [-pi/2, pi/2] top to bottom, in
the OpenCV camera frame (y down). The panorama intersects its H x W world
rays against the view's primitive table (kernel A1 on the card, with the
view's cut planes) and renders them tile by tile, like any full image.
"""

from __future__ import annotations

import math

import torch

from panopticnerf_tpu_torch.config import Config
from panopticnerf_tpu_torch.data.dataset import DeviceDataset, view_primitives
from panopticnerf_tpu_torch.render.renderer import (
    RenderOut,
    SceneBounds,
    intersect_and_render,
)


def panorama_rays(position: torch.Tensor, rotation: torch.Tensor, h: int, w: int):
    """position (3,), rotation (3, 3) camera to world -> (o, d), each
    (H * W, 3) in row-major pixel order."""
    dev = position.device
    v, u = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                          torch.arange(w, dtype=torch.float32, device=dev), indexing="ij")
    theta = ((u.reshape(-1) + 0.5) / w) * (2 * math.pi) - math.pi
    phi = ((v.reshape(-1) + 0.5) / h) * math.pi - math.pi / 2
    # y-down camera frame: up is -y, phi > 0 looks down
    d_cam = torch.stack([torch.cos(phi) * torch.sin(theta), torch.sin(phi),
                         torch.cos(phi) * torch.cos(theta)], dim=-1)
    d = d_cam @ rotation.T
    o = torch.broadcast_to(position, d.shape).contiguous()
    return o, d


def render_panorama(model, ds: DeviceDataset, view: int, hw: tuple[int, int],
                    cfg: Config, world=None) -> RenderOut:
    """An equirect panorama of size `hw` from `view`'s camera centre and
    orientation, against `view`'s primitive table (its tiles over the
    ranks of a distributed `world`)."""
    h, w = hw
    c2w = ds.c2w[view]
    o, d = panorama_rays(c2w[:, 3], c2w[:, :3], h, w)
    prims = view_primitives(ds, view) if cfg.render.use_primitives else None
    return intersect_and_render(cfg, model, o, d, prims,
                                SceneBounds(ds.bounds_center, ds.bounds_scale), world)
