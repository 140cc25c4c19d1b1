"""Batched ray generation for perspective cameras.

Port of `panopticnerf_tpu/ops/rays.py`. Conventions: OpenCV camera (x right,
y down, z forward); `c2w` is (3, 4) camera-to-world; K is (3, 3). The MEI
fisheye model is not ported yet.
"""

from __future__ import annotations

import torch


def pixel_dirs_perspective(uv: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """uv (..., 2) pixel coordinates (u = col, v = row), K (3, 3) ->
    (..., 3) un-normalised camera-frame directions."""
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    x = (uv[..., 0] - cx) / fx
    y = (uv[..., 1] - cy) / fy
    return torch.stack([x, y, torch.ones_like(x)], dim=-1)


def rays_from_dirs(dirs_cam: torch.Tensor, c2w: torch.Tensor):
    """Rotate camera-frame dirs to world and broadcast origins.

    dirs_cam (..., 3); c2w (..., 3, 4) broadcastable against the dirs batch.
    Returns (rays_o, rays_d) in the world frame, rays_d normalised.
    """
    R = c2w[..., :3, :3]
    t = c2w[..., :3, 3]
    d = torch.sum(R * dirs_cam[..., None, :], dim=-1)
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    o = torch.broadcast_to(t, d.shape).contiguous()
    return o, d


def gen_rays_perspective(uv: torch.Tensor, K: torch.Tensor, c2w: torch.Tensor):
    """uv (..., 2), K (3, 3), c2w (..., 3, 4) -> world rays (o, d)."""
    return rays_from_dirs(pixel_dirs_perspective(uv, K), c2w)


def full_image_uv(h: int, w: int, device: torch.device | str) -> torch.Tensor:
    """(H*W, 2) float uv grid in row-major order (matches image flatten)."""
    v, u = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=device),
        torch.arange(w, dtype=torch.float32, device=device),
        indexing="ij",
    )
    return torch.stack([u.reshape(-1), v.reshape(-1)], dim=-1)
