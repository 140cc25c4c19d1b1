"""Batched ray generation for perspective and fisheye cameras.

Port of `panopticnerf_tpu/ops/rays.py`. Conventions: OpenCV camera (x right,
y down, z forward); `c2w` is (3, 4) camera-to-world; K is (3, 3).
KITTI-360's fisheye cameras (image_02/03) follow the MEI unified model
(mirror parameter xi, radial distortion k1, k2): unprojection undistorts
by a fixed number of fixed-point iterations, then solves for the point on
the unit sphere in closed form.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class FisheyeParams(NamedTuple):
    """MEI unified camera model parameters (KITTI-360 fisheye yaml)."""

    gamma1: torch.Tensor  # focal-like x
    gamma2: torch.Tensor  # focal-like y
    u0: torch.Tensor
    v0: torch.Tensor
    xi: torch.Tensor      # mirror parameter
    k1: torch.Tensor      # radial distortion
    k2: torch.Tensor


def pixel_dirs_perspective(uv: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """uv (..., 2) pixel coordinates (u = col, v = row), K (3, 3) ->
    (..., 3) un-normalised camera-frame directions."""
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    x = (uv[..., 0] - cx) / fx
    y = (uv[..., 1] - cy) / fy
    return torch.stack([x, y, torch.ones_like(x)], dim=-1)


def _undistort_fisheye(xd: torch.Tensor, yd: torch.Tensor, p: FisheyeParams, iters: int = 8):
    """Invert x_d = x (1 + k1 r^2 + k2 r^4) by `iters` fixed-point steps."""
    x, y = xd, yd
    for _ in range(iters):
        r2 = x * x + y * y
        scale = 1.0 + p.k1 * r2 + p.k2 * r2 * r2
        x, y = xd / scale, yd / scale
    return x, y


def pixel_dirs_fisheye(uv: torch.Tensor, p: FisheyeParams, iters: int = 8) -> torch.Tensor:
    """Unproject MEI fisheye pixels uv (..., 2) to (..., 3) unit
    camera-frame directions: normalise, undistort, then the sphere point
    X_z = (xi + sqrt(1 + (1 - xi^2) r^2)) / (1 + r^2) - xi (the
    discriminant clamped at 0 outside the field of view)."""
    xd = (uv[..., 0] - p.u0) / p.gamma1
    yd = (uv[..., 1] - p.v0) / p.gamma2
    x, y = _undistort_fisheye(xd, yd, p, iters)
    r2 = x * x + y * y
    xi = p.xi
    disc = torch.clamp(1.0 + (1.0 - xi * xi) * r2, min=0.0)
    factor = (xi + torch.sqrt(disc)) / (1.0 + r2)
    X = torch.stack([factor * x, factor * y, factor - xi], dim=-1)
    return X / torch.linalg.vector_norm(X, dim=-1, keepdim=True)


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


def gen_rays_fisheye(uv: torch.Tensor, p: FisheyeParams, c2w: torch.Tensor):
    return rays_from_dirs(pixel_dirs_fisheye(uv, p), c2w)


def full_image_uv(h: int, w: int, device: torch.device | str) -> torch.Tensor:
    """(H*W, 2) float uv grid in row-major order (matches image flatten)."""
    v, u = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=device),
        torch.arange(w, dtype=torch.float32, device=device),
        indexing="ij",
    )
    return torch.stack([u.reshape(-1), v.reshape(-1)], dim=-1)
