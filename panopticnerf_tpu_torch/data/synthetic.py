"""Procedural synthetic scene (port of `panopticnerf_tpu/data/synthetic.py`).

N coloured boxes in front of a camera arc, one box class each, over a sky
background (+ an optional large flat ground box); with
`data.synthetic_fisheye` every frame adds an MEI fisheye view of the same
pose. Ground truth rgb / semantic / instance / depth come from an
independent raycaster (float64, the reference's arithmetic). Everything
else is numpy, seeded, and
identical to the reference's code until the arrays move to the device, so
the port's arrays equal the reference's bit for bit.

Semantic space: 0 = sky/background, 1..C-1 = box classes.
"""

from __future__ import annotations

import numpy as np
import torch

from panopticnerf_tpu_torch.config import Config
from panopticnerf_tpu_torch.data.dataset import DeviceDataset

SKY_CLASS = 0
IGNORE = 255


def _look_at(eye: np.ndarray, target: np.ndarray) -> np.ndarray:
    """OpenCV-convention c2w (3, 4): z forward, y down."""
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    up_world = np.array([0.0, -1.0, 0.0])
    right = np.cross(fwd, up_world)
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    R = np.stack([right, down, fwd], axis=1)  # columns = camera axes in world
    return np.concatenate([R, eye[:, None]], axis=1).astype(np.float32)


def _raycast(origin, d, centers, half, rots, near, far, device):
    """Independent OBB raycaster (the JAX package's numpy `_raycast`):
    nearest hit of rays d (N, 3) from one origin. Float64 elementwise torch
    ops on `device`, the reference's operations in its order (its einsum's
    three products summed left to right), so the same bits on any device.
    -> numpy (t_hit (N,), box_idx (N,) with -1 on miss, face_axis (N,))."""
    f64 = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float64, device=device)
    R, c, hf, dd = f64(rots), f64(centers), f64(half), f64(d)
    rel = f64(origin)[None] - c                                   # (P, 3)
    o_l = rel[:, 0:1] * R[:, 0] + rel[:, 1:2] * R[:, 1] + rel[:, 2:3] * R[:, 2]
    d_l = (dd[:, None, 0:1] * R[None, :, 0] + dd[:, None, 1:2] * R[None, :, 1]
           + dd[:, None, 2:3] * R[None, :, 2])                    # (N, P, 3)
    small = torch.abs(d_l) < 1e-9
    safe = torch.where(small, torch.full_like(d_l, 1e-9), d_l)
    t1 = (-hf - o_l) / safe
    t2 = (hf - o_l) / safe
    par_out = small & (torch.abs(o_l) > hf)
    t_lo = torch.where(par_out, torch.inf, torch.minimum(t1, t2))
    t_hi = torch.where(par_out, -torch.inf, torch.maximum(t1, t2))
    axis_in = torch.argmax(t_lo, dim=-1)                          # first of ties, as numpy
    t_in = torch.amax(t_lo, dim=-1)
    t_out = torch.amin(t_hi, dim=-1)
    hit = (t_out > torch.clamp(t_in, min=near)) & (t_in < far)
    t_in = torch.where(hit, torch.clamp(t_in, min=near), torch.inf)
    best = torch.argmin(t_in, dim=-1)
    rows = torch.arange(dd.shape[0], device=device)
    t_best = t_in[rows, best]
    idx = torch.where(torch.isfinite(t_best), best, -1)
    return t_best.cpu().numpy(), idx.cpu().numpy(), axis_in[rows, best].cpu().numpy()


def _mei_unproject_np(uv: np.ndarray, fp: np.ndarray, iters: int = 10) -> np.ndarray:
    """Numpy MEI unprojection (the mirror of ops.rays.pixel_dirs_fisheye),
    so that fisheye ground truth does not come from the code under test."""
    g1, g2, u0, v0, xi, k1, k2 = [float(x) for x in fp]
    xd = (uv[:, 0] - u0) / g1
    yd = (uv[:, 1] - v0) / g2
    x, y = xd.copy(), yd.copy()
    for _ in range(iters):
        r2 = x * x + y * y
        s = 1.0 + k1 * r2 + k2 * r2 * r2
        x, y = xd / s, yd / s
    r2 = x * x + y * y
    disc = np.maximum(1.0 + (1.0 - xi * xi) * r2, 0.0)
    factor = (xi + np.sqrt(disc)) / (1.0 + r2)
    X = np.stack([factor * x, factor * y, factor - xi], 1)
    return X / np.linalg.norm(X, axis=1, keepdims=True)


def build_synthetic_arrays(cfg: Config, seed: int = 0) -> dict:
    """The scene as numpy arrays, keyed by DeviceDataset field."""
    dc = cfg.data
    rng = np.random.default_rng(seed)
    h, w = dc.synthetic_image_hw
    n_boxes = dc.synthetic_num_boxes
    n_frames = dc.synthetic_num_frames
    num_classes = cfg.model.num_classes

    # --- boxes ---
    centers = np.stack([
        rng.uniform(-6, 6, n_boxes),
        rng.uniform(-2, 2, n_boxes),
        rng.uniform(6, 16, n_boxes),
    ], axis=1)
    sizes = rng.uniform(1.0, 3.5, (n_boxes, 3))
    angles = rng.uniform(0, 2 * np.pi, n_boxes)
    rots = np.zeros((n_boxes, 3, 3))
    for i, a in enumerate(angles):  # yaw-only rotations
        c, s = np.cos(a), np.sin(a)
        rots[i] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
    classes = 1 + (np.arange(n_boxes) % (num_classes - 1))
    instances = np.arange(1, n_boxes + 1)
    palette = rng.uniform(0.2, 1.0, (n_boxes, 3))
    if dc.synthetic_ground:
        # road-like primitive: huge, thin, flat, 'stuff' (instance 0)
        centers = np.concatenate([centers, [[0.0, 4.0, 10.0]]])
        sizes = np.concatenate([sizes, [[40.0, 0.5, 40.0]]])
        rots = np.concatenate([rots, [np.eye(3)]])
        classes = np.concatenate([classes, [1]])
        instances = np.concatenate([instances, [0]])
        palette = np.concatenate([palette, [[0.35, 0.3, 0.3]]])
        n_boxes = n_boxes + 1

    # --- cameras: arc looking at the scene centre ---
    fx = 0.8 * w
    K = np.array([[fx, 0, w / 2], [0, fx, h / 2], [0, 0, 1]], np.float32)
    target = np.array([0.0, 0.0, 11.0])
    c2ws = []
    for i in range(n_frames):
        ang = (i / max(n_frames - 1, 1) - 0.5) * 0.8
        eye = np.array([np.sin(ang) * 10.0, -1.0 + 0.3 * np.sin(i), -2.0 + np.cos(ang) * 1.5])
        c2ws.append(_look_at(eye, target))
    c2w = np.stack(c2ws)

    # --- render GT (independent raycaster) ---
    half = sizes / 2.0
    vv, uu = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    uv = np.stack([uu.reshape(-1) + 0.5, vv.reshape(-1) + 0.5], axis=1)
    x = (uv[:, 0] - K[0, 2]) / K[0, 0]
    y = (uv[:, 1] - K[1, 2]) / K[1, 1]
    dirs_cam = np.stack([x, y, np.ones_like(x)], axis=1)

    # every frame gets a perspective view and, with synthetic_fisheye, an
    # MEI fisheye view of the same pose
    fp = np.array([0.9 * w, 0.9 * h, w / 2, h / 2, 2.0, 0.01, -0.002], np.float32)
    view_frames, view_models = [], []
    for f in range(n_frames):
        view_frames.append(f)
        view_models.append(0)
        if dc.synthetic_fisheye:
            view_frames.append(f)
            view_models.append(1)
    n_views = len(view_frames)

    fe_dirs = _mei_unproject_np(uv, fp) if dc.synthetic_fisheye else None
    if dc.synthetic_fisheye:
        # the in-FOV mask from the unprojection's discriminant
        xd = (uv[:, 0] - fp[2]) / fp[0]
        yd = (uv[:, 1] - fp[3]) / fp[1]
        x_u, y_u = xd.copy(), yd.copy()
        for _ in range(10):
            rr = x_u * x_u + y_u * y_u
            s_ = 1.0 + fp[5] * rr + fp[6] * rr * rr
            x_u, y_u = xd / s_, yd / s_
        fe_valid = (1.0 + (1.0 - fp[4] ** 2) * (x_u ** 2 + y_u ** 2)) > 1e-4
    images = np.zeros((n_views, h, w, 3), np.uint8)
    gt_sem = np.full((n_views, h, w), SKY_CLASS, np.int32)
    gt_inst = np.zeros((n_views, h, w), np.int32)
    depth = np.zeros((n_views, h, w), np.float32)
    valid_masks = np.ones((n_views, h, w), bool)
    near, far = 0.1, 40.0
    shade = np.array([1.0, 0.75, 0.55])  # per-face-axis shading factor
    for vi_, (f, cam_m) in enumerate(zip(view_frames, view_models)):
        R, t = c2w[f, :, :3], c2w[f, :, 3]
        d = (dirs_cam if cam_m == 0 else fe_dirs) @ R.T
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        t_hit, idx, face = _raycast(t, d, centers, half, rots, near, far, "cpu")
        hit = idx >= 0
        sky = np.stack([
            0.4 + 0.3 * (uv[:, 1] / h), 0.5 + 0.3 * (uv[:, 1] / h), 0.9 * np.ones(h * w)
        ], axis=1)
        col = sky.copy()
        col[hit] = palette[idx[hit]] * shade[face[hit]][:, None]
        images[vi_] = (col.reshape(h, w, 3).clip(0, 1) * 255).astype(np.uint8)
        gt_sem[vi_] = np.where(hit, classes[np.clip(idx, 0, None)], SKY_CLASS).reshape(h, w)
        gt_inst[vi_] = np.where(hit, instances[np.clip(idx, 0, None)], 0).reshape(h, w)
        depth[vi_] = np.where(hit, t_hit, 0.0).reshape(h, w).astype(np.float32)
        if cam_m == 1:
            valid_masks[vi_] = fe_valid.reshape(h, w)
            gt_sem[vi_][~valid_masks[vi_]] = IGNORE
            depth[vi_][~valid_masks[vi_]] = 0.0

    # --- pseudo-labels: GT + noise ---
    pseudo = gt_sem.copy()
    flip = rng.uniform(size=pseudo.shape) < 0.07
    if dc.synthetic_sky_noise > 0:
        flip |= (gt_sem == SKY_CLASS) & (
            rng.uniform(size=pseudo.shape) < dc.synthetic_sky_noise)
    pseudo[flip] = rng.integers(0, num_classes, size=int(flip.sum()))
    pseudo[~valid_masks] = IGNORE
    if dc.pseudo_clean_neighbors > 0:
        from panopticnerf_tpu_torch.data.pseudo import majority_clean

        pseudo = np.stack([majority_clean(p, dc.pseudo_clean_neighbors) for p in pseudo])
    # sparse depth: keep ~25% of pixels
    keep = rng.uniform(size=depth.shape) < 0.25
    depth = np.where(keep, depth, 0.0)

    # --- primitives (world -> unit-cube affines) ---
    inv_half = 1.0 / half
    lin = inv_half[:, :, None] * np.swapaxes(rots, 1, 2)
    trans = -np.einsum("pij,pj->pi", lin, centers)
    w2p = np.concatenate([lin, trans[:, :, None]], axis=2).astype(np.float32)
    P = dc.max_primitives
    pad = max(P - n_boxes, 0)
    w2p_pad = np.concatenate([w2p, np.zeros((pad, 3, 4), np.float32)])[:P]
    sem_pad = np.concatenate([classes, np.zeros(pad, np.int64)])[:P].astype(np.int32)
    inst_pad = np.concatenate([instances, np.zeros(pad, np.int64)])[:P].astype(np.int32)
    valid_pad = np.concatenate([np.ones(n_boxes, bool), np.zeros(pad, bool)])[:P]

    tile = lambda a: np.broadcast_to(a[None], (n_views,) + a.shape).copy()
    arrays = {
        "images": images, "K": tile(K), "c2w": c2w[np.asarray(view_frames)], "pseudo": pseudo,
        "depth": depth, "prim_w2p": tile(w2p_pad), "prim_sem": tile(sem_pad),
        "prim_inst": tile(inst_pad), "prim_valid": tile(valid_pad),
        "bounds_center": np.array([0.0, 0.0, 8.0], np.float32),
        "bounds_scale": np.float32(1.0 / 20.0),
        "gt_sem": gt_sem, "gt_inst": gt_inst,
    }
    if dc.synthetic_fisheye:
        arrays.update(cam_model=np.asarray(view_models, np.int32),
                      fisheye=np.broadcast_to(fp[None], (n_views, 7)).copy(),
                      valid_mask=valid_masks)
    return arrays


def build_synthetic_dataset(cfg: Config, device: torch.device | str,
                            seed: int = 0) -> DeviceDataset:
    arrays = build_synthetic_arrays(cfg, seed)
    return DeviceDataset(**{
        k: torch.from_numpy(np.array(v, order="C")).to(device)
        for k, v in arrays.items()
    })
