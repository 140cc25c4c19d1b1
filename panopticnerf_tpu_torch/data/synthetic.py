"""Procedural synthetic scene (port of `panopticnerf_tpu/data/synthetic.py`).

N coloured boxes in front of a camera arc, one box class each, over a sky
background (+ an optional large flat ground box). Ground truth rgb /
semantic / instance / depth come from an independent numpy raycaster.
Everything is numpy, seeded, and identical to the reference's code until the
arrays move to the device, so the port's arrays equal the reference's bit
for bit.

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


def _raycast(o, d, centers, half, rots, near, far):
    """Independent numpy OBB raycaster: nearest hit per ray.

    Returns (t_hit (N,), box_idx (N,), face_axis (N,)), box_idx -1 on miss.
    """
    n = o.shape[0]
    p = centers.shape[0]
    o_l = np.einsum("pji,npj->npi", rots, o[:, None] - centers[None])  # R^T (o - c)
    d_l = np.einsum("pji,npj->npi", rots, np.broadcast_to(d[:, None], (n, p, 3)))
    safe = np.where(np.abs(d_l) < 1e-9, 1e-9, d_l)
    t1 = (-half[None] - o_l) / safe
    t2 = (half[None] - o_l) / safe
    t_lo = np.minimum(t1, t2)
    t_hi = np.maximum(t1, t2)
    par_out = (np.abs(d_l) < 1e-9) & (np.abs(o_l) > half[None])
    t_lo = np.where(par_out, np.inf, t_lo)
    t_hi = np.where(par_out, -np.inf, t_hi)
    axis_in = np.argmax(t_lo, axis=-1)
    t_in = np.max(t_lo, axis=-1)
    t_out = np.min(t_hi, axis=-1)
    hit = (t_out > np.maximum(t_in, near)) & (t_in < far)
    t_in = np.where(hit, np.maximum(t_in, near), np.inf)
    best = np.argmin(t_in, axis=-1)
    t_best = t_in[np.arange(n), best]
    idx = np.where(np.isfinite(t_best), best, -1)
    face = axis_in[np.arange(n), best]
    return t_best, idx, face


def build_synthetic_arrays(cfg: Config, seed: int = 0) -> dict:
    """The scene as numpy arrays, keyed by DeviceDataset field."""
    dc = cfg.data
    if dc.synthetic_fisheye:
        raise NotImplementedError("synthetic fisheye views are not ported yet")
    if dc.pseudo_clean_neighbors > 0:
        raise NotImplementedError("data.pseudo_clean_neighbors is not ported yet")
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

    n_views = n_frames
    images = np.zeros((n_views, h, w, 3), np.uint8)
    gt_sem = np.full((n_views, h, w), SKY_CLASS, np.int32)
    gt_inst = np.zeros((n_views, h, w), np.int32)
    depth = np.zeros((n_views, h, w), np.float32)
    near, far = 0.1, 40.0
    shade = np.array([1.0, 0.75, 0.55])  # per-face-axis shading factor
    for f in range(n_frames):
        R, t = c2w[f, :, :3], c2w[f, :, 3]
        d = dirs_cam @ R.T
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        o = np.broadcast_to(t, d.shape)
        t_hit, idx, face = _raycast(o, d, centers, half, rots, near, far)
        hit = idx >= 0
        sky = np.stack([
            0.4 + 0.3 * (uv[:, 1] / h), 0.5 + 0.3 * (uv[:, 1] / h), 0.9 * np.ones(h * w)
        ], axis=1)
        col = sky.copy()
        col[hit] = palette[idx[hit]] * shade[face[hit]][:, None]
        images[f] = (col.reshape(h, w, 3).clip(0, 1) * 255).astype(np.uint8)
        gt_sem[f] = np.where(hit, classes[np.clip(idx, 0, None)], SKY_CLASS).reshape(h, w)
        gt_inst[f] = np.where(hit, instances[np.clip(idx, 0, None)], 0).reshape(h, w)
        depth[f] = np.where(hit, t_hit, 0.0).reshape(h, w).astype(np.float32)

    # --- pseudo-labels: GT + noise ---
    pseudo = gt_sem.copy()
    flip = rng.uniform(size=pseudo.shape) < 0.07
    if dc.synthetic_sky_noise > 0:
        flip |= (gt_sem == SKY_CLASS) & (
            rng.uniform(size=pseudo.shape) < dc.synthetic_sky_noise)
    pseudo[flip] = rng.integers(0, num_classes, size=int(flip.sum()))
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
    return {
        "images": images, "K": tile(K), "c2w": c2w, "pseudo": pseudo,
        "depth": depth, "prim_w2p": tile(w2p_pad), "prim_sem": tile(sem_pad),
        "prim_inst": tile(inst_pad), "prim_valid": tile(valid_pad),
        "bounds_center": np.array([0.0, 0.0, 8.0], np.float32),
        "bounds_scale": np.float32(1.0 / 20.0),
        "gt_sem": gt_sem, "gt_inst": gt_inst,
    }


def build_synthetic_dataset(cfg: Config, device: torch.device | str,
                            seed: int = 0) -> DeviceDataset:
    arrays = build_synthetic_arrays(cfg, seed)
    return DeviceDataset(**{
        k: torch.from_numpy(np.array(v, order="C")).to(device)
        for k, v in arrays.items()
    })
