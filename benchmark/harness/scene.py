"""The cells' scenes, made from the seed: the procedural synthetic scene is
the program's own generator (`data.dataset synthetic`, seeded by
train.seed); a KITTI-360 scene is a tree on disk that this module writes
and the program's loader reads.

`write_demo_tree` is a frozen copy of the program's demo-tree writer
(perspective cameras only): boxes and concave L-buildings raycast in
float64 into left and right images, PSPNet-style pseudo-labels with label
noise, sparse plane-z SGM depth, the ground-truth label images, the 3D
boxes' XML, poses and calibration. Its PNGs are compressed at zlib level 1
(the program's reader takes any level), which keeps the write short.
"""

from __future__ import annotations

import os
import struct
import xml.etree.ElementTree as ET
import zlib

import numpy as np
import torch

SEQ = "2013_05_28_drive_0000_sync"
_BOX_CLASSES = [("car", 26), ("building", 11), ("vegetation", 21)]
_GROUND = ("road", 7)
_SKY_ID = 23
_NOISE_IDS = np.array([7, 8, 11, 21, 23, 26])


def write_png(path: str, arr: np.ndarray) -> None:
    """8-bit RGB (H, W, 3), 8-bit grey (H, W) or 16-bit grey (H, W) PNG,
    rows unfiltered."""
    depth, colour = {(np.dtype(np.uint8), 3): (8, 2), (np.dtype(np.uint8), 2): (8, 0),
                     (np.dtype(np.uint16), 2): (16, 0)}[(arr.dtype, arr.ndim)]
    h, w = arr.shape[:2]
    rows = np.ascontiguousarray(arr.astype(arr.dtype.newbyteorder(">"))).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows.view(np.uint8)], axis=1)

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, colour,
                                                                 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw.tobytes(), 1)) + chunk(b"IEND", b""))


def _raycast(origin, d, centers, half, rots, near, far, device):
    """Nearest hit of rays d (N, 3) from one origin against oriented boxes,
    in float64 -> numpy (t_hit, box index or -1, the entry face's axis)."""
    f64 = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float64, device=device)
    R, c, hf, dd = f64(rots), f64(centers), f64(half), f64(d)
    rel = f64(origin)[None] - c
    o_l = rel[:, 0:1] * R[:, 0] + rel[:, 1:2] * R[:, 1] + rel[:, 2:3] * R[:, 2]
    d_l = (dd[:, None, 0:1] * R[None, :, 0] + dd[:, None, 1:2] * R[None, :, 1]
           + dd[:, None, 2:3] * R[None, :, 2])
    small = torch.abs(d_l) < 1e-9
    safe = torch.where(small, torch.full_like(d_l, 1e-9), d_l)
    t1, t2 = (-hf - o_l) / safe, (hf - o_l) / safe
    par_out = small & (torch.abs(o_l) > hf)
    t_lo = torch.where(par_out, torch.inf, torch.minimum(t1, t2))
    t_hi = torch.where(par_out, -torch.inf, torch.maximum(t1, t2))
    axis_in = torch.argmax(t_lo, dim=-1)
    t_in, t_out = torch.amax(t_lo, dim=-1), torch.amin(t_hi, dim=-1)
    hit = (t_out > torch.clamp(t_in, min=near)) & (t_in < far)
    t_in = torch.where(hit, torch.clamp(t_in, min=near), torch.inf)
    best = torch.argmin(t_in, dim=-1)
    rows = torch.arange(dd.shape[0], device=device)
    t_best = t_in[rows, best]
    idx = torch.where(torch.isfinite(t_best), best, -1)
    return t_best.cpu().numpy(), idx.cpu().numpy(), axis_in[rows, best].cpu().numpy()


def _mat_xml(parent, name, arr):
    node = ET.SubElement(parent, name)
    ET.SubElement(node, "rows").text = str(arr.shape[0])
    ET.SubElement(node, "cols").text = str(arr.shape[1])
    ET.SubElement(node, "dt").text = "d"
    ET.SubElement(node, "data").text = " ".join(f"{v:.8f}" for v in arr.reshape(-1))


def _scene(n_boxes: int, rng: np.random.Generator):
    """Box soup in front of the camera path + a road-plane ground box."""
    centers = np.stack([rng.uniform(-5.0, 5.0, n_boxes), rng.uniform(-1.5, 1.0, n_boxes),
                        rng.uniform(7.0, 16.0, n_boxes)], axis=1)
    sizes = rng.uniform(1.2, 3.5, (n_boxes, 3))
    angles = rng.uniform(0, 2 * np.pi, n_boxes)
    rots = np.zeros((n_boxes, 3, 3))
    for i, a in enumerate(angles):
        c, s = np.cos(a), np.sin(a)
        rots[i] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
    labels = [_BOX_CLASSES[i % len(_BOX_CLASSES)] for i in range(n_boxes)]
    centers = np.concatenate([centers, [[0.0, 3.0, 12.0]]])
    sizes = np.concatenate([sizes, [[60.0, 0.4, 60.0]]])
    rots = np.concatenate([rots, [np.eye(3)]])
    labels.append(_GROUND)
    palette = rng.uniform(0.25, 1.0, (n_boxes + 1, 3))
    palette[-1] = [0.35, 0.33, 0.33]
    return centers, sizes, rots, labels, palette


def _l_prism(i: int, rng: np.random.Generator):
    """One L-shaped building (a concave 6-gon in x-z, extruded in y) and the
    two boxes that tile it."""
    sign = 1.0 if i % 2 == 0 else -1.0
    x0 = 2.3 + rng.uniform(0.0, 0.6)
    z0 = 9.0 + 2.2 * (i // 2) + rng.uniform(0.0, 0.8)
    wx = 1.4 + rng.uniform(0.0, 0.5)
    dz = 3.4 + rng.uniform(0.0, 0.8)
    lx = 2.0 + rng.uniform(0.0, 0.6)
    wz = 1.4 + rng.uniform(0.0, 0.4)
    y_top, y_bot = -1.5, 2.9
    ring = np.array([[x0, z0], [x0 + wx + lx, z0], [x0 + wx + lx, z0 + wz],
                     [x0 + wx, z0 + wz], [x0 + wx, z0 + dz], [x0, z0 + dz]])
    ring[:, 0] *= sign
    centers = np.array([[sign * (x0 + wx / 2), (y_top + y_bot) / 2, z0 + dz / 2],
                        [sign * (x0 + wx + lx / 2), (y_top + y_bot) / 2, z0 + wz / 2]])
    sizes = np.array([[wx, y_bot - y_top, dz], [lx, y_bot - y_top, wz]])
    return ring, (y_top, y_bot), centers, sizes


def write_demo_tree(root: str, n_frames: int, hw, n_boxes: int, seed: int, n_concave: int,
                    frame_start: int, label_noise: float = 0.05, depth_keep: float = 0.6,
                    baseline: float = 0.5, device="cuda") -> str:
    """Write a KITTI-360-layout tree of `n_frames` stereo frames under `root`."""
    h, w = hw
    rng = np.random.default_rng(seed)
    centers, sizes, rots, labels, palette = _scene(n_boxes, rng)
    ann_of_box = list(range(len(labels)))
    ann_labels = list(labels)
    ann_geom: list[tuple] = [("cuboid", i) for i in range(len(labels))]
    for b in range(n_concave):
        ring, (y_top, y_bot), bc, bs = _l_prism(b, rng)
        ann_id = len(ann_labels)
        ann_labels.append(("building", 11))
        ann_geom.append(("lprism", ring, y_top, y_bot))
        ann_of_box += [ann_id, ann_id]
        centers = np.concatenate([centers, bc])
        sizes = np.concatenate([sizes, bs])
        rots = np.concatenate([rots, [np.eye(3), np.eye(3)]])
        color = rng.uniform(0.25, 1.0, 3)
        palette = np.concatenate([palette, [color, color]])
    ann_of_box = np.asarray(ann_of_box)
    half = sizes / 2.0
    raw_ids = np.array([i for _, i in ann_labels])
    inst_local = np.zeros(len(ann_labels), np.int64)
    seen: dict[int, int] = {}
    for i, rid in enumerate(raw_ids):
        if rid in (26, 11):
            seen[rid] = seen.get(rid, 0) + 1
            inst_local[i] = seen[rid]
    box_raw, box_inst = raw_ids[ann_of_box], inst_local[ann_of_box]

    fx = 0.8 * w
    K = np.array([[fx, 0, w / 2], [0, fx, h / 2], [0, 0, 1]])
    os.makedirs(f"{root}/calibration", exist_ok=True)
    with open(f"{root}/calibration/perspective.txt", "w") as f:
        f.write(f"P_rect_00: {fx} 0 {w/2} 0 0 {fx} {h/2} 0 0 0 1 0\n"
                "R_rect_00: 1 0 0 0 1 0 0 0 1\n")
        f.write(f"P_rect_01: {fx} 0 {w/2} {-fx*baseline} 0 {fx} {h/2} 0 0 0 1 0\n"
                "R_rect_01: 1 0 0 0 1 0 0 0 1\n")
        f.write(f"S_rect_00: {w} {h}\n")
    with open(f"{root}/calibration/calib_cam_to_pose.txt", "w") as f:
        f.write("image_00: 1 0 0 0 0 1 0 0 0 0 1 0\n")

    os.makedirs(f"{root}/data_poses/{SEQ}", exist_ok=True)
    c2ws = []
    with open(f"{root}/data_poses/{SEQ}/cam0_to_world.txt", "w") as f, \
            open(f"{root}/data_poses/{SEQ}/poses.txt", "w") as g:
        for i in range(n_frames):
            c2w = np.eye(4)
            c2w[0, 3] = (i - (n_frames - 1) / 2) * 0.45
            c2w[1, 3] = -0.3
            c2ws.append(c2w)
            fn = frame_start + i
            f.write(f"{fn} " + " ".join(f"{v:.6f}" for v in c2w.reshape(-1)) + "\n")
            g.write(f"{fn} " + " ".join(f"{v:.6f}" for v in c2w[:3].reshape(-1)) + "\n")

    os.makedirs(f"{root}/data_3d_bboxes/train", exist_ok=True)
    rootel = ET.Element("opencv_storage")
    cube = np.array([[x, y, z] for x in (-0.5, 0.5) for y in (-0.5, 0.5) for z in (-0.5, 0.5)])
    for i, ((label, rid), geom) in enumerate(zip(ann_labels, ann_geom)):
        obj = ET.SubElement(rootel, f"object_{i}")
        T = np.eye(4)
        if geom[0] == "cuboid":
            j = geom[1]
            T[:3, :3] = rots[j] @ np.diag(sizes[j])
            T[:3, 3] = centers[j]
            verts = cube
        else:
            _, ring, y_top, y_bot = geom
            verts = np.array([[x, y, z] for y in (y_top, y_bot) for x, z in ring])
        _mat_xml(obj, "transform", T)
        _mat_xml(obj, "vertices", verts)
        _mat_xml(obj, "faces", np.zeros((6, 4)))
        ET.SubElement(obj, "label").text = label
        ET.SubElement(obj, "semanticId").text = str(rid)
        ET.SubElement(obj, "instanceId").text = str(int(inst_local[i]))
        ET.SubElement(obj, "index").text = str(i)
        ET.SubElement(obj, "start_frame").text = str(frame_start)
        ET.SubElement(obj, "end_frame").text = str(frame_start + n_frames - 1)
        ET.SubElement(obj, "timestamp").text = "-1"
        ET.SubElement(obj, "dynamic").text = "0"
    ET.ElementTree(rootel).write(f"{root}/data_3d_bboxes/train/{SEQ}.xml")

    os.makedirs(f"{root}/visible_id/{SEQ}", exist_ok=True)
    for i in range(n_frames):
        with open(f"{root}/visible_id/{SEQ}/{frame_start + i:010d}.txt", "w") as f:
            f.write("\n".join(str(j) for j in range(len(ann_labels))) + "\n")

    vv, uu = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    uv = np.stack([uu.reshape(-1) + 0.5, vv.reshape(-1) + 0.5], axis=1)
    dirs_cam = np.stack([(uv[:, 0] - K[0, 2]) / K[0, 0], (uv[:, 1] - K[1, 2]) / K[1, 1],
                         np.ones(h * w)], axis=1)
    inv_norm = 1.0 / np.linalg.norm(dirs_cam, axis=1)
    shade = np.array([1.0, 0.75, 0.55])
    for cam in ("image_00", "image_01"):
        os.makedirs(f"{root}/data_2d_raw/{SEQ}/{cam}/data_rect", exist_ok=True)
        os.makedirs(f"{root}/pspnet/{SEQ}/{cam}", exist_ok=True)
    os.makedirs(f"{root}/sgm/{SEQ}/image_00", exist_ok=True)
    d1 = f"{root}/data_2d_semantics/train/{SEQ}/image_00/semantic"
    d2 = f"{root}/data_2d_semantics/train/{SEQ}/image_00/instance"
    os.makedirs(d1, exist_ok=True)
    os.makedirs(d2, exist_ok=True)
    sky = np.stack([0.45 + 0.25 * (uv[:, 1] / h), 0.55 + 0.25 * (uv[:, 1] / h),
                    0.9 * np.ones(h * w)], axis=1)
    for fr in range(n_frames):
        fn = frame_start + fr
        for cam_idx, cam in enumerate(("image_00", "image_01")):
            c2w = c2ws[fr].copy()
            if cam_idx == 1:
                c2w[:3, 3] = c2w[:3, 3] + c2w[:3, 0] * baseline
            R, t = c2w[:3, :3], c2w[:3, 3]
            d = dirs_cam @ R.T
            d /= np.linalg.norm(d, axis=1, keepdims=True)
            t_hit, idx, face = _raycast(t, d, centers, half, rots, 0.1, 60.0, device)
            hit = idx >= 0
            col = sky.copy()
            col[hit] = palette[idx[hit]] * shade[face[hit]][:, None]
            img = (col.reshape(h, w, 3).clip(0, 1) * 255).astype(np.uint8)
            write_png(f"{root}/data_2d_raw/{SEQ}/{cam}/data_rect/{fn:010d}.png", img)
            sem_raw = np.where(hit, box_raw[np.clip(idx, 0, None)], _SKY_ID)
            pseudo = sem_raw.copy()
            flip = rng.uniform(size=pseudo.shape) < label_noise
            pseudo[flip] = rng.choice(_NOISE_IDS, size=int(flip.sum()))
            np.save(f"{root}/pspnet/{SEQ}/{cam}/{fn:010d}.npy", pseudo.reshape(h, w).astype(np.int32))
            if cam_idx == 0:
                z = np.where(hit, t_hit * inv_norm, 0.0)
                keep = rng.uniform(size=z.shape) < depth_keep
                np.save(f"{root}/sgm/{SEQ}/image_00/{fn:010d}.npy",
                        np.where(keep, z, 0.0).reshape(h, w).astype(np.float32))
                write_png(f"{d1}/{fn:010d}.png", sem_raw.reshape(h, w).astype(np.uint8))
                inst_map = sem_raw.astype(np.int64) * 1000
                inst_map[hit] += box_inst[idx[hit]]
                write_png(f"{d2}/{fn:010d}.png", inst_map.reshape(h, w).astype(np.uint16))
    return SEQ
