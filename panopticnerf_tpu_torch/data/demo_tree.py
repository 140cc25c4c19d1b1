"""Geometrically CONSISTENT miniature KITTI-360 tree generator (port of
`panopticnerf_tpu/data/demo_tree.py`: the same scene, the same arrays,
PNGs written by `viz/png.py` instead of PIL).

The handcrafted loader fixture (tests/test_kitti360.make_fake_kitti) paints
pseudo/GT labels that deliberately do NOT match its 3D primitives — fine for
exercising parser/loader plumbing, but adversarial as a QUALITY proxy: the
fixed semantic field contradicts the 2D labels, bounding staged-pipeline
mIoU near 0.5 regardless of training (the round-2 "quality gap").

This generator instead raycasts an actual box scene (data/synthetic.py's
independent raycaster, here as float64 torch ops on a chosen device that
give the same bits) and writes every KITTI-360 stream
from that single source of truth:

  - rgb images (left + stereo right) shaded from the boxes over a sky
    gradient,
  - pspnet/ pseudo-labels = GT raw ids + uniform label-flip noise,
  - sgm/ depth in PLANE-Z convention (z along the optical axis, like real
    stereo SGM) — the loader's plane_z -> ray-distance conversion is
    thereby validated end-to-end,
  - data_2d_semantics GT (raw-id semantic png + sem*1000+inst instance png),
  - data_3d_bboxes XML cuboids whose transforms reproduce the raycast
    geometry exactly (plus, with n_concave>0, L-shaped concave extruded
    polygons written as single 12-vertex annotations and raycast as the
    two boxes that tile them — the annotation3d convex decomposition must
    reproduce the raycast geometry for the streams to stay consistent),
  - calibration / poses / visible_id.

Reference layout: [pn] preprocessed KITTI-360 release (unverified,
SURVEY.md §3.4). Write one from the command line:

    python -m panopticnerf_tpu_torch.data.demo_tree OUT [--frames N] [--hw H,W]
        [--boxes N] [--concave N] [--seed S] [--seq NAME] [--frame_start F] [--fisheye]
        [--device cpu]
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET

import numpy as np
import torch

from panopticnerf_tpu_torch.data.kitti360 import fisheye_valid_mask
from panopticnerf_tpu_torch.data.synthetic import _mei_unproject_np, _raycast
from panopticnerf_tpu_torch.viz.png import write_png

SEQ = "2013_05_28_drive_0000_sync"

# (label, raw semantic id) per box slot; classes cycle. car/building are
# 'things' (instances in GT), vegetation is stuff — all three exercised.
_BOX_CLASSES = [("car", 26), ("building", 11), ("vegetation", 21)]
_GROUND = ("road", 7)
_SKY_ID = 23
_NOISE_IDS = np.array([7, 8, 11, 21, 23, 26])  # incl. sidewalk as a distractor


def _mat_xml(parent, name, arr):
    node = ET.SubElement(parent, name)
    ET.SubElement(node, "rows").text = str(arr.shape[0])
    ET.SubElement(node, "cols").text = str(arr.shape[1])
    ET.SubElement(node, "dt").text = "d"
    ET.SubElement(node, "data").text = " ".join(f"{v:.8f}" for v in arr.reshape(-1))


def _scene(n_boxes: int, rng: np.random.Generator):
    """Box soup in front of the camera path + a road-plane ground box."""
    centers = np.stack([
        rng.uniform(-5.0, 5.0, n_boxes),
        rng.uniform(-1.5, 1.0, n_boxes),
        rng.uniform(7.0, 16.0, n_boxes),
    ], axis=1)
    sizes = rng.uniform(1.2, 3.5, (n_boxes, 3))
    angles = rng.uniform(0, 2 * np.pi, n_boxes)
    rots = np.zeros((n_boxes, 3, 3))
    for i, a in enumerate(angles):  # yaw-only, KITTI-like
        c, s = np.cos(a), np.sin(a)
        rots[i] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
    labels = [_BOX_CLASSES[i % len(_BOX_CLASSES)] for i in range(n_boxes)]
    # ground: huge thin 'road' box under the scene (y is down)
    centers = np.concatenate([centers, [[0.0, 3.0, 12.0]]])
    sizes = np.concatenate([sizes, [[60.0, 0.4, 60.0]]])
    rots = np.concatenate([rots, [np.eye(3)]])
    labels.append(_GROUND)
    palette = rng.uniform(0.25, 1.0, (n_boxes + 1, 3))
    palette[-1] = [0.35, 0.33, 0.33]  # asphalt
    return centers, sizes, rots, labels, palette


def _l_prism(i: int, rng: np.random.Generator):
    """One L-shaped building footprint (concave 6-gon in x-z, extruded in y).

    Returns (ring 6x2 in x-z file order, (y_top, y_bottom), centers 2x3,
    sizes 2x3) where the two axis-aligned boxes tile the L exactly — the
    raycast renders the boxes, the XML carries the single concave polygon,
    and parse_bbox_xml's convex decomposition must reproduce the boxes.
    """
    sign = 1.0 if i % 2 == 0 else -1.0            # alternate street side
    x0 = 2.3 + rng.uniform(0.0, 0.6)
    z0 = 9.0 + 2.2 * (i // 2) + rng.uniform(0.0, 0.8)
    wx = 1.4 + rng.uniform(0.0, 0.5)              # vertical-leg width (x)
    dz = 3.4 + rng.uniform(0.0, 0.8)              # vertical-leg depth (z)
    lx = 2.0 + rng.uniform(0.0, 0.6)              # horizontal-leg length (x)
    wz = 1.4 + rng.uniform(0.0, 0.4)              # horizontal-leg depth (z)
    y_top, y_bot = -1.5, 2.9                      # roof .. just above road
    ring = np.array([
        [x0, z0], [x0 + wx + lx, z0], [x0 + wx + lx, z0 + wz],
        [x0 + wx, z0 + wz], [x0 + wx, z0 + dz], [x0, z0 + dz],
    ])
    ring[:, 0] *= sign
    centers = np.array([
        [sign * (x0 + wx / 2), (y_top + y_bot) / 2, z0 + dz / 2],
        [sign * (x0 + wx + lx / 2), (y_top + y_bot) / 2, z0 + wz / 2],
    ])
    sizes = np.array([[wx, y_bot - y_top, dz], [lx, y_bot - y_top, wz]])
    return ring, (y_top, y_bot), centers, sizes


def write_demo_tree(root: str, n_frames: int = 8, hw: tuple[int, int] = (48, 64),
                    n_boxes: int = 6, seed: int = 0, label_noise: float = 0.05,
                    depth_keep: float = 0.6, baseline: float = 0.5,
                    seq: str = SEQ, fisheye: bool = False,
                    n_concave: int = 0, frame_start: int = 0,
                    device: torch.device | str = "cuda") -> str:
    """Write the tree under `root`; returns the sequence name. Call with
    several `seq`/`seed` values over one root to build a multi-sequence
    tree (data.sequences; BASELINE config 5).

    `frame_start` offsets every frame NUMBER (pose lines, file names, XML
    frame ranges) without changing the camera path, matching the real
    KITTI-360 layout where training windows start mid-sequence (the shipped
    configs' `data.frame_start: 3353` runs against such a tree unmodified).

    With `fisheye=True` the tree additionally carries the -360 branch's
    left-fisheye streams (calibration/image_02.yaml MEI intrinsics,
    data_2d_raw/.../image_02/data_rgb, pspnet/.../image_02), raycast from
    the cam0 pose through the MEI camera model — so `data.use_fisheye`
    joint perspective+fisheye batches run on geometrically consistent
    KITTI-format data. The MEI c2p is identity and poses.txt already holds
    the cam0 pose, so the fisheye view shares cam0's pose exactly.

    The raycasts run on `device`; every array written is the same on any
    device."""
    SEQ = seq  # noqa: N806 — shadow the module default for the body below
    h, w = hw
    rng = np.random.default_rng(seed)
    centers, sizes, rots, labels, palette = _scene(n_boxes, rng)
    # Annotation bookkeeping: cuboids are one raycast box == one annotation;
    # each concave L-building (n_concave) is ONE annotation (a 12-vertex
    # extruded polygon in the XML) backed by TWO raycast boxes that tile it,
    # exercising parse_bbox_xml's convex decomposition end-to-end.
    ann_of_box = list(range(len(labels)))
    ann_labels = list(labels)               # (name, raw id) per annotation
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
    # local instance index per class (things get 1-based ids; stuff gets 0)
    inst_local = np.zeros(len(ann_labels), np.int64)
    seen: dict[int, int] = {}
    for i, rid in enumerate(raw_ids):
        if (rid in (26, 11)):  # car/building are things here
            seen[rid] = seen.get(rid, 0) + 1
            inst_local[i] = seen[rid]
    box_raw = raw_ids[ann_of_box]           # per-raycast-box raw id
    box_inst = inst_local[ann_of_box]       # per-raycast-box instance

    fx = 0.8 * w
    K = np.array([[fx, 0, w / 2], [0, fx, h / 2], [0, 0, 1]])

    # --- calibration ---
    os.makedirs(f"{root}/calibration", exist_ok=True)
    with open(f"{root}/calibration/perspective.txt", "w") as f:
        P0 = f"{fx} 0 {w/2} 0 0 {fx} {h/2} 0 0 0 1 0"
        P1 = f"{fx} 0 {w/2} {-fx*baseline} 0 {fx} {h/2} 0 0 0 1 0"
        f.write(f"P_rect_00: {P0}\nR_rect_00: 1 0 0 0 1 0 0 0 1\n")
        f.write(f"P_rect_01: {P1}\nR_rect_01: 1 0 0 0 1 0 0 0 1\n")
        f.write(f"S_rect_00: {w} {h}\n")
    with open(f"{root}/calibration/calib_cam_to_pose.txt", "w") as f:
        f.write("image_00: 1 0 0 0 0 1 0 0 0 0 1 0\n")
        if fisheye:
            f.write("image_02: 1 0 0 0 0 1 0 0 0 0 1 0\n")
    # MEI fisheye intrinsics in tree-native pixels (image_width == w, so
    # the loader's fisheye_params_scaled is the identity at ratio 1.0)
    fe_fp = np.array([0.9 * w, 0.9 * h, w / 2, h / 2, 2.0, 0.01, -0.002],
                     np.float32)
    if fisheye:
        with open(f"{root}/calibration/image_02.yaml", "w") as f:
            f.write(
                "%YAML:1.0\n---\n"
                f"image_width: {w}\nimage_height: {h}\n"
                "mirror_parameters:\n"
                f"   xi: {fe_fp[4]}\n"
                "distortion_parameters:\n"
                f"   k1: {fe_fp[5]}\n   k2: {fe_fp[6]}\n"
                "projection_parameters:\n"
                f"   gamma1: {fe_fp[0]}\n   gamma2: {fe_fp[1]}\n"
                f"   u0: {fe_fp[2]}\n   v0: {fe_fp[3]}\n"
            )

    # --- poses: straight path along +x, looking +z ---
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

    # --- 3D bboxes XML (cuboids; transform = R @ diag(size)) ---
    os.makedirs(f"{root}/data_3d_bboxes/train", exist_ok=True)
    rootel = ET.Element("opencv_storage")
    cube = np.array([[x, y, z] for x in (-0.5, 0.5) for y in (-0.5, 0.5)
                     for z in (-0.5, 0.5)])
    for i, ((label, rid), geom) in enumerate(zip(ann_labels, ann_geom)):
        obj = ET.SubElement(rootel, f"object_{i}")
        if geom[0] == "cuboid":
            j = geom[1]
            T = np.eye(4)
            T[:3, :3] = rots[j] @ np.diag(sizes[j])
            T[:3, 3] = centers[j]
            verts = cube
        else:  # concave extruded polygon: identity transform, world verts
            _, ring, y_top, y_bot = geom
            T = np.eye(4)
            verts = np.array([[x, y, z] for y in (y_top, y_bot)
                              for x, z in ring])
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

    # --- visible ids: every annotation, every frame ---
    os.makedirs(f"{root}/visible_id/{SEQ}", exist_ok=True)
    for i in range(n_frames):
        with open(f"{root}/visible_id/{SEQ}/{frame_start + i:010d}.txt", "w") as f:
            f.write("\n".join(str(j) for j in range(len(ann_labels))) + "\n")

    # --- per-frame raycast renders ---
    vv, uu = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    uv = np.stack([uu.reshape(-1) + 0.5, vv.reshape(-1) + 0.5], axis=1)
    x = (uv[:, 0] - K[0, 2]) / K[0, 0]
    y = (uv[:, 1] - K[1, 2]) / K[1, 1]
    dirs_cam = np.stack([x, y, np.ones_like(x)], axis=1)
    inv_norm = 1.0 / np.linalg.norm(dirs_cam, axis=1)   # ray-dist -> plane-z
    near, far = 0.1, 60.0
    shade = np.array([1.0, 0.75, 0.55])

    fe_dirs = fe_valid = None
    if fisheye:
        fe_dirs = _mei_unproject_np(uv, fe_fp)
        fe_valid = fisheye_valid_mask(fe_fp, (h, w)).reshape(-1)

    for cam in ("image_00", "image_01"):
        os.makedirs(f"{root}/data_2d_raw/{SEQ}/{cam}/data_rect", exist_ok=True)
        os.makedirs(f"{root}/pspnet/{SEQ}/{cam}", exist_ok=True)
    if fisheye:
        os.makedirs(f"{root}/data_2d_raw/{SEQ}/image_02/data_rgb", exist_ok=True)
        os.makedirs(f"{root}/pspnet/{SEQ}/image_02", exist_ok=True)
    os.makedirs(f"{root}/sgm/{SEQ}/image_00", exist_ok=True)
    d1 = f"{root}/data_2d_semantics/train/{SEQ}/image_00/semantic"
    d2 = f"{root}/data_2d_semantics/train/{SEQ}/image_00/instance"
    os.makedirs(d1, exist_ok=True)
    os.makedirs(d2, exist_ok=True)

    for fr in range(n_frames):
        fn = frame_start + fr
        for cam_idx, cam in enumerate(("image_00", "image_01")):
            c2w = c2ws[fr].copy()
            if cam_idx == 1:
                c2w[:3, 3] = c2w[:3, 3] + c2w[:3, 0] * baseline
            R, t = c2w[:3, :3], c2w[:3, 3]
            d = dirs_cam @ R.T
            d /= np.linalg.norm(d, axis=1, keepdims=True)
            t_hit, idx, face = _raycast(t, d, centers, half, rots, near, far, device)
            hit = idx >= 0

            sky = np.stack([0.45 + 0.25 * (uv[:, 1] / h),
                            0.55 + 0.25 * (uv[:, 1] / h),
                            0.9 * np.ones(h * w)], axis=1)
            col = sky.copy()
            col[hit] = palette[idx[hit]] * shade[face[hit]][:, None]
            img = (col.reshape(h, w, 3).clip(0, 1) * 255).astype(np.uint8)
            write_png(f"{root}/data_2d_raw/{SEQ}/{cam}/data_rect/{fn:010d}.png", img)

            sem_raw = np.where(hit, box_raw[np.clip(idx, 0, None)], _SKY_ID)
            pseudo = sem_raw.copy()
            flip = rng.uniform(size=pseudo.shape) < label_noise
            pseudo[flip] = rng.choice(_NOISE_IDS, size=int(flip.sum()))
            np.save(f"{root}/pspnet/{SEQ}/{cam}/{fn:010d}.npy",
                    pseudo.reshape(h, w).astype(np.int32))

            if cam_idx == 0:
                # sgm: PLANE-Z depth (stereo convention), sparsified
                z = np.where(hit, t_hit * inv_norm, 0.0)
                keep = rng.uniform(size=z.shape) < depth_keep
                np.save(f"{root}/sgm/{SEQ}/image_00/{fn:010d}.npy",
                        np.where(keep, z, 0.0).reshape(h, w).astype(np.float32))

                write_png(f"{d1}/{fn:010d}.png", sem_raw.reshape(h, w).astype(np.uint8))
                inst_map = sem_raw.astype(np.int64) * 1000
                inst_map[hit] += box_inst[idx[hit]]
                # uint16 like the real KITTI-360 instance PNGs
                # (semantic*1000+instance <= ~45k fits)
                write_png(f"{d2}/{fn:010d}.png", inst_map.reshape(h, w).astype(np.uint16))

        if fisheye:
            # left fisheye from the cam0 pose (identity c2p, IMU pose =
            # cam0 pose — see docstring); outside the MEI FOV circle the
            # image is black and the pseudo-label is raw id 0 (-> ignore)
            c2w = c2ws[fr]
            R, t = c2w[:3, :3], c2w[:3, 3]
            d = fe_dirs @ R.T
            t_hit, idx, face = _raycast(t, d, centers, half, rots, near, far, device)
            hit = (idx >= 0) & fe_valid

            sky = np.stack([0.45 + 0.25 * (uv[:, 1] / h),
                            0.55 + 0.25 * (uv[:, 1] / h),
                            0.9 * np.ones(h * w)], axis=1)
            col = np.where(fe_valid[:, None], sky, 0.0)
            col[hit] = palette[idx[hit]] * shade[face[hit]][:, None]
            img = (col.reshape(h, w, 3).clip(0, 1) * 255).astype(np.uint8)
            write_png(f"{root}/data_2d_raw/{SEQ}/image_02/data_rgb/{fn:010d}.png", img)

            sem_raw = np.where(hit, box_raw[np.clip(idx, 0, None)], _SKY_ID)
            sem_raw = np.where(fe_valid, sem_raw, 0)
            pseudo = sem_raw.copy()
            flip = (rng.uniform(size=pseudo.shape) < label_noise) & fe_valid
            pseudo[flip] = rng.choice(_NOISE_IDS, size=int(flip.sum()))
            np.save(f"{root}/pspnet/{SEQ}/image_02/{fn:010d}.npy",
                    pseudo.reshape(h, w).astype(np.int32))
    return SEQ


def main(argv=None) -> str:
    import argparse

    p = argparse.ArgumentParser(description="write a miniature KITTI-360 tree")
    p.add_argument("out")
    p.add_argument("--frames", type=int, default=8)
    p.add_argument("--hw", type=str, default="48,64", help="H,W of the written images")
    p.add_argument("--boxes", type=int, default=6)
    p.add_argument("--concave", type=int, default=0, help="L-shaped concave buildings")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--seq", type=str, default=SEQ)
    p.add_argument("--frame_start", type=int, default=0)
    p.add_argument("--fisheye", action="store_true")
    p.add_argument("--device", type=str, default="cuda", help="where the raycasts run")
    a = p.parse_args(argv)
    os.makedirs(a.out, exist_ok=True)
    hw = tuple(int(x) for x in a.hw.split(","))
    seq = write_demo_tree(a.out, n_frames=a.frames, hw=hw, n_boxes=a.boxes, seed=a.seed,
                          seq=a.seq, fisheye=a.fisheye, n_concave=a.concave,
                          frame_start=a.frame_start, device=a.device)
    print(seq, "->", a.out)
    return seq


if __name__ == "__main__":
    main()
