"""KITTI-360 dataset loader -> DeviceDataset (port of
`panopticnerf_tpu/data/kitti360.py`).

Reference: the Dataset in [pn] lib/datasets/kitti360/panopticnerf.py
(unverified — SURVEY.md §2.2/§3.4). Expected tree (the PanopticNeRF
release's preprocessed layout):

  <root>/
    calibration/perspective.txt            P_rect_00/01, R_rect_00/01, S_rect_*
    calibration/calib_cam_to_pose.txt      image_00..03 -> IMU/pose frame
    calibration/image_02.yaml image_03.yaml  fisheye intrinsics (MEI model)
    data_poses/<seq>/cam0_to_world.txt     frame + 4x4 rectified-cam0 -> world
    data_poses/<seq>/poses.txt             frame + 3x4 IMU -> world
    data_2d_raw/<seq>/image_00/data_rect/<frame:010d>.png   (left rectified)
    data_2d_raw/<seq>/image_01/data_rect/<frame:010d>.png   (right rectified)
    data_2d_raw/<seq>/image_02/data_rgb/<frame:010d>.png    (left fisheye)
    data_2d_raw/<seq>/image_03/data_rgb/<frame:010d>.png    (right fisheye)
    data_3d_bboxes/train/<seq>.xml         3D bounding primitives
    pspnet/<seq>/image_00/<frame:010d>.npy|.png    2D pseudo-labels (raw ids)
    sgm/<seq>/image_00/<frame:010d>.npy|.png       stereo depth (m | mm-uint16)
    visible_id/<seq>/<frame:010d>.txt|.npy         per-frame visible prims
    data_2d_semantics/train/<seq>/image_00/semantic/<frame:010d>.png  eval GT
    data_2d_semantics/train/<seq>/image_00/instance/<frame:010d>.png  eval GT

Host work here is cold-path only (calibration, XML, image decode at init):
every array is built in numpy on the host, then moved to the device once,
and all per-step work is on the device. Images are decoded and resized by
`data/image.py`, which equals PIL's decode, BILINEAR and NEAREST pixel for
pixel without needing PIL. Missing optional streams (pspnet/sgm/GT)
degrade gracefully to ignore/invalid values so config-1 runs need only
images+poses+calibration.
"""

from __future__ import annotations

import os
import warnings

import numpy as np
import torch

from panopticnerf_tpu_torch.config import Config
from panopticnerf_tpu_torch.data import labels as L
from panopticnerf_tpu_torch.data.annotation3d import (
    boxes_visible_in_frame,
    load_visible_ids,
    parse_bbox_xml,
)
from panopticnerf_tpu_torch.data.dataset import DeviceDataset
from panopticnerf_tpu_torch.data.image import load_rgb, resize_bilinear, resize_nearest
from panopticnerf_tpu_torch.data.pseudo import cross_view_clean, majority_clean
from panopticnerf_tpu_torch.utils.profiling import span
from panopticnerf_tpu_torch.viz.png import read_png

IGNORE = 255
_load_npy = span("data.decode")(np.load)  # .npy streams count as decoding, as PNGs do


# ---------------------------------------------------------------- calibration
def load_perspective_calib(path: str) -> dict:
    """Parse calibration/perspective.txt -> {key: ndarray}."""
    out = {}
    with open(path) as f:
        for line in f:
            if ":" not in line:
                continue
            key, vals = line.split(":", 1)
            arr = np.array(vals.split(), dtype=np.float64)
            key = key.strip()
            if key.startswith("P_rect"):
                out[key] = arr.reshape(3, 4)
            elif key.startswith("R_rect"):
                out[key] = arr.reshape(3, 3)
            else:
                out[key] = arr
    return out


def load_cam_to_pose(path: str) -> dict:
    out = {}
    with open(path) as f:
        for line in f:
            if ":" not in line:
                continue
            key, vals = line.split(":", 1)
            out[key.strip()] = np.array(vals.split(), dtype=np.float64).reshape(3, 4)
    return out


def load_cam0_to_world(path: str) -> dict[int, np.ndarray]:
    """frame -> (4, 4) rectified-cam0 -> world."""
    data = np.loadtxt(path)
    data = np.atleast_2d(data)
    return {int(r[0]): r[1:17].reshape(4, 4) for r in data}


def stereo_right_c2w(c2w0: np.ndarray, baseline: float) -> np.ndarray:
    """Rectified right camera pose: origin shifted along the rectified x axis."""
    c2w1 = c2w0.copy()
    c2w1[:3, 3] = c2w0[:3, 3] + c2w0[:3, 0] * baseline
    return c2w1


def load_imu_poses(path: str) -> dict[int, np.ndarray]:
    """data_poses/<seq>/poses.txt: frame + 3x4 IMU->world."""
    data = np.atleast_2d(np.loadtxt(path))
    out = {}
    for r in data:
        m = np.eye(4)
        m[:3] = r[1:13].reshape(3, 4)
        out[int(r[0])] = m
    return out


def load_fisheye_calib(path: str) -> dict:
    """Parse KITTI-360 fisheye yaml (MEI model). The files start with an
    opencv '%YAML:1.0' directive that pyyaml rejects — strip it."""
    import yaml

    with open(path) as f:
        text = f.read()
    lines = [l for l in text.splitlines() if not l.startswith("%YAML")]
    doc = yaml.safe_load("\n".join(lines).replace("!!opencv-matrix", ""))
    mirror = doc.get("mirror_parameters", {})
    dist = doc.get("distortion_parameters", {})
    proj = doc.get("projection_parameters", {})
    return {
        "image_width": int(doc.get("image_width", 1400)),
        "image_height": int(doc.get("image_height", 1400)),
        "xi": float(mirror.get("xi", 0.0)),
        "k1": float(dist.get("k1", 0.0)),
        "k2": float(dist.get("k2", 0.0)),
        "gamma1": float(proj.get("gamma1", 1.0)),
        "gamma2": float(proj.get("gamma2", 1.0)),
        "u0": float(proj.get("u0", 0.0)),
        "v0": float(proj.get("v0", 0.0)),
    }


def fisheye_params_scaled(fc: dict, out_hw: tuple[int, int]) -> np.ndarray:
    """(7,) [gamma1 gamma2 u0 v0 xi k1 k2] rescaled to the stored image size."""
    h, w = out_hw
    sx = w / fc["image_width"]
    sy = h / fc["image_height"]
    return np.array(
        [fc["gamma1"] * sx, fc["gamma2"] * sy, fc["u0"] * sx, fc["v0"] * sy,
         fc["xi"], fc["k1"], fc["k2"]],
        np.float32,
    )


def fisheye_valid_mask(fp: np.ndarray, hw: tuple[int, int], iters: int = 8) -> np.ndarray:
    """Pixels whose MEI unprojection is defined: after undistortion,
    1 + (1 - xi^2) r^2 > 0 (the FOV circle for xi > 1)."""
    h, w = hw
    g1, g2, u0, v0, xi, k1, k2 = [float(x) for x in fp]
    vv, uu = np.meshgrid(np.arange(h) + 0.5, np.arange(w) + 0.5, indexing="ij")
    xd = (uu - u0) / g1
    yd = (vv - v0) / g2
    x, y = xd, yd
    for _ in range(iters):
        r2 = x * x + y * y
        scale = 1.0 + k1 * r2 + k2 * r2 * r2
        x, y = xd / np.maximum(scale, 1e-6), yd / np.maximum(scale, 1e-6)
    r2 = x * x + y * y
    return (1.0 + (1.0 - xi * xi) * r2) > 1e-4


# ------------------------------------------------------------------- streams
def _load_image(path: str, ratio: float) -> np.ndarray:
    img = load_rgb(path)
    if ratio != 1.0:
        h, w = img.shape[:2]
        img = resize_bilinear(img, (max(int(w * ratio), 1), max(int(h * ratio), 1)))
    return img


def _load_label_map(base: str, hw: tuple[int, int]) -> np.ndarray:
    """Pseudo-label map as raw ids; nearest-resized to (h, w); IGNORE if absent."""
    h, w = hw
    for ext in (".npy", ".png"):
        p = base + ext
        if os.path.exists(p):
            arr = _load_npy(p).astype(np.int32) if ext == ".npy" else read_png(p)
            return resize_nearest(arr, (w, h)).astype(np.int32)
    return np.full((h, w), IGNORE, np.int32)


def plane_z_to_ray_factor(K: np.ndarray, hw: tuple[int, int]) -> np.ndarray:
    """(h, w) multiplier converting plane-z depth to ray distance for a
    pinhole camera: ray = z * ||(x, y, 1)|| with x = (u - cx)/fx etc.

    Stereo SGM produces plane-z (z = f*b/disparity along the rectified
    optical axis) while the renderer composites Euclidean distance along
    unit-norm rays (ops/composite.py depth_map) — the factor is 1.0 only at
    the principal point and grows toward the image borders.
    """
    h, w = hw
    x = (np.arange(w) + 0.5 - K[0, 2]) / K[0, 0]
    y = (np.arange(h) + 0.5 - K[1, 2]) / K[1, 1]
    return np.sqrt(x[None, :] ** 2 + y[:, None] ** 2 + 1.0).astype(np.float32)


def _load_depth(base: str, hw: tuple[int, int]) -> np.ndarray:
    """Depth in meters, 0 where invalid; uint16 PNGs are millimeters."""
    h, w = hw
    for ext in (".npy", ".png"):
        p = base + ext
        if os.path.exists(p):
            if ext == ".npy":
                arr = _load_npy(p).astype(np.float32)
            else:
                raw = read_png(p)
                arr = raw.astype(np.float32) / 1000.0 if raw.dtype == np.uint16 else raw.astype(np.float32)
            return resize_nearest(arr, (w, h))
    return np.zeros((h, w), np.float32)


def _load_gt_sem_inst(root: str, seq: str, frame: int, hw: tuple[int, int]):
    h, w = hw
    sem_p = os.path.join(root, "data_2d_semantics", "train", seq, "image_00", "semantic", f"{frame:010d}.png")
    inst_p = os.path.join(root, "data_2d_semantics", "train", seq, "image_00", "instance", f"{frame:010d}.png")
    sem = np.full((h, w), IGNORE, np.int32)
    inst = np.zeros((h, w), np.int32)
    if os.path.exists(sem_p):
        sem = resize_nearest(read_png(sem_p), (w, h)).astype(np.int32)
    if os.path.exists(inst_p):
        # KITTI-360 instance png encodes semantic*1000 + instance (uint16/32)
        raw = resize_nearest(read_png(inst_p), (w, h)).astype(np.int32)
        inst = raw % 1000
        if not os.path.exists(sem_p):
            sem = raw // 1000
    return sem, inst


# ---------------------------------------------------------------- main build
def build_kitti360_dataset(cfg: Config, device: torch.device | str) -> DeviceDataset:
    """The views of one sequence window (`data.sequence`), on `device`."""
    dc = cfg.data
    root = dc.root
    seq = dc.sequence
    ratio = dc.ratio
    to_train_ids = cfg.model.num_classes == L.NUM_TRAIN_IDS
    if dc.depth_convention not in ("plane_z", "ray"):
        raise ValueError(
            f"data.depth_convention must be 'plane_z' or 'ray', "
            f"got {dc.depth_convention!r}")

    calib = load_perspective_calib(os.path.join(root, "calibration", "perspective.txt"))
    P0 = calib["P_rect_00"]
    K_full = P0[:, :3].copy()
    baseline = 0.0
    if "P_rect_01" in calib:
        baseline = -calib["P_rect_01"][0, 3] / calib["P_rect_01"][0, 0]
    K = K_full.copy()
    K[:2] *= ratio

    c2w0_all = load_cam0_to_world(os.path.join(root, "data_poses", seq, "cam0_to_world.txt"))

    frames = [
        dc.frame_start + i * dc.frame_step
        for i in range(dc.frame_num)
        if (dc.frame_start + i * dc.frame_step) in c2w0_all
    ]
    if not frames:
        raise FileNotFoundError(
            f"no posed frames in window [{dc.frame_start}, "
            f"{dc.frame_start + dc.frame_num * dc.frame_step}) for {seq}"
        )

    # --- primitives --- (train/ is the PanopticNeRF layout; train_full/ is
    # the raw KITTI-360 download's directory name — accept both)
    xml_path = os.path.join(root, "data_3d_bboxes", "train", f"{seq}.xml")
    if not os.path.exists(xml_path):
        alt = os.path.join(root, "data_3d_bboxes", "train_full", f"{seq}.xml")
        if os.path.exists(alt):
            xml_path = alt
    boxes = (
        parse_bbox_xml(xml_path, max_cut_planes=dc.max_cut_planes)
        if os.path.exists(xml_path)
        else []
    )
    all_w2p = (
        np.stack([b.world_to_prim for b in boxes])
        if boxes
        else np.zeros((0, 3, 4), np.float32)
    )
    raw_sem = np.array([b.semantic_id for b in boxes], np.int32)
    if to_train_ids and len(boxes):
        prim_sem_all = L.ID_TO_TRAINID[np.clip(raw_sem, 0, L.NUM_IDS - 1)].astype(np.int32)
        prim_sem_all[prim_sem_all == IGNORE] = -1  # guide-only primitives
    else:
        prim_sem_all = raw_sem
    prim_inst_all = np.array([b.instance_id for b in boxes], np.int32)
    F = max(dc.max_cut_planes, 1)
    allpass = np.zeros((F, 4), np.float32)
    allpass[:, 3] = 1.0
    any_planes = any(b.cut_planes is not None for b in boxes)
    prim_planes_all = (
        np.stack([b.cut_planes if b.cut_planes is not None else allpass for b in boxes])
        if (boxes and any_planes)
        else None
    )
    # visibility: by-index lookup tables. One XML annotation can map to
    # several records (concave decomposition), so a visible id resolves to
    # ALL of its pieces. `index_of` keys on the XML 'index' node when
    # present; `ordinal_of` keys on file position (for visible-id files
    # that index annotations positionally).
    index_of: dict[int, list[int]] = {}
    ordinal_of: dict[int, list[int]] = {}
    for i, b in enumerate(boxes):
        if b.index >= 0:
            index_of.setdefault(b.index, []).append(i)
        if b.ordinal >= 0:
            ordinal_of.setdefault(b.ordinal, []).append(i)

    visible_dir = os.path.join(root, "visible_id", seq)
    P = dc.max_primitives

    # --- fisheye calibration (image_02/03; -360 branch) ---
    fisheye_cams = {}
    imu_poses = None
    if dc.use_fisheye:
        cam2pose = load_cam_to_pose(os.path.join(root, "calibration", "calib_cam_to_pose.txt"))
        imu_poses = load_imu_poses(os.path.join(root, "data_poses", seq, "poses.txt"))
        for cam in ("image_02", "image_03"):
            ypath = os.path.join(root, "calibration", f"{cam}.yaml")
            if os.path.exists(ypath) and cam in cam2pose:
                fc = load_fisheye_calib(ypath)
                c2p = np.eye(4)
                c2p[:3] = cam2pose[cam]
                fisheye_cams[cam] = (fc, c2p)

    # --- per-view assembly (cam0 [+ cam1] [+ fisheye 02/03]) ---
    images, Ks, c2ws, pseudos, depths = [], [], [], [], []
    pw2p, psem, pinst, pvalid, pplanes = [], [], [], [], []
    gt_sems, gt_insts = [], []
    cam_models, fisheye_ps, valid_masks, view_frames = [], [], [], []
    base_positions = []  # per-frame cam0 positions (stream-independent norm)
    any_gt = False
    any_fisheye = False
    truncated_frames: list[tuple[int, int]] = []

    for frame in frames:
        vis = load_visible_ids(visible_dir, frame)
        if vis is not None and len(index_of):
            vis_idx = [i for v in vis.tolist() for i in index_of.get(v, [])]
        elif vis is not None:
            vis_idx = [i for v in vis.tolist() for i in ordinal_of.get(v, [])]
        else:
            vis_idx = boxes_visible_in_frame(boxes, frame)
        if len(vis_idx) > P:
            # Concave decomposition multiplies records per annotation, so a
            # max_primitives tuned pre-decomposition can silently under-
            # represent geometry (holes in the fixed field). Never silent.
            dropped = len(vis_idx) - P
            truncated_frames.append((frame, dropped))
            vis_idx = vis_idx[:P]
        n_vis = len(vis_idx)
        w2p = np.zeros((P, 3, 4), np.float32)
        sem = np.full((P,), -1, np.int32)
        inst = np.zeros((P,), np.int32)
        val = np.zeros((P,), bool)
        planes = np.tile(allpass, (P, 1, 1)) if any_planes else None
        if n_vis:
            sel = np.asarray(vis_idx, np.int64)
            w2p[:n_vis] = all_w2p[sel]
            sem[:n_vis] = prim_sem_all[sel]
            inst[:n_vis] = prim_inst_all[sel]
            val[:n_vis] = True
            if planes is not None:
                planes[:n_vis] = prim_planes_all[sel]

        c2w0 = c2w0_all[frame][:3]
        base_positions.append(c2w0[:, 3])
        cams = [("image_00", c2w0)]
        if dc.use_stereo and baseline > 0:
            cams.append(("image_01", stereo_right_c2w(c2w0_all[frame], baseline)[:3]))

        for cam, (fc, c2p) in fisheye_cams.items():
            if imu_poses is not None and frame in imu_poses:
                c2w_fe = (imu_poses[frame] @ c2p)[:3]
                cams.append((cam, c2w_fe))

        for cam, c2w in cams:
            is_fisheye = cam in fisheye_cams
            sub = "data_rgb" if is_fisheye else "data_rect"
            img_p = os.path.join(root, "data_2d_raw", seq, cam, sub, f"{frame:010d}.png")
            img = _load_image(img_p, ratio)
            hw = img.shape[:2]
            # fisheye-first layouts are unsupported: the perspective view sets HW
            if is_fisheye and images and hw != images[0].shape[:2]:
                th, tw = images[0].shape[:2]
                img = resize_bilinear(img, (tw, th))
                hw = (th, tw)
            images.append(img)
            Ks.append(K.astype(np.float32))
            c2ws.append(c2w.astype(np.float32))
            view_frames.append(frame)
            if is_fisheye:
                any_fisheye = True
                fp = fisheye_params_scaled(fc, hw)
                cam_models.append(1)
                fisheye_ps.append(fp)
                valid_masks.append(fisheye_valid_mask(fp, hw))
            else:
                cam_models.append(0)
                fisheye_ps.append(np.array([1, 1, 0, 0, 0, 0, 0], np.float32))
                valid_masks.append(np.ones(hw, bool))
            if dc.use_pspnet:
                lab = _load_label_map(os.path.join(root, "pspnet", seq, cam, f"{frame:010d}"), hw)
                if to_train_ids:
                    lab = L.ids_to_trainids(lab)
                if dc.pseudo_clean_neighbors > 0:
                    lab = majority_clean(lab, dc.pseudo_clean_neighbors)
            else:
                lab = np.full(hw, IGNORE, np.int32)
            pseudos.append(lab)
            if dc.use_depth:
                dep = _load_depth(os.path.join(root, "sgm", seq, cam, f"{frame:010d}"), hw)
                # DeviceDataset.depth carries RAY DISTANCE (the renderer's
                # composited convention). SGM maps are plane-z — convert
                # per pixel; zeros (invalid) stay zero. Fisheye views have
                # no SGM stream; any depth found there is passed through
                # (no pinhole factor applies to the MEI model).
                if dc.depth_convention == "plane_z" and not is_fisheye:
                    dep = dep * plane_z_to_ray_factor(K, hw)
                depths.append(dep)
            else:
                depths.append(np.zeros(hw, np.float32))
            pw2p.append(w2p)
            psem.append(sem)
            pinst.append(inst)
            pvalid.append(val)
            if planes is not None:
                pplanes.append(planes)
            if cam == "image_00":
                gs, gi = _load_gt_sem_inst(root, seq, frame, hw)
                if (gs != IGNORE).any():
                    any_gt = True
                    if to_train_ids:
                        gs = L.ids_to_trainids(gs)
            else:
                gs = np.full(hw, IGNORE, np.int32)
                gi = np.zeros(hw, np.int32)
            gt_sems.append(gs)
            gt_insts.append(gi)

    if truncated_frames:
        worst = max(d for _, d in truncated_frames)
        warnings.warn(
            f"data.max_primitives={P} truncated visible primitives on "
            f"{len(truncated_frames)}/{len(frames)} frames (worst: {worst} "
            f"records dropped) — concave annotations decompose into multiple "
            f"convex pieces, so raise data.max_primitives to cover them "
            f"(holes in the fixed semantic field otherwise).",
            stacklevel=2,
        )

    if dc.pseudo_cross_view > 0:
        if not (dc.use_pspnet and dc.use_depth):
            warnings.warn(
                "data.pseudo_cross_view > 0 requires use_pspnet and "
                "use_depth — cross-view fusion skipped (no pseudo-labels "
                "or no depth streams to verify against).",
                stacklevel=2,
            )
        else:
            pseudos = list(cross_view_clean(
                np.stack(pseudos), np.stack(depths),
                np.stack(Ks), np.stack(c2ws),
                np.asarray(view_frames, np.int64),
                np.asarray(cam_models, np.int32) == 0,
                window=dc.pseudo_cross_view,
                tol=dc.pseudo_xview_tol,
                min_voters=dc.pseudo_xview_min_voters,
                mode=dc.pseudo_xview_mode,
                repaint=dc.pseudo_xview_repaint))

    images = np.stack(images)
    # Scene normalization: center on the camera trajectory, scale so the far
    # plane maps inside ~[-1, 1] for stable PE. Derived from the per-frame
    # cam0 positions ONLY — a property of the sequence window, NOT of which
    # streams are enabled: normalizing over the loaded view pool made the
    # model coordinate frame depend on use_stereo/use_fisheye, so a
    # checkpoint trained with stereo rendered garbage when evaluated with
    # `use_stereo False`. Same window -> bitwise-identical normalization.
    cam_pos = np.stack(base_positions)
    center = cam_pos.mean(0).astype(np.float32)
    radius = float(np.linalg.norm(cam_pos - center, axis=1).max()) + cfg.render.far
    scale = np.float32(1.0 / radius)

    arrays = dict(
        images=images, K=np.stack(Ks), c2w=np.stack(c2ws), pseudo=np.stack(pseudos),
        depth=np.stack(depths), prim_w2p=np.stack(pw2p), prim_sem=np.stack(psem),
        prim_inst=np.stack(pinst), prim_valid=np.stack(pvalid),
        prim_planes=np.stack(pplanes) if pplanes else None,
        bounds_center=center, bounds_scale=np.asarray(scale),
        gt_sem=np.stack(gt_sems) if any_gt else None,
        gt_inst=np.stack(gt_insts) if any_gt else None,
        cam_model=np.array(cam_models, np.int32) if any_fisheye else None,
        fisheye=np.stack(fisheye_ps) if any_fisheye else None,
        valid_mask=np.stack(valid_masks) if any_fisheye else None,
    )
    return DeviceDataset(**{k: None if v is None else torch.from_numpy(v).to(device)
                            for k, v in arrays.items()})
