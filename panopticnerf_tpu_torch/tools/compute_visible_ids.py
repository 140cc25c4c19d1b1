"""Per-frame visible-primitive id lists for a KITTI-360 tree (port of
tools/compute_visible_ids.py; host numpy).

The PanopticNeRF release ships precomputed `visible_id/` files; raw
KITTI-360 downloads lack them, and the loader reads them
(data/kitti360.py). A primitive is visible in a frame when any of its world
vertices, or its centre, projects inside the rectified cam0 frustum
(widened by `--margin`) within `--max-depth` metres, or when the camera is
inside its bounding box, and the frame lies in its annotation window.

    python -m panopticnerf_tpu_torch.tools.compute_visible_ids --root datasets/KITTI-360 \\
        --sequence 2013_05_28_drive_0000_sync [--max-depth 120]

Writes `<root>/visible_id/<sequence>/<frame:010d>.txt`, one id per line.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from panopticnerf_tpu_torch.data.annotation3d import parse_bbox_xml
from panopticnerf_tpu_torch.data.kitti360 import load_cam0_to_world, load_perspective_calib


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="per-frame visible primitive ids")
    ap.add_argument("--root", required=True)
    ap.add_argument("--sequence", required=True)
    ap.add_argument("--max-depth", type=float, default=120.0)
    ap.add_argument("--margin", type=float, default=0.1,
                    help="frustum margin as a fraction of image size")
    return ap.parse_args(argv)


def main(argv=None, log=print) -> str:
    """Returns the directory written."""
    args = parse_args(argv)
    calib = load_perspective_calib(os.path.join(args.root, "calibration", "perspective.txt"))
    K = calib["P_rect_00"][:, :3]
    wh = calib.get("S_rect_00", np.array([1408.0, 376.0]))
    w, h = float(wh[0]), float(wh[1])
    poses = load_cam0_to_world(os.path.join(args.root, "data_poses", args.sequence,
                                            "cam0_to_world.txt"))
    boxes = parse_bbox_xml(os.path.join(args.root, "data_3d_bboxes", "train",
                                        f"{args.sequence}.xml"))
    out_dir = os.path.join(args.root, "visible_id", args.sequence)
    os.makedirs(out_dir, exist_ok=True)

    # every box's vertices (padded) and its centre
    max_v = max(b.vertices_world.shape[0] for b in boxes)
    verts = np.zeros((len(boxes), max_v + 1, 3), np.float64)
    vmask = np.zeros((len(boxes), max_v + 1), bool)
    for i, b in enumerate(boxes):
        nv = b.vertices_world.shape[0]
        verts[i, :nv] = b.vertices_world
        verts[i, nv] = b.vertices_world.mean(0)
        vmask[i, : nv + 1] = True
    lo = np.where(vmask[..., None], verts, np.inf).min(1)
    hi = np.where(vmask[..., None], verts, -np.inf).max(1)

    mx, my = args.margin * w, args.margin * h
    n_written = 0
    for frame, c2w in sorted(poses.items()):
        w2c_R = c2w[:3, :3].T
        w2c_t = -w2c_R @ c2w[:3, 3]
        cam = (verts @ w2c_R.T) + w2c_t            # (B, V, 3) camera coordinates
        z = cam[..., 2]
        uvw = cam @ K.T
        with np.errstate(divide="ignore", invalid="ignore"):
            u = uvw[..., 0] / z
            v = uvw[..., 1] / z
        in_img = ((z > 0.05) & (z < args.max_depth)
                  & (u > -mx) & (u < w + mx) & (v > -my) & (v < h + my) & vmask)
        cam_pos = c2w[:3, 3]
        inside = ((cam_pos >= lo) & (cam_pos <= hi)).all(-1)
        visible = in_img.any(1) | inside
        for i, b in enumerate(boxes):  # the annotation windows
            s = b.start_frame if b.start_frame >= 0 else -(10**9)
            e = b.end_frame if b.end_frame >= 0 else 10**9
            if not (s <= frame <= e):
                visible[i] = False
        ids = [b.index if b.index >= 0 else i for i, b in enumerate(boxes) if visible[i]]
        with open(os.path.join(out_dir, f"{frame:010d}.txt"), "w") as f:
            f.write("\n".join(str(i) for i in ids))
        n_written += 1
    log(f"wrote visible_id for {n_written} frames -> {out_dir}")
    return out_dir


if __name__ == "__main__":
    main()
