"""Validate a KITTI-360 tree against the layout the loader expects (port of
tools/check_data.py; host code, no PIL).

Walks `data.root` and reports, per stream, whether it is present and how
many frames of the configured window it covers, before a long training run
discovers a hole. uint16 SGM PNGs are read by `viz/png.py` with the
loader's millimetre rule (/1000); float `.npy` maps are read as they are.
Exit code 0 iff every stream the config's flags require is usable.

    python -m panopticnerf_tpu_torch.tools.check_data --cfg_file configs/kitti360_panoptic.yaml \\
        [KEY VALUE ...]
    python -m panopticnerf_tpu_torch.tools.check_data --root datasets/KITTI-360 \\
        --sequence 2013_05_28_drive_0000_sync --frame_start 3353 --frame_num 64
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from panopticnerf_tpu_torch.viz.png import read_png


def _frames_covered(dir_path: str, frames: list[int], exts: tuple[str, ...]) -> int:
    if not os.path.isdir(dir_path):
        return 0
    return sum(any(os.path.exists(os.path.join(dir_path, f"{fr:010d}{e}")) for e in exts)
               for fr in frames)


def check_tree(root: str, sequence: str, frames: list[int],
               use_stereo: bool = True, use_fisheye: bool = False,
               use_pspnet: bool = True, use_depth: bool = True) -> dict:
    """-> {stream: (status, required, detail)}, status in ok | partial |
    missing. Images, poses, calibration and the 3D boxes are required;
    pspnet and sgm as the config's flags say; visible_id, image_03 and the
    ground truth degrade gracefully in the loader (data/kitti360.py)."""
    n = len(frames)
    img = lambda cam, sub: os.path.join(root, "data_2d_raw", sequence, cam, sub)
    rep: dict[str, tuple[str, bool, str]] = {}

    def put(name, required, path, exts=None):
        if exts is None:
            rep[name] = ("ok" if os.path.exists(path) else "missing", required, path)
        else:
            covered = _frames_covered(path, frames, exts)
            status = "ok" if covered == n else "partial" if covered > 0 else "missing"
            rep[name] = (status, required, f"{path}: {covered}/{n} frames")

    put("calibration/perspective", True, os.path.join(root, "calibration", "perspective.txt"))
    put("calibration/cam_to_pose", True,
        os.path.join(root, "calibration", "calib_cam_to_pose.txt"))
    put("poses/cam0_to_world", True,
        os.path.join(root, "data_poses", sequence, "cam0_to_world.txt"))
    put("images/image_00", True, img("image_00", "data_rect"), (".png", ".jpg"))
    put("images/image_01", use_stereo, img("image_01", "data_rect"), (".png", ".jpg"))
    if use_fisheye:
        put("calibration/fisheye_yaml", True, os.path.join(root, "calibration", "image_02.yaml"))
        put("poses/imu", True, os.path.join(root, "data_poses", sequence, "poses.txt"))
        put("images/image_02", True, img("image_02", "data_rgb"), (".png", ".jpg"))
        put("images/image_03", False, img("image_03", "data_rgb"), (".png", ".jpg"))
    xml = os.path.join(root, "data_3d_bboxes", "train", f"{sequence}.xml")
    xml2 = os.path.join(root, "data_3d_bboxes", "train_full", f"{sequence}.xml")
    rep["primitives/3d_bboxes"] = (
        ("ok", True, xml) if os.path.exists(xml) else
        ("ok", True, xml2) if os.path.exists(xml2) else ("missing", True, xml))
    put("primitives/visible_id", False, os.path.join(root, "visible_id", sequence),
        (".txt", ".npy"))
    put("pseudo_labels/pspnet", use_pspnet, os.path.join(root, "pspnet", sequence, "image_00"),
        (".npy", ".png"))
    put("depth/sgm", use_depth, os.path.join(root, "sgm", sequence, "image_00"),
        (".npy", ".png"))
    gt = os.path.join(root, "data_2d_semantics", "train", sequence, "image_00")
    put("eval_gt/semantic", False, os.path.join(gt, "semantic"), (".png",))
    put("eval_gt/instance", False, os.path.join(gt, "instance"), (".png",))
    return rep


def diagnose_depth_units(root: str, sequence: str, frames: list[int],
                         cam: str = "image_00") -> tuple[str, str]:
    """Check SGM depth values, not just presence: a median of ~10^4 after
    the loader's unit rules means millimetres stored as metres, one under
    0.5 m means metres stored as uint16 (divided by the millimetre rule).
    The verdict is the median over frames of each frame's median valid
    depth, so one sparse frame does not decide it. -> (status, message),
    status in ok | warn | none. The depth convention (plane z or ray
    distance) is declared by data.depth_convention, not detected here."""
    base_dir = os.path.join(root, "sgm", sequence, cam)
    meds = []
    for fr in frames:
        base = os.path.join(base_dir, f"{fr:010d}")
        if os.path.exists(base + ".npy"):
            arr = np.load(base + ".npy").astype(np.float32)
        elif os.path.exists(base + ".png"):
            raw = read_png(base + ".png")
            # data/kitti360._load_depth: uint16 PNGs are millimetres
            arr = (raw.astype(np.float32) / 1000.0 if raw.dtype == np.uint16
                   else raw.astype(np.float32))
        else:
            continue
        valid = arr > 0
        if valid.any():
            meds.append(float(np.median(arr[valid])))
    if not meds:
        return ("none", "no depth frames found to value-check")
    med = float(np.median(meds))
    if med > 200.0:
        return ("warn",
                f"median valid depth {med:.0f} over {len(meds)} frames — "
                f"driving scenes sit at ~5-50 m; values this large look "
                f"like MILLIMETERS stored as meters (float maps are read "
                f"as-is; only uint16 PNGs get the /1000 mm rule)")
    if med < 0.5:
        return ("warn",
                f"median valid depth {med:.3f} m over {len(meds)} frames — "
                f"suspiciously small; uint16 PNGs are interpreted as "
                f"millimeters (/1000), so meters stored as uint16 "
                f"arrive 1000x too small")
    return ("ok", f"median valid depth {med:.1f} m over {len(meds)} frames; "
                  f"interpreted per data.depth_convention "
                  f"(plane_z -> ray distance at load)")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="KITTI-360 layout checker")
    p.add_argument("--cfg_file", default=None)
    p.add_argument("--root", default=None)
    p.add_argument("--sequence", default="2013_05_28_drive_0000_sync")
    p.add_argument("--frame_start", type=int, default=0)
    p.add_argument("--frame_num", type=int, default=64)
    p.add_argument("--frame_step", type=int, default=1)
    args, opts = p.parse_known_args(argv)  # flags may follow KEY VALUE options
    for tok in opts:
        if tok.startswith("--"):
            p.error(f"unrecognized flag {tok!r}")
    args.opts = opts
    return args


def main(argv=None, log=print) -> int:
    """Print the report; -> the exit code (0 iff every required stream is ok
    and the depth values look like metres)."""
    args = parse_args(argv)
    if args.cfg_file or args.opts:
        # KEY VALUE overrides apply even without --cfg_file, on the default config
        from panopticnerf_tpu_torch.config import load_config

        d = load_config(args.cfg_file, args.opts).data
        root, seq = d.root, d.sequence
        frames = list(range(d.frame_start, d.frame_start + d.frame_num * d.frame_step,
                            d.frame_step))
        flags = dict(use_stereo=d.use_stereo, use_fisheye=d.use_fisheye,
                     use_pspnet=d.use_pspnet, use_depth=d.use_depth)
    else:
        root = args.root or "datasets/KITTI-360"
        seq = args.sequence
        frames = list(range(args.frame_start,
                            args.frame_start + args.frame_num * args.frame_step,
                            args.frame_step))
        flags = {}

    rep = check_tree(root, seq, frames, **flags)
    width = max(len(k) for k in rep)
    bad = False
    for name, (status, required, detail) in rep.items():
        kind = "required" if required else "optional"
        mark = "+" if status == "ok" else ("!" if required else "~")
        log(f" {mark} {name:<{width}}  {status:<8} {kind:<9} {detail}")
        bad |= required and status != "ok"
    if flags.get("use_depth", True):
        dstat, dmsg = diagnose_depth_units(root, seq, frames)
        if dstat != "none":
            mark = "+" if dstat == "ok" else "!"
            log(f" {mark} {'depth/units':<{width}}  {dstat:<8} {'check':<9} {dmsg}")
            bad |= dstat == "warn"
    if bad:
        log("\nFAIL: required streams missing/partial for this config "
            "(optional streams degrade gracefully; see docs/MIGRATION.md).")
        return 1
    log("\nOK: layout satisfies the configured streams.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
