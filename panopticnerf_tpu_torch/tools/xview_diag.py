"""Cross-view label cleaning diagnostic: catch rate against erosion (port
of tools/xview_diag.py; host numpy after the loader).

It loads a clean demo tree and its corrupted clone (tools/corrupt_pseudo.py)
through the loader with cross-view cleaning off, runs `cross_view_clean`
over a (mode, window, tol, min_voters, repaint) grid on the noisy labels,
and reports per setting:

  caught      share of corrupted pixels demoted, or repainted to the clean label
  erosion     share of uncorrupted labelled pixels lost (demoted or repainted wrongly)
  residual    wrong-label share among the labelled pixels left (what training sees)
  repaint_acc share of repainted pixels painted to the clean label
and the same three against the ground truth where it exists (`*_gt`).
"Corrupted" means noisy != clean pseudo-label, so the clean tree's own iid
flips count as the uncorrupted ground state.

    python -m panopticnerf_tpu_torch.tools.xview_diag --clean /tmp/kitti_tree \\
        --noisy /tmp/kitti_tree_noisy [--grid "splat:2:0.1:2:0,pull:2:0.1:2:0"] [--device cuda]

`--device` is where the loader puts the views (they come back to the host
for the grid).
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

DEFAULT_GRID = ",".join([
    "pull:2:0.1:2:0",        # the pull vote, window 2
    "pull:7:0.1:2:0",        # the pull vote, window 7
    "splat:2:0.1:2:0",       # the push vote, same knobs
    "splat:2:0.1:3:0",       # stricter quorum
    "splat:2:0.05:2:0",      # tighter depth tolerance
    "splat:2:0.2:2:0",       # looser depth tolerance
    "splat:7:0.1:2:0",       # wider window
    "splat:2:0.1:2:0.8",     # repaint at 80 % concentration
    "splat:7:0.1:3:0.8",     # wide + quorum + repaint
])


def tree_opts(root: str) -> list:
    """The loader's KEY VALUE options for an 8-frame demo tree, cross-view
    cleaning off."""
    return ["data.root", root, "data.frame_start", "0", "data.frame_num", "8",
            "data.test_every", "4", "data.max_primitives", "32", "data.max_intervals", "12",
            "data.ratio", "1.0", "render.far", "40.0", "data.pseudo_cross_view", "0"]


def load_views(cfg_file: str, opts: list, device):
    """Load a tree through the loader; return the host numpy pieces that
    cross_view_clean reads, each view's frame and the perspective mask."""
    from panopticnerf_tpu_torch.config import load_config
    from panopticnerf_tpu_torch.data.kitti360 import build_kitti360_dataset

    cfg = load_config(cfg_file, opts)
    ds = build_kitti360_dataset(cfg, device)
    np_ = lambda t: t.cpu().numpy()
    V = ds.pseudo.shape[0]
    n_frames = cfg.data.frame_num
    view_frames = np.repeat(np.arange(n_frames), V // n_frames)
    persp = np_(ds.cam_model) == 0 if ds.cam_model is not None else np.ones(V, bool)
    gt = np_(ds.gt_sem) if ds.gt_sem is not None else np.full(tuple(ds.pseudo.shape), 255,
                                                              np.int32)
    return (np_(ds.pseudo), gt, np_(ds.depth), np_(ds.K), np_(ds.c2w), view_frames, persp)


def main(argv=None, log=print) -> dict:
    """Returns the summary written to `--out`."""
    p = argparse.ArgumentParser(description="cross-view cleaning: catch rate vs erosion")
    p.add_argument("--clean", required=True)
    p.add_argument("--noisy", required=True)
    p.add_argument("--cfg_file", default="configs/kitti360_panoptic.yaml")
    p.add_argument("--grid", default=DEFAULT_GRID)
    p.add_argument("--out", default="out/xview_diag.json")
    p.add_argument("--device", type=str, default="cuda")
    args, opts = p.parse_known_args(argv)
    from panopticnerf_tpu_torch.data.pseudo import IGNORE, cross_view_clean

    t0 = time.time()
    lab_c, gt, *_ = load_views(args.cfg_file, tree_opts(args.clean) + opts, args.device)
    lab_n, _, depths, Ks, c2ws, view_frames, persp = load_views(
        args.cfg_file, tree_opts(args.noisy) + opts, args.device)
    log(f"loaded {lab_n.shape} views in {time.time() - t0:.1f}s")

    labeled = (lab_n != IGNORE) & (lab_c != IGNORE)
    corrupted = labeled & (lab_n != lab_c)
    clean_px = labeled & (lab_n == lab_c)
    log(f"corruption rate among labeled: {corrupted.sum() / labeled.sum():.4f}")

    rows = []
    for spec in args.grid.split(","):
        mode, window, tol, mv, rp = spec.strip().split(":")
        window, tol, mv, rp = int(window), float(tol), int(mv), float(rp)
        t0 = time.time()
        out = cross_view_clean(lab_n, depths, Ks, c2ws, view_frames, persp, window=window,
                               tol=tol, min_voters=mv, mode=mode, repaint=rp)
        changed = out != lab_n
        fixed = corrupted & ((out == IGNORE) | (out == lab_c)) & changed
        caught = fixed.sum() / max(corrupted.sum(), 1)
        lost = clean_px & changed & (out != lab_c)
        erosion = lost.sum() / max(clean_px.sum(), 1)
        still = (out != IGNORE) & labeled
        residual = ((out != lab_c) & still).sum() / max(still.sum(), 1)
        painted = changed & (out != IGNORE)
        r_acc = (float((painted & (out == lab_c)).sum() / painted.sum())
                 if painted.any() else None)
        # against the ground truth: demoting the clean tree's own flips is a
        # gain there, so erosion_gt counts only correct supervision lost
        has_gt = (gt != IGNORE) & labeled
        good = has_gt & (lab_n == gt)
        bad = has_gt & (lab_n != gt)
        erosion_gt = (good & changed & (out != gt)).sum() / max(good.sum(), 1)
        caught_gt = (bad & ((out == IGNORE) | (out == gt)) & changed).sum() / max(bad.sum(), 1)
        still_gt = (out != IGNORE) & has_gt
        residual_gt = ((out != gt) & still_gt).sum() / max(still_gt.sum(), 1)
        row = dict(mode=mode, window=window, tol=tol, min_voters=mv, repaint=rp,
                   caught=round(float(caught), 4), erosion=round(float(erosion), 4),
                   residual=round(float(residual), 4), caught_gt=round(float(caught_gt), 4),
                   erosion_gt=round(float(erosion_gt), 4),
                   residual_gt=round(float(residual_gt), 4),
                   repaint_frac=round(float(painted.sum() / labeled.sum()), 4),
                   repaint_acc=None if r_acc is None else round(r_acc, 4),
                   secs=round(time.time() - t0, 1))
        rows.append(row)
        log(json.dumps(row))

    base = ((lab_n != lab_c) & labeled).sum() / labeled.sum()
    summary = {"pre_clean_noise": round(float(base), 4), "grid": rows}
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(summary, f, indent=1)
    log(f"wrote {args.out}")
    return summary


if __name__ == "__main__":
    main()
