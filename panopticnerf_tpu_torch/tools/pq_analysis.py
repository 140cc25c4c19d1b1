"""PQ^Things diagnosis: the fusion sweep plus per-view instance error maps
(port of tools/pq_analysis.py).

    python -m panopticnerf_tpu_torch.tools.pq_analysis --cfg_file configs/kitti360_panoptic.yaml \\
        [KEY VALUE ...] [--blends 0,0.25,0.5,0.75,1] [--out out/pq_analysis] [--device cuda]

It renders every ground-truth view of the config's checkpoint once, then
on the cached fields (1) sweeps `fixed_blend` x the interval-selection
rule x the sky rule over mIoU / PQ, and (2) at the config's own fusion
lists every unmatched ground-truth thing segment with its best IoU and
writes one error map per view, `errmap_view<v>.png` (things: true
positives green, missed blue, false positives red; `viz/png.py`, no PIL),
and `report.json` (the sweep, the misses, the checkpoint's step).
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="PQ fusion sweep + error maps")
    p.add_argument("--cfg_file", type=str, required=True)
    p.add_argument("--blends", type=str, default="0,0.25,0.5,0.75,1")
    p.add_argument("--out", type=str, default="out/pq_analysis")
    p.add_argument("--device", type=str, default="cuda")
    args, opts = p.parse_known_args(argv)
    for tok in opts:
        if tok.startswith("--"):
            p.error(f"unrecognized flag {tok!r}")
    args.opts = opts
    return args


def error_map(sem, inst, gt_sem, gt_inst, valid, things, C, view):
    """(h * w, 3) uint8 error map of one view's things and its unmatched
    ground-truth segments [{view, class, instance, area, best_iou}]."""
    err = np.zeros((sem.shape[0], 3), np.uint8)
    misses = []
    # every ground-truth thing segment: its best IoU against a predicted
    # segment of its class
    gt_key = gt_sem.astype(np.int64) * 1_000_000 + gt_inst
    pr_key = sem.astype(np.int64) * 1_000_000 + inst
    for key in np.unique(gt_key[valid & things[np.clip(gt_sem, 0, C - 1)]]):
        cls, gi = int(key // 1_000_000), int(key % 1_000_000)
        gmask = (gt_key == key) & valid
        best_iou = 0.0
        for pk in np.unique(pr_key[gmask & (sem == cls)]):
            pmask = pr_key == pk
            inter = (gmask & pmask).sum()
            union = gmask.sum() + (pmask & valid).sum() - inter
            best_iou = max(best_iou, inter / max(union, 1))
        matched = best_iou > 0.5
        err[gmask, 2 if not matched else 1] = 255   # missed blue / matched green
        if not matched:
            misses.append({"view": int(view), "class": cls, "instance": gi,
                           "area": int(gmask.sum()), "best_iou": round(best_iou, 3)})
    # false positives: predicted thing segments with no ground truth of their class
    for pk in np.unique(pr_key[valid & things[np.clip(sem, 0, C - 1)]]):
        pmask = (pr_key == pk) & valid
        if not (gt_sem[pmask] == int(pk // 1_000_000)).any():
            err[pmask, 0] = 255
    return err, misses


def main(argv=None, log=print) -> dict:
    """Returns the report written to `<out>/report.json`."""
    args = parse_args(argv)
    from panopticnerf_tpu_torch.config import make_cfg
    from panopticnerf_tpu_torch.eval import resolve_sky_class
    from panopticnerf_tpu_torch.eval.panoptic import fuse_panoptic
    from panopticnerf_tpu_torch.eval.sweep import cache_gt_views, fusion_sweep
    from panopticnerf_tpu_torch.viz.png import write_png

    cfg = make_cfg(args)
    cached, views, step, things, C, ds = cache_gt_views(cfg, args.device)
    sky_class = resolve_sky_class(cfg)
    log(f"rendered {len(views)} GT views (ckpt step {step})")

    rows = fusion_sweep(cached, things, C, [float(b) for b in args.blends.split(",")],
                        sky_rules=("off", "empty", "support", "soft:0.5"), sky_class=sky_class)
    for row in rows:
        log(json.dumps(row))

    os.makedirs(args.out, exist_ok=True)
    h, w = ds.images.shape[1:3]
    misses = []
    for v, c in zip(views, cached):
        sem, inst = fuse_panoptic(
            c["sem_logits"], c["sem_fixed"], c["inst_mass"], c["inst_ids"], c["inst_sem"],
            things, cfg.loss.eval_fixed_blend, sky_rule=cfg.eval.sky_rule, sky_class=sky_class)
        gt_sem = c["gt_sem"]
        valid = (gt_sem != 255) & (gt_sem >= 0) & (gt_sem < C)
        if c["valid"] is not None:
            valid &= c["valid"]
        err, missed = error_map(sem.cpu().numpy(), inst.cpu().numpy(), gt_sem, c["gt_inst"],
                                valid, things, C, v)
        misses += missed
        write_png(os.path.join(args.out, f"errmap_view{v:04d}.png"), err.reshape(h, w, 3))

    misses.sort(key=lambda r: -r["area"])
    log(f"\nunmatched gt thing segments ({len(misses)}):")
    for r in misses[:20]:
        log(json.dumps(r))
    report = {"sweep": rows, "misses": misses, "ckpt_step": int(step)}
    with open(os.path.join(args.out, "report.json"), "w") as f:
        json.dump(report, f, indent=1)
    log(f"\nwrote {args.out}/report.json + error maps")
    return report


if __name__ == "__main__":
    main()
