"""The fusion pick table: one command, one row per fusion variant (port of
tools/landing_sweep.py).

    python -m panopticnerf_tpu_torch.tools.landing_sweep \\
        --cfg_file configs/kitti360_panoptic.yaml \\
        --ckpts default=out/trained_model/torch/panopticnerf/exp_a[,nofix=...] \\
        [--blends 0,0.25,0.5,0.75,1] [--metric mean] [--device cuda] [KEY VALUE ...]

For each named checkpoint (a step root of the port,
`<model_dir>/torch/<task>/<exp_name>`, as engine.port_roots names it) it
renders the ground-truth views once, re-fuses them across (rule x blend x
sky rule) and prints every row, the best row per checkpoint and overall by
`--metric`:
  mean  = mean(miou, pq)   (save_best's selection metric)
  pq    = whole-image PQ;  pq_things / pq_stuff = the category splits.
The last line is the override string to pass to `run --type evaluate`. The
views are those the evaluator scores: every view with semantic ground truth.
To compare the train-time `loss.filter_fix2d`, pass two checkpoints trained
with it on and off (`fixf=...,nofix=...`).
"""

from __future__ import annotations

import argparse
import json
import os
import time


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="fusion pick table")
    p.add_argument("--cfg_file", type=str, required=True)
    p.add_argument("--ckpts", type=str, required=True,
                   help="name=dir[,name2=dir2...]; dir is a step root of the port, "
                        "<model_dir>/torch/<task>/<exp_name>")
    p.add_argument("--blends", type=str, default="0,0.25,0.5,0.75,1")
    p.add_argument("--sky_rules", type=str, default="off,empty,support,soft:0.5",
                   help="eval.sky_rule variants to grid over (eval/panoptic.py; soft:<w> is "
                        "the graded support rule)")
    p.add_argument("--metric", type=str, default="mean",
                   choices=["mean", "pq", "pq_things", "pq_stuff", "miou"])
    p.add_argument("--out", type=str, default="out/landing_sweep.json")
    p.add_argument("--device", type=str, default="cuda")
    args, opts = p.parse_known_args(argv)
    for tok in opts:
        if tok.startswith("--"):
            p.error(f"unrecognized flag {tok!r}")
    args.opts = opts
    return args


def score(row, metric):
    if metric == "mean":
        return 0.5 * (row["miou"] + row["pq"])
    v = row.get(metric)
    return -1.0 if v is None else v


def split_step_root(path: str):
    """<model_dir>/torch/<task>/<exp_name> -> (model_dir, task, exp_name)."""
    path = path.rstrip("/")
    exp_name = os.path.basename(path)
    task = os.path.basename(os.path.dirname(path))
    torch_dir = os.path.dirname(os.path.dirname(path))
    if not exp_name or not task or os.path.basename(torch_dir) != "torch":
        raise SystemExit(f"--ckpts dir {path!r} must look like <model_dir>/torch/<task>/<exp_name>")
    return os.path.dirname(torch_dir), task, exp_name


def main(argv=None, log=print) -> dict:
    """Returns {"metric", "rows", "pick"} as written to `--out`."""
    args = parse_args(argv)
    from panopticnerf_tpu_torch.config import make_cfg
    from panopticnerf_tpu_torch.eval import resolve_sky_class
    from panopticnerf_tpu_torch.eval.sweep import cache_gt_views, fusion_sweep

    blends = [float(b) for b in args.blends.split(",")]
    sky_rules = tuple(s.strip() for s in args.sky_rules.split(","))
    all_rows, best = [], None
    for spec in args.ckpts.split(","):
        name, _, path = spec.partition("=")
        if not path:
            raise SystemExit(f"--ckpts entry {spec!r} must be name=dir")
        cfg = make_cfg(args)
        cfg.model_dir, cfg.task, cfg.exp_name = split_step_root(path)
        t0 = time.perf_counter()
        cached, views, step, things, C, _ = cache_gt_views(cfg, args.device)
        t1 = time.perf_counter()
        log(f"[{name}] rendered {len(views)} GT views (step {step}) in {t1 - t0:.3f} s")
        rows = fusion_sweep(cached, things, C, blends, sky_rules=sky_rules,
                            sky_class=resolve_sky_class(cfg))
        log(f"[{name}] fused and scored {len(rows)} variants in "
            f"{time.perf_counter() - t1:.3f} s")
        del cached
        for r in rows:
            r = dict(ckpt=name, step=int(step), **r)
            r["score"] = round(score(r, args.metric), 4)
            all_rows.append(r)
            log(json.dumps(r))
        top = max((r for r in all_rows if r["ckpt"] == name), key=lambda r: r["score"])
        log(f"[{name}] pick: rule={top['rule']} blend={top['blend']} "
            f"sky_rule={top['sky_rule']} ({args.metric}={top['score']})")
        if best is None or top["score"] > best["score"]:
            best = top

    result = {"metric": args.metric, "rows": all_rows, "pick": best}
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    log(f"\nwrote {args.out}")
    log(f"PICK ckpt={best['ckpt']} rule={best['rule']} blend={best['blend']} "
        f"sky_rule={best['sky_rule']} -> evaluate with:")
    rule_flag = "eval.fusion_rule " + best["rule"] + " " if best["rule"] != "match" else ""
    sky_flag = "eval.sky_rule " + best["sky_rule"] + " " if best["sky_rule"] != "off" else ""
    log(f"  python -m panopticnerf_tpu_torch.run --type evaluate --cfg_file {args.cfg_file} "
        f"{rule_flag}{sky_flag}loss.eval_fixed_blend {best['blend']}")
    return result


if __name__ == "__main__":
    main()
