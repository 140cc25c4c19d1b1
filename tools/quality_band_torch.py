#!/usr/bin/env python
"""The seeded quality band of the port's training on the card: for each
variant and seed, `python -m panopticnerf_tpu_torch.train_net` on
configs/synthetic_flagship.yaml as shipped (3000 steps), then `python -m
panopticnerf_tpu_torch.run --type evaluate` on the checkpoint it wrote.

    python tools/quality_band_torch.py [--variants plain,trunk,field,hybrid] [--seeds 0,1,2]
                                       [--root DIR] [--device cuda] [KEY VALUE ...]

Variants: `plain` (model.use_pallas and render.use_pallas_intersect off:
no kernel), `trunk`, `field` and `hybrid` (model.pallas_mode; kernels A2
and B / B', C / C' or C'). train.seed seeds the init, the draws and the
synthetic scene alike, so each seed is its own scene: a kernel mode is
compared with plain on the same seed. Prints each run's PSNR / mIoU / PQ,
ms/step (median of run_train's log windows after the first) and wall
seconds, then each variant's mean, standard deviation and range over the
seeds and its mean difference from plain, beside the card's name and power
limit; the last line is one JSON object of all of it. Each run's training
log goes to <root>/<variant>_seed<s>/train.log (root: a temporary
directory unless --root is given).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

CFG_FILE = os.path.join(REPO, "configs", "synthetic_flagship.yaml")
VARIANTS = {
    "plain": ["model.use_pallas", "false", "render.use_pallas_intersect", "false"],
    "trunk": ["model.pallas_mode", "trunk"],
    "field": ["model.pallas_mode", "field"],
    "hybrid": ["model.pallas_mode", "hybrid"],
}
METRICS = ("psnr", "miou", "pq")


def card(device: str) -> str:
    """The card's name and power limit as nvidia-smi gives them ('cpu' off the card)."""
    if not device.startswith("cuda"):
        return "cpu"
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def one_run(variant: str, seed: int, root: str, device: str, extra) -> dict:
    """train_net then run --type evaluate for one variant and seed."""
    from panopticnerf_tpu_torch import run, train_net

    d = os.path.join(root, f"{variant}_seed{seed}")
    os.makedirs(d, exist_ok=True)
    args = ["--cfg_file", CFG_FILE, "--device", device, *VARIANTS[variant], *extra,
            "train.seed", str(seed), "train.resume", "false", "model_dir", d,
            "record_dir", os.path.join(d, "record"), "result_dir", os.path.join(d, "result")]
    t0 = time.perf_counter()
    with open(os.path.join(d, "train.log"), "w") as fh, contextlib.redirect_stdout(fh):
        tr = train_net.main(args)
    train_s = time.perf_counter() - t0
    ms = [1000.0 * s / k for k, s in tr["windows"][1:]]
    t0 = time.perf_counter()
    with open(os.path.join(d, "evaluate.log"), "w") as fh, contextlib.redirect_stdout(fh):
        ev = run.main(["--type", "evaluate", *args])
    out = {"variant": variant, "seed": seed, "steps": int(tr["steps"]), "eval_step": ev["step"],
           **{m: float(ev[m]) for m in METRICS}, "ms_step": float(np.median(ms)),
           "train_s": train_s, "evaluate_s": time.perf_counter() - t0,
           "final_loss_total": float(tr["losses"][-1])}
    if not all(np.isfinite(out[m]) for m in METRICS) or out["eval_step"] != out["steps"]:
        raise RuntimeError(f"{variant} seed {seed}: bad evaluation {out}")
    return out


def bands(rows, variants):
    """Per variant and metric: mean, standard deviation (ddof 1), min, max
    over the seeds, and the mean of the per-seed difference from plain."""
    by = {(r["variant"], r["seed"]): r for r in rows}
    seeds = sorted({r["seed"] for r in rows})
    out = {}
    for v in variants:
        out[v] = {}
        for m in METRICS + ("ms_step",):
            x = np.array([by[v, s][m] for s in seeds])
            b = {"mean": float(x.mean()), "std": float(x.std(ddof=1)) if len(x) > 1 else 0.0,
                 "min": float(x.min()), "max": float(x.max())}
            if v != "plain" and "plain" in variants:
                b["minus_plain"] = float(np.mean([by[v, s][m] - by["plain", s][m] for s in seeds]))
            out[v][m] = b
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--seeds", default="0,1,2")
    ap.add_argument("--root", default="", help="model dirs go here (default: a temporary one)")
    ap.add_argument("--device", default="cuda")
    args, extra = ap.parse_known_args(argv)
    variants = [v for v in args.variants.split(",") if v]
    seeds = [int(s) for s in args.seeds.split(",") if s]
    device_name = card(args.device)
    print(device_name, flush=True)
    rows = []
    with (contextlib.nullcontext(args.root) if args.root else tempfile.TemporaryDirectory()) as root:
        for seed in seeds:
            for v in variants:
                r = one_run(v, seed, root, args.device, extra)
                rows.append(r)
                print(f"{v:6s} seed {seed}: PSNR {r['psnr']:.4f}  mIoU {r['miou']:.4f}  "
                      f"PQ {r['pq']:.4f}  {r['ms_step']:.3f} ms/step  train {r['train_s']:.1f} s  "
                      f"evaluate {r['evaluate_s']:.1f} s  final loss {r['final_loss_total']:.5f}",
                      flush=True)
    b = bands(rows, variants)
    for v in variants:
        print(f"{v:6s} over seeds {seeds}: " + "; ".join(
            f"{m} {b[v][m]['mean']:.4f} ± {b[v][m]['std']:.4f} [{b[v][m]['min']:.4f}, "
            f"{b[v][m]['max']:.4f}]" + (f" (vs plain {b[v][m]['minus_plain']:+.4f})"
                                        if "minus_plain" in b[v][m] else "")
            for m in METRICS + ("ms_step",)))
    print(json.dumps({"card": device_name, "config": "configs/synthetic_flagship.yaml",
                      "overrides": extra, "seeds": seeds, "runs": rows, "bands": b}))


if __name__ == "__main__":
    main()
