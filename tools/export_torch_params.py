#!/usr/bin/env python
"""Export the committed flagship checkpoint for the PyTorch port.

    JAX_PLATFORMS=cpu python tools/export_torch_params.py [--views 0,4] [--skip-eval]

1. Restores `artifacts/panopticnerf/synthetic_flagship/10000` with orbax and
   writes its flax parameter tree as a flat `.npz` (keys such as
   `coarse/trunk_0/kernel`) to `artifacts/torch/synthetic_flagship_10000.npz`.
   The PyTorch package cannot read orbax; `panopticnerf_tpu_torch.convert`
   turns this file into a `state_dict`.
2. Evaluates the same checkpoint with this package's evaluation path (the
   loop of `engine.run_evaluate`, with the intersection kernel in interpret
   mode on the CPU) and writes PSNR / mIoU / PQ per view and overall to
   `artifacts/torch/synthetic_flagship_10000_jax_eval.json` — the reference
   the port's evaluation is held against. `--views` limits the evaluation
   to a named subset; the JSON records which views it covers.

The output directory is a sibling of `artifacts/panopticnerf/`, never inside
the orbax step root (orbax scans that root for step directories).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

CFG_FILE = os.path.join(REPO, "configs", "synthetic_flagship.yaml")
OUT_DIR = os.path.join(REPO, "artifacts", "torch")
NPZ = os.path.join(OUT_DIR, "synthetic_flagship_10000.npz")
EVAL_JSON = os.path.join(OUT_DIR, "synthetic_flagship_10000_jax_eval.json")


def flatten(tree, prefix: str = "") -> dict:
    """Nested param dict -> {"a/b/c": np.ndarray}."""
    flat = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            flat.update(flatten(v, key))
        else:
            flat[key] = np.asarray(v)
    return flat


def load_cfg():
    from panopticnerf_tpu.config import load_config

    cfg = load_config(CFG_FILE)
    cfg.model_dir = os.path.join(REPO, "artifacts")
    return cfg


def export_params(cfg) -> dict:
    from panopticnerf_tpu import engine

    _, _, _, params, step = engine._restore_for_eval(cfg)
    flat = flatten(params["params"])
    os.makedirs(OUT_DIR, exist_ok=True)
    np.savez(NPZ, **flat)
    print(f"wrote {NPZ}: {len(flat)} arrays, "
          f"{sum(a.size for a in flat.values())} params (step {step})")
    return flat


def _metrics(res: dict) -> dict:
    return {k: float(res[k]) for k in ("psnr", "miou", "pq") if k in res}


def evaluate_reference(cfg, views_arg: str | None) -> dict:
    """The loop of engine.run_evaluate, plus a per-view Evaluator."""
    import jax

    from panopticnerf_tpu import engine
    from panopticnerf_tpu.eval import make_evaluator

    ds, test_ids, model, params, step = engine._restore_for_eval(cfg)
    render = jax.jit(lambda p, v: engine._render_view(cfg, model, p, ds, v))
    has_gt = np.asarray((ds.gt_sem != 255).any(axis=(1, 2)))
    views = sorted(set(np.nonzero(has_gt)[0].tolist()) | set(int(v) for v in test_ids))
    if views_arg:
        keep = [int(v) for v in views_arg.split(",")]
        views = [v for v in views if v in keep]
    psnr_views = set(int(v) for v in test_ids)

    overall = make_evaluator(cfg)
    per_view = {}
    hw = ds.images.shape[1:3]
    for view in views:
        t0 = time.time()
        out = jax.block_until_ready(render(params, int(view)))
        dt = time.time() - t0
        gt_rgb = (np.asarray(ds.images[view], np.float32).reshape(-1, 3) / 255.0
                  if view in psnr_views else None)
        gt_sem = np.asarray(ds.gt_sem[view]).reshape(-1)
        gt_inst = np.asarray(ds.gt_inst[view]).reshape(-1)
        gt_depth = (np.asarray(ds.depth[view]).reshape(-1)
                    if view in psnr_views else None)
        one = make_evaluator(cfg)
        for ev in (overall, one):
            ev.evaluate(out, gt_rgb, gt_sem, gt_inst, gt_depth=gt_depth,
                        image_hw=hw)
        per_view[str(view)] = _metrics(one.summarize())
        print(f"view {view}: {per_view[str(view)]} ({dt:.1f} s on the CPU)",
              flush=True)
    return {
        "checkpoint": "artifacts/panopticnerf/synthetic_flagship/10000",
        "step": int(step),
        "config": "configs/synthetic_flagship.yaml",
        "backend": jax.default_backend(),
        "views": views,
        "psnr_views": sorted(v for v in views if v in psnr_views),
        "per_view": per_view,
        "overall": _metrics(overall.summarize()),
    }


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--views", default=None,
                   help="comma-separated view ids to evaluate (default: all "
                        "views run_evaluate renders)")
    p.add_argument("--skip-eval", action="store_true",
                   help="write the .npz only")
    args = p.parse_args()
    cfg = load_cfg()
    export_params(cfg)
    if args.skip_eval:
        return
    t0 = time.time()
    res = evaluate_reference(cfg, args.views)
    res["seconds"] = round(time.time() - t0, 1)
    with open(EVAL_JSON, "w") as f:
        json.dump(res, f, indent=1)
        f.write("\n")
    print(f"wrote {EVAL_JSON}: overall {res['overall']}")


if __name__ == "__main__":
    main()
