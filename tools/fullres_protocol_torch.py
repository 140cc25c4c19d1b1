#!/usr/bin/env python
"""The full-resolution protocol of configs/kitti360_panoptic.yaml through the
port's entry points, on the card: the demo tree at KITTI-360's 376x1408 (8
stereo frames, 16 boxes and 4 concave L-buildings: 33 convex records, P =
32, F = 8), the staged chain `python -m panopticnerf_tpu_torch.run_staged`
at 2000 steps per stage, then for arms a and b the panoptic stage to 10k
steps with `python -m panopticnerf_tpu_torch.train_net` (warm from the
semantic stage, an evaluation on 8 views every 2000 steps, save_best on
mean(mIoU, PQ)) and `python -m panopticnerf_tpu_torch.run --type evaluate`
of the best checkpoint.

    python tools/fullres_protocol_torch.py --arm a --seed 0 --root DIR [--device cuda]
                                           [--steps 2000] [--long_steps 10000]
                                           [--tree_hw 376,1408] [KEY VALUE ...]

Arms (ARMS): a, the shipped config (`--proposal 4,64`, the panoptic stage's
4x64 coarse); b, the full-coarse control (coarse 0 / 0: the fine field's
8x256 shape); c, the -360 chain (`--fisheye`: the four perspective stages
and kitti360_360 at 2000 steps each, no continuation). KEY VALUE options
go to every stage and the continuation (for example `model.use_pallas false
render.use_pallas_intersect false`, the plain path). Prints the card's name
and power limit, every stage's and evaluation's numbers, and as its last
line one JSON object of all of it: the tree's write time, make_dataset's
build time, ms/step per stage (median of run_train's log windows after the
first), peak device memory (torch.cuda.max_memory_allocated) over each
stage, over the continuation's training and over its evaluation, the
quality at every in-training evaluation, the step save_best picked and
run_evaluate's s/view. The logs go to DIR/<arm>_seed<seed>/.

    python tools/fullres_protocol_torch.py --summarize LOG [LOG ...]

reads the last line of each run's output and holds each arm to its JAX
record (JAX_ROWS) at the save_best selection: the mean over the seeds of
PSNR, mIoU and PQ must lie within the larger of 2x the seeds' standard
deviation and MARGIN of the record (arm c: the kitti360_360 stage's).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from quality_band_torch import card  # noqa: E402  (tools/quality_band_torch.py)

CFG_FILE = os.path.join(REPO, "configs", "kitti360_panoptic.yaml")
TREE = {"frames": 8, "boxes": 16, "concave": 4}
HW = "376,1408"
METRICS = ("psnr", "miou", "pq", "pq_things", "pq_stuff")
# the JAX package's records of each arm at its save_best selection (arm c:
# the last stage), on a v5e: PSNR, mIoU, PQ
JAX_ROWS = {"a": ("BASELINE.md:1210, step 8000", (31.0, 0.988, 0.935)),
            "b": ("BASELINE.md:664, step 6000", (30.3, 0.986, 0.924)),
            "c": ("BASELINE.md:647, kitti360_360", (29.5, 0.977, 0.895))}
MARGIN = (0.5, 0.005, 0.03)
# (run_staged flags, stages of the chain, the continuation's coarse field or
# None, KEY VALUE options of every run)
ARMS = {
    "a": (["--proposal", "4,64"], 3,
          ["model.coarse_trunk_depth", "4", "model.coarse_trunk_width", "64"], []),
    "b": ([], 3, ["model.coarse_trunk_depth", "0", "model.coarse_trunk_width", "0"], []),
    # the demo tree holds one sequence; kitti360_360.yaml lists two
    "c": (["--fisheye"], 0, None, ["data.sequences", "2013_05_28_drive_0000_sync"]),
}


def staged_argv(arm: str, tree: str, steps: int, device: str, opts, hw: str = HW) -> list:
    """The run_staged command line of an arm's chain."""
    flags, stages, _, arm_opts = ARMS[arm]
    return ["--synthesize-tree", tree, "--tree-hw", hw,
            "--tree-frames", str(TREE["frames"]), "--tree-boxes", str(TREE["boxes"]),
            "--tree-concave", str(TREE["concave"]), "--steps", str(steps),
            "--stages", str(stages), *flags, "--device", device, *arm_opts, *opts]


def long_opts(arm: str, tree: str, init_from: str, long_steps: int, hw: str = HW) -> list:
    """The continuation's KEY VALUE options: the tree's presets, the arm's
    coarse field and the protocol's schedule (tools/r5_p64_defense.sh's ARM:
    epochs of 500 steps, an evaluation every 4)."""
    from panopticnerf_tpu_torch.run_staged import tree_presets

    hw = tuple(int(x) for x in hw.split(","))
    return [*tree_presets(tree, TREE["frames"], hw, TREE["boxes"], TREE["concave"]),
            *ARMS[arm][2], "train.pretrain", "", "train.max_steps", str(long_steps),
            "train.epochs", str(long_steps // 500), "train.ep_iter", "500",
            "train.eval_ep", "4", "train.eval_views", "8",
            "train.init_from", init_from, "exp_name", "kitti360_panoptic_10k"]


def _ms_step(windows) -> float:
    return float(np.median([1000.0 * s / k for k, s in windows[1:] or windows]))


def _scores(res: dict) -> dict:
    return {m: float(res[m]) for m in METRICS if m in res}


def _peak_gib(device: str) -> float:
    if not device.startswith("cuda"):
        return float("nan")
    return torch.cuda.max_memory_allocated() / 2**30


def _reset_peak(device: str) -> None:
    if device.startswith("cuda"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()


def run_arm(arm: str, seed: int, root: str, device: str, steps: int, long_steps: int, opts,
            hw: str = HW, log=print) -> dict:
    from panopticnerf_tpu_torch import engine, run, run_staged, train_net
    from panopticnerf_tpu_torch.config import load_config
    from panopticnerf_tpu_torch.data import make_dataset

    d = os.path.join(root, f"{arm}_seed{seed}")
    tree = os.path.join(root, f"tree_{arm}_seed{seed}")
    os.makedirs(d, exist_ok=True)
    common = ["train.seed", str(seed), "model_dir", os.path.join(d, "model"),
              "record_dir", os.path.join(d, "record"), "result_dir", os.path.join(d, "result"),
              *opts]
    out = {"arm": arm, "seed": seed, "opts": list(opts), "stages": []}

    # the chain: the tree's write is what run_chain does before its first line
    t0 = time.perf_counter()
    first = []

    def chain_log(*a):
        if not first:
            first.append(time.perf_counter() - t0)
        print(*a, file=fh, flush=True)

    args = run_staged.parse_args(staged_argv(arm, tree, steps, device, common, hw))
    with open(os.path.join(d, "chain.log"), "w") as fh:
        _reset_peak(device)
        for rec in run_staged.run_chain(args, log=chain_log):
            st = {"name": rec["name"], "train_s": rec["train_seconds"],
                  "eval_s": rec["eval_seconds"], "ms_step": _ms_step(rec["train"]["windows"]),
                  "n_rays": rec["cfg"].data.n_rays, "peak_gib": _peak_gib(device),
                  "eval_s_view": float(np.median(rec["eval"]["render_seconds"])),
                  **_scores(rec["eval"])}
            out["stages"].append(st)
            log(f"{arm} seed {seed} {st['name']}: " + ", ".join(
                f"{k} {v:.4f}" for k, v in st.items() if isinstance(v, float)))
            _reset_peak(device)
    out["tree_s"] = first[0]
    stage_root = engine.port_roots(rec["cfg"]).steps
    cont = ARMS[arm][2] is not None
    # make_dataset's build time: the continuation's config, else the last stage's
    cfg = rec["cfg"]
    if cont:
        lopts = [*long_opts(arm, tree, stage_root, long_steps, hw), *common]
        cfg = load_config(CFG_FILE, lopts)
    _reset_peak(device)
    t0 = time.perf_counter()
    ds, train_ids, test_ids = make_dataset(cfg, device)
    if device.startswith("cuda"):
        torch.cuda.synchronize()
    out["build_s"] = time.perf_counter() - t0
    out["dataset_gib"] = _peak_gib(device)
    out["views"] = {"train": len(train_ids), "test": len(test_ids),
                    "hw": list(ds.images.shape[1:3])}
    del ds
    log(f"{arm} seed {seed}: tree {out['tree_s']:.2f} s, make_dataset of {cfg.exp_name} "
        f"{out['build_s']:.2f} s (peak {out['dataset_gib']:.3f} GiB), views {out['views']}")
    if not cont:
        return out

    argv = ["--cfg_file", CFG_FILE, "--device", device, *lopts]
    _reset_peak(device)
    t0 = time.perf_counter()
    with open(os.path.join(d, "train.log"), "w") as fh, contextlib.redirect_stdout(fh):
        tr = train_net.main(argv)
    out["long"] = {"train_s": time.perf_counter() - t0, "ms_step": _ms_step(tr["windows"]),
                   "peak_gib": _peak_gib(device), "steps": int(tr["steps"]),
                   "evals": [{"step": s, "seconds": secs, **_scores(res)}
                             for s, secs, res in tr["evals"]]}
    with open(engine.port_roots(cfg).best_metric) as f:
        out["long"]["best"] = json.load(f)
    for e in out["long"]["evals"]:
        log(f"{arm} seed {seed} eval@{e['step']}: " + ", ".join(
            f"{k} {v:.4f}" for k, v in e.items() if k != "step"))
    _reset_peak(device)
    t0 = time.perf_counter()
    with open(os.path.join(d, "evaluate.log"), "w") as fh, contextlib.redirect_stdout(fh):
        ev = run.main(["--type", "evaluate", *argv, "train.eval_step", "-1"])
    out["evaluate"] = {"seconds": time.perf_counter() - t0, "step": ev["step"],
                       "views": len(ev["views"]), "s_view": float(np.median(ev["render_seconds"])),
                       "peak_gib": _peak_gib(device), **_scores(ev)}
    log(f"{arm} seed {seed}: {long_steps} steps at {out['long']['ms_step']:.3f} ms/step "
        f"(peak {out['long']['peak_gib']:.2f} GiB), best {out['long']['best']}; run_evaluate of "
        f"the best: {out['evaluate']}")
    return out


def selected(run: dict) -> tuple:
    """(step or stage, PSNR, mIoU, PQ) at an arm's selection: the
    continuation's save_best evaluation, else the chain's last stage."""
    if "long" in run:
        step = run["long"]["best"]["step"]
        row = next(e for e in run["long"]["evals"] if e["step"] == step)
    else:
        step, row = run["stages"][-1]["name"], run["stages"][-1]
    return (step, *(row[m] for m in METRICS[:3]))


def summarize(paths, log=print) -> dict:
    """Each arm's selections, their mean and standard deviation (ddof 1)
    over the seeds, and the criterion against JAX_ROWS."""
    runs = []
    for p in paths:
        with open(p) as fh:
            runs.append(json.loads(fh.read().strip().splitlines()[-1]))
    out = {}
    for arm in sorted({r["arm"] for r in runs}):
        rows = [(r["seed"], r["opts"], *selected(r)) for r in runs if r["arm"] == arm]
        x = np.array([r[3:] for r in rows], np.float64)
        mean = x.mean(0)
        std = x.std(0, ddof=1) if len(x) > 1 else np.zeros(3)
        where, ref = JAX_ROWS[arm]
        allowed = np.maximum(2 * std, MARGIN)
        within = np.abs(mean - ref) <= allowed
        out[arm] = {"runs": rows, "mean": mean.tolist(), "std": std.tolist(), "jax": ref,
                    "allowed": allowed.tolist(), "within": within.tolist()}
        for seed, opts, step, *m in rows:
            log(f"arm {arm} seed {seed} {' '.join(opts)}: selected {step}: PSNR {m[0]:.4f}, "
                f"mIoU {m[1]:.4f}, PQ {m[2]:.4f}")
        log(f"arm {arm}, {len(rows)} run(s): mean " + ", ".join(
            f"{n} {mu:.4f} ± {sd:.4f} (JAX {r}, {where}: |d| {abs(mu - r):.4f} <= {a:.4f}: {w})"
            for n, mu, sd, r, a, w in zip(("PSNR", "mIoU", "PQ"), mean, std, ref, allowed,
                                          within)))
    return out


def main(argv=None):
    if argv is None:
        argv = sys.argv[1:]
    if argv[:1] == ["--summarize"]:
        return summarize(argv[1:])
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arm", choices=sorted(ARMS), required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--root", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tree_hw", default=HW, help="the tree's image size (a smaller one for a "
                    "run on the CPU)")
    ap.add_argument("--steps", type=int, default=2000, help="steps per stage of the chain")
    ap.add_argument("--long_steps", type=int, default=10000, help="the continuation's steps")
    args, opts = ap.parse_known_args(argv)
    for tok in opts:
        if tok.startswith("--"):
            ap.error(f"unrecognized flag {tok!r}")
    if args.device.startswith("cuda"):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    name = card(args.device)
    print(name, flush=True)
    t0 = time.perf_counter()
    out = run_arm(args.arm, args.seed, args.root, args.device, args.steps, args.long_steps, opts,
                  args.tree_hw, log=lambda *a: print(*a, flush=True))
    out.update(card=name, wall_s=time.perf_counter() - t0, steps=args.steps,
               long_steps=args.long_steps)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
