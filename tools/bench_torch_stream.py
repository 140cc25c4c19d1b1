#!/usr/bin/env python
"""Streamed against unstreamed training of configs/kitti360_360.yaml on one
GPU, in interleaved runs: does the window upload hide behind the steps?

    python tools/bench_torch_stream.py [--frames 32] [--steps 100] [--pairs 2]
        [--refresh 25] [KEY VALUE ...]

Writes two fisheye demo sequences (seeds 0 and 1, KITTI-360's 376x1408, 8
boxes and 2 concave buildings) into a temporary root, then runs
`engine.run_train` of `--steps` steps from a seeded init, alternating
data.stream_window 64 (S) and 0 (U) as S U U S ..., `--pairs` of each,
with train.log_interval 5, data.stream_refresh_steps `--refresh` and
train.pretrain_steps 50. Prints the card's name and power limit, then one
JSON line per run: `ms` of every 5-step log window after the first (host
clock between two log readbacks, each of which synchronises), their
median, and for a streamed run the median of the windows that hold a
refresh and of those that do not, and each `advance()`'s host seconds
waited and whether its copy was already done on the device.

Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

LOG_INTERVAL = 5


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--frames", type=int, default=32)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--pairs", type=int, default=2)
    p.add_argument("--refresh", type=int, default=25)
    args, opts = p.parse_known_args(argv)

    import torch

    from panopticnerf_tpu_torch import engine
    from panopticnerf_tpu_torch.config import load_config
    from panopticnerf_tpu_torch.data.demo_tree import write_demo_tree

    cfg_file = os.path.join(REPO, "configs", "kitti360_360.yaml")
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    with tempfile.TemporaryDirectory() as tmp:
        for i, seq in enumerate(load_config(cfg_file, []).data.sequences):
            write_demo_tree(f"{tmp}/tree", n_frames=args.frames, hw=(376, 1408), n_boxes=8,
                            seed=i, seq=seq, fisheye=True, n_concave=2, frame_start=3353,
                            device=dev)
        order = ["S", "U", "U", "S"] * args.pairs
        for k, mode in enumerate(order[:2 * args.pairs]):
            cfg = load_config(cfg_file, [
                "data.root", f"{tmp}/tree", "data.frame_num", str(args.frames),
                "data.stream_window", "64" if mode == "S" else "0",
                "data.stream_refresh_steps", str(args.refresh), "train.pretrain_steps", "50",
                "train.log_interval", str(LOG_INTERVAL), "model_dir", f"{tmp}/m{k}",
                "record_dir", f"{tmp}/rec{k}", "result_dir", f"{tmp}/res", *opts])
            res = engine.run_train(cfg, dev, max_steps=args.steps, log=lambda *a: None)
            ends = np.cumsum([n for n, _ in res["windows"]])
            ms = {int(e): 1000.0 * s / n for e, (n, s) in zip(ends, res["windows"])}
            ms.pop(int(ends[0]))  # the first window warms up
            line = {"run": k, "mode": mode, "ms": [round(v, 3) for v in ms.values()],
                    "median": round(float(np.median(list(ms.values()))), 3)}
            if mode == "S":
                swaps = [s for s, _ in res["stream"]["windows"][1:]]
                holds = lambda e: any(e - LOG_INTERVAL <= s < e for s in swaps)
                line["median_refresh"] = round(float(np.median(
                    [v for e, v in ms.items() if holds(e)])), 3)
                line["median_other"] = round(float(np.median(
                    [v for e, v in ms.items() if not holds(e)])), 3)
                line["blocked_ms"] = [round(1e3 * b, 4) for b in res["stream"]["blocked"]]
                line["ready"] = res["stream"]["ready"]
            print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
