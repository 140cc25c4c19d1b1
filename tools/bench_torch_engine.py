#!/usr/bin/env python
"""Wall time per training step of the PyTorch port's engine, on one GPU.

    python tools/bench_torch_engine.py [--root DIR] [--steps 300] [--series 60]
        [--cfg_file configs/synthetic_flagship.yaml] [KEY VALUE ...]

`--root` is the repository whose `panopticnerf_tpu_torch` is imported
(default: the one holding this script), so that one call can time two
trees with the same script, in turns. Prints the card's name and power
limit, then one JSON line per reading:

- `recorder`: the seconds of a `Recorder`'s first and second `record`
  (the first makes the TensorBoard writer where one imports), and
  whether it made one;
- `run_train` (`--steps` > 0): `engine.run_train` of `--steps` steps from `init_params`
  into a temporary model_dir, with the config's cadence (the flagship's
  saves every 1000 and evaluates every 500 steps, so 300 steps reach
  neither): ms/step of every log window (host clock between two log
  readbacks, each of which synchronises) and their median after the first;
- `series` (`--series N` > 0): N steps of a fresh state, each timed alone
  and synchronised: ms of steps 1-3 and the medians of steps 2-20 and
  21-N, which show how many steps the card takes to reach its pace;
- `queue`: the throughput probe's loop (`run --type network`: W warm-up
  steps and one synchronisation, then 50 steps and one synchronisation)
  with W = 1 and W = 20, on one fresh state each;
- `run_network`: the tree's own `engine.run_network`, where it has one.

Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--root", default=REPO)
    p.add_argument("--cfg_file", default=os.path.join(REPO, "configs", "synthetic_flagship.yaml"))
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--series", type=int, default=60)
    args, opts = p.parse_known_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    import torch

    from panopticnerf_tpu_torch import engine
    from panopticnerf_tpu_torch.config import load_config
    from panopticnerf_tpu_torch.data import make_dataset
    from panopticnerf_tpu_torch.models import init_params, make_network
    from panopticnerf_tpu_torch.train import make_train_state, make_train_step

    if not torch.cuda.is_available():
        raise SystemExit("bench_torch_engine: no CUDA device")
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"{card}; tree {root}; package {os.path.dirname(engine.__file__)}")
    emit = lambda **kw: print(json.dumps({"tree": root, **kw}), flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        cfg = load_config(args.cfg_file, opts + ["model_dir", tmp, "record_dir", tmp])
        if os.path.exists(os.path.join(root, "panopticnerf_tpu_torch", "train", "recorder.py")):
            from panopticnerf_tpu_torch.train.recorder import Recorder

            rec, secs = Recorder(os.path.join(tmp, "recorder")), []
            for step in (1, 2):
                rec.update({"loss": 1.0}, step=step)
                t0 = time.perf_counter()
                rec.record("train")
                secs.append(time.perf_counter() - t0)
            emit(reading="recorder", first_s=secs[0], second_s=secs[1],
                 tensorboard=rec._tb is not None)
            rec.close()
        if args.steps > 0:
            res = engine.run_train(cfg, dev, max_steps=args.steps, log=lambda *a: None)
            ms = [1000.0 * s / k for k, s in res["windows"]]
            emit(reading="run_train", steps=args.steps, window_ms=ms,
                 median_after_first=float(np.median(ms[1:])))

    def fresh():
        ds, train_ids, _ = make_dataset(cfg, dev)
        model = make_network(cfg, dev)
        init_params(model, torch.Generator(dev).manual_seed(cfg.train.seed))
        state = make_train_state(cfg, model)
        ids = torch.as_tensor(np.asarray(train_ids), device=dev)
        gen = torch.Generator(dev).manual_seed(0)
        step = make_train_step(cfg, model)
        return lambda: step(state, ds, ids, gen)["loss_total"]

    if args.series > 0:
        step, times = fresh(), []
        for _ in range(args.series):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize(dev)
            times.append(1000.0 * (time.perf_counter() - t0))
        emit(reading="series", first_three_ms=times[:3],
             median_2_20_ms=float(np.median(times[1:20])),
             median_21_n_ms=float(np.median(times[20:])), n=args.series)

    for warmup in (1, 20):
        step = fresh()
        for _ in range(warmup):
            loss = step()
        float(loss)
        t0 = time.perf_counter()
        for _ in range(50):
            loss = step()
        float(loss)
        dt = time.perf_counter() - t0
        emit(reading="queue", warmup=warmup, ms_per_step=1000.0 * dt / 50,
             rays_per_sec=cfg.data.n_rays * 50 / dt)

    if hasattr(engine, "run_network"):
        net = engine.run_network(cfg, dev, log=lambda *a: None)
        emit(reading="run_network", rays_per_sec=net["rays_per_sec"],
             ms_per_step=1000.0 / net["iters_per_sec"])


if __name__ == "__main__":
    main()
