#!/usr/bin/env python
"""Device time by op of the PyTorch port's training step, on one GPU.

    python tools/profile_torch_step.py [--cfg_file configs/synthetic_flagship.yaml]
        [--warmup 20] [--steps 10] [KEY VALUE ...]

Builds the config's dataset and model from `init_params` on the first CUDA
device, takes `--warmup` steps, times `--steps` steps, then records
`--steps` more under `torch.profiler` (CPU + CUDA activity) and prints: the
card's name and power limit, the wall time per step of the timed steps
(host clock, synchronised) with the card's SM clock, power draw and
temperature read right after them, the device time of all kernels per step
and its share of the wall time (the device's busy share), the caching
allocator's device allocations, frees, retries and stream syncs over the
timed steps, then the rows
with the most self device time: kernels, and the operators (aten ops,
autograd Functions, the optimizer step) whose kernels they include, so
those two kinds of row overlap; then the rows with the most self CPU time
(the host's side of the step) and every CUDA runtime call's count and
self CPU time per step. Fails without a CUDA device.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--cfg_file", default=os.path.join(REPO, "configs", "synthetic_flagship.yaml"))
    p.add_argument("--warmup", type=int, default=20)
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--top", type=int, default=25)
    args, opts = p.parse_known_args(argv)

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from panopticnerf_tpu_torch.config import load_config
    from panopticnerf_tpu_torch.data import make_dataset
    from panopticnerf_tpu_torch.models import init_params, make_network
    from panopticnerf_tpu_torch.train import make_train_state, make_train_step

    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_step: no CUDA device")
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())
    cfg = load_config(args.cfg_file, opts)
    ds, train_ids, _ = make_dataset(cfg, dev)
    model = make_network(cfg, dev)
    init_params(model, torch.Generator(dev).manual_seed(cfg.train.seed))
    state = make_train_state(cfg, model)
    step = make_train_step(cfg, model)
    view_ids = torch.as_tensor(np.asarray(train_ids), device=dev)
    gen = torch.Generator(dev).manual_seed(cfg.train.seed + 1)
    for _ in range(args.warmup):
        step(state, ds, view_ids, gen)
    torch.cuda.synchronize()

    mem0 = torch.cuda.memory_stats(dev)
    t0 = time.perf_counter()
    for _ in range(args.steps):
        step(state, ds, view_ids, gen)
    torch.cuda.synchronize()
    wall_ms = 1000.0 * (time.perf_counter() - t0) / args.steps
    mem1 = torch.cuda.memory_stats(dev)
    churn = {k: mem1.get(k, 0) - mem0.get(k, 0) for k in
             ("num_device_alloc", "num_device_free", "num_alloc_retries", "num_sync_all_streams")}
    card = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(args.steps):
            step(state, ds, view_ids, gen)
        torch.cuda.synchronize()
    from torch.autograd import DeviceType

    dev_us = lambda e: e.self_device_time_total
    events = sorted((e for e in prof.key_averages() if dev_us(e) > 0), key=lambda e: -dev_us(e))
    kernel_ms = sum(dev_us(e) for e in events
                    if e.device_type == DeviceType.CUDA) / 1000.0 / args.steps
    print(f"steps {args.steps} after {args.warmup} warm-up: wall {wall_ms:.3f} ms/step "
          f"(unprofiled; SM clock, power, temperature after them: {card}), kernels "
          f"{kernel_ms:.3f} ms/step ({100.0 * kernel_ms / wall_ms:.1f} % of the wall time)")
    print("caching allocator over the timed steps: " + ", ".join(f"{k} {v}" for k, v in
                                                                  churn.items()))
    for e in events[:args.top]:
        ms = dev_us(e) / 1000.0 / args.steps
        kind = "kernel" if e.device_type == DeviceType.CUDA else "op"
        print(f"  {ms:8.3f} ms/step {100.0 * ms / kernel_ms:5.1f} %  {kind:6s} "
              f"x{e.count // args.steps:<4d} {e.key[:90]}")
    host = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    host_ms = sum(e.self_cpu_time_total for e in host) / 1000.0 / args.steps
    print(f"host: {host_ms:.3f} ms/step of self CPU time in profiled rows; the most:")
    for e in host[:args.top // 2]:
        print(f"  {e.self_cpu_time_total / 1000.0 / args.steps:8.3f} ms/step  "
              f"x{e.count // args.steps:<4d} {e.key[:90]}")
    print("CUDA runtime calls (where the host can wait on the device): " + "; ".join(
        f"{e.key} x{e.count / args.steps:g} {e.self_cpu_time_total / 1000.0 / args.steps:.3f} ms"
        for e in host if e.key.startswith("cuda")))


if __name__ == "__main__":
    main()
