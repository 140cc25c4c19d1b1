#!/usr/bin/env python
"""Record K consecutive training steps of the flagship in the JAX package
and in the PyTorch port, from the same seeded init and with the same
random numbers, and how far the runs drift apart.

    JAX_PLATFORMS=cpu python tools/export_torch_train_trajectory.py [--steps 20] [--n_rays 2048]

Starts from flax's seeded init of configs/synthetic_flagship.yaml
(`init_params(model, key(train.seed))`, as `engine._build` does) and runs
four implementations of the same step side by side, one step each in turn:

- `jax_plain`: the JAX package's jitted `make_train_step(cfg, model,
  donate=False)` with model.use_pallas false (plain XLA);
- `jax_trunk`: the same with model.use_pallas true in the flagship's mode
  trunk (the Pallas kernels in interpret mode on the CPU);
- `port_plain` / `port_trunk`: the port's `make_train_step` on the CPU in
  the same two modes (the plain field; the fused trunk through the plain
  twins of kernels B / B'), its weights converted from the same flax init
  (`convert.params_from_flax`) and, at each step t, JAX's draws of step t
  replayed (`jax_step_draws` from run_train's base key `key(train.seed +
  1)`, as `tools/export_torch_train_step.py` walks it).

It records every stat of every run at every step, and for each pair of
runs (a, b) the parameter drift ||θa - θb|| / ||θb - θ0||: the distance
between the two runs' parameters over how far training moved b's from the
init, over all parameters and as the largest and median leaf's at every
step, and per leaf at the last. The
pair jax_trunk / jax_plain is the floor: two correct implementations of
one step in the reference, which differ only where they round in bf16.

Writes `artifacts/torch/synthetic_flagship_jax_trajectory.json` (stats and
drifts only: no params, no draws); `--n_rays` other than the config's adds
`_rays<N>` to the name. `jax_run`, `port_run` and `drift` are also used by
tests/test_torch_trajectory.py.
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
sys.path.insert(0, os.path.join(REPO, "tools"))

from export_torch_train_step import jax_step_draws  # noqa: E402

CFG_FILE = os.path.join(REPO, "configs", "synthetic_flagship.yaml")
OUT = os.path.join(REPO, "artifacts", "torch", "synthetic_flagship_jax_trajectory.json")
# run name -> model.use_pallas (each in the config's model.pallas_mode)
RUNS = {"jax_plain": "false", "jax_trunk": "true", "port_plain": "false", "port_trunk": "true"}
# (a, b): drift of a from b; the first pair is the floor
PAIRS = (("jax_trunk", "jax_plain"), ("port_plain", "jax_plain"),
         ("port_trunk", "jax_trunk"), ("port_trunk", "port_plain"))


def trajectory_step_draws(jcfg, key, step: int, n_views: int, hw, device="cpu"):
    """JAX's random numbers of step `step` from base key `key` as the port's
    StepDraws, on `device`."""
    import torch

    from panopticnerf_tpu_torch.data.dataset import BatchDraws
    from panopticnerf_tpu_torch.render import RenderDraws
    from panopticnerf_tpu_torch.train import StepDraws

    d = jax_step_draws(jcfg, key, step, n_views, hw)
    t = lambda k: torch.from_numpy(d[k]).to(device) if k in d else None
    return StepDraws(BatchDraws(t("group"), t("u"), t("v")),
                     RenderDraws(t("coarse"), t("bg"), t("fine"), t("noise_coarse"),
                                 t("noise_fine")))


def _flat_np(tree):
    from panopticnerf_tpu_torch.convert import flatten

    return {k: np.asarray(v, np.float32) for k, v in flatten(tree).items()}


def jax_run(jcfg, params, key):
    """Consecutive steps of the JAX package's jitted train step from
    `params` (flax's init): yields, after each step, (stats, params, ema)
    with params / ema flat {"coarse/trunk_0/kernel": array} (ema None when
    train.ema_decay is 0)."""
    import jax

    from panopticnerf_tpu.data import make_dataset
    from panopticnerf_tpu.models import make_network
    from panopticnerf_tpu.train import make_train_state, make_train_step

    ds, train_ids, _ = make_dataset(jcfg)
    model = make_network(jcfg)
    state = make_train_state(jcfg, model, params)
    step_fn = make_train_step(jcfg, model, donate=False)
    view_ids = jax.numpy.asarray(train_ids)
    while True:
        state, stats = step_fn(state, ds, view_ids, key)
        ema = None if state.ema_params is None else _flat_np(state.ema_params["params"])
        yield ({k: float(v) for k, v in stats.items()}, _flat_np(state.params["params"]), ema)


def port_run(cfg, jcfg, params, key, device="cpu"):
    """The same steps in the port: its model loaded with `params`, JAX's
    draws of each step replayed. Yields as `jax_run`."""
    import torch

    from panopticnerf_tpu_torch.convert import params_from_flax, params_to_flax
    from panopticnerf_tpu_torch.data import make_dataset
    from panopticnerf_tpu_torch.models import make_network
    from panopticnerf_tpu_torch.train import make_train_state, make_train_step

    ds, train_ids, _ = make_dataset(cfg, device)
    model = make_network(cfg, device)
    model.load_state_dict(params_from_flax({k: np.asarray(v) for k, v in
                                            _flat_np(params["params"]).items()}))
    state = make_train_state(cfg, model)
    step = make_train_step(cfg, model)
    view_ids = torch.as_tensor(np.asarray(train_ids), device=device)
    hw = tuple(ds.images.shape[1:3])
    t = 0
    while True:
        draws = trajectory_step_draws(jcfg, key, t, len(train_ids), hw, device)
        stats = step(state, ds, view_ids, None, draws)
        t += 1
        # copies: a (1, n) weight's transpose is contiguous and would alias the live tensor
        copy = lambda sd: {k: np.array(v) for k, v in params_to_flax(sd).items()}
        ema = None if state.ema is None else copy(state.ema)
        yield ({k: float(v) for k, v in stats.items()}, copy(model.state_dict()), ema)


def drift(a: dict, b: dict, theta0: dict):
    """-> (||a - b|| / ||b - θ0|| over every leaf together, per leaf: the
    same ratio, None for a leaf training did not move)."""
    num = den = 0.0
    leaves = {}
    for k in sorted(b):
        d = float(np.sum((a[k].astype(np.float64) - b[k]) ** 2))
        m = float(np.sum((b[k].astype(np.float64) - theta0[k]) ** 2))
        num, den = num + d, den + m
        leaves[k] = float(np.sqrt(d / m)) if m > 0 else None
    return float(np.sqrt(num / max(den, 1e-300))), leaves


def stat_gap(a: dict, b: dict) -> dict:
    """Relative gap |a - b| / |b| of every stat (0 where both are 0)."""
    return {k: 0.0 if a[k] == b[k] else abs(a[k] - b[k]) / max(abs(b[k]), 1e-30) for k in b}


def _summary(values):
    vals = [v for v in values if v is not None]
    return {"max": float(max(vals)), "median": float(np.median(vals)), "leaves": len(values),
            "unmoved": len(values) - len(vals)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=20, help="K, consecutive steps per run")
    ap.add_argument("--n_rays", type=int, default=0, help="data.n_rays (0: the config's)")
    ap.add_argument("--runs", default=",".join(RUNS), help="comma-separated subset of runs")
    ap.add_argument("--out", default="", help="output path (default: under artifacts/torch/)")
    args = ap.parse_args(argv)

    import jax
    import torch

    from panopticnerf_tpu.config import load_config as jax_load_config
    from panopticnerf_tpu.models import init_params, make_network
    from panopticnerf_tpu_torch.config import load_config

    names = [r for r in args.runs.split(",") if r]
    extra = ["data.n_rays", str(args.n_rays)] if args.n_rays else []
    out_path = args.out or (OUT if not args.n_rays else OUT[:-5] + f"_rays{args.n_rays}.json")
    t_start = time.time()
    base = jax_load_config(CFG_FILE, extra)
    seed = base.train.seed
    params = init_params(make_network(base), jax.random.key(seed))
    theta0 = _flat_np(params["params"])
    key = jax.random.key(seed + 1)  # run_train's base key
    runs = {}
    for name in names:
        opts = extra + ["model.use_pallas", RUNS[name]]
        jcfg = jax_load_config(CFG_FILE, opts)
        runs[name] = (jax_run(jcfg, params, key) if name.startswith("jax")
                      else port_run(load_config(CFG_FILE, opts), jcfg, params, key))
    pairs = [(a, b) for a, b in PAIRS if a in runs and b in runs]
    stats = {n: {} for n in names}
    secs = {n: [] for n in names}
    glob = {f"{a}/{b}": [] for a, b in pairs}
    leaf_max = {f"{a}/{b}": [] for a, b in pairs}
    leaf_median = {f"{a}/{b}": [] for a, b in pairs}
    gaps = {f"{a}/{b}": {} for a, b in pairs}
    last = {}
    for t in range(args.steps):
        for n in names:
            t0 = time.time()
            s, p, _ = next(runs[n])
            secs[n].append(round(time.time() - t0, 2))
            last[n] = p
            for k, v in s.items():  # float32 values, written in float32's shortest form
                stats[n].setdefault(k, []).append(float(str(np.float32(v))))
        line = []
        for a, b in pairs:
            g, leaves = drift(last[a], last[b], theta0)
            glob[f"{a}/{b}"].append(g)
            summary = _summary(list(leaves.values()))
            leaf_max[f"{a}/{b}"].append(summary["max"])
            leaf_median[f"{a}/{b}"].append(summary["median"])
            for k, v in stat_gap({k: stats[a][k][t] for k in stats[b]},
                                 {k: stats[b][k][t] for k in stats[b]}).items():
                gaps[f"{a}/{b}"].setdefault(k, []).append(v)
            line.append(f"{a}/{b} {g:.3e}")
        print(f"step {t + 1}: loss_total " + " ".join(f"{n} {stats[n]['loss_total'][t]:.6f}"
                                                    for n in names)
              + "; drift " + ", ".join(line) + "; s " + " ".join(f"{secs[n][t]}" for n in names),
              flush=True)
    pair_out = {}
    for a, b in pairs:
        _, leaves = drift(last[a], last[b], theta0)
        g = gaps[f"{a}/{b}"]
        pair_out[f"{a}/{b}"] = {
            "drift_by_step": glob[f"{a}/{b}"],
            "leaf_drift_max_by_step": leaf_max[f"{a}/{b}"],
            "leaf_drift_median_by_step": leaf_median[f"{a}/{b}"],
            "leaf_drift_at_K": leaves,
            "leaf_drift_at_K_summary": _summary(list(leaves.values())),
            "stat_rel_gap_max": {k: float(max(v)) for k, v in g.items()},
            "stat_rel_gap_median": {k: float(np.median(v)) for k, v in g.items()},
        }
    res = {
        "config": "configs/synthetic_flagship.yaml",
        "overrides": extra,
        "n_rays": base.data.n_rays,
        "steps": args.steps,
        "init": f"panopticnerf_tpu.models.init_params(model, jax.random.key({seed}))",
        "base_key": f"jax.random.key({seed + 1})",
        "backend": jax.default_backend(),
        "torch": torch.__version__,
        "runs": {n: {"model.use_pallas": RUNS[n], "model.pallas_mode": base.model.pallas_mode,
                     "seconds_per_step": secs[n], "stats": stats[n]} for n in names},
        "floor": f"{PAIRS[0][0]}/{PAIRS[0][1]}",
        "pairs": pair_out,
        "seconds": round(time.time() - t_start, 1),
    }
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(res, f)
        f.write("\n")
    print(f"wrote {out_path} ({os.path.getsize(out_path)} bytes) in {res['seconds']} s")
    for p, v in pair_out.items():
        print(f"  {p}: drift at K {v['drift_by_step'][-1]:.4e}, per leaf max "
              f"{v['leaf_drift_at_K_summary']['max']:.4e} median "
              f"{v['leaf_drift_at_K_summary']['median']:.4e}; stat gap max "
              + ", ".join(f"{k} {x:.2e}" for k, x in sorted(v["stat_rel_gap_max"].items())))


if __name__ == "__main__":
    main()
