#!/usr/bin/env python
"""Record one JAX training step of the flagship for the PyTorch port.

    JAX_PLATFORMS=cpu python tools/export_torch_train_step.py [--mode trunk|field|hybrid]

Restores `artifacts/panopticnerf/synthetic_flagship/10000` into a fresh
train state (step 0, Adam moments zero) and reproduces the random numbers
of `train.make_train_step` by walking its key chain from run_train's base
key `key(train.seed + 1)`: fold_in(step) -> split -> `sample_ray_batch`'s
randint draws; the render key -> split 4 -> `guided_z`'s `key_in` / `key_bg`
uniforms and `sample_pdf`'s uniforms. Then it runs the real jitted step
(`model.use_pallas true`, the kernels in interpret mode on the CPU) and,
separately, `jax.grad` of the same loss (asserting that its loss equals the
step's). It writes:

- `artifacts/torch/synthetic_flagship_10000_jax_step.npz`: the draws, the
  training view pool, and per parameter leaf the gradient divided by its
  norm (float16, for cosines) and the sign of the first Adam update (int8);
- `artifacts/torch/synthetic_flagship_10000_jax_step.json`: the step's loss
  terms and stats, `grad_norm`, each leaf's gradient norm, the sign counts.

`--mode field` / `--mode hybrid` run the step with `model.pallas_mode`
set to that mode (the whole-field kernels C / C' in interpret mode) and
write `..._jax_step_<mode>.{npz,json}` with the stats, gradient directions
and update signs only: the draws are the trunk record's (the same key
chain; the script checks that they are equal when that record exists).

The port replays the draws through its own step and compares
(`chip_smoke.py`). `jax_step_draws` and `jax_step_reference` are also used
by the port's CPU parity tests.
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
NPZ = os.path.join(OUT_DIR, "synthetic_flagship_10000_jax_step.npz")
JSON = os.path.join(OUT_DIR, "synthetic_flagship_10000_jax_step.json")


def jax_step_draws(cfg, key, step: int, n_views: int, hw) -> dict:
    """The random numbers `make_train_step` draws at `step` from base key
    `key`, as numpy arrays: group (G,) positions in the view pool, u / v
    (N,) pixel column / row, coarse (N, S_in) (or (N, S) without
    primitives), bg (N, S_bg), fine (N, n_importance), and the density
    noise normals when render.raw_noise_std > 0."""
    import jax

    rc, n, g = cfg.render, cfg.data.n_rays, cfg.data.views_per_batch
    h, w = hw
    k = jax.random.fold_in(key, step)
    k_batch, k_render = jax.random.split(k)
    k1, k2, k3 = jax.random.split(k_batch, 3)
    out = {"group": jax.random.randint(k1, (g,), 0, n_views),
           "u": jax.random.randint(k2, (n,), 0, w),
           "v": jax.random.randint(k3, (n,), 0, h)}
    k_coarse, k_fine, k_nc, k_nf = jax.random.split(k_render, 4)
    if rc.use_primitives:
        s_bg = max(int(round(rc.n_samples * rc.bg_sample_frac)), 1) if rc.bg_sample_frac > 0 else 0
        key_in, key_bg = jax.random.split(k_coarse)
        out["coarse"] = jax.random.uniform(key_in, (n, rc.n_samples - s_bg))
        if s_bg:
            out["bg"] = jax.random.uniform(key_bg, (n, s_bg))
    else:
        out["coarse"] = jax.random.uniform(k_coarse, (n, rc.n_samples))
    if rc.n_importance > 0:
        out["fine"] = jax.random.uniform(k_fine, (n, rc.n_importance))
    if rc.raw_noise_std > 0:
        out["noise_coarse"] = jax.random.normal(k_nc, (n, rc.n_samples))
        out["noise_fine"] = jax.random.normal(k_nf, (n, rc.n_samples + rc.n_importance))
    return {k: np.array(v) for k, v in out.items()}  # writable copies


def jax_step_reference(cfg, model, params, ds, view_ids, key):
    """One real `make_train_step` step from a fresh state on `params`, and
    jax.grad of the same loss. -> (stats, grads, new_params) as numpy
    pytrees; asserts the two losses agree."""
    import jax
    import jax.numpy as jnp

    from panopticnerf_tpu.data.dataset import batch_intervals, sample_ray_batch
    from panopticnerf_tpu.render.renderer import SceneBounds, render_rays
    from panopticnerf_tpu.train import make_train_state, make_train_step
    from panopticnerf_tpu.train.loss import compute_losses
    from panopticnerf_tpu.train.step import resolve_train_model, weight_th_schedule

    state = make_train_state(cfg, model, params)
    step_fn = make_train_step(cfg, model, donate=False)
    new_state, stats = step_fn(state, ds, view_ids, key)

    field = resolve_train_model(cfg, model)
    interpret = jax.default_backend() == "cpu"
    g = cfg.data.views_per_batch

    def loss_fn(p):
        k_batch, k_render = jax.random.split(jax.random.fold_in(key, 0))
        batch = sample_ray_batch(k_batch, ds, view_ids, cfg.data.n_rays, g)
        iv = None
        if cfg.render.use_primitives:
            iv = batch_intervals(ds, batch, cfg.render.near, cfg.render.far,
                                 cfg.data.max_intervals, g,
                                 use_pallas=cfg.render.use_pallas_intersect and g > 0,
                                 pallas_interpret=interpret)
        sem_scale = 0.0 if (cfg.train.pretrain == "nerf" and cfg.train.pretrain_steps > 0) else 1.0
        agree_on = 1.0 if (cfg.loss.agree_filter
                           and int(cfg.loss.agree_start * cfg.train.max_steps) <= 0) else 0.0
        out = render_rays(field, p, batch.rays_o, batch.rays_d,
                          SceneBounds(ds.bounds_center, ds.bounds_scale), k_render, cfg,
                          iv=iv, train=True)
        return compute_losses(out, batch, cfg, sem_scale=sem_scale, agree_on=agree_on,
                              weight_th=weight_th_schedule(cfg, 0))

    (loss, _), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    np.testing.assert_allclose(float(loss), float(stats["loss_total"]), rtol=1e-6)
    to_np = lambda t: jax.tree.map(np.asarray, t)
    return ({k: float(v) for k, v in stats.items()}, to_np(grads), to_np(new_state.params))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        out.update(_flat(v, key) if isinstance(v, dict) else {key: np.asarray(v)})
    return out


def record_paths(mode: str):
    """(npz, json) of the record of `mode` (the trunk record has no suffix)."""
    if mode == "trunk":
        return NPZ, JSON
    return NPZ[:-4] + f"_{mode}.npz", JSON[:-5] + f"_{mode}.json"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mode", choices=("trunk", "field", "hybrid"), default="trunk",
                    help="model.pallas_mode of the recorded step")
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp

    from panopticnerf_tpu import engine
    from panopticnerf_tpu.config import load_config
    from panopticnerf_tpu.data.dataset import train_test_split

    t_start = time.time()
    cfg = load_config(CFG_FILE)
    cfg.model_dir = os.path.join(REPO, "artifacts")
    cfg.model.pallas_mode = args.mode
    npz_path, json_path = record_paths(args.mode)
    ds, _, model, params, ckpt_step = engine._restore_for_eval(cfg)
    train_ids, _ = train_test_split(ds.images.shape[0], cfg.data.test_every)
    key = jax.random.key(cfg.train.seed + 1)  # run_train's base key
    draws = jax_step_draws(cfg, key, 0, len(train_ids), ds.images.shape[1:3])
    stats, grads, new_params = jax_step_reference(cfg, model, params, ds,
                                                  jnp.asarray(train_ids), key)
    g = _flat(grads["params"])
    old, new = _flat(params["params"]), _flat(new_params["params"])
    arrays = {}
    if args.mode == "trunk":
        arrays = {f"draw/{k}": v for k, v in draws.items()}
        arrays["view_ids"] = np.asarray(train_ids, np.int32)
    elif os.path.exists(NPZ):
        with np.load(NPZ) as trunk:
            for k, v in draws.items():
                np.testing.assert_array_equal(trunk[f"draw/{k}"], v, err_msg=k)
    leaf_norms, signs = {}, {"pos": 0, "neg": 0, "zero": 0}
    for name in sorted(g):
        norm = float(np.linalg.norm(g[name].astype(np.float64)))
        leaf_norms[name] = norm
        arrays[f"grad_dir/{name}"] = (g[name] / max(norm, 1e-30)).astype(np.float16)
        s = np.sign(new[name].astype(np.float64) - old[name]).astype(np.int8)
        arrays[f"update_sign/{name}"] = s
        signs["pos"] += int((s > 0).sum())
        signs["neg"] += int((s < 0).sum())
        signs["zero"] += int((s == 0).sum())
    os.makedirs(OUT_DIR, exist_ok=True)
    np.savez_compressed(npz_path, **arrays)
    res = {
        "checkpoint": "artifacts/panopticnerf/synthetic_flagship/10000",
        "checkpoint_step": int(ckpt_step),
        "config": "configs/synthetic_flagship.yaml",
        "pallas_mode": args.mode,
        "draws": os.path.relpath(NPZ, REPO),
        "backend": jax.default_backend(),
        "step": 0,
        "base_key": f"jax.random.key({cfg.train.seed + 1})",
        "lr": float(cfg.train.lr),
        "stats": stats,
        "grad_norm": stats["grad_norm"],
        "leaf_grad_norms": leaf_norms,
        "update_signs": signs,
        "seconds": round(time.time() - t_start, 1),
    }
    with open(json_path, "w") as f:
        json.dump(res, f, indent=1)
        f.write("\n")
    print(f"wrote {npz_path} ({os.path.getsize(npz_path)} bytes) and {json_path}: loss_total "
          f"{stats['loss_total']:.6f}, grad_norm {stats['grad_norm']:.6f}, "
          f"{res['seconds']} s")


if __name__ == "__main__":
    main()
