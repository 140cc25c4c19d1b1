"""The port's engine against the JAX package's on the CPU:

- the cadence of one tiny run (20 steps, ep_iter 5, save_ep 2, eval_ep 1)
  in both packages: the same saved steps, the same `eval@` steps, the same
  sidecar keys and selection metric;
- the evaluation's valid mask: the same seeded mask on the tiny synthetic
  dataset of both packages, the port's `evaluate_views` and `run_evaluate`
  held against the JAX package's on params converted with
  `convert.params_from_flax`, at the render parity test's tolerances.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panopticnerf_tpu import engine as jax_engine
from panopticnerf_tpu.config import load_config as jax_load_config
from panopticnerf_tpu.data.synthetic import build_synthetic_dataset as jax_build
from panopticnerf_tpu.eval import make_evaluator as jax_make_evaluator
from panopticnerf_tpu.models import init_params, make_network as jax_make_network
from panopticnerf_tpu_torch import engine
from panopticnerf_tpu_torch.config import load_config
from panopticnerf_tpu_torch.convert import flatten, params_from_flax
from panopticnerf_tpu_torch.data.synthetic import build_synthetic_dataset
from panopticnerf_tpu_torch.models import make_network
from panopticnerf_tpu_torch.train.checkpoint import all_steps
from torch_scenes import engine_opts


def test_cadence_matches_jax(tmp_path):
    opts = engine_opts(tmp_path, "cadence", save_ep=2, eval_ep=1)
    jcfg, cfg = jax_load_config(None, opts), load_config(None, opts)
    jlogs, logs = [], []
    jax_engine.run_train(jcfg, max_steps=20, log=jlogs.append)
    engine.run_train(cfg, "cpu", max_steps=20, log=logs.append)

    roots = engine.port_roots(cfg)
    jsteps = sorted(int(x) for x in os.listdir(jcfg.trained_model_dir) if x.isdigit())
    assert all_steps(roots.steps) == jsteps == [10, 20]
    evals = lambda ls: [line.split(":")[0] for line in ls if line.startswith("eval@")]
    assert evals(logs) == evals(jlogs) == ["eval@5", "eval@10", "eval@15", "eval@20"]
    jbest = [x for x in os.listdir(jcfg.best_model_dir) if x.isdigit()]
    assert len(jbest) == len(all_steps(roots.best)) == 1
    jmeta = json.load(open(jcfg.best_metric_path))
    meta = json.load(open(roots.best_metric))
    assert set(meta) == set(jmeta) and meta["metric"] == jmeta["metric"] == "miou_pq_mean"
    assert sum("saved best@" in line for line in logs) >= 1
    assert sum("saved best@" in line for line in jlogs) >= 1


TINY = [
    "data.synthetic_image_hw", "12,16", "data.synthetic_num_frames", "2",
    "data.synthetic_num_boxes", "4", "data.max_primitives", "6",
    "data.max_intervals", "4", "data.test_every", "2",
    "model.trunk_depth", "2", "model.trunk_width", "32", "model.skips", "0",
    "model.color_width", "16", "model.num_classes", "5",
    "model.compute_dtype", "float32",
    "render.n_samples", "8", "render.n_importance", "8", "render.near", "0.5",
    "render.far", "40.0", "render.use_primitives", "true",
    "render.use_pallas_intersect", "true", "render.ray_tile", "128",
]


@pytest.fixture(scope="module")
def masked():
    """Both packages' tiny dataset with one seeded valid mask, the same
    flax-initialised params in each, and the port's model."""
    jcfg, cfg = jax_load_config(None, TINY), load_config(None, TINY)
    jmodel = jax_make_network(jcfg)
    params = init_params(jmodel, jax.random.key(5))
    mask = np.random.default_rng(11).uniform(size=(2, 12, 16)) > 0.35
    jds = jax_build(jcfg, seed=0)._replace(valid_mask=jnp.asarray(mask))
    ds = build_synthetic_dataset(cfg, "cpu", seed=0)._replace(valid_mask=torch.from_numpy(mask))
    model = make_network(cfg, "cpu")
    model.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    model.eval()
    return dict(jcfg=jcfg, cfg=cfg, jmodel=jmodel, params=params, jds=jds, ds=ds,
                model=model, mask=mask)


def _close(res, ref):
    assert abs(res["psnr"] - ref["psnr"]) <= 1e-3
    assert res["miou"] == ref["miou"] and res["pq"] == ref["pq"]
    np.testing.assert_array_equal(res["pq_per_class"], ref["pq_per_class"])
    assert abs(res["ssim"] - ref["ssim"]) <= 1e-3
    assert abs(res["depth_rmse"] - ref["depth_rmse"]) <= 1e-3


def test_evaluate_views_passes_valid_mask_like_jax(masked):
    m = masked
    ref = jax_engine.evaluate_views(m["jcfg"], m["jmodel"], m["params"], m["jds"], [0, 1])
    res = engine.evaluate_views(m["cfg"], m["model"], m["ds"], [0, 1])
    _close(res, ref)
    unmasked = engine.evaluate_views(m["cfg"], m["model"], m["ds"]._replace(valid_mask=None),
                                     [0, 1])
    assert unmasked["psnr"] != res["psnr"]   # the mask reaches the scores


def test_run_evaluate_passes_valid_mask(masked, tmp_path, monkeypatch):
    """run_evaluate on the masked dataset (a converted .npz) against the
    JAX evaluator fed the JAX renders with the same mask (run_evaluate's
    protocol: PSNR and depth on the test views, labels on every view)."""
    m = masked
    flat = {k: np.asarray(v) for k, v in flatten(m["params"]["params"]).items()}
    os.makedirs(tmp_path / "torch")
    np.savez(tmp_path / "torch" / "default_4.npz", **flat)
    real = engine.make_dataset

    def with_mask(cfg, device):
        ds, train_ids, test_ids = real(cfg, device)
        return ds._replace(valid_mask=m["ds"].valid_mask.to(device)), train_ids, test_ids

    monkeypatch.setattr(engine, "make_dataset", with_mask)
    cfg = load_config(None, TINY + ["model_dir", str(tmp_path)])
    res = engine.run_evaluate(cfg, "cpu", log=lambda *a: None)
    assert res["step"] == 4 and res["views"] == [0, 1]

    jds, jcfg = m["jds"], m["jcfg"]
    ev = jax_make_evaluator(jcfg)
    render = jax.jit(lambda p, v: jax_engine._render_view(jcfg, m["jmodel"], p, jds, v))
    for v in (0, 1):
        photo = v == 1   # the test view
        ev.evaluate(render(m["params"], v),
                    np.asarray(jds.images[v], np.float32).reshape(-1, 3) / 255.0 if photo else None,
                    np.asarray(jds.gt_sem[v]).reshape(-1), np.asarray(jds.gt_inst[v]).reshape(-1),
                    valid=m["mask"][v].reshape(-1),
                    gt_depth=np.asarray(jds.depth[v]).reshape(-1) if photo else None,
                    image_hw=(12, 16))
    _close(res, ev.summarize())
