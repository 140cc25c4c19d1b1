"""The port's fusion sweep (panopticnerf_tpu_torch/eval/sweep.py) and its two
tools against the JAX package's: `fusion_sweep` rows equal to JAX's for
every rule, blend and sky rule (the case of
tests/test_eval_metrics.py::test_fusion_sweep_sky_rule_grid and a seeded
case with things and stuff), `cache_gt_views` on the tiny synthetic scene
with the same flax-initialised parameters within the render parity
tolerance (tests/test_torch_render_eval.py: atol 1e-4), and
`tools.landing_sweep` / `tools.pq_analysis` end to end on the CPU."""

import json
import os

import jax
import numpy as np
import pytest
import torch

from panopticnerf_tpu.eval.sweep import cache_gt_views as jax_cache
from panopticnerf_tpu.eval.sweep import fusion_sweep as jax_sweep
from panopticnerf_tpu_torch.eval.sweep import cache_gt_views, fusion_sweep
from test_torch_run_staged import one_intra_op_thread  # noqa: F401 (autouse)

FIELDS = ("sem_logits", "sem_fixed", "inst_mass", "inst_ids", "inst_sem")
BLENDS = [0.0, 0.25, 0.5, 0.75, 1.0]
SKY_RULES = ("off", "empty", "support", "soft:0.5")


def _on_torch(cached):
    return [{k: torch.from_numpy(np.asarray(v)) if k in FIELDS else v for k, v in c.items()}
            for c in cached]


def test_sky_rule_grid_case_matches_jax():
    things = np.array([False, True, False, False])
    cached = [dict(
        sem_logits=np.array([[0.0, 0.0, 5.0, 0.0], [5.0, 0.0, 0.0, 0.0]], np.float32),
        sem_fixed=np.array([[0.0, 0.0, 0.0, 0.0], [0.9, 0.0, 0.0, 0.0]], np.float32),
        inst_mass=np.zeros((2, 1), np.float32), inst_ids=np.zeros((2, 1), np.int32),
        inst_sem=np.zeros((2, 1), np.int32),
        gt_sem=np.array([3, 0]), gt_inst=np.array([0, 0]), valid=None)]
    kw = dict(blends=[0.5], rules=("match",), sky_rules=("off", "empty"), sky_class=3)
    rows = fusion_sweep(_on_torch(cached), things, 4, **kw)
    assert rows == jax_sweep(cached, things, 4, **kw)
    by = {r["sky_rule"]: r for r in rows}
    assert by["empty"]["miou"] > by["off"]["miou"]


def _random_cached(seed, views=3, n=600, C=6, K=4):
    rng = np.random.default_rng(seed)
    cached = []
    for v in range(views):
        gt_sem = rng.integers(0, C, n)
        gt_sem[rng.uniform(size=n) < 0.05] = 255
        inst_ids = rng.integers(1, 5, (n, K)).astype(np.int32)
        inst_sem = rng.integers(0, C, (n, K)).astype(np.int32)
        fixed = rng.uniform(size=(n, C)).astype(np.float32) * (rng.uniform(size=(n, 1)) > 0.3)
        mass = rng.uniform(size=(n, K)).astype(np.float32) * (rng.uniform(size=(n, K)) > 0.4)
        cached.append(dict(
            sem_logits=rng.normal(0, 2, (n, C)).astype(np.float32), sem_fixed=fixed,
            inst_mass=mass, inst_ids=inst_ids, inst_sem=inst_sem, gt_sem=gt_sem,
            gt_inst=np.where(np.isin(gt_sem, [1, 3, 4]), rng.integers(1, 5, n), 0),
            valid=(rng.uniform(size=n) > 0.1) if v != 1 else None))
    return cached


@pytest.mark.parametrize("seed", [0, 1])
def test_random_case_matches_jax(seed):
    things = np.array([False, True, False, True, True, False])
    cached = _random_cached(seed)
    kw = dict(blends=BLENDS, rules=("match", "raw"), sky_rules=SKY_RULES, sky_class=0)
    rows = fusion_sweep(_on_torch(cached), things, 6, **kw)
    ref = jax_sweep(cached, things, 6, **kw)
    assert len(rows) == 40 and rows == ref
    assert {r["pq_things"] is None for r in rows} == {False}
    assert len({(r["miou"], r["pq"]) for r in rows}) > 1  # the variants differ


def _tiny(tmp_path):
    """Both packages' tiny synthetic scene with the same flax-initialised
    parameters: the JAX pieces and the port's config over a converted .npz."""
    from panopticnerf_tpu.config import load_config as jax_load_config
    from panopticnerf_tpu.data.synthetic import build_synthetic_dataset as jax_build
    from panopticnerf_tpu.models import init_params, make_network as jax_make_network
    from panopticnerf_tpu_torch.config import load_config
    from panopticnerf_tpu_torch.convert import flatten
    from test_torch_engine_jax import TINY

    jcfg = jax_load_config(None, TINY)
    jmodel = jax_make_network(jcfg)
    params = init_params(jmodel, jax.random.key(5))
    os.makedirs(tmp_path / "torch")
    np.savez(tmp_path / "torch" / "default_4.npz",
             **{k: np.asarray(v) for k, v in flatten(params["params"]).items()})
    cfg = load_config(None, TINY + ["model_dir", str(tmp_path)])
    return jcfg, jmodel, params, jax_build(jcfg, seed=0), cfg


def test_cache_gt_views_matches_jax(tmp_path, monkeypatch):
    from panopticnerf_tpu import engine as jax_engine

    jcfg, jmodel, params, jds, cfg = _tiny(tmp_path)
    monkeypatch.setattr(jax_engine, "_restore_for_eval",
                        lambda c: (jds, np.array([1]), jmodel, params, 4))
    ref, jviews, _, jthings, jC, _ = jax_cache(jcfg)
    cached, views, step, things, C, ds = cache_gt_views(cfg, "cpu")
    assert views == jviews and step == 4 and C == jC and np.array_equal(things, jthings)
    for c, r in zip(cached, ref):
        for name in ("sem_logits", "sem_fixed", "inst_mass"):
            np.testing.assert_allclose(c[name].numpy(), r[name], rtol=0, atol=1e-4, err_msg=name)
        for name in ("inst_ids", "inst_sem", "gt_sem", "gt_inst"):
            assert np.array_equal(np.asarray(c[name]), r[name]), name
        assert c["valid"] is None and r["valid"] is None
    kw = dict(blends=BLENDS, sky_rules=SKY_RULES, sky_class=0)
    rows, jrows = fusion_sweep(cached, things, C, **kw), jax_sweep(ref, jthings, jC, **kw)
    assert [(r["miou"], r["pq"]) for r in rows] == [(r["miou"], r["pq"]) for r in jrows]


def test_the_row_at_the_shipped_fusion_equals_run_evaluate(tmp_path):
    from panopticnerf_tpu_torch import engine
    from panopticnerf_tpu_torch.eval import resolve_sky_class

    *_, cfg = _tiny(tmp_path)
    cached, _, _, things, C, _ = cache_gt_views(cfg, "cpu")
    row, = fusion_sweep(cached, things, C, [cfg.loss.eval_fixed_blend],
                        rules=(cfg.eval.fusion_rule,), sky_rules=(cfg.eval.sky_rule,),
                        sky_class=resolve_sky_class(cfg))
    res = engine.run_evaluate(cfg, "cpu", log=lambda *a: None)
    assert row["miou"] == round(res["miou"], 4) and row["pq"] == round(res["pq"], 4)


def test_landing_sweep_and_pq_analysis_end_to_end(tmp_path):
    from panopticnerf_tpu_torch import engine
    from panopticnerf_tpu_torch.config import load_config
    from panopticnerf_tpu_torch.tools import landing_sweep, pq_analysis
    from panopticnerf_tpu_torch.viz.png import read_png
    from torch_scenes import engine_opts

    opts = engine_opts(tmp_path, "sweep")
    cfg = load_config(None, opts)
    engine.run_train(cfg, "cpu", max_steps=5, log=lambda *a: None)
    cfg_file = tmp_path / "tiny.yaml"
    cfg_file.write_text("task: panopticnerf\n")

    logs = []
    step_root = engine.port_roots(cfg).steps
    out = landing_sweep.main(["--cfg_file", str(cfg_file), "--ckpts", f"a={step_root}",
                              "--blends", "0,0.5,1", "--out", str(tmp_path / "ls.json"),
                              "--device", "cpu", *opts], log=logs.append)
    assert len(out["rows"]) == 3 * 2 * 4 and out["pick"]["ckpt"] == "a"
    assert json.load(open(tmp_path / "ls.json"))["pick"] == out["pick"]
    assert logs[-1].startswith("  python -m panopticnerf_tpu_torch.run --type evaluate")
    assert any(line.startswith("[a] pick: rule=") for line in logs)
    with pytest.raises(SystemExit):
        landing_sweep.main(["--cfg_file", str(cfg_file), "--ckpts", f"a={tmp_path}/x/y",
                            "--device", "cpu", *opts], log=logs.append)

    rep = pq_analysis.main(["--cfg_file", str(cfg_file), "--out", str(tmp_path / "pq"),
                            "--device", "cpu", *opts], log=logs.append)
    report = json.load(open(tmp_path / "pq" / "report.json"))
    assert report["ckpt_step"] == 5 and len(report["sweep"]) == 5 * 2 * 4
    assert report == json.loads(json.dumps(rep))
    pngs = sorted(f for f in os.listdir(tmp_path / "pq") if f.endswith(".png"))
    assert len(pngs) == 6  # one per view with ground truth
    img = read_png(str(tmp_path / "pq" / pngs[0]))
    assert img.shape == (16, 24, 3) and img.dtype == np.uint8
