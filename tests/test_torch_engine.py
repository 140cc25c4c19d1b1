"""The port's engine around the training step on the CPU, at a tiny size
(tests/torch_scenes.py `engine_opts`): the save and evaluation cadence,
save_best and `train.eval_step -1`, the best metric across a resume (and
a legacy sidecar's reset), EMA evaluation, warm starts (EMA re-seeded,
across a coarse topology change), exact in-process resume, the recorder's
lines, and `run --type network / visualize` (with a panorama)."""

import json
import os
import warnings

import numpy as np
import pytest
import torch

from panopticnerf_tpu_torch import engine, run
from panopticnerf_tpu_torch.config import load_config
from panopticnerf_tpu_torch.train.checkpoint import all_steps
from panopticnerf_tpu_torch.viz.png import read_png
from torch_scenes import engine_opts


def _train(tmp_path, steps, exp_name="enginetest", extra=(), **train):
    cfg = load_config(None, engine_opts(tmp_path, exp_name, **train) + list(extra))
    logs = []
    res = engine.run_train(cfg, "cpu", max_steps=steps, log=logs.append)
    return cfg, res, logs


def test_cadence_save_best_and_eval_step_best(tmp_path):
    """Saves every save_ep epochs and at the end (newest 3 kept), an
    evaluation every eval_ep epochs, the best in a sibling root with its
    sidecar, nothing inside the JAX package's orbax root; `train.eval_step
    -1` evaluates the best step."""
    cfg, res, logs = _train(tmp_path, 20, save_ep=1, eval_ep=2)
    step_root, best_root, meta_path, _ = engine.port_roots(cfg)
    assert all_steps(step_root) == [10, 15, 20] and res["checkpoint"].endswith("20.pt")
    assert [e[0] for e in res["evals"]] == [10, 20]
    assert sum(line.startswith("eval@") for line in logs) == 2
    assert all(np.isfinite(e[2][k]) for e in res["evals"] for k in ("psnr", "miou", "pq"))
    meta = json.load(open(meta_path))
    assert set(meta) == {"value", "step", "metric"} and meta["metric"] == "miou_pq_mean"
    assert all_steps(best_root) == [meta["step"]]
    assert any(f"saved best@{meta['step']}" in line for line in logs)
    assert not os.path.exists(cfg.trained_model_dir)   # the orbax root stays the JAX package's
    assert res["steps"] == 20 and not res["preempted"] and len(res["losses"]) == 20

    best = max(res["evals"], key=lambda e: 0.5 * (e[2]["miou"] + e[2]["pq"]))
    assert best[0] == meta["step"]
    cfg.train.eval_step = -1
    ev = engine.run_evaluate(cfg, "cpu", log=lambda *a: None)
    assert ev["step"] == meta["step"]


def test_best_metric_survives_resume_and_legacy_sidecar_resets(tmp_path):
    cfg, _, _ = _train(tmp_path, 10, "bestresume", eval_ep=1)
    meta_path = engine.port_roots(cfg).best_metric
    kind = json.load(open(meta_path))["metric"]
    json.dump({"value": 1e9, "step": 10, "metric": kind}, open(meta_path, "w"))
    _, res, logs = _train(tmp_path, 20, "bestresume", eval_ep=1, resume="true")
    assert any("resumed from step 10" in line for line in logs)
    assert any("best-metric state restored" in line for line in logs)
    assert not any("saved best@" in line for line in logs)   # nothing beat 1e9
    assert json.load(open(meta_path))["value"] == 1e9
    assert len(res["losses"]) == 10

    # no metric name: written by single-metric selection, so it cannot be
    # compared with the (mIoU + PQ) / 2 mean and selection starts afresh
    json.dump({"value": 1e9, "step": 10}, open(meta_path, "w"))
    _, _, logs = _train(tmp_path, 30, "bestresume", eval_ep=1, resume="true")
    assert any("resetting best state" in line for line in logs)
    assert any("saved best@" in line for line in logs)
    meta = json.load(open(meta_path))
    assert meta["metric"] == kind and meta["value"] < 1e9


def test_ema_through_engine_paths(tmp_path):
    """The in-training evaluation scores the EMA weights (not the raw
    ones), run_evaluate restores them, and a warm start re-seeds the
    average at the loaded weights."""
    cfg, res, _ = _train(tmp_path, 10, "emarun", eval_ep=1, ema_decay=0.9)
    state = res["state"]
    assert state.ema is not None
    raw = {k: v.clone() for k, v in state.model.state_dict().items()}
    assert any(not torch.equal(raw[k], state.ema[k]) for k in raw)

    model = engine.make_network(cfg, "cpu").eval()
    ds, _, test_ids = engine.make_dataset(cfg, "cpu")
    model.load_state_dict(state.ema)
    want = engine.evaluate_views(cfg, model, ds, test_ids)
    got = res["evals"][-1][2]
    assert got["psnr"] == want["psnr"] and got["miou"] == want["miou"]
    for k, v in state.model.state_dict().items():   # the training module is untouched
        assert torch.equal(v, raw[k])

    ev = engine.run_evaluate(cfg, "cpu", log=lambda *a: None)   # prefer_ema restore
    assert ev["step"] == 10
    assert ev["psnr"] == pytest.approx(want["psnr"], abs=0)

    _, res2, logs2 = _train(tmp_path, 3, "emawarm", ema_decay=0.9,
                            init_from=engine.port_roots(cfg).steps)
    assert any("warm-started params from" in line for line in logs2)
    s2 = res2["state"]
    for k, p in s2.model.state_dict().items():   # near the warm weights, not the fresh init
        assert (s2.ema[k] - p).abs().max() < 0.05, k


def test_warm_start_across_coarse_topology(tmp_path):
    """A full-coarse checkpoint warm-starts a proposal-coarse model: the
    fine field merges, the resized coarse trunk keeps its fresh init."""
    cfg, _, _ = _train(tmp_path, 5, "fullcoarse")
    full = engine.port_roots(cfg).steps
    with warnings.catch_warnings(record=True) as ws:
        warnings.simplefilter("always")
        _, res, logs = _train(tmp_path, 3, "propcoarse", init_from=full,
                              extra=["model.coarse_trunk_depth", "1",
                                     "model.coarse_trunk_width", "8"])
    assert any("warm-started" in line for line in logs)
    assert any("merged" in str(w.message) for w in ws), [str(w.message) for w in ws]
    assert np.isfinite(res["losses"]).all()


def test_resume_equals_straight_run(tmp_path):
    """A run saved at step 6 and resumed to 10 equals a straight 10-step run
    bit for bit: every loss, every parameter, the EMA and the optimizer's
    moments (the generator's state, Adam's state and the step count all
    come back)."""
    over = dict(ema_decay=0.9, lr_decay_rate=0.5, max_steps=10)
    _, straight, _ = _train(tmp_path / "a", 10, **over)
    _, first, _ = _train(tmp_path / "b", 6, **over)
    assert first["checkpoint"].endswith("6.pt")
    _, resumed, logs = _train(tmp_path / "b", 10, resume="true", **over)
    assert any("resumed from step 6" in line for line in logs)
    np.testing.assert_array_equal(first["losses"], straight["losses"][:6])
    np.testing.assert_array_equal(resumed["losses"], straight["losses"][6:])
    a, b = straight["state"], resumed["state"]
    assert a.step == b.step == 10
    for k, v in a.model.state_dict().items():
        assert torch.equal(v, b.model.state_dict()[k]), k
        assert torch.equal(a.ema[k], b.ema[k]), k
    for i, st in a.optimizer.state_dict()["state"].items():
        for k, v in st.items():
            assert torch.equal(v, b.optimizer.state_dict()["state"][i][k]), (i, k)

    # a resume at or past the end trains nothing and saves no <max_steps>.pt
    # holding the later step
    cfg, done, logs = _train(tmp_path / "b", 8, resume="true", **over)
    assert any("resumed from step 10" in line for line in logs)
    assert done["steps"] == done["state"].step == 10 and len(done["losses"]) == 0
    assert done["checkpoint"] is None and 8 not in all_steps(engine.port_roots(cfg).steps)


def test_recorder_lines_every_record_interval(tmp_path):
    cfg, _, logs = _train(tmp_path, 20, record_interval=10)
    rows = [json.loads(l) for l in open(os.path.join(cfg.record_path, "metrics.jsonl"))]
    assert [r["step"] for r in rows] == [10, 20] and all(r["prefix"] == "train" for r in rows)
    assert "loss_total" in rows[0] and "rays_per_sec" in rows[0]
    assert sum(line.startswith("epoch ") for line in logs) == 2
    assert sum(line.startswith("step ") for line in logs) == 4   # every log_interval 5


def test_run_cli_network_and_visualize(tmp_path):
    opts = engine_opts(tmp_path)
    net = run.main(["--type", "network", "--device", "cpu", *opts])
    assert net["rays_per_sec"] > 0 and net["iters_per_sec"] > 0

    engine.run_train(load_config(None, opts), "cpu", max_steps=3, log=lambda *a: None)
    files = run.main(["--type", "visualize", "--trajectory", "3", "--device", "cpu", *opts])
    names = sorted(os.path.basename(f) for f in files)
    assert all(os.path.exists(f) for f in files)
    test_views = [1, 4]
    per_view = ["depth", "labelinst", "labelsem", "panoptic", "rgb", "semantic"]
    want = sorted([f"{v:06d}_{k}.png" for v in test_views for k in per_view]
                  + [f"{2_000_000 + i:06d}_{k}.png" for i in range(3)
                     for k in ("depth", "panoptic", "rgb", "semantic")])
    assert [n for n in names if n.endswith(".png")] == want

    # the 360-degree panorama from the middle test view (4), as view 1,000,004
    files = run.main(["--type", "visualize", "--panorama", "8,16", "--device", "cpu", *opts])
    pano = sorted(os.path.basename(f) for f in files if "1000004_" in os.path.basename(f))
    assert pano == [f"1000004_{k}.png" for k in ("depth", "panoptic", "rgb", "semantic")]
    assert read_png([f for f in files if f.endswith("1000004_rgb.png")][0]).shape == (8, 16, 3)
    with pytest.raises(SystemExit):
        run.parse_args(["--type", "visualize", "--trajectoy", "3"])
    with pytest.raises(SystemExit):
        run.parse_args(["--type", "train"])
