"""One whole training step of the port against the JAX step, and the
training entry point end to end on the CPU.

The step test builds both models from the same flax init, replays the JAX
step's random numbers (the key chain of `tools/export_torch_train_step.py`)
through the port's step, and compares loss, stats and the updated params
with the tolerances of the JAX package's own use_pallas test
(tests/test_pallas_train_step.py: rtol 1e-4 on the loss, atol 2e-5 on the
params), float32 compute, with the fused trunk, in the whole-field modes
`field` and `hybrid`, and with the plain field.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panopticnerf_tpu.config import load_config as jax_load_config
from panopticnerf_tpu.data.synthetic import build_synthetic_dataset as jax_build
from panopticnerf_tpu.models import init_params as jax_init_params
from panopticnerf_tpu.models import make_network as jax_make_network
from panopticnerf_tpu_torch import engine, run, train_net
from panopticnerf_tpu_torch.config import load_config
from panopticnerf_tpu_torch.convert import flatten, params_from_flax, params_to_flax
from panopticnerf_tpu_torch.data.dataset import BatchDraws
from panopticnerf_tpu_torch.data.synthetic import build_synthetic_dataset
from panopticnerf_tpu_torch.models import init_params, make_network
from panopticnerf_tpu_torch.render import RenderDraws
from panopticnerf_tpu_torch.train import StepDraws, make_train_state, make_train_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

from export_torch_train_step import jax_step_draws, jax_step_reference  # noqa: E402

STEP = [
    "data.synthetic_image_hw", "16,24", "data.synthetic_num_frames", "4",
    "data.synthetic_num_boxes", "3", "data.n_rays", "64", "data.views_per_batch", "4",
    "data.max_primitives", "4", "data.max_intervals", "2", "data.test_every", "0",
    "model.trunk_depth", "3", "model.trunk_width", "32", "model.color_width", "16",
    "model.num_classes", "4", "model.compute_dtype", "float32", "model.skips", "1",
    "render.n_samples", "8", "render.n_importance", "8", "render.near", "0.5",
    "render.far", "40.0", "render.use_primitives", "true",
    "render.use_pallas_intersect", "true",
]


@pytest.mark.parametrize("use_pallas,mode", [("true", "trunk"), ("false", "trunk"),
                                             ("true", "field"), ("true", "hybrid")],
                         ids=["true", "false", "field", "hybrid"])
def test_train_step_matches_jax(use_pallas, mode):
    opts = STEP + ["model.use_pallas", use_pallas, "model.pallas_mode", mode]
    jcfg, cfg = jax_load_config(None, opts), load_config(None, opts)
    jmodel = jax_make_network(jcfg)
    params = jax_init_params(jmodel, jax.random.key(0))
    jds = jax_build(jcfg, seed=0)
    view_ids = np.arange(4)
    key = jax.random.key(7)
    draws = jax_step_draws(jcfg, key, 0, len(view_ids), (16, 24))
    stats, _, new_params = jax_step_reference(jcfg, jmodel, params, jds,
                                              jnp.asarray(view_ids), key)

    model = make_network(cfg, "cpu")
    model.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    ds = build_synthetic_dataset(cfg, "cpu", seed=0)
    state = make_train_state(cfg, model)
    t = lambda k: torch.from_numpy(draws[k]) if k in draws else None
    got = make_train_step(cfg, model)(
        state, ds, torch.from_numpy(view_ids), None,
        StepDraws(BatchDraws(t("group"), t("u"), t("v")),
                  RenderDraws(t("coarse"), t("bg"), t("fine"))))
    assert set(got) == set(stats) and state.step == 1
    for k, want in stats.items():
        np.testing.assert_allclose(float(got[k]), want, rtol=1e-4, atol=1e-7, err_msg=k)
    new = params_to_flax(model.state_dict())
    want = flatten(new_params["params"])
    assert set(new) == set(want)
    for k in want:
        np.testing.assert_allclose(new[k], np.asarray(want[k]), rtol=0, atol=2e-5, err_msg=k)


def test_run_train_cli_then_evaluate(tmp_path):
    """`python -m panopticnerf_tpu_torch.train_net` for 3 steps on the CPU
    writes `<model_dir>/torch/<task>/<exp_name>/3.pt`; the evaluation CLI
    reads it and scores finite metrics. The per-step losses come back
    finite, and the same seed gives the same run (train.resume off, so the
    second run starts afresh)."""
    opts = STEP + ["model.use_pallas", "true", "train.log_interval", "2",
                   "train.resume", "false", "model_dir", str(tmp_path),
                   "record_dir", str(tmp_path / "record")]
    logs = []
    res = engine.run_train(load_config(None, opts), "cpu", max_steps=3, log=logs.append)
    assert res["steps"] == 3 and len(res["losses"]) == 3
    assert np.isfinite(res["losses"]).all()
    assert res["checkpoint"] == str(tmp_path / "torch" / "panopticnerf" / "default" / "3.pt")
    assert os.path.exists(res["checkpoint"]) and not res["preempted"]
    assert sum(line.startswith("step ") for line in logs) == 2    # steps 2 and 3
    again = train_net.main(["--device", "cpu", "--max_steps", "3", *opts])
    np.testing.assert_array_equal(again["losses"], res["losses"])
    ev = run.main(["--type", "evaluate", "--device", "cpu", *opts])
    assert ev["step"] == 3
    assert all(np.isfinite(ev[k]) for k in ("psnr", "miou", "pq"))


def test_step_rejects_mixed_batches():
    """Fully mixed batches (data.views_per_batch 0), once refused, now
    train: finite stats, the same seed gives the same steps, and the batch
    is intersected ray by ray (tests/test_torch_mixed.py holds one step
    against JAX). A grouped batch that does not divide is still refused."""
    cfg = load_config(None, STEP + ["data.views_per_batch", "0", "model.use_pallas", "true"])
    ds = build_synthetic_dataset(cfg, "cpu", seed=0)
    runs = []
    for _ in range(2):
        model = make_network(cfg, "cpu")
        init_params(model, torch.Generator().manual_seed(0))
        state, step = make_train_state(cfg, model), make_train_step(cfg, model)
        gen = torch.Generator().manual_seed(1)
        runs.append([float(step(state, ds, torch.arange(4), gen)["loss_total"])
                     for _ in range(3)])
    assert runs[0] == runs[1] and np.isfinite(runs[0]).all()
    bad = load_config(None, STEP + ["data.views_per_batch", "5"])
    with pytest.raises(ValueError):
        make_train_step(bad, make_network(bad, "cpu"))
