"""The port's checkpoints (train/checkpoint.py, torch format) and recorder
(train/recorder.py): roundtrip of the whole training state, max_to_keep,
read paths that create nothing, strict and partial loads against the JAX
package's `_merge_params`, and the recorder's numbers against the JAX
package's Recorder for the same updates."""

import json
import os
import warnings

import jax
import numpy as np
import pytest
import torch

from panopticnerf_tpu.config import load_config as jax_load_config
from panopticnerf_tpu.models import init_params as jax_init_params
from panopticnerf_tpu.models import make_network as jax_make_network
from panopticnerf_tpu.train.checkpoint import _merge_params as jax_merge_params
from panopticnerf_tpu.train.recorder import Recorder as JaxRecorder
from panopticnerf_tpu.train.recorder import SmoothedValue as JaxSmoothedValue
from panopticnerf_tpu_torch.config import load_config
from panopticnerf_tpu_torch.convert import params_from_flax, save_npz
from panopticnerf_tpu_torch.data import make_dataset
from panopticnerf_tpu_torch.models import init_params, make_network
from panopticnerf_tpu_torch.train import make_train_state, make_train_step
from panopticnerf_tpu_torch.train.checkpoint import (
    all_steps,
    latest_step,
    load_model,
    load_network,
    save_model,
)
from panopticnerf_tpu_torch.train.recorder import Recorder, SmoothedValue

BASE = ["model.trunk_depth", "2", "model.trunk_width", "16", "model.color_width", "8",
        "model.compute_dtype", "float32"]
TRAIN = BASE + [
    "data.synthetic_image_hw", "16,24", "data.synthetic_num_frames", "4",
    "data.synthetic_num_boxes", "3", "data.n_rays", "64", "data.max_primitives", "4",
    "data.max_intervals", "2", "model.num_classes", "4", "render.n_samples", "8",
    "render.n_importance", "8", "render.near", "0.5", "render.far", "40.0",
    "render.use_primitives", "true", "train.ema_decay", "0.9",
]


def _trained_state(seed: int, steps: int = 2):
    """A tiny TrainState after `steps` Adam steps (optimizer moments, step
    count and EMA all non-trivial) and the generator that drew them."""
    cfg = load_config(None, TRAIN)
    ds, train_ids, _ = make_dataset(cfg, "cpu")
    model = make_network(cfg, "cpu")
    init_params(model, torch.Generator().manual_seed(seed))
    state = make_train_state(cfg, model)
    gen = torch.Generator().manual_seed(seed + 1)
    step = make_train_step(cfg, model)
    for _ in range(steps):
        step(state, ds, torch.as_tensor(train_ids), gen)
    return state, gen


def _equal_dicts(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0, msg=k)


def test_checkpoint_roundtrip(tmp_path):
    state, gen = _trained_state(0)
    d = str(tmp_path / "ckpt")
    path = save_model(state, d, step=7, generator=gen)
    assert path == os.path.join(d, "7.pt") and latest_step(d) == 7

    fresh, fresh_gen = _trained_state(5, steps=1)
    restored, step = load_model(fresh, d, generator=fresh_gen)
    assert step == 7 and restored is fresh and fresh.step == state.step == 2
    _equal_dicts(fresh.model.state_dict(), state.model.state_dict())
    _equal_dicts(fresh.ema, state.ema)
    assert torch.equal(fresh_gen.get_state(), gen.get_state())
    a, b = fresh.optimizer.state_dict(), state.optimizer.state_dict()
    assert a["param_groups"] == b["param_groups"]
    for i, st in b["state"].items():
        _equal_dicts(a["state"][i], st)
    params, step = load_network(fresh.model.state_dict(), d, prefer_ema=True)
    assert step == 7
    _equal_dicts(params, state.ema)


def test_checkpoint_max_to_keep(tmp_path):
    state, gen = _trained_state(0, steps=0)
    d = str(tmp_path / "ckpt")
    for s in (1, 2, 3, 4, 5):
        save_model(state, d, step=s, generator=gen, max_to_keep=2)
    assert all_steps(d) == [4, 5] and latest_step(d) == 5
    assert sorted(os.listdir(d)) == ["4.pt", "5.pt"]   # no temporary file left


def test_checkpoint_missing_dir_and_read_paths_create_nothing(tmp_path):
    state, _ = _trained_state(0, steps=0)
    missing = str(tmp_path / "never_saved")
    assert latest_step(missing) is None and all_steps(missing) == []
    restored, step = load_model(state, missing)
    assert restored is state and step is None
    with pytest.raises(FileNotFoundError):
        load_network(state.model.state_dict(), missing)
    with pytest.raises(FileNotFoundError):
        load_network(state.model.state_dict(), missing + ".npz")
    assert not os.path.exists(missing)


def test_checkpoint_ema_mismatch_raises(tmp_path):
    state, gen = _trained_state(0, steps=0)
    save_model(state, str(tmp_path), 1, generator=gen)
    state.ema = None
    with pytest.raises(ValueError, match="EMA"):
        load_model(state, str(tmp_path))


def test_load_network_reads_a_converted_npz(tmp_path):
    state, _ = _trained_state(0, steps=1)
    path = str(tmp_path / "default_40.npz")
    save_npz(path, state.model.state_dict())
    params, step = load_network(state.model.state_dict(), path)
    assert step == 40
    _equal_dicts(params, state.model.state_dict())


def _flax_params(n_importance: int, num_classes: int, seed: int):
    cfg = jax_load_config(None, BASE + ["model.num_classes", str(num_classes),
                                        "render.n_importance", str(n_importance)])
    return jax.tree.map(np.asarray, jax_init_params(jax_make_network(cfg), jax.random.key(seed)))


def _port_model(n_importance: int, num_classes: int):
    cfg = load_config(None, BASE + ["model.num_classes", str(num_classes),
                                    "render.n_importance", str(n_importance)])
    return cfg, make_network(cfg, "cpu")


@pytest.mark.parametrize("n_importance,num_classes,n_warn", [(8, 4, 0), (0, 7, 2)],
                         ids=["coarse_into_coarse_fine", "resized_sem_head"])
def test_partial_merge_matches_jax(tmp_path, n_importance, num_classes, n_warn):
    """A coarse-only checkpoint (4 classes) warm-starts a coarse+fine model
    or one with a resized semantic head: the port copies the same leaves
    as JAX's `_merge_params` on the same trees and warns as often."""
    src = _flax_params(0, 4, seed=1)
    dst = _flax_params(n_importance, num_classes, seed=2)
    cfg1, m1 = _port_model(0, 4)
    m1.load_state_dict(params_from_flax(src))
    save_model(make_train_state(cfg1, m1), str(tmp_path), 5)
    _, m2 = _port_model(n_importance, num_classes)
    m2.load_state_dict(params_from_flax(dst))

    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        ref = jax_merge_params(dst, src)
    with warnings.catch_warnings(record=True) as tw:
        warnings.simplefilter("always")
        got, step = load_network(m2.state_dict(), str(tmp_path), strict=False)
    assert step == 5
    _equal_dicts(got, params_from_flax(ref))
    shape = lambda ws: sum("shape mismatch" in str(w.message) for w in ws)
    assert shape(jw) == shape(tw) == n_warn
    assert any("merged" in str(w.message) for w in tw)   # a partial merge, not a full one
    with pytest.raises(ValueError):   # strict: the topology must match
        load_network(m2.state_dict(), str(tmp_path), strict=True)


def test_partial_merge_with_nothing_matching_raises(tmp_path):
    cfg1, m1 = _port_model(0, 4)
    save_model(make_train_state(cfg1, m1), str(tmp_path), 1)
    with pytest.raises(ValueError, match="0/1"):
        load_network({"other.weight": torch.zeros(2, 2)}, str(tmp_path), strict=False)


UPDATES = [({"loss": 1.0, "psnr": 20.0}, 10), ({"loss": 0.5, "psnr": 22.0}, 20),
           ({"loss": 0.25, "psnr": 23.5, "grad_norm": 3.0}, 30), ({"loss": 0.125}, None)]


@pytest.mark.parametrize("window", [1, 3, 20])
def test_smoothed_value_matches_jax(window):
    a, b = SmoothedValue(window), JaxSmoothedValue(window)
    for v in (1.0, 4.0, 2.0, 8.0, 5.0):
        a.update(v)
        b.update(v)
        assert (a.median, a.avg, a.global_avg, a.count) == (b.median, b.avg, b.global_avg, b.count)


def test_recorder_jsonl_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setattr(Recorder, "_writer", lambda self: None)   # JSONL only, as the JAX side
    port = Recorder(str(tmp_path / "port"))
    ref = JaxRecorder(str(tmp_path / "jax"), use_tensorboard=False)
    for scalars, step in UPDATES:
        for r in (port, ref):
            r.update(scalars, step=step)
            r.record("train")
    line, ref_line = port.log_line(3, 10, 1e-3), ref.log_line(3, 10, 1e-3)
    assert line.split("(")[0] == ref_line.split("(")[0]   # all but the wall time
    port.close()
    port.close()   # idempotent
    ref.close()
    rows = [json.loads(l) for l in open(port.jsonl_path)]
    assert rows == [json.loads(l) for l in open(ref.jsonl_path)]
    assert len(rows) == 4 and rows[-1]["step"] == 30
