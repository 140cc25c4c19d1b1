"""Streaming (data.stream_window) in the port against the JAX package and
against the port's own unstreamed runs, on the CPU at a tiny size:

- `HostViews.window` field for field equal to the reference's (every
  optional field present, and with some absent);
- `ViewWindowStreamer`'s window ids over 5 advances equal the reference's
  for the same seed and pool (a sub-pool, and a window larger than it);
- a streamed `run_train` refreshes at the configured steps, logs each
  refresh, and every batch reads the resident window, whose views equal
  their host slice bit for bit;
- the in-training evaluation on the window of test views, `run_evaluate`
  and `run_visualize` (with a panorama) score and write as unstreamed runs;
- a streamed run stopped by max_steps or SIGTERM and resumed (across a
  refresh, and exactly at one) equals the uninterrupted run bit for bit;
- a failing upload makes `advance()` raise, with the cause.
"""

import os
import signal

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panopticnerf_tpu.data import dataset as jds_mod
from panopticnerf_tpu.data import stream as jstream
from panopticnerf_tpu_torch import engine, run
from panopticnerf_tpu_torch.config import load_config
from panopticnerf_tpu_torch.data import make_dataset
from panopticnerf_tpu_torch.data import stream as tstream
from panopticnerf_tpu_torch.data.dataset import DeviceDataset
from panopticnerf_tpu_torch.models import make_network
from panopticnerf_tpu_torch.train import eval_state_dict
from panopticnerf_tpu_torch.train import step as step_module
from torch_scenes import engine_opts

STREAM = ["data.stream_window", "3", "data.stream_refresh_steps", "2"]


def _pools(drop=()):
    """The same seeded 10-view pool as a JAX and a port DeviceDataset, every
    optional field present except those in `drop`."""
    rng = np.random.default_rng(0)
    v, h, w, p, f = 10, 6, 8, 5, 3
    arrays = dict(
        images=rng.integers(0, 256, (v, h, w, 3), dtype=np.uint8),
        K=rng.normal(size=(v, 3, 3)).astype(np.float32),
        c2w=rng.normal(size=(v, 3, 4)).astype(np.float32),
        pseudo=rng.integers(0, 20, (v, h, w)).astype(np.int32),
        depth=rng.uniform(-1, 30, (v, h, w)).astype(np.float32),
        prim_w2p=rng.normal(size=(v, p, 3, 4)).astype(np.float32),
        prim_sem=rng.integers(0, 19, (v, p)).astype(np.int32),
        prim_inst=rng.integers(0, 900, (v, p)).astype(np.int32),
        prim_valid=rng.uniform(size=(v, p)) > 0.3,
        bounds_center=rng.normal(size=3).astype(np.float32),
        bounds_scale=np.float32(0.05),
        gt_sem=rng.integers(0, 256, (v, h, w)).astype(np.int32),
        gt_inst=rng.integers(0, 50, (v, h, w)).astype(np.int32),
        prim_planes=rng.normal(size=(v, p, f, 4)).astype(np.float32),
        cam_model=rng.integers(0, 2, v).astype(np.int32),
        fisheye=rng.normal(size=(v, 7)).astype(np.float32),
        valid_mask=rng.uniform(size=(v, h, w)) > 0.2,
    )
    for k in drop:
        arrays[k] = None
    jds = jds_mod.DeviceDataset(**{k: None if a is None else jnp.asarray(a)
                                   for k, a in arrays.items()})
    tds = DeviceDataset(**{k: None if a is None else torch.from_numpy(np.array(a))
                           for k, a in arrays.items()})
    return jds, tds


@pytest.mark.parametrize("drop", [(), ("gt_sem", "gt_inst", "prim_planes", "cam_model",
                                       "fisheye", "valid_mask")])
def test_host_views_window_matches_jax(drop):
    jds, tds = _pools(drop)
    ids = np.array([7, 2, 5])
    ref = jstream.HostViews.from_device(jds).window(ids)
    got = tstream.HostViews(tds, "cpu").window(ids)
    assert got._fields == ref._fields
    for name in got._fields:
        a, b = getattr(ref, name), getattr(got, name)
        assert (a is None) == (b is None), name
        if a is not None:
            a = np.asarray(a)
            assert b.dtype == torch.from_numpy(np.array(a)).dtype and b.shape == a.shape, name
            np.testing.assert_array_equal(b.numpy(), a, err_msg=name)
    # the window is a copy: writing to it leaves the pool alone
    got.images.zero_()
    assert bool(tds.images[7].any())


@pytest.mark.parametrize("window,include,seed", [(4, None, 0), (3, [0, 2, 3, 5, 7, 8], 3),
                                                 (12, None, 1), (7, [1, 4, 6], 2)],
                         ids=["pool", "subpool", "window>pool", "window>subpool"])
def test_streamer_draws_jax_window_ids(window, include, seed):
    jds, tds = _pools()
    inc = None if include is None else np.array(include)
    ref = jstream.ViewWindowStreamer(jstream.HostViews.from_device(jds), window, seed=seed,
                                     include=inc)
    got = tstream.ViewWindowStreamer(tstream.HostViews(tds, "cpu"), window, seed=seed,
                                     include=inc)
    want_ids, ids = [ref.current()[1]], [got.current()[1]]
    for _ in range(5):
        want_ids.append(ref.advance()[1])
        ids.append(got.advance()[1])
    for a, b in zip(want_ids, ids):
        np.testing.assert_array_equal(b, a)
    assert got.refreshes == ref.refreshes == 5 and len(got.blocked) == 5 and all(got.ready)
    ds, now = got.current()
    assert torch.equal(ds.images, tds.images[torch.from_numpy(now)])
    # skip: the sequence from its third window on, without their uploads
    later = tstream.ViewWindowStreamer(tstream.HostViews(tds, "cpu"), window, seed=seed,
                                       include=inc, skip=2)
    np.testing.assert_array_equal(later.current()[1], ids[2])
    np.testing.assert_array_equal(later.advance()[1], ids[3])
    for st in (got, later):
        st.close()


def test_failing_upload_reraises():
    _, tds = _pools()
    host = tstream.HostViews(tds, "cpu")
    good = host.window
    calls = []

    def flaky(ids):  # the first window uploads, the prefetched one fails
        calls.append(ids)
        if len(calls) > 1:
            raise OSError("the pool's disk went away")
        return good(ids)

    host.window = flaky
    st = tstream.ViewWindowStreamer(host, 4, seed=0)
    with pytest.raises(RuntimeError, match="upload of the next view window") as err:
        st.advance()
    assert isinstance(err.value.__cause__, OSError)


# ---------------------------------------------------------------- run_train


def _opts(root, *extra, **train):
    return engine_opts(root, **train) + STREAM + list(extra)


def test_streamed_run_train_refreshes_in_window(tmp_path, monkeypatch):
    """7 steps, windows of 3 of the 4 training views redrawn at steps 2, 4,
    6: the reference's window sequence, one refresh line each, and every
    step's batch drawn from the resident window."""
    seen = []
    sample = step_module.sample_ray_batch

    def spy(ds, view_ids, *a, **k):
        batch = sample(ds, view_ids, *a, **k)
        seen.append((ds, view_ids.clone(), batch.view.clone()))
        return batch

    monkeypatch.setattr(step_module, "sample_ray_batch", spy)
    cfg = load_config(None, _opts(tmp_path))
    logs = []
    res = engine.run_train(cfg, "cpu", max_steps=7, log=logs.append)
    pool, train_ids, _ = make_dataset(cfg, "cpu")
    rng = np.random.default_rng(cfg.train.seed)
    want = [np.sort(rng.choice(train_ids, 3, replace=False)) for _ in range(4)]
    windows = res["stream"]["windows"]
    assert [s for s, _ in windows] == [0, 2, 4, 6]
    for (_, ids), w in zip(windows, want):
        np.testing.assert_array_equal(ids, w)
    refresh = [line for line in logs if line.startswith("stream window refresh")]
    assert [line.split(":")[0] for line in refresh] == [
        "stream window refresh #1 @step 2", "stream window refresh #2 @step 4",
        "stream window refresh #3 @step 6"]
    assert len(res["stream"]["blocked"]) == 3 and all(res["stream"]["ready"])
    assert len(seen) == 7 and np.isfinite(res["losses"]).all()
    for step, (ds, view_ids, views) in enumerate(seen):
        ids = torch.from_numpy(want[step // 2])
        assert torch.equal(view_ids, torch.arange(3)) and int(views.max()) < 3
        for name in ("images", "c2w", "K", "prim_w2p", "pseudo", "depth"):
            assert torch.equal(getattr(ds, name), getattr(pool, name)[ids]), (step, name)


def test_window_larger_than_the_pool_trains_on_the_pool(tmp_path):
    cfg = load_config(None, _opts(tmp_path, "data.stream_window", "10"))
    res = engine.run_train(cfg, "cpu", max_steps=3, log=lambda *a: None)
    _, train_ids, _ = make_dataset(cfg, "cpu")
    assert all(np.array_equal(ids, train_ids) for _, ids in res["stream"]["windows"])
    assert np.isfinite(res["losses"]).all()


def _same_scores(a: dict, b: dict) -> bool:
    """Evaluator summaries equal, value for value (arrays too; NaN equal to
    NaN), host timings aside."""
    keys = set(a) - {"render_seconds"}
    return keys == set(b) - {"render_seconds"} and all(
        np.array_equal(np.asarray(a[k]), np.asarray(b[k]), equal_nan=True) for k in keys)


def test_streamed_evaluation_scores_as_unstreamed(tmp_path):
    """The in-training evaluation reads the test views from their own
    window (renumbered); it scores as an evaluation of the same weights on
    the unstreamed dataset. `run_evaluate` and `run_visualize` (panorama
    included) on the checkpoint give the same scores and the same files at
    data.stream_window 3 and 0, and `run_network` times the first window."""
    opts = _opts(tmp_path, eval_ep=1)
    res = engine.run_train(load_config(None, opts), "cpu", max_steps=5, log=lambda *a: None)
    (step, _, streamed), = res["evals"]
    flat = load_config(None, opts + ["data.stream_window", "0"])
    ds, _, test_ids = make_dataset(flat, "cpu")
    model = make_network(flat, "cpu").eval()
    model.load_state_dict(eval_state_dict(res["state"]))
    assert step == 5 and _same_scores(streamed, engine.evaluate_views(flat, model, ds, test_ids))

    scores = [run.main(["--type", "evaluate", "--device", "cpu", *o])
              for o in (opts, opts + ["data.stream_window", "0"])]
    assert _same_scores(*scores) and scores[0]["step"] == 5 and "psnr" in scores[0]
    files = {}
    for window in ("3", "0"):
        out = tmp_path / f"viz{window}"
        written = run.main(["--type", "visualize", "--panorama", "4,8", "--device", "cpu", *opts,
                            "data.stream_window", window, "result_dir", str(out)])
        files[window] = {os.path.relpath(f, out): open(f, "rb").read() for f in written}
    assert files["3"] == files["0"] and any("1000004_" in f for f in files["3"])
    net = run.main(["--type", "network", "--device", "cpu", *opts])
    assert net["rays_per_sec"] > 0


@pytest.fixture(scope="module")
def straight(tmp_path_factory):
    root = tmp_path_factory.mktemp("straight")
    return engine.run_train(load_config(None, _opts(root, max_steps=8)), "cpu", max_steps=8,
                            log=lambda *a: None)


@pytest.mark.parametrize("how,stop", [("max_steps", 3), ("max_steps", 4), ("sigterm", 4)],
                         ids=["across-a-refresh", "at-a-refresh", "sigterm-at-a-refresh"])
def test_streamed_resume_equals_straight_run(straight, tmp_path, monkeypatch, how, stop):
    """Stopped at `stop` (refreshes at 2, 4, 6) and resumed to 8: the same
    windows from the resume on, the same losses and parameters bit for bit
    as the uninterrupted run."""
    opts = _opts(tmp_path, max_steps=8)
    if how == "sigterm":
        make_step = engine.make_train_step

        def stopping(cfg, model):  # SIGTERM during step `stop` - 1
            step_fn, calls = make_step(cfg, model), [0]

            def step(*a, **k):
                out = step_fn(*a, **k)
                calls[0] += 1
                if calls[0] == stop:
                    signal.raise_signal(signal.SIGTERM)
                return out
            return step

        monkeypatch.setattr(engine, "make_train_step", stopping)
        first = engine.run_train(load_config(None, opts), "cpu", max_steps=8, log=lambda *a: None)
        assert first["preempted"] and first["steps"] == stop
        monkeypatch.undo()
    else:
        first = engine.run_train(load_config(None, opts), "cpu", max_steps=stop,
                                 log=lambda *a: None)
    logs = []
    resumed = engine.run_train(load_config(None, opts + ["train.resume", "true"]), "cpu",
                               max_steps=8, log=logs.append)
    assert any(f"resumed from step {stop}" in line for line in logs)
    np.testing.assert_array_equal(first["losses"], straight["losses"][:stop])
    np.testing.assert_array_equal(resumed["losses"], straight["losses"][stop:])
    in_force = [(s, ids) for s, ids in straight["stream"]["windows"] if s <= stop][-1][1]
    got = resumed["stream"]["windows"]
    np.testing.assert_array_equal(got[0][1], in_force)
    want = [(s, ids) for s, ids in straight["stream"]["windows"] if s > stop]
    assert [s for s, _ in got[1:]] == [s for s, _ in want]
    for (_, a), (_, b) in zip(got[1:], want):
        np.testing.assert_array_equal(a, b)
    for k, v in straight["state"].model.state_dict().items():
        assert torch.equal(v, resumed["state"].model.state_dict()[k]), k
