"""Data parallelism in the port (`panopticnerf_tpu_torch/parallel/`) on the
CPU: ranks are processes joined over gloo by a file:// rendezvous
(tests/torch_parallel_worker.py kills every rank when one fails or runs
past its timeout).

(a) An in-process world of one rank equals the single-process step bit for
    bit in each field mode (plain versions of the kernels), and its tiled
    render and `run_evaluate` equal the single-process ones; `draw_step`
    draws what the lazy sampler and renderer draw.
(b) Four ranks at a small width, first step on the JAX step's recorded
    draws, for G = 8 (whole groups per rank), 2 (a group split across
    ranks) and 0 (fully mixed): the ranks' parameters are bit-equal after
    every step; loss terms and parameters are within 1e-6 relative (atol
    1e-7 on the parameters, for entries near zero) of the single-process
    port step, whose gradient the ranks' summed shares equal but for the
    summation order; and the first step is within
    tests/test_torch_train_step.py's tolerances of JAX's
    `make_parallel_train_step` on a 4-device mesh (GSPMD route).
(c) `run_train` on two ranks writes the recorder lines, the step
    checkpoints, the best checkpoint and its sidecar once; a run stopped
    halfway and resumed equals the straight run bit for bit; a streamed run
    keeps the same windows on both ranks; a SIGTERM sent to one rank stops
    both at the same step with one checkpoint.
(d) The sharded `run_evaluate` on two ranks (384 rays, not a multiple of
    ray_tile 128 x 2) equals the single-process scores and maps bit for
    bit.
(e) data.n_rays not divisible by the world size and a mismatched
    parallel.data_parallel raise on every rank, without a hang.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panopticnerf_tpu.config import load_config as jax_load_config
from panopticnerf_tpu.data.synthetic import build_synthetic_dataset as jax_build
from panopticnerf_tpu.models import init_params as jax_init_params
from panopticnerf_tpu.models import make_network as jax_make_network
from panopticnerf_tpu.parallel import make_mesh as jax_make_mesh
from panopticnerf_tpu.parallel import make_parallel_train_step as jax_parallel_step
from panopticnerf_tpu.train import make_train_state as jax_train_state
from panopticnerf_tpu_torch import engine
from panopticnerf_tpu_torch.config import load_config
from panopticnerf_tpu_torch.convert import flatten, params_from_flax, params_to_flax
from panopticnerf_tpu_torch.data.dataset import (
    BatchDraws,
    batch_intervals,
    sample_ray_batch,
)
from panopticnerf_tpu_torch.data.synthetic import build_synthetic_dataset
from panopticnerf_tpu_torch.models import init_params, make_network
from panopticnerf_tpu_torch.parallel import (
    make_parallel_train_step,
    maybe_init_distributed,
    resolve_world,
)
from panopticnerf_tpu_torch.render import RenderDraws, SceneBounds, render_rays
from panopticnerf_tpu_torch.train import StepDraws, make_train_state, make_train_step
from panopticnerf_tpu_torch.train.checkpoint import all_steps
from panopticnerf_tpu_torch.train.step import draw_step
from test_torch_mixed import _mixed_draws
from test_torch_train_step import STEP, jax_step_draws
from torch_parallel_worker import run_ranks, sigterm_rank_after_first_log
from torch_scenes import engine_opts

QUIET = lambda *a: None


def _world_of_one(tmp_path):
    return maybe_init_distributed("cpu", backend="gloo", init_method=f"file://{tmp_path}/rv",
                                  rank=0, world_size=1, timeout_s=60)


def _same_scores(a, b):
    keys = set(a) - {"render_seconds"}
    return keys == set(b) - {"render_seconds"} and all(
        np.array_equal(np.asarray(a[k]), np.asarray(b[k]), equal_nan=True) for k in keys)


# ---------------------------------------------------------------- (a) one rank


@pytest.mark.parametrize("use_pallas,mode", [("false", "trunk"), ("true", "trunk"),
                                             ("true", "field"), ("true", "hybrid")],
                         ids=["plain", "trunk", "field", "hybrid"])
def test_world_of_one_equals_single_process_step(tmp_path, use_pallas, mode):
    """Three steps with the density noise on: every stat and parameter
    bit-equal, the collectives over one rank included."""
    cfg = load_config(None, STEP + ["model.use_pallas", use_pallas, "model.pallas_mode", mode,
                                    "render.raw_noise_std", "0.5"])
    ds = build_synthetic_dataset(cfg, "cpu", seed=0)
    runs = []
    world = _world_of_one(tmp_path)
    try:
        for parallel in (False, True):
            model = make_network(cfg, "cpu")
            init_params(model, torch.Generator().manual_seed(0))
            state = make_train_state(cfg, model)
            step = (make_parallel_train_step(cfg, model, world) if parallel
                    else make_train_step(cfg, model))
            gen = torch.Generator().manual_seed(1)
            stats = [step(state, ds, torch.arange(4), gen) for _ in range(3)]
            runs.append((stats, model.state_dict()))
    finally:
        world.close()
    (single, p_single), (par, p_par) = runs
    for a, b in zip(single, par):
        assert set(a) == set(b)
        for k in a:
            assert torch.equal(a[k], b[k]), k
    for k in p_single:
        assert torch.equal(p_single[k], p_par[k]), k


def test_world_of_one_render_and_evaluate(tmp_path):
    """The tile-sharded render over one rank is the single-process render,
    and so are `run_evaluate`'s scores."""
    cfg = load_config(None, engine_opts(tmp_path))
    engine.run_train(cfg, "cpu", max_steps=2, log=QUIET)
    ds, _, model, _ = engine._restore_for_eval(cfg, "cpu")
    want_maps = engine._render_view(cfg, model, ds, 1)
    want = engine.run_evaluate(cfg, "cpu", log=QUIET)
    world = _world_of_one(tmp_path)
    try:
        maps = engine._render_view(cfg, model, ds, 1, world)
        got = engine.run_evaluate(cfg, "cpu", log=QUIET, world=world)
    finally:
        world.close()
    for a, b in zip(want_maps, maps):
        assert (a is None and b is None) or torch.equal(a, b)
    assert _same_scores(want, got)


@pytest.mark.parametrize("prims,n_importance,noise", [("true", "8", "0.0"), ("true", "8", "1.0"),
                                                      ("false", "0", "1.0"),
                                                      ("false", "8", "0.0")])
def test_draw_step_is_the_lazy_draws(prims, n_importance, noise):
    """`draw_step` up front gives the batch and render that drawing lazily
    from the same generator gives, and leaves the generator where the lazy
    draws leave it."""
    cfg = load_config(None, STEP + ["render.use_primitives", prims,
                                    "render.n_importance", n_importance,
                                    "render.raw_noise_std", noise])
    ds = build_synthetic_dataset(cfg, "cpu", seed=0)
    model = make_network(cfg, "cpu")
    init_params(model, torch.Generator().manual_seed(0))
    view_ids, n, g = torch.arange(4), cfg.data.n_rays, cfg.data.views_per_batch
    bounds = SceneBounds(ds.bounds_center, ds.bounds_scale)

    def render(batch, **kw):
        iv = None
        if cfg.render.use_primitives:
            iv = batch_intervals(ds, batch, cfg.render.near, cfg.render.far,
                                 cfg.data.max_intervals, g)
        return render_rays(model, batch.rays_o, batch.rays_d, bounds, cfg, iv=iv, train=True,
                           **kw)

    with torch.no_grad():
        lazy_gen = torch.Generator().manual_seed(3)
        lazy_batch = sample_ray_batch(ds, view_ids, n, g, lazy_gen)
        lazy = render(lazy_batch, generator=lazy_gen)
        gen = torch.Generator().manual_seed(3)
        draws = draw_step(cfg, 4, (16, 24), gen, "cpu")
        batch = sample_ray_batch(ds, view_ids, n, g, draws=draws.batch)
        out = render(batch, draws=draws.render)
    assert all(torch.equal(a, b) for a, b in zip(lazy_batch, batch))
    for name, a, b in zip(out._fields, lazy, out):
        if name == "coarse" and a is not None:
            a, b = a.rgb, b.rgb
        assert (a is None and b is None) or torch.equal(a, b), name
    assert torch.equal(lazy_gen.get_state(), gen.get_state())


def test_data_parallel_without_a_launch_raises():
    cfg = load_config(None, STEP + ["parallel.data_parallel", "2"])
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 2"):
        resolve_world(cfg, "cpu")
    assert not resolve_world(load_config(None, STEP), "cpu").distributed


# ---------------------------------------------------------------- (b) four ranks

GROUPS = {"G8": "8", "G2": "2", "G0": "0"}
STEPS = 3


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """Each case on four ranks (one spawn), on the single-process port step,
    and JAX's parallel step on a 4-device mesh."""
    cases, refs = [], {}
    for name, g in GROUPS.items():
        opts = STEP + ["data.views_per_batch", g, "model.use_pallas", "true",
                       "model.pallas_mode", "trunk", "parallel.data_parallel", "4"]
        jcfg = jax_load_config(None, opts + ["model.use_pallas", "false",
                                             "parallel.kernel_shard_map", "false"])
        jmodel = jax_make_network(jcfg)
        params = jax_init_params(jmodel, jax.random.key(0))
        key = jax.random.key(7)
        draws = jax_step_draws(jcfg, key, 0, 4, (16, 24))
        if g == "0":
            k_batch, _ = jax.random.split(jax.random.fold_in(key, 0))
            mixed = _mixed_draws(k_batch, 64, 4, (16, 24))
            draws.update(group=mixed.group.numpy(), u=mixed.u.numpy(), v=mixed.v.numpy())
        port_params = {k: v.numpy() for k, v in
                       params_from_flax(jax.tree.map(np.asarray, params)).items()}
        cases.append({"opts": opts, "params": port_params, "draws": draws, "steps": STEPS})

        mesh = jax_make_mesh(jcfg)
        with pytest.warns(UserWarning, match="intersection kernel disabled"):
            jstep = jax_parallel_step(jcfg, jmodel, mesh, donate=False)
        jstate, jstats = jstep(jax_train_state(jcfg, jmodel, params), jax_build(jcfg, seed=0),
                               jnp.arange(4), key)

        cfg = load_config(None, opts)
        model = make_network(cfg, "cpu")
        model.load_state_dict({k: torch.from_numpy(v) for k, v in port_params.items()})
        state, step = make_train_state(cfg, model), make_train_step(cfg, model)
        ds, gen = build_synthetic_dataset(cfg, "cpu", seed=0), torch.Generator().manual_seed(1)
        t = {k: torch.from_numpy(v) for k, v in draws.items()}
        first = StepDraws(BatchDraws(t["group"], t["u"], t["v"]),
                          RenderDraws(t.get("coarse"), t.get("bg"), t.get("fine")))
        single = []
        for i in range(STEPS):
            stats = step(state, ds, torch.arange(4), gen, first if i == 0 else None)
            single.append(({k: float(v) for k, v in stats.items()},
                           {k: v.numpy().copy() for k, v in model.state_dict().items()}))
        refs[name] = {"single": single, "jax_stats": {k: float(v) for k, v in jstats.items()},
                      "jax_params": flatten(jax.tree.map(np.asarray, jstate.params)["params"])}
    ranks = run_ranks(tmp_path_factory.mktemp("four"), 4, "steps", {"cases": cases})
    return {name: {"ranks": [r[i] for r in ranks], **refs[name]}
            for i, name in enumerate(GROUPS)}


@pytest.mark.parametrize("case", list(GROUPS))
def test_four_ranks_bit_equal_after_every_step(four_ranks, case):
    ranks = four_ranks[case]["ranks"]
    for i in range(STEPS):
        for r in range(1, 4):
            assert ranks[r][i][0] == ranks[0][i][0], (i, r)
            for k, v in ranks[0][i][1].items():
                assert np.array_equal(ranks[r][i][1][k], v), (i, r, k)


@pytest.mark.parametrize("case", list(GROUPS))
def test_four_ranks_match_the_single_process_step(four_ranks, case):
    got, want = four_ranks[case]["ranks"][0], four_ranks[case]["single"]
    for i in range(STEPS):
        for k, v in want[i][0].items():
            if k.startswith("loss_"):
                np.testing.assert_allclose(got[i][0][k], v, rtol=1e-6, err_msg=f"{i} {k}")
        for k, v in want[i][1].items():
            np.testing.assert_allclose(got[i][1][k], v, rtol=1e-6, atol=1e-7,
                                       err_msg=f"{i} {k}")


@pytest.mark.parametrize("case", list(GROUPS))
def test_four_ranks_match_jax_parallel_step(four_ranks, case):
    """The first step against JAX's GSPMD step on the same batch and draws,
    at the tolerances of tests/test_torch_train_step.py."""
    stats, params = four_ranks[case]["ranks"][0][0]
    want = four_ranks[case]["jax_stats"]
    assert set(stats) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(stats[k], v, rtol=1e-4, atol=1e-7, err_msg=k)
    got = params_to_flax({k: torch.from_numpy(v) for k, v in params.items()})
    jp = four_ranks[case]["jax_params"]
    assert set(got) == set(jp)
    for k in jp:
        np.testing.assert_allclose(got[k], np.asarray(jp[k]), rtol=0, atol=2e-5, err_msg=k)


# ---------------------------------------------------------------- (c)-(e) two ranks


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    root = tmp_path_factory.mktemp("two")
    opts = engine_opts(root, max_steps=20, save_ep=2, eval_ep=2, record_interval=5)
    stream = engine_opts(root / "stream", max_steps=8) + [
        "data.stream_window", "3", "data.stream_refresh_steps", "3"]
    bad = [engine_opts(root / "bad") + ["data.n_rays", "63", "data.views_per_batch", "3"],
           engine_opts(root / "bad") + ["parallel.data_parallel", "3"]]
    ranks = run_ranks(root / "ranks", 2, "engine",
                      {"root": str(root), "opts": opts, "stream_opts": stream, "bad_opts": bad})
    cfg = load_config(None, opts + ["model_dir", f"{root}/straight",
                                    "record_dir", f"{root}/straight_rec"])
    return {"ranks": ranks, "cfg": cfg}


def test_two_ranks_write_each_file_once(two_ranks):
    cfg, ranks = two_ranks["cfg"], two_ranks["ranks"]
    rows = [json.loads(line) for line in open(os.path.join(cfg.record_path, "metrics.jsonl"))]
    assert [r["step"] for r in rows] == [5, 10, 15, 20]
    roots = engine.port_roots(cfg)
    assert all_steps(roots.steps) == [10, 20] and all_steps(roots.best) != []
    assert len(os.listdir(roots.best)) == 1
    meta = json.load(open(roots.best_metric))
    assert meta["metric"] == "miou_pq_mean" and all_steps(roots.best) == [meta["step"]]
    a, b = ranks[0]["straight"], ranks[1]["straight"]
    assert a["checkpoint"] == b["checkpoint"] == os.path.join(roots.steps, "20.pt")
    np.testing.assert_array_equal(a["losses"], b["losses"])
    assert [e[0] for e in a["evals"]] == [10, 20]
    for (sa, _, ea), (sb, _, eb) in zip(a["evals"], b["evals"]):
        assert sa == sb and _same_scores(ea, eb)  # the same save_best decisions


def test_two_ranks_resume_equals_straight_run(two_ranks):
    for rank in two_ranks["ranks"]:
        straight, first, resumed = rank["straight"], rank["first"], rank["resumed"]
        assert first["steps"] == 10 and resumed["steps"] == 20
        np.testing.assert_array_equal(first["losses"], straight["losses"][:10])
        np.testing.assert_array_equal(resumed["losses"], straight["losses"][10:])
        for k, v in straight["params"].items():
            assert np.array_equal(resumed["params"][k], v), k


def test_two_ranks_stream_the_same_windows(two_ranks):
    a, b = (r["stream"] for r in two_ranks["ranks"])
    assert [s for s, _ in a] == [0, 3, 6]
    assert len(a) == len(b) and all(sa == sb and np.array_equal(ia, ib)
                                    for (sa, ia), (sb, ib) in zip(a, b))


def test_two_ranks_evaluate_equals_single_process(two_ranks):
    cfg, ranks = two_ranks["cfg"], two_ranks["ranks"]
    assert ranks[1]["evaluate"] is None
    assert _same_scores(ranks[0]["evaluate"], engine.run_evaluate(cfg, "cpu", log=QUIET))
    ds, _, model, _ = engine._restore_for_eval(cfg, "cpu")
    want = engine._render_view(cfg, model, ds, 1)
    assert want.rgb.shape[0] == 384 and cfg.render.ray_tile == 128
    for rank in ranks:
        for a, b in zip(want, rank["maps"]):
            assert (a is None and b is None) or np.array_equal(a.numpy(), b)


def test_two_ranks_visualize_and_network(two_ranks, tmp_path):
    """Rank 0 writes the visualizer's files (the single-process run's names:
    views, trajectory frames, the panorama), rank 1 none; both ranks time
    the data-parallel step."""
    cfg, ranks = two_ranks["cfg"], two_ranks["ranks"]
    single = dataclasses.replace(cfg, result_dir=str(tmp_path))
    want = engine.run_visualize(single, "cpu", log=QUIET, panorama_hw=(8, 16), trajectory=2)
    assert sorted(ranks[0]["visualize"]) == sorted(os.path.relpath(f, single.result_path)
                                                   for f in want)
    assert ranks[1]["visualize"] == [] and len(want) > 0
    assert all(r["network"]["rays_per_sec"] > 0 for r in ranks)


def test_two_ranks_refuse_an_uneven_batch_and_a_wrong_world(two_ranks):
    for rank in two_ranks["ranks"]:
        uneven, wrong = rank["refused"]
        assert uneven is not None and "divisible by the world size 2" in uneven
        assert wrong is not None and "data_parallel=3" in wrong


def test_sigterm_to_one_rank_stops_both_at_one_step(tmp_path):
    opts = engine_opts(tmp_path, max_steps=2000, log_interval=2)
    log_path = str(tmp_path / "rank0.log")
    poke = sigterm_rank_after_first_log(log_path)
    a, b = run_ranks(tmp_path / "ranks", 2, "sigterm", {"opts": opts, "log_path": log_path},
                     poke=poke)
    assert poke.sent, "SIGTERM was never sent"
    assert a["preempted"] and b["preempted"]
    assert a["steps"] == b["steps"] < 2000
    k = a["steps"]
    steps_dir = engine.port_roots(load_config(None, opts)).steps
    assert all_steps(steps_dir) == [k]
    assert a["checkpoint"] == b["checkpoint"] == os.path.join(steps_dir, f"{k}.pt")
    np.testing.assert_array_equal(a["losses"], b["losses"])
    assert f"SIGTERM received: checkpointing at step {k}" in open(log_path).read()
