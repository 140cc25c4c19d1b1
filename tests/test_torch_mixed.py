"""Fully mixed batches (data.views_per_batch 0) and the evaluation's keep-M
truncation (render.eval_keep_samples) of the port against the JAX package,
on the same numpy-seeded inputs:

- `intersect_rays_per_ray` (a primitive table per ray) against the
  reference's, with cut planes, P < K and exact entry-depth ties: masks and
  labels equal, depths within atol 1e-5 (tests/test_torch_intersect.py's
  tolerance for the same slab test);
- `sample_ray_batch` / `batch_intervals` at views_per_batch 0 with the
  reference's draws: rays within 1e-6, intervals as above but atol 1e-4 (the
  batch's directions carry their own ulps, as in test_torch_train.py);
- one mixed training step against the JAX step, at
  tests/test_torch_train_step.py's tolerances;
- `topm_eval_select` bit for bit (ties, zero-mass rays, -0.0 weights,
  m >= S), and the order its stable sorts share with `jax.lax.sort` on
  signed zeros and NaNs;
- a keep-M render of whole views within atol 1e-4, the tolerance of
  tests/test_torch_render_eval.py's render parity, but depth within 5e-4:
  coarse weights that tie to float32 summation order can keep a different
  sample of negligible weight, which moves a ~10 m depth by up to 1.6e-4
  while rgb moves by 7e-6 (read on this test's seeds).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panopticnerf_tpu import engine as jax_engine
from panopticnerf_tpu.config import load_config as jax_load_config
from panopticnerf_tpu.data import dataset as jds_mod
from panopticnerf_tpu.data.synthetic import build_synthetic_dataset as jax_build
from panopticnerf_tpu.models import init_params as jax_init_params
from panopticnerf_tpu.models import make_network as jax_make_network
from panopticnerf_tpu.ops import intersect as jint
from panopticnerf_tpu.ops import sampling as jsamp
from panopticnerf_tpu_torch import engine
from panopticnerf_tpu_torch.config import load_config
from panopticnerf_tpu_torch.convert import flatten, params_from_flax, params_to_flax
from panopticnerf_tpu_torch.data import dataset as tds_mod
from panopticnerf_tpu_torch.data.synthetic import build_synthetic_dataset
from panopticnerf_tpu_torch.models import make_network
from panopticnerf_tpu_torch.ops import intersect as tint
from panopticnerf_tpu_torch.ops import sampling as tsamp
from panopticnerf_tpu_torch.render import RenderDraws
from panopticnerf_tpu_torch.train import StepDraws, make_train_state, make_train_step
from test_torch_train_step import STEP, jax_step_draws, jax_step_reference
from torch_scenes import random_boxes, random_rays

T = lambda a: torch.from_numpy(np.array(a))  # a writable copy
NEAR, FAR = 0.5, 40.0


def _assert_intervals(got, ref, atol):
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(ref.mask))
    np.testing.assert_array_equal(got.semantic.numpy(), np.asarray(ref.semantic))
    np.testing.assert_array_equal(got.instance.numpy(), np.asarray(ref.instance))
    np.testing.assert_allclose(got.t_in.numpy(), np.asarray(ref.t_in), rtol=0, atol=atol)
    np.testing.assert_allclose(got.t_out.numpy(), np.asarray(ref.t_out), rtol=0, atol=atol)
    assert got.semantic.dtype == torch.int32 and got.mask.dtype == torch.bool


# ---------------------------------------------------------------- per-ray intersection


@pytest.mark.parametrize("p,f,k,dup", [
    (12, 0, 4, 0),    # K < P
    (12, 4, 8, 0),    # cut planes
    (5, 0, 16, 0),    # P < K: the padded tail slots
    (10, 0, 6, 4),    # duplicated primitives: exact entry-depth ties
    (6, 3, 12, 3),    # ties with cut planes, P < K
])
def test_intersect_rays_per_ray_matches_jax(p, f, k, dup):
    """Each of 96 rays against one of 3 seeded tables (its view's), as the
    mixed batch gathers them."""
    rng = np.random.default_rng(100 + p + f + k + dup)
    tables, centers = zip(*(random_boxes(rng, p, f, dup) for _ in range(3)))
    o, d = random_rays(rng, 96, np.concatenate(centers), n_away=8)
    which = rng.integers(0, 3, 96)
    fields = [np.stack([t[i] for t in tables])[which] for i in range(4)]
    planes = None if f == 0 else np.stack([t[4] for t in tables])[which]
    ref = jint.intersect_rays_per_ray(
        jnp.asarray(o), jnp.asarray(d),
        jint.Primitives(*map(jnp.asarray, fields),
                        None if planes is None else jnp.asarray(planes)), NEAR, FAR, k)
    got = tint.intersect_rays_per_ray(
        T(o), T(d), tint.Primitives(*map(T, fields), None if planes is None else T(planes)),
        NEAR, FAR, k)
    _assert_intervals(got, ref, 1e-5)
    assert bool(got.mask.any()) and not bool(got.mask.all())
    if k > p:
        assert not bool(got.mask[:, p:].any())


# ---------------------------------------------------------------- the mixed batch


@pytest.fixture(scope="module")
def small():
    opts = STEP + ["data.views_per_batch", "0"]
    jcfg, cfg = jax_load_config(None, opts), load_config(None, opts)
    return dict(jcfg=jcfg, cfg=cfg, jds=jax_build(jcfg, seed=0),
                ds=build_synthetic_dataset(cfg, "cpu", seed=0))


def _mixed_draws(key, n, n_views, hw):
    """sample_ray_batch's randint draws at views_per_batch 0: a view
    position per ray, then the pixel columns and rows."""
    k1, k2, k3 = jax.random.split(key, 3)
    return tds_mod.BatchDraws(T(jax.random.randint(k1, (n,), 0, n_views)),
                              T(jax.random.randint(k2, (n,), 0, hw[1])),
                              T(jax.random.randint(k3, (n,), 0, hw[0])))


def test_mixed_batch_and_intervals_match_jax(small):
    jds, ds = small["jds"], small["ds"]
    view_ids = np.array([0, 2, 3])
    key = jax.random.key(11)
    jb = jds_mod.sample_ray_batch(key, jds, jnp.asarray(view_ids), 64, 0)
    tb = tds_mod.sample_ray_batch(ds, T(view_ids), 64, 0, draws=_mixed_draws(key, 64, 3, (16, 24)))
    for name, a, b in zip(tb._fields, jb, tb):
        a = np.asarray(a)
        if a.dtype.kind in "iub":
            np.testing.assert_array_equal(b.numpy(), a, err_msg=name)
        else:
            np.testing.assert_allclose(b.numpy(), a, rtol=0, atol=1e-6, err_msg=name)
    assert len(set(tb.view.tolist())) == 3  # the rays mix every pool view
    jiv = jds_mod.batch_intervals(jds, jb, NEAR, FAR, 2, 0)
    tiv = tds_mod.batch_intervals(ds, tb, NEAR, FAR, 2, 0)
    _assert_intervals(tiv, jiv, 1e-4)
    assert bool(tiv.mask.any())
    # use_kernel does not apply to the per-ray path; a generator draws a batch
    for a, b in zip(tds_mod.batch_intervals(ds, tb, NEAR, FAR, 2, 0, use_kernel=False), tiv):
        assert torch.equal(a, b)
    g = torch.Generator().manual_seed(0)
    drawn = tds_mod.sample_ray_batch(ds, T(view_ids), 64, 0, g)
    assert drawn.view.shape == (64,) and set(drawn.view.tolist()) <= set(view_ids.tolist())


@pytest.mark.parametrize("mode", ["trunk", "field"])
def test_mixed_train_step_matches_jax(mode):
    """One step on a fully mixed batch with the reference's draws, through
    the fused field of `mode` (plain B / B' or C / C' on the CPU); the
    tolerances of tests/test_torch_train_step.py."""
    opts = STEP + ["data.views_per_batch", "0", "model.use_pallas", "true",
                   "model.pallas_mode", mode]
    jcfg, cfg = jax_load_config(None, opts), load_config(None, opts)
    jmodel = jax_make_network(jcfg)
    params = jax_init_params(jmodel, jax.random.key(0))
    jds = jax_build(jcfg, seed=0)
    view_ids = np.arange(4)
    key = jax.random.key(7)
    draws = jax_step_draws(jcfg, key, 0, len(view_ids), (16, 24))
    k_batch, _ = jax.random.split(jax.random.fold_in(key, 0))
    batch = _mixed_draws(k_batch, 64, len(view_ids), (16, 24))
    stats, _, new_params = jax_step_reference(jcfg, jmodel, params, jds,
                                              jnp.asarray(view_ids), key)

    model = make_network(cfg, "cpu")
    model.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    state = make_train_state(cfg, model)
    t = lambda k: torch.from_numpy(draws[k]) if k in draws else None
    got = make_train_step(cfg, model)(
        state, build_synthetic_dataset(cfg, "cpu", seed=0), torch.from_numpy(view_ids), None,
        StepDraws(batch, RenderDraws(t("coarse"), t("bg"), t("fine"))))
    assert set(got) == set(stats) and state.step == 1
    for k, want in stats.items():
        np.testing.assert_allclose(float(got[k]), want, rtol=1e-4, atol=1e-7, err_msg=k)
    new = params_to_flax(model.state_dict())
    want = flatten(new_params["params"])
    for k in want:
        np.testing.assert_allclose(new[k], np.asarray(want[k]), rtol=0, atol=2e-5, err_msg=k)


# ---------------------------------------------------------------- keep-M


def _keep_inputs(seed, n=48, sc=12, sf=10, zero_rays=6):
    """Sorted coarse depths, their bin edges and interior weights (with
    exact ties, -0.0 entries and rays of zero mass), and the merged set."""
    rng = np.random.default_rng(seed)
    z = np.sort(rng.uniform(0.5, 40.0, (n, sc)), 1).astype(np.float32)
    mid = (0.5 * (z[:, 1:] + z[:, :-1])).astype(np.float32)
    w = rng.choice([0.0, 0.25, 0.5, 1.0], (n, sc - 2)) * rng.uniform(0.5, 1.0, (n, 1))
    w = w.astype(np.float32)
    w[:zero_rays] = 0.0
    w[zero_rays:2 * zero_rays] = -0.0
    w[::7, ::3] = -0.0
    fine = np.sort(rng.uniform(0.5, 40.0, (n, sf)), 1).astype(np.float32)
    fine[:, :2] = z[:, 3:5]  # merged depths equal to coarse ones
    z_all = np.sort(np.concatenate([z, fine], 1), 1, kind="stable")
    return z_all, mid, w


@pytest.mark.parametrize("m", [1, 7, 16, 21, 22, 30])
def test_topm_eval_select_matches_jax(m):
    """m = 22 is S (no-op: the merged set and no deltas), 30 > S."""
    z_all, mid, w = _keep_inputs(m)
    jz, jd = jsamp.topm_eval_select(jnp.asarray(z_all), jnp.asarray(mid), jnp.asarray(w), m)
    tz, td = tsamp.topm_eval_select(T(z_all), T(mid), T(w), m)
    np.testing.assert_array_equal(tz.numpy(), np.asarray(jz))
    if m >= z_all.shape[1]:
        assert jd is None and td is None and torch.equal(tz, T(z_all))
        return
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    assert tz.shape == (z_all.shape[0], m) and bool((torch.diff(tz, dim=1) >= 0).all())
    # a zero-mass ray keeps its m nearest depths, as the reference's stable sort
    np.testing.assert_array_equal(tz[0].numpy(), z_all[0, :m])


def test_stable_sort_orders_zeros_and_nans_as_lax_sort():
    """Both zeros, both infinities and NaNs of both signs: `jax.lax.sort`
    makes -0.0 equal to +0.0 and every NaN equal and last
    (`_canonicalize_float_for_sort`), and so does the port's stable
    `torch.sort`: equal keys keep their input order in both."""
    vals = np.array([0.0, -0.0, 1.0, -np.inf, np.nan, -1.0, -0.0, 0.0, np.inf, -np.nan, 2.0,
                     -0.0], np.float32)
    assert np.signbit(vals[9]) and np.signbit(vals[1])
    key = np.stack([vals, vals[::-1]])
    payload = np.tile(np.arange(vals.size, dtype=np.float32), (2, 1))
    _, want = jax.lax.sort((jnp.asarray(key), jnp.asarray(payload)), dimension=-1, num_keys=1)
    (got,) = tsamp._stable_sort_by(T(key), T(payload))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got[0, :7].numpy(), [3, 5, 0, 1, 6, 7, 11])


KEEP = [
    "data.synthetic_image_hw", "12,16", "data.synthetic_num_frames", "2",
    "data.synthetic_num_boxes", "4", "data.max_primitives", "6",
    "data.max_intervals", "4", "data.test_every", "2",
    "model.trunk_depth", "2", "model.trunk_width", "32", "model.skips", "0",
    "model.color_width", "16", "model.num_classes", "5", "model.compute_dtype", "float32",
    "render.n_samples", "8", "render.n_importance", "8", "render.near", "0.5",
    "render.far", "40.0", "render.use_primitives", "true", "render.ray_tile", "128",
]


@pytest.mark.parametrize("keep", [10, 16])
def test_keep_m_render_matches_jax(keep):
    """Whole-view renders with render.eval_keep_samples (16 = S: untruncated)
    against the JAX renderer: every RenderOut field within atol 1e-4, depth
    within 5e-4 (see the module docstring)."""
    opts = KEEP + ["render.eval_keep_samples", str(keep)]
    jcfg, cfg = jax_load_config(None, opts), load_config(None, opts)
    jmodel = jax_make_network(jcfg)
    params = jax_init_params(jmodel, jax.random.key(5))
    jds = jax_build(jcfg, seed=0)
    model = make_network(cfg, "cpu")
    model.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    ds = build_synthetic_dataset(cfg, "cpu", seed=0)
    render = jax.jit(lambda p, v: jax_engine._render_view(jcfg, jmodel, p, jds, v))
    full = engine._render_view(load_config(None, KEEP), model, ds, 1)
    for view in (0, 1):
        ref, out = render(params, view), engine._render_view(cfg, model, ds, view)
        for name in out._fields:
            a, b = getattr(ref, name), getattr(out, name)
            assert (a is None) == (b is None), name
            if a is None:
                continue
            a, b = np.asarray(a), b.numpy()
            if a.dtype.kind in "iub":
                np.testing.assert_array_equal(b, a, err_msg=name)
            else:
                atol = 5e-4 if name == "depth" else 1e-4
                np.testing.assert_allclose(b, a, rtol=0, atol=atol, err_msg=name)
    if keep == 16:  # m = S leaves the render as it was
        for a, b in zip(full, out):
            assert (a is None and b is None) or torch.equal(a, b)
    else:
        assert not torch.equal(full.rgb, out.rgb)
