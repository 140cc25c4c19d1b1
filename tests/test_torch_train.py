"""The pieces of the port's training step against the JAX package, on small
inputs made from a seed: the samplers with injected uniforms (the repaired
guided_z draw), the grouped ray batch and its intervals (the Pallas grouped
kernel in interpret mode), the training branch of render_rays, the loss
stack under every filter, the optimizer against optax, and the weight
carry-over in both directions. Each tolerance is stated where it is used."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from panopticnerf_tpu.config import load_config as jax_load_config
from panopticnerf_tpu.data import dataset as jds_mod
from panopticnerf_tpu.data.synthetic import build_synthetic_dataset as jax_build
from panopticnerf_tpu.models import init_params as jax_init_params
from panopticnerf_tpu.models import make_network as jax_make_network
from panopticnerf_tpu.ops import intersect as jint
from panopticnerf_tpu.ops import sampling as jsamp
from panopticnerf_tpu.render import renderer as jrend
from panopticnerf_tpu.train import loss as jloss
from panopticnerf_tpu_torch.config import load_config
from panopticnerf_tpu_torch.convert import flatten, params_from_flax, params_to_flax
from panopticnerf_tpu_torch.data import dataset as tds_mod
from panopticnerf_tpu_torch.data.synthetic import build_synthetic_dataset
from panopticnerf_tpu_torch.models import make_network
from panopticnerf_tpu_torch.ops import intersect as tint
from panopticnerf_tpu_torch.ops import sampling as tsamp
from panopticnerf_tpu_torch.render import RenderDraws, RenderOut, SceneBounds, render_rays
from panopticnerf_tpu_torch.train import apply_gradients, lr_at, make_train_state
from panopticnerf_tpu_torch.train.loss import compute_losses

SMALL = [
    "data.synthetic_image_hw", "16,24", "data.synthetic_num_frames", "4",
    "data.synthetic_num_boxes", "3", "data.n_rays", "64", "data.views_per_batch", "4",
    "data.max_primitives", "4", "data.max_intervals", "3", "model.trunk_depth", "3",
    "model.trunk_width", "32", "model.color_width", "16", "model.num_classes", "4",
    "model.compute_dtype", "float32", "model.skips", "1", "render.n_samples", "8",
    "render.n_importance", "8", "render.near", "0.5", "render.far", "40.0",
    "render.use_primitives", "true", "render.use_pallas_intersect", "true",
]

T = lambda a: torch.from_numpy(np.array(a))  # a writable copy


def _assert_tree_close(got, want, atol, names, rtol=0.0):
    for name, a, b in zip(names, want, got):
        if a is None:
            assert b is None, name
            continue
        a, b = np.asarray(a), b.detach().numpy()
        assert a.shape == b.shape, name
        if a.dtype.kind in "iub":
            np.testing.assert_array_equal(b, a, err_msg=name)
        else:
            np.testing.assert_allclose(b, a, rtol=rtol, atol=atol, err_msg=name)


# ---------------------------------------------------------------- samplers


def _intervals(n, k, seed, no_hit=4):
    rng = np.random.default_rng(seed)
    t_in = np.sort(rng.uniform(1, 30, (n, k)), 1)
    t_out = t_in + rng.uniform(0.1, 8, (n, k))
    mask = rng.uniform(size=(n, k)) > 0.3
    mask[:no_hit] = False                                   # rays that hit nothing
    t_in = np.where(mask, t_in, tint.BIG).astype(np.float32)
    t_out = np.where(mask, t_out, tint.BIG).astype(np.float32)
    sem = np.where(mask, 1, -1).astype(np.int32)
    j = jint.RayIntervals(*(jnp.asarray(a) for a in (t_in, t_out, sem, sem, mask)))
    t = tint.RayIntervals(*(torch.from_numpy(a) for a in (t_in, t_out, sem, sem, mask)))
    return j, t


@pytest.mark.parametrize("bg_frac", [0.25, 0.0])
def test_guided_z_perturbed_matches_jax_with_its_uniforms(bg_frac):
    """Fed the uniforms jax.random gives for key_in / key_bg, the port's
    perturbed guided_z equals the reference's, no-hit rays included: one
    (N, S_in) draw serves as both the jitter and the stratified fallback
    (a second draw for the fallback broke this). Float32 association
    differs only in the inverse-CDF sums: atol 1e-5 on depths <= 40."""
    j, t = _intervals(64, 6, 0)
    key = jax.random.key(3)
    ref = np.asarray(jsamp.guided_z(key, j, 24, 0.5, 40.0, True, bg_frac))
    s_in, s_bg = tsamp.guided_split(24, bg_frac)
    key_in, key_bg = jax.random.split(key)
    u_in = T(jax.random.uniform(key_in, (64, s_in)))
    u_bg = T(jax.random.uniform(key_bg, (64, s_bg))) if s_bg else None
    out = tsamp.guided_z(t, 24, 0.5, 40.0, True, bg_frac, u_in=u_in, u_bg=u_bg).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)
    assert (np.diff(out, axis=1) >= 0).all()
    with pytest.raises(ValueError):  # pre-drawn uniforms of the wrong shape
        tsamp.guided_z(t, 24, 0.5, 40.0, True, bg_frac, u_in=u_in[:, :3], u_bg=u_bg)


def test_sample_pdf_and_stratified_z_with_injected_uniforms():
    """sample_pdf and stratified_z with perturb, fed jax.random's uniforms:
    equal to the reference within float32 cumsum-order ulps."""
    rng = np.random.default_rng(1)
    z = np.sort(rng.uniform(0.5, 40, (32, 16)), 1).astype(np.float32)
    mid = 0.5 * (z[:, 1:] + z[:, :-1])
    w = rng.exponential(size=(32, 14)).astype(np.float32)
    key = jax.random.key(9)
    ref = np.asarray(jsamp.sample_pdf(key, jnp.asarray(mid), jnp.asarray(w), 12, True))
    out = tsamp.sample_pdf(T(mid), T(w), 12, True,
                           u_fine=T(jax.random.uniform(key, (32, 12)))).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    ref = np.asarray(jsamp.stratified_z(key, 5, 32, 0.5, 40.0, True))
    out = tsamp.stratified_z(5, 32, 0.5, 40.0, True, "cpu",
                             u=T(jax.random.uniform(key, (5, 32)))).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


# ---------------------------------------------------------------- batch + intervals


@pytest.fixture(scope="module")
def small():
    jcfg, cfg = jax_load_config(None, SMALL), load_config(None, SMALL)
    return dict(jcfg=jcfg, cfg=cfg, jds=jax_build(jcfg, seed=0),
                ds=build_synthetic_dataset(cfg, "cpu", seed=0))


def _batch_draws(key, cfg, n_views, hw):
    k1, k2, k3 = jax.random.split(key, 3)
    n, g = cfg.data.n_rays, cfg.data.views_per_batch
    return tds_mod.BatchDraws(T(jax.random.randint(k1, (g,), 0, n_views)),
                              T(jax.random.randint(k2, (n,), 0, hw[1])),
                              T(jax.random.randint(k3, (n,), 0, hw[0])))


def test_ray_batch_and_grouped_intervals_match_jax(small):
    """sample_ray_batch with the reference's randint draws gives its batch
    (rays within 1e-6), and batch_intervals (grouped, the plain version of
    A2 on the CPU) gives the intervals of `intersect_groups_pallas` in
    interpret mode: labels and masks equal, depths within 1e-4."""
    jcfg, cfg, jds, ds = small["jcfg"], small["cfg"], small["jds"], small["ds"]
    view_ids = np.array([0, 2, 3])
    key = jax.random.key(5)
    jb = jds_mod.sample_ray_batch(key, jds, jnp.asarray(view_ids), 64, 4)
    jiv = jds_mod.batch_intervals(jds, jb, 0.5, 40.0, 3, 4, use_pallas=True,
                                  pallas_interpret=True)
    draws = _batch_draws(key, cfg, 3, (16, 24))
    tb = tds_mod.sample_ray_batch(ds, T(view_ids), 64, 4, draws=draws)
    _assert_tree_close(tb, jb, 1e-6, tb._fields)
    tiv = tds_mod.batch_intervals(ds, tb, 0.5, 40.0, 3, 4)
    _assert_tree_close(tiv, jiv, 1e-4, tiv._fields)
    assert bool(tiv.mask.any())
    plain = tds_mod.batch_intervals(ds, tb, 0.5, 40.0, 3, 4, use_kernel=False)
    for a, b in zip(plain, tiv):
        assert torch.equal(a, b)
    g = torch.Generator().manual_seed(0)
    again = [tds_mod.sample_ray_batch(ds, T(view_ids), 64, 4, g) for _ in range(2)]
    assert not torch.equal(again[0].rays_d, again[1].rays_d)
    with pytest.raises(ValueError):  # 64 rays in 5 groups
        tds_mod.sample_ray_batch(ds, T(view_ids), 64, 5, g)
    # views_per_batch 0 (fully mixed): every ray draws its own view and is
    # intersected against that view's table alone (tests/test_torch_mixed.py
    # holds both against JAX)
    mixed = tds_mod.sample_ray_batch(ds, T(view_ids), 64, 0, g)
    assert set(mixed.view.tolist()) <= set(view_ids.tolist())
    miv = tds_mod.batch_intervals(ds, mixed, 0.5, 40.0, 3, 0)
    for i in (0, 17, 63):
        one = tint.intersect_rays_plain(mixed.rays_o[i:i + 1], mixed.rays_d[i:i + 1],
                                        tds_mod.view_primitives(ds, int(mixed.view[i])),
                                        0.5, 40.0, 3)
        for a, b in zip(one, miv):
            assert torch.equal(a[0], b[i])


def test_render_rays_train_branch_matches_jax(small):
    """The training render (jitter, density noise, the coarse RenderOut and
    the per-sample extras) with the reference's draws, float32 field: the
    coarse level within 1e-4; the fine level within rtol 1e-4, atol 2e-3,
    because the inverse CDF divides by bin masses, which turns cumsum-order
    ulps into fine depths that differ by up to 2e-5 relative, and the field
    outputs at those depths move with them."""
    jcfg, cfg, jds, ds = small["jcfg"], small["cfg"], small["jds"], small["ds"]
    jcfg.render.raw_noise_std = cfg.render.raw_noise_std = 0.5
    try:
        model = jax_make_network(jcfg)
        params = jax_init_params(model, jax.random.key(1))
        key = jax.random.key(2)
        jb = jds_mod.sample_ray_batch(key, jds, jnp.arange(4), 64, 4)
        jiv = jds_mod.batch_intervals(jds, jb, 0.5, 40.0, 3, 4)
        rkey = jax.random.key(4)
        ref = jrend.render_rays(model, params, jb.rays_o, jb.rays_d,
                                jrend.SceneBounds(jds.bounds_center, jds.bounds_scale),
                                rkey, jcfg, iv=jiv, train=True)
        k_coarse, k_fine, k_nc, k_nf = jax.random.split(rkey, 4)
        key_in, key_bg = jax.random.split(k_coarse)
        draws = RenderDraws(T(jax.random.uniform(key_in, (64, 6))),
                            T(jax.random.uniform(key_bg, (64, 2))),
                            T(jax.random.uniform(k_fine, (64, 8))),
                            T(jax.random.normal(k_nc, (64, 8))),
                            T(jax.random.normal(k_nf, (64, 16))))
        tmodel = make_network(cfg, "cpu")
        tmodel.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
        iv = tint.RayIntervals(*(T(a) for a in jiv))
        out = render_rays(tmodel, T(jb.rays_o), T(jb.rays_d),
                          SceneBounds(ds.bounds_center, ds.bounds_scale), cfg, iv=iv,
                          train=True, draws=draws)
    finally:
        jcfg.render.raw_noise_std = cfg.render.raw_noise_std = 0.0
    names = [f for f in out._fields if f != "coarse"]
    _assert_tree_close([getattr(out.coarse, f) for f in names],
                       [getattr(ref.coarse, f) for f in names], 1e-4, names)
    _assert_tree_close([getattr(out, f) for f in names], [getattr(ref, f) for f in names],
                       2e-3, names, rtol=1e-4)
    assert out.z.shape == (64, 16) and out.coarse.z.shape == (64, 8)


# ---------------------------------------------------------------- losses


LOSS_CASES = {
    "default": {},
    "no_pseudo_filter": {"pseudo_filter": False},
    "relative": {"rel_filter_ratio": 0.5, "rel_filter_total": 0.2, "weight_th": 0.1},
    "empty_sky_hard": {"empty_sky_filter": True},
    "empty_sky_graded": {"empty_sky_filter": True, "empty_sky_weight": 0.3,
                         "filter_fix2d": False},
    "agree": {"agree_filter": True, "agree_conf": 0.3},
    "no_depth_no_3d": {"depth_weight": 0.0, "sem3d_weight": 0.0},
}


def _render_arrays(rng, n, s, k, c):
    """Random render outputs (numpy): the fine level's fields and the
    coarse level's (own rgb / depth)."""
    sem_fixed = rng.uniform(size=(n, c)).astype(np.float32) * (rng.uniform(size=(n, 1)) > 0.3)
    inside = rng.uniform(size=(n, s, k)) > 0.6
    inst_sem = rng.integers(-1, c, (n, k)).astype(np.int32)
    inside &= (inst_sem >= 0)[:, None, :]
    arrays = dict(
        rgb=rng.uniform(size=(n, 3)), depth=rng.uniform(1, 30, n), acc=rng.uniform(size=n),
        sem_logits=rng.normal(size=(n, c)) * 3, sem_fixed=sem_fixed,
        inst_mass=rng.uniform(size=(n, k)), inst_ids=rng.integers(0, 5, (n, k)),
        inst_sem=inst_sem, z=rng.uniform(1, 30, (n, s)), weights=rng.uniform(size=(n, s)),
        sample_sem_logits=rng.normal(size=(n, s, c)), sample_inside_k=inside,
        sample_cnt=inside.sum(-1))
    arrays = {name: (a.astype(np.float32) if a.dtype == np.float64 else
                     a.astype(np.int32) if a.dtype == np.int64 else a)
              for name, a in arrays.items()}
    coarse = dict(arrays, rgb=rng.uniform(size=(n, 3)).astype(np.float32),
                  depth=rng.uniform(1, 30, n).astype(np.float32))
    return arrays, coarse


@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_compute_losses_matches_jax(case):
    """Every loss term and stat, and the gradient of the total with
    respect to every float render output (fine and coarse), against the
    reference's compute_losses under one filter combination each: rtol
    1e-5, atol 1e-7 (same float32 formulas, other summation order)."""
    rng = np.random.default_rng(sorted(LOSS_CASES).index(case))
    n, s, k, c = 96, 6, 3, 5
    arrays, coarse = _render_arrays(rng, n, s, k, c)
    batch = dict(rays_o=np.zeros((n, 3), np.float32), rays_d=np.zeros((n, 3), np.float32),
                 rgb=rng.uniform(size=(n, 3)).astype(np.float32),
                 pseudo=np.where(rng.uniform(size=n) < 0.1, 255,
                                 rng.integers(0, c, n)).astype(np.int32),
                 depth=np.where(rng.uniform(size=n) < 0.5, rng.uniform(1, 30, n), 0.0
                                ).astype(np.float32),
                 view=np.zeros(n, np.int32), valid=rng.uniform(size=n) < 0.95)
    opts = ["model.num_classes", str(c)]
    jcfg, cfg = jax_load_config(None, opts), load_config(None, opts)
    for key, val in LOSS_CASES[case].items():
        setattr(jcfg.loss, key, val)
        setattr(cfg.loss, key, val)
    sem_scale, agree_on, weight_th = (0.5, 1.0, 0.07) if case == "agree" else (1.0, 0.0, None)
    diff = ["rgb", "depth", "sem_logits", "sem_fixed", "sample_sem_logits"]

    def jax_total(fine, crs):
        out = jrend.RenderOut(**{**{a: jnp.asarray(v) for a, v in arrays.items()}, **fine},
                              coarse=jrend.RenderOut(**{**{a: jnp.asarray(v) for a, v in
                                                           coarse.items()}, **crs}))
        return jloss.compute_losses(out, jds_mod.RayBatch(**{a: jnp.asarray(v) for a, v in
                                                             batch.items()}), jcfg,
                                    sem_scale=sem_scale, agree_on=agree_on,
                                    weight_th=weight_th)

    fine0 = {a: jnp.asarray(arrays[a]) for a in diff}
    crs0 = {a: jnp.asarray(coarse[a]) for a in ("rgb", "depth")}
    (ref_total, ref_stats), (gf, gc) = jax.value_and_grad(jax_total, argnums=(0, 1),
                                                          has_aux=True)(fine0, crs0)

    leaves = {a: torch.from_numpy(arrays[a]).requires_grad_() for a in diff}
    cleaves = {a: torch.from_numpy(coarse[a]).requires_grad_() for a in ("rgb", "depth")}
    out = RenderOut(**{**{a: torch.from_numpy(v) for a, v in arrays.items()}, **leaves},
                    coarse=RenderOut(**{**{a: torch.from_numpy(v) for a, v in coarse.items()},
                                        **cleaves}))
    total, stats = compute_losses(out, tds_mod.RayBatch(**{a: torch.from_numpy(v) for a, v in
                                                           batch.items()}),
                                  cfg, sem_scale=sem_scale, agree_on=agree_on,
                                  weight_th=weight_th)
    total.backward()
    assert set(stats) == set(ref_stats)
    for key in ref_stats:
        np.testing.assert_allclose(float(stats[key].detach()), float(ref_stats[key]), rtol=1e-5,
                                   atol=1e-7, err_msg=key)
    # a leaf no term reads has no .grad; JAX's is 0
    grad = lambda t: (torch.zeros_like(t) if t.grad is None else t.grad).numpy()
    for a in diff:
        np.testing.assert_allclose(grad(leaves[a]), np.asarray(gf[a]), rtol=1e-5, atol=1e-7,
                                   err_msg=a)
    for a in ("rgb", "depth"):
        np.testing.assert_allclose(grad(cleaves[a]), np.asarray(gc[a]), rtol=1e-5, atol=1e-7,
                                   err_msg=f"coarse {a}")


# ---------------------------------------------------------------- optimizer


@pytest.mark.parametrize("clip,wd,ema", [(0.0, 0.0, 0.0), (0.05, 0.0, 0.9), (0.0, 1e-2, 0.0)])
def test_optimizer_matches_optax(clip, wd, ema):
    """Six updates of Adam (or AdamW) with the exponential lr decay, global
    norm clipping and the warmup EMA against optax on the same gradients:
    params within 1e-6 (Adam's ops in another association), EMA likewise."""
    cfg = load_config(None, ["train.lr", "1e-2", "train.max_steps", "4",
                             "train.grad_clip", str(clip), "train.weight_decay", str(wd),
                             "train.ema_decay", str(ema)])
    rng = np.random.default_rng(0)
    w0 = rng.normal(size=(5, 3)).astype(np.float32)
    grads = [rng.normal(size=(5, 3)).astype(np.float32) * 0.1 for _ in range(6)]
    for t in range(6):
        np.testing.assert_allclose(lr_at(cfg, t), float(optax.exponential_decay(1e-2, 4, 0.1)(t)),
                                   rtol=1e-6)

    from panopticnerf_tpu.config import load_config as jlc
    from panopticnerf_tpu.train.step import make_optimizer

    jcfg = jlc(None, ["train.lr", "1e-2", "train.max_steps", "4", "train.grad_clip", str(clip),
                      "train.weight_decay", str(wd)])
    tx = make_optimizer(jcfg)
    p, opt_state, e = jnp.asarray(w0), None, jnp.asarray(w0)
    opt_state = tx.init(p)
    module = torch.nn.Linear(3, 5, bias=False)
    with torch.no_grad():
        module.weight.copy_(torch.from_numpy(w0))
    state = make_train_state(cfg, module)
    for t, g in enumerate(grads):
        upd, opt_state = tx.update(jnp.asarray(g), opt_state, p)
        p = optax.apply_updates(p, upd)
        if ema:
            d = min(ema, (1.0 + t + 1) / (10.0 + t + 1))
            e = e * d + p * (1 - d)
        module.weight.grad = torch.from_numpy(g.copy())
        g_norm = apply_gradients(state, cfg)
        np.testing.assert_allclose(float(g_norm), np.linalg.norm(g), rtol=1e-6)
        np.testing.assert_allclose(module.weight.detach().numpy(), np.asarray(p), rtol=0,
                                   atol=1e-6)
    assert state.step == 6
    if ema:
        np.testing.assert_allclose(state.ema["weight"].numpy(), np.asarray(e), atol=1e-6)


# ---------------------------------------------------------------- weights


def test_params_to_flax_round_trip():
    """flax tree -> state_dict -> flax tree is the identity (both directions
    of the weight carry-over)."""
    jcfg = jax_load_config(None, SMALL)
    params = jax.tree.map(np.asarray, jax_init_params(jax_make_network(jcfg),
                                                      jax.random.key(0)))
    sd = params_from_flax(params)
    flat = params_to_flax(sd)
    want = flatten(params["params"])
    assert set(flat) == set(want)
    for k in want:
        np.testing.assert_array_equal(flat[k], want[k], err_msg=k)
    model = make_network(load_config(None, SMALL), "cpu")
    model.load_state_dict(params_from_flax(flat))
    for k, v in model.state_dict().items():
        assert torch.equal(v, sd[k]), k
