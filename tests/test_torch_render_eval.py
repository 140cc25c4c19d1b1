"""The port's evaluation slice against the JAX package, end to end and piece
by piece, on a tiny synthetic config (2 views of 12x16, 4 boxes, a 2x32
field in float32, 8 + 8 samples, K = 4, 128-ray tiles so the last tile is
padded):

- `build_synthetic_dataset` gives bit-equal arrays (tiny and flagship);
- `engine._render_view`: every RenderOut field within atol 1e-4;
- `run.py --type evaluate` on a converted checkpoint against the JAX
  evaluator on the JAX renders: PSNR within 1e-3, mIoU and PQ equal;
- the sampling tie rules (stable merge a-first, searchsorted right, the
  no-hit fallback, the 1e-5 denominator guard), compositing, the K-factored
  fixed field, panoptic fusion and the metrics (with their empty-input
  guards: pytest.ini turns numpy's warnings into errors).
"""

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
from panopticnerf_tpu.eval import metrics as jm
from panopticnerf_tpu.eval.panoptic import fuse_panoptic as jax_fuse
from panopticnerf_tpu.models import init_params, make_network as jax_make_network
from panopticnerf_tpu.ops.composite import composite as jax_composite
from panopticnerf_tpu.ops import intersect as jint
from panopticnerf_tpu.ops import sampling as jsamp
from panopticnerf_tpu_torch import engine, run
from panopticnerf_tpu_torch.config import load_config
from panopticnerf_tpu_torch.convert import flatten, params_from_flax
from panopticnerf_tpu_torch.data.synthetic import build_synthetic_dataset
from panopticnerf_tpu_torch.eval import metrics as tm
from panopticnerf_tpu_torch.eval.panoptic import fuse_panoptic
from panopticnerf_tpu_torch.models import make_network
from panopticnerf_tpu_torch.ops.composite import composite
from panopticnerf_tpu_torch.ops import intersect as tint
from panopticnerf_tpu_torch.ops import sampling as tsamp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = os.path.join(REPO, "configs", "synthetic_flagship.yaml")

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


# ---------------------------------------------------------------- dataset


@pytest.mark.parametrize("cfg_file,opts", [(None, TINY), (FLAGSHIP, [])])
def test_synthetic_dataset_bit_equal(cfg_file, opts):
    ref = jax_build(jax_load_config(cfg_file, opts), seed=0)
    ds = build_synthetic_dataset(load_config(cfg_file, opts), "cpu", seed=0)
    assert ds._fields == ref._fields
    for name in ds._fields:
        a, b = getattr(ref, name), getattr(ds, name)
        assert (a is None) == (b is None), name
        if a is not None:
            a = np.asarray(a)
            assert b.numpy().dtype == a.dtype and b.shape == a.shape, name
            np.testing.assert_array_equal(b.numpy(), a, err_msg=name)


# ---------------------------------------------------------------- the slice


@pytest.fixture(scope="module")
def tiny():
    jcfg = jax_load_config(None, TINY)
    model = jax_make_network(jcfg)
    params = init_params(model, jax.random.key(5))
    jds = jax_build(jcfg, seed=0)
    cfg = load_config(None, TINY)
    tmodel = make_network(cfg, "cpu")
    tmodel.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    ds = build_synthetic_dataset(cfg, "cpu", seed=0)
    render = jax.jit(lambda p, v: jax_engine._render_view(jcfg, model, p, jds, v))
    outs = {v: render(params, v) for v in range(2)}
    return dict(jcfg=jcfg, params=params, jds=jds, cfg=cfg, model=tmodel, ds=ds,
                outs=outs)


@pytest.mark.parametrize("view", [0, 1])
def test_render_view_matches_jax(tiny, view):
    ref = tiny["outs"][view]
    out = engine._render_view(tiny["cfg"], tiny["model"], tiny["ds"], view)
    assert out.rgb.shape == (12 * 16, 3) and out.inst_mass.shape == (12 * 16, 4)
    for name in out._fields:
        a, b = getattr(ref, name), getattr(out, name)
        assert (a is None) == (b is None), name
        if a is None:
            continue
        a, b = np.asarray(a), b.numpy()
        assert a.shape == b.shape, name
        if a.dtype.kind in "iub":
            np.testing.assert_array_equal(b, a, err_msg=name)
        else:
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-4, err_msg=name)
    assert float(out.sem_fixed.sum()) > 0 and bool(out.inst_mass.any())


def test_run_evaluate_cli_matches_jax_evaluator(tiny, tmp_path):
    """`python -m panopticnerf_tpu_torch.run --type evaluate` on a converted
    checkpoint vs the JAX evaluator fed the JAX renders (run_evaluate's
    protocol: PSNR on test views, mIoU / PQ on every view with GT)."""
    flat = {k: np.asarray(v) for k, v in flatten(tiny["params"]["params"]).items()}
    os.makedirs(tmp_path / "torch")
    np.savez(tmp_path / "torch" / "default_7.npz", **flat)
    np.savez(tmp_path / "torch" / "default_3.npz", **flat)
    res = run.main(["--type", "evaluate", "--device", "cpu", *TINY,
                    "model_dir", str(tmp_path)])
    assert res["step"] == 7 and res["views"] == [0, 1] and len(res["render_seconds"]) == 2

    jds, test_ids = tiny["jds"], [1]
    ev = jax_make_evaluator(tiny["jcfg"])
    for v in (0, 1):
        gt_rgb = (np.asarray(jds.images[v], np.float32).reshape(-1, 3) / 255.0
                  if v in test_ids else None)
        gt_depth = np.asarray(jds.depth[v]).reshape(-1) if v in test_ids else None
        ev.evaluate(tiny["outs"][v], gt_rgb, np.asarray(jds.gt_sem[v]).reshape(-1),
                    np.asarray(jds.gt_inst[v]).reshape(-1), gt_depth=gt_depth,
                    image_hw=(12, 16))
    ref = ev.summarize()
    assert abs(res["psnr"] - ref["psnr"]) <= 1e-3
    assert res["miou"] == ref["miou"] and res["pq"] == ref["pq"]
    np.testing.assert_array_equal(res["pq_per_class"], ref["pq_per_class"])
    assert abs(res["ssim"] - ref["ssim"]) <= 1e-3
    assert abs(res["depth_rmse"] - ref["depth_rmse"]) <= 1e-3


def test_checkpoint_path_errors(tmp_path):
    cfg = load_config(None, ["model_dir", str(tmp_path)])
    with pytest.raises(FileNotFoundError):
        engine.checkpoint_path(cfg)
    cfg.train.eval_step = -1
    with pytest.raises(FileNotFoundError):   # no best checkpoint saved
        engine.checkpoint_path(cfg)
    assert not os.path.exists(tmp_path / "torch")   # the probe created nothing


# ---------------------------------------------------------------- sampling


def test_merge_sorted_ties_a_first():
    """Equal values keep `a` ahead of `b`. The reference's one-hot sums turn
    -0.0 into +0.0, so only its values compare; the port keeps signed
    zeros, which makes its order of equal values observable."""
    a = np.array([[-0.0, 1.0, 2.0], [0.0, 1.0, 1.0]], np.float32)
    b = np.array([[0.0, 1.0, 3.0], [-0.0, 1.0, 5.0]], np.float32)
    ref = np.asarray(jsamp.merge_sorted(jnp.asarray(a), jnp.asarray(b)))
    out = tsamp.merge_sorted(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(out, ref)
    assert np.signbit(out[0, 0]) and not np.signbit(out[0, 1])   # a's -0.0 first
    assert not np.signbit(out[1, 0]) and np.signbit(out[1, 1])   # a's +0.0 first


def test_merge_z_random_with_ties():
    rng = np.random.default_rng(0)
    a = np.sort(rng.integers(0, 6, (32, 9)), 1).astype(np.float32)
    b = np.sort(rng.integers(0, 6, (32, 7)), 1).astype(np.float32)
    np.testing.assert_array_equal(
        tsamp.merge_z(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(jsamp.merge_z(jnp.asarray(a), jnp.asarray(b))))


def test_sample_pdf_searchsorted_right_and_guard():
    """u = 0.5 lands exactly on cdf = [0, .5, .5, 1]: counting u >= cdf
    (searchsorted right) picks the bin after the empty one, and the empty
    bin's zero width hits the 1e-5 denominator guard."""
    bins = np.array([[0.0, 1.0, 2.0, 3.0]], np.float32)
    w = np.array([[1.0, -1e-5, 1.0]], np.float32)
    ref = np.asarray(jsamp.sample_pdf(jax.random.key(0), jnp.asarray(bins),
                                      jnp.asarray(w), 1, False))
    out = tsamp.sample_pdf(torch.from_numpy(bins), torch.from_numpy(w), 1, False).numpy()
    np.testing.assert_array_equal(out, ref)
    assert out[0, 0] == 2.0


def test_sample_pdf_random_matches_jax():
    rng = np.random.default_rng(1)
    z = np.sort(rng.uniform(0.5, 40, (64, 16)), 1).astype(np.float32)
    mid = 0.5 * (z[:, 1:] + z[:, :-1])
    w = rng.exponential(size=(64, 14)).astype(np.float32)
    w[:8] = 0.0  # all-empty rays: uniform fallback through the +1e-5
    ref = np.asarray(jsamp.sample_pdf(jax.random.key(0), jnp.asarray(mid),
                                      jnp.asarray(w), 16, False))
    out = tsamp.sample_pdf(torch.from_numpy(mid), torch.from_numpy(w), 16, False).numpy()
    # float32 cumsums in another order: a few ulps of depths up to 40
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


def _iv(t_in, t_out, mask):
    mask = np.asarray(mask, bool)
    sem = np.where(mask, 1, -1).astype(np.int32)
    j = jint.RayIntervals(jnp.asarray(t_in, jnp.float32), jnp.asarray(t_out, jnp.float32),
                          jnp.asarray(sem), jnp.asarray(sem), jnp.asarray(mask))
    t = tint.RayIntervals(torch.tensor(t_in, dtype=torch.float32),
                          torch.tensor(t_out, dtype=torch.float32),
                          torch.from_numpy(sem), torch.from_numpy(sem), torch.from_numpy(mask))
    return j, t


def test_guided_z_tie_and_no_hit_fallback():
    """Ray 0: segments [1, 1.25] and [3, 3.75] (total length 1), u = 0.25
    sits exactly on the first cdf entry -> searchsorted right starts the
    second segment (3.0, not 1.25). Ray 1 hits nothing: full-range
    stratified fallback."""
    big = tint.BIG
    j, t = _iv([[1.0, 3.0], [big, big]], [[1.25, 3.75], [big, big]],
               [[True, True], [False, False]])
    for bg in (0.0, 0.5):
        ref = np.asarray(jsamp.guided_z(jax.random.key(0), j, 4, 0.5, 40.0, False, bg))
        out = tsamp.guided_z(t, 4, 0.5, 40.0, False, bg).numpy()
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)
    out = tsamp.guided_z(t, 2, 0.5, 40.0, False, 0.0).numpy()
    assert out[0, 0] == 3.0


def test_guided_z_overlapping_intervals_matches_jax():
    rng = np.random.default_rng(2)
    t_in = np.sort(rng.uniform(1, 30, (64, 6)), 1)
    t_out = t_in + rng.uniform(0.1, 8, (64, 6))
    mask = rng.uniform(size=(64, 6)) > 0.3
    mask[:4] = False
    t_in, t_out = np.where(mask, t_in, tint.BIG), np.where(mask, t_out, tint.BIG)
    j, t = _iv(t_in, t_out, mask)
    ref = np.asarray(jsamp.guided_z(jax.random.key(0), j, 24, 0.5, 40.0, False, 0.25))
    out = tsamp.guided_z(t, 24, 0.5, 40.0, False, 0.25).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)
    assert (np.diff(out, axis=1) >= 0).all()


def test_stratified_z_matches_jax():
    ref = np.asarray(jsamp.stratified_z(jax.random.key(0), 3, 64, 0.5, 40.0, False))
    out = tsamp.stratified_z(3, 64, 0.5, 40.0, False, "cpu").numpy()
    np.testing.assert_array_equal(out, ref)


def test_perturbed_samplers_use_the_generator():
    """With perturb, the draws come from the given generator only: the same
    seed gives the same depths, and they stay sorted."""
    big = tint.BIG
    _, iv = _iv([[1.0, 3.0], [big, big]], [[1.25, 3.75], [big, big]],
                [[True, True], [False, False]])
    bins = torch.linspace(0.5, 40.0, 17)[None].repeat(3, 1)
    w = torch.rand(3, 16, generator=torch.Generator().manual_seed(0))
    draws = []
    for _ in range(2):
        g = torch.Generator().manual_seed(3)
        draws.append((tsamp.stratified_z(4, 8, 0.5, 40.0, True, "cpu", g),
                      tsamp.guided_z(iv, 16, 0.5, 40.0, True, 0.25, generator=g),
                      tsamp.sample_pdf(bins, w, 12, True, generator=g)))
    for a, b in zip(*draws):
        assert torch.equal(a, b) and bool((torch.diff(a, dim=1) >= 0).all())
    assert not torch.equal(draws[0][0], tsamp.stratified_z(4, 8, 0.5, 40.0, False, "cpu"))


# ---------------------------------------------------------------- composite / fixed field


def test_composite_matches_jax():
    rng = np.random.default_rng(3)
    n, s, c, k = 32, 12, 5, 4
    sigma = rng.normal(0, 5, (n, s)).astype(np.float32)
    rgb = rng.uniform(size=(n, s, 3)).astype(np.float32)
    z = np.sort(rng.uniform(0.5, 40, (n, s)), 1).astype(np.float32)
    sem = rng.normal(size=(n, s, c)).astype(np.float32)
    inside = rng.uniform(size=(n, s, k)) > 0.5
    ref = jax_composite(jnp.asarray(sigma), jnp.asarray(rgb), jnp.asarray(z), 40.0,
                          sem_logits=jnp.asarray(sem), inside_intervals=jnp.asarray(inside))
    out = composite(torch.from_numpy(sigma), torch.from_numpy(rgb),
                          torch.from_numpy(z), sem_logits=torch.from_numpy(sem),
                          inside_intervals=torch.from_numpy(inside))
    for name in ("rgb", "depth", "acc", "weights", "sem_logits", "inst_mass"):
        np.testing.assert_allclose(getattr(out, name).numpy(),
                                   np.asarray(getattr(ref, name)), rtol=1e-5, atol=1e-5,
                                   err_msg=name)


def test_fixed_map_from_weights_matches_jax():
    rng = np.random.default_rng(4)
    n, s, k, c = 16, 10, 4, 5
    t_in = np.sort(rng.uniform(1, 20, (n, k)), 1).astype(np.float32)
    t_out = (t_in + rng.uniform(0.5, 6, (n, k))).astype(np.float32)
    mask = rng.uniform(size=(n, k)) > 0.2
    sem = np.where(mask, rng.integers(-1, c, (n, k)), -1).astype(np.int32)
    z = np.sort(rng.uniform(0.5, 30, (n, s)), 1).astype(np.float32)
    w = rng.uniform(size=(n, s)).astype(np.float32)
    jiv = jint.RayIntervals(jnp.asarray(t_in), jnp.asarray(t_out), jnp.asarray(sem),
                            jnp.asarray(sem), jnp.asarray(mask))
    tiv = tint.RayIntervals(*(torch.from_numpy(a) for a in (t_in, t_out, sem, sem, mask)))
    jlab, jcnt = jint.labeled_containment(jnp.asarray(z), jiv)
    tlab, tcnt = tint.labeled_containment(torch.from_numpy(z), tiv)
    np.testing.assert_array_equal(tlab.numpy(), np.asarray(jlab))
    np.testing.assert_array_equal(tcnt.numpy(), np.asarray(jcnt))
    ref = jint.fixed_map_from_weights(jnp.asarray(w), jlab, jcnt, jiv, c)
    out = tint.fixed_map_from_weights(torch.from_numpy(w), tlab, tcnt, tiv, c)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------- fusion / metrics


@pytest.mark.parametrize("rule", ["match", "raw"])
def test_fuse_panoptic_matches_jax(rule):
    rng = np.random.default_rng(5)
    n, c, k = 256, 5, 4
    logits = rng.normal(size=(n, c)).astype(np.float32)
    fixed = (rng.uniform(size=(n, c)) * (rng.uniform(size=(n, 1)) > 0.3)).astype(np.float32)
    mass = (rng.uniform(size=(n, k)) * (rng.uniform(size=(n, k)) > 0.4)).astype(np.float32)
    ids = rng.integers(0, 9, (n, k)).astype(np.int32)
    isem = rng.integers(-1, c, (n, k)).astype(np.int32)
    things = np.array([False, True, True, False, True])
    js, ji = jax_fuse(jnp.asarray(logits), jnp.asarray(fixed), jnp.asarray(mass),
                      jnp.asarray(ids), jnp.asarray(isem) if rule == "match" else None,
                      things, 0.5)
    ts, ti = fuse_panoptic(torch.from_numpy(logits), torch.from_numpy(fixed),
                           torch.from_numpy(mass), torch.from_numpy(ids),
                           torch.from_numpy(isem) if rule == "match" else None, things, 0.5)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert ts.dtype == torch.int32 and ti.dtype == torch.int32
    with pytest.raises(ValueError):   # the reference reads an unknown rule as "empty"
        fuse_panoptic(torch.from_numpy(logits), torch.from_numpy(fixed), None, None,
                      None, things, sky_rule="suport", sky_class=0)


def test_metrics_match_jax():
    rng = np.random.default_rng(6)
    c = 5
    gt_sem = rng.integers(0, c, (24, 32))
    gt_sem[:4] = 255                                    # void band
    gt_inst = rng.integers(0, 3, (24, 32))
    pred_sem = np.where(rng.uniform(size=gt_sem.shape) < 0.8, gt_sem % c,
                        rng.integers(0, c, gt_sem.shape))
    pred_inst = np.where(rng.uniform(size=gt_sem.shape) < 0.9, gt_inst, 1)
    things = np.array([False, True, True, False, True])
    np.testing.assert_array_equal(tm.confusion_matrix(pred_sem, gt_sem, c),
                                  np.asarray(jm.confusion_matrix(pred_sem, gt_sem, c)))
    a = tm.panoptic_quality(pred_sem, pred_inst, gt_sem, gt_inst, things, c)
    b = jm.panoptic_quality(pred_sem, pred_inst, gt_sem, gt_inst, things, c)
    for key in b:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    assert tm.pq_from_stats(a)["mean_pq"] == jm.pq_from_stats(b)["mean_pq"]
    cm = tm.confusion_matrix(pred_sem, gt_sem, c)
    assert tm.iou_from_confusion(cm)[1] == jm.iou_from_confusion(cm)[1]
    img = rng.uniform(size=(24, 32, 3))
    ref = rng.uniform(size=(24, 32, 3))
    assert tm.ssim(img, ref) == jm.ssim(img, ref)
    assert tm.psnr(img, ref) == jm.psnr(img, ref)
    pd = rng.uniform(1, 20, 200)
    gd = np.where(rng.uniform(size=200) < 0.5, rng.uniform(1, 20, 200), 0.0)
    assert tm.depth_error_sums(pd, gd) == jm.depth_error_sums(pd, gd)


def test_metrics_empty_inputs_raise_no_warnings():
    """Empty selections return NaN / zeros without numpy warnings (which
    pytest.ini turns into errors)."""
    assert np.isnan(tm.psnr(np.zeros((4, 3)), np.zeros((4, 3)), np.zeros((4, 3), bool)))
    assert np.isnan(tm.ssim(np.zeros((8, 8)), np.zeros((8, 8))))
    assert np.isnan(tm.ssim(np.zeros((16, 16)), np.zeros((16, 16)), np.zeros((16, 16), bool)))
    assert np.isnan(tm.iou_from_confusion(np.zeros((3, 3)))[1])
    stats = {"iou_sum": np.zeros(3), "tp": np.zeros(3, np.int64),
             "fp": np.zeros(3, np.int64), "fn": np.zeros(3, np.int64)}
    assert np.isnan(tm.pq_from_stats(stats)["mean_pq"])
    s = tm.depth_error_sums(np.ones(5), np.zeros(5))
    assert s["n"] == 0 and tm.depth_from_sums(s)["depth_rmse"] == 0.0
    allvoid = np.full((4, 4), 255)
    st = tm.panoptic_quality(np.zeros((4, 4), int), np.zeros((4, 4), int), allvoid,
                             np.zeros((4, 4), int), np.array([False, True]), 2)
    assert st["fp"].sum() == 0 and st["fn"].sum() == 0
