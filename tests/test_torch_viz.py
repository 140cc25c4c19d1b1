"""The port's visualisation against the JAX package's on the CPU: the
trajectory poses and one novel-pose frame, the Visualizer's PNG files
(decoded with PIL, pixel for pixel), and panoptic fusion under every
`eval.sky_rule`."""

from typing import NamedTuple, Optional

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from panopticnerf_tpu import engine as jax_engine
from panopticnerf_tpu.config import load_config as jax_load_config
from panopticnerf_tpu.data.synthetic import build_synthetic_dataset as jax_build
from panopticnerf_tpu.eval.panoptic import fuse_panoptic as jax_fuse
from panopticnerf_tpu.models import init_params, make_network as jax_make_network
from panopticnerf_tpu.viz import Visualizer as JaxVisualizer
from panopticnerf_tpu_torch import engine
from panopticnerf_tpu_torch.config import load_config
from panopticnerf_tpu_torch.convert import params_from_flax
from panopticnerf_tpu_torch.data.synthetic import build_synthetic_dataset
from panopticnerf_tpu_torch.eval.panoptic import fuse_panoptic
from panopticnerf_tpu_torch.models import make_network
from panopticnerf_tpu_torch.viz import Visualizer
from panopticnerf_tpu_torch.viz.png import write_png

TINY = [
    "data.synthetic_image_hw", "12,16", "data.synthetic_num_frames", "3",
    "data.synthetic_num_boxes", "4", "data.max_primitives", "6",
    "data.max_intervals", "4", "data.test_every", "2",
    "model.trunk_depth", "2", "model.trunk_width", "32", "model.skips", "0",
    "model.color_width", "16", "model.num_classes", "5", "model.compute_dtype", "float32",
    "render.n_samples", "8", "render.n_importance", "8", "render.near", "0.5",
    "render.far", "40.0", "render.use_primitives", "true", "render.ray_tile", "128",
]


@pytest.mark.parametrize("n_frames", [2, 5, 9])
def test_trajectory_poses_match_jax(n_frames):
    jds = jax_build(jax_load_config(None, TINY), seed=0)
    ds = build_synthetic_dataset(load_config(None, TINY), "cpu", seed=0)
    ref = jax_engine._trajectory_poses(jds, n_frames)
    got = engine._trajectory_poses(ds, n_frames)
    assert [v for _, v in got] == [v for _, v in ref]
    for (a, _), (b, _) in zip(got, ref):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
        np.testing.assert_allclose(a[:, :3] @ a[:, :3].T, np.eye(3), atol=1e-5)


def test_trajectory_frame_matches_jax():
    """The middle of 3 frames (half way between views 0 and 1) from the
    same flax params: every RenderOut field within the render parity
    test's atol 1e-4, integer fields equal."""
    jcfg, cfg = jax_load_config(None, TINY), load_config(None, TINY)
    jmodel = jax_make_network(jcfg)
    params = init_params(jmodel, jax.random.key(5))
    jds = jax_build(jcfg, seed=0)
    ds = build_synthetic_dataset(cfg, "cpu", seed=0)
    model = make_network(cfg, "cpu")
    model.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    model.eval()
    ref = list(jax_engine.render_trajectory(jcfg, jmodel, params, jds, 3))[1]
    got = list(engine.render_trajectory(cfg, model, ds, 3))[1]
    assert got[:2] == ref[:2]
    for name in got[2]._fields:
        a, b = getattr(ref[2], name), getattr(got[2], name)
        assert (a is None) == (b is None), name
        if a is None:
            continue
        a, b = np.asarray(a), b.numpy()
        assert a.shape == b.shape, name
        if a.dtype.kind in "iub":
            np.testing.assert_array_equal(b, a, err_msg=name)
        else:
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-4, err_msg=name)


class _Out(NamedTuple):
    rgb: object
    depth: object
    sem_logits: Optional[object] = None


@pytest.mark.parametrize("dataset,num_classes", [("synthetic", 4), ("kitti360", 19)])
def test_visualizer_pngs_match_jax(tmp_path, dataset, num_classes):
    """write_view (rgb, depth, semantic, panoptic) and
    write_label_transfer (8-bit ids, 16-bit sem * 1000 + inst) of the same
    maps: PIL decodes the port's files to the JAX Visualizer's pixels."""
    h, w = 6, 10
    rng = np.random.default_rng(3)
    rgb = rng.uniform(-0.1, 1.1, (h * w, 3)).astype(np.float32)
    depth = np.where(rng.uniform(size=h * w) > 0.2, rng.uniform(1, 30, h * w), 0.0).astype(
        np.float32)
    sem = rng.integers(0, num_classes, h * w).astype(np.int32)
    inst = np.where(rng.uniform(size=h * w) > 0.4, rng.integers(1, 3000, h * w), 0).astype(
        np.int32)
    opts = ["data.dataset", dataset, "model.num_classes", str(num_classes)]
    jviz = JaxVisualizer(jax_load_config(None, opts + ["result_dir", str(tmp_path / "jax")]))
    viz = Visualizer(load_config(None, opts + ["result_dir", str(tmp_path / "port")]))
    ref = (jviz.write_view(7, _Out(rgb, depth), (h, w), sem=sem, inst=inst)
           + jviz.write_label_transfer(7, sem, inst, (h, w)))
    got = (viz.write_view(7, _Out(torch.from_numpy(rgb), torch.from_numpy(depth)), (h, w),
                          sem=sem, inst=inst)
           + viz.write_label_transfer(7, sem, inst, (h, w)))
    assert [p.split("/")[-1] for p in got] == [p.split("/")[-1] for p in ref]
    assert len(got) == 6
    for a, b in zip(ref, got):
        ia, ib = Image.open(a), Image.open(b)
        assert ia.mode == ib.mode, a
        np.testing.assert_array_equal(np.asarray(ib), np.asarray(ia), err_msg=b)


def test_write_png_rejects_other_layouts(tmp_path):
    for bad in (np.zeros((2, 3, 4), np.uint8), np.zeros((2, 3), np.float32),
                np.zeros((2, 3, 3), np.uint16)):
        with pytest.raises(ValueError):
            write_png(str(tmp_path / "x.png"), bad)


@pytest.mark.parametrize("sky_rule", ["off", "empty", "support", "soft", "soft:0.3", "soft:1"])
@pytest.mark.parametrize("sky_class", [0, 2])
def test_fuse_panoptic_sky_rules_match_jax(sky_rule, sky_class):
    rng = np.random.default_rng(9)
    n, c, k = 512, 5, 4
    logits = (3 * rng.normal(size=(n, c))).astype(np.float32)
    fixed = (rng.uniform(size=(n, c)) * (rng.uniform(size=(n, c)) > 0.5)
             * (rng.uniform(size=(n, 1)) > 0.3)).astype(np.float32)
    mass = (rng.uniform(size=(n, k)) * (rng.uniform(size=(n, k)) > 0.4)).astype(np.float32)
    ids = rng.integers(0, 9, (n, k)).astype(np.int32)
    isem = rng.integers(-1, c, (n, k)).astype(np.int32)
    things = np.array([False, True, True, False, True])
    js, ji = jax_fuse(*(jax.numpy.asarray(a) for a in (logits, fixed, mass, ids, isem)),
                      things, 0.5, sky_rule=sky_rule, sky_class=sky_class)
    ts, ti = fuse_panoptic(*(torch.from_numpy(a) for a in (logits, fixed, mass, ids, isem)),
                           things, 0.5, sky_rule=sky_rule, sky_class=sky_class)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert ts.dtype == torch.int32 and ti.dtype == torch.int32


@pytest.mark.parametrize("sky_rule", ["emtpy", "soft:x", "softer", ""])
def test_unknown_sky_rule_raises(sky_rule):
    from panopticnerf_tpu_torch.eval import make_evaluator

    with pytest.raises(ValueError):
        make_evaluator(load_config(None, ["eval.sky_rule", sky_rule]))
