"""The 360-degree panorama of the port (`render/panorama.py`, `run --type
visualize --panorama H,W`) against the JAX package, on the same weights and
scenes:

- `panorama_rays` within 1e-6 of the reference's (float32 trigonometry);
- `render_panorama` on the tiny synthetic scene and on a fisheye demo tree
  with concave buildings (cut planes): every RenderOut field within atol
  1e-4, the tolerance of tests/test_torch_render_eval.py's render parity;
- `run --type visualize --panorama 8,16` writes the panorama of the middle
  test view as view 1,000,000 + view, with the files and pixels of the JAX
  package's run_visualize.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from panopticnerf_tpu import engine as jax_engine
from panopticnerf_tpu.config import load_config as jax_load_config
from panopticnerf_tpu.data import make_dataset as jax_make_dataset
from panopticnerf_tpu.models import init_params as jax_init_params
from panopticnerf_tpu.models import make_network as jax_make_network
from panopticnerf_tpu.render import panorama_rays as jax_panorama_rays
from panopticnerf_tpu.render import render_panorama as jax_render_panorama
from panopticnerf_tpu.train import make_train_state as jax_make_train_state
from panopticnerf_tpu.train.checkpoint import save_model as jax_save_model
from panopticnerf_tpu_torch import run
from panopticnerf_tpu_torch.config import load_config
from panopticnerf_tpu_torch.convert import flatten, params_from_flax
from panopticnerf_tpu_torch.data import make_dataset
from panopticnerf_tpu_torch.data.demo_tree import write_demo_tree
from panopticnerf_tpu_torch.models import make_network
from panopticnerf_tpu_torch.render import panorama_rays, render_panorama
from panopticnerf_tpu_torch.viz.png import read_png
from torch_scenes import engine_opts

TINY = [
    "data.synthetic_image_hw", "12,16", "data.synthetic_num_frames", "2",
    "data.synthetic_num_boxes", "4", "data.max_primitives", "6",
    "data.max_intervals", "4", "data.test_every", "2",
    "model.trunk_depth", "2", "model.trunk_width", "32", "model.skips", "0",
    "model.color_width", "16", "model.num_classes", "5", "model.compute_dtype", "float32",
    "render.n_samples", "8", "render.n_importance", "8", "render.near", "0.5",
    "render.far", "40.0", "render.use_primitives", "true", "render.ray_tile", "128",
]
TREE = [
    "exp_name", "kp", "data.dataset", "kitti360", "data.frame_num", "2", "data.ratio", "0.5",
    "data.use_fisheye", "true", "data.max_primitives", "16", "data.max_intervals", "4",
    "data.test_every", "3", "model.num_classes", "19", "model.trunk_depth", "2",
    "model.trunk_width", "32", "model.skips", "0", "model.color_width", "16",
    "model.compute_dtype", "float32", "render.n_samples", "8", "render.n_importance", "8",
    "render.near", "0.5", "render.far", "40.0", "render.use_primitives", "true",
    "render.ray_tile", "128",
]


@pytest.mark.parametrize("hw,seed", [((8, 16), 0), ((5, 7), 1), ((32, 64), 2)])
def test_panorama_rays_match_jax(hw, seed):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    pos = rng.uniform(-20, 20, 3).astype(np.float32)
    rot = q.astype(np.float32)
    jo, jd = jax_panorama_rays(jnp.asarray(pos), jnp.asarray(rot), *hw)
    o, d = panorama_rays(torch.from_numpy(pos), torch.from_numpy(rot), *hw)
    assert o.shape == d.shape == (hw[0] * hw[1], 3)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=0, atol=1e-6)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=0, atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(d.numpy(), axis=1), 1.0, atol=1e-6)


@pytest.fixture(scope="module")
def demo_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("pano_tree"))
    write_demo_tree(root, n_frames=2, hw=(48, 64), n_boxes=4, seed=0, fisheye=True,
                    n_concave=1, device="cpu")
    return root


@pytest.mark.parametrize("scene", ["synthetic", "tree"])
def test_render_panorama_matches_jax(scene, demo_root):
    opts = TINY if scene == "synthetic" else TREE + ["data.root", demo_root]
    jcfg, cfg = jax_load_config(None, opts), load_config(None, opts)
    jmodel = jax_make_network(jcfg)
    params = jax_init_params(jmodel, jax.random.key(5))
    model = make_network(cfg, "cpu")
    model.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    model.eval()
    jds, _, jtest = jax_make_dataset(jcfg)
    ds, _, test_ids = make_dataset(cfg, "cpu")
    view = int(test_ids[len(test_ids) // 2])
    assert view == int(jtest[len(jtest) // 2])
    if scene == "tree":
        assert ds.prim_planes is not None and bool((ds.prim_planes[view, ..., :3] != 0).any())
    hw = (8, 16)
    ref = jax.jit(lambda p: jax_render_panorama(jmodel, p, jds, view, hw, jcfg))(params)
    out = render_panorama(model, ds, view, hw, cfg)
    assert out.rgb.shape == (hw[0] * hw[1], 3) and bool(out.acc.gt(0).any())
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


def test_visualize_panorama_cli_writes_like_jax(tmp_path):
    """One set of flax weights as a JAX checkpoint and as the port's
    converted .npz: both packages' visualize writes the panorama of test
    view 4 (of 1 and 4) as 1000004_{depth,panoptic,rgb,semantic}.png, 8x16,
    with the same pixels (rgb within one 8-bit level, the label images
    equal)."""
    opts = engine_opts(tmp_path) + ["parallel.data_parallel", "1"]  # JAX: one device
    jcfg = jax_load_config(None, opts)
    jmodel = jax_make_network(jcfg)
    params = jax_init_params(jmodel, jax.random.key(3))
    jax_save_model(jax_make_train_state(jcfg, jmodel, params), jcfg.trained_model_dir, 1)
    os.makedirs(tmp_path / "models" / "torch")
    np.savez(tmp_path / "models" / "torch" / "enginetest_1.npz",
             **{k: np.asarray(v) for k, v in flatten(params["params"]).items()})
    jfiles = jax_engine.run_visualize(jcfg, log=lambda *a: None, panorama_hw=(8, 16))
    files = run.main(["--type", "visualize", "--panorama", "8,16", "--device", "cpu", *opts,
                      "result_dir", str(tmp_path / "port")])
    pano = lambda fs: {os.path.basename(f): f for f in fs
                       if os.path.basename(f).startswith("1000004_")}
    want, got = pano(jfiles), pano(files)
    assert sorted(got) == sorted(want) == [f"1000004_{k}.png" for k in
                                           ("depth", "panoptic", "rgb", "semantic")]
    for name, path in got.items():
        a, b = np.asarray(Image.open(want[name])).astype(int), read_png(path).astype(int)
        assert a.shape == b.shape and a.shape[:2] == (8, 16), name
        if name.endswith("rgb.png") or name.endswith("depth.png"):
            assert np.abs(a - b).max() <= 1, name
        else:
            np.testing.assert_array_equal(b, a, err_msg=name)
