"""The port's KITTI-360 path against the JAX package, on demo trees and on
tests/test_kitti360.py's handcrafted tree: fisheye unprojection, the
loader (every field), multi-sequence pools, the reference behaviours that
test_kitti360.py pins, pseudo-label cleaning, the demo-tree writer, one
training step with fisheye groups and cut planes, the label-transfer export,
the repair of the evaluation without semantic ground truth, and the
streamed pool on the tree. Integer arrays must be equal, float arrays
within 1e-6; the step is held at tests/test_torch_train_step.py's
tolerances."""

import os
import shutil
import subprocess
import sys
import warnings
import xml.etree.ElementTree as ET

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from panopticnerf_tpu import engine as jax_engine
from panopticnerf_tpu.config import load_config as jax_load_config
from panopticnerf_tpu.data import make_dataset as jax_make_dataset
from panopticnerf_tpu.data import pseudo as jax_pseudo
from panopticnerf_tpu.data.dataset import concat_datasets as jax_concat
from panopticnerf_tpu.data.dataset import view_rays as jax_view_rays
from panopticnerf_tpu.data.demo_tree import write_demo_tree as jax_write_tree
from panopticnerf_tpu.data.kitti360 import build_kitti360_dataset as jax_build
from panopticnerf_tpu.data.synthetic import build_synthetic_dataset as jax_build_synthetic
from panopticnerf_tpu.models import init_params as jax_init_params
from panopticnerf_tpu.models import make_network as jax_make_network
from panopticnerf_tpu.ops.rays import FisheyeParams as JaxFisheyeParams
from panopticnerf_tpu.ops.rays import pixel_dirs_fisheye as jax_pixel_dirs_fisheye
from panopticnerf_tpu.train import make_train_state as jax_make_train_state
from panopticnerf_tpu.train import make_train_step as jax_make_train_step
from panopticnerf_tpu.train.checkpoint import save_model as jax_save_model
from panopticnerf_tpu_torch import engine, export_label_transfer
from panopticnerf_tpu_torch.config import load_config
from panopticnerf_tpu_torch.convert import flatten, params_from_flax, params_to_flax
from panopticnerf_tpu_torch.data import concat_datasets, make_dataset, pseudo, view_rays
from panopticnerf_tpu_torch.data.annotation3d import load_visible_ids, parse_bbox_xml
from panopticnerf_tpu_torch.data.dataset import BatchDraws, sample_ray_batch
from panopticnerf_tpu_torch.data.demo_tree import main as demo_tree_main
from panopticnerf_tpu_torch.data.demo_tree import write_demo_tree
from panopticnerf_tpu_torch.data.kitti360 import (
    _load_depth,
    build_kitti360_dataset,
    plane_z_to_ray_factor,
)
from panopticnerf_tpu_torch.data.synthetic import build_synthetic_dataset
from panopticnerf_tpu_torch.models import make_network
from panopticnerf_tpu_torch.ops.rays import FisheyeParams, pixel_dirs_fisheye
from panopticnerf_tpu_torch.render import RenderDraws
from panopticnerf_tpu_torch.train import StepDraws, make_train_state, make_train_step
from panopticnerf_tpu_torch.viz.png import read_png
from test_kitti360 import H, W, _mat_xml, make_fake_kitti

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

from export_torch_train_step import jax_step_draws  # noqa: E402

SEQ = "2013_05_28_drive_0000_sync"

# the tiny tree: 4 frames of 48x64 read at ratio 0.5 (24x32), stereo and
# the left fisheye (12 views), one L-shaped building cut into convex pieces
TREE = dict(n_frames=4, hw=(48, 64), n_boxes=4, seed=0, fisheye=True, n_concave=1)
KITTI = [
    "exp_name", "kt", "data.dataset", "kitti360", "data.frame_num", "4", "data.ratio", "0.5",
    "data.use_fisheye", "true", "data.max_primitives", "16", "data.max_intervals", "4",
    "data.n_rays", "64", "data.views_per_batch", "4", "data.test_every", "3",
    "model.num_classes", "19", "model.trunk_depth", "3", "model.trunk_width", "32",
    "model.skips", "1", "model.color_width", "16", "model.compute_dtype", "float32",
    "render.n_samples", "8", "render.n_importance", "8", "render.near", "0.5",
    "render.far", "40.0", "render.use_primitives", "true", "render.ray_tile", "128",
    "train.pretrain_steps", "0", "parallel.data_parallel", "1",
]


def assert_ds_equal(ref, ds, atol=1e-6):
    """Every field of a JAX DeviceDataset and the port's: integer and bool
    arrays equal, float arrays within `atol`."""
    assert ds._fields == ref._fields
    for name in ds._fields:
        a, b = getattr(ref, name), getattr(ds, name)
        assert (a is None) == (b is None), name
        if a is None:
            continue
        a, b = np.asarray(a), b.cpu().numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, (name, a.shape, b.shape, a.dtype, b.dtype)
        if a.dtype.kind in "iub":
            np.testing.assert_array_equal(b, a, err_msg=name)
        else:
            np.testing.assert_allclose(b, a, rtol=0, atol=atol, err_msg=name)


def both(opts):
    return jax_load_config(None, opts), load_config(None, opts)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A demo tree written by the JAX package."""
    root = str(tmp_path_factory.mktemp("jax_tree"))
    jax_write_tree(root, **TREE)
    return root


@pytest.fixture(scope="module")
def fake_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("fake"))
    make_fake_kitti(root)
    return root


# ---------------------------------------------------------------- fisheye


@pytest.mark.parametrize("fp", [(35.0, 35.0, 20.0, 20.0, 2.2, 0.01, -0.002),
                                (57.6, 43.2, 32.0, 24.0, 2.0, 0.01, -0.002),
                                (700.0, 700.0, 700.0, 700.0, 0.9, 0.02, 0.001)])
def test_pixel_dirs_fisheye_matches_jax(fp):
    rng = np.random.default_rng(int(fp[0]))
    uv = rng.uniform(0, 2 * fp[2], (4096, 2)).astype(np.float32)
    p = np.asarray(fp, np.float32)
    want = np.asarray(jax_pixel_dirs_fisheye(jnp.asarray(uv), JaxFisheyeParams(*p)))
    got = pixel_dirs_fisheye(torch.from_numpy(uv), FisheyeParams(*torch.from_numpy(p)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_view_rays_and_batch_of_mixed_cameras_match_jax(tree):
    jcfg, cfg = both(KITTI + ["data.root", tree])
    jds, ds = jax_build(jcfg), build_kitti360_dataset(cfg, "cpu")
    assert ds.cam_model.tolist() == [0, 0, 1] * 4
    rays = jax.jit(jax_view_rays, static_argnums=1)
    for view in (0, 2):
        for a, b in zip(rays(jds, view), view_rays(ds, view)):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=1e-6)
    from panopticnerf_tpu.data.dataset import sample_ray_batch as jax_sample

    ids = np.array([0, 2, 5, 8])
    jb = jax.jit(jax_sample, static_argnums=(3, 4))(jax.random.key(3), jds, jnp.asarray(ids),
                                                   64, 4)
    # the JAX sampler's draws, from its own key split
    k1, k2, k3 = jax.random.split(jax.random.key(3), 3)
    draws = BatchDraws(*(torch.from_numpy(np.array(x)) for x in (
        jax.random.randint(k1, (4,), 0, 4), jax.random.randint(k2, (64,), 0, 32),
        jax.random.randint(k3, (64,), 0, 24))))
    b = sample_ray_batch(ds, torch.from_numpy(ids), 64, 4, draws=draws)
    for name in b._fields:
        x, y = np.asarray(getattr(jb, name)), getattr(b, name).numpy()
        if x.dtype.kind in "iub":
            np.testing.assert_array_equal(y, x, err_msg=name)
        else:
            np.testing.assert_allclose(y, x, rtol=0, atol=1e-6, err_msg=name)
    assert bool((~b.valid).any()) and bool(ds.cam_model[b.view].eq(1).any())


# ---------------------------------------------------------------- the loader


@pytest.mark.parametrize("extra", [
    [],
    ["data.use_fisheye", "false", "data.ratio", "1.0", "data.pseudo_clean_neighbors", "3"],
    ["data.pseudo_cross_view", "2", "data.pseudo_xview_mode", "pull"],
    ["data.pseudo_cross_view", "1", "data.pseudo_xview_repaint", "0.6"],
    ["data.use_stereo", "false", "data.use_depth", "false", "data.max_cut_planes", "0"],
], ids=["fisheye_half", "stereo_clean", "xview_pull", "xview_splat_repaint", "mono_no_planes"])
def test_loader_matches_jax_on_demo_tree(tree, extra):
    jcfg, cfg = both(KITTI + ["data.root", tree] + extra)
    ref = jax_build(jcfg)
    ds = build_kitti360_dataset(cfg, "cpu")
    assert_ds_equal(ref, ds)
    if "data.max_cut_planes" not in extra:  # the L-building's pieces carry real planes
        planes = ds.prim_planes[0][ds.prim_valid[0]]
        assert bool(((planes[..., :3] != 0).any(-1)).any())


@pytest.mark.parametrize("extra", [
    ["data.use_fisheye", "true", "data.use_depth", "false"],      # 40x40 fisheye -> 24x32
    ["data.use_fisheye", "true", "data.ratio", "0.5"],            # ratio, then the resize
    ["data.use_stereo", "false", "data.ratio", "0.5", "data.use_pspnet", "false",
     "data.use_depth", "false"],
    ["data.depth_convention", "ray", "data.pseudo_cross_view", "2"],
], ids=["fisheye_resize", "fisheye_ratio", "mono_quarter", "ray_xview"])
def test_loader_matches_jax_on_fake_tree(fake_root, extra):
    opts = ["data.dataset", "kitti360", "data.root", fake_root, "data.frame_start", "100",
            "data.frame_num", "3", "data.max_primitives", "4", "model.num_classes", "19"]
    jcfg, cfg = both(opts + extra)
    assert_ds_equal(jax_build(jcfg), build_kitti360_dataset(cfg, "cpu"))


def test_two_sequence_pool_matches_jax(tmp_path):
    """data.sequences: both packages' make_dataset on a two-sequence tree
    (fisheye, seeds 0 and 1), and concat_datasets of a fisheye and a
    perspective-only pool, whose missing fields take neutral values."""
    root = str(tmp_path / "two")
    seqs = ["2013_05_28_drive_0000_sync", "2013_05_28_drive_0002_sync"]
    for i, sq in enumerate(seqs):
        jax_write_tree(root, n_frames=2, hw=(24, 32), n_boxes=3, seed=i, seq=sq,
                       fisheye=True, frame_start=3353)
    opts = KITTI + ["data.root", root, "data.frame_num", "2", "data.frame_start", "3353",
                    "data.ratio", "1.0", "data.sequences", ",".join(seqs)]
    jcfg, cfg = both(opts)
    (jds, jtr, jte), (ds, tr, te) = jax_make_dataset(jcfg), make_dataset(cfg, "cpu")
    assert ds.images.shape[0] == 12
    assert_ds_equal(jds, ds)
    np.testing.assert_array_equal(tr, jtr)
    np.testing.assert_array_equal(te, jte)

    persp = str(tmp_path / "persp")
    jax_write_tree(persp, n_frames=2, hw=(24, 32), n_boxes=3, seed=2)
    one = KITTI + ["data.frame_num", "2", "data.ratio", "1.0"]
    jp, p = both(one + ["data.root", persp, "data.use_fisheye", "false",
                        "data.max_cut_planes", "0"])
    jf, f = both(one + ["data.root", root, "data.sequence", seqs[0], "data.frame_start", "3353"])
    ref = jax_concat([jax_build(jp), jax_build(jf)])
    got = concat_datasets([build_kitti360_dataset(p, "cpu"), build_kitti360_dataset(f, "cpu")])
    assert_ds_equal(ref, got)
    assert got.cam_model[:4].eq(0).all() and bool(got.valid_mask[:4].all())


# ------------------------------------------ reference behaviours (test_kitti360.py)


def _fake_cfg(root, **kw):
    opts = ["data.dataset", "kitti360", "data.root", root, "data.frame_start", "100",
            "data.frame_num", "3", "data.max_primitives", "4", "data.max_intervals", "4",
            "model.num_classes", "19"]
    for k, v in kw.items():
        opts += [f"data.{k}", str(v)]
    return load_config(None, opts)


def test_train_full_bbox_dir_fallback(tmp_path):
    root = str(tmp_path / "kitti")
    os.makedirs(root)
    make_fake_kitti(root)
    shutil.move(os.path.join(root, "data_3d_bboxes", "train"),
                os.path.join(root, "data_3d_bboxes", "train_full"))
    assert bool(build_kitti360_dataset(_fake_cfg(root), "cpu").prim_valid.any())


def test_max_primitives_truncation_warns(fake_root):
    with pytest.warns(UserWarning, match="truncated visible primitives"):
        build_kitti360_dataset(_fake_cfg(fake_root, max_primitives=1), "cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error", UserWarning)
        build_kitti360_dataset(_fake_cfg(fake_root, max_primitives=8), "cpu")


def test_sgm_uint16_png_is_millimeters(tmp_path):
    base = str(tmp_path / "0000000100")
    mm = np.zeros((6, 8), np.uint16)
    mm[2, 3] = 5250
    Image.fromarray(mm).save(base + ".png")
    d = _load_depth(base, (6, 8))
    assert d.dtype == np.float32 and d[2, 3] == pytest.approx(5.25)
    assert d.sum() == pytest.approx(5.25)
    base2 = str(tmp_path / "0000000101")
    np.save(base2 + ".npy", np.full((6, 8), 7.5, np.float32))
    assert _load_depth(base2, (6, 8))[0, 0] == pytest.approx(7.5)


def test_visible_id_positional_when_xml_has_no_index(tmp_path):
    root = str(tmp_path / "kitti")
    seq = make_fake_kitti(root)
    xml_path = f"{root}/data_3d_bboxes/train/{seq}.xml"
    tree = ET.parse(xml_path)
    for obj in tree.getroot():
        obj.remove(obj.find("index"))
    tree.write(xml_path)
    boxes = parse_bbox_xml(xml_path)
    assert all(b.index == -1 for b in boxes)
    assert [b.ordinal for b in boxes] == list(range(len(boxes)))
    ds = build_kitti360_dataset(_fake_cfg(root), "cpu")
    assert int(ds.prim_valid[4].sum()) == 1 and int(ds.prim_sem[4, 0]) == 13
    assert_ds_equal(jax_build(jax_load_config(None, [
        "data.dataset", "kitti360", "data.root", root, "data.frame_start", "100",
        "data.frame_num", "3", "data.max_primitives", "4", "data.max_intervals", "4",
        "model.num_classes", "19"])), ds)


def test_visible_id_ordinal_expands_concave_pieces(tmp_path):
    rootel = ET.Element("opencv_storage")
    obj = ET.SubElement(rootel, "object_0")
    T = np.eye(4)
    T[:3, 3] = [0, 0, 10]
    l2d = np.array([[0, 0], [2, 0], [2, 1], [1, 1], [1, 3], [0, 3]], float)
    poly = np.concatenate([np.stack([l2d[:, 0], np.full(6, -1.0), l2d[:, 1]], 1),
                           np.stack([l2d[:, 0], np.full(6, 1.0), l2d[:, 1]], 1)])
    for name, a in (("transform", T), ("vertices", poly), ("faces", np.zeros((8, 4)))):
        _mat_xml(obj, name, a)
    for k, v in (("label", "building"), ("semanticId", "11"), ("instanceId", "7"),
                 ("start_frame", "0"), ("end_frame", "10"), ("timestamp", "-1"),
                 ("dynamic", "0")):
        ET.SubElement(obj, k).text = v
    xml_path = str(tmp_path / "seq.xml")
    ET.ElementTree(rootel).write(xml_path)
    boxes = parse_bbox_xml(xml_path)
    assert len(boxes) >= 2 and all(b.ordinal == 0 for b in boxes)
    assert all(b.instance_id == boxes[0].instance_id for b in boxes)
    from panopticnerf_tpu.data.annotation3d import parse_bbox_xml as jax_parse

    for a, b in zip(jax_parse(xml_path), boxes):
        np.testing.assert_array_equal(b.world_to_prim, a.world_to_prim)
        np.testing.assert_array_equal(b.cut_planes, a.cut_planes)
    np.save(os.path.join(str(tmp_path), "0000000005.npy"), np.array([0]))
    assert load_visible_ids(str(tmp_path), 5).tolist() == [0]


def test_depth_plane_z_converted_to_ray_distance(fake_root):
    ds = build_kitti360_dataset(_fake_cfg(fake_root, use_stereo=False), "cpu")
    K = np.array([[20.0, 0, W / 2], [0, 20.0, H / 2], [0, 0, 1]])
    factor = plane_z_to_ray_factor(K, (H, W))
    expect = np.where(np.arange(W)[None, :] < W // 2, 10.0 * factor, 0.0)
    np.testing.assert_allclose(ds.depth[0].numpy(), expect, rtol=1e-5)
    ray = build_kitti360_dataset(_fake_cfg(fake_root, use_stereo=False,
                                           depth_convention="ray"), "cpu")
    np.testing.assert_allclose(ray.depth[0].numpy(), np.broadcast_to(
        np.where(np.arange(W)[None, :] < W // 2, 10.0, 0.0), (H, W)), rtol=1e-6)
    with pytest.raises(ValueError, match="depth_convention"):
        build_kitti360_dataset(_fake_cfg(fake_root, depth_convention="zz"), "cpu")


def test_scene_bounds_do_not_depend_on_streams(fake_root):
    base = build_kitti360_dataset(_fake_cfg(fake_root, use_stereo=False), "cpu")
    for kw in (dict(), dict(use_fisheye=True, use_depth=False)):
        other = build_kitti360_dataset(_fake_cfg(fake_root, **kw), "cpu")
        assert torch.equal(base.bounds_center, other.bounds_center)
        assert torch.equal(base.bounds_scale, other.bounds_scale)


# ---------------------------------------------------------------- pseudo labels


@pytest.mark.parametrize("mode,repaint,min_voters", [("pull", 0.0, 2), ("splat", 0.0, 2),
                                                      ("splat", 0.5, 1)])
def test_cross_view_clean_matches_jax(tree, mode, repaint, min_voters):
    jds = jax_build(jax_load_config(None, KITTI + ["data.root", tree, "data.ratio", "1.0"]))
    labels = np.asarray(jds.pseudo).copy()
    rng = np.random.default_rng(0)  # blobs of wrong labels for the vote to catch
    labels[rng.uniform(size=labels.shape) < 0.1] = 8
    args = (labels, np.asarray(jds.depth), np.asarray(jds.K), np.asarray(jds.c2w),
            np.repeat(np.arange(4), 3), np.asarray(jds.cam_model) == 0)
    kw = dict(window=1, tol=0.1, min_voters=min_voters, mode=mode, repaint=repaint)
    want = jax_pseudo.cross_view_clean(*args, **kw)
    got = pseudo.cross_view_clean(*args, **kw)
    np.testing.assert_array_equal(got, want)
    assert (got != labels).any()


@pytest.mark.parametrize("k", [1, 3, 5, 8])
def test_majority_clean_matches_jax(k):
    labels = np.random.default_rng(k).integers(0, 4, (17, 23)).astype(np.int32)
    labels[3:6, 4:9] = 255
    np.testing.assert_array_equal(pseudo.majority_clean(labels, k),
                                  jax_pseudo.majority_clean(labels, k))


@pytest.mark.parametrize("extra", [["data.synthetic_fisheye", "true"],
                                   ["data.pseudo_clean_neighbors", "4"]])
def test_synthetic_fisheye_and_cleaning_bit_equal(extra):
    opts = ["data.synthetic_image_hw", "12,16", "data.synthetic_num_frames", "3",
            "data.synthetic_num_boxes", "3", "model.num_classes", "5"] + extra
    assert_ds_equal(jax_build_synthetic(jax_load_config(None, opts), seed=0),
                    build_synthetic_dataset(load_config(None, opts), "cpu", seed=0), atol=0)


# ---------------------------------------------------------------- the demo tree


@pytest.mark.parametrize("kw", [
    dict(TREE),
    dict(n_frames=2, hw=(24, 40), n_boxes=3, seed=5, n_concave=2, frame_start=3353,
         seq="2013_05_28_drive_0002_sync"),
    dict(n_frames=3, hw=(20, 28), n_boxes=2, seed=1, label_noise=0.2, depth_keep=0.3),
], ids=["fisheye_concave", "offset_two_concave", "noisy"])
def test_demo_tree_equals_jax_writer(tmp_path, kw):
    jax_root, root = str(tmp_path / "j"), str(tmp_path / "p")
    assert jax_write_tree(jax_root, **kw) == write_demo_tree(root, **kw, device="cpu")
    files = sorted(os.path.relpath(os.path.join(d, f), jax_root)
                   for d, _, fs in os.walk(jax_root) for f in fs)
    assert files == sorted(os.path.relpath(os.path.join(d, f), root)
                           for d, _, fs in os.walk(root) for f in fs)
    for rel in files:
        a, b = os.path.join(jax_root, rel), os.path.join(root, rel)
        if rel.endswith(".png"):
            want = np.asarray(Image.open(a))
            got = read_png(b)
            assert got.dtype == want.dtype, rel
            np.testing.assert_array_equal(got, want, err_msg=rel)
        elif rel.endswith(".npy"):
            np.testing.assert_array_equal(np.load(b), np.load(a), err_msg=rel)
        else:
            assert open(a, "rb").read() == open(b, "rb").read(), rel


def test_demo_tree_cli(tmp_path):
    seq = demo_tree_main([str(tmp_path / "t"), "--frames", "2", "--hw", "16,24", "--concave",
                          "1", "--fisheye", "--frame_start", "7", "--device", "cpu"])
    assert os.path.exists(tmp_path / "t" / "data_2d_raw" / seq / "image_02" / "data_rgb"
                          / "0000000008.png")


# ---------------------------------------------------------------- one step


def test_train_step_on_the_tree_matches_jax(tree):
    """One step with fisheye and perspective groups and real cut planes,
    the fused trunk and the grouped intersection, from the same flax init
    with the JAX step's draws."""
    opts = KITTI + ["data.root", tree, "model.use_pallas", "true",
                    "render.use_pallas_intersect", "true"]
    jcfg, cfg = both(opts)
    jds = jax_build(jcfg)
    ds = build_kitti360_dataset(cfg, "cpu")
    assert ds.prim_planes is not None
    view_ids = np.array([0, 2, 5, 7, 8, 11])
    key = jax.random.key(11)
    draws = jax_step_draws(jcfg, key, 0, len(view_ids), (24, 32))
    groups = view_ids[draws["group"]]
    assert set(np.asarray(ds.cam_model)[groups].tolist()) == {0, 1}  # mixed cameras

    jmodel = jax_make_network(jcfg)
    params = jax_init_params(jmodel, jax.random.key(0))
    state = jax_make_train_state(jcfg, jmodel, params)
    new_state, stats = jax_make_train_step(jcfg, jmodel, donate=False)(
        state, jds, jnp.asarray(view_ids), key)

    model = make_network(cfg, "cpu")
    model.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    tstate = make_train_state(cfg, model)
    t = lambda k: torch.from_numpy(draws[k]) if k in draws else None
    got = make_train_step(cfg, model)(
        tstate, ds, torch.from_numpy(view_ids), None,
        StepDraws(BatchDraws(t("group"), t("u"), t("v")),
                  RenderDraws(t("coarse"), t("bg"), t("fine"))))
    assert set(got) == set(stats)
    for k, want in stats.items():
        np.testing.assert_allclose(float(got[k]), float(want), rtol=1e-4, atol=1e-7, err_msg=k)
    new = params_to_flax(model.state_dict())
    want = flatten(jax.tree.map(np.asarray, new_state.params)["params"])
    for k in want:
        np.testing.assert_allclose(new[k], want[k], rtol=0, atol=2e-5, err_msg=k)


# ------------------------------------------------- the export and the repairs


@pytest.fixture(scope="module")
def trained(tmp_path_factory, tree):
    """The tiny tree's copy with one set of flax weights, as a JAX orbax
    checkpoint and as the port's converted .npz (step 1)."""
    base = tmp_path_factory.mktemp("export")
    root = str(base / "tree")
    shutil.copytree(tree, root)
    opts = KITTI + ["data.root", root, "model_dir", str(base / "m"),
                    "result_dir", str(base / "res"), "record_dir", str(base / "rec")]
    jcfg, cfg = both(opts)
    jmodel = jax_make_network(jcfg)
    params = jax_init_params(jmodel, jax.random.key(4))
    jax_save_model(jax_make_train_state(jcfg, jmodel, params), jcfg.trained_model_dir, 1)
    os.makedirs(base / "m" / "torch")
    np.savez(base / "m" / "torch" / "kt_1.npz",
             **{k: np.asarray(v) for k, v in flatten(params["params"]).items()})
    return dict(base=base, root=root, opts=opts, jcfg=jcfg, cfg=cfg)


def _jax_tool():
    import export_label_transfer as jax_tool  # tools/export_label_transfer.py

    return jax_tool


def test_export_encodes_maps_like_the_jax_tool(trained, monkeypatch):
    """Given the same fused maps, both exports decode to the same arrays."""
    import panopticnerf_tpu.eval as jax_eval
    import panopticnerf_tpu_torch.eval as port_eval

    class Fixed:  # the same seeded maps for every view, in both packages
        def __init__(self, *a, **k):
            rng = np.random.default_rng(9)
            self.maps = (rng.integers(0, 19, 24 * 32), rng.integers(0, 3000, 24 * 32))

        def evaluate(self, out):
            return self.maps

    monkeypatch.setattr(jax_eval, "make_evaluator", Fixed)
    monkeypatch.setattr(port_eval, "make_evaluator", Fixed)
    base = trained["base"]
    jfiles = _jax_tool().export(trained["jcfg"], str(base / "enc_j"), log=lambda *a: None)
    files = export_label_transfer.export(trained["cfg"], str(base / "enc_p"), "cpu",
                                         log=lambda *a: None)
    assert [os.path.relpath(f, base / "enc_p") for f in files] == \
        [os.path.relpath(f, base / "enc_j") for f in jfiles]
    for a, b in zip(jfiles, files):
        want = np.asarray(Image.open(a))
        assert read_png(b).dtype == want.dtype
        np.testing.assert_array_equal(read_png(b), want)


def test_export_matches_jax_and_round_trips(trained):
    base, root = trained["base"], trained["root"]
    jfiles = _jax_tool().export(trained["jcfg"], str(base / "exp_j"), log=lambda *a: None)
    files = export_label_transfer.main(["--device", "cpu", "--out", str(base / "exp_p"), "--zip",
                                        *trained["opts"]])
    assert len(files) == 8 and os.path.exists(str(base / "exp_p") + ".zip")
    assert files[0].endswith(os.path.join("train", SEQ, "image_00", "semantic", "0000000000.png"))
    differ = total = 0
    for a, b in zip(jfiles, files):
        want, got = np.asarray(Image.open(a)), read_png(b)
        differ, total = differ + int((want != got).sum()), total + want.size
    assert differ <= 0.001 * total, (differ, total)

    # the port's loader reads the export back as ground truth, exactly
    shutil.rmtree(os.path.join(root, "data_2d_semantics"))
    shutil.copytree(str(base / "exp_p"), os.path.join(root, "data_2d_semantics"))
    ds = build_kitti360_dataset(trained["cfg"], "cpu")
    from panopticnerf_tpu_torch.data import labels as L

    for i in range(4):
        sem, enc = read_png(files[2 * i]).astype(np.int32), read_png(files[2 * i + 1])
        np.testing.assert_array_equal(enc.astype(np.int32) // 1000, sem)
        np.testing.assert_array_equal(ds.gt_sem[3 * i].numpy(), L.ids_to_trainids(sem))
        np.testing.assert_array_equal(ds.gt_inst[3 * i].numpy(), enc.astype(np.int32) % 1000)


def test_evaluate_without_semantic_ground_truth(trained, tmp_path):
    """A tree without data_2d_semantics (the loader allows it): run_evaluate
    renders the test views only and scores PSNR like the JAX package, and
    the in-training evaluation and save_best's metric agree with it."""
    root = str(tmp_path / "nogt")
    shutil.copytree(trained["root"], root)
    shutil.rmtree(os.path.join(root, "data_2d_semantics"))
    opts = trained["opts"] + ["data.root", root]
    jcfg, cfg = both(opts)
    res = engine.run_evaluate(cfg, "cpu", log=lambda *a: None)
    _, _, test_ids = make_dataset(cfg, "cpu")
    assert res["views"] == sorted(int(v) for v in test_ids) and "miou" not in res
    ref = jax_engine.run_evaluate(jcfg, log=lambda *a: None)
    assert set(k for k in ref if np.isscalar(ref[k])) == \
        set(k for k in res if np.isscalar(res[k]) and k != "step")
    assert abs(res["psnr"] - ref["psnr"]) <= 1e-3

    ds, _, model, _ = engine._restore_for_eval(cfg, "cpu")
    ev = engine.evaluate_views(cfg, model, ds, test_ids)
    jds, _, jmodel, params, _ = jax_engine._restore_for_eval(jcfg)
    jev = jax_engine.evaluate_views(jcfg, jmodel, params, jds, test_ids)
    assert set(ev) == set(jev) and abs(ev["psnr"] - jev["psnr"]) <= 1e-3
    assert engine._selection_metric(ev) == (ev["psnr"], "psnr")  # no mIoU: PSNR selects


@pytest.mark.parametrize("entry", ["make_dataset", "run_train"])
def test_stream_window_is_refused_until_ported(tree, entry, tmp_path):
    """Streaming (ROADMAP 1.6), refused before it was ported, now runs on the
    tree (12 views: 8 for training, 4 held out). `make_dataset` keeps the
    pool on the host whatever the device (asked for CUDA here, where there
    is none), equal to the unstreamed pool; `run_train` trains on windows of
    4 training views redrawn every 2 steps with the reference's draws,
    logging each refresh."""
    opts = KITTI + ["data.root", tree, "data.stream_window", "4",
                    "data.stream_refresh_steps", "2", "model_dir", str(tmp_path / "m"),
                    "record_dir", str(tmp_path / "rec")]
    cfg = load_config(None, opts)
    if entry == "make_dataset":
        ds, train_ids, test_ids = make_dataset(cfg, "cuda")
        ref, ref_train, ref_test = make_dataset(load_config(None, KITTI + ["data.root", tree]),
                                                "cpu")
        np.testing.assert_array_equal(train_ids, ref_train)
        np.testing.assert_array_equal(test_ids, ref_test)
        for name, a, b in zip(ds._fields, ref, ds):
            assert (a is None) == (b is None), name
            if a is not None:
                assert b.device.type == "cpu" and torch.equal(a, b), name
    else:
        logs = []
        res = engine.run_train(cfg, "cpu", max_steps=5, log=logs.append)
        _, train_ids, _ = make_dataset(cfg, "cpu")
        rng = np.random.default_rng(cfg.train.seed)
        assert [s for s, _ in res["stream"]["windows"]] == [0, 2, 4]
        for _, ids in res["stream"]["windows"]:
            np.testing.assert_array_equal(ids, np.sort(rng.choice(train_ids, 4, replace=False)))
        assert sum(line.startswith("stream window refresh") for line in logs) == 2
        assert np.isfinite(res["losses"]).all() and len(res["losses"]) == 5


def test_kitti360_modules_import_no_jax_and_no_pil():
    code = (
        "import sys\n"
        "import panopticnerf_tpu_torch.data.kitti360, panopticnerf_tpu_torch.data.demo_tree\n"
        "import panopticnerf_tpu_torch.data.image, panopticnerf_tpu_torch.export_label_transfer\n"
        "import panopticnerf_tpu_torch.data.annotation3d, panopticnerf_tpu_torch.data.pseudo\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'panopticnerf_tpu', 'PIL', 'imageio'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr
