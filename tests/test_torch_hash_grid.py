"""PanopticNeRF-360's hybrid field in the port (`ops/hash_grid.py`, `models/nerf.py`
`HashGrid`, the heads on [h, g]), on the CPU: the grid's sizes and indexing by hand; the
plain encoding, the hybrid field, a small view's maps and one trunk-mode training step's
loss and every leaf's gradient against the benchmark's plain reference
(`benchmark/reference/hybrid.py`, which imports nothing of the port); the evaluation
adapter's plain path and counters; the training modes that have no grid input raising;
the config, the draw and the checkpoint conversion of the tables. The JAX package has no
grid: these hold the port to that reference instead."""

import dataclasses
import importlib.util
import os
import sys

import pytest
import torch

from panopticnerf_tpu_torch.config import ModelConfig, load_config
from panopticnerf_tpu_torch.config.config import to_dict
from panopticnerf_tpu_torch.convert import params_from_flax, params_to_flax
from panopticnerf_tpu_torch.models import init_params, make_network
from panopticnerf_tpu_torch.models.eval_field import EvalField
from panopticnerf_tpu_torch.models.fused_apply import FusedTrainAdapter
from panopticnerf_tpu_torch.models.nerf import NeRFMLP, coarse_field_cfg
from panopticnerf_tpu_torch.ops.field_eval import eval_dims, grid_evaluator
from panopticnerf_tpu_torch.ops.hash_grid import GRID, GridSpec, corner_rows, hash_grid_encode
from panopticnerf_tpu_torch.ops.intersect import Primitives
from panopticnerf_tpu_torch.render import renderer
from panopticnerf_tpu_torch.utils import profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(REPO, "benchmark")
GRID_YAML = os.path.join(REPO, "configs", "torch", "kitti360_grid.yaml")


def _reference():
    """benchmark/reference/hybrid.py, loaded by path (it imports reference.nerf)."""
    if BENCH not in sys.path:
        sys.path.insert(0, BENCH)
    spec = importlib.util.spec_from_file_location(
        "reference.hybrid", os.path.join(BENCH, "reference", "hybrid.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _small_cfg(extra=()):
    """configs/torch/kitti360_grid.yaml at narrow widths (the narrowest E takes)."""
    return load_config(GRID_YAML, ["model.trunk_width", "64", "model.color_width", "16",
                                   "render.n_samples", "16", "render.n_importance", "16",
                                   "render.ray_tile", "64", *extra])


def test_the_sixteen_resolutions():
    assert GRID == GridSpec(levels=16, features=2, log2_table=19, min_res=16, max_res=2048)
    assert GRID.resolutions == (16, 22, 30, 42, 58, 80, 111, 153, 212, 294, 406, 561, 776, 1072,
                                1482, 2048)
    assert GRID.dense == (True,) * 5 + (False,) * 11
    assert GRID.rows[:5] == (17 ** 3, 23 ** 3, 31 ** 3, 43 ** 3, 59 ** 3)
    assert GRID.rows[5:] == (1 << 19,) * 11 and GRID.dim == 32
    assert sum(GRID.rows) * 2 * 4 == pytest.approx(48.8e6, rel=1e-3)  # ~49 MB a field


def test_the_hash_of_known_corners():
    """(k0 * 1 ^ k1 * 2654435761 ^ k2 * 805459861) mod T in uint32 arithmetic, by hand."""
    t = 1 << 19
    for k in [(0, 0, 0), (1, 0, 0), (0, 1, 0), (0, 0, 1), (80, 80, 80), (2048, 7, 1999)]:
        want = ((k[0] * 1) % 2 ** 32 ^ (k[1] * 2654435761) % 2 ** 32
                ^ (k[2] * 805459861) % 2 ** 32) % t
        got = corner_rows(*(torch.tensor([c]) for c in k), 80, False, t)
        assert int(got) == want, k
    assert int(corner_rows(torch.tensor([0]), torch.tensor([1]), torch.tensor([0]), 80, False,
                           t)) == 2654435761 % t == 489905
    assert int(corner_rows(torch.tensor([0]), torch.tensor([0]), torch.tensor([1]), 80, False,
                           t)) == 805459861 % t == 153493


def _one_hot_tables(level, row):
    tables = [torch.zeros(r, GRID.features) for r in GRID.rows]
    tables[level][row] = torch.tensor([1.0, -2.0])
    return tables


@pytest.mark.parametrize("level", range(5))
def test_dense_indexing(level):
    """On the dense levels 0-4 a point on a grid vertex k reads row k0 + k1 (N + 1) + k2
    (N + 1)^2 with weight 1, and only that row."""
    res = GRID.resolutions[level]
    k = (3, res - 1, 5)
    row = k[0] + k[1] * (res + 1) + k[2] * (res + 1) ** 2
    u = torch.tensor([[c / res for c in k]], dtype=torch.float64).float()
    pts = u * 2 - 1
    g = hash_grid_encode(pts, _one_hot_tables(level, row))
    want = torch.zeros(1, 32)
    want[0, 2 * level:2 * level + 2] = torch.tensor([1.0, -2.0])
    assert torch.allclose(g, want, atol=1e-6)


def test_the_border_clamp():
    """u = 1 (and any point beyond the cube) lies in the last cell, i = N - 1, t = 1: it
    reads corner N of that axis with weight 1; below the cube, corner 0."""
    res = GRID.resolutions[2]
    row = res + res * (res + 1) + 0 * (res + 1) ** 2  # corner (N, N, 0)
    tables = _one_hot_tables(2, row)
    for p in ([1.0, 1.0, -1.0], [3.0, 1.5, -7.0]):
        g = hash_grid_encode(torch.tensor([p]), tables)
        assert torch.equal(g[0, 4:6], torch.tensor([1.0, -2.0])), p
        assert float(g.abs().sum()) == 3.0


def _hybrid_field(cfg, seed):
    """A NeRFMLP with the hybrid reference's seeded draw loaded (tables in +-1)."""
    ref = _reference()
    conf = to_dict(cfg)
    w = ref.make_weights(conf, seed, "cpu")
    model = make_network(cfg, "cpu").eval()
    model.load_state_dict(w)
    return ref, conf, w, model


def test_the_encoding_and_the_field_against_the_reference():
    """The plain encoding equals the reference's bit for bit on every level (dense and
    hashed), and the hybrid field's sigma, rgb and logits equal the reference field's, at
    both levels (the fine 8x64 trunk, the 4x64 proposal coarse)."""
    cfg = _small_cfg()
    ref, conf, w, model = _hybrid_field(cfg, 3)
    g = torch.Generator().manual_seed(0)
    pts = (torch.rand(40, 12, 3, generator=g) * 2 - 1) * 1.3
    dirs = torch.nn.functional.normalize(torch.randn(40, 1, 3, generator=g), dim=-1)
    for level, prefix in ((0, "coarse"), (1, "fine")):
        net = model.coarse if level == 0 else model.fine
        enc = hash_grid_encode(pts, net.grid.tables())
        assert torch.equal(enc, ref.grid_encode(w, prefix, pts)), prefix
        with torch.no_grad():
            got = model(pts, dirs, level=level)
        want = ref.hybrid_field(w, conf, level, pts, dirs)
        for name, a, b in zip(("sigma", "rgb", "sem"), got, want):
            assert torch.equal(a, b), (prefix, name)
    assert model.coarse.sigma.in_features == model.fine.sigma.in_features == 64 + 32


def _small_scene():
    """One 8x12 view looking down +z at three boxes, the first cut by a plane."""
    h, w = 8, 12
    centers = torch.tensor([[0.0, 0.0, 4.0], [1.0, 0.3, 6.0], [-1.2, -0.2, 5.0]])
    halves = torch.tensor([[0.8, 0.6, 0.7], [0.9, 0.9, 1.2], [0.5, 0.7, 0.6]])
    w2p = torch.zeros(3, 3, 4)
    w2p[:, range(3), range(3)] = 1.0 / halves
    w2p[:, :, 3] = -centers / halves
    planes = torch.zeros(3, 2, 4)
    planes[:, :, 3] = 1.0
    planes[0, 0] = torch.tensor([0.6, 0.0, 0.8, 0.3])
    K = torch.tensor([[8.0, 0.0, w / 2], [0.0, 8.0, h / 2], [0.0, 0.0, 1.0]])
    return {"images": torch.zeros(1, h, w, 3, dtype=torch.uint8), "K": K[None],
            "c2w": torch.cat([torch.eye(3), torch.zeros(3, 1)], 1)[None],
            "prim_w2p": w2p[None], "prim_planes": planes[None],
            "prim_sem": torch.tensor([[11, 13, 7]]), "prim_inst": torch.tensor([[1, 2, 3]]),
            "prim_valid": torch.tensor([[True, True, True]]),
            "bounds_center": torch.tensor([0.0, 0.0, 5.0]), "bounds_scale": torch.tensor(0.125)}


@pytest.mark.parametrize("adapter", [False, True])
def test_a_small_view_against_the_reference(adapter):
    """A whole view through the port's `intersect_and_render` (plain model, or the evaluation
    adapter that kernels G and E take on the card, here on its plain versions) against the
    reference's `render_view` on the same seeded weights: rgb, depth and the composited
    logits within float rounding; the adapter's counters hold every point of both levels."""
    cfg = _small_cfg()
    ref, conf, w, model = _hybrid_field(cfg, 5)
    scene = _small_scene()
    o, d = sys.modules["reference.nerf"].view_rays(scene, 0)
    prims = Primitives(scene["prim_w2p"][0], scene["prim_sem"][0].int(),
                       scene["prim_inst"][0].int(), scene["prim_valid"][0],
                       scene["prim_planes"][0])
    bounds = renderer.SceneBounds(scene["bounds_center"], scene["bounds_scale"])
    field = model
    if adapter:
        dims = {lv: eval_dims(c) for lv, c in ((0, coarse_field_cfg(cfg.model, True)),
                                                (1, cfg.model))}
        assert all(dm.grid_dim == 32 for dm in dims.values())
        field = EvalField(model, dims)
    profiling.reset()
    with torch.no_grad():
        out = renderer.intersect_and_render(cfg, field, o, d, prims, bounds)
    want = ref.render_view(w, conf, scene, 0)
    n = o.shape[0]
    points = profiling.calls("render.field.points")
    assert points == 64 * (16 + 32) * -(-n // 64)  # 96 rays in 2 tiles of 64
    if adapter:
        assert profiling.calls("render.grid.points") == points
        assert profiling.calls("render.field.points_fused") == points
    profiling.reset()
    assert torch.allclose(out.rgb, want["rgb"], atol=1e-6)
    assert torch.allclose(out.depth, want["depth"], rtol=1e-6, atol=1e-5)
    assert torch.allclose(out.sem_logits, want["sem_logits"], rtol=1e-5, atol=1e-5)
    assert float(out.rgb.std()) > 0


def _train_side(mode):
    """The benchmark's training driver (harness/train.py) on kitti360_grid at a small size:
    the program's first step (its loss, every leaf's gradient from Adam's first moment) and
    the reference Trainer's on the same weights and draws."""
    import json
    import tempfile

    if BENCH not in sys.path:
        sys.path.insert(0, BENCH)
    from harness import core
    from harness import train as drv

    conf = core.load_json(os.path.join(BENCH, "configs", "kitti360_grid.json"))
    small = {"scene": {"frames": 2, "hw": [24, 88]},
             "program": {"data": {"n_rays": 128},
                         "model": {"trunk_width": 32, "color_width": 16,
                                   "use_pallas": mode != "plain"},
                         "render": {"n_samples": 16, "n_importance": 16}}}
    conf = core.merged(conf, small)
    traffic = dict(json.load(open(os.path.join(BENCH, "traffic", "train.json"))), check_steps=1)
    with tempfile.TemporaryDirectory() as tmp:
        ctx = {"device": "cpu", "sync": lambda: None, "seeds": core.sub_seeds(2400000001),
               "conf": conf, "traffic": traffic, "tmpdir": tmp}
        s = drv.setup(ctx)
        ref = drv.reference_side(conf["program"], s)
    return s["side"], ref


@pytest.mark.parametrize("mode", ["trunk", "plain"])
def test_one_training_step_against_the_reference(mode):
    """One step of `make_train_step` (pallas_mode trunk: the trunk through B / B''s plain
    versions, the heads on [h, g], the grid as its plain differentiable encoding; or the
    plain model) against the reference Trainer: the loss, and every leaf's gradient, the 32
    tables included, each within a relative Frobenius error of GRAD_REL of the reference's
    (the trunk's placement differs from flax's by bf16 roundings; the plain model's does
    not)."""
    side, ref = _train_side(mode)
    # measured on the CPU: trunk 7.0e-6 / 0.035 (coarse.grid.table_15), plain 0 / 6.7e-8
    loss_tol, grad_rel = {"trunk": (1e-4, 0.05), "plain": (1e-6, 1e-5)}[mode]
    assert abs(side["losses"][0] - ref["losses"][0]) <= loss_tol * abs(ref["losses"][0])
    grads, ref_g = side["grads1"], ref["grads1"]
    assert set(grads) == set(ref_g)
    tables = [k for k in grads if ".grid.table_" in k]
    assert len(tables) == 32
    norms = {k: float(v.norm()) for k, v in ref_g.items()}
    med = sorted(norms.values())[len(norms) // 2]
    for k in grads:
        err = float((grads[k] - ref_g[k]).norm()) / max(norms[k], 1e-3 * med, 1e-30)
        assert err <= grad_rel, (k, err, norms[k])
    assert all(norms[k] > 0 for k in tables)


@pytest.mark.parametrize("mode", ["field", "hybrid"])
def test_the_whole_field_modes_raise_for_a_grid(mode):
    cfg = _small_cfg(["model.pallas_mode", mode])
    model = make_network(cfg, "cpu")
    with pytest.raises(ValueError, match="grid"):
        FusedTrainAdapter(model, cfg.model, mode=mode)
    from panopticnerf_tpu_torch.train.step import make_train_step

    with pytest.raises(ValueError, match="grid"):
        make_train_step(cfg, model)
    assert isinstance(FusedTrainAdapter(model, cfg.model, mode="trunk"), FusedTrainAdapter)


def test_the_shipped_config_builds_and_draws():
    """configs/torch/kitti360_grid.yaml: kitti360_panoptic's config with a grid on each
    field level; the heads read W + 32 (288 fine, 96 coarse); `init_params` draws the
    tables in +-1e-4 as Instant-NGP does; a field without model.hash_grid has no grid."""
    cfg = load_config(GRID_YAML)
    base = load_config(os.path.join(REPO, "configs", "kitti360_panoptic.yaml"))
    assert cfg.model.hash_grid and not base.model.hash_grid
    assert dataclasses.replace(cfg, exp_name=base.exp_name,
                               model=dataclasses.replace(cfg.model, hash_grid=False)) == base
    model = make_network(cfg, "meta")
    assert model.fine.feature.in_features == 288 and model.coarse.sem_hidden.in_features == 96
    assert [tuple(t.shape) for t in model.fine.grid.tables()] == [(r, 2) for r in GRID.rows]
    assert NeRFMLP(ModelConfig()).grid is None
    small = make_network(_small_cfg(), "cpu")
    init_params(small, torch.Generator().manual_seed(0))
    for t in small.fine.grid.tables() + small.coarse.grid.tables():
        assert 0 < float(t.detach().abs().max()) <= 1e-4


def test_the_tables_convert_and_load():
    """The converted-checkpoint form keeps each table as it is, (rows, F), under its leaf
    name, and reads back bit for bit."""
    model = make_network(_small_cfg(), "cpu")
    init_params(model, torch.Generator().manual_seed(1))
    flat = params_to_flax(model.state_dict())
    assert flat["fine/grid/table_3"].shape == tuple(model.fine.grid.table_3.shape)
    back = params_from_flax(flat)
    assert set(back) == set(model.state_dict())
    assert all(torch.equal(back[k], v) for k, v in model.state_dict().items())


def test_the_grid_evaluator_by_device():
    """On the CPU the grid evaluates as the plain encoding rounded to bf16; a device with no
    implementation raises; E's shapes take the grid's 32 features, or none."""
    cfg = _small_cfg()
    net = make_network(cfg, "cpu").fine
    init_params(net, torch.Generator().manual_seed(2))
    pts = torch.rand(50, 3) * 2 - 1
    got = grid_evaluator(net.grid.tables(), "cpu")(pts)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, hash_grid_encode(pts, net.grid.tables()).bfloat16())
    with pytest.raises(ValueError):
        grid_evaluator(net.grid.tables(), "meta")
    assert eval_dims(cfg.model).grid_dim == 32
    assert eval_dims(dataclasses.replace(cfg.model, hash_grid=False)).grid_dim == 0
