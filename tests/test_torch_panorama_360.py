"""PanopticNeRF-360's own setting with the hybrid field (`configs/torch/kitti360_360_grid.yaml`:
both fields 8x256 with a hash grid) rendered as an equirect panorama (`render/panorama.py`),
on the CPU, against the benchmark's plain reference `benchmark/reference/hybrid360.py`
(which imports nothing of the port): the panorama's rays (row order, unit norm, the angles
at the corners); a 16x32 panorama from a small two-sequence fisheye demo tree through the
port's `render_panorama` (the plain model, and the evaluation adapter that kernels G and E
take on the card, here on its plain versions) on the reference's seeded draw; the
panorama's spans and counter. The JAX package has no grid: these hold the port to that
reference instead."""

import importlib.util
import math
import os
import subprocess
import sys

import pytest
import torch

from panopticnerf_tpu_torch.config import load_config
from panopticnerf_tpu_torch.config.config import to_dict
from panopticnerf_tpu_torch.data import make_dataset
from panopticnerf_tpu_torch.data.demo_tree import write_demo_tree
from panopticnerf_tpu_torch.models import make_network
from panopticnerf_tpu_torch.models.eval_field import EvalField
from panopticnerf_tpu_torch.models.nerf import coarse_field_cfg
from panopticnerf_tpu_torch.ops.field_eval import eval_dims
from panopticnerf_tpu_torch.render import panorama_rays, render_panorama
from panopticnerf_tpu_torch.utils import profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(REPO, "benchmark")
YAML = os.path.join(REPO, "configs", "torch", "kitti360_360_grid.yaml")
HW = (16, 32)


def _reference():
    """benchmark/reference/hybrid360.py, loaded by path (it imports reference.nerf and
    reference.hybrid)."""
    if BENCH not in sys.path:
        sys.path.insert(0, BENCH)
    spec = importlib.util.spec_from_file_location(
        "reference.hybrid360", os.path.join(BENCH, "reference", "hybrid360.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_the_reference_imports_nothing_of_the_port_or_jax():
    code = ("import sys; sys.path.insert(0, sys.argv[1]); import reference.hybrid360; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code, BENCH], capture_output=True, text=True,
                         timeout=120, cwd=BENCH)
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "reference" in loaded and "torch" in loaded
    assert not loaded & {"panopticnerf_tpu_torch", "panopticnerf_tpu", "jax", "jaxlib", "flax"}


@pytest.mark.parametrize("hw,seed", [((16, 32), 0), ((5, 7), 1), ((512, 1024), 2)])
def test_panorama_rays_against_the_reference(hw, seed):
    """The port's rays equal the reference's to within an ulp of a unit vector (the port
    rotates by a product with R's transpose, the reference sums R's columns: the same
    three products, rounded in another order); origins bit for bit; unit norm."""
    ref = _reference()
    g = torch.Generator().manual_seed(seed)
    rot, _ = torch.linalg.qr(torch.randn(3, 3, generator=g))
    pos = torch.randn(3, generator=g) * 20
    o, d = panorama_rays(pos, rot, *hw)
    ro, rd = ref.panorama_rays(pos, rot, *hw)
    assert o.shape == d.shape == ro.shape == rd.shape == (hw[0] * hw[1], 3)
    assert torch.equal(o, ro) and torch.equal(o[0], pos)
    assert float((d - rd).abs().max()) <= 2.5e-7
    assert float((d.norm(dim=-1) - 1).abs().max()) <= 1e-6


def test_the_rays_row_order_and_corners():
    """With the camera's own frame (R = I): pixel (v, u) is row v W + u; the top-left
    pixel looks at theta = -pi + pi / W (left, behind), phi = -pi / 2 + pi / (2 H) (up,
    so y < 0 in the y-down frame); the bottom-right at theta = pi - pi / W, phi = pi / 2 -
    pi / (2 H); the grid's middle four pixels look along +z on average."""
    ref = _reference()
    h, w = 6, 8
    for fn in (panorama_rays, ref.panorama_rays):
        _, d = fn(torch.zeros(3), torch.eye(3), h, w)
        angle = lambda v, u: (((u + 0.5) / w) * 2 * math.pi - math.pi,
                              ((v + 0.5) / h) * math.pi - math.pi / 2)
        for v, u in [(0, 0), (0, w - 1), (h - 1, 0), (h - 1, w - 1), (2, 5)]:
            th, ph = angle(v, u)
            want = torch.tensor([math.cos(ph) * math.sin(th), math.sin(ph),
                                 math.cos(ph) * math.cos(th)])
            assert torch.allclose(d[v * w + u], want, atol=1e-6), (fn, v, u)
        assert float(d[0, 1]) < 0 and float(d[-1, 1]) > 0  # top looks up, bottom down
        assert float(d[0, 2]) < 0 and float(d[0, 0]) < 0     # left edge: behind, to the left
        mid = d.view(h, w, 3)[h // 2 - 1: h // 2 + 1, w // 2 - 1: w // 2 + 1].mean((0, 1))
        assert float(mid[2]) > 0.85 and float(mid[:2].abs().max()) < 1e-6


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """The YAML as shipped (both sequences, fisheye, streamed pool) on a tiny tree, at
    narrow widths: -> (cfg, dataset)."""
    root = str(tmp_path_factory.mktemp("pano360"))
    cfg = load_config(YAML, ["data.root", root, "data.frame_num", "2", "data.frame_start", "0",
                             "model.trunk_width", "64", "model.color_width", "16",
                             "render.n_samples", "16", "render.n_importance", "16",
                             "render.ray_tile", "128"])
    for i, sq in enumerate(cfg.data.sequences):
        write_demo_tree(root, n_frames=2, hw=(24, 88), n_boxes=4, seed=i, seq=sq, fisheye=True,
                        n_concave=1, device="cpu")
    ds, _, _ = make_dataset(cfg, "cpu")
    return cfg, ds


@pytest.mark.parametrize("adapter", [False, True])
def test_a_small_panorama_against_the_reference(scene, adapter):
    """A 16x32 panorama of view 1 (4 tiles of 128 rays) through the port's `render_panorama`
    (the plain hybrid model, or the evaluation adapter with hybrid grids on both levels)
    against the reference's `render_panorama` on the same seeded weights. Tolerances: the
    rays may differ by an ulp (above), which moves a sample's depth and a point by float
    rounding; rgb within 1e-6 absolute, depth within 1e-6 relative (depths reach far,
    120 m), logits within 1e-5, the same as the hybrid perspective view's test. Some of
its rays meet a primitive, the others none (the no-interval path). The spans
    `render.panorama` and `render.panorama.rays` open once a panorama, `render.view`
    inside the first, and `render.panorama.pixels` counts H x W."""
    cfg, ds = scene
    ref = _reference()
    conf = to_dict(cfg)
    # the reference refuses fisheye inputs; a panorama reads no image
    conf["data"]["use_fisheye"] = False
    w = ref.make_weights(conf, 5, "cpu")
    model = make_network(cfg, "cpu").eval()
    model.load_state_dict(w)
    field = model
    if adapter:
        dims = {lv: eval_dims(c) for lv, c in ((0, coarse_field_cfg(cfg.model, True)),
                                                (1, cfg.model))}
        assert all(dm.grid_dim == 32 and dm.width == 64 for dm in dims.values())
        field = EvalField(model, dims)
    profiling.reset()
    with torch.no_grad():
        out = render_panorama(field, ds, 1, HW, cfg)
    snap = profiling.snapshot()
    n = HW[0] * HW[1]
    assert snap[("render.panorama", None)]["calls"] == 1
    assert snap[("render.panorama.rays", "render.panorama")]["calls"] == 1
    assert snap[("render.view", "render.panorama")]["calls"] == 1
    assert profiling.calls("render.panorama.pixels") == n == profiling.calls("render.rays")
    points = profiling.calls("render.field.points")
    assert points == n * (16 + 32)
    if adapter:
        assert profiling.calls("render.grid.points") == points
        assert profiling.calls("render.field.points_fused") == points
    profiling.reset()
    want = ref.render_panorama(w, conf, {k: getattr(ds, k) for k in ds._fields}, 1, HW)
    assert out.rgb.shape == (n, 3) and out.sem_logits.shape == (n, 19)
    assert torch.allclose(out.rgb, want["rgb"], atol=1e-6)
    assert torch.allclose(out.depth, want["depth"], rtol=1e-6, atol=1e-5)
    assert torch.allclose(out.sem_logits, want["sem_logits"], rtol=1e-5, atol=1e-5)
    hit = (out.inst_ids >= 0).any(-1).float().mean()  # rays that meet a primitive
    assert 0 < float(hit) < 1 and float(out.rgb.std()) > 0
