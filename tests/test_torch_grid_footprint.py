"""Kernel G's lane-paired gathers on the CPU: the footprint model
(`ops.hash_grid_cuda.gather_footprint`, the distinct 128-byte lines and 32-byte sectors each
warp load touches) by hand and on ray-ordered points, the evaluation adapter's counter
`render.grid.points_paired`, and the benchmark's reader `render_grid_paired_pct.render`. The
kernel itself runs on the card only (`tests/test_torch_cuda.py`)."""

import importlib.util
import os

import pytest
import torch

from panopticnerf_tpu_torch.config import load_config
from panopticnerf_tpu_torch.models import eval_field as eval_field_mod
from panopticnerf_tpu_torch.models import init_params, make_network
from panopticnerf_tpu_torch.models.eval_field import EvalField
from panopticnerf_tpu_torch.models.nerf import coarse_field_cfg
from panopticnerf_tpu_torch.ops.field_eval import eval_dims
from panopticnerf_tpu_torch.ops.hash_grid import GRID, hash_grid_encode
from panopticnerf_tpu_torch.ops.hash_grid_cuda import GridKernel, gather_footprint
from panopticnerf_tpu_torch.utils import profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRID_YAML = os.path.join(REPO, "configs", "torch", "kitti360_grid.yaml")


def _point(i0, i1, i2, frac=0.5, level=0):
    """A scene-normalised point in cell (i0, i1, i2) of `level`, `frac` into it on each axis."""
    res = GRID.resolutions[level]
    u = torch.tensor([[(i + frac) / res for i in (i0, i1, i2)]], dtype=torch.float64)
    return (u * 2 - 1).float()


def test_the_footprint_by_hand():
    """Level 0 (dense, N = 16, rows k0 + 17 k1 + 289 k2). Cell (0, 0, 0): corners at rows 0,
    1, 17, 18, 289, 290, 306, 307, lines 0, 0, 1, 1, 18, 18, 19, 19 (16 rows a line), sectors
    0, 0, 4, 4, 72, 72, 76, 76 (4 rows a sector). 33 points there: one thread a point takes
    two warps of 8 loads, each load one line and one sector (16, 16); lane pairs take three
    warps of 4 loads, each load one line (12, 12). Cell (15, 0, 0): rows 15 and 16 lie in
    lines 0 and 1 and sectors 3 and 4, so the first paired load touches two of each (5, 5);
    one thread a point touches one a load (8, 8). At any level one point alone takes one
    line and one sector a load under one thread a point."""
    pts = _point(0, 0, 0).repeat(33, 1)
    assert gather_footprint(pts, paired=False)[0] == (16, 16)
    assert gather_footprint(pts, paired=True)[0] == (12, 12)
    edge = _point(15, 0, 0)
    assert gather_footprint(edge, paired=False)[0] == (8, 8)
    assert gather_footprint(edge, paired=True)[0] == (5, 5)
    assert gather_footprint(edge, paired=False) == [(8, 8)] * GRID.levels
    assert all(4 <= lines <= 8 and lines <= sectors <= 8
               for lines, sectors in gather_footprint(edge, paired=True))


def _ray_points(rays, samples, seed, centre):
    """`samples` sorted depths on each of `rays` seeded rays, ray-major (G's order), from one
    centre (a panorama) or from origins scattered near the scene's centre (a view's tile)."""
    g = torch.Generator().manual_seed(seed)
    o = (torch.rand(1 if centre else rays, 1, 3, generator=g) * 2 - 1) * 0.3
    d = torch.nn.functional.normalize(torch.randn(rays, 1, 3, generator=g), dim=-1)
    t = torch.rand(rays, samples, 1, generator=g).sort(dim=1).values * 1.5
    return (o + d * t).reshape(-1, 3)


@pytest.mark.parametrize("samples,seed,centre", [(128, 1, True), (64, 2, True),
                                                  (128, 3, False), (64, 4, False)])
def test_pairs_touch_no_more_lines_on_ray_ordered_points(samples, seed, centre):
    """On ray-ordered points the paired gathers touch at most the lines and sectors of one
    thread a point at every level, and about half the lines over the 16 levels."""
    pts = _ray_points(256, samples, seed, centre)
    one, two = gather_footprint(pts, paired=False), gather_footprint(pts, paired=True)
    assert len(one) == len(two) == GRID.levels
    for level, (a, b) in enumerate(zip(one, two)):
        assert b[0] <= a[0] and b[1] <= a[1], (level, a, b)
    lines = [sum(x[0] for x in f) for f in (one, two)]
    assert 0.45 < lines[1] / lines[0] < 0.65, lines


class _PairedGrid:
    """The plain encoding in the place of kernel G, marked as G marks itself."""

    paired = GridKernel.paired

    def __init__(self, tables):
        self.tables = tables

    def __call__(self, pts):
        return hash_grid_encode(pts, self.tables).to(torch.bfloat16)


@pytest.mark.parametrize("paired", [False, True])
def test_the_adapter_counts_paired_points(monkeypatch, paired):
    """`render.grid.points_paired` counts every grid point when the grid is G (marked
    `paired`), and 0 beside `render.grid.points` where it is not (the CPU's plain encoding)."""
    assert GridKernel.paired is True
    cfg = load_config(GRID_YAML, ["model.trunk_width", "64", "model.color_width", "16"])
    model = make_network(cfg, "cpu").eval()
    init_params(model, torch.Generator().manual_seed(4))
    dims = {0: eval_dims(coarse_field_cfg(cfg.model, True)), 1: eval_dims(cfg.model)}
    if paired:
        real = eval_field_mod._evaluator

        def evaluator(net, d, device):
            field, _ = real(net, d, device)
            return field, _PairedGrid(net.grid.tables())

        monkeypatch.setattr(eval_field_mod, "_evaluator", evaluator)
    field = EvalField(model, dims)
    g = torch.Generator().manual_seed(0)
    pts = torch.rand(6, 5, 3, generator=g) * 2 - 1
    dirs = torch.nn.functional.normalize(torch.randn(6, 1, 3, generator=g), dim=-1)
    profiling.reset()
    with torch.no_grad():
        for level in (0, 1):
            field(pts, dirs, level=level)
    assert profiling.calls("render.grid.points") == 60
    assert profiling.calls("render.grid.points_paired") == (60 if paired else 0)
    assert ("render.grid.points_paired", "render.grid.coarse") in profiling.snapshot()
    profiling.reset()


def test_the_paired_share_reader():
    """`render_grid_paired_pct.render`: paired grid points over every grid point; None where
    no grid point was encoded or the program does not count paired points."""
    spec = importlib.util.spec_from_file_location(
        "render_grid_paired_pct_render",
        os.path.join(REPO, "benchmark", "metrics", "render_grid_paired_pct.render.py"))
    reader = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(reader)
    profiling.reset()
    assert reader.read({}) is None
    profiling.count("render.grid.points", 400)
    assert reader.read({}) is None  # a program without the counter
    profiling.count("render.grid.points_paired", 0)
    assert reader.read({}) == 0.0
    profiling.count("render.grid.points_paired", 300)
    assert reader.read({}) == 75.0
    profiling.count("render.grid.points_paired", 100)
    assert reader.read({}) == 100.0
    profiling.reset()
    profiling.count("render.grid.points_paired", 0)
    assert reader.read({}) is None  # no grid point: a configuration without a grid
    profiling.reset()
