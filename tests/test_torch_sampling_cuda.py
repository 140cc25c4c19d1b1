"""The choice of kernel Z (`ops/sampling_cuda.py`, the evaluation render's
sampling on the card) on the CPU: the evaluation branch keeps the plain
sampling ops on a CPU tensor, with gradients on, with jitter and at shapes
beyond Z's limits, and counts the rays it samples at each level; the wrapper
refuses a CPU tensor and the shapes it does not take before it builds
anything; the rows Z shares across rays are the plain functions' own; and
the benchmark's reader of Z's share."""

import importlib.util
import os
import sys

import pytest
import torch

from panopticnerf_tpu_torch.config import load_config
from panopticnerf_tpu_torch.models import make_network
from panopticnerf_tpu_torch.ops import sampling, sampling_cuda
from panopticnerf_tpu_torch.ops.intersect import BIG, RayIntervals
from panopticnerf_tpu_torch.render import renderer
from panopticnerf_tpu_torch.utils import profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOUNDS = renderer.SceneBounds(torch.zeros(3), torch.tensor(0.25))
N, K = 12, 4


def _cfg(*extra):
    return load_config(None, [
        "data.max_intervals", str(K), "model.trunk_depth", "2", "model.trunk_width", "32",
        "model.skips", "0", "model.color_width", "16", "model.num_classes", "5",
        "render.n_samples", "8", "render.n_importance", "8", "render.use_primitives", "true",
        "render.near", "0.5", "render.far", "6.0", *extra])


def _inputs(seed=0, k=K):
    g = torch.Generator().manual_seed(seed)
    o = torch.randn(N, 3, generator=g) * 0.1
    d = torch.nn.functional.normalize(torch.randn(N, 3, generator=g), dim=-1)
    t_in = (0.5 + 4.0 * torch.rand(N, k, generator=g)).sort(-1).values
    mask = torch.rand(N, k, generator=g) < 0.8
    sem = torch.where(mask, torch.randint(-1, 5, (N, k), generator=g), -1).to(torch.int32)
    iv = RayIntervals(torch.where(mask, t_in, BIG), torch.where(mask, t_in + 1.0, BIG),
                      sem, sem.clone(), mask)
    return o, d, iv


@pytest.mark.parametrize("case", ["no_grad", "grad", "perturb", "wide"])
def test_cpu_evaluation_keeps_the_plain_sampling(case):
    """On the CPU the evaluation branch samples with the plain ops, whatever
    the gradients, the jitter or the shapes: both levels' rays counted,
    none fused, no launch of Z; the depths those ops give."""
    extra = {"perturb": ["render.perturb", "true"],
             "wide": ["render.n_samples", "8", "render.n_importance", "1100"]}.get(case, [])
    cfg = _cfg(*extra)
    torch.manual_seed(0)
    model = make_network(cfg, "cpu").eval()
    o, d, iv = _inputs()
    profiling.reset()
    with torch.set_grad_enabled(case == "grad"):
        out = renderer.render_rays(model, o, d, BOUNDS, cfg, iv=iv, train=False)
    assert profiling.calls("render.sample.rays") == 2 * N
    assert profiling.calls("render.sample.rays_fused") == 0
    assert profiling.calls("kernels.launch.Z") == 0
    profiling.reset()
    rc = cfg.render
    z = sampling.guided_z(iv, rc.n_samples, rc.near, rc.far, False, rc.bg_sample_frac)
    assert torch.equal(out.coarse.z, z)
    w = out.coarse.weights.detach()
    z_fine = sampling.sample_pdf(0.5 * (z[:, 1:] + z[:, :-1]), w[:, 1:-1], rc.n_importance,
                                 False)
    assert torch.equal(out.z, sampling.merge_z(z, z_fine))


def test_training_counts_no_sampled_rays():
    """The training branch counts nothing (only evaluated tiles are counted)."""
    cfg = _cfg()
    torch.manual_seed(0)
    model = make_network(cfg, "cpu")
    o, d, iv = _inputs()
    profiling.reset()
    renderer.render_rays(model, o, d, BOUNDS, cfg, iv=iv, train=True,
                         generator=torch.Generator().manual_seed(1))
    assert profiling.calls("render.sample.rays") == 0
    assert profiling.calls("kernels.launch.Z") == 0
    profiling.reset()


def test_stratified_coarse_level_is_counted_once_per_level():
    """Without primitives the coarse level runs `stratified_z` (no Z there);
    both levels of each tile are still counted."""
    cfg = _cfg("render.use_primitives", "false", "render.ray_tile", "4")
    torch.manual_seed(0)
    model = make_network(cfg, "cpu").eval()
    o, d, _ = _inputs()
    profiling.reset()
    renderer.render_image_rays(model, o, d, BOUNDS, cfg)
    assert profiling.calls("render.sample.rays") == 2 * N  # 3 tiles of 4 rays, 2 levels
    assert profiling.calls("render.sample.rays_fused") == 0
    profiling.reset()


def test_chooser_reads_only_its_inputs():
    """Never on a CPU tensor, with gradients on or with jitter; the shapes Z
    takes cover every shipped config's evaluation shapes."""
    t = torch.zeros(N, K)
    with torch.no_grad():
        assert not renderer._fused_sampling_takes(t, False, True)
    assert sampling_cuda.takes_coarse(16, 48, 16) and sampling_cuda.takes_fine(64, 64)
    assert sampling_cuda.takes_coarse(8, 36, 12)      # synthetic_panoptic: 48 at K = 8
    assert sampling_cuda.takes_coarse(32, 1, 0) and sampling_cuda.takes_coarse(1, 1000, 24)
    assert sampling_cuda.takes_fine(3, 1) and sampling_cuda.takes_fine(128, 896)
    assert not sampling_cuda.takes_coarse(33, 48, 16)
    assert not sampling_cuda.takes_coarse(0, 48, 16)
    assert not sampling_cuda.takes_coarse(16, 0, 1)
    assert not sampling_cuda.takes_coarse(16, 1000, 25)
    assert not sampling_cuda.takes_fine(2, 64)
    assert not sampling_cuda.takes_fine(64, 0)
    assert not sampling_cuda.takes_fine(64, 961)


def test_wrapper_refuses_what_it_does_not_take():
    """A CPU tensor, and shapes past Z's limits, raise before anything is built."""
    _, _, iv = _inputs()
    with pytest.raises(ValueError, match="CUDA"):
        sampling_cuda.guided_z_cuda(iv, 8, 0.5, 6.0)
    with pytest.raises(ValueError, match="CUDA"):
        sampling_cuda.fine_z_cuda(torch.zeros(N, 8), torch.zeros(N, 8), 8)
    _, _, wide = _inputs(k=33)
    with pytest.raises(ValueError, match="K 33"):
        sampling_cuda.guided_z_cuda(wide, 8, 0.5, 6.0)
    with pytest.raises(ValueError, match="S_in 0"):
        sampling_cuda.guided_z_cuda(iv, 1, 0.5, 6.0, 0.25)
    with pytest.raises(ValueError, match="S 2"):
        sampling_cuda.fine_z_cuda(torch.zeros(N, 2), torch.zeros(N, 2), 8)
    with pytest.raises(ValueError, match="n_importance 1000"):
        sampling_cuda.fine_z_cuda(torch.zeros(N, 64), torch.zeros(N, 64), 1000)
    with pytest.raises(ValueError, match="expected"):
        sampling_cuda.fine_z_cuda(torch.zeros(N), torch.zeros(N), 8)


@pytest.mark.parametrize("s,bg", [(64, 0.25), (48, 0.25), (9, 0.0)])
def test_shared_rows_are_the_plain_functions_own(s, bg):
    """The rows Z reads (computed here on the CPU as on the card): a ray
    that hits nothing gets guided_z's fallback merged with its background,
    a ray with one interval gets frac x its length from the entry, and the
    fine positions are sample_pdf's."""
    s_in, s_bg = sampling.guided_split(s, bg)
    frac, z_fb, z_bg = sampling_cuda._coarse_rows(torch.device("cpu"), s_in, s_bg, 0.5, 6.0)
    t_in = torch.tensor([[BIG, BIG], [1.0, BIG]])
    t_out = torch.tensor([[BIG, BIG], [3.5, BIG]])
    mask = torch.tensor([[False, False], [True, False]])
    iv = RayIntervals(t_in, t_out, -torch.ones(2, 2, dtype=torch.int32),
                      -torch.ones(2, 2, dtype=torch.int32), mask)
    z = sampling.guided_z(iv, s, 0.5, 6.0, False, bg)
    z_hit = 1.0 + (frac * 2.5 - 0.0)
    want = [z_fb, z_hit] if z_bg is None else [sampling.merge_sorted(r[None], z_bg[None])[0]
                                                for r in (z_fb, z_hit)]
    assert torch.equal(z, torch.stack(want))
    # one bin [0, 1] of weight 1: cdf [0, 1], so sample_pdf returns its u exactly
    u = sampling_cuda._fine_positions(torch.device("cpu"), 64)
    assert torch.equal(sampling.sample_pdf(torch.tensor([[0.0, 1.0]]), torch.ones(1, 1), 64,
                                           False), u[None])


def _reader(name):
    bench = os.path.join(REPO, "benchmark")
    if bench not in sys.path:
        sys.path.insert(0, bench)
    spec = importlib.util.spec_from_file_location(name.replace(".", "_"),
                                                  os.path.join(bench, "metrics", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_sampling_fused_reader():
    """`render_sampling_fused_pct.render`: Z's rays over every sampled ray,
    None without the counters (a program without Z)."""
    fused = _reader("render_sampling_fused_pct.render").read
    profiling.reset()
    assert fused({}) is None
    profiling.count("render.sample.rays", 400)
    profiling.count("render.sample.rays_fused", 300)
    assert fused({}) == 75.0
    profiling.reset()
