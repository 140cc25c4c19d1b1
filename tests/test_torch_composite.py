"""The choice of kernel V (`ops/composite_cuda.py`, the evaluation render's
compositing on the card) on the CPU: the evaluation branch keeps the plain
compositing ops on a CPU tensor and with gradients on, returns the per-sample
extras there and counts the rays it composites; the wrapper refuses a CPU
tensor before it builds anything; and the benchmark's two readers of V."""

import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

from panopticnerf_tpu_torch.config import load_config
from panopticnerf_tpu_torch.models import make_network
from panopticnerf_tpu_torch.ops import composite_cuda
from panopticnerf_tpu_torch.ops.intersect import BIG, RayIntervals
from panopticnerf_tpu_torch.render import renderer
from panopticnerf_tpu_torch.utils import profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOUNDS = renderer.SceneBounds(torch.zeros(3), torch.tensor(0.25))
N, K = 12, 4


def _cfg():
    return load_config(None, [
        "data.max_intervals", str(K), "model.trunk_depth", "2", "model.trunk_width", "32",
        "model.skips", "0", "model.color_width", "16", "model.num_classes", "5",
        "render.n_samples", "8", "render.n_importance", "8", "render.use_primitives", "true",
        "render.near", "0.5", "render.far", "6.0"])


def _inputs(seed=0):
    g = torch.Generator().manual_seed(seed)
    o = torch.randn(N, 3, generator=g) * 0.1
    d = torch.nn.functional.normalize(torch.randn(N, 3, generator=g), dim=-1)
    t_in = (0.5 + 4.0 * torch.rand(N, K, generator=g)).sort(-1).values
    mask = torch.rand(N, K, generator=g) < 0.8
    sem = torch.where(mask, torch.randint(-1, 5, (N, K), generator=g), -1).to(torch.int32)
    iv = RayIntervals(torch.where(mask, t_in, BIG), torch.where(mask, t_in + 1.0, BIG),
                      sem, sem.clone(), mask)
    return o, d, iv


@pytest.mark.parametrize("grad", [False, True])
def test_cpu_evaluation_keeps_the_plain_ops(grad):
    """On the CPU, with gradients off and on, the evaluation branch runs the
    plain ops: nothing fused, every ray of both levels counted, the per-sample
    extras and every map returned."""
    cfg = _cfg()
    torch.manual_seed(0)
    model = make_network(cfg, "cpu").eval()
    o, d, iv = _inputs()
    profiling.reset()
    with torch.set_grad_enabled(grad):
        out = renderer.render_rays(model, o, d, BOUNDS, cfg, iv=iv, train=False)
    assert profiling.calls("render.composite.rays") == 2 * N
    assert profiling.calls("render.composite.rays_fused") == 0
    assert profiling.calls("kernels.launch.V") == 0
    profiling.reset()
    for o_ in (out, out.coarse):
        assert o_.sample_inside_k is not None and o_.sample_cnt is not None
        assert o_.sample_inside_k.shape == (N, o_.z.shape[1], K)
        assert o_.sem_fixed is not None and o_.inst_mass is not None
    assert out.rgb.requires_grad == grad


def test_chooser_reads_only_its_inputs():
    """The evaluation branch's choice: never on a CPU tensor or with
    gradients on; the shapes V takes (S >= 1, K <= 32, C <= 128)."""
    _, _, iv = _inputs()
    with torch.no_grad():
        assert not renderer._fused_composite_takes(torch.zeros(N, 8), None, iv, 5)
    assert composite_cuda.takes(128, 16, 19) and composite_cuda.takes(1, 0, 0)
    assert composite_cuda.takes(96, 32, 128)
    assert not composite_cuda.takes(0, 16, 19)
    assert not composite_cuda.takes(64, 33, 19)
    assert not composite_cuda.takes(64, 16, 129)


def test_wrapper_refuses_a_cpu_tensor():
    _, _, iv = _inputs()
    sigma, rgb, z = torch.zeros(N, 8), torch.zeros(N, 8, 3), torch.zeros(N, 8)
    with pytest.raises(ValueError):
        composite_cuda.composite_cuda(sigma, rgb, z, iv=iv, num_classes=5)


def _reader(name):
    bench = os.path.join(REPO, "benchmark")
    if bench not in sys.path:
        sys.path.insert(0, bench)
    spec = importlib.util.spec_from_file_location(name.replace(".", "_"),
                                                  os.path.join(bench, "metrics", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_composite_readers():
    """`render_composite_fused_pct.render`: V's rays over every composited
    ray, None without the counters. `composite_roofline.render`: V's own
    bytes at HBM's rate over its device time, None where the trace holds no
    kernel of V (a program without it)."""
    fused = _reader("render_composite_fused_pct.render").read
    profiling.reset()
    assert fused({}) is None
    profiling.count("render.composite.rays", 400)
    profiling.count("render.composite.rays_fused", 100)
    assert fused({}) == 25.0
    profiling.reset()

    roof = _reader("composite_roofline.render")
    cfg = load_config(os.path.join(REPO, "configs", "kitti360_panoptic.yaml"))
    trace = lambda s, e: {"units": 2, "layers": {"renderer": {"seconds": s, "events": e}}}
    assert roof.read({"cfg": cfg, "n_rays": 132352, "trace": trace(0.0, 0)}) is None
    assert roof.read({"cfg": cfg, "n_rays": 132352,
                      "trace": {"units": 2, "layers": {}}}) is None
    # kitti360: 64 + 128 samples of 100 bytes a point and 19 classes, K = 16
    per_ray = roof.level_bytes(64, 19, 16, 19, False) + roof.level_bytes(128, 19, 16, 19, False)
    assert roof.level_bytes(1, 19, 0, 0, False) == 100 + 20 + 76
    least = per_ray * 132352 * 2 / 3.35e12
    assert roof.read({"cfg": cfg, "n_rays": 132352,
                      "trace": trace(4 * least, 8)}) == pytest.approx(25.0)
    assert np.isclose(least / 2 * 1e3, 0.79, atol=0.01)  # ms a view, 0.76 of it the points
