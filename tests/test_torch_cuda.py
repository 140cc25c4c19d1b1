"""Tests of the port that need an NVIDIA GPU: each CUDA kernel against its
plain PyTorch version on the card, and the dispatch around it.

Run on a machine with a card: `python -m pytest tests/test_torch_cuda.py -q`.
Without one every test here skips (the `cuda_device` fixture decides at run
time). This file imports no JAX, so it also runs where JAX is absent.
"""

import numpy as np
import pytest
import torch

from panopticnerf_tpu_torch.ops.intersect import (
    BIG,
    Primitives,
    intersect_rays,
    intersect_rays_plain,
)
from panopticnerf_tpu_torch.utils.profiling import calls
from torch_sampling_order import KernelZOrder, against_plain
from torch_scenes import random_boxes, random_rays

pytestmark = pytest.mark.cuda


def launches(kernel: str) -> int:
    """Launches of a kernel (A1, A2, B, B', C, C') so far in this process."""
    return calls(f"kernels.launch.{kernel}")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _to(device, w2p, sem, inst, valid, planes):
    t = lambda a: torch.from_numpy(a).to(device)
    return Primitives(t(w2p), t(sem), t(inst), t(valid),
                      None if planes is None else t(planes))


# P at the 48 KB shared-memory limit of the table: 819 with F = 0, 261 with F = 8
@pytest.mark.parametrize("p,f,k,dup,m", [
    (32, 0, 16, 0, 5000), (32, 8, 16, 0, 5000), (5, 0, 8, 0, 5000), (24, 0, 16, 6, 5000),
    (12, 4, 4, 3, 5000),
    # ragged M, K 1 / 4 / 16 / 32, P 1 / 7 / 32 / 33 / the limit, ties (dup)
    (1, 0, 1, 0, 31), (1, 4, 32, 0, 257), (7, 0, 4, 2, 33), (7, 8, 32, 3, 1),
    (32, 0, 1, 4, 257), (32, 4, 32, 8, 33), (33, 0, 16, 5, 257), (33, 8, 4, 0, 31),
    (261, 8, 16, 10, 257), (261, 8, 32, 0, 33), (819, 0, 32, 20, 257), (819, 0, 1, 3, 1)])
def test_intersect_kernel_matches_plain(cuda_device, p, f, k, dup, m):
    rng = np.random.default_rng(p * 100 + f * 10 + k + m)
    scene, centers = random_boxes(rng, p, f, dup)
    o, d = random_rays(rng, m, centers, n_zero=min(16, m // 4))
    prims = _to(cuda_device, *scene)
    ro, rd = torch.from_numpy(o).to(cuda_device), torch.from_numpy(d).to(cuda_device)
    assert ro.is_contiguous() and prims.world_to_prim.is_contiguous()
    out = intersect_rays(ro, rd, prims, 0.5, 40.0, k)
    ref = intersect_rays_plain(ro, rd, prims, 0.5, 40.0, k)
    torch.cuda.synchronize()
    # Same arithmetic order and no FMA contraction on either side: the two
    # agree exactly; a decision-boundary flip would show up here.
    assert torch.equal(out.mask, ref.mask)
    assert torch.equal(out.semantic, ref.semantic)
    assert torch.equal(out.instance, ref.instance)
    assert torch.equal(out.t_in, ref.t_in)
    assert torch.equal(out.t_out, ref.t_out)
    assert bool((out.t_in[~out.mask] == BIG).all())
    if k > p:
        assert not bool(out.mask[:, p:].any())


def test_intersect_dispatch_counts_launches(cuda_device):
    rng = np.random.default_rng(0)
    scene, centers = random_boxes(rng, 8)
    prims = _to(cuda_device, *scene)
    o, d = random_rays(rng, 64, centers)
    before = launches("A1")
    intersect_rays(torch.from_numpy(o).to(cuda_device),
                   torch.from_numpy(d).to(cuda_device), prims, 0.5, 40.0, 4)
    assert launches("A1") == before + 1


def test_intersect_wrapper_rejects_bad_inputs(cuda_device):
    from panopticnerf_tpu_torch.ops.intersect_cuda import intersect_rays_cuda

    rng = np.random.default_rng(1)
    (w2p, sem, inst, valid, _), centers = random_boxes(rng, 8)
    prims = _to(cuda_device, w2p, sem, inst, valid, None)
    o, d = random_rays(rng, 64, centers)
    ro, rd = torch.from_numpy(o).to(cuda_device), torch.from_numpy(d).to(cuda_device)
    with pytest.raises(ValueError):
        intersect_rays_cuda(ro.cpu(), rd.cpu(), prims, 0.5, 40.0, 4)
    with pytest.raises(TypeError):
        intersect_rays_cuda(ro.double(), rd, prims, 0.5, 40.0, 4)
    with pytest.raises(ValueError):
        intersect_rays_cuda(ro, rd, prims, 0.5, 40.0, 33)
    bad = prims._replace(semantic=prims.semantic.long())
    with pytest.raises(TypeError):
        intersect_rays_cuda(ro, rd, bad, 0.5, 40.0, 4)
    # one primitive past the 48 KB table limit (261 with F = 8 fit)
    (w2p, sem, inst, valid, planes), _ = random_boxes(rng, 262, 8)
    with pytest.raises(ValueError):
        intersect_rays_cuda(ro, rd, _to(cuda_device, w2p, sem, inst, valid, planes), 0.5, 40.0, 4)


def test_tiny_render_cuda_matches_cpu(cuda_device):
    """The whole evaluation render of a tiny synthetic config on the card
    (through the kernel) against the same render on the CPU (through its
    plain version), float32 field with TF32 off."""
    from panopticnerf_tpu_torch import engine
    from panopticnerf_tpu_torch.config import load_config
    from panopticnerf_tpu_torch.data import make_dataset
    from panopticnerf_tpu_torch.models import make_network

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = load_config(None, [
        "data.synthetic_image_hw", "24,40", "data.synthetic_num_frames", "2",
        "data.synthetic_num_boxes", "6", "data.max_primitives", "8",
        "data.max_intervals", "4", "model.trunk_depth", "2", "model.trunk_width", "32",
        "model.skips", "0", "model.color_width", "16", "model.num_classes", "7",
        "model.compute_dtype", "float32", "render.n_samples", "16",
        "render.n_importance", "16", "render.use_primitives", "true",
        "render.ray_tile", "512"])
    torch.manual_seed(0)
    cpu_model = make_network(cfg, "cpu")
    gpu_model = make_network(cfg, cuda_device)
    gpu_model.load_state_dict(cpu_model.state_dict())
    ds_cpu, _, _ = make_dataset(cfg, "cpu")
    ds_gpu, _, _ = make_dataset(cfg, cuda_device)
    before = launches("A1")
    for view in (0, 1):
        ref = engine._render_view(cfg, cpu_model, ds_cpu, view)
        out = engine._render_view(cfg, gpu_model, ds_gpu, view)
        for name in ref._fields:
            a, b = getattr(ref, name), getattr(out, name)
            if a is None:
                assert b is None
                continue
            if a.dtype.is_floating_point:
                torch.testing.assert_close(b.cpu(), a, rtol=1e-4, atol=1e-4)
            else:
                assert torch.equal(b.cpu(), a), name
    assert launches("A1") == before + 2


def test_render_spans_time_the_device(cuda_device):
    """The flagship's view rendered twice under a device-only profiler
    session, as the benchmark's first traced stretch runs it: the session
    sets the flag the spans read, every stage span of `render.view` gets
    its device ms on every call, and the stages sum to no more than the
    view (float rounding of the summed ms aside)."""
    import os

    from torch.autograd import profiler as autograd_profiler

    from panopticnerf_tpu_torch.config import load_config
    from panopticnerf_tpu_torch.data import make_dataset, view_primitives, view_rays
    from panopticnerf_tpu_torch.models import make_network
    from panopticnerf_tpu_torch.render.renderer import SceneBounds, intersect_and_render
    from panopticnerf_tpu_torch.utils import profiling

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = load_config(os.path.join(repo, "configs", "synthetic_flagship.yaml"),
                      ["data.synthetic_num_frames", "2"])
    ds, _, _ = make_dataset(cfg, cuda_device)
    model = make_network(cfg, cuda_device).eval()
    o, d = view_rays(ds, 1)
    render = lambda: intersect_and_render(cfg, model, o, d, view_primitives(ds, 1),
                                          SceneBounds(ds.bounds_center, ds.bounds_scale))
    render()
    torch.cuda.synchronize()
    profiling.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]):
        assert autograd_profiler._is_profiler_enabled
        render()
        render()
        torch.cuda.synchronize()
    snap = profiling.snapshot()
    profiling.reset()
    view = snap[("render.view", None)]
    assert view["calls"] == view["device_calls"] == 2 and view["device_ms"] > 0
    stages = {k: r for k, r in snap.items()
              if k[1] == "render.view" and not k[0].startswith("render.rays")}
    assert len(stages) == 7
    assert all(r["device_calls"] == r["calls"] > 0 and r["device_ms"] > 0 for r in stages.values())
    assert sum(r["device_ms"] for r in stages.values()) <= view["device_ms"] * (1 + 1e-6)


def test_span_cost_on_the_card(cuda_device):
    """A span's host cost on the card's host, beyond an empty loop's: with
    no profiler session (the benchmark's window) a table update and two
    clock reads, a few microseconds; inside a device-only session (the
    benchmark's first traced stretch) also a `record_function` range and two
    CUDA event records, tens of microseconds. Medians of 7 rounds of 500
    spans, under the count at which spans read their events while they
    run; every span of the session is device-timed."""
    import contextlib
    import statistics
    import time

    from panopticnerf_tpu_torch.utils import profiling

    def per_span_us(body, n=500):
        t0 = time.perf_counter()
        for _ in range(n):
            body()
        return 1e6 * (time.perf_counter() - t0) / n

    def empty():
        with contextlib.nullcontext():
            pass

    def one_span():
        with profiling.span("cost"):
            pass

    torch.zeros(1, device=cuda_device)
    cost = {}
    session = {"off": contextlib.nullcontext, "device": lambda: torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA])}
    for mode, make in session.items():
        rounds = []
        for _ in range(7):
            profiling.reset()
            with make():
                rounds.append(per_span_us(one_span) - per_span_us(empty))
                torch.cuda.synchronize()
            row = profiling.snapshot()[("cost", None)]
            assert row["calls"] == 500 and row["device_calls"] == (500 if mode == "device" else 0)
        cost[mode] = statistics.median(rounds)
    profiling.reset()
    print(f"span cost, us: off {cost['off']:.3f}, device session {cost['device']:.3f}")
    assert cost["off"] < 10.0 and cost["device"] < 150.0, cost


@pytest.mark.parametrize("g,m,p,f,k,dup", [
    (4, 300, 12, 4, 8, 2), (8, 256, 32, 0, 16, 4),  # the flagship step's shape
    (3, 1, 7, 8, 32, 2), (5, 31, 33, 0, 4, 3), (2, 257, 1, 0, 1, 0), (8, 33, 261, 8, 16, 6),
    (1, 257, 819, 0, 32, 10), (6, 257, 32, 8, 32, 8)])
def test_grouped_intersect_kernel_matches_plain(cuda_device, g, m, p, f, k, dup):
    """Kernel A2 (the grouped wrapper, grid.y = G) against the per-group
    plain version: bit-equal, as for A1; its own launch counter."""
    from panopticnerf_tpu_torch.ops.intersect import intersect_groups, intersect_groups_plain
    from panopticnerf_tpu_torch.ops.intersect_cuda import intersect_groups_cuda

    rng = np.random.default_rng(11 + g * m + p)
    scenes, rays = [], []
    for _ in range(g):
        scene, centers = random_boxes(rng, p, f, dup)
        scenes.append(scene)
        rays.append(random_rays(rng, m, centers, n_zero=min(4, m // 4)))
    stack = lambda i: None if f == 0 and i == 4 else np.stack([s[i] for s in scenes])
    prims = _to(cuda_device, *(stack(i) for i in range(5)))
    ro = torch.from_numpy(np.stack([r[0] for r in rays])).to(cuda_device)
    rd = torch.from_numpy(np.stack([r[1] for r in rays])).to(cuda_device)
    before = launches("A2")
    out = intersect_groups(ro, rd, prims, 0.5, 40.0, k)
    ref = intersect_groups_plain(ro, rd, prims, 0.5, 40.0, k)
    torch.cuda.synchronize()
    assert launches("A2") == before + 1
    assert out.t_in.shape == (g, m, k)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        intersect_groups_cuda(ro[0], rd[0], prims, 0.5, 40.0, 8)


def _trunk_case(device, n, width, layers, skips, seed):
    from panopticnerf_tpu_torch.ops.mlp_train import F_PAD, pack_trunk

    rng = np.random.default_rng(seed)
    f = 63
    ws = [torch.from_numpy(rng.normal(size=((f if i == 0 else width + (f if i in skips else 0)),
                                             width)).astype(np.float32) * np.sqrt(2.0 / width))
          for i in range(layers)]
    bs = [torch.from_numpy(rng.normal(size=(width,)).astype(np.float32) * 0.1)
          for _ in range(layers)]
    wp, bp = pack_trunk([w.to(device) for w in ws], [b.to(device) for b in bs], skips,
                        torch.bfloat16)
    x = np.zeros((n, F_PAD), np.float32)
    x[:, :f] = rng.uniform(-1, 1, (n, f))
    xp = torch.from_numpy(x).to(device, torch.bfloat16)
    g = torch.from_numpy(rng.normal(size=(n, width)).astype(np.float32)).to(device)
    return xp, wp, bp, g


def _rel(a, b):
    a, b = a.float(), b.float()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b).clamp_min(1e-30))


@pytest.mark.parametrize("n,width,layers,skips", [
    (1, 256, 8, (5,)), (100, 256, 8, (5,)), (333, 256, 8, ()), (1000, 64, 3, (2,)),
    (77, 64, 2, (1,)), (4096, 128, 4, (1, 3)), (3000, 128, 5, (2,)), (20000, 256, 8, (5,)),
    (140001, 256, 8, (5,)),
    # ragged N around the 64-point halves and 128-point tiles of the forward
    (63, 64, 1, ()), (127, 128, 4, (2,)), (129, 256, 4, ()), (1000, 256, 1, ()),
    (129, 64, 8, (5,)), (63, 128, 8, (3, 5)), (127, 256, 8, (5,)), (1000, 128, 8, ())])
def test_trunk_kernels_match_plain(cuda_device, n, width, layers, skips):
    """Kernels B and B' against their plain versions on the same packed
    inputs. The card sums in another order, so bf16 roundings flip in a
    few places: relative Frobenius error <= 5e-3 for each output."""
    from panopticnerf_tpu_torch.ops.mlp_train import trunk_backward_plain, trunk_forward_plain
    from panopticnerf_tpu_torch.ops.mlp_train_cuda import trunk_backward_cuda, trunk_forward_cuda

    torch.backends.cuda.matmul.allow_tf32 = False
    xp, wp, bp, g = _trunk_case(cuda_device, n, width, layers, skips, n + width)
    acts = trunk_forward_cuda(xp, wp, bp, skips)
    acts_ref = trunk_forward_plain(xp, wp, bp, skips)
    torch.cuda.synchronize()
    assert _rel(acts, acts_ref) <= 5e-3
    got = trunk_backward_cuda(xp, acts, g, wp, skips)
    ref = trunk_backward_plain(xp, acts, g, wp, skips)
    torch.cuda.synchronize()
    for name, a, b in zip(("dx", "dW", "db"), got, ref):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert bool(torch.isfinite(a).all()), name
        assert _rel(a, b) <= 5e-3, (name, _rel(a, b))


@pytest.mark.parametrize("n,width,layers,skips", [
    (20000, 256, 8, (5,)), (140001, 256, 8, (5,)), (999, 128, 4, (2,)), (77, 64, 3, (2,))])
def test_trunk_backward_repeats_bit_for_bit(cuda_device, n, width, layers, skips):
    """Two calls of B' on the same inputs give the same bits: every sum of
    the data and weight passes and of the reductions runs in a fixed order
    (no atomics)."""
    from panopticnerf_tpu_torch.ops.mlp_train_cuda import trunk_backward_cuda, trunk_forward_cuda

    xp, wp, bp, g = _trunk_case(cuda_device, n, width, layers, skips, 7 * n + width)
    acts = trunk_forward_cuda(xp, wp, bp, skips)
    first = trunk_backward_cuda(xp, acts, g, wp, skips)
    second = trunk_backward_cuda(xp, acts, g, wp, skips)
    torch.cuda.synchronize()
    for name, a, b in zip(("dx", "dW", "db"), first, second):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("n,width,layers,skips", [
    (140001, 256, 8, (5,)), (129, 256, 8, (5,)), (1000, 128, 4, (2,)), (63, 64, 1, ())])
def test_trunk_forward_repeats_bit_for_bit(cuda_device, n, width, layers, skips):
    """Two calls of B on the same inputs give the same bits (no split-K, no
    atomics: every sum runs in one fixed order)."""
    from panopticnerf_tpu_torch.ops.mlp_train_cuda import trunk_forward_cuda

    xp, wp, bp, _ = _trunk_case(cuda_device, n, width, layers, skips, 3 * n + width)
    first = trunk_forward_cuda(xp, wp, bp, skips)
    second = trunk_forward_cuda(xp, wp, bp, skips)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_trunk_function_counts_launches(cuda_device):
    """fused_trunk_train on CUDA tensors goes through B and B' once each."""
    from panopticnerf_tpu_torch.ops.mlp_train import fused_trunk_train

    rng = np.random.default_rng(2)
    ws = [torch.from_numpy(rng.normal(size=s).astype(np.float32) * 0.1).to(cuda_device)
          .requires_grad_() for s in [(63, 64), (64, 64), (127, 64)]]
    bs = [torch.zeros(64, device=cuda_device, requires_grad=True) for _ in range(3)]
    x = torch.from_numpy(rng.uniform(-1, 1, (500, 63)).astype(np.float32)).to(cuda_device)
    f0, b0 = launches("B"), launches("B'")
    out = fused_trunk_train(x.to(torch.bfloat16), ws, bs, (2,))
    out.sum().backward()
    assert (launches("B"), launches("B'")) == (f0 + 1, b0 + 1)
    assert out.dtype == torch.float32 and out.shape == (500, 64)
    assert all(w.grad is not None and w.grad.dtype == torch.float32 for w in ws)
    with pytest.raises(TypeError):  # the kernels take bf16 only
        fused_trunk_train(x, ws, bs, (2,))


def test_trunk_wrappers_reject_bad_inputs(cuda_device):
    from panopticnerf_tpu_torch.ops.mlp_train_cuda import trunk_backward_cuda, trunk_forward_cuda

    xp, wp, bp, g = _trunk_case(cuda_device, 64, 64, 3, (2,), 0)
    with pytest.raises(ValueError):
        trunk_forward_cuda(xp.cpu(), wp, bp, (2,))
    with pytest.raises(TypeError):
        trunk_forward_cuda(xp.float(), wp, bp, (2,))
    with pytest.raises(ValueError):  # layer 0 cannot be a skip layer
        trunk_forward_cuda(xp, wp, bp, (0,))
    with pytest.raises(ValueError):
        trunk_forward_cuda(xp[:, :32].contiguous(), wp, bp, (2,))
    with pytest.raises(ValueError):
        trunk_forward_cuda(xp.t().contiguous().t(), wp, bp, (2,))
    _, wp96, bp96, _ = _trunk_case(cuda_device, 64, 96, 2, (), 0)
    with pytest.raises(ValueError):  # width the kernels do not take
        trunk_forward_cuda(xp, wp96, bp96, ())
    acts = trunk_forward_cuda(xp, wp, bp, (2,))
    with pytest.raises(TypeError):
        trunk_backward_cuda(xp, acts, g.to(torch.bfloat16), wp, (2,))
    with pytest.raises(ValueError):
        trunk_backward_cuda(xp, acts[:2], g, wp, (2,))


_RAGGED_N = (1, 63, 64, 65, 127, 129, 1000)


def _field_case(device, n, width, layers, skips, use_sem, viewdirs, classes, cw, seed):
    """Seeded parameters (leaf order of FieldDims.leaves), packed in bf16,
    padded inputs and upstream gradients on `device`."""
    from panopticnerf_tpu_torch.ops.field_train import D_PAD, FieldDims, pack_field
    from panopticnerf_tpu_torch.ops.mlp_train import F_PAD

    d_dim = 27 if viewdirs else 0
    dims = FieldDims(x_dim=63, d_dim=d_dim, width=width, sem_hidden=width // 2,
                     color_width=cw, num_classes=classes, layers=layers, skips=skips,
                     use_sem=use_sem)
    ins = {f"trunk_{i}": 63 if i == 0 else width + (63 if i in skips else 0)
           for i in range(layers)}
    ins.update(sem_hidden=width, sem_out=width // 2, feature=width, sigma=width,
               color_hidden=width + d_dim, color_out=cw)
    outs = {f"trunk_{i}": width for i in range(layers)}
    outs.update(sem_hidden=width // 2, sem_out=classes, feature=width, sigma=1,
                color_hidden=cw, color_out=3)
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(device)
    params = []
    for name in dims.leaves():
        params.append(t(rng.normal(size=(outs[name], ins[name])) * np.sqrt(2.0 / ins[name])))
        params.append(t(rng.normal(size=(outs[name],)) * 0.1))
    pk = pack_field(params, dims, torch.bfloat16)
    x = np.zeros((n, F_PAD), np.float32)
    x[:, :63] = rng.uniform(-1, 1, (n, 63))
    d = np.zeros((n, D_PAD), np.float32)
    d[:, :d_dim] = rng.uniform(-1, 1, (n, d_dim))
    g_out = t(rng.normal(size=(n, 4)))
    g_sem = t(rng.normal(size=(n, classes))) if use_sem else None
    return dims, pk, t(x).to(torch.bfloat16), t(d).to(torch.bfloat16), g_out, g_sem


@pytest.mark.parametrize("dw_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("n,width,layers,skips,use_sem,viewdirs,classes,cw", [
    (1, 256, 8, (5,), True, True, 19, 128), (100, 256, 8, (5,), True, True, 19, 128),
    (333, 128, 4, (2,), False, True, 19, 64), (4096, 64, 3, (), True, False, 5, 32),
    (20000, 256, 8, (5,), True, True, 19, 128), (140001, 256, 8, (5,), True, True, 19, 128),
    # ragged N, every width, 1 / 4 / 8 layers, the head widths on both sides of 64
    (63, 64, 1, (), False, False, 19, 32), (127, 128, 4, (2,), True, False, 19, 128),
    (129, 256, 8, (5,), False, True, 5, 64), (1000, 256, 4, (), True, True, 70, 96),
    (1000, 64, 4, (2,), True, True, 70, 96), (129, 128, 8, (3, 5), True, True, 100, 128),
    # every width x CP 32 / 128 x CWP 32 / 64 / 128 x the semantic head on and off, at
    # ragged N (each width meets every N)
    *[(_RAGGED_N[i % len(_RAGGED_N)], width, 3, (2,), use_sem, i % 2 == 0, classes, cw)
      for i, (width, classes, cw, use_sem) in enumerate(
          (width, classes, cw, use_sem) for width in (64, 128, 256) for classes in (19, 100)
          for cw in (27, 50, 100) for use_sem in (True, False))]])
def test_field_kernels_match_plain(cuda_device, n, width, layers, skips, use_sem, viewdirs,
                                   classes, cw, dw_dtype):
    """Kernels C and C' against their plain versions on the same packed
    inputs (C' on C's saved activations, in both dW dtypes); C' without
    saved activations recomputes them and gives the same result bit for
    bit. The card sums in another order, so bf16 roundings flip in a few
    places: relative Frobenius error <= 5e-3 for each output."""
    from panopticnerf_tpu_torch.ops.field_train import field_backward_plain, field_forward_plain
    from panopticnerf_tpu_torch.ops.field_train_cuda import field_backward_cuda, field_forward_cuda

    torch.backends.cuda.matmul.allow_tf32 = False
    dwt = getattr(torch, dw_dtype)
    dims, pk, xp, dp, g_out, g_sem = _field_case(cuda_device, n, width, layers, skips, use_sem,
                                                 viewdirs, classes, cw, n + width)
    out, sem, saved = field_forward_cuda(xp, dp, pk, dims)
    r_out, r_sem, r_saved = field_forward_plain(xp, dp, pk, dims)
    torch.cuda.synchronize()
    pairs = [("out", out, r_out), ("sem", sem, r_sem)] + list(zip(saved._fields, saved, r_saved))
    got = field_backward_cuda(xp, dp, g_out, g_sem, pk, dims, saved, dwt)
    ref = field_backward_plain(xp, dp, g_out, g_sem, pk, dims, saved, dwt)
    again = field_backward_cuda(xp, dp, g_out, g_sem, pk, dims, None, dwt)
    torch.cuda.synchronize()
    pairs += [("dx", got[0], ref[0]), ("dd", got[1], ref[1])]
    pairs += [(f"d{k}", a, b) for k, a, b in zip(got[2]._fields, got[2], ref[2])]
    for name, a, b in pairs:
        if b is None:
            assert a is None, name
            continue
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert bool(torch.isfinite(a.float()).all()), name
        assert _rel(a, b) <= 5e-3, (name, _rel(a, b))
    assert got[2].hw.dtype == dwt and got[2].hb.dtype == torch.float32
    # the recompute gives C' on C's activations exactly, and so does a
    # second call on them (fixed summation orders, no atomics)
    repeat = field_backward_cuda(xp, dp, g_out, g_sem, pk, dims, saved, dwt)
    torch.cuda.synchronize()
    for other in (again, repeat):
        for a, b in zip([got[0], got[1], *got[2]], [other[0], other[1], *other[2]]):
            assert (a is None and b is None) or torch.equal(a, b)


@pytest.mark.parametrize("n,width,layers,skips,use_sem,viewdirs,classes,cw", [
    (140001, 256, 8, (5,), True, True, 19, 128), (129, 256, 8, (5,), False, False, 19, 128),
    (1000, 64, 4, (2,), True, True, 70, 96)])
def test_field_forward_repeats_bit_for_bit(cuda_device, n, width, layers, skips, use_sem,
                                           viewdirs, classes, cw):
    """Two calls of C on the same inputs give the same bits: every output
    and every saved activation."""
    from panopticnerf_tpu_torch.ops.field_train_cuda import field_forward_cuda

    dims, pk, xp, dp, _, _ = _field_case(cuda_device, n, width, layers, skips, use_sem, viewdirs,
                                         classes, cw, 5 * n + width)
    out, sem, saved = field_forward_cuda(xp, dp, pk, dims)
    out2, sem2, saved2 = field_forward_cuda(xp, dp, pk, dims)
    torch.cuda.synchronize()
    for a, b in zip((out, sem, *saved), (out2, sem2, *saved2)):
        assert (a is None and b is None) or torch.equal(a, b)


@pytest.mark.parametrize("dw_dtype", ["bfloat16", "float32"])
def test_field_backward_recompute_equals_saved(cuda_device, dw_dtype):
    """C' with its own recompute (saved None, as mode hybrid calls it) runs
    C's forward, so it equals C' on C's saved activations bit for bit."""
    from panopticnerf_tpu_torch.ops.field_train_cuda import field_backward_cuda, field_forward_cuda

    dwt = getattr(torch, dw_dtype)
    dims, pk, xp, dp, g_out, g_sem = _field_case(cuda_device, 300, 64, 3, (2,), True, True, 7,
                                                 32, 21)
    saved = field_forward_cuda(xp, dp, pk, dims)[2]
    on_saved = field_backward_cuda(xp, dp, g_out, g_sem, pk, dims, saved, dwt)
    recomputed = field_backward_cuda(xp, dp, g_out, g_sem, pk, dims, None, dwt)
    torch.cuda.synchronize()
    for a, b in zip([on_saved[0], on_saved[1], *on_saved[2]],
                    [recomputed[0], recomputed[1], *recomputed[2]]):
        assert (a is None and b is None) or torch.equal(a, b)


def test_field_modes_count_launches(cuda_device):
    """Mode "field" goes through C and C' once each per call, mode
    "hybrid" through C' only; neither launches B or B'. The kernels take
    bf16 only."""
    from panopticnerf_tpu_torch.config import ModelConfig
    from panopticnerf_tpu_torch.models.nerf import NeRFMLP
    from panopticnerf_tpu_torch.ops.field_train import (
        FieldDims,
        field_hybrid_apply,
        field_train_apply,
    )

    net = NeRFMLP(ModelConfig(trunk_depth=4, trunk_width=64, skips=(1,), color_width=32,
                              num_classes=7)).to(cuda_device)
    dims = FieldDims(x_dim=63, d_dim=27, width=64, sem_hidden=32, color_width=32,
                     num_classes=7, layers=4, skips=(2,), use_sem=True)
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.uniform(-1, 1, (500, 63)).astype(np.float32)).to(cuda_device)
    d = torch.from_numpy(rng.uniform(-1, 1, (500, 27)).astype(np.float32)).to(cuda_device)
    counts = lambda: (launches("C"), launches("C'"), launches("B"), launches("B'"))
    for fn, step in ((field_train_apply, (1, 1, 0, 0)), (field_hybrid_apply, (0, 1, 0, 0))):
        before = counts()
        net.zero_grad()
        sigma, rgb, sem = fn(net, dims, x.to(torch.bfloat16), d.to(torch.bfloat16))
        (sigma.sum() + rgb.sum() + sem.sum()).backward()
        assert tuple(a - b for a, b in zip(counts(), before)) == step
        assert sigma.shape == (500,) and rgb.shape == (500, 3) and sem.shape == (500, 7)
        assert all(p.grad is not None and p.grad.dtype == torch.float32
                   for p in net.parameters())
    with pytest.raises(TypeError):
        field_train_apply(net, dims, x, d)


def test_field_wrappers_reject_bad_inputs(cuda_device):
    from panopticnerf_tpu_torch.ops.field_train_cuda import field_backward_cuda, field_forward_cuda

    dims, pk, xp, dp, g_out, g_sem = _field_case(cuda_device, 64, 64, 3, (2,), True, True, 5,
                                                 32, 0)
    with pytest.raises(ValueError):
        field_forward_cuda(xp.cpu(), dp, pk, dims)
    with pytest.raises(TypeError):
        field_forward_cuda(xp.float(), dp, pk, dims)
    with pytest.raises(ValueError):
        field_forward_cuda(xp, dp[:, :16].contiguous(), pk, dims)
    wide = _field_case(cuda_device, 64, 96, 2, (), True, True, 5, 32, 0)
    with pytest.raises(ValueError):  # width the kernels do not take
        field_forward_cuda(*wide[2:4], wide[1], wide[0])
    with pytest.raises(TypeError):
        field_backward_cuda(xp, dp, g_out, g_sem, pk, dims, None, torch.float16)
    with pytest.raises(ValueError):
        field_backward_cuda(xp, dp, g_out[:10], g_sem, pk, dims)


def test_intersect_kernels_on_demo_tree_cut_planes(cuda_device, tmp_path):
    """A1 on every view and A2 on grouped training batches of a demo tree
    the port writes itself (fisheye views, two concave buildings cut into
    convex pieces with real half-spaces): bit-equal to their plain
    versions."""
    from panopticnerf_tpu_torch.config import load_config
    from panopticnerf_tpu_torch.data import make_dataset, view_primitives, view_rays
    from panopticnerf_tpu_torch.data.dataset import batch_intervals, sample_ray_batch
    from panopticnerf_tpu_torch.data.demo_tree import write_demo_tree
    from panopticnerf_tpu_torch.ops.intersect import intersect_rays, intersect_rays_plain

    root = str(tmp_path / "tree")
    write_demo_tree(root, n_frames=4, hw=(96, 128), n_boxes=6, seed=2, fisheye=True,
                    n_concave=2, device=cuda_device)
    cfg = load_config(None, ["data.dataset", "kitti360", "data.root", root, "data.frame_num",
                             "4", "data.ratio", "0.5", "data.use_fisheye", "true",
                             "data.max_primitives", "16", "data.max_intervals", "8",
                             "data.n_rays", "512", "data.views_per_batch", "4",
                             "model.num_classes", "19"])
    ds, train_ids, _ = make_dataset(cfg, cuda_device)
    planes = ds.prim_planes[ds.prim_valid]
    assert bool((planes[..., :3] != 0).any(-1).any())          # real cut planes
    hits = 0
    for view in range(ds.images.shape[0]):
        o, d = view_rays(ds, view)
        prims = view_primitives(ds, view)
        out = intersect_rays(o, d, prims, 0.5, 120.0, 8)
        ref = intersect_rays_plain(o, d, prims, 0.5, 120.0, 8)
        for a, b in zip(out, ref):
            assert torch.equal(a, b), view
        hits += int(out.mask.sum())
    assert hits > 0
    gen = torch.Generator(cuda_device).manual_seed(0)
    view_ids = torch.as_tensor(train_ids, device=cuda_device)
    before = launches("A2")
    for _ in range(5):
        batch = sample_ray_batch(ds, view_ids, 512, 4, gen)
        out = batch_intervals(ds, batch, 0.5, 120.0, 8, 4)
        ref = batch_intervals(ds, batch, 0.5, 120.0, 8, 4, use_kernel=False)
        for a, b in zip(out, ref):
            assert torch.equal(a, b)
    assert launches("A2") == before + 5


def test_demo_tree_written_on_the_card_equals_the_cpu_one(cuda_device, tmp_path):
    """The writer's float64 raycast gives the same bits on the card as on
    the CPU (where tests/test_torch_kitti360.py holds it against the JAX
    writer): every file of the two trees decodes to the same arrays."""
    import filecmp
    import os

    from panopticnerf_tpu_torch.data.demo_tree import write_demo_tree
    from panopticnerf_tpu_torch.viz.png import read_png

    kw = dict(n_frames=3, hw=(60, 88), n_boxes=5, seed=3, fisheye=True, n_concave=2)
    write_demo_tree(str(tmp_path / "cpu"), **kw, device="cpu")
    write_demo_tree(str(tmp_path / "card"), **kw, device=cuda_device)
    files = [os.path.relpath(os.path.join(d, f), tmp_path / "cpu")
             for d, _, fs in os.walk(tmp_path / "cpu") for f in fs]
    assert len(files) > 20
    for rel in files:
        a, b = str(tmp_path / "cpu" / rel), str(tmp_path / "card" / rel)
        if rel.endswith(".png"):
            assert np.array_equal(read_png(a), read_png(b)), rel
        elif rel.endswith(".npy"):
            assert np.array_equal(np.load(a), np.load(b)), rel
        else:
            assert filecmp.cmp(a, b, shallow=False), rel


def _pool(n_views=12, h=20, w=24, p=6, f=3, seed=0):
    """A seeded host pool of `n_views` views with every optional field."""
    from panopticnerf_tpu_torch.data.dataset import DeviceDataset

    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    return DeviceDataset(
        images=t(rng.integers(0, 256, (n_views, h, w, 3), dtype=np.uint8)),
        K=t(rng.normal(size=(n_views, 3, 3)).astype(np.float32)),
        c2w=t(rng.normal(size=(n_views, 3, 4)).astype(np.float32)),
        pseudo=t(rng.integers(0, 20, (n_views, h, w)).astype(np.int32)),
        depth=t(rng.uniform(-1, 30, (n_views, h, w)).astype(np.float32)),
        prim_w2p=t(rng.normal(size=(n_views, p, 3, 4)).astype(np.float32)),
        prim_sem=t(rng.integers(0, 19, (n_views, p)).astype(np.int32)),
        prim_inst=t(rng.integers(0, 900, (n_views, p)).astype(np.int32)),
        prim_valid=t(rng.uniform(size=(n_views, p)) > 0.3),
        bounds_center=t(rng.normal(size=3).astype(np.float32)),
        bounds_scale=torch.tensor(0.05),
        gt_sem=t(rng.integers(0, 256, (n_views, h, w)).astype(np.int32)),
        gt_inst=t(rng.integers(0, 50, (n_views, h, w)).astype(np.int32)),
        prim_planes=t(rng.normal(size=(n_views, p, f, 4)).astype(np.float32)),
        cam_model=t(rng.integers(0, 2, n_views).astype(np.int32)),
        fisheye=t(rng.normal(size=(n_views, 7)).astype(np.float32)),
        valid_mask=t(rng.uniform(size=(n_views, h, w)) > 0.2))


def test_streamer_async_window_equals_a_synchronous_upload(cuda_device):
    """Each window the streamer copies on its side stream (pinned staging,
    non-blocking) equals a synchronous upload of the same views bit for
    bit, also while the consuming stream is busy and the previous window is
    released as the next one is swapped in."""
    from panopticnerf_tpu_torch.data.stream import HostViews, ViewWindowStreamer, views_to

    pool = _pool()
    host = HostViews(pool, cuda_device)
    st = ViewWindowStreamer(host, 5, seed=4)
    busy = torch.randn(2048, 2048, device=cuda_device)
    seen = []
    for _ in range(6):
        for _ in range(4):  # keep the consuming stream busy across the swap
            busy = busy @ busy / busy.norm()
        ds, ids = st.advance()
        seen.append(ids)
        ref = views_to(pool, ids, cuda_device)
        for name, a, b in zip(ds._fields, ds, ref):
            assert a.device.type == "cuda" and torch.equal(a, b), name
    st.close()
    assert len(st.blocked) == len(st.ready) == 6
    assert all(len(set(ids.tolist())) == 5 for ids in seen)


def test_intersect_kernel_on_panorama_rays(cuda_device):
    """A1 on an equirect panorama's world rays from one centre (every
    direction, up and down included) against cut-plane boxes around it:
    bit for bit with its plain version."""
    from panopticnerf_tpu_torch.render import panorama_rays

    rng = np.random.default_rng(7)
    scene, _ = random_boxes(rng, 64, 8, 4)
    prims = _to(cuda_device, *scene)
    rot = torch.from_numpy(np.linalg.qr(rng.normal(size=(3, 3)))[0].astype(np.float32))
    for hw in ((64, 128), (97, 211)):
        o, d = panorama_rays(torch.tensor([0.5, -1.0, 9.0], device=cuda_device),
                             rot.to(cuda_device), *hw)
        out = intersect_rays(o, d, prims, 0.5, 120.0, 16)
        ref = intersect_rays_plain(o, d, prims, 0.5, 120.0, 16)
        torch.cuda.synchronize()
        for a, b in zip(out, ref):
            assert torch.equal(a, b)
        assert 0 < int(out.mask.sum()) < out.mask.numel()


# Kernel E (the evaluation field): the shipped fields, ragged point counts
# and the heads switched off. (ModelConfig changes, rays, samples per ray).
_EVAL_CASES = [
    ({"num_classes": 19}, 4096, 128),                                    # 8x256, a fine tile
    ({"num_classes": 19, "trunk_depth": 4, "trunk_width": 64, "skips": (),
      "color_width": 64}, 4096, 64),                                     # the 4x64 proposal
    ({"trunk_width": 128, "color_width": 64, "num_classes": 8}, 1001, 96),  # 128-wide, keep-M
    ({"num_classes": 19}, 1, 64), ({"num_classes": 19}, 37, 37),
    ({"num_classes": 100, "use_semantic": False, "color_width": 50}, 333, 13),
    ({"num_classes": 5, "use_viewdirs": False, "trunk_width": 64, "trunk_depth": 3,
      "skips": (0,), "color_width": 27}, 129, 7),
    ({"num_classes": 128, "trunk_width": 128, "skips": (1, 4), "color_width": 100}, 70, 64),
]
# E against its plain version: both sum each product in f32 and round it to
# bf16, in another order (wgmma chains against cuBLAS), so a sum that lands
# within a rounding of a bf16 boundary rounds the other way in a few places,
# and an activation one bf16 ulp off moves what follows it. The plain
# version runs with cuBLAS's reduced-precision reductions off: with them,
# cuBLAS may round a split-K partial sum to bf16 (colour width 50 read
# 3.0e-2 of rgb off against 7.7e-5 without). Measured on the H100 at the
# cases above: at most 3.9e-4 of an output's values differ, the relative
# Frobenius error at most 1.2e-4. Ceilings: five times both.
EVAL_SHARE, EVAL_REL = 2e-3, 6e-4


def _eval_case(device, change, rays, samples, seed):
    """A field with seeded weights and biases away from zero, its packing,
    points in [-1.5, 1.5]^3 on `rays` rays of `samples` points."""
    import dataclasses

    from panopticnerf_tpu_torch.config import ModelConfig
    from panopticnerf_tpu_torch.models.nerf import NeRFMLP
    from panopticnerf_tpu_torch.ops.field_eval import eval_dims, pack_eval

    cfg = dataclasses.replace(ModelConfig(), **change)
    torch.manual_seed(seed)
    net = NeRFMLP(cfg).to(device)
    with torch.no_grad():
        for p in net.parameters():
            p.add_(torch.randn_like(p) * 0.05)
    dims = eval_dims(cfg)
    g = torch.Generator(device).manual_seed(seed)
    pts = (torch.rand(rays * samples, 3, device=device, generator=g) * 2 - 1) * 1.5
    dirs = torch.nn.functional.normalize(torch.randn(rays, 3, device=device, generator=g), dim=-1)
    return net, dims, pack_eval(net, dims, torch.bfloat16), pts, dirs


@pytest.mark.parametrize("change,rays,samples", _EVAL_CASES)
def test_eval_field_kernel_matches_plain(cuda_device, change, rays, samples):
    """Kernel E against its plain version (the model's own ops) per output,
    within EVAL_SHARE / EVAL_REL; finite; the plain version equals the
    model; the kernel launch counted once."""
    from panopticnerf_tpu_torch.ops.field_eval import field_eval_plain
    from panopticnerf_tpu_torch.ops.field_eval_cuda import EvalKernel

    net, dims, pk, pts, dirs = _eval_case(cuda_device, change, rays, samples, rays + samples)
    before = launches("E")
    got = EvalKernel(pk, dims, cuda_device)(pts, dirs, samples)
    assert launches("E") == before + 1
    matmul = torch.backends.cuda.matmul
    reduced = matmul.allow_bf16_reduced_precision_reduction
    matmul.allow_bf16_reduced_precision_reduction = False
    try:
        ref = field_eval_plain(pts, dirs, samples, pk, dims)
        model = net(pts.view(rays, samples, 3), dirs[:, None, :] if dims.d_dim else None)
        torch.cuda.synchronize()
    finally:
        matmul.allow_bf16_reduced_precision_reduction = reduced
    for name, a, b, m in zip(("sigma", "rgb", "sem"), got, ref, model):
        if b is None:
            assert a is None and m is None, name
            continue
        assert a.dtype == torch.float32 and a.shape == b.shape, name
        assert torch.equal(b, m.reshape(b.shape)), name
        assert bool(torch.isfinite(a).all()), name
        share = float((a != b).float().mean())
        assert share <= EVAL_SHARE and _rel(a, b) <= EVAL_REL, (name, share, _rel(a, b))


@pytest.mark.parametrize("samples,x_freqs,d_freqs", [(64, 10, 4), (37, 10, 4), (96, 6, 2),
                                                      (128, 0, -1), (1, 10, 0)])
def test_eval_field_encodings_bit_for_bit(cuda_device, samples, x_freqs, d_freqs):
    """The encodings E computes into shared memory (written out by its
    probe) equal `positional_encoding` on the card, cast to bf16, bit for
    bit: points near the scene, far out and at 2^k multiples; each ray's
    directions repeated over its samples; zeros in the padding columns."""
    from panopticnerf_tpu_torch.ops.encoding import positional_encoding
    from panopticnerf_tpu_torch.ops.field_eval_cuda import field_eval_encodings_cuda

    rays = 999
    g = torch.Generator(cuda_device).manual_seed(samples + x_freqs)
    n = rays * samples
    pts = torch.cat([torch.rand(n // 3, 3, device=cuda_device, generator=g) * 2 - 1,
                     (torch.rand(n // 3, 3, device=cuda_device, generator=g) * 2 - 1) * 60,
                     torch.randn(n - 2 * (n // 3), 3, device=cuda_device, generator=g) * 4])
    pts[:16] = torch.ldexp(torch.ones(16, 3, device=cuda_device),
                           torch.arange(-8, 8, device=cuda_device)[:, None])
    dirs = torch.nn.functional.normalize(torch.randn(rays, 3, device=cuda_device, generator=g),
                                         dim=-1)
    x_k, d_k = field_eval_encodings_cuda(pts, dirs, samples, x_freqs, d_freqs)
    x_ref = torch.zeros_like(x_k)
    xe = positional_encoding(pts, x_freqs)
    x_ref[:, :xe.shape[1]] = xe.to(torch.bfloat16)
    d_ref = torch.zeros_like(d_k)
    if d_freqs >= 0:
        de = positional_encoding(dirs, d_freqs).to(torch.bfloat16).repeat_interleave(samples, 0)
        d_ref[:, :de.shape[1]] = de
    torch.cuda.synchronize()
    assert torch.equal(x_k.view(torch.int16), x_ref.view(torch.int16))
    assert torch.equal(d_k.view(torch.int16), d_ref.view(torch.int16))


def test_eval_field_kernel_repeats_bit_for_bit(cuda_device):
    """Two calls of E on the same inputs give the same bits (no atomics,
    fixed summation orders), at a fine tile's 524,288 points."""
    from panopticnerf_tpu_torch.ops.field_eval_cuda import EvalKernel

    _, dims, pk, pts, dirs = _eval_case(cuda_device, {"num_classes": 19}, 4096, 128, 5)
    kernel = EvalKernel(pk, dims, cuda_device)
    first, second = kernel(pts, dirs, 128), kernel(pts, dirs, 128)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_eval_field_wrapper_rejects_bad_inputs(cuda_device):
    import dataclasses

    from panopticnerf_tpu_torch.ops.field_eval_cuda import EvalKernel

    _, dims, pk, pts, dirs = _eval_case(cuda_device, {"num_classes": 7}, 8, 16, 0)
    kernel = EvalKernel(pk, dims, cuda_device)
    with pytest.raises(ValueError):
        kernel(pts.cpu(), dirs, 16)
    with pytest.raises(TypeError):
        kernel(pts.double(), dirs, 16)
    with pytest.raises(ValueError):  # not rays x samples
        kernel(pts[:100].contiguous(), dirs, 16)
    with pytest.raises(ValueError):
        EvalKernel(pk, dims, "cpu")
    with pytest.raises(ValueError):
        EvalKernel(pk._replace(wp=pk.wp[:, :, :32]), dims, cuda_device)
    with pytest.raises(ValueError):  # a width the kernel does not take
        EvalKernel(pk, dataclasses.replace(dims, width=96), cuda_device)
    with pytest.raises(ValueError):  # an encoding width that is not 3 (2 F + 1)
        EvalKernel(pk, dataclasses.replace(dims, x_dim=62), cuda_device)


# --------------------------------------------------------------- kernel G

def _grid_case(device, change, seed):
    """A hybrid field (the hash grid of configs/torch/kitti360_grid.yaml at
    `change`'s widths) with seeded weights and tables uniform in +-1."""
    import dataclasses

    from panopticnerf_tpu_torch.config import ModelConfig
    from panopticnerf_tpu_torch.models.nerf import NeRFMLP

    cfg = dataclasses.replace(ModelConfig(hash_grid=True), **change)
    torch.manual_seed(seed)
    net = NeRFMLP(cfg).to(device)
    g = torch.Generator(device).manual_seed(seed)
    with torch.no_grad():
        for name, p in net.named_parameters():
            if ".table_" in name:
                p.copy_(torch.rand(p.shape, device=device, generator=g) * 2 - 1)
            else:
                p.add_(torch.randn_like(p) * 0.05)
    return cfg, net


def _grid_points(device, n, seed):
    """Points inside the cube, far outside it, on its faces and at cell
    corners of every level."""
    g = torch.Generator(device).manual_seed(seed)
    pts = torch.cat([torch.rand(n // 2, 3, device=device, generator=g) * 2 - 1,
                     torch.randn(n - n // 2, 3, device=device, generator=g) * 1.5])
    pts[:6] = torch.tensor([[1.0, 1.0, 1.0], [-1.0, -1.0, -1.0], [1.0, -1.0, 0.0],
                            [2.0, -3.0, 0.5], [0.0, 0.0, 0.0], [0.5, 0.25, -0.125]])
    return pts


def _grid_case_points(device, case):
    """The points of a G case: "n1" / "n15" / "n300001" that many points (inside and outside
    the cube, on its faces, at cell corners), which leave lanes of G's last warp past the
    end; "rays" 2047 seeded rays x 128 sorted samples in the render's ray-major order, whose
    lane pairs share lines; "integer" points whose finest-level coordinates (N = 2048) are
    exact integers, t = 0 on every axis; "line_edge" points in cells with kx mod 16 = 15 at
    every level, whose x-neighbour rows cross a 128-byte line."""
    from panopticnerf_tpu_torch.ops.hash_grid import GRID

    g = torch.Generator(device).manual_seed(7)
    if case.startswith("n"):
        n = int(case[1:])
        if n >= 6:
            return _grid_points(device, n, 3)
        return torch.rand(n, 3, device=device, generator=g) * 2 - 1
    if case == "rays":
        o = (torch.rand(2047, 1, 3, device=device, generator=g) * 2 - 1) * 0.3
        d = torch.nn.functional.normalize(torch.randn(2047, 1, 3, device=device, generator=g),
                                          dim=-1)
        t = torch.rand(2047, 128, 1, device=device, generator=g).sort(dim=1).values * 1.5
        return (o + d * t).reshape(-1, 3).contiguous()
    if case == "integer":
        k = torch.randint(0, 2049, (20_000, 3), device=device, generator=g)
        pts = k.float() / 1024.0 - 1.0  # u = k / 2048, exact
        assert torch.equal(((pts + 1.0) / 2.0) * 2048.0, k.float())
        return pts
    assert case == "line_edge"
    out = []
    for res in GRID.resolutions:
        q = torch.randint(0, res // 16, (2000, 1), device=device, generator=g)
        rest = torch.rand(2000, 2, device=device, generator=g)
        ux = (16 * q + 15 + torch.rand(2000, 1, device=device, generator=g) * 0.999) / res
        out.append(torch.cat([ux, rest], dim=1) * 2 - 1)
    pts = torch.cat(out).contiguous()
    res = torch.tensor(GRID.resolutions, device=device).repeat_interleave(2000)
    kx = torch.floor((pts[:, 0] + 1.0) / 2.0 * res).long()
    assert bool(((kx % 16) == 15).float().mean() > 0.99)
    return pts


@pytest.mark.parametrize("case", ["n1", "n15", "n300001", "rays", "integer", "line_edge"])
def test_hash_grid_kernel_bit_for_bit(cuda_device, case):
    """Kernel G equals the plain encoding rounded to bf16, bit for bit (the
    plain version's order of operations, no contraction, through the lane
    pairs' exchange), at every level of the grid (dense and hashed), on
    each case of `_grid_case_points`; one launch counted."""
    from panopticnerf_tpu_torch.ops.hash_grid import hash_grid_encode
    from panopticnerf_tpu_torch.ops.hash_grid_cuda import GridKernel

    _, net = _grid_case(cuda_device, {"num_classes": 19}, 3)
    tables = [t.detach() for t in net.grid.tables()]
    pts = _grid_case_points(cuda_device, case)
    before = launches("G")
    got = GridKernel(tables, cuda_device)(pts)
    assert launches("G") == before + 1
    ref = hash_grid_encode(pts, tables).to(torch.bfloat16)
    torch.cuda.synchronize()
    assert got.shape == (pts.shape[0], 32) and got.dtype == torch.bfloat16
    assert torch.equal(got.view(torch.int16), ref.view(torch.int16))


def test_hash_grid_wrapper_rejects_bad_inputs(cuda_device):
    from panopticnerf_tpu_torch.ops.hash_grid_cuda import GridKernel

    _, net = _grid_case(cuda_device, {"num_classes": 7, "trunk_width": 64}, 0)
    tables = [t.detach() for t in net.grid.tables()]
    kernel = GridKernel(tables, cuda_device)
    with pytest.raises(ValueError):
        kernel(torch.zeros(10, 3))
    with pytest.raises(TypeError):
        kernel(torch.zeros(10, 3, device=cuda_device, dtype=torch.float64))
    with pytest.raises(ValueError):  # a table of another size
        GridKernel([tables[0][:5].contiguous()] + tables[1:], cuda_device)
    with pytest.raises(ValueError):  # F != 2
        GridKernel([t.repeat(1, 2) for t in tables], cuda_device)
    with pytest.raises(ValueError):  # a level short
        GridKernel(tables[:-1], cuda_device)
    with pytest.raises(ValueError):
        GridKernel(tables, "cpu")


@pytest.mark.parametrize("change,rays,samples", [
    ({"num_classes": 19}, 1001, 128),  # the fine field of kitti360_grid
    ({"num_classes": 19}, 2047, 64),  # the 8x256 coarse of kitti360_360_grid, 64-sample tiles
    ({"num_classes": 19, "trunk_depth": 4, "trunk_width": 64, "skips": (), "color_width": 64},
     2047, 64),  # its 4x64 proposal coarse
    ({"num_classes": 8, "trunk_width": 128, "color_width": 64, "use_semantic": False}, 33, 37),
])
def test_eval_field_kernel_with_grid_matches_plain(cuda_device, change, rays, samples):
    """Kernel E with the hash grid's features (from kernel G) against its
    plain version with the same features, within EVAL_SHARE / EVAL_REL;
    the plain version equals the hybrid model."""
    from panopticnerf_tpu_torch.ops.field_eval import eval_dims, field_eval_plain, pack_eval
    from panopticnerf_tpu_torch.ops.field_eval_cuda import EvalKernel
    from panopticnerf_tpu_torch.ops.hash_grid_cuda import GridKernel

    cfg, net = _grid_case(cuda_device, change, rays)
    dims = eval_dims(cfg)
    assert dims is not None and dims.grid_dim == 32
    pk = pack_eval(net, dims, torch.bfloat16)
    g = torch.Generator(cuda_device).manual_seed(samples)
    pts = (torch.rand(rays * samples, 3, device=cuda_device, generator=g) * 2 - 1) * 1.2
    dirs = torch.nn.functional.normalize(torch.randn(rays, 3, device=cuda_device, generator=g),
                                         dim=-1)
    grid = GridKernel([t.detach() for t in net.grid.tables()], cuda_device)(pts)
    got = EvalKernel(pk, dims, cuda_device)(pts, dirs, samples, grid)
    matmul = torch.backends.cuda.matmul
    reduced = matmul.allow_bf16_reduced_precision_reduction
    matmul.allow_bf16_reduced_precision_reduction = False
    try:
        ref = field_eval_plain(pts, dirs, samples, pk, dims, grid)
        with torch.no_grad():
            model = net(pts.view(rays, samples, 3), dirs[:, None, :])
        torch.cuda.synchronize()
    finally:
        matmul.allow_bf16_reduced_precision_reduction = reduced
    for name, a, b, m in zip(("sigma", "rgb", "sem"), got, ref, model):
        if b is None:
            assert a is None and m is None, name
            continue
        assert torch.equal(b, m.reshape(b.shape)), name
        assert bool(torch.isfinite(a).all()), name
        share = float((a != b).float().mean())
        assert share <= EVAL_SHARE and _rel(a, b) <= EVAL_REL, (name, share, _rel(a, b))
    with pytest.raises(ValueError):  # a hybrid field's E needs the features
        EvalKernel(pk, dims, cuda_device)(pts, dirs, samples)


def _view_gaps(out, ref):
    """The benchmark's numbers (benchmark/harness/render.py `gaps`) of one
    view: mean |rgb gap|; mean |gap| over the reference's mean |value| of
    depth and of the semantic logits."""
    rel = lambda a, b: float((a - b).abs().mean() / b.abs().mean().clamp(min=1e-30))
    return (float((out.rgb - ref.rgb).abs().mean()), rel(out.depth, ref.depth),
            rel(out.sem_logits, ref.sem_logits))


def _render_both(cfg, device, ds, view, seed):
    """One view through `intersect_and_render` with E and with the plain
    model (seeded lecun weights, biases away from zero, a hash grid's tables
    uniform in +-1), and E's launches, the two counters, G's launches and
    the grid's points over E's render."""
    from panopticnerf_tpu_torch.data import view_primitives, view_rays
    from panopticnerf_tpu_torch.models import init_params, make_network
    from panopticnerf_tpu_torch.render import renderer
    from panopticnerf_tpu_torch.utils import profiling

    model = make_network(cfg, device).eval()
    init_params(model, torch.Generator(device).manual_seed(seed))
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                p.normal_(0.0, 0.05, generator=torch.Generator(device).manual_seed(len(name)))
            elif ".table_" in name:  # a hash grid's tables where they move the maps
                p.uniform_(-1.0, 1.0, generator=torch.Generator(device).manual_seed(len(name)))
    o, d = view_rays(ds, view)
    bounds = renderer.SceneBounds(ds.bounds_center, ds.bounds_scale)
    render = lambda: renderer.intersect_and_render(cfg, model, o, d, view_primitives(ds, view),
                                                   bounds)
    profiling.reset()
    out = render()
    counts = (launches("E"), profiling.calls("render.field.points"),
              profiling.calls("render.field.points_fused"), launches("G"),
              profiling.calls("render.grid.points"))
    profiling.reset()
    keep = renderer.eval_field
    renderer.eval_field = lambda m, c, dv: m
    try:
        ref = render()
    finally:
        renderer.eval_field = keep
    torch.cuda.synchronize()
    return out, ref, counts, o.shape[0]


def test_eval_render_views_against_the_plain_model(cuda_device, tmp_path):
    """A flagship view and a KITTI-360 demo-tree view (4x64 proposal coarse,
    8x256 fine) through `intersect_and_render`: E's maps against the plain
    model's within a tenth of the benchmark's limits (benchmark/limits/),
    E launched once per tile and level, every field point fused."""
    import os

    from panopticnerf_tpu_torch.config import load_config
    from panopticnerf_tpu_torch.data import make_dataset
    from panopticnerf_tpu_torch.data.demo_tree import write_demo_tree

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    root = str(tmp_path / "tree")
    write_demo_tree(root, n_frames=2, hw=(376, 1408), n_boxes=8, seed=1, n_concave=2,
                    device=cuda_device)
    cases = {
        "flagship": (load_config(os.path.join(repo, "configs", "synthetic_flagship.yaml"),
                                 ["data.synthetic_num_frames", "2"]),
                     (1e-5, 1.5e-5, 3e-4)),
        "kitti360": (load_config(os.path.join(repo, "configs", "kitti360_panoptic.yaml"),
                                 ["data.root", root, "data.frame_start", "0",
                                  "data.frame_num", "2"]),
                     (1e-5, 5e-6, 3e-4)),
    }
    for name, (cfg, limits) in cases.items():
        ds, _, _ = make_dataset(cfg, cuda_device)
        out, ref, (e, points, fused, _, _), n = _render_both(cfg, cuda_device, ds, 1, 11)
        tiles = -(-n // cfg.render.ray_tile)
        assert e == 2 * tiles and points == fused > 0, (name, e, tiles, points, fused)
        gaps = _view_gaps(out, ref)
        assert all(g <= lim for g, lim in zip(gaps, limits)), (name, gaps, limits)
        assert bool(torch.isfinite(out.rgb).all() and torch.isfinite(out.sem_logits).all())


def test_grid_render_view_against_the_plain_model(cuda_device, tmp_path):
    """A KITTI-360 demo-tree view of configs/torch/kitti360_grid.yaml (both fields
    hybrid) through `intersect_and_render`: G then E against the plain
    hybrid model within a tenth of the benchmark's limits for kitti360;
    G and E launched once per tile and level; every point encoded and
    fused."""
    import os

    from panopticnerf_tpu_torch.config import load_config
    from panopticnerf_tpu_torch.data import make_dataset
    from panopticnerf_tpu_torch.data.demo_tree import write_demo_tree

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    root = str(tmp_path / "tree")
    write_demo_tree(root, n_frames=2, hw=(376, 1408), n_boxes=8, seed=1, n_concave=2,
                    device=cuda_device)
    cfg = load_config(os.path.join(repo, "configs", "torch", "kitti360_grid.yaml"),
                      ["data.root", root, "data.frame_start", "0", "data.frame_num", "2"])
    ds, _, _ = make_dataset(cfg, cuda_device)
    out, ref, (e, points, fused, g, encoded), n = _render_both(cfg, cuda_device, ds, 1, 11)
    tiles = -(-n // cfg.render.ray_tile)
    assert e == g == 2 * tiles and points == fused == encoded > 0, (e, g, tiles, points, fused,
                                                                     encoded)
    gaps = _view_gaps(out, ref)
    assert all(x <= lim for x, lim in zip(gaps, (1e-5, 5e-6, 3e-4))), gaps
    assert bool(torch.isfinite(out.rgb).all() and torch.isfinite(out.sem_logits).all())


def test_grid_panorama_against_the_plain_model(cuda_device, tmp_path):
    """A 64x128 equirect panorama (`render_panorama`) of configs/torch/kitti360_360_grid.yaml
    (both fields 8x256 with a hash grid; its two sequences, fisheye) from a demo-tree view:
    G then E on both levels against the plain hybrid model within a tenth of the benchmark's
    kitti360 limits; G and E launched once per tile and level; every point encoded and
    fused; the rays behind and above the camera meet no primitive. The panorama's spans
    `render.panorama` and `render.panorama.rays` open once, `render.view` inside the first,
    and `render.panorama.pixels` counts its H x W rays."""
    import os

    from panopticnerf_tpu_torch.config import load_config
    from panopticnerf_tpu_torch.data import make_dataset
    from panopticnerf_tpu_torch.data.demo_tree import write_demo_tree
    from panopticnerf_tpu_torch.models import init_params, make_network
    from panopticnerf_tpu_torch.render import renderer, render_panorama
    from panopticnerf_tpu_torch.utils import profiling

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    root = str(tmp_path / "tree")
    # the pool on the card (stream_window 0): evaluation renders from the resident pool
    cfg = load_config(os.path.join(repo, "configs", "torch", "kitti360_360_grid.yaml"),
                      ["data.root", root, "data.frame_num", "2", "data.frame_start", "0",
                       "data.stream_window", "0"])
    for i, sq in enumerate(cfg.data.sequences):
        write_demo_tree(root, n_frames=2, hw=(94, 352), n_boxes=8, seed=i, seq=sq, fisheye=True,
                        n_concave=2, device=cuda_device)
    ds, _, _ = make_dataset(cfg, cuda_device)
    model = make_network(cfg, cuda_device).eval()
    init_params(model, torch.Generator(cuda_device).manual_seed(11))
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                p.normal_(0.0, 0.05, generator=torch.Generator(cuda_device).manual_seed(len(name)))
            elif ".table_" in name:
                p.uniform_(-1.0, 1.0, generator=torch.Generator(cuda_device).manual_seed(len(name)))
    hw = (64, 128)
    n = hw[0] * hw[1]
    profiling.reset()
    with torch.no_grad():
        out = render_panorama(model, ds, 1, hw, cfg)
    snap = profiling.snapshot()
    counts = (launches("E"), launches("G"), profiling.calls("render.field.points"),
              profiling.calls("render.field.points_fused"), profiling.calls("render.grid.points"))
    assert snap[("render.panorama", None)]["calls"] == 1
    assert snap[("render.panorama.rays", "render.panorama")]["calls"] == 1
    assert snap[("render.view", "render.panorama")]["calls"] == 1
    assert profiling.calls("render.panorama.pixels") == n
    profiling.reset()
    keep = renderer.eval_field
    renderer.eval_field = lambda m, c, dv: m
    try:
        with torch.no_grad():
            ref = render_panorama(model, ds, 1, hw, cfg)
    finally:
        renderer.eval_field = keep
    torch.cuda.synchronize()
    tiles = -(-n // cfg.render.ray_tile)
    e, g, points, fused, encoded = counts
    assert e == g == 2 * tiles and points == fused == encoded == n * (64 + 128), counts
    gaps = _view_gaps(out, ref)
    assert all(x <= lim for x, lim in zip(gaps, (1e-5, 5e-6, 3e-4))), gaps
    hit = (out.inst_ids >= 0).any(-1).float().mean()
    assert 0 < float(hit) < 1
    assert bool(torch.isfinite(out.rgb).all() and torch.isfinite(out.sem_logits).all())


def _composite_inputs(device, n, s, k, c, seed, logits=True, intervals=True, delta=False,
                      zero_rays=0):
    """Seeded inputs of one compositing level, as the evaluation render
    hands them over: E's f32 outputs, sorted depths, A1's intervals (entry
    sorted; misses at BIG with label -1 and mask False; some labelled -1
    but kept, as unlabelled stuff; a label past C - 1, which the fixed map
    clamps), samples placed exactly on an entry and an exit depth, and
    `zero_rays` trailing rays with the all-zero intervals a tile's padding
    gets."""
    from panopticnerf_tpu_torch.ops.intersect import RayIntervals

    g = torch.Generator().manual_seed(seed)
    sigma = torch.randn(n, s, generator=g) * 3.0
    rgb = torch.rand(n, s, 3, generator=g)
    sem = torch.randn(n, s, c, generator=g) * 2.0 if logits else None
    z = 0.5 + 12.0 * torch.rand(n, s, generator=g)
    dl = 0.2 * torch.rand(n, s, generator=g) if delta else None
    iv = None
    if intervals:
        t_in = (0.5 + 10.0 * torch.rand(n, k, generator=g)).sort(-1).values
        t_out = t_in + 3.0 * torch.rand(n, k, generator=g)
        mask = torch.rand(n, k, generator=g) < 0.75
        semantic = torch.randint(-1, c + 2, (n, k), generator=g, dtype=torch.int32)
        if s >= 8:  # samples exactly on the first interval's entry and exit depths
            z[:, 3] = t_in[:, 0]
            z[:, 7] = t_out[:, 0]
        t_in = torch.where(mask, t_in, BIG)
        t_out = torch.where(mask, t_out, BIG)
        semantic = torch.where(mask, semantic, -1).to(torch.int32)
        if zero_rays:
            for t in (t_in, t_out, semantic, mask):
                t[-zero_rays:] = 0
        iv = RayIntervals(t_in, t_out, semantic, semantic.clone(), mask)
    z = z.sort(-1).values
    put = lambda t: None if t is None else t.to(device).contiguous()
    return (put(sigma), put(rgb), put(sem), put(z), put(dl),
            None if iv is None else RayIntervals(*map(put, iv)))


def _composite_plain(sigma, rgb, sem, z, dl, iv, c, white_bkgd):
    """The evaluation branch's plain ops, as `render_rays` ran them before V."""
    from panopticnerf_tpu_torch.ops.composite import composite
    from panopticnerf_tpu_torch.ops.intersect import (
        fixed_map_from_weights,
        labeled_containment,
        samples_in_intervals,
    )

    inside = samples_in_intervals(z, iv) if iv is not None else None
    out = composite(sigma, rgb, z, sem_logits=sem, inside_intervals=inside,
                    white_bkgd=white_bkgd, delta=dl)
    if iv is not None:
        lab, cnt = labeled_containment(z, iv)
        out = out._replace(sem_fixed=fixed_map_from_weights(out.weights, lab, cnt, iv, c))
    return out


# V against the plain ops. Only the order of the sums differs (the same f32
# products, no multiply-add contraction on either side): the exclusive
# transmittance's sum of up to 128 taus moves a weight by a few ulps of 1
# (abs <= 1e-6); a map, a sum of S weighted values or of K masses, by a few
# ulps of its largest terms (relative Frobenius error <= 1e-5). A wrong
# containment edge, a dropped sample or a lost class moves them by 1e-2 or more.
W_ABS, MAP_REL = 1e-6, 1e-5


@pytest.mark.parametrize("s,k,c,logits,intervals,delta,white,zero_rays", [
    (64, 16, 19, True, True, False, False, 0),
    (128, 16, 19, True, True, False, False, 0),
    (96, 16, 19, True, True, True, False, 0),    # keep-M 96 with the full set's deltas
    (128, 12, 19, True, True, False, True, 5),   # the full-resolution protocol's K
    (64, 12, 45, False, True, False, False, 5),  # no learned logits; 45 classes
    (128, 16, 19, True, False, False, True, 0),  # no primitives
    (48, 8, 8, True, True, False, True, 3),      # synthetic_panoptic's shapes
    (37, 32, 128, True, True, True, False, 1),   # ragged S, the largest K and C
    (1, 1, 1, True, True, False, False, 0),
])
def test_composite_kernel_matches_plain(cuda_device, s, k, c, logits, intervals, delta, white,
                                        zero_rays):
    from panopticnerf_tpu_torch.ops.composite_cuda import composite_cuda

    n = 1000
    sigma, rgb, sem, z, dl, iv = _composite_inputs(cuda_device, n, s, k, c, s * 7 + k + c,
                                                   logits, intervals, delta, zero_rays)
    before = launches("V")
    got = composite_cuda(sigma, rgb, z, sem_logits=sem, delta=dl, iv=iv, num_classes=c,
                         white_bkgd=white)
    assert launches("V") == before + 1
    ref = _composite_plain(sigma, rgb, sem, z, dl, iv, c, white)
    torch.cuda.synchronize()
    for name in ref._fields:
        a, b = getattr(got, name), getattr(ref, name)
        assert (a is None) == (b is None), name
        if b is None:
            continue
        assert a.shape == b.shape and bool(torch.isfinite(a).all()), name
        if name == "weights":
            assert float((a - b).abs().max()) <= W_ABS, (name, float((a - b).abs().max()))
        else:
            rel = float(torch.linalg.vector_norm(a - b)
                        / torch.linalg.vector_norm(b).clamp_min(1e-30))
            assert rel <= MAP_REL, (name, rel)
    if intervals:
        assert float(got.inst_mass.abs().sum()) > 0 and float(got.sem_fixed.abs().sum()) > 0
        if zero_rays:  # no interval holds a padded ray's samples
            assert not bool(got.inst_mass[-zero_rays:].any())
            assert not bool(got.sem_fixed[-zero_rays:].any())


def test_composite_kernel_repeats_bit_for_bit(cuda_device):
    from panopticnerf_tpu_torch.ops.composite_cuda import composite_cuda

    args = _composite_inputs(cuda_device, 3000, 128, 16, 19, 5, delta=True)
    sigma, rgb, sem, z, dl, iv = args
    run = lambda: composite_cuda(sigma, rgb, z, sem_logits=sem, delta=dl, iv=iv, num_classes=19)
    a, b = run(), run()
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_composite_wrapper_rejects_bad_inputs(cuda_device):
    from panopticnerf_tpu_torch.ops.composite_cuda import composite_cuda

    sigma, rgb, sem, z, dl, iv = _composite_inputs(cuda_device, 64, 32, 16, 19, 1, delta=True)
    ok = dict(sem_logits=sem, delta=dl, iv=iv, num_classes=19)
    composite_cuda(sigma, rgb, z, **ok)
    widen = lambda times: type(iv)(*[torch.cat([t] * times, 1) for t in iv])
    composite_cuda(sigma, rgb, z, **dict(ok, iv=widen(2)))  # K = 32, the most V takes
    bad = [
        ((sigma.cpu(), rgb.cpu(), z.cpu()), dict(iv=None)),                   # not on the card
        ((sigma.double(), rgb, z), ok),                                       # dtype
        ((sigma, rgb[:, :-1].contiguous(), z), ok),                           # shape
        ((sigma, rgb, z.t().contiguous().t()), ok),                           # not contiguous
        ((sigma, rgb, z), dict(ok, sem_logits=sem[..., :0].contiguous())),    # C = 0
        ((sigma, rgb, z), dict(ok, num_classes=0)),                           # C = 0 for the map
        ((sigma, rgb, z), dict(ok, num_classes=129)),                         # C past 128
        ((sigma, rgb, z), dict(ok, iv=iv._replace(semantic=iv.semantic.long()))),
        ((sigma, rgb, z), dict(ok, iv=iv._replace(mask=iv.mask.to(torch.uint8)))),
        ((sigma, rgb, z), dict(ok, iv=widen(3))),                              # K = 48
        ((sigma, rgb, z), dict(ok, delta=dl[:, :-1].contiguous())),
    ]
    for args, kw in bad:
        with pytest.raises((ValueError, TypeError)):
            composite_cuda(*args, **kw)


def test_composite_kernel_counts_in_the_render(cuda_device):
    """A small evaluation render on the card composites every tile and
    level through V: V launched twice a tile, every ray of both levels
    counted as composited and as fused; with gradients on, the plain ops
    run (no launch, nothing fused) and the per-sample extras come back."""
    from panopticnerf_tpu_torch.config import load_config
    from panopticnerf_tpu_torch.data import make_dataset, view_primitives, view_rays
    from panopticnerf_tpu_torch.models import make_network
    from panopticnerf_tpu_torch.render import renderer
    from panopticnerf_tpu_torch.utils import profiling

    cfg = load_config(None, [
        "data.synthetic_image_hw", "24,40", "data.synthetic_num_frames", "2",
        "data.synthetic_num_boxes", "6", "data.max_primitives", "8",
        "data.max_intervals", "4", "model.trunk_depth", "2", "model.trunk_width", "32",
        "model.skips", "0", "model.color_width", "16", "model.num_classes", "7",
        "render.n_samples", "16", "render.n_importance", "16",
        "render.use_primitives", "true", "render.ray_tile", "256"])
    torch.manual_seed(0)
    model = make_network(cfg, cuda_device).eval()
    ds, _, _ = make_dataset(cfg, cuda_device)
    o, d = view_rays(ds, 0)
    bounds = renderer.SceneBounds(ds.bounds_center, ds.bounds_scale)
    profiling.reset()
    with torch.no_grad():
        out = renderer.intersect_and_render(cfg, model, o, d, view_primitives(ds, 0), bounds)
    torch.cuda.synchronize()
    tiles = -(-o.shape[0] // 256)
    assert launches("V") == 2 * tiles
    assert profiling.calls("render.composite.rays") == 2 * tiles * 256
    assert profiling.calls("render.composite.rays_fused") == 2 * tiles * 256
    assert out.sem_fixed is not None and out.inst_mass is not None
    profiling.reset()
    iv = renderer.intersect_rays(o[:64], d[:64], view_primitives(ds, 0), cfg.render.near,
                                 cfg.render.far, cfg.data.max_intervals)
    with torch.enable_grad():
        plain = renderer.render_rays(model, o[:64], d[:64], bounds, cfg, iv=iv, train=False)
    assert launches("V") == 0 and profiling.calls("render.composite.rays_fused") == 0
    assert profiling.calls("render.composite.rays") == 2 * 64
    assert plain.sample_inside_k is not None and plain.sample_cnt is not None
    with torch.no_grad():
        fused = renderer.render_rays(model, o[:64], d[:64], bounds, cfg, iv=iv, train=False)
    assert launches("V") == 2
    assert fused.sample_inside_k is None and fused.sample_cnt is None
    for name in ("rgb", "depth", "acc", "sem_logits", "sem_fixed", "inst_mass"):
        torch.testing.assert_close(getattr(fused, name), getattr(plain, name).detach(),
                                   rtol=1e-5, atol=1e-5)
    profiling.reset()


# ------------------------------------------------------------- kernel Z
# The evaluation render's sampling (csrc/sample.cu behind ops/sampling_cuda.py)
# against the plain ops of ops/sampling.py. Z differs from them only in the
# order of three sums (the cdf of the union segments, the sum of the weights,
# the cdf of the pdf), so: on inputs where every such sum is exact it equals
# them bit for bit; with those sums taken in Z's order (`KernelZOrder`) it
# equals them bit for bit on any input; against them as they are, it lies
# within the ceilings PERF.md derives from the sums' order.

Z_PAD = float(np.float32(1e-5))  # sample_pdf's 1e-5 as its float32 ops see it
Z_NEAR, Z_FAR = 0.5, 40.0


def _sampling_intervals(device, n, k, seed, dyadic=True):
    """(N, K) intervals in [Z_NEAR, Z_FAR] as A1 hands them over (entry
    sorted, misses at BIG, masked, last); on a 2^-8 grid when `dyadic`, so
    that every sum of their lengths is exact in any order. Rows of every
    kind, by ray index mod 8: random (overlapping, nested, disjoint,
    zero-length), 1 touching (each interval starts where the one before
    ends), 2 no hit (all masked), 3 zero-padded (all zero and unmasked, a
    padded tile's rays)."""
    from panopticnerf_tpu_torch.ops.intersect import RayIntervals

    g = torch.Generator().manual_seed(seed)
    q = (lambda t: torch.round(t * 256) / 256) if dyadic else (lambda t: t)
    span = Z_FAR - Z_NEAR
    kind = torch.arange(n) % 8
    t_in = q(Z_NEAR + (span - 4.0) * torch.rand(n, k, generator=g))
    length = q(4.0 * torch.rand(n, k, generator=g))
    length[torch.rand(n, k, generator=g) < 0.1] = 0.0
    steps = q(torch.rand(n, k, generator=g) * (span - 1.0) / k)
    starts = Z_NEAR + torch.cumsum(steps, 1) - steps
    t_in = torch.where((kind == 1)[:, None], starts, t_in)
    length = torch.where((kind == 1)[:, None], steps, length)
    t_out = t_in + length
    mask = (torch.rand(n, k, generator=g) < 0.8) & (kind != 2)[:, None]
    t_in, t_out = torch.where(mask, t_in, BIG), torch.where(mask, t_out, BIG)
    order = torch.argsort(t_in, dim=1, stable=True)
    t_in, t_out, mask = (torch.gather(t, 1, order) for t in (t_in, t_out, mask))
    pad = kind == 3
    t_in[pad], t_out[pad], mask[pad] = 0.0, 0.0, False
    sem = torch.full((n, k), -1, dtype=torch.int32)
    put = lambda t: t.to(device).contiguous()
    return RayIntervals(put(t_in), put(t_out), put(sem), put(sem.clone()), put(mask))


def _dyadic_weights(n, s, seed):
    """(N, S) weights whose interior (columns 1 .. S - 2, B of them) makes
    every sum of sample_pdf exact in any order: w + 1e-5 in float32 is
    m 2^q exactly, with integers m summing to 2^24, so the sum is 2^(24 + q),
    the pdf m 2^-24, and every partial sum of either a float32 value."""
    import math

    rng = np.random.default_rng(seed)
    b = s - 2
    unit = 2.0 ** max(-38, round(math.log2(3e-5 * b)) - 24)
    lo = math.ceil(Z_PAD / unit)                    # w >= 0
    hi = math.floor((2.0 ** -14 + Z_PAD) / unit)    # w < 2^-14: a float32 multiple of 2^-38
    rest = 2 ** 24 - b * lo
    p = rng.dirichlet(np.full(b, 20.0), size=n)
    r = np.floor(p * rest).astype(np.int64)
    r[np.arange(b)[None, :] < (rest - r.sum(1))[:, None]] += 1
    m = lo + r
    assert (m <= hi).all() and (m.sum(1) == 2 ** 24).all()
    w_in = m * unit - Z_PAD
    w32 = w_in.astype(np.float32)
    assert (w32.astype(np.float64) == w_in).all()
    assert ((w32 + np.float32(Z_PAD)).astype(np.float64) == m * unit).all()
    w = rng.random((n, s)).astype(np.float32)
    w[:, 1:-1] = w32
    return torch.from_numpy(w)


def _coarse_depths(n, s, seed, dyadic=True, unsorted=0):
    """(N, S) sorted coarse depths in [Z_NEAR, Z_FAR]; on a quarter-metre grid
    when `dyadic` (repeated depths: empty bins, fine depths equal to coarse
    ones, ties in the merge); the last `unsorted` rows shuffled."""
    g = torch.Generator().manual_seed(seed)
    z = Z_NEAR + (Z_FAR - Z_NEAR) * torch.rand(n, s, generator=g)
    if dyadic:
        z = torch.round(z * 4) / 4
    z = z.sort(1).values
    if unsorted:
        z[-unsorted:] = z[-unsorted:][:, torch.randperm(s, generator=g)]
    return z


def _sparse_weights(n, s, seed):
    """(N, S) weights as a render gives them: most rays a few bins of mass
    near a surface and the rest ~0, some uniform, some all zero."""
    g = torch.Generator().manual_seed(seed)
    w = torch.rand(n, s, generator=g) * (torch.rand(n, s, generator=g) < 0.1)
    w = w / w.sum(1, keepdim=True).clamp_min(1.0)
    kind = torch.arange(n) % 8
    w[kind == 4] = 0.0
    w[kind == 5] = 1.0 / s
    return w


def _plain_fine(z, w, m):
    """The evaluation render's plain fine depths (render_rays before Z)."""
    from panopticnerf_tpu_torch.ops import sampling

    z_mid = 0.5 * (z[:, 1:] + z[:, :-1])
    return sampling.merge_z(z, sampling.sample_pdf(z_mid, w[:, 1:-1], m, False))


@pytest.mark.parametrize("k,s,bg", [(16, 64, 0.25), (1, 64, 0.25), (32, 64, 0.25),
                                    (16, 48, 0.25), (16, 64, 0.0), (8, 9, 0.25),
                                    (16, 128, 0.25)])
def test_sample_coarse_bit_for_bit_on_dyadic_intervals(cuda_device, k, s, bg):
    """Z's coarse pass equals guided_z bit for bit where the union's sums are
    exact (the shipped 48 + 16 at K = 1, 16, 32; other splits; no
    background, whose depths stay unmerged)."""
    from panopticnerf_tpu_torch.ops import sampling
    from panopticnerf_tpu_torch.ops.sampling_cuda import guided_z_cuda

    iv = _sampling_intervals(cuda_device, 2000, k, seed=k * 1000 + s)
    before = launches("Z")
    got = guided_z_cuda(iv, s, Z_NEAR, Z_FAR, bg)
    assert launches("Z") == before + 1
    ref = sampling.guided_z(iv, s, Z_NEAR, Z_FAR, False, bg)
    torch.cuda.synchronize()
    assert got.shape == ref.shape and torch.equal(got, ref), \
        float((got - ref).abs().max())


@pytest.mark.parametrize("s,m,unsorted", [(64, 64, 0), (64, 64, 40), (128, 64, 0), (3, 1, 0),
                                          (64, 128, 0), (37, 5, 7)])
def test_sample_fine_bit_for_bit_on_dyadic_inputs(cuda_device, s, m, unsorted):
    """Z's fine pass equals sample_pdf + merge_z bit for bit where every sum
    is exact: dyadic weights, depths on a grid with repeats (empty bins and
    ties between the merged lists), some rows out of order (the merge's
    count of every pair)."""
    from panopticnerf_tpu_torch.ops.sampling_cuda import fine_z_cuda

    n = 2000
    z = _coarse_depths(n, s, seed=s + m, unsorted=unsorted).to(cuda_device)
    w = _dyadic_weights(n, s, seed=s * m).to(cuda_device)
    got = fine_z_cuda(z, w, m)
    ref = _plain_fine(z, w, m)
    torch.cuda.synchronize()
    assert got.shape == (n, s + m) and torch.equal(got, ref), float((got - ref).abs().max())


@pytest.mark.parametrize("k,s,m", [(16, 64, 64), (32, 64, 64), (4, 48, 96)])
def test_sample_bit_for_bit_in_its_own_order(cuda_device, monkeypatch, k, s, m):
    """On seeded random inputs (no grid), the plain ops with their sums taken
    in Z's order equal Z bit for bit: both passes, and keep-M on Z's depths."""
    from panopticnerf_tpu_torch.ops import sampling
    from panopticnerf_tpu_torch.ops.sampling_cuda import fine_z_cuda, guided_z_cuda

    n = 4096
    iv = _sampling_intervals(cuda_device, n, k, seed=7 + k, dyadic=False)
    z = guided_z_cuda(iv, s, Z_NEAR, Z_FAR, 0.25)
    w = _sparse_weights(n, s, seed=k).to(cuda_device)
    z_all = fine_z_cuda(z, w, m)
    monkeypatch.setattr(sampling, "torch", KernelZOrder())
    ref = sampling.guided_z(iv, s, Z_NEAR, Z_FAR, False, 0.25)
    ref_all = _plain_fine(z, w, m)
    z_mid, w_int = 0.5 * (z[:, 1:] + z[:, :-1]), w[:, 1:-1]
    keep = sampling.topm_eval_select(z_all, z_mid, w_int, s)
    keep_ref = sampling.topm_eval_select(ref_all, z_mid, w_int, s)
    torch.cuda.synchronize()
    assert torch.equal(z, ref), float((z - ref).abs().max())
    assert torch.equal(z_all, ref_all), float((z_all - ref_all).abs().max())
    assert all(torch.equal(a, b) for a, b in zip(keep, keep_ref))


def test_sample_against_the_plain_ops_within_the_order_ceiling(cuda_device):
    """On seeded random inputs, Z against the plain ops as they are: every
    depth within the ceiling that the sums' order allows, but on the few
    rays where the two orders put a position into another segment or bin,
    or decide the 1e-5 rule otherwise (both derived and found in
    `torch_sampling_order.against_plain`)."""
    iv = _sampling_intervals(cuda_device, 4096, 16, seed=3, dyadic=False)
    w = _sparse_weights(4096, 64, seed=5).to(cuda_device)
    r = against_plain(iv, 64, 0.25, w, 64, Z_NEAR, Z_FAR)
    print("Z against the plain ops:", r)
    assert r["coarse_gap"] <= r["coarse_ceiling"], r
    assert r["fine_over"] <= 0.0, r
    assert r["coarse_flips"] <= 4096 // 100 and r["fine_flips"] <= 4096 // 20, r


def test_sample_kernel_repeats_bit_for_bit(cuda_device):
    from panopticnerf_tpu_torch.ops.sampling_cuda import fine_z_cuda, guided_z_cuda

    iv = _sampling_intervals(cuda_device, 20000, 16, seed=1, dyadic=False)
    w = _sparse_weights(20000, 64, seed=2).to(cuda_device)
    a = guided_z_cuda(iv, 64, Z_NEAR, Z_FAR)
    b = guided_z_cuda(iv, 64, Z_NEAR, Z_FAR)
    fa, fb = fine_z_cuda(a, w, 64), fine_z_cuda(a, w, 64)
    torch.cuda.synchronize()
    assert torch.equal(a, b) and torch.equal(fa, fb)


def test_sample_wrapper_rejects_bad_inputs(cuda_device):
    from panopticnerf_tpu_torch.ops.sampling_cuda import fine_z_cuda, guided_z_cuda

    iv = _sampling_intervals(cuda_device, 64, 16, seed=1)
    z = _coarse_depths(64, 64, seed=1).to(cuda_device)
    w = _dyadic_weights(64, 64, seed=1).to(cuda_device)
    guided_z_cuda(iv, 64, Z_NEAR, Z_FAR)
    fine_z_cuda(z, w, 64)
    widen = lambda times: type(iv)(*[torch.cat([t] * times, 1) for t in iv])
    guided_z_cuda(widen(2), 64, Z_NEAR, Z_FAR)  # K = 32, the most Z takes
    bad_coarse = [
        (iv._replace(t_in=iv.t_in.cpu(), t_out=iv.t_out.cpu(), mask=iv.mask.cpu()), 64),
        (iv._replace(t_in=iv.t_in.double()), 64),
        (iv._replace(mask=iv.mask.to(torch.uint8)), 64),
        (iv._replace(t_out=iv.t_out[:, :-1].contiguous()), 64),
        (iv._replace(t_in=iv.t_in.t().contiguous().t()), 64),
        (widen(3), 64),                                   # K = 48
        (iv, 1),                                          # S_in 0
        (iv, 1100),                                       # S past 1024
    ]
    for args in bad_coarse:
        with pytest.raises((ValueError, TypeError)):
            guided_z_cuda(*args, Z_NEAR, Z_FAR)
    bad_fine = [
        (z.cpu(), w.cpu(), 64),
        (z.double(), w, 64),
        (z, w.half(), 64),
        (z, w[:, :-1].contiguous(), 64),
        (z.t().contiguous().t(), w, 64),
        (z[:, :2].contiguous(), w[:, :2].contiguous(), 64),  # S 2
        (z, w, 0),
        (z, w, 961),                                         # S + M past 1024
    ]
    for args in bad_fine:
        with pytest.raises((ValueError, TypeError)):
            fine_z_cuda(*args)


def test_sample_kernel_counts_in_the_render(cuda_device):
    """A small evaluation render on the card samples every tile and level
    through Z: Z launched twice a tile, every ray of both levels counted as
    sampled and as fused; keep-M runs on Z's depths; with gradients on the
    plain ops run (no launch, nothing fused) and give the same depths within
    the ceiling; the training render never launches Z."""
    from panopticnerf_tpu_torch.config import load_config
    from panopticnerf_tpu_torch.data import make_dataset, view_primitives, view_rays
    from panopticnerf_tpu_torch.models import make_network
    from panopticnerf_tpu_torch.render import renderer
    from panopticnerf_tpu_torch.utils import profiling

    opts = ["data.synthetic_image_hw", "24,40", "data.synthetic_num_frames", "2",
            "data.synthetic_num_boxes", "6", "data.max_primitives", "8",
            "data.max_intervals", "4", "model.trunk_depth", "2", "model.trunk_width", "32",
            "model.skips", "0", "model.color_width", "16", "model.num_classes", "7",
            "render.n_samples", "16", "render.n_importance", "16",
            "render.use_primitives", "true", "render.ray_tile", "256"]
    cfg = load_config(None, opts)
    torch.manual_seed(0)
    model = make_network(cfg, cuda_device).eval()
    ds, _, _ = make_dataset(cfg, cuda_device)
    o, d = view_rays(ds, 0)
    bounds = renderer.SceneBounds(ds.bounds_center, ds.bounds_scale)
    tiles = -(-o.shape[0] // 256)
    for keep in (0, 20):
        kcfg = load_config(None, opts + ["render.eval_keep_samples", str(keep)])
        profiling.reset()
        with torch.no_grad():
            out = renderer.intersect_and_render(kcfg, model, o, d, view_primitives(ds, 0), bounds)
        torch.cuda.synchronize()
        assert launches("Z") == launches("V") == 2 * tiles
        assert profiling.calls("render.sample.rays") == 2 * tiles * 256
        assert profiling.calls("render.sample.rays_fused") == 2 * tiles * 256
        assert bool(torch.isfinite(out.rgb).all())
    profiling.reset()
    iv = renderer.intersect_rays(o[:64], d[:64], view_primitives(ds, 0), cfg.render.near,
                                 cfg.render.far, cfg.data.max_intervals)
    with torch.enable_grad():
        plain = renderer.render_rays(model, o[:64], d[:64], bounds, cfg, iv=iv, train=False)
    assert launches("Z") == 0 and profiling.calls("render.sample.rays_fused") == 0
    assert profiling.calls("render.sample.rays") == 2 * 64
    with torch.no_grad():
        fused = renderer.render_rays(model, o[:64], d[:64], bounds, cfg, iv=iv, train=False)
    assert launches("Z") == 2
    ceil = (4 * 4 + 4) * 2.0 ** -24 * cfg.render.far  # against_plain's coarse ceiling, K = 4
    assert float((fused.coarse.z - plain.coarse.z).abs().max()) <= ceil
    torch.testing.assert_close(fused.z, plain.z.detach(), rtol=1e-4, atol=1e-4)
    profiling.reset()
    with torch.enable_grad():
        renderer.render_rays(model, o[:64], d[:64], bounds, cfg, iv=iv, train=True,
                             generator=torch.Generator(cuda_device).manual_seed(0))
    with torch.no_grad():  # a training render without gradients still samples plainly
        renderer.render_rays(model, o[:64], d[:64], bounds, cfg, iv=iv, train=True,
                             generator=torch.Generator(cuda_device).manual_seed(0))
    assert launches("Z") == 0 and profiling.calls("render.sample.rays") == 0
    profiling.reset()
