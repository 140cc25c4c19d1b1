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
from torch_scenes import random_boxes, random_rays

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _to(device, w2p, sem, inst, valid, planes):
    t = lambda a: torch.from_numpy(a).to(device)
    return Primitives(t(w2p), t(sem), t(inst), t(valid),
                      None if planes is None else t(planes))


@pytest.mark.parametrize("p,f,k,dup", [(32, 0, 16, 0), (32, 8, 16, 0),
                                       (5, 0, 8, 0), (24, 0, 16, 6),
                                       (12, 4, 4, 3)])
def test_intersect_kernel_matches_plain(cuda_device, p, f, k, dup):
    rng = np.random.default_rng(p * 100 + f * 10 + k)
    scene, centers = random_boxes(rng, p, f, dup)
    o, d = random_rays(rng, 5000, centers, n_zero=16)
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
    from panopticnerf_tpu_torch.ops.intersect_cuda import intersect_rays_cuda

    rng = np.random.default_rng(0)
    scene, centers = random_boxes(rng, 8)
    prims = _to(cuda_device, *scene)
    o, d = random_rays(rng, 64, centers)
    before = intersect_rays_cuda.launches
    intersect_rays(torch.from_numpy(o).to(cuda_device),
                   torch.from_numpy(d).to(cuda_device), prims, 0.5, 40.0, 4)
    assert intersect_rays_cuda.launches == before + 1


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


def test_tiny_render_cuda_matches_cpu(cuda_device):
    """The whole evaluation render of a tiny synthetic config on the card
    (through the kernel) against the same render on the CPU (through its
    plain version), float32 field with TF32 off."""
    from panopticnerf_tpu_torch import engine
    from panopticnerf_tpu_torch.config import load_config
    from panopticnerf_tpu_torch.data import make_dataset
    from panopticnerf_tpu_torch.models import make_network
    from panopticnerf_tpu_torch.ops.intersect_cuda import intersect_rays_cuda

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
    before = intersect_rays_cuda.launches
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
    assert intersect_rays_cuda.launches == before + 2
