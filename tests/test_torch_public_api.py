"""The port's `ops.make_box_primitives`, `ops.fixed_semantic_distribution`
and `viz.make_visualizer` against the JAX package's, on seeded inputs
(float32 on the CPU)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panopticnerf_tpu import ops as jops
from panopticnerf_tpu_torch import ops
from torch_scenes import random_boxes, random_rays


def _boxes(seed, p=7):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-6, 6, (p, 3)).astype(np.float32)
    sizes = rng.uniform(0.0, 4.0, (p, 3)).astype(np.float32)
    sizes[0, 1] = 0.0  # a degenerate extent, clamped to 1e-9 in both
    rots, _ = np.linalg.qr(rng.normal(size=(p, 3, 3)))
    return (centers, sizes, rots.astype(np.float32), rng.integers(0, 19, p),
            rng.integers(0, 900, p))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("with_valid", [False, True])
def test_make_box_primitives_matches_jax(seed, with_valid):
    args = _boxes(seed)
    valid = np.arange(7) % 3 != 0 if with_valid else None
    ref = jops.make_box_primitives(*[jnp.asarray(a) for a in args],
                                   None if valid is None else jnp.asarray(valid))
    out = ops.make_box_primitives(*[torch.from_numpy(np.asarray(a)) for a in args],
                                  None if valid is None else torch.from_numpy(valid))
    np.testing.assert_allclose(out.world_to_prim.numpy(), np.asarray(ref.world_to_prim),
                               rtol=1e-6, atol=1e-6)
    for name in ("semantic", "instance", "valid"):
        a, b = getattr(out, name).numpy(), np.asarray(getattr(ref, name))
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert out.cut_planes is None


@pytest.mark.parametrize("seed", [0, 3])
def test_fixed_semantic_distribution_matches_jax(seed):
    rng = np.random.default_rng(seed)
    (w2p, sem, inst, valid, _), centers = random_boxes(rng, 9)
    o, d = random_rays(rng, 64, centers)
    sem[:2] = -1  # unlabelled primitives carry no class
    prims = ops.Primitives(*[torch.from_numpy(a) for a in (w2p, sem, inst, valid)])
    jprims = jops.Primitives(*[jnp.asarray(a) for a in (w2p, sem, inst, valid)])
    iv = ops.intersect_rays(torch.from_numpy(o), torch.from_numpy(d), prims, 0.5, 40.0, 4)
    jiv = jops.intersect_rays(jnp.asarray(o), jnp.asarray(d), jprims, 0.5, 40.0, 4)
    z = np.sort(rng.uniform(0.5, 30.0, (64, 24)), axis=1).astype(np.float32)
    dist, any_lab = ops.fixed_semantic_distribution(torch.from_numpy(z), iv, 19)
    jdist, jany = jops.fixed_semantic_distribution(jnp.asarray(z), jiv, 19)
    assert bool(any_lab.any()) and np.array_equal(any_lab.numpy(), np.asarray(jany))
    np.testing.assert_allclose(dist.numpy(), np.asarray(jdist), rtol=1e-6, atol=1e-7)
    sums = dist.sum(-1).numpy()
    np.testing.assert_allclose(sums[any_lab.numpy()], 1.0, rtol=1e-6)


def test_make_visualizer_matches_jax(tmp_path):
    from panopticnerf_tpu.config import load_config as jax_load_config
    from panopticnerf_tpu.viz import make_visualizer as jax_make_visualizer
    from panopticnerf_tpu_torch.config import load_config
    from panopticnerf_tpu_torch.viz import Visualizer, make_visualizer

    opts = ["result_dir", str(tmp_path), "model.num_classes", "19"]
    viz, jviz = make_visualizer(load_config(None, opts)), jax_make_visualizer(
        jax_load_config(None, opts))
    assert isinstance(viz, Visualizer)
    assert viz.out_dir == jviz.out_dir
    assert np.array_equal(viz.sem_palette, jviz.sem_palette)
    assert np.array_equal(viz.inst_palette, jviz.inst_palette)
