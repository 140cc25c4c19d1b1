"""The port's plain intersection (`panopticnerf_tpu_torch.ops.intersect`)
against the JAX package's TPU kernel in interpret mode
(`intersect_rays_pallas(..., interpret=True)`) and its XLA path
(`intersect_rays`), on the same numpy-seeded inputs.

Mask, semantic and instance ids must be equal; t_in / t_out agree to
atol 1e-5 (float32; XLA may contract multiply-adds and sums the
local-frame coordinates in another order, so the last bits may differ; a
cut plane nearly parallel to a ray divides by a small n.d and scales such
differences up, which is why the JAX package holds its own kernel to its
XLA path with an added rtol 1e-5).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panopticnerf_tpu.ops.intersect import Primitives as JPrimitives
from panopticnerf_tpu.ops.intersect import intersect_rays as jax_intersect_rays
from panopticnerf_tpu.ops.pallas_intersect import intersect_rays_pallas
from panopticnerf_tpu_torch.ops.intersect import BIG, Primitives, intersect_rays
from torch_scenes import random_boxes, random_rays

NEAR, FAR = 0.5, 40.0


def _run_all(scene, o, d, k):
    w2p, sem, inst, valid, planes = scene
    tp = Primitives(*(torch.from_numpy(a) for a in (w2p, sem, inst, valid)),
                    cut_planes=None if planes is None else torch.from_numpy(planes))
    port = intersect_rays(torch.from_numpy(o), torch.from_numpy(d), tp, NEAR, FAR, k)
    jp = JPrimitives(jnp.asarray(w2p), jnp.asarray(sem), jnp.asarray(inst),
                     jnp.asarray(valid), None if planes is None else jnp.asarray(planes))
    pallas = intersect_rays_pallas(jnp.asarray(o), jnp.asarray(d), jp, NEAR, FAR, k,
                                   tile=64, interpret=True)
    xla = jax_intersect_rays(jnp.asarray(o), jnp.asarray(d), jp, NEAR, FAR, k)
    return port, pallas, xla


def _assert_same(port, ref):
    m = np.asarray(ref.mask)
    np.testing.assert_array_equal(port.mask.numpy(), m)
    np.testing.assert_array_equal(port.semantic.numpy(), np.asarray(ref.semantic))
    np.testing.assert_array_equal(port.instance.numpy(), np.asarray(ref.instance))
    np.testing.assert_allclose(port.t_in.numpy(), np.asarray(ref.t_in), rtol=0, atol=1e-5)
    np.testing.assert_allclose(port.t_out.numpy(), np.asarray(ref.t_out), rtol=0, atol=1e-5)
    assert port.semantic.dtype == torch.int32 and port.mask.dtype == torch.bool
    assert bool((port.t_in[~port.mask] == BIG).all())
    assert bool((port.semantic[~port.mask] == -1).all())


@pytest.mark.parametrize("p,f,k,dup", [
    (12, 0, 4, 0),    # F = 0, K < P
    (12, 4, 8, 0),    # cut planes
    (5, 0, 16, 0),    # K > P
    (10, 0, 6, 4),    # duplicated primitives: exact ties
    (8, 3, 12, 3),    # ties with cut planes, K > P
])
def test_plain_intersect_matches_pallas_and_xla(p, f, k, dup):
    scene, centers = random_boxes(np.random.default_rng(p * 7 + f), p, f, dup)
    o, d = random_rays(np.random.default_rng(p + k), 192, centers, n_zero=8, n_away=16)
    port, pallas, xla = _run_all(scene, o, d, k)
    assert int(port.mask.sum()) > 0 and not bool(port.mask[96:112].any())
    _assert_same(port, pallas)
    _assert_same(port, xla)
    if dup:
        # exact ties occurred, and their order matched the reference's above
        ties = (port.t_in[:, 1:] == port.t_in[:, :-1]) & port.mask[:, 1:]
        assert bool(ties.any())


def test_plain_intersect_zero_direction_rays():
    """Padding rays (d = 0) inside a box span [near, far]; outside, nothing."""
    scene, _ = random_boxes(np.random.default_rng(3), 4)
    w2p = scene[0]
    # ray origin at box 0's centre (inside) and one far away (outside)
    c0 = -np.linalg.solve(w2p[0, :, :3].astype(np.float64), w2p[0, :, 3].astype(np.float64))
    o = np.stack([c0, [100.0, 100.0, 100.0]]).astype(np.float32)
    d = np.zeros((2, 3), np.float32)
    scene = (w2p, scene[1], scene[2], np.ones(4, bool), None)
    port, pallas, xla = _run_all(scene, o, d, 4)
    _assert_same(port, pallas)
    _assert_same(port, xla)
    assert bool(port.mask[0, 0]) and float(port.t_in[0, 0]) == NEAR
    assert float(port.t_out[0, 0]) == FAR and not bool(port.mask[1].any())


def test_intersect_rays_rejects_unknown_device():
    scene, centers = random_boxes(np.random.default_rng(0), 4)
    o, d = random_rays(np.random.default_rng(0), 8, centers)
    tp = Primitives(*(torch.from_numpy(a) for a in scene[:4]))
    with pytest.raises(ValueError):
        intersect_rays(torch.from_numpy(o).to("meta"), torch.from_numpy(d).to("meta"),
                       tp, NEAR, FAR, 4)
