"""The port's field (`models/nerf.py`) and weight converter (`convert.py`)
against the flax field of the JAX package, at three levels:

1. a small flax PanopticNeRF with random initial weights, converted with
   `params_from_flax`: forward parity in float32 (atol 1e-5) and under the
   bfloat16 compute dtype (atol 3e-2: bf16 keeps 8 mantissa bits, so a
   rounding flip in one intermediate moves an output by a bf16 ulp of its
   magnitude, up to ~1e-2 for the O(1) outputs here; XLA's CPU dot and
   torch's CPU bf16 matmul accumulate in different orders);
2. the committed `artifacts/torch/synthetic_flagship_10000.npz` equals the
   orbax restore of `artifacts/panopticnerf/synthetic_flagship/10000`;
3. the full-width (8x256) committed field against the JAX field on 256
   points in bf16: most outputs bit-equal, the rest within two bf16 ulps
   (or the atol above for values near zero).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panopticnerf_tpu.config import load_config as jax_load_config
from panopticnerf_tpu.models import init_params, make_network as jax_make_network
from panopticnerf_tpu_torch.config import load_config
from panopticnerf_tpu_torch.convert import flatten, load_npz, params_from_flax
from panopticnerf_tpu_torch.models import make_network

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = os.path.join(REPO, "configs", "synthetic_flagship.yaml")
NPZ = os.path.join(REPO, "artifacts", "torch", "synthetic_flagship_10000.npz")

SMALL = ["model.trunk_depth", "4", "model.trunk_width", "32", "model.skips", "1",
         "model.color_width", "16", "model.num_classes", "5",
         "model.xyz_freqs", "4", "model.dir_freqs", "2", "render.n_importance", "8"]


def _inputs(n=64, s=3, seed=0):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1, 1, (n, s, 3)).astype(np.float32)
    dirs = rng.normal(size=(n, 1, 3))
    dirs = (dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)).astype(np.float32)
    return pts, dirs


def _both(opts, params=None):
    jcfg = jax_load_config(None, opts)
    jm = jax_make_network(jcfg)
    if params is None:
        params = init_params(jm, jax.random.key(3))
    tm = make_network(load_config(None, opts), "cpu")
    tm.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    return jm, params, tm


def _forward(jm, params, tm, pts, dirs, level):
    jo = jm.apply(params, jnp.asarray(pts), jnp.asarray(dirs), level=level)
    with torch.no_grad():
        to = tm(torch.from_numpy(pts), torch.from_numpy(dirs), level=level)
    return [np.asarray(a) for a in jo], [b.numpy() for b in to]


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-5), ("bfloat16", 3e-2)])
@pytest.mark.parametrize("level", [0, 1])
def test_small_field_forward_parity(dtype, atol, level):
    jm, params, tm = _both(SMALL + ["model.compute_dtype", dtype])
    pts, dirs = _inputs()
    jo, to = _forward(jm, params, tm, pts, dirs, level)
    for a, b in zip(jo, to):
        assert a.shape == b.shape and b.dtype == np.float32
        np.testing.assert_allclose(b, a, rtol=0, atol=atol)


def test_small_proposal_coarse_field_parity():
    """model.coarse_trunk_depth/width shrink the coarse field only."""
    opts = SMALL + ["model.compute_dtype", "float32", "model.coarse_trunk_depth", "2",
                    "model.coarse_trunk_width", "16"]
    jm, params, tm = _both(opts)
    assert tm.coarse.trunk_0.weight.shape == (16, 27)
    pts, dirs = _inputs(seed=1)
    for level in (0, 1):
        jo, to = _forward(jm, params, tm, pts, dirs, level)
        for a, b in zip(jo, to):
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-5)


def test_params_from_flax_layouts():
    jm, params, _ = _both(SMALL)
    state = params_from_flax(jax.tree.map(np.asarray, params))
    k = np.asarray(params["params"]["fine"]["trunk_2"]["kernel"])  # (in, out), after the skip
    assert k.shape == (32 + 27, 32)
    np.testing.assert_array_equal(state["fine.trunk_2.weight"].numpy(), k.T)
    flat = {"fine/sigma/bias": np.ones(1, np.float32), "fine/sigma/kernel": np.ones((4, 1))}
    assert params_from_flax(flat)["fine.sigma.weight"].shape == (1, 4)
    with pytest.raises(KeyError):
        params_from_flax({"fine/sigma/scale": np.ones(1)})


@pytest.fixture(scope="module")
def flagship_params():
    from panopticnerf_tpu.train.checkpoint import load_network

    cfg = jax_load_config(FLAGSHIP)
    cfg.model_dir = os.path.join(REPO, "artifacts")
    tpl = init_params(jax_make_network(cfg), jax.random.key(0))
    params, step = load_network(tpl, cfg.trained_model_dir)
    assert step == 10000
    return params


def test_committed_npz_equals_orbax_restore(flagship_params):
    flat = {k: np.asarray(v) for k, v in flatten(flagship_params["params"]).items()}
    with np.load(NPZ) as z:
        assert sorted(z.files) == sorted(flat)
        for k in z.files:
            assert z[k].dtype == flat[k].dtype
            np.testing.assert_array_equal(z[k], flat[k])


def test_flagship_field_bf16_parity(flagship_params):
    cfg = jax_load_config(FLAGSHIP)
    jm = jax_make_network(cfg)
    tm = make_network(load_config(FLAGSHIP), "cpu")
    tm.load_state_dict(load_npz(NPZ))
    assert tm.fine.trunk_5.weight.shape == (256, 319)
    assert dataclasses.asdict(tm.fine.cfg)["compute_dtype"] == "bfloat16"
    rng = np.random.default_rng(0)
    pts = rng.uniform(-0.5, 0.5, (256, 1, 3)).astype(np.float32)
    dirs = rng.normal(size=(256, 1, 3))
    dirs = (dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)).astype(np.float32)
    for level in (0, 1):
        jo, to = _forward(jm, flagship_params, tm, pts, dirs, level)
        for a, b in zip(jo, to):
            # two bf16 ulps relative (2^-7 each), and the small-field atol
            # for logits near zero, which inherit flips from wider layers
            np.testing.assert_allclose(b, a, rtol=2.0 ** -6, atol=3e-2)
            assert (a == b).mean() > 0.5
