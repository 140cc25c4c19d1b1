"""The port's fused trunk (the plain version of kernels B / B') and the
fused field adapter against the JAX package's Pallas versions in interpret
mode, plus `init_params` against flax's initialisers. Small shapes: widths
32-64, up to 8 layers, a few hundred points."""

import contextlib
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panopticnerf_tpu.config import load_config as jax_load_config
from panopticnerf_tpu.models import init_params as jax_init_params
from panopticnerf_tpu.models import make_network as jax_make_network
from panopticnerf_tpu.models.pallas_apply import pallas_field_apply
from panopticnerf_tpu.ops.pallas_mlp_train import fused_trunk_train as jax_fused_trunk_train
from panopticnerf_tpu_torch.config import load_config
from panopticnerf_tpu_torch.convert import flatten, params_from_flax, params_to_flax
from panopticnerf_tpu_torch.models import init_params, make_network
from panopticnerf_tpu_torch.models.fused_apply import FusedTrainAdapter, fused_field_apply
from panopticnerf_tpu_torch.ops import _nvcc
from panopticnerf_tpu_torch.ops._nvcc import TMA_ENCODE_FAILED
from panopticnerf_tpu_torch.ops.mlp_train import (
    MAX_SPLITS,
    POINT_STEP,
    fused_trunk_train,
    weight_splits,
)
from panopticnerf_tpu_torch.ops.mlp_train_cuda import backward_plan_bytes, forward_plan_bytes
from panopticnerf_tpu_torch.utils import profiling


def _trunk_inputs(n, layers, width, f, skips, seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (n, f)).astype(np.float32)
    ws = [(rng.normal(size=((f if i == 0 else width + (f if i in skips else 0)), width))
           * np.sqrt(2.0 / width)).astype(np.float32) for i in range(layers)]
    bs = [(rng.normal(size=(width,)) * 0.1).astype(np.float32) for _ in range(layers)]
    r = rng.normal(size=(n, width)).astype(np.float32)
    return x, ws, bs, r


@pytest.mark.parametrize("dtype,n,layers,width,skips", [
    ("float32", 200, 4, 32, (2,)),
    ("float32", 77, 3, 32, ()),
    ("bfloat16", 300, 8, 64, (5,)),   # flagship-style: flax skip 4 -> kernel skip 5
    ("bfloat16", 129, 3, 32, ()),
])
def test_fused_trunk_matches_pallas_interpret(dtype, n, layers, width, skips):
    """Forward and dx / dW / db against `fused_trunk_train(interpret=True)`
    on a random cotangent, ragged N (not a tile multiple). Same rounding
    placement on both sides: float32 agrees to 1e-5; bf16 to one bf16 ulp
    of the largest entry (the CPU sums in another order, so a rare
    rounding flips)."""
    x, ws, bs, r = _trunk_inputs(n, layers, width, 63, skips, n)
    jdt = jnp.dtype(dtype)

    def jf(x_, ws_, bs_):
        out = jax_fused_trunk_train(x_.astype(jdt), ws_, bs_, skips, tile=128, interpret=True)
        return jnp.sum(out * r), out

    (_, jout), jg = jax.value_and_grad(jf, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(x), [jnp.asarray(w) for w in ws], [jnp.asarray(b) for b in bs])
    tx = torch.from_numpy(x).requires_grad_()
    tw = [torch.from_numpy(w).requires_grad_() for w in ws]
    tb = [torch.from_numpy(b).requires_grad_() for b in bs]
    out = fused_trunk_train(tx.to(getattr(torch, dtype)), tw, tb, skips)
    assert out.dtype == torch.float32 and out.shape == (n, width)
    (out * torch.from_numpy(r)).sum().backward()
    pairs = [("out", jout, out), ("dx", jg[0], tx.grad)]
    pairs += [(f"dw{i}", jg[1][i], tw[i].grad) for i in range(layers)]
    pairs += [(f"db{i}", jg[2][i], tb[i].grad) for i in range(layers)]
    for name, a, b in pairs:
        a, b = np.asarray(a, np.float32), b.detach().float().numpy()
        atol = 1e-5 * max(1.0, np.abs(a).max())
        if dtype == "bfloat16":
            atol = np.abs(a).max() * 2.0 ** -7
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=atol, err_msg=name)


FIELD = ["model.trunk_depth", "6", "model.trunk_width", "64", "model.skips", "4",
         "model.color_width", "32", "model.num_classes", "5", "render.n_importance", "8",
         "model.use_pallas", "true"]


@pytest.mark.parametrize("dtype,level", [("float32", 1), ("bfloat16", 0), ("bfloat16", 1)])
def test_fused_adapter_matches_pallas_field_apply(dtype, level):
    """`FusedTrainAdapter` vs `pallas_field_apply(mode="trunk")`: sigma /
    rgb / semantic logits and the gradient of every parameter. float32
    agrees to 1e-4. In bf16 the two frameworks round the heads' products
    and their gradient sums at other places, so outputs are held to 2 % of
    each array's largest entry and each gradient leaf to a relative
    Frobenius error of 3 %."""
    opts = FIELD + ["model.compute_dtype", dtype]
    jcfg, cfg = jax_load_config(None, opts), load_config(None, opts)
    jmodel = jax_make_network(jcfg)
    params = jax_init_params(jmodel, jax.random.key(3))
    rng = np.random.default_rng(level)
    pts = rng.uniform(-1, 1, (24, 5, 3)).astype(np.float32)
    dirs = rng.normal(size=(24, 1, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    rs = [rng.normal(size=s).astype(np.float32) for s in [(24, 5), (24, 5, 3), (24, 5, 5)]]

    def jloss(p):
        outs = pallas_field_apply(p, jcfg.model, jnp.asarray(pts), jnp.asarray(dirs),
                                  level=level, has_fine=True, interpret=True, mode="trunk")
        return sum(jnp.sum(o * r_) for o, r_ in zip(outs, rs)), outs

    (_, jouts), jgrads = jax.value_and_grad(jloss, has_aux=True)(params)
    model = make_network(cfg, "cpu")
    model.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    outs = FusedTrainAdapter(model, cfg.model)(torch.from_numpy(pts), torch.from_numpy(dirs),
                                               level=level)
    sum(torch.sum(o * torch.from_numpy(r_)) for o, r_ in zip(outs, rs)).backward()
    tol = (lambda a: 1e-4) if dtype == "float32" else (lambda a: 0.02 * max(np.abs(a).max(), 1e-6))
    for name, a, b in zip(("sigma", "rgb", "sem"), jouts, outs):
        a = np.asarray(a, np.float32)
        np.testing.assert_allclose(b.detach().numpy(), a, rtol=0, atol=tol(a), err_msg=name)
    want = {k: np.asarray(v) for k, v in flatten(jgrads["params"]).items()}
    got = params_to_flax({k: torch.zeros_like(p) if p.grad is None else p.grad
                          for k, p in model.named_parameters()})
    assert set(got) == set(want)
    sub = "fine" if level == 1 else "coarse"
    assert any(np.abs(v).max() > 0 for k, v in got.items() if k.startswith(sub))
    for k in want:
        if dtype == "float32":
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-4, err_msg=k)
        else:
            err = np.linalg.norm(got[k] - want[k]) / max(np.linalg.norm(want[k]), 1e-12)
            assert err <= 0.03, (k, err)


def test_fused_field_small_coarse_and_modes():
    """The proposal-sized coarse field runs the plain flax chain in every
    mode (same numbers as the plain model); an unknown mode raises
    ValueError (the JAX package would take it as "field")."""
    opts = FIELD + ["model.coarse_trunk_depth", "2", "model.coarse_trunk_width", "32",
                    "model.compute_dtype", "float32"]
    cfg = load_config(None, opts)
    model = make_network(cfg, "cpu")
    init_params(model, torch.Generator().manual_seed(0))
    pts = torch.rand(4, 3, 3)
    dirs = torch.nn.functional.normalize(torch.randn(4, 1, 3), dim=-1)
    for mode in ("trunk", "hybrid", "field"):
        for a, b in zip(fused_field_apply(model, cfg.model, pts, dirs, level=0, mode=mode),
                        model(pts, dirs, level=0)):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
        for a, b in zip(FusedTrainAdapter(model, cfg.model, mode=mode)(pts, dirs, level=0),
                        model(pts, dirs, level=0)):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError):
        fused_field_apply(model, cfg.model, pts, dirs, level=1, mode="fused")
    with pytest.raises(ValueError):
        FusedTrainAdapter(model, cfg.model, mode="Field")


def test_init_params_statistics_match_flax():
    """lecun normal weights (truncated at 2 sigma, variance 1 / fan_in) and
    zero biases, as flax's Dense gives: per-layer std within 3 % and the
    truncation bound of flax's own draw."""
    opts = ["model.num_classes", "19", "render.n_importance", "64"]
    jparams = flatten(jax_init_params(jax_make_network(jax_load_config(None, opts)),
                                      jax.random.key(0))["params"])
    model = make_network(load_config(None, opts), "cpu")
    flat = params_to_flax(init_params(model, torch.Generator().manual_seed(0)).state_dict())
    assert set(flat) == set(jparams)
    for k, ref in jparams.items():
        ref, got = np.asarray(ref), flat[k]
        assert got.shape == ref.shape, k
        if k.endswith("bias"):
            assert not got.any() and not ref.any(), k
            continue
        std = 1.0 / np.sqrt(ref.shape[0])
        if ref.size >= 2000:
            assert abs(got.std() / std - 1) < 0.03 and abs(ref.std() / std - 1) < 0.03, k
        bound = 2.0 * std / 0.87962566103423978
        assert np.abs(got).max() <= bound * (1 + 1e-6) and np.abs(ref).max() <= bound * (1 + 1e-6), k


@pytest.mark.parametrize("n", [1, 63, 64, 100, 4096, 4097, 20000, 131072, 140001, 262144])
def test_weight_splits_cover_every_point_once(n):
    """The split-K schedule of the CUDA weight pass: every point falls in
    exactly one split, and each split's size is a multiple of the kernel's
    point step (a ring stage never reaches into the next split)."""
    splits, chunk = weight_splits(n)
    assert 1 <= splits <= MAX_SPLITS
    assert chunk % POINT_STEP == 0 and chunk >= POINT_STEP
    counts = np.zeros(n, np.int64)
    for s in range(splits):
        counts[s * chunk:min(n, (s + 1) * chunk)] += 1
    assert (counts == 1).all()


@pytest.mark.parametrize("kernel", ["trunk backward", "trunk forward"])
@pytest.mark.parametrize("err,why", [(TMA_ENCODE_FAILED, "a TMA descriptor could not be encoded"),
                                     (1, "CUDA error 1")])
def test_backward_launch_failure_names_its_cause(monkeypatch, err, why, kernel):
    """A refused launch (backward or forward) raises from the shared launch
    call, says whether a TMA descriptor or CUDA refused it (the entry
    points' own code is not a CUDA error), and counts no launch; an accepted
    one counts one. The entry point gets the current stream last."""
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: SimpleNamespace(cuda_stream=7))
    got = []
    entry = lambda *args: got.append(args) or err
    profiling.reset()
    with pytest.raises(RuntimeError) as e:
        _nvcc.launch(entry, torch.device("cpu"), 3, 5, kernel=kernel, counter="B'")
    assert str(e.value) == f"{kernel} kernel launch failed: {why}"
    assert got == [(3, 5, 7)] and profiling.calls("kernels.launch.B'") == 0
    _nvcc.launch(lambda *args: 0, torch.device("cpu"), kernel=kernel, counter="B'")
    assert profiling.calls("kernels.launch.B'") == 1
    profiling.reset()


@pytest.mark.parametrize("n", [1, 131072, 262144])
def test_forward_plan_bytes_flagship_hand_count(n):
    """Kernel B's design floor at the flagship trunk (W = 256, L = 8): per
    point 128 bytes of padded x_enc read and 8 x 256 x 2 = 4,096 bytes of
    saved activations written; the packed weights (8 x 320 x 256 bf16) and
    biases (8 x 256 f32) read once."""
    want = n * (128 + 4096) + 8 * 320 * 256 * 2 + 8 * 256 * 4
    assert forward_plan_bytes(n, 256, 8) == want
    # the backward reads back exactly the activations B saved, bar the last
    data, weight = backward_plan_bytes(n, 256, 8, (5,))
    assert weight - n * (2 * 8 * 256 + 2 * 64 * 2) == n * 7 * 256 * 2
