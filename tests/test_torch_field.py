"""The port's whole-field training modes (the plain versions of kernels
C / C' inside `_FieldTrain` and `_FieldHybrid`) against the JAX package's
`fused_field_apply` / `hybrid_field_apply` with the Pallas kernels in
interpret mode, plus the packing and the model-level glue. Small shapes:
widths 32-64, up to 6 layers, a few hundred points (N not a tile
multiple)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panopticnerf_tpu.config import load_config as jax_load_config
from panopticnerf_tpu.models import init_params as jax_init_params
from panopticnerf_tpu.models import make_network as jax_make_network
from panopticnerf_tpu.models.pallas_apply import pallas_field_apply
from panopticnerf_tpu.ops.pallas_field_train import FieldDims as JaxFieldDims
from panopticnerf_tpu.ops.pallas_field_train import fused_field_apply as jax_field_apply
from panopticnerf_tpu.ops.pallas_field_train import hybrid_field_apply as jax_hybrid_apply
from panopticnerf_tpu_torch.config import ModelConfig, load_config
from panopticnerf_tpu_torch.convert import flatten, params_from_flax, params_to_flax
from panopticnerf_tpu_torch.models import make_network
from panopticnerf_tpu_torch.models.fused_apply import FusedTrainAdapter
from panopticnerf_tpu_torch.models.nerf import NeRFMLP
from panopticnerf_tpu_torch.ops.field_train import (
    FieldDims,
    _leaf_params,
    field_hybrid_apply,
    field_train_apply,
    pack_field,
    unpack_field_grads,
)
from panopticnerf_tpu_torch.ops.field_train_cuda import (
    forward_plan_bytes,
    heads_data_plan_bytes,
    heads_partials,
)

X_DIM, D_DIM, CLASSES, COLOR = 63, 27, 5, 32


def _net(width, layers, flax_skips, use_sem, viewdirs, dtype, seed):
    """A NeRFMLP with seeded random weights and biases (numpy), and its
    flax parameter dict."""
    cfg = ModelConfig(trunk_depth=layers, trunk_width=width, skips=flax_skips,
                      color_width=COLOR, num_classes=CLASSES, use_semantic=use_sem,
                      use_viewdirs=viewdirs, compute_dtype=dtype)
    net = NeRFMLP(cfg)
    rng = np.random.default_rng(seed)
    flax = {}
    with torch.no_grad():
        for name, m in net.named_children():
            w = rng.normal(size=(m.in_features, m.out_features)) * np.sqrt(2.0 / m.in_features)
            b = rng.normal(size=(m.out_features,)) * 0.1
            m.weight.copy_(torch.from_numpy(w.T.astype(np.float32)))
            m.bias.copy_(torch.from_numpy(b.astype(np.float32)))
            flax[name] = {"kernel": jnp.asarray(w, jnp.float32),
                          "bias": jnp.asarray(b, jnp.float32)}
    return cfg, net, flax


def _dims(cfg, d_dim):
    skips = tuple(s + 1 for s in cfg.skips if s + 1 < cfg.trunk_depth)
    kw = dict(x_dim=X_DIM, d_dim=d_dim, width=cfg.trunk_width,
              sem_hidden=cfg.trunk_width // 2, color_width=cfg.color_width,
              num_classes=cfg.num_classes, layers=cfg.trunk_depth, skips=skips,
              use_sem=cfg.use_semantic)
    return JaxFieldDims(**kw), FieldDims(**kw)


def _run_both(mode, dtype, n, layers, width, flax_skips, use_sem, viewdirs, seed=0):
    """Outputs and gradients (params, x_enc, d_enc) of a random linear
    loss through the JAX mode and the port's, as numpy dicts."""
    cfg, net, flax = _net(width, layers, flax_skips, use_sem, viewdirs, dtype, seed)
    d_dim = D_DIM if viewdirs else 0
    jdims, dims = _dims(cfg, d_dim)
    rng = np.random.default_rng(seed + 1)
    x = rng.uniform(-1, 1, (n, X_DIM)).astype(np.float32)
    d = rng.uniform(-1, 1, (n, D_DIM)).astype(np.float32)
    rs = [rng.normal(size=s).astype(np.float32) for s in [(n,), (n, 3), (n, CLASSES)]]
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jfn = jax_field_apply if mode == "field" else jax_hybrid_apply

    def jloss(p, x_, d_):
        outs = jfn(p, jdims, x_.astype(jdt), d_.astype(jdt) if viewdirs else None,
                   tile=128, interpret=True)
        return sum(jnp.sum(o * r) for o, r in zip(outs, rs) if o is not None), outs

    (_, jouts), (jgp, jgx, jgd) = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        flax, jnp.asarray(x), jnp.asarray(d))

    tx = torch.from_numpy(x).requires_grad_()
    td = torch.from_numpy(d).requires_grad_()
    fn = field_train_apply if mode == "field" else field_hybrid_apply
    outs = fn(net, dims, tx.to(tdt), td.to(tdt) if viewdirs else None)
    sum(torch.sum(o * torch.from_numpy(r)) for o, r in zip(outs, rs) if o is not None).backward()
    want = {"sigma": jouts[0], "rgb": jouts[1], "dx": jgx}
    got = {"sigma": outs[0], "rgb": outs[1], "dx": tx.grad}
    if use_sem:
        want["sem"], got["sem"] = jouts[2], outs[2]
    else:
        assert outs[2] is None
    if viewdirs:
        want["dd"], got["dd"] = jgd, td.grad
    for name, m in net.named_children():
        want[f"{name}/kernel"] = jgp[name]["kernel"]
        want[f"{name}/bias"] = jgp[name]["bias"]
        got[f"{name}/kernel"] = m.weight.grad.t()
        got[f"{name}/bias"] = m.bias.grad
    to_np = lambda v: np.asarray(v.detach().float() if torch.is_tensor(v) else v, np.float32)
    return {k: to_np(v) for k, v in want.items()}, {k: to_np(v) for k, v in got.items()}, net


CASES = [  # dtype, n, layers, width, flax skips, use_sem, viewdirs
    ("float32", 300, 4, 32, (1,), True, True),
    ("float32", 77, 3, 32, (), False, True),
    ("float32", 130, 3, 32, (0,), True, False),
    ("bfloat16", 300, 6, 64, (4,), True, True),    # flagship-style: flax skip 4 -> kernel 5
    ("bfloat16", 129, 3, 32, (), False, False),
]


def _assert_close(want, got, dtype):
    """float32: atol 1e-4 (the CPU sums in another order). bfloat16: both
    sides round at the same places, but a sum in another order flips a
    rounding now and then: outputs to 2 % of the array's largest entry,
    each gradient to a relative Frobenius error of 3 %."""
    assert set(want) == set(got)
    for k, a in want.items():
        b = got[k]
        assert b.shape == a.shape, k
        scale = max(float(np.abs(a).max()), 1.0)
        if dtype == "float32":
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-4, err_msg=k)
        elif k in ("sigma", "rgb", "sem"):
            np.testing.assert_allclose(b, a, rtol=0, atol=0.02 * scale, err_msg=k)
        else:
            err = np.linalg.norm(b - a) / max(np.linalg.norm(a), 1e-12)
            assert err <= 0.03, (k, err)


@pytest.mark.parametrize("dtype,n,layers,width,skips,use_sem,viewdirs", CASES)
def test_field_mode_matches_jax(dtype, n, layers, width, skips, use_sem, viewdirs):
    """`_FieldTrain` (plain C forward, plain C' backward) against JAX's
    `fused_field_apply` + `jax.grad`: outputs, every parameter's gradient,
    dx_enc and dd_enc."""
    want, got, _ = _run_both("field", dtype, n, layers, width, skips, use_sem, viewdirs)
    _assert_close(want, got, dtype)


@pytest.mark.parametrize("dtype,n,layers,width,skips,use_sem,viewdirs", CASES)
def test_hybrid_mode_matches_jax(dtype, n, layers, width, skips, use_sem, viewdirs):
    """`_FieldHybrid` (flax-placement forward, plain C' backward with the
    kernel's recompute) against JAX's `hybrid_field_apply`."""
    want, got, _ = _run_both("hybrid", dtype, n, layers, width, skips, use_sem, viewdirs)
    _assert_close(want, got, dtype)


def test_bf16_mode_contracts():
    """Each mode's own rounding contract, at width 64 with 300 points:
    `field` rounds dW to bf16 (every weight gradient is a bf16 value) and
    keeps sigma in f32 (so it differs from the flax-placement model's);
    `hybrid` leaves dW in f32 and its forward is the model's (sigma and
    the semantic logits bit-equal to NeRFMLP on the same inputs)."""
    args = ("bfloat16", 300, 6, 64, (4,), True, True)
    _, field, net = _run_both("field", *args)
    _, hybrid, _ = _run_both("hybrid", *args)
    weights = [k for k in field if k.endswith("/kernel")]
    for k in weights:
        v = torch.from_numpy(field[k])
        assert torch.equal(v, v.to(torch.bfloat16).float()), k
    assert any(not torch.equal(torch.from_numpy(hybrid[k]),
                               torch.from_numpy(hybrid[k]).to(torch.bfloat16).float())
               for k in weights)
    # the same inputs through the plain model: its forward takes pts, so
    # compare on the encodings it computes itself
    rng = np.random.default_rng(5)
    pts = torch.from_numpy(rng.uniform(-1, 1, (300, 3)).astype(np.float32))
    dirs = torch.nn.functional.normalize(torch.from_numpy(
        rng.normal(size=(300, 3)).astype(np.float32)), dim=-1)
    from panopticnerf_tpu_torch.ops.encoding import positional_encoding

    x_enc = positional_encoding(pts, 10).to(torch.bfloat16)
    d_enc = positional_encoding(dirs, 4).to(torch.bfloat16)
    dims = _dims(net.cfg, D_DIM)[1]
    with torch.no_grad():
        ref = net(pts, dirs)
        f_out = field_train_apply(net, dims, x_enc, d_enc)
        h_out = field_hybrid_apply(net, dims, x_enc, d_enc)
    assert torch.equal(h_out[0], ref[0]) and torch.equal(h_out[2], ref[2])
    assert not torch.equal(f_out[0], ref[0])
    assert float((f_out[0] - ref[0]).abs().max()) < 0.05 * float(ref[0].abs().max())


@pytest.mark.parametrize("use_sem,viewdirs", [(True, True), (False, False)])
def test_pack_unpack_roundtrip(use_sem, viewdirs):
    """`unpack_field_grads` is the exact transpose of `pack_field`: packing
    the parameters and unpacking the packed blocks as if they were
    gradients gives every parameter back; the padding holds zeros."""
    cfg, net, _ = _net(64, 4, (1,), use_sem, viewdirs, "float32", 3)
    dims = _dims(cfg, D_DIM if viewdirs else 0)[1]
    params = _leaf_params(net, dims)
    pk = pack_field(params, dims, torch.float32)
    assert pk.hw.shape == (64, dims.ho) and pk.wch.shape == (64 + 32, dims.cwp)
    assert dims.ho == 32 + 32 + 64 and dims.cwp == 32 and dims.cp == 32
    for a, b in zip(unpack_field_grads(pk, dims, params), params):
        assert torch.equal(a, b.detach())
    assert not pk.hw[:, dims.sem_hidden + 1:dims.sa].any()
    assert not pk.wco[:, 3:].any() and not pk.bco[3:].any()


FIELD = ["model.trunk_depth", "6", "model.trunk_width", "64", "model.skips", "4",
         "model.color_width", "32", "model.num_classes", "5", "render.n_importance", "8",
         "model.use_pallas", "true"]


@pytest.mark.parametrize("mode,dtype,level", [("field", "float32", 1), ("field", "bfloat16", 0),
                                              ("hybrid", "float32", 0),
                                              ("hybrid", "bfloat16", 1)])
def test_fused_adapter_modes_match_pallas_field_apply(mode, dtype, level):
    """`FusedTrainAdapter(mode=...)` against `pallas_field_apply(mode=...)`
    on points and view directions, through the model-level glue (encodings,
    skips, dims): outputs and every parameter's gradient, tolerances as
    in `_assert_close`."""
    opts = FIELD + ["model.compute_dtype", dtype, "model.pallas_mode", mode]
    jcfg, cfg = jax_load_config(None, opts), load_config(None, opts)
    params = jax_init_params(jax_make_network(jcfg), jax.random.key(4))
    rng = np.random.default_rng(level + 10)
    # flax inits biases at 0: give them values so the bias paths count
    params = jax.tree.map(lambda v: v + (rng.normal(size=v.shape) * 0.1 if v.ndim == 1 else 0),
                          params)
    pts = rng.uniform(-1, 1, (24, 5, 3)).astype(np.float32)
    dirs = rng.normal(size=(24, 1, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    rs = [rng.normal(size=s).astype(np.float32) for s in [(24, 5), (24, 5, 3), (24, 5, 5)]]

    def jloss(p):
        outs = pallas_field_apply(p, jcfg.model, jnp.asarray(pts), jnp.asarray(dirs),
                                  level=level, has_fine=True, interpret=True, mode=mode)
        return sum(jnp.sum(o * r_) for o, r_ in zip(outs, rs)), outs

    (_, jouts), jgrads = jax.value_and_grad(jloss, has_aux=True)(params)
    model = make_network(cfg, "cpu")
    model.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    outs = FusedTrainAdapter(model, cfg.model, mode=mode)(
        torch.from_numpy(pts), torch.from_numpy(dirs), level=level)
    sum(torch.sum(o * torch.from_numpy(r_)) for o, r_ in zip(outs, rs)).backward()
    want = {n: np.asarray(o, np.float32) for n, o in zip(("sigma", "rgb", "sem"), jouts)}
    got = {n: o.detach().numpy() for n, o in zip(("sigma", "rgb", "sem"), outs)}
    sub = "fine" if level == 1 else "coarse"
    want.update({k: np.asarray(v) for k, v in flatten(jgrads["params"]).items()
                 if k.startswith(sub)})
    grads = params_to_flax({k: torch.zeros_like(p) if p.grad is None else p.grad
                            for k, p in model.named_parameters()})
    got.update({k: v for k, v in grads.items() if k.startswith(sub)})
    assert any(np.abs(v).max() > 0 for k, v in got.items() if "/" in k)
    _assert_close(want, got, dtype)


@pytest.mark.parametrize("use_sem", [True, False])
@pytest.mark.parametrize("n", [1, 262144])
def test_forward_plan_bytes_flagship_hand_count(n, use_sem):
    """Kernel C's design floor at the flagship field (W = 256, L = 8, 128-wide
    semantic and colour heads, 19 classes): per point x_enc / d_enc padded
    (128 + 64 bytes) read, sigma and rgb (16) and sem (76) written, and the
    5,120 bytes C' reads back written (8 trunk activations 4,096, s 256,
    feature 512, r 256); the packed weights and biases read once. C''s
    heads data pass: g_out 16, g_sem 76, s 256, r 256 read; the trunk's f32
    g 1,024 and the bf16 g of color_out 64, colour hidden 256, sem_out 64,
    the head block 832, and dd 64 written."""
    dims = FieldDims(x_dim=63, d_dim=27, width=256, sem_hidden=128, color_width=128,
                     num_classes=19, layers=8, skips=(5,), use_sem=use_sem)
    sem = 256 + 76 if use_sem else 0
    weights = (8 * (320 * 256 * 2 + 256 * 4) + 256 * 416 * 2 + 416 * 4 + 288 * 128 * 2
               + 128 * 4 + 128 * 32 * 2 + 32 * 4 + (128 * 32 * 2 + 32 * 4 if use_sem else 0))
    assert forward_plan_bytes(n, dims) == n * (128 + 64 + 16 + 4096 + 512 + 256 + sem) + weights
    if use_sem:
        assert forward_plan_bytes(n, dims) - weights == n * (284 + 5120)
    heads = 16 + 256 + 1024 + 64 + 256 + 832 + 64 + (76 + 256 + 64 if use_sem else 0)
    assert heads_data_plan_bytes(n, dims) == n * heads


@pytest.mark.parametrize("width", [64, 128, 256])
@pytest.mark.parametrize("classes", [19, 64, 70, 128])
@pytest.mark.parametrize("color_width", [27, 64, 96, 128])
def test_heads_partials_cover_every_block(width, classes, color_width):
    """The db partials of C''s heads data pass, for every width and head
    combination the kernels take: two rows per 128-point tile cover the
    min(SMs, tiles) blocks of two consumer warpgroups the kernel runs on
    any card, and a row holds [db_head | db_sem_out | db_colour | db_rgb]
    in the widths the wrapper splits it by."""
    for use_sem in (True, False):
        dims = FieldDims(x_dim=63, d_dim=27, width=width, sem_hidden=width // 2,
                         color_width=color_width, num_classes=classes, layers=8, skips=(5,),
                         use_sem=use_sem)
        for n in (1, 127, 128, 129, 131072, 262145):
            rows, cols = heads_partials(n, dims)
            tiles = -(-n // 128)
            for sms in (1, 78, 132, 10**6):
                assert rows >= 2 * min(sms, tiles)
            assert rows == 2 * tiles
            assert cols == dims.ho + dims.cp + dims.cwp + 32
