"""The whole NeRF field for the training step: the plain versions of
kernels C / C', the packing, and the autograd Functions of the two
whole-field training modes.

Port of `panopticnerf_tpu/ops/pallas_field_train.py`. The field is the
L-layer ReLU trunk plus every head: one head block [sem_hidden | sigma |
feature] on the trunk output, `sem_out`, the colour branch over
[feature | d_enc], `color_out`.

Mode "field" (`field_train_apply`, `_FieldTrain`): forward is kernel C,
backward kernel C'. The rounding placement is the TPU kernel's, not
flax's, and is part of the contract:
- the trunk as in `ops/mlp_train.py` (f32 products and bias, ReLU in f32,
  an activation rounded to the compute dtype only as the next input);
- ho = h @ W_head (f32 accumulation) + b_head (f32); sigma is ho's f32
  column, never rounded; s = relu(ho_sem) in f32, rounded only as
  `sem_out`'s input; sem = the f32 product + the f32 bias;
- the colour input [round(feature) | d_enc] is one product with
  K = W + d, + the f32 bias, ReLU in f32, rounded as `color_out`'s input;
  the rgb logits are f32 (the sigmoid is the caller's, in f32);
- backward: every upstream g is rounded to the compute dtype before both
  of its products, db sums the f32 g; the ReLU masks come from the saved
  (rounded) activations; dW is rounded to the compute dtype before it
  reaches the f32 parameters, db stays f32.
Mode "hybrid" (`field_hybrid_apply`, `_FieldHybrid`): the forward is plain
PyTorch GEMMs with flax's placement (every product rounded, then the
bias added in the compute dtype; the colour branch one product over
cat([feature, d_enc])), the sigmoid on the f32 logits; the backward is
kernel C' on the packed weights, with its activations and masks
recomputed in the kernel's placement (not the forward's tensors), and dW
left in float32.

Packed layout (the port's own; the TPU kernel padded every block to 128
lanes): the trunk as `ops/mlp_train.py` (x_enc padded to F_PAD = 64); d_enc
padded to D_PAD = 32; head block (W, HO) with columns [sem_hidden (SH) |
sigma | zeros up to SA = round_up(SH + 1, 32) | feature (W)], HO = SA + W
(a hybrid field's head block has W + grid_dim rows: those of h, then those
of the hash grid's features; only kernel E reads it);
`sem_out` (SH, CP), CP = round_up(classes, 32); colour hidden (W + D_PAD,
CWP), CWP = round_up(color_width, 32); `color_out` (CWP, CO_PAD = 32).
Widths are multiples of 32, the CUDA kernels' column granularity (four
column warps x one m16n8 tile). Biases are float32 vectors of the padded
widths.

Dispatch: CUDA tensors launch kernels C / C' of `csrc/field_train.cu`
(`ops/field_train_cuda.py`), CPU tensors run `field_forward_plain` /
`field_backward_plain`, any other device raises. The TPU path's `lax.map`
chunking of large point counts is not ported (it worked around a TPU
compiler limit): at the fine level (N = 262,144) JAX's `field` mode sums
two segments' bf16-rounded dW, the port sums all points once and rounds
once.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch
from torch.nn import functional as F

from panopticnerf_tpu_torch.ops._nvcc import check
from panopticnerf_tpu_torch.ops.mlp_train import (
    F_PAD,
    MAX_LAYERS,
    WIDTHS,
    pack_trunk,
    trunk_backward_plain,
    trunk_forward_plain,
    unpack_trunk_grad,
)

D_PAD = 32
CO_PAD = 32
HEAD_MAX = 128  # largest padded class count / colour width the CUDA kernels take


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


@dataclasses.dataclass(frozen=True)
class FieldDims:
    """Static shape of one field level; `skips` in the kernel convention
    (a layer index in `skips` consumes [h, x_enc])."""

    x_dim: int
    d_dim: int
    width: int
    sem_hidden: int
    color_width: int
    num_classes: int
    layers: int
    skips: tuple
    use_sem: bool
    grid_dim: int = 0  # hash grid features the heads read after h (E only; C / C' take none)

    def __post_init__(self):
        if self.x_dim > F_PAD or self.d_dim > D_PAD:
            raise ValueError(f"x_enc / d_enc widths {self.x_dim} / {self.d_dim} exceed "
                             f"{F_PAD} / {D_PAD}")
        if 0 in self.skips:
            raise ValueError("layer 0 cannot be a skip layer (it reads x_enc only)")

    @property
    def sa(self) -> int:
        """Columns of the [sem_hidden | sigma | 0...] part of the head block."""
        return _round_up(self.sem_hidden + 1, 32)

    @property
    def ho(self) -> int:
        return self.sa + self.width

    @property
    def cp(self) -> int:
        return _round_up(self.num_classes, 32)

    @property
    def cwp(self) -> int:
        return _round_up(self.color_width, 32)

    def leaves(self) -> list:
        """Names of the NeRFMLP submodules the field reads, in the order
        the autograd Functions take their (weight, bias) pairs."""
        names = [f"trunk_{i}" for i in range(self.layers)]
        if self.use_sem:
            names += ["sem_hidden", "sem_out"]
        return names + ["feature", "sigma", "color_hidden", "color_out"]


class FieldPacked(NamedTuple):
    """Packed weights (compute dtype) and biases (float32); the gradients
    of C' come back in the same form. wso / bso are None without the
    semantic head."""

    wp: torch.Tensor    # (L, W + F_PAD, W)
    bp: torch.Tensor    # (L, W)
    hw: torch.Tensor    # (W + grid_dim, HO)
    hb: torch.Tensor    # (HO,)
    wso: Optional[torch.Tensor]  # (SH, CP)
    bso: Optional[torch.Tensor]  # (CP,)
    wch: torch.Tensor   # (W + D_PAD, CWP)
    bch: torch.Tensor   # (CWP,)
    wco: torch.Tensor   # (CWP, CO_PAD)
    bco: torch.Tensor   # (CO_PAD,)


class FieldSaved(NamedTuple):
    """What kernel C keeps for C' (compute dtype): every trunk activation,
    s = relu(ho_sem) (None without the semantic head), round(feature),
    r = relu(colour hidden)."""

    acts: torch.Tensor  # (L, N, W)
    s: Optional[torch.Tensor]  # (N, SH)
    feat: torch.Tensor  # (N, W)
    r: torch.Tensor     # (N, CWP)


def check_packed(pk: FieldPacked, dims: FieldDims, dev: torch.device) -> None:
    """Checks packed weights against `dims` and the field kernels' limits
    (C, C' and the evaluation field E)."""
    w = dims.width
    if w not in WIDTHS:
        raise ValueError(f"field width {w} not in {WIDTHS}")
    if dims.sem_hidden != w // 2:
        raise ValueError(f"sem_hidden {dims.sem_hidden} != width / 2 = {w // 2}")
    if dims.cwp > HEAD_MAX or dims.cp > HEAD_MAX:
        raise ValueError(f"colour width {dims.color_width} / classes {dims.num_classes} "
                         f"exceed {HEAD_MAX}")
    if not 1 <= dims.layers <= MAX_LAYERS:
        raise ValueError(f"{dims.layers} layers outside [1, {MAX_LAYERS}]")
    bf, f32 = torch.bfloat16, torch.float32
    check("trunk weights", pk.wp, bf, (dims.layers, w + F_PAD, w), dev)
    check("trunk biases", pk.bp, f32, (dims.layers, w), dev)
    check("head weights", pk.hw, bf, (w + dims.grid_dim, dims.ho), dev)
    check("head biases", pk.hb, f32, (dims.ho,), dev)
    if dims.use_sem:
        check("sem_out weights", pk.wso, bf, (dims.sem_hidden, dims.cp), dev)
        check("sem_out biases", pk.bso, f32, (dims.cp,), dev)
    check("colour weights", pk.wch, bf, (w + D_PAD, dims.cwp), dev)
    check("colour biases", pk.bch, f32, (dims.cwp,), dev)
    check("color_out weights", pk.wco, bf, (dims.cwp, CO_PAD), dev)
    check("color_out biases", pk.bco, f32, (CO_PAD,), dev)


def _params_by_name(params, dims: FieldDims) -> dict:
    names = dims.leaves()
    return {name: (params[2 * i], params[2 * i + 1]) for i, name in enumerate(names)}


@torch.no_grad()
def pack_field(params, dims: FieldDims, dtype: torch.dtype) -> FieldPacked:
    """(weight (out, in), bias) pairs in `dims.leaves()` order -> FieldPacked.
    Not differentiable: the Functions' backward unpacks the gradient."""
    p = _params_by_name(params, dims)
    w, sh, sa = dims.width, dims.sem_hidden, dims.sa
    dev = params[0].device
    z = lambda *shape, dt=dtype: torch.zeros(shape, dtype=dt, device=dev)
    layers = [p[f"trunk_{i}"] for i in range(dims.layers)]
    wp, bp = pack_trunk([lw.t() for lw, _ in layers], [lb for _, lb in layers],
                        dims.skips, dtype)
    hw, hb = z(w + dims.grid_dim, dims.ho), z(dims.ho, dt=torch.float32)
    wso = bso = None
    if dims.use_sem:
        hw[:, :sh] = p["sem_hidden"][0].t()
        hb[:sh] = p["sem_hidden"][1]
        wso, bso = z(sh, dims.cp), z(dims.cp, dt=torch.float32)
        wso[:, :dims.num_classes] = p["sem_out"][0].t()
        bso[:dims.num_classes] = p["sem_out"][1]
    hw[:, sh] = p["sigma"][0][0]
    hb[sh] = p["sigma"][1][0]
    hw[:, sa:] = p["feature"][0].t()
    hb[sa:] = p["feature"][1]
    ch_w, ch_b = p["color_hidden"]
    extra = ch_w.shape[1] - w          # the viewdir rows, when the model has them
    if extra > D_PAD:
        raise ValueError(f"color_hidden reads {extra} viewdir columns > {D_PAD}")
    wch, bch = z(w + D_PAD, dims.cwp), z(dims.cwp, dt=torch.float32)
    wch[:w + extra, :dims.color_width] = ch_w.t()
    bch[:dims.color_width] = ch_b
    wco, bco = z(dims.cwp, CO_PAD), z(CO_PAD, dt=torch.float32)
    wco[:dims.color_width, :3] = p["color_out"][0].t()
    bco[:3] = p["color_out"][1]
    return FieldPacked(wp, bp, hw, hb, wso, bso, wch, bch, wco, bco)


def unpack_field_grads(d: FieldPacked, dims: FieldDims, params) -> list:
    """Exact transpose of `pack_field`: packed dW / db -> one gradient per
    parameter of `params` (same order and shapes)."""
    w, sh, sa = dims.width, dims.sem_hidden, dims.sa
    p = _params_by_name(params, dims)
    g = {}
    for i, k in enumerate(unpack_trunk_grad(d.wp, dims.skips, dims.x_dim)):
        g[f"trunk_{i}"] = (k.t(), d.bp[i])
    if dims.use_sem:
        g["sem_hidden"] = (d.hw[:, :sh].t(), d.hb[:sh])
        g["sem_out"] = (d.wso[:, :dims.num_classes].t(), d.bso[:dims.num_classes])
    g["feature"] = (d.hw[:, sa:].t(), d.hb[sa:])
    g["sigma"] = (d.hw[:, sh:sh + 1].t(), d.hb[sh:sh + 1])
    rows = p["color_hidden"][0].shape[1]
    g["color_hidden"] = (d.wch[:rows, :dims.color_width].t(), d.bch[:dims.color_width])
    g["color_out"] = (d.wco[:dims.color_width, :3].t(), d.bco[:3])
    return [t for name in dims.leaves() for t in g[name]]


def pad_cols(t: Optional[torch.Tensor], cols: int, n: int, like: torch.Tensor) -> torch.Tensor:
    """(N, c) -> (N, cols) with zero columns appended; None -> zeros."""
    if t is None:
        return like.new_zeros((n, cols))
    return F.pad(t, (0, cols - t.shape[1])).contiguous()


def field_forward_plain(xp: torch.Tensor, dp: torch.Tensor, pk: FieldPacked,
                        dims: FieldDims):
    """Plain version of kernel C: xp (N, F_PAD), dp (N, D_PAD) compute dtype
    -> (out (N, 4) f32 = [sigma | rgb logits], sem (N, C) f32 or None,
    FieldSaved)."""
    cdt = xp.dtype
    sh, sa = dims.sem_hidden, dims.sa
    acts = trunk_forward_plain(xp, pk.wp, pk.bp, dims.skips)
    ho = acts[-1].float() @ pk.hw.float() + pk.hb
    s = sem = None
    if dims.use_sem:
        s = torch.relu(ho[:, :sh]).to(cdt)
        sem = (s.float() @ pk.wso.float() + pk.bso)[:, :dims.num_classes]
    feat = ho[:, sa:].to(cdt)
    inp_ch = torch.cat([feat, dp], dim=1)
    r = torch.relu(inp_ch.float() @ pk.wch.float() + pk.bch).to(cdt)
    rgb = r.float() @ pk.wco.float() + pk.bco
    out = torch.cat([ho[:, sh:sh + 1], rgb[:, :3]], dim=1)
    return out, sem, FieldSaved(acts, s, feat, r)


def field_backward_plain(xp: torch.Tensor, dp: torch.Tensor, g_out: torch.Tensor,
                         g_sem: Optional[torch.Tensor], pk: FieldPacked, dims: FieldDims,
                         saved: FieldSaved, dw_dtype: torch.dtype = torch.float32):
    """Plain version of kernel C', op for op like the TPU kernel's
    `_field_bwd_kernel`: (xp, dp, g_out (N, 4) f32 [g_sigma | g_rgb logits],
    g_sem (N, C) f32 or None, packed weights, the forward's FieldSaved) ->
    (dx (N, F_PAD), dd (N, D_PAD) in the compute dtype, FieldPacked of
    gradients: dW in `dw_dtype`, db float32)."""
    cdt = xp.dtype
    rnd = lambda t: t.to(cdt).float()
    n = xp.shape[0]
    w, sh, sa = dims.width, dims.sem_hidden, dims.sa
    acts, s, feat, r = saved
    g_out = g_out.float()

    g_co = g_out.new_zeros((n, CO_PAD))
    g_co[:, :3] = g_out[:, 1:4]
    g_co_c = rnd(g_co)
    dwco, dbco = r.float().T @ g_co_c, g_co.sum(0)
    g_r = (g_co_c @ pk.wco.float().T) * (r > 0).float()
    g_r_c = rnd(g_r)
    inp_ch = torch.cat([feat, dp], dim=1).float()
    dwch, dbch = inp_ch.T @ g_r_c, g_r.sum(0)
    g_inp = g_r_c @ pk.wch.float().T

    g_ho = g_out.new_zeros((n, dims.ho))
    g_ho[:, sa:] = g_inp[:, :w]
    g_ho[:, sh] = g_out[:, 0]
    dwso = dbso = None
    if dims.use_sem:
        g_sp = g_out.new_zeros((n, dims.cp))
        g_sp[:, :dims.num_classes] = g_sem.float()
        g_sp_c = rnd(g_sp)
        dwso, dbso = s.float().T @ g_sp_c, g_sp.sum(0)
        g_ho[:, :sh] = (g_sp_c @ pk.wso.float().T) * (s > 0).float()
    g_ho_c = rnd(g_ho)
    dhw, dhb = acts[-1].float().T @ g_ho_c, g_ho.sum(0)
    g = g_ho_c @ pk.hw.float().T
    dx, dwp, dbp = trunk_backward_plain(xp, acts, g, pk.wp, dims.skips, dw_dtype=dw_dtype)
    to = lambda t: None if t is None else t.to(dw_dtype)
    grads = FieldPacked(dwp, dbp, to(dhw), dhb, to(dwso), dbso, to(dwch), dbch, to(dwco), dbco)
    return dx, g_inp[:, w:].to(cdt), grads


def _forward(xp, dp, pk, dims):
    if xp.device.type == "cuda":
        from panopticnerf_tpu_torch.ops.field_train_cuda import field_forward_cuda

        return field_forward_cuda(xp, dp, pk, dims)
    if xp.device.type == "cpu":
        return field_forward_plain(xp, dp, pk, dims)
    raise ValueError(f"fused field: no implementation for device {xp.device}")


def _backward(xp, dp, g_out, g_sem, pk, dims, saved, dw_dtype):
    """C' with the forward's FieldSaved, or with saved None: C' recomputes
    the forward in the kernel's placement first (the TPU kernel's
    recompute; on the card a pass of C' itself)."""
    if xp.device.type == "cuda":
        from panopticnerf_tpu_torch.ops.field_train_cuda import field_backward_cuda

        return field_backward_cuda(xp, dp, g_out, g_sem, pk, dims, saved, dw_dtype)
    if xp.device.type == "cpu":
        if saved is None:
            saved = field_forward_plain(xp, dp, pk, dims)[2]
        return field_backward_plain(xp, dp, g_out, g_sem, pk, dims, saved, dw_dtype)
    raise ValueError(f"fused field: no implementation for device {xp.device}")


def _upstream(dims: FieldDims, g_sigma, g_rgb, g_sem):
    g_out = torch.cat([g_sigma.float()[:, None], g_rgb.float()], dim=1).contiguous()
    g_sem = g_sem.float().contiguous() if dims.use_sem else None
    return g_out, g_sem


def _input_grads(ctx, dx, dd):
    d_grad = None
    if ctx.d_dim:
        d_grad = dd[:, :ctx.d_dim].to(ctx.d_dtype)
    return dx[:, :ctx.x_dim].to(ctx.x_dtype), d_grad


class _FieldTrain(torch.autograd.Function):
    """Mode "field": forward kernel C, saving its activations; backward
    kernel C' on them, dW rounded to the compute dtype."""

    @staticmethod
    def forward(ctx, x_enc, d_enc, dims, *params):
        cdt = x_enc.dtype
        n = x_enc.shape[0]
        pk = pack_field(params, dims, cdt)
        xp = pad_cols(x_enc.detach(), F_PAD, n, x_enc)
        dp = pad_cols(None if d_enc is None else d_enc.detach().to(cdt), D_PAD, n, x_enc)
        out, sem, saved = _forward(xp, dp, pk, dims)
        ctx.dims, ctx.pk, ctx.saved, ctx.xp, ctx.dp = dims, pk, saved, xp, dp
        ctx.params = params
        ctx.x_dim, ctx.x_dtype = x_enc.shape[1], x_enc.dtype
        ctx.d_dim = 0 if d_enc is None else d_enc.shape[1]
        ctx.d_dtype = None if d_enc is None else d_enc.dtype
        if sem is None:
            sem = out.new_zeros((n, 0))
        return out[:, 0], out[:, 1:4], sem

    @staticmethod
    def backward(ctx, g_sigma, g_rgb, g_sem):
        g_out, g_sem = _upstream(ctx.dims, g_sigma, g_rgb, g_sem)
        dx, dd, dpk = _backward(ctx.xp, ctx.dp, g_out, g_sem, ctx.pk, ctx.dims, ctx.saved,
                                ctx.xp.dtype)
        grads = unpack_field_grads(dpk, ctx.dims, ctx.params)
        grads = [gr.to(p.dtype) for gr, p in zip(grads, ctx.params)]
        return (*_input_grads(ctx, dx, dd), None, *grads)


def hybrid_forward_plain(x_enc: torch.Tensor, d_enc: Optional[torch.Tensor], params,
                         dims: FieldDims):
    """The hybrid mode's forward (port of `_jnp_field_forward`): flax's
    placement, every product rounded to the compute dtype, then the bias
    added in it. -> (sigma (N,), rgb logits (N, 3), sem (N, C) | None), f32."""
    dt = x_enc.dtype
    p = _params_by_name(params, dims)
    dense = lambda v, name: F.linear(v, p[name][0].to(dt)) + p[name][1].to(dt)
    h = x_enc
    for i in range(dims.layers):
        inp = torch.cat([h, x_enc], dim=1) if i in dims.skips else h
        h = torch.relu(dense(inp, f"trunk_{i}"))
    sigma = dense(h, "sigma")[:, 0].float()
    sem = None
    if dims.use_sem:
        sem = dense(torch.relu(dense(h, "sem_hidden")), "sem_out").float()
    feat = dense(h, "feature")
    if d_enc is not None and dims.d_dim:
        feat = torch.cat([feat, d_enc.to(dt)], dim=1)
    r = torch.relu(dense(feat, "color_hidden"))
    return sigma, dense(r, "color_out").float(), sem


class _FieldHybrid(torch.autograd.Function):
    """Mode "hybrid": forward `hybrid_forward_plain`; backward kernel C',
    which recomputes the activations in the kernel's placement; dW stays
    float32."""

    @staticmethod
    def forward(ctx, x_enc, d_enc, dims, *params):
        sigma, rgb, sem = hybrid_forward_plain(x_enc, d_enc, params, dims)
        ctx.dims, ctx.params = dims, params
        ctx.x_enc, ctx.d_enc = x_enc.detach(), None if d_enc is None else d_enc.detach()
        ctx.x_dim, ctx.x_dtype = x_enc.shape[1], x_enc.dtype
        ctx.d_dim = 0 if d_enc is None else d_enc.shape[1]
        ctx.d_dtype = None if d_enc is None else d_enc.dtype
        if sem is None:
            sem = sigma.new_zeros((x_enc.shape[0], 0))
        return sigma, rgb, sem

    @staticmethod
    def backward(ctx, g_sigma, g_rgb, g_sem):
        x_enc, d_enc, dims = ctx.x_enc, ctx.d_enc, ctx.dims
        cdt, n = x_enc.dtype, x_enc.shape[0]
        pk = pack_field(ctx.params, dims, cdt)
        xp = pad_cols(x_enc, F_PAD, n, x_enc)
        dp = pad_cols(None if d_enc is None else d_enc.to(cdt), D_PAD, n, x_enc)
        g_out, g_sem = _upstream(dims, g_sigma, g_rgb, g_sem)
        dx, dd, dpk = _backward(xp, dp, g_out, g_sem, pk, dims, None, torch.float32)
        grads = unpack_field_grads(dpk, dims, ctx.params)
        grads = [gr.to(p.dtype) for gr, p in zip(grads, ctx.params)]
        return (*_input_grads(ctx, dx, dd), None, *grads)


def _leaf_params(net: torch.nn.Module, dims: FieldDims) -> list:
    return [t for name in dims.leaves()
            for t in (getattr(net, name).weight, getattr(net, name).bias)]


def _apply(fn, net, dims: FieldDims, x_enc, d_enc):
    if d_enc is not None and d_enc.shape[1] != dims.d_dim:
        raise ValueError(f"d_enc has {d_enc.shape[1]} columns, dims say {dims.d_dim}")
    sigma, rgb_logits, sem = fn.apply(x_enc, d_enc, dims, *_leaf_params(net, dims))
    return sigma, torch.sigmoid(rgb_logits), (sem if dims.use_sem else None)


def field_train_apply(net: torch.nn.Module, dims: FieldDims, x_enc: torch.Tensor,
                      d_enc: Optional[torch.Tensor]):
    """Mode "field" on one NeRFMLP's parameters: x_enc (N, x_dim), d_enc
    (N, d_dim) or None, both in the compute dtype -> (sigma (N,), rgb (N, 3)
    after the sigmoid, sem_logits (N, C) | None), float32. Port of
    `fused_field_apply`."""
    return _apply(_FieldTrain, net, dims, x_enc, d_enc)


def field_hybrid_apply(net: torch.nn.Module, dims: FieldDims, x_enc: torch.Tensor,
                       d_enc: Optional[torch.Tensor]):
    """Mode "hybrid"; same contract as `field_train_apply`. Port of
    `hybrid_field_apply`."""
    return _apply(_FieldHybrid, net, dims, x_enc, d_enc)
