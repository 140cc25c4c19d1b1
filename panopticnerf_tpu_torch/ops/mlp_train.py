"""Fused NeRF trunk for the training step: the plain version of kernels B/B'.

Port of `panopticnerf_tpu/ops/pallas_mlp_train.py`. `fused_trunk_train`
runs the L-layer ReLU trunk as a `torch.autograd.Function` whose backward is
written out op for op like the TPU kernel's `_bwd_kernel` (it is not taken
from autograd through the forward), because the rounding placement is part
of the contract:
- matmul inputs in the compute dtype, products accumulated in float32;
- biases added in float32 (they are packed as float32), ReLU in float32;
  an activation is rounded to the compute dtype only as the next layer's
  input (and as the trunk's output);
- backward: the ReLU mask comes from the activation; the upstream gradient
  g is rounded to the compute dtype before both products (dW = inp^T g,
  g_in = g W^T); db sums the float32 g; dx is returned in the compute
  dtype; dW is rounded to the compute dtype before it reaches the float32
  parameters (the TPU kernel's `dwp.astype(wp.dtype)`).

Skip convention: a layer index in `skips` consumes [h, x_enc] (the flax
model concatenates AFTER layer s, so the kernel's skip is s + 1).

Packed layout (the port's own; the TPU kernel padded to 128 lanes): weights
(L, W + F_PAD, W) in the compute dtype — rows [0, W) multiply h, rows
[W, W + F) multiply x_enc, so layer 0 reads rows [W, W + F_PAD) and a skip
layer reads all of them; biases (L, W) float32; x_enc padded with zeros to
F_PAD = 64 columns.

Dispatch: CUDA tensors launch kernels B (forward) and B' (backward) of
`csrc/mlp_train.cu` (`ops/mlp_train_cuda.py`), CPU tensors run
`trunk_forward_plain` / `trunk_backward_plain`, any other device raises.
The TPU path's `lax.map` chunking of large point counts is not ported: it
worked around a TPU compiler limit.
"""

from __future__ import annotations

from typing import Sequence

import torch

F_PAD = 64

# The CUDA tile engine's limits on this layout (kernels B / B', and C / C' / E
# through `ops/field_train.py`)
WIDTHS = (64, 128, 256)
MAX_LAYERS = 32
SPLIT_POINTS = 4096  # points per split of the weight pass (at most MAX_SPLITS splits)
MAX_SPLITS = 32
POINT_STEP = 64      # points per ring stage of the weight pass: each split's size is a multiple
BM = 128             # points per tile of the forward / data pass


def skip_mask(skips, layers: int) -> int:
    """The kernels' bit mask of the skip layers (bit s: layer s reads [h, x_enc])."""
    if any(not 0 < s < layers for s in skips):
        raise ValueError(f"skips {skips} must lie in [1, {layers})")
    return sum(1 << s for s in skips)


def weight_splits(n: int) -> tuple:
    """(splits, chunk) of the split-K weight pass over n points: split s
    takes points [s * chunk, min(n, (s + 1) * chunk)); chunk is a multiple
    of POINT_STEP, so that no ring stage of a split reaches into the next."""
    splits = max(1, min(MAX_SPLITS, -(-n // SPLIT_POINTS)))
    per_split = -(-n // splits)
    return splits, -(-per_split // POINT_STEP) * POINT_STEP


def pack_trunk(weights: Sequence[torch.Tensor], biases: Sequence[torch.Tensor],
               skips: tuple[int, ...], dtype: torch.dtype):
    """Per-layer (in, out) weights and (out,) biases -> (wp (L, W + F_PAD, W)
    in `dtype`, bp (L, W) float32). Not differentiable (the Function's
    backward unpacks the gradient itself)."""
    width = weights[-1].shape[-1]
    f = weights[0].shape[0]
    if f > F_PAD:
        raise ValueError(f"x_enc width {f} > {F_PAD}")
    if 0 in skips:
        raise ValueError("layer 0 cannot be a skip layer (it reads x_enc only)")
    dev = weights[0].device
    wp = torch.zeros((len(weights), width + F_PAD, width), dtype=dtype, device=dev)
    bp = torch.zeros((len(weights), width), dtype=torch.float32, device=dev)
    with torch.no_grad():
        for i, (w, b) in enumerate(zip(weights, biases)):
            w = w.to(dtype)
            if i == 0:
                wp[i, width:width + f] = w
            elif i in skips:
                wp[i, :width] = w[:width]
                wp[i, width:width + f] = w[width:]
            else:
                wp[i, :width] = w
            bp[i] = b.to(torch.float32)
    return wp, bp


def unpack_trunk_grad(dwp: torch.Tensor, skips: tuple[int, ...], f: int) -> list:
    """(L, W + F_PAD, W) -> per-layer (in, out) gradients (views)."""
    width = dwp.shape[-1]
    out = []
    for i in range(dwp.shape[0]):
        if i == 0:
            out.append(dwp[i, width:width + f])
        elif i in skips:
            out.append(torch.cat([dwp[i, :width], dwp[i, width:width + f]]))
        else:
            out.append(dwp[i, :width])
    return out


def _layer_input(i: int, h_c, xp, wp, skips):
    """(input, weight rows) of layer i in the packed layout."""
    width = wp.shape[-1]
    if i == 0:
        return xp, wp[0, width:]
    if i in skips:
        return torch.cat([h_c, xp], dim=1), wp[i]
    return h_c, wp[i, :width]


def trunk_forward_plain(xp: torch.Tensor, wp: torch.Tensor, bp: torch.Tensor,
                        skips: tuple[int, ...]) -> torch.Tensor:
    """Plain version of kernel B: xp (N, F_PAD) -> every layer's activation
    (L, N, W) in the compute dtype (the last one is the trunk's output)."""
    layers, _, width = wp.shape
    acts = xp.new_empty((layers, xp.shape[0], width))
    h_c = None
    for i in range(layers):
        inp, w = _layer_input(i, h_c, xp, wp, skips)
        pre = inp.float() @ w.float() + bp[i]                # f32 products, f32 bias
        h_c = torch.relu(pre).to(xp.dtype)                   # ReLU in f32, then round
        acts[i] = h_c
    return acts


def trunk_backward_plain(xp: torch.Tensor, acts: torch.Tensor, g: torch.Tensor,
                         wp: torch.Tensor, skips: tuple[int, ...],
                         dw_dtype: torch.dtype | None = None):
    """Plain version of kernel B': (xp, the forward's acts, g (N, W) float32
    upstream gradient) -> (dx (N, F_PAD) compute dtype, dW (L, W + F_PAD, W)
    rounded to `dw_dtype` (default: the compute dtype), db (L, W) float32)."""
    layers, _, width = wp.shape
    cdt = xp.dtype
    gx = torch.zeros((xp.shape[0], F_PAD), dtype=torch.float32, device=xp.device)
    dwp = torch.zeros(wp.shape, dtype=torch.float32, device=xp.device)
    dbp = torch.zeros((layers, width), dtype=torch.float32, device=xp.device)
    g = g.float()
    for i in reversed(range(layers)):
        g = g * (acts[i] > 0).float()
        inp, w = _layer_input(i, acts[i - 1] if i else None, xp, wp, skips)
        g_c = g.to(cdt).float()                              # rounded before both products
        rows = slice(width, None) if i == 0 else slice(0, inp.shape[1])
        dwp[i, rows] = inp.float().T @ g_c
        dbp[i] = g.sum(0)
        g_inp = g_c @ w.float().T
        if i == 0:
            gx = gx + g_inp
        elif i in skips:
            gx = gx + g_inp[:, width:]
            g = g_inp[:, :width]
        else:
            g = g_inp
    return gx.to(cdt), dwp.to(dw_dtype or cdt), dbp


def _forward(xp, wp, bp, skips):
    if xp.device.type == "cuda":
        from panopticnerf_tpu_torch.ops.mlp_train_cuda import trunk_forward_cuda

        return trunk_forward_cuda(xp, wp, bp, skips)
    if xp.device.type == "cpu":
        return trunk_forward_plain(xp, wp, bp, skips)
    raise ValueError(f"fused trunk: no implementation for device {xp.device}")


def _backward(xp, acts, g, wp, skips):
    if xp.device.type == "cuda":
        from panopticnerf_tpu_torch.ops.mlp_train_cuda import trunk_backward_cuda

        return trunk_backward_cuda(xp, acts, g, wp, skips)
    if xp.device.type == "cpu":
        return trunk_backward_plain(xp, acts, g, wp, skips)
    raise ValueError(f"fused trunk: no implementation for device {xp.device}")


def pad_x(x_enc: torch.Tensor) -> torch.Tensor:
    """(N, F) -> (N, F_PAD), zero columns appended."""
    return torch.nn.functional.pad(x_enc, (0, F_PAD - x_enc.shape[1])).contiguous()


class _TrunkTrain(torch.autograd.Function):
    """Forward: kernel B (or its plain version), saving every layer's
    activation in the compute dtype for the backward (the TPU kernel
    recomputes them instead; same values). Backward: kernel B'."""

    @staticmethod
    def forward(ctx, x_enc, skips, *params):
        layers = len(params) // 2
        weights, biases = params[:layers], params[layers:]
        wp, bp = pack_trunk(weights, biases, skips, x_enc.dtype)
        xp = pad_x(x_enc.detach())
        acts = _forward(xp, wp, bp, skips)
        ctx.save_for_backward(xp, acts, wp)
        ctx.skips = skips
        ctx.f = x_enc.shape[1]
        ctx.param_dtypes = [p.dtype for p in params]
        return acts[-1].float()

    @staticmethod
    def backward(ctx, g):
        xp, acts, wp = ctx.saved_tensors
        dxp, dwp, dbp = _backward(xp, acts, g.float().contiguous(), wp, ctx.skips)
        grads = unpack_trunk_grad(dwp, ctx.skips, ctx.f) + list(dbp)
        grads = [d.to(dt) for d, dt in zip(grads, ctx.param_dtypes)]
        return (dxp[:, :ctx.f], None, *grads)


def fused_trunk_train(x_enc: torch.Tensor, weights: Sequence[torch.Tensor],
                      biases: Sequence[torch.Tensor], skips: tuple[int, ...]) -> torch.Tensor:
    """Differentiable fused trunk. x_enc (N, F) in the compute dtype;
    weights[i] (in_i, W) flax layout (float32 parameters, or views of
    them); biases[i] (W,); `skips` in the kernel's convention. Returns
    (N, W) float32 holding compute-dtype values, like the TPU version."""
    if len(weights) != len(biases) or not weights:
        raise ValueError("fused_trunk_train needs one bias per weight")
    return _TrunkTrain.apply(x_enc, tuple(skips), *weights, *biases)
