"""The evaluation field, forward only (kernel E): its plain version, the
packing and the dispatch.

E evaluates one field level of the evaluation render from the sample
points and their rays' directions: the encodings, the trunk and every head,
with flax's rounding placement, the placement of `models/nerf.py`
(`NeRFMLP.forward`): each Dense layer's product rounded to the compute
dtype, then its bias (cast down) added in it; sigma and the semantic logits
promoted to float32; rgb the sigmoid of the rounded logits, promoted. It
replaces no TPU kernel (the JAX package renders this field with plain XLA
ops); kernel C (`ops/field_train.py`) computes the same field for training
in the TPU kernel's placement, which differs, and saves activations E does
not need.

Packed layout: `ops/field_train.py`'s (`pack_field`), the biases rounded to
the compute dtype and held as float32 (`pack_eval`). `field_eval_plain`
runs the model's own ops on the packed weights (each product on the slice
that holds the model's weight, in the model's layout), so it equals
`NeRFMLP.forward` bit for bit; the kernel sums its products in another
order. Dispatch (`evaluator`): on a CUDA device E (`csrc/field_eval.cu`,
`ops/field_eval_cuda.py`), on the CPU the plain version, any other device
raises. `eval_dims` says whether E takes a field's shape: W in
{64, 128, 256}, up to 32 layers, skips before the last layer, the encodings
within 64 / 32 columns, the colour width and the class count within 128
(the kernel computes in bf16 only), with or without the hash grid.

A hybrid field (model.hash_grid) adds the hash grid: kernel G
(`ops/hash_grid_cuda.py`) writes its features g (P, 32) bf16 per tile and
level, and E reads [h, g] as the input of its sigma, sem_hidden and feature
heads (their packed block has W + 32 rows); `grid_evaluator` is G's
dispatch, as `evaluator` is E's.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.nn import functional as F

from panopticnerf_tpu_torch.config import ModelConfig
from panopticnerf_tpu_torch.ops.encoding import posenc_dim, positional_encoding
from panopticnerf_tpu_torch.ops.field_train import (
    D_PAD,
    HEAD_MAX,
    FieldDims,
    FieldPacked,
    pack_field,
)
from panopticnerf_tpu_torch.ops.hash_grid import GRID, hash_grid_encode
from panopticnerf_tpu_torch.ops.mlp_train import F_PAD, MAX_LAYERS, WIDTHS


def eval_dims(c: ModelConfig) -> Optional[FieldDims]:
    """The FieldDims of a field whose effective config is `c` (for a small
    proposal coarse, `coarse_field_cfg`'s), or None where E does not take
    its shape. Skips in the kernel convention (the layer after a flax skip
    reads [h, x_enc])."""
    x_dim = posenc_dim(3, c.xyz_freqs)
    d_dim = posenc_dim(3, c.dir_freqs) if c.use_viewdirs else 0
    if (c.trunk_width not in WIDTHS
            or not 1 <= c.trunk_depth <= MAX_LAYERS
            or any(not 0 <= s < c.trunk_depth - 1 for s in c.skips)
            or c.xyz_freqs < 0 or x_dim > F_PAD or (c.use_viewdirs and not 0 <= c.dir_freqs)
            or d_dim > D_PAD or not 1 <= c.color_width <= HEAD_MAX
            or not 1 <= c.num_classes <= HEAD_MAX):
        return None
    return FieldDims(x_dim=x_dim, d_dim=d_dim, width=c.trunk_width,
                     sem_hidden=c.trunk_width // 2, color_width=c.color_width,
                     num_classes=c.num_classes, layers=c.trunk_depth,
                     skips=tuple(sorted({s + 1 for s in c.skips})), use_sem=c.use_semantic,
                     grid_dim=GRID.dim if c.hash_grid else 0)


def freqs(dim: int) -> int:
    """Bands of an encoding of `dim` columns ([v, sin, cos per band] of a
    3-vector); -1 for none (no view directions)."""
    return (dim // 3 - 1) // 2 if dim else -1


@torch.no_grad()
def pack_eval(net: torch.nn.Module, dims: FieldDims, dtype: torch.dtype) -> FieldPacked:
    """One NeRFMLP's parameters -> FieldPacked in `dtype`, every bias
    rounded to `dtype` (as the model casts it) and held as float32."""
    params = [t for name in dims.leaves()
              for t in (getattr(net, name).weight, getattr(net, name).bias)]
    pk = pack_field(params, dims, dtype)
    rnd = lambda b: None if b is None else b.to(dtype).float()
    return pk._replace(bp=rnd(pk.bp), hb=rnd(pk.hb), bso=rnd(pk.bso), bch=rnd(pk.bch),
                       bco=rnd(pk.bco))


def field_eval_plain(pts: torch.Tensor, dirs: torch.Tensor, samples: int, pk: FieldPacked,
                     dims: FieldDims, grid: Optional[torch.Tensor] = None):
    """Plain version of kernel E: pts (R x S, 3) float32 (point p on ray
    p // S), dirs (R, 3) float32, the packed weights, with `dims.grid_dim`
    the hash grid's features `grid` (P, grid_dim) in the compute dtype ->
    (sigma (P,), rgb (P, 3), sem (P, C) | None), float32. The model's ops in
    the model's order, each product on the packed slice that holds the
    model's weight."""
    dt = pk.wp.dtype
    w, sh, sa, xd = dims.width, dims.sem_hidden, dims.sa, dims.x_dim

    def dense(v, wt, b):  # wt (in, out) packed slice -> the model's (out, in) weight
        return F.linear(v, wt.t().contiguous()) + b.to(dt)

    x_enc = positional_encoding(pts, freqs(xd)).to(dt)
    h = x_enc
    for i in range(dims.layers):
        if i == 0:
            h = dense(h, pk.wp[0, w:w + xd], pk.bp[0])
        elif i in dims.skips:
            h = dense(torch.cat([h, x_enc], dim=-1), pk.wp[i, :w + xd], pk.bp[i])
        else:
            h = dense(h, pk.wp[i, :w], pk.bp[i])
        h = torch.relu(h)
    if dims.grid_dim:
        h = torch.cat([h, grid.to(dt)], dim=-1)
    sigma = dense(h, pk.hw[:, sh:sh + 1], pk.hb[sh:sh + 1])[..., 0].float()
    sem = None
    if dims.use_sem:
        s = torch.relu(dense(h, pk.hw[:, :sh], pk.hb[:sh]))
        c = dims.num_classes
        sem = dense(s, pk.wso[:, :c], pk.bso[:c]).float()
    feat = dense(h, pk.hw[:, sa:], pk.hb[sa:])
    cw = dims.color_width
    if dims.d_dim:
        d_enc = positional_encoding(dirs, freqs(dims.d_dim)).to(dt)
        d_enc = d_enc.repeat_interleave(samples, dim=0)
        feat = torch.cat([feat, d_enc], dim=-1)
    r = torch.relu(dense(feat, pk.wch[:w + dims.d_dim, :cw], pk.bch[:cw]))
    rgb = torch.sigmoid(dense(r, pk.wco[:cw, :3], pk.bco[:3])).float()
    return sigma, rgb, sem


def evaluator(pk: FieldPacked, dims: FieldDims, device):
    """The packed field as a callable `(pts, dirs, samples, grid=None)` with
    the contract of `field_eval_plain`: kernel E bound to the weights on a
    CUDA device (`ops.field_eval_cuda.EvalKernel`, the weights checked
    once), the plain version on the CPU; any other device raises."""
    dev = torch.device(device)
    if dev.type == "cuda":
        from panopticnerf_tpu_torch.ops.field_eval_cuda import EvalKernel

        return EvalKernel(pk, dims, dev)
    if dev.type == "cpu":
        return lambda pts, dirs, samples, grid=None: field_eval_plain(pts, dirs, samples, pk,
                                                                      dims, grid)
    raise ValueError(f"evaluation field: no implementation for device {dev}")


def grid_evaluator(tables, device):
    """A field's hash grid as a callable `pts (P, 3) float32 -> (P, 32)
    bf16`: kernel G bound to the tables on a CUDA device
    (`ops.hash_grid_cuda.GridKernel`), the plain encoding rounded to bf16 on
    the CPU; any other device raises."""
    dev = torch.device(device)
    if dev.type == "cuda":
        from panopticnerf_tpu_torch.ops.hash_grid_cuda import GridKernel

        return GridKernel([t.detach() for t in tables], dev)
    if dev.type == "cpu":
        return lambda pts: hash_grid_encode(pts, tables).to(torch.bfloat16)
    raise ValueError(f"hash grid: no implementation for device {dev}")
