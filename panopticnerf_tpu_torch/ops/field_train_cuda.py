"""Wrappers of the CUDA whole-field kernels (`csrc/field_train.cu`).

- `field_forward_cuda` (kernel C) replaces the forward of `field_train`,
  `panopticnerf_tpu/ops/pallas_field_train.py` (`_field_fwd_impl`);
- `field_backward_cuda` (kernel C') replaces its backward
  (`_field_bwd_impl`), which is also `field_hybrid`'s backward.
Same contracts as `ops.field_train.field_forward_plain` /
`field_backward_plain`, their plain versions, on the packed layout of
`ops.field_train`. The kernels take bf16 activations and weights, W in
{64, 128, 256} with sem_hidden = W / 2, colour width and class count up to
128, x_enc padded to 64 and d_enc to 32 columns, up to 32 layers (the
limits of `ops.field_train.check_packed`); anything else raises. They
launch through `ops/_nvcc.py`; counters `kernels.launch.C` and
`kernels.launch.C'` (C' is one launch of the multi-pass backward, its
recompute included).
"""

from __future__ import annotations

from typing import Optional

import torch

from panopticnerf_tpu_torch.ops import _nvcc
from panopticnerf_tpu_torch.ops._nvcc import P, I, U, check, ptr
from panopticnerf_tpu_torch.ops.field_train import (
    CO_PAD,
    D_PAD,
    FieldDims,
    FieldPacked,
    FieldSaved,
    check_packed,
)
from panopticnerf_tpu_torch.ops.mlp_train import BM, F_PAD, skip_mask, weight_splits

SIGNATURES = {"field_fwd_launch": [P] * 18 + [I, I, I, U, I, I, I, I, P],
              "field_bwd_launch": [P] * 33 + [I, I, I, U] + [I] * 7 + [P]}


def load():
    """Build (first call only) and load the kernel library."""
    return _nvcc.load("field_train", SIGNATURES)


def forward_plan_bytes(n: int, dims: FieldDims) -> int:
    """Bytes of device memory kernel C moves for n points, each read or
    written once: x_enc and d_enc (padded) read; sigma and the rgb logits
    (f32), sem (f32, with the semantic head) written; what C' reads back
    written: every trunk activation, s (with the semantic head),
    bf16(feature) and r; the packed weights and biases read. Over HBM's
    rate, the design's floor beside the function's operations bound."""
    w, sh, cwp = dims.width, dims.sem_hidden, dims.cwp
    sem = (2 * sh + 4 * dims.num_classes) if dims.use_sem else 0
    point = 2 * (F_PAD + D_PAD) + 4 * 4 + 2 * (dims.layers * w + w + cwp) + sem
    weights = (dims.layers * (2 * (w + F_PAD) * w + 4 * w) + (2 * w + 4) * dims.ho
               + (2 * (w + D_PAD) + 4) * cwp + (2 * cwp + 4) * CO_PAD
               + ((2 * sh + 4) * dims.cp if dims.use_sem else 0))
    return n * point + weights


def heads_data_plan_bytes(n: int, dims: FieldDims) -> int:
    """Bytes of device memory the heads' data pass of C' moves for n
    points, each read or written once: the upstream g_out and g_sem (f32),
    the saved s and r read; the trunk's f32 upstream g, the bf16 g of
    each head product (color_out, colour hidden, sem_out, the head block)
    and dd written."""
    sem = (4 * dims.num_classes + 2 * dims.sem_hidden + 2 * dims.cp) if dims.use_sem else 0
    return n * (4 * 4 + 2 * dims.cwp + 4 * dims.width + 2 * (CO_PAD + dims.cwp + dims.ho + D_PAD)
                + sem)


def heads_weight_plan_bytes(n: int, dims: FieldDims) -> int:
    """Bytes of device memory the head blocks' weight pass of C' moves for
    n points, each read once: h, s (with the semantic head), bf16(feature),
    d_enc, r and the bf16 g of each head product."""
    sem = (dims.sem_hidden + dims.cp) * 2 if dims.use_sem else 0
    return n * (2 * (2 * dims.width + D_PAD + 2 * dims.cwp + dims.ho + CO_PAD) + sem)


def heads_partials(n: int, dims: FieldDims) -> tuple:
    """(rows, columns) of the db partials of C''s heads data pass for n
    points: one row per block and consumer warpgroup (the kernel runs
    min(SMs, tiles) blocks of two, so 2 per 128-point tile always suffice),
    each row the head block's HO columns, then sem_out's CP, the colour
    hidden layer's CWP and color_out's CO_PAD, summed in order by the
    reduction."""
    return 2 * -(-n // BM), dims.ho + dims.cp + dims.cwp + CO_PAD


def _validate(xp: torch.Tensor, dp: torch.Tensor, pk: FieldPacked, dims: FieldDims) -> int:
    """Checks the inputs and the packed weights against `dims`; -> n."""
    if xp.device.type != "cuda":
        raise ValueError(f"the field kernels need CUDA tensors, got {xp.device}")
    n = xp.shape[0]
    if n < 1:
        raise ValueError("no points")
    if dims.grid_dim:
        raise ValueError("kernels C / C' take no hash grid features")
    check_packed(pk, dims, xp.device)
    check("x", xp, torch.bfloat16, (n, F_PAD), xp.device)
    check("d", dp, torch.bfloat16, (n, D_PAD), xp.device)
    return n


def _launch_forward(lib, xp, dp, pk: FieldPacked, dims: FieldDims, n: int, counter):
    dev, bf = xp.device, torch.bfloat16
    w = dims.width
    out = torch.empty((n, 4), dtype=torch.float32, device=dev)
    sem = (torch.empty((n, dims.num_classes), dtype=torch.float32, device=dev)
           if dims.use_sem else None)
    saved = FieldSaved(
        acts=torch.empty((dims.layers, n, w), dtype=bf, device=dev),
        s=torch.empty((n, dims.sem_hidden), dtype=bf, device=dev) if dims.use_sem else None,
        feat=torch.empty((n, w), dtype=bf, device=dev),
        r=torch.empty((n, dims.cwp), dtype=bf, device=dev))
    _nvcc.launch(
        lib.field_fwd_launch, dev,
        xp.data_ptr(), dp.data_ptr(), pk.wp.data_ptr(), pk.bp.data_ptr(),
        pk.hw.data_ptr(), pk.hb.data_ptr(), ptr(pk.wso), ptr(pk.bso), pk.wch.data_ptr(),
        pk.bch.data_ptr(), pk.wco.data_ptr(), pk.bco.data_ptr(), out.data_ptr(), ptr(sem),
        saved.acts.data_ptr(), ptr(saved.s), saved.feat.data_ptr(), saved.r.data_ptr(),
        n, w, dims.layers, skip_mask(dims.skips, dims.layers), dims.num_classes, dims.cwp,
        dims.cp, int(dims.use_sem), kernel="field forward", counter=counter)
    return out, sem, saved


def field_forward_cuda(xp: torch.Tensor, dp: torch.Tensor, pk: FieldPacked, dims: FieldDims):
    """Kernel C: xp (N, 64), dp (N, 32) bf16, packed weights -> (out (N, 4)
    f32 = [sigma | rgb logits], sem (N, C) f32 or None, FieldSaved)."""
    n = _validate(xp, dp, pk, dims)
    return _launch_forward(load(), xp, dp, pk, dims, n, "C")


def field_backward_cuda(xp: torch.Tensor, dp: torch.Tensor, g_out: torch.Tensor,
                        g_sem: Optional[torch.Tensor], pk: FieldPacked, dims: FieldDims,
                        saved: Optional[FieldSaved] = None,
                        dw_dtype: torch.dtype = torch.bfloat16):
    """Kernel C': (xp, dp, g_out (N, 4) f32, g_sem (N, C) f32 or None,
    packed weights, kernel C's FieldSaved or None) -> (dx (N, 64) bf16,
    dd (N, 32) bf16, FieldPacked of gradients: dW in `dw_dtype` (bf16 or
    float32), db float32). With `saved` None it first runs C's forward to
    recompute the activations."""
    n = _validate(xp, dp, pk, dims)
    dev, bf, f32 = xp.device, torch.bfloat16, torch.float32
    w, layers = dims.width, dims.layers
    mask = skip_mask(dims.skips, layers)
    if dw_dtype not in (bf, f32):
        raise TypeError(f"dW dtype {dw_dtype} is neither bfloat16 nor float32")
    check("g_out", g_out, f32, (n, 4), dev)
    if dims.use_sem:
        check("g_sem", g_sem, f32, (n, dims.num_classes), dev)
    lib = load()
    if saved is None:  # the recompute is a pass of C' (module docstring), not a launch of C
        saved = _launch_forward(lib, xp, dp, pk, dims, n, None)[2]
    check("acts", saved.acts, bf, (layers, n, w), dev)
    if dims.use_sem:
        check("s", saved.s, bf, (n, dims.sem_hidden), dev)
    check("feat", saved.feat, bf, (n, w), dev)
    check("r", saved.r, bf, (n, dims.cwp), dev)

    splits, chunk = weight_splits(n)
    blocks = -(-n // BM)
    ho, cp, cwp, sh = dims.ho, dims.cp, dims.cwp, dims.sem_hidden
    parts, hb_len = heads_partials(n, dims)
    pad64 = lambda m: -(-m // 64) * 64
    # the head blocks' split-K partials, one after another (64-row slices)
    part_len = splits * (w * ho + pad64(sh) * cp + (w + 64) * cwp + pad64(cwp) * CO_PAD)
    e = lambda *shape, dt=f32: torch.empty(shape, dtype=dt, device=dev)
    g_h = e(n, w)
    gbuf, gb_co, gb_r = e(layers, n, w, dt=bf), e(n, CO_PAD, dt=bf), e(n, cwp, dt=bf)
    gb_sem = e(n, cp, dt=bf) if dims.use_sem else None
    gb_ho = e(n, ho, dt=bf)
    db_part_t, db_part_h, gx_part = e(2 * blocks, layers, w), e(parts, hb_len), e(n, F_PAD)
    dw_part_t, part = e(splits, layers, w + F_PAD, w), e(part_len)
    dx, dd = e(n, F_PAD, dt=bf), e(n, D_PAD, dt=bf)
    dwp, dbp = e(layers, w + F_PAD, w, dt=dw_dtype), e(layers, w)
    dhw = e(w, ho, dt=dw_dtype)
    dwso = e(sh, cp, dt=dw_dtype) if dims.use_sem else None
    dwch, dwco = e(w + D_PAD, cwp, dt=dw_dtype), e(cwp, CO_PAD, dt=dw_dtype)
    db_h = e(hb_len)
    _nvcc.launch(
        lib.field_bwd_launch, dev,
        xp.data_ptr(), dp.data_ptr(), pk.wp.data_ptr(), pk.hw.data_ptr(), ptr(pk.wso),
        pk.wch.data_ptr(), pk.wco.data_ptr(), saved.acts.data_ptr(), ptr(saved.s),
        saved.feat.data_ptr(), saved.r.data_ptr(), g_out.data_ptr(), ptr(g_sem),
        g_h.data_ptr(), gbuf.data_ptr(), gb_co.data_ptr(), gb_r.data_ptr(), ptr(gb_sem),
        gb_ho.data_ptr(), db_part_t.data_ptr(), db_part_h.data_ptr(), gx_part.data_ptr(),
        dw_part_t.data_ptr(), part.data_ptr(), dx.data_ptr(), dd.data_ptr(), dwp.data_ptr(),
        dbp.data_ptr(), dhw.data_ptr(), ptr(dwso), dwch.data_ptr(), dwco.data_ptr(),
        db_h.data_ptr(),
        n, w, layers, mask, dims.num_classes, cwp, cp, int(dims.use_sem), splits, chunk,
        int(dw_dtype == f32), kernel="field backward", counter="C'")
    dhb, dbso, dbch, dbco = torch.split(db_h, [ho, cp, cwp, CO_PAD])
    grads = FieldPacked(dwp, dbp, dhw, dhb, dwso, dbso if dims.use_sem else None, dwch, dbch,
                        dwco, dbco)
    return dx, dd, grads
