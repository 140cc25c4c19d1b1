"""Wrappers of the CUDA trunk kernels (`csrc/mlp_train.cu`).

- `trunk_forward_cuda` (kernel B) replaces the forward of `trunk_train`,
  `panopticnerf_tpu/ops/pallas_mlp_train.py` (`_trunk_fwd_impl`);
- `trunk_backward_cuda` (kernel B') replaces its backward
  (`_trunk_bwd_rule` -> `_bwd_kernel`).
Same contracts as `ops.mlp_train.trunk_forward_plain` /
`trunk_backward_plain`, their plain versions. The kernels take bf16
activations and weights, W in {64, 128, 256}, x_enc padded to 64 columns
and up to 32 layers (the limits in `ops.mlp_train`); anything else raises.
They launch through `ops/_nvcc.py`; counters `kernels.launch.B` and
`kernels.launch.B'` (B' is one launch of the three-pass backward).
"""

from __future__ import annotations

import torch

from panopticnerf_tpu_torch.ops import _nvcc
from panopticnerf_tpu_torch.ops._nvcc import P, I, U, check
from panopticnerf_tpu_torch.ops.mlp_train import (
    BM,
    F_PAD,
    MAX_LAYERS,
    WIDTHS,
    skip_mask,
    weight_splits,
)

SIGNATURES = {"trunk_fwd_launch": [P, P, P, P, I, I, I, U, P],
              "trunk_bwd_launch": [P] * 11 + [I, I, I, U, I, I, P]}


def load():
    """Build (first call only) and load the kernel library."""
    return _nvcc.load("mlp_train", SIGNATURES)


def _dims(xp: torch.Tensor, wp: torch.Tensor):
    if xp.device.type != "cuda":
        raise ValueError(f"the trunk kernels need CUDA tensors, got {xp.device}")
    if wp.dim() != 3:
        raise ValueError(f"packed weights must be (L, W + {F_PAD}, W), got {tuple(wp.shape)}")
    layers, _, width = wp.shape
    n = xp.shape[0]
    if width not in WIDTHS:
        raise ValueError(f"trunk width {width} not in {WIDTHS}")
    if not 1 <= layers <= MAX_LAYERS:
        raise ValueError(f"{layers} layers outside [1, {MAX_LAYERS}]")
    if n < 1:
        raise ValueError("no points")
    return n, layers, width


def forward_plan_bytes(n: int, width: int, layers: int) -> int:
    """Bytes of device memory kernel B moves for n points, each read or
    written once: x_enc (padded to F_PAD) read, every layer's bf16
    activation written (the output, and what B' reads back), the packed
    weights and biases read. Over HBM's rate, the design's floor beside
    the function's operations bound."""
    return (n * (2 * F_PAD + 2 * layers * width)
            + layers * (2 * (width + F_PAD) * width + 4 * width))


def backward_plan_bytes(n: int, width: int, layers: int, skips) -> tuple:
    """(data pass, weight pass) bytes of device memory B''s three-pass plan
    moves for n points, each read or written once: the data pass reads the
    f32 upstream g and every layer's mask (its saved bf16 activation) and
    writes every layer's bf16 g and dx; the weight pass reads the
    activations acts[0 .. L-2], x once for each layer that reads it (layer 0
    and the skip layers) and every layer's bf16 g. Over HBM's rate, the
    least time the plan can take."""
    data = n * (4 * width + 2 * layers * 2 * width + 2 * F_PAD)
    weight = n * (2 * (layers - 1) * width + 2 * F_PAD * (1 + len(skips)) + 2 * layers * width)
    return data, weight


def trunk_forward_cuda(xp: torch.Tensor, wp: torch.Tensor, bp: torch.Tensor,
                       skips) -> torch.Tensor:
    """Kernel B: xp (N, 64) bf16, wp (L, W + 64, W) bf16, bp (L, W) f32 ->
    every layer's bf16 activation (L, N, W); the last is the output."""
    n, layers, width = _dims(xp, wp)
    dev = xp.device
    check("x", xp, torch.bfloat16, (n, F_PAD), dev)
    check("weights", wp, torch.bfloat16, (layers, width + F_PAD, width), dev)
    check("biases", bp, torch.float32, (layers, width), dev)
    mask = skip_mask(skips, layers)
    acts = torch.empty((layers, n, width), dtype=torch.bfloat16, device=dev)
    _nvcc.launch(load().trunk_fwd_launch, dev, xp.data_ptr(), wp.data_ptr(), bp.data_ptr(),
                 acts.data_ptr(), n, width, layers, mask, kernel="trunk forward", counter="B")
    return acts


def trunk_backward_cuda(xp: torch.Tensor, acts: torch.Tensor, g: torch.Tensor,
                        wp: torch.Tensor, skips):
    """Kernel B': (xp (N, 64) bf16, acts (L, N, W) bf16 from kernel B,
    g (N, W) f32, wp) -> (dx (N, 64) bf16, dW (L, W + 64, W) bf16,
    db (L, W) f32)."""
    n, layers, width = _dims(xp, wp)
    dev = xp.device
    check("x", xp, torch.bfloat16, (n, F_PAD), dev)
    check("acts", acts, torch.bfloat16, (layers, n, width), dev)
    check("g", g, torch.float32, (n, width), dev)
    check("weights", wp, torch.bfloat16, (layers, width + F_PAD, width), dev)
    mask = skip_mask(skips, layers)
    splits, chunk = weight_splits(n)
    tiles = -(-n // BM)
    gbuf = torch.empty((layers, n, width), dtype=torch.bfloat16, device=dev)
    # db partials: one per data-pass block and consumer warpgroup (at most 2 per tile)
    db_part = torch.empty((2 * tiles, layers, width), dtype=torch.float32, device=dev)
    gx_part = torch.empty((n, F_PAD), dtype=torch.float32, device=dev)
    dw_part = torch.empty((splits, layers, width + F_PAD, width), dtype=torch.float32,
                          device=dev)
    dx = torch.empty((n, F_PAD), dtype=torch.bfloat16, device=dev)
    dwp = torch.empty((layers, width + F_PAD, width), dtype=torch.bfloat16, device=dev)
    dbp = torch.empty((layers, width), dtype=torch.float32, device=dev)
    _nvcc.launch(load().trunk_bwd_launch, dev,
                 xp.data_ptr(), wp.data_ptr(), acts.data_ptr(), g.data_ptr(), gbuf.data_ptr(),
                 db_part.data_ptr(), gx_part.data_ptr(), dw_part.data_ptr(), dx.data_ptr(),
                 dwp.data_ptr(), dbp.data_ptr(), n, width, layers, mask, splits, chunk,
                 kernel="trunk backward", counter="B'")
    return dx, dwp, dbp
