"""Wrappers of the CUDA trunk kernels (`csrc/mlp_train.cu`).

- `trunk_forward_cuda` (kernel B) replaces the forward of `trunk_train`,
  `panopticnerf_tpu/ops/pallas_mlp_train.py` (`_trunk_fwd_impl`);
- `trunk_backward_cuda` (kernel B') replaces its backward
  (`_trunk_bwd_rule` -> `_bwd_kernel`).
Same contracts as `ops.mlp_train.trunk_forward_plain` /
`trunk_backward_plain`, their plain versions. The kernels take bf16
activations and weights, W in {64, 128, 256}, x_enc padded to 64 columns
and up to 32 layers; anything else raises. They launch on PyTorch's current
stream and do not synchronise; each launch adds one to its counter,
`kernels.launch.B` or `kernels.launch.B'` (utils/profiling.py; B' is one
launch of the three-pass backward).
"""

from __future__ import annotations

import ctypes

import torch

from panopticnerf_tpu_torch.ops import _nvcc
from panopticnerf_tpu_torch.ops.mlp_train import F_PAD
from panopticnerf_tpu_torch.utils.profiling import count

WIDTHS = (64, 128, 256)
MAX_LAYERS = 32
SPLIT_POINTS = 4096  # points per split of the weight pass (at most MAX_SPLITS splits)
MAX_SPLITS = 32
POINT_STEP = 64      # points per ring stage of the weight pass: each split's size is a multiple
BM = 128             # points per tile of the forward / data pass
TMA_ENCODE_FAILED = 9001  # kTmaEncodeFailed (csrc/hopper.cuh): not a CUDA error code

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint


def load() -> ctypes.CDLL:
    """Build (first call only) and load the kernel library."""
    lib = _nvcc.load("mlp_train")
    lib.trunk_fwd_launch.argtypes = [_P, _P, _P, _P, _I, _I, _I, _U, _P]
    lib.trunk_fwd_launch.restype = _I
    lib.trunk_bwd_launch.argtypes = [_P] * 11 + [_I, _I, _I, _U, _I, _I, _P]
    lib.trunk_bwd_launch.restype = _I
    return lib


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple,
           device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _skip_mask(skips, layers: int) -> int:
    if any(not 0 < s < layers for s in skips):
        raise ValueError(f"skips {skips} must lie in [1, {layers})")
    return sum(1 << s for s in skips)


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


def weight_splits(n: int) -> tuple:
    """(splits, chunk) of the split-K weight pass over n points: split s
    takes points [s * chunk, min(n, (s + 1) * chunk)); chunk is a multiple
    of POINT_STEP, so that no ring stage of a split reaches into the next."""
    splits = max(1, min(MAX_SPLITS, -(-n // SPLIT_POINTS)))
    per_split = -(-n // splits)
    return splits, -(-per_split // POINT_STEP) * POINT_STEP


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


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _launch_failed(kernel: str, err: int) -> RuntimeError:
    why = ("a TMA descriptor could not be encoded" if err == TMA_ENCODE_FAILED
           else f"CUDA error {err}")
    return RuntimeError(f"{kernel} kernel launch failed: {why}")


def trunk_forward_cuda(xp: torch.Tensor, wp: torch.Tensor, bp: torch.Tensor,
                       skips) -> torch.Tensor:
    """Kernel B: xp (N, 64) bf16, wp (L, W + 64, W) bf16, bp (L, W) f32 ->
    every layer's bf16 activation (L, N, W); the last is the output."""
    n, layers, width = _dims(xp, wp)
    dev = xp.device
    _check("x", xp, torch.bfloat16, (n, F_PAD), dev)
    _check("weights", wp, torch.bfloat16, (layers, width + F_PAD, width), dev)
    _check("biases", bp, torch.float32, (layers, width), dev)
    mask = _skip_mask(skips, layers)
    acts = torch.empty((layers, n, width), dtype=torch.bfloat16, device=dev)
    lib = load()
    with torch.cuda.device(dev):
        err = lib.trunk_fwd_launch(xp.data_ptr(), wp.data_ptr(), bp.data_ptr(),
                                   acts.data_ptr(), n, width, layers, mask, _stream(dev))
    if err != 0:
        raise _launch_failed("trunk forward", err)
    count("kernels.launch.B")
    return acts


def trunk_backward_cuda(xp: torch.Tensor, acts: torch.Tensor, g: torch.Tensor,
                        wp: torch.Tensor, skips):
    """Kernel B': (xp (N, 64) bf16, acts (L, N, W) bf16 from kernel B,
    g (N, W) f32, wp) -> (dx (N, 64) bf16, dW (L, W + 64, W) bf16,
    db (L, W) f32)."""
    n, layers, width = _dims(xp, wp)
    dev = xp.device
    _check("x", xp, torch.bfloat16, (n, F_PAD), dev)
    _check("acts", acts, torch.bfloat16, (layers, n, width), dev)
    _check("g", g, torch.float32, (n, width), dev)
    _check("weights", wp, torch.bfloat16, (layers, width + F_PAD, width), dev)
    mask = _skip_mask(skips, layers)
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
    lib = load()
    with torch.cuda.device(dev):
        err = lib.trunk_bwd_launch(
            xp.data_ptr(), wp.data_ptr(), acts.data_ptr(), g.data_ptr(), gbuf.data_ptr(),
            db_part.data_ptr(), gx_part.data_ptr(), dw_part.data_ptr(), dx.data_ptr(),
            dwp.data_ptr(), dbp.data_ptr(), n, width, layers, mask, splits, chunk, _stream(dev))
    if err != 0:
        raise _launch_failed("trunk backward", err)
    count("kernels.launch.B'")
    return dx, dwp, dbp
