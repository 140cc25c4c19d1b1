"""Wrapper of the CUDA evaluation field (`csrc/field_eval.cu`, kernel E).

`EvalKernel(pk, dims, device)` binds kernel E to one field's packed weights
(`ops.field_eval.pack_eval`), checked once; each call then checks only its
points and launches, with the contract of `ops.field_eval.field_eval_plain`,
E's plain version: the render evaluates a field once per tile and level, so
the weights' checks and pointers are not paid again on each launch. The
kernel takes float32 points and directions, bf16 weights with float32
biases holding bf16 values, W in {64, 128, 256} with sem_hidden = W / 2, a
colour width and class count up to 128, up to 32 layers, encodings of at
most 10 (points) and 4 (directions) bands, and for a hybrid field (`dims.grid_dim`
32) the hash grid's features g (P, 32) bf16 that kernel G wrote, which its
sigma, sem_hidden and feature heads read after h; anything else raises. It
launches through `ops/_nvcc.py`; counter `kernels.launch.E`.
`field_eval_encodings_cuda` writes out the encodings as E computes them
into shared memory, for the test that holds them to `positional_encoding`.
"""

from __future__ import annotations

import torch

from panopticnerf_tpu_torch.ops import _nvcc
from panopticnerf_tpu_torch.ops._nvcc import P, I, U, check, ptr
from panopticnerf_tpu_torch.ops.encoding import posenc_dim
from panopticnerf_tpu_torch.ops.field_eval import freqs
from panopticnerf_tpu_torch.ops.field_train import FieldDims, FieldPacked, check_packed
from panopticnerf_tpu_torch.ops.mlp_train import skip_mask

SIGNATURES = {"field_eval_launch": [P] * 15 + [I, I, I, I, U] + [I] * 6 + [P, P],
              "field_eval_encode_launch": [P] * 4 + [I] * 4 + [P]}


def load():
    """Build (first call only) and load the kernel library."""
    return _nvcc.load("field_eval", SIGNATURES)


class EvalKernel:
    """Kernel E on one field's packed weights: `(pts (R x S, 3), dirs (R, 3),
    S, grid (P, grid_dim) bf16 | None)` float32 -> (sigma (P,), rgb (P, 3),
    sem (P, C) | None), float32.
    Holds `pk` (the tensors the kernel reads stay alive with it)."""

    def __init__(self, pk: FieldPacked, dims: FieldDims, device: torch.device):
        self.device = torch.device(device)
        if self.device.type != "cuda":
            raise ValueError(f"the evaluation field kernel needs a CUDA device, got {device}")
        if dims.grid_dim not in (0, 32):
            raise ValueError(f"kernel E takes 0 or 32 hash grid features, not {dims.grid_dim}")
        if any(d and d != posenc_dim(3, freqs(d)) for d in (dims.x_dim, dims.d_dim)):
            raise ValueError(f"encoding widths {dims.x_dim} / {dims.d_dim} are not 3 (2 F + 1)")
        check_packed(pk, dims, self.device)
        self.pk, self.dims, self.lib = pk, dims, load()
        self.weights = (pk.wp.data_ptr(), pk.bp.data_ptr(), pk.hw.data_ptr(), pk.hb.data_ptr(),
                        ptr(pk.wso), ptr(pk.bso), pk.wch.data_ptr(), pk.bch.data_ptr(),
                        pk.wco.data_ptr(), pk.bco.data_ptr())
        self.shape = (dims.width, dims.layers, skip_mask(dims.skips, dims.layers),
                      freqs(dims.x_dim), freqs(dims.d_dim), dims.num_classes, dims.cwp, dims.cp,
                      int(dims.use_sem))

    def __call__(self, pts: torch.Tensor, dirs: torch.Tensor, samples: int,
                 grid: torch.Tensor | None = None):
        dev, f32 = self.device, torch.float32
        n, rays = pts.shape[0], dirs.shape[0]
        if samples < 1 or n != rays * samples:
            raise ValueError(f"{n} points are not {rays} rays x {samples} samples")
        check("pts", pts, f32, (n, 3), dev)
        check("dirs", dirs, f32, (rays, 3), dev)
        if self.dims.grid_dim:
            if grid is None:
                raise ValueError("a hybrid field's E needs the hash grid's features")
            check("grid features", grid, torch.bfloat16, (n, self.dims.grid_dim), dev)
        elif grid is not None:
            raise ValueError("grid features given to a field without a hash grid")
        sigma = torch.empty((n,), dtype=f32, device=dev)
        rgb = torch.empty((n, 3), dtype=f32, device=dev)
        sem = (torch.empty((n, self.dims.num_classes), dtype=f32, device=dev)
               if self.dims.use_sem else None)
        if n:
            _nvcc.launch(self.lib.field_eval_launch, dev, pts.data_ptr(), dirs.data_ptr(),
                         *self.weights, sigma.data_ptr(), rgb.data_ptr(), ptr(sem), n, samples,
                         *self.shape, ptr(grid), kernel="evaluation field", counter="E")
        return sigma, rgb, sem


def field_eval_encodings_cuda(pts: torch.Tensor, dirs: torch.Tensor, samples: int,
                              x_freqs: int, d_freqs: int):
    """E's encodings of pts (R x S, 3) and of dirs (R, 3), float32 ->
    (x_enc (P, 64), d_enc (P, 64)) bf16, each padded with zero columns as in
    E's shared memory (d_freqs -1: no view directions, all zeros)."""
    n, rays = pts.shape[0], dirs.shape[0]
    if n < 1 or samples < 1 or n != rays * samples or not 0 <= x_freqs <= 10 \
            or not -1 <= d_freqs <= 4:
        raise ValueError("points, samples or bands out of range")
    check("pts", pts, torch.float32, (n, 3), pts.device)
    check("dirs", dirs, torch.float32, (rays, 3), pts.device)
    x_out = torch.empty((n, 64), dtype=torch.bfloat16, device=pts.device)
    d_out = torch.empty_like(x_out)
    _nvcc.launch(load().field_eval_encode_launch, pts.device, pts.data_ptr(), dirs.data_ptr(),
                 x_out.data_ptr(), d_out.data_ptr(), n, samples, x_freqs, d_freqs,
                 kernel="encoding probe", counter=None)
    return x_out, d_out
