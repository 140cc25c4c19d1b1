"""Wrapper of the CUDA hash grid encoding (`csrc/hash_grid.cu`, kernel G).

`GridKernel(tables, device)` binds kernel G to one field's tables (float32
(rows_l, 2) per level of `ops.hash_grid.GRID`), checked once; each call
`(pts (P, 3) float32) -> g (P, 32) bf16` then checks only its points and
launches: the encoding of `ops.hash_grid.hash_grid_encode` rounded to bf16,
bit for bit (the kernel keeps the plain version's order of operations and
contracts no multiply-add). Other tables raise. It launches on PyTorch's current stream and does not
synchronise; each launch adds one to the counter `kernels.launch.G`
(utils/profiling.py).
"""

from __future__ import annotations

import ctypes

import torch

from panopticnerf_tpu_torch.ops import _nvcc
from panopticnerf_tpu_torch.ops.hash_grid import GRID
from panopticnerf_tpu_torch.ops.mlp_train_cuda import _check, _launch_failed, _stream
from panopticnerf_tpu_torch.utils.profiling import count

_P = ctypes.c_void_p
_I = ctypes.c_int


def load() -> ctypes.CDLL:
    """Build (first call only) and load the kernel library."""
    lib = _nvcc.load("hash_grid")
    lib.hash_grid_launch.argtypes = [_P, ctypes.POINTER(_P), ctypes.POINTER(_I),
                                     ctypes.POINTER(_I), _I, _I, _I, _P, _P]
    lib.hash_grid_launch.restype = _I
    return lib


class GridKernel:
    """Kernel G on one field's tables: `pts (P, 3)` float32 -> (P, 32) bf16.
    Holds the tables (the pointers the kernel reads stay alive with it)."""

    def __init__(self, tables, device: torch.device):
        self.device = torch.device(device)
        if self.device.type != "cuda":
            raise ValueError(f"the hash grid kernel needs a CUDA device, got {device}")
        if len(tables) != GRID.levels:
            raise ValueError(f"{len(tables)} tables for {GRID.levels} levels")
        for level, (t, rows) in enumerate(zip(tables, GRID.rows)):
            _check(f"table {level}", t, torch.float32, (rows, GRID.features), self.device)
        self.tables, self.lib = list(tables), load()
        self._ptrs = (_P * GRID.levels)(*[t.data_ptr() for t in self.tables])
        self._res = (_I * GRID.levels)(*GRID.resolutions)
        self._dense = (_I * GRID.levels)(*[int(d) for d in GRID.dense])

    def __call__(self, pts: torch.Tensor) -> torch.Tensor:
        n = pts.shape[0]
        _check("pts", pts, torch.float32, (n, 3), self.device)
        out = torch.empty((n, GRID.dim), dtype=torch.bfloat16, device=self.device)
        if n:
            with torch.cuda.device(self.device):
                err = self.lib.hash_grid_launch(pts.data_ptr(), self._ptrs, self._res, self._dense,
                                                GRID.levels, GRID.log2_table, n,
                                                out.data_ptr(), _stream(self.device))
            if err != 0:
                raise _launch_failed("hash grid", err)
            count("kernels.launch.G")
        return out
