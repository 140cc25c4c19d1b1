"""Wrapper of the CUDA hash grid encoding (`csrc/hash_grid.cu`, kernel G).

`GridKernel(tables, device)` binds kernel G to one field's tables (float32
(rows_l, 2) per level of `ops.hash_grid.GRID`), checked once; each call
`(pts (P, 3) float32) -> g (P, 32) bf16` then checks only its points and
launches: the encoding of `ops.hash_grid.hash_grid_encode` rounded to bf16,
bit for bit (the kernel keeps the plain version's order of operations and
contracts no multiply-add). Other tables raise. It launches through
`ops/_nvcc.py`; counter `kernels.launch.G`.
"""

from __future__ import annotations

import ctypes

import torch

from panopticnerf_tpu_torch.ops import _nvcc
from panopticnerf_tpu_torch.ops._nvcc import P, I, check
from panopticnerf_tpu_torch.ops.hash_grid import GRID

SIGNATURES = {"hash_grid_launch": [P, ctypes.POINTER(P), ctypes.POINTER(I), ctypes.POINTER(I),
                                   I, I, I, P, P]}


def load():
    """Build (first call only) and load the kernel library."""
    return _nvcc.load("hash_grid", SIGNATURES)


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
            check(f"table {level}", t, torch.float32, (rows, GRID.features), self.device)
        self.tables, self.lib = list(tables), load()
        self._ptrs = (P * GRID.levels)(*[t.data_ptr() for t in self.tables])
        self._res = (I * GRID.levels)(*GRID.resolutions)
        self._dense = (I * GRID.levels)(*[int(d) for d in GRID.dense])

    def __call__(self, pts: torch.Tensor) -> torch.Tensor:
        n = pts.shape[0]
        check("pts", pts, torch.float32, (n, 3), self.device)
        out = torch.empty((n, GRID.dim), dtype=torch.bfloat16, device=self.device)
        if n:
            _nvcc.launch(self.lib.hash_grid_launch, self.device, pts.data_ptr(), self._ptrs,
                         self._res, self._dense, GRID.levels, GRID.log2_table, n, out.data_ptr(),
                         kernel="hash grid", counter="G")
        return out
