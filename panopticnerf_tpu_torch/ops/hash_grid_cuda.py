"""Wrapper of the CUDA hash grid encoding (`csrc/hash_grid.cu`, kernel G).

`GridKernel(tables, device)` binds kernel G to one field's tables (float32
(rows_l, 2) per level of `ops.hash_grid.GRID`), checked once; each call
`(pts (P, 3) float32) -> g (P, 32) bf16` then checks only its points and
launches: the encoding of `ops.hash_grid.hash_grid_encode` rounded to bf16,
bit for bit (the kernel keeps the plain version's order of operations and
contracts no multiply-add). Other tables raise. It launches through
`ops/_nvcc.py`; counter `kernels.launch.G`. Two adjacent lanes take a point
(`GridKernel.paired`), each fetching the corners of one x-side of its cell,
and a block eight levels of its points, so each point's eight levels are
stored as one 32-byte sector.

`gather_footprint(pts, paired)` is the plain model of what G's loads touch:
per level, the distinct 128-byte lines and 32-byte sectors its warps' load
instructions touch for a tile's points, under one thread a point (8 loads a
warp of 32 points) or G's lane pairs (4 loads a warp of 16 points, the two
x-neighbours in one load).
"""

from __future__ import annotations

import ctypes

import torch

from panopticnerf_tpu_torch.ops import _nvcc
from panopticnerf_tpu_torch.ops._nvcc import P, I, check
from panopticnerf_tpu_torch.ops.hash_grid import GRID, corner_rows

SIGNATURES = {"hash_grid_launch": [P, ctypes.POINTER(P), ctypes.POINTER(I), ctypes.POINTER(I),
                                   I, I, I, P, P]}


def load():
    """Build (first call only) and load the kernel library."""
    return _nvcc.load("hash_grid", SIGNATURES)


class GridKernel:
    """Kernel G on one field's tables: `pts (P, 3)` float32 -> (P, 32) bf16.
    Holds the tables (the pointers the kernel reads stay alive with it)."""

    paired = True  # every point's corners are gathered by a lane pair

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


LINE_ROWS, SECTOR_ROWS = 16, 4  # 8-byte rows in a 128-byte line, in a 32-byte sector


def gather_footprint(pts: torch.Tensor, paired: bool) -> list:
    """The lines and sectors kernel G's loads touch for the points `pts`
    (P, 3) (a tile's own points, in the order G reads them): per level of
    `GRID`, (lines, sectors) summed over the tile's warps and their load
    instructions, each the count of distinct 128-byte lines / 32-byte
    sectors one warp-wide load touches (tables 128-byte aligned, rows of 8
    bytes). One thread a point: a warp holds 32 points and load c fetches
    corner c of each. Paired (G): a warp holds 16 points and load m fetches
    corners 2m and 2m + 1 of each, one a lane. Lanes past P load nothing.
    The cell maths is `hash_grid_encode`'s; plain ops on any device."""
    u = ((pts.float() + 1.0) / 2.0).clamp(0.0, 1.0)
    n = pts.shape[0]
    warp = torch.arange(n, device=pts.device) // (16 if paired else 32)
    corners = torch.arange(8, device=pts.device)
    load = warp[:, None] * 8 + (corners >> 1 if paired else corners)  # (P, 8): the warp's load
    out = []
    for res, dense in zip(GRID.resolutions, GRID.dense):
        i = torch.floor(u * float(res)).clamp(max=float(res - 1)).long()
        rows = torch.stack([corner_rows(i[:, 0] + (c & 1), i[:, 1] + (c >> 1 & 1),
                                        i[:, 2] + (c >> 2), res, dense, GRID.table_size)
                            for c in range(8)], dim=1)
        out.append(tuple(int(torch.unique(load * (1 << 32) + rows // size).numel())
                         for size in (LINE_ROWS, SECTOR_ROWS)))
    return out
