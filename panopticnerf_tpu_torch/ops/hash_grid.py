"""The multi-resolution hash grid of PanopticNeRF-360's hybrid field
(Instant-NGP, Müller et al., arXiv 2201.05989): its sizes (`GRID`,
Instant-NGP's for NeRF) and its plain encoding in PyTorch ops,
differentiable in the tables (the CPU's path and training's; kernel G,
`ops/hash_grid_cuda.py`, computes the same forward on the card for the
evaluation render). A field has this grid when `model.hash_grid` is set.

The JAX package has no grid: the port is held to the benchmark's plain
reference (`benchmark/reference/hybrid.py`) instead. The equations, for a
scene-normalised point p (what the positional encoding takes):
- u = clamp((p + 1) / 2, 0, 1): the cube [-1, 1]^3 onto [0, 1]^3, points
  outside it take the border cell;
- L = 16 levels of resolution N_l = floor(N_min b^l) (float64), b =
  exp((ln N_max - ln N_min) / (L - 1)), N_min = 16, N_max = 2048;
- at level l: x = u N_l, i = min(floor(x), N_l - 1), t = x - i; corner
  c in {0,1}^3 is k = i + c; a level whose (N_l + 1)^3 corners fit the
  table size T = 2^19 is dense (levels 0-4), (N_l + 1)^3 rows at k_0 + k_1
  (N_l + 1) + k_2 (N_l + 1)^2; the others hold T rows at (k_0 * 1 xor k_1 *
  2654435761 xor k_2 * 805459861) mod T in uint32 arithmetic;
- f_l = sum over the corners c = c_0 + 2 c_1 + 4 c_2, in that order, of
  w_c theta_l[row], w_c = (c_0 ? t_0 : 1 - t_0) (c_1 ? t_1 : 1 - t_1)
  (c_2 ? t_2 : 1 - t_2), all in float32, F = 2 features a row; the encoding
  is [f_0, ..., f_15], 32 columns.
Departure from tiny-cuda-nn: its +0.5 offset of the cell and its `scale -
1` resolutions are not followed; the paper's floor(N_min b^l) is.
"""

from __future__ import annotations

import dataclasses
import math

import torch

PRIMES = (1, 2654435761, 805459861)


@dataclasses.dataclass(frozen=True)
class GridSpec:
    """Static sizes of a hash grid."""

    levels: int
    features: int
    log2_table: int
    min_res: int
    max_res: int

    @property
    def table_size(self) -> int:
        return 1 << self.log2_table

    @property
    def resolutions(self) -> tuple:
        """N_l = floor(N_min b^l) in float64, b = exp((ln N_max - ln N_min) / (L - 1))."""
        b = math.exp((math.log(self.max_res) - math.log(self.min_res)) / (self.levels - 1))
        return tuple(math.floor(self.min_res * b ** l) for l in range(self.levels))

    @property
    def dense(self) -> tuple:
        """Per level: whether its (N_l + 1)^3 corners fit the table size."""
        return tuple((r + 1) ** 3 <= self.table_size for r in self.resolutions)

    @property
    def rows(self) -> tuple:
        """Rows of each level's table."""
        return tuple((r + 1) ** 3 if d else self.table_size
                     for r, d in zip(self.resolutions, self.dense))

    @property
    def dim(self) -> int:
        """Columns of the encoding, L x F."""
        return self.levels * self.features


GRID = GridSpec(levels=16, features=2, log2_table=19, min_res=16, max_res=2048)


def corner_rows(k0: torch.Tensor, k1: torch.Tensor, k2: torch.Tensor, res: int, dense: bool,
                table_size: int) -> torch.Tensor:
    """Table rows of integer corners (int64 tensors)."""
    if dense:
        return k0 + k1 * (res + 1) + k2 * (res + 1) ** 2
    # the low bits of the int64 products are the uint32 products'; T divides 2^32
    return (k0 * PRIMES[0] ^ k1 * PRIMES[1] ^ k2 * PRIMES[2]) & (table_size - 1)


def hash_grid_encode(pts: torch.Tensor, tables) -> torch.Tensor:
    """pts (..., 3) float32 scene-normalised, `tables` one (rows_l, F) float32
    tensor per level of `GRID` -> the encoding (..., L x F), float32;
    differentiable in the tables (and in pts through t)."""
    u = ((pts.float() + 1.0) / 2.0).clamp(0.0, 1.0)
    out = []
    for res, dense, table in zip(GRID.resolutions, GRID.dense, tables):
        x = u * float(res)
        i = torch.floor(x).clamp(max=float(res - 1))
        t = x - i
        i = i.long()
        acc = None
        for c in range(8):
            bit = [(c >> j) & 1 for j in range(3)]
            w = None
            for j in range(3):
                wj = t[..., j] if bit[j] else 1.0 - t[..., j]
                w = wj if w is None else w * wj
            row = corner_rows(i[..., 0] + bit[0], i[..., 1] + bit[1], i[..., 2] + bit[2], res,
                              dense, GRID.table_size)
            term = w[..., None] * table[row]
            acc = term if acc is None else acc + term
        out.append(acc)
    return torch.cat(out, dim=-1)
