"""Kernel G (the hybrid field's hash grid encoding) against its roofline: the
least time of the traced views' encodings over G's device time there. The
least time of a view is the larger of its own bytes at HBM's rate (each
point's f32 position in, 12 bytes, and its L x F bf16 features out) and its
f32 operations at the f32 peak (per point and level: the cell's coordinates
and weights, 8 corners of F products and sums, ~60). It counts no table
bytes, since a view need not touch every row, so the share cannot pass 100 %.
Every point of both fields is encoded: n_rays x (coarse + fine samples) a
view. None where the configuration has no grid (and on a program without
`model.hash_grid`). The grid's sizes are the configuration's `assumed`
ones: 16 levels of 2 features."""

import dataclasses

from harness import yardstick as ys

LAYERS = ("grid_encoding",)
OPS_PER_POINT_LEVEL = 60
LEVELS, DIM = 16, 32


def read(ctx):
    cfg = ctx["cfg"]
    m = cfg.model
    if not getattr(m, "hash_grid", False):
        return None
    r = cfg.render
    ev = dataclasses.replace(cfg, render=dataclasses.replace(
        r, n_samples=r.eval_n_samples or r.n_samples,
        n_importance=r.eval_n_importance if r.eval_n_importance >= 0 else r.n_importance))
    points = ctx["n_rays"] * sum(f["samples"] for f in ys.fields_of(ev))
    least_ms, _ = ys.least_ms(points * OPS_PER_POINT_LEVEL * LEVELS, points * (12 + 2 * DIM),
                              ys.PEAK_F32)
    tr = ctx["trace"]
    return 100.0 * least_ms * 1e-3 * tr["units"] / tr["layers"]["grid_encoding"]["seconds"]
