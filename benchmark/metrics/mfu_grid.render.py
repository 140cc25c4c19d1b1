"""Model FLOPs utilisation of the hybrid field's evaluation render: both
fields' Dense FLOPs over every ray of a view (2 x in x out per point and Dense
layer forward), the sigma, sem_hidden and feature heads at their input widened
by the hash grid's 32 features, counted from shapes, over the view time of
the traced run's window and the bf16 peak. The grid's own gathers are not
FLOPs of a Dense and are left out (`grid_roofline.render` reads them). None
where the configuration has no grid (`mfu.render` counts the plain shapes)."""

import dataclasses

from harness import yardstick as ys

LAYERS = ()
GRID_DIM = 32  # the configuration's `assumed` grid: 16 levels of 2 features


def read(ctx):
    cfg, w = ctx["cfg"], ctx["window"]
    m = cfg.model
    if not getattr(m, "hash_grid", False):
        return None
    r = cfg.render
    ev = dataclasses.replace(cfg, render=dataclasses.replace(
        r, n_samples=r.eval_n_samples or r.n_samples,
        n_importance=r.eval_n_importance if r.eval_n_importance >= 0 else r.n_importance))
    per_ray = 0
    for f in ys.fields_of(ev):
        heads_out = f["width"] // 2 + 1 + f["width"]  # [sem_hidden | sigma | feature]
        per_ray += f["samples"] * (ys.macs_per_point(ys.field_shapes(f)) + GRID_DIM * heads_out)
    flops = 2.0 * ctx["n_rays"] * per_ray
    return 100.0 * flops * w["units"] / w["seconds"] / ys.PEAK_BF16
