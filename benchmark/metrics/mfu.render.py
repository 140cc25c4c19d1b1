"""Model FLOPs utilisation of the evaluation render: both fields' forward
over every ray of a view (2 x in x out per point and Dense layer, heads
included), counted from shapes, over the view time of the traced run's
window and the bf16 peak."""

import dataclasses

from harness import yardstick as ys

LAYERS = ()


def read(ctx):
    cfg, w = ctx["cfg"], ctx["window"]
    r = cfg.render
    ev = dataclasses.replace(cfg, render=dataclasses.replace(
        r, n_samples=r.eval_n_samples or r.n_samples,
        n_importance=r.eval_n_importance if r.eval_n_importance >= 0 else r.n_importance))
    flops = ys.field_flops(ev, ctx["n_rays"], backward=False)
    return 100.0 * flops * w["units"] / w["seconds"] / ys.PEAK_BF16
