"""Model FLOPs utilisation of the training step: both fields' forward
(2 x in x out per point and Dense layer, heads included) and backward
(twice that), counted from shapes, over the step time of the traced run's
window (the steps outside the profiled stretch) and the bf16 peak."""

from harness import yardstick as ys

LAYERS = ()


def read(ctx):
    w = ctx["window"]
    flops = ys.field_flops(ctx["cfg"], ctx["n_rays"], backward=True)
    return 100.0 * flops * w["units"] / w["seconds"] / ys.PEAK_BF16
