"""The share of the evaluation field's points that kernel E evaluated: the points the fused
field took (counter `render.field.points_fused`) over every point either field evaluated
(`render.field.points`), over the whole run. None where the program counts neither."""

from panopticnerf_tpu_torch.utils import profiling

LAYERS = ()


def read(ctx):
    if not hasattr(profiling, "calls"):
        return None
    points = profiling.calls("render.field.points")
    if points == 0:
        return None
    return 100.0 * profiling.calls("render.field.points_fused") / points
