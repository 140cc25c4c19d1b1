"""The share of the evaluation render's compositing that kernel V did: the rays V composited
(counter `render.composite.rays_fused`) over every ray the evaluation branch composited
(`render.composite.rays`, each level of each tile), over the whole run. None where the program
counts neither (a program without V)."""

from panopticnerf_tpu_torch.utils import profiling

LAYERS = ()


def read(ctx):
    if not hasattr(profiling, "calls"):
        return None
    rays = profiling.calls("render.composite.rays")
    if rays == 0:
        return None
    return 100.0 * profiling.calls("render.composite.rays_fused") / rays
