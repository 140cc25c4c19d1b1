"""The share of the evaluation render's sampling that kernel Z did: the rays Z sampled (counter
`render.sample.rays_fused`) over every ray the evaluation branch sampled (`render.sample.rays`,
each level of each tile), over the whole run. None where the program counts neither (a program
without Z)."""

from panopticnerf_tpu_torch.utils import profiling

LAYERS = ()


def read(ctx):
    if not hasattr(profiling, "calls"):
        return None
    rays = profiling.calls("render.sample.rays")
    if rays == 0:
        return None
    return 100.0 * profiling.calls("render.sample.rays_fused") / rays
