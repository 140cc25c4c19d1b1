"""The share of the rays rendered that are padding: the zero rays `render_image_rays` adds
to fill a view's last tile (counter `render.rays_padded`) over every ray it renders, real
(`render.rays`) and padded, over the whole run. None where the program counts neither."""

from panopticnerf_tpu_torch.utils import profiling

LAYERS = ()


def read(ctx):
    if not hasattr(profiling, "calls"):
        return None
    rays, padded = profiling.calls("render.rays"), profiling.calls("render.rays_padded")
    if rays + padded == 0:
        return None
    return 100.0 * padded / (rays + padded)
