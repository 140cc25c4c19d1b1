from panopticnerf_tpu_torch.render.panorama import panorama_rays, render_panorama
from panopticnerf_tpu_torch.render.renderer import (
    RenderDraws,
    RenderOut,
    SceneBounds,
    eval_render_cfg,
    intersect_and_render,
    render_image_rays,
    render_rays,
)

__all__ = ["RenderDraws", "RenderOut", "SceneBounds", "eval_render_cfg",
           "intersect_and_render", "panorama_rays", "render_image_rays", "render_panorama",
           "render_rays"]
