from panopticnerf_tpu_torch.render.renderer import (
    RenderDraws,
    RenderOut,
    SceneBounds,
    eval_render_cfg,
    render_image_rays,
    render_rays,
)

__all__ = ["RenderDraws", "RenderOut", "SceneBounds", "eval_render_cfg", "render_image_rays",
           "render_rays"]
