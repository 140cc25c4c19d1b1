from panopticnerf_tpu_torch.render.renderer import (
    RenderOut,
    SceneBounds,
    eval_render_cfg,
    render_image_rays,
    render_rays,
)

__all__ = ["RenderOut", "SceneBounds", "eval_render_cfg", "render_image_rays",
           "render_rays"]
