"""Full-image rendering with its tiles spread over the ranks (port of
`panopticnerf_tpu/parallel/render.py`).

`render_image_rays` renders a view tile by tile on one device. Here the
view's rays are padded to a multiple of `render.ray_tile` x W, and rank r
renders tiles r, r + W, r + 2W, ... (the tiles JAX's sharded map gives
device r), after intersecting its own rays (kernel A1 on the card, once
per view on every rank), through the renderer's own tile loop
(`render_tiles`). The per-ray maps are then gathered, so every rank holds
the whole view, as JAX replicates them to every host. Each tile is the
tile `render_image_rays` renders, with the same rays, intervals and zero
padding, so the maps equal the single-process render's.
"""

from __future__ import annotations

from typing import Optional

import torch

from panopticnerf_tpu_torch.config import Config
from panopticnerf_tpu_torch.ops.intersect import Primitives, intersect_rays
from panopticnerf_tpu_torch.parallel.distributed import World
from panopticnerf_tpu_torch.render.renderer import (
    RenderOut,
    SceneBounds,
    eval_render_cfg,
    render_tiles,
)


@torch.no_grad()
def render_image_rays_sharded(model, rays_o, rays_d, bounds: SceneBounds, cfg: Config,
                              world: World, prims: Optional[Primitives] = None) -> RenderOut:
    """The contract of `intersect_and_render` (intervals against `prims`
    when render.use_primitives, then the tiled render), with the tiles
    sharded over `world`: every rank returns the whole view's RenderOut."""
    rcfg = eval_render_cfg(cfg)
    tile, w, n = rcfg.render.ray_tile, world.size, rays_o.shape[0]
    dev = rays_o.device
    n_steps = -(-n // (tile * w))               # tiles per rank
    tiles = torch.arange(n_steps, device=dev) * w + world.rank
    idx = (tiles[:, None] * tile + torch.arange(tile, device=dev)).reshape(-1)
    n_real = int((idx < n).sum())               # the rank's real rays lead its rows
    pad = lambda a: torch.cat([a[idx[:n_real]], a.new_zeros((len(idx) - n_real,) + a.shape[1:])])
    ro, rd = pad(rays_o), pad(rays_d)
    iv = None
    if cfg.render.use_primitives:
        iv = intersect_rays(ro, rd, prims, cfg.render.near, cfg.render.far,
                            cfg.data.max_intervals)
        for x in iv:  # padding rows get the zero intervals render_image_rays pads with
            x[n_real:] = 0

    fields = []
    for mine in render_tiles(model, ro, rd, bounds, rcfg, iv):  # (n_steps * tile, ...)
        if mine is None:
            fields.append(None)
            continue
        every = world.all_gather(mine)                          # (W, n_steps * tile, ...)
        every = every.reshape((w, n_steps, tile) + mine.shape[1:]).transpose(0, 1)
        fields.append(every.reshape((-1,) + mine.shape[1:])[:n])
    return RenderOut(*fields)
