"""Full-image rendering with its tiles spread over the ranks (port of
`panopticnerf_tpu/parallel/render.py`).

`render_image_rays` renders a view tile by tile on one device. Here the
view's rays are padded to a multiple of `render.ray_tile` x W, and rank r
renders tiles r, r + W, r + 2W, ... (the tiles JAX's sharded map gives
device r), after intersecting its own rays (kernel A1 on the card, once
per view on every rank). The per-ray maps are then gathered, so every
rank holds the whole view, as JAX replicates them to every host. Each
tile is the tile `render_image_rays` renders, with the same rays,
intervals and zero padding, so the maps equal the single-process
render's.
"""

from __future__ import annotations

from typing import Optional

import torch

from panopticnerf_tpu_torch.config import Config
from panopticnerf_tpu_torch.ops.intersect import Primitives, RayIntervals, intersect_rays
from panopticnerf_tpu_torch.parallel.distributed import World
from panopticnerf_tpu_torch.render.renderer import (
    N_RAY_FIELDS,
    RenderOut,
    SceneBounds,
    eval_render_cfg,
    render_rays,
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

    parts = []
    for s in range(0, len(idx), tile):
        iv_t = RayIntervals(*[x[s:s + tile] for x in iv]) if iv is not None else None
        out = render_rays(model, ro[s:s + tile], rd[s:s + tile], bounds, rcfg, iv=iv_t,
                          train=False)
        parts.append(out[:N_RAY_FIELDS])
    fields = []
    for i in range(N_RAY_FIELDS):
        if parts[0][i] is None:
            fields.append(None)
            continue
        mine = torch.cat([p[i] for p in parts])                 # (n_steps * tile, ...)
        every = world.all_gather(mine)                          # (W, n_steps * tile, ...)
        every = every.reshape((w, n_steps, tile) + mine.shape[1:]).transpose(0, 1)
        fields.append(every.reshape((-1,) + mine.shape[1:])[:n])
    return RenderOut(*fields)
