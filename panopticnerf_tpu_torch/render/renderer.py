"""Volume renderer (port of `panopticnerf_tpu/render/renderer.py`).

`render_rays` renders a ray batch: guided (or stratified) coarse depths ->
coarse field -> compositing -> inverse-CDF fine depths -> fine field ->
compositing, with the fixed semantic field composited K-factored. Only the
evaluation branch (`train=False`: no jitter, no density noise) is ported so
far. `render_image_rays` renders a whole view as a loop over tiles of
`render.ray_tile` rays.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from panopticnerf_tpu_torch.config import Config
from panopticnerf_tpu_torch.ops import sampling
from panopticnerf_tpu_torch.ops.composite import composite
from panopticnerf_tpu_torch.ops.intersect import (
    RayIntervals,
    fixed_map_from_weights,
    labeled_containment,
    samples_in_intervals,
)


# RenderOut's leading per-ray fields (rgb .. inst_sem); the rest are extras.
N_RAY_FIELDS = 8


class SceneBounds(NamedTuple):
    """Scene normalisation applied before positional encoding."""

    center: torch.Tensor  # (3,)
    scale: torch.Tensor   # () world-to-unit multiplier


class RenderOut(NamedTuple):
    rgb: torch.Tensor                     # (N, 3)
    depth: torch.Tensor                   # (N,)
    acc: torch.Tensor                     # (N,)
    sem_logits: Optional[torch.Tensor]    # (N, C) learned field, composited
    sem_fixed: Optional[torch.Tensor]     # (N, C) fixed field, composited
    inst_mass: Optional[torch.Tensor]     # (N, K) per-interval opacity mass
    inst_ids: Optional[torch.Tensor]      # (N, K) interval instance ids
    inst_sem: Optional[torch.Tensor]      # (N, K) interval semantic ids
    # per-sample extras (dropped by render_image_rays)
    coarse: Optional["RenderOut"] = None
    z: Optional[torch.Tensor] = None              # (N, S)
    weights: Optional[torch.Tensor] = None        # (N, S)
    sample_sem_logits: Optional[torch.Tensor] = None  # (N, S, C)
    sample_inside_k: Optional[torch.Tensor] = None    # (N, S, K) labelled containment
    sample_cnt: Optional[torch.Tensor] = None         # (N, S)


def _composite_level(model, rays_o, rays_d, z, bounds: SceneBounds, level: int,
                     iv: Optional[RayIntervals], num_classes: int, white_bkgd: bool):
    pts = rays_o[:, None, :] + rays_d[:, None, :] * z[..., None]     # (N, S, 3)
    pts = (pts - bounds.center) * bounds.scale
    sigma, rgb, sem = model(pts, rays_d[:, None, :], level=level)

    inside_iv = inside_lab = cnt = None
    if iv is not None:
        inside_iv = samples_in_intervals(z, iv)
        inside_lab, cnt = labeled_containment(z, iv)
    out = composite(sigma, rgb, z, sem_logits=sem, inside_intervals=inside_iv,
                    white_bkgd=white_bkgd)
    if iv is not None:
        out = out._replace(sem_fixed=fixed_map_from_weights(
            out.weights, inside_lab, cnt, iv, num_classes))
    return out, sem, inside_lab, cnt


def render_rays(model, rays_o, rays_d, bounds: SceneBounds, cfg: Config,
                iv: Optional[RayIntervals] = None, train: bool = True) -> RenderOut:
    """Render a batch of rays (N, 3) with the intervals `iv` (N, K)."""
    if train:
        raise NotImplementedError("the training branch of render_rays is not ported yet")
    rc = cfg.render
    n = rays_o.shape[0]
    dev = rays_o.device
    num_classes = cfg.model.num_classes

    if iv is not None and rc.use_primitives:
        z = sampling.guided_z(iv, rc.n_samples, rc.near, rc.far, False, rc.bg_sample_frac)
    else:
        z = sampling.stratified_z(n, rc.n_samples, rc.near, rc.far, False, dev)
    out_c, sem_c, lab_c, cnt_c = _composite_level(
        model, rays_o, rays_d, z, bounds, 0, iv, num_classes, rc.white_bkgd)

    def pack(out, sem_samples, inside_k, cnt, z_used, coarse=None):
        return RenderOut(
            rgb=out.rgb, depth=out.depth, acc=out.acc,
            sem_logits=out.sem_logits, sem_fixed=out.sem_fixed,
            inst_mass=out.inst_mass,
            inst_ids=iv.instance if iv is not None else None,
            inst_sem=iv.semantic if iv is not None else None,
            coarse=coarse, z=z_used, weights=out.weights,
            sample_sem_logits=sem_samples, sample_inside_k=inside_k,
            sample_cnt=cnt,
        )

    if rc.n_importance <= 0:
        return pack(out_c, sem_c, lab_c, cnt_c, z)

    # --- hierarchical fine pass: bins are the coarse midpoints, masses the
    # interior coarse weights ---
    z_mid = 0.5 * (z[:, 1:] + z[:, :-1])                        # (N, S-1)
    w_interior = out_c.weights[:, 1:-1]                         # (N, S-2)
    z_fine = sampling.sample_pdf(z_mid, w_interior, rc.n_importance, False)
    z_all = sampling.merge_z(z, z_fine)
    if 0 < rc.eval_keep_samples < z_all.shape[1]:
        raise NotImplementedError("render.eval_keep_samples is not ported yet")
    out_f, sem_f, lab_f, cnt_f = _composite_level(
        model, rays_o, rays_d, z_all, bounds, 1, iv, num_classes, rc.white_bkgd)
    coarse = pack(out_c, sem_c, lab_c, cnt_c, z)
    return pack(out_f, sem_f, lab_f, cnt_f, z_all, coarse=coarse)


def eval_render_cfg(cfg: Config) -> Config:
    """Config of full-image eval renders: applies render.eval_n_samples /
    eval_n_importance (0 / -1 = follow training)."""
    rc = cfg.render
    ns = rc.eval_n_samples if rc.eval_n_samples > 0 else rc.n_samples
    ni = rc.eval_n_importance if rc.eval_n_importance >= 0 else rc.n_importance
    mc = cfg.model
    if ni <= 0 < rc.n_importance and (mc.coarse_trunk_depth or mc.coarse_trunk_width):
        raise ValueError(
            "render.eval_n_importance 0 renders the COARSE field only, but "
            "model.coarse_trunk_depth/width configure a small proposal coarse "
            "whose only trained role is importance weights. Use "
            "eval_n_importance > 0 or unset the proposal coarse size.")
    if (ns, ni) == (rc.n_samples, rc.n_importance):
        return cfg
    return dataclasses.replace(
        cfg, render=dataclasses.replace(rc, n_samples=ns, n_importance=ni))


@torch.no_grad()
def render_image_rays(model, rays_o, rays_d, bounds: SceneBounds, cfg: Config,
                      iv: Optional[RayIntervals] = None) -> RenderOut:
    """Full-image render: pad rays (and intervals) with zeros to a tile
    multiple, render tile by tile, drop the per-sample extras and the
    padding. Returns a RenderOut with leading dim = n_rays."""
    cfg = eval_render_cfg(cfg)
    tile = cfg.render.ray_tile
    n = rays_o.shape[0]
    n_pad = (-n) % tile
    pad = lambda a: torch.cat([a, a.new_zeros((n_pad,) + a.shape[1:])]) if n_pad else a
    ro, rd = pad(rays_o), pad(rays_d)
    iv_p = RayIntervals(*[pad(x) for x in iv]) if iv is not None else None

    tiles = []
    for s in range(0, n + n_pad, tile):
        iv_t = RayIntervals(*[x[s:s + tile] for x in iv_p]) if iv_p is not None else None
        out = render_rays(model, ro[s:s + tile], rd[s:s + tile], bounds, cfg,
                          iv=iv_t, train=False)
        tiles.append(out[:N_RAY_FIELDS])  # per-sample extras dropped
    fields = [None if tiles[0][i] is None else torch.cat([t[i] for t in tiles])[:n]
              for i in range(N_RAY_FIELDS)]
    return RenderOut(*fields)
