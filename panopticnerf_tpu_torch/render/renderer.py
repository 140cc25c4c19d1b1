"""Volume renderer (port of `panopticnerf_tpu/render/renderer.py`).

`render_rays` renders a ray batch: guided (or stratified) coarse depths ->
coarse field -> compositing -> inverse-CDF fine depths -> fine field ->
compositing, with the fixed semantic field composited K-factored. The
training branch (`train=True`) adds the stratified jitter (`render.perturb`)
and the density noise (`render.raw_noise_std`), keeps the coarse RenderOut
and the per-sample extras for the losses, and stops the gradient through
the coarse weights that place the fine samples. Its random numbers come
from a `torch.Generator` or, for replaying a reference's draws, from a
`RenderDraws`. The evaluation branch keeps the render.eval_keep_samples
best-weighted fine depths when that is set (`ops.sampling.topm_eval_select`).
`render_image_rays` renders a whole view as a loop over tiles of
`render.ray_tile` rays; `intersect_and_render` intersects first, and every
full-image render of the port goes through it (over the ranks of a
distributed world, `parallel/render.py`).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from panopticnerf_tpu_torch.config import Config
from panopticnerf_tpu_torch.ops import sampling
from panopticnerf_tpu_torch.ops.composite import composite
from panopticnerf_tpu_torch.ops.intersect import (
    Primitives,
    RayIntervals,
    fixed_map_from_weights,
    intersect_rays,
    labeled_containment,
    samples_in_intervals,
)


# RenderOut's leading per-ray fields (rgb .. inst_sem); the rest are extras.
N_RAY_FIELDS = 8


class SceneBounds(NamedTuple):
    """Scene normalisation applied before positional encoding."""

    center: torch.Tensor  # (3,)
    scale: torch.Tensor   # () world-to-unit multiplier


class RenderDraws(NamedTuple):
    """Pre-drawn random numbers of one training render (N rays).

    `coarse`: (N, S_in) uniforms of the guided coarse depths, the jitter and
    the no-hit fallback alike (or (N, S) of the stratified depths without
    primitives); `bg`: (N, S_bg) background jitter; `fine`: (N, n_importance)
    inverse-CDF jitter; `noise_coarse` / `noise_fine`: standard normals
    shaped like each level's sigma (only with render.raw_noise_std > 0).
    """

    coarse: Optional[torch.Tensor] = None
    bg: Optional[torch.Tensor] = None
    fine: Optional[torch.Tensor] = None
    noise_coarse: Optional[torch.Tensor] = None
    noise_fine: Optional[torch.Tensor] = None


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
                     iv: Optional[RayIntervals], num_classes: int, white_bkgd: bool,
                     noise_std: float = 0.0, noise: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None,
                     delta: Optional[torch.Tensor] = None):
    pts = rays_o[:, None, :] + rays_d[:, None, :] * z[..., None]     # (N, S, 3)
    pts = (pts - bounds.center) * bounds.scale
    sigma, rgb, sem = model(pts, rays_d[:, None, :], level=level)
    if noise_std > 0:
        # classic NeRF density-noise regulariser (reference raw_noise_std)
        if noise is None:
            noise = torch.randn(sigma.shape, generator=generator, device=sigma.device)
        sigma = sigma + noise_std * noise

    inside_iv = inside_lab = cnt = None
    if iv is not None:
        inside_iv = samples_in_intervals(z, iv)
        inside_lab, cnt = labeled_containment(z, iv)
    out = composite(sigma, rgb, z, sem_logits=sem, inside_intervals=inside_iv,
                    white_bkgd=white_bkgd, delta=delta)
    if iv is not None:
        out = out._replace(sem_fixed=fixed_map_from_weights(
            out.weights, inside_lab, cnt, iv, num_classes))
    return out, sem, inside_lab, cnt


def render_rays(model, rays_o, rays_d, bounds: SceneBounds, cfg: Config,
                iv: Optional[RayIntervals] = None, train: bool = True,
                generator: Optional[torch.Generator] = None,
                draws: Optional[RenderDraws] = None) -> RenderOut:
    """Render a batch of rays (N, 3) with the intervals `iv` (N, K).

    `model` is called as model(pts, viewdirs, level=...). With `train`, the
    random numbers come from `draws` where given, else from `generator`.
    """
    rc = cfg.render
    n = rays_o.shape[0]
    dev = rays_o.device
    num_classes = cfg.model.num_classes
    perturb = rc.perturb and train
    noise_std = rc.raw_noise_std if train else 0.0
    dr = draws if draws is not None else RenderDraws()

    if iv is not None and rc.use_primitives:
        z = sampling.guided_z(iv, rc.n_samples, rc.near, rc.far, perturb, rc.bg_sample_frac,
                              generator=generator, u_in=dr.coarse, u_bg=dr.bg)
    else:
        z = sampling.stratified_z(n, rc.n_samples, rc.near, rc.far, perturb, dev,
                                  generator=generator, u=dr.coarse)
    out_c, sem_c, lab_c, cnt_c = _composite_level(
        model, rays_o, rays_d, z, bounds, 0, iv, num_classes, rc.white_bkgd,
        noise_std, dr.noise_coarse, generator)

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
    w_interior = out_c.weights[:, 1:-1].detach()                # (N, S-2), no gradient
    z_fine = sampling.sample_pdf(z_mid, w_interior, rc.n_importance, perturb,
                                 generator=generator, u_fine=dr.fine)
    z_all = sampling.merge_z(z, z_fine)
    delta_f = None
    if not train and 0 < rc.eval_keep_samples < z_all.shape[1]:
        # forward-only keep-M: the fine field queries only the samples with
        # coarse-weight support, composited with the full set's deltas
        z_all, delta_f = sampling.topm_eval_select(z_all, z_mid, w_interior,
                                                   rc.eval_keep_samples)
    out_f, sem_f, lab_f, cnt_f = _composite_level(
        model, rays_o, rays_d, z_all, bounds, 1, iv, num_classes, rc.white_bkgd,
        noise_std, dr.noise_fine, generator, delta=delta_f)
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


def intersect_and_render(cfg: Config, model, rays_o, rays_d, prims: Optional[Primitives],
                         bounds: SceneBounds, world=None) -> RenderOut:
    """Interval intersection of the rays against one table (kernel A1 on a
    CUDA device: a failure raises, nothing falls back), then the tiled
    full-image render; with a distributed `world` (parallel.World), the
    tiles spread over its ranks (`render_image_rays_sharded`) and every
    rank returns the whole view. Evaluated views, trajectory frames and
    panoramas all render through here."""
    if world is not None and world.distributed:
        from panopticnerf_tpu_torch.parallel.render import render_image_rays_sharded

        return render_image_rays_sharded(model, rays_o, rays_d, bounds, cfg, world, prims)
    iv = None
    if cfg.render.use_primitives:
        iv = intersect_rays(rays_o, rays_d, prims, cfg.render.near, cfg.render.far,
                            cfg.data.max_intervals)
    return render_image_rays(model, rays_o, rays_d, bounds, cfg, iv=iv)
