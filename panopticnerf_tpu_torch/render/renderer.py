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
`render.ray_tile` rays (`render_tiles`, which the tile-sharded render of
`parallel/render.py` runs too); `intersect_and_render` intersects first,
and every full-image render of the port goes through it.

Spans (utils/profiling.py): `render.view` around `intersect_and_render`,
`render.intersect` inside it, and per tile and level
`render.sample.<level>` (the depths), `render.field.<level>` (the points
and the model) and `render.composite.<level>` (the containment, the
compositing, the fixed map); counters `render.rays` and
`render.rays_padded` (the zero rays that fill the last tile), and in the
evaluation branch `render.field.points` (every point a field evaluates),
`render.field.points_fused` (those kernel E evaluates),
`render.composite.rays` (every ray composited, per level),
`render.composite.rays_fused` (those kernel V composites),
`render.sample.rays` (every ray sampled, per level) and
`render.sample.rays_fused` (those kernel Z samples).

On a CUDA device without gradients the evaluation branch samples each level
with kernel Z (`ops/sampling_cuda.py`: the guided coarse depths in one
launch, the fine depths merged with them in another) and composites it with
kernel V (`ops/composite_cuda.py`: the weights, the maps, the instance mass
and the fixed map in one launch) where its inputs fit the kernels; training,
the CPU and other inputs run the plain ops (`ops/sampling.py`, the
stratified depths without primitives among them).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from panopticnerf_tpu_torch.config import Config
from panopticnerf_tpu_torch.models.eval_field import eval_field
from panopticnerf_tpu_torch.ops import sampling
from panopticnerf_tpu_torch.ops.composite import composite
from panopticnerf_tpu_torch.ops.composite_cuda import composite_cuda, takes as takes_composite
from panopticnerf_tpu_torch.ops.intersect import (
    Primitives,
    RayIntervals,
    fixed_map_from_weights,
    intersect_rays,
    labeled_containment,
    samples_in_intervals,
)
from panopticnerf_tpu_torch.ops.sampling_cuda import (
    fine_z_cuda,
    guided_z_cuda,
    takes_coarse,
    takes_fine,
)
from panopticnerf_tpu_torch.utils.profiling import count, span


# RenderOut's leading per-ray fields (rgb .. inst_sem); the rest are extras.
N_RAY_FIELDS = 8
LEVELS = ("coarse", "fine")


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


def _fused_composite_takes(sigma, sem, iv: Optional[RayIntervals], num_classes: int) -> bool:
    """Whether an evaluation level composites through kernel V
    (`ops/composite_cuda.py`): on a CUDA device, without gradients, at the
    shapes V takes. The choice reads only its inputs."""
    if sigma.device.type != "cuda" or torch.is_grad_enabled():
        return False
    k = 0 if iv is None else iv.t_in.shape[-1]
    classes = max(0 if sem is None else sem.shape[-1], num_classes if iv is not None else 0)
    return takes_composite(sigma.shape[-1], k, classes)


def _fused_sampling_takes(t: torch.Tensor, perturb: bool, shapes_taken: bool) -> bool:
    """Whether an evaluation level samples through kernel Z
    (`ops/sampling_cuda.py`): its input `t` on a CUDA device, gradients off,
    no jitter, at shapes Z takes (`shapes_taken`). The choice reads only its
    inputs."""
    return (t.device.type == "cuda" and not torch.is_grad_enabled() and not perturb
            and shapes_taken)


def _composite_level(model, rays_o, rays_d, z, bounds: SceneBounds, level: int,
                     iv: Optional[RayIntervals], num_classes: int, white_bkgd: bool,
                     noise_std: float = 0.0, noise: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None,
                     delta: Optional[torch.Tensor] = None, evaluate: bool = False):
    with span(f"render.field.{LEVELS[level]}"):
        pts = rays_o[:, None, :] + rays_d[:, None, :] * z[..., None]     # (N, S, 3)
        pts = (pts - bounds.center) * bounds.scale
        if evaluate:
            count("render.field.points", z.numel())
        sigma, rgb, sem = model(pts, rays_d[:, None, :], level=level)
        if noise_std > 0:
            # classic NeRF density-noise regulariser (reference raw_noise_std)
            if noise is None:
                noise = torch.randn(sigma.shape, generator=generator, device=sigma.device)
            sigma = sigma + noise_std * noise

    with span(f"render.composite.{LEVELS[level]}"):
        if evaluate:
            count("render.composite.rays", z.shape[0])
            if _fused_composite_takes(sigma, sem, iv, num_classes):
                count("render.composite.rays_fused", z.shape[0])
                dense = lambda t: None if t is None else t.contiguous()
                iv_d = None if iv is None else RayIntervals(*map(dense, iv))
                out = composite_cuda(dense(sigma), dense(rgb), dense(z), sem_logits=dense(sem),
                                     delta=dense(delta), iv=iv_d, num_classes=num_classes,
                                     white_bkgd=white_bkgd)
                return out, sem, None, None
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
    Without `train` and without gradients, on a CUDA device, the fields
    whose shape kernel E takes evaluate through it (`models.eval_field`),
    each level samples through kernel Z and composites through kernel V
    where they take the level's inputs; the per-sample extras
    `sample_inside_k` and `sample_cnt` are then None (only the training loss
    reads them).
    """
    rc = cfg.render
    n = rays_o.shape[0]
    dev = rays_o.device
    if not train:
        model = eval_field(model, cfg.model, dev)
    num_classes = cfg.model.num_classes
    perturb = rc.perturb and train
    noise_std = rc.raw_noise_std if train else 0.0
    dr = draws if draws is not None else RenderDraws()

    evaluate = not train
    with span("render.sample.coarse"):
        if evaluate:
            count("render.sample.rays", n)
        if iv is not None and rc.use_primitives:
            split = sampling.guided_split(rc.n_samples, rc.bg_sample_frac)
            if evaluate and _fused_sampling_takes(
                    iv.t_in, perturb, takes_coarse(iv.t_in.shape[-1], *split)):
                count("render.sample.rays_fused", n)
                dense = RayIntervals(*[t.contiguous() for t in iv])
                z = guided_z_cuda(dense, rc.n_samples, rc.near, rc.far, rc.bg_sample_frac)
            else:
                z = sampling.guided_z(iv, rc.n_samples, rc.near, rc.far, perturb,
                                      rc.bg_sample_frac, generator=generator, u_in=dr.coarse,
                                      u_bg=dr.bg)
        else:
            z = sampling.stratified_z(n, rc.n_samples, rc.near, rc.far, perturb, dev,
                                      generator=generator, u=dr.coarse)
    out_c, sem_c, lab_c, cnt_c = _composite_level(
        model, rays_o, rays_d, z, bounds, 0, iv, num_classes, rc.white_bkgd,
        noise_std, dr.noise_coarse, generator, evaluate=evaluate)

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
    with span("render.sample.fine"):
        if evaluate:
            count("render.sample.rays", n)
        # forward-only keep-M: the fine field queries only the samples with
        # coarse-weight support, composited with the full set's deltas
        keep = evaluate and 0 < rc.eval_keep_samples < z.shape[1] + rc.n_importance
        fused = evaluate and _fused_sampling_takes(
            z, perturb, takes_fine(z.shape[1], rc.n_importance))
        if fused:
            count("render.sample.rays_fused", n)
            z_all = fine_z_cuda(z.contiguous(), out_c.weights.contiguous(), rc.n_importance)
        if keep or not fused:
            z_mid = 0.5 * (z[:, 1:] + z[:, :-1])                        # (N, S-1)
            w_interior = out_c.weights[:, 1:-1].detach()                # (N, S-2), no gradient
        if not fused:
            z_fine = sampling.sample_pdf(z_mid, w_interior, rc.n_importance, perturb,
                                         generator=generator, u_fine=dr.fine)
            z_all = sampling.merge_z(z, z_fine)
        delta_f = None
        if keep:
            z_all, delta_f = sampling.topm_eval_select(z_all, z_mid, w_interior,
                                                       rc.eval_keep_samples)
    out_f, sem_f, lab_f, cnt_f = _composite_level(
        model, rays_o, rays_d, z_all, bounds, 1, iv, num_classes, rc.white_bkgd,
        noise_std, dr.noise_fine, generator, delta=delta_f, evaluate=evaluate)
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
def render_tiles(model, rays_o, rays_d, bounds: SceneBounds, cfg: Config,
                 iv: Optional[RayIntervals]) -> list:
    """The evaluation render of rays (and intervals) whose count is a
    multiple of `render.ray_tile`, tile by tile, with `cfg` the
    `eval_render_cfg` of the view: the evaluation field is bound once for
    all the tiles (`eval_field` gives a bound field back as it is); -> the
    N_RAY_FIELDS per-ray fields (None where the render gives none),
    concatenated over the tiles."""
    tile = cfg.render.ray_tile
    model = eval_field(model, cfg.model, rays_o.device)
    tiles = []
    for s in range(0, rays_o.shape[0], tile):
        iv_t = RayIntervals(*[x[s:s + tile] for x in iv]) if iv is not None else None
        out = render_rays(model, rays_o[s:s + tile], rays_d[s:s + tile], bounds, cfg,
                          iv=iv_t, train=False)
        tiles.append(out[:N_RAY_FIELDS])  # per-sample extras dropped
    return [None if tiles[0][i] is None else torch.cat([t[i] for t in tiles])
            for i in range(N_RAY_FIELDS)]


@torch.no_grad()
def render_image_rays(model, rays_o, rays_d, bounds: SceneBounds, cfg: Config,
                      iv: Optional[RayIntervals] = None) -> RenderOut:
    """Full-image render: pad rays (and intervals) with zeros to a tile
    multiple, render tile by tile, drop the per-sample extras and the
    padding. Returns a RenderOut with leading dim = n_rays."""
    cfg = eval_render_cfg(cfg)
    n = rays_o.shape[0]
    n_pad = (-n) % cfg.render.ray_tile
    count("render.rays", n)
    count("render.rays_padded", n_pad)
    pad = lambda a: torch.cat([a, a.new_zeros((n_pad,) + a.shape[1:])]) if n_pad else a
    iv_p = RayIntervals(*[pad(x) for x in iv]) if iv is not None else None
    fields = render_tiles(model, pad(rays_o), pad(rays_d), bounds, cfg, iv_p)
    return RenderOut(*[None if f is None else f[:n] for f in fields])


def intersect_and_render(cfg: Config, model, rays_o, rays_d, prims: Optional[Primitives],
                         bounds: SceneBounds, world=None) -> RenderOut:
    """Interval intersection of the rays against one table (kernel A1 on a
    CUDA device: a failure raises, nothing falls back), then the tiled
    full-image render; with a distributed `world` (parallel.World), the
    tiles spread over its ranks (`render_image_rays_sharded`) and every
    rank returns the whole view. Evaluated views, trajectory frames and
    panoramas all render through here."""
    with span("render.view"):
        if world is not None and world.distributed:
            from panopticnerf_tpu_torch.parallel.render import render_image_rays_sharded

            return render_image_rays_sharded(model, rays_o, rays_d, bounds, cfg, world, prims)
        iv = None
        if cfg.render.use_primitives:
            with span("render.intersect"):
                iv = intersect_rays(rays_o, rays_d, prims, cfg.render.near, cfg.render.far,
                                    cfg.data.max_intervals)
        return render_image_rays(model, rays_o, rays_d, bounds, cfg, iv=iv)
