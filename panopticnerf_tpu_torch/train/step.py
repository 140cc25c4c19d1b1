"""Training step, optimizer and schedules (port of `panopticnerf_tpu/train/step.py`).

`make_train_step(cfg, model)` returns `step(state, ds, view_ids, generator,
draws=None) -> stats`: the step's random numbers (`draw_step`, all drawn up
front) -> ray batch -> intervals (grouped batches through
kernel A2 on the card, fully mixed batches, data.views_per_batch 0, ray by
ray in plain PyTorch) -> training render (with `model.use_pallas`, both
8x256 fields through the kernels of `model.pallas_mode`: B / B' for the trunk in
"trunk", C / C' for the whole field in "field", C' as the backward of a
plain forward in "hybrid") -> losses -> backward -> Adam, in place on
`state`. A data-parallel rank (`parallel/step.py`) passes a `RankShare`:
it renders its rows of the whole batch, its losses divide by the global
denominators, and its gradients are summed over the ranks before the
update.
The optimizer follows optax's definitions, which the reference uses:
- `exponential_decay`, not staircased: the update at count t uses
  lr * rate ** (t / max_steps);
- Adam with b1 0.9, b2 0.999, eps 1e-8 (eps_root 0), or AdamW when
  train.weight_decay > 0;
- `clip_by_global_norm` when train.grad_clip > 0;
- an EMA of the params with warmup min(decay, (1 + t) / (10 + t)).
Stats are 0-dim device tensors; the step never reads them back.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from panopticnerf_tpu_torch.config import Config
from panopticnerf_tpu_torch.data.dataset import (
    BatchDraws,
    DeviceDataset,
    batch_intervals,
    sample_ray_batch,
)
from panopticnerf_tpu_torch.models.nerf import PanopticNeRF
from panopticnerf_tpu_torch.ops.sampling import guided_split
from panopticnerf_tpu_torch.render.renderer import RenderDraws, SceneBounds, render_rays
from panopticnerf_tpu_torch.train.loss import compute_losses

ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


@dataclasses.dataclass
class TrainState:
    """The model (its float32 parameters are the params), the optimizer,
    the number of updates taken, and the EMA of the params (None when
    train.ema_decay is 0)."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0
    ema: Optional[dict] = None


@dataclasses.dataclass
class StepDraws:
    """Every random number of one step, for replaying a reference's draws."""

    batch: BatchDraws
    render: RenderDraws


def lr_at(cfg: Config, count: int) -> float:
    """optax.exponential_decay(lr, max_steps, rate) at `count`."""
    tc = cfg.train
    rate = tc.lr_decay_rate if tc.lr_decay_rate > 0 else 1.0
    return tc.lr * rate ** (count / max(tc.max_steps, 1))


def make_optimizer(cfg: Config, params) -> torch.optim.Optimizer:
    tc = cfg.train
    if tc.weight_decay > 0:
        return torch.optim.AdamW(params, lr=lr_at(cfg, 0), betas=ADAM_BETAS, eps=ADAM_EPS,
                                 weight_decay=tc.weight_decay, foreach=True)
    return torch.optim.Adam(params, lr=lr_at(cfg, 0), betas=ADAM_BETAS, eps=ADAM_EPS,
                            foreach=True)


def make_train_state(cfg: Config, model: torch.nn.Module) -> TrainState:
    ema = None
    if cfg.train.ema_decay > 0:
        ema = {k: v.detach().clone() for k, v in model.state_dict().items()}
    return TrainState(model=model, optimizer=make_optimizer(cfg, model.parameters()), ema=ema)


@torch.no_grad()
def ema_update(state: TrainState, decay: float) -> None:
    """One warmup-corrected EMA step (t = the post-update step count)."""
    if state.ema is None:
        return
    t = float(state.step)
    d = min(decay, (1.0 + t) / (10.0 + t))
    for k, p in state.model.state_dict().items():
        state.ema[k].mul_(d).add_(p, alpha=1.0 - d)


def eval_state_dict(state: TrainState) -> dict:
    """Weights every evaluation renders with (the EMA when tracked)."""
    return state.model.state_dict() if state.ema is None else state.ema


def global_norm(tensors) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(t.float() ** 2) for t in tensors))


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float, g_norm: torch.Tensor) -> None:
    """optax.clip_by_global_norm, in place: g / |g| * max_norm where
    |g| >= max_norm."""
    scale = torch.where(g_norm < max_norm, torch.ones_like(g_norm), max_norm / g_norm)
    torch._foreach_mul_(grads, scale)


def weight_th_schedule(cfg: Config, step: int) -> float:
    """Pseudo-filter threshold at `step`: linear anneal from loss.weight_th
    to loss.weight_th_final over [weight_th_anneal_start * max_steps,
    max_steps] (the static loss.weight_th when weight_th_final < 0)."""
    lc = cfg.loss
    if lc.weight_th_final < 0:
        return lc.weight_th
    a0 = int(lc.weight_th_anneal_start * cfg.train.max_steps)
    frac = float(np.clip((step - a0) / max(cfg.train.max_steps - a0, 1), 0.0, 1.0))
    return lc.weight_th + frac * (lc.weight_th_final - lc.weight_th)


def apply_gradients(state: TrainState, cfg: Config) -> torch.Tensor:
    """The update of the step from the params' .grad: global norm, clip,
    lr(t), Adam / AdamW, step count, EMA. Returns the unclipped global norm."""
    params = [p for group in state.optimizer.param_groups for p in group["params"]]
    grads = [p.grad for p in params if p.grad is not None]
    g_norm = global_norm(grads)
    if cfg.train.grad_clip > 0:
        clip_by_global_norm(grads, cfg.train.grad_clip, g_norm)
    for group in state.optimizer.param_groups:
        group["lr"] = lr_at(cfg, state.step)
    state.optimizer.step()
    state.step += 1
    ema_update(state, cfg.train.ema_decay)
    return g_norm


def resolve_train_model(cfg: Config, model: PanopticNeRF):
    """The field the step renders with: the fused adapter in
    model.pallas_mode when model.use_pallas (kernels B / B', C / C' or C'
    on the card), else the model itself (the flax-placement plain field)."""
    if cfg.model.use_pallas:
        from panopticnerf_tpu_torch.models.fused_apply import FusedTrainAdapter

        return FusedTrainAdapter(model, cfg.model, mode=cfg.model.pallas_mode)
    return model


def draw_step(cfg: Config, n_views: int, hw, generator: Optional[torch.Generator],
              device) -> StepDraws:
    """Every random number of one training step of the whole batch, drawn
    from `generator` with the calls, shapes and order in which
    `sample_ray_batch` and `render_rays` draw them: the batch's group (or
    per-ray view) positions and pixel columns / rows, then the coarse
    uniforms (the guided in-interval ones, then the background ones; the
    stratified ones without primitives), the coarse density noise, the
    inverse-CDF uniforms and the fine density noise, each only where
    the config draws it (render.perturb, render.raw_noise_std,
    render.n_importance)."""
    n, g, rc = cfg.data.n_rays, cfg.data.views_per_batch, cfg.render
    h, w = hw
    randint = lambda high, size: torch.randint(0, high, (size,), generator=generator,
                                               device=device)
    rand = lambda *shape: torch.rand(shape, generator=generator, device=device)
    randn = lambda *shape: torch.randn(shape, generator=generator, device=device)
    batch = BatchDraws(randint(n_views, g if g > 0 else n), randint(w, n), randint(h, n))
    coarse = bg = fine = noise_coarse = noise_fine = None
    if rc.perturb:
        if rc.use_primitives:
            s_in, s_bg = guided_split(rc.n_samples, rc.bg_sample_frac)
            coarse = rand(n, s_in)
            bg = rand(n, s_bg) if s_bg > 0 else None
        else:
            coarse = rand(n, rc.n_samples)
    if rc.raw_noise_std > 0:
        noise_coarse = randn(n, rc.n_samples)
    if rc.n_importance > 0:
        fine = rand(n, rc.n_importance) if rc.perturb else None
        if rc.raw_noise_std > 0:
            noise_fine = randn(n, rc.n_samples + rc.n_importance)
    return StepDraws(batch, RenderDraws(coarse, bg, fine, noise_coarse, noise_fine))


class RankShare(NamedTuple):
    """One rank's part of a data-parallel step (parallel/step.py): its rows
    [start, stop) of the global batch, the SUM over ranks that makes the
    loss means global, and the in-place SUM of the gradients."""

    start: int
    stop: int
    reducer: Callable[[torch.Tensor], torch.Tensor]
    reduce_grads: Callable[[list], None]


def _rows(t, start: int, stop: int):
    """A NamedTuple of (N, ...) tensors (None fields kept) cut to rows [start, stop)."""
    return type(t)(*[None if x is None else x[start:stop] for x in t])


def make_train_step(cfg: Config, model: PanopticNeRF, share: Optional[RankShare] = None):
    """-> step(state, ds, view_ids, generator, draws=None) -> stats dict.

    `view_ids` (T,) is the pool of training views; `generator` (on the
    dataset's device) draws the step's random numbers (`draw_step`) unless
    `draws` (a StepDraws) supplies them. With `share` (a data-parallel
    rank), the batch, its intervals and its draws are the whole batch's,
    and the rank renders its rows of them.
    """
    field = resolve_train_model(cfg, model)
    g = cfg.data.views_per_batch
    if g > 0 and cfg.data.n_rays % g:
        raise ValueError(f"data.n_rays={cfg.data.n_rays} must be divisible by "
                         f"data.views_per_batch={g}")
    sem_gate = cfg.train.pretrain == "nerf"
    agree_start_step = int(cfg.loss.agree_start * cfg.train.max_steps)

    def step(state: TrainState, ds: DeviceDataset, view_ids: torch.Tensor,
             generator: Optional[torch.Generator] = None,
             draws: Optional[StepDraws] = None) -> dict:
        t = state.step
        if draws is None:
            draws = draw_step(cfg, view_ids.shape[0], ds.images.shape[1:3], generator,
                              ds.images.device)
        batch = sample_ray_batch(ds, view_ids, cfg.data.n_rays, g, draws=draws.batch)
        iv = None
        if cfg.render.use_primitives:
            iv = batch_intervals(ds, batch, cfg.render.near, cfg.render.far,
                                 cfg.data.max_intervals, g,
                                 use_kernel=cfg.render.use_pallas_intersect)
        render_draws = draws.render
        if share is not None:
            cut = lambda x: None if x is None else _rows(x, share.start, share.stop)
            batch, iv, render_draws = cut(batch), cut(iv), cut(render_draws)
        sem_scale = 0.0 if sem_gate and t < cfg.train.pretrain_steps else 1.0
        agree_on = 1.0 if cfg.loss.agree_filter and t >= agree_start_step else 0.0
        out = render_rays(field, batch.rays_o, batch.rays_d,
                          SceneBounds(ds.bounds_center, ds.bounds_scale), cfg, iv=iv,
                          train=True, draws=render_draws)
        loss, stats = compute_losses(out, batch, cfg, sem_scale=sem_scale,
                                     agree_on=agree_on, weight_th=weight_th_schedule(cfg, t),
                                     reducer=share.reducer if share is not None else None)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        if share is not None:
            share.reduce_grads([p for group in state.optimizer.param_groups
                                for p in group["params"]])
        g_norm = apply_gradients(state, cfg)
        stats = {k: v.detach() for k, v in stats.items()}
        stats["grad_norm"] = g_norm.detach()
        return stats

    return step
