"""Data-parallel training step over torch.distributed ranks (port of
`panopticnerf_tpu/parallel/step.py`).

Every rank draws the same global step from one identically seeded
generator (`train.step.draw_step`), builds the whole ray batch and its
intervals (kernel A2 on the whole batch, or the per-ray path of a fully
mixed batch), and renders its contiguous N / W rays with their draws
through the kernels of `model.pallas_mode`. The loss means are global (the
denominators summed over ranks before the division, `compute_losses`'s
reducer), `loss.backward()` gives the rank's share of the gradient, one
all-reduce of a flat buffer of every gradient sums the shares, and the
unchanged update (clip, lr, Adam, EMA) leaves bit-equal parameters on
every rank.

Unlike the JAX package's shard_map route, which folds the device index
into each shard's render key (`parallel/step.py:150` there), the ranks
slice one global set of draws: the W-rank step is the single-process step
on the same batch at any W, as JAX's GSPMD route is.
"""

from __future__ import annotations

import torch

from panopticnerf_tpu_torch.config import Config
from panopticnerf_tpu_torch.parallel.distributed import World
from panopticnerf_tpu_torch.train.step import RankShare, TrainState, make_train_step


def make_parallel_train_step(cfg: Config, model, world: World):
    """-> step(state, ds, view_ids, generator, draws=None) -> stats (the
    global stats, equal on every rank), as `make_train_step`'s. Raises
    ValueError, on every rank alike, unless data.n_rays divides by the
    world's size (the JAX engine trains single-device there; across
    processes that would be W diverging models)."""
    if not world.distributed:
        raise ValueError("make_parallel_train_step needs a distributed World "
                         "(maybe_init_distributed under torchrun)")
    n = cfg.data.n_rays
    if n % world.size:
        raise ValueError(f"data.n_rays={n} must be divisible by the world size {world.size}")
    per_rank = n // world.size

    @torch.no_grad()
    def reduce_grads(params) -> None:
        grads = [p.grad for p in params if p.grad is not None]
        flat = world.all_reduce_(torch.cat([g.reshape(-1) for g in grads]))
        offset = 0
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()

    share = RankShare(world.rank * per_rank, (world.rank + 1) * per_rank, world.all_reduce_,
                      reduce_grads)
    return make_train_step(cfg, model, share)


@torch.no_grad()
def broadcast_state(state: TrainState, generator: torch.Generator, world: World) -> None:
    """Rank 0's parameters and buffers, optimizer state, EMA and generator
    state, on every rank (after a build, a warm start or a restore)."""
    for t in state.model.state_dict().values():
        world.broadcast_(t)
    for group in state.optimizer.param_groups:  # Adam's moments and counts, once restored
        for p in group["params"]:
            for key, value in sorted(state.optimizer.state.get(p, {}).items()):
                if torch.is_tensor(value):
                    world.broadcast_(value)
    if state.ema is not None:
        for key in sorted(state.ema):
            world.broadcast_(state.ema[key])
    gen = generator.get_state()
    generator.set_state(world.broadcast_(gen))
