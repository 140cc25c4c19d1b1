"""Alpha compositing (port of `panopticnerf_tpu/ops/composite.py`):
alpha = 1 - exp(-softplus(sigma) * delta), transmittance-weighted sums of
rgb / depth / learned semantic logits / per-interval instance mass."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class CompositeOut(NamedTuple):
    rgb: torch.Tensor                    # (N, 3)
    depth: torch.Tensor                  # (N,)
    acc: torch.Tensor                    # (N,) total opacity
    weights: torch.Tensor                # (N, S)
    sem_logits: Optional[torch.Tensor]   # (N, C) composited learned logits
    sem_fixed: Optional[torch.Tensor]    # (N, C) composited fixed distribution
    inst_mass: Optional[torch.Tensor]    # (N, K) mass per kept interval


def compute_weights(sigma: torch.Tensor, z: torch.Tensor, last_delta: float = 1e10,
                    delta: Optional[torch.Tensor] = None) -> torch.Tensor:
    """w_i = alpha_i * prod_{j<i} (1 - alpha_j).

    sigma (N, S) raw density (softplus applied here); z (N, S) sorted depths.
    The last sample gets `last_delta`, so any positive terminal density
    saturates. The exclusive transmittance is exp(-cumsum(tau)) in log space.
    """
    if delta is None:
        delta = torch.cat([torch.diff(z, dim=-1),
                           torch.full_like(z[:, :1], last_delta)], dim=-1)
    density = torch.logaddexp(sigma, torch.zeros_like(sigma))  # softplus
    tau = density * delta
    alpha = 1.0 - torch.exp(-tau)
    log_trans = -torch.cumsum(tau, dim=-1)
    trans = torch.exp(torch.cat([torch.zeros_like(log_trans[:, :1]),
                                 log_trans[:, :-1]], dim=-1))
    return alpha * trans


def composite(sigma: torch.Tensor, rgb: torch.Tensor, z: torch.Tensor,
              sem_logits: Optional[torch.Tensor] = None,
              inside_intervals: Optional[torch.Tensor] = None,
              white_bkgd: bool = False,
              delta: Optional[torch.Tensor] = None) -> CompositeOut:
    """sigma (N, S); rgb (N, S, 3); z (N, S) sorted; sem_logits (N, S, C);
    inside_intervals (N, S, K) bool containment (for the instance mass).
    The fixed field is composited K-factored by the caller
    (ops.intersect.fixed_map_from_weights)."""
    w = compute_weights(sigma, z, delta=delta)
    wsum = lambda field: torch.sum(w[..., None] * field, dim=1)
    rgb_map = wsum(rgb)
    acc = torch.sum(w, dim=-1)
    if white_bkgd:
        rgb_map = rgb_map + (1.0 - acc[:, None])
    return CompositeOut(
        rgb=rgb_map,
        depth=torch.sum(w * z, dim=-1),
        acc=acc,
        weights=w,
        sem_logits=None if sem_logits is None else wsum(sem_logits),
        sem_fixed=None,
        inst_mass=(None if inside_intervals is None
                   else wsum(inside_intervals.to(w.dtype))),
    )
