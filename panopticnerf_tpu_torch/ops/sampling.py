"""Samplers: stratified, primitive-interval-guided, and hierarchical (inverse-CDF).

Port of `panopticnerf_tpu/ops/sampling.py`, written with sort, gather and
searchsorted where the reference used compare-count and one-hot forms; the
tie rules are the reference's:
- `merge_sorted` is a stable merge that puts `a` ahead of equal `b`;
- interval / bin selection counts `u >= cdf` (searchsorted right).

Random draws come from an explicit `torch.Generator` (only with
`perturb`); the evaluation path is deterministic and draws nothing.
"""

from __future__ import annotations

from typing import Optional

import torch

from panopticnerf_tpu_torch.ops.intersect import RayIntervals


def _linspace01(num: int, device) -> torch.Tensor:
    """num points on [0, 1] as i / (num - 1), each correctly rounded to
    float32 (the reference's values; torch.linspace can differ by an ulp)."""
    return torch.arange(num, dtype=torch.float32, device=device) / (num - 1)


def _uniform(n: int, s: int, generator: Optional[torch.Generator], device):
    return torch.rand((n, s), generator=generator, device=device)


def stratified_z(n_rays: int, n_samples: int, near, far, perturb: bool,
                 device, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Uniform stratified depths in [near, far]. near/far: scalar or (N, 1)."""
    t = _linspace01(n_samples + 1, device)[:-1]                # (S,) bin starts
    if perturb:
        u = _uniform(n_rays, n_samples, generator, device)
    else:
        u = torch.full((n_rays, n_samples), 0.5, device=device)
    frac = t[None, :] + u / n_samples                          # (N, S) in [0, 1)
    return near + (far - near) * frac


def merge_sorted(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Stable merge of two row-sorted arrays (N, A) + (N, B) -> (N, A+B);
    equal values keep `a` ahead of `b`."""
    return torch.cat([a, b], dim=1).sort(dim=1, stable=True).values


def _union_segments(iv: RayIntervals):
    """Disjoint ascending segments covering the union of the entry-sorted
    (possibly overlapping) intervals: seg_in_k = max(t_in_k, prior end),
    seg_len_k = max(0, t_out_k - seg_in_k)."""
    end = torch.where(iv.mask, iv.t_out, -1e9)
    prev_end = torch.cat([torch.full_like(end[:, :1], -1e9),
                          torch.cummax(end, dim=1).values[:, :-1]], dim=1)
    seg_in = torch.maximum(iv.t_in, prev_end)
    seg_len = torch.clamp(torch.where(iv.mask, iv.t_out - seg_in, 0.0), min=0.0)
    return seg_in, seg_len


def guided_z(iv: RayIntervals, n_samples: int, near: float, far: float,
             perturb: bool, bg_frac: float = 0.25,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Stratified samples inside the union of a ray's intervals (+ background).

    ceil((1-bg_frac)*S) samples go over the union arc length by inverse CDF;
    the rest are stratified over [near, far]. Rays that hit nothing fall
    back to full-range stratified samples. Output (N, S), sorted.
    """
    n = iv.t_in.shape[0]
    dev = iv.t_in.device
    s_bg = max(int(round(n_samples * bg_frac)), 1) if bg_frac > 0 else 0
    s_in = n_samples - s_bg

    seg_in, seg_len = _union_segments(iv)                      # (N, K)
    cdf = torch.cumsum(seg_len, dim=-1)
    total = cdf[:, -1:]
    any_hit = total[:, 0] > 1e-8

    base = _linspace01(s_in + 1, dev)[:-1][None, :]            # (1, S_in)
    if perturb:
        jitter = _uniform(n, s_in, generator, dev) / s_in
    else:
        jitter = 0.5 / s_in
    u = (base + jitter) * total                                # (N, S_in)

    # Segment of each u: the count of cdf entries <= u, clipped.
    k = seg_len.shape[-1]
    idx = torch.searchsorted(cdf, u, right=True).clamp(0, k - 1)
    cdf_prev = torch.cat([torch.zeros_like(cdf[:, :1]), cdf[:, :-1]], dim=-1)
    z_in = torch.gather(seg_in, 1, idx) + (u - torch.gather(cdf_prev, 1, idx))

    z_fallback = stratified_z(n, s_in, near, far, perturb, dev, generator)
    z_in = torch.where(any_hit[:, None], z_in, z_fallback)
    if s_bg > 0:
        z_bg = stratified_z(n, s_bg, near, far, perturb, dev, generator)
        return merge_sorted(z_in, z_bg)
    return z_in


def sample_pdf(bins: torch.Tensor, weights: torch.Tensor, n_importance: int,
               perturb: bool, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Hierarchical fine sampling: inverse CDF over coarse weights.

    bins (N, B+1) depth bin edges; weights (N, B) unnormalised mass per bin.
    Returns (N, n_importance) depths, monotone in u.
    """
    n, b = weights.shape
    dev = weights.device
    w = weights + 1e-5
    pdf = w / torch.sum(w, dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], dim=-1)  # (N, B+1)

    if perturb:
        base = _linspace01(n_importance + 1, dev)[:-1]
        u = base[None] + _uniform(n, n_importance, generator, dev) / n_importance
    else:
        u = _linspace01(n_importance + 2, dev)[1:-1]
        u = u[None].expand(n, n_importance).contiguous()

    inds = torch.searchsorted(cdf, u, right=True)             # #{cdf <= u}
    below = torch.clamp(inds - 1, 0, b - 1)
    above = torch.clamp(inds, 1, b)
    cdf_lo = torch.gather(cdf, 1, below)
    cdf_hi = torch.gather(cdf, 1, above)
    z_lo = torch.gather(bins, 1, below)
    z_hi = torch.gather(bins, 1, above)

    denom = torch.where(cdf_hi - cdf_lo < 1e-5, 1.0, cdf_hi - cdf_lo)
    frac = (u - cdf_lo) / denom
    return z_lo + frac * (z_hi - z_lo)


def merge_z(z_coarse: torch.Tensor, z_fine: torch.Tensor) -> torch.Tensor:
    """Sorted union of coarse + fine depths: (N, Sc+Sf)."""
    return merge_sorted(z_coarse, z_fine)
