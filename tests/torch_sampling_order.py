"""Kernel Z's order of sums, and Z against the plain sampling ops (torch
only, so that the card tests and `chip_smoke.py` share them).

Z (csrc/sample.cu) computes what ops/sampling.py computes without jitter,
with only the order of three sums changed: the cdf of the union segments,
the sum of the weights and the cdf of the pdf. `KernelZOrder` is `torch` as
ops/sampling.py sees it with those sums taken in Z's order: set as that
module's `torch`, the plain ops equal Z bit for bit. `against_plain` holds Z
against the plain ops as they are, under the ceilings the sums' order
allows (derived in its docstring)."""

import torch

EPS = 2.0 ** -24


class KernelZOrder:
    """`torch`, with a cumsum in index order (one rounding a step) and
    torch.sum over the last dimension per lane over a stride of 32 (lane l
    adds columns l, l + 32, ...), then a butterfly over the 32 lanes' sums."""

    def __getattr__(self, name):
        return getattr(torch, name)

    @staticmethod
    def cumsum(x, dim):
        assert dim in (-1, x.dim() - 1)
        cols = [x[..., 0]]
        for i in range(1, x.shape[-1]):
            cols.append(cols[-1] + x[..., i])
        return torch.stack(cols, -1)

    @staticmethod
    def sum(x, dim, keepdim=False):
        assert dim in (-1, 1) and x.dim() == 2
        lanes = torch.zeros(x.shape[0], 32, dtype=x.dtype, device=x.device)
        for r0 in range(0, x.shape[1], 32):
            chunk = x[:, r0:r0 + 32]
            lanes[:, :chunk.shape[1]] = lanes[:, :chunk.shape[1]] + chunk
        idx = torch.arange(32, device=x.device)
        for d in (16, 8, 4, 2, 1):
            lanes = lanes + lanes[:, idx ^ d]
        return lanes[:, :1] if keepdim else lanes[:, 0]


def against_plain(iv, s, bg_frac, weights, m, near, far, coarse=None, fine=None):
    """Z's two passes (or the given `coarse` (N, S) and `fine` (N, S + m)
    outputs, as Z computed them on these inputs) against the plain ops on
    one tile: the guided coarse depths of the intervals `iv`, then the fine
    depths of those plain coarse depths and `weights` (N, S).

    The ceilings: a sum of n non-negative terms moves by at most (n - 1)
    EPS of itself in another order, so between two orders a coarse cdf
    entry or the union length moves by 2 (K - 1) EPS far at most, a
    position u = frac total as much, and a depth seg_in + (u - cdf_prev) by
    (4 K + 4) EPS far with its roundings. In the fine pass the sum and a cdf
    entry together move a cdf entry by delta = (4 B + 4) EPS (B = S - 2
    bins, cdf <= 1), so frac = (u - cdf_lo) / denom by 3 delta / denom and a
    depth by that times its bin's width, plus 4 EPS far of roundings. A
    merged row moves no further than its largest depth (sorting is
    1-Lipschitz). Where the two orders place a position in another segment
    or bin, or decide the 1e-5 rule otherwise, the depth can jump by a gap
    or a bin: such rays ("flips") are found by running both orders' searches
    and are left out of the ceilings, and counted.

    -> {"coarse_gap": the largest |dz| on rays without a flip,
    "coarse_ceiling", "coarse_flips", "coarse_gap_all", "fine_gap", "fine_over":
    the largest excess of a ray's |dz| over its ceiling (<= 0: within),
    "fine_ceiling_min", "fine_ceiling_max", "fine_flips", "fine_gap_all"}."""
    from panopticnerf_tpu_torch.ops import sampling
    from panopticnerf_tpu_torch.ops.sampling_cuda import fine_z_cuda, guided_z_cuda

    n, k = iv.t_in.shape
    dev = iv.t_in.device
    zo = KernelZOrder()
    s_in, _ = sampling.guided_split(s, bg_frac)
    got = guided_z_cuda(iv, s, near, far, bg_frac) if coarse is None else coarse
    ref = sampling.guided_z(iv, s, near, far, False, bg_frac)
    ceil_c = (4 * k + 4) * EPS * far
    _, seg_len = sampling._union_segments(iv)
    frac = sampling._linspace01(s_in + 1, dev)[:-1] + 0.5 / s_in

    def segment(cdf):
        u = (frac[None] * cdf[:, -1:]).contiguous()
        return torch.searchsorted(cdf.contiguous(), u, right=True).clamp(0, k - 1)

    flips = (segment(torch.cumsum(seg_len, -1)) != segment(zo.cumsum(seg_len, -1))).any(1)
    gap_c = (got - ref).abs().max(1).values

    z = ref
    got_f = fine_z_cuda(z, weights, m) if fine is None else fine
    z_mid = 0.5 * (z[:, 1:] + z[:, :-1])
    ref_f = sampling.merge_z(z, sampling.sample_pdf(z_mid, weights[:, 1:-1], m, False))
    b = s - 2
    delta = (4 * b + 4) * EPS
    wp = weights[:, 1:-1] + 1e-5
    u_f = sampling._linspace01(m + 2, dev)[1:-1].expand(n, m).contiguous()

    def placement(total, cumsum):
        pdf = wp / total
        cdf = torch.cat([torch.zeros_like(pdf[:, :1]), cumsum(pdf, -1)], -1).contiguous()
        inds = torch.searchsorted(cdf, u_f, right=True)
        below, above = (inds - 1).clamp(0, b - 1), inds.clamp(1, b)
        step = cdf.gather(1, above) - cdf.gather(1, below)
        return inds, step < 1e-5, step, below, above

    inds, rule, step, below, above = placement(wp.sum(-1, keepdim=True), torch.cumsum)
    inds_z, rule_z, *_ = placement(zo.sum(wp, -1, keepdim=True), zo.cumsum)
    denom = torch.where(rule, 1.0, step)
    width = (z_mid.gather(1, above) - z_mid.gather(1, below)).abs()
    bound = (4 * EPS * far + width * 3 * delta / denom).max(1).values
    flips_f = ((inds != inds_z) | (rule != rule_z)).any(1)
    gap_f = (got_f - ref_f).abs().max(1).values
    keep_c, keep_f = ~flips, ~flips_f
    return {"coarse_gap": float(gap_c[keep_c].max()), "coarse_ceiling": ceil_c,
            "coarse_flips": int(flips.sum()), "coarse_gap_all": float(gap_c.max()),
            "fine_gap": float(gap_f[keep_f].max()),
            "fine_over": float((gap_f - bound)[keep_f].max()),
            "fine_ceiling_min": float(bound.min()), "fine_ceiling_max": float(bound.max()),
            "fine_flips": int(flips_f.sum()), "fine_gap_all": float(gap_f.max())}
