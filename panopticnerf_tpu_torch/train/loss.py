"""PanopticNeRF loss stack (port of `panopticnerf_tpu/train/loss.py`).

L_rgb (fine + coarse MSE) + sparse-depth L1 + 2D CE of the fixed semantic
rendering + 2D CE of the learned semantic rendering vs the filtered
pseudo-labels + per-sample 3D CE inside primitives, weighted per cfg. The
filters are the reference's: the consistency filter (`pseudo_filter`, the
annealable `weight_th`, `rel_filter_ratio` / `rel_filter_total`), the
empty-sky filter with its graded weight (`empty_sky_filter`,
`empty_sky_weight`), `filter_fix2d`, and the late self-agreement demotion
(`agree_filter`, gated on a detached softmax). Every mean is an exact
masked mean: numerator over max(denominator, 1).

`empty_sky_weight` is copied as the reference has it: nothing stops a pixel
from being both kept and graded (ROADMAP Queue 3).
"""

from __future__ import annotations

import torch

from panopticnerf_tpu_torch.config import Config
from panopticnerf_tpu_torch.data.dataset import RayBatch
from panopticnerf_tpu_torch.data.labels import sky_train_id
from panopticnerf_tpu_torch.render.renderer import RenderOut


def masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    m = mask.to(x.dtype)
    return torch.sum(x * m) / torch.clamp(torch.sum(m), min=1.0)


def _log_softmax(logits: torch.Tensor) -> torch.Tensor:
    m = logits.amax(-1, keepdim=True)
    return logits - m - torch.log(torch.sum(torch.exp(logits - m), -1, keepdim=True))


def cross_entropy_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-element CE of integer labels vs logits (last axis = classes)."""
    lab = torch.clamp(labels, 0, logits.shape[-1] - 1).long()
    return -torch.gather(_log_softmax(logits), -1, lab[..., None])[..., 0]


def cross_entropy_probs(probs: torch.Tensor, labels: torch.Tensor,
                        eps: float = 1e-6) -> torch.Tensor:
    """CE where predictions are (possibly unnormalised) probabilities."""
    p = probs / torch.clamp(torch.sum(probs, -1, keepdim=True), min=eps)
    lab = torch.clamp(labels, 0, probs.shape[-1] - 1).long()
    sel = torch.gather(p, -1, lab[..., None])[..., 0]
    return -torch.log(torch.clamp(sel, min=eps))


def compute_losses(out: RenderOut, batch: RayBatch, cfg: Config, sem_scale: float = 1.0,
                   agree_on: float = 0.0, weight_th: float | None = None):
    """-> (total loss, stats dict of 0-dim tensors).

    `sem_scale` is the `pretrain nerf` gate (0 during the geometry stage),
    `agree_on` the 0/1 activation of the self-agreement demotion, and
    `weight_th` the (annealed) consistency threshold (cfg.loss.weight_th
    when None).
    """
    lc = cfg.loss
    num_classes = cfg.model.num_classes
    stats = {}
    ray_ok = batch.valid

    mse_fine = masked_mean(torch.mean((out.rgb - batch.rgb) ** 2, -1), ray_ok)
    l_rgb = mse_fine
    if out.coarse is not None:
        l_rgb = l_rgb + masked_mean(torch.mean((out.coarse.rgb - batch.rgb) ** 2, -1), ray_ok)
    stats["loss_rgb"] = l_rgb
    stats["psnr"] = -10.0 * torch.log10(torch.clamp(mse_fine.detach(), min=1e-10))
    total = lc.rgb_weight * l_rgb

    if lc.depth_weight > 0:
        valid = (batch.depth > 0) & ray_ok
        l_depth = masked_mean(torch.abs(out.depth - batch.depth), valid)
        if out.coarse is not None:
            l_depth = l_depth + masked_mean(torch.abs(out.coarse.depth - batch.depth), valid)
        stats["loss_depth"] = l_depth
        total = total + lc.depth_weight * l_depth

    has_pseudo = (batch.pseudo != 255) & ray_ok
    soft_px = None  # graded empty-sky pixels (loss.empty_sky_weight)
    if out.sem_fixed is not None:
        fixed_map = out.sem_fixed                                  # (N, C)
        lab = torch.clamp(batch.pseudo, 0, num_classes - 1).long()
        class_mass = torch.gather(fixed_map, -1, lab[:, None])[:, 0]
        ray_has_prims = torch.sum(fixed_map, -1) > 1e-6
        if lc.pseudo_filter:
            th = lc.weight_th if weight_th is None else weight_th
            consistent = class_mass > th
            if lc.rel_filter_ratio > 0:
                consistent = consistent & (class_mass >= lc.rel_filter_ratio * fixed_map.amax(-1))
            if lc.rel_filter_total > 0:
                consistent = consistent & (
                    class_mass >= lc.rel_filter_total * torch.sum(fixed_map, -1))
            empty_ok = ~ray_has_prims
            if lc.empty_sky_filter:
                is_sky = batch.pseudo == sky_train_id(num_classes)
                if lc.empty_sky_weight > 0:
                    soft_px = has_pseudo & empty_ok & ~is_sky
                empty_ok = empty_ok & is_sky
            keep = has_pseudo & (consistent | empty_ok)
        else:
            keep = has_pseudo
        stats["filter_keep_frac"] = keep.float().mean()

        if lc.fix2d_weight > 0:
            ce_fix = cross_entropy_probs(fixed_map, batch.pseudo)
            fix_keep = has_pseudo & ray_has_prims
            if lc.filter_fix2d:
                fix_keep = fix_keep & keep
            l_fix = masked_mean(ce_fix, fix_keep)
            stats["loss_sem_fix2d"] = l_fix
            total = total + sem_scale * lc.fix2d_weight * l_fix
    else:
        keep = has_pseudo

    if lc.agree_filter and out.sem_logits is not None and lc.sem2d_weight > 0:
        probs = torch.softmax(out.sem_logits.detach(), -1)  # the gate must not backprop
        overrule = ((probs.argmax(-1) != batch.pseudo)
                    & (probs.amax(-1) > lc.agree_conf))
        if out.sem_fixed is not None:
            lab_a = torch.clamp(batch.pseudo, 0, num_classes - 1)
            has_prims_a = torch.sum(out.sem_fixed, -1) > 1e-6
            overrule = overrule & ~(has_prims_a & (out.sem_fixed.argmax(-1) == lab_a))
        demote = overrule & (agree_on > 0)
        keep = keep & ~demote
        if soft_px is not None:
            soft_px = soft_px & ~demote
        stats["agree_demote_frac"] = demote.float().mean()

    if out.sem_logits is not None and lc.sem2d_weight > 0:
        ce2d = cross_entropy_logits(out.sem_logits, batch.pseudo)
        sem2d_w = keep
        if soft_px is not None:
            sem2d_w = keep.float() + lc.empty_sky_weight * soft_px.float()
        l_sem2d = masked_mean(ce2d, sem2d_w)
        stats["loss_sem2d"] = l_sem2d
        total = total + sem_scale * lc.sem2d_weight * l_sem2d

    if (out.sample_sem_logits is not None and out.sample_inside_k is not None
            and lc.sem3d_weight > 0):
        logits = out.sample_sem_logits                              # (N, S, C)
        sem_k = torch.clamp(out.inst_sem, 0, num_classes - 1).long()
        onehot = (torch.nn.functional.one_hot(sem_k, num_classes).to(logits.dtype)
                  * (out.inst_sem >= 0)[..., None])                 # (N, K, C)
        inside = out.sample_inside_k.to(logits.dtype)               # (N, S, K)
        cnt = out.sample_cnt
        # target = sum_k inside_k onehot_k / cnt, as one (S, K) x (K, C) product per ray
        target = torch.bmm(inside, onehot) / torch.clamp(cnt, min=1.0)[..., None]
        ce3d = -torch.sum(target * _log_softmax(logits), -1)        # (N, S)
        l_sem3d = masked_mean(ce3d, cnt > 0)
        stats["loss_sem3d"] = l_sem3d
        total = total + sem_scale * lc.sem3d_weight * l_sem3d

    stats["loss_total"] = total
    return total, stats
