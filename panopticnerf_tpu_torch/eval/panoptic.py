"""Panoptic fusion: rendered fields -> (semantic, instance) label maps
(port of `panopticnerf_tpu/eval/panoptic.py`).

  sem(p)  = argmax_c of the learned softmax, blended with the normalised
            fixed field where the ray carries fixed mass;
  inst(p) = inst_ids[argmax_k inst_mass], preferring intervals whose class
            matches sem(p) ("match" rule; inst_sem=None gives the raw argmax),
            if sem(p) is a thing class and the ray has primitive mass; else 0.

`sky_rule` (eval.sky_rule) uses the fact that the 3D annotation covers
every non-sky surface: "empty" labels a ray with no composited fixed mass
`sky_class`; "support" also zeroes the probability of every class without
fixed support on that ray (sky always kept); "soft:<w>" (w in [0, 1],
default 0.5) scales unsupported classes by (1 - w) and blends empty rays
toward the sky one-hot with weight w, pinning nothing. "off" is the plain
fusion. The reference treats any other string as "empty"; the port raises
ValueError for it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def check_sky_rule(sky_rule: str) -> Optional[float]:
    """Validate eval.sky_rule; returns the blend weight w of "soft[:w]"
    (None for the other rules)."""
    if sky_rule in ("off", "empty", "support"):
        return None
    if sky_rule == "soft":
        return 0.5
    if sky_rule.startswith("soft:"):
        try:
            return float(sky_rule[5:])
        except ValueError:
            pass
    raise ValueError(f"unknown eval.sky_rule {sky_rule!r}: "
                     f"one of off, empty, support, soft[:w]")


def fuse_panoptic(
    sem_logits: Optional[torch.Tensor],   # (N, C) composited learned logits
    sem_fixed: Optional[torch.Tensor],    # (N, C) composited fixed distribution
    inst_mass: Optional[torch.Tensor],    # (N, K) per-interval opacity mass
    inst_ids: Optional[torch.Tensor],     # (N, K)
    inst_sem: Optional[torch.Tensor],     # (N, K) interval semantic ids
    things: np.ndarray,                   # (C,) bool thing-class table
    fixed_blend: float = 0.5,
    sky_rule: str = "off",
    sky_class: Optional[int] = None,
    empty_eps: float = 1e-4,
):
    """Returns (sem (N,), inst (N,)) int32 tensors on the input's device."""
    if sem_logits is None and sem_fixed is None:
        raise ValueError("fuse_panoptic needs sem_logits or sem_fixed")
    soft_w = check_sky_rule(sky_rule)
    probs = None
    if sem_logits is not None:
        mx = sem_logits.amax(-1, keepdim=True)
        probs = torch.exp(sem_logits - mx
                          - torch.log(torch.sum(torch.exp(sem_logits - mx), -1, keepdim=True)))
    if sem_fixed is not None:
        total = sem_fixed.sum(-1, keepdim=True)
        fixed = sem_fixed / torch.clamp(total, min=1e-6)
        has_fixed = total > 1e-6
        if probs is None:
            probs = torch.where(has_fixed, fixed, 0.0)
        elif fixed_blend > 0:
            probs = torch.where(has_fixed, (1 - fixed_blend) * probs + fixed_blend * fixed,
                                probs)
    empty = None
    if sem_fixed is not None and sky_rule != "off" and sky_class is not None:
        empty = sem_fixed.sum(-1) <= empty_eps
        sky_onehot = torch.arange(sem_fixed.shape[-1], device=sem_fixed.device) == sky_class
        supported = (sem_fixed > empty_eps) | sky_onehot
        if sky_rule == "support":
            probs = torch.where(supported, probs, 0.0)
        elif soft_w is not None:
            demoted = torch.where(supported, probs, (1.0 - soft_w) * probs)
            toward_sky = (1.0 - soft_w) * probs + soft_w * torch.where(sky_onehot, 1.0, 0.0)
            probs = torch.where(empty[:, None], toward_sky, demoted)
            empty = None  # the blend decides empty rays; no hard pin
    sem = torch.argmax(probs, dim=-1).to(torch.int32)
    if empty is not None:
        # with "support" an empty ray keeps only the sky column; should its
        # probability be exactly 0, argmax would fall back to class 0
        sem = torch.where(empty, sky_class, sem).to(torch.int32)

    things_t = torch.as_tensor(np.asarray(things, bool), device=sem.device)
    is_thing = things_t[torch.clamp(sem, 0, things_t.shape[0] - 1).long()]
    if inst_mass is None or inst_ids is None:
        return sem, torch.zeros_like(sem)

    if inst_sem is not None:
        match = inst_sem == sem[:, None]
        mass_pref = torch.where(match, inst_mass, -1.0)
        any_match = torch.any(match & (inst_mass > 0), dim=-1)
        k_star = torch.where(any_match, torch.argmax(mass_pref, dim=-1),
                             torch.argmax(inst_mass, dim=-1))
    else:
        k_star = torch.argmax(inst_mass, dim=-1)
    inst = torch.gather(inst_ids, 1, k_star[:, None])[:, 0]
    has_mass = inst_mass.amax(-1) > 1e-4
    inst = torch.where(is_thing & has_mass, inst, 0).to(torch.int32)
    return sem, inst
