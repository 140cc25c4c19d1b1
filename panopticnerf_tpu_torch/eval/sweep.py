"""The fusion sweep: one render of a checkpoint's ground-truth views, then
every fusion variant re-fused from the cached fields (port of
`panopticnerf_tpu/eval/sweep.py`).

`cache_gt_views` renders each view with semantic ground truth once and
keeps the per-pixel fields the fusion reads (learned logits, the fixed
field's mass, the instance mass, ids and classes) on the render's device;
`fusion_sweep` fuses them there for each (interval-selection rule x
`eval_fixed_blend` x `eval.sky_rule`) and scores each variant on the host,
so that ten variants cost one render. The drivers are
`panopticnerf_tpu_torch.tools.landing_sweep` (the pick table) and
`panopticnerf_tpu_torch.tools.pq_analysis` (error maps, missed segments).
"""

from __future__ import annotations

import numpy as np
import torch


@torch.no_grad()
def cache_gt_views(cfg, device: torch.device | str):
    """Render every view with semantic ground truth once on `device`.
    Returns (cached, views, step, things, C, ds): one dict per view with the
    render's fields (tensors on `device`) and the view's flat ground truth
    (host arrays: gt_sem, gt_inst, valid or None)."""
    from panopticnerf_tpu_torch import engine
    from panopticnerf_tpu_torch.eval import make_evaluator

    ds, _, model, step = engine._restore_for_eval(cfg, device)
    things = make_evaluator(cfg).things
    C = cfg.model.num_classes
    if ds.gt_sem is None:
        raise ValueError("the fusion sweep needs semantic / instance ground truth")
    views = np.nonzero((ds.gt_sem != 255).flatten(1).any(1).cpu().numpy())[0].tolist()
    flat = lambda t, v: t[v].reshape(-1).cpu().numpy()
    cached = []
    for v in views:
        out = engine._render_view(cfg, model, ds, int(v))
        cached.append(dict(
            sem_logits=out.sem_logits, sem_fixed=out.sem_fixed, inst_mass=out.inst_mass,
            inst_ids=out.inst_ids, inst_sem=out.inst_sem,
            gt_sem=flat(ds.gt_sem, v), gt_inst=flat(ds.gt_inst, v),
            valid=flat(ds.valid_mask, v) if ds.valid_mask is not None else None))
    return cached, views, step, things, C, ds


def fusion_sweep(cached, things, C, blends, rules=("match", "raw"), sky_rules=("off",),
                 sky_class=0):
    """Grid over (sky_rule, rule, blend) -> one row of metrics each: `rule`,
    `blend`, `sky_rule`, `miou`, `pq`, `pq_things`, `pq_stuff` (4 decimals;
    None for a category with no segment). `sky_class`: resolve it with
    eval.resolve_sky_class. Fusion runs where the cached fields live."""
    from panopticnerf_tpu_torch.eval import metrics
    from panopticnerf_tpu_torch.eval.panoptic import fuse_panoptic

    rows = []
    for sky in sky_rules:
        for rule in rules:
            for blend in blends:
                cm = np.zeros((C, C), np.int64)
                pq_stats = {"iou_sum": np.zeros(C), "tp": np.zeros(C, np.int64),
                            "fp": np.zeros(C, np.int64), "fn": np.zeros(C, np.int64)}
                for c in cached:
                    sem, inst = fuse_panoptic(
                        c["sem_logits"], c["sem_fixed"], c["inst_mass"], c["inst_ids"],
                        c["inst_sem"] if rule == "match" else None,
                        things, blend, sky_rule=sky, sky_class=sky_class)
                    sem, inst = sem.cpu().numpy(), inst.cpu().numpy()
                    gt_sem = c["gt_sem"]
                    if c["valid"] is not None:
                        gt_sem = np.where(c["valid"], gt_sem, 255)
                    cm += metrics.confusion_matrix(sem, gt_sem, C)
                    st = metrics.panoptic_quality(sem, inst, gt_sem, c["gt_inst"], things, C)
                    for k in pq_stats:
                        pq_stats[k] += st[k]
                _, miou = metrics.iou_from_confusion(cm)
                pq = metrics.pq_from_stats(pq_stats)
                pres = pq["present"]
                row = {"rule": rule, "blend": float(blend), "sky_rule": sky,
                       "miou": round(miou, 4), "pq": round(pq["mean_pq"], 4)}
                for name, sel in (("pq_things", things), ("pq_stuff", ~things)):
                    m = pres & sel[: len(pres)]
                    row[name] = round(float(pq["pq"][m].mean()), 4) if m.any() else None
                rows.append(row)
    return rows
