"""Accumulating evaluator (port of `panopticnerf_tpu/eval/evaluator.py`).

`evaluate(out, ...)` fuses one rendered view into panoptic labels on the
render's device, moves the per-ray maps to host numpy once and accumulates
PSNR / SSIM / depth errors / the confusion matrix / PQ statistics;
`summarize()` returns PSNR, per-class IoU, mIoU and PQ (+ SQ, RQ, PQ^Th,
PQ^St).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from panopticnerf_tpu_torch.eval import metrics
from panopticnerf_tpu_torch.eval.panoptic import check_sky_rule, fuse_panoptic


def _np(t):
    return None if t is None else t.detach().cpu().numpy()


class Evaluator:
    def __init__(self, num_classes: int, things: np.ndarray, ignore: int = 255,
                 fixed_blend: float = 0.5, fusion_rule: str = "match",
                 sky_rule: str = "off", sky_class: int = 0, sky_eps: float = 1e-4):
        if fusion_rule not in ("match", "raw"):
            raise ValueError(f"unknown eval.fusion_rule {fusion_rule!r}")
        check_sky_rule(sky_rule)
        self.num_classes = num_classes
        self.things = np.asarray(things, bool)
        self.ignore = ignore
        self.fixed_blend = fixed_blend
        self.fusion_rule = fusion_rule
        self.sky_rule = sky_rule
        self.sky_class = sky_class
        self.sky_eps = sky_eps
        self.reset()

    def reset(self):
        self.psnrs = []
        self.ssims = []
        self.depth_sums = {"n": 0, "se_sum": 0.0, "absrel_sum": 0.0, "delta125": 0}
        self.cm = np.zeros((self.num_classes, self.num_classes), np.int64)
        self.pq_stats = {
            "iou_sum": np.zeros(self.num_classes),
            "tp": np.zeros(self.num_classes, np.int64),
            "fp": np.zeros(self.num_classes, np.int64),
            "fn": np.zeros(self.num_classes, np.int64),
        }

    def evaluate(
        self,
        out,                                      # RenderOut, flat (H*W) leading dim
        gt_rgb: Optional[np.ndarray] = None,      # (H*W, 3) float in [0, 1]
        gt_sem: Optional[np.ndarray] = None,      # (H*W,) int
        gt_inst: Optional[np.ndarray] = None,     # (H*W,) int
        valid: Optional[np.ndarray] = None,       # (H*W,) bool
        gt_depth: Optional[np.ndarray] = None,    # (H*W,) ray distance; <= 0 hole
        image_hw: Optional[tuple] = None,         # (H, W) — enables SSIM
    ):
        """Accumulate one rendered view. Returns its fused (sem, inst) maps
        as numpy arrays (None without semantic fields)."""
        rgb = _np(out.rgb)
        if gt_rgb is not None:
            mask = None if valid is None else np.broadcast_to(
                np.asarray(valid, bool)[:, None], gt_rgb.shape)
            self.psnrs.append(metrics.psnr(rgb, gt_rgb, mask))
            if image_hw is not None:
                h, w = image_hw
                m2d = None if valid is None else np.asarray(valid, bool).reshape(h, w)
                self.ssims.append(metrics.ssim(
                    rgb.reshape(h, w, -1), np.asarray(gt_rgb).reshape(h, w, -1), m2d))
        if gt_depth is not None and out.depth is not None:
            s = metrics.depth_error_sums(_np(out.depth), gt_depth, valid)
            for k in self.depth_sums:
                self.depth_sums[k] += s[k]
        if valid is not None and gt_sem is not None:
            gt_sem = np.where(np.asarray(valid, bool), gt_sem, self.ignore)

        if out.sem_logits is None and out.sem_fixed is None:
            return None, None
        sem, inst = fuse_panoptic(
            out.sem_logits, out.sem_fixed, out.inst_mass, out.inst_ids,
            out.inst_sem if self.fusion_rule == "match" else None,
            self.things, self.fixed_blend, sky_rule=self.sky_rule,
            sky_class=self.sky_class, empty_eps=self.sky_eps)
        sem, inst = _np(sem), _np(inst)
        if gt_sem is not None:
            self.cm += metrics.confusion_matrix(sem, gt_sem, self.num_classes, self.ignore)
            if gt_inst is not None:
                st = metrics.panoptic_quality(sem, inst, gt_sem, gt_inst, self.things,
                                              self.num_classes, self.ignore)
                for k in self.pq_stats:
                    self.pq_stats[k] += st[k]
        return sem, inst

    def summarize(self) -> dict:
        result = {}
        psnrs = [p for p in self.psnrs if np.isfinite(p)]
        if psnrs:
            result["psnr"] = float(np.mean(psnrs))
        ssims = [s for s in self.ssims if np.isfinite(s)]
        if ssims:
            result["ssim"] = float(np.mean(ssims))
        if self.depth_sums["n"] > 0:
            result.update(metrics.depth_from_sums(self.depth_sums))
        if self.cm.sum() > 0:
            iou, miou = metrics.iou_from_confusion(self.cm)
            result["iou_per_class"] = iou
            result["miou"] = miou
        st = self.pq_stats
        if st["tp"].sum() + st["fn"].sum() + st["fp"].sum() > 0:
            pq = metrics.pq_from_stats(st)
            result["pq_per_class"] = pq["pq"]
            result["pq"] = pq["mean_pq"]
            result["sq"] = pq["sq"]
            result["rq"] = pq["rq"]
            pres = pq["present"]
            for name, sel in (("things", self.things), ("stuff", ~self.things)):
                m = pres & sel[: len(pres)]
                if m.any():
                    result[f"pq_{name}"] = float(pq["pq"][m].mean())
        return result

    def summary_table(self, class_names: list[str] | None = None) -> str:
        """Per-class table (IoU / PQ rows), then PQ^Th/PQ^St, PSNR and depth."""
        res = self.summarize()
        lines = []
        if "miou" in res:
            iou = res["iou_per_class"]
            pqc = res.get("pq_per_class")
            lines.append(f"{'class':<22}{'IoU':>8}{'PQ':>8}")
            for c in range(self.num_classes):
                if not np.isfinite(iou[c]) and (pqc is None or pqc[c] == 0):
                    continue
                name = class_names[c] if class_names and c < len(class_names) else str(c)
                iou_s = f"{iou[c]:.3f}" if np.isfinite(iou[c]) else "-"
                pq_s = f"{pqc[c]:.3f}" if pqc is not None else "-"
                lines.append(f"{name:<22}{iou_s:>8}{pq_s:>8}")
            lines.append(f"{'mean':<22}{res['miou']:>8.3f}{res.get('pq', float('nan')):>8.3f}")
        if "pq_things" in res or "pq_stuff" in res:
            lines.append(f"PQ_th: {res.get('pq_things', float('nan')):.3f}  "
                         f"PQ_st: {res.get('pq_stuff', float('nan')):.3f}")
        if "psnr" in res:
            line = f"PSNR: {res['psnr']:.2f} dB"
            if "ssim" in res:
                line += f"  SSIM: {res['ssim']:.4f}"
            lines.append(line)
        if "depth_rmse" in res:
            lines.append(f"depth: rmse {res['depth_rmse']:.3f} m  "
                         f"abs-rel {res['depth_abs_rel']:.4f}  "
                         f"d<1.25 {res['depth_delta125']:.4f}")
        return "\n".join(lines)
