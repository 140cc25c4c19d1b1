"""Evaluation metrics (port of `panopticnerf_tpu/eval/metrics.py`): PSNR,
confusion-matrix mIoU, panoptic quality with panopticapi void handling,
SSIM and depth errors.

The metrics run on host numpy arrays (the evaluator moves the rendered maps
off the device once per view); they guard empty selections so that numpy's
empty-slice / invalid-value / divide warnings never fire.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def psnr(pred: np.ndarray, gt: np.ndarray, mask: Optional[np.ndarray] = None) -> float:
    pred = np.asarray(pred, np.float64)
    gt = np.asarray(gt, np.float64)
    if mask is not None:
        m = np.asarray(mask, bool)
        if m.sum() == 0:
            return float("nan")
        mse = float(np.mean(((pred - gt) ** 2)[m]))
    else:
        mse = float(np.mean((pred - gt) ** 2))
    return float(-10.0 * np.log10(max(mse, 1e-12)))


def confusion_matrix(pred: np.ndarray, gt: np.ndarray, num_classes: int,
                     ignore: int = 255) -> np.ndarray:
    """Dense (C, C) int64 confusion matrix [gt, pred]; ignore-labelled
    pixels dropped, predictions clipped into [0, C-1]."""
    pred = np.asarray(pred).reshape(-1).astype(np.int64)
    gt = np.asarray(gt).reshape(-1).astype(np.int64)
    valid = (gt != ignore) & (gt >= 0) & (gt < num_classes)
    idx = gt[valid] * num_classes + np.clip(pred[valid], 0, num_classes - 1)
    return np.bincount(idx, minlength=num_classes * num_classes).reshape(
        num_classes, num_classes)


def iou_from_confusion(cm: np.ndarray):
    """Per-class IoU + mIoU over classes present in GT or prediction."""
    cm = np.asarray(cm, np.float64)
    tp = np.diag(cm)
    fp = cm.sum(0) - tp
    fn = cm.sum(1) - tp
    denom = tp + fp + fn
    iou = np.where(denom > 0, tp / np.maximum(denom, 1), np.nan)
    miou = float(np.nanmean(iou)) if np.isfinite(iou).any() else float("nan")
    return iou, miou


def panoptic_quality(pred_sem, pred_inst, gt_sem, gt_inst, things: np.ndarray,
                     num_classes: int, ignore: int = 255) -> dict:
    """Per-image PQ statistics (accumulate across frames, then summarise).

    Thing classes: every (class, instance) pair is a segment; stuff classes:
    the whole class mask is one segment (instance 0). Void handling follows
    panopticapi's pq_compute: gt segments exist on valid pixels only; the
    match IoU is inter / (gt_area + pred_full_area - inter - pred_void_overlap);
    an UNMATCHED predicted segment more than half over void is dropped, not
    counted as a false positive.

    Returns per-class arrays: iou_sum, tp, fp, fn (each (C,)).
    """
    pred_sem = np.asarray(pred_sem).reshape(-1)
    pred_inst = np.asarray(pred_inst).reshape(-1)
    gt_sem = np.asarray(gt_sem).reshape(-1)
    gt_inst = np.asarray(gt_inst).reshape(-1)
    things = np.asarray(things, bool)

    valid = (gt_sem != ignore) & (gt_sem >= 0) & (gt_sem < num_classes)
    gs, gi = gt_sem[valid], gt_inst[valid]
    gi = np.where(things[np.clip(gs, 0, num_classes - 1)], gi, 0)
    p_in_range = (pred_sem >= 0) & (pred_sem < num_classes)
    pi_all = np.where(p_in_range & things[np.clip(pred_sem, 0, num_classes - 1)],
                      pred_inst, 0)

    def unique_segs(sem, inst):
        key = sem.astype(np.int64) * 1_000_000 + inst.astype(np.int64)
        return np.unique(key, return_inverse=True, return_counts=True)

    g_uniq, g_inv, g_cnt = unique_segs(gs, gi)
    p_uniq, p_inv_all, p_cnt = unique_segs(pred_sem, pi_all)   # p_cnt = full areas
    p_void = np.bincount(p_inv_all[~valid], minlength=len(p_uniq))

    pair_key = g_inv.astype(np.int64) * len(p_uniq) + p_inv_all[valid]
    pair_uniq, pair_cnt = np.unique(pair_key, return_counts=True)
    gt_idx = pair_uniq // len(p_uniq)
    pr_idx = pair_uniq % len(p_uniq)

    iou_sum = np.zeros(num_classes)
    tp = np.zeros(num_classes, np.int64)
    fp = np.zeros(num_classes, np.int64)
    fn = np.zeros(num_classes, np.int64)
    g_matched = np.zeros(len(g_uniq), bool)
    p_matched = np.zeros(len(p_uniq), bool)
    g_class = (g_uniq // 1_000_000).astype(np.int64)
    p_class = (p_uniq // 1_000_000).astype(np.int64)

    for k in range(len(pair_uniq)):
        gidx, pidx = gt_idx[k], pr_idx[k]
        if g_class[gidx] != p_class[pidx]:
            continue
        inter = pair_cnt[k]
        iou = inter / (g_cnt[gidx] + p_cnt[pidx] - inter - p_void[pidx])
        if iou > 0.5:
            c = g_class[gidx]
            tp[c] += 1
            iou_sum[c] += iou
            g_matched[gidx] = True
            p_matched[pidx] = True

    for i in np.nonzero(~g_matched)[0]:
        fn[g_class[i]] += 1
    for i in np.nonzero(~p_matched)[0]:
        if p_void[i] * 2 > p_cnt[i]:  # majority-void prediction: unjudged
            continue
        c = p_class[i]
        if 0 <= c < num_classes:
            fp[c] += 1
    return {"iou_sum": iou_sum, "tp": tp, "fp": fp, "fn": fn}


def pq_from_stats(stats: dict) -> dict:
    """Accumulated PQ stats -> per-class PQ/SQ/RQ and the mean PQ over
    classes present in GT or prediction."""
    tp = stats["tp"].astype(np.float64)
    fp = stats["fp"].astype(np.float64)
    fn = stats["fn"].astype(np.float64)
    denom = tp + 0.5 * fp + 0.5 * fn
    present = denom > 0
    sq = np.where(tp > 0, stats["iou_sum"] / np.maximum(tp, 1), 0.0)
    rq = np.where(present, tp / np.maximum(denom, 1e-9), 0.0)
    pq = sq * rq
    mean_pq = float(pq[present].mean()) if present.any() else float("nan")
    return {"pq": pq, "sq": sq, "rq": rq, "present": present, "mean_pq": mean_pq}


def _ssim_window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    g = np.exp(-(x ** 2) / (2.0 * sigma ** 2))
    return g / g.sum()


def ssim(pred: np.ndarray, gt: np.ndarray, mask: Optional[np.ndarray] = None,
         data_range: float = 1.0) -> float:
    """Mean SSIM (Wang et al. 2004: 11x11 Gaussian window, sigma 1.5) over
    valid windows, channel-averaged. mask (H, W): a window counts iff its
    centre pixel is valid. NaN when no window is valid."""
    from scipy.ndimage import correlate1d

    pred = np.asarray(pred, np.float64)
    gt = np.asarray(gt, np.float64)
    if pred.ndim == 2:
        pred, gt = pred[..., None], gt[..., None]
    win = _ssim_window()
    half = len(win) // 2

    def filt(img):
        out = correlate1d(img, win, axis=0, mode="constant")
        return correlate1d(out, win, axis=1, mode="constant")

    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    mu_p, mu_g = filt(pred), filt(gt)
    var_p = filt(pred * pred) - mu_p ** 2
    var_g = filt(gt * gt) - mu_g ** 2
    cov = filt(pred * gt) - mu_p * mu_g
    smap = ((2 * mu_p * mu_g + c1) * (2 * cov + c2)
            / ((mu_p ** 2 + mu_g ** 2 + c1) * (var_p + var_g + c2)))
    smap = smap[half:-half, half:-half]  # 'valid' windows only
    if smap.size == 0:
        return float("nan")
    if mask is not None:
        m = np.asarray(mask, bool)[half:-half, half:-half]
        if not m.any():
            return float("nan")
        return float(smap[m].mean())
    return float(smap.mean())


def depth_error_sums(pred: np.ndarray, gt: np.ndarray,
                     valid: Optional[np.ndarray] = None) -> dict:
    """Accumulable sums for RMSE, abs-rel and delta<1.25 over pixels with
    gt > 0 (ray-distance metres on both sides)."""
    pred = np.asarray(pred, np.float64).reshape(-1)
    gt = np.asarray(gt, np.float64).reshape(-1)
    m = gt > 0
    if valid is not None:
        m &= np.asarray(valid, bool).reshape(-1)
    p, g = pred[m], gt[m]
    ratio = np.maximum(p / np.maximum(g, 1e-9), g / np.maximum(p, 1e-9))
    return {
        "n": int(m.sum()),
        "se_sum": float(((p - g) ** 2).sum()),
        "absrel_sum": float((np.abs(p - g) / np.maximum(g, 1e-9)).sum()),
        "delta125": int((ratio < 1.25).sum()),
    }


def depth_from_sums(s: dict) -> dict:
    n = max(s["n"], 1)
    return {
        "depth_rmse": float(np.sqrt(s["se_sum"] / n)),
        "depth_abs_rel": float(s["absrel_sum"] / n),
        "depth_delta125": float(s["delta125"] / n),
    }
