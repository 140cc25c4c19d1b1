import numpy as np

from panopticnerf_tpu_torch.data import labels as L
from panopticnerf_tpu_torch.eval.evaluator import Evaluator
from panopticnerf_tpu_torch.eval.lpips import LPIPS, make_lpips
from panopticnerf_tpu_torch.eval.metrics import (
    confusion_matrix,
    iou_from_confusion,
    panoptic_quality,
    pq_from_stats,
    psnr,
)
from panopticnerf_tpu_torch.eval.panoptic import fuse_panoptic


def make_evaluator(cfg, things=None) -> Evaluator:
    """Evaluator for `cfg`: KITTI-360 thing classes at 19 classes, else every
    class but 0 (the synthetic scene's sky/stuff) is a thing; LPIPS when
    eval.lpips_weights names a usable weights file."""
    if things is None:
        if cfg.model.num_classes == L.NUM_TRAIN_IDS:
            things = L.TRAINID_HAS_INSTANCES
        else:
            things = np.ones(cfg.model.num_classes, bool)
            things[0] = False
    return Evaluator(cfg.model.num_classes, things,
                     fixed_blend=cfg.loss.eval_fixed_blend,
                     lpips_fn=make_lpips(cfg.eval.lpips_weights),
                     fusion_rule=cfg.eval.fusion_rule,
                     sky_rule=cfg.eval.sky_rule,
                     sky_class=resolve_sky_class(cfg),
                     sky_eps=cfg.eval.sky_eps)


def resolve_sky_class(cfg) -> int:
    """eval.sky_class, or auto (-1): the labels-table sky trainId at 19
    classes, else class 0."""
    if cfg.eval.sky_class >= 0:
        return int(cfg.eval.sky_class)
    return L.sky_train_id(cfg.model.num_classes)


__all__ = [
    "Evaluator",
    "LPIPS",
    "confusion_matrix",
    "fuse_panoptic",
    "iou_from_confusion",
    "make_evaluator",
    "make_lpips",
    "panoptic_quality",
    "pq_from_stats",
    "psnr",
    "resolve_sky_class",
]
