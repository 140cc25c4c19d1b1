"""Visualizer: colourised rgb / depth / semantic / panoptic images and
KITTI-360 label maps (port of `panopticnerf_tpu/viz/visualizer.py`).

The palettes and colourisations are the reference's, in numpy. Images are
written by `viz/png.py`, which needs no PIL; `write_video` keeps the
reference's best-effort contract (None when imageio is absent).
"""

from __future__ import annotations

import glob
import os
from typing import Optional

import numpy as np

from panopticnerf_tpu_torch.config import Config
from panopticnerf_tpu_torch.data import labels as L
from panopticnerf_tpu_torch.viz.png import write_png

VIDEO_FPS = 10


def _np(t):
    return t.detach().cpu().numpy() if hasattr(t, "detach") else np.asarray(t)


def _instance_palette(n: int = 256, seed: int = 1) -> np.ndarray:
    rng = np.random.default_rng(seed)
    pal = rng.integers(40, 255, (n, 3)).astype(np.uint8)
    pal[0] = 0
    return pal


def depth_to_color(depth: np.ndarray, d_min: float | None = None,
                   d_max: float | None = None) -> np.ndarray:
    """Perceptual ramp (dark blue near -> yellow far) without matplotlib."""
    d = np.asarray(depth, np.float32)
    seen = (d > 0).any()
    lo = d_min if d_min is not None else float(np.percentile(d[d > 0], 2)) if seen else 0.0
    hi = d_max if d_max is not None else float(np.percentile(d[d > 0], 98)) if seen else 1.0
    t = np.clip((d - lo) / max(hi - lo, 1e-6), 0, 1)
    r = np.clip(1.5 * t, 0, 1)
    g = np.clip(1.5 * t - 0.25, 0, 1)
    b = np.clip(1.0 - 1.2 * t, 0, 1)
    return (np.stack([r, g, b], -1) * 255).astype(np.uint8)


def semantic_raw_ids(sem: np.ndarray, num_classes: int) -> np.ndarray:
    """A rendered semantic map -> canonical KITTI-360 raw ids: models
    trained in trainId space (19 classes) invert trainId -> id; raw-id
    models pass through."""
    if num_classes == L.NUM_TRAIN_IDS:
        train_to_id = np.zeros(L.NUM_TRAIN_IDS + 1, np.int32)
        for t in range(L.NUM_TRAIN_IDS):
            train_to_id[t] = L.trainId2label[t].id
        return train_to_id[np.clip(sem, 0, L.NUM_TRAIN_IDS)]
    return np.asarray(sem, np.int32)


def label_transfer_maps(sem: np.ndarray, inst: np.ndarray, hw: tuple[int, int],
                        num_classes: int) -> tuple[np.ndarray, np.ndarray]:
    """Fused (sem, inst) of one view -> the KITTI-360 data_2d_semantics
    encoding: (H, W) uint8 raw semantic ids, (H, W) uint16
    semantic * 1000 + instance % 1000."""
    h, w = hw
    sem_raw = semantic_raw_ids(np.asarray(sem).reshape(h, w), num_classes)
    enc = sem_raw.astype(np.int32) * 1000 + (np.asarray(inst).reshape(h, w) % 1000)
    return sem_raw.astype(np.uint8), enc.astype(np.uint16)


class Visualizer:
    def __init__(self, cfg: Config):
        self.cfg = cfg
        self.out_dir = cfg.result_path
        os.makedirs(self.out_dir, exist_ok=True)
        if cfg.data.dataset == "kitti360" and cfg.model.num_classes == L.NUM_TRAIN_IDS:
            self.sem_palette = np.concatenate([L.TRAINID_COLOR[:-1], np.zeros((237, 3), np.uint8)])
        else:
            self.sem_palette = _instance_palette(256, seed=7)
            self.sem_palette[0] = (70, 130, 180)  # synthetic sky
        self.inst_palette = _instance_palette()

    def colorize_sem(self, sem: np.ndarray) -> np.ndarray:
        return self.sem_palette[np.clip(sem, 0, 255)]

    def colorize_panoptic(self, sem: np.ndarray, inst: np.ndarray) -> np.ndarray:
        """Semantic palette, with thing pixels tinted by instance id."""
        base = self.colorize_sem(sem).astype(np.int32)
        tint = self.inst_palette[np.asarray(inst) % 256].astype(np.int32)
        is_thing = np.asarray(inst) > 0
        return np.where(is_thing[..., None], (base + tint) // 2, base).astype(np.uint8)

    def _save(self, name: str, arr: np.ndarray) -> str:
        path = os.path.join(self.out_dir, name)
        write_png(path, arr)
        return path

    def write_view(self, view: int, out, hw: tuple[int, int],
                   sem: Optional[np.ndarray] = None,
                   inst: Optional[np.ndarray] = None) -> list[str]:
        """rgb, depth, and where given semantic and panoptic images of one
        flat (H*W) RenderOut."""
        h, w = hw
        files = []
        rgb = (_np(out.rgb).reshape(h, w, 3).clip(0, 1) * 255).astype(np.uint8)
        files.append(self._save(f"{view:06d}_rgb.png", rgb))
        files.append(self._save(f"{view:06d}_depth.png",
                                depth_to_color(_np(out.depth).reshape(h, w))))
        if sem is not None:
            files.append(self._save(f"{view:06d}_semantic.png",
                                    self.colorize_sem(sem.reshape(h, w))))
        if sem is not None and inst is not None:
            files.append(self._save(f"{view:06d}_panoptic.png",
                                    self.colorize_panoptic(sem.reshape(h, w),
                                                           inst.reshape(h, w))))
        return files

    def write_label_transfer(self, view: int, sem: np.ndarray, inst: np.ndarray,
                             hw: tuple[int, int]) -> list[str]:
        """KITTI-360 submission-style label maps (the format of
        data_2d_semantics): 8-bit raw semantic ids, and 16-bit
        semantic * 1000 + instance."""
        sem_raw, enc = label_transfer_maps(sem, inst, hw, self.cfg.model.num_classes)
        return [self._save(f"{view:06d}_labelsem.png", sem_raw),
                self._save(f"{view:06d}_labelinst.png", enc)]

    def write_video(self, pattern_suffix: str = "_rgb.png", name: str = "video.mp4"):
        """Assemble written frames into a video (imageio; best-effort)."""
        frames = sorted(glob.glob(os.path.join(self.out_dir, f"*{pattern_suffix}")))
        if not frames:
            return None
        try:
            import imageio.v2 as imageio

            path = os.path.join(self.out_dir, name)
            with imageio.get_writer(path, fps=VIDEO_FPS) as wtr:
                for f in frames:
                    wtr.append_data(imageio.imread(f))
            return path
        except (ImportError, OSError, RuntimeError, ValueError):
            return None
