"""Image decoding and resampling without PIL, equal to PIL pixel for pixel.

The KITTI-360 loader of the JAX package reads and resizes every stream
through PIL (`panopticnerf_tpu/data/kitti360.py`), which the card's
machine lacks. This module reproduces the calls it makes:

- `load_rgb`: `Image.open(path).convert("RGB")` for 8-bit grey, RGB and
  RGBA PNGs (grey is replicated, alpha dropped);
- `resize_bilinear`: `Image.resize(size, BILINEAR)` on uint8 images, the
  separable two-pass resample of Pillow's Resample.c: a triangle filter
  whose support grows with the reduction, weights normalised per output
  pixel and stored in 22-bit fixed point, rounding
  `(acc + 2**21) >> 22` clipped to 0-255, the horizontal pass first with
  a uint8 image between the passes;
- `resize_nearest`: `Image.resize(size, NEAREST)`. For 8-bit, int32 and
  float32 images Pillow steps the source coordinate by in / out from half
  a step, so the index is the floor of that running sum; for 16-bit
  images (mode I;16) it takes floor((x + 0.5) * in / out). The two differ
  at some sizes, and each is kept for its dtype.

Sizes are (width, height), as PIL takes them.
"""

from __future__ import annotations

import math

import numpy as np

from panopticnerf_tpu_torch.utils.profiling import span
from panopticnerf_tpu_torch.viz.png import read_png

PRECISION_BITS = 22  # Pillow's fixed-point weights for 8-bit images


def load_rgb(path: str) -> np.ndarray:
    """(H, W, 3) uint8 of an 8-bit grey, RGB or RGBA PNG."""
    img = read_png(path)
    if img.dtype != np.uint8:
        raise ValueError(f"{path}: a 16-bit image is not an RGB image")
    if img.ndim == 2:
        return np.repeat(img[..., None], 3, axis=-1)
    return np.ascontiguousarray(img[..., :3])


def _bilinear_coeffs(in_size: int, out_size: int):
    """-> (first source index (out,), fixed-point weights (out, ksize))
    of one axis, as Pillow's precompute_coeffs + normalize_coeffs_8bpc."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    ss = 1.0 / filterscale
    first = np.zeros(out_size, np.int64)
    weights = np.zeros((out_size, ksize), np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        k = [max(1.0 - abs((x + xmin - center + 0.5) * ss), 0.0) for x in range(xmax)]
        ww = 0.0
        for v in k:
            ww += v
        for x, v in enumerate(k):
            v = v / ww if ww != 0.0 else v
            weights[xx, x] = int(0.5 + v * (1 << PRECISION_BITS))  # v >= 0: trunc = floor
        first[xx] = xmin
    return first, weights


def _resample_axis(img: np.ndarray, axis: int, out_size: int) -> np.ndarray:
    first, weights = _bilinear_coeffs(img.shape[axis], out_size)
    idx = np.minimum(first[:, None] + np.arange(weights.shape[1]), img.shape[axis] - 1)
    src = np.moveaxis(img, axis, -1).astype(np.int64)        # (..., in)
    acc = np.full(src.shape[:-1] + (out_size,), 1 << (PRECISION_BITS - 1), np.int64)
    for j in range(weights.shape[1]):  # weights past a pixel's support are 0
        acc += src[..., idx[:, j]] * weights[:, j]
    out = np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, -1, axis)


@span("data.resize")
def resize_bilinear(img: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """uint8 (H, W) or (H, W, C) -> size (w, h), as PIL's BILINEAR."""
    if img.dtype != np.uint8:
        raise ValueError(f"resize_bilinear takes uint8 images, not {img.dtype}")
    w, h = size
    out = img
    if w != img.shape[1]:
        out = _resample_axis(out, 1, w)
    if h != img.shape[0]:
        out = _resample_axis(out, 0, h)
    return np.ascontiguousarray(out)


def _nearest_index(in_size: int, out_size: int, stepped: bool) -> np.ndarray:
    step = in_size / out_size
    if stepped:  # xo = step / 2, then xo += step per pixel
        pos = np.full(out_size, step)
        pos[0] = step * 0.5
        pos = np.cumsum(pos)
    else:
        pos = (np.arange(out_size) + 0.5) * step
    return np.minimum(np.floor(pos).astype(np.int64), in_size - 1)


@span("data.resize")
def resize_nearest(arr: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """(H, W) uint8, uint16, int32 or float32 -> size (w, h), as PIL's
    NEAREST on modes L, I;16, I and F."""
    if arr.dtype not in (np.uint8, np.uint16, np.int32, np.float32) or arr.ndim != 2:
        raise ValueError(f"resize_nearest takes (H, W) uint8 / uint16 / int32 / float32, "
                         f"not {arr.shape} {arr.dtype}")
    w, h = size
    if (h, w) == arr.shape:
        return arr.copy()
    stepped = arr.dtype != np.uint16
    rows = _nearest_index(arr.shape[0], h, stepped)
    cols = _nearest_index(arr.shape[1], w, stepped)
    return np.ascontiguousarray(arr[rows[:, None], cols[None, :]])
