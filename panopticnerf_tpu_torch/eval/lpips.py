"""LPIPS perceptual distance, AlexNet backbone, weights read from a file
(port of `panopticnerf_tpu/eval/lpips.py`).

The metric needs pretrained convolution weights, which are not in the
repo: it runs only when `eval.lpips_weights` names an `.npz` in the layout
that tools/convert_lpips_weights.py writes, and the evaluator skips it
otherwise (`make_lpips` logs "LPIPS disabled" for a missing or malformed
file).

Zhang et al. 2018 (lpips 'alex', v0.1 lin layer):
  x in [0, 1] -> x * 2 - 1 -> (x - shift) / scale
  AlexNet conv features after each of the 5 ReLUs
  each feature map unit-normalised along its channels
  d = sum_l mean_hw(sum_c lin_l[c] * (f_l(pred) - f_l(gt))^2)

It runs on the render's device as `F.conv2d` / `F.max_pool2d`, with
cuDNN's TF32 rounding off, so that the card computes the float32 distance
the CPU does; only the scalar goes back to the host.
"""

from __future__ import annotations

import contextlib
import zipfile

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# (out_ch, kernel, stride, pad, maxpool_after) for AlexNet 'features'
_ALEX_LAYERS = (
    (64, 11, 4, 2, True),
    (192, 5, 1, 2, True),
    (384, 3, 1, 1, False),
    (256, 3, 1, 1, False),
    (256, 3, 1, 1, False),
)

_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)


def _expected_keys() -> list[str]:
    keys = []
    for i in range(len(_ALEX_LAYERS)):
        keys += [f"conv{i}_w", f"conv{i}_b", f"lin{i}"]
    return keys


@contextlib.contextmanager
def _no_tf32():
    """cuDNN convolutions in full float32 (TF32 would round to ~1e-3)."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


class LPIPS(nn.Module):
    """`lpips(pred, gt)` -> 0-dim float32 distance on the module's device,
    for (H, W, 3) images in [0, 1] (tensors or numpy arrays); NaN when
    min(H, W) < 48. Move it with `.to(device)`.

    Raises ValueError on a malformed weights file (missing arrays or wrong
    shapes), which `make_lpips` turns into a skipped metric.
    """

    def __init__(self, weights_path: str):
        super().__init__()
        with np.load(weights_path) as z:
            missing = [k for k in _expected_keys() if k not in z]
            if missing:
                raise ValueError(
                    f"LPIPS weights file {weights_path!r} is missing arrays "
                    f"{missing}; expected the layout written by "
                    f"tools/convert_lpips_weights.py")
            in_ch = 3
            for i, (out_ch, k, _, _, _) in enumerate(_ALEX_LAYERS):
                w = np.asarray(z[f"conv{i}_w"], np.float32)
                b = np.asarray(z[f"conv{i}_b"], np.float32)
                lin = np.asarray(z[f"lin{i}"], np.float32).reshape(-1)
                if w.shape != (out_ch, in_ch, k, k):
                    raise ValueError(
                        f"conv{i}_w shape {w.shape} != {(out_ch, in_ch, k, k)}")
                if b.shape != (out_ch,) or lin.shape != (out_ch,):
                    raise ValueError(
                        f"conv{i}_b/lin{i} must be ({out_ch},); got "
                        f"{b.shape}/{lin.shape}")
                self.register_buffer(f"conv{i}_w", torch.from_numpy(w))
                self.register_buffer(f"conv{i}_b", torch.from_numpy(b))
                self.register_buffer(f"lin{i}", torch.from_numpy(lin))
                in_ch = out_ch
        self.register_buffer("shift", torch.from_numpy(_SHIFT)[None, :, None, None])
        self.register_buffer("scale", torch.from_numpy(_SCALE)[None, :, None, None])

    def _features(self, x: torch.Tensor) -> list[torch.Tensor]:
        feats = []
        for i, (_, _, stride, pad, pool) in enumerate(_ALEX_LAYERS):
            x = torch.relu(F.conv2d(x, getattr(self, f"conv{i}_w"), getattr(self, f"conv{i}_b"),
                                    stride=stride, padding=pad))
            feats.append(x)
            if pool:  # lax.reduce_window max, 3x3 stride 2, VALID
                x = F.max_pool2d(x, 3, 2)
        return feats

    def _prep(self, im) -> torch.Tensor:
        im = torch.as_tensor(im, device=self.shift.device).to(torch.float32)
        im = im.permute(2, 0, 1)[None] * 2.0 - 1.0
        return (im - self.shift) / self.scale

    @torch.no_grad()
    def forward(self, pred, gt) -> torch.Tensor:
        h, w = pred.shape[:2]
        # two stride-2 pools after a stride-4 conv: a smaller frame has no
        # layer-5 features and the metric is undefined
        if min(h, w) < 48:
            return torch.tensor(float("nan"), device=self.shift.device)
        with _no_tf32():
            fp, fg = self._features(self._prep(pred)), self._features(self._prep(gt))
        total = torch.zeros((), device=self.shift.device)
        for i, (a, b) in enumerate(zip(fp, fg)):
            na = a / torch.sqrt(torch.sum(a ** 2, 1, keepdim=True) + 1e-10)
            nb = b / torch.sqrt(torch.sum(b ** 2, 1, keepdim=True) + 1e-10)
            d = (na - nb) ** 2                                        # (1, C, h, w)
            total = total + torch.mean(torch.sum(d * getattr(self, f"lin{i}")[None, :, None, None],
                                                 dim=1))
        return total


def make_lpips(weights_path: str, log=print):
    """LPIPS module (on the CPU), or None when no weights are configured or
    the file is missing or malformed (the metric is then skipped). A file
    that is not a whole zip archive (a truncated download) is malformed
    too: the reference raises zipfile.BadZipFile there."""
    if not weights_path:
        return None
    try:
        return LPIPS(weights_path)
    except (OSError, ValueError, zipfile.BadZipFile) as e:
        log(f"LPIPS disabled: {e}")
        return None
