"""Field apply of the training step (port of
`panopticnerf_tpu/models/pallas_apply.py`), in one of three modes:

- "trunk": the 8x256 trunk runs through `ops.mlp_train.fused_trunk_train`
  (kernels B / B' on the card); the heads stay plain PyTorch ops rounded
  as the reference's XLA heads round them (below);
- "field": the whole field, trunk and heads, through
  `ops.field_train.field_train_apply` (kernel C forward, C' backward);
- "hybrid": `ops.field_train.field_hybrid_apply`, a flax-placement
  forward in plain PyTorch GEMMs and kernel C' as the backward.

The heads of mode "trunk":
- one concatenated [feature | sem_hidden | sigma] product, rounded, then
  the bias added (both in the compute dtype);
- `sem_out` on the ReLU of the sem_hidden slice;
- the colour branch as feat @ Wch[:W] + d_enc @ Wch[W:] + b, each step
  rounded in that order, then the sigmoid in float32.
A small proposal coarse field (model.coarse_trunk_depth/width) runs its
trunk as the plain flax chain and the trunk-mode heads in every mode.
A hybrid field (model.hash_grid, port-only) runs in mode "trunk"
alone: the trunk through B / B', the grid as its plain differentiable
encoding (`ops/hash_grid.py`), and the heads as above on [h, g]; modes
"field" and "hybrid" (kernels C / C', which have no grid input) raise
ValueError.
The JAX package sends any mode string other than "trunk" and "hybrid" to
the field path; the port takes exactly the three names and raises
ValueError for any other.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.nn import functional as F

from panopticnerf_tpu_torch.config import ModelConfig
from panopticnerf_tpu_torch.models.nerf import PanopticNeRF, _dense, coarse_field_cfg
from panopticnerf_tpu_torch.ops.encoding import positional_encoding
from panopticnerf_tpu_torch.ops.field_train import (
    FieldDims,
    field_hybrid_apply,
    field_train_apply,
)
from panopticnerf_tpu_torch.ops.mlp_train import fused_trunk_train

MODES = ("trunk", "hybrid", "field")


def _check_mode(cfg: ModelConfig, mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"model.pallas_mode {mode!r} is not one of {MODES}")
    if mode != "trunk" and cfg.hash_grid:
        raise ValueError(f"model.pallas_mode {mode!r} has no hash grid input (kernels C / C'); "
                         "a field with model.hash_grid trains in mode 'trunk' or with "
                         "model.use_pallas false")


def fused_field_apply(model: PanopticNeRF, cfg: ModelConfig, pts: torch.Tensor,
                      viewdirs: Optional[torch.Tensor], level: int = 0,
                      mode: str = "trunk"):
    """Same contract as `PanopticNeRF.forward` (scene-normalised pts)."""
    _check_mode(cfg, mode)
    net = model.fine if (level == 1 and model.has_fine) else model.coarse
    eff = coarse_field_cfg(cfg, model.has_fine) if level == 0 else cfg
    small_coarse = eff is not cfg
    c = eff
    dt = getattr(torch, c.compute_dtype)
    shape = pts.shape[:-1]
    x_enc = positional_encoding(pts.reshape(-1, 3), c.xyz_freqs).to(dt)

    d_enc = None
    if c.use_viewdirs and viewdirs is not None:
        d = torch.broadcast_to(viewdirs, pts.shape).reshape(-1, 3)
        d_enc = positional_encoding(d, c.dir_freqs).to(dt)

    # flax concatenates after layer s, so the layer consuming [h, x] is s + 1
    kernel_skips = tuple(s + 1 for s in c.skips if s + 1 < c.trunk_depth)
    if mode != "trunk" and not small_coarse:
        dims = FieldDims(
            x_dim=x_enc.shape[-1], d_dim=0 if d_enc is None else d_enc.shape[-1],
            width=c.trunk_width, sem_hidden=c.trunk_width // 2, color_width=c.color_width,
            num_classes=c.num_classes, layers=c.trunk_depth, skips=kernel_skips,
            use_sem=c.use_semantic)
        fn = field_hybrid_apply if mode == "hybrid" else field_train_apply
        sigma, rgb, sem = fn(net, dims, x_enc, d_enc)
        return _reshape(sigma, rgb, sem, shape, c.num_classes)

    layers = [getattr(net, f"trunk_{i}") for i in range(c.trunk_depth)]
    if small_coarse:
        h = x_enc
        for i, layer in enumerate(layers):
            h = torch.relu(_dense(h, layer, dt))
            if i in c.skips:
                h = torch.cat([h, x_enc], dim=-1)
    else:
        h = fused_trunk_train(x_enc, [layer.weight.t() for layer in layers],
                              [layer.bias for layer in layers], kernel_skips).to(dt)

    if net.grid is not None:
        h = torch.cat([h, net.grid(pts.reshape(-1, 3)).to(dt)], dim=-1)
    heads = [net.feature] + ([net.sem_hidden] if c.use_semantic else []) + [net.sigma]
    w_cat = torch.cat([m.weight for m in heads]).to(dt)
    b_cat = torch.cat([m.bias for m in heads]).to(dt)
    hw = F.linear(h, w_cat) + b_cat
    width = c.trunk_width
    sigma = hw[..., -1].float()
    sem = None
    if c.use_semantic:
        s = torch.relu(hw[..., width:width + width // 2])
        sem = _dense(s, net.sem_out, dt).float()
    feat = hw[..., :width]
    if d_enc is not None:
        w_ch = net.color_hidden.weight.to(dt)
        pre = (F.linear(feat, w_ch[:, :width]) + F.linear(d_enc, w_ch[:, width:])
               + net.color_hidden.bias.to(dt))
    else:
        pre = _dense(feat, net.color_hidden, dt)
    r = torch.relu(pre)
    rgb = torch.sigmoid(_dense(r, net.color_out, dt).float())
    return _reshape(sigma, rgb, sem, shape, c.num_classes)


def _reshape(sigma, rgb, sem, shape, num_classes):
    return (sigma.reshape(shape), rgb.reshape(*shape, 3),
            None if sem is None else sem.reshape(*shape, num_classes))


class FusedTrainAdapter:
    """Drop-in for `PanopticNeRF` in `render_rays` (called as
    `adapter(pts, viewdirs, level=...)`) that runs the fused field on the
    model's own parameters, so gradients reach them as they would through
    the plain model."""

    def __init__(self, model: PanopticNeRF, cfg_model: ModelConfig, mode: str = "trunk"):
        _check_mode(cfg_model, mode)
        self.model = model
        self.cfg = cfg_model
        self.mode = mode

    def __call__(self, pts, viewdirs, level: int = 0):
        return fused_field_apply(self.model, self.cfg, pts, viewdirs, level=level,
                                 mode=self.mode)
