"""NeRF field network with semantic head (port of `panopticnerf_tpu/models/nerf.py`).

Frequency PE (10 xyz / 4 dir bands), an 8x256 ReLU trunk that re-injects
the position encoding after the skip layer -> sigma + feature; a
view-independent semantic head; a view-dependent colour branch
(feature + dir PE -> 128 -> rgb). Coarse and fine fields are separate
instances.

Precision follows the reference's flax placement exactly: the encodings are
computed in float32 and cast to the compute dtype; every Dense multiplies
in the compute dtype with its float32 parameters cast down, rounds the
product, then adds the cast-down bias; sigma, the semantic logits and rgb
are promoted to float32.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from panopticnerf_tpu_torch.config import ModelConfig
from panopticnerf_tpu_torch.ops.encoding import positional_encoding, posenc_dim


def coarse_field_cfg(cfg: ModelConfig, has_fine: bool) -> ModelConfig:
    """Effective config of the COARSE field: `cfg`, unless the small-coarse
    override (model.coarse_trunk_depth/width) is set and a fine field exists
    — then the coarse trunk shrinks and skips past the new depth drop."""
    if not has_fine or not (cfg.coarse_trunk_depth or cfg.coarse_trunk_width):
        return cfg
    depth = cfg.coarse_trunk_depth or cfg.trunk_depth
    width = cfg.coarse_trunk_width or cfg.trunk_width
    return dataclasses.replace(
        cfg, trunk_depth=depth, trunk_width=width,
        skips=tuple(s for s in cfg.skips if s < depth - 1),
        color_width=min(cfg.color_width, width),
    )


def _dense(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """flax Dense(dtype=dtype, param_dtype=float32): x @ W in `dtype`, then
    + b in `dtype` (two roundings, as flax does)."""
    return torch.nn.functional.linear(x, layer.weight.to(dtype)) + layer.bias.to(dtype)


class NeRFMLP(nn.Module):
    """One radiance + semantics field (coarse or fine)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = getattr(torch, cfg.compute_dtype)
        x_dim = posenc_dim(3, cfg.xyz_freqs)
        d_dim = posenc_dim(3, cfg.dir_freqs)
        w = cfg.trunk_width
        in_dim = x_dim
        for i in range(cfg.trunk_depth):
            setattr(self, f"trunk_{i}", nn.Linear(in_dim, w))
            in_dim = w + x_dim if i in cfg.skips else w
        self.sigma = nn.Linear(in_dim, 1)
        if cfg.use_semantic:
            self.sem_hidden = nn.Linear(in_dim, w // 2)
            self.sem_out = nn.Linear(w // 2, cfg.num_classes)
        self.feature = nn.Linear(in_dim, w)
        self.color_hidden = nn.Linear(w + (d_dim if cfg.use_viewdirs else 0), cfg.color_width)
        self.color_out = nn.Linear(cfg.color_width, 3)

    def forward(self, pts: torch.Tensor, viewdirs: Optional[torch.Tensor]):
        """pts (..., 3) scene-normalised positions; viewdirs (..., 3) unit,
        broadcastable against pts. Returns (sigma (...,), rgb (..., 3),
        sem_logits (..., C) | None), all float32."""
        c = self.cfg
        dt = self.compute_dtype
        x_enc = positional_encoding(pts, c.xyz_freqs).to(dt)
        h = x_enc
        for i in range(c.trunk_depth):
            h = torch.relu(_dense(h, getattr(self, f"trunk_{i}"), dt))
            if i in c.skips:
                h = torch.cat([h, x_enc], dim=-1)

        sigma = _dense(h, self.sigma, dt)[..., 0].float()
        sem_logits = None
        if c.use_semantic:
            s = torch.relu(_dense(h, self.sem_hidden, dt))
            sem_logits = _dense(s, self.sem_out, dt).float()

        feat = _dense(h, self.feature, dt)
        if c.use_viewdirs and viewdirs is not None:
            d_enc = positional_encoding(viewdirs, c.dir_freqs).to(dt)
            d_enc = d_enc.expand(*feat.shape[:-1], d_enc.shape[-1])
            feat = torch.cat([feat, d_enc], dim=-1)
        r = torch.relu(_dense(feat, self.color_hidden, dt))
        rgb = torch.sigmoid(_dense(r, self.color_out, dt)).float()
        return sigma, rgb, sem_logits


class PanopticNeRF(nn.Module):
    """Coarse (+ fine) field pair; `level` 0 = coarse, 1 = fine."""

    def __init__(self, cfg: ModelConfig, has_fine: bool = False):
        super().__init__()
        self.has_fine = has_fine
        self.coarse = NeRFMLP(coarse_field_cfg(cfg, has_fine))
        if has_fine:
            self.fine = NeRFMLP(cfg)

    def forward(self, pts, viewdirs, level: int = 0):
        if level == 1 and self.has_fine:
            return self.fine(pts, viewdirs)
        return self.coarse(pts, viewdirs)
