"""Plain PyTorch reference of PanopticNeRF-360's hybrid scene field (Fu et
al., T-PAMI 2025, arXiv 2309.10815): the NeRF field of `reference/nerf.py`
with a multi-resolution hash grid beside its trunk (Instant-NGP, Müller et
al., arXiv 2201.05989), whose features join the trunk's output at the input
of the sigma, sem_hidden and feature heads. The pipeline around the field
(intersection, sampling, compositing, the losses, Adam, the tiled view) is
nerf's, given this field.

It imports nothing of the program under test, and no kernel. The grid,
Instant-NGP's sizes for NeRF (L = 16 levels of F = 2 features, tables of
T = 2^19 rows, resolutions N_min = 16 to N_max = 2048; the configuration's
`assumed`), on a scene-normalised point p:
- u = clamp((p + 1) / 2, 0, 1); N_l = floor(N_min b^l) in float64, b =
  exp((ln N_max - ln N_min) / (L - 1));
- x = u N_l, i = min(floor(x), N_l - 1), t = x - i; the 8 corners k = i + c;
  a level with (N_l + 1)^3 <= T is dense (row k_0 + k_1 (N_l + 1) + k_2 (N_l +
  1)^2), the others hashed (row (k_0 xor k_1 2654435761 xor k_2 805459861)
  mod T, uint32);
- f_l = sum over the corners of the trilinear weight times the row, float32;
  g = [f_0 .. f_{L-1}] cast to bf16, as the positional encoding is.
tiny-cuda-nn's +0.5 cell offset and `scale - 1` resolutions are not
followed; the paper's floor(N_min b^l) is. Then h' = [h, g] feeds sigma,
sem_hidden and feature, every Dense in flax's bf16 placement (nerf's).

The draw (`make_weights`): nerf's lecun-normal draw of every Dense weight in
the same order (the heads at their widened fan-in), zero biases, then every
table uniform in +-1 from the same generator. Instant-NGP draws its tables
in +-1e-4, where the grid adds less to rgb than `rgb_gap`'s limit, so that
a program that skipped the grid would pass; at +-1 the grid moves every map.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from reference import nerf
from reference.nerf import fp8_quant, leaf_gap, quiet_leaves  # noqa: F401 (the contract)

PRIMES = (1, 2654435761, 805459861)
TABLE_RANGE = 1.0
LEVELS, FEATURES, TABLE, MIN_RES, MAX_RES = 16, 2, 1 << 19, 16, 2048


def grid_levels() -> list[tuple[int, int, bool]]:
    """(N_l, rows, dense) of every level of the grid."""
    b = math.exp((math.log(MAX_RES) - math.log(MIN_RES)) / (LEVELS - 1))
    out = []
    for level in range(LEVELS):
        res = math.floor(MIN_RES * b ** level)
        dense = (res + 1) ** 3 <= TABLE
        out.append((res, (res + 1) ** 3 if dense else TABLE, dense))
    return out


def param_shapes(cfg: dict) -> dict:
    """nerf's parameters with the sigma, sem_hidden and feature heads reading
    L x F more columns, then each field's tables `<field>.grid.table_<l>`
    (rows_l, F)."""
    extra = LEVELS * FEATURES
    out = {}
    for k, s in nerf.param_shapes(cfg).items():
        head = k.rsplit(".", 2)[1] in ("sigma", "sem_hidden", "feature")
        out[k] = (s[0], s[1] + extra) if head and k.endswith(".weight") else s
    for prefix in ("coarse", "fine"):
        for level, (_, rows, _) in enumerate(grid_levels()):
            out[f"{prefix}.grid.table_{level}"] = (rows, FEATURES)
    return out


def make_weights(conf_program: dict, seed: int, device) -> dict:
    """Every parameter of both hybrid fields, f32 on `device`: nerf's draw of
    the Dense weights (one uniform draw, the truncated normal by its inverse
    CDF, scaled to variance 1 / fan_in), zero biases, then the tables
    uniform in +-TABLE_RANGE, from one generator."""
    shapes = param_shapes(conf_program)
    weights = {k: s for k, s in shapes.items() if k.endswith(".weight")}
    tables = {k: s for k, s in shapes.items() if ".grid." in k}
    total = sum(o * i for o, i in weights.values())
    g = torch.Generator(device).manual_seed(seed)
    flat = nerf.std_normal_trunc(torch.rand(total, generator=g, device=device).clamp(1e-7, 1 - 1e-7))
    out, at = {}, 0
    for k, s in shapes.items():
        if k.endswith(".weight"):
            o, i = s
            out[k] = flat[at:at + o * i].view(o, i) * (1.0 / math.sqrt(i) / 0.87962566103423978)
            at += o * i
        elif k.endswith(".bias"):
            out[k] = torch.zeros(s, device=device)
    for k, s in tables.items():
        out[k] = (torch.rand(s, generator=g, device=device) * 2.0 - 1.0) * TABLE_RANGE
    return out


def grid_encode(params: dict, prefix: str, pts: torch.Tensor) -> torch.Tensor:
    """pts (..., 3) scene-normalised -> the grid's features (..., L x F), f32."""
    u = torch.clamp((pts + 1.0) / 2.0, 0.0, 1.0)
    feats = []
    for level, (res, _, dense) in enumerate(grid_levels()):
        table = params[f"{prefix}.grid.table_{level}"]
        x = u * float(res)
        lo = torch.clamp(torch.floor(x), max=float(res - 1))
        t = x - lo
        lo = lo.long()
        f = None
        for c in range(8):
            cx, cy, cz = c & 1, (c >> 1) & 1, (c >> 2) & 1
            kx, ky, kz = lo[..., 0] + cx, lo[..., 1] + cy, lo[..., 2] + cz
            if dense:
                row = kx + ky * (res + 1) + kz * (res + 1) * (res + 1)
            else:
                row = ((kx * PRIMES[0]) ^ (ky * PRIMES[1]) ^ (kz * PRIMES[2])) % TABLE
            w = ((t[..., 0] if cx else 1.0 - t[..., 0]) * (t[..., 1] if cy else 1.0 - t[..., 1])
                 * (t[..., 2] if cz else 1.0 - t[..., 2]))
            term = w[..., None] * table[row]
            f = term if f is None else f + term
        feats.append(f)
    return torch.cat(feats, -1)


def hybrid_field(params: dict, cfg: dict, level: int, pts: torch.Tensor, dirs: torch.Tensor,
                 quant: Optional[Callable] = None):
    """pts (..., 3) scene-normalised, dirs (..., 3) unit and broadcastable
    -> (sigma (...), rgb (..., 3), sem logits (..., C)), all f32."""
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 products, no TF32
    torch.backends.cudnn.allow_tf32 = False
    m = cfg["model"]
    s = nerf.field_sizes(cfg, level)
    prefix = "coarse" if level == 0 else "fine"
    dt = torch.bfloat16
    q = quant or (lambda a: a)

    def dense(x, name):
        w = params[f"{prefix}.{name}.weight"].to(dt)
        return F.linear(q(x), q(w)) + params[f"{prefix}.{name}.bias"].to(dt)

    x_enc = nerf.posenc(pts, m["xyz_freqs"]).to(dt)
    h = x_enc
    for i in range(s["depth"]):
        h = torch.relu(dense(h, f"trunk_{i}"))
        if i in s["skips"]:
            h = torch.cat([h, x_enc], -1)
    h = torch.cat([h, grid_encode(params, prefix, pts).to(dt)], -1)
    sigma = dense(h, "sigma")[..., 0].float()
    sem = dense(torch.relu(dense(h, "sem_hidden")), "sem_out").float()
    feat = dense(h, "feature")
    d_enc = nerf.posenc(dirs, m["dir_freqs"]).to(dt).expand(*feat.shape[:-1], -1)
    r = torch.relu(dense(torch.cat([feat, d_enc], -1), "color_hidden"))
    rgb = torch.sigmoid(dense(r, "color_out")).float()
    return sigma, rgb, sem


render_view = partial(nerf.render_view, field=hybrid_field)
Trainer = partial(nerf.Trainer, field=hybrid_field)
