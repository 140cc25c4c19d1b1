"""Frequency positional encoding (port of `panopticnerf_tpu/ops/encoding.py`)."""

from __future__ import annotations

import torch


def posenc_dim(dim: int, num_freqs: int, include_input: bool = True) -> int:
    return dim * (2 * num_freqs + (1 if include_input else 0))


def positional_encoding(x: torch.Tensor, num_freqs: int,
                        include_input: bool = True) -> torch.Tensor:
    """gamma(x) = [x, sin(2^0 x), cos(2^0 x), ..., sin(2^{F-1} x), cos(2^{F-1} x)].

    x: (..., D). Returns (..., D*(2F+1)) (or D*2F without the identity);
    within a band the D sines come first, then the D cosines.
    """
    if num_freqs == 0:
        return x if include_input else x.new_zeros(x.shape[:-1] + (0,))
    freqs = 2.0 ** torch.arange(num_freqs, dtype=x.dtype, device=x.device)  # (F,)
    xb = x[..., None, :] * freqs[:, None]                                   # (..., F, D)
    enc = torch.cat([torch.sin(xb), torch.cos(xb)], dim=-1)                 # (..., F, 2D)
    enc = enc.reshape(*x.shape[:-1], num_freqs * 2 * x.shape[-1])
    if include_input:
        enc = torch.cat([x, enc], dim=-1)
    return enc
