"""Sinusoidal positional encoding (NeRF paper eq. 4) and mip-NeRF's
integrated encoding, the counterparts of ``posenc`` and
``integrated_posenc`` in ``nerf_rs_tpu/models/encoding.py``.

Column layout is the JAX package's: the raw input first (when
``include_input``), then per level ``l`` the block [sin(2^l x),
cos(2^l x)] over all input dims. The fused kernel reproduces the same
layout (``kernels/fused_render.pe_encode``).
"""

from __future__ import annotations

import torch


def posenc(x: torch.Tensor, levels: int, include_input: bool = True) -> torch.Tensor:
    """gamma(x) for (..., D) inputs -> (..., D * (2 * levels [+ 1]))."""
    if levels == 0:
        return x
    scales = 2.0 ** torch.arange(levels, dtype=x.dtype, device=x.device)  # (L,)
    xb = x[..., None, :] * scales[:, None]  # (..., L, D)
    four = torch.cat([torch.sin(xb), torch.cos(xb)], dim=-1)  # (..., L, 2D)
    flat = four.reshape(*x.shape[:-1], -1)
    if include_input:
        return torch.cat([x, flat], dim=-1)
    return flat


def integrated_posenc(mean: torch.Tensor, var: torch.Tensor, levels: int,
                      include_input: bool = True) -> torch.Tensor:
    """mip-NeRF's integrated encoding (arXiv 2103.13415 eq. 14) of
    diagonal Gaussians (mean, var), both (..., D): the expected sinusoid
    under the Gaussian, i.e. sin and cos of 2^l mean damped by
    exp(-4^l var / 2). The layout is ``posenc``'s, with the raw mean
    first, so the same weights take either encoding."""
    if levels == 0:
        return mean
    scales = 2.0 ** torch.arange(levels, dtype=mean.dtype, device=mean.device)  # (L,)
    xb = mean[..., None, :] * scales[:, None]  # (..., L, D)
    damp = torch.exp(-0.5 * var[..., None, :] * (scales * scales)[:, None])
    four = torch.cat([torch.sin(xb) * damp, torch.cos(xb) * damp], dim=-1)
    flat = four.reshape(*mean.shape[:-1], -1)
    if include_input:
        return torch.cat([mean, flat], dim=-1)
    return flat


def posenc_dim(in_dim: int, levels: int, include_input: bool = True) -> int:
    if levels == 0:
        return in_dim
    return in_dim * (2 * levels + (1 if include_input else 0))
