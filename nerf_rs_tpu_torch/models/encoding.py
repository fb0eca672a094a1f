"""Sinusoidal positional encoding (NeRF paper eq. 4), mip-NeRF's
integrated encoding and the reference's screen-space encodings, the
counterparts of ``posenc``, ``integrated_posenc`` and ``screen_*`` in
``nerf_rs_tpu/models/encoding.py``.

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


# The reference's screen-space encodings (its src/input_transforms.rs), on
# (..., 2) pixel coordinates in its index order, (row y, col x).

def screen_identity(e) -> torch.Tensor:
    """The coordinates as f32 (the reference's ``identity``)."""
    return torch.as_tensor(e, dtype=torch.float32)


def screen_scale(e, height: int, width: int) -> torch.Tensor:
    """(y / height, x / width) (``scale_by_screen_size``)."""
    e = torch.as_tensor(e, dtype=torch.float32)
    return e / torch.tensor([height, width], dtype=torch.float32, device=e.device)


def _center(e: torch.Tensor) -> torch.Tensor:
    """(1 - y - 0.5, x - 0.5) (the reference's ``center``)."""
    return torch.stack([1.0 - e[..., 0] - 0.5, e[..., 1] - 0.5], dim=-1)


def screen_scale_center(e, height: int, width: int) -> torch.Tensor:
    """``_center`` of ``screen_scale`` (``scale_by_screen_size_and_center``)."""
    return _center(screen_scale(e, height, width))


def screen_coconet(e, height: int, width: int) -> torch.Tensor:
    """The reference's 6-wide ``corners_and_polar``: (y, x, 1 - y, 1 - x) of
    the scaled coordinate, then the radius and 1 / tan(y / x) of the scaled
    and centred one (both offset by 1e-6, as the reference has them)."""
    s = screen_scale(e, height, width)
    c = _center(s)
    r = torch.sqrt(c[..., 0] ** 2 + c[..., 1] ** 2)
    cot = 1.0 / torch.tan(c[..., 0] / (c[..., 1] + 1e-6) + 1e-6)
    return torch.stack([s[..., 0], s[..., 1], 1.0 - s[..., 0], 1.0 - s[..., 1], r, cot],
                       dim=-1)


def screen_fourier(e, height: int, width: int, out_dim: int) -> torch.Tensor:
    """The reference's ``fourier_features`` with its quirks: of ``out_dim``
    slots only the first out_dim // 2 are filled, sin(2^(i // 2) x) at even
    i and cos(2^(i // 2) y) at odd i over the scaled and centred
    coordinate; the rest stay 0."""
    c = screen_scale_center(e, height, width)
    half = out_dim // 2
    feats = [torch.sin(2.0 ** (i // 2) * c[..., 1]) if i % 2 == 0
             else torch.cos(2.0 ** (i // 2) * c[..., 0]) for i in range(half)]
    feats += [torch.zeros_like(c[..., 0])] * (out_dim - half)
    return torch.stack(feats, dim=-1)
