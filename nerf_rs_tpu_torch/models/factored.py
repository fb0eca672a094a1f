"""The factored (CP-decomposed) multiresolution radiance field, the
counterpart of ``nerf_rs_tpu/models/factored.py``.

Per axis a and point n, a 2-hot-per-level "hat basis" row W_a[n, :]
over the concatenated knots of every level (relu(1 - |u * res - knot|),
resolutions on a geometric ladder like the hash pyramid's) times a dense
(sumR, C) line table gives the axis feature; the encoding is the CP
product of the three axes' features, enc[n, c] = X[n, c] Y[n, c]
Z[n, c]; the tiny sigma and color heads of ``models/hashgrid.py`` map it
to (sigma_raw, rgb_raw).

Two encode routes, as in the JAX package, chosen by
``ModelConfig.fac_fused``:
  * ``factored_encode`` (off, the CLI's route): the dense hat matrix
    times the lines in the matmul dtype. Under "mixed" that is a bf16
    product whose output is bf16, and the CP product runs in bf16, as
    ``w @ lines.astype(bf16)`` does in the JAX package.
  * ``kernels/fused_factored.fused_factored_encode`` (on): the CUDA
    kernel K3, which multiplies bf16-rounded weights and lines in f32 and
    returns f32 features; the heads cast them to bf16 afterwards.

The field is a ``FactoredField`` holding ``lines`` (3, sumR, C) and the
heads, keyed like the JAX tree (``lines``, ``sigma1.w``, ...).
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..config import ModelConfig

from .hashgrid import apply_tiny_heads, init_tiny_heads
from .mlp import he_init_, seed_rng


def fac_resolutions(cfg: ModelConfig) -> List[int]:
    """Geometric resolution ladder base..max, like the hash pyramid."""
    L = cfg.fac_levels
    if L == 1:
        return [cfg.fac_base_res]
    b = math.exp(
        (math.log(cfg.fac_max_res) - math.log(cfg.fac_base_res)) / (L - 1)
    )
    return [int(math.floor(cfg.fac_base_res * (b ** l))) for l in range(L)]


def knot_constants(cfg: ModelConfig) -> Tuple[np.ndarray, np.ndarray]:
    """Per-column (res[j], knot[j]) of the concatenated level grids: a
    level of resolution R contributes R + 1 knots (both endpoints)."""
    res, knot = [], []
    for r in fac_resolutions(cfg):
        res.extend([r] * (r + 1))
        knot.extend(range(r + 1))
    return np.asarray(res, np.float32), np.asarray(knot, np.float32)


def basis_dim(cfg: ModelConfig) -> int:
    return sum(r + 1 for r in fac_resolutions(cfg))


class FactoredField(nn.Module):
    """Parameters of the factored field; ``forward`` is ``apply_nerf``."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.lines = nn.Parameter(torch.zeros(3, basis_dim(cfg), cfg.fac_comps, device=device))
        init_tiny_heads(self, cfg.fac_comps, cfg, device)

    def forward(self, points, viewdirs, dtype=None):
        from .mlp import apply_nerf

        return apply_nerf(self, points, viewdirs, self.cfg, dtype)


def init_factored_params(cfg: ModelConfig, seed: int = 0, device=None,
                         stream: int = 0) -> FactoredField:
    """Lines N(0, ``fac_init_scale``), then the heads He truncated-normal
    with zero biases, all drawn with numpy from ``seed`` (``stream`` as
    in ``mlp.init_nerf_params``): the same weights on every device and
    torch version."""
    rng = seed_rng(seed, stream)
    model = FactoredField(cfg)
    with torch.no_grad():
        lines = cfg.fac_init_scale * rng.standard_normal(tuple(model.lines.shape))
        model.lines.copy_(torch.from_numpy(lines))
    he_init_(model, rng)
    return model.to(device)


def unit_coords(points: torch.Tensor, aabb: float) -> torch.Tensor:
    """(N, 3) world points -> clip((p + aabb) / (2 aabb), 0, 1), with an
    IEEE f32 division (a CUDA division by a Python scalar multiplies by
    its reciprocal instead, which can move a hat weight)."""
    two = torch.full((), 2.0 * aabb, dtype=torch.float32, device=points.device)
    return torch.clamp((points + aabb) / two, 0.0, 1.0)


def hat_weights(u_axis: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """(N,) coordinates in [0, 1] -> (N, sumR) f32 hat weights
    max(0, 1 - |u * res[j] - knot[j]|): the two knots around the point
    on every level. f32, the caller casts afterwards (a bf16 position at
    R = 512 would quantise the cell)."""
    res, knot = (torch.from_numpy(c).to(u_axis.device) for c in knot_constants(cfg))
    pos = u_axis[:, None] * res[None, :]
    return F.relu(1.0 - torch.abs(pos - knot[None, :]))


def factored_encode(lines: torch.Tensor, points: torch.Tensor, cfg: ModelConfig,
                    dtype=None) -> torch.Tensor:
    """(..., 3) world points -> (..., C) CP-product features, through the
    dense hat matrix in the matmul ``dtype`` (bf16 features under a bf16
    ``dtype``). Differentiable in the lines and the points."""
    lead = points.shape[:-1]
    u = unit_coords(points.reshape(-1, 3), cfg.fac_aabb)
    mm = dtype if dtype is not None else torch.float32
    enc = None
    for a in range(3):
        feat = hat_weights(u[:, a], cfg).to(mm) @ lines[a].to(mm)  # (N, C)
        enc = feat if enc is None else enc * feat
    return enc.reshape(*lead, cfg.fac_comps)


def apply_factored(
    params: FactoredField,
    points: torch.Tensor,
    viewdirs: Optional[torch.Tensor],
    cfg: ModelConfig,
    dtype=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sigma_raw (...,), rgb_raw (..., 3)), f32, before the activations:
    the encode of ``cfg.fac_fused``'s route, then the tiny heads."""
    if cfg.fac_fused:
        from ..kernels.fused_factored import fused_factored_encode

        enc = fused_factored_encode(params.lines, points, cfg, dtype)
    else:
        enc = factored_encode(params.lines, points, cfg, dtype)
    return apply_tiny_heads(params, enc, viewdirs, cfg, dtype)
