"""Ray-ray intersections and the view-consistency probe, the counterpart
of ``nerf_rs_tpu/ops/intersect.py``: closed-form closest approach of two
ray bundles with the reference's validity test (``ray_intersection``),
all pairs of two ray sets (``pairwise_view_intersections``), the mean
density gap at points seen through two view rotations
(``density_consistency``) and the screen map of intersection points the
training loop's diagnostics log (``trace_intersections_to_screen``).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..config import ModelConfig

from ..models.mlp import apply_nerf


class Intersections(NamedTuple):
    point_a: torch.Tensor  # (..., 3) closest point on ray a
    point_b: torch.Tensor  # (..., 3) closest point on ray b
    s: torch.Tensor  # (...,) parameter along a
    t: torch.Tensor  # (...,) parameter along b
    valid: torch.Tensor  # (...,) bool: the rays meet (not parallel, gap < tol, both in range)


def ray_intersection(o_a: torch.Tensor, d_a: torch.Tensor, o_b: torch.Tensor,
                     d_b: torch.Tensor, t_max: float = math.inf,
                     tol: float = 1e-4) -> Intersections:
    """Closest approach of two ray bundles, batched: s, t minimising
    |o_a + s d_a - (o_b + t d_b)|, valid where the directions are not
    parallel (|d_a x d_b|^2 >= tol^2), the gap is under ``tol`` and both
    parameters lie in [0, t_max]. Parallel pairs get s = t = 0."""
    r = o_b - o_a
    a = torch.sum(d_a * d_a, -1)
    b = torch.sum(d_a * d_b, -1)
    c = torch.sum(d_b * d_b, -1)
    d = torch.sum(d_a * r, -1)
    e = torch.sum(d_b * r, -1)
    denom = a * c - b * b
    parallel = denom < tol * tol
    safe = torch.where(parallel, torch.ones_like(denom), denom)
    zero = torch.zeros_like(denom)
    s = torch.where(parallel, zero, (c * d - b * e) / safe)
    t = torch.where(parallel, zero, (b * d - a * e) / safe)
    pa = o_a + s[..., None] * d_a
    pb = o_b + t[..., None] * d_b
    gap = torch.linalg.norm(pa - pb, dim=-1)
    valid = (~parallel) & (gap < tol) & (s >= 0.0) & (s <= t_max) & (t >= 0.0) & (t <= t_max)
    return Intersections(pa, pb, s, t, valid)


def pairwise_view_intersections(o_a: torch.Tensor, d_a: torch.Tensor, o_b: torch.Tensor,
                                d_b: torch.Tensor, t_max: float,
                                tol: float = 1e-3) -> Intersections:
    """Every pair of an (N, 3) and an (M, 3) ray set: (N, M) results."""
    return ray_intersection(o_a[:, None, :], d_a[:, None, :], o_b[None, :, :],
                            d_b[None, :, :], t_max=t_max, tol=tol)


def density_consistency(params, model_cfg: ModelConfig, points: torch.Tensor,
                        pose_a: torch.Tensor, pose_b: torch.Tensor, dtype=None) -> torch.Tensor:
    """mean |sigma(R_a p) - sigma(R_b p)| over world points ``points``
    (N, 3) under the view rotations ``pose_a`` and ``pose_b`` (3, 3), the
    field queried along +z. Zero for a field whose density ignores the
    view; a probe of pipelines that bake the pose into their inputs."""
    pa = torch.einsum("ij,nj->ni", pose_a, points)
    pb = torch.einsum("ij,nj->ni", pose_b, points)
    dirs = torch.tensor([0.0, 0.0, 1.0], device=points.device).expand(pa.shape)
    sig_a, _ = apply_nerf(params, pa, dirs, model_cfg, dtype)
    sig_b, _ = apply_nerf(params, pb, dirs, model_cfg, dtype)
    return torch.mean(torch.abs(sig_a - sig_b))


def trace_intersections_to_screen(inter: Intersections, width: int, height: int,
                                  res: int = 100) -> torch.Tensor:
    """(res, res) map of the valid intersection points' (x, y) over [-2,
    2]^2, normalised to its largest count (all zeros when none is valid).
    ``width`` and ``height`` are the screen's, unused by the map, as in the
    JAX function."""
    pts = inter.point_a.reshape(-1, 3)
    valid = inter.valid.reshape(-1)
    x = torch.clamp(((pts[:, 0] + 2.0) / 4.0 * res).to(torch.int32), 0, res - 1).long()
    y = torch.clamp(((pts[:, 1] + 2.0) / 4.0 * res).to(torch.int32), 0, res - 1).long()
    img = torch.zeros(res * res, device=pts.device)
    img.index_add_(0, y * res + x, valid.float())
    img = img.reshape(res, res)
    m = img.max()
    return torch.where(m > 0, img / m, img)
