"""Sampling along rays, the counterpart of ``nerf_rs_tpu/ops/sampling.py``:
stratified point samples (even in t, or in 1/t for unbounded scenes), the
reference's compat draw (``compat_ts``), mip-NeRF's conical-frustum
Gaussians, and hierarchical resampling (``sample_pdf``, ``merge_ts``).

Random draws come from an explicit ``torch.Generator``; torch and JAX
streams differ, so parity tests use ``randomized=False`` (bin
midpoints) or hand both sides the same numbers (``invert_cdf`` takes
the uniforms ``sample_pdf`` would draw).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch


def stratified_ts(
    num_rays: int,
    num_samples: int,
    near: float,
    far: float,
    randomized: bool = True,
    generator: Optional[torch.Generator] = None,
    device=None,
    space: str = "linear",
) -> torch.Tensor:
    """(num_rays, num_samples) sorted sample distances: [near, far] cut
    into num_samples even bins, one uniform draw per bin (NeRF eq. 2),
    or the bin midpoints when ``randomized`` is False.

    ``space="disparity"`` makes the bins even in 1/t between 1/near and
    1/far (mip-NeRF 360's unbounded spacing; near > 0), laid out so that
    the ts still ascend."""
    if space == "disparity":
        bins = 1.0 / torch.linspace(1.0 / near, 1.0 / far, num_samples + 1, device=device)
    elif space == "linear":
        bins = torch.linspace(near, far, num_samples + 1, device=device)
    else:
        raise ValueError(f"space must be 'linear' or 'disparity', got {space!r}")
    lower, upper = bins[:-1], bins[1:]
    if randomized:
        u = torch.rand((num_rays, num_samples), generator=generator,
                       device=generator.device if generator is not None else device)
        u = u.to(bins.device)
    else:
        u = torch.full((num_rays, num_samples), 0.5, device=device)
    return lower + (upper - lower) * u


def compat_ts(
    num_rays: int,
    num_samples: int,
    far: float,
    randomized: bool = True,
    generator: Optional[torch.Generator] = None,
    device=None,
) -> torch.Tensor:
    """The reference's effective sample distances, (num_rays, num_samples):
    randomized, t = u * far over [0, far) sorted per ray; else t = i / n *
    far, which starts at t = 0. There is no near plane: the reference's
    ``t *= (T_FAR - HITHER) + HITHER`` parses as ``t * T_FAR`` (SURVEY.md
    section 2.8), and compat keeps that."""
    if randomized:
        u = torch.rand((num_rays, num_samples), generator=generator,
                       device=generator.device if generator is not None else device)
        return torch.sort(u.to(device) * far, dim=-1).values
    t = torch.arange(num_samples, dtype=torch.float32, device=device) / num_samples * far
    return t.expand(num_rays, num_samples)


def deltas_from_ts(ts: torch.Tensor, far: float) -> torch.Tensor:
    """delta_i = t_{i+1} - t_i with t_N := far: the far plane is the
    last exit."""
    last = torch.full(ts.shape[:-1] + (1,), far, dtype=ts.dtype, device=ts.device)
    return torch.cat([ts[..., 1:], last], dim=-1) - ts


def points_from_ts(
    origins: torch.Tensor, dirs: torch.Tensor, ts: torch.Tensor
) -> torch.Tensor:
    """World-space sample points o + t*d: (..., S, 3)."""
    return origins[..., None, :] + ts[..., :, None] * dirs[..., None, :]


def conical_gaussians(
    origins: torch.Tensor,
    dirs: torch.Tensor,
    edges: torch.Tensor,
    base_radius,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-interval conical-frustum Gaussians for mip-NeRF's integrated
    encoding (arXiv 2103.13415 eqs. 7 and 16, the stable form). The S =
    edges.shape[-1] - 1 intervals [t0, t1] along a cone of base radius
    ``base_radius`` (a float, or a (..., 1) tensor per ray) become
    Gaussians with mean o + t_mean d and a diagonal covariance built
    from the along-ray variance t_var and the across-ray r_var.

    Returns (mean (..., S, 3), var (..., S, 3), midpoints (..., S),
    exact interval lengths (..., S)).
    """
    t0, t1 = edges[..., :-1], edges[..., 1:]
    mu = 0.5 * (t0 + t1)
    hw = 0.5 * (t1 - t0)
    mu2, hw2 = mu * mu, hw * hw
    denom = 3.0 * mu2 + hw2
    t_mean = mu + 2.0 * mu * hw2 / denom
    t_var = hw2 / 3.0 - (4.0 / 15.0) * (hw2 * hw2 * (12.0 * mu2 - hw2) / (denom * denom))
    r_var = base_radius * base_radius * (
        mu2 / 4.0 + (5.0 / 12.0) * hw2 - (4.0 / 15.0) * hw2 * hw2 / denom)
    d2 = dirs * dirs
    dnorm2 = torch.clamp(torch.sum(d2, dim=-1, keepdim=True), min=1e-10)
    mean = origins[..., None, :] + t_mean[..., :, None] * dirs[..., None, :]
    var = (t_var[..., :, None] * d2[..., None, :]
           + r_var[..., :, None] * (1.0 - d2[..., None, :] / dnorm2[..., None, :]))
    return mean, var, mu, t1 - t0


def pixel_radius(camera) -> float:
    """The pixel's footprint at unit distance along the ray, the cone
    base radius of mip-NeRF sampling: 2 / sqrt(12) of the pixel's width
    in world units."""
    focal = camera.focal
    if focal is None:
        focal = 0.5 * camera.width / math.tan(0.5 * camera.fov)
    return float(2.0 / math.sqrt(12.0) / focal)


def sample_pdf(
    bins: torch.Tensor,
    weights: torch.Tensor,
    num_samples: int,
    randomized: bool = True,
    generator: Optional[torch.Generator] = None,
    eps: float = 1e-5,
) -> torch.Tensor:
    """Inverse-CDF sampling of the piecewise-constant ray PDF that
    ``weights`` (..., B) put on the bins (..., B + 1) (NeRF section 5.2).
    Returns (..., num_samples) new distances, sorted per ray: the draw
    is stratified in CDF space (one jittered u per equal-mass bin), so u
    rises along each ray and its inverse does too. Deterministic draws
    are evenly spaced in [0, 1 - 1e-6]."""
    shape = weights.shape[:-1] + (num_samples,)
    dev = weights.device
    if randomized:
        jitter = torch.rand(shape, generator=generator,
                            device=generator.device if generator is not None else dev)
        u = (torch.arange(num_samples, dtype=torch.float32, device=dev)
             + jitter.to(dev)) / num_samples
    else:
        u = torch.linspace(0.0, 1.0 - 1e-6, num_samples, device=dev).expand(shape)
    return invert_cdf(bins, weights, u, eps)


def invert_cdf(bins: torch.Tensor, weights: torch.Tensor, u: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """The inverse of the CDF of ``weights`` over ``bins`` at the sorted
    draws ``u`` (..., F): the step of ``sample_pdf`` after the draw, with
    the JAX package's arithmetic (weights + eps, the bracketing CDF and
    bin entries, a denominator below eps read as 1)."""
    weights = weights + eps  # no NaN on empty rays
    pdf = weights / torch.sum(weights, dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)
    u = u.contiguous()
    # entries of the monotone cdf at or below u: the last of them brackets
    # u from below, the first above it from above (the JAX masked max/min)
    above = torch.searchsorted(cdf.contiguous(), u, right=True)
    last = cdf.shape[-1] - 1
    below = torch.clamp(above - 1, min=0)
    above = torch.clamp(above, max=last)
    cdf_below, cdf_above = cdf.gather(-1, below), cdf.gather(-1, above)
    bins_below, bins_above = bins.gather(-1, below), bins.gather(-1, above)
    denom = cdf_above - cdf_below
    denom = torch.where(denom < eps, torch.ones_like(denom), denom)
    frac = (u - cdf_below) / denom
    return (bins_below + frac * (bins_above - bins_below)).detach()


def merge_ts(coarse_ts: torch.Tensor, fine_ts: torch.Tensor) -> torch.Tensor:
    """Union of two per-ray sorted sample sets, sorted (NeRF section 5.2:
    the fine network evaluates the combined set). Each element lands at
    its own rank plus the count of the other set's elements before it;
    on a tie the coarse sample comes first."""
    a, b = coarse_ts.contiguous(), fine_ts.contiguous()
    sa, sb = a.shape[-1], b.shape[-1]
    pa = torch.arange(sa, device=a.device) + torch.searchsorted(b, a, right=False)
    pb = torch.arange(sb, device=a.device) + torch.searchsorted(a, b, right=True)
    out = torch.empty(a.shape[:-1] + (sa + sb,), dtype=a.dtype, device=a.device)
    return out.scatter_(-1, torch.cat([pa, pb], dim=-1), torch.cat([a, b], dim=-1))
