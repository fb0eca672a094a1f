"""Point sampling along rays, the counterpart of the linear-space part
of ``nerf_rs_tpu/ops/sampling.py``.

Random draws come from an explicit ``torch.Generator``; torch and JAX
streams differ, so parity tests use ``randomized=False`` (bin
midpoints) or hand both sides the same numbers. Disparity-space
stratification comes with slice 5, hierarchical resampling with slice 2.
"""

from __future__ import annotations

from typing import Optional

import torch


def stratified_ts(
    num_rays: int,
    num_samples: int,
    near: float,
    far: float,
    randomized: bool = True,
    generator: Optional[torch.Generator] = None,
    device=None,
) -> torch.Tensor:
    """(num_rays, num_samples) sorted sample distances: [near, far] cut
    into num_samples even bins, one uniform draw per bin (NeRF eq. 2),
    or the bin midpoints when ``randomized`` is False."""
    bins = torch.linspace(near, far, num_samples + 1, device=device)
    lower, upper = bins[:-1], bins[1:]
    if randomized:
        u = torch.rand((num_rays, num_samples), generator=generator,
                       device=generator.device if generator is not None else device)
        u = u.to(bins.device)
    else:
        u = torch.full((num_rays, num_samples), 0.5, device=device)
    return lower + (upper - lower) * u


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
