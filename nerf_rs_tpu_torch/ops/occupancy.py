"""Occupancy-grid sampling, the counterpart of
``nerf_rs_tpu/ops/occupancy.py`` (the NerfAcc / Instant-NGP lineage): a
coarse (res, res, res) grid of EMA'd raw densities over the scene's AABB
concentrates each ray's fixed sample budget in occupied cells. The same S
samples are drawn by inverse CDF from a per-ray piecewise-constant PDF over
even bins of [near, far] (even in 1/t under disparity spacing) whose mass
sits on the bins whose midpoints the grid calls occupied, blended with a
uniform floor (``occ_uniform_frac``) that keeps empty bins supervised. A
fresh (all-zero) grid gives the uniform PDF, the warm-up.

The grid lives in ``TrainState.grid`` and in checkpoints; the train loop
updates it every ``occ_update_steps`` steps (``update_grid``: sigma of the
eager field at jittered cell centres, the step's matmul dtype). Its sigma
is a plain product through ``models/mlp.apply_nerf``, as the JAX package
computes it in XLA outside any Pallas kernel.

Random draws come from an explicit ``torch.Generator``; ``update_grid``
also takes the jitter itself, so tests can hand it JAX's.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..config import CameraConfig, ModelConfig, RenderConfig

from ..models.mlp import apply_nerf
from . import sampling


def init_grid(res: int, device=None) -> torch.Tensor:
    """A zero grid: nothing occupied yet, so the occupancy samplers draw
    the uniform PDF."""
    return torch.zeros((res, res, res), dtype=torch.float32, device=device)


@torch.no_grad()
def update_grid(grid: torch.Tensor, params, model_cfg: ModelConfig, aabb: float,
                decay: float = 0.95, dtype=torch.bfloat16,
                generator: Optional[torch.Generator] = None,
                jitter: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The EMA-max update, occ <- max(occ * decay, sigma(centre + jitter)):
    jittered centres cover the cells' interiors over successive updates,
    and the max keeps a cell occupied until it decays (NerfAcc's rule).
    ``jitter`` (res^3, 3), uniform in [-cell / 2, cell / 2), or drawn
    from ``generator``; sigma from ``apply_nerf`` at ``dtype`` (None:
    f32), its view direction +z (sigma does not read it). Returns the new
    grid."""
    res = grid.shape[0]
    cell = 2.0 * aabb / res
    c = torch.linspace(-aabb + cell / 2.0, aabb - cell / 2.0, res, device=grid.device)
    gx, gy, gz = torch.meshgrid(c, c, c, indexing="ij")  # x slowest: the grid's layout
    pts = torch.stack([gx.reshape(-1), gy.reshape(-1), gz.reshape(-1)], dim=-1)
    if jitter is None:
        u = torch.rand(pts.shape, generator=generator,
                       device=generator.device if generator is not None else grid.device)
        jitter = -cell / 2.0 + u.to(grid.device) * cell
    pts = (pts + jitter.to(grid.device)).reshape(res * res, res, 3)
    vd = torch.zeros_like(pts)
    vd[..., 2] = 1.0
    sigma, _ = apply_nerf(params, pts, vd, model_cfg, dtype)
    return torch.maximum(grid * decay, sigma.float().reshape(res, res, res))


def _bin_occupancy(origins: torch.Tensor, dirs: torch.Tensor, mids: torch.Tensor,
                   grid: torch.Tensor, aabb: float) -> torch.Tensor:
    """The grid's raw density at each (ray, bin midpoint): (N, B). A
    point outside the AABB reads as empty."""
    res = grid.shape[0]
    scale = res / (2.0 * aabb)
    idx, inside = [], None
    for c in range(3):
        x = origins[:, c:c + 1] + mids[None, :] * dirs[:, c:c + 1]
        i = torch.floor((x + aabb) * scale).to(torch.int64)
        ok = (i >= 0) & (i < res)
        inside = ok if inside is None else inside & ok
        idx.append(torch.clamp(i, 0, res - 1))
    vals = grid.reshape(-1)[(idx[0] * res + idx[1]) * res + idx[2]]
    return torch.where(inside, vals, torch.zeros_like(vals))


def _occ_pdf(origins: torch.Tensor, dirs: torch.Tensor, grid: torch.Tensor,
             camera: CameraConfig, render_cfg: RenderConfig
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each ray's PDF: (bins (N, B + 1), weights (N, B)) over B =
    ``occ_bins`` bins of [near, far], even in t or (disparity spacing) in
    1/t. A bin whose midpoint's density passes ``occ_threshold`` is
    occupied; the occupied bins share 1 - a of the mass, and every bin
    gets a / B (a = ``occ_uniform_frac``)."""
    B = render_cfg.occ_bins
    dev = origins.device
    if render_cfg.sampling_space == "disparity":
        bins_1d = 1.0 / torch.linspace(1.0 / camera.near, 1.0 / camera.far, B + 1, device=dev)
    else:
        bins_1d = torch.linspace(camera.near, camera.far, B + 1, device=dev)
    mids = 0.5 * (bins_1d[1:] + bins_1d[:-1])
    occ = _bin_occupancy(origins, dirs, mids, grid, render_cfg.occ_aabb)
    hard = (occ > render_cfg.occ_threshold).float()
    a = render_cfg.occ_uniform_frac
    occ_mass = hard / torch.clamp(hard.sum(dim=-1, keepdim=True), min=1.0)
    w = (1.0 - a) * occ_mass + a / B
    return bins_1d.expand(origins.shape[0], B + 1), w


def occupancy_ts(origins: torch.Tensor, dirs: torch.Tensor, grid: torch.Tensor,
                 num_samples: int, camera: CameraConfig, render_cfg: RenderConfig,
                 randomized: bool = True,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """(N, num_samples) sorted point samples drawn from the occupancy PDF
    (``sampling.sample_pdf``, stratified in CDF space)."""
    bins, w = _occ_pdf(origins, dirs, grid, camera, render_cfg)
    return sampling.sample_pdf(bins, w, num_samples, randomized, generator=generator)


def occupancy_edges(origins: torch.Tensor, dirs: torch.Tensor, grid: torch.Tensor,
                    num_samples: int, camera: CameraConfig, render_cfg: RenderConfig,
                    randomized: bool = True,
                    generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """(N, num_samples + 1) sorted interval edges for the IPE passes: the
    same PDF's num_samples + 1 draws, so intervals are narrow in occupied
    bins and wide (their high frequencies damped) across empty space."""
    bins, w = _occ_pdf(origins, dirs, grid, camera, render_cfg)
    return sampling.sample_pdf(bins, w, num_samples + 1, randomized, generator=generator)
