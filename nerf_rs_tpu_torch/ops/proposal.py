"""Proposal-guided sampling and the interlevel loss (mip-NeRF 360
lineage), the counterpart of ``nerf_rs_tpu/ops/proposal.py``.

Flow: stratified ts -> the proposal MLP -> compositing weights -> an
inverse-CDF resample (``sampling.sample_pdf``, sorted by construction),
``num_levels`` times through the one proposal net -> the main field
evaluates only the last draw. The proposal trains on the interlevel bound
loss: its weight histogram must cover the main field's on every main
interval.

Draws come from one ``torch.Generator`` in a fixed order: the stratified
draw, then one ``sample_pdf`` draw per level. The kernel route of the
train step (``train/step._whole_ray_proposal_grads``) draws in the same
order, so the same generator gives both routes the same samples.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..config import CameraConfig, ProposalConfig

from ..models.proposal import apply_proposal
from . import sampling


def edges_from_ts(ts: torch.Tensor) -> torch.Tensor:
    """(..., S) sample distances -> (..., S + 1) histogram edges [t_0,
    midpoints, t_last], the bins hierarchical sampling uses."""
    mids = 0.5 * (ts[..., 1:] + ts[..., :-1])
    return torch.cat([ts[..., :1], mids, ts[..., -1:]], dim=-1)


def weights_from_sigma(sigma: torch.Tensor, deltas: torch.Tensor) -> torch.Tensor:
    """w_i = T_i (1 - exp(-sigma_i delta_i)), T from an exclusive cumsum
    (the compositing weights without colors)."""
    sd = sigma * deltas
    excl = torch.cumsum(sd, dim=-1) - sd
    return torch.exp(-excl) * (1.0 - torch.exp(-sd))


def proposal_weights(prop_params, origins: torch.Tensor, dirs: torch.Tensor, ts: torch.Tensor,
                     pcfg: ProposalConfig, far: float, dtype=None,
                     contract: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """(weights (..., P), edges (..., P + 1)) of the proposal histogram
    along each ray at the samples ``ts`` (..., P); differentiable in the
    proposal net."""
    pts = sampling.points_from_ts(origins, dirs, ts)
    sigma = apply_proposal(prop_params, pts, pcfg, dtype, contract=contract)
    return weights_from_sigma(sigma, sampling.deltas_from_ts(ts, far)), edges_from_ts(ts)


def anneal_weights(w: torch.Tensor, anneal: Optional[float]) -> torch.Tensor:
    """mip-NeRF 360's resampling annealing: the draw weights to the power
    ``anneal`` in (0, 1] (None: off). The interlevel loss sees the raw
    histogram."""
    if anneal is None:
        return w
    return torch.pow(torch.clamp(w, min=1e-7), anneal)


def proposal_resample(
    origins: torch.Tensor,
    dirs: torch.Tensor,
    prop_params,
    pcfg: ProposalConfig,
    num_main_samples: int,
    camera: CameraConfig,
    randomized: bool,
    generator: Optional[torch.Generator] = None,
    dtype=None,
    anneal: Optional[float] = None,
    space: str = "linear",
    contract: bool = False,
):
    """The main field's sample distances, guided by ``pcfg.num_levels``
    rounds of resampling through the proposal net: (ts_main (N, F) sorted,
    hists), one (edges (N, P + 1), weights (N, P)) pair per level whose
    weights carry the proposal's gradient. Only the level-0 draw has a
    spacing (``space``); each draw detaches its weights, so sample
    positions are no gradient path."""
    n = origins.shape[0]
    ts = sampling.stratified_ts(n, pcfg.num_samples, camera.near, camera.far, randomized,
                                generator=generator, device=origins.device, space=space)
    hists = []
    for lvl in range(pcfg.num_levels):
        w, bins = proposal_weights(prop_params, origins, dirs, ts, pcfg, camera.far, dtype,
                                   contract=contract)
        hists.append((bins, w))
        last = lvl == pcfg.num_levels - 1
        ts = sampling.sample_pdf(bins, anneal_weights(w.detach(), anneal),
                                 num_main_samples if last else pcfg.num_samples, randomized,
                                 generator=generator)
    return ts, tuple(hists)


def interlevel_loss(main_edges: torch.Tensor, w_main: torch.Tensor, prop_edges: torch.Tensor,
                    w_prop: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
    """mip-NeRF 360's proposal loss: for each main interval the bound is
    the total proposal weight of the proposal intervals that overlap it;
    the loss is the mean over rays of sum_i max(0, w_main_i - bound_i)^2 /
    (w_main_i + eps). The main histogram is detached: this trains the
    proposal toward the main field, never the reverse. The overlap mask is
    (..., F, P) bool."""
    w_main = w_main.detach()
    lo_m, hi_m = main_edges[..., :-1], main_edges[..., 1:]
    lo_p, hi_p = prop_edges[..., :-1], prop_edges[..., 1:]
    overlap = (lo_p[..., None, :] < hi_m[..., :, None]) & (hi_p[..., None, :] > lo_m[..., :, None])
    bound = torch.sum(torch.where(overlap, w_prop[..., None, :], 0.0), dim=-1)
    excess = torch.clamp(w_main - bound, min=0.0)
    return torch.mean(torch.sum(excess ** 2 / (w_main + eps), dim=-1))


def multi_interlevel_loss(main_edges: torch.Tensor, w_main: torch.Tensor, hists) -> torch.Tensor:
    """The interlevel loss summed over every level's (edges, weights)."""
    total = 0.0
    for bins, w in hists:
        total = total + interlevel_loss(main_edges, w_main, bins, w)
    return total
