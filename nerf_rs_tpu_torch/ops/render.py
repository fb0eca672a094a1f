"""Volume rendering: alpha compositing, mip-NeRF 360's distortion loss
and the ray renderer, the counterpart of ``nerf_rs_tpu/ops/render.py``:
point-sampled (PE) and interval-sampled (mip-NeRF's IPE, with per-ray cone
radii for multiscale batches) passes, the hierarchical fine pass (NeRF
section 5.2) in both fine modes, the shared-network fast fine pass,
proposal-guided (mip-NeRF 360) and occupancy-guided sampling, each through
the whole-ray render kernel or the eager field, in linear or disparity
sample spacing; and the reference's compat passes (``compat_sampling``:
t = u * far, ``compat_density_color``: the density composited as grey;
``compat_predict``).

T_i = exp(-sum_{j<i} sigma_j delta_j) from one exclusive cumsum,
w_i = T_i (1 - exp(-sigma_i delta_i)), C = sum_i w_i c_i. Nothing is
clamped: under compat's raw density sigma may be negative, 1 -
exp(-sigma delta) then too, and T may pass 1, as in the reference.

The paper's sigma noise (``raw_noise_std`` > 0, randomized passes only)
perturbs each pass's raw density with a draw of its own and runs every
pass through the eager field, as the JAX package does.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from ..config import CameraConfig, ModelConfig, RenderConfig

from ..models.mlp import apply_nerf
from . import sampling


class RenderOut(NamedTuple):
    rgb: torch.Tensor  # (..., 3) composited color
    weights: torch.Tensor  # (..., S) compositing weights
    sigma: torch.Tensor  # (..., S) densities (post-activation)
    depth: torch.Tensor  # (...,) expected termination depth
    acc: torch.Tensor  # (...,) accumulated opacity
    ts: Optional[torch.Tensor] = None  # (..., S) sample distances (IPE: interval midpoints)
    deltas: Optional[torch.Tensor] = None  # (..., S) exact interval lengths (IPE passes only)


def composite(
    sigma: torch.Tensor,
    colors: torch.Tensor,
    deltas: torch.Tensor,
    white_background: bool = False,
    ts: Optional[torch.Tensor] = None,
) -> RenderOut:
    """Alpha-composite per-sample sigma (..., S) and colors (..., S, C)
    over deltas (..., S); ``ts`` gives the depth map."""
    sd = sigma * deltas
    excl = torch.cumsum(sd, dim=-1) - sd
    weights = torch.exp(-excl) * (1.0 - torch.exp(-sd))
    rgb = torch.sum(weights[..., None] * colors, dim=-2)
    acc = torch.sum(weights, dim=-1)
    depth = (torch.sum(weights * ts, dim=-1) if ts is not None
             else torch.zeros_like(acc))
    if white_background:
        rgb = rgb + (1.0 - acc[..., None])
    return RenderOut(rgb=rgb, weights=weights, sigma=sigma, depth=depth,
                     acc=acc, ts=ts)


def distortion_loss(
    weights: torch.Tensor,
    ts: torch.Tensor,
    near: float,
    far: float,
    space: str = "linear",
    deltas: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """mip-NeRF 360's distortion loss (eq. 15, arXiv 2111.12077) for point
    samples, the mean over rays of

        L = sum_ij w_i w_j |s_i - s_j| + (1/3) sum_i w_i^2 d_i

    with s the sample positions normalised to [0, 1] over [near, far] (in
    t, or with ``space="disparity"`` in 1/t) and d their normalised
    interval lengths. The double sum is O(S) through inclusive prefix sums:
    sum_j w_j |s_i - s_j| = s_i (2 cw_i - W) + M - 2 cwm_i. Positions are
    values: only the weights carry gradient.

    ``deltas`` (IPE passes): ``ts`` are interval midpoints and ``deltas``
    exact interval lengths, so the s-space lengths are exact (disparity:
    dt / ((mid - dt/2)(mid + dt/2))); without them the point convention
    applies (the last interval runs to the far plane)."""
    ts = ts.detach()
    if deltas is not None:
        deltas = deltas.detach()
    if space == "disparity":
        g0, g1 = 1.0 / near, 1.0 / far
        s = (g0 - 1.0 / ts) / (g0 - g1)
        if deltas is not None:
            d = deltas / ((ts - 0.5 * deltas) * (ts + 0.5 * deltas)) / (g0 - g1)
        else:
            d = torch.cat([s[..., 1:], torch.ones_like(s[..., :1])], dim=-1) - s
    else:
        inv_span = 1.0 / (far - near)
        s = (ts - near) * inv_span
        d = (deltas if deltas is not None else sampling.deltas_from_ts(ts, far)) * inv_span
    cw = torch.cumsum(weights, dim=-1)
    cwm = torch.cumsum(weights * s, dim=-1)
    a = s * (2.0 * cw - cw[..., -1:]) + cwm[..., -1:] - 2.0 * cwm
    return torch.mean(torch.sum(weights * a + weights * weights * d / 3.0, dim=-1))


def compat_predict(params, points: torch.Tensor, ts: torch.Tensor, model_cfg: ModelConfig,
                   far: float, dtype=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's ``NeRF::predict`` on world points (..., S, 3) at
    distances ``ts`` (..., S): the compat field, whose radiance head is
    evaluated and then discarded, as the reference commits it; the raw
    densities composited as the colour (sigma, sigma, sigma, 1) onto no
    background. Returns ((..., 4) colours, (..., S) densities)."""
    sigma, _rgba = apply_nerf(params, points, None, model_cfg, dtype)
    colors = torch.stack([sigma, sigma, sigma, torch.ones_like(sigma)], dim=-1)
    out = composite(sigma, colors, sampling.deltas_from_ts(ts, far), ts=ts)
    return out.rgb, sigma


def train_fused_supported(model_cfg: ModelConfig) -> bool:
    """Architectures the whole-ray train kernel covers: the paper field
    with relu or softplus density."""
    return (
        not model_cfg.compat
        and model_cfg.arch == "nerf"
        and model_cfg.use_viewdirs
        and model_cfg.rgb_activation == "sigmoid"
        and model_cfg.include_input_in_enc
        and model_cfg.sigma_activation in ("relu", "softplus")
    )


def fused_supported(model_cfg: ModelConfig) -> bool:
    """The whole-ray render kernel covers the same family as the train
    kernel."""
    return train_fused_supported(model_cfg)


def _shared_fast(render_cfg: RenderConfig, model_cfg: ModelConfig, fine_params,
                 use_fused: bool) -> bool:
    """Whether the shared-network fast fine pass runs (one net, union,
    point samples, eager field; the render kernel returns no per-sample
    colors to cache): the fine pass evaluates only the new samples and
    composites the union from the coarse pass's cached (sigma, rgb)."""
    return (render_cfg.share_network and render_cfg.fine_mode != "standalone"
            and render_cfg.num_fine_samples > 0 and fine_params is None
            and not render_cfg.compat_density_color and not model_cfg.ipe and not use_fused)


def render_rays(
    params,
    origins: torch.Tensor,
    dirs: torch.Tensor,
    model_cfg: ModelConfig,
    render_cfg: RenderConfig,
    camera: CameraConfig,
    randomized: Optional[bool] = None,
    generator: Optional[torch.Generator] = None,
    dtype=None,
    use_fused: bool = False,
    packed=None,
    fine_params=None,
    fine_packed=None,
    prop_params=None,
    prop_cfg=None,
    grid: Optional[torch.Tensor] = None,
    radii: Optional[torch.Tensor] = None,
) -> Tuple[RenderOut, Optional[RenderOut]]:
    """Sample -> field -> composite for rays of any leading shape, with
    the hierarchical fine pass when ``render_cfg.num_fine_samples > 0``.
    Returns (coarse, fine); fine is None without a fine pass.

    The fine pass resamples the coarse weights' histogram
    (``sampling.sample_pdf``) and evaluates the fine samples alone
    (``fine_mode="standalone"``) or their union with the coarse ones,
    through ``fine_params`` when given (the paper's second net), else
    through ``params``. With ``model_cfg.ipe`` every pass samples
    intervals and encodes their conical-frustum Gaussians (mip-NeRF).

    ``use_fused`` renders every pass through the whole-ray kernel
    (``kernels/fused_ray.py``; pass ``packed``/``fine_packed`` to reuse
    weights packed once per frame). Otherwise the field runs as
    ``apply_nerf`` at ``dtype`` and composites in f32. Draws come from
    ``generator``: the coarse jitter, then the fine pass's.

    ``prop_params`` (a ``ProposalMLP``, with ``prop_cfg``): the point
    samples of the one pass are proposal-guided (``ops/proposal.
    proposal_resample``, without annealing) instead of stratified; the
    interlevel loss lives in ``train/step.py``. IPE passes ignore it, as
    in the JAX package (the config refuses IPE with a proposal).

    ``grid`` (an occupancy grid, ``ops/occupancy.py``): the coarse point
    samples, or with IPE the coarse interval edges, are drawn from its
    PDF instead of stratified. ``radii`` (rays' leading shape): the IPE
    passes' per-ray cone radii (multiscale batches); by default every ray
    carries the camera's ``pixel_radius``. Point-sampled passes ignore it.

    With ``share_network``, a union fine pass, point samples and the eager
    field, the fine pass evaluates only the new fine samples and
    composites the union from the coarse pass's (sigma, rgb), sorted with
    the samples by depth (``_shared_fast``).

    ``render_cfg.raw_noise_std`` > 0 on a randomized pass: each field
    evaluation adds ``raw_noise_std`` times a standard normal draw to the
    raw density (the paper's regulariser), a draw of its own per pass, from
    ``generator`` after that pass's samples; every pass then runs through
    the eager field (the render kernel takes no noise, as in the JAX
    package).

    ``render_cfg.compat_sampling``: the point samples are the reference's
    (``sampling.compat_ts``) unless a proposal net or a grid picks them;
    IPE edges stay stratified. ``render_cfg.compat_density_color``: each
    point pass composites its densities as the grey (sigma, sigma, sigma)
    through the eager field, never the render kernel. These follow the JAX
    function's order of choices.
    """
    use_fused = use_fused and fused_supported(model_cfg)
    rand = render_cfg.randomized if randomized is None else randomized
    noise_std = render_cfg.raw_noise_std if rand else 0.0
    if noise_std > 0.0:
        use_fused = False

    def pass_noise(shape) -> Optional[torch.Tensor]:
        """The standard normal draw of the next pass's raw densities."""
        if noise_std == 0.0:
            return None
        return standard_normal(shape, generator, origins.device)

    shape = origins.shape[:-1]
    flat_o = origins.reshape(-1, 3)
    flat_d = dirs.reshape(-1, 3)
    n = flat_o.shape[0]
    S, S_f = render_cfg.num_samples, render_cfg.num_fine_samples
    near, far = camera.near, camera.far
    viewdirs = flat_d / torch.linalg.norm(flat_d, dim=-1, keepdim=True)
    # the IPE passes' cone radius: the camera's (a float, as the JAX
    # package takes it), or per ray; the kernel takes one per ray
    radius = None
    if model_cfg.ipe:
        radius = sampling.pixel_radius(camera) if radii is None else radii.reshape(-1, 1)
        radii = (torch.full((n,), radius, device=flat_o.device) if radii is None
                 else radii.reshape(-1))
    else:
        radii = None
    if use_fused:
        from ..kernels.fused_render import pack_weights

        packed = packed if packed is not None else pack_weights(params, model_cfg)
        if fine_params is not None and fine_packed is None:
            fine_packed = pack_weights(fine_params, model_cfg)

    def run_pass(pass_params, pk, ts, edges=None) -> RenderOut:
        """One pass over (N, S_p) point samples ``ts``, or (IPE) over the
        S_p intervals between (N, S_p + 1) ``edges``."""
        if edges is not None:
            ts = 0.5 * (edges[..., :-1] + edges[..., 1:])
            deltas = edges[..., 1:] - edges[..., :-1]
        else:
            deltas = sampling.deltas_from_ts(ts, far)
        if use_fused and (edges is not None or not render_cfg.compat_density_color):
            from ..kernels.fused_ray import fused_ray_render

            rgb, acc, depth, w, sig = fused_ray_render(
                pk, flat_o.contiguous(), flat_d.contiguous(), viewdirs.contiguous(),
                ts.contiguous(), deltas.contiguous(), model_cfg, ts.shape[-1], radii=radii)
            if render_cfg.white_background:
                rgb = rgb + (1.0 - acc[..., None])
            return RenderOut(rgb=rgb, weights=w, sigma=sig, depth=depth, acc=acc, ts=ts,
                             deltas=deltas if edges is not None else None)
        eps = pass_noise(ts.shape)
        if edges is not None:
            mean, var, _, _ = sampling.conical_gaussians(flat_o, flat_d, edges, radius)
            sigma, rgb = apply_nerf(pass_params, mean, viewdirs[..., None, :], model_cfg, dtype,
                                    pos_var=var, noise_std=noise_std, noise=eps)
            return composite(sigma, rgb[..., :3], deltas,
                             white_background=render_cfg.white_background,
                             ts=ts)._replace(deltas=deltas)
        pts = sampling.points_from_ts(flat_o, flat_d, ts)
        sigma, rgb = apply_nerf(pass_params, pts, viewdirs[..., None, :], model_cfg, dtype,
                                noise_std=noise_std, noise=eps)
        colors = (torch.stack([sigma, sigma, sigma], dim=-1) if render_cfg.compat_density_color
                  else rgb[..., :3])
        return composite(sigma, colors, deltas,
                         white_background=render_cfg.white_background, ts=ts)

    compat = render_cfg.compat_sampling
    if model_cfg.ipe:
        # S + 1 edges: S intervals, composited over their exact lengths;
        # the edges are the fine pass's histogram bins
        if grid is not None and not compat:
            from .occupancy import occupancy_edges

            edges = occupancy_edges(flat_o, flat_d, grid, S, camera, render_cfg, rand,
                                    generator=generator)
        else:
            edges = sampling.stratified_ts(n, S + 1, near, far, rand, generator=generator,
                                           device=flat_o.device,
                                           space=render_cfg.sampling_space)
        coarse = run_pass(params, packed, None, edges)
    else:
        if prop_params is not None and not compat:
            from .proposal import proposal_resample

            ts, _ = proposal_resample(flat_o, flat_d, prop_params, prop_cfg, S, camera, rand,
                                      generator=generator, dtype=dtype,
                                      space=render_cfg.sampling_space,
                                      contract=model_cfg.contract)
        elif grid is not None and not compat:
            from .occupancy import occupancy_ts

            ts = occupancy_ts(flat_o, flat_d, grid, S, camera, render_cfg, rand,
                              generator=generator)
        elif compat:
            ts = sampling.compat_ts(n, S, far, rand, generator=generator, device=flat_o.device)
        else:
            ts = sampling.stratified_ts(n, S, near, far, rand, generator=generator,
                                        device=flat_o.device, space=render_cfg.sampling_space)
        if _shared_fast(render_cfg, model_cfg, fine_params, use_fused):
            coarse, fine = _shared_fast_passes(params, flat_o, flat_d, viewdirs, ts, model_cfg,
                                               render_cfg, camera, rand, generator, dtype,
                                               noise_std, pass_noise)
            return _unflatten(coarse, shape), _unflatten(fine, shape)
        coarse = run_pass(params, packed, ts)

    fine = None
    if S_f > 0:
        fparams, fpacked = ((fine_params, fine_packed) if fine_params is not None
                            else (params, packed))
        standalone = render_cfg.fine_mode == "standalone"
        if model_cfg.ipe:
            fine_edges = sampling.sample_pdf(edges, coarse.weights, S_f + 1, rand,
                                             generator=generator)
            if not standalone:
                fine_edges = sampling.merge_ts(edges, fine_edges)
            fine = run_pass(fparams, fpacked, None, fine_edges)
        else:
            mids = 0.5 * (ts[..., 1:] + ts[..., :-1])
            bins = torch.cat([ts[..., :1], mids, ts[..., -1:]], dim=-1)
            fine_ts = sampling.sample_pdf(bins, coarse.weights, S_f, rand, generator=generator)
            all_ts = fine_ts if standalone else sampling.merge_ts(ts, fine_ts)
            fine = run_pass(fparams, fpacked, all_ts)

    return _unflatten(coarse, shape), (_unflatten(fine, shape) if fine is not None else None)


def _unflatten(out: RenderOut, shape) -> RenderOut:
    return RenderOut(
        rgb=out.rgb.reshape(*shape, 3),
        weights=out.weights.reshape(*shape, -1),
        sigma=out.sigma.reshape(*shape, -1),
        depth=out.depth.reshape(shape),
        acc=out.acc.reshape(shape),
        ts=out.ts.reshape(*shape, -1),
        deltas=None if out.deltas is None else out.deltas.reshape(*shape, -1),
    )


def _shared_fast_passes(params, flat_o, flat_d, viewdirs, ts, model_cfg: ModelConfig,
                        render_cfg: RenderConfig, camera: CameraConfig, rand: bool,
                        generator, dtype, noise_std: float,
                        pass_noise) -> Tuple[RenderOut, RenderOut]:
    """The shared-network fast fine pass (``nerf_rs_tpu/ops/render.py``'s
    ``shared_fast``): the coarse samples through the field once, the
    fine draws from the coarse weights (inverse CDF), only the fine
    samples through the field, then one stable sort of (ts, sigma, r, g,
    b) by ts and channel-wise compositing of the union. ``pass_noise(shape)``
    gives each evaluation's sigma noise draw (None: no noise)."""
    far = camera.far
    sigma_c, rgb_c = apply_nerf(params, sampling.points_from_ts(flat_o, flat_d, ts),
                                viewdirs[..., None, :], model_cfg, dtype,
                                noise_std=noise_std, noise=pass_noise(ts.shape))
    coarse = composite(sigma_c, rgb_c[..., :3], sampling.deltas_from_ts(ts, far),
                       white_background=render_cfg.white_background, ts=ts)
    mids = 0.5 * (ts[..., 1:] + ts[..., :-1])
    bins = torch.cat([ts[..., :1], mids, ts[..., -1:]], dim=-1)
    fine_ts = sampling.sample_pdf(bins, coarse.weights, render_cfg.num_fine_samples, rand,
                                  generator=generator)
    sigma_f, rgb_f = apply_nerf(params, sampling.points_from_ts(flat_o, flat_d, fine_ts),
                                viewdirs[..., None, :], model_cfg, dtype,
                                noise_std=noise_std, noise=pass_noise(fine_ts.shape))
    ts_u, order = torch.sort(torch.cat([ts, fine_ts], dim=-1), dim=-1, stable=True)
    sigma_u = torch.cat([sigma_c, sigma_f], dim=-1).gather(-1, order)
    chans = [torch.cat([rgb_c[..., c], rgb_f[..., c]], dim=-1).gather(-1, order)
             for c in range(3)]
    sd = sigma_u * sampling.deltas_from_ts(ts_u, far)
    w = torch.exp(-(torch.cumsum(sd, dim=-1) - sd)) * (1.0 - torch.exp(-sd))
    rgb = torch.stack([torch.sum(w * c, dim=-1) for c in chans], dim=-1)
    acc = torch.sum(w, dim=-1)
    if render_cfg.white_background:
        rgb = rgb + (1.0 - acc[..., None])
    fine = RenderOut(rgb=rgb, weights=w, sigma=sigma_u, depth=torch.sum(w * ts_u, dim=-1),
                     acc=acc, ts=ts_u)
    return coarse, fine


def standard_normal(shape, generator: Optional[torch.Generator], device) -> torch.Tensor:
    """Standard normal draws of ``shape`` from ``generator`` (on its
    device), on ``device``: the sigma noise of one pass."""
    src = generator.device if generator is not None else device
    return torch.randn(shape, generator=generator, device=src).to(device)


def mse(pred: torch.Tensor, gold: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - gold) ** 2)


def psnr_from_mse(m: torch.Tensor) -> torch.Tensor:
    """PSNR in dB for [0, 1] images."""
    return -10.0 / math.log(10.0) * torch.log(torch.clamp(m, min=1e-10))


def psnr(pred: torch.Tensor, gold: torch.Tensor) -> torch.Tensor:
    return psnr_from_mse(mse(pred, gold))
