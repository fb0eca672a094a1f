"""Volume rendering: alpha compositing and the ray renderer, the
counterpart of the coarse point-sampled part of
``nerf_rs_tpu/ops/render.py``.

T_i = exp(-sum_{j<i} sigma_j delta_j) from one exclusive cumsum,
w_i = T_i (1 - exp(-sigma_i delta_i)), C = sum_i w_i c_i.

Fine (hierarchical), proposal, occupancy, IPE and compat passes come
with later slices of the port and raise ``NotImplementedError``.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from nerf_rs_tpu.config import CameraConfig, ModelConfig, RenderConfig

from ..models.mlp import apply_nerf
from . import sampling


class RenderOut(NamedTuple):
    rgb: torch.Tensor  # (..., 3) composited color
    weights: torch.Tensor  # (..., S) compositing weights
    sigma: torch.Tensor  # (..., S) densities (post-activation)
    depth: torch.Tensor  # (...,) expected termination depth
    acc: torch.Tensor  # (...,) accumulated opacity
    ts: Optional[torch.Tensor] = None  # (..., S) sample distances


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


def check_render_supported(model_cfg: ModelConfig, render_cfg: RenderConfig) -> None:
    """Raise for the render options later slices of the port bring."""
    if render_cfg.num_fine_samples > 0:
        raise NotImplementedError("the fine pass comes with slice 2 of the port")
    if render_cfg.occ_res > 0:
        raise NotImplementedError("occupancy sampling comes with slice 4 of the port")
    if render_cfg.sampling_space != "linear":
        raise NotImplementedError("disparity sampling comes with slice 5 of the port")
    if render_cfg.compat_sampling or render_cfg.compat_density_color:
        raise NotImplementedError("compat rendering comes with slice 10 of the port")
    if model_cfg.ipe:
        raise NotImplementedError("IPE rendering comes with slice 3 of the port")


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
) -> Tuple[RenderOut, None]:
    """Sample -> field -> composite for rays of any leading shape.
    Returns (coarse, None); the fine pass comes with slice 2.

    ``use_fused`` renders through the whole-ray kernel
    (``kernels/fused_ray.py``; pass ``packed`` to reuse weights packed
    once per frame). Otherwise the field runs as ``apply_nerf`` at
    ``dtype`` and composites in f32.
    """
    check_render_supported(model_cfg, render_cfg)
    use_fused = use_fused and fused_supported(model_cfg)
    rand = render_cfg.randomized if randomized is None else randomized
    if rand and render_cfg.raw_noise_std > 0.0:
        raise NotImplementedError("sigma noise (raw_noise_std) comes with slice 7 of the port")
    shape = origins.shape[:-1]
    flat_o = origins.reshape(-1, 3)
    flat_d = dirs.reshape(-1, 3)
    n = flat_o.shape[0]
    S = render_cfg.num_samples
    ts = sampling.stratified_ts(n, S, camera.near, camera.far, rand,
                                generator=generator, device=flat_o.device)
    deltas = sampling.deltas_from_ts(ts, camera.far)
    viewdirs = flat_d / torch.linalg.norm(flat_d, dim=-1, keepdim=True)

    if use_fused:
        from ..kernels.fused_ray import fused_ray_render
        from ..kernels.fused_render import pack_weights

        pk = packed if packed is not None else pack_weights(params, model_cfg)
        rgb, acc, depth, w, sig = fused_ray_render(
            pk, flat_o.contiguous(), flat_d.contiguous(), viewdirs.contiguous(),
            ts, deltas, model_cfg, S,
        )
        if render_cfg.white_background:
            rgb = rgb + (1.0 - acc[..., None])
        out = RenderOut(rgb=rgb, weights=w, sigma=sig, depth=depth, acc=acc,
                        ts=ts)
    else:
        pts = sampling.points_from_ts(flat_o, flat_d, ts)
        sigma, rgb = apply_nerf(params, pts, viewdirs[..., None, :],
                                model_cfg, dtype)
        out = composite(sigma, rgb[..., :3], deltas,
                        white_background=render_cfg.white_background, ts=ts)

    return RenderOut(
        rgb=out.rgb.reshape(*shape, 3),
        weights=out.weights.reshape(*shape, S),
        sigma=out.sigma.reshape(*shape, S),
        depth=out.depth.reshape(shape),
        acc=out.acc.reshape(shape),
        ts=out.ts.reshape(*shape, S),
    ), None


def mse(pred: torch.Tensor, gold: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - gold) ** 2)


def psnr_from_mse(m: torch.Tensor) -> torch.Tensor:
    """PSNR in dB for [0, 1] images."""
    return -10.0 / math.log(10.0) * torch.log(torch.clamp(m, min=1e-10))


def psnr(pred: torch.Tensor, gold: torch.Tensor) -> torch.Tensor:
    return psnr_from_mse(mse(pred, gold))
