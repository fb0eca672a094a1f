"""Full-frame rendering on one device: the counterpart of the render
parts of ``nerf_rs_tpu/parallel/dp.py`` (``default_render_chunk``,
``make_dp_render`` with its handling of the second net: a fine field, or
the proposal net) and
``nerf_rs_tpu/train/loop.py`` (``render_frame``). ``parallel/dp.make_dp_render``
splits a frame's rays over the ranks, each rendering its block through
``make_render``.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from .config import CameraConfig, Config, RenderConfig

from .ops import render as render_ops

RenderFn = Callable[..., Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]


def matmul_dtype(cfg: Config):
    """The field's matmul dtype for the eager path: bf16 for the "bf16"
    and "mixed" precisions, None (f32) for "f32". The kernel always
    multiplies in bf16."""
    return torch.bfloat16 if cfg.train.precision in ("bf16", "mixed") else None


def default_render_chunk(render_cfg: RenderConfig, fused: bool = False,
                         model_cfg=None) -> int:
    """Rays per render call for a fixed ray-sample budget (the JAX
    package's rule): 65536 rays at 64 samples, 4x that through the
    kernel (per-sample activations never reach device memory), scaled
    down as samples per ray grow, power-of-two floored. The factored
    field and the brick hash grid render on the eager path: 32,768 rays at
    128 samples; the flat hash grid at an 8x smaller budget, 4096 rays."""
    s, f = render_cfg.num_samples, render_cfg.num_fine_samples
    s_total = max(s, f) if render_cfg.fine_mode == "standalone" else s + f
    mult = 4 if fused else 1
    budget = mult * 65536 * 64
    if (model_cfg is not None and getattr(model_cfg, "arch", "") == "hashgrid"
            and not getattr(model_cfg, "hash_brick", False)):
        budget //= 8
    chunk = max(4096, min(mult * 65536, budget // max(s_total, 1)))
    return 1 << (chunk.bit_length() - 1)


def make_render(cfg: Config, camera: Optional[CameraConfig] = None,
                chunk: int = 0) -> RenderFn:
    """Renderer over flat rays: fn(params, origins (N, 3), dirs (N, 3),
    fine_params=None, grid=None) -> rgb (N, 3), depth (N,), acc (N,), of
    the fine pass with hierarchical sampling (through ``fine_params`` when
    the run has a fine field; ``share_network`` renders both passes with
    ``params``). With proposal sampling the second slot, ``fine_params``,
    carries the proposal net: each chunk resamples through it (eager)
    before its one pass. With ``cfg.render.occ_res`` > 0 the occupancy
    ``grid`` guides each chunk's coarse samples (IPE: edges), as in
    training. Deterministic sampling (bin midpoints). Through
    the kernel, both fields' weights are packed once per call, outside the
    chunk loop, and each chunk launches the kernel once per pass; the
    last chunk may be ragged (the kernel masks it), so nothing is
    padded."""
    camera = camera or cfg.camera
    dtype = matmul_dtype(cfg)
    use_fused = cfg.use_fused_kernel and render_ops.fused_supported(cfg.model)
    if chunk <= 0:
        chunk = default_render_chunk(cfg.render, fused=use_fused,
                                     model_cfg=cfg.model)

    @torch.no_grad()
    def render(params, origins, dirs, fine_params=None, grid=None):
        grid = grid if cfg.render.occ_res > 0 else None
        prop_params = None
        if cfg.proposal.enabled:  # the second slot carries the proposal net
            prop_params, fine_params = fine_params, None
        packed = fine_packed = None
        if use_fused:
            from .kernels.fused_render import pack_weights

            packed = pack_weights(params, cfg.model)
            if fine_params is not None:
                fine_packed = pack_weights(fine_params, cfg.model)
        outs = []
        for i in range(0, origins.shape[0], chunk):
            coarse, fine = render_ops.render_rays(
                params, origins[i:i + chunk], dirs[i:i + chunk], cfg.model,
                cfg.render, camera, randomized=False, dtype=dtype,
                use_fused=use_fused, packed=packed, fine_params=fine_params,
                fine_packed=fine_packed, prop_params=prop_params, prop_cfg=cfg.proposal,
                grid=grid,
            )
            out = fine if fine is not None else coarse
            outs.append((out.rgb, out.depth, out.acc))
        rgb, depth, acc = (torch.cat(parts) for parts in zip(*outs))
        return rgb, depth, acc

    return render


def render_frame(
    cfg: Config,
    params: torch.nn.Module,
    origins: torch.Tensor,
    dirs: torch.Tensor,
    render_fn: Optional[RenderFn] = None,
    chunk: int = 0,
    fine_params: Optional[torch.nn.Module] = None,
    grid: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(H, W) rays -> (H, W, 3) rgb, (H, W) depth, (H, W) acc (the fine
    pass's with hierarchical sampling; with an occupancy grid, on the
    samples it guides)."""
    h, w = origins.shape[:2]
    if render_fn is None:
        render_fn = make_render(cfg, chunk=chunk)
    rgb, depth, acc = render_fn(params, origins.reshape(-1, 3), dirs.reshape(-1, 3),
                                fine_params=fine_params, grid=grid)
    return rgb.reshape(h, w, 3), depth.reshape(h, w), acc.reshape(h, w)
