"""The single-device training step, the counterpart of
``nerf_rs_tpu/train/step.py``: MSE of composited colors against gold
pixels, Adam at the configured rate.

Gradients come from the whole-ray training kernel
(``kernels/fused_train.py``) whenever ``whole_ray_supported(cfg)`` holds,
and from autograd of the eager path (``ops/render.render_rays``: the
field at bf16, compositing in f32) otherwise -- the same choice
``train_step_core`` makes in the JAX package.

Random draws (the batch, the stratified sample jitter) come from an
explicit ``torch.Generator``; ``step_generator`` derives one per step
from (seed, step), so a resumed run draws what an unbroken run draws.
The fine pass (slice 2), IPE (slice 3), occupancy (slice 4), proposal
sampling and the distortion loss (slice 5), error resampling (slice 6),
EMA, gradient accumulation and sigma noise (slice 7) raise
``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from nerf_rs_tpu.config import Config

from ..models.mlp import NerfMLP, check_supported, init_nerf_params
from ..ops import render, sampling
from ..render import matmul_dtype

Grads = Dict[str, torch.Tensor]
Aux = Dict[str, torch.Tensor]


@dataclasses.dataclass
class TrainState:
    step: int
    params: NerfMLP
    optimizer: torch.optim.Adam
    grid: None = None  # occupancy grid: slice 4
    ema: None = None  # EMA weights: slice 7


class Batch(NamedTuple):
    """One training batch of rays on the device."""

    origins: torch.Tensor  # (N, 3)
    dirs: torch.Tensor  # (N, 3)
    gold: torch.Tensor  # (N, 3) target pixels
    idx: Optional[torch.Tensor] = None  # flat pixel index (view * H + y) * W + x


def check_train_supported(cfg: Config) -> None:
    """Raise for the training options later slices of the port bring."""
    check_supported(cfg.model)
    render.check_render_supported(cfg.model, cfg.render)
    t, d = cfg.train, cfg.data
    later = [
        (cfg.proposal.enabled, "proposal sampling", 5),
        (t.distortion_weight > 0.0, "the distortion loss", 5),
        (d.batch_mode != "per_ray", f"batch_mode={d.batch_mode}", 6),
        (d.multiscale_levels > 1, "multiscale batches", 6),
        (t.error_resample_frac > 0.0, "error resampling", 6),
        (t.ema_decay > 0.0, "the EMA of the weights", 7),
        (t.accumulation_steps > 1, "gradient accumulation", 7),
        (cfg.render.raw_noise_std > 0.0, "sigma noise (raw_noise_std)", 7),
        (t.profile_steps > 0, "the profiler window", 7),
    ]
    for on, what, n in later:
        if on:
            raise NotImplementedError(f"{what} comes with slice {n} of the port")


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of one training step, a fixed function of (seed,
    step) -- the port's ``jax.random.fold_in(key, step)``."""
    g = torch.Generator(device=device)
    g.manual_seed(((seed & 0x7FFFFFFF) << 32) | (step & 0xFFFFFFFF))
    return g


def learning_rate(cfg: Config, count: int) -> float:
    """The rate of the update that follows ``count`` updates: constant,
    or lr * (lr_final / lr) ** (count / lr_decay_steps) with
    ``lr_decay_steps`` > 0 (``optax.exponential_decay``)."""
    t = cfg.train
    if t.lr_decay_steps > 0:
        return t.learning_rate * (t.lr_final / t.learning_rate) ** (count / t.lr_decay_steps)
    return t.learning_rate


def make_optimizer(cfg: Config, params: NerfMLP) -> torch.optim.Adam:
    """Adam with optax's defaults (b1 0.9, b2 0.999, eps 1e-8); the
    schedule is applied per update by ``apply_grads``."""
    return torch.optim.Adam(params.parameters(), lr=learning_rate(cfg, 0),
                            betas=(0.9, 0.999), eps=1e-8)


def init_state(cfg: Config, device=None) -> TrainState:
    """Fresh state: weights from ``cfg.train.seed`` (drawn on the CPU,
    so one seed gives the same weights on every device), step 0."""
    check_train_supported(cfg)
    params = init_nerf_params(cfg.model, cfg.train.seed, device)
    return TrainState(step=0, params=params, optimizer=make_optimizer(cfg, params))


def loss_fn(params: NerfMLP, batch: Batch, generator: Optional[torch.Generator],
            cfg: Config) -> Tuple[torch.Tensor, Aux]:
    """MSE of the coarse pass's colors against the gold pixels, through
    the eager (differentiable) path."""
    coarse, _ = render.render_rays(
        params, batch.origins, batch.dirs, cfg.model, cfg.render, cfg.camera,
        generator=generator, dtype=matmul_dtype(cfg),
    )
    gold = batch.gold[..., :3]
    loss = render.mse(coarse.rgb, gold)
    aux = {
        "loss": loss,
        "loss_coarse": loss,
        "psnr": render.psnr_from_mse(loss),
        "ray_err": torch.mean((coarse.rgb - gold) ** 2, dim=-1),
    }
    return loss, aux


def whole_ray_supported(cfg: Config) -> bool:
    """Configurations the whole-ray train kernel carries."""
    return (
        cfg.use_whole_ray_train
        and render.train_fused_supported(cfg.model)
        and cfg.render.raw_noise_std == 0.0
        and not cfg.render.compat_density_color
        and cfg.train.accumulation_steps <= 1
    )


def whole_ray_grads(params: NerfMLP, batch: Batch, generator: Optional[torch.Generator],
                    cfg: Config) -> Tuple[Grads, Aux]:
    """Gradients and aux from one launch of the whole-ray train kernel
    (the one-pass branch of the JAX ``whole_ray_grads``)."""
    from ..kernels.fused_render import pack_weights, pack_weights_t
    from ..kernels.fused_train import fused_train_grads, unpack_grads

    check_train_supported(cfg)  # the fine, IPE, occupancy and proposal branches
    rc = cfg.render
    o, d = batch.origins, batch.dirs
    n, S = o.shape[0], rc.num_samples
    ts = sampling.stratified_ts(n, S, cfg.camera.near, cfg.camera.far, rc.randomized,
                                generator=generator, device=o.device)
    deltas = sampling.deltas_from_ts(ts, cfg.camera.far)
    vd = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    with torch.no_grad():
        pk = pack_weights(params, cfg.model)
        tg = fused_train_grads(
            pk, pack_weights_t(pk), o.contiguous(), d.contiguous(), vd.contiguous(), ts,
            deltas, batch.gold[..., :3].contiguous(), cfg.model, S,
            white_bg=rc.white_background,
        )
    loss = tg.diag[:, 4].mean()
    aux = {
        "loss": loss,
        "loss_coarse": loss,
        "psnr": render.psnr_from_mse(loss),
        "ray_err": tg.diag[:, 4],
    }
    return unpack_grads(tg, params, cfg.model), aux


def apply_grads(state: TrainState, grads: Grads, cfg: Config) -> TrainState:
    """The optimizer tail: one Adam update at the scheduled rate, then
    step + 1. Updates ``state`` in place and returns it."""
    if cfg.train.ema_decay > 0.0:
        raise NotImplementedError("the EMA of the weights comes with slice 7 of the port")
    for name, p in state.params.named_parameters():
        p.grad = grads[name]
    for group in state.optimizer.param_groups:
        group["lr"] = learning_rate(cfg, state.step)
    state.optimizer.step()
    state.step += 1
    return state


def train_step(state: TrainState, batch: Batch, generator: Optional[torch.Generator],
               cfg: Config) -> Tuple[TrainState, Aux]:
    """One optimizer step: the kernel's gradients when
    ``whole_ray_supported(cfg)``, else autograd of ``loss_fn``."""
    check_train_supported(cfg)
    if whole_ray_supported(cfg):
        grads, aux = whole_ray_grads(state.params, batch, generator, cfg)
    else:
        state.params.zero_grad(set_to_none=True)
        loss, aux = loss_fn(state.params, batch, generator, cfg)
        loss.backward()
        grads = {name: p.grad for name, p in state.params.named_parameters()}
        aux = {k: v.detach() for k, v in aux.items()}
    return apply_grads(state, grads, cfg), aux


@torch.no_grad()
def eval_step(state: TrainState, batch: Batch, cfg: Config) -> Dict[str, torch.Tensor]:
    """Deterministic (midpoint-sampled) evaluation pass."""
    out, _ = render.render_rays(state.params, batch.origins, batch.dirs, cfg.model,
                                cfg.render, cfg.camera, randomized=False,
                                dtype=matmul_dtype(cfg))
    m = render.mse(out.rgb, batch.gold[..., :3])
    return {"mse": m, "psnr": render.psnr_from_mse(m), "rgb": out.rgb,
            "depth": out.depth, "acc": out.acc}


def make_train_step(cfg: Config, dataset) -> Callable[[TrainState, torch.Generator],
                                                       Tuple[TrainState, Aux]]:
    """The step with the per-ray batch drawn inside it: fn(state,
    generator) -> (state, aux), aux carrying ``batch_idx``. The
    single-device form of ``parallel/dp.make_dp_train_step(cfg, mesh,
    dataset)``; multi-GPU comes with slice 8."""
    check_train_supported(cfg)

    def step(state: TrainState, generator: torch.Generator):
        batch = dataset.sample_batch(generator, cfg.train.num_rays)
        state, aux = train_step(state, batch, generator, cfg)
        aux["batch_idx"] = batch.idx
        return state, aux

    return step
