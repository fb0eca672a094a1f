"""The single-device training step, the counterpart of
``nerf_rs_tpu/train/step.py``: MSE of composited colors against gold
pixels (coarse plus fine with hierarchical sampling, paper eq. 6), plus
the factored field's L1 on its line tables (``fac_l1``), Adam at the
configured rate over every trainable net.

Gradients come from the whole-ray training kernel
(``kernels/fused_train.py``) whenever ``whole_ray_supported(cfg)`` holds
-- hierarchical configs as the chain coarse kernel -> resample -> fine
kernel -- and from autograd of the eager path (``ops/render.render_rays``:
the field at bf16, compositing in f32) otherwise: the same choice
``train_step_core`` makes in the JAX package. The factored field and the
hash grid always take autograd; with ``fac_fused`` the factored encode's
gradient comes from K3's backward kernel (``kernels/fused_factored.py``),
and the hash grid's table gradient is the scatter-add of its fetch
(``models/hashgrid.py``). The hash grid has no regulariser.

Two nets: with ``num_fine_samples > 0`` and no ``share_network`` the fine
pass has its own field, ``TrainState.fine_params``; gradients and Adam
state of both are keyed by parameter name, the fine net's under
``fine.``.

Random draws (the batch, the sample jitter, the fine pass's resampling)
come from an explicit ``torch.Generator``; ``step_generator`` derives
one per step from (seed, step), so a resumed run draws what an unbroken
run draws. Occupancy (slice 4), proposal sampling and the distortion
loss (slice 5), error resampling and multiscale batches (slice 6), EMA,
gradient accumulation and sigma noise (slice 7) raise
``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn

from ..config import Config

from ..models.mlp import check_supported, init_nerf_params
from ..ops import render, sampling
from ..render import matmul_dtype

Grads = Dict[str, torch.Tensor]
Aux = Dict[str, torch.Tensor]


@dataclasses.dataclass
class TrainState:
    step: int
    params: nn.Module  # NerfMLP, FactoredField or HashGridField, as cfg.model.arch says
    optimizer: torch.optim.Adam  # one Adam over params and fine_params
    fine_params: Optional[nn.Module] = None  # the fine pass's own field (_has_fine_net)
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


def _has_fine_net(cfg: Config) -> bool:
    """A separate fine field (the paper's scheme); ``share_network``
    runs both hierarchical passes through ``params``."""
    return cfg.render.num_fine_samples > 0 and not cfg.render.share_network


def named_trainable(state: TrainState):
    """(name, parameter) of every trained weight: the field's under its
    state-dict names, the fine field's under ``fine.``."""
    yield from state.params.named_parameters()
    if state.fine_params is not None:
        for name, p in state.fine_params.named_parameters():
            yield f"fine.{name}", p


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


def make_optimizer(cfg: Config, *nets: nn.Module) -> torch.optim.Adam:
    """One Adam over every net's parameters with optax's defaults (b1
    0.9, b2 0.999, eps 1e-8), as optax's adam over the tuple of trees;
    the schedule is applied per update by ``apply_grads``."""
    return torch.optim.Adam([p for net in nets for p in net.parameters()],
                            lr=learning_rate(cfg, 0), betas=(0.9, 0.999), eps=1e-8)


def init_state(cfg: Config, device=None) -> TrainState:
    """Fresh state: weights from ``cfg.train.seed``, drawn with numpy on
    the CPU (one seed gives the same weights on every device and torch
    version); the fine field, when there is one, from its own stream of
    the same seed. Step 0."""
    check_train_supported(cfg)
    params = init_nerf_params(cfg.model, cfg.train.seed, device)
    fine = (init_nerf_params(cfg.model, cfg.train.seed, device, stream=1)
            if _has_fine_net(cfg) else None)
    nets = (params,) if fine is None else (params, fine)
    return TrainState(step=0, params=params, optimizer=make_optimizer(cfg, *nets),
                      fine_params=fine)


def _reg_loss(params: nn.Module, cfg: Config) -> Optional[torch.Tensor]:
    """The architecture's parameter regulariser: for the factored field,
    ``fac_l1`` * mean |lines| (TensoRF's L1 on the line tables); else
    None."""
    if cfg.model.arch == "factored" and cfg.model.fac_l1 > 0.0:
        return cfg.model.fac_l1 * torch.mean(torch.abs(params.lines))
    return None


def loss_fn(params: nn.Module, batch: Batch, generator: Optional[torch.Generator],
            cfg: Config, fine_params: Optional[nn.Module] = None) -> Tuple[torch.Tensor, Aux]:
    """MSE of the coarse pass's colors against the gold pixels, plus the
    fine pass's with hierarchical sampling (paper eq. 6) and the field's
    regulariser (``_reg_loss``), through the eager (differentiable)
    path."""
    coarse, fine = render.render_rays(
        params, batch.origins, batch.dirs, cfg.model, cfg.render, cfg.camera,
        generator=generator, dtype=matmul_dtype(cfg), fine_params=fine_params,
    )
    gold = batch.gold[..., :3]
    loss_c = render.mse(coarse.rgb, gold)
    aux = {"loss_coarse": loss_c}
    loss, finest = loss_c, coarse
    reg = _reg_loss(params, cfg)
    if reg is not None:
        loss = loss + reg
    if fine is not None:
        loss_f = render.mse(fine.rgb, gold)
        loss, finest = loss + loss_f, fine
        aux["loss_fine"] = loss_f
    aux.update({
        "loss": loss,
        "psnr": render.psnr_from_mse(aux.get("loss_fine", loss_c)),
        "ray_err": torch.mean((finest.rgb - gold) ** 2, dim=-1),
    })
    return loss, aux


def whole_ray_supported(cfg: Config) -> bool:
    """Configurations the whole-ray train kernel carries: coarse-only and
    hierarchical (as a coarse kernel -> resample -> fine kernel chain),
    PE and IPE."""
    return (
        cfg.use_whole_ray_train
        and render.train_fused_supported(cfg.model)
        and cfg.render.raw_noise_std == 0.0
        and not cfg.render.compat_density_color
        and cfg.train.accumulation_steps <= 1
    )


def _whole_ray_pass(params: nn.Module, batch: Batch, vd: torch.Tensor, ts: torch.Tensor,
                    deltas: torch.Tensor, cfg: Config, radii=None):
    """One launch of the whole-ray train kernel over (N, S) samples:
    (gradients keyed like ``params``' state dict, TrainGrads)."""
    from ..kernels.fused_render import pack_weights, pack_weights_t
    from ..kernels.fused_train import fused_train_grads, unpack_grads

    with torch.no_grad():
        pk = pack_weights(params, cfg.model)
        tg = fused_train_grads(
            pk, pack_weights_t(pk), batch.origins.contiguous(), batch.dirs.contiguous(),
            vd.contiguous(), ts.contiguous(), deltas.contiguous(),
            batch.gold[..., :3].contiguous(), cfg.model, ts.shape[-1],
            white_bg=cfg.render.white_background, radii=radii,
        )
    return unpack_grads(tg, params, cfg.model), tg


def whole_ray_grads(params: nn.Module, batch: Batch, generator: Optional[torch.Generator],
                    cfg: Config, fine_params: Optional[nn.Module] = None) -> Tuple[Grads, Aux]:
    """Gradients and aux from the whole-ray train kernel: one launch, or
    with hierarchical sampling the chain coarse kernel (which gives the
    per-ray weights) -> inverse-CDF resample -> fine kernel. The losses
    sum (paper eq. 6), and with one shared net so do the two passes'
    gradients; a separate fine net's come under ``fine.``. IPE configs
    sample S + 1 edges and hand the kernel interval midpoints, exact
    lengths and the camera's cone radius."""
    check_train_supported(cfg)  # the occupancy and proposal branches
    rc, cam = cfg.render, cfg.camera
    o, d = batch.origins, batch.dirs
    n, S = o.shape[0], rc.num_samples
    ipe = cfg.model.ipe
    radii = (torch.full((n,), sampling.pixel_radius(cam), device=o.device)
             if ipe else None)
    if ipe:
        edges = sampling.stratified_ts(n, S + 1, cam.near, cam.far, rc.randomized,
                                       generator=generator, device=o.device)
        ts, deltas = 0.5 * (edges[:, :-1] + edges[:, 1:]), edges[:, 1:] - edges[:, :-1]
    else:
        ts = sampling.stratified_ts(n, S, cam.near, cam.far, rc.randomized,
                                    generator=generator, device=o.device)
        deltas = sampling.deltas_from_ts(ts, cam.far)
    vd = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    grads, tg_c = _whole_ray_pass(params, batch, vd, ts, deltas, cfg, radii)
    loss_c = tg_c.diag[:, 4].mean()
    if rc.num_fine_samples == 0:
        return grads, {"loss": loss_c, "loss_coarse": loss_c,
                       "psnr": render.psnr_from_mse(loss_c), "ray_err": tg_c.diag[:, 4]}

    # the fine pass on samples drawn from the coarse kernel's weights
    standalone = rc.fine_mode == "standalone"
    if ipe:
        fine_edges = sampling.sample_pdf(edges, tg_c.weights, rc.num_fine_samples + 1,
                                         rc.randomized, generator=generator)
        if not standalone:
            fine_edges = sampling.merge_ts(edges, fine_edges)
        all_ts = 0.5 * (fine_edges[:, :-1] + fine_edges[:, 1:])
        fine_deltas = fine_edges[:, 1:] - fine_edges[:, :-1]
    else:
        mids = 0.5 * (ts[:, 1:] + ts[:, :-1])
        bins = torch.cat([ts[:, :1], mids, ts[:, -1:]], dim=-1)
        fine_ts = sampling.sample_pdf(bins, tg_c.weights, rc.num_fine_samples,
                                      rc.randomized, generator=generator)
        all_ts = fine_ts if standalone else sampling.merge_ts(ts, fine_ts)
        fine_deltas = sampling.deltas_from_ts(all_ts, cam.far)
    fnet = fine_params if fine_params is not None else params
    grads_f, tg_f = _whole_ray_pass(fnet, batch, vd, all_ts, fine_deltas, cfg, radii)
    loss_f = tg_f.diag[:, 4].mean()
    if fine_params is not None:
        grads.update((f"fine.{k}", v) for k, v in grads_f.items())
    else:  # one shared net: both passes' gradients land on it
        for k, v in grads_f.items():
            grads[k] = grads[k] + v
    return grads, {"loss": loss_c + loss_f, "loss_coarse": loss_c, "loss_fine": loss_f,
                   "psnr": render.psnr_from_mse(loss_f), "ray_err": tg_f.diag[:, 4]}


def apply_grads(state: TrainState, grads: Grads, cfg: Config) -> TrainState:
    """The optimizer tail: one Adam update of every trainable net at the
    scheduled rate, then step + 1. ``grads`` is keyed as
    ``named_trainable``. Updates ``state`` in place and returns it."""
    if cfg.train.ema_decay > 0.0:
        raise NotImplementedError("the EMA of the weights comes with slice 7 of the port")
    for name, p in named_trainable(state):
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
        grads, aux = whole_ray_grads(state.params, batch, generator, cfg, state.fine_params)
    else:
        state.optimizer.zero_grad(set_to_none=True)
        loss, aux = loss_fn(state.params, batch, generator, cfg, state.fine_params)
        loss.backward()
        grads = {name: p.grad for name, p in named_trainable(state)}
        aux = {k: v.detach() for k, v in aux.items()}
    return apply_grads(state, grads, cfg), aux


@torch.no_grad()
def eval_step(state: TrainState, batch: Batch, cfg: Config) -> Dict[str, torch.Tensor]:
    """Deterministic (midpoint-sampled) evaluation pass; with
    hierarchical sampling it reports the fine pass."""
    coarse, fine = render.render_rays(state.params, batch.origins, batch.dirs, cfg.model,
                                      cfg.render, cfg.camera, randomized=False,
                                      dtype=matmul_dtype(cfg), fine_params=state.fine_params)
    out = fine if fine is not None else coarse
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
