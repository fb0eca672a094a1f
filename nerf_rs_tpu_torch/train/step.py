"""The single-device training step, the counterpart of
``nerf_rs_tpu/train/step.py``: MSE of composited colors against gold
pixels (coarse plus fine with hierarchical sampling, paper eq. 6), plus
the factored field's L1 on its line tables (``fac_l1``), mip-NeRF 360's
distortion loss on the finest pass (``distortion_weight``) and, with
proposal sampling, the interlevel loss that trains the proposal net; Adam
at the configured rate over every trainable net.

Gradients come from the whole-ray training kernel
(``kernels/fused_train.py``) whenever ``whole_ray_supported(cfg)`` holds
-- hierarchical configs as the chain coarse kernel -> resample -> fine
kernel -- and from autograd of the eager path (``ops/render.render_rays``:
the field at bf16, compositing in f32) otherwise: the same choice
``train_step_core`` makes in the JAX package. The factored field and the
hash grid always take autograd; with ``fac_fused`` the factored encode's
gradient comes from K3's backward kernel (``kernels/fused_factored.py``),
and the hash grid's table gradient is the scatter-add of its fetch
(``models/hashgrid.py``). The hash grid has no regulariser. The reference's
compat field (``cfg.model.compat``) trains through autograd as well (the
train kernel does not take it, ``render.train_fused_supported``), on its
compat samples and grey composite; its radiance head, evaluated and
discarded, gets a zero gradient (``_grad``).

Two nets: with ``num_fine_samples > 0`` and no ``share_network`` the fine
pass has its own field, and with ``cfg.proposal.enabled`` the proposal
net (``models/proposal.py``) takes the same slot,
``TrainState.fine_params``; gradients and Adam state of both are keyed by
parameter name, the second net's under ``fine.``. Under proposal sampling
the main field's gradient comes from the train kernel (or autograd) and
the proposal's from autograd through its histograms alone
(``_whole_ray_proposal_grads``).

With an occupancy grid (``cfg.render.occ_res > 0``, ``ops/occupancy.py``)
the coarse point samples, or with IPE the coarse interval edges, are drawn
from the grid's PDF, in the kernel route and in autograd's, and in
evaluation; the grid lives in ``TrainState.grid`` and the train loop
updates it. Multiscale batches carry per-ray cone radii
(``Batch.radii``), which the IPE passes take in place of the camera's.

Random draws (the batch, the sample jitter, the fine pass's or the
proposal levels' resampling, the sigma noise) come from an explicit
``torch.Generator``; ``step_generator`` derives one per step from (seed,
step), so a resumed run draws what an unbroken run draws.

Slice 7: with ``ema_decay`` > 0 the state carries an exponential moving
average of every trainable net (``TrainState.ema``), updated after each
Adam step by ``apply_grads`` and swapped in for evaluation by
``with_ema_params``; ``accumulation_steps`` > 1 splits the batch into
micro-batches whose gradients are averaged before the one Adam update
(autograd, as in the JAX package); ``render.raw_noise_std`` > 0 perturbs
the raw densities of the randomized passes (autograd: the train kernel
takes no noise).
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Callable, Dict, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..config import Config

from ..models.mlp import init_nerf_params
from ..ops import render, sampling
from ..render import matmul_dtype

Grads = Dict[str, torch.Tensor]
Aux = Dict[str, torch.Tensor]


@dataclasses.dataclass
class TrainState:
    step: int
    params: nn.Module  # NerfMLP, FactoredField or HashGridField, as cfg.model.arch says
    optimizer: torch.optim.Adam  # one Adam over params and fine_params
    # the second net: the fine pass's own field (_has_fine_net) or the
    # proposal net (cfg.proposal.enabled); the config allows one of them
    fine_params: Optional[nn.Module] = None
    # the occupancy grid (res, res, res) f32 when cfg.render.occ_res > 0,
    # updated by the train loop every occ_update_steps and checkpointed
    grid: Optional[torch.Tensor] = None
    # the exponential moving average of the trainable nets when
    # cfg.train.ema_decay > 0: a copy of ``params``, or with a second net
    # the pair (params, fine_params), as the JAX package's pytree is; None
    # when the EMA is off. Stored debiased (see apply_grads).
    ema: Union[None, nn.Module, Tuple[nn.Module, nn.Module]] = None


class Batch(NamedTuple):
    """One training batch of rays on the device."""

    origins: torch.Tensor  # (N, 3)
    dirs: torch.Tensor  # (N, 3)
    gold: torch.Tensor  # (N, 3) target pixels
    idx: Optional[torch.Tensor] = None  # flat pixel index (view * H + y) * W + x
    # per-ray cone radius at unit distance (multiscale batches), which the
    # IPE passes take; None: the camera's pixel_radius
    radii: Optional[torch.Tensor] = None


def _has_fine_net(cfg: Config) -> bool:
    """A separate fine field (the paper's scheme); ``share_network``
    runs both hierarchical passes through ``params``."""
    return cfg.render.num_fine_samples > 0 and not cfg.render.share_network


def _has_prop(cfg: Config) -> bool:
    return cfg.proposal.enabled


def named_trainable(state: TrainState):
    """(name, parameter) of every trained weight: the field's under its
    state-dict names, the second net's (fine field or proposal) under
    ``fine.``."""
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


def grid_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of the occupancy grid's update after step ``step``:
    a stream of its own (the top bit set, which ``step_generator``'s
    seeds never have), so a resumed run draws what an unbroken run draws."""
    g = torch.Generator(device=device)
    g.manual_seed((1 << 63) | ((seed & 0x7FFFFFFF) << 32) | (step & 0xFFFFFFFF))
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
    version); the fine field or the proposal net, when there is one, from
    its own stream of the same seed. Step 0."""
    params = init_nerf_params(cfg.model, cfg.train.seed, device)
    if _has_prop(cfg):
        if cfg.render.num_fine_samples != 0:
            raise ValueError("proposal sampling is the hierarchy: set num_fine_samples=0")
        if cfg.model.compat:
            raise ValueError("proposal sampling needs the paper model, not compat")
        from ..models.proposal import init_proposal_params

        fine = init_proposal_params(cfg.proposal, cfg.train.seed, device)
    else:
        fine = (init_nerf_params(cfg.model, cfg.train.seed, device, stream=1)
                if _has_fine_net(cfg) else None)
    nets = (params,) if fine is None else (params, fine)
    grid = None
    if cfg.render.occ_res > 0:
        from ..ops.occupancy import init_grid

        grid = init_grid(cfg.render.occ_res, next(params.parameters()).device)
    ema = None
    if cfg.train.ema_decay > 0.0:
        # the weights themselves (the stored EMA is debiased: its first
        # update replaces them by the first step's weights)
        ema = ema_copy(params) if fine is None else (ema_copy(params), ema_copy(fine))
    return TrainState(step=0, params=params, optimizer=make_optimizer(cfg, *nets),
                      fine_params=fine, grid=grid, ema=ema)


def ema_copy(net: nn.Module) -> nn.Module:
    """A copy of ``net`` that holds its EMA: the same module, its
    parameters outside autograd."""
    out = copy.deepcopy(net)
    out.requires_grad_(False)
    return out


def ema_nets(ema) -> Tuple[nn.Module, ...]:
    """The EMA's nets in ``named_trainable``'s order: (params,) or
    (params, fine_params)."""
    return ema if isinstance(ema, tuple) else (ema,)


def with_ema_params(state: TrainState) -> TrainState:
    """The state with the EMA swapped in for ``params`` (and, with a
    second net, ``fine_params``): what eval and render see after a run
    with ``--ema_decay`` > 0. ``state`` itself when it carries no EMA.
    Shares every tensor with ``state``."""
    if state.ema is None:
        return state
    if isinstance(state.ema, tuple):
        return dataclasses.replace(state, params=state.ema[0], fine_params=state.ema[1])
    return dataclasses.replace(state, params=state.ema)


def _reg_loss(params: nn.Module, cfg: Config) -> Optional[torch.Tensor]:
    """The architecture's parameter regulariser: for the factored field,
    ``fac_l1`` * mean |lines| (TensoRF's L1 on the line tables); else
    None."""
    if cfg.model.arch == "factored" and cfg.model.fac_l1 > 0.0:
        return cfg.model.fac_l1 * torch.mean(torch.abs(params.lines))
    return None


def _prop_anneal(cfg: Config, step: Optional[int]) -> Optional[float]:
    """mip-NeRF 360's annealing exponent of the proposal's draw weights:
    bias(step / anneal_steps, slope) = s x / ((s - 1) x + 1), ramping 0 ->
    1 over ``proposal.anneal_steps``; None when off or without a step.
    Computed in f32, as the JAX package computes it on the device."""
    a = cfg.proposal.anneal_steps
    if a <= 0 or step is None:
        return None
    f32 = np.float32
    x = np.clip(f32(step) / f32(a), f32(0.0), f32(1.0))
    s = f32(cfg.proposal.anneal_slope)
    return float(s * x / ((s - f32(1.0)) * x + f32(1.0)))


def loss_fn(params: nn.Module, batch: Batch, generator: Optional[torch.Generator],
            cfg: Config, fine_params: Optional[nn.Module] = None,
            step: Optional[int] = None,
            grid: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Aux]:
    """MSE of the coarse pass's colors against the gold pixels, plus the
    fine pass's with hierarchical sampling (paper eq. 6), the field's
    regulariser (``_reg_loss``) and the distortion loss on the finest pass,
    through the eager (differentiable) path, on samples the occupancy
    ``grid`` guides when one is given, with the batch's cone radii. With
    proposal sampling ``fine_params`` is the proposal net and the loss is
    ``_proposal_loss``'s."""
    if _has_prop(cfg):
        return _proposal_loss(params, fine_params, batch, generator, cfg, step=step)
    coarse, fine = render.render_rays(
        params, batch.origins, batch.dirs, cfg.model, cfg.render, cfg.camera,
        generator=generator, dtype=matmul_dtype(cfg), fine_params=fine_params,
        grid=grid, radii=batch.radii,
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
    if cfg.train.distortion_weight > 0.0:
        loss_d = render.distortion_loss(finest.weights, finest.ts, cfg.camera.near,
                                        cfg.camera.far, space=cfg.render.sampling_space,
                                        deltas=finest.deltas)
        loss = loss + cfg.train.distortion_weight * loss_d
        aux["loss_dist"] = loss_d
    aux.update({
        "loss": loss,
        "psnr": render.psnr_from_mse(aux.get("loss_fine", loss_c)),
        "ray_err": torch.mean((finest.rgb - gold) ** 2, dim=-1),
    })
    return loss, aux


def _proposal_loss(params: nn.Module, prop_params: nn.Module, batch: Batch,
                   generator: Optional[torch.Generator], cfg: Config,
                   main_weights_fn: Optional[Callable] = None,
                   step: Optional[int] = None) -> Tuple[torch.Tensor, Aux]:
    """The photometric loss on proposal-guided samples, plus the
    interlevel loss that trains the proposal (mip-NeRF 360's scheme) and
    the distortion loss on the main pass, through the eager path.
    ``main_weights_fn(ts) -> (rgb, weights)`` replaces the main pass (the
    eager field + composite by default)."""
    from ..models.mlp import apply_nerf
    from ..ops import proposal as prop_ops

    dtype = matmul_dtype(cfg)
    o, d = batch.origins, batch.dirs
    ts_m, hists = prop_ops.proposal_resample(
        o, d, prop_params, cfg.proposal, cfg.render.num_samples, cfg.camera,
        cfg.render.randomized, generator=generator, dtype=dtype,
        anneal=_prop_anneal(cfg, step), space=cfg.render.sampling_space,
        contract=cfg.model.contract)
    gold = batch.gold[..., :3]
    if main_weights_fn is None:
        vd = d / torch.linalg.norm(d, dim=-1, keepdim=True)
        # the paper's sigma noise on the main pass, drawn after the proposal's
        noise_std = cfg.render.raw_noise_std if cfg.render.randomized else 0.0
        eps = (render.standard_normal(ts_m.shape, generator, o.device) if noise_std > 0.0
               else None)
        sigma, rgb = apply_nerf(params, sampling.points_from_ts(o, d, ts_m), vd[..., None, :],
                                cfg.model, dtype, noise_std=noise_std, noise=eps)
        out = render.composite(sigma, rgb[..., :3], sampling.deltas_from_ts(ts_m, cfg.camera.far),
                               white_background=cfg.render.white_background, ts=ts_m)
        rgb_m, w_m = out.rgb, out.weights
    else:
        rgb_m, w_m = main_weights_fn(ts_m)
    loss_photo = render.mse(rgb_m[..., :3], gold)
    loss_il = prop_ops.multi_interlevel_loss(prop_ops.edges_from_ts(ts_m), w_m, hists)
    loss = loss_photo + cfg.proposal.loss_mult * loss_il
    reg = _reg_loss(params, cfg)
    if reg is not None:
        loss = loss + reg
    aux = {"loss_coarse": loss_photo, "loss_prop": loss_il,
           "psnr": render.psnr_from_mse(loss_photo),
           "ray_err": torch.mean((rgb_m[..., :3] - gold) ** 2, dim=-1).detach()}
    if cfg.train.distortion_weight > 0.0:
        loss_d = render.distortion_loss(w_m, ts_m, cfg.camera.near, cfg.camera.far,
                                        space=cfg.render.sampling_space)
        loss = loss + cfg.train.distortion_weight * loss_d
        aux["loss_dist"] = loss_d
    aux["loss"] = loss
    return loss, aux


def _whole_ray_proposal_grads(params: nn.Module, prop_params: nn.Module, batch: Batch,
                              generator: Optional[torch.Generator], cfg: Config,
                              step: Optional[int] = None) -> Tuple[Grads, Aux]:
    """Proposal-guided training through the train kernel: the proposal
    net picks the samples (eager), one kernel launch gives the main
    field's gradients on them (with the distortion loss in the kernel),
    and the proposal's gradients come from autograd of the interlevel
    loss through its histograms alone: the kernel's weights are values,
    the stop-gradient mip-NeRF 360 wants. Draws as ``_proposal_loss``
    makes them (``ops/proposal``'s order), so one generator gives both
    routes the same samples."""
    from ..ops import proposal as prop_ops

    dtype = matmul_dtype(cfg)
    pcfg, rc, cam = cfg.proposal, cfg.render, cfg.camera
    o, d = batch.origins, batch.dirs
    anneal = _prop_anneal(cfg, step)
    with torch.enable_grad():
        ts = sampling.stratified_ts(o.shape[0], pcfg.num_samples, cam.near, cam.far,
                                    rc.randomized, generator=generator, device=o.device,
                                    space=rc.sampling_space)
        hists = []
        for lvl in range(pcfg.num_levels):
            w, bins = prop_ops.proposal_weights(prop_params, o, d, ts, pcfg, cam.far, dtype,
                                                contract=cfg.model.contract)
            hists.append((bins, w))
            ts = sampling.sample_pdf(
                bins, prop_ops.anneal_weights(w.detach(), anneal),
                rc.num_samples if lvl == pcfg.num_levels - 1 else pcfg.num_samples,
                rc.randomized, generator=generator)
        vd = d / torch.linalg.norm(d, dim=-1, keepdim=True)
        dist_w = cfg.train.distortion_weight
        grads, tg = _whole_ray_pass(params, batch, vd, ts, sampling.deltas_from_ts(ts, cam.far),
                                    cfg, dist=dist_w > 0.0)
        loss_il = prop_ops.multi_interlevel_loss(prop_ops.edges_from_ts(ts), tg.weights, hists)
        grads_p = torch.autograd.grad(pcfg.loss_mult * loss_il, list(prop_params.parameters()))
    grads.update((f"fine.{name}", g) for (name, _), g in zip(prop_params.named_parameters(),
                                                              grads_p))
    loss_photo = tg.diag[:, 4].mean()
    loss_il = loss_il.detach()
    aux = {"loss": loss_photo + pcfg.loss_mult * loss_il, "loss_coarse": loss_photo,
           "loss_prop": loss_il, "psnr": render.psnr_from_mse(loss_photo),
           "ray_err": tg.diag[:, 4]}
    if dist_w > 0.0:
        aux["loss_dist"] = tg.diag[:, 5].mean()
        aux["loss"] = aux["loss"] + dist_w * aux["loss_dist"]
    return grads, aux


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
                    deltas: torch.Tensor, cfg: Config, radii=None, dist: bool = False):
    """One launch of the whole-ray train kernel over (N, S) samples:
    (gradients keyed like ``params``' state dict, TrainGrads). ``dist``
    adds the distortion loss in the kernel (the finest pass only, as
    ``loss_fn`` does)."""
    from ..kernels.fused_render import pack_weights, pack_weights_t
    from ..kernels.fused_train import fused_train_grads, unpack_grads

    with torch.no_grad():
        pk = pack_weights(params, cfg.model)
        tg = fused_train_grads(
            pk, pack_weights_t(pk), batch.origins.contiguous(), batch.dirs.contiguous(),
            vd.contiguous(), ts.contiguous(), deltas.contiguous(),
            batch.gold[..., :3].contiguous(), cfg.model, ts.shape[-1],
            white_bg=cfg.render.white_background, radii=radii,
            dist_weight=cfg.train.distortion_weight if dist else 0.0, near=cfg.camera.near,
            far=cfg.camera.far, dist_space=cfg.render.sampling_space,
        )
    return unpack_grads(tg, params, cfg.model), tg


def whole_ray_grads(params: nn.Module, batch: Batch, generator: Optional[torch.Generator],
                    cfg: Config, fine_params: Optional[nn.Module] = None,
                    step: Optional[int] = None,
                    grid: Optional[torch.Tensor] = None) -> Tuple[Grads, Aux]:
    """Gradients and aux from the whole-ray train kernel: one launch, or
    with hierarchical sampling the chain coarse kernel (which gives the
    per-ray weights) -> inverse-CDF resample -> fine kernel. The losses
    sum (paper eq. 6), and with one shared net so do the two passes'
    gradients; a separate fine net's come under ``fine.``. IPE configs
    sample S + 1 edges and hand the kernel interval midpoints, exact
    lengths and the rays' cone radii (the batch's, or the camera's). With
    an occupancy ``grid`` the coarse samples (IPE: edges) are drawn from
    its PDF. The distortion loss rides the finest pass's launch. With
    proposal sampling ``fine_params`` is the proposal net
    (``_whole_ray_proposal_grads``)."""
    if _has_prop(cfg):
        return _whole_ray_proposal_grads(params, fine_params, batch, generator, cfg, step)
    rc, cam = cfg.render, cfg.camera
    o, d = batch.origins, batch.dirs
    n, S = o.shape[0], rc.num_samples
    ipe = cfg.model.ipe
    radii = None
    if ipe:
        radii = (batch.radii if batch.radii is not None
                 else torch.full((n,), sampling.pixel_radius(cam), device=o.device))
    space = rc.sampling_space
    if ipe:
        if grid is not None and not rc.compat_sampling:
            from ..ops.occupancy import occupancy_edges

            edges = occupancy_edges(o, d, grid, S, cam, rc, rc.randomized, generator=generator)
        else:
            edges = sampling.stratified_ts(n, S + 1, cam.near, cam.far, rc.randomized,
                                           generator=generator, device=o.device, space=space)
        ts, deltas = 0.5 * (edges[:, :-1] + edges[:, 1:]), edges[:, 1:] - edges[:, :-1]
    else:
        if grid is not None and not rc.compat_sampling:
            from ..ops.occupancy import occupancy_ts

            ts = occupancy_ts(o, d, grid, S, cam, rc, rc.randomized, generator=generator)
        elif rc.compat_sampling:
            ts = sampling.compat_ts(n, S, cam.far, rc.randomized, generator=generator,
                                    device=o.device)
        else:
            ts = sampling.stratified_ts(n, S, cam.near, cam.far, rc.randomized,
                                        generator=generator, device=o.device, space=space)
        deltas = sampling.deltas_from_ts(ts, cam.far)
    vd = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    dist_w = cfg.train.distortion_weight
    one_pass = rc.num_fine_samples == 0
    grads, tg_c = _whole_ray_pass(params, batch, vd, ts, deltas, cfg, radii,
                                  dist=one_pass and dist_w > 0.0)
    loss_c = tg_c.diag[:, 4].mean()
    if one_pass:
        aux = {"loss": loss_c, "loss_coarse": loss_c, "psnr": render.psnr_from_mse(loss_c),
               "ray_err": tg_c.diag[:, 4]}
        if dist_w > 0.0:
            aux["loss_dist"] = tg_c.diag[:, 5].mean()
            aux["loss"] = loss_c + dist_w * aux["loss_dist"]
        return grads, aux

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
    grads_f, tg_f = _whole_ray_pass(fnet, batch, vd, all_ts, fine_deltas, cfg, radii,
                                    dist=dist_w > 0.0)
    loss_f = tg_f.diag[:, 4].mean()
    if fine_params is not None:
        grads.update((f"fine.{k}", v) for k, v in grads_f.items())
    else:  # one shared net: both passes' gradients land on it
        for k, v in grads_f.items():
            grads[k] = grads[k] + v
    aux = {"loss": loss_c + loss_f, "loss_coarse": loss_c, "loss_fine": loss_f,
           "psnr": render.psnr_from_mse(loss_f), "ray_err": tg_f.diag[:, 4]}
    if dist_w > 0.0:
        aux["loss_dist"] = tg_f.diag[:, 5].mean()
        aux["loss"] = aux["loss"] + dist_w * aux["loss_dist"]
    return grads, aux


def apply_grads(state: TrainState, grads: Grads, cfg: Config) -> TrainState:
    """The optimizer tail: one Adam update of every trainable net at the
    scheduled rate, the EMA's update when there is one, then step + 1.
    ``grads`` is keyed as ``named_trainable``. Updates ``state`` in place
    and returns it. Every step body goes through it: a tail that skips
    the EMA leaves eval rendering the initial weights (the JAX package's
    first ``--ema_decay`` drive hit that)."""
    for name, p in named_trainable(state):
        p.grad = grads[name]
    for group in state.optimizer.param_groups:
        group["lr"] = learning_rate(cfg, state.step)
    state.optimizer.step()
    if state.ema is not None and cfg.train.ema_decay > 0.0:
        update_ema(state, cfg.train.ema_decay)
    state.step += 1
    return state


def ema_coefficients(decay: float, step: int) -> Tuple[float, float]:
    """(alpha, beta) of the debiased EMA's update after ``step`` earlier
    updates, e <- alpha e + beta p: the JAX package's (d (1 - d^t) e + (1 -
    d) p) / (1 - d^(t+1)) with its three f32 coefficients divided out once.
    The stored value deb_t = raw_t / (1 - d^t) with raw_0 = 0 is an average
    of seen weights only: after one update (alpha = 0) it is those weights,
    and eval may swap it in at any step."""
    f32 = np.float32
    d, t = f32(decay), f32(step)
    prev_scale = f32(1.0) - f32(np.float64(d) ** np.float64(t))
    new_scale = f32(1.0) - f32(np.float64(d) ** np.float64(t + f32(1.0)))
    return float(d * prev_scale / new_scale), float((f32(1.0) - d) / new_scale)


@torch.no_grad()
def update_ema(state: TrainState, decay: float) -> None:
    """One debiased EMA update of every trainable net from the weights
    Adam just wrote (``ema_coefficients`` at ``state.step``), in place:
    elementwise tensor ops on the weights' device, f32 products and one
    sum, no division (a host in f32 gets the same bits)."""
    alpha, beta = ema_coefficients(decay, state.step)
    ema = [e for net in ema_nets(state.ema) for e in net.parameters()]
    live = [p for _, p in named_trainable(state)]
    torch._foreach_mul_(ema, alpha)
    torch._foreach_add_(ema, torch._foreach_mul(live, beta))


def compute_grads(state: TrainState, batch: Batch, generator: Optional[torch.Generator],
                  cfg: Config) -> Tuple[Grads, Aux]:
    """One step's gradients (keyed as ``named_trainable``) and aux: the
    kernel's when ``whole_ray_supported(cfg)``, else autograd of
    ``loss_fn``; with ``accumulation_steps`` > 1, ``accumulated_grads``'.
    The data-parallel step (``parallel/dp.py``) averages them over the
    ranks before ``apply_grads``."""
    if whole_ray_supported(cfg):
        return whole_ray_grads(state.params, batch, generator, cfg, state.fine_params,
                               state.step, state.grid)
    if cfg.train.accumulation_steps > 1:
        return accumulated_grads(state, batch, generator, cfg)
    state.optimizer.zero_grad(set_to_none=True)
    loss, aux = loss_fn(state.params, batch, generator, cfg, state.fine_params, state.step,
                        state.grid)
    loss.backward()
    return ({name: _grad(p) for name, p in named_trainable(state)},
            {k: v.detach() for k, v in aux.items()})


def _grad(p: torch.Tensor) -> torch.Tensor:
    """``p``'s gradient after a backward pass: zeros where the loss does
    not reach it (compat's radiance head, evaluated and discarded), as the
    JAX package's gradient of it is exactly 0; Adam's update of a zero
    gradient from zero moments is 0, so those weights keep their bits."""
    return p.grad if p.grad is not None else torch.zeros_like(p)


def train_step(state: TrainState, batch: Batch, generator: Optional[torch.Generator],
               cfg: Config) -> Tuple[TrainState, Aux]:
    """One optimizer step: ``compute_grads``, then ``apply_grads``."""
    grads, aux = compute_grads(state, batch, generator, cfg)
    return apply_grads(state, grads, cfg), aux


def accumulated_grads(state: TrainState, batch: Batch, generator: Optional[torch.Generator],
                      cfg: Config) -> Tuple[Grads, Aux]:
    """Gradient accumulation: the batch's first ``acc * (n // acc)`` rays
    cut into ``acc = accumulation_steps`` micro-batches in order, autograd
    of ``loss_fn`` on each (its draws from ``generator`` one micro-batch
    after another), the gradients summed in that order and divided by
    ``acc``. The aux values are the micro-batches' means, ``ray_err``
    their per-ray values concatenated. As in the JAX package's scan body,
    ``loss_fn`` gets no step, so the proposal's anneal is off under
    accumulation."""
    acc = cfg.train.accumulation_steps
    micro = batch.origins.shape[0] // acc
    state.optimizer.zero_grad(set_to_none=True)
    auxs = []
    for i in range(acc):
        part = Batch(*(None if x is None else x[i * micro:(i + 1) * micro] for x in batch))
        loss, aux = loss_fn(state.params, part, generator, cfg, state.fine_params, None,
                            state.grid)
        loss.backward()  # sums into .grad, micro-batch after micro-batch
        auxs.append({k: v.detach() for k, v in aux.items()})
    grads = {name: _grad(p) / acc for name, p in named_trainable(state)}
    aux = {k: torch.stack([a[k] for a in auxs]).mean(0) for k in auxs[0] if k != "ray_err"}
    aux["ray_err"] = torch.cat([a["ray_err"] for a in auxs])
    return grads, aux


@torch.no_grad()
def eval_step(state: TrainState, batch: Batch, cfg: Config) -> Dict[str, torch.Tensor]:
    """Deterministic (midpoint-sampled) evaluation pass; with
    hierarchical sampling it reports the fine pass, with proposal sampling
    the main pass on the proposal's samples. An occupancy-trained field
    samples where its grid says, as in training: evaluated with uniform
    samples it collapses."""
    prop = _has_prop(cfg)
    coarse, fine = render.render_rays(state.params, batch.origins, batch.dirs, cfg.model,
                                      cfg.render, cfg.camera, randomized=False,
                                      dtype=matmul_dtype(cfg),
                                      fine_params=None if prop else state.fine_params,
                                      prop_params=state.fine_params if prop else None,
                                      prop_cfg=cfg.proposal,
                                      grid=state.grid if cfg.render.occ_res > 0 else None,
                                      radii=batch.radii)
    out = fine if fine is not None else coarse
    m = render.mse(out.rgb, batch.gold[..., :3])
    return {"mse": m, "psnr": render.psnr_from_mse(m), "rgb": out.rgb,
            "depth": out.depth, "acc": out.acc}


def make_train_step(cfg: Config, dataset, sample: Optional[Callable[[torch.Generator], Batch]]
                    = None) -> Callable[[TrainState, torch.Generator], Tuple[TrainState, Aux]]:
    """The step with its batch drawn inside it: fn(state, generator) ->
    (state, aux), aux carrying ``batch_idx``. The batch is
    ``sample(generator)``, by default the dataset's per-ray batch (the
    train loop passes the other batch modes). The one-rank form of
    ``parallel/dp.make_dp_train_step(cfg, mesh, dataset)``."""
    if sample is None:
        sample = lambda g: dataset.sample_batch(g, cfg.train.num_rays)  # noqa: E731

    def step(state: TrainState, generator: torch.Generator):
        batch = sample(generator)
        state, aux = train_step(state, batch, generator, cfg)
        aux["batch_idx"] = batch.idx
        return state, aux

    return step
