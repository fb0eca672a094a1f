"""The training driver on one device, the counterpart of ``train`` in
``nerf_rs_tpu/train/loop.py``: the trainer owns iteration; eval, logging
and checkpoints are step-counter hooks that fire when
``it % N == 0 and it > 0``.

Per step the batch is drawn inside the step (``step.make_train_step``)
from a generator derived from (seed, step), so a run resumed at step k
draws what an unbroken run draws. With an occupancy grid, after every step
``it`` with ``it % occ_update_steps == 0`` the grid takes its EMA update
from the new weights, jittered by a stream of its own
(``step.grid_generator``), as in the JAX loop. Losses stay on the device and are
read once per ``CHART_STEPS`` steps, never once per step.

Slice 7's hooks, as the JAX loop has them: the run directory
``{log_dir}/{run id}`` holds ``config.json`` and the TensorBoard events
(``utils/tb.TBLogger``: the hparams at step 0, the loss every step, and at
each logging step the throughput, ``psnr_train`` and the diagnostics of
``log_diagnostics``); the eval hook renders with the EMA weights when the
run keeps them (``step.with_ema_params``) and logs its prediction and depth
images unless ``--log_densities_only``; ``--profile_steps`` N > 0 records
steps [start + profile_start, start + profile_start + N) with
``torch.profiler`` into a Chrome trace in the run directory
(``utils/profiling.trace``).

The batch modes (``DataConfig.batch_mode``, as the JAX loop routes them):
``per_ray`` and ``multiview`` draw on the device inside the step; with
``error_resample_frac`` > 0 a share of every batch comes from the
per-pixel error store, which each step's per-ray errors update
(``update_error_store``) and the checkpoints carry (``.err.npy``; a resume
reads it back); ``host`` (without error resampling) takes its batches from
the async host pipeline (``data/pipeline.PrefetchPipeline``). A Blender
scene's held-out ``test`` split, where it has one, is the eval hook's.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..config import Config

from ..data.factory import effective_config, make_dataset
from ..ops import metrics, render as render_ops
from ..render import make_render, render_frame
from ..utils.profiling import Throughput, trace
from ..utils.tb import TBLogger
from ..utils.term import image_preview, sparkline
from . import checkpoint as ckpt
from .step import (TrainState, grid_generator, init_state, make_train_step, step_generator,
                   with_ema_params)

CHART_STEPS = 50
DIAG_RAYS = 1024  # rays the diagnostics look at
DIAG_PAIRS = 128  # of which the intersection map pairs up


def diag_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of the diagnostics at step ``step``: a stream of its
    own (bit 62 set, which neither ``step_generator``'s nor
    ``grid_generator``'s seeds have)."""
    g = torch.Generator(device=device)
    g.manual_seed((1 << 62) | ((seed & 0x7FFFFFFF) << 32) | (step & 0xFFFFFFFF))
    return g


@torch.no_grad()
def log_diagnostics(tb, dataset, cfg: Config, it: int, batch=None,
                    state: Optional[TrainState] = None):
    """The reference's logging-step diagnostics, as the JAX loop's
    ``_log_diagnostics`` logs them: the batch's screen coordinates
    (``screen_x`` / ``screen_y``, from its flat pixel indices), the ``t``
    histogram of stratified samples on its first DIAG_RAYS rays, the sample
    points' occupancy maps on the yx, zx and yz planes (``world_*``), the map
    of the pairwise intersections of the first DIAG_PAIRS rays
    (``intersections``, ``ops/intersect``) and, with a ``state``, the raw
    weights' density at the points (the ``density`` histogram and
    ``density_*`` maps; the field at f32, queried with the rays' directions
    as they are, as the JAX loop queries it). Without a batch that carries
    its indices, DIAG_RAYS rays are drawn from ``diag_generator``, which also
    jitters the samples."""
    from ..models.mlp import apply_nerf
    from ..ops import intersect, sampling

    g = diag_generator(cfg.train.seed, it, dataset.images.device)
    if batch is None or batch.idx is None:
        batch = dataset.sample_batch(g, DIAG_RAYS)
    n = min(DIAG_RAYS, batch.origins.shape[0])
    origins, dirs = batch.origins[:n], batch.dirs[:n]
    if batch.idx is not None:
        idx = batch.idx[:n].cpu().numpy()
        tb.screen_coords(np.stack([idx % dataset.width, (idx // dataset.width) % dataset.height],
                                  -1), it)
    cam = cfg.camera
    ts = sampling.stratified_ts(n, cfg.render.num_samples, cam.near, cam.far, True,
                                generator=g, device=origins.device,
                                space=cfg.render.sampling_space)
    tb.ray_ts(ts.cpu().numpy(), it)
    pts = sampling.points_from_ts(origins, dirs, ts)
    pts_np = pts.cpu().numpy()
    tb.point_maps(pts_np, it, prefix="world")
    m = min(DIAG_PAIRS, n)
    inter = intersect.pairwise_view_intersections(origins[:m], dirs[:m], origins[:m],
                                                  dirs[:m], t_max=cam.far, tol=1e-3)
    tb.image("intersections", intersect.trace_intersections_to_screen(
        inter, dataset.width, dataset.height).cpu().numpy(), it)
    if state is not None:
        sigma, _ = apply_nerf(state.params, pts, dirs[:, None, :], cfg.model)
        sigma = sigma.cpu().numpy()
        tb.histogram("density", sigma, it)
        tb.point_maps(pts_np, it, weights=sigma, prefix="density")


def resolve_device(name: str = "cuda") -> torch.device:
    """The device a run asks for: the card unless the caller asks for
    the CPU. Never falls back: asking for the card without one raises."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: no CUDA device is visible; the port runs on "
                           f"the card unless asked for the CPU (--device cpu)")
    return dev


def update_occupancy(state: TrainState, cfg: Config, it: int) -> torch.Tensor:
    """The grid's EMA update after step ``it`` (``ops/occupancy.update_grid``
    at the step's matmul dtype), jittered from ``grid_generator``."""
    from ..ops.occupancy import update_grid
    from ..render import matmul_dtype

    rc = cfg.render
    return update_grid(state.grid, state.params, cfg.model, rc.occ_aabb, rc.occ_decay,
                       matmul_dtype(cfg),
                       generator=grid_generator(cfg.train.seed, it, state.grid.device))


def make_pipeline(cfg: Config, dataset):
    """The async host pipeline of a ``--batch_mode host`` run over
    ``dataset``'s images and poses, at the run's batch size, prefetch
    depth, workers, loader and seed; None in every other mode and under
    error resampling, whose batches are drawn on the device. The caller
    closes it."""
    if cfg.data.batch_mode != "host" or cfg.train.error_resample_frac > 0:
        return None
    from ..data.pipeline import PrefetchPipeline

    return PrefetchPipeline(
        dataset.host_images, cfg.camera,
        angles=dataset.host_poses if dataset.mode == "angles" else None,
        c2w=dataset.host_poses if dataset.mode == "c2w" else None,
        num_rays=cfg.train.num_rays, white_background=dataset.white_background,
        depth=cfg.data.prefetch, seed=cfg.train.seed,
        use_native=cfg.data.use_native_loader, num_workers=cfg.data.data_workers,
        device=dataset.images.device)


def batch_source(cfg: Config, dataset, err_store, pipeline):
    """The step's batch as a function of its generator, for the run's
    batch mode: error-weighted, from the host pipeline, multiview or per
    ray."""
    n, frac = cfg.train.num_rays, cfg.train.error_resample_frac
    if err_store is not None:
        return lambda g: dataset.sample_batch_error_weighted(g, n, err_store, frac)
    if pipeline is not None:
        return lambda g: next(pipeline)
    if cfg.data.batch_mode == "multiview":
        return lambda g: dataset.sample_multiview_batch(g, n, cfg.data.views_per_batch)
    return lambda g: dataset.sample_batch(g, n)


def train(
    cfg: Config,
    dataset=None,
    eval_dataset=None,
    on_step: Optional[Callable[[int, Dict[str, float]], None]] = None,
    device=None,
) -> TrainState:
    """Run the training loop on ``dataset``'s device (without a dataset,
    on ``device``, by default the card); returns the final TrainState."""
    if dataset is None:
        dataset = make_dataset(cfg, device if device is not None else resolve_device())
    device = dataset.images.device
    if eval_dataset is None and cfg.data.dataset == "blender":
        try:  # the held-out split, where the scene has one
            eval_dataset = make_dataset(cfg, device, split="test")
        except FileNotFoundError:
            eval_dataset = None
    cfg = effective_config(cfg, dataset)
    tb = TBLogger(cfg.log_dir, cfg.run_name or str(int(time.time())))
    tb.hparams(cfg.hparams())
    with open(os.path.join(tb.dir, "config.json"), "w") as f:
        f.write(cfg.to_json())

    state = init_state(cfg, device)
    # resume: an explicit --load_path wins; else the newest in save_dir
    load_path = cfg.load_path or ckpt.latest_checkpoint(cfg.save_dir)
    if load_path:
        ckpt.restore(load_path, state)
        print(f"resumed from {load_path} at step {state.step}")
    if not cfg.do_train:
        tb.close()
        return state

    err_store = None
    if cfg.train.error_resample_frac > 0:
        # the error distribution is part of the trajectory: resume it too
        saved = ckpt.load_err_store(load_path) if load_path else None
        if saved is not None:
            err_store = torch.as_tensor(saved, dtype=torch.float32, device=device)
            print(f"resumed the error store from {ckpt.err_store_path(load_path)}")
        else:
            err_store = dataset.init_error_store()
    pipeline = make_pipeline(cfg, dataset)
    try:
        return _run(cfg, state, dataset, eval_dataset, on_step, device, tb, err_store,
                    make_train_step(cfg, dataset,
                                    batch_source(cfg, dataset, err_store, pipeline)))
    finally:
        tb.close()
        if pipeline is not None:
            pipeline.close()


def _run(cfg: Config, state: TrainState, dataset, eval_dataset, on_step, device, tb,
         err_store, step_fn) -> TrainState:
    """The iterations of ``train`` from ``state.step``."""
    from ..data.dataset import update_error_store

    render_fn = make_render(cfg)
    thr = Throughput(cfg.train.num_rays, cfg.render.num_samples)
    losses = []
    pending = []  # [(iter, device scalar)], read once per chart redraw
    start = state.step

    def flush_losses():
        if not pending:
            return
        vals = torch.stack([v for _, v in pending]).tolist()
        for (i, _), v in zip(pending, vals):
            losses.append(v)
            tb.scalars({"loss": v}, i)
        pending.clear()

    trace_path = None  # while the profiler window is open
    t = cfg.train
    with contextlib.ExitStack() as window:
        for it in range(start, t.num_iter):
            if t.profile_steps > 0 and it == start + t.profile_start:
                trace_path = window.enter_context(trace(tb.dir))
            if trace_path is not None and it == start + t.profile_start + t.profile_steps:
                window.close()
                print(f"profiler trace written to {trace_path}")
                trace_path = None
            state, aux = step_fn(state, step_generator(cfg.train.seed, it, device))
            if err_store is not None:
                update_error_store(err_store, aux["batch_idx"], aux["ray_err"],
                                   cfg.train.error_resample_ema)
            if state.grid is not None and it % cfg.render.occ_update_steps == 0:
                state.grid = update_occupancy(state, cfg, it)
            pending.append((it, aux["loss"]))

            if it % CHART_STEPS == 0 and it > start:
                flush_losses()
                print(f"iter={it}, loss={losses[-1]:.6f}  {sparkline(losses[-200:])}")

            # --- logging hook ---
            if it % cfg.train.logging_steps == 0 and it > 0:
                flush_losses()
                stats = thr.stats()
                tb.scalars(stats, it)
                tb.scalars({"psnr_train": float(aux["psnr"])}, it)
                thr.reset()
                idx = aux.get("batch_idx")
                diag = None if idx is None else dataset.batch_from_idx(idx[:DIAG_RAYS])
                log_diagnostics(tb, dataset, cfg, it, batch=diag, state=state)
                if on_step:
                    on_step(it, {**stats, "loss": losses[-1] if losses else float("nan")})

            # --- eval hook: render a view through the render kernel (the
            # fine pass's colors with hierarchical sampling; the held-out split
            # where the scene has one), with the EMA weights when the run keeps
            # them; the raw weights go on training ---
            if cfg.eval_on_train and it % cfg.train.eval_steps == 0 and it > 0:
                eval_ds = eval_dataset if eval_dataset is not None else dataset
                o, d = eval_ds.view_rays(0)
                ev = with_ema_params(state)
                rgb, depth, _ = render_frame(cfg, ev.params, o, d, render_fn,
                                             fine_params=ev.fine_params, grid=state.grid)
                gold = eval_ds.view_gold(0)
                m = render_ops.mse(rgb, gold)
                psnr = float(render_ops.psnr_from_mse(m))
                ssim = float(metrics.ssim(rgb, gold))
                tb.scalars({"psnr_eval": psnr, "mse_eval": float(m), "ssim_eval": ssim}, it)
                if cfg.debug:  # the gold view, to eyeball the data pipeline
                    tb.image("prediction", gold.cpu().numpy(), it)
                elif not cfg.log_densities_only:
                    tb.image("prediction", rgb.cpu().numpy(), it)
                    tb.image("depth", (depth / depth.max().clamp(min=1e-6)).cpu().numpy(), it)
                print(f"iter={it}, eval psnr={psnr:.2f}")
                if cfg.live_preview:
                    print(image_preview(np.asarray(rgb.cpu())))

            # --- checkpoint hook ---
            if it % cfg.train.save_steps == 0 and it > 0:
                print(f"saved {ckpt.save(state, cfg.save_dir, err_store=err_store)}")

            thr.tick()

        if trace_path is not None:  # the run ended inside the window
            window.close()
            print(f"profiler trace written to {trace_path}")
    flush_losses()
    ckpt.save(state, cfg.save_dir, err_store=err_store)
    return state
