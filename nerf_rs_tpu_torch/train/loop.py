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
read once per ``CHART_STEPS`` steps, never once per step. TensorBoard,
the diagnostics and the profiler window come with slice 7 of the port;
until then scalars and images go to a logger that drops them.

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

import json
import os
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..config import Config

from ..data.factory import effective_config, make_dataset
from ..ops import metrics, render as render_ops
from ..render import make_render, render_frame
from ..utils.profiling import Throughput
from ..utils.term import image_preview, sparkline
from . import checkpoint as ckpt
from .step import (TrainState, grid_generator, init_state, make_train_step, step_generator)

CHART_STEPS = 50


class NullLogger:
    """Drops scalars and images (TensorBoard comes with slice 7)."""

    def scalars(self, values: Dict[str, float], step: int) -> None:
        pass

    def image(self, tag: str, img, step: int) -> None:
        pass


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
    run_dir = os.path.join(cfg.log_dir, cfg.run_name or str(int(time.time())))
    os.makedirs(run_dir, exist_ok=True)
    with open(os.path.join(run_dir, "config.json"), "w") as f:
        f.write(json.dumps(cfg.to_dict(), indent=2, sort_keys=True))
    tb = NullLogger()

    state = init_state(cfg, device)
    # resume: an explicit --load_path wins; else the newest in save_dir
    load_path = cfg.load_path or ckpt.latest_checkpoint(cfg.save_dir)
    if load_path:
        ckpt.restore(load_path, state)
        print(f"resumed from {load_path} at step {state.step}")
    if not cfg.do_train:
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

    for it in range(start, cfg.train.num_iter):
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
            if on_step:
                on_step(it, {**stats, "loss": losses[-1] if losses else float("nan")})

        # --- eval hook: render a view through the render kernel (the
        # fine pass's colors with hierarchical sampling; the held-out split
        # where the scene has one) ---
        if cfg.eval_on_train and it % cfg.train.eval_steps == 0 and it > 0:
            eval_ds = eval_dataset if eval_dataset is not None else dataset
            o, d = eval_ds.view_rays(0)
            rgb, depth, _ = render_frame(cfg, state.params, o, d, render_fn,
                                         fine_params=state.fine_params, grid=state.grid)
            gold = eval_ds.view_gold(0)
            m = render_ops.mse(rgb, gold)
            psnr = float(render_ops.psnr_from_mse(m))
            ssim = float(metrics.ssim(rgb, gold))
            tb.scalars({"psnr_eval": psnr, "mse_eval": float(m), "ssim_eval": ssim}, it)
            # --debug shows the gold view, to eyeball the data pipeline
            tb.image("prediction", (gold if cfg.debug else rgb).cpu().numpy(), it)
            tb.image("depth", (depth / depth.max().clamp(min=1e-6)).cpu().numpy(), it)
            print(f"iter={it}, eval psnr={psnr:.2f}")
            if cfg.live_preview:
                print(image_preview(np.asarray(rgb.cpu())))

        # --- checkpoint hook ---
        if it % cfg.train.save_steps == 0 and it > 0:
            print(f"saved {ckpt.save(state, cfg.save_dir, err_store=err_store)}")

        thr.tick()

    flush_losses()
    ckpt.save(state, cfg.save_dir, err_store=err_store)
    return state
