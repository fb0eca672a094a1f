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
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..config import Config

from ..data.factory import make_dataset
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

    step_fn = make_train_step(cfg, dataset)
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
        # fine pass's colors with hierarchical sampling) ---
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
            print(f"saved {ckpt.save(state, cfg.save_dir)}")

        thr.tick()

    flush_losses()
    ckpt.save(state, cfg.save_dir)
    return state
