"""The training loop, the counterpart of ``train`` and
``train_multiscene`` in ``nerf_rs_tpu/train/loop.py``: the trainer owns
iteration; eval, logging and checkpoints are step-counter hooks that fire
when ``it % N == 0 and it > 0``. On one device, or data parallel over the
ranks of a process group (``parallel/``; see ``train``).

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
import dataclasses
import os
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..config import Config

from ..data.factory import effective_config, make_dataset
from ..ops import metrics, render as render_ops
from ..parallel import dist_init, dp, mesh as mesh_mod
from ..render import make_render, render_frame
from ..utils.profiling import Throughput, trace
from ..utils.tb import NullLogger, TBLogger
from ..utils.term import image_preview, sparkline
from . import checkpoint as ckpt
from .step import TrainState, grid_generator, init_state, step_generator, with_ema_params

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
    histogram of stratified samples (under ``compat_sampling`` the
    reference's, ``compat_ts``) on its first DIAG_RAYS rays, the sample
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
    if cfg.render.compat_sampling:
        ts = sampling.compat_ts(n, cfg.render.num_samples, cam.far, generator=g,
                                device=origins.device)
    else:
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


def make_throughput(cfg: Config, num_chips: int = 1) -> Throughput:
    """The loop's throughput window: a step's rays (every rank's), coarse
    plus fine samples a ray, over ``num_chips`` cards (the JAX loop's)."""
    return Throughput(cfg.train.num_rays,
                      cfg.render.num_samples + cfg.render.num_fine_samples, num_chips)


def _rank_device(device):
    """The device of this rank: the process group's, else ``device``, else
    the card."""
    bound = dist_init.device()
    if bound is not None:
        return bound
    return device if device is not None else resolve_device()


def train(
    cfg: Config,
    dataset=None,
    eval_dataset=None,
    on_step: Optional[Callable[[int, Dict[str, float]], None]] = None,
    device=None,
) -> TrainState:
    """Run the training loop on ``dataset``'s device (without a dataset,
    on ``device``, by default the card; each rank of a process group on
    its own); returns the final TrainState.

    Data parallel over the ranks of the process group (``dist_init``;
    ``parallel/launch.py`` starts them), as the JAX loop runs over its
    mesh: ``num_rays`` padded to a multiple of the ranks, the step of
    ``parallel/dp.make_dp_train_step``, the eval render sharded
    (``dp.make_dp_render``) and entered by every rank, as are the
    occupancy grid's update and the EMA; only the primary rank writes (the
    run directory, events, checkpoints and their error store, followed by
    a barrier) and prints. Without a caller's dataset a host process of a
    multi-host run loads views ``[process::processes]``; with
    ``--shard_pixel_store`` (per-ray batches, no error resampling, more
    than one rank) each rank keeps its block of its process's views.
    One rank: no process group, the single-device step."""
    dist_init.initialize()
    primary = dist_init.is_primary()
    mesh = mesh_mod.make_mesh(cfg.num_devices)
    nchips = mesh_mod.num_shards(mesh)
    per_ray = cfg.data.batch_mode == "per_ray"
    err_frac = cfg.train.error_resample_frac
    shard_store = cfg.data.shard_pixel_store and nchips > 1
    if cfg.data.shard_pixel_store and (not per_ray or err_frac > 0):
        if primary:
            print("shard_pixel_store ignored: needs batch_mode=per_ray with no error "
                  "resampling (store stays replicated)")
        shard_store = False
    if dataset is None:
        device = _rank_device(device)
        nproc, local = dist_init.process_count(), dist_init.local_ranks()
        dataset = make_dataset(cfg, device,
                               process_shard=(dist_init.process_index(), nproc)
                               if nproc > 1 else None,
                               local_multiple=local if shard_store else 1)
        if shard_store and local > 1:
            dataset = dataset.view_block(dist_init.local_rank(), local)
    else:
        shard_store = False  # a caller's store is every rank's
    device = dataset.images.device
    if eval_dataset is None and cfg.data.dataset == "blender":
        try:  # the held-out split, where the scene has one
            eval_dataset = make_dataset(cfg, device, split="test")
        except FileNotFoundError:
            eval_dataset = None
    cfg = effective_config(cfg, dataset)
    num_rays = mesh_mod.pad_to_shards(cfg.train.num_rays, mesh)
    if num_rays != cfg.train.num_rays:
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, num_rays=num_rays))
    tb = (TBLogger(cfg.log_dir, cfg.run_name or str(int(time.time()))) if primary
          else NullLogger())
    tb.hparams(cfg.hparams())
    if primary:
        with open(os.path.join(tb.dir, "config.json"), "w") as f:
            f.write(cfg.to_json())

    state = init_state(cfg, device)
    # resume: an explicit --load_path wins; else the newest in save_dir
    load_path = cfg.load_path or ckpt.latest_checkpoint(cfg.save_dir)
    if load_path:
        ckpt.restore(load_path, state)
        if primary:
            print(f"resumed from {load_path} at step {state.step}")
    if not cfg.do_train:
        tb.close()
        return state

    err_store = None
    if err_frac > 0:
        # the error distribution is part of the trajectory: resume it too
        saved = ckpt.load_err_store(load_path) if load_path else None
        if saved is not None:
            err_store = torch.as_tensor(saved, dtype=torch.float32, device=device)
            if primary:
                print(f"resumed the error store from {ckpt.err_store_path(load_path)}")
        else:
            err_store = dataset.init_error_store()
    pipeline = make_pipeline(cfg, dataset)
    try:
        step_fn = dp.make_dp_train_step(cfg, mesh, dataset, shard_store=shard_store,
                                        sample=batch_source(cfg, dataset, err_store, pipeline),
                                        err_store=err_store)
        return _run(cfg, state, dataset, eval_dataset, on_step, device, tb, err_store, step_fn,
                    mesh, primary)
    finally:
        tb.close()
        if pipeline is not None:
            pipeline.close()


def _run(cfg: Config, state: TrainState, dataset, eval_dataset, on_step, device, tb,
         err_store, step_fn, mesh, primary: bool) -> TrainState:
    """The iterations of ``train`` from ``state.step``."""
    from ..data.dataset import update_error_store

    render_fn = dp.make_dp_render(cfg, mesh)
    thr = make_throughput(cfg, mesh_mod.num_shards(mesh))
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
            if primary and t.profile_steps > 0 and it == start + t.profile_start:
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
                if primary:
                    print(f"iter={it}, loss={losses[-1]:.6f}  {sparkline(losses[-200:])}")

            # --- logging hook ---
            if it % cfg.train.logging_steps == 0 and it > 0:
                flush_losses()
                stats = thr.stats()
                tb.scalars(stats, it)
                tb.scalars({"psnr_train": float(aux["psnr"])}, it)
                thr.reset()
                if primary:
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
                if primary:
                    print(f"iter={it}, eval psnr={psnr:.2f}")
                    if cfg.live_preview:
                        print(image_preview(np.asarray(rgb.cpu())))

            # --- checkpoint hook: the primary writes, every rank waits ---
            if it % cfg.train.save_steps == 0 and it > 0:
                _save(state, cfg, err_store, primary, announce=True)

            thr.tick()

        if trace_path is not None:  # the run ended inside the window
            window.close()
            print(f"profiler trace written to {trace_path}")
    flush_losses()
    _save(state, cfg, err_store, primary)
    return state


def _save(state: TrainState, cfg: Config, err_store, primary: bool,
          announce: bool = False) -> None:
    """The primary writes the checkpoint (the state is every rank's); then
    every rank waits for it."""
    if primary:
        path = ckpt.save(state, cfg.save_dir, err_store=err_store)
        if announce:
            print(f"saved {path}")
    dist_init.barrier()


def scene_cfg(cfg: Config, spec: str) -> Config:
    """One scene's config from a ``--scenes`` entry: a dataset name selects
    that dataset; anything else is an ``img_dir`` of the configured
    dataset (the JAX loop's ``_scene_cfg``)."""
    if spec in ("sphere", "flat_sphere", "multiview_png", "blender"):
        data = dataclasses.replace(cfg.data, dataset=spec)
    else:
        data = dataclasses.replace(cfg.data, img_dir=spec)
    return dataclasses.replace(cfg, data=data)


def train_multiscene(
    cfg: Config,
    scene_specs=None,
    datasets=None,
    on_step: Optional[Callable[[int, Dict[str, float]], None]] = None,
    device=None,
) -> List[TrainState]:
    """Multi-scene training, the JAX loop's ``train_multiscene``: one field
    per scene over the (scene, data) mesh (``parallel/multiscene.py``), the
    same hooks as ``train``. Whole-ray training is off, as in the JAX
    package: the scenes train through autograd, and the render kernel serves
    their eval, each scene's frame rendered on one device by its group's
    first rank. Per-scene losses (every 50 steps and at logging steps) and
    eval PSNRs are gathered to every rank and printed by the primary, which
    alone writes: the run directory, and one checkpoint of every scene
    (``checkpoint.save_scenes``), gathered from the scene groups. Returns
    this rank's scenes' states (every scene's on one rank)."""
    from ..parallel import multiscene as ms_mod

    dist_init.initialize()
    primary = dist_init.is_primary()
    cfg = dataclasses.replace(cfg, use_whole_ray_train=False)
    n_scenes = len(datasets) if datasets is not None else len(scene_specs or ())
    if n_scenes < 1:
        raise ValueError("train_multiscene needs scene_specs or datasets")
    mesh = mesh_mod.make_scene_mesh(n_scenes, cfg.num_devices)
    scenes = ms_mod.local_scenes(mesh, n_scenes)
    if datasets is None:
        device = _rank_device(device)
        local_ds = [make_dataset(scene_cfg(cfg, scene_specs[i]), device) for i in scenes]
    else:
        local_ds = [datasets[i] for i in scenes]
    device = local_ds[0].images.device
    cfg = effective_config(cfg, local_ds[0])
    num_rays = mesh_mod.pad_to_shards(cfg.train.num_rays, mesh)
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, num_rays=num_rays))
    tb = (TBLogger(cfg.log_dir, cfg.run_name or str(int(time.time()))) if primary
          else NullLogger())
    tb.hparams(cfg.hparams())
    if primary:
        with open(os.path.join(tb.dir, "config.json"), "w") as f:
            f.write(cfg.to_json())

    states = ms_mod.init_multiscene_state(cfg, mesh, n_scenes, device)
    load_path = cfg.load_path or ckpt.latest_checkpoint(cfg.save_dir)
    if load_path:
        for state, i in zip(states, scenes):
            ckpt.restore(load_path, state, scene=i)
        if primary:
            print(f"resumed from {load_path} at step {states[0].step}")
    step_fn = ms_mod.make_multiscene_train_step(cfg, mesh, n_scenes)
    sampler = ms_mod.MultiSceneSampler(local_ds, scenes)
    render_fn = make_render(cfg)
    leader = mesh.coords[mesh_mod.DATA_AXIS] == 0

    def eval_all(it):
        psnrs, rgb = [], None
        for state, ds in zip(states, local_ds):
            if not leader:
                psnrs.append(float("nan"))
                continue
            ev = with_ema_params(state)
            o, d = ds.view_rays(0)
            rgb, _, _ = render_frame(cfg, ev.params, o, d, render_fn,
                                     fine_params=ev.fine_params, grid=state.grid)
            psnrs.append(float(render_ops.psnr(rgb, ds.view_gold(0))))
        psnrs = ms_mod.gather_scenes(torch.tensor(psnrs, device=device), mesh).tolist()
        for s, p in enumerate(psnrs):
            tb.scalars({f"psnr_eval/scene_{s}": p}, it)
        if primary:
            print(f"iter={it}, per-scene eval psnr=[{', '.join(f'{p:.2f}' for p in psnrs)}]")
            if cfg.live_preview:
                print(image_preview(np.asarray(rgb.cpu())))

    def save(announce=False):
        blobs = ms_mod.gather_scene_objects(
            [ckpt.state_blob(st) for st in states] if leader else [], mesh)
        if primary:
            path = ckpt.save_scenes(blobs, cfg.save_dir)
            if announce:
                print(f"saved {path}")
        dist_init.barrier()

    if not cfg.do_train:
        tb.close()
        return states
    t = cfg.train
    try:
        for it in range(states[0].step, t.num_iter):
            g = step_generator(t.seed, it, device)
            states, auxes = step_fn(states, sampler.sample(g, num_rays), g)
            log_now = it % t.logging_steps == 0 and it > 0
            if it % CHART_STEPS == 0 or log_now:
                losses = ms_mod.gather_scenes(torch.stack([a["loss"] for a in auxes]),
                                              mesh).tolist()
                if primary and it % CHART_STEPS == 0:
                    print(f"iter={it}, per-scene loss=[{', '.join(f'{v:.5f}' for v in losses)}]")
                if log_now:
                    for s, v in enumerate(losses):
                        tb.scalars({f"loss/scene_{s}": v}, it)
                    if on_step:
                        on_step(it, {"loss": float(np.mean(losses))})
            if cfg.eval_on_train and it % t.eval_steps == 0 and it > 0:
                eval_all(it)
            if it % t.save_steps == 0 and it > 0:
                save(announce=True)
        eval_all(t.num_iter)
        save()
    finally:
        tb.close()
    return states
