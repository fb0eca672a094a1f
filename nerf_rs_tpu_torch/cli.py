"""CLI of the port: ``train``, ``eval``, ``render`` and ``export``, the
counterparts of ``cmd_train``, ``cmd_eval``, ``cmd_render`` and
``cmd_export`` in ``nerf_rs_tpu/cli.py``.

  python -m nerf_rs_tpu_torch.cli train --preset full --dataset sphere
  python -m nerf_rs_tpu_torch.cli train --preset hierarchical --dataset sphere
  python -m nerf_rs_tpu_torch.cli eval --preset mipnerf --dataset sphere --max_views 3
  python -m nerf_rs_tpu_torch.cli train --preset factored --dataset sphere
  python -m nerf_rs_tpu_torch.cli train --preset ngp --dataset sphere [--hash_brick false]
  python -m nerf_rs_tpu_torch.cli train --preset proposal --dataset sphere
  python -m nerf_rs_tpu_torch.cli train --preset unbounded --dataset sphere
  python -m nerf_rs_tpu_torch.cli train --preset record --dataset sphere
  python -m nerf_rs_tpu_torch.cli train --preset mipnerf --multiscale_levels 4 --dataset sphere
  python -m nerf_rs_tpu_torch.cli eval --preset mipnerf --scales 1,2,4,8 --dataset sphere
  python -m nerf_rs_tpu_torch.cli render --dataset sphere --view 0
  python -m nerf_rs_tpu_torch.cli train --preset record --dataset blender --img_dir data/proclego
  python -m nerf_rs_tpu_torch.cli eval --preset record --dataset blender --img_dir data/proclego
  python -m nerf_rs_tpu_torch.cli train --dataset llff --img_dir data/fern --ndc true
  python -m nerf_rs_tpu_torch.cli train --preset pod --dataset blender --img_dir data/proclego
  python -m nerf_rs_tpu_torch.cli train --preset full --dataset sphere --ema_decay 0.999
  python -m nerf_rs_tpu_torch.cli render --preset full --dataset sphere --depth true --gif true
  python -m nerf_rs_tpu_torch.cli export --preset full --dataset sphere --grid_res 128 --mesh true
  python -m nerf_rs_tpu_torch.cli train --preset pod --dataset sphere --num_devices 4
  python -m nerf_rs_tpu_torch.cli train --scenes sphere,flat_sphere --num_devices 4
  python -m nerf_rs_tpu_torch.cli eval --scenes sphere,flat_sphere --scene_index 1

It takes the JAX parser's flags that the ported slices serve, with the
JAX defaults (``--use_whole_ray_train`` is off unless a preset turns it
on; the presets ``tiny``, ``full``, ``hierarchical``, ``mipnerf``,
``proposal``, ``unbounded`` and ``record`` do,
with the JAX package's values, and explicit flags beat the preset).
``--preset factored`` (or ``--arch factored``) selects the factored field,
whose encode runs as the JAX CLI runs it, through the dense hat matrix:
the factored-encode kernel is ``ModelConfig.fac_fused``, for which the
parser has no flag. ``--preset ngp`` (or ``--arch hashgrid``) selects the
hash-grid field, in the brick table layout with the preset and in the flat
one with ``--hash_brick false``; every table fetch goes through the row-gather
kernel. ``--preset proposal`` samples through a proposal net (2 x 64 ->
128 main samples, annealed); ``--preset unbounded`` is mip-NeRF 360's
recipe (contraction, disparity spacing, a 2-level annealed proposal, the
distortion loss), both through the whole-ray kernels. ``--preset record`` is
the JAX package's quality-record composition: IPE on one shared field, a
union fine pass, softplus density, a white background and coarse interval
edges drawn from an occupancy grid (``--occ_res 32``; the ``--occ_*`` flags),
through the whole-ray kernels. ``--multiscale_levels`` trains on a box
pyramid of the views (each ray with its level's cone radius), and ``eval
--scales`` reports PSNR and SSIM at each downscale. Eval and render of a
proposal checkpoint need the preset it was trained with (the file's second
net is the proposal); those of an occupancy-trained one need its
``--occ_res``.
The datasets: the sphere, the reference's multiview PNG layout
(``--img_dir``, ``--view_*``, ``--num_views_per_hemisphere``), Blender
scenes (``--dataset blender``; ``eval --split`` picks the split) and LLFF
captures (``--llff_factor``, ``--llff_holdout``; ``--ndc`` warps the rays
to NDC and sets near 0, far 1 unless they are given). The batch modes
(``--batch_mode per_ray | multiview | host``, ``--views_per_batch``; the
host pipeline's ``--prefetch``, ``--data_workers`` and
``--use_native_loader``, the C++ gather) and error-weighted resampling
(``--error_resample_frac``, ``--error_resample_ema``; ``--preset pod``).
Slice 7: the weights' EMA (``--ema_decay``; eval, render and export use
the EMA weights of a checkpoint that holds them), gradient accumulation
(``--accumulation_steps``), the paper's sigma noise (``--raw_noise_std``,
a flag the JAX parser lacks: its ``RenderConfig`` field), the TensorBoard
events and diagnostics in the run directory (``--logging_steps``,
``--log_densities_only``), the profiler window (``--profile_steps``),
``render --depth`` (a depth / far and an acc PNG beside each frame) and
``--gif`` (``sweep.gif``, written by the port) and ``export`` (the density
grid as ``.npz``, a ``.ply`` point cloud, with ``--mesh`` a marching-
tetrahedra mesh). Slice 8: ``--num_devices`` data-parallel ranks, one a
card over NCCL (0: every visible card; more than are visible raises), or
gloo ranks with ``--device cpu``, started by ``parallel/launch.py``, on
each host of a multi-host run (``NERF_NUM_PROCESSES``, ``NERF_PROCESS_ID``,
``NERF_COORDINATOR``); ``--shard_pixel_store`` (each rank keeps a block of
the views); ``--scenes`` (one field a scene, the scenes over a (scene,
data) mesh, one stacked checkpoint) and ``--scene_index`` (which scene of
it ``eval``, ``render`` and ``export`` read). ``eval`` and ``render`` run
on the ranks, ``export`` on the primary's device. ``--compat`` is the
reference's committed math (``config.reference_compat_config``: the 8 x 100
raw-xyz field, its density composited as grey, t = u * far samples), of
which the flags keep only ``--num_samples``; it trains through autograd and
renders through the eager field (``--use_fused_kernel`` defaults off, and
the render kernel does not take it when asked), and ``export`` refuses it, as
the JAX CLI's fails on it. The parser knows every flag of the JAX parser,
and an unknown flag is argparse's error.

Runs go to the card (the paper field trains through the whole-ray train
kernel and renders through the render kernel) unless ``--device cpu`` asks for
the CPU, the port's counterpart of ``JAX_PLATFORMS=cpu``; without a
card, ``--device cuda`` (the default) raises.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import os
import sys
import time

import numpy as np
import torch

from .config import (
    CameraConfig,
    Config,
    DataConfig,
    ModelConfig,
    ProposalConfig,
    RenderConfig,
    TrainConfig,
    reference_compat_config,
)

from .train.loop import resolve_device


def _bool_flag(p, name, default, help=""):
    p.add_argument(
        f"--{name}",
        type=lambda s: s.lower() in ("1", "true", "yes"),
        default=default,
        help=help + f" (default {default})",
    )


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="nerf_rs_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    common = argparse.ArgumentParser(add_help=False)
    _bool_flag(common, "debug", False, "eval renders the gold view instead of predictions")
    _bool_flag(common, "do_train", True)
    _bool_flag(common, "eval_on_train", True)
    _bool_flag(common, "live_preview", False,
               "print eval frames in the terminal (ANSI half-blocks)")
    _bool_flag(common, "log_densities_only", False,
               "the eval hook logs no prediction or depth images")
    common.add_argument("--log_dir", default="logs")
    common.add_argument("--save_dir", default="checkpoints")
    common.add_argument("--load_path", default="")
    common.add_argument("--run_name", default="")
    common.add_argument("--num_iter", type=int, default=50_000)
    common.add_argument("--eval_steps", type=int, default=101)
    common.add_argument("--logging_steps", type=int, default=101)
    common.add_argument("--save_steps", type=int, default=1001)
    common.add_argument("--learning_rate", type=float, default=5e-4)
    common.add_argument("--lr_decay_steps", type=int, default=0,
                        help="exponential decay horizon (0 = constant lr)")
    common.add_argument("--lr_final", type=float, default=5e-6)
    common.add_argument("--ema_decay", type=float, default=0.0,
                        help="EMA of the trainable weights for eval, render and export (0 = "
                             "off); the averaging window 1/(1-d) a small fraction of num_iter "
                             "(0.999 for 30k iterations)")
    common.add_argument("--accumulation_steps", type=int, default=1,
                        help="micro-batches whose gradients one Adam update averages")
    common.add_argument("--raw_noise_std", type=float, default=0.0,
                        help="std of the noise on the raw density of randomized passes (the "
                             "paper's regulariser; trains through autograd)")
    common.add_argument("--profile_steps", type=int, default=0,
                        help="trace N steps with torch.profiler, from the 10th after the "
                             "run's first step, into a Chrome trace in the run directory "
                             "(0 = off)")
    common.add_argument("--img_dir", default="data/monkey-128-no-shading-2d-6")
    common.add_argument("--view_start", type=int, default=0)
    common.add_argument("--view_end", type=int, default=84)
    common.add_argument("--view_step", type=int, default=1)
    common.add_argument("--num_views_per_hemisphere", type=int, default=6)
    common.add_argument("--dataset", default="multiview_png",
                        choices=["multiview_png", "blender", "llff", "sphere",
                                 "flat_sphere"])
    common.add_argument("--llff_factor", type=int, default=1,
                        help="LLFF image downsample factor (loads images_{factor}/ when "
                             "present)")
    common.add_argument("--llff_holdout", type=int, default=8,
                        help="every Nth LLFF view is test (0 = none)")
    common.add_argument("--width", type=int, default=128)
    common.add_argument("--height", type=int, default=128)
    common.add_argument("--near", type=float, default=0.05)
    common.add_argument("--far", type=float, default=2.0)
    _bool_flag(common, "ndc", False,
               "NDC ray warp (NeRF appendix C, forward-facing / LLFF captures); sets "
               "--near 0 --far 1 unless they are given")
    common.add_argument("--ndc_near", type=float, default=1.0,
                        help="world near-plane distance of the NDC warp")
    common.add_argument("--num_rays", type=int, default=4096)
    common.add_argument("--num_samples", type=int, default=64)
    common.add_argument("--num_fine_samples", type=int, default=0)
    _bool_flag(common, "share_network", False,
               "one field for both hierarchical passes")
    common.add_argument(
        "--fine_mode", default="union", choices=["union", "standalone"],
        help="union: composite coarse+fine samples (paper); standalone: "
             "composite only the fine samples",
    )
    _bool_flag(common, "white_background", False)
    common.add_argument("--occ_res", type=int, default=0,
                        help="occupancy-grid resolution for grid-guided sampling (0 = off)")
    common.add_argument("--occ_update_steps", type=int, default=16,
                        help="grid EMA update cadence (train steps)")
    common.add_argument("--occ_threshold", type=float, default=1e-2,
                        help="raw-sigma occupancy cutoff")
    common.add_argument("--occ_aabb", type=float, default=1.0,
                        help="the grid's AABB half-extent")
    common.add_argument("--occ_bins", type=int, default=64,
                        help="ray bins tested against the grid per draw")
    common.add_argument("--occ_decay", type=float, default=0.95,
                        help="per-update EMA decay")
    common.add_argument("--occ_uniform_frac", type=float, default=0.25,
                        help="uniform floor blended into the occupancy PDF")
    common.add_argument("--multiscale_levels", type=int, default=1,
                        help="mip-NeRF multiscale training: > 1 draws each batch across a "
                             "1/1 .. 1/2^(L-1) box pyramid, every ray with its level's cone "
                             "radius")
    common.add_argument("--sigma_activation", default="relu", choices=["relu", "softplus"])
    _bool_flag(common, "ipe", False,
               "mip-NeRF: conical-frustum intervals with the integrated encoding")
    _bool_flag(common, "contract", False,
               "mip-NeRF 360 scene contraction (unbounded scenes): sample positions map "
               "into the radius-2 ball before the encoding; pair with --sampling_space "
               "disparity (--preset unbounded)")
    common.add_argument("--sampling_space", default="linear", choices=["linear", "disparity"],
                        help="spacing of the stratified draw: linear (NeRF eq. 2) or "
                             "disparity (even in 1/t; needs --near > 0)")
    _bool_flag(common, "use_proposal", False,
               "proposal-net sampling (mip-NeRF 360): a small density MLP picks the main "
               "field's samples, trained with the interlevel loss (num_fine_samples 0)")
    common.add_argument("--proposal_samples", type=int, default=64,
                        help="samples the proposal MLP evaluates per level")
    common.add_argument("--proposal_levels", type=int, default=1,
                        help="resampling rounds through the one proposal MLP")
    common.add_argument("--proposal_depth", type=int, default=4)
    common.add_argument("--proposal_width", type=int, default=64)
    common.add_argument("--proposal_anneal_steps", type=int, default=0,
                        help="mip-NeRF 360 resampling annealing horizon (0 = off)")
    common.add_argument("--distortion_weight", type=float, default=0.0,
                        help="mip-NeRF 360 distortion loss weight on the finest pass "
                             "(0 = off; the paper uses 0.01)")
    common.add_argument("--arch", default="nerf", choices=["nerf", "hashgrid", "factored"],
                        help="field family: the paper NeRF, the Instant-NGP hash encoding "
                             "with tiny heads, or the factored (CP) multiresolution lines "
                             "with tiny heads")
    common.add_argument("--hash_levels", type=int, default=16,
                        help="hashgrid resolution levels")
    common.add_argument("--hash_table_log2", type=int, default=19,
                        help="log2 entries per hash level")
    common.add_argument("--hash_base_res", type=int, default=16)
    common.add_argument("--hash_max_res", type=int, default=1024)
    common.add_argument("--hash_aabb", type=float, default=1.6,
                        help="hash grid AABB half-extent")
    _bool_flag(common, "hash_brick", False,
               "brick table layout: one 128-wide row per (point, level) instead of "
               "8 corner pairs; same parameter count")
    common.add_argument("--fac_levels", type=int, default=6,
                        help="factored-family resolution-ladder levels")
    common.add_argument("--fac_base_res", type=int, default=16)
    common.add_argument("--fac_max_res", type=int, default=512,
                        help="finest factored line resolution")
    common.add_argument("--fac_comps", type=int, default=48,
                        help="CP rank (channels per axis)")
    common.add_argument("--fac_aabb", type=float, default=1.6,
                        help="factored field AABB half-extent")
    common.add_argument("--fac_l1", type=float, default=0.0,
                        help="L1 penalty on the factored line tables")
    common.add_argument("--batch_mode", default="per_ray",
                        choices=["per_ray", "multiview", "host"],
                        help="per_ray: iid on-device sampling; multiview: views_per_batch "
                             "views, the rays split evenly (the reference's batches); host: "
                             "the async host pipeline")
    common.add_argument("--views_per_batch", type=int, default=4,
                        help="distinct views per batch (multiview mode)")
    common.add_argument("--prefetch", type=int, default=2,
                        help="host-pipeline buffered batches")
    common.add_argument("--data_workers", type=int, default=1,
                        help="parallel host assembly threads (host mode)")
    _bool_flag(common, "use_native_loader", True,
               "the C++ batch assembler for the host mode's gold gather (built with g++ "
               "at first use; a failed build raises)")
    _bool_flag(common, "shard_pixel_store", False,
               "split the pixel store's views over the ranks (per_ray batches, no error "
               "resampling, more than one rank)")
    common.add_argument("--scenes", default="",
                        help="comma-separated scenes of multi-scene training: each a dataset "
                             "name (sphere, flat_sphere) or an img_dir for --dataset; one field "
                             "a scene, the scenes over a (scene, data) mesh of the ranks")
    common.add_argument("--error_resample_frac", type=float, default=0.0,
                        help="fraction of rays drawn from the per-pixel error distribution")
    common.add_argument("--error_resample_ema", type=float, default=0.5)
    common.add_argument("--precision", default="mixed", choices=["f32", "bf16", "mixed"],
                        help="matmul precision of the eager field path; the "
                             "kernels always multiply in bf16")
    common.add_argument("--seed", type=int, default=0)
    common.add_argument("--device", default="cuda",
                        help="where the run goes: cuda (the card; raises without one) or cpu")
    common.add_argument("--num_devices", type=int, default=0,
                        help="data-parallel ranks, one a device: cards (0: every visible card; "
                             "more than are visible raises), or gloo ranks with --device cpu "
                             "(0: one); over NERF_NUM_PROCESSES hosts, the run's total")
    _bool_flag(common, "compat", False,
               "reference-compat math (8x100 raw-xyz MLP, density composited as grey, "
               "t = u * far); keeps only --num_samples of the model and render flags")
    _bool_flag(common, "use_fused_kernel", True,
               "render through the whole-ray CUDA render kernel (compat mode defaults it "
               "off)")
    _bool_flag(common, "use_whole_ray_train", False,
               "train through the whole-ray CUDA train kernel (the presets "
               "turn it on)")
    common.add_argument("--preset", default="",
                        choices=["", "tiny", "full", "hierarchical", "mipnerf", "factored",
                                 "ngp", "proposal", "unbounded", "record", "pod"],
                        help="tiny = 100x100 coarse-only 4096-ray fit; full = paper "
                             "NeRF, stratified 64; hierarchical = two fields, 64 + 128 "
                             "union; mipnerf = IPE, one field, 64 + 128 standalone; all "
                             "through the train kernel; factored = CP lines + tiny heads, "
                             "softplus, lr 1e-2, 128 samples, white background; ngp = "
                             "Instant-NGP hash grid in the brick layout, with the same "
                             "heads and settings; proposal = a proposal net picks 128 main "
                             "samples (annealed over 1000 steps); unbounded = mip-NeRF 360: "
                             "contraction, disparity sampling over [0.3, 60], a 2-level "
                             "annealed proposal, distortion loss 0.01, softplus; record = "
                             "IPE, one field, 64 + 128 union, softplus, white background, "
                             "coarse edges from a 32^3 occupancy grid; pod = error-weighted "
                             "resampling of at least half the rays, data parallel over "
                             "--num_devices cards")

    sub.add_parser("train", parents=[common])

    pe = sub.add_parser("eval", parents=[common])
    pe.add_argument("--scene_index", type=int, default=0,
                    help="which scene of a --scenes checkpoint")
    pe.add_argument("--split", default="test",
                    help="dataset split to evaluate (Blender: transforms_{split}.json; LLFF: "
                         "the holdout's test, train or all)")
    pe.add_argument("--max_views", type=int, default=0, help="0 = all views")
    pe.add_argument("--out_dir", default="", help="optionally dump per-view renders")
    pe.add_argument("--scales", default="",
                    help="comma-separated downscales to evaluate (e.g. 1,2,4,8; "
                         "default 1)")

    pr = sub.add_parser("render", parents=[common])
    pr.add_argument("--scene_index", type=int, default=0,
                    help="which scene of a --scenes checkpoint")
    pr.add_argument("--out_dir", default="renders")
    pr.add_argument("--view", type=int, default=-1,
                    help="render one dataset view instead of a sweep")
    pr.add_argument("--frames", type=int, default=40, help="spherical sweep length")
    pr.add_argument("--pitch", type=float, default=math.pi / 6)
    _bool_flag(pr, "gif", False, "also write the sweep as an animated sweep.gif")
    _bool_flag(pr, "depth", False,
               "also write depth (expected termination distance / far) and acc (opacity) PNGs "
               "beside each frame")

    px = sub.add_parser("export", parents=[common])
    px.add_argument("--scene_index", type=int, default=0,
                    help="which scene of a --scenes checkpoint")
    px.add_argument("--grid_res", type=int, default=128, help="density grid resolution per axis")
    px.add_argument("--export_aabb", type=float, default=1.6,
                    help="half-extent of the sampled cube")
    px.add_argument("--threshold", type=float, default=5.0,
                    help="sigma cutoff of the .ply point cloud and the mesh")
    px.add_argument("--out", default="export/field",
                    help="output prefix; writes <out>.npz and <out>.ply")
    _bool_flag(px, "mesh", False,
               "also extract the --threshold isosurface as a triangle mesh (marching "
               "tetrahedra) into <out>_mesh.ply")
    return p


def explicit_dests(argv) -> set:
    """Dest names the user explicitly passed in ``argv``: re-parses with
    every default suppressed, so presets never clobber an explicit
    flag."""
    p = build_parser()
    stack = [p]
    while stack:
        parser = stack.pop()
        for a in parser._actions:
            if isinstance(a, argparse._SubParsersAction):
                stack.extend(a.choices.values())
            else:
                a.default = argparse.SUPPRESS
    ns, _ = p.parse_known_args(argv)
    return set(vars(ns))


def _apply_preset(args):
    """Overlay the named preset onto parsed args: explicit user flags
    (``args._explicit``) beat the preset, which beats parser defaults."""
    p = getattr(args, "preset", "")
    explicit = getattr(args, "_explicit", set())

    def _set(**kw):
        for name, value in kw.items():
            if name not in explicit:
                setattr(args, name, value)

    if getattr(args, "ndc", False):
        # NDC warps rays to the unit depth range: near 0, far 1 unless given
        _set(near=0.0, far=1.0)
    if getattr(args, "compat", False):
        # compat's grey composite renders through the eager field unless the
        # user asks for the kernel (which does not take the compat field)
        _set(use_fused_kernel=False)
    if p == "tiny":
        _set(width=100, height=100, num_rays=4096, num_samples=64,
             num_fine_samples=0, use_whole_ray_train=True)
    elif p == "full":
        _set(num_samples=64, num_fine_samples=0, use_whole_ray_train=True)
    elif p == "hierarchical":
        # NeRF section 5.2: separate coarse and fine fields, union fine pass
        _set(num_samples=64, num_fine_samples=128, white_background=True,
             use_whole_ray_train=True)
    elif p == "mipnerf":
        # mip-NeRF: IPE intervals, one field for both passes, the fine
        # intervals composited standalone, softplus density
        _set(ipe=True, share_network=True, fine_mode="standalone",
             num_samples=64, num_fine_samples=128,
             sigma_activation="softplus", white_background=True,
             use_whole_ray_train=True)
    elif p == "record":
        # the JAX package's quality-record composition: IPE intervals on
        # one shared field, the union fine pass (64 + 128: 193 intervals),
        # softplus, white background, and the coarse edges drawn from a
        # 32^3 occupancy grid over [-1.6, 1.6]^3 with a 10% uniform floor
        _set(ipe=True, share_network=True, fine_mode="union",
             num_samples=64, num_fine_samples=128,
             sigma_activation="softplus", white_background=True,
             use_whole_ray_train=True, occ_res=32, occ_aabb=1.6,
             occ_uniform_frac=0.10)
    elif p == "factored":
        # the CP-factored multiresolution field (models/factored.py); its
        # grids learn at a high rate, like the ngp preset's
        _set(arch="factored", sigma_activation="softplus", learning_rate=1e-2,
             num_samples=128, white_background=True)
    elif p == "ngp":
        # the Instant-NGP family (models/hashgrid.py): hash tables learn at a
        # much higher rate than MLPs (paper section 4); softplus keeps density
        # gradients alive through the sparse table entries. The brick layout
        # is the JAX preset's; --hash_brick false selects the paper's flat one
        _set(arch="hashgrid", sigma_activation="softplus", hash_brick=True,
             learning_rate=1e-2, num_samples=128, white_background=True)
    elif p == "proposal":
        # a proposal net picks 128 main samples, the main pass through the
        # train kernel; the anneal keeps early draws near-uniform
        _set(num_samples=128, num_fine_samples=0, use_proposal=True,
             proposal_samples=64, use_whole_ray_train=True,
             white_background=True, proposal_anneal_steps=1000)
    elif p == "pod":
        # error-weighted resampling of at least half the rays; its data
        # parallelism is --num_devices' (0: every card)
        _set(error_resample_frac=max(args.error_resample_frac, 0.5))
    elif p == "unbounded":
        # mip-NeRF 360's unbounded recipe: radius-2 contraction, disparity
        # spacing, a 2-level annealed proposal and the distortion loss in
        # disparity s-space, all through the whole-ray kernels
        _set(contract=True, sampling_space="disparity", near=0.3, far=60.0,
             use_proposal=True, proposal_samples=64, proposal_levels=2,
             num_samples=64, num_fine_samples=0, proposal_anneal_steps=1000,
             distortion_weight=0.01, sigma_activation="softplus",
             white_background=False, use_whole_ray_train=True)
    return args


def config_from_args(args) -> Config:
    args = _apply_preset(args)
    if args.compat:
        # the reference's model and render settings; of their flags only
        # --num_samples is read, as the JAX CLI reads them
        base = reference_compat_config()
        model = base.model
        render = dataclasses.replace(base.render, num_samples=args.num_samples)
    else:
        model = ModelConfig(arch=args.arch, hash_levels=args.hash_levels,
                            hash_table_log2=args.hash_table_log2,
                            hash_base_res=args.hash_base_res, hash_max_res=args.hash_max_res,
                            hash_aabb=args.hash_aabb, hash_brick=args.hash_brick,
                            fac_levels=args.fac_levels,
                            fac_base_res=args.fac_base_res, fac_max_res=args.fac_max_res,
                            fac_comps=args.fac_comps, fac_aabb=args.fac_aabb,
                            fac_l1=args.fac_l1, sigma_activation=args.sigma_activation,
                            ipe=args.ipe, contract=args.contract)
        render = RenderConfig(num_samples=args.num_samples,
                              num_fine_samples=args.num_fine_samples,
                              share_network=args.share_network,
                              fine_mode=args.fine_mode,
                              white_background=args.white_background,
                              occ_res=args.occ_res,
                              occ_update_steps=args.occ_update_steps,
                              occ_threshold=args.occ_threshold,
                              occ_aabb=args.occ_aabb,
                              occ_bins=args.occ_bins,
                              occ_decay=args.occ_decay,
                              occ_uniform_frac=args.occ_uniform_frac,
                              sampling_space=args.sampling_space,
                              raw_noise_std=args.raw_noise_std)
    return Config(
        debug=args.debug,
        do_train=args.do_train,
        eval_on_train=args.eval_on_train,
        live_preview=args.live_preview,
        log_dir=args.log_dir,
        save_dir=args.save_dir,
        load_path=args.load_path,
        run_name=args.run_name,
        camera=CameraConfig(width=args.width, height=args.height, near=args.near,
                            far=args.far, ndc=args.ndc, ndc_near=args.ndc_near),
        model=model,
        log_densities_only=args.log_densities_only,
        render=render,
        train=TrainConfig(
            num_rays=args.num_rays,
            learning_rate=args.learning_rate,
            lr_decay_steps=args.lr_decay_steps,
            lr_final=args.lr_final,
            num_iter=args.num_iter,
            eval_steps=args.eval_steps,
            logging_steps=args.logging_steps,
            save_steps=args.save_steps,
            seed=args.seed,
            precision=args.precision,
            distortion_weight=args.distortion_weight,
            error_resample_frac=args.error_resample_frac,
            error_resample_ema=args.error_resample_ema,
            accumulation_steps=args.accumulation_steps,
            ema_decay=args.ema_decay,
            profile_steps=args.profile_steps,
        ),
        data=DataConfig(dataset=args.dataset, img_dir=args.img_dir,
                        view_start=args.view_start, view_end=args.view_end,
                        view_step=args.view_step,
                        num_views_per_hemisphere=args.num_views_per_hemisphere,
                        batch_mode=args.batch_mode, views_per_batch=args.views_per_batch,
                        prefetch=args.prefetch, use_native_loader=args.use_native_loader,
                        data_workers=args.data_workers, llff_factor=args.llff_factor,
                        llff_holdout=args.llff_holdout,
                        multiscale_levels=args.multiscale_levels,
                        shard_pixel_store=args.shard_pixel_store,
                        near_explicit="near" in getattr(args, "_explicit", set()),
                        far_explicit="far" in getattr(args, "_explicit", set())),
        proposal=ProposalConfig(
            enabled=args.use_proposal,
            num_samples=args.proposal_samples,
            num_levels=args.proposal_levels,
            net_depth=args.proposal_depth,
            net_width=args.proposal_width,
            anneal_steps=args.proposal_anneal_steps,
        ),
        use_fused_kernel=args.use_fused_kernel,
        use_whole_ray_train=args.use_whole_ray_train,
        num_devices=args.num_devices,
    )


def _scenes(args) -> list:
    return [x for x in getattr(args, "scenes", "").split(",") if x]


def _load_params(cfg: Config, device, scene=None):
    """The field (and the second net: the fine field of a two-field
    hierarchical run, or the proposal net; and the occupancy grid with
    --occ_res) with the weights of --load_path, else of the newest
    checkpoint in --save_dir (weights only: inference does not depend on
    the optimizer), its EMA weights where the file holds them (without
    --ema_decay too), of scene ``scene`` of a --scenes checkpoint: the JAX
    CLI's ``_restore_for_inference``. Returns (params, second net or None,
    grid or None, path or None)."""
    from .parallel import dist_init
    from .train import checkpoint as ckpt
    from .train.step import init_state

    state = init_state(cfg, device)
    params, fine = state.params, state.fine_params
    load_path = cfg.load_path or ckpt.latest_checkpoint(cfg.save_dir)
    if load_path:
        step = ckpt.restore_weights(load_path, params, fine, state.grid, scene=scene)
        ema = ckpt.load_ema(load_path, params, fine, scene=scene)
        if dist_init.is_primary():
            print(f"loaded {load_path} (step {step})")
            if ema is not None:
                print("using EMA weights for inference")
        if ema is not None:
            params, fine = ema if isinstance(ema, tuple) else (ema, fine)
    return params, fine, state.grid, load_path


def _inference_setup(args, split: str = "train"):
    """What eval and render share on a rank: its device and data mesh, the
    config, the dataset (of --scene_index's scene with --scenes) and the
    weights."""
    from .data.factory import effective_config, make_dataset
    from .parallel import dist_init, mesh as mesh_mod
    from .train.loop import scene_cfg

    cfg = config_from_args(args)
    device = dist_init.device() or resolve_device(args.device)
    mesh = mesh_mod.make_mesh(cfg.num_devices)
    scenes, scene = _scenes(args), None
    data_cfg = cfg
    if scenes:
        scene = args.scene_index
        if not 0 <= scene < len(scenes):
            raise ValueError(f"--scene_index {scene} is not one of the {len(scenes)} --scenes")
        data_cfg = scene_cfg(cfg, scenes[scene])
    dataset = make_dataset(data_cfg, device, split=split)
    cfg = effective_config(cfg, dataset)
    return (cfg, device, mesh, dataset) + _load_params(cfg, device, scene)


def _on_ranks(args, fn) -> int:
    """``fn(args)`` on every rank of --num_devices (one: in this process)."""
    from .parallel import launch

    return launch.run(fn, (args,), args.num_devices, torch.device(args.device).type)


def cmd_train(args) -> int:
    """Training on --num_devices ranks (``train/loop.train``), or with
    --scenes one field a scene (``train/loop.train_multiscene``)."""
    return _on_ranks(args, _train_rank)


def _train_rank(args) -> int:
    from .parallel import dist_init
    from .train.loop import train, train_multiscene

    cfg = config_from_args(args)
    device = resolve_device(args.device)  # a rank of a process group takes its own
    scenes = _scenes(args)
    if scenes:
        states = train_multiscene(cfg, scene_specs=scenes, device=device)
        if dist_init.is_primary():
            print(f"done at step {states[0].step} ({len(scenes)} scenes)")
        return 0
    state = train(cfg, device=device)
    if dist_init.is_primary():
        print(f"done at step {state.step}")
    return 0


def cmd_eval(args) -> int:
    """Per-view and mean PSNR and SSIM over a split, rendered with the
    deterministic sampler; with ``--scales`` at each downscale (the rays
    through the centres of scale-wide pixel blocks, a camera whose cone
    radius widens by the scale, the gold box-averaged), then the mean over
    every (scale, view). Every rank renders its share of each frame; the
    primary prints and writes."""
    return _on_ranks(args, _eval_rank)


def _eval_rank(args) -> int:
    from .data.dataset import scaled_camera
    from .data.images import save_png
    from .ops import render as render_ops
    from .ops.metrics import ssim as ssim_fn
    from .parallel import dist_init, dp
    from .render import render_frame

    split = args.split if args.dataset in ("blender", "llff") else "train"
    cfg, device, mesh, dataset, params, fine_params, grid, load_path = _inference_setup(args,
                                                                                         split)
    primary = dist_init.is_primary()
    if not load_path:
        if primary:
            print("error: no checkpoint found (use --load_path or --save_dir)")
        return 1
    scales = [int(x) for x in args.scales.split(",") if x] or [1]
    n = dataset.num_views if args.max_views <= 0 else min(args.max_views, dataset.num_views)
    if args.out_dir and primary:
        os.makedirs(args.out_dir, exist_ok=True)
    per_scale = {}  # scale -> (psnrs, ssims)
    t0 = time.time()
    for scale in scales:
        scfg = cfg if scale == 1 else dataclasses.replace(
            cfg, camera=scaled_camera(cfg.camera, scale))
        render_fn = dp.make_dp_render(scfg, mesh)
        psnrs, ssims = per_scale.setdefault(scale, ([], []))
        tag = f" 1/{scale}" if len(scales) > 1 else ""
        for v in range(n):
            rgb, _, _ = render_frame(scfg, params, *dataset.view_rays(v, scale), render_fn,
                                     fine_params=fine_params, grid=grid)
            gold = dataset.view_gold(v, scale)
            p = float(render_ops.psnr(rgb, gold))
            s = float(ssim_fn(rgb, gold))
            psnrs.append(p)
            ssims.append(s)
            if primary:
                print(f"view {v:3d}{tag}: psnr {p:.2f}  ssim {s:.4f}")
                if args.out_dir:
                    suffix = f"-s{scale}" if len(scales) > 1 else ""
                    save_png(os.path.join(args.out_dir, f"eval-{v:03d}{suffix}.png"), rgb)
    if not primary:
        return 0
    for scale in scales:
        psnrs, ssims = per_scale[scale]
        tag = f" at 1/{scale}" if len(scales) > 1 else ""
        print(f"mean psnr over {n} {args.split} views{tag}: {np.mean(psnrs):.2f} "
              f"(min {np.min(psnrs):.2f}, max {np.max(psnrs):.2f}), "
              f"mean ssim {np.mean(ssims):.4f} in {time.time()-t0:.1f}s")
    if len(scales) > 1:
        allp = [p for ps, _ in per_scale.values() for p in ps]
        alls = [s for _, ss in per_scale.values() for s in ss]
        print(f"multiscale mean psnr: {np.mean(allp):.2f}, mean ssim {np.mean(alls):.4f}")
    return 0


def cmd_render(args) -> int:
    """One dataset view (``--view``) or a spherical sweep of ``--frames``
    frames in one render call; with ``--depth`` a ``-depth.png`` (the
    expected termination distance over far, clipped to [0, 1]) and an
    ``-acc.png`` beside each frame, with ``--gif`` the sweep as
    ``sweep.gif``. Every rank renders its share of the rays; the primary
    writes and prints."""
    return _on_ranks(args, _render_rank)


def _render_rank(args) -> int:
    from .data.images import save_gif, save_png
    from .ops import rays as rays_ops, render as render_ops
    from .parallel import dist_init, dp
    from .render import render_frame

    cfg, device, mesh, dataset, params, fine_params, grid, load_path = _inference_setup(args)
    primary = dist_init.is_primary()
    if not load_path and primary:
        print("warning: no checkpoint found; rendering an untrained field")
    render_fn = dp.make_dp_render(cfg, mesh)

    if primary:
        os.makedirs(args.out_dir, exist_ok=True)
    t0 = time.time()

    def save_depth_acc(stem, depth, acc):
        # depth / far: a scale-free PNG; acc is in [0, 1]; grey as RGB
        dn = torch.clamp(depth / cfg.camera.far, 0.0, 1.0)
        save_png(stem + "-depth.png", dn[..., None].expand(*dn.shape, 3))
        an = torch.clamp(acc, 0.0, 1.0)
        save_png(stem + "-acc.png", an[..., None].expand(*an.shape, 3))

    if args.view >= 0:
        o, d = dataset.view_rays(args.view)
        rgb, depth, acc = render_frame(cfg, params, o, d, render_fn, fine_params=fine_params,
                                       grid=grid)
        if primary:
            psnr = float(render_ops.psnr(rgb, dataset.view_gold(args.view)))
            path = os.path.join(args.out_dir, f"view-{args.view}.png")
            save_png(path, rgb)
            if args.depth:
                save_depth_acc(os.path.join(args.out_dir, f"view-{args.view}"), depth, acc)
            print(f"{path}  psnr={psnr:.2f}  ({time.time()-t0:.2f}s)")
        return 0

    # the whole sweep's rays go through one render call
    angles = rays_ops.spherical_render_path(args.frames, args.pitch, device)
    poses = rays_ops.pose_from_yaw_pitch(angles[:, 0], angles[:, 1])
    h, w = cfg.camera.height, cfg.camera.width
    grids = [rays_ops.maybe_ndc(*rays_ops.ray_grid(poses[i], cfg.camera), cfg.camera)
             for i in range(args.frames)]
    big_o = torch.cat([o.reshape(-1, 3) for o, _ in grids]).reshape(args.frames * h, w, 3)
    big_d = torch.cat([d.reshape(-1, 3) for _, d in grids]).reshape(args.frames * h, w, 3)
    rgb, depth, acc = render_frame(cfg, params, big_o, big_d, render_fn,
                                   fine_params=fine_params, grid=grid)
    if not primary:
        return 0
    rgb = rgb.reshape(args.frames, h, w, 3).cpu()
    depth = depth.reshape(args.frames, h, w).cpu()
    acc = acc.reshape(args.frames, h, w).cpu()
    for i in range(args.frames):
        save_png(os.path.join(args.out_dir, f"frame-{i:03d}.png"), rgb[i])
        if args.depth:
            save_depth_acc(os.path.join(args.out_dir, f"frame-{i:03d}"), depth[i], acc[i])
    if args.gif:
        gif_path = os.path.join(args.out_dir, "sweep.gif")
        save_gif(gif_path, rgb, fps=10, loop=0)
        print(f"wrote {gif_path}")
    dt = time.time() - t0
    print(f"rendered {args.frames} frames of {w}x{h} "
          f"in {dt:.2f}s ({dt/args.frames:.3f}s/frame)")
    return 0


def cmd_export(args) -> int:
    """The trained field (its EMA weights where the checkpoint holds them;
    with --scenes, --scene_index's) sampled on a ``--grid_res``^3 grid
    through the eager field (``.npz``), the cells above ``--threshold`` as
    a coloured point cloud (``.ply``) and, with ``--mesh``, the
    threshold's isosurface as a triangle mesh (``_mesh.ply``). It runs in
    this process, on the primary rank's device."""
    from .parallel import launch
    from .utils import export as export_mod
    from .utils import mesh as mesh_mod

    cfg = config_from_args(args)
    device = resolve_device(args.device)
    launch.local_ranks(cfg.num_devices, device.type)  # the count is checked, as for a run
    scenes = _scenes(args)
    if scenes and not 0 <= args.scene_index < len(scenes):
        raise ValueError(f"--scene_index {args.scene_index} is not one of the {len(scenes)} "
                         f"--scenes")
    params, _, _, load_path = _load_params(cfg, device, args.scene_index if scenes else None)
    if not load_path:
        print("error: no checkpoint found (use --load_path or --save_dir)")
        return 1
    t0 = time.time()
    sigma, rgb = export_mod.sample_density_grid(params, cfg.model, res=args.grid_res,
                                                aabb=args.export_aabb)
    out_dir = os.path.dirname(args.out)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    export_mod.save_npz(args.out + ".npz", sigma, rgb, args.export_aabb)
    xyz, rgb8 = export_mod.occupied_points(sigma, rgb, args.export_aabb, args.threshold)
    export_mod.save_ply(args.out + ".ply", xyz, rgb8)
    print(f"exported {args.grid_res}^3 grid -> {args.out}.npz, {xyz.shape[0]} points "
          f"(sigma > {args.threshold}) -> {args.out}.ply in {time.time()-t0:.1f}s")
    if args.mesh:
        verts, faces, colors = mesh_mod.marching_tetrahedra(sigma, args.threshold,
                                                            args.export_aabb, rgb=rgb)
        mesh_path = args.out + "_mesh.ply"
        mesh_mod.save_mesh_ply(mesh_path, verts, faces, colors)
        print(f"mesh: {verts.shape[0]} verts / {faces.shape[0]} faces -> {mesh_path}")
    return 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    args._explicit = explicit_dests(argv)
    # the kernels' plain versions and any f32 matmul must stay full f32
    torch.backends.cuda.matmul.allow_tf32 = False
    cmd = {"train": cmd_train, "eval": cmd_eval, "render": cmd_render,
           "export": cmd_export}[args.cmd]
    return cmd(args)


if __name__ == "__main__":
    sys.exit(main())
