"""CLI of the port: ``train``, ``eval`` and ``render``, the counterparts
of ``cmd_train``, ``cmd_eval`` and ``cmd_render`` in
``nerf_rs_tpu/cli.py``.

  python -m nerf_rs_tpu_torch.cli train --preset full --dataset sphere
  python -m nerf_rs_tpu_torch.cli train --preset hierarchical --dataset sphere
  python -m nerf_rs_tpu_torch.cli eval --preset mipnerf --dataset sphere --max_views 3
  python -m nerf_rs_tpu_torch.cli train --preset factored --dataset sphere
  python -m nerf_rs_tpu_torch.cli train --preset ngp --dataset sphere [--hash_brick false]
  python -m nerf_rs_tpu_torch.cli render --dataset sphere --view 0

It takes the JAX parser's flags that the ported slices serve, with the
JAX defaults (``--use_whole_ray_train`` is off unless a preset turns it
on; the presets ``tiny``, ``full``, ``hierarchical`` and ``mipnerf`` do,
with the JAX package's values, and explicit flags beat the preset).
``--preset factored`` (or ``--arch factored``) selects the factored field,
whose encode runs as the JAX CLI runs it, through the dense hat matrix:
the factored-encode kernel is ``ModelConfig.fac_fused``, for which the
parser has no flag. ``--preset ngp`` (or ``--arch hashgrid``) selects the
hash-grid field, in the brick table layout with the preset and in the flat
one with ``--hash_brick false``; every table fetch goes through the row-gather
kernel.
Flags, presets and values of slices not ported yet, and the ``export``
subcommand, are refused with an error that names the slice, never
ignored.

Runs go to the card (the paper field trains through the whole-ray train
kernel and renders through the render kernel) unless ``--device cpu`` asks for
the CPU, the port's counterpart of ``JAX_PLATFORMS=cpu``; without a
card, ``--device cuda`` (the default) raises.
"""

from __future__ import annotations

import argparse
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
    RenderConfig,
    TrainConfig,
)

from .train.loop import resolve_device

LATER = {"export": "slice 7"}

# the JAX parser's flags that later slices bring, by slice
_LATER_FLAGS = {
    3: "multiscale_levels",
    4: "occ_res occ_update_steps occ_threshold occ_aabb occ_bins occ_decay "
       "occ_uniform_frac",
    5: "contract sampling_space use_proposal proposal_samples proposal_levels "
       "proposal_depth proposal_width proposal_anneal_steps distortion_weight",
    6: "img_dir view_start view_end view_step num_views_per_hemisphere llff_factor "
       "llff_holdout ndc ndc_near batch_mode views_per_batch prefetch data_workers "
       "use_native_loader error_resample_frac error_resample_ema",
    7: "ema_decay accumulation_steps profile_steps log_densities_only depth gif",
    8: "num_devices shard_pixel_store scenes scene_index",
    10: "compat",
}
_FLAG_SLICE = {f: n for n, flags in _LATER_FLAGS.items() for f in flags.split()}
_PRESET_SLICE = {"record": 4, "proposal": 5, "unbounded": 5, "pod": 6}


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
    common.add_argument("--dataset", default="multiview_png",
                        choices=["multiview_png", "blender", "llff", "sphere",
                                 "flat_sphere"])
    common.add_argument("--width", type=int, default=128)
    common.add_argument("--height", type=int, default=128)
    common.add_argument("--near", type=float, default=0.05)
    common.add_argument("--far", type=float, default=2.0)
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
    common.add_argument("--sigma_activation", default="relu", choices=["relu", "softplus"])
    _bool_flag(common, "ipe", False,
               "mip-NeRF: conical-frustum intervals with the integrated encoding")
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
    common.add_argument("--precision", default="mixed", choices=["f32", "bf16", "mixed"],
                        help="matmul precision of the eager field path; the "
                             "kernels always multiply in bf16")
    common.add_argument("--seed", type=int, default=0)
    common.add_argument("--device", default="cuda",
                        help="where the run goes: cuda (the card; raises without one) or cpu")
    _bool_flag(common, "use_fused_kernel", True,
               "render through the whole-ray CUDA render kernel")
    _bool_flag(common, "use_whole_ray_train", False,
               "train through the whole-ray CUDA train kernel (the presets "
               "turn it on)")
    common.add_argument("--preset", default="",
                        choices=["", "tiny", "full", "hierarchical", "mipnerf", "factored",
                                 "ngp", *sorted(_PRESET_SLICE)],
                        help="tiny = 100x100 coarse-only 4096-ray fit; full = paper "
                             "NeRF, stratified 64; hierarchical = two fields, 64 + 128 "
                             "union; mipnerf = IPE, one field, 64 + 128 standalone; all "
                             "through the train kernel; factored = CP lines + tiny heads, "
                             "softplus, lr 1e-2, 128 samples, white background; ngp = "
                             "Instant-NGP hash grid in the brick layout, with the same "
                             "heads and settings")

    sub.add_parser("train", parents=[common])

    pe = sub.add_parser("eval", parents=[common])
    pe.add_argument("--split", default="test", help="dataset split to evaluate")
    pe.add_argument("--max_views", type=int, default=0, help="0 = all views")
    pe.add_argument("--out_dir", default="", help="optionally dump per-view renders")
    pe.add_argument("--scales", default="",
                    help="downscales to evaluate; only 1 until multiscale (slice 3)")

    pr = sub.add_parser("render", parents=[common])
    pr.add_argument("--out_dir", default="renders")
    pr.add_argument("--view", type=int, default=-1,
                    help="render one dataset view instead of a sweep")
    pr.add_argument("--frames", type=int, default=40, help="spherical sweep length")
    pr.add_argument("--pitch", type=float, default=math.pi / 6)
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

    if p in _PRESET_SLICE:
        raise NotImplementedError(f"--preset {p} comes with slice {_PRESET_SLICE[p]} "
                                  f"of the port")
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
    return args


def config_from_args(args) -> Config:
    args = _apply_preset(args)
    return Config(
        debug=args.debug,
        do_train=args.do_train,
        eval_on_train=args.eval_on_train,
        live_preview=args.live_preview,
        log_dir=args.log_dir,
        save_dir=args.save_dir,
        load_path=args.load_path,
        run_name=args.run_name,
        camera=CameraConfig(width=args.width, height=args.height,
                            near=args.near, far=args.far),
        model=ModelConfig(arch=args.arch, hash_levels=args.hash_levels,
                          hash_table_log2=args.hash_table_log2,
                          hash_base_res=args.hash_base_res, hash_max_res=args.hash_max_res,
                          hash_aabb=args.hash_aabb, hash_brick=args.hash_brick,
                          fac_levels=args.fac_levels,
                          fac_base_res=args.fac_base_res, fac_max_res=args.fac_max_res,
                          fac_comps=args.fac_comps, fac_aabb=args.fac_aabb,
                          fac_l1=args.fac_l1, sigma_activation=args.sigma_activation,
                          ipe=args.ipe),
        render=RenderConfig(num_samples=args.num_samples,
                            num_fine_samples=args.num_fine_samples,
                            share_network=args.share_network,
                            fine_mode=args.fine_mode,
                            white_background=args.white_background),
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
        ),
        data=DataConfig(dataset=args.dataset),
        use_fused_kernel=args.use_fused_kernel,
        use_whole_ray_train=args.use_whole_ray_train,
    )


def _load_params(cfg: Config, device):
    """The field (and the fine field of a two-field hierarchical run)
    with the weights of --load_path, else of the newest checkpoint in
    --save_dir (weights only: inference does not depend on the
    optimizer). Returns (params, fine params or None, path or None)."""
    from .train import checkpoint as ckpt
    from .train.step import init_state

    state = init_state(cfg, device)
    load_path = cfg.load_path or ckpt.latest_checkpoint(cfg.save_dir)
    if load_path:
        step = ckpt.restore_weights(load_path, state.params, state.fine_params)
        print(f"loaded {load_path} (step {step})")
    return state.params, state.fine_params, load_path


def cmd_train(args) -> int:
    from .data.factory import make_dataset
    from .train.loop import train

    cfg = config_from_args(args)
    state = train(cfg, dataset=make_dataset(cfg, resolve_device(args.device)))
    print(f"done at step {state.step}")
    return 0


def cmd_eval(args) -> int:
    """Per-view and mean PSNR and SSIM over a split, rendered with the
    deterministic sampler."""
    from .data.factory import make_dataset
    from .data.images import save_png
    from .ops import render as render_ops
    from .ops.metrics import ssim as ssim_fn
    from .render import make_render, render_frame

    if args.scales not in ("", "1"):
        raise NotImplementedError("multiscale eval (--scales) comes with slice 3 of the port "
                                  "(multiscale)")
    cfg = config_from_args(args)
    device = resolve_device(args.device)
    dataset = make_dataset(cfg, device)
    params, fine_params, load_path = _load_params(cfg, device)
    if not load_path:
        print("error: no checkpoint found (use --load_path or --save_dir)")
        return 1
    render_fn = make_render(cfg)
    n = dataset.num_views if args.max_views <= 0 else min(args.max_views, dataset.num_views)
    if args.out_dir:
        os.makedirs(args.out_dir, exist_ok=True)
    psnrs, ssims = [], []
    t0 = time.time()
    for v in range(n):
        rgb, _, _ = render_frame(cfg, params, *dataset.view_rays(v), render_fn,
                                 fine_params=fine_params)
        gold = dataset.view_gold(v)
        p = float(render_ops.psnr(rgb, gold))
        s = float(ssim_fn(rgb, gold))
        psnrs.append(p)
        ssims.append(s)
        print(f"view {v:3d}: psnr {p:.2f}  ssim {s:.4f}")
        if args.out_dir:
            save_png(os.path.join(args.out_dir, f"eval-{v:03d}.png"), rgb)
    print(f"mean psnr over {n} {args.split} views: {np.mean(psnrs):.2f} "
          f"(min {np.min(psnrs):.2f}, max {np.max(psnrs):.2f}), "
          f"mean ssim {np.mean(ssims):.4f} in {time.time()-t0:.1f}s")
    return 0


def cmd_render(args) -> int:
    from .data.factory import make_dataset
    from .data.images import save_png
    from .ops import rays as rays_ops, render as render_ops
    from .render import make_render, render_frame

    cfg = config_from_args(args)
    device = resolve_device(args.device)
    dataset = make_dataset(cfg, device)
    params, fine_params, load_path = _load_params(cfg, device)
    if not load_path:
        print("warning: no checkpoint found; rendering an untrained field")
    render_fn = make_render(cfg)

    os.makedirs(args.out_dir, exist_ok=True)
    t0 = time.time()
    if args.view >= 0:
        o, d = dataset.view_rays(args.view)
        rgb, _, _ = render_frame(cfg, params, o, d, render_fn, fine_params=fine_params)
        psnr = float(render_ops.psnr(rgb, dataset.view_gold(args.view)))
        path = os.path.join(args.out_dir, f"view-{args.view}.png")
        save_png(path, rgb)
        print(f"{path}  psnr={psnr:.2f}  ({time.time()-t0:.2f}s)")
        return 0

    # the whole sweep's rays go through one render call
    angles = rays_ops.spherical_render_path(args.frames, args.pitch, device)
    poses = rays_ops.pose_from_yaw_pitch(angles[:, 0], angles[:, 1])
    h, w = cfg.camera.height, cfg.camera.width
    grids = [rays_ops.ray_grid(poses[i], cfg.camera) for i in range(args.frames)]
    big_o = torch.cat([o.reshape(-1, 3) for o, _ in grids]).reshape(args.frames * h, w, 3)
    big_d = torch.cat([d.reshape(-1, 3) for _, d in grids]).reshape(args.frames * h, w, 3)
    rgb, _, _ = render_frame(cfg, params, big_o, big_d, render_fn, fine_params=fine_params)
    rgb = rgb.reshape(args.frames, h, w, 3).cpu()
    for i in range(args.frames):
        save_png(os.path.join(args.out_dir, f"frame-{i:03d}.png"), rgb[i])
    dt = time.time() - t0
    print(f"rendered {args.frames} frames of {w}x{h} "
          f"in {dt:.2f}s ({dt/args.frames:.3f}s/frame)")
    return 0


def _later(flag: str) -> str:
    n = _FLAG_SLICE.get(flag.lstrip("-").split("=")[0])
    return f"{flag} (slice {n})" if n else flag


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] in LATER:
        print(f"error: `{argv[0]}` is not ported yet (it comes with "
              f"{LATER[argv[0]]} of the port)", file=sys.stderr)
        return 2
    parser = build_parser()
    args, unknown = parser.parse_known_args(argv)
    if unknown:
        parser.error("not ported to the PyTorch package yet (later slices): "
                     + " ".join(_later(f) for f in unknown if f.startswith("-")))
    args._explicit = explicit_dests(argv)
    # the kernels' plain versions and any f32 matmul must stay full f32
    torch.backends.cuda.matmul.allow_tf32 = False
    cmd = {"train": cmd_train, "eval": cmd_eval, "render": cmd_render}[args.cmd]
    try:
        return cmd(args)
    except NotImplementedError as e:
        print(f"error: not ported yet: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
