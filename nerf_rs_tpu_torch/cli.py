"""CLI of the port: the ``render`` subcommand, the counterpart of
``cmd_render`` in ``nerf_rs_tpu/cli.py``.

  python -m nerf_rs_tpu_torch.cli render --dataset sphere --view 0
  python -m nerf_rs_tpu_torch.cli render --dataset sphere --frames 40

It takes the JAX parser's flags that the ported slice serves. Flags of
slices not ported yet, and the ``train``/``eval``/``export``
subcommands, are refused with an error rather than ignored. Renders run
on the CUDA device when there is one (through the whole-ray kernel),
else on the CPU.
"""

from __future__ import annotations

import argparse
import math
import os
import sys
import time

import torch

from nerf_rs_tpu.config import (
    CameraConfig,
    Config,
    DataConfig,
    ModelConfig,
    RenderConfig,
    TrainConfig,
)

LATER = {"train": "the training slice", "eval": "the training slice",
         "export": "slice 7"}


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
    pr = sub.add_parser("render")
    pr.add_argument("--dataset", default="multiview_png",
                    choices=["multiview_png", "blender", "llff", "sphere",
                             "flat_sphere"])
    pr.add_argument("--width", type=int, default=128)
    pr.add_argument("--height", type=int, default=128)
    pr.add_argument("--near", type=float, default=0.05)
    pr.add_argument("--far", type=float, default=2.0)
    pr.add_argument("--num_samples", type=int, default=64)
    pr.add_argument("--precision", default="mixed", choices=["f32", "bf16", "mixed"],
                    help="matmul precision of the eager field path; the "
                         "kernel always multiplies in bf16")
    _bool_flag(pr, "white_background", False)
    _bool_flag(pr, "use_fused_kernel", True,
               "render through the whole-ray CUDA kernel")
    pr.add_argument("--load_path", default="")
    pr.add_argument("--save_dir", default="checkpoints")
    pr.add_argument("--out_dir", default="renders")
    pr.add_argument("--view", type=int, default=-1,
                    help="render one dataset view instead of a sweep")
    pr.add_argument("--frames", type=int, default=40, help="spherical sweep length")
    pr.add_argument("--pitch", type=float, default=math.pi / 6)
    return p


def config_from_args(args) -> Config:
    return Config(
        load_path=args.load_path,
        save_dir=args.save_dir,
        camera=CameraConfig(width=args.width, height=args.height,
                            near=args.near, far=args.far),
        model=ModelConfig(),
        render=RenderConfig(num_samples=args.num_samples,
                            white_background=args.white_background),
        train=TrainConfig(precision=args.precision),
        data=DataConfig(dataset=args.dataset),
        use_fused_kernel=args.use_fused_kernel,
    )


def cmd_render(args) -> int:
    from .data.factory import make_dataset
    from .data.images import save_png
    from .models.mlp import init_nerf_params
    from .ops import rays as rays_ops, render as render_ops
    from .render import make_render, render_frame
    from .train import checkpoint as ckpt

    cfg = config_from_args(args)
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    dataset = make_dataset(cfg, device)
    params = init_nerf_params(
        cfg.model, torch.Generator().manual_seed(cfg.train.seed), device)
    load_path = cfg.load_path or ckpt.latest_checkpoint(cfg.save_dir)
    if load_path:
        step = ckpt.restore_weights(load_path, params)
        print(f"loaded {load_path} (step {step})")
    else:
        print("warning: no checkpoint found; rendering an untrained field")
    render_fn = make_render(cfg)

    os.makedirs(args.out_dir, exist_ok=True)
    t0 = time.time()
    if args.view >= 0:
        o, d = dataset.view_rays(args.view)
        rgb, _, _ = render_frame(cfg, params, o, d, render_fn)
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
    rgb, _, _ = render_frame(cfg, params, big_o, big_d, render_fn)
    rgb = rgb.reshape(args.frames, h, w, 3).cpu()
    for i in range(args.frames):
        save_png(os.path.join(args.out_dir, f"frame-{i:03d}.png"), rgb[i])
    dt = time.time() - t0
    print(f"rendered {args.frames} frames of {w}x{h} "
          f"in {dt:.2f}s ({dt/args.frames:.3f}s/frame)")
    return 0


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
                     + " ".join(unknown))
    # the kernel's plain reference and any f32 matmul must stay full f32
    torch.backends.cuda.matmul.allow_tf32 = False
    return cmd_render(args)


if __name__ == "__main__":
    sys.exit(main())
