"""Smoke test of the PyTorch port on one CUDA card (an H100).

    python3 chip_smoke.py

Phases, each fatal (any failure exits non-zero):
  1. device: a CUDA card must be present; prints nvidia-smi's name and
     power limit. Without a card the script exits 1 and prints no result.
  2. build: compiles the whole-ray render kernel (K1) and train kernel
     (K2) from nerf_rs_tpu_torch/kernels/csrc/ with nvcc for sm_90a, both
     at once; prints build seconds and ptxas' register and spill lines.
  3. K1 vs its plain PyTorch version at the flagship width (8x256 trunk,
     skip 4, F 256, V 128, PE 10/4, S 64) on 4,103 rays of two poses,
     with midpoint and jittered samples, relu and softplus sigma.
  4. K2 vs its plain version on the same rays with sphere gold and
     jittered samples (relu, relu on white, softplus on white), and vs
     the plain version's float64 witness (the same bf16 rounding points,
     float64 sums); vs autograd of the eager path; two launches
     bit-identical.
  5. the render path through the CLI: `render --dataset sphere` of an
     800x800 view from a seed-0 checkpoint, counting K1 launches (one
     per 262,144-ray chunk), then a 4-frame 128x128 sweep.
  6. the training path through the CLI: `train --preset full --dataset
     sphere` for 201 steps (K2 once per step, K1 for the two evals), then
     a resume to 211 (exactly 10 more K2 launches).
  7. learning: the 64x64 verify drive through K2 must reach eval PSNR
     above 20 at iteration 300; then `cli eval` and `cli render` on its
     checkpoint.
  8. times: the 800x800 frame and one 262,144-ray chunk through K1 and
     the plain version; the flagship train step (4096 rays x 64) through
     K2, through autograd and through the plain version, K2a and K2b
     alone, and a profile of the K2 step.
The line before the last is one JSON object describing the kernels; the
last is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import zlib
from concurrent.futures import ThreadPoolExecutor

# kernel vs plain version on the same card, same inputs. Both multiply
# bf16 operands into f32 sums; they differ only in summation order,
# which can flip the bf16 rounding of a hidden activation (one bf16 ulp
# is 0.4%); sigma, unsquashed, shows such a flip most. Tightened from
# the JAX package's kernel-vs-XLA bars (3e-3, depth 5e-3, sigma 2e-2 in
# tests/test_fused_ray.py) to ~5x the largest diffs seen on an H100.
TOL = {"rgb": 1e-3, "acc": 1e-3, "depth": 2e-3, "weights": 1e-3, "sigma": 2e-2}
# K2 vs its plain version and vs the float64 witness: kernels/fused_train.py
# KERNEL_TOL, shared with tests/test_torch_cuda.py. K2 vs autograd keeps the
# JAX package's kernel-vs-autodiff bars (tests/test_fused_train.py):
# autograd rounds to bf16 at other points.
AUTOGRAD_TOL = {"rgb": 2e-2, "loss": 2e-3, "grads": 4e-2}
VERIFY_PSNR = 20.0  # eval PSNR the 64x64 learning check must pass at iteration 300
N_RAYS = 4103  # ragged: not a multiple of the kernel's 2-ray tile
FRAME = 800
PLAIN_CHUNK = 32768  # rays per call of the plain version (device memory)
KERNELS = ("fused_ray", "fused_train")  # csrc/{name}.cu


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def read_png(path: str):
    """(H, W, C) uint8 of a PNG written by data/images.save_png (8-bit,
    filter type 0 on every scanline)."""
    import numpy as np

    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        fail(f"{path} is not a PNG")
    pos, idat, w, h, c = 8, b"", 0, 0, 0
    while pos < len(data):
        n = int.from_bytes(data[pos:pos + 4], "big")
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            w, h = int.from_bytes(body[:4], "big"), int.from_bytes(body[4:8], "big")
            c = {2: 3, 6: 4}[body[9]]
        elif kind == b"IDAT":
            idat += body
        pos += 12 + n
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + w * c)
    return raw[:, 1:].reshape(h, w, c)


def best_of(fn, windows: int = 3) -> float:
    """Best wall time of ``windows`` calls, each fenced by synchronize."""
    import torch

    times = []
    for _ in range(windows):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return min(times)


def event_ms(fn, reps: int = 3) -> float:
    """Best device time of ``fn`` in ms over ``reps`` CUDA-event windows."""
    import torch

    best = math.inf
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end))
    return best


def run_cli(argv) -> tuple:
    """(rc, stdout) of one port CLI call; the output is printed too."""
    from nerf_rs_tpu_torch import cli

    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        rc = cli.main(argv)
    print(log.getvalue().rstrip())
    return rc, log.getvalue()


def leaf_err(got, want) -> float:
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1e-12)


def check_train_kernel(model, mcfg, rays, ts, gold, far) -> float:
    """K2 against its plain version, the float64 witness and autograd of
    the eager path, at the flagship width; two launches bit-identical.
    Returns the largest absolute difference from the plain version."""
    import dataclasses

    import torch

    from nerf_rs_tpu_torch.kernels.fused_render import pack_weights, pack_weights_t
    from nerf_rs_tpu_torch.kernels.fused_train import (
        KERNEL_TOL, fused_train_grads, fused_train_grads_reference, unpack_grads)
    from nerf_rs_tpu_torch.models.mlp import apply_nerf
    from nerf_rs_tpu_torch.ops import render as render_ops, sampling

    o, d, vd = rays
    S = ts.shape[1]
    deltas = sampling.deltas_from_ts(ts, far)
    max_err = 0.0
    for case, act, white in (("relu", "relu", False), ("relu, white bg", "relu", True),
                             ("softplus, white bg", "softplus", True)):
        cfg = dataclasses.replace(mcfg, sigma_activation=act)
        pk = pack_weights(model, cfg)
        args = (pk, pack_weights_t(pk), o, d, vd, ts, deltas, gold, cfg, S)
        got = fused_train_grads(*args, white_bg=white)
        torch.cuda.synchronize()
        want = fused_train_grads_reference(*args, white_bg=white)
        witness = fused_train_grads_reference(*args, white_bg=white, dtype=torch.float64)
        outs = (got.diag, got.weights, *got.dw, *got.db)
        if not all(bool(torch.isfinite(t).all()) for t in outs):
            fail(f"K2 [{case}]: non-finite outputs")
        max_err = max(max_err, *(float((g - w).abs().max()) for g, w in zip(
            outs, (want.diag, want.weights, *want.dw, *want.db))))
        for name, a, b in (("K2 vs plain", got, want), ("K2 vs f64 witness", got, witness),
                           ("plain vs f64 witness", want, witness)):
            errs = {
                "diag": float((a.diag[:, :5].double() - b.diag[:, :5]).abs().max()),
                "weights": float((a.weights.double() - b.weights).abs().max()),
                "grads": max(leaf_err(g.double(), w) for g, w in zip(a.dw + a.db, b.dw + b.db)),
            }
            print(f"{name} [{case}] max |diff|: "
                  + ", ".join(f"{k} {v:.3g} (tol {KERNEL_TOL[k]:g})" for k, v in errs.items()))
            bad = [k for k, v in errs.items() if not v <= KERNEL_TOL[k]]
            if bad:
                fail(f"{name} [{case}] disagree on {bad}")

        model.zero_grad(set_to_none=True)
        sigma, rgb = apply_nerf(model, sampling.points_from_ts(o, d, ts), vd[:, None, :],
                                cfg, torch.bfloat16)
        out = render_ops.composite(sigma, rgb, deltas, white_background=white)
        loss = render_ops.mse(out.rgb, gold)
        loss.backward()
        params = dict(model.named_parameters())
        errs = {
            "rgb": float((got.diag[:, :3] - out.rgb.detach()).abs().max()),
            "loss": abs(float(got.diag[:, 4].mean()) - float(loss.detach())),
            "grads": max(leaf_err(g, params[k].grad)
                         for k, g in unpack_grads(got, model, cfg).items()),
        }
        print(f"K2 vs autograd [{case}] max |diff|: "
              + ", ".join(f"{k} {v:.3g} (tol {AUTOGRAD_TOL[k]:g})" for k, v in errs.items()))
        bad = [k for k, v in errs.items() if not v <= AUTOGRAD_TOL[k]]
        if bad:
            fail(f"K2 [{case}] disagrees with autograd on {bad}")
    model.zero_grad(set_to_none=True)
    again = fused_train_grads(*args, white_bg=white)
    if not all(torch.equal(a, b) for a, b in zip(outs, (again.diag, again.weights,
                                                        *again.dw, *again.db))):
        fail("two K2 launches on the same inputs gave different bits")
    print("K2: two launches on the same inputs give bit-identical outputs")
    return max_err


def drive_training(tmp: str) -> int:
    """`cli train --preset full` for 201 steps, then a resume to 211;
    returns K2's launches on the first run."""
    from nerf_rs_tpu_torch.kernels.fused_ray import fused_ray_render
    from nerf_rs_tpu_torch.kernels.fused_train import fused_train_grads
    from nerf_rs_tpu_torch.train import checkpoint as ckpt

    ckdir = os.path.join(tmp, "train")
    argv = ["train", "--preset", "full", "--dataset", "sphere", "--num_iter", "201",
            "--eval_steps", "100", "--save_steps", "1000", "--save_dir", ckdir,
            "--log_dir", ckdir]
    fused_train_grads.launches = 0
    fused_ray_render.launches = 0
    t0 = time.perf_counter()
    rc, out = run_cli(argv)
    k2, k1 = fused_train_grads.launches, fused_ray_render.launches
    print(f"cli train --preset full, 201 steps: rc {rc}, K2 launches {k2}, K1 launches {k1}, "
          f"{time.perf_counter() - t0:.1f} s")
    losses = [float(v) for v in re.findall(r"iter=\d+, loss=(\S+)", out)]
    evals = [float(v) for v in re.findall(r"eval psnr=(\S+)", out)]
    if rc != 0 or k2 != 201 or k1 != 2:
        fail(f"train: rc {rc}, K2 launches {k2} (want 201), K1 launches {k1} (want 2)")
    if len(losses) != 4 or not all(map(math.isfinite, losses + evals)) or len(evals) != 2:
        fail(f"train: losses {losses}, eval psnrs {evals}")
    if not str(ckpt.latest_checkpoint(ckdir)).endswith("-201.pt"):
        fail(f"train wrote no step-201 checkpoint in {os.listdir(ckdir)}")

    fused_train_grads.launches = 0
    rc, out = run_cli([a if a != "201" else "211" for a in argv])
    if rc != 0 or "at step 201" not in out or fused_train_grads.launches != 10:
        fail(f"resume: rc {rc}, K2 launches {fused_train_grads.launches} (want 10)")
    print(f"resume to 211: K2 launches {fused_train_grads.launches}")
    return k2


def verify_drive(tmp: str) -> None:
    """The 64x64 learning check (the JAX package's verify drive) on the
    port, then eval and render on its checkpoint."""
    from nerf_rs_tpu_torch.kernels.fused_ray import fused_ray_render

    vdir = os.path.join(tmp, "verify")
    common = ["--dataset", "sphere", "--width", "64", "--height", "64", "--num_samples", "32",
              "--save_dir", vdir]
    rc, out = run_cli(["train", *common, "--num_rays", "1024", "--num_iter", "301",
                       "--eval_steps", "100", "--learning_rate", "1e-3",
                       "--use_whole_ray_train", "true", "--log_dir", vdir])
    psnr = dict(re.findall(r"iter=(\d+), eval psnr=(\S+)", out))
    if rc != 0 or "300" not in psnr or not float(psnr["300"]) > VERIFY_PSNR:
        fail(f"verify drive: rc {rc}, eval psnr {psnr} (need > {VERIFY_PSNR} at 300)")
    print(f"verify drive: eval psnr at 100/200/300 = {psnr}")
    for argv, launches in ((["eval", *common, "--max_views", "3"], 3),
                           (["render", *common, "--view", "0",
                             "--out_dir", os.path.join(tmp, "vrender")], 1)):
        fused_ray_render.launches = 0
        rc, out = run_cli(argv)
        if rc != 0 or fused_ray_render.launches != launches or "psnr" not in out:
            fail(f"{argv[0]} on the trained checkpoint: rc {rc}, "
                 f"K1 launches {fused_ray_render.launches} (want {launches})")


@contextlib.contextmanager
def plain_train_route():
    """Route the train step's kernel call to the plain version, for the
    timing comparison only."""
    from nerf_rs_tpu_torch.kernels import fused_train

    real = fused_train.fused_train_grads
    fused_train.fused_train_grads = fused_train.fused_train_grads_reference
    try:
        yield
    finally:
        fused_train.fused_train_grads = real


def device_ms(prof) -> dict:
    """Device time in ms by kernel name from a torch.profiler run."""
    out = {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = e.self_cuda_time_total
        if t > 0:
            out[e.key] = out.get(e.key, 0.0) + t / 1000.0
    return out


def time_training(card: str) -> dict:
    """The flagship step (4096 rays x 64 samples) through K2, autograd
    and the plain version; K2a and K2b alone; a profile of the K2 step."""
    import dataclasses

    import torch

    from nerf_rs_tpu_torch import cli
    from nerf_rs_tpu_torch.data.factory import make_dataset
    from nerf_rs_tpu_torch.kernels.fused_render import pack_weights, pack_weights_t
    from nerf_rs_tpu_torch.kernels.fused_train import (
        fused_train_grads, fused_train_grads_reference)
    from nerf_rs_tpu_torch.ops import sampling
    from nerf_rs_tpu_torch.train.step import init_state, make_train_step, step_generator

    dev = torch.device("cuda")
    argv = ["train", "--preset", "full", "--dataset", "sphere"]
    args = cli.build_parser().parse_args(argv)
    args._explicit = cli.explicit_dests(argv)
    cfg = cli.config_from_args(args)
    ds = make_dataset(cfg, dev)
    samples = cfg.train.num_rays * cfg.render.num_samples

    def stepper(c):
        state = init_state(c, dev)
        fn = make_train_step(c, ds)
        it = [0]

        def run(n):
            nonlocal state
            for _ in range(n):
                state, _ = fn(state, step_generator(0, it[0], dev))
                it[0] += 1
        return run

    times = {}
    for name, c, window in (("K2", cfg, 20),
                            ("autograd", dataclasses.replace(cfg, use_whole_ray_train=False), 20)):
        run = stepper(c)
        run(3)
        times[name] = best_of(lambda: run(window)) / window
    with plain_train_route():
        run = stepper(cfg)
        run(1)
        times["plain"] = best_of(lambda: run(2)) / 2
    for name, t in times.items():
        print(f"flagship train step through {name} [{card}]: {t * 1e3:.3f} ms/step, "
              f"{samples / t:.4g} ray-samples/s (best of 3 windows)")

    # one K2 call at the step's shape, alone, and its plain version
    batch = ds.sample_batch(step_generator(0, 0, dev), cfg.train.num_rays)
    ts = sampling.stratified_ts(batch.origins.shape[0], cfg.render.num_samples,
                                cfg.camera.near, cfg.camera.far, True,
                                generator=step_generator(1, 0, dev), device=dev)
    model = init_state(cfg, dev).params
    pk = pack_weights(model, cfg.model)
    vd = batch.dirs / torch.linalg.norm(batch.dirs, dim=-1, keepdim=True)
    k2_args = (pk, pack_weights_t(pk), batch.origins.contiguous(), batch.dirs.contiguous(),
               vd.contiguous(), ts, sampling.deltas_from_ts(ts, cfg.camera.far),
               batch.gold.contiguous(), cfg.model, cfg.render.num_samples)
    fused_train_grads(*k2_args)
    k2_ms = event_ms(lambda: fused_train_grads(*k2_args))
    plain_ms = event_ms(lambda: fused_train_grads_reference(*k2_args))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            fused_train_grads(*k2_args)
        torch.cuda.synchronize()
    per = {k: v / 5 for k, v in device_ms(prof).items()}
    k2a = sum(v for k, v in per.items() if "train_tile_kernel" in k)
    k2b = sum(v for k, v in per.items() if re.search(r"dw_partial|colsum|reduce_kernel|feat_bias", k))
    print(f"one K2 call, 4096 x 64 [{card}]: {k2_ms:.3f} ms (CUDA events), plain version "
          f"{plain_ms:.3f} ms; device time K2a {k2a:.3f} ms, K2b {k2b:.3f} ms "
          + "(" + ", ".join(f"{k.split('(')[0].split('::')[-1]} {v:.3f}" for k, v in
                          sorted(per.items(), key=lambda kv: -kv[1])) + ")")

    # where a K2 step's time goes: device time by kernel over 10 steps
    run = stepper(cfg)
    run(3)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(10)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / 10
    per = sorted(((v / 10, k) for k, v in device_ms(prof).items()), reverse=True)
    busy = sum(v for v, _ in per)
    print(f"K2 step profile [{card}]: wall {wall:.3f} ms/step (profiled), device busy "
          f"{busy:.3f} ms/step, idle {100 * (1 - busy / wall):.1f}%")
    for v, k in per[:12]:
        print(f"  {v:8.3f} ms/step  {k[:100]}")
    return {"k2_ms": k2_ms, "plain_ms": plain_ms}


def main() -> int:
    import torch

    # ---- 1. device ----
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke test runs on the card only")
    card = card_line()
    print(card)
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False  # plain version: full f32
    torch.backends.cudnn.allow_tf32 = False

    from nerf_rs_tpu_torch import CameraConfig, ModelConfig
    from nerf_rs_tpu_torch import cli
    from nerf_rs_tpu_torch.data import synthetic
    from nerf_rs_tpu_torch.data.factory import make_dataset
    from nerf_rs_tpu_torch.kernels import build
    from nerf_rs_tpu_torch.kernels.fused_ray import (
        fused_ray_render, fused_ray_render_reference)
    from nerf_rs_tpu_torch.kernels.fused_render import pack_weights
    from nerf_rs_tpu_torch.models.mlp import init_nerf_params
    from nerf_rs_tpu_torch.ops import rays as rays_ops, sampling
    from nerf_rs_tpu_torch.render import make_render, render_frame
    from nerf_rs_tpu_torch.train import checkpoint as ckpt

    # ---- 2. build: one nvcc per kernel source, all started together ----
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        libs = dict(zip(KERNELS, pool.map(build.build, KERNELS)))
    print(f"build: {time.perf_counter() - t0:.1f} s for {', '.join(KERNELS)}")
    for name, lib in libs.items():
        print(f"  {name} -> {lib.name}")
        for line in lib.with_suffix(".log").read_text().splitlines():
            if re.search(r"registers|spill", line):
                print(f"ptxas [{name}]:", line.strip())

    # ---- 3. kernel vs plain version ----
    mcfg = ModelConfig()  # flagship: 8x256, skip 4, F 256, V 128, PE 10/4
    model = init_nerf_params(mcfg, 0, dev)
    packed = pack_weights(model, mcfg)
    cam = CameraConfig(width=64, height=64)
    poses = rays_ops.pose_from_yaw_pitch(
        torch.tensor([0.37, 2.1]), torch.tensor([0.21, 0.9]), device=dev)
    grids = [rays_ops.ray_grid(poses[i], cam) for i in range(2)]
    o = torch.cat([g[0].reshape(-1, 3) for g in grids])[:N_RAYS].contiguous()
    d = torch.cat([g[1].reshape(-1, 3) for g in grids])[:N_RAYS].contiguous()
    vd = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    S = 64
    ts_mid = sampling.stratified_ts(N_RAYS, S, cam.near, cam.far, False, device=dev)
    ts_jit = sampling.stratified_ts(
        N_RAYS, S, cam.near, cam.far, True,
        generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    softplus = ModelConfig(sigma_activation="softplus")
    max_err = 0.0
    for case, cfg_case, ts in (("relu midpoints", mcfg, ts_mid),
                               ("relu jittered", mcfg, ts_jit),
                               ("softplus jittered", softplus, ts_jit)):
        deltas = sampling.deltas_from_ts(ts, cam.far)
        args = (packed, o, d, vd, ts, deltas, cfg_case, S)
        got = fused_ray_render(*args)
        torch.cuda.synchronize()
        want = fused_ray_render_reference(*args)
        errs = {}
        for name, a, b in zip(TOL, got, want):
            if not torch.isfinite(a).all():
                fail(f"{case}: kernel {name} has non-finite values")
            errs[name] = float((a - b).abs().max())
        print(f"kernel vs plain [{case}] max |diff|: "
              + ", ".join(f"{k} {v:.3g} (tol {TOL[k]:g})" for k, v in errs.items()))
        bad = [k for k, v in errs.items() if not v <= TOL[k]]
        if bad:
            fail(f"{case}: kernel disagrees with its plain version on {bad}")
        max_err = max(max_err, *errs.values())

    # ---- 4. K2 vs its plain version and vs autograd ----
    gold = synthetic.sphere_image(cam, device=dev)[..., :3].reshape(-1, 3)
    gold = torch.cat([gold, gold])[:N_RAYS].contiguous()
    train_err = check_train_kernel(model, mcfg, (o, d, vd), ts_jit, gold, cam.far)

    # ---- 5. the render path through the CLI ----
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        path = ckpt.save(model, os.path.join(tmp, "ckpt"), step=0)
        out_dir = os.path.join(tmp, "renders")
        log = io.StringIO()
        fused_ray_render.launches = 0
        with contextlib.redirect_stdout(log):
            rc = cli.main(["render", "--dataset", "sphere", "--width", str(FRAME),
                           "--height", str(FRAME), "--view", "0",
                           "--load_path", path, "--out_dir", out_dir])
        launches = fused_ray_render.launches
        print(log.getvalue().rstrip())
        chunks = math.ceil(FRAME * FRAME / 262144)
        print(f"cli render --view 0 at {FRAME}x{FRAME}: rc {rc}, "
              f"kernel launches {launches} (chunks {chunks})")
        if rc != 0:
            fail(f"cli render returned {rc}")
        if launches != chunks:
            fail(f"expected {chunks} kernel launches on the render path, saw {launches}")
        m = re.search(r"psnr=(\S+)", log.getvalue())
        if m is None or not math.isfinite(float(m.group(1))):
            fail("cli render printed no finite psnr")
        png = read_png(os.path.join(out_dir, "view-0.png"))
        if png.shape != (FRAME, FRAME, 3):
            fail(f"view-0.png has shape {png.shape}")

        # the same frame again, outside the counted run, to inspect values
        cfg = cli.config_from_args(cli.build_parser().parse_args(
            ["render", "--dataset", "sphere", "--width", str(FRAME),
             "--height", str(FRAME)]))
        dataset = make_dataset(cfg, dev)
        fo, fd = dataset.view_rays(0)
        rgb, depth, acc = render_frame(cfg, model, fo, fd)
        if not (torch.isfinite(rgb).all() and torch.isfinite(depth).all()):
            fail("800x800 frame has non-finite values")
        if not (rgb.min() >= 0.0 and rgb.max() <= 1.0 + 1e-6):
            fail(f"frame outside [0, 1]: {float(rgb.min())} .. {float(rgb.max())}")
        want_png = (rgb.clamp(0, 1) * 255.0).to(torch.uint8).cpu().numpy()
        png_diff = int(abs(png.astype(int) - want_png.astype(int)).max())
        if png_diff > 1:
            fail(f"view-0.png differs from the rendered frame by {png_diff} levels")
        print(f"frame: rgb in [{float(rgb.min()):.4f}, {float(rgb.max()):.4f}], "
              f"mean acc {float(acc.mean()):.4f}, png vs frame {png_diff} levels")

        sweep_dir = os.path.join(tmp, "sweep")
        log = io.StringIO()
        fused_ray_render.launches = 0
        with contextlib.redirect_stdout(log):
            rc = cli.main(["render", "--dataset", "sphere", "--width", "128",
                           "--height", "128", "--frames", "4",
                           "--load_path", path, "--out_dir", sweep_dir])
        print(log.getvalue().rstrip())
        frames = sorted(os.listdir(sweep_dir))
        if rc != 0 or len(frames) != 4 or fused_ray_render.launches != 1:
            fail(f"sweep: rc {rc}, frames {frames}, "
                 f"launches {fused_ray_render.launches}")

        # ---- 6. the training path through the CLI ----
        train_launches = drive_training(tmp)

        # ---- 7. learning: the verify drive, then eval and render ----
        verify_drive(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # ---- 8. times ----
    flat_o, flat_d = fo.reshape(-1, 3), fd.reshape(-1, 3)
    render_fn = make_render(cfg)

    def kernel_frame():
        return render_fn(model, flat_o, flat_d)

    def plain_frame():
        pk = pack_weights(model, mcfg)
        outs = []
        for i in range(0, flat_o.shape[0], PLAIN_CHUNK):
            co, cd = flat_o[i:i + PLAIN_CHUNK], flat_d[i:i + PLAIN_CHUNK]
            ts = sampling.stratified_ts(co.shape[0], S, cfg.camera.near,
                                        cfg.camera.far, False, device=dev)
            dl = sampling.deltas_from_ts(ts, cfg.camera.far)
            cvd = cd / torch.linalg.norm(cd, dim=-1, keepdim=True)
            outs.append(fused_ray_render_reference(
                pk, co, cd, cvd, ts, dl, mcfg, S)[0])
        return torch.cat(outs)

    k_rgb = kernel_frame()[0]
    p_rgb = plain_frame()
    frame_err = float((k_rgb - p_rgb).abs().max())
    if not frame_err <= TOL["rgb"]:
        fail(f"800x800 frame: kernel path vs plain version differ by {frame_err}")
    t_kernel = best_of(kernel_frame)
    t_plain = best_of(plain_frame)
    print(f"800x800 frame, S=64, 8x256 mixed [{card}]: kernel {t_kernel:.4f} s, "
          f"plain {t_plain:.4f} s (best of 3; kernel vs plain rgb {frame_err:.3g})")

    # one main-path chunk (262,144 rays) alone: kernel vs plain version
    n = 262144
    co, cd = flat_o[:n].contiguous(), flat_d[:n].contiguous()
    cvd = cd / torch.linalg.norm(cd, dim=-1, keepdim=True)
    ts = sampling.stratified_ts(n, S, cfg.camera.near, cfg.camera.far, False, device=dev)
    dl = sampling.deltas_from_ts(ts, cfg.camera.far)

    def kernel_chunk():
        fused_ray_render(packed, co, cd, cvd, ts, dl, mcfg, S)

    def plain_chunk():
        for i in range(0, n, PLAIN_CHUNK):
            j = slice(i, i + PLAIN_CHUNK)
            fused_ray_render_reference(packed, co[j], cd[j], cvd[j], ts[j], dl[j], mcfg, S)

    kernel_chunk()
    ms = event_ms(kernel_chunk)
    plain_ms = event_ms(plain_chunk)
    # every packed matrix multiplies each sample row once
    flops_row = 2 * sum(k * c for k, c in packed.w_shape)
    tflops = flops_row * n * S / (ms * 1e-3) / 1e12
    print(f"one {n}-ray chunk [{card}]: kernel {ms:.3f} ms "
          f"(~{tflops:.1f} TFLOP/s bf16), plain {plain_ms:.3f} ms")

    train_times = time_training(card)

    if "jax" in sys.modules:
        fail("jax was imported")
    print(json.dumps({"kernels": [{
        "name": "fused_ray_render",
        "route": "cuda",
        "source": "nerf_rs_tpu_torch/kernels/csrc/fused_ray.cu",
        "replaces": "nerf_rs_tpu/kernels/fused_ray.py:45",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
    }, {
        "name": "fused_train_grads",
        "route": "cuda",
        "source": "nerf_rs_tpu_torch/kernels/csrc/fused_train.cu",
        "replaces": "nerf_rs_tpu/kernels/fused_train.py:93",
        "launches": train_launches,
        "max_abs_err": train_err,
        "ms": train_times["k2_ms"],
        "plain_ms": train_times["plain_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
