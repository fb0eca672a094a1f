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
  9. the hierarchical branches of both kernels at the flagship width, vs
     their plain versions (K2 also vs the float64 witness) on the 4,103
     rays of phase 3: IPE (relu and softplus, jittered intervals, the
     camera's cone radius) and rays longer than one tile (S = 192, the
     hierarchical union pass, and 193); K2 bit-identical across launches
     at S = 192.
 10. the hierarchical path through the CLI, per preset (hierarchical:
     two fields, 64 + 128 union; mipnerf: IPE, one field, 64 + 128
     standalone): `train` for 51 steps at full width (exactly 2 K2
     launches per step, K1 for the eval), `render --view 0` at 800x800
     and `eval --max_views 2` on the checkpoint (2 K1 launches per chunk);
     then a 64x64 learning drive per preset and seed: the mean over
     LEARN_SEEDS of `cli eval`'s mean PSNR over LEARN_VIEWS views at
     iteration 301 must pass PRESET_PSNR.
 11. times: each preset's step through K2 and through autograd, its
     800x800 frame through K1 (checked against the plain version on a
     chunk of it), a profile of the hierarchical K2 step; the new
     branches' kernel calls at the presets' shapes (a whole K1 chunk,
     K2's 4096-ray calls), each held to its plain version and timed
     against it, a PyTorch library path and the bound.
 12. K3, the factored-encode kernel (forward and backward), vs its plain
     versions, bf16 and f32, on the points of sphere rays with 128
     jittered samples (every 8th pushed out past the AABB, so clipped):
     4096 rays (524,288 points, a train step's call) and 4,103 rays
     (ragged); two backward launches bit-identical.
 13. the factored path (FACTORED_CONFIG: the bench's factored window,
     128x128 sphere, 4096 rays x 128 samples, mixed, lr 1e-2, with
     fac_fused on): train/loop.train for FAC_STEPS steps (exactly one K3
     forward per step and per eval chunk, one backward per step), an
     800x800 render_frame (20 chunks, 20 forwards; its first chunk held to
     the plain route) and an eval of 2 views; `cli train/eval/render
     --preset factored`, whose route is the dense-hat encode (0 K3
     launches, as in the JAX CLI); the 64x64 learning drive through K3
     for LEARN_SEEDS, the mean over seeds of `cli eval`'s mean PSNR over
     LEARN_VIEWS views above FAC_PSNR.
 14. times: the factored step through K3 and through the CLI's route, a
     profile of the K3 step (device idle), K3's forward and backward at
     524,288 points and its forward at a 4,194,304-point render chunk,
     each beside its plain version, a PyTorch library path
     (F.embedding_bag over the 2L taps per axis, and its autograd) and
     its bound.
Every kernel launch counter is set to 0 just before the path it counts
and read just after. The line before the last is one JSON object
describing the kernels (with each one's bound and a PyTorch library
call's time at the flagship shape); the last is {"ok": true, "device":
{...}}.

    python3 chip_smoke.py --time-step ROOT

times the flagship path of the checkout at ROOT instead (the train step
through K2, autograd and the plain version, one K2 call and one K1
chunk), with the helpers above. To compare two commits, unpack the other
into a git-ignored directory (`git archive`) and run both in one call on
one card, in turns:

    for r in _scratch/parent . . _scratch/parent; do
        python3 chip_smoke.py --time-step $r; done
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
# A preset's frame through K1 vs through the plain version, on the same
# rays: the coarse pass at TOL; the fine pass samples where each route's
# own coarse weights put it, so a fine sample can move within its bin and
# the fine colors are held to a mean and a max of their own, ~3-4x the
# readings on an H100 (hierarchical: mean 3.0e-5, max 1.2e-2; mipnerf:
# 2.3e-5 and 1.5e-4).
FINE_TOL = {"mean": 1e-4, "max": 5e-2}
VERIFY_PSNR = 20.0  # eval PSNR the 64x64 learning check must pass at iteration 300
# The presets' 64x64 learning drives (--num_samples 32 --num_fine_samples
# 64, 1024 rays, lr 1e-3, 301 steps), one per seed: the mean over seeds of
# `cli eval`'s mean PSNR over the first LEARN_VIEWS views must pass
# min(20 dB, the JAX package's own drives with the same flags and seeds on
# the CPU, kernels off, less 1 dB). Those read 16.77 (hierarchical) and
# 23.21 dB (mipnerf); PERF.md has the commands and each seed's reading.
LEARN_SEEDS = (0, 1, 2)
LEARN_VIEWS = 4
PRESET_PSNR = {"hierarchical": 15.77, "mipnerf": 20.0}
PRESETS = ("hierarchical", "mipnerf")
PRESET_STEPS = 51
# ragged (not a multiple of the kernel's 2-ray tile), and more than the
# 4096 rays of a train step, so the branch checks cover its K2b splits
N_RAYS = 4103
FRAME = 800
CHUNK = 262144  # rays per K1 call of the flagship render path
PLAIN_CHUNK = 32768  # rays per call of the plain version (device memory)
# (kernel, case, ipe, rays, samples) of the new branches' calls on the
# presets' main paths: a K1 chunk of the mipnerf fine pass and of the
# hierarchical union pass; K2 per train step (the flagship's PE call too)
BRANCH_SHAPES = (("K1", "IPE, S=128", True, 131072, 128),
                 ("K1", "S=192", False, 65536, 192),
                 ("K2", "S=64", False, 4096, 64),
                 ("K2", "IPE, S=64", True, 4096, 64),
                 ("K2", "IPE, S=128", True, 4096, 128),
                 ("K2", "S=192", False, 4096, 192))
KERNELS = ("fused_ray", "fused_train", "fused_factored")  # csrc/{name}.cu
# the card's published dense bf16 rate, f32 rate outside the tensor cores,
# and memory rate (H100 SXM, 700 W)
PEAK_FLOPS = 989e12
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
# The factored path (phases 12-14). FAC_STEPS train steps with an eval at
# step 50; the 64x64 learning drive (--preset factored --num_samples 32,
# 1024 rays, lr 1e-2, 301 steps) through K3 must pass min(20 dB, the JAX
# package's own drives on the same flags and seeds on the CPU, less 1 dB):
# those read 19.14 / 19.36 / 19.50 dB, mean 19.33 (PERF.md has the commands).
FAC_STEPS = 51
FAC_PSNR = 18.33
FAC_RAYS = 4096  # rays of a train step: 524,288 points at 128 samples
FAC_CHUNK = 32768  # rays of a render chunk: 4,194,304 points
# the frame's first chunk through K3 vs the plain route: both encode in f32
# to within K3's KERNEL_TOL, and the bf16 heads could then round an
# activation the other way. Both read 0 on an H100 (the bf16 route's
# encodings came out bit-equal); the bars leave room for a few such flips.
FAC_FRAME_TOL = {"mean": 1e-5, "max": 5e-3}


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


def hold(label: str, errs: dict, tol: dict) -> None:
    """Print ``label``'s largest differences; fail past any bar."""
    print(f"{label} max |diff|: "
          + ", ".join(f"{k} {v:.3g} (tol {tol[k]:g})" for k, v in errs.items()))
    bad = [k for k, v in errs.items() if not v <= tol[k]]
    if bad:
        fail(f"{label} disagree on {bad}")


def k1_errs(label: str, got, want) -> dict:
    """K1's largest absolute difference per output (TOL's keys); fails on
    a wrong shape or a non-finite kernel value."""
    import torch

    errs = {}
    for key, a, b in zip(TOL, got, want):
        if a.shape != b.shape or not bool(torch.isfinite(a).all()):
            fail(f"{label}: {key} has shape {tuple(a.shape)} or non-finite values")
        errs[key] = float((a - b).abs().max())
    return errs


def k2_outs(tg) -> tuple:
    return (tg.diag, tg.weights, *tg.dw, *tg.db)


def k2_errs(label: str, got, want) -> dict:
    """K2 against a plain version (f32, or the float64 witness) at
    KERNEL_TOL's keys; fails on a non-finite kernel output."""
    import torch

    if not all(bool(torch.isfinite(t).all()) for t in k2_outs(got)):
        fail(f"{label}: non-finite outputs")
    return {
        "diag": float((got.diag[:, :5].double() - want.diag[:, :5]).abs().max()),
        "weights": float((got.weights.double() - want.weights).abs().max()),
        "grads": max(leaf_err(a.double(), b) for a, b in zip(got.dw + got.db,
                                                              want.dw + want.db)),
    }


def k2_abs(got, want) -> float:
    """The largest absolute difference over all of K2's outputs."""
    return max(float((a - b).abs().max()) for a, b in zip(k2_outs(got), k2_outs(want)))


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
        max_err = max(max_err, k2_abs(got, want))
        for name, a, b in (("K2 vs plain", got, want), ("K2 vs f64 witness", got, witness),
                           ("plain vs f64 witness", want, witness)):
            label = f"{name} [{case}]"
            hold(label, k2_errs(label, a, b), KERNEL_TOL)

        model.zero_grad(set_to_none=True)
        sigma, rgb = apply_nerf(model, sampling.points_from_ts(o, d, ts), vd[:, None, :],
                                cfg, torch.bfloat16)
        out = render_ops.composite(sigma, rgb, deltas, white_background=white)
        loss = render_ops.mse(out.rgb, gold)
        loss.backward()
        params = dict(model.named_parameters())
        hold(f"K2 vs autograd [{case}]", {
            "rgb": float((got.diag[:, :3] - out.rgb.detach()).abs().max()),
            "loss": abs(float(got.diag[:, 4].mean()) - float(loss.detach())),
            "grads": max(leaf_err(g, params[k].grad)
                         for k, g in unpack_grads(got, model, cfg).items()),
        }, AUTOGRAD_TOL)
    model.zero_grad(set_to_none=True)
    again = fused_train_grads(*args, white_bg=white)
    if not all(torch.equal(a, b) for a, b in zip(k2_outs(got), k2_outs(again))):
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


def sample_inputs(n, s, ipe, cam, gen):
    """Jittered samples of ``n`` rays: (ts, deltas, edges, radii). With
    ``ipe``, ts are the midpoints of s intervals between s + 1 edges,
    deltas their exact lengths, radii the camera's cone radius per ray;
    else ts are s stratified samples and edges and radii are None."""
    import torch

    from nerf_rs_tpu_torch.ops import sampling

    dev = gen.device
    if not ipe:
        ts = sampling.stratified_ts(n, s, cam.near, cam.far, True, generator=gen, device=dev)
        return ts, sampling.deltas_from_ts(ts, cam.far), None, None
    edges = sampling.stratified_ts(n, s + 1, cam.near, cam.far, True, generator=gen, device=dev)
    return ((0.5 * (edges[:, 1:] + edges[:, :-1])).contiguous(),
            (edges[:, 1:] - edges[:, :-1]).contiguous(), edges,
            torch.full((n,), sampling.pixel_radius(cam), device=dev))


def branch_inputs(cam, dev):
    """Inputs of the branch checks on the N_RAYS rays: (name, ipe, S, ts
    or interval midpoints, deltas, radii) for IPE at the mipnerf passes'
    64 and 128 intervals, and rays of 192 and 193 samples (the
    hierarchical union pass; the record preset's)."""
    gen = torch_generator(dev, 5)
    out = []
    for name, ipe, s in (("IPE relu, S=64", True, 64), ("IPE softplus, S=128", True, 128),
                         ("S=192 relu", False, 192), ("S=193 softplus", False, 193)):
        ts, dl, _, radii = sample_inputs(N_RAYS, s, ipe, cam, gen)
        out.append((name, ipe, s, ts, dl, radii))
    return out


def torch_generator(dev, seed):
    import torch

    return torch.Generator(device=dev).manual_seed(seed)


def branch_cfg(mcfg, name, ipe):
    import dataclasses

    return dataclasses.replace(mcfg, ipe=ipe,
                               sigma_activation="softplus" if "softplus" in name else "relu")


def check_render_branches(model, mcfg, rays, cam) -> float:
    """K1's IPE and long-ray branches against the plain version at the
    flagship width; returns the largest difference."""
    import torch

    from nerf_rs_tpu_torch.kernels.fused_ray import fused_ray_render, fused_ray_render_reference
    from nerf_rs_tpu_torch.kernels.fused_render import pack_weights

    max_err = 0.0
    for name, ipe, s, ts, dl, radii in branch_inputs(cam, rays[0].device):
        cfg = branch_cfg(mcfg, name, ipe)
        args = (pack_weights(model, cfg), *rays, ts, dl, cfg, s)
        got = fused_ray_render(*args, radii=radii)
        torch.cuda.synchronize()
        want = fused_ray_render_reference(*args, radii=radii)
        errs = k1_errs(f"K1 [{name}]", got, want)
        hold(f"K1 vs plain [{name}]", errs, TOL)
        max_err = max(max_err, *errs.values())
    return max_err


def check_train_branches(model, mcfg, rays, gold, cam) -> float:
    """K2's IPE and long-ray branches against the plain version and its
    float64 witness at the flagship width (white background); two
    launches at S = 192 bit-identical. Returns the largest difference
    from the plain version."""
    import torch

    from nerf_rs_tpu_torch.kernels.fused_render import pack_weights, pack_weights_t
    from nerf_rs_tpu_torch.kernels.fused_train import (
        KERNEL_TOL, fused_train_grads, fused_train_grads_reference)

    max_err = 0.0
    for name, ipe, s, ts, dl, radii in branch_inputs(cam, rays[0].device):
        cfg = branch_cfg(mcfg, name, ipe)
        pk = pack_weights(model, cfg)
        args = (pk, pack_weights_t(pk), *rays, ts, dl, gold, cfg, s)
        got = fused_train_grads(*args, white_bg=True, radii=radii)
        torch.cuda.synchronize()
        if got.weights.shape != (N_RAYS, s):
            fail(f"K2 [{name}]: weights of shape {tuple(got.weights.shape)}")
        for ref, dtype in (("plain", torch.float32), ("f64 witness", torch.float64)):
            want = fused_train_grads_reference(*args, white_bg=True, radii=radii, dtype=dtype)
            if dtype == torch.float32:
                max_err = max(max_err, k2_abs(got, want))
            label = f"K2 vs {ref} [{name}]"
            hold(label, k2_errs(label, got, want), KERNEL_TOL)
            del want
        if s == 192:
            again = fused_train_grads(*args, white_bg=True, radii=radii)
            if not all(torch.equal(a, b) for a, b in zip(k2_outs(got), k2_outs(again))):
                fail("two K2 launches at S=192 gave different bits")
            print("K2 at S=192: two launches on the same inputs give bit-identical outputs")
    return max_err


def preset_cfg(preset, *extra):
    from nerf_rs_tpu_torch import cli

    argv = ["train", "--preset", preset, "--dataset", "sphere", *extra]
    args = cli.build_parser().parse_args(argv)
    args._explicit = cli.explicit_dests(argv)
    return cli.config_from_args(args)


def drive_preset(tmp: str, preset: str) -> dict:
    """`cli train --preset {preset}` for PRESET_STEPS steps at full width
    (two K2 launches per step: coarse and fine), then `render --view 0`
    at 800x800 and `eval --max_views 2` on its checkpoint (two K1
    launches per chunk). Returns each path's launch counts."""
    from nerf_rs_tpu_torch.kernels.fused_ray import fused_ray_render
    from nerf_rs_tpu_torch.kernels.fused_train import fused_train_grads
    from nerf_rs_tpu_torch.render import default_render_chunk

    ckdir = os.path.join(tmp, preset)
    fused_train_grads.launches = 0
    fused_ray_render.launches = 0
    t0 = time.perf_counter()
    rc, out = run_cli(["train", "--preset", preset, "--dataset", "sphere", "--num_iter",
                       str(PRESET_STEPS), "--eval_steps", "50", "--save_steps", "1000",
                       "--save_dir", ckdir, "--log_dir", ckdir])
    k2, k1 = fused_train_grads.launches, fused_ray_render.launches
    print(f"cli train --preset {preset}, {PRESET_STEPS} steps: rc {rc}, K2 launches {k2}, "
          f"K1 launches {k1}, {time.perf_counter() - t0:.1f} s")
    losses = [float(v) for v in re.findall(r"iter=\d+, loss=(\S+)", out)]
    evals = [float(v) for v in re.findall(r"eval psnr=(\S+)", out)]
    if rc != 0 or k2 != 2 * PRESET_STEPS or k1 != 2:
        fail(f"train --preset {preset}: rc {rc}, K2 launches {k2} (want {2 * PRESET_STEPS}), "
             f"K1 launches {k1} (want 2: one eval, one chunk, two passes)")
    if not losses or not all(map(math.isfinite, losses + evals)) or len(evals) != 1:
        fail(f"train --preset {preset}: losses {losses}, eval psnrs {evals}")
    counts = {"train": k2, "train_eval": k1}

    cfg = preset_cfg(preset)
    chunk = default_render_chunk(cfg.render, fused=True, model_cfg=cfg.model)
    frame_launches = 2 * math.ceil(FRAME * FRAME / chunk)
    eval_launches = 2 * 2 * math.ceil(cfg.camera.width * cfg.camera.height / chunk)
    for key, argv, want in (
            ("render", ["render", "--width", str(FRAME), "--height", str(FRAME), "--view", "0",
                        "--out_dir", os.path.join(tmp, f"{preset}-render")], frame_launches),
            ("eval", ["eval", "--max_views", "2"], eval_launches)):
        fused_ray_render.launches = 0
        rc, out = run_cli([*argv, "--preset", preset, "--dataset", "sphere", "--save_dir", ckdir])
        k1 = fused_ray_render.launches
        m = re.search(r"psnr[= ](\S+)", out)
        print(f"cli {key} --preset {preset}: rc {rc}, K1 launches {k1} (want {want})")
        if rc != 0 or k1 != want or m is None or not math.isfinite(float(m.group(1))):
            fail(f"{key} --preset {preset}: rc {rc}, K1 launches {k1} (want {want}), "
                 f"psnr {m and m.group(1)}")
        counts[key] = k1
    png = read_png(os.path.join(tmp, f"{preset}-render", "view-0.png"))
    if png.shape != (FRAME, FRAME, 3):
        fail(f"{preset} view-0.png has shape {png.shape}")
    return counts


def learning_drive(tmp: str, preset: str) -> dict:
    """The preset's 64x64 learning drive through K2, once per seed in
    LEARN_SEEDS, then `cli eval` on each checkpoint: the mean over seeds
    of the mean PSNR over the first LEARN_VIEWS views must pass
    PRESET_PSNR[preset]. Returns each seed's readings and the mean."""
    from nerf_rs_tpu_torch.kernels.fused_train import fused_train_grads

    common = ["--preset", preset, "--dataset", "sphere", "--width", "64", "--height", "64",
              "--num_samples", "32", "--num_fine_samples", "64"]
    per_seed = {}
    for seed in LEARN_SEEDS:
        vdir = os.path.join(tmp, f"learn-{preset}-{seed}")
        fused_train_grads.launches = 0
        rc, out = run_cli(["train", *common, "--seed", str(seed), "--num_rays", "1024",
                           "--num_iter", "301", "--eval_steps", "100", "--learning_rate", "1e-3",
                           "--save_dir", vdir, "--log_dir", vdir])
        curve = dict(re.findall(r"iter=(\d+), eval psnr=(\S+)", out))
        if rc != 0 or fused_train_grads.launches != 2 * 301:
            fail(f"{preset} learning drive, seed {seed}: rc {rc}, K2 launches "
                 f"{fused_train_grads.launches} (want 602)")
        rc, out = run_cli(["eval", *common, "--save_dir", vdir, "--max_views", str(LEARN_VIEWS)])
        m = re.search(r"mean psnr over \d+ \S+ views: (\S+)", out)
        if rc != 0 or m is None or not math.isfinite(float(m.group(1))):
            fail(f"{preset} learning drive, seed {seed}: eval rc {rc}, no finite mean psnr")
        per_seed[seed] = {"view0_curve": curve, "mean_psnr": float(m.group(1))}
    mean = sum(r["mean_psnr"] for r in per_seed.values()) / len(per_seed)
    bar = PRESET_PSNR[preset]
    print(f"{preset} learning drives (64x64, 32 + 64 samples): mean psnr over {LEARN_VIEWS} "
          f"views at 301 per seed {[r['mean_psnr'] for r in per_seed.values()]}, mean {mean:.3f} "
          f"(bar {bar})")
    if not mean > bar:
        fail(f"{preset} learning drives: mean psnr {mean:.3f} over seeds {LEARN_SEEDS} "
             f"(need > {bar})")
    return {"seeds": per_seed, "mean_psnr": mean}


@contextlib.contextmanager
def plain_render_route():
    """Route the render path's kernel call to the plain version, for the
    frame check only."""
    from nerf_rs_tpu_torch.kernels import fused_ray

    real = fused_ray.fused_ray_render
    fused_ray.fused_ray_render = fused_ray.fused_ray_render_reference
    try:
        yield
    finally:
        fused_ray.fused_ray_render = real


def flops_per_row(mcfg, backward: bool) -> float:
    """Products one sample row needs, at the field's true widths (no pad
    columns): the forward's; with ``backward`` also the input gradients
    of every layer past the first and every weight gradient (K2)."""
    W, L, F, V = mcfg.net_width, mcfg.net_depth, mcfg.feature_width, mcfg.view_head_width
    pos, dird = 3 + 6 * mcfg.pos_enc_levels, 3 + 6 * mcfg.dir_enc_levels
    fwd = pos * W + (L - 1) * W * W + pos * W + W * (F + 1) + (F + dird) * V + V * 3
    if not backward:
        return 2.0 * fwd
    dx = (L - 1) * W * W + W * (F + 1) + F * V + V * 3  # no gradient into the encodings
    return 2.0 * (2 * fwd + dx)


def bound_ms(flops: float, nbytes: float, peak_flops: float = PEAK_FLOPS) -> tuple:
    """The least time for the work: (ms, what bounds it)."""
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def eager_field(model, cfg, o, d, vd, ts, edges=None, radius=None):
    """The eager field at bf16 (cuBLAS products) on every sample of the
    rays: at the points ts, or (IPE) on the conical Gaussians of the
    intervals between ``edges``. (sigma, rgb), as apply_nerf gives them."""
    import torch

    from nerf_rs_tpu_torch.models.mlp import apply_nerf
    from nerf_rs_tpu_torch.ops import sampling

    if edges is None:
        return apply_nerf(model, sampling.points_from_ts(o, d, ts), vd[:, None, :], cfg,
                          torch.bfloat16)
    mean, var, _, _ = sampling.conical_gaussians(o, d, edges, radius)
    return apply_nerf(model, mean, vd[:, None, :], cfg, torch.bfloat16, pos_var=var)


def time_branches(card: str, model, mcfg, cam, flat_o, flat_d) -> list:
    """The new branches' kernel calls at the presets' shapes: a whole K1
    chunk (the mipnerf fine pass's 131,072 rays x 128 IPE intervals, the
    hierarchical union pass's 65,536 x 192) and K2's 4096-ray calls. Each
    is held to its plain version (TOL, KERNEL_TOL) and timed against it,
    against a PyTorch library path computing the same function (K1: the
    eager bf16 field + composite; K2: autograd of the eager loss) and
    against its bound. Returns one row each."""
    import dataclasses

    import torch

    from nerf_rs_tpu_torch.kernels import fused_train
    from nerf_rs_tpu_torch.kernels.fused_ray import (
        fused_ray_render, fused_ray_render_reference, padded_samples)
    from nerf_rs_tpu_torch.kernels.fused_render import pack_weights, pack_weights_t
    from nerf_rs_tpu_torch.kernels.fused_train import (
        KERNEL_TOL, fused_train_grads, fused_train_grads_reference)
    from nerf_rs_tpu_torch.ops import render as render_ops, sampling

    dev = flat_o.device
    rows = []
    gold = torch.rand(4096, 3, generator=torch_generator(dev, 9), device=dev)
    for kernel, name, ipe, n, s in BRANCH_SHAPES:
        cfg = dataclasses.replace(mcfg, ipe=ipe, sigma_activation="softplus" if ipe else "relu")
        o, d = flat_o[:n].contiguous(), flat_d[:n].contiguous()
        vd = (d / torch.linalg.norm(d, dim=-1, keepdim=True)).contiguous()
        ts, dl, edges, radii = sample_inputs(n, s, ipe, cam, torch_generator(dev, 3))
        radius = sampling.pixel_radius(cam) if ipe else None
        pk = pack_weights(model, cfg)
        io = n * (36 + 8 * s + (4 if ipe else 0))  # rays, samples and radii in
        label = f"{kernel} vs plain [{name}, {n} rays]"
        if kernel == "K1":
            args = (pk, o, d, vd, ts, dl, cfg, s)
            chunks = [slice(i, i + PLAIN_CHUNK) for i in range(0, n, PLAIN_CHUNK)]
            fn = lambda: fused_ray_render(*args, radii=radii)  # noqa: E731
            plain = lambda: [fused_ray_render_reference(  # noqa: E731
                pk, o[j], d[j], vd[j], ts[j], dl[j], cfg, s,
                radii=None if radii is None else radii[j]) for j in chunks]
            got = fn()
            torch.cuda.synchronize()
            errs = k1_errs(label, got, [torch.cat(parts) for parts in zip(*plain())])
            hold(label, errs, TOL)
            err = max(errs.values())
            lib_rays = (1 << 22) // s  # the eager activations of 4M rows at a time

            @torch.no_grad()
            def library():
                for i in range(0, n, lib_rays):
                    j = slice(i, i + lib_rays)
                    sigma, rgb = eager_field(model, cfg, o[j], d[j], vd[j], ts[j],
                                             None if edges is None else edges[j], radius)
                    render_ops.composite(sigma, rgb, dl[j], ts=ts[j])
            flops = flops_per_row(cfg, False) * n * s
            nbytes = io + n * (20 + 8 * s) + 2 * pk.w.numel() + 4 * pk.b.numel()
        else:
            args = (pk, pack_weights_t(pk), o, d, vd, ts, dl, gold[:n], cfg, s)
            fn = lambda: fused_train_grads(*args, white_bg=True, radii=radii)  # noqa: E731
            plain = lambda: fused_train_grads_reference(  # noqa: E731
                *args, white_bg=True, radii=radii)
            got = fn()
            torch.cuda.synchronize()
            want = plain()
            hold(label, k2_errs(label, got, want), KERNEL_TOL)
            err = k2_abs(got, want)

            def library():
                model.zero_grad(set_to_none=True)
                sigma, rgb = eager_field(model, cfg, o, d, vd, ts, edges, radius)
                out = render_ops.composite(sigma, rgb, dl, white_background=True)
                render_ops.mse(out.rgb, gold[:n]).backward()
            flops = flops_per_row(cfg, True) * n * s
            nbytes = io + n * (12 + 32 + 4 * s) + 2 * pk.w.numel() + 4 * (pk.w.numel()
                                                                         + pk.b.numel())
        got = want = None
        ms = event_ms(fn)
        plain_ms = event_ms(plain, reps=1)
        library()
        library_ms = event_ms(library)
        model.zero_grad(set_to_none=True)
        b, by = bound_ms(flops, nbytes)
        row = {"kernel": kernel, "case": name, "rays": n, "samples": s, "max_abs_err": err,
               "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": b,
               "bound_by": by}
        if kernel == "K2":  # the stashes and dW partials of one call
            row["scratch_bytes"] = fused_train._library().nerf_fused_train_scratch_bytes(
                n, padded_samples(s), pk.depth, pk.W, pk.F, pk.V, pk.P, pk.D,
                pk.w.numel() + pk.b.numel())
        print(f"{kernel} {name}, {n} rays [{card}]: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
              f"library {library_ms:.3f} ms, bound {b:.3f} ms ({by}), "
              f"{flops / (ms * 1e-3) / 1e12:.1f} TFLOP/s"
              + (f", scratch {row['scratch_bytes'] / 1e9:.3f} GB" if kernel == "K2" else ""))
        rows.append(row)
    return rows


def time_presets(card: str) -> dict:
    """Each preset's step (4096 rays, 64 + 128 samples) through K2 and
    through autograd, its 800x800 frame through K1 (its first rays checked
    against the plain version, pass by pass), and a profile of the
    hierarchical K2 step."""
    import dataclasses

    import torch

    from nerf_rs_tpu_torch.data.factory import make_dataset
    from nerf_rs_tpu_torch.ops import render as render_ops
    from nerf_rs_tpu_torch.render import make_render
    from nerf_rs_tpu_torch.train.step import init_state, make_train_step, step_generator

    dev = torch.device("cuda")
    out = {}
    for preset in PRESETS:
        cfg = preset_cfg(preset)
        ds = make_dataset(cfg, dev)
        times = {}
        for name, c, window in (("K2", cfg, 10),
                                ("autograd", dataclasses.replace(cfg, use_whole_ray_train=False),
                                 5)):
            state = init_state(c, dev)
            fn = make_train_step(c, ds)
            it = [0]

            def run(k):
                nonlocal state
                for _ in range(k):
                    state, _ = fn(state, step_generator(0, it[0], dev))
                    it[0] += 1
            run(2)
            times[name] = best_of(lambda: run(window)) / window
            if name == "K2" and preset == "hierarchical":
                torch.cuda.synchronize()
                with torch.profiler.profile(
                        activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                    t0 = time.perf_counter()
                    run(5)
                    torch.cuda.synchronize()
                    wall = (time.perf_counter() - t0) * 1e3 / 5
                per = sorted(((v / 5, k) for k, v in device_ms(prof).items()), reverse=True)
                busy = sum(v for v, _ in per)
                print(f"hierarchical K2 step profile [{card}]: wall {wall:.3f} ms/step "
                      f"(profiled), device busy {busy:.3f} ms/step, "
                      f"idle {100 * (1 - busy / wall):.1f}%")
                for v, k in per[:8]:
                    print(f"  {v:8.3f} ms/step  {k[:100]}")
            del state
        for name, t in times.items():
            print(f"{preset} train step through {name} [{card}]: {t * 1e3:.3f} ms/step")

        fcfg = preset_cfg(preset, "--width", str(FRAME), "--height", str(FRAME))
        fds = make_dataset(fcfg, dev)
        fo, fd = (a.reshape(-1, 3) for a in fds.view_rays(0))
        st = init_state(fcfg, dev)
        render_fn = make_render(fcfg)
        frame = lambda: render_fn(st.params, fo, fd, fine_params=st.fine_params)  # noqa: E731
        if not bool(torch.isfinite(frame()[0]).all()):
            fail(f"{preset} 800x800 frame: non-finite values")
        # the frame's first rays through both routes, coarse and fine
        k = PLAIN_CHUNK // 4
        passes = []
        for route in (contextlib.nullcontext, plain_render_route):
            with route(), torch.no_grad():
                passes.append(render_ops.render_rays(
                    st.params, fo[:k], fd[:k], fcfg.model, fcfg.render, fcfg.camera,
                    randomized=False, dtype=torch.bfloat16, use_fused=True,
                    fine_params=st.fine_params))
        coarse_err = float((passes[0][0].rgb - passes[1][0].rgb).abs().max())
        fine_diff = (passes[0][1].rgb - passes[1][1].rgb).abs()
        errs = {"coarse": coarse_err, "fine mean": float(fine_diff.mean()),
                "fine max": float(fine_diff.max())}
        print(f"{preset} frame, K1 vs plain on its first {k} rays: coarse rgb "
              f"{coarse_err:.3g} (tol {TOL['rgb']:g}), fine rgb mean {errs['fine mean']:.3g} "
              f"(tol {FINE_TOL['mean']:g}), max {errs['fine max']:.3g} (tol {FINE_TOL['max']:g})")
        if not (coarse_err <= TOL["rgb"] and errs["fine mean"] <= FINE_TOL["mean"]
                and errs["fine max"] <= FINE_TOL["max"]):
            fail(f"{preset} frame: K1 and the plain version disagree: {errs}")
        t_frame = best_of(frame)
        print(f"{preset} 800x800 frame [{card}]: {t_frame:.4f} s through K1 (best of 3)")
        out[preset] = {"k2_ms": times["K2"] * 1e3, "autograd_ms": times["autograd"] * 1e3,
                       "frame_s": t_frame}
    return out


def frame_rays(dev):
    """The render config of an 800x800 sphere view and its rays, (cfg,
    origins, dirs), each (H, W, 3)."""
    from nerf_rs_tpu_torch import cli
    from nerf_rs_tpu_torch.data.factory import make_dataset

    cfg = cli.config_from_args(cli.build_parser().parse_args(
        ["render", "--dataset", "sphere", "--width", str(FRAME), "--height", str(FRAME)]))
    return (cfg, *make_dataset(cfg, dev).view_rays(0))


def time_chunk(card: str, packed, mcfg, cam, flat_o, flat_d) -> dict:
    """One flagship render chunk (the first CHUNK rays of a frame, 64
    midpoint samples) through K1 and through its plain version. Returns
    both times and the chunk's inputs (origins, dirs, viewdirs, ts,
    deltas)."""
    import torch

    from nerf_rs_tpu_torch.kernels.fused_ray import fused_ray_render, fused_ray_render_reference
    from nerf_rs_tpu_torch.ops import sampling

    n, s, dev = CHUNK, 64, flat_o.device
    co, cd = flat_o[:n].contiguous(), flat_d[:n].contiguous()
    cvd = cd / torch.linalg.norm(cd, dim=-1, keepdim=True)
    ts = sampling.stratified_ts(n, s, cam.near, cam.far, False, device=dev)
    dl = sampling.deltas_from_ts(ts, cam.far)

    def kernel_chunk():
        fused_ray_render(packed, co, cd, cvd, ts, dl, mcfg, s)

    def plain_chunk():
        for i in range(0, n, PLAIN_CHUNK):
            j = slice(i, i + PLAIN_CHUNK)
            fused_ray_render_reference(packed, co[j], cd[j], cvd[j], ts[j], dl[j], mcfg, s)

    kernel_chunk()
    ms = event_ms(kernel_chunk)
    plain_ms = event_ms(plain_chunk)
    # every packed matrix multiplies each sample row once
    flops_row = 2 * sum(k * c for k, c in packed.w_shape)
    print(f"one {n}-ray chunk [{card}]: kernel {ms:.3f} ms "
          f"(~{flops_row * n * s / (ms * 1e-3) / 1e12:.1f} TFLOP/s bf16), "
          f"plain {plain_ms:.3f} ms")
    return {"ms": ms, "plain_ms": plain_ms, "inputs": (co, cd, cvd, ts, dl)}


def library_times(card: str, model, mcfg, co, cd, cvd, ts, dl) -> dict:
    """One PyTorch library path computing each kernel's function on its
    flagship inputs, timed and used nowhere in the port: K1, the eager
    field at bf16 (cuBLAS) + composite over the 262,144-ray chunk (in
    four calls of 65,536 rays, for device memory); K2, autograd's
    forward + backward of the eager loss at 4096 rays x 64 samples."""
    import torch

    from nerf_rs_tpu_torch.ops import render as render_ops

    @torch.no_grad()
    def k1_library():
        for i in range(0, co.shape[0], 65536):
            j = slice(i, i + 65536)
            sigma, rgb = eager_field(model, mcfg, co[j], cd[j], cvd[j], ts[j])
            render_ops.composite(sigma, rgb, dl[j], ts=ts[j])

    n = 4096
    gold = torch.rand(n, 3, generator=torch_generator(co.device, 4), device=co.device)

    def k2_library():
        model.zero_grad(set_to_none=True)
        sigma, rgb = eager_field(model, mcfg, co[:n], cd[:n], cvd[:n], ts[:n])
        out = render_ops.composite(sigma, rgb, dl[:n])
        render_ops.mse(out.rgb, gold).backward()

    k1_library()
    k2_library()
    times = {"fused_ray_render": event_ms(k1_library), "fused_train_grads": event_ms(k2_library)}
    model.zero_grad(set_to_none=True)
    print(f"library paths [{card}]: eager bf16 field + composite, 262,144 x 64: "
          f"{times['fused_ray_render']:.3f} ms; autograd of the eager loss, 4096 x 64: "
          f"{times['fused_train_grads']:.3f} ms")
    return times


def factored_config(run_dir=None, **train):
    """FACTORED_CONFIG: the bench's factored window (bench.py:136-145) with
    the kernel on; with ``run_dir``, the loop's logs and checkpoints go
    there."""
    from nerf_rs_tpu_torch import (CameraConfig, Config, DataConfig, ModelConfig, RenderConfig,
                                   TrainConfig)

    dirs = {} if run_dir is None else {"log_dir": run_dir, "save_dir": run_dir}
    return Config(camera=CameraConfig(width=128, height=128),
                  model=ModelConfig(arch="factored", sigma_activation="softplus", fac_fused=True),
                  render=RenderConfig(num_samples=128, white_background=True),
                  train=TrainConfig(num_rays=FAC_RAYS, precision="mixed", learning_rate=1e-2,
                                    **train),
                  data=DataConfig(dataset="sphere"), **dirs)


def factored_points(ds, cam, n_rays: int, seed: int):
    """(n_rays * 128, 3) points of sphere rays with 128 jittered samples,
    every 8th pushed out to twice its place (past the AABB: clipped)."""
    from nerf_rs_tpu_torch.ops import sampling

    dev = ds.images.device
    gen = torch_generator(dev, seed)
    batch = ds.sample_batch(gen, n_rays)
    ts = sampling.stratified_ts(n_rays, 128, cam.near, cam.far, True, generator=gen, device=dev)
    pts = sampling.points_from_ts(batch.origins, batch.dirs, ts).reshape(-1, 3).clone()
    pts[::8] *= 2.0
    return pts.contiguous()


def check_factored_kernel(ds, mcfg, cam, lines) -> dict:
    """K3's forward and backward against their plain versions, bf16 and
    f32, on a train step's 524,288 points and on 4,103 rays' (ragged);
    two backward launches bit-identical. Returns the largest absolute
    differences (enc, d_lines) and the largest d_lines one relative to its
    axis's largest entry."""
    import torch

    from nerf_rs_tpu_torch.kernels import fused_factored as k3

    errs = {"enc": 0.0, "d_lines_abs": 0.0, "d_lines": 0.0}
    for n_rays in (FAC_RAYS, N_RAYS):
        pts = factored_points(ds, cam, n_rays, 11)
        clipped = int((pts.abs() > mcfg.fac_aabb).any(-1).sum())
        g = torch.randn(pts.shape[0], mcfg.fac_comps, generator=torch_generator(pts.device, 12),
                        device=pts.device)
        for name, dtype in (("bf16", torch.bfloat16), ("f32", None)):
            enc = k3.fused_factored_encode_forward(lines, pts, mcfg, dtype)
            d = k3.fused_factored_encode_backward(lines, pts, g, mcfg, dtype)
            again = k3.fused_factored_encode_backward(lines, pts, g, mcfg, dtype)
            torch.cuda.synchronize()
            if not (bool(torch.isfinite(enc).all()) and bool(torch.isfinite(d).all())):
                fail(f"K3 [{name}, {pts.shape[0]} points]: non-finite outputs")
            if not torch.equal(d, again):
                fail(f"two K3 backward launches [{name}, {pts.shape[0]} points] gave different bits")
            want = k3.fused_factored_encode_backward_reference(lines, pts, g, mcfg, dtype)
            got = {"enc": float((enc - k3.fused_factored_encode_reference(lines, pts, mcfg, dtype))
                                .abs().max()),
                   "d_lines": max(leaf_err(d[a], want[a]) for a in range(3))}
            hold(f"K3 vs plain [{name}, {pts.shape[0]} points, {clipped} clipped]", got,
                 k3.KERNEL_TOL)
            errs["enc"] = max(errs["enc"], got["enc"])
            errs["d_lines"] = max(errs["d_lines"], got["d_lines"])
            errs["d_lines_abs"] = max(errs["d_lines_abs"], float((d - want).abs().max()))
    print("K3 backward: two launches on the same inputs give bit-identical d_lines")
    return errs


@contextlib.contextmanager
def plain_factored_route():
    """Route K3's forward to its plain version, for the frame check only."""
    from nerf_rs_tpu_torch.kernels import fused_factored as k3

    real = k3.fused_factored_encode_forward
    k3.fused_factored_encode_forward = k3.fused_factored_encode_reference
    try:
        yield
    finally:
        k3.fused_factored_encode_forward = real


def drive_factored(tmp: str, fo, fd, card: str) -> dict:
    """The factored path through K3: train/loop.train on FACTORED_CONFIG
    for FAC_STEPS steps (an eval at step 50), an 800x800 render_frame of
    the rays (fo, fd) and an eval of 2 views, each with its exact K3
    launch counts; the frame's first chunk held to the plain route. Then
    (outside the counted runs) the frame's time. Returns the launch counts
    by path and the frame's seconds."""
    import dataclasses

    import torch

    from nerf_rs_tpu_torch.data.factory import make_dataset
    from nerf_rs_tpu_torch.kernels import fused_factored as k3
    from nerf_rs_tpu_torch.ops import render as render_ops
    from nerf_rs_tpu_torch.render import default_render_chunk, render_frame
    from nerf_rs_tpu_torch.train.loop import train

    dev = fo.device
    fwd, bwd = k3.fused_factored_encode, k3.fused_factored_encode_backward
    cfg = factored_config(os.path.join(tmp, "factored"), num_iter=FAC_STEPS, eval_steps=50,
                          save_steps=1000)
    ds = make_dataset(cfg, dev)
    chunk = default_render_chunk(cfg.render, model_cfg=cfg.model)
    eval_chunks = math.ceil(cfg.camera.width * cfg.camera.height / chunk)
    fwd.launches = bwd.launches = 0
    t0 = time.perf_counter()
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        state = train(cfg, ds)
    counts = {"train": fwd.launches, "train_backward": bwd.launches}
    print(log.getvalue().rstrip())
    print(f"factored train, {FAC_STEPS} steps through K3: forward launches {fwd.launches}, "
          f"backward {bwd.launches}, {time.perf_counter() - t0:.1f} s")
    if (fwd.launches, bwd.launches) != (FAC_STEPS + eval_chunks, FAC_STEPS):
        fail(f"factored train: K3 launches {fwd.launches} / {bwd.launches} (want "
             f"{FAC_STEPS + eval_chunks} = steps + eval chunks / {FAC_STEPS})")
    losses = [float(v) for v in re.findall(r"iter=\d+, loss=(\S+)", log.getvalue())]
    evals = [float(v) for v in re.findall(r"eval psnr=(\S+)", log.getvalue())]
    if not losses or len(evals) != 1 or not all(map(math.isfinite, losses + evals)):
        fail(f"factored train: losses {losses}, eval psnrs {evals}")

    fcfg = dataclasses.replace(cfg, camera=dataclasses.replace(cfg.camera, width=FRAME,
                                                               height=FRAME))
    frame_chunks = math.ceil(FRAME * FRAME / default_render_chunk(fcfg.render,
                                                                  model_cfg=fcfg.model))
    fwd.launches = 0
    rgb, depth, acc = render_frame(fcfg, state.params, fo, fd)
    torch.cuda.synchronize()
    counts["frame"] = fwd.launches
    if fwd.launches != frame_chunks or frame_chunks != 20:
        fail(f"factored 800x800 frame: K3 launches {fwd.launches} (want {frame_chunks} = 20)")
    if not (bool(torch.isfinite(rgb).all()) and bool(torch.isfinite(depth).all())):
        fail("factored 800x800 frame: non-finite values")
    with plain_factored_route(), torch.no_grad():
        plain, _ = render_ops.render_rays(
            state.params, fo.reshape(-1, 3)[:chunk], fd.reshape(-1, 3)[:chunk], fcfg.model,
            fcfg.render, fcfg.camera, randomized=False, dtype=torch.bfloat16)
    diff = (rgb.reshape(-1, 3)[:chunk] - plain.rgb).abs()
    errs = {"mean": float(diff.mean()), "max": float(diff.max())}
    hold(f"factored frame, K3 vs plain route on its first {chunk} rays", errs, FAC_FRAME_TOL)
    print(f"factored 800x800 frame: rgb in [{float(rgb.min()):.4f}, {float(rgb.max()):.4f}], "
          f"mean acc {float(acc.mean()):.4f}")

    fwd.launches = 0
    psnrs = [float(render_ops.psnr(render_frame(cfg, state.params, *ds.view_rays(v))[0],
                                   ds.view_gold(v))) for v in range(2)]
    counts["eval"] = fwd.launches
    print(f"factored eval of 2 views through K3: psnr {psnrs}, K3 launches {fwd.launches}")
    if fwd.launches != 2 * eval_chunks or not all(map(math.isfinite, psnrs)):
        fail(f"factored eval: K3 launches {fwd.launches} (want {2 * eval_chunks}), psnr {psnrs}")
    counts["frame_s"] = best_of(lambda: render_frame(fcfg, state.params, fo, fd))
    print(f"factored 800x800 frame [{card}]: {counts['frame_s']:.4f} s through K3 (best of 3)")
    return counts


def drive_factored_cli(tmp: str) -> None:
    """`cli train/eval/render --preset factored` at full width: the CLI's
    route is the dense-hat encode, so K3 is launched no time."""
    from nerf_rs_tpu_torch.kernels import fused_factored as k3

    ckdir = os.path.join(tmp, "factored-cli")
    common = ["--preset", "factored", "--dataset", "sphere", "--save_dir", ckdir]
    k3.fused_factored_encode.launches = k3.fused_factored_encode_backward.launches = 0
    for argv in (["train", *common, "--num_iter", "11", "--eval_steps", "10", "--save_steps",
                  "1000", "--log_dir", ckdir],
                 ["eval", *common, "--max_views", "1"],
                 ["render", *common, "--view", "0", "--out_dir", os.path.join(tmp, "fac-render")]):
        rc, out = run_cli(argv)
        m = re.search(r"psnr[= ](\S+)", out)
        if rc != 0 or m is None or not math.isfinite(float(m.group(1))):
            fail(f"cli {argv[0]} --preset factored: rc {rc}, psnr {m and m.group(1)}")
    launches = (k3.fused_factored_encode.launches, k3.fused_factored_encode_backward.launches)
    print(f"cli train/eval/render --preset factored: K3 launches {launches} (want (0, 0))")
    if launches != (0, 0):
        fail(f"the CLI's factored route launched K3: {launches}")
    if read_png(os.path.join(tmp, "fac-render", "view-0.png")).shape != (128, 128, 3):
        fail("cli render --preset factored wrote no 128x128 view")


def factored_learning(tmp: str, dev) -> dict:
    """The 64x64 factored drive (the preset at --num_samples 32, 1024 rays,
    301 steps) through K3 for each seed in LEARN_SEEDS, then `cli eval` on
    its checkpoint: the mean over seeds of the mean PSNR over LEARN_VIEWS
    views must pass FAC_PSNR."""
    import dataclasses

    from nerf_rs_tpu_torch.data.factory import make_dataset
    from nerf_rs_tpu_torch.kernels import fused_factored as k3
    from nerf_rs_tpu_torch.train.loop import train

    common = ["--preset", "factored", "--dataset", "sphere", "--width", "64", "--height", "64",
              "--num_samples", "32"]
    per_seed = {}
    for seed in LEARN_SEEDS:
        vdir = os.path.join(tmp, f"learn-factored-{seed}")
        cfg = preset_cfg("factored", "--width", "64", "--height", "64", "--num_samples", "32",
                         "--num_rays", "1024", "--num_iter", "301", "--eval_steps", "100",
                         "--seed", str(seed), "--save_dir", vdir, "--log_dir", vdir)
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, fac_fused=True))
        k3.fused_factored_encode_backward.launches = 0
        log = io.StringIO()
        with contextlib.redirect_stdout(log):
            train(cfg, make_dataset(cfg, dev))
        curve = dict(re.findall(r"iter=(\d+), eval psnr=(\S+)", log.getvalue()))
        if k3.fused_factored_encode_backward.launches != 301:
            fail(f"factored learning drive, seed {seed}: K3 backward launches "
                 f"{k3.fused_factored_encode_backward.launches} (want 301)")
        rc, out = run_cli(["eval", *common, "--save_dir", vdir, "--max_views", str(LEARN_VIEWS)])
        m = re.search(r"mean psnr over \d+ \S+ views: (\S+)", out)
        if rc != 0 or m is None or not math.isfinite(float(m.group(1))):
            fail(f"factored learning drive, seed {seed}: eval rc {rc}, no finite mean psnr")
        per_seed[seed] = {"view0_curve": curve, "mean_psnr": float(m.group(1))}
    mean = sum(r["mean_psnr"] for r in per_seed.values()) / len(per_seed)
    print(f"factored learning drives through K3 (64x64, 32 samples): mean psnr over "
          f"{LEARN_VIEWS} views at 301 per seed {[r['mean_psnr'] for r in per_seed.values()]}, "
          f"mean {mean:.3f} (bar {FAC_PSNR})")
    if not mean > FAC_PSNR:
        fail(f"factored learning drives: mean psnr {mean:.3f} over seeds {LEARN_SEEDS} "
             f"(need > {FAC_PSNR})")
    return {"seeds": per_seed, "mean_psnr": mean}


def library_factored(lines, pts, mcfg, dtype):
    """A PyTorch library path computing K3's forward, used nowhere in the
    port: the 2L taps per axis (indices and weights, as the kernel forms
    them), one F.embedding_bag(mode="sum", per_sample_weights=...) per
    axis over the operands rounded as the kernel rounds them, and the
    product. ``lines`` (f32) may require grad: autograd of this is the
    library backward."""
    import torch
    import torch.nn.functional as F

    from nerf_rs_tpu_torch.models.factored import fac_resolutions, unit_coords

    u = unit_coords(pts, mcfg.fac_aabb)
    idx, w, off = [], [], 0
    for r in fac_resolutions(mcfg):
        pos = u * float(r)
        k0 = torch.clamp(torch.floor(pos), max=r - 1)
        idx += [off + k0, off + k0 + 1]
        w += [torch.relu(1.0 - (pos - k0).abs()), torch.relu(1.0 - (pos - k0 - 1.0).abs())]
        off += r + 1
    idx = torch.stack(idx, -1).long()  # (N, 3, 2L)
    w = torch.stack(w, -1)
    if dtype == torch.bfloat16:
        w = w.bfloat16().float()
        lines = lines.bfloat16().float()
    enc = None
    for a in range(3):
        f = F.embedding_bag(idx[:, a], lines[a], per_sample_weights=w[:, a], mode="sum")
        enc = f if enc is None else enc * f
    return enc


def time_factored(card: str, ds, lines) -> dict:
    """The factored step through K3 and through the CLI's route, a profile
    of the K3 step, and K3's calls at the main path's shapes (forward and
    backward at 524,288 points, forward at a 4,194,304-point render chunk)
    beside their plain versions, the library path and the bound."""
    import dataclasses

    import torch

    from nerf_rs_tpu_torch.kernels import fused_factored as k3
    from nerf_rs_tpu_torch.models.factored import basis_dim
    from nerf_rs_tpu_torch.train.step import init_state, make_train_step, step_generator

    dev = ds.images.device
    cfg = factored_config()
    mcfg = cfg.model
    bf16 = torch.bfloat16
    out = {}

    def stepper(c):
        state = init_state(c, dev)
        fn = make_train_step(c, ds)
        it = [0]

        def run(k):
            nonlocal state
            for _ in range(k):
                state, _ = fn(state, step_generator(0, it[0], dev))
                it[0] += 1
        return run

    for name, c in (("K3", cfg), ("the CLI route", dataclasses.replace(
            cfg, model=dataclasses.replace(mcfg, fac_fused=False)))):
        run = stepper(c)
        run(3)
        out[name] = best_of(lambda: run(10)) / 10 * 1e3
        print(f"factored train step through {name} [{card}]: {out[name]:.3f} ms/step "
              f"(best of 3 windows of 10)")
    run = stepper(cfg)
    run(3)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(5)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / 5
    per = sorted(((v / 5, k) for k, v in device_ms(prof).items()), reverse=True)
    busy = sum(v for v, _ in per)
    out["idle_pct"] = 100 * (1 - busy / wall)
    print(f"factored K3 step profile [{card}]: wall {wall:.3f} ms/step (profiled), device busy "
          f"{busy:.3f} ms/step, idle {out['idle_pct']:.1f}%")
    for v, k in per[:10]:
        print(f"  {v:8.3f} ms/step  {k[:100]}")

    C, R = mcfg.fac_comps, basis_dim(mcfg)
    rows = []
    for kind, n_rays in (("forward", FAC_RAYS), ("backward", FAC_RAYS), ("forward", FAC_CHUNK)):
        pts = factored_points(ds, cfg.camera, n_rays, 13)
        n = pts.shape[0]
        g = torch.randn(n, C, generator=torch_generator(dev, 14), device=dev)
        lib_lines = lines.detach().clone().requires_grad_(kind == "backward")
        if kind == "forward":
            fn = lambda: k3.fused_factored_encode_forward(lines, pts, mcfg, bf16)  # noqa: E731
            plain = lambda: k3.fused_factored_encode_reference(lines, pts, mcfg, bf16)  # noqa: E731
            with torch.no_grad():
                library = lambda: library_factored(lib_lines, pts, mcfg, bf16)  # noqa: E731
                lib_err = float((library() - plain()).abs().max())
            # points in, encodings out, the bf16 line tables; per point 3 axes
            # x 2L taps x C products and sums, and the CP product
            nbytes = n * (12 + 4 * C) + 2 * 3 * R * C
            flops = n * (3 * 2 * 2 * mcfg.fac_levels * C + 2 * C)
        else:
            fn = lambda: k3.fused_factored_encode_backward(lines, pts, g, mcfg, bf16)  # noqa: E731
            plain = lambda: k3.fused_factored_encode_backward_reference(  # noqa: E731
                lines, pts, g, mcfg, bf16)
            enc = library_factored(lib_lines, pts, mcfg, bf16)
            library = lambda: torch.autograd.grad(enc, lib_lines, g, retain_graph=True)  # noqa: E731
            lib_err = leaf_err(library()[0], plain())
            # points and g in, the bf16 line tables, d_lines out; per point the
            # three axis features (2L taps x C each), d_feat, and the scatter of
            # w d_feat into 2L rows per axis
            nbytes = n * (12 + 4 * C) + 2 * 3 * R * C + 4 * 3 * R * C
            flops = n * (2 * 3 * 2 * 2 * mcfg.fac_levels * C + 3 * 2 * C)
        fn()
        ms = event_ms(fn)
        plain_ms = event_ms(plain, reps=1)
        library()
        library_ms = event_ms(library)
        b, by = bound_ms(flops, nbytes, PEAK_F32)
        dense_ms = 3 * n * R * C * 2 * (2 if kind == "backward" else 1) / PEAK_FLOPS * 1e3
        row = {"kernel": kind, "points": n, "ms": ms, "plain_ms": plain_ms,
               "library_ms": library_ms, "library_vs_plain": lib_err, "bound_ms": b,
               "bound_by": by, "sparse_flops": flops, "bytes": nbytes,
               "dense_bound_ms": dense_ms}
        print(f"K3 {kind}, {n} points [{card}]: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
              f"library {library_ms:.3f} ms (vs plain {lib_err:.3g}), bound {b:.4f} ms ({by}; "
              f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP at {PEAK_F32 / 1e12:.0f} "
              f"TFLOP/s f32), {nbytes / (ms * 1e-3) / 1e9:.0f} GB/s; the dense hat product "
              f"the TPU ran would be {dense_ms:.3f} ms at {PEAK_FLOPS / 1e12:.0f} TFLOP/s bf16")
        rows.append(row)
        del pts, g, lib_lines
    out["calls"] = rows
    return out


def time_step(root: str) -> int:
    """The flagship path's times for the checkout at ``root``: the train
    step through K2, autograd and the plain version, one K2 call, and one
    K1 chunk. Its kernels build into that checkout."""
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import torch

    import nerf_rs_tpu_torch as pkg

    if not torch.cuda.is_available():
        fail("no CUDA device: the kernels run on the card only")
    if not os.path.abspath(pkg.__file__).startswith(root + os.sep):
        fail(f"imported {pkg.__file__}, not the checkout at {root}")
    torch.backends.cuda.matmul.allow_tf32 = False  # plain version: full f32
    from nerf_rs_tpu_torch import ModelConfig
    from nerf_rs_tpu_torch.kernels.fused_render import pack_weights
    from nerf_rs_tpu_torch.models.mlp import init_nerf_params

    card = card_line()
    print(f"{root} [{card}]")
    dev = torch.device("cuda")
    time_training(card)
    mcfg = ModelConfig()
    cfg, fo, fd = frame_rays(dev)
    time_chunk(card, pack_weights(init_nerf_params(mcfg, 0, dev), mcfg), mcfg, cfg.camera,
               fo.reshape(-1, 3), fd.reshape(-1, 3))
    return 0


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
        errs = k1_errs(f"K1 [{case}]", got, fused_ray_render_reference(*args))
        hold(f"K1 vs plain [{case}]", errs, TOL)
        max_err = max(max_err, *errs.values())

    # ---- 4. K2 vs its plain version and vs autograd ----
    gold = synthetic.sphere_image(cam, device=dev)[..., :3].reshape(-1, 3)
    gold = torch.cat([gold, gold])[:N_RAYS].contiguous()
    train_err = check_train_kernel(model, mcfg, (o, d, vd), ts_jit, gold, cam.far)

    # ---- 9. the hierarchical branches: IPE, rays longer than one tile ----
    max_err = max(max_err, check_render_branches(model, mcfg, (o, d, vd), cam))
    train_err = max(train_err, check_train_branches(model, mcfg, (o, d, vd), gold, cam))

    # ---- 12. K3 vs its plain versions ----
    fcfg = factored_config()
    fac_ds = make_dataset(fcfg, dev)
    fac_lines = init_nerf_params(fcfg.model, 0, dev).lines.detach()
    fac_errs = check_factored_kernel(fac_ds, fcfg.model, fcfg.camera, fac_lines)

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
        cfg, fo, fd = frame_rays(dev)
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

        # ---- 10. the hierarchical path through the CLI, per preset ----
        preset_counts = {p: drive_preset(tmp, p) for p in PRESETS}
        learned = {p: learning_drive(tmp, p) for p in PRESETS}

        # ---- 13. the factored path: K3 through the library, the CLI's route ----
        fac_counts = drive_factored(tmp, fo, fd, card)
        drive_factored_cli(tmp)
        fac_learned = factored_learning(tmp, dev)
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
    chunk = time_chunk(card, packed, mcfg, cfg.camera, flat_o, flat_d)

    train_times = time_training(card)

    # ---- 11. times of the hierarchical path and the new branches ----
    branch_rows = time_branches(card, model, mcfg, cfg.camera, flat_o, flat_d)
    max_err = max(max_err, *(r["max_abs_err"] for r in branch_rows if r["kernel"] == "K1"))
    train_err = max(train_err, *(r["max_abs_err"] for r in branch_rows if r["kernel"] == "K2"))
    preset_times = time_presets(card)
    library = library_times(card, model, mcfg, *chunk["inputs"])

    # ---- 14. times of the factored path and K3 ----
    fac_times = time_factored(card, fac_ds, fac_lines)
    fac_fwd, fac_bwd, fac_chunk = fac_times.pop("calls")

    bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "nerf_rs_tpu"))
    if bad:
        fail(f"imported {bad}: the port stands without JAX and the JAX package")
    # the flagship shapes' bounds: a 262,144-ray chunk at S=64 (K1), a
    # 4096 x 64 step's call (K2); every input read once, output written once
    k1_bound, k1_by = bound_ms(flops_per_row(mcfg, False) * CHUNK * S,
                               CHUNK * (36 + 8 * S + 20 + 8 * S) + 2 * packed.w.numel())
    k2_bound, k2_by = bound_ms(flops_per_row(mcfg, True) * 4096 * S,
                               4096 * (36 + 8 * S + 12 + 32 + 4 * S)
                               + 4 * (packed.w.numel() + packed.b.numel()))
    k1_paths = {"render_flagship": launches,
                **{f"{p}_{k}": c[k] for p, c in preset_counts.items()
                   for k in ("train_eval", "render", "eval")}}
    k2_paths = {"train_flagship": train_launches,
                **{f"{p}_train": c["train"] for p, c in preset_counts.items()}}
    k3_paths = {f"factored_{k}": fac_counts[k] for k in ("train", "frame", "eval")}
    k3b_paths = {"factored_train": fac_counts["train_backward"]}
    print(json.dumps({"kernels": [{
        "name": "fused_ray_render",
        "route": "cuda",
        "source": "nerf_rs_tpu_torch/kernels/csrc/fused_ray.cu",
        "replaces": "nerf_rs_tpu/kernels/fused_ray.py:45",
        "launches": sum(k1_paths.values()),
        "launches_by_path": k1_paths,
        "max_abs_err": max_err,
        "ms": chunk["ms"],
        "plain_ms": chunk["plain_ms"],
        "bound_ms": k1_bound,
        "bound_by": k1_by,
        "library_ms": library["fused_ray_render"],
        "branches": [r for r in branch_rows if r["kernel"] == "K1"],
    }, {
        "name": "fused_train_grads",
        "route": "cuda",
        "source": "nerf_rs_tpu_torch/kernels/csrc/fused_train.cu",
        "replaces": "nerf_rs_tpu/kernels/fused_train.py:93",
        "launches": sum(k2_paths.values()),
        "launches_by_path": k2_paths,
        "max_abs_err": train_err,
        "ms": train_times["k2_ms"],
        "plain_ms": train_times["plain_ms"],
        "bound_ms": k2_bound,
        "bound_by": k2_by,
        "library_ms": library["fused_train_grads"],
        "branches": [r for r in branch_rows if r["kernel"] == "K2"],
    }, {
        "name": "fused_factored_encode",
        "route": "cuda",
        "source": "nerf_rs_tpu_torch/kernels/csrc/fused_factored.cu",
        "replaces": "nerf_rs_tpu/kernels/fused_factored.py:58",
        "launches": sum(k3_paths.values()),
        "launches_by_path": k3_paths,
        "max_abs_err": fac_errs["enc"],
        "ms": fac_fwd["ms"],
        "plain_ms": fac_fwd["plain_ms"],
        "bound_ms": fac_fwd["bound_ms"],
        "bound_by": fac_fwd["bound_by"],
        "library_ms": fac_fwd["library_ms"],
        "points": fac_fwd["points"],
        "cases": [fac_chunk],
    }, {
        "name": "fused_factored_encode_backward",
        "route": "cuda",
        "source": "nerf_rs_tpu_torch/kernels/csrc/fused_factored.cu",
        "replaces": "nerf_rs_tpu/kernels/fused_factored.py:73",
        "launches": sum(k3b_paths.values()),
        "launches_by_path": k3b_paths,
        "max_abs_err": fac_errs["d_lines_abs"],
        "max_rel_err": fac_errs["d_lines"],
        "ms": fac_bwd["ms"],
        "plain_ms": fac_bwd["plain_ms"],
        "bound_ms": fac_bwd["bound_ms"],
        "bound_by": fac_bwd["bound_by"],
        "library_ms": fac_bwd["library_ms"],
        "points": fac_bwd["points"],
    }], "presets": preset_times, "learning": learned,
        "factored": {**fac_times, "frame_s": fac_counts["frame_s"],
                     "learning": fac_learned}}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--time-step"] and len(sys.argv) == 3:
        sys.exit(time_step(sys.argv[2]))
    if len(sys.argv) != 1:
        fail("usage: python3 chip_smoke.py [--time-step ROOT]")
    sys.exit(main())
