"""Smoke test of the PyTorch port on one CUDA card (an H100).

    python3 chip_smoke.py

Phases, each fatal (any failure exits non-zero):
  1. device: a CUDA card must be present; prints nvidia-smi's name and
     power limit. Without a card the script exits 1 and prints no result.
  2. build: compiles the whole-ray render kernel (K1), the train kernel
     (K2), K3 and K4 from nerf_rs_tpu_torch/kernels/csrc/ with nvcc for
     sm_90a, all at once; prints build seconds and ptxas' registers, spills
     and shared memory of every kernel instance, and which instances ptxas
     left with serialized wgmma (K1's instance for widths other than the
     paper's); fails where K2b's dw_wgmma_kernel spills or has its wgmma
     serialized.
  3. K1 vs its plain PyTorch version at the flagship width (8x256 trunk,
     skip 4, F 256, V 128, PE 10/4, S 64) on 4,103 rays of two poses,
     with midpoint and jittered samples, relu and softplus sigma. The
     seed-0 weights' biases are drawn at random (random_biases_), for
     this and every later check of this model.
  4. K2 vs its plain version on the same rays with sphere gold and
     jittered samples (relu, relu on white, softplus on white), and vs
     the plain version's float64 witness (the same bf16 rounding points,
     float64 sums); vs autograd of the eager path; two launches
     bit-identical; K2b alone against the float64 product of the stashes
     K2a left (check_dw_stashes, at DW_TOL; again in phases 9 and 36).
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
     camera's cone radius; and at S = 193, the record preset's union of
     intervals) and rays longer than one tile (S = 192, the hierarchical
     union pass, and 193); K2 bit-identical across launches
     at S = 192. Then K2 at S = 150, 191 and 192, which run as 192 (two rays
     a CTA in three passes), vs the plain version, the float64 witness and
     the same samples padded to 256; reruns bit-identical.
 10. the hierarchical path through the CLI, per preset (hierarchical:
     two fields, 64 + 128 union; mipnerf: IPE, one field, 64 + 128
     standalone): `train` for 51 steps at full width (exactly 2 K2
     launches per step, K1 for the eval), `render --view 0` at 800x800
     and `eval --max_views 2` on the checkpoint (2 K1 launches per chunk).
     (Each path's 64x64 learning drives run in phase 28.)
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
     (ragged); two forward and two backward launches bit-identical. The
     backward also vs its float64 witness (the plain version's rounded
     operands, float64 sums; the plain version's own gap is printed), on
     the step's points shuffled, on FAC_NONE under bf16 and f32 (a per-axis
     table larger than a CTA's shared memory, which the f32 scatter takes
     in tiles of levels), and once under
     torch.cuda.set_sync_debug_mode("error"); then the geometries past
     K3's former caps (FAC_WIDE: 20 levels, and 6 levels x 192 channels),
     forward and backward under bf16 and f32 lines on a train step's
     points, against the plain versions and the witness, reruns
     bit-identical, and beside the JAX kernel's dense hat product
     (check_dense_form: d_lines within the bound of the d_feat elements
     that its other order of sums rounds differently).
 13. the factored path (FACTORED_CONFIG: the bench's factored window,
     128x128 sphere, 4096 rays x 128 samples, mixed, lr 1e-2, with
     fac_fused on): train/loop.train for FAC_STEPS steps (exactly one K3
     forward per step and per eval chunk, one backward per step), an
     800x800 render_frame (20 chunks, 20 forwards; its first chunk held to
     the plain route) and an eval of 2 views; `cli train/eval/render
     --preset factored`, whose route is the dense-hat encode (0 K3
     launches, as in the JAX CLI).
 14. times: the factored step through K3 and through the CLI's route, a
     profile of the K3 step (device idle), K3's forward and backward at
     524,288 points (the forward with bf16 and with f32 lines, the
     backward with bf16 lines on ray-ordered and on shuffled points and
     with f32 lines; the backward's device time split into kernel A, the
     d_feat kernel, kernel B, the scatter, and the reduce) and its forward
     at a 4,194,304-point render chunk, and its bf16 forward and backward at
     FAC_WIDE's geometries, and forward and backward under bf16
     and f32 lines at FAC_CORNERS' (100 levels x 16; one level of 60,001
     knots x 4) on CORNER_RAYS rays' points, each beside its plain version,
     a PyTorch library path (F.embedding_bag over the 2L taps per axis, and
     its autograd) and its bound.
 15. K4, the row gather (gather_rows, gather_pairs), vs its plain versions,
     bit for bit, on the indices of an ngp train step (4096 rays x 128
     jittered samples, every 8th point past the AABB) captured from the
     encodes: gather_rows on the (131,072, 128) brick table at a sub-chunk's
     2,097,152 rows, at a ragged N and with repeated rows; gather_pairs on
     the flat table at the step's 67,108,864 pairs, and once more under
     torch.cuda.set_sync_debug_mode("error") (no host synchronisation);
     the hash grid's fixed-order table gradient (scatter_rows) at the
     step's fetches, in both layouts and in the flat one with keys outside
     the table, bit-equal to its plain version and across launches, and
     once more under set_sync_debug_mode("error").
 16. the hash-grid path through the CLI, for `--preset ngp` (brick) and
     with `--hash_brick false` (flat): `train` for NGP_STEPS steps at full
     width (4 gather_rows or 1 gather_pairs per step, and the eval at step
     50), `render --view 0` at 800x800 (625 gather_rows, or 157
     gather_pairs) and `eval --max_views 2`, each with its exact K4 launch
     count; the frame's first chunk from the trained weights through K4 and
     through the plain route, bit for bit.
 17. times: each layout's step (best of 3 windows) with a profile's device
     idle share, each layout's 800x800 frame, and K4's two calls at the
     main path's shapes beside their plain versions, torch.index_select and
     their bounds; scatter_rows at a brick sub-chunk's and a flat step's
     fetches, timed beside index_add_ and beside PyTorch's deterministic
     route (index_put_ with accumulate=True under
     torch.use_deterministic_algorithms), which the port never calls, with
     its device time split into the sort and the reduce.
 18. the unbounded-scene branches of K1 and K2 at the flagship width, vs
     their plain versions (K2 also vs the float64 witness and autograd, two
     launches bit-identical; diag slot 5 vs ops/render.distortion_loss) on
     the 4,103 rays of phase 3 with samples over [0.3, 60]: the
     contraction under PE and IPE, the distortion loss in linear and in
     disparity space (with exact IPE lengths), S = 64, 150, 192 and 193.
 19. the unbounded path through the CLI, per preset (unbounded: mip-NeRF
     360's contraction, disparity spacing, a 2-level annealed proposal and
     the distortion loss; proposal: a proposal net picks 128 samples):
     `train` for UNB_STEPS steps at full width (exactly 1 K2 launch per step,
     1 K1 launch for the eval at step 50), `render --view 0` at 800x800 (3
     or 5 K1 chunks) and `eval --max_views 2`.
 20. times: each preset's step through K2 and through autograd, its 800x800
     frame through K1 (its first rays held to the plain route), a profile of
     the unbounded K2 step; the new cases' kernel calls at the presets'
     shapes (a whole K1 chunk, K2's 4096-ray call), each held to its plain
     version and timed against it, a PyTorch library path and the bound.
 21. the record path through the CLI (`--preset record`: IPE, one shared
     field, the 64 + 128 union of 193 intervals, coarse edges from a 32^3
     occupancy grid): `train` for PRESET_STEPS steps at full width (exactly
     2 K2 launches a step, 2 K1 for the eval), the grid updated after steps
     0, 16, 32 and 48 and non-zero in the checkpoint, `render --view 0` at
     800x800 (20 K1 launches) and `eval --max_views 2` (4), then a resume
     for REC_RESUME steps that keeps the restored grid.
 22. multiscale through the CLI: `train --preset mipnerf --multiscale_levels
     4` for PRESET_STEPS steps (2 K2 launches a step), `eval --scales
     1,2,4,8 --max_views 2` on its checkpoint (16 K1 launches, a finite mean
     PSNR at each scale and the multiscale mean).
 23. times: K1 and K2 at the record shapes (a whole K1 chunk of 65,536 rays
     x 193 IPE intervals, K2's 4096-ray union call and its 64-interval
     coarse call), each held to its plain version (K2 also to the float64
     witness) and timed beside it, the library path and the bound (counting
     193 rows a ray, not the 256 the kernels pad to); the record step
     through K2 and through autograd with a profile's device idle share,
     its 800x800 frame through K1 on a grid. (K3's forward and backward at
     FAC_WIDE's geometries are timed in phase 14, with the preset's.)
 24. procedural scenes written by the port on the card: `python -m
     nerf_rs_tpu_torch.tools.make_scene` of the lego at SCENE_FLAGS (100x100,
     20 + 2 + 4 views, 256 samples) and LEGO64_FLAGS (64x64), each timed, their
     test splits loaded back; a 32x32 gold view integrated on the card against
     the CPU's (GOLD_TOL at GOLD_SHARE of the values, GOLD_EDGE at all).
 25. `--dataset blender` through the CLI (c2w rays, the lego's [2, 6]):
     `--preset full` and `--preset record` train for BLENDER_STEPS steps (1 or
     2 K2 launches a step, an eval at step 10 through K1), `eval --split
     test` (4 views) and `render --view 0`, exact K1 counts, finite PSNRs.
 26. the host pipeline (`--batch_mode host --use_native_loader true`, two
     workers; the port's C++ gather built from its own source) through K2,
     and `--preset pod` (error-weighted resampling, the train kernel) for
     HOST_STEPS steps, its checkpoint's `.err.npy` store moved off its start,
     and a resume that reads it back.
 27. `--dataset llff --ndc true` on tests/data/llff_mini and `--dataset
     multiview_png` on 12 sphere views written as image-{i}.png in multiview
     batches: train, eval and render through K1 and K2 with exact counts.
 28. the learning drives, LEARN_WORKERS processes at once (spawned after
     the build; one drive's host work overlaps another's kernels): per
     path and seed a 64x64 drive of 301 steps at 1024 rays, then `cli
     eval` of its checkpoint over LEARN_VIEWS views, with the path's exact
     launch count in the drive;
     the mean over seeds of the mean PSNR must pass the path's bar:
     hierarchical and mipnerf (LEARN_SEEDS, PRESET_PSNR), factored through
     K3 (train/loop.train with fac_fused, FAC_PSNR), ngp through K4
     (NGP_PSNR), unbounded and proposal (UNB_PSNR, PROP_PSNR; proposal with
     softplus density), record (REC_SEEDS, REC_PSNR), multiscale mipnerf
     (MS_PSNR) and record on the 64x64 lego (LEGO_SEEDS, its 4 test views,
     LEGO_PSNR). Beside them fault 6's drive (FAULT6: proposal, relu, seed 2,
     301 steps from one start and the same draws through K2, through K2's
     plain version in its place and through autograd); K2 and its plain
     version must end within FAULT6_MARGIN dB of each other.
 29. times: the full and record steps through K2 on the sphere at 100x100,
     and on the lego per ray and through the host pipeline, and each mode's
     batch alone.
 30. slice 7 (run after phase 27): `train --preset full --ema_decay 0.999`
     for EMA_STEPS steps at 4096 x 64 (K2 exactly once a step), its EMA
     against the host's f32 recurrence from the weights of every step
     (EMA_TOL), a --profile_steps window whose Chrome trace names K2's
     train_narrow_kernel, a logging step's events; a resume of EMA_RESUME steps
     whose EMA keeps averaging from the restored one; `eval --max_views 2`
     and `render --depth --gif --frames 4` at 800x800 on the EMA weights (K1
     launches by the chunk plan; frame 0's depth PNG, decoded by the port,
     within 1 LSB of render_frame's depth / far; the GIF's 4 frames of
     800x800 by the port's header walk); `export --mesh` at 128^3 at a
     threshold the field crosses (the .npz's shapes; the point cloud holds
     every cell above it, the mesh has faces); one `--accumulation_steps 4
     --raw_noise_std 1.0` step (autograd: no K2; finite weights), and four
     micro-batches' mean gradient against the one batch's (f32, ACC_TOL);
     then one line of times: the EMA step against the plain step
     (interleaved windows), the EMA update alone, the sweep, the export.
 31. slice 8 (run after phase 30): DP_RANKS ranks share the card over gloo
     (NCCL refuses two ranks on one card), spawned by the port's launcher,
     each counting its own launches: one flagship DP step over a given
     4096-ray batch (midpoint samples; 2048 rays a rank, K2 once a rank),
     whose reduced gradient must match one K2 call over all 4096 rays
     (KERNEL_TOL); DP_STEPS in-step steps of --preset full and POD_STEPS
     error-weighted steps of --preset pod through K2 (K2 once a step a
     rank), after which both ranks' weights, Adam state and error store
     must hash the same; each rank's pod drive again from the same start,
     which must end at the same loss and error store, and DRAW_CALLS calls of
     error_weighted_from_draws on the pod run's store with one set of draws,
     which must give one set of pixels (fault 11); the 800x800 frame in two blocks through K1 (2
     chunks a rank), equal to the one-process frame. Then `train --scenes
     sphere,flat_sphere` at 64x64 for MS_STEPS steps on the one card (a 1 x
     1 scene mesh; autograd: no K2; K1 for the per-scene evals), `eval` and
     `render --scene_index 1` (scene 1's view 0 PSNR equal to the
     training's last eval); and `train --num_devices 2` on the one card
     must exit non-zero naming its one card. Every phase runs on the first
     visible card (pin_first_card).
 32. slice 10 (run after phase 31): compat mode at the reference's width
     (8 x 100 trunk, 100 -> 50 -> 4 head), 84 rays x 64 samples, f32, on the
     128 x 128 sphere: `train --compat true` for COMPAT_STEPS steps and a
     resume of COMPAT_RESUME, `eval --max_views 2`, `render --view 0` and
     `render --use_fused_kernel true`, with every kernel counter at 0 on every
     path (the JAX package runs compat through XLA alone), finite losses, the
     radiance head's weights as they started; `export` refused naming compat,
     with no file written; one compat step on the card against the same step
     on the CPU (COMPAT_TOL; the head's gradient exactly 0); compat_predict
     against the reference's math in numpy (ORACLE_TOL); the compat step's
     time, best of 3 windows.
 33. rays past 256 samples and fields past K1's resident layouts (run
     after phase 18): K1 and K2 vs their plain versions (K2 also vs the
     float64 witness; at S = 300 also vs autograd) at the flagship width on
     the 4,103 rays at S = 257, 300, 384, 512 and 640 (257 and 300 pad to
     384: one ray a CTA in S / 128 passes; K1's streamed instance, K2's
     narrow one), on 64 rays at 2048, at S = 300 with IPE and with the
     contraction and the disparity distortion loss, at depth 21 (skip 4,
     softplus; at S = 192 K1 no longer fits its resident layout: the
     streamed instance with two rays a CTA spanning passes; under relu K2's
     gradients are held at DEEP_RELU_GRADS: see deep_relu) and with IPE at 16
     levels at S = 150 (K1 streamed); each kernel twice, bit-identical, and once at
     the padded S, whose pads' weights are 0 and whose other outputs equal
     the first call's bits; then one K2 call over 4096 x 512 (2,097,152
     rows: two launches of at most BLOCK_ROWS) against the same call in one
     launch (diag and weights bit for bit, the gradients at BLOCKED_TOL) and
     against its two blocks' rays called alone (diag and weights bit for bit,
     half the gradients' sum expected bit for bit, held at BLOCKED_TOL).
 34. the long-ray paths through the CLI (run after phase 32): `train
     --preset full --num_samples 300` and `train --preset hierarchical
     --num_fine_samples 256` (a union of 320) for LONG_STEPS steps each with
     exact K2 counts (ray_blocks' launches per call: two per 4096 x 384
     call), and `render --num_samples 300` of the flagship checkpoint at
     800x800 (one K1 launch per 32,768-ray chunk, 20).
 35. times of the long rays: K1 on a 32,768-ray chunk at S = 300 and 512,
     K2 on 4096 rays at S = 300 and 512 (two launches each), each against
     its plain version, its library path and its bound (time_branches,
     LONG_SHAPES); the train steps of phase 34's two configurations through
     K2 and autograd, with a profile of each K2 step.
 36. fields of any width (faults 13 and 14; run after phase 35): at every
     width of WIDTHS (40/40/24 and 100/100/50, padded to multiples of 16;
     384/384/128, 384/384/384 (a view head of two column blocks), 512/512/256
     and 1024/256/128, the cluster route: every
     check prints the route C took, routes), K1 and
     K2 vs their plain versions (K2 also vs the float64 witness) at S = 64
     (relu), 192 (IPE) and 300 (the contraction with the disparity
     distortion loss), random biases, reruns bit-identical, the padded S's
     call equal, exact launches (check_widths); at 512/512/256 and
     1024/256/128 (WIDE_RUNS) train/loop.train for WIDE_STEPS steps of
     `--preset full` through K2 (exactly one launch a step) and through
     autograd, each timed, the 800x800 frame from seeded weights through
     K1 twice (exact chunks, equal bits; its first rays held to the plain
     version) beside the eager field's (best of 2 each), the steps alone;
     at those widths and at 40/40/24 and 100/100/50 one K1 chunk and one K2
     call at the main path's shapes, each held whole to its plain version
     (K1 at TOL, K2 at KERNEL_TOL) and timed beside it, its library path and
     its bound, the K2 call's scratch bytes (drive_wide).
 37. the caps the JAX package never had, lifted (faults 15-17; run after
     phase 36): K1 and K2 at depth 130 (width 64, its trunk scaled to unit
     variance) and at the paper widths with pos_enc_levels 20 and 34 (K1's
     wide route: its scratch asked for exactly there; the routes printed), each against its
     plain versions and the float64 witness on the 4,103 rays (check_lifted);
     K3 at 300 levels forward and backward, bf16 and f32, against its plain
     versions and the witness (check_lifted_factored); train/loop.train of
     `--preset ngp --hash_brick false` at hash_features 8 (the CLI has no
     flag for it) and its 800x800 frame through gather_rows and scatter_rows
     with exact counts, one step at F = 40, and gather_rows
     and scatter_rows at F = 8 and 40 bit-equal to their plain versions and
     timed (drive_lifted_features); then the times: one K1 chunk and one K2
     call at pos_enc_levels 20 (width_calls) and K3 at 300 levels
     (time_k3_calls).
The record, multiscale and lego learning drives and fault 6's check fail the run at its end,
after phase 29 has printed its measurements. `clock:` lines give each
phase's wall seconds. Every kernel launch counter is set
to 0 just before the path it counts and read just after. The line before the last is one JSON object
describing the kernels (with each one's bound and a PyTorch library
call's time at the flagship shape); the last is {"ok": true, "device":
{...}}. A kernel's "ms" is one call alone, in a CUDA-event window of its
own (K4's gathers: per call in a window of GATHER_CALLS calls); K3's
forward and scatter_rows also give "ms_window", per call in a window of
back-to-back calls, where the host enqueues the next call while the card
runs this one.

    python3 chip_smoke.py --time-step ROOT

times the kernels in the checkout at ROOT instead, with the helpers above:
ptxas' report of every kernel instance, the flagship train step through
K2, autograd and the plain version, one flagship K2 call and K1 chunk,
every K1 and K2 call of phases 11 and 20 (K2 at S = 192 with 4096 rays
among them) and phase 35's K2 calls (300 and 512 samples, two blocks each)
beside its library path, each K2 call's device time split by kernel with
its K2b beside K2b's floor, and every K2 preset's train step through K2 and autograd
(TIMED_STEPS: hierarchical, mipnerf, unbounded, proposal, record, the
flagship at 300 samples), each K2 step profiled; then the
calls of phases 14 and 17: scatter_rows in both layouts (split into the
sort and the reduce), K4's gathers, the ngp steps and frames, the
factored step and K3's calls. Each K1 call also prints the bytes of
weights that it must read from L2 by the kernel's design and the rate that
implies: modelled, not measured. It also times the calls at 512/512/256
and 1024/256/128 (the wide route) and at the padded widths 40/40/24 and
100/100/50 (width_calls: one K1 chunk and one K2 call beside the eager
field and autograd, each K2 call split by kernel).

    python3 chip_smoke.py --dp-cards N

measures slice 8 across N cards over NCCL (a call with N cards): the
flagship DP step (4096 rays over the ranks, DP_WINDOW steps a window, best
of 3) and the 800x800 frame through the sharded renderer (best of 3), on one
card and on N, then `cli train --preset full --num_devices N` and `cli
render --num_devices N` of an 800x800 view once each, and prints one JSON
line of the times.

    python3 chip_smoke.py --trace-draws

traces fault 11 on one card: POD_STEPS error-weighted steps run twice from
one start through each running sum of the error store (torch.cumsum, the
scan before the repair, and fixed_order_cumsum), the first step and call at
which the runs part, and DRAW_CALLS calls of each scan, of
error_weighted_from_draws and of update_error_store on one store.

    python3 chip_smoke.py --learn PRESET SEEDS [FLAG ...]

runs the preset's 64x64 learning drive, as the learning checks run it, for
each of the comma-separated SEEDS with the extra CLI flags, and prints each
seed's mean PSNR (a diagnostic, with no bar).

    python3 chip_smoke.py --witness-steps PRESET SEED STEPS [FLAG ...]

runs that drive's first STEPS steps through K2 and through autograd from
the same start, each K2 launch held to its float64 witness (a diagnostic of
a drive that stalls through one route and not the other). To compare two
commits, unpack the other
into a git-ignored directory (`git archive`) and run both in one call on
one card, in turns, each checkout through its own script:

    for r in _scratch/parent . . _scratch/parent; do
        (cd $r && python3 chip_smoke.py --time-step .); done
"""

from __future__ import annotations

import contextlib
import dataclasses
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
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from typing import NamedTuple, Optional

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
# the learning drives run in LEARN_WORKERS processes at once (phase 28), each
# drive's host work overlapping the others' kernels
LEARN_WORKERS = 4
LEARN_VIEWS = 4
PRESET_PSNR = {"hierarchical": 15.77, "mipnerf": 20.0}
PRESETS = ("hierarchical", "mipnerf")
# the train steps --time-step times (each through K2 and autograd, the K2 step
# profiled for its device-idle share): every preset whose step runs K2, and
# the flagship recipe at 300 samples (two K2 blocks a step)
TIMED_STEPS = (("hierarchical", ()), ("mipnerf", ()), ("unbounded", ()), ("proposal", ()),
               ("record", ()), ("full", ("--num_samples", "300")))
PRESET_STEPS = 51
# ragged (not a multiple of the kernel's 2-ray tile), and more than the
# 4096 rays of a train step, so the branch checks cover its K2b splits
N_RAYS = 4103
FRAME = 800
CHUNK = 262144  # rays per K1 call of the flagship render path
PLAIN_CHUNK = 32768  # rays per call of the plain version (device memory)


class Shape(NamedTuple):
    """A kernel call on a main path, timed in time_branches."""

    kernel: str  # "K1" or "K2"
    case: str
    ipe: bool
    contract: bool
    space: Optional[str]  # the distortion loss's space, None: off
    rays: int
    samples: int
    near: float
    far: float
    white: bool  # K2's background


# the hierarchical branches' calls on the presets' main paths: a K1 chunk of
# the mipnerf fine pass and of the hierarchical union pass; K2 per train
# step (the flagship's PE call too)
BRANCH_SHAPES = tuple(Shape(k, c, ipe, False, None, n, s, 0.05, 2.0, True)
                      for k, c, ipe, n, s in (("K1", "IPE, S=128", True, 131072, 128),
                                              ("K1", "S=192", False, 65536, 192),
                                              ("K2", "S=64", False, 4096, 64),
                                              ("K2", "IPE, S=64", True, 4096, 64),
                                              ("K2", "IPE, S=128", True, 4096, 128),
                                              ("K2", "S=192", False, 4096, 192)))
KERNELS = ("fused_ray", "fused_train", "fused_factored", "gather_rows")  # csrc/{name}.cu
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
# The hash-grid path (phases 15-17): `--preset ngp` is the brick table, and
# `--hash_brick false` the flat one. The 64x64 learning drive (--preset ngp
# --num_samples 32, 1024 rays, lr 1e-2, 301 steps) must pass min(20 dB, the
# JAX package's own drives on the same flags and seeds on the CPU, less 1
# dB): those read 17.07 / 17.29 / 17.63 dB, mean 17.33 (PERF.md has the
# commands).
NGP_LAYOUTS = {"brick": (), "flat": ("--hash_brick", "false")}
NGP_STEPS = 51
# K4 launches per train step, per 128x128 eval view and per 800x800 frame, as
# the JAX chunking gives them: 2^17 points per gather_rows call, 32,768-ray
# (brick) or 4096-ray (flat) render chunks
NGP_K4 = {"brick": (4, 16, 625), "flat": (1, 4, 157)}
NGP_PSNR = 16.33
NGP_RAYS = 4096  # rays of a train step: 524,288 points at 128 samples
NGP_RAGGED = 100_003
GATHER_CALLS = 20  # K3 and K4 calls per timing window
# The unbounded-scene path (phases 18-20). The presets' 64x64 learning
# drives (--num_samples 32, 1024 rays, lr 1e-3, 301 steps, and UNB_LEARN_FLAGS)
# must pass min(20 dB, the JAX package's own drives on the same flags and
# seeds on the CPU, kernels off, less 1 dB); PERF.md has the commands and
# readings. The proposal preset's relu density drives with softplus: with relu,
# seed 2's draw stays near the transparent optimum through K2 at lr 1e-3 and
# 5e-4 (11.4 and 11.2 dB) and through K2's plain version (11.4) while autograd
# climbs out (19.2): the routes round at other points, and the plain version
# leaves KERNEL_TOL of the float64 witness as often as K2 does (ROADMAP Queue 3,
# fault 6); softplus keeps the density's gradient alive where relu's is 0, so
# the check measures learning, not the draw.
UNB_PRESETS = ("unbounded", "proposal")
UNB_LEARN_FLAGS = {"unbounded": (), "proposal": ("--sigma_activation", "softplus")}
UNB_PSNR = 20.0
PROP_PSNR = 17.55
UNB_STEPS = 51
# K1 launches per 800x800 frame: 262,144-ray chunks at 64 samples
# (unbounded), 131,072 at 128 (proposal)
UNB_FRAME_K1 = {"unbounded": 3, "proposal": 5}
UNB_NEAR, UNB_FAR = 0.3, 60.0  # the unbounded preset's range
# (name, ipe, contract, distortion space or None, samples) of phase 18's
# checks on the N_RAYS rays, samples over [UNB_NEAR, UNB_FAR]
UNB_BRANCHES = (("PE + contract, S=64", False, True, None, 64),
                ("IPE + contract, S=64", True, True, None, 64),
                ("distortion linear, S=128", False, False, "linear", 128),
                ("contract + distortion disparity, S=64", False, True, "disparity", 64),
                ("IPE + contract + distortion disparity, S=64", True, True, "disparity", 64),
                ("contract + distortion disparity, S=192", False, True, "disparity", 192),
                ("IPE + contract + distortion disparity, S=150", True, True, "disparity", 150),
                ("IPE + distortion disparity, S=193", True, False, "disparity", 193))
# the presets' main-path calls: a K1 frame chunk and K2 per train step, with
# the presets' ranges and backgrounds
UNB_SHAPES = (Shape("K1", "PE + contract, S=64 (unbounded chunk)", False, True, None, 262144,
                    64, UNB_NEAR, UNB_FAR, False),
              Shape("K1", "PE, S=128 (proposal chunk)", False, False, None, 131072, 128, 0.05,
                    2.0, True),
              Shape("K2", "PE + contract + distortion disparity, S=64 (unbounded step)", False,
                    True, "disparity", 4096, 64, UNB_NEAR, UNB_FAR, False),
              Shape("K2", "PE, S=128 (proposal step)", False, False, None, 4096, 128, 0.05, 2.0,
                    True))
UNB_DIST = 0.01  # the unbounded preset's distortion weight
# The record preset (phases 21 and 23): IPE, one shared field, the union
# pass of 65 + 129 edges = 193 intervals (padded to 256 rows a ray in the
# kernels), coarse edges from a 32^3 occupancy grid updated every
# REC_GRID_EVERY steps; a render chunk is 65,536 rays. Multiscale
# (phase 22): the mipnerf preset on a 4-level pyramid, evaluated at 1, 2, 4
# and 8. The 64x64 learning drives (--num_samples 32 --num_fine_samples 64,
# 1024 rays, lr 1e-3, 301 steps; the multiscale one with
# --multiscale_levels 4) must pass min(20 dB, the JAX package's own drives
# with the same flags and seeds on the CPU, kernels off, less 1 dB); PERF.md
# has the commands and each seed's reading. The multiscale drives read
# 19.50 / 19.80 / 19.45 dB, mean 19.58 (seeds LEARN_SEEDS; the record drive's
# seeds are REC_SEEDS, below).
REC_GRID_EVERY = 16
REC_RESUME = 4  # steps of the resume
MS_FLAGS = ("--multiscale_levels", "4")
MS_SCALES = (1, 2, 4, 8)
REC_PSNR = 20.0
MS_PSNR = 18.58
# The record drive runs ten seeds, and its bar comes from the JAX package's
# drives on the same ten: at lr 1e-3 some starts of this preset go
# transparent at the first Adam update and recover slowly in both packages
# (tests/torch_record_pair.py drives both from one start on one stream of
# draws: the same trajectory, slow or not), so the mean of three seeds
# measures which starts are slow, not the port. The JAX drives of seeds 0-9
# read 21.76 / 21.66 / 22.89 / 21.50 / 21.91 / 21.13 / 20.70 / 22.13 /
# 21.87 / 22.12 dB, mean 21.77: REC_PSNR = min(20, 21.77 - 1).
REC_SEEDS = tuple(range(10))
# the record preset's kernel calls: a whole K1 chunk of the union pass and
# K2's 4096-ray union call, IPE at 193 intervals (white background), and the
# coarse pass's 64-interval call
RECORD_SHAPES = (Shape("K1", "IPE, S=193 (record union chunk)", True, False, None, 65536, 193,
                       0.05, 2.0, True),
                 Shape("K2", "IPE, S=193 (record union step)", True, False, None, 4096, 193,
                       0.05, 2.0, True),
                 Shape("K2", "IPE, S=64 (record coarse step)", True, False, None, 4096, 64,
                       0.05, 2.0, True))

# The datasets and the host pipeline (phases 24-29): the port's make-scene
# writes procedural lego scenes on the card (SCENE_FLAGS, and LEGO64_FLAGS for
# the learning drive); `--dataset blender` trains (BLENDER_STEPS steps),
# evaluates its test split and renders a view through K1 and K2 with exact
# counts in `--preset full` and `--preset record`; the host pipeline through
# the port's C++ gather and `--preset pod` (error-weighted resampling; the
# train kernel asked for) with a resume that reads its error store back; LLFF
# on tests/data/llff_mini with --ndc and the multiview PNG layout on sphere
# views written here, in multiview batches. The 64x64 learning drive of
# --preset record on the 64x64 lego (--num_samples 32 --num_fine_samples 64,
# 1024 rays, lr 1e-3, 301 steps, `cli eval` over its 4 test views) must pass
# LEGO_PSNR = min(20 dB, the JAX package's own drives on the same flags, seeds
# and scene on the CPU, less 1 dB); PERF.md has the commands and readings.
SCENE_FLAGS = ("--size", "100", "--n_train", "20", "--n_val", "2", "--n_test", "4",
               "--num_samples", "256")
LEGO64_FLAGS = ("--size", "64", "--n_train", "20", "--n_val", "2", "--n_test", "4",
                "--num_samples", "256")
BLENDER_STEPS = 11
# the procedural lego's cameras sit 4.03 from its centre: rays sample [2, 6]
LEGO_DATA = ("--dataset", "blender", "--near", "2", "--far", "6")
BLENDER_PRESETS = ("full", "record")
# phase 29's timing windows of 10 steps per preset: the record step (~40 ms)
# reads within 1% in one window
DATA_WINDOWS = {"full": 3, "record": 1}
LEGO_SEEDS = (0, 1, 2)
# the JAX drives of seeds 0-2 on the 64x64 lego (--near 2 --far 6) read 23.99 /
# 23.54 / 23.82 dB, mean 23.78: LEGO_PSNR = min(20, 23.78 - 1)
LEGO_PSNR = 20.0
# a gold frame integrated on the card against the CPU's: f32 sums of 64
# samples whose transcendentals round apart by an ulp or two, at GOLD_SHARE of
# the frame's values; at the rest a texture's checker or a primitive's edge
# falls on the other side of a sample on one device (up to GOLD_EDGE)
GOLD_TOL = 1e-4
GOLD_SHARE = 0.98
GOLD_EDGE = 0.25
HOST_STEPS = 6
LLFF_MINI = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "data", "llff_mini")
# phase 30 (slice 7) on the flagship preset: the EMA drive (4096 rays x 64
# samples, K2 once a step) with a profiler window over steps 10-12 and a
# logging step, its resume, the eval and the 800x800 sweep with --depth --gif
# on its EMA weights, export --mesh at 128^3, and an accumulated noisy step
EMA_ARGS = ("--preset", "full", "--dataset", "sphere", "--ema_decay", "0.999")
EMA_STEPS = 50
EMA_RESUME = 5
# the EMA on the card against the host's f32 recurrence from the same
# weights (the same operations in the same order), relative to each leaf's
# largest entry
EMA_TOL = 1e-6
PROFILE_STEPS = 3
SWEEP_FRAMES = 4
EXPORT_RES = 128
EMA_WINDOW = 20  # steps per timing window of the EMA step and the plain step
# four micro-batches' mean gradient against the one batch's, f32 field at the
# preset's widths: the summation order of 4,096 rays' sums only
ACC_TOL = 1e-4
# K3 at the corners fault 7 lifted (tests/test_torch_cuda.py's FAC_CORNERS),
# timed on the points of CORNER_RAYS sphere rays (128 samples each)
FAC_CORNERS = {"levels 100": dict(arch="factored", fac_levels=100, fac_comps=16),
               "60,001 knots": dict(arch="factored", fac_levels=1, fac_base_res=60000,
                                    fac_comps=4)}
CORNER_RAYS = 1024
# fault 6 (ROADMAP Queue 3 item 6): the proposal preset's relu drive on seed 2,
# 301 steps from one start and the same draws through K2, through K2's plain
# version in its place and through autograd; K2 and its plain version must
# end within FAULT6_MARGIN dB of each other: 16x the 0.030 dB they part by,
# 1/15 of the 7.7 dB by which a route that leaves the plateau (autograd) parts
FAULT6 = ("proposal", "2", "301", ("--sigma_activation", "relu"))
FAULT6_MARGIN = 0.5
# phase 31 (slice 8): two ranks share the card over gloo (NCCL refuses two
# ranks on one card): the flagship's DP step (4096 rays, 2048 a rank, K2
# once a step a rank) for DP_STEPS steps, --preset pod's error-weighted step
# through K2 for POD_STEPS, the 800x800 frame in two blocks through K1; then
# multi-scene training through the CLI on the one card (a 1 x 1 scene mesh)
DP_RANKS = 2
DP_STEPS = 50
POD_STEPS = 20
POD_ARGS = ("--preset", "pod", "--dataset", "sphere", "--use_whole_ray_train", "true")
# fault 11 (ROADMAP Queue 3 item 11): the pod drive runs twice from one start
# in each rank and must end at the same loss and error store, and
# error_weighted_from_draws on the pod run's store (84 views x 128 x 128 =
# 1,376,256 pixels) with one set of draws gives the same pixels DRAW_CALLS times
DRAW_CALLS = 100
MS_SCENES = "sphere,flat_sphere"
MS_ARGS = ("--scenes", MS_SCENES, "--width", "64", "--height", "64", "--num_rays", "1024")
MS_STEPS = 200
MS_EVAL_EVERY = 100
# phase 32 (slice 10): compat mode, the reference's committed math at its own
# width (8 x 100 trunk, 100 -> 50 -> 4 head) on the 128 x 128 sphere, 84 rays x
# 64 samples, f32, through autograd and the eager field, as the JAX package runs
# it: no kernel launches on any of its paths
COMPAT_ARGS = ("--compat", "true", "--dataset", "sphere", "--num_rays", "84",
               "--precision", "f32")
COMPAT_STEPS = 200
COMPAT_RESUME = 5
# the card's compat step against the CPU's from the same weights and batch
# (midpoint samples, f32 without TF32: the same sums over 5,376 points in
# another order): the loss relative to itself, each gradient leaf relative to
# its largest entry
COMPAT_TOL = {"loss": 1e-5, "grads": 1e-4}
# compat_predict against the reference's math in numpy (tests/test_compat.py's bar)
ORACLE_TOL = 1e-4
COMPAT_WINDOW = 20  # compat steps a timing window
# --dp-cards N: windows of DP_WINDOW flagship steps (best of 3) and of one
# 800x800 frame, on one card and on N over NCCL, in one call
DP_WINDOW = 20


# checks whose failure fails the run at its end, after every later phase has
# run and printed its measurements (the learning drives of phases 21 and 22)
DEFERRED = []


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


def timed_call(fn) -> tuple:
    """``fn()``'s result and its wall seconds, fenced by synchronize: a
    check's call timed once (for plain versions of a second or more)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


_LAP = [0.0]


def lap(label: str) -> None:
    """Prints the wall seconds since the last lap (main's phases, each
    against the run's time limit)."""
    now = time.perf_counter()
    print(f"clock: {label} {now - _LAP[0]:.1f} s")
    _LAP[0] = now


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


def per_call_ms(fn, calls: int, reps: int = 3) -> float:
    """Device time of one call of ``fn`` in a window of ``calls`` calls
    back to back (best of ``reps`` CUDA-event windows): the host enqueues
    the next call while the card runs this one, as on a main path."""
    def loop():
        for _ in range(calls):
            fn()
    return event_ms(loop, reps) / calls


def ptxas_report(name: str, lib) -> dict:
    """One line per kernel of a built library from its ptxas log
    (kernels/build.py keeps it): registers, spill stores and loads, and
    static shared memory, and whether ptxas serialized its wgmma. Returns
    {instance: (registers, spill store bytes, spill load bytes, wgmma
    serialized)} in the log's order."""
    entry, spills, report, serial, spill_b = None, "", {}, set(), (0, 0)
    for line in lib.with_suffix(".log").read_text().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(r"([a-z][a-z_]*kernel)(I.*?EE)?", m.group(1))
            args = re.findall(r"L[a-z](\d+)E", k.group(2) or "") if k else []
            entry = (k.group(1) if k else m.group(1)) + (f"<{','.join(args)}>" if args else "")
            spills, spill_b = "", (0, 0)
            continue
        m = re.search(r"wgmma.mma_async instructions are serialized due to (.*) in the function "
                      r"'\S*?([a-z][a-z_]*kernel)(I(.*?)EEvN)?", line)
        if m:  # named as the entries are: a template's arguments in <>, else the name alone
            args = re.findall(r"L[a-z](\d+)E", (m.group(4) or "") + "E")
            serial.add(m.group(2) + (f"<{','.join(args)}>" if args else ""))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and entry:
            spills = f"spill stores {m.group(1)} B, spill loads {m.group(2)} B"
            spill_b = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers(.*)", line)
        if m and entry:
            smem = re.search(r"(\d+) bytes smem", line)
            print(f"ptxas [{name}] {entry}: {m.group(1)} registers, {spills or 'no spills'}, "
                  f"static smem {smem.group(1) if smem else 0} B"
                  + (", wgmma serialized" if entry in serial else ""))
            report[entry] = (int(m.group(1)), *spill_b, entry in serial)
            entry = None
    return report


def run_cli(argv) -> tuple:
    """(rc, stdout) of one port CLI call; the output is printed too."""
    from nerf_rs_tpu_torch import cli

    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        rc = cli.main(argv)
    print(log.getvalue().rstrip())
    return rc, log.getvalue()


def kernel_counts() -> dict:
    """Every kernel wrapper's launch count."""
    from nerf_rs_tpu_torch.kernels import fused_factored as k3, gather_rows as k4
    from nerf_rs_tpu_torch.kernels.fused_ray import fused_ray_render
    from nerf_rs_tpu_torch.kernels.fused_train import fused_train_grads

    return {"K1": fused_ray_render.launches, "K2": fused_train_grads.launches,
            "K3": k3.fused_factored_encode.launches,
            "K3 backward": k3.fused_factored_encode_backward.launches,
            "gather_rows": k4.gather_rows.launches, "gather_pairs": k4.gather_pairs.launches,
            "scatter_rows": k4.scatter_rows.launches}


def reset_counts() -> None:
    from nerf_rs_tpu_torch.kernels import fused_factored as k3, gather_rows as k4
    from nerf_rs_tpu_torch.kernels.fused_ray import fused_ray_render
    from nerf_rs_tpu_torch.kernels.fused_train import fused_train_grads

    for fn in (fused_ray_render, fused_train_grads, k3.fused_factored_encode,
               k3.fused_factored_encode_backward, k4.gather_rows, k4.gather_pairs,
               k4.scatter_rows):
        fn.launches = 0


def learn_worker_init() -> None:
    """A learning pool process: main's matmul settings, the port and its
    kernels loaded (built by main before the pool starts), the card up."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from nerf_rs_tpu_torch import cli  # noqa: F401
    from nerf_rs_tpu_torch.kernels import build

    for name in KERNELS:
        build.load(name)
    torch.zeros(1, device="cuda")


def drive_seed(calls) -> list:
    """One learning drive's calls, in a learning pool process: each
    ("cli", argv) one `cli.main`, each ("factored", flags) train/loop.train
    of `--preset factored` with those flags and fac_fused on (through K3).
    Per call (rc, its stdout, kernel_counts()), every count set to 0 before
    it."""
    import dataclasses

    import torch

    from nerf_rs_tpu_torch import cli
    from nerf_rs_tpu_torch.data.factory import make_dataset
    from nerf_rs_tpu_torch.train.loop import train

    out = []
    for kind, arg in calls:
        reset_counts()
        log = io.StringIO()
        with contextlib.redirect_stdout(log):
            if kind == "cli":
                rc = cli.main(arg)
            else:
                cfg = preset_cfg("factored", *arg)
                cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model,
                                                                         fac_fused=True))
                train(cfg, make_dataset(cfg, torch.device("cuda")))
                rc = 0
        out.append((rc, log.getvalue(), kernel_counts()))
    return out


def start_learning_pool() -> tuple:
    """LEARN_WORKERS spawned processes for the learning drives, each
    started at once by a warm-up task so that their start-up overlaps
    main's checks. Returns the pool and the warm-up tasks."""
    import multiprocessing

    pool = ProcessPoolExecutor(LEARN_WORKERS, mp_context=multiprocessing.get_context("spawn"),
                               initializer=learn_worker_init)
    return pool, [pool.submit(time.sleep, 1.0) for _ in range(LEARN_WORKERS)]


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


def k1_tol(far: float) -> dict:
    """TOL with the depth bar scaled to the sample range: depth = sum w t,
    so a weight's difference moves it by up to t (TOL's 2e-3 is at the
    sphere scene's far = 2)."""
    return {**TOL, "depth": TOL["depth"] * max(1.0, far / 2.0)}


def k2_outs(tg) -> tuple:
    return (tg.diag, tg.weights, *tg.dw, *tg.db)


def k2_errs(label: str, got, want) -> dict:
    """K2 against a plain version (f32, or the float64 witness) at
    KERNEL_TOL's keys; fails on a non-finite kernel output."""
    import torch

    if not all(bool(torch.isfinite(t).all()) for t in k2_outs(got)):
        fail(f"{label}: non-finite outputs")
    return {
        "diag": float((got.diag[:, :6].double() - want.diag[:, :6]).abs().max()),
        "weights": float((got.weights.double() - want.weights).abs().max()),
        "grads": max(leaf_err(a.double(), b) for a, b in zip(got.dw + got.db,
                                                              want.dw + want.db)),
    }


def k2_abs(got, want) -> float:
    """The largest absolute difference over all of K2's outputs."""
    return max(float((a - b).abs().max()) for a, b in zip(k2_outs(got), k2_outs(want)))


def check_train_kernel(model, mcfg, rays, ts, gold, far) -> float:
    """K2 against its plain version, the float64 witness and autograd of
    the eager path, at the flagship width, on the narrow instance (the
    route C takes up to 256 wide); two launches bit-identical. Returns the
    largest absolute difference from the plain version."""
    import dataclasses

    import torch

    from nerf_rs_tpu_torch.kernels import fused_train
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
        if fused_train.route(pk, S) != "narrow wgmma":
            fail(f"K2 [{case}]: route {fused_train.route(pk, S)}, want the narrow instance")
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


def check_dw_stashes(label: str, model, mcfg, rays, ts, dl, gold) -> float:
    """K2b alone: one K2 call through a scratch of the caller's, then every
    job's dW (and its bias sums from ``bias_col0`` on) against the float64
    product A^T G (sum_rows G) of the stashes K2a left there
    (fused_train.stash_views), each leaf relative to its largest entry, at
    DW_TOL. Prints and returns the largest gap."""
    import torch

    from nerf_rs_tpu_torch.kernels import fused_train
    from nerf_rs_tpu_torch.kernels.fused_ray import padded_samples
    from nerf_rs_tpu_torch.kernels.fused_render import pack_weights, pack_weights_t

    pk = pack_weights(model, mcfg)
    n, s = ts.shape
    S = padded_samples(s)
    total = pk.w.numel() + pk.b.numel()
    nbytes = fused_train._library().nerf_fused_train_scratch_bytes(
        n, S, pk.depth, pk.W, pk.F, pk.V, pk.P, pk.D, total)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=ts.device)
    got = fused_train.fused_train_grads(pk, pack_weights_t(pk), *rays, ts, dl, gold, mcfg, s,
                                        scratch=scratch)
    views = fused_train.stash_views(scratch, pk, n, s)

    def stash(name, layer):
        t = views[name]
        return (t[layer] if t.dim() == 3 else t)[:views["rows"]].double()

    def gap(a, b):
        return float((a.double() - b).abs().max()) / max(float(b.abs().max()), 1e-30)

    worst, worst_bias = 0.0, 0.0
    for job in fused_train.dw_jobs(pk):
        g = stash(job.g, job.g_layer)
        worst = max(worst, gap(got.dw[pk.w_off.index(job.out)],
                               stash(job.a, job.a_layer).t() @ g))
        if job.bias_out >= 0:
            db = got.db[pk.b_off.index(job.bias_out - pk.w.numel())]
            worst_bias = max(worst_bias, gap(db[job.bias_col0:job.N], g[:, job.bias_col0:].sum(0)))
    print(f"K2b alone [{label}]: dW within {worst:.3g} and the bias sums within "
          f"{worst_bias:.3g} of the float64 product of its stashes (bar "
          f"{fused_train.DW_TOL:g}; {len(fused_train.dw_jobs(pk))} jobs, {views['rows']} rows)")
    if max(worst, worst_bias) > fused_train.DW_TOL:
        fail(f"K2b alone [{label}]: {max(worst, worst_bias):.3g} from the float64 product of "
             "its stashes")
    return max(worst, worst_bias)


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


def kernel_name(key: str) -> str:
    """A profiler key's kernel name with its template arguments
    ("train_narrow_kernel<false>"), or the key's first 60 characters."""
    m = re.search(r"(\w+kernel)(<[^()]*>)?", key)
    return m.group(1) + (m.group(2) or "") if m else key[:60]


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


PROFILE_FLOOR = 0.85  # least share of a call's event time that its profile must hold
NOT_PROFILED = "not measured (the profile lost kernels' events)"


def profiled_split(fn, calls: int, window_ms: float, bound: float):
    """Device time in ms by kernel name of one call of ``fn``, from a
    torch.profiler run of ``calls`` calls back to back; or None (not
    measured) where the profile lost kernels' events, as it does late in a
    long run: where its total is below the call's bound, or below
    PROFILE_FLOOR of ``window_ms``, the call's own device time in a
    CUDA-event window (where the card sets the pace the two agree)."""
    import torch

    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    per = {k: v / calls for k, v in device_ms(prof).items()}
    total = sum(per.values())
    return per if total >= max(bound, PROFILE_FLOOR * window_ms) else None


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
    per = profiled_split(lambda: fused_train_grads(*k2_args), 5, k2_ms, 0.0)
    b2, by2, nb2 = k2b_floor(pk, samples)
    k2b = None
    if per is None:
        split = f"device time {NOT_PROFILED}"
    else:
        k2a = sum(v for k, v in per.items() if re.search(r"train_\w*kernel", k))
        k2b = sum(v for k, v in per.items() if re.search(K2B_KERNELS, k))
        split = (f"device time K2a {k2a:.3f} ms, K2b {k2b:.3f} ms ("
                 + ", ".join(f"{kernel_name(k)} {v:.3f}" for k, v in
                             sorted(per.items(), key=lambda kv: -kv[1])) + ")")
    print(f"one K2 call, 4096 x 64 [{card}]: {k2_ms:.3f} ms (CUDA events), plain version "
          f"{plain_ms:.3f} ms; {split}; K2b's floor {b2:.3f} ms ({by2}: {nb2 / 1e9:.3f} GB, the "
          "stashes read once and the gradient written once)")

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
    return {"k2_ms": k2_ms, "plain_ms": plain_ms, "k2b_ms": k2b, "k2b_bound_ms": b2}


def sample_inputs(n, s, ipe, cam, gen, near=None, far=None, space="linear"):
    """Jittered samples of ``n`` rays over [near, far] (by default the
    camera's), even in t or in disparity: (ts, deltas, edges, radii). With
    ``ipe``, ts are the midpoints of s intervals between s + 1 edges,
    deltas their exact lengths, radii the camera's cone radius per ray;
    else ts are s stratified samples and edges and radii are None."""
    import torch

    from nerf_rs_tpu_torch.ops import sampling

    dev = gen.device
    near = cam.near if near is None else near
    far = cam.far if far is None else far
    if not ipe:
        ts = sampling.stratified_ts(n, s, near, far, True, generator=gen, device=dev, space=space)
        return ts, sampling.deltas_from_ts(ts, far), None, None
    edges = sampling.stratified_ts(n, s + 1, near, far, True, generator=gen, device=dev,
                                   space=space)
    return ((0.5 * (edges[:, 1:] + edges[:, :-1])).contiguous(),
            (edges[:, 1:] - edges[:, :-1]).contiguous(), edges,
            torch.full((n,), sampling.pixel_radius(cam), device=dev))


def branch_inputs(cam, dev):
    """Inputs of the branch checks on the N_RAYS rays: (name, ipe, S, ts
    or interval midpoints, deltas, radii) for IPE at the mipnerf passes'
    64 and 128 intervals and at the record preset's union of 193, and rays
    of 192 and 193 point samples (the hierarchical union pass)."""
    gen = torch_generator(dev, 5)
    out = []
    for name, ipe, s in (("IPE relu, S=64", True, 64), ("IPE softplus, S=128", True, 128),
                         ("S=192 relu", False, 192), ("S=193 softplus", False, 193),
                         ("IPE softplus, S=193 (record union)", True, 193)):
        ts, dl, _, radii = sample_inputs(N_RAYS, s, ipe, cam, gen)
        out.append((name, ipe, s, ts, dl, radii))
    return out


def torch_generator(dev, seed):
    import torch

    return torch.Generator(device=dev).manual_seed(seed)


def random_biases_(model, seed: int, scale: float = 0.1):
    """Every bias of ``model`` (its parameters named ``b``) drawn from
    N(0, scale^2) with numpy from ``seed``, in place: init_nerf_params'
    biases are all zero, and a kernel that left one out would still agree
    with its plain version on them."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.rsplit(".", 1)[-1] == "b":
                p.copy_(torch.from_numpy(rng.normal(0.0, scale, tuple(p.shape))
                                         .astype(np.float32)))
    return model


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


def want_narrow(pk, S: int, label: str) -> None:
    """Fails unless K2a takes its narrow instance ("narrow wgmma", C
    train_mode) for ``pk`` at S, as every field up to 256 wide does."""
    from nerf_rs_tpu_torch.kernels import fused_train

    got = fused_train.route(pk, S)
    if max(pk.widths) <= 256 and got != "narrow wgmma":
        fail(f"{label}: K2a takes the {got} route, want the narrow instance")


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
        want_narrow(pk, s, f"K2 [{name}]")
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


def check_union_rows(model, mcfg, rays, gold, cam) -> float:
    """K2 at S = 150, 191 and 192, which the wrapper runs as 192 (two rays
    a CTA, three 128-row passes), on the N_RAYS rays (ragged: the last CTA
    holds one ray) at the flagship width: against its plain version and the
    float64 witness, and against a call on the same samples padded to 256
    (one ray a CTA, two passes), at KERNEL_TOL; two launches bit-identical,
    K2b's folded bias sums among the outputs. Returns the largest absolute
    difference from the plain version."""
    import torch

    from nerf_rs_tpu_torch.kernels.fused_render import pack_weights, pack_weights_t
    from nerf_rs_tpu_torch.kernels.fused_train import (
        KERNEL_TOL, fused_train_grads, fused_train_grads_reference)

    pk = pack_weights(model, mcfg)
    pkt = pack_weights_t(pk)
    want_narrow(pk, 192, "K2 at S = 150-192")
    gen = torch_generator(rays[0].device, 13)
    max_err = 0.0
    for s in (150, 191, 192):
        ts, dl, _, _ = sample_inputs(N_RAYS, s, False, cam, gen)
        args = (pk, pkt, *rays, ts, dl, gold, mcfg, s)
        got = fused_train_grads(*args, white_bg=True)
        torch.cuda.synchronize()
        for ref, dtype in (("plain", torch.float32), ("f64 witness", torch.float64)):
            want = fused_train_grads_reference(*args, white_bg=True, dtype=dtype)
            if dtype == torch.float32:
                max_err = max(max_err, k2_abs(got, want))
            label = f"K2 vs {ref} [S={s}]"
            hold(label, k2_errs(label, got, want), KERNEL_TOL)
            del want
        pad = 256 - s
        wide = fused_train_grads(pk, pkt, *rays, torch.cat([ts, ts[:, -1:].expand(-1, pad)], 1),
                                 torch.cat([dl, dl.new_zeros(N_RAYS, pad)], 1), gold, mcfg, 256,
                                 white_bg=True)
        if wide.weights[:, s:].any():
            fail(f"K2 [S={s} padded to 256]: the pads' weights are not 0")
        label = f"K2 at S={s} (run as 192) vs the same rays padded to 256"
        hold(label, k2_errs(label, got, wide._replace(weights=wide.weights[:, :s])), KERNEL_TOL)
        again = fused_train_grads(*args, white_bg=True)
        if not all(torch.equal(a, b) for a, b in zip(k2_outs(got), k2_outs(again))):
            fail(f"two K2 launches at S={s} gave different bits")
        print(f"K2 at S={s}: two launches bit-identical (dW and the folded bias sums)")
        del got, wide, again
    return max_err


def cli_config(argv):
    """The config a port CLI call ``argv`` resolves to."""
    from nerf_rs_tpu_torch import cli

    args = cli.build_parser().parse_args(argv)
    args._explicit = cli.explicit_dests(argv)
    return cli.config_from_args(args)


def preset_cfg(preset, *extra):
    return cli_config(["train", "--preset", preset, "--dataset", "sphere", *extra])


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


def drive_record(tmp: str) -> dict:
    """`--preset record` through the CLI at full width (drive_preset: train
    for PRESET_STEPS steps with 2 K2 launches a step, `render --view 0` at
    800x800 and `eval --max_views 2` with exact K1 counts), with the
    occupancy grid updated after steps 0, 16, 32 and 48 and non-zero in the
    checkpoint; then a resume for REC_RESUME steps (2 K2 launches each, no
    update) whose checkpoint holds the restored grid unchanged. Returns the
    launch counts."""
    import torch

    from nerf_rs_tpu_torch.kernels.fused_train import fused_train_grads
    from nerf_rs_tpu_torch.train import checkpoint as ckpt, loop

    updates = []
    real = loop.update_occupancy

    def counted(state, cfg, it):
        updates.append(it)
        return real(state, cfg, it)

    loop.update_occupancy = counted
    try:
        counts = drive_preset(tmp, "record")
        want = list(range(0, PRESET_STEPS, REC_GRID_EVERY))
        ckdir = os.path.join(tmp, "record")
        grid = torch.load(ckpt.latest_checkpoint(ckdir), weights_only=True)["grid"]
        print(f"record grid: updates after steps {updates} (want {want}), {tuple(grid.shape)}, "
              f"{int((grid > 0.01).sum())} of {grid.numel()} cells occupied, max "
              f"{float(grid.max()):.4g}")
        if updates != want or tuple(grid.shape) != (32, 32, 32) or not float(grid.max()) > 0:
            fail(f"record grid: updates {updates} (want {want}), shape {tuple(grid.shape)}, "
                 f"max {float(grid.max())}")
        updates.clear()
        fused_train_grads.launches = 0
        steps = PRESET_STEPS + REC_RESUME
        rc, out = run_cli(["train", "--preset", "record", "--dataset", "sphere", "--num_iter",
                           str(steps), "--eval_steps", "50", "--save_steps", "1000",
                           "--save_dir", ckdir, "--log_dir", ckdir])
        k2 = fused_train_grads.launches
        after = torch.load(ckpt.latest_checkpoint(ckdir), weights_only=True)
        print(f"record resume to {steps}: rc {rc}, K2 launches {k2}, updates {updates}, grid "
              f"restored {torch.equal(after['grid'], grid)}")
        if (rc != 0 or k2 != 2 * REC_RESUME or updates or after["step"] != steps
                or not torch.equal(after["grid"], grid)):
            fail(f"record resume: rc {rc}, K2 launches {k2} (want {2 * REC_RESUME}), updates "
                 f"{updates}, step {after['step']}, grid kept {torch.equal(after['grid'], grid)}")
        counts["resume"] = k2
    finally:
        loop.update_occupancy = real
    return counts


def drive_multiscale(tmp: str) -> dict:
    """`train --preset mipnerf --multiscale_levels 4` through the CLI at
    full width for PRESET_STEPS steps (2 K2 launches a step, 2 K1 for the
    eval), then `eval --scales 1,2,4,8 --max_views 2` on its checkpoint:
    each scale's views through K1 (one chunk, two passes, a view), a
    finite mean PSNR at each scale and the multiscale mean. Returns the
    launch counts."""
    from nerf_rs_tpu_torch.kernels.fused_ray import fused_ray_render
    from nerf_rs_tpu_torch.kernels.fused_train import fused_train_grads

    ckdir = os.path.join(tmp, "mipnerf-ms")
    common = ["--preset", "mipnerf", *MS_FLAGS, "--dataset", "sphere", "--save_dir", ckdir]
    fused_train_grads.launches = 0
    fused_ray_render.launches = 0
    rc, out = run_cli(["train", *common, "--num_iter", str(PRESET_STEPS), "--eval_steps", "50",
                       "--save_steps", "1000", "--log_dir", ckdir])
    k2, k1 = fused_train_grads.launches, fused_ray_render.launches
    print(f"cli train --preset mipnerf {' '.join(MS_FLAGS)}, {PRESET_STEPS} steps: rc {rc}, "
          f"K2 launches {k2}, K1 launches {k1}")
    if rc != 0 or k2 != 2 * PRESET_STEPS or k1 != 2:
        fail(f"multiscale train: rc {rc}, K2 launches {k2} (want {2 * PRESET_STEPS}), K1 "
             f"launches {k1} (want 2)")
    fused_ray_render.launches = 0
    rc, out = run_cli(["eval", *common, "--max_views", "2", "--scales",
                       ",".join(map(str, MS_SCALES))])
    k1_eval = fused_ray_render.launches
    means = dict(re.findall(r"mean psnr over 2 \S+ views at 1/(\d+): (\S+)", out))
    m = re.search(r"multiscale mean psnr: ([^,\s]+)", out)
    print(f"cli eval --scales {','.join(map(str, MS_SCALES))}: rc {rc}, K1 launches {k1_eval} "
          f"(want {2 * 2 * len(MS_SCALES)}), mean psnr by scale {means}, multiscale mean "
          f"{m and m.group(1)}")
    if (rc != 0 or k1_eval != 2 * 2 * len(MS_SCALES) or sorted(map(int, means)) != list(MS_SCALES)
            or m is None or not all(math.isfinite(float(v)) for v in [*means.values(),
                                                                      m.group(1)])):
        fail(f"multiscale eval: rc {rc}, K1 launches {k1_eval}, means {means}")
    return {"train": k2, "train_eval": k1, "eval_scales": k1_eval,
            "psnr_by_scale": {int(k): float(v) for k, v in means.items()}}


def write_scenes(tmp: str, card: str) -> dict:
    """Phase 24: the port's make-scene writes the procedural lego at
    SCENE_FLAGS and at LEGO64_FLAGS on the card, each timed; the test split
    loads (clear and opaque pixels both present), and one 32 x 32 view
    integrated on the card stands within GOLD_TOL of the CPU's at GOLD_SHARE
    of its values and within GOLD_EDGE at all. Returns {name: (directory,
    seconds)}."""
    import numpy as np
    import torch

    from nerf_rs_tpu_torch.data import blender, procedural
    from nerf_rs_tpu_torch.tools import make_scene

    out = {}
    for name, flags in (("lego", SCENE_FLAGS), ("lego64", LEGO64_FLAGS)):
        path = os.path.join(tmp, name)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        log = io.StringIO()
        with contextlib.redirect_stdout(log):
            rc = make_scene.main(["--out", path, *flags, "--device", "cuda"])
        dt = time.perf_counter() - t0
        size = int(flags[1])
        scene = blender.load_blender(path, "test")
        alpha = scene.images[..., 3]
        print(f"make_scene {' '.join(flags)} on the card [{card}]: rc {rc}, {dt:.2f} s; test "
              f"split {scene.images.shape}, {float((alpha > 200).mean()):.3f} of its pixels "
              f"opaque")
        if (rc != 0 or scene.images.shape != (4, size, size, 4) or not (alpha == 0).any()
                or not (alpha > 200).any()):
            fail(f"make_scene {name}: rc {rc}, test split {scene.images.shape}")
        out[name] = (path, dt)
    c2w = procedural.hemisphere_poses(1, 1)[0]
    focal = 0.5 * 32 / math.tan(0.5 * procedural.CAMERA_ANGLE_X)
    frames = [procedural.render_gold(c2w, 32, 32, focal, num_samples=64, device=dev)
              for dev in ("cuda", "cpu")]
    diff = np.abs(frames[0] - frames[1])
    share, gap = float((diff <= GOLD_TOL).mean()), float(diff.max())
    print(f"render_gold 32x32, 64 samples, card vs CPU: {share:.4f} of the values within "
          f"{GOLD_TOL:g} (want {GOLD_SHARE}), the largest gap {gap:.3g} (tol {GOLD_EDGE})")
    if not (share >= GOLD_SHARE and gap <= GOLD_EDGE):
        fail(f"render_gold on the card stands from the CPU's: {share} within {GOLD_TOL}, "
             f"the largest gap {gap}")
    return out


def _render_launches(preset: str, pixels: int, views: int) -> int:
    """K1 launches of ``views`` frames of ``pixels`` rays under the preset:
    its passes times the render chunks a view."""
    from nerf_rs_tpu_torch.render import default_render_chunk

    cfg = preset_cfg(preset)
    passes = 2 if cfg.render.num_fine_samples > 0 else 1
    chunk = default_render_chunk(cfg.render, fused=True, model_cfg=cfg.model)
    return views * passes * math.ceil(pixels / chunk)


def drive_dataset(tmp: str, key: str, flags, steps: int, k2_per_step: int, pixels: int,
                  eval_views: int, eval_flags=(), train_flags=()) -> dict:
    """`cli train` on a dataset for ``steps`` steps (``k2_per_step`` K2
    launches a step, and an eval at step 10 when it comes), then `eval`
    (``eval_flags``; ``eval_views`` views) and `render --view 0`, each
    through K1 with exact counts and a finite PSNR. Returns the counts."""
    from nerf_rs_tpu_torch.kernels.fused_ray import fused_ray_render
    from nerf_rs_tpu_torch.kernels.fused_train import fused_train_grads

    preset = flags[flags.index("--preset") + 1] if "--preset" in flags else "full"
    ckdir = os.path.join(tmp, key)
    common = [*flags, "--save_dir", ckdir]
    fused_train_grads.launches = 0
    fused_ray_render.launches = 0
    rc, out = run_cli(["train", *common, *train_flags, "--num_iter", str(steps),
                       "--eval_steps", "10", "--save_steps", "1000", "--log_dir", ckdir])
    k2, k1 = fused_train_grads.launches, fused_ray_render.launches
    want_k1 = _render_launches(preset, pixels, 1) if steps > 10 else 0
    print(f"cli train {' '.join(flags)} {' '.join(train_flags)}, {steps} steps: rc {rc}, K2 "
          f"launches {k2} (want {k2_per_step * steps}), K1 launches {k1} (want {want_k1})")
    losses = [float(v) for v in re.findall(r"iter=\d+, loss=(\S+)", out)]
    if (rc != 0 or k2 != k2_per_step * steps or k1 != want_k1
            or not all(map(math.isfinite, losses))):
        fail(f"{key} train: rc {rc}, K2 {k2}, K1 {k1}, losses {losses}")
    counts = {"train": k2, "train_eval": k1}
    for name, argv, want in (
            ("eval", ["eval", *eval_flags], _render_launches(preset, pixels, eval_views)),
            ("render", ["render", "--view", "0", "--out_dir", os.path.join(ckdir, "r")],
             _render_launches(preset, pixels, 1))):
        fused_ray_render.launches = 0
        rc, out = run_cli([*argv, *common])
        k1 = fused_ray_render.launches
        m = re.search(r"(?:mean psnr over \d+ \S+ views: |psnr=)([^\s,]+)", out)
        print(f"cli {name} {key}: rc {rc}, K1 launches {k1} (want {want}), psnr "
              f"{m and m.group(1)}")
        if rc != 0 or k1 != want or m is None or not math.isfinite(float(m.group(1))):
            fail(f"{key} {name}: rc {rc}, K1 launches {k1} (want {want}), psnr "
                 f"{m and m.group(1)}")
        counts[name] = k1
    return counts


def drive_host_and_pod(tmp: str, scene: str) -> dict:
    """Phase 26: `train --batch_mode host --use_native_loader true` (two
    workers) on the Blender scene through K2, the C++ gather built from the
    port's own source; then `--preset pod` through K2 for HOST_STEPS steps,
    whose checkpoint carries its error store (moved off its start), and a
    resume of 3 steps that reads it back. Returns the K2 counts."""
    import numpy as np

    from nerf_rs_tpu_torch.data import native_loader
    from nerf_rs_tpu_torch.kernels.fused_train import fused_train_grads
    from nerf_rs_tpu_torch.train import checkpoint as ckpt

    data = [*LEGO_DATA, "--img_dir", scene, "--eval_steps", "100", "--save_steps", "1000"]
    counts = {}
    fused_train_grads.launches = 0
    ckdir = os.path.join(tmp, "host")
    rc, out = run_cli(["train", "--preset", "full", *data, "--batch_mode", "host",
                       "--use_native_loader", "true", "--data_workers", "2", "--num_iter",
                       str(HOST_STEPS), "--save_dir", ckdir, "--log_dir", ckdir])
    counts["host_train"] = fused_train_grads.launches
    lib = native_loader.library_path()
    print(f"cli train --batch_mode host --use_native_loader true: rc {rc}, K2 launches "
          f"{counts['host_train']}, native library {lib.name} built {lib.exists()}")
    if rc != 0 or counts["host_train"] != HOST_STEPS or not lib.exists():
        fail(f"host pipeline: rc {rc}, K2 {counts['host_train']}, library {lib.exists()}")
    ckdir = os.path.join(tmp, "pod")
    pod = ["train", "--preset", "pod", "--use_whole_ray_train", "true", *data,
           "--save_dir", ckdir, "--log_dir", ckdir]
    fused_train_grads.launches = 0
    rc, out = run_cli([*pod, "--num_iter", str(HOST_STEPS)])
    counts["pod_train"] = fused_train_grads.launches
    first = ckpt.load_err_store(ckpt.latest_checkpoint(ckdir))
    fused_train_grads.launches = 0
    rc2, out2 = run_cli([*pod, "--num_iter", str(HOST_STEPS + 3)])
    counts["pod_resume"] = fused_train_grads.launches
    after = ckpt.load_err_store(ckpt.latest_checkpoint(ckdir))
    moved = first is not None and bool((first != 1.0).any())
    print(f"cli train --preset pod: rc {rc}, K2 launches {counts['pod_train']}; error store "
          f"{None if first is None else first.shape}, moved off its start {moved}; resume rc "
          f"{rc2}, K2 launches {counts['pod_resume']}, read back "
          f"{'resumed the error store from' in out2}")
    if (rc != 0 or rc2 != 0 or counts["pod_train"] != HOST_STEPS or counts["pod_resume"] != 3
            or not moved or "resumed the error store from" not in out2
            or after is None or np.array_equal(after, first)):
        fail(f"pod: rc {rc}/{rc2}, K2 {counts['pod_train']}/{counts['pod_resume']}, store "
             f"moved {moved}")
    return counts


def drive_llff_and_multiview(tmp: str) -> dict:
    """Phase 27: `--dataset llff --ndc true` on tests/data/llff_mini (train,
    eval of its held-out view, render), and `--dataset multiview_png` on 12
    64x64 sphere views written here as image-{i}.png, in multiview batches.
    Returns the launch counts."""
    from nerf_rs_tpu_torch import CameraConfig
    from nerf_rs_tpu_torch.data import synthetic
    from nerf_rs_tpu_torch.data.images import save_png

    counts = {"llff": drive_dataset(
        tmp, "llff", ["--preset", "full", "--dataset", "llff", "--img_dir", LLFF_MINI, "--ndc",
                      "true"], 4, 1, 24 * 32, 1)}
    views = os.path.join(tmp, "views")
    imgs = synthetic.sphere_scene_images(CameraConfig(width=64, height=64), 12)
    for i in range(12):
        save_png(os.path.join(views, f"image-{i}.png"), imgs[i])
    counts["multiview"] = drive_dataset(
        tmp, "multiview", ["--preset", "full", "--dataset", "multiview_png", "--img_dir", views,
                           "--view_end", "12", "--width", "64", "--height", "64"], 4, 1,
        64 * 64, 2, eval_flags=("--max_views", "2"),
        train_flags=("--batch_mode", "multiview"))
    return counts


def time_datasets(card: str, scene: str) -> dict:
    """Phase 29: the full and record steps (4096 rays) through K2 on the
    sphere at 100x100 and on the Blender scene (c2w rays) at the same
    shapes, per ray and through the host pipeline (the C++ gather), the
    steps and batches built as ``train.loop.train`` builds them; best of
    DATA_WINDOWS[preset] windows of 10 steps; and the batch alone (rays and
    gold) in each mode, the host cost of the c2w rays beside the sphere's
    yaw/pitch ones."""
    import torch

    from nerf_rs_tpu_torch.data.factory import effective_config, make_dataset
    from nerf_rs_tpu_torch.train.loop import batch_source, make_pipeline
    from nerf_rs_tpu_torch.train.step import init_state, make_train_step, step_generator

    dev = torch.device("cuda")
    out = {}
    for preset in BLENDER_PRESETS:
        windows = DATA_WINDOWS[preset]
        for name, argv in (("sphere per_ray", ("--width", "100", "--height", "100")),
                           ("blender per_ray", (*LEGO_DATA, "--img_dir", scene)),
                           ("blender host", (*LEGO_DATA, "--img_dir", scene,
                                             "--batch_mode", "host",
                                             "--use_native_loader", "true"))):
            cfg = preset_cfg(preset, *argv)
            ds = make_dataset(cfg, dev)
            cfg = effective_config(cfg, ds)
            pipe = make_pipeline(cfg, ds)
            try:
                sample = batch_source(cfg, ds, None, pipe)
                fn = make_train_step(cfg, ds, sample)
                state = init_state(cfg, dev)
                it = [0]

                def run(k):
                    nonlocal state
                    for _ in range(k):
                        state, _ = fn(state, step_generator(0, it[0], dev))
                        it[0] += 1
                run(2)
                step_ms = best_of(lambda: run(10), windows) / 10 * 1e3
                g = torch.Generator(device=dev).manual_seed(0)
                batch_ms = best_of(lambda: [sample(g) for _ in range(10)], windows) / 10 * 1e3
            finally:
                if pipe is not None:
                    pipe.close()
            print(f"{preset} step, {name} [{card}]: {step_ms:.3f} ms/step through K2; the "
                  f"batch alone {batch_ms:.3f} ms")
            out[f"{preset} {name}"] = {"step_ms": step_ms, "batch_ms": batch_ms}
            del state
    return out


def learning_drive(pool, tmp: str, preset: str, extra=("--num_fine_samples", "64"),
                   k2_per_step: int = 2, bar: Optional[float] = None,
                   name: Optional[str] = None, defer: bool = False,
                   seeds=LEARN_SEEDS):
    """The preset's 64x64 learning drive through K2 (``k2_per_step``
    launches a step), once per seed in ``seeds``, then `cli eval` on each
    checkpoint, each seed's drive a task of the learning ``pool``: the mean
    over seeds of the mean PSNR over the first LEARN_VIEWS views must pass
    ``bar`` (PRESET_PSNR[preset] by default). ``name`` (by default the
    preset's) names the drives' directories. Returns a function that waits
    for the drives, prints and checks them: with ``defer`` a mean under the
    bar fails the run at its end (DEFERRED); it returns each seed's
    readings, the mean and ``launches``, the K2 launches counted over the
    seeds' drives (each counter set to 0 before its drive)."""
    common = ["--preset", preset, "--dataset", "sphere", "--width", "64", "--height", "64",
              "--num_samples", "32", *extra]
    tasks = {}
    for seed in seeds:
        vdir = os.path.join(tmp, f"learn-{name or preset}-{seed}")
        tasks[seed] = pool.submit(drive_seed, [
            ("cli", ["train", *common, "--seed", str(seed), "--num_rays", "1024",
                     "--num_iter", "301", "--eval_steps", "100", "--learning_rate", "1e-3",
                     "--save_dir", vdir, "--log_dir", vdir]),
            ("cli", ["eval", *common, "--save_dir", vdir, "--max_views", str(LEARN_VIEWS)])])

    def finish() -> dict:
        per_seed, launches = {}, 0
        for seed, task in tasks.items():
            (rc, out, counts), (erc, eout, _) = task.result()
            print(out.rstrip())
            print(eout.rstrip())
            curve = dict(re.findall(r"iter=(\d+), eval psnr=(\S+)", out))
            launches += counts["K2"]
            if rc != 0 or counts["K2"] != k2_per_step * 301:
                fail(f"{preset} learning drive, seed {seed}: rc {rc}, K2 launches "
                     f"{counts['K2']} (want {k2_per_step * 301})")
            m = re.search(r"mean psnr over \d+ \S+ views: (\S+)", eout)
            if erc != 0 or m is None or not math.isfinite(float(m.group(1))):
                fail(f"{preset} learning drive, seed {seed}: eval rc {erc}, no finite mean psnr")
            per_seed[seed] = {"view0_curve": curve, "mean_psnr": float(m.group(1))}
        mean = sum(r["mean_psnr"] for r in per_seed.values()) / len(per_seed)
        want = PRESET_PSNR[preset] if bar is None else bar
        print(f"{preset} learning drives (64x64, {' '.join(common[8:])}): mean psnr over "
              f"{LEARN_VIEWS} views at 301 per seed {[r['mean_psnr'] for r in per_seed.values()]}, "
              f"mean {mean:.3f} (bar {want})")
        if not mean > want:
            msg = (f"{name or preset} learning drives: mean psnr {mean:.3f} over seeds "
                   f"{seeds} (need > {want})")
            if not defer:
                fail(msg)
            print(f"chip_smoke: {msg}; the run fails at its end")
            DEFERRED.append(msg)
        return {"seeds": per_seed, "mean_psnr": mean, "bar": want, "launches": launches}
    return finish


# Rays past 256 samples and fields past K1's resident layouts (phase 33; the
# counterparts of the JAX kernels, which take any S and any depth): K1 and K2
# against their plain versions (K2 also the float64 witness) on the N_RAYS
# rays at LONG_S (257 and 300 pad to 384, one ray a CTA in S / 128 passes),
# on LONG_FEW rays at LONG_S_MAX, at S = 300 in the IPE and the contraction +
# distortion branches, at depth DEEP_DEPTH (skip DEEP_SKIP; at S = 192 K1's
# resident layout, whose biases grow with depth, no longer fits: the
# streamed instance, two rays a CTA spanning passes) and with IPE at
# WIDE_PE_LEVELS levels at S = 150 (K1 streamed; K2 takes every one of these
# on its narrow instance). Reruns bit-identical; the pads' weights exactly 0
# and the call at the padded S equal to the call on the rays as they are;
# one K2 call over more than BLOCK_ROWS rows against its blocks called one
# by one. Phase 34 drives the CLI's long-ray paths, LONG_STEPS steps each.
LONG_S = (257, 300, 384, 512, 640)
LONG_S_MAX, LONG_FEW = 2048, 64
LONG_BRANCHES = (("IPE softplus, S=300", True, False, None, 300),
                 ("contract + distortion disparity, S=300", False, True, "disparity", 300))
DEEP_DEPTH, DEEP_SKIP = 21, 4
# K2 vs its plain version on the deep relu field (deep_relu), each gradient
# leaf relative to its max: on an H100 80GB HBM3 at 700 W it read K2-plain
# 0.105, with the plain version 0.16 from the float64 witness; K2 may stand
# from the plain version ~1.5x as far as the plain version stands from the
# witness
DEEP_RELU_GRADS = 0.25
WIDE_PE_LEVELS = 16  # P = 99 -> 112 encoding columns
LONG_STEPS = 51  # a loss line is printed at step 50
LONG_BLOCKED = (4096, 512)  # 2,097,152 rows: two launches
# the long rays' main-path calls (phase 35): a default render chunk at S =
# 300 and 512 (render.default_render_chunk: 32,768 rays) and a 4096-ray
# train step's call (two launches each)
LONG_SHAPES = tuple(Shape(k, c, False, False, None, n, s, 0.05, 2.0, False)
                    for k, c, n, s in (("K1", "S=300 (a 32,768-ray chunk)", 32768, 300),
                                       ("K1", "S=512 (a 32,768-ray chunk)", 32768, 512),
                                       ("K2", "S=300, 4096 rays (two blocks)", 4096, 300),
                                       ("K2", "S=512, 4096 rays (two blocks)", 4096, 512)))


# Phase 36: fields of any width (faults 13 and 14), as (net, feature, view
# head) widths: no multiples of 16 (pack_weights pads them), and past 256 (the
# wide instances), 1024 being mip-NeRF 360's trunk with this package's heads
WIDTHS = {"40/40/24": (40, 40, 24), "100/100/50": (100, 100, 50),
          "384/384/128": (384, 384, 128), "384/384/384": (384, 384, 384),
          "512/512/256": (512, 512, 256),
          "1024/256/128": (1024, 256, 128)}
# each width's checks: (S, IPE, contraction + disparity distortion), on
# WIDTH_ROWS // S of the N_RAYS rays (the float64 witness of the 1024-wide
# field stays a few GB)
WIDTH_BRANCHES = ((64, False, False), (192, True, False), (300, False, True))
WIDTH_ROWS = 32768
WIDE_RUNS = ("512/512/256", "1024/256/128")  # the trains and frames of phase 36
PADDED_RUNS = ("40/40/24", "100/100/50")  # timed calls only (no path of their own)
WIDE_STEPS = 20
WIDE_WINDOW = 3  # steps a timing window of the K2 and autograd steps


def check_long_case(label, model, cfg, rays, gold, ts, dl, radii=None, dist=None,
                    autograd=False, far=2.0) -> tuple:
    """K1 and K2 on one set of samples: K1 vs its plain version (TOL, depth
    scaled to the range); K2 vs its plain version and the float64 witness
    (KERNEL_TOL), with ``autograd`` also vs autograd of the eager loss; each
    kernel run twice, bit-identical, and once more on the samples padded as
    the wrappers pad them, whose pads' weights are exactly 0 and whose other
    outputs equal the first call's bits. Returns the largest absolute
    differences of K1 and K2 from their plain versions."""
    import torch

    from nerf_rs_tpu_torch.kernels.fused_ray import (
        fused_ray_render, fused_ray_render_reference, pad_samples)
    from nerf_rs_tpu_torch.kernels.fused_render import pack_weights, pack_weights_t
    from nerf_rs_tpu_torch.kernels.fused_train import (
        KERNEL_TOL, fused_train_grads, fused_train_grads_reference, unpack_grads)
    from nerf_rs_tpu_torch.models.mlp import apply_nerf
    from nerf_rs_tpu_torch.ops import render as render_ops, sampling

    o, d, vd = rays
    s = ts.shape[1]
    tp, dp = pad_samples(ts, dl)
    sp = tp.shape[1]
    dist = dist or {}
    pk = pack_weights(model, cfg)
    got = fused_ray_render(pk, o, d, vd, ts, dl, cfg, s, radii=radii)
    torch.cuda.synchronize()
    want = fused_ray_render_reference(pk, o, d, vd, ts, dl, cfg, s, radii=radii)
    errs = k1_errs(f"K1 [{label}]", got, want)
    hold(f"K1 vs plain [{label}]", errs, k1_tol(far))
    k1_err = max(errs.values())
    del want
    again = fused_ray_render(pk, o, d, vd, ts, dl, cfg, s, radii=radii)
    padded = fused_ray_render(pk, o, d, vd, tp, dp, cfg, sp, radii=radii)
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        fail(f"two K1 launches [{label}] gave different bits")
    if padded[3][:, s:].any():
        fail(f"K1 [{label}]: the pads' weights are not 0")
    if not all(torch.equal(a, b[:, :s] if a.dim() == 2 and a.shape[1] == s else b)
               for a, b in zip(got, padded)):
        fail(f"K1 [{label}]: the call at the padded S = {sp} differs from the call at {s}")
    del got, again, padded

    want_narrow(pk, s, f"K2 [{label}]")
    args = (pk, pack_weights_t(pk), o, d, vd, ts, dl, gold, cfg, s)
    got = fused_train_grads(*args, white_bg=True, radii=radii, **dist)
    torch.cuda.synchronize()
    k2_err = 0.0
    for ref, dtype in (("plain", torch.float32), ("f64 witness", torch.float64)):
        want = fused_train_grads_reference(*args, white_bg=True, radii=radii, dtype=dtype,
                                           **dist)
        if dtype == torch.float32:
            k2_err = k2_abs(got, want)
        lab = f"K2 vs {ref} [{label}]"
        hold(lab, k2_errs(lab, got, want), KERNEL_TOL)
        del want
        torch.cuda.empty_cache()
    again = fused_train_grads(*args, white_bg=True, radii=radii, **dist)
    if not all(torch.equal(a, b) for a, b in zip(k2_outs(got), k2_outs(again))):
        fail(f"two K2 launches [{label}] gave different bits")
    del again
    padded = fused_train_grads(pk, pack_weights_t(pk), o, d, vd, tp, dp, gold, cfg, sp,
                               white_bg=True, radii=radii, **dist)
    if padded.weights[:, s:].any():
        fail(f"K2 [{label}]: the pads' weights are not 0")
    if not all(torch.equal(a, b) for a, b in zip(
            k2_outs(got), k2_outs(padded._replace(weights=padded.weights[:, :s])))):
        fail(f"K2 [{label}]: the call at the padded S = {sp} differs from the call at {s}")
    del padded
    if autograd:
        model.zero_grad(set_to_none=True)
        sigma, rgb = apply_nerf(model, sampling.points_from_ts(o, d, ts), vd[:, None, :], cfg,
                                torch.bfloat16)
        out = render_ops.composite(sigma, rgb, dl, white_background=True)
        loss = render_ops.mse(out.rgb, gold)
        loss.backward()
        params = dict(model.named_parameters())
        hold(f"K2 vs autograd [{label}]", {
            "rgb": float((got.diag[:, :3] - out.rgb.detach()).abs().max()),
            "loss": abs(float(got.diag[:, 4].mean()) - float(loss.detach())),
            "grads": max(leaf_err(g, params[k].grad)
                         for k, g in unpack_grads(got, model, cfg).items()),
        }, AUTOGRAD_TOL)
        model.zero_grad(set_to_none=True)
        del sigma, rgb, out, loss
    del got
    torch.cuda.empty_cache()
    print(f"K1 and K2 [{label}]: reruns bit-identical, the pads' weights 0, the call at the "
          f"padded S = {sp} equal to the call at {s}")
    return k1_err, k2_err


def deep_relu(model, cfg, rays, gold, ts, dl) -> None:
    """The deep field under relu density. At its initial scale the first
    layers' gradients are ~1e-6 of ~1e-2 at the heads, and the bf16 rounding
    of each trunk G, flipped by the f32 summation order, walks through 21
    layers: the f32 plain version itself stands 0.16 of a first-layer leaf
    from the float64 witness (KERNEL_TOL's 2.5e-2 holds at the initial scale
    of the 8-layer field). K1 (the forward) is held at TOL; K2 to the plain
    version at KERNEL_TOL on diag and weights and at DEEP_RELU_GRADS on each
    leaf; its gaps to the witness are printed beside the plain version's."""
    import dataclasses

    import torch

    from nerf_rs_tpu_torch.kernels.fused_ray import fused_ray_render, fused_ray_render_reference
    from nerf_rs_tpu_torch.kernels.fused_render import pack_weights, pack_weights_t
    from nerf_rs_tpu_torch.kernels.fused_train import (
        KERNEL_TOL, fused_train_grads, fused_train_grads_reference)

    cfg = dataclasses.replace(cfg, sigma_activation="relu")
    pk = pack_weights(model, cfg)
    s = ts.shape[1]
    got = fused_ray_render(pk, *rays, ts, dl, cfg, s)
    torch.cuda.synchronize()
    label = f"depth {cfg.net_depth} relu, S={s}"
    hold(f"K1 vs plain [{label}]", k1_errs(f"K1 [{label}]", got, fused_ray_render_reference(
        pk, *rays, ts, dl, cfg, s)), TOL)
    args = (pk, pack_weights_t(pk), *rays, ts, dl, gold, cfg, s)
    got = fused_train_grads(*args, white_bg=True)
    want = fused_train_grads_reference(*args, white_bg=True)
    wit = fused_train_grads_reference(*args, white_bg=True, dtype=torch.float64)
    gap = lambda a, b: max(leaf_err(x.double(), y.double())  # noqa: E731
                           for x, y in zip(a.dw + a.db, b.dw + b.db))
    errs = k2_errs(f"K2 vs plain [{label}]", got, want)
    print(f"K2 [{label}]: grads K2-witness {gap(got, wit):.3g}, plain-witness "
          f"{gap(want, wit):.3g}")
    hold(f"K2 vs plain [{label}]", errs, {**KERNEL_TOL, "grads": DEEP_RELU_GRADS})
    del got, want, wit
    torch.cuda.empty_cache()


def check_long_rays(model, mcfg, rays, gold, cam) -> tuple:
    """Phase 33 (see LONG_S): returns the largest absolute differences of K1
    and K2 from their plain versions and the blocked call's launches."""
    import dataclasses

    import torch

    from nerf_rs_tpu_torch.kernels import fused_train
    from nerf_rs_tpu_torch.kernels.fused_ray import padded_samples
    from nerf_rs_tpu_torch.kernels.fused_render import pack_weights, pack_weights_t
    from nerf_rs_tpu_torch.kernels.fused_train import BLOCKED_TOL, fused_train_grads
    from nerf_rs_tpu_torch.models.mlp import init_nerf_params

    dev = rays[0].device
    gen = torch_generator(dev, 33)
    k1_err = k2_err = 0.0
    for s in LONG_S + (LONG_S_MAX,):
        n = LONG_FEW if s == LONG_S_MAX else N_RAYS
        ts, dl, _, _ = sample_inputs(n, s, False, cam, gen)
        a, b = check_long_case(f"S={s} relu, {n} rays", model, mcfg,
                               tuple(r[:n].contiguous() for r in rays), gold[:n].contiguous(),
                               ts, dl, autograd=s == 300)
        k1_err, k2_err = max(k1_err, a), max(k2_err, b)
    for name, ipe, contract, space, s in LONG_BRANCHES:
        cfg = dataclasses.replace(mcfg, ipe=ipe, contract=contract, sigma_activation="softplus")
        near, far = (UNB_NEAR, UNB_FAR) if contract else (cam.near, cam.far)
        ts, dl, _, radii = sample_inputs(N_RAYS, s, ipe, cam, gen, near, far,
                                         space or "linear")
        dist = None if space is None else dict(dist_weight=UNB_DIST, near=near, far=far,
                                               dist_space=space)
        a, b = check_long_case(name, model, cfg, rays, gold, ts, dl, radii, dist, far=far)
        k1_err, k2_err = max(k1_err, a), max(k2_err, b)
    deep_cfg = dataclasses.replace(mcfg, net_depth=DEEP_DEPTH, skip_layer=DEEP_SKIP,
                                   sigma_activation="softplus")
    deep = random_biases_(init_nerf_params(deep_cfg, 0, dev), 1)
    for s in (64, 192):
        ts, dl, _, _ = sample_inputs(N_RAYS, s, False, cam, gen)
        a, b = check_long_case(f"depth {DEEP_DEPTH} softplus, S={s}", deep, deep_cfg, rays, gold,
                               ts, dl)
        k1_err, k2_err = max(k1_err, a), max(k2_err, b)
        if s == 64:
            deep_relu(deep, deep_cfg, rays, gold, ts, dl)
    del deep
    wide_cfg = dataclasses.replace(mcfg, ipe=True, pos_enc_levels=WIDE_PE_LEVELS,
                                   sigma_activation="softplus")
    wide = random_biases_(init_nerf_params(wide_cfg, 0, dev), 2)
    ts, dl, _, radii = sample_inputs(N_RAYS, 150, True, cam, gen)
    a, b = check_long_case(f"IPE at {WIDE_PE_LEVELS} levels, S=150", wide, wide_cfg, rays, gold,
                           ts, dl, radii)
    k1_err, k2_err = max(k1_err, a), max(k2_err, b)
    del wide

    # one call over more than BLOCK_ROWS rows against the same call in one launch
    n, s = LONG_BLOCKED
    o, d = (torch.cat([r, r])[:n].contiguous() for r in rays[:2])
    vd = (d / torch.linalg.norm(d, dim=-1, keepdim=True)).contiguous()
    g = torch.cat([gold, gold])[:n].contiguous()
    ts, dl, _, _ = sample_inputs(n, s, False, cam, gen)
    pk = pack_weights(model, mcfg)
    args = (pk, pack_weights_t(pk), o, d, vd, ts, dl, g, mcfg, s)
    blocks = fused_train.ray_blocks(n, padded_samples(s))
    before = fused_train_grads.launches
    got = fused_train_grads(*args)
    launches = fused_train_grads.launches - before
    if launches != len(blocks) or len(blocks) < 2:
        fail(f"K2 over {n} x {s}: {launches} launches for blocks {blocks}")
    cap = fused_train.BLOCK_ROWS
    fused_train.BLOCK_ROWS = n * padded_samples(s)
    try:
        one = fused_train_grads(*args)
    finally:
        fused_train.BLOCK_ROWS = cap
    same = (torch.equal(got.diag, one.diag) and torch.equal(got.weights, one.weights))
    gap = max(leaf_err(a, b) for a, b in zip(got.dw + got.db, one.dw + one.db))
    print(f"K2 over {n} x {s} ({n * padded_samples(s):,} rows): {launches} launches, blocks "
          f"{blocks}; against the call in one launch: diag and weights "
          f"{'bit-identical' if same else 'DIFFERENT'}, grads {gap:.3g} of a leaf's max "
          f"(tol {BLOCKED_TOL})")
    if not same or gap > BLOCKED_TOL:
        fail(f"K2 over {n} x {s}: the blocked call differs from the call in one launch")
    del one
    # ... and against its blocks' rays in calls of their own, each with its own
    # means: two equal blocks, so a half of their gradients' sum scales every
    # bf16 rounding by a power of two and should give the blocked call's bits
    if len({hi - lo for lo, hi in blocks}) != 1 or len(blocks) & (len(blocks) - 1):
        fail(f"K2 over {n} x {s}: blocks {blocks} are not a power of two of equal size")
    parts = [fused_train_grads(pk, args[1], o[lo:hi], d[lo:hi], vd[lo:hi],
                               ts[lo:hi].contiguous(), dl[lo:hi].contiguous(), g[lo:hi], mcfg, s)
             for lo, hi in blocks]
    same = (torch.equal(got.diag, torch.cat([p.diag for p in parts]))
            and torch.equal(got.weights, torch.cat([p.weights for p in parts])))
    sums = [sum(leaves[1:], leaves[0].clone()) / len(parts)
            for leaves in zip(*(p.dw + p.db for p in parts))]
    exact = all(torch.equal(a, b) for a, b in zip(got.dw + got.db, sums))
    gap = max(leaf_err(a, b) for a, b in zip(got.dw + got.db, sums))
    print(f"K2 over {n} x {s}: against its blocks' rays in calls of their own (the gradients' "
          f"sum over {len(parts)}): diag and weights {'bit-identical' if same else 'DIFFERENT'}, "
          f"grads {'bit-identical' if exact else f'{gap:.3g} of a leaf max'} (tol {BLOCKED_TOL})")
    if not same or gap > BLOCKED_TOL:
        fail(f"K2 over {n} x {s}: the blocked call differs from its blocks called alone")
    del got, parts, sums
    torch.cuda.empty_cache()
    return k1_err, k2_err, launches


def width_cfg(name: str, base=None, **changes):
    """The flagship ModelConfig (or ``base``) at WIDTHS[name]."""
    import dataclasses

    from nerf_rs_tpu_torch import ModelConfig

    w, f, v = WIDTHS[name]
    return dataclasses.replace(base or ModelConfig(), net_width=w, feature_width=f,
                               view_head_width=v, **changes)


def check_widths(rays, gold, cam) -> tuple:
    """Phase 36's checks: at every width of WIDTHS, K1 and K2 against their
    plain versions (check_long_case: K1 at TOL, K2 at KERNEL_TOL and against
    the float64 witness, reruns bit-identical, the padded S's call equal) at
    S = 64 (relu), 192 (IPE, softplus) and 300 (the contraction with the
    disparity distortion loss, softplus), random biases, each case's launches
    exact (3 of each kernel: the call, its rerun, the padded call). Returns
    the largest differences of K1 and K2 from their plain versions and the
    launch counts by case."""
    import torch

    from nerf_rs_tpu_torch.kernels.fused_ray import fused_ray_render
    from nerf_rs_tpu_torch.kernels.fused_render import pack_weights
    from nerf_rs_tpu_torch.kernels.fused_train import fused_train_grads
    from nerf_rs_tpu_torch.models.mlp import init_nerf_params

    dev = rays[0].device
    gen = torch_generator(dev, 36)
    k1_err = k2_err = 0.0
    counts = {}
    for name in WIDTHS:
        for s, ipe, contract in WIDTH_BRANCHES:
            cfg = width_cfg(name, ipe=ipe, contract=contract,
                            sigma_activation="softplus" if ipe or contract else "relu")
            model = random_biases_(init_nerf_params(cfg, 0, dev), 36)
            n = min(N_RAYS, WIDTH_ROWS // s)
            near, far = (UNB_NEAR, UNB_FAR) if contract else (cam.near, cam.far)
            space = "disparity" if contract else "linear"
            ts, dl, _, radii = sample_inputs(n, s, ipe, cam, gen, near, far, space)
            dist = (dict(dist_weight=UNB_DIST, near=near, far=far, dist_space=space)
                    if contract else None)
            label = (f"widths {name}, S={s}{' IPE' if ipe else ''}"
                     f"{' contract + disparity distortion' if contract else ''}, {n} rays")
            print(f"{label}: {routes(pack_weights(model, cfg), s)}")
            fused_ray_render.launches = fused_train_grads.launches = 0
            a, b = check_long_case(label, model, cfg, tuple(r[:n].contiguous() for r in rays),
                                   gold[:n].contiguous(), ts, dl, radii, dist, far=far)
            got = (fused_ray_render.launches, fused_train_grads.launches)
            counts[f"{name} S={s}"] = got
            if got != (3, 3):
                fail(f"widths {name}, S={s}: K1 / K2 launches {got}, want (3, 3)")
            k1_err, k2_err = max(k1_err, a), max(k2_err, b)
            del model
    torch.cuda.empty_cache()
    print(f"phase 36 checks: K1 and K2 at every width of {list(WIDTHS)}, exact launches "
          f"{counts}")
    return k1_err, k2_err, counts


def seeded_model(mcfg, dev):
    """Seeded weights with random biases, sigma's raised by 0.5 so the sphere's
    rays gather weight, carried through convert.params_to_numpy and
    params_from_numpy as a JAX checkpoint's are."""
    from nerf_rs_tpu_torch.convert import params_from_numpy, params_to_numpy
    from nerf_rs_tpu_torch.models.mlp import NerfMLP, init_nerf_params

    tree = params_to_numpy(random_biases_(init_nerf_params(mcfg, 0, dev), 36))
    tree["sigma"]["b"] = tree["sigma"]["b"] + 0.5
    model = NerfMLP(mcfg).to(dev)
    model.load_state_dict(params_from_numpy(tree))
    return model


def width_calls(name, model, mcfg, fcfg, flat_o, flat_d, card) -> dict:
    """One K1 chunk (default_render_chunk's rays of the frame) and one K2 call
    (the recipe's 4096 rays) at ``mcfg``'s widths, each warmed, timed (best
    of 2 windows for K1, 3 for K2) beside its plain version, its library path
    and its bound, and held to the plain version's result from its timed
    window (K1 at TOL, K2 at KERNEL_TOL); the K2 call's scratch bytes and
    blocks."""
    import torch

    from nerf_rs_tpu_torch.kernels import fused_train
    from nerf_rs_tpu_torch.kernels.fused_ray import (
        fused_ray_render, fused_ray_render_reference)
    from nerf_rs_tpu_torch.kernels.fused_render import pack_weights, pack_weights_t
    from nerf_rs_tpu_torch.kernels.fused_train import (
        KERNEL_TOL, fused_train_grads, fused_train_grads_reference)
    from nerf_rs_tpu_torch.ops import render as render_ops, sampling
    from nerf_rs_tpu_torch.render import default_render_chunk

    dev = flat_o.device
    row = {}
    pk = pack_weights(model, mcfg)
    S = fcfg.render.num_samples
    row["routes"] = routes(pk, S)
    print(f"widths {name}: {row['routes']}")
    n1 = min(default_render_chunk(fcfg.render, fused=True, model_cfg=mcfg), flat_o.shape[0])
    ts = sampling.stratified_ts(n1, S, fcfg.camera.near, fcfg.camera.far, False, device=dev)
    dl = sampling.deltas_from_ts(ts, fcfg.camera.far)
    o, d = flat_o[:n1].contiguous(), flat_d[:n1].contiguous()
    vd = (d / torch.linalg.norm(d, dim=-1, keepdim=True)).contiguous()
    k1 = lambda: fused_ray_render(pk, o, d, vd, ts, dl, mcfg, S)  # noqa: E731
    got = k1()  # warms the path (and packs PackedWeights.k1) outside the windows
    ms = event_ms(k1, reps=2)  # ~1.7 s a call at 1024 wide
    step = PLAIN_CHUNK
    want = []
    plain_ms = event_ms(lambda: want.extend(fused_ray_render_reference(
        pk, o[i:i + step], d[i:i + step], vd[i:i + step], ts[i:i + step],
        dl[i:i + step], mcfg, S) for i in range(0, n1, step)), reps=1)
    want = [torch.cat(outs) for outs in zip(*want)]
    hold(f"widths {name}: the K1 chunk's {n1} rays, K1 vs plain",
         k1_errs(f"widths {name}: K1 chunk", got, want), k1_tol(fcfg.camera.far))
    del got, want

    @torch.no_grad()
    def library():
        for i in range(0, n1, 65536):
            j = slice(i, i + 65536)
            sigma, rgb_s = eager_field(model, mcfg, o[j], d[j], vd[j], ts[j])
            render_ops.composite(sigma, rgb_s, dl[j], ts=ts[j])
    library_ms = event_ms(library, reps=1)
    b, by = bound_ms(flops_per_row(mcfg, False) * n1 * S,
                     n1 * (36 + 8 * S + 20 + 8 * S) + 2 * pk.w.numel() + 4 * pk.b.numel())
    row["k1_chunk"] = {"rays": n1, "samples": S, "ms": ms, "plain_ms": plain_ms,
                       "library_ms": library_ms, "bound_ms": b, "bound_by": by}
    print(f"widths {name}: K1 chunk {n1} x {S} [{card}]: kernel {ms:.3f} ms, plain "
          f"{plain_ms:.3f} ms, library {library_ms:.3f} ms, bound {b:.3f} ms ({by}), "
          f"{flops_per_row(mcfg, False) * n1 * S / (ms * 1e-3) / 1e12:.1f} TFLOP/s")
    n2 = min(4096, flat_o.shape[0])  # the flagship recipe's rays a step
    gold = torch.rand(n2, 3, generator=torch_generator(dev, 9), device=dev)
    ts = sampling.stratified_ts(n2, S, fcfg.camera.near, fcfg.camera.far, True,
                                generator=torch_generator(dev, 10), device=dev)
    dl = sampling.deltas_from_ts(ts, fcfg.camera.far)
    o, d = flat_o[:n2].contiguous(), flat_d[:n2].contiguous()
    vd = (d / torch.linalg.norm(d, dim=-1, keepdim=True)).contiguous()
    args = (pk, pack_weights_t(pk), o, d, vd, ts, dl, gold, mcfg, S)
    k2 = lambda: fused_train_grads(*args)  # noqa: E731
    got = k2()
    ms = event_ms(k2)
    want = []
    plain_ms = event_ms(lambda: want.append(fused_train_grads_reference(*args)), reps=1)
    label = f"widths {name}: the K2 call's {n2} x {S} rows, K2 vs plain"
    hold(label, k2_errs(label, got, want[0]), KERNEL_TOL)
    del got, want

    def library2():
        model.zero_grad(set_to_none=True)
        sigma, rgb_s = eager_field(model, mcfg, o, d, vd, ts)
        render_ops.mse(render_ops.composite(sigma, rgb_s, dl).rgb, gold).backward()
    library2()
    library_ms = event_ms(library2, reps=2)
    model.zero_grad(set_to_none=True)
    b, by = bound_ms(flops_per_row(mcfg, True) * n2 * S,
                     n2 * (36 + 8 * S + 12 + 32 + 4 * S) + 2 * pk.w.numel()
                     + 4 * (pk.w.numel() + pk.b.numel()))
    scratch = fused_train._library().nerf_fused_train_scratch_bytes(
        n2, S, pk.depth, pk.W, pk.F, pk.V, pk.P, pk.D, pk.w.numel() + pk.b.numel())
    row["k2_call"] = {"rays": n2, "samples": S, "ms": ms, "plain_ms": plain_ms,
                      "library_ms": library_ms, "bound_ms": b, "bound_by": by,
                      "scratch_bytes": scratch,
                      "blocks": len(fused_train.ray_blocks(
                          n2, S, fused_train.block_rows(pk, S)))}
    print(f"widths {name}: K2 call {n2} x {S} [{card}]: kernel {ms:.3f} ms, plain "
          f"{plain_ms:.3f} ms, library {library_ms:.3f} ms, bound {b:.3f} ms ({by}), "
          f"{flops_per_row(mcfg, True) * n2 * S / (ms * 1e-3) / 1e12:.1f} TFLOP/s, "
          f"scratch {scratch:,} B in {row['k2_call']['blocks']} block(s)")
    del pk, args
    torch.cuda.empty_cache()
    return row


def routes(pk, S: int) -> str:
    """Which K1 and K2a instance the kernels take for ``pk`` at S samples
    (decided in C by shape: fused_ray.route, fused_train.route)."""
    from nerf_rs_tpu_torch.kernels import fused_ray, fused_train

    return f"K1 {fused_ray.route(pk, S)}, K2a {fused_train.route(pk, S)}"


def wide_k2_split(smoke, name: str, dev, card: str):
    """Device time by kernel of one K2 call at WIDTHS[name], the recipe's
    4096 x 64 rows built as width_calls builds them with ``smoke``'s (a
    checkout's chip_smoke module's) helpers, from a profile of 3 calls: K2a
    (its instance), K2b (dW partials, reduce, feat bias) and the rest (the
    cluster route's weight repack). Uses only the wrapper, so it times any
    checkout; None where the profile lost events."""
    import torch

    from nerf_rs_tpu_torch.kernels import fused_train
    from nerf_rs_tpu_torch.kernels.fused_render import pack_weights, pack_weights_t
    from nerf_rs_tpu_torch.kernels.fused_train import fused_train_grads
    from nerf_rs_tpu_torch.ops import sampling

    fcfg, fo, fd = smoke.frame_rays(dev)
    mcfg = smoke.width_cfg(name, fcfg.model)
    pk = pack_weights(smoke.seeded_model(mcfg, dev), mcfg)
    S, n = fcfg.render.num_samples, 4096
    o, d = fo.reshape(-1, 3)[:n].contiguous(), fd.reshape(-1, 3)[:n].contiguous()
    vd = (d / torch.linalg.norm(d, dim=-1, keepdim=True)).contiguous()
    gold = torch.rand(n, 3, generator=smoke.torch_generator(dev, 9), device=dev)
    ts = sampling.stratified_ts(n, S, fcfg.camera.near, fcfg.camera.far, True,
                                generator=smoke.torch_generator(dev, 10), device=dev)
    args = (pk, pack_weights_t(pk), o, d, vd, ts, sampling.deltas_from_ts(ts, fcfg.camera.far),
            gold, mcfg, S)
    fused_train_grads(*args)
    ms = event_ms(lambda: fused_train_grads(*args))
    per = profiled_split(lambda: fused_train_grads(*args), 3, ms, 0.0)
    route = fused_train.route(pk, S) if hasattr(fused_train, "route") else "mma.sync wide"
    if per is None:
        print(f"widths {name}: K2 call {n} x {S} [{card}]: {ms:.3f} ms, K2a {route}; "
              f"device time {NOT_PROFILED}")
        return None
    k2a = sum(v for k, v in per.items() if re.search(r"train_\w*kernel", k))
    k2b = sum(v for k, v in per.items() if re.search(K2B_KERNELS, k))
    rest = sum(per.values()) - k2a - k2b
    b2, by2, nb2 = k2b_floor(pk, n * S)
    print(f"widths {name}: K2 call {n} x {S} [{card}]: {ms:.3f} ms (CUDA events), K2a {route}; "
          f"device time K2a {k2a:.3f} ms, K2b {k2b:.3f} ms, the rest {rest:.3f} ms ("
          + ", ".join(f"{kernel_name(k)} {v:.3f}" for k, v in
                      sorted(per.items(), key=lambda kv: -kv[1]))
          + f"); K2b's floor {b2:.3f} ms ({by2}: {nb2 / 1e9:.3f} GB)")
    del pk, args
    torch.cuda.empty_cache()
    return {"ms": ms, "k2a": k2a, "k2b": k2b, "rest": rest, "route": route}


def drive_wide(tmp: str, card: str, dev) -> dict:
    """Phase 36's runs, at each width of WIDE_RUNS: train/loop.train takes
    WIDE_STEPS steps of the flagship recipe (`--preset full` on the sphere:
    4096 rays x 64 samples, Adam 5e-4, mixed) through K2, exactly one launch a
    step and no K1, timed beside the same run through autograd (no K2);
    then seeded weights (seeded_model) render the 800x800 view with
    render_frame through K1 twice (its exact chunk count each time, the two
    frames' bits equal, the first chunk's rays held to the plain version at
    TOL), timed beside the eager field's frame (best of 2 each); the steps
    alone (best of 2 windows of WIDE_WINDOW) and width_calls. At each
    width of PADDED_RUNS width_calls alone. Returns the rows by width."""
    import dataclasses

    import torch

    from nerf_rs_tpu_torch.data.factory import make_dataset
    from nerf_rs_tpu_torch.kernels.fused_ray import (
        fused_ray_render, fused_ray_render_reference)
    from nerf_rs_tpu_torch.kernels.fused_render import pack_weights
    from nerf_rs_tpu_torch.kernels.fused_train import fused_train_grads
    from nerf_rs_tpu_torch.ops import sampling
    from nerf_rs_tpu_torch.render import default_render_chunk, render_frame
    from nerf_rs_tpu_torch.train.loop import train
    from nerf_rs_tpu_torch.train.step import init_state, make_train_step, step_generator

    out = {}
    fcfg0, fo, fd = frame_rays(dev)
    flat_o, flat_d = fo.reshape(-1, 3), fd.reshape(-1, 3)
    for name in WIDE_RUNS:
        row = out[name] = {}
        run_dir = os.path.join(tmp, f"wide-{name.replace('/', '-')}")
        base = preset_cfg("full")
        cfg = dataclasses.replace(
            base, model=width_cfg(name, base.model), log_dir=run_dir, save_dir=run_dir,
            train=dataclasses.replace(base.train, num_iter=WIDE_STEPS, eval_steps=10 ** 6,
                                      save_steps=10 ** 6, logging_steps=10 ** 6))
        ds = make_dataset(cfg, dev)
        for route, c in (("K2", cfg), ("autograd", dataclasses.replace(
                cfg, use_whole_ray_train=False, save_dir=run_dir + "-autograd"))):
            fused_ray_render.launches = fused_train_grads.launches = 0
            log = io.StringIO()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(log):
                state = train(c, ds)
            torch.cuda.synchronize()
            row[f"train_{route}_s"] = time.perf_counter() - t0
            want = (WIDE_STEPS if route == "K2" else 0, 0)
            got = (fused_train_grads.launches, fused_ray_render.launches)
            row[f"train_{route}_launches"] = got[0]
            if got != want or state.step != WIDE_STEPS:
                fail(f"widths {name}: {WIDE_STEPS}-step train through {route}: K2 / K1 "
                     f"launches {got} (want {want}), step {state.step}")
            if not all(bool(torch.isfinite(p).all()) for p in state.params.parameters()):
                fail(f"widths {name}: {WIDE_STEPS}-step train through {route}: non-finite "
                     "weights")
            del state
        print(f"widths {name}: {WIDE_STEPS}-step train/loop.train of --preset full [{card}]: "
              f"through K2 {row['train_K2_s']:.3f} s ({WIDE_STEPS} launches), through "
              f"autograd {row['train_autograd_s']:.3f} s (set-up and the checkpoint included)")
        for route, c in (("K2", cfg), ("autograd", dataclasses.replace(
                cfg, use_whole_ray_train=False))):
            state = init_state(c, dev)
            fn = make_train_step(c, ds)
            it = [0]

            def run(k):
                nonlocal state
                for _ in range(k):
                    state, _ = fn(state, step_generator(0, it[0], dev))
                    it[0] += 1
            run(1)
            row[f"step_{route}_ms"] = best_of(lambda: run(WIDE_WINDOW), 2) / WIDE_WINDOW * 1e3
            del state
        print(f"widths {name}: train step [{card}]: K2 {row['step_K2_ms']:.3f} ms, autograd "
              f"{row['step_autograd_ms']:.3f} ms (best of 2 windows of {WIDE_WINDOW})")

        # the frame from seeded weights: 20 steps at lr 5e-4 take the 1024-wide field to
        # an opaque, saturated one, a frame that would show nothing
        model = seeded_model(cfg.model, dev)
        fcfg = dataclasses.replace(fcfg0, model=cfg.model)
        chunk = default_render_chunk(fcfg.render, fused=True, model_cfg=fcfg.model)
        chunks = math.ceil(FRAME * FRAME / chunk)
        frames, e_frames = [], []
        fused_ray_render.launches = 0
        row["frame_K1_s"] = best_of(lambda: frames.append(render_frame(fcfg, model, fo, fd)),
                                    2)
        row["frame_launches"] = fused_ray_render.launches // 2
        if fused_ray_render.launches != 2 * chunks:
            fail(f"widths {name}: two 800x800 frames: K1 launches "
                 f"{fused_ray_render.launches}, want {2 * chunks}")
        if not all(torch.equal(a, b) for a, b in zip(*frames)):
            fail(f"widths {name}: two 800x800 frames through K1 gave different bits")
        rgb, depth, acc = frames.pop()
        del frames
        if not (bool(torch.isfinite(rgb).all()) and bool(torch.isfinite(depth).all())):
            fail(f"widths {name}: 800x800 frame has non-finite values")
        eager = dataclasses.replace(fcfg, use_fused_kernel=False)
        row["frame_eager_s"] = best_of(
            lambda: e_frames.append(render_frame(eager, model, fo, fd)[0]), 2)
        e_rgb = e_frames.pop()
        del e_frames
        pk = pack_weights(model, cfg.model)
        S = fcfg.render.num_samples
        n = PLAIN_CHUNK
        ts = sampling.stratified_ts(n, S, fcfg.camera.near, fcfg.camera.far, False, device=dev)
        dl = sampling.deltas_from_ts(ts, fcfg.camera.far)
        o, d = flat_o[:n].contiguous(), flat_d[:n].contiguous()
        vd = (d / torch.linalg.norm(d, dim=-1, keepdim=True)).contiguous()
        plain = fused_ray_render_reference(pk, o, d, vd, ts, dl, cfg.model, S)
        hold(f"widths {name}: the frame's first {n} rays, K1 vs plain",
             {"rgb": float((rgb.reshape(-1, 3)[:n] - plain[0]).abs().max())},
             {"rgb": TOL["rgb"]})
        gap = float((rgb - e_rgb).abs().max())
        print(f"widths {name}: 800x800 frame [{card}]: K1 {row['frame_K1_s']:.3f} s "
              f"({chunks} launches a frame), eager field {row['frame_eager_s']:.3f} s (best "
              f"of 2 frames each; rgb apart by "
              f"{gap:.3g} at most); rgb in [{float(rgb.min()):.4f}, {float(rgb.max()):.4f}], "
              f"mean acc {float(acc.mean()):.4f}")
        del plain, e_rgb, rgb, depth, acc

        row.update(width_calls(name, model, cfg.model, fcfg, flat_o, flat_d, card))
        del model
        torch.cuda.empty_cache()
    for name in PADDED_RUNS:  # the padded widths' calls, on the narrow instances
        mcfg = width_cfg(name, fcfg0.model)
        out[name] = width_calls(name, seeded_model(mcfg, dev), mcfg,
                                dataclasses.replace(fcfg0, model=mcfg), flat_o, flat_d, card)
    return out


# Phase 37: the caps the JAX package never had, lifted. Fault 15: the offset
# tables leave the launch parameters (K1/K2 past depth 123 at width 64, K3
# past 256 levels); fault 17: encodings no wgmma layout holds take the wide
# instance (pos_enc_levels 20, P = 128, at the paper widths: K1 wide; 34, P =
# 208: K2 wide too); fault 16: the flat hash table at any F (gather_rows and
# scatter_rows past 4-aligned widths, 32 lanes and 128 columns)
LIFT_DEPTH = 130
LIFT_NARROW = dict(net_width=64, feature_width=64, view_head_width=32, skip_layer=4)
LIFT_PE = ((20, "relu"), (34, "softplus"))
LIFT_LEVELS = 300
LIFT_CHECK_RAYS = 256  # K3's checks at 300 levels: 32,768 points (the plain dense hat: 5.7 GB)
LIFT_FEATURES = 8  # the flat table's F of the train and frame drive
LIFT_WIDE_F = 40  # one step at this F
# rays whose fetches time gather_rows / scatter_rows at each F (the plain
# scatter's elements stay those of the F = 2 step's: 1.3e8 and 1.7e8)
LIFT_TIMED = {8: 1024, 40: 256}


def unit_variance_(model, cfg, o, d, ts):
    """Scales each trunk layer's weights so that its relu output has an RMS
    of 1 on the rays' samples (layer-sequential unit variance): a trunk of
    130 layers then keeps its signal and its gradients (at the initial scale
    they fade to ~1e-12 of the heads' by the first layer), so K2's leaves
    are compared where they carry a gradient. Returns ``model``."""
    import torch

    from nerf_rs_tpu_torch.models.encoding import posenc

    with torch.no_grad():
        x = posenc((o[:, None] + ts[..., None] * d[:, None]).reshape(-1, 3).double(),
                   cfg.pos_enc_levels, True)
        h = x
        for i, layer in enumerate(model.trunk):
            inp = torch.cat([h, x], -1) if i == cfg.skip_layer and i > 0 else h
            out = torch.relu(inp @ layer.w.double())
            rms = out.square().mean().sqrt()
            layer.w.div_(rms.float())
            h = out / rms
    return model


# How far from the float64 witness K1 and K2 may stand on the deep trunk, as a
# multiple of the plain version's own distance (per output; per gradient leaf
# relative to its max; at least TOL / KERNEL_TOL): the bf16 rounding of every
# activation, flipped by the f32 summation order, compounds through 130 layers,
# and on an H100 the plain version stood up to 2.1e-2 (weights), 0.34 (sigma)
# and 1.4e-2 (a leaf) from its witness, the kernels at most 1.81x as far
# (tests/test_torch_cuda.py DEEP_WITNESS_FACTOR)
DEEP_WITNESS_FACTOR = 2.5


def check_deep_case(label, model, cfg, rays, gold, ts, dl) -> tuple:
    """K1 and K2 on the deep trunk: each run twice, bit-identical, and held
    to the float64 witness at DEEP_WITNESS_FACTOR times the plain version's
    distance from it. Returns K1's and K2's largest differences from their
    plain versions (printed beside the plain version's from the witness)."""
    import torch

    from nerf_rs_tpu_torch.kernels.fused_ray import fused_ray_render, fused_ray_render_reference
    from nerf_rs_tpu_torch.kernels.fused_render import pack_weights, pack_weights_t
    from nerf_rs_tpu_torch.kernels.fused_train import (
        KERNEL_TOL, fused_train_grads, fused_train_grads_reference)

    s = ts.shape[1]
    pk = pack_weights(model, cfg)
    want_narrow(pk, s, f"K2 [{label}]")
    args = (pk, *rays, ts, dl, cfg, s)
    got = fused_ray_render(*args)
    if not all(torch.equal(a, b) for a, b in zip(got, fused_ray_render(*args))):
        fail(f"two K1 launches [{label}] gave different bits")
    plain = fused_ray_render_reference(*args)
    wit = fused_ray_render_reference(*args, dtype=torch.float64)
    k1_err, gaps = 0.0, []
    for name, g, p, w in zip(TOL, got, plain, wit):
        mine, theirs = (float((x.double() - w).abs().max()) for x in (g, p))
        bar = max(TOL[name], DEEP_WITNESS_FACTOR * theirs)
        gaps.append(f"{name} {mine:.3g} / {theirs:.3g}")
        k1_err = max(k1_err, float((g - p).abs().max()))
        if not mine <= bar:
            fail(f"K1 [{label}] {name}: {mine:.3g} from the witness, bar {bar:.3g}")
    print(f"K1 [{label}] from the float64 witness, kernel / plain: {', '.join(gaps)}")
    del got, plain, wit
    targs = (pk, pack_weights_t(pk), *rays, ts, dl, gold, cfg, s)
    tg = fused_train_grads(*targs, white_bg=True)
    if not all(torch.equal(a, b) for a, b in zip(
            k2_outs(tg), k2_outs(fused_train_grads(*targs, white_bg=True)))):
        fail(f"two K2 launches [{label}] gave different bits")
    plain = fused_train_grads_reference(*targs, white_bg=True)
    wit = fused_train_grads_reference(*targs, white_bg=True, dtype=torch.float64)
    worst = {"diag": (0.0, 0.0), "weights": (0.0, 0.0), "grads": (0.0, 0.0)}
    for key, g, p, w in (("diag", tg.diag[:, :6], plain.diag[:, :6], wit.diag[:, :6]),
                         ("weights", tg.weights, plain.weights, wit.weights),
                         *(("grads", *x) for x in zip(tg.dw + tg.db, plain.dw + plain.db,
                                                      wit.dw + wit.db))):
        scale = max(float(w.abs().max()), 1e-12) if key == "grads" else 1.0
        mine, theirs = (float((x.double() - w).abs().max()) / scale for x in (g, p))
        if not mine <= max(KERNEL_TOL[key], DEEP_WITNESS_FACTOR * theirs):
            fail(f"K2 [{label}] {key}: {mine:.3g} from the witness, the plain version {theirs:.3g}")
        worst[key] = tuple(map(max, worst[key], (mine, theirs)))
    print(f"K2 [{label}] from the float64 witness, kernel / plain: "
          + ", ".join(f"{k} {a:.3g} / {b:.3g}" for k, (a, b) in worst.items()))
    k2_err = k2_abs(tg, plain)
    del tg, plain, wit
    torch.cuda.empty_cache()
    return k1_err, k2_err


def check_lifted(rays, gold, cam) -> tuple:
    """Phase 37's K1 and K2 checks on the N_RAYS rays at S = 64: depth
    LIFT_DEPTH at width 64 (scaled to unit variance; check_deep_case, 2
    launches of each), and the paper widths at each encoding of LIFT_PE
    (check_long_case: against the plain versions, K2 also the float64
    witness, reruns bit-identical, the padded call equal; 3 launches of
    each), where K1 must ask for the wide instance's scratch. Returns K1's
    and K2's largest differences from their plain versions and the launch
    counts by case."""
    import torch

    from nerf_rs_tpu_torch import ModelConfig
    from nerf_rs_tpu_torch.kernels import fused_ray
    from nerf_rs_tpu_torch.kernels.fused_ray import fused_ray_render
    from nerf_rs_tpu_torch.kernels.fused_render import pack_weights
    from nerf_rs_tpu_torch.kernels.fused_train import fused_train_grads
    from nerf_rs_tpu_torch.models.mlp import init_nerf_params

    dev = rays[0].device
    gen = torch_generator(dev, 37)
    k1_err = k2_err = 0.0
    counts = {}
    cases = [(f"depth {LIFT_DEPTH} (width 64) softplus",
              ModelConfig(net_depth=LIFT_DEPTH, sigma_activation="softplus", **LIFT_NARROW))]
    cases += [(f"pos_enc_levels {lv} {act}", ModelConfig(pos_enc_levels=lv, sigma_activation=act))
              for lv, act in LIFT_PE]
    for label, cfg in cases:
        ts, dl, _, _ = sample_inputs(N_RAYS, 64, False, cam, gen)
        model = random_biases_(init_nerf_params(cfg, 0, dev), 37)
        if cfg.net_depth > 100:
            unit_variance_(model, cfg, rays[0], rays[1], ts)
        pk = pack_weights(model, cfg)
        scratch = fused_ray._library().nerf_fused_ray_scratch_bytes(
            N_RAYS, 64, pk.depth, pk.W, pk.F, pk.V, pk.P, pk.D)
        if (scratch > 0) != (cfg.pos_enc_levels >= 19):
            fail(f"phase 37 [{label}]: K1's scratch {scratch} B: the wide routes are for "
                 f"encodings past P = 112 only")
        fused_ray_render.launches = fused_train_grads.launches = 0
        deep = cfg.net_depth > 100
        a, b = (check_deep_case if deep else check_long_case)(
            f"{label}, S=64, {N_RAYS} rays", model, cfg, rays, gold, ts, dl)
        got = (fused_ray_render.launches, fused_train_grads.launches)
        want = (2, 2) if deep else (3, 3)
        counts[label] = got
        if got != want:
            fail(f"phase 37 [{label}]: K1 / K2 launches {got}, want {want}")
        print(f"phase 37 [{label}]: {routes(pk, 64)} (K1's scratch {scratch:,} B), P = "
              f"{pk.P}, {len(pk.w_off)} packed matrices")
        k1_err, k2_err = max(k1_err, a), max(k2_err, b)
        del model, pk
    torch.cuda.empty_cache()
    return k1_err, k2_err, counts


def check_lifted_factored(ds, cam) -> dict:
    """K3 at LIFT_LEVELS levels (past the former 256, the preset's ladder and
    channels): forward against its plain version at KERNEL_TOL and its
    reruns, backward by check_backward_case (plain and float64 witness,
    reruns), bf16 and f32 lines, on LIFT_CHECK_RAYS rays' points; one launch
    of each a call. Returns the largest differences."""
    import torch

    from nerf_rs_tpu_torch import ModelConfig
    from nerf_rs_tpu_torch.kernels import fused_factored as k3
    from nerf_rs_tpu_torch.models.factored import basis_dim

    cfg = ModelConfig(arch="factored", fac_levels=LIFT_LEVELS)
    dev = ds.images.device
    gen = torch_generator(dev, 37)
    lines = 0.25 * torch.randn(3, basis_dim(cfg), cfg.fac_comps, generator=gen, device=dev)
    pts = factored_points(ds, cam, LIFT_CHECK_RAYS, 37)
    g = torch.randn(pts.shape[0], cfg.fac_comps, generator=gen, device=dev)
    errs = {"enc": 0.0, "d_lines": 0.0, "d_lines_abs": 0.0}
    for name, dtype in (("bf16", torch.bfloat16), ("f32", None)):
        label = f"{name}, {LIFT_LEVELS} levels (sumR {basis_dim(cfg)}), {pts.shape[0]} points"
        k3.fused_factored_encode.launches = k3.fused_factored_encode_backward.launches = 0
        enc = k3.fused_factored_encode_forward(lines, pts, cfg, dtype)
        if not torch.equal(enc, k3.fused_factored_encode_forward(lines, pts, cfg, dtype)):
            fail(f"two K3 forward launches [{label}] gave different bits")
        got = float((enc - k3.fused_factored_encode_reference(lines, pts, cfg, dtype))
                    .abs().max())
        hold(f"K3 forward vs plain [{label}]", {"enc": got}, k3.KERNEL_TOL)
        e = check_backward_case(label, lines, pts, g, cfg, dtype)
        launches = (k3.fused_factored_encode.launches, k3.fused_factored_encode_backward.launches)
        if launches != (2, 2):
            fail(f"K3 [{label}]: forward / backward launches {launches}, want (2, 2)")
        errs["enc"], errs["d_lines"] = max(errs["enc"], got), max(errs["d_lines"], e["d_lines"])
        errs["d_lines_abs"] = max(errs["d_lines_abs"], e["abs"])
        del enc
    del lines, g, pts
    torch.cuda.empty_cache()
    return errs


def flat_fetch_inputs(dev, features: int, n_rays: int) -> tuple:
    """The row fetch of the flat table at F = ``features`` (gather_rows,
    fault 16) of one ngp step's encode on ``n_rays`` rays x 128 jittered
    samples (factored_points, as ngp_fetch_inputs), captured on a seed-0
    table, and its backward's scatter_rows call with seeded cotangents:
    ({"rows": (table, row indices)}, (g, keys, None, lanes, shape))."""
    import torch

    from nerf_rs_tpu_torch.data.factory import make_dataset
    from nerf_rs_tpu_torch.models import hashgrid
    from nerf_rs_tpu_torch.models.mlp import init_nerf_params

    cfg = flat_cfg(features)
    seen = {}
    real = hashgrid._RowFetch.apply

    def spy(table, ridx):
        seen.setdefault("rows", (table, ridx.clone()))
        return real(table, ridx)
    hashgrid._RowFetch.apply = staticmethod(spy)
    try:
        pts = factored_points(make_dataset(cfg, dev), cfg.camera, n_rays, 21)
        with torch.no_grad():
            hashgrid.hash_encode(init_nerf_params(cfg.model, 0, dev).table.detach(), pts,
                                 cfg.model)
    finally:
        del hashgrid._RowFetch.apply  # back to autograd.Function's own
    table, ridx = seen["rows"]
    g = torch.randn(ridx.shape[0], features, generator=torch_generator(dev, 23), device=dev)
    return seen, (g, ridx, None, tuple(range(features)), tuple(table.shape))


def drive_flat_features(tmp: str, fo, fd, features: int) -> dict:
    """The flat hash table at F = ``features`` through the library (the CLI
    has no flag for the table's features, as the JAX CLI has none):
    train/loop.train of `--preset ngp --hash_brick false` for NGP_STEPS steps
    (an eval at step 50), each step's encode one gather_rows launch and its
    backward one scatter_rows, gather_pairs none; then the 800x800
    render_frame of the trained field, one gather_rows launch per render
    chunk, its first chunk through K4 and through the plain route with the
    same bits. Returns the launch counts by path."""
    import torch

    from nerf_rs_tpu_torch.data.factory import make_dataset
    from nerf_rs_tpu_torch.kernels import gather_rows as k4
    from nerf_rs_tpu_torch.ops import render as render_ops
    from nerf_rs_tpu_torch.render import default_render_chunk, render_frame
    from nerf_rs_tpu_torch.train.loop import train as train_loop

    name = f"flat F={features}"
    cfg = flat_cfg(features)
    run_dir = os.path.join(tmp, f"ngp-F{features}")
    cfg = dataclasses.replace(cfg, log_dir=run_dir, save_dir=run_dir, train=dataclasses.replace(
        cfg.train, num_iter=NGP_STEPS, eval_steps=50, save_steps=10 ** 6))
    want = (NGP_STEPS + ngp_render_fetches(cfg, cfg.camera.width * cfg.camera.height), 0,
            NGP_STEPS)
    reset_k4()
    t0 = time.perf_counter()
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        state = train_loop(cfg, make_dataset(cfg, fo.device))
    got = (k4.gather_rows.launches, k4.gather_pairs.launches, k4.scatter_rows.launches)
    losses = [float(v) for v in re.findall(r"iter=\d+, loss=(\S+)", log.getvalue())]
    evals = [float(v) for v in re.findall(r"eval psnr=(\S+)", log.getvalue())]
    print(f"ngp [{name}] train/loop.train, {NGP_STEPS} steps: gather_rows / gather_pairs / "
          f"scatter_rows launches {got} (want {want}), losses {losses}, eval psnr {evals}, "
          f"{time.perf_counter() - t0:.1f} s")
    if (got != want or not losses or len(evals) != 1
            or not all(map(math.isfinite, losses + evals))):
        fail(f"ngp [{name}] train: launches {got} (want {want}), losses {losses}, evals {evals}")
    counts = {"train": got[0], "train_scatter": got[2]}
    fcfg = dataclasses.replace(cfg, camera=dataclasses.replace(cfg.camera, width=FRAME,
                                                               height=FRAME))
    frame_k4 = ngp_render_fetches(fcfg, FRAME * FRAME)
    reset_k4()
    rgb, depth, _ = render_frame(fcfg, state.params, fo, fd)
    torch.cuda.synchronize()
    got = (k4.gather_rows.launches, k4.gather_pairs.launches, k4.scatter_rows.launches)
    counts["frame"] = got[0]
    if got != (frame_k4, 0, 0) or frame_k4 != NGP_K4["flat"][2]:
        fail(f"ngp [{name}] 800x800 frame: launches {got} (want ({frame_k4}, 0, 0))")
    if not (bool(torch.isfinite(rgb).all()) and bool(torch.isfinite(depth).all())):
        fail(f"ngp [{name}] 800x800 frame: non-finite values")
    chunk = default_render_chunk(fcfg.render, model_cfg=fcfg.model)
    with plain_gather_route(), torch.no_grad():
        plain = render_ops.render_rays(
            state.params, fo.reshape(-1, 3)[:chunk], fd.reshape(-1, 3)[:chunk], fcfg.model,
            fcfg.render, fcfg.camera, randomized=False, dtype=torch.bfloat16)[0].rgb
    if not torch.equal(rgb.reshape(-1, 3)[:chunk], plain):
        fail(f"ngp [{name}] frame: K4 and the plain route differ by "
             f"{float((rgb.reshape(-1, 3)[:chunk] - plain).abs().max())}")
    print(f"ngp [{name}] 800x800 frame: {frame_k4} gather_rows launches, its first {chunk} rays "
          f"bit-equal to the plain route; rgb in [{float(rgb.min()):.4f}, "
          f"{float(rgb.max()):.4f}]")
    return counts


def flat_cfg(features: int, *extra):
    """`--preset ngp --hash_brick false` (ngp_cfg) with the table's F."""
    cfg = ngp_cfg("flat", *extra)
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, hash_features=features))


def flat_step(fo, features: int, num_rays: int) -> dict:
    """One train step of the flat table at F = ``features`` on ``num_rays``
    rays (make_train_step): one gather_rows and one scatter_rows launch, a
    finite loss and table. Returns the launch counts."""
    import torch

    from nerf_rs_tpu_torch.data.factory import make_dataset
    from nerf_rs_tpu_torch.kernels import gather_rows as k4
    from nerf_rs_tpu_torch.train.step import init_state, make_train_step, step_generator

    cfg = flat_cfg(features, "--num_rays", str(num_rays))
    state = init_state(cfg, fo.device)
    fn = make_train_step(cfg, make_dataset(cfg, fo.device))
    reset_k4()
    state, aux = fn(state, step_generator(0, 0, fo.device))
    loss = float(aux["loss"])
    got = (k4.gather_rows.launches, k4.gather_pairs.launches, k4.scatter_rows.launches)
    finite = bool(torch.isfinite(state.params.table).all())
    print(f"ngp [flat F={features}] one train step on {num_rays} rays: gather_rows / "
          f"gather_pairs / scatter_rows launches {got} (want (1, 0, 1)), loss {loss:.6f}, "
          f"table finite {finite}")
    if got != (1, 0, 1) or not math.isfinite(loss) or not finite:
        fail(f"ngp [flat F={features}] step: launches {got}, loss {loss}, table finite {finite}")
    return {"train": got[0], "train_scatter": got[2]}


def drive_lifted_features(tmp: str, card: str, fo, fd) -> dict:
    """Phase 37's flat hash tables past F = 2: drive_flat_features at F =
    LIFT_FEATURES (NGP_STEPS steps and the 800x800 frame) and flat_step at F
    = LIFT_WIDE_F (1,024 rays), then gather_rows and scatter_rows at each F
    of LIFT_TIMED: bit-equal to their plain versions (scatter also across
    launches) and timed (time_gather, time_scatter). Returns the counts and
    the times."""
    import torch

    from nerf_rs_tpu_torch.kernels import gather_rows as k4

    out = {"counts": drive_flat_features(tmp, fo, fd, LIFT_FEATURES),
           "step_counts": flat_step(fo, LIFT_WIDE_F, 1024)}
    out["times"] = {}
    for features, n_rays in LIFT_TIMED.items():
        fetch, scatter = flat_fetch_inputs(fo.device, features, n_rays)
        g, key, lane0, lanes, shape = scatter
        got = k4.scatter_rows(g, key, lane0, lanes, shape)
        again = k4.scatter_rows(g, key, lane0, lanes, shape)
        if not (torch.equal(got, again)
                and torch.equal(got, k4.scatter_rows_reference(g, key, lane0, lanes, shape))):
            fail(f"scatter_rows [flat F={features}]: differs from its plain version or across "
                 f"launches")
        print(f"scatter_rows [flat F={features}], {g.shape[0]} fetches into {shape}: bit-equal "
              f"to its plain version and across launches")
        del got, again
        out["times"][f"F={features}"] = {
            "gather_rows": time_gather(card, fetch)["gather_rows"],
            "scatter_rows": time_scatter(card, {f"flat F={features}": scatter})[
                f"flat F={features}"]}
        del fetch, scatter, g, key
        torch.cuda.empty_cache()
    return out

def check_rays(dev):
    """The N_RAYS rays of two poses that phases 3-4, 9, 18, 33 and 36 check
    the whole-ray kernels on, their view directions and sphere gold, and the
    64x64 camera: ((o, d, vd), gold, cam)."""
    import torch

    from nerf_rs_tpu_torch import CameraConfig
    from nerf_rs_tpu_torch.data import synthetic
    from nerf_rs_tpu_torch.ops import rays as rays_ops

    cam = CameraConfig(width=64, height=64)
    poses = rays_ops.pose_from_yaw_pitch(
        torch.tensor([0.37, 2.1]), torch.tensor([0.21, 0.9]), device=dev)
    grids = [rays_ops.ray_grid(poses[i], cam) for i in range(2)]
    o = torch.cat([g[0].reshape(-1, 3) for g in grids])[:N_RAYS].contiguous()
    d = torch.cat([g[1].reshape(-1, 3) for g in grids])[:N_RAYS].contiguous()
    vd = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    gold = synthetic.sphere_image(cam, device=dev)[..., :3].reshape(-1, 3)
    gold = torch.cat([gold, gold])[:N_RAYS].contiguous()
    return (o, d, vd), gold, cam


def drive_long_cli(tmp: str, ckpt_path: str) -> dict:
    """Phase 34: `cli train --preset full --num_samples 300` and `--preset
    hierarchical --num_fine_samples 256` (a 320-sample union) for LONG_STEPS
    steps each, with exact K2 counts (ray_blocks' launches a call), and
    `cli render --num_samples 300` of the flagship checkpoint at 800x800
    with one K1 launch a render chunk. Returns each path's counts."""
    from nerf_rs_tpu_torch.kernels.fused_ray import fused_ray_render, padded_samples
    from nerf_rs_tpu_torch.kernels.fused_train import fused_train_grads, ray_blocks
    from nerf_rs_tpu_torch.render import default_render_chunk

    counts = {}
    for key, preset, flags in (("full_300", "full", ("--num_samples", "300")),
                               ("hierarchical_fine256", "hierarchical",
                                ("--num_fine_samples", "256"))):
        cfg = preset_cfg(preset, *flags)
        r = cfg.render
        calls = ([r.num_samples, r.num_samples + r.num_fine_samples] if r.num_fine_samples
                 else [r.num_samples])
        want = LONG_STEPS * sum(len(ray_blocks(cfg.train.num_rays, padded_samples(c)))
                                for c in calls)
        ckdir = os.path.join(tmp, f"long-{key}")
        fused_train_grads.launches = 0
        fused_ray_render.launches = 0
        t0 = time.perf_counter()
        rc, out = run_cli(["train", "--preset", preset, "--dataset", "sphere", *flags,
                           "--num_iter", str(LONG_STEPS), "--eval_steps", "1000",
                           "--save_steps", "1000", "--save_dir", ckdir, "--log_dir", ckdir])
        k2 = fused_train_grads.launches
        losses = [float(v) for v in re.findall(r"iter=\d+, loss=(\S+)", out)]
        print(f"cli train --preset {preset} {' '.join(flags)}, {LONG_STEPS} steps (calls at S = "
              f"{calls}): rc {rc}, K2 launches {k2} (want {want}), "
              f"{time.perf_counter() - t0:.1f} s")
        if rc != 0 or k2 != want or not losses or not all(map(math.isfinite, losses)):
            fail(f"train --preset {preset} {flags}: rc {rc}, K2 launches {k2} (want {want}), "
                 f"losses {losses}")
        counts[f"long_{key}_train"] = k2
    rcfg = cli_config(["render", "--dataset", "sphere", "--num_samples", "300"])
    want = math.ceil(FRAME * FRAME / default_render_chunk(rcfg.render, fused=True,
                                                          model_cfg=rcfg.model))
    out_dir = os.path.join(tmp, "long-render")
    fused_ray_render.launches = 0
    rc, out = run_cli(["render", "--dataset", "sphere", "--width", str(FRAME), "--height",
                       str(FRAME), "--view", "0", "--num_samples", "300", "--load_path",
                       ckpt_path, "--out_dir", out_dir])
    k1 = fused_ray_render.launches
    m = re.search(r"psnr=(\S+)", out)
    print(f"cli render --num_samples 300 at {FRAME}x{FRAME}: rc {rc}, K1 launches {k1} "
          f"(want {want}: one a chunk)")
    if rc != 0 or k1 != want or m is None or not math.isfinite(float(m.group(1))):
        fail(f"render --num_samples 300: rc {rc}, K1 launches {k1} (want {want})")
    png = read_png(os.path.join(out_dir, "view-0.png"))
    if png.shape != (FRAME, FRAME, 3):
        fail(f"long-ray view-0.png has shape {png.shape}")
    counts["long_render_300"] = k1
    return counts


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


# K2b's kernels in a profile: the dW reduction (this tree's dw_wgmma_kernel,
# or an older checkout's dw_partial_kernel / colsum kernel), the splits'
# reduce and d feat_b
K2B_KERNELS = r"dw_wgmma|dw_partial|colsum|reduce_kernel|feat_bias"


def k2b_floor(pk, rows: int) -> tuple:
    """K2b's bound for a K2 call over ``rows`` stash rows (n rays x S, the
    rows the function needs: a padded ray's pad rows carry a zero G and
    count for nothing), from the packed widths alone (so it reads any
    checkout): one read of every bf16 stash a row (PE(x), each trunk layer's h and G, the
    feature, [dfeat | dsigma | 0], h_v and g_v, PE(d), d rgb_raw) and one
    write of the f32 gradient, against the products dW = A^T G of every
    weight matrix. (ms, what bounds it, bytes)."""
    L, W, F, V, P, D = pk.depth, pk.W, pk.F, pk.V, pk.P, pk.D
    row = 2 * (P + 2 * L * W + F + (F + 8) + 2 * V + D + 8)
    nbytes = rows * row + 4 * (pk.w.numel() + pk.b.numel())
    skip = P * W if 0 < pk.skip_layer < L else 0
    macs = P * W + (L - 1) * W * W + skip + W * (F + 8) + F * V + D * V + V * 8
    ms, by = bound_ms(2.0 * rows * macs, nbytes)
    return ms, by, nbytes


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


def time_branches(card: str, model, mcfg, cam, flat_o, flat_d, shapes=BRANCH_SHAPES,
                  plain_too: bool = True, witness: bool = False) -> list:
    """The branches' kernel calls at the presets' shapes (``shapes``, by
    default the hierarchical ones: a whole K1 chunk of the mipnerf fine
    pass's 131,072 rays x 128 IPE intervals and of the hierarchical union
    pass's 65,536 x 192, and K2's 4096-ray calls; phase 20 passes the
    unbounded presets'). Each is held to its plain version (TOL with the
    depth bar scaled to the range, KERNEL_TOL) and timed against it,
    against a PyTorch library path computing the same function (K1: the
    eager bf16 field, with the contraction when on, + composite; K2:
    autograd of the eager loss, with the distortion loss when on) and
    against its bound (the contraction and the distortion loss are
    elementwise and per-ray work: the products bound both). Each K2 row also
    splits the call's device time by kernel (a profile of 3 calls). With
    ``plain_too`` False (--time-step) the plain version is neither run nor
    timed; with ``witness`` each K2 call is also held to the float64
    witness. Returns one row each."""
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
    for kernel, name, ipe, contract, space, n, s, near, far, white in shapes:
        cfg = dataclasses.replace(mcfg, ipe=ipe, contract=contract,
                                  sigma_activation="softplus" if ipe or contract else "relu")
        o, d = flat_o[:n].contiguous(), flat_d[:n].contiguous()
        vd = (d / torch.linalg.norm(d, dim=-1, keepdim=True)).contiguous()
        ts, dl, edges, radii = sample_inputs(n, s, ipe, cam, torch_generator(dev, 3), near, far,
                                             "disparity" if contract else "linear")
        radius = sampling.pixel_radius(cam) if ipe else None
        dist = ({} if space is None
                else dict(dist_weight=UNB_DIST, near=near, far=far, dist_space=space))
        pk = pack_weights(model, cfg)
        io = n * (36 + 8 * s + (4 if ipe else 0))  # rays, samples and radii in
        label = f"{kernel} vs plain [{name}, {n} rays]"
        if kernel == "K1":
            args = (pk, o, d, vd, ts, dl, cfg, s)
            step = max(1, PLAIN_CHUNK * 256 // max(s, 256))  # at most 8.4 M plain rows a call
            chunks = [slice(i, i + step) for i in range(0, n, step)]
            fn = lambda: fused_ray_render(*args, radii=radii)  # noqa: E731
            plain = lambda: [fused_ray_render_reference(  # noqa: E731
                pk, o[j], d[j], vd[j], ts[j], dl[j], cfg, s,
                radii=None if radii is None else radii[j]) for j in chunks]
            got = fn()
            torch.cuda.synchronize()
            err = plain_ms = None
            if plain_too:  # the plain version (~1 s) timed on its checked call
                want, plain_s = timed_call(plain)
                errs = k1_errs(label, got, [torch.cat(parts) for parts in zip(*want)])
                hold(label, errs, k1_tol(far))
                err, plain_ms = max(errs.values()), plain_s * 1e3
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
            fn = lambda: fused_train_grads(*args, white_bg=white, radii=radii,  # noqa: E731
                                           **dist)
            plain = lambda: fused_train_grads_reference(  # noqa: E731
                *args, white_bg=white, radii=radii, **dist)
            got = fn()
            torch.cuda.synchronize()
            err = plain_ms = None
            if plain_too:
                want = plain()
                plain_ms = event_ms(plain, reps=1)
                hold(label, k2_errs(label, got, want), KERNEL_TOL)
                err = k2_abs(got, want)
                if witness:
                    want = fused_train_grads_reference(*args, white_bg=white, radii=radii,
                                                       dtype=torch.float64, **dist)
                    wlabel = f"K2 vs f64 witness [{name}, {n} rays]"
                    hold(wlabel, k2_errs(wlabel, got, want), KERNEL_TOL)

            def library():
                model.zero_grad(set_to_none=True)
                sigma, rgb = eager_field(model, cfg, o, d, vd, ts, edges, radius)
                out = render_ops.composite(sigma, rgb, dl, white_background=white)
                loss = render_ops.mse(out.rgb, gold[:n])
                if space is not None:
                    loss = loss + UNB_DIST * render_ops.distortion_loss(
                        out.weights, ts, near, far, space, dl if ipe else None)
                loss.backward()
            flops = flops_per_row(cfg, True) * n * s
            nbytes = io + n * (12 + 32 + 4 * s) + 2 * pk.w.numel() + 4 * (pk.w.numel()
                                                                         + pk.b.numel())
        got = want = None
        ms = event_ms(fn)
        library()
        library_ms = event_ms(library)
        model.zero_grad(set_to_none=True)
        b, by = bound_ms(flops, nbytes)
        row = {"kernel": kernel, "case": name, "rays": n, "samples": s, "max_abs_err": err,
               "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": b,
               "bound_by": by}
        if kernel == "K1":
            wbytes, rate = k1_weight_traffic(pk, n, s, ms)
        if kernel == "K2":  # the stashes and dW partials of one call; the split by kernel
            sp = padded_samples(s)  # the largest block's
            row["scratch_bytes"] = fused_train._library().nerf_fused_train_scratch_bytes(
                fused_train.ray_blocks(n, sp)[0][1], sp, pk.depth, pk.W, pk.F, pk.V, pk.P,
                pk.D, pk.w.numel() + pk.b.numel())
            per = profiled_split(fn, 3, ms, b)
            split = row["split_ms"] = None if per is None else {}
            for k, v in (per or {}).items():
                split[kernel_name(k)] = split.get(kernel_name(k), 0.0) + v
            row["k2b_ms"] = (None if per is None else
                             sum(v for k, v in per.items() if re.search(K2B_KERNELS, k)))
            # over the rows the function needs: the pad rows' G is zero
            row["k2b_bound_ms"], k2b_by, k2b_bytes = k2b_floor(pk, n * s)
        plain_txt = f"{plain_ms:.3f} ms" if plain_too else "not run"
        print(f"{kernel} {name}, {n} rays [{card}]: kernel {ms:.3f} ms, plain {plain_txt}, "
              f"library {library_ms:.3f} ms, bound {b:.3f} ms ({by}), "
              f"{flops / (ms * 1e-3) / 1e12:.1f} TFLOP/s"
              + (f", weights from L2 (modelled) {wbytes / 1e9:.1f} GB, {rate / 1e12:.2f} TB/s"
                 if kernel == "K1" else "")
              + (f", scratch {row['scratch_bytes'] / 1e9:.3f} GB; device time by kernel: "
                 + (", ".join(f"{k} {v:.3f}" for k, v in sorted(row["split_ms"].items(),
                                                                key=lambda kv: -kv[1]))
                    + f"; K2b {row['k2b_ms']:.3f} ms against its floor "
                    f"{row['k2b_bound_ms']:.3f} ms ({k2b_by}: {k2b_bytes / 1e9:.3f} GB)"
                    if row["split_ms"] is not None else NOT_PROFILED)
                 if kernel == "K2" else ""))
        rows.append(row)
    return rows


def preset_steps(card: str, preset: str, profiled: bool, extra=()) -> dict:
    """The preset's train step (4096 rays; with the CLI flags ``extra``)
    through K2 and through autograd, in seconds (best of 3 windows of 10 and
    5 steps), and with ``profiled`` the device idle share of the K2 step from
    a profile of 5 steps."""
    import dataclasses

    import torch

    from nerf_rs_tpu_torch.data.factory import make_dataset
    from nerf_rs_tpu_torch.train.step import init_state, make_train_step, step_generator

    dev = torch.device("cuda")
    cfg = preset_cfg(preset, *extra)
    ds = make_dataset(cfg, dev)
    label = " ".join((preset,) + tuple(extra))
    times = {}
    for name, c, window in (("K2", cfg, 10),
                            ("autograd", dataclasses.replace(cfg, use_whole_ray_train=False), 5)):
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
        if name == "K2" and profiled:
            torch.cuda.synchronize()
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                run(5)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3 / 5
            per = sorted(((v / 5, k) for k, v in device_ms(prof).items()), reverse=True)
            busy = sum(v for v, _ in per)
            times["idle_pct"] = 100 * (1 - busy / wall)
            print(f"{label} K2 step profile [{card}]: wall {wall:.3f} ms/step "
                  f"(profiled), device busy {busy:.3f} ms/step, "
                  f"idle {times['idle_pct']:.1f}%")
            for v, k in per[:8]:
                print(f"  {v:8.3f} ms/step  {k[:100]}")
        del state
    for name in ("K2", "autograd"):
        print(f"{label} train step through {name} [{card}]: {times[name] * 1e3:.3f} ms/step")
    return times


def time_presets(card: str, presets=PRESETS, profiled=("hierarchical",)) -> dict:
    """Each preset's step (4096 rays; the hierarchical presets' 64 + 128
    samples, or the proposal presets' main samples) through K2 and through
    autograd, its 800x800 frame through K1 from seed-0 weights with random
    biases (its first rays checked against the plain version, pass by
    pass: under a proposal the one main pass, on samples both routes draw
    alike), and a profile of the K2 step of the presets in ``profiled``."""
    import torch

    from nerf_rs_tpu_torch.data.factory import make_dataset
    from nerf_rs_tpu_torch.ops import render as render_ops
    from nerf_rs_tpu_torch.render import make_render
    from nerf_rs_tpu_torch.train.loop import update_occupancy
    from nerf_rs_tpu_torch.train.step import init_state

    dev = torch.device("cuda")
    out = {}
    for preset in presets:
        times = preset_steps(card, preset, preset in profiled)

        fcfg = preset_cfg(preset, "--width", str(FRAME), "--height", str(FRAME))
        fds = make_dataset(fcfg, dev)
        fo, fd = (a.reshape(-1, 3) for a in fds.view_rays(0))
        st = init_state(fcfg, dev)
        random_biases_(st.params, 3)
        if st.fine_params is not None:
            random_biases_(st.fine_params, 4)
        if st.grid is not None:  # the occupancy grid of these weights, as the loop makes it
            st.grid = update_occupancy(st, fcfg, 0)
        render_fn = make_render(fcfg)
        frame = lambda: render_fn(st.params, fo, fd, fine_params=st.fine_params,  # noqa: E731
                                  grid=st.grid)
        if not bool(torch.isfinite(frame()[0]).all()):
            fail(f"{preset} 800x800 frame: non-finite values")
        # the frame's first rays through both routes, coarse and fine
        k = PLAIN_CHUNK // 4
        prop = fcfg.proposal.enabled
        passes = []
        for route in (contextlib.nullcontext, plain_render_route):
            with route(), torch.no_grad():
                passes.append(render_ops.render_rays(
                    st.params, fo[:k], fd[:k], fcfg.model, fcfg.render, fcfg.camera,
                    randomized=False, dtype=torch.bfloat16, use_fused=True,
                    fine_params=None if prop else st.fine_params,
                    prop_params=st.fine_params if prop else None, prop_cfg=fcfg.proposal,
                    grid=st.grid))
        coarse_err = float((passes[0][0].rgb - passes[1][0].rgb).abs().max())
        fine_diff = (passes[0][1].rgb - passes[1][1].rgb).abs() if not prop else torch.zeros(1)
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
                       "frame_s": t_frame,
                       **({"idle_pct": times["idle_pct"]} if "idle_pct" in times else {})}
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
    plain_chunk()
    plain_ms = event_ms(plain_chunk, reps=1)  # ~1 s
    # every packed matrix multiplies each sample row once
    flops_row = 2 * sum(k * c for k, c in packed.w_shape)
    wbytes, rate = k1_weight_traffic(packed, n, s, ms)
    print(f"one {n}-ray chunk [{card}]: kernel {ms:.3f} ms "
          f"(~{flops_row * n * s / (ms * 1e-3) / 1e12:.1f} TFLOP/s bf16), "
          f"plain {plain_ms:.3f} ms; weights from L2 (modelled) {wbytes / 1e9:.1f} GB a call, "
          f"{rate / 1e12:.2f} TB/s")
    return {"ms": ms, "plain_ms": plain_ms, "inputs": (co, cd, cvd, ts, dl)}


def k1_weight_traffic(packed, n: int, s: int, ms: float) -> tuple:
    """The bytes of K1's weights that leave L2 for one call of n rays of
    s samples, and the rate that implies at ms, as the kernel's design has
    them (a model: no counter reads them): every CTA pass of 128 rows reads
    them once, and the CTAs of a cluster (kernels/fused_ray.K1_CLUSTER; a
    checkout without it shares nothing) share each read."""
    from nerf_rs_tpu_torch.kernels import fused_ray

    sp = fused_ray.padded_samples(s)
    R = fused_ray.rays_per_cta(sp)
    passes = -(-n // R) * R * sp / fused_ray.TILE_ROWS
    k1 = getattr(packed, "k1", None)
    wbytes = 2 * (k1.w.numel() if k1 is not None else packed.w.numel())
    nbytes = passes * wbytes / getattr(fused_ray, "K1_CLUSTER", 1)
    return nbytes, nbytes / (ms * 1e-3)


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


# K3's backward on the geometry no forward level of whose table fits in
# shared memory under f32 (tests/test_torch_cuda.py's FAC_NONE: 2,601 + 5,001
# knots x 8 channels); the f32 scatter takes its table in tiles of levels
FAC_NONE = dict(arch="factored", fac_levels=2, fac_base_res=2600, fac_max_res=5000, fac_comps=8)
# Geometries past K3's former caps (16 levels; levels x channels 1,024),
# which the JAX kernel computes: 20 levels of the preset's ladder, and the
# preset's 6 levels at 192 channels (L x C = 1,152)
FAC_WIDE = {"levels 20": dict(arch="factored", fac_levels=20),
            "6 x 192": dict(arch="factored", fac_comps=192)}


def d_lines_witness(lines, pts, g, mcfg, dtype):
    """The float64 witness of K3's backward: the plain version's d_feat
    (rounded as the kernel rounds it) and hat weights, their products and
    sums in float64, so a gap names the side that strays."""
    import torch

    from nerf_rs_tpu_torch.kernels import fused_factored as k3
    from nerf_rs_tpu_torch.models.factored import hat_weights, unit_coords

    d_feat = k3.fused_factored_dfeat_reference(lines, pts, g, mcfg, dtype).double()
    u = unit_coords(pts, mcfg.fac_aabb)
    out = torch.zeros(lines.shape, dtype=torch.float64, device=lines.device)
    for a in range(3):
        for i in range(0, u.shape[0], k3.PLAIN_CHUNK):
            w = k3._round(hat_weights(u[i:i + k3.PLAIN_CHUNK, a], mcfg), dtype).double()
            out[a] += w.t() @ d_feat[a, i:i + k3.PLAIN_CHUNK]
    return out


def check_backward_case(label, lines, pts, g, mcfg, dtype) -> dict:
    """One K3 backward case: two launches bit-identical, finite, and held
    to its plain version and to the float64 witness at KERNEL_TOL (per axis,
    relative to the axis's largest entry). Returns the differences."""
    import torch

    from nerf_rs_tpu_torch.kernels import fused_factored as k3

    d = k3.fused_factored_encode_backward(lines, pts, g, mcfg, dtype)
    again = k3.fused_factored_encode_backward(lines, pts, g, mcfg, dtype)
    torch.cuda.synchronize()
    if not torch.equal(d, again):
        fail(f"two K3 backward launches [{label}] gave different bits")
    if not bool(torch.isfinite(d).all()):
        fail(f"K3 backward [{label}]: non-finite outputs")
    want = k3.fused_factored_encode_backward_reference(lines, pts, g, mcfg, dtype)
    wit = d_lines_witness(lines, pts, g, mcfg, dtype)
    errs = {"d_lines": max(leaf_err(d[a].double(), wit[a]) for a in range(3)),
            "plain_vs_witness": max(leaf_err(want[a].double(), wit[a]) for a in range(3)),
            "vs_plain": max(leaf_err(d[a], want[a]) for a in range(3))}
    hold(f"K3 backward vs its float64 witness [{label}]", {"d_lines": errs["d_lines"]},
         k3.KERNEL_TOL)
    hold(f"K3 backward vs plain [{label}]", {"d_lines": errs["vs_plain"]}, k3.KERNEL_TOL)
    print(f"  plain version vs the witness [{label}]: {errs['plain_vs_witness']:.3g}")
    errs["abs"] = float((d - want).abs().max())
    return errs


def check_factored_kernel(ds, mcfg, cam, lines) -> dict:
    """K3's forward and backward against their plain versions, bf16 and
    f32, on a train step's 524,288 points and on 4,103 rays' (ragged); the
    backward also against its float64 witness, on the step's points
    shuffled, and on FAC_NONE under bf16; two launches bit-identical; one
    backward call under torch.cuda.set_sync_debug_mode("error"). Returns the
    largest absolute differences (enc, d_lines) and the largest d_lines one
    relative to its axis's largest entry, against the plain version and
    against the witness."""
    import torch

    from nerf_rs_tpu_torch import ModelConfig
    from nerf_rs_tpu_torch.kernels import fused_factored as k3
    from nerf_rs_tpu_torch.models.factored import basis_dim

    errs = {"enc": 0.0, "d_lines_abs": 0.0, "d_lines": 0.0, "d_lines_witness": 0.0,
            "plain_witness": 0.0}

    def keep(got):
        errs["d_lines"] = max(errs["d_lines"], got["vs_plain"])
        errs["d_lines_witness"] = max(errs["d_lines_witness"], got["d_lines"])
        errs["plain_witness"] = max(errs["plain_witness"], got["plain_vs_witness"])
        errs["d_lines_abs"] = max(errs["d_lines_abs"], got["abs"])

    for n_rays in (FAC_RAYS, N_RAYS):
        pts = factored_points(ds, cam, n_rays, 11)
        clipped = int((pts.abs() > mcfg.fac_aabb).any(-1).sum())
        g = torch.randn(pts.shape[0], mcfg.fac_comps, generator=torch_generator(pts.device, 12),
                        device=pts.device)
        for name, dtype in (("bf16", torch.bfloat16), ("f32", None)):
            enc = k3.fused_factored_encode_forward(lines, pts, mcfg, dtype)
            enc_again = k3.fused_factored_encode_forward(lines, pts, mcfg, dtype)
            torch.cuda.synchronize()
            if not torch.equal(enc, enc_again):
                fail(f"two K3 forward launches [{name}, {pts.shape[0]} points] gave different bits")
            if not bool(torch.isfinite(enc).all()):
                fail(f"K3 forward [{name}, {pts.shape[0]} points]: non-finite outputs")
            got = float((enc - k3.fused_factored_encode_reference(lines, pts, mcfg, dtype))
                        .abs().max())
            hold(f"K3 forward vs plain [{name}, {pts.shape[0]} points, {clipped} clipped]",
                 {"enc": got}, k3.KERNEL_TOL)
            errs["enc"] = max(errs["enc"], got)
            keep(check_backward_case(f"{name}, {pts.shape[0]} points, {clipped} clipped", lines,
                                     pts, g, mcfg, dtype))
        if n_rays == FAC_RAYS:
            perm = torch.randperm(pts.shape[0], generator=torch_generator(pts.device, 13),
                                  device=pts.device)
            keep(check_backward_case(f"bf16, {pts.shape[0]} points shuffled", lines,
                                     pts[perm].contiguous(), g, mcfg, torch.bfloat16))
            torch.cuda.synchronize()
            try:
                torch.cuda.set_sync_debug_mode("error")
                k3.fused_factored_encode_backward(lines, pts, g, mcfg, torch.bfloat16)
            except RuntimeError as e:
                fail(f"K3 backward synchronises with the host: {e}")
            finally:
                torch.cuda.set_sync_debug_mode(0)
            print("K3 backward: no host sync under set_sync_debug_mode('error')")
    none = ModelConfig(**FAC_NONE)
    gen = torch_generator(lines.device, 14)
    none_lines = 0.25 * torch.randn(3, basis_dim(none), none.fac_comps, generator=gen,
                                    device=lines.device)
    pts = factored_points(ds, cam, N_RAYS, 15)
    g = torch.randn(pts.shape[0], none.fac_comps, generator=gen, device=pts.device)
    for name, dtype in (("bf16", torch.bfloat16), ("f32", None)):
        keep(check_backward_case(f"{name}, FAC_NONE (sumR {basis_dim(none)}), "
                                 f"{pts.shape[0]} points", none_lines, pts, g, none, dtype))
    # past the former caps: a train step's points, forward and backward
    pts = factored_points(ds, cam, FAC_RAYS, 16)
    for geometry, kw in FAC_WIDE.items():
        wide = ModelConfig(**kw)
        wide_lines = 0.25 * torch.randn(3, basis_dim(wide), wide.fac_comps, generator=gen,
                                        device=lines.device)
        g = torch.randn(pts.shape[0], wide.fac_comps, generator=gen, device=pts.device)
        for name, dtype in (("bf16", torch.bfloat16), ("f32", None)):
            label = f"{name}, {geometry} (sumR {basis_dim(wide)}), {pts.shape[0]} points"
            enc = k3.fused_factored_encode_forward(wide_lines, pts, wide, dtype)
            if not torch.equal(enc, k3.fused_factored_encode_forward(wide_lines, pts, wide,
                                                                      dtype)):
                fail(f"two K3 forward launches [{label}] gave different bits")
            got = float((enc - k3.fused_factored_encode_reference(wide_lines, pts, wide, dtype))
                        .abs().max())
            hold(f"K3 forward vs plain [{label}]", {"enc": got}, k3.KERNEL_TOL)
            errs["enc"] = max(errs["enc"], got)
            keep(check_backward_case(label, wide_lines, pts, g, wide, dtype))
            check_dense_form(label, enc, wide_lines, pts, g, wide, dtype)
        del wide_lines, g
    print("K3 forward and backward: two launches on the same inputs give bit-identical outputs")
    return errs


def check_dense_form(label, enc, lines, pts, g, mcfg, dtype) -> None:
    """K3 beside the JAX kernel's own form, the dense hat product, which
    sums each feature's taps in another order than the kernels and the
    plain versions: the encoding within KERNEL_TOL of its largest magnitude
    (at least 1), d_lines within KERNEL_TOL of each axis's scale plus what
    the d_feat elements that the two orders round differently move it by
    (``dense_order_gap``), elementwise."""
    from nerf_rs_tpu_torch.kernels import fused_factored as k3

    dense = k3.fused_factored_encode_reference(lines, pts, mcfg, dtype, dense=True)
    enc_err = float((enc - dense).abs().max())
    enc_bar = k3.KERNEL_TOL["enc"] * max(1.0, float(dense.abs().max()))
    d = k3.fused_factored_encode_backward(lines, pts, g, mcfg, dtype)
    want, bound, flips = k3.dense_order_gap(lines, pts, g, mcfg, dtype)
    scale = want.abs().amax(dim=(1, 2), keepdim=True)
    gap = (d - want).abs() / scale
    over = float(((d - want).abs() - bound - k3.KERNEL_TOL["d_lines"] * scale).max())
    print(f"K3 vs the dense hat product [{label}]: enc {enc_err:.3g} (bar {enc_bar:.3g}); "
          f"d_lines {float(gap.max()):.3g} of its scale, {flips} d_feat elements rounded "
          f"differently, their bound {float((bound / scale).max()):.3g}; "
          f"{'ok' if over <= 0 else 'over by %.3g' % over}")
    if enc_err > enc_bar or over > 0:
        fail(f"K3 strays from the dense hat product [{label}]")


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


def factored_learning(pool, tmp: str):
    """The 64x64 factored drive (the preset at --num_samples 32, 1024 rays,
    301 steps) through K3 for each seed in LEARN_SEEDS, then `cli eval` on
    its checkpoint, each seed's drive a task of the learning ``pool``.
    Returns a function that waits for them and checks them: the mean over
    seeds of the mean PSNR over LEARN_VIEWS views must pass FAC_PSNR."""
    common = ["--preset", "factored", "--dataset", "sphere", "--width", "64", "--height", "64",
              "--num_samples", "32"]
    tasks = {}
    for seed in LEARN_SEEDS:
        vdir = os.path.join(tmp, f"learn-factored-{seed}")
        tasks[seed] = pool.submit(drive_seed, [
            ("factored", ["--width", "64", "--height", "64", "--num_samples", "32",
                          "--num_rays", "1024", "--num_iter", "301", "--eval_steps", "100",
                          "--seed", str(seed), "--save_dir", vdir, "--log_dir", vdir]),
            ("cli", ["eval", *common, "--save_dir", vdir, "--max_views", str(LEARN_VIEWS)])])

    def finish() -> dict:
        per_seed = {}
        for seed, task in tasks.items():
            (_, log, counts), (rc, out, _) = task.result()
            print(out.rstrip())
            curve = dict(re.findall(r"iter=(\d+), eval psnr=(\S+)", log))
            if counts["K3 backward"] != 301:
                fail(f"factored learning drive, seed {seed}: K3 backward launches "
                     f"{counts['K3 backward']} (want 301)")
            m = re.search(r"mean psnr over \d+ \S+ views: (\S+)", out)
            if rc != 0 or m is None or not math.isfinite(float(m.group(1))):
                fail(f"factored learning drive, seed {seed}: eval rc {rc}, no finite mean psnr")
            per_seed[seed] = {"view0_curve": curve, "mean_psnr": float(m.group(1))}
        mean = sum(r["mean_psnr"] for r in per_seed.values()) / len(per_seed)
        print(f"factored learning drives through K3 (64x64, 32 samples): mean psnr over "
              f"{LEARN_VIEWS} views at 301 per seed "
              f"{[r['mean_psnr'] for r in per_seed.values()]}, mean {mean:.3f} (bar {FAC_PSNR})")
        if not mean > FAC_PSNR:
            fail(f"factored learning drives: mean psnr {mean:.3f} over seeds {LEARN_SEEDS} "
                 f"(need > {FAC_PSNR})")
        return {"seeds": per_seed, "mean_psnr": mean}
    return finish


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
    and at FAC_WIDE's geometries (bf16, 524,288 points) beside their plain
    versions, the library path and the bound."""
    import dataclasses

    import torch

    from nerf_rs_tpu_torch import ModelConfig
    from nerf_rs_tpu_torch.models.mlp import init_nerf_params
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

    out["calls"] = time_k3_calls(card, ds, mcfg, lines, (("forward", FAC_RAYS, bf16, "ray"),
                                                         ("backward", FAC_RAYS, bf16, "ray"),
                                                         ("forward", FAC_CHUNK, bf16, "ray"),
                                                         ("forward", FAC_RAYS, None, "ray"),
                                                         ("backward", FAC_RAYS, bf16, "shuffled"),
                                                         ("backward", FAC_RAYS, None, "ray")))
    # K3 past its former caps: a geometry that a checkout's kernels refuse
    # (an older commit's, in an A/B) is named, and main fails on it
    out["wide"], out["refused"] = [], []
    for geometry, kw in FAC_WIDE.items():
        wide = ModelConfig(**kw)
        try:
            out["wide"] += [dict(r, geometry=geometry) for r in time_k3_calls(
                card, ds, wide, init_nerf_params(wide, 0, dev).lines.detach(),
                (("forward", FAC_RAYS, bf16, "ray"), ("backward", FAC_RAYS, bf16, "ray")))]
        except ValueError as e:
            print(f"K3 at {geometry} [{card}]: refused ({e})")
            out["refused"].append(geometry)
    # the corners fault 7 lifted, bf16 and f32 lines, on CORNER_RAYS rays' points
    out["corners"] = []
    for geometry, kw in FAC_CORNERS.items():
        corner = ModelConfig(**kw)
        out["corners"] += [dict(r, geometry=geometry) for r in time_k3_calls(
            card, ds, corner, init_nerf_params(corner, 0, dev).lines.detach(),
            tuple((kind, CORNER_RAYS, dt, "ray") for dt in (bf16, None)
                  for kind in ("forward", "backward")))]
    return out


def time_k3_calls(card: str, ds, mcfg, lines, cases) -> list:
    """K3's calls ``cases`` ((kind, rays, dtype, order) on the points of
    factored_points' sphere rays) at the geometry ``mcfg``, each beside its
    plain version, the library path (F.embedding_bag and its autograd) and
    the bound; the backward's device time split into kernel A, kernel B and
    the reduce. One row each."""
    import torch

    from nerf_rs_tpu_torch.kernels import fused_factored as k3
    from nerf_rs_tpu_torch.models.factored import basis_dim

    dev = ds.images.device
    bf16 = torch.bfloat16
    cam = factored_config().camera
    C, R = mcfg.fac_comps, basis_dim(mcfg)
    rows = []
    for kind, n_rays, dtype, order in cases:
        pts = factored_points(ds, cam, n_rays, 13)
        n = pts.shape[0]
        if order == "shuffled":
            pts = pts[torch.randperm(n, generator=torch_generator(dev, 15), device=dev)]
            pts = pts.contiguous()
        g = torch.randn(n, C, generator=torch_generator(dev, 14), device=dev)
        lib_lines = lines.detach().clone().requires_grad_(kind == "backward")
        if kind == "forward":
            fn = lambda: k3.fused_factored_encode_forward(lines, pts, mcfg, dtype)  # noqa: E731
            plain = lambda: k3.fused_factored_encode_reference(lines, pts, mcfg, dtype)  # noqa: E731
            with torch.no_grad():
                library = lambda: library_factored(lib_lines, pts, mcfg, dtype)  # noqa: E731
                lib_err = float((library() - plain()).abs().max())
            # points in, encodings out, the line tables (bf16 or f32); per
            # point 3 axes x 2L taps x C products and sums, and the CP product
            nbytes = n * (12 + 4 * C) + (2 if dtype == bf16 else 4) * 3 * R * C
            flops = n * (3 * 2 * 2 * mcfg.fac_levels * C + 2 * C)
        else:
            fn = lambda: k3.fused_factored_encode_backward(lines, pts, g, mcfg, dtype)  # noqa: E731
            plain = lambda: k3.fused_factored_encode_backward_reference(  # noqa: E731
                lines, pts, g, mcfg, dtype)
            enc = library_factored(lib_lines, pts, mcfg, dtype)
            library = lambda: torch.autograd.grad(enc, lib_lines, g, retain_graph=True)  # noqa: E731
            lib_err = leaf_err(library()[0], plain())
            # points and g in, the bf16 line tables, d_lines out; per point the
            # three axis features (2L taps x C each), d_feat, and the scatter of
            # w d_feat into 2L rows per axis
            nbytes = n * (12 + 4 * C) + 2 * 3 * R * C + 4 * 3 * R * C
            flops = n * (2 * 3 * 2 * 2 * mcfg.fac_levels * C + 3 * 2 * C)
        fn()
        ms = event_ms(fn)
        ms_window = per_call_ms(fn, GATHER_CALLS)
        plain_ms = event_ms(plain, reps=1)
        library()
        library_ms = event_ms(library)
        b, by = bound_ms(flops, nbytes, PEAK_F32)
        dense_ms = 3 * n * R * C * 2 * (2 if kind == "backward" else 1) / PEAK_FLOPS * 1e3
        row = {"kernel": kind, "points": n, "order": order, "levels": mcfg.fac_levels,
               "comps": C, "lines": "bf16" if dtype == bf16 else "f32",
               "ms": ms, "ms_window": ms_window, "plain_ms": plain_ms,
               "library_ms": library_ms, "library_vs_plain": lib_err, "bound_ms": b,
               "bound_by": by, "sparse_flops": flops, "bytes": nbytes,
               "dense_bound_ms": dense_ms}
        split = ""
        if kind == "backward":
            # the backward's device time by kernel: d_feat (kernel A), the
            # scatter (kernel B: tensor cores under bf16, CUDA cores under
            # f32) and the fixed-order reduce
            prof = profiled_split(fn, 5, ms_window, b)
            per = {} if prof is None else {kernel_name(k).split("<")[0]: v
                                           for k, v in prof.items()}
            row["kernel_a_ms"] = per.get("factored_dfeat_kernel", 0.0) if per else None
            row["kernel_b_ms"] = (per.get("factored_scatter_mma_kernel", 0.0)
                                  + per.get("factored_scatter_walk_kernel", 0.0)) if per else None
            row["reduce_ms"] = per.get("factored_reduce_kernel", 0.0) if per else None
            row["device_ms"] = sum(per.values()) if per else None
            split = (f"; device {row['device_ms']:.3f} ms: kernel A (d_feat) "
                     f"{row['kernel_a_ms']:.3f}, kernel B (scatter) {row['kernel_b_ms']:.3f}, "
                     f"reduce {row['reduce_ms']:.4f}; by kernel: "
                     + ", ".join(f"{k} {v:.4f}" for k, v in sorted(per.items()))
                     if per else f"; device split {NOT_PROFILED}")
        print(f"K3 {kind}, {mcfg.fac_levels} x {C}, {n} {order} points, {row['lines']} lines "
              f"[{card}]: kernel {ms:.3f} ms "
              f"alone ({ms_window:.3f} ms a call in a window of {GATHER_CALLS}{split}), plain "
              f"{plain_ms:.3f} ms, "
              f"library {library_ms:.3f} ms (vs plain {lib_err:.3g}), bound {b:.4f} ms ({by}; "
              f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP at {PEAK_F32 / 1e12:.0f} "
              f"TFLOP/s f32), {nbytes / (ms * 1e-3) / 1e9:.0f} GB/s; the dense hat product "
              f"the TPU ran would be {dense_ms:.3f} ms at {PEAK_FLOPS / 1e12:.0f} TFLOP/s bf16")
        rows.append(row)
        del pts, g, lib_lines
    return rows


def ngp_cfg(layout: str, *extra):
    """`--preset ngp` (the brick table) or with `--hash_brick false` (flat)."""
    return preset_cfg("ngp", *NGP_LAYOUTS[layout], *extra)


def ngp_fetches(cfg, points: int) -> int:
    """K4 launches of one encode of ``points`` points: one gather_pairs
    (flat), or one gather_rows per _BRICK_CHUNK points (brick)."""
    from nerf_rs_tpu_torch.models.hashgrid import _BRICK_CHUNK

    return math.ceil(points / _BRICK_CHUNK) if cfg.model.hash_brick else 1


def logging_steps_in(num_iter: int, every: int = 101) -> int:
    """The loop's logging steps of a run of ``num_iter`` steps from 0 (it %
    every == 0 and it > 0), each of which evaluates the field once for the
    diagnostics (train/loop.log_diagnostics)."""
    return (num_iter - 1) // every


def ngp_render_fetches(cfg, rays: int) -> int:
    """K4 launches of rendering ``rays`` rays: the render chunks'
    encodes."""
    from nerf_rs_tpu_torch.render import default_render_chunk

    chunk = default_render_chunk(cfg.render, model_cfg=cfg.model)
    return sum(ngp_fetches(cfg, min(chunk, rays - i) * cfg.render.num_samples)
               for i in range(0, rays, chunk))


def k4_counts(brick: bool) -> tuple:
    """(launches of the layout's K4 entry point, launches of the other)."""
    from nerf_rs_tpu_torch.kernels import gather_rows as k4

    rows, pairs = k4.gather_rows.launches, k4.gather_pairs.launches
    return (rows, pairs) if brick else (pairs, rows)


def reset_k4() -> None:
    from nerf_rs_tpu_torch.kernels import gather_rows as k4

    k4.gather_rows.launches = k4.gather_pairs.launches = k4.scatter_rows.launches = 0


def scatter_count() -> int:
    from nerf_rs_tpu_torch.kernels import gather_rows as k4

    return k4.scatter_rows.launches


def ngp_fetch_inputs(dev) -> dict:
    """The K4 calls of one ngp train step (4096 rays x 128 jittered samples,
    every 8th point pushed out past the AABB), captured from the encodes on
    seed-0 tables: the brick layout's first gather_rows call (a sub-chunk of
    2^17 points x 16 levels = 2^21 rows of the (131,072, 128) table) and the
    flat layout's gather_pairs call (2^26 pairs of the (8,388,608, 2)
    table)."""
    import torch

    from nerf_rs_tpu_torch.data.factory import make_dataset
    from nerf_rs_tpu_torch.kernels import gather_rows as k4
    from nerf_rs_tpu_torch.models import hashgrid
    from nerf_rs_tpu_torch.models.mlp import init_nerf_params

    seen = {}
    real = k4.gather_rows, k4.gather_pairs

    def spy(name, fn):
        def call(table, idx):
            seen.setdefault(name, (table, idx.clone()))
            return fn(table, idx)
        call.launches = 0  # the wrapper counts on the name it is bound to
        return call

    brick, flat = ngp_cfg("brick"), ngp_cfg("flat")
    pts = factored_points(make_dataset(brick, dev), brick.camera, NGP_RAYS, 21)
    k4.gather_rows, k4.gather_pairs = spy("rows", real[0]), spy("pairs", real[1])
    try:
        with torch.no_grad():
            for cfg, encode in ((brick, hashgrid.brick_encode), (flat, hashgrid.hash_encode)):
                encode(init_nerf_params(cfg.model, 0, dev).table.detach(), pts, cfg.model)
    finally:
        k4.gather_rows, k4.gather_pairs = real
    return seen


def check_gather_kernel(inputs) -> float:
    """K4 against its plain versions on the card, bit for bit: gather_rows
    at the brick sub-chunk's 2^21 rows, at a ragged N, and with each row
    repeated 64 times; gather_pairs at the flat step's 2^26 pairs. Returns
    the largest absolute difference (0 when the bits agree)."""
    import torch

    from nerf_rs_tpu_torch.kernels import gather_rows as k4

    table, idx = inputs["rows"]
    flat, fidx = inputs["pairs"]
    rep = idx[torch.arange(idx.shape[0], device=idx.device) // 64]
    cases = [("gather_rows", k4.gather_rows, k4.gather_rows_reference, table, i, name)
             for i, name in ((idx, "2^21 rows of a brick sub-chunk"),
                             (idx[:NGP_RAGGED], f"{NGP_RAGGED} rows (ragged)"),
                             (rep, "2^21 rows, each repeated 64 times"))]
    cases.append(("gather_pairs", k4.gather_pairs, k4.gather_pairs_reference, flat, fidx,
                  "2^26 pairs of a flat step"))
    worst = 0.0
    for kernel, fn, plain, t, i, name in cases:
        got = fn(t, i)
        torch.cuda.synchronize()
        want = plain(t, i)
        if got.shape != want.shape or not bool(torch.isfinite(got).all()):
            fail(f"K4 {kernel} [{name}]: shape {tuple(got.shape)} or non-finite values")
        err = float((got - want).abs().max())
        print(f"K4 {kernel} vs plain [{name}]: max |diff| {err:g}, bit-equal "
              f"{torch.equal(got, want)}")
        if not torch.equal(got, want):
            fail(f"K4 {kernel} [{name}] differs from its plain version")
        worst = max(worst, err)
        del got, want
    try:  # the wrapper reads nothing on the host: no synchronisation in the call
        torch.cuda.set_sync_debug_mode("error")
        k4.gather_pairs(flat, fidx)
    except RuntimeError as e:
        fail(f"K4 gather_pairs synchronises with the host: {e}")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    print("K4 gather_pairs under torch.cuda.set_sync_debug_mode('error'): no host sync")
    return worst


@contextlib.contextmanager
def plain_gather_route():
    """Route the hash grid's table fetch to K4's plain versions, for the
    frame check only."""
    from nerf_rs_tpu_torch.kernels import gather_rows as k4

    real = k4.gather_rows, k4.gather_pairs
    k4.gather_rows, k4.gather_pairs = k4.gather_rows_reference, k4.gather_pairs_reference
    try:
        yield
    finally:
        k4.gather_rows, k4.gather_pairs = real


def drive_ngp(tmp: str, layout: str, fo, fd) -> dict:
    """`cli train --preset ngp` (brick, or flat with --hash_brick false) for
    NGP_STEPS steps at full width with an eval at step 50, `render --view 0`
    at 800x800 and `eval --max_views 2` on its checkpoint, each with its
    exact K4 launch count (derived from the chunking, and held to the
    counts the design gives: brick 4 per step, 16 per 128x128 view, 625
    per frame; flat 1, 4 and 157). Then the frame's first render chunk from
    the trained weights through K4 and through the plain route: the same
    bits. Returns the launch counts by path."""
    import torch

    from nerf_rs_tpu_torch.ops import render as render_ops
    from nerf_rs_tpu_torch.render import default_render_chunk
    from nerf_rs_tpu_torch.train import checkpoint as ckpt
    from nerf_rs_tpu_torch.train.step import init_state

    brick = layout == "brick"
    cfg = ngp_cfg(layout)
    fcfg = ngp_cfg(layout, "--width", str(FRAME), "--height", str(FRAME))
    S, view = cfg.render.num_samples, cfg.camera.width * cfg.camera.height
    step_k4 = ngp_fetches(cfg, cfg.train.num_rays * S)
    view_k4 = ngp_render_fetches(cfg, view)
    frame_k4 = ngp_render_fetches(fcfg, FRAME * FRAME)
    if (step_k4, view_k4, frame_k4) != NGP_K4[layout]:
        fail(f"ngp {layout}: K4 launches per step, view and frame {step_k4, view_k4, frame_k4}")
    ckdir = os.path.join(tmp, f"ngp-{layout}")
    flags = ["--preset", "ngp", *NGP_LAYOUTS[layout], "--dataset", "sphere", "--save_dir", ckdir]
    reset_k4()
    t0 = time.perf_counter()
    rc, out = run_cli(["train", *flags, "--num_iter", str(NGP_STEPS), "--eval_steps", "50",
                       "--save_steps", "1000", "--log_dir", ckdir])
    got, other = k4_counts(brick)
    want = NGP_STEPS * step_k4 + view_k4
    scattered = scatter_count()
    print(f"cli train --preset ngp [{layout}], {NGP_STEPS} steps: rc {rc}, K4 launches {got} "
          f"(want {want}), scatter_rows launches {scattered} (want {NGP_STEPS * step_k4}), "
          f"{time.perf_counter() - t0:.1f} s")
    if scattered != NGP_STEPS * step_k4:
        fail(f"train --preset ngp [{layout}]: scatter_rows launches {scattered} "
             f"(want {NGP_STEPS * step_k4}: one per fetch's backward)")
    losses = [float(v) for v in re.findall(r"iter=\d+, loss=(\S+)", out)]
    evals = [float(v) for v in re.findall(r"eval psnr=(\S+)", out)]
    if rc != 0 or (got, other) != (want, 0):
        fail(f"train --preset ngp [{layout}]: rc {rc}, K4 launches {got} / {other} "
             f"(want {want} / 0)")
    if not losses or len(evals) != 1 or not all(map(math.isfinite, losses + evals)):
        fail(f"train --preset ngp [{layout}]: losses {losses}, eval psnrs {evals}")
    counts = {"train": got, "train_scatter": scattered}
    for key, argv, want in (
            ("render", ["render", "--width", str(FRAME), "--height", str(FRAME), "--view", "0",
                        "--out_dir", os.path.join(tmp, f"ngp-{layout}-render")], frame_k4),
            ("eval", ["eval", "--max_views", "2"], 2 * view_k4)):
        reset_k4()
        rc, out = run_cli([*argv, *flags])
        got, other = k4_counts(brick)
        m = re.search(r"psnr[= ](\S+)", out)
        print(f"cli {key} --preset ngp [{layout}]: rc {rc}, K4 launches {got} (want {want})")
        if (rc != 0 or (got, other) != (want, 0) or scatter_count() or m is None
                or not math.isfinite(float(m.group(1)))):
            fail(f"{key} --preset ngp [{layout}]: rc {rc}, K4 launches {got} / {other} "
                 f"(want {want} / 0), psnr {m and m.group(1)}")
        counts[key] = got
    if read_png(os.path.join(tmp, f"ngp-{layout}-render", "view-0.png")).shape != (
            FRAME, FRAME, 3):
        fail(f"ngp [{layout}] wrote no {FRAME}x{FRAME} view")

    # the frame's first chunk from the trained weights, K4 vs the plain route
    params = init_state(fcfg, fo.device).params
    ckpt.restore_weights(ckpt.latest_checkpoint(ckdir), params)
    chunk = default_render_chunk(fcfg.render, model_cfg=fcfg.model)
    rgbs = []
    for route in (contextlib.nullcontext, plain_gather_route):
        with route(), torch.no_grad():
            rgbs.append(render_ops.render_rays(
                params, fo.reshape(-1, 3)[:chunk], fd.reshape(-1, 3)[:chunk], fcfg.model,
                fcfg.render, fcfg.camera, randomized=False, dtype=torch.bfloat16)[0].rgb)
    err = float((rgbs[0] - rgbs[1]).abs().max())
    print(f"ngp [{layout}] frame, K4 vs plain route on its first {chunk} rays: rgb max |diff| "
          f"{err:g} (want the same bits); rgb in [{float(rgbs[0].min()):.4f}, "
          f"{float(rgbs[0].max()):.4f}]")
    if not torch.equal(rgbs[0], rgbs[1]):
        fail(f"ngp [{layout}] frame: K4 and the plain route differ by {err}")
    return counts


def ngp_learning(pool, tmp: str):
    """The 64x64 `--preset ngp` drive (--num_samples 32, 1024 rays, lr 1e-2,
    301 steps) through K4 for each seed in LEARN_SEEDS, then `cli eval` on
    its checkpoint, each seed's drive a task of the learning ``pool``.
    Returns a function that waits for them and checks them: the mean over
    seeds of the mean PSNR over LEARN_VIEWS views must pass NGP_PSNR; it
    returns the readings with the K4 and scatter_rows launches counted."""
    common = ["--preset", "ngp", "--dataset", "sphere", "--width", "64", "--height", "64",
              "--num_samples", "32"]
    cfg = ngp_cfg("brick", "--width", "64", "--height", "64", "--num_samples", "32",
                  "--num_rays", "1024")
    # the steps, the evals at 100, 200 and 300, and the diagnostics' density at
    # the logging steps 101 and 202 (the field at the first 1,024 rays' samples)
    want = ((301 + logging_steps_in(301)) * ngp_fetches(cfg, 1024 * 32)
            + 3 * ngp_render_fetches(cfg, 64 * 64))
    want_scatter = 301 * ngp_fetches(cfg, 1024 * 32)
    tasks = {}
    for seed in LEARN_SEEDS:
        vdir = os.path.join(tmp, f"learn-ngp-{seed}")
        tasks[seed] = pool.submit(drive_seed, [
            ("cli", ["train", *common, "--seed", str(seed), "--num_rays", "1024",
                     "--num_iter", "301", "--eval_steps", "100", "--save_dir", vdir,
                     "--log_dir", vdir]),
            ("cli", ["eval", *common, "--save_dir", vdir, "--max_views", str(LEARN_VIEWS)])])

    def finish() -> dict:
        per_seed, launches, scatter_launches = {}, 0, 0
        for seed, task in tasks.items():
            (rc, out, counts), (erc, eout, _) = task.result()
            print(out.rstrip())
            print(eout.rstrip())
            curve = dict(re.findall(r"iter=(\d+), eval psnr=(\S+)", out))
            got = (counts["gather_rows"], counts["gather_pairs"])
            if rc != 0 or got != (want, 0) or counts["scatter_rows"] != want_scatter:
                fail(f"ngp learning drive, seed {seed}: rc {rc}, K4 launches {got} (want "
                     f"{want} / 0), scatter_rows launches {counts['scatter_rows']}")
            launches += counts["gather_rows"]
            scatter_launches += counts["scatter_rows"]
            m = re.search(r"mean psnr over \d+ \S+ views: (\S+)", eout)
            if erc != 0 or m is None or not math.isfinite(float(m.group(1))):
                fail(f"ngp learning drive, seed {seed}: eval rc {erc}, no finite mean psnr")
            per_seed[seed] = {"view0_curve": curve, "mean_psnr": float(m.group(1))}
        mean = sum(r["mean_psnr"] for r in per_seed.values()) / len(per_seed)
        print(f"ngp learning drives through K4 (64x64, 32 samples): mean psnr over "
              f"{LEARN_VIEWS} views at 301 per seed "
              f"{[r['mean_psnr'] for r in per_seed.values()]}, mean {mean:.3f} (bar {NGP_PSNR})")
        if not mean > NGP_PSNR:
            fail(f"ngp learning drives: mean psnr {mean:.3f} over seeds {LEARN_SEEDS} "
                 f"(need > {NGP_PSNR})")
        return {"seeds": per_seed, "mean_psnr": mean, "launches": launches,
                "scatter_launches": scatter_launches}
    return finish


def time_ngp(card: str, fo, fd) -> dict:
    """Each layout's ngp step (4096 rays x 128, mixed, the autograd path)
    as the best of 3 windows of 10 steps, a profile of 5 steps (device
    idle share), and its 800x800 frame (seed-0 weights), best of 3."""
    import torch

    from nerf_rs_tpu_torch.data.factory import make_dataset
    from nerf_rs_tpu_torch.render import render_frame
    from nerf_rs_tpu_torch.train.step import init_state, make_train_step, step_generator

    dev = fo.device
    out = {}
    for layout in NGP_LAYOUTS:
        cfg = ngp_cfg(layout)
        state = init_state(cfg, dev)
        fn = make_train_step(cfg, make_dataset(cfg, dev))
        it = [0]

        def run(k):
            nonlocal state
            for _ in range(k):
                state, _ = fn(state, step_generator(0, it[0], dev))
                it[0] += 1
        run(3)
        step_ms = best_of(lambda: run(10)) / 10 * 1e3
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run(5)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / 5
        per = sorted(((v / 5, k) for k, v in device_ms(prof).items()), reverse=True)
        busy = sum(v for v, _ in per)
        idle = 100 * (1 - busy / wall)
        print(f"ngp [{layout}] train step [{card}]: {step_ms:.3f} ms/step (best of 3 windows "
              f"of 10); profile: wall {wall:.3f} ms/step, device busy {busy:.3f} ms/step, "
              f"idle {idle:.1f}%")
        for v, k in per[:10]:
            print(f"  {v:8.3f} ms/step  {k[:100]}")
        del state, fn
        fcfg = ngp_cfg(layout, "--width", str(FRAME), "--height", str(FRAME))
        params = init_state(fcfg, dev).params
        frame = lambda: render_frame(fcfg, params, fo, fd)  # noqa: E731
        if not bool(torch.isfinite(frame()[0]).all()):
            fail(f"ngp [{layout}] 800x800 frame: non-finite values")
        frame_s = best_of(frame)
        print(f"ngp [{layout}] 800x800 frame [{card}]: {frame_s:.4f} s (best of 3)")
        out[layout] = {"step_ms": step_ms, "idle_pct": idle, "profiled_wall_ms": wall,
                       "busy_ms": busy, "frame_s": frame_s}
        del params
    return out


def time_gather(card: str, inputs) -> dict:
    """K4's calls at the main path's shapes (gather_rows at a brick
    sub-chunk's 2^21 rows, gather_pairs at a flat step's 2^26 pairs), each
    beside its plain version, the library call (torch.index_select, on the
    table for gather_rows and on its (M/2, 2) view at fidx // 2 for
    gather_pairs) and its bound: the bytes these indices need (each
    distinct row or pair read once, the indices read, the output written)
    over the memory rate. Each time is per call, over a CUDA-event window
    of GATHER_CALLS calls: the wrapper's (neither wrapper reads the
    indices on the host), and the kernel's alone, launched through its C
    entry point into one output (no wrapper, no allocation)."""
    import torch

    from nerf_rs_tpu_torch.kernels import gather_rows as k4

    lib4 = k4._library()
    stream = torch.cuda.current_stream().cuda_stream
    cases = []
    if "rows" in inputs:  # the row tables': a 16 B kernel and an element-wise one
        table, idx = inputs["rows"]
        out = torch.empty(idx.shape[0], table.shape[1], device=table.device)
        cases.append(("gather_rows", lambda: k4.gather_rows(table, idx),
                      lambda: k4.gather_rows_reference(table, idx),
                      lambda: torch.index_select(table, 0, idx), idx, table.shape[1],
                      lambda o=out: lib4.nerf_gather_rows(
                          table.data_ptr(), idx.data_ptr(), o.data_ptr(), idx.shape[0],
                          table.shape[0], table.shape[1], stream), out))
    if "pairs" in inputs:
        flat, fidx = inputs["pairs"]
        pairs_view = flat.view(-1, 2)
        half = fidx // 2
        out = torch.empty(fidx.shape[0], 2, device=flat.device)
        cases.append(("gather_pairs", lambda: k4.gather_pairs(flat, fidx),
                      lambda: k4.gather_pairs_reference(flat, fidx),
                      lambda: torch.index_select(pairs_view, 0, half), half, 2,
                      lambda o=out: lib4.nerf_gather_pairs(
                          flat.data_ptr(), flat.shape[0], fidx.data_ptr(), o.data_ptr(),
                          fidx.shape[0], stream), out))
    rows = {}
    for name, fn, plain, lib, ids, width, launch, out in cases:
        n = ids.shape[0]
        distinct = int(torch.unique(ids).numel())
        nbytes = distinct * width * 4 + n * 4 + n * width * 4
        want = fn()
        if not torch.equal(lib(), want):
            fail(f"{name}: torch.index_select and K4 disagree")
        if launch() != 0 or not torch.equal(out, want):
            fail(f"{name}: the kernel launched through its C entry point disagrees")
        del want

        ms, plain_ms, library_ms, kernel_ms = (per_call_ms(f, GATHER_CALLS)
                                               for f in (fn, plain, lib, launch))
        b, by = bound_ms(0.0, nbytes)
        alone = (f"kernel alone {kernel_ms:.3f} ms, {nbytes / (kernel_ms * 1e-3) / 1e12:.2f} "
                 f"TB/s of needed bytes")
        print(f"K4 {name}, {n} indices ({distinct} distinct) [{card}]: wrapper {ms:.3f} ms "
              f"({alone}), plain {plain_ms:.3f} ms, torch.index_select "
              f"{library_ms:.3f} ms, bound {b:.4f} ms ({by}, {nbytes / 1e9:.3f} GB)")
        rows[name] = {"indices": n, "distinct": distinct, "ms": ms, "kernel_ms": kernel_ms,
                      "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": b,
                      "bound_by": by, "bytes": nbytes}
    return rows


def check_unbounded_branches(model, mcfg, rays, gold, cam) -> tuple:
    """K1's and K2's contraction and distortion branches at the flagship
    width on the N_RAYS rays with jittered samples over [UNB_NEAR,
    UNB_FAR] (even in disparity, or in t for the linear distortion case),
    per UNB_BRANCHES case: K1 vs its plain version (TOL, the depth bar
    scaled to the range); K2 vs its plain version and the float64 witness
    (KERNEL_TOL, diag slot 5 among the diag columns), the mean of slot 5 vs
    ops/render.distortion_loss of the kernel's weights (rtol 1e-4: the
    same sums in another order), two launches bit-identical; one case also
    vs autograd of the eager loss with the distortion term. Returns the
    largest absolute differences of K1 and K2 from their plain versions."""
    import dataclasses

    import torch

    from nerf_rs_tpu_torch.kernels.fused_ray import fused_ray_render, fused_ray_render_reference
    from nerf_rs_tpu_torch.kernels.fused_render import pack_weights, pack_weights_t
    from nerf_rs_tpu_torch.kernels.fused_train import (
        KERNEL_TOL, fused_train_grads, fused_train_grads_reference, unpack_grads)
    from nerf_rs_tpu_torch.models.mlp import apply_nerf
    from nerf_rs_tpu_torch.ops import render as render_ops, sampling

    o, d, vd = rays
    gen = torch_generator(o.device, 17)
    k1_err = k2_err = 0.0
    for name, ipe, contract, space, s in UNB_BRANCHES:
        cfg = dataclasses.replace(mcfg, ipe=ipe, contract=contract, sigma_activation="softplus")
        ts, dl, _, radii = sample_inputs(N_RAYS, s, ipe, cam, gen, UNB_NEAR, UNB_FAR,
                                         "linear" if space == "linear" else "disparity")
        pk = pack_weights(model, cfg)
        got = fused_ray_render(pk, o, d, vd, ts, dl, cfg, s, radii=radii)
        torch.cuda.synchronize()
        errs = k1_errs(f"K1 [{name}]", got,
                       fused_ray_render_reference(pk, o, d, vd, ts, dl, cfg, s, radii=radii))
        hold(f"K1 vs plain [{name}]", errs, k1_tol(UNB_FAR))
        k1_err = max(k1_err, *errs.values())

        args = (pk, pack_weights_t(pk), o, d, vd, ts, dl, gold, cfg, s)
        dist = ({} if space is None
                else dict(dist_weight=UNB_DIST, near=UNB_NEAR, far=UNB_FAR, dist_space=space))
        got = fused_train_grads(*args, radii=radii, **dist)
        torch.cuda.synchronize()
        for ref, dtype in (("plain", torch.float32), ("f64 witness", torch.float64)):
            want = fused_train_grads_reference(*args, radii=radii, dtype=dtype, **dist)
            if dtype == torch.float32:
                k2_err = max(k2_err, k2_abs(got, want))
            label = f"K2 vs {ref} [{name}]"
            hold(label, k2_errs(label, got, want), KERNEL_TOL)
            del want
        again = fused_train_grads(*args, radii=radii, **dist)
        if not all(torch.equal(a, b) for a, b in zip(k2_outs(got), k2_outs(again))):
            fail(f"two K2 launches [{name}] gave different bits")
        if space is None:
            if float(got.diag[:, 5].abs().max()) != 0.0:
                fail(f"K2 [{name}]: diag slot 5 is not 0 with the distortion loss off")
            continue
        plain_dist = float(render_ops.distortion_loss(got.weights, ts, UNB_NEAR, UNB_FAR, space,
                                                      dl if ipe else None))
        slot5 = float(got.diag[:, 5].mean())
        print(f"K2 [{name}]: mean diag slot 5 {slot5:.6g}, distortion_loss of its weights "
              f"{plain_dist:.6g}; two launches bit-identical")
        if not abs(slot5 - plain_dist) <= 1e-4 * abs(plain_dist) or plain_dist <= 0:
            fail(f"K2 [{name}]: diag slot 5 {slot5} vs distortion_loss {plain_dist}")
        if name == "contract + distortion disparity, S=64":
            model.zero_grad(set_to_none=True)
            sigma, rgb = apply_nerf(model, sampling.points_from_ts(o, d, ts), vd[:, None, :], cfg,
                                    torch.bfloat16)
            out = render_ops.composite(sigma, rgb, dl)
            mse = render_ops.mse(out.rgb, gold)
            ldist = render_ops.distortion_loss(out.weights, ts, UNB_NEAR, UNB_FAR, space)
            (mse + UNB_DIST * ldist).backward()
            params = dict(model.named_parameters())
            hold(f"K2 vs autograd [{name}]", {
                "rgb": float((got.diag[:, :3] - out.rgb.detach()).abs().max()),
                "loss": max(abs(float(got.diag[:, 4].mean()) - float(mse.detach())),
                            abs(float(got.diag[:, 5].mean()) - float(ldist.detach()))),
                "grads": max(leaf_err(g, params[k].grad)
                             for k, g in unpack_grads(got, model, cfg).items()),
            }, AUTOGRAD_TOL)
            model.zero_grad(set_to_none=True)
    return k1_err, k2_err


def drive_unbounded(tmp: str, preset: str) -> dict:
    """`cli train --preset {preset}` for UNB_STEPS steps at full width
    (exactly one K2 launch per step, one K1 launch for the 128x128 eval at
    step 50), then `render --view 0` at 800x800 (UNB_FRAME_K1 chunks, as
    render.default_render_chunk gives them) and `eval --max_views 2` on its
    checkpoint. Returns each path's launch counts."""
    from nerf_rs_tpu_torch.kernels.fused_ray import fused_ray_render
    from nerf_rs_tpu_torch.kernels.fused_train import fused_train_grads
    from nerf_rs_tpu_torch.render import default_render_chunk

    cfg = preset_cfg(preset)
    chunk = default_render_chunk(cfg.render, fused=True, model_cfg=cfg.model)
    frame_k1 = math.ceil(FRAME * FRAME / chunk)
    if frame_k1 != UNB_FRAME_K1[preset]:
        fail(f"{preset}: {frame_k1} render chunks of {chunk} rays per frame "
             f"(want {UNB_FRAME_K1[preset]})")
    view_k1 = math.ceil(cfg.camera.width * cfg.camera.height / chunk)
    ckdir = os.path.join(tmp, preset)
    flags = ["--preset", preset, "--dataset", "sphere", "--save_dir", ckdir]
    fused_train_grads.launches = fused_ray_render.launches = 0
    t0 = time.perf_counter()
    rc, out = run_cli(["train", *flags, "--num_iter", str(UNB_STEPS), "--eval_steps", "50",
                       "--save_steps", "1000", "--log_dir", ckdir])
    k2, k1 = fused_train_grads.launches, fused_ray_render.launches
    print(f"cli train --preset {preset}, {UNB_STEPS} steps: rc {rc}, K2 launches {k2}, "
          f"K1 launches {k1}, {time.perf_counter() - t0:.1f} s")
    losses = [float(v) for v in re.findall(r"iter=\d+, loss=(\S+)", out)]
    evals = [float(v) for v in re.findall(r"eval psnr=(\S+)", out)]
    if rc != 0 or k2 != UNB_STEPS or k1 != view_k1:
        fail(f"train --preset {preset}: rc {rc}, K2 launches {k2} (want {UNB_STEPS}), "
             f"K1 launches {k1} (want {view_k1})")
    if not losses or len(evals) != 1 or not all(map(math.isfinite, losses + evals)):
        fail(f"train --preset {preset}: losses {losses}, eval psnrs {evals}")
    counts = {"train": k2, "train_eval": k1}
    for key, argv, want in (
            ("render", ["render", "--width", str(FRAME), "--height", str(FRAME), "--view", "0",
                        "--out_dir", os.path.join(tmp, f"{preset}-render")], frame_k1),
            ("eval", ["eval", "--max_views", "2"], 2 * view_k1)):
        fused_ray_render.launches = fused_train_grads.launches = 0
        rc, out = run_cli([*argv, *flags])
        k1 = fused_ray_render.launches
        m = re.search(r"psnr[= ](\S+)", out)
        print(f"cli {key} --preset {preset}: rc {rc}, K1 launches {k1} (want {want})")
        if (rc != 0 or k1 != want or fused_train_grads.launches or m is None
                or not math.isfinite(float(m.group(1)))):
            fail(f"{key} --preset {preset}: rc {rc}, K1 launches {k1} (want {want}), "
                 f"psnr {m and m.group(1)}")
        counts[key] = k1
    if read_png(os.path.join(tmp, f"{preset}-render", "view-0.png")).shape != (FRAME, FRAME, 3):
        fail(f"{preset} wrote no {FRAME}x{FRAME} view")
    return counts


def scatter_inputs(dev) -> dict:
    """The table-gradient scatters of one ngp train step (4096 rays x 128
    jittered samples, as ngp_fetch_inputs), captured from the fetches: the
    brick layout's first sub-chunk (2^21 row fetches with their base lanes,
    16 values each, into the (131,072, 128) table) and the flat layout's
    2^26 pair fetches (2 values each, into the (8,388,608, 2) table), with
    seeded normal cotangents."""
    import torch

    from nerf_rs_tpu_torch.data.factory import make_dataset
    from nerf_rs_tpu_torch.models import hashgrid
    from nerf_rs_tpu_torch.models.mlp import init_nerf_params

    seen = {}
    fetches = {"brick": hashgrid._BrickFetch, "flat": hashgrid._PairFetch}
    for layout, fn in fetches.items():
        real = fn.apply

        def spy(table, *idx, _layout=layout, _real=real):
            seen.setdefault(_layout, (tuple(table.shape), *(i.clone() for i in idx)))
            return _real(table, *idx)
        fn.apply = staticmethod(spy)
    try:
        brick, flat = ngp_cfg("brick"), ngp_cfg("flat")
        pts = factored_points(make_dataset(brick, dev), brick.camera, NGP_RAYS, 21)
        with torch.no_grad():
            for cfg, encode in ((brick, hashgrid.brick_encode), (flat, hashgrid.hash_encode)):
                encode(init_nerf_params(cfg.model, 0, dev).table.detach(), pts, cfg.model)
    finally:
        for fn in fetches.values():
            del fn.apply  # back to autograd.Function's own
    gen = torch_generator(dev, 23)
    shape, rows_idx, base_lane = seen["brick"]
    out = {"brick": (torch.randn(rows_idx.shape[0], 16, generator=gen, device=dev), rows_idx,
                     base_lane, tuple(hashgrid._CORNER_LANES), shape)}
    shape, fidx = seen["flat"]
    out["flat"] = (torch.randn(fidx.shape[0], 2, generator=gen, device=dev), fidx // 2, None,
                   (0, 1), shape)
    return out


# scatter_rows' device time split by kernel: the sort (this port's radix_*
# kernels, or the library sort an earlier tree called) and the reduce (its
# scatter_* kernels); the rest (fills, memsets, index arithmetic) is "other"
SCATTER_SORT = re.compile(r"radix|[Ss]ort")
SCATTER_CALLS = 5  # scatter_rows calls per timing window
SCATTER_REDUCE = re.compile(r"scatter_")


def scatter_case(inputs, dev) -> tuple:
    """The flat layout's fetches with keys outside the table mixed in: every
    7th below 0 and every 11th at or past the last row."""
    import torch

    g, key, lane0, lanes, shape = inputs["flat"]
    key = key.clone()
    idx = torch.arange(key.shape[0], device=dev)
    key[idx % 7 == 3] = -1 - (idx[idx % 7 == 3] % 5).int()
    key[idx % 11 == 5] = shape[0] + (idx[idx % 11 == 5] % 3).int()
    return g, key, lane0, lanes, shape


def check_scatter(inputs, dev) -> float:
    """scatter_rows against its plain version bit for bit and across two
    launches, on both layouts' fetches of an ngp step and on the flat ones
    with keys outside the table; each call once more under
    torch.cuda.set_sync_debug_mode("error"), where a host synchronisation
    raises. Returns the largest absolute difference (0 when the bits
    agree)."""
    import torch

    from nerf_rs_tpu_torch.kernels import gather_rows as k4

    cases = dict(inputs)
    cases["flat, keys outside the table"] = scatter_case(inputs, dev)
    worst = 0.0
    for name, (g, key, lane0, lanes, shape) in cases.items():
        got = k4.scatter_rows(g, key, lane0, lanes, shape)
        again = k4.scatter_rows(g, key, lane0, lanes, shape)
        torch.cuda.synchronize()
        want = k4.scatter_rows_reference(g, key, lane0, lanes, shape)
        err = float((got - want).abs().max())
        if not (torch.equal(got, want) and torch.equal(got, again)):
            fail(f"scatter_rows [{name}]: differs from its plain version or across launches "
                 f"(max |diff| {err})")
        try:
            torch.cuda.set_sync_debug_mode("error")
            k4.scatter_rows(g, key, lane0, lanes, shape)
        except RuntimeError as e:
            fail(f"scatter_rows [{name}] synchronises with the host: {e}")
        finally:
            torch.cuda.set_sync_debug_mode(0)
        print(f"scatter_rows [{name}], {g.shape[0]} fetches into {shape}: bit-equal to its plain "
              f"version and across launches; no host sync under set_sync_debug_mode('error')")
        worst = max(worst, err)
        del got, again, want
    return worst


def time_scatter(card: str, inputs) -> dict:
    """The hash grid's table gradient at an ngp step's fetches, per layout:
    scatter_rows timed beside index_add_ on the same elements (float
    atomics, whose order changes between runs), PyTorch's deterministic
    route (index_put_ with accumulate=True under
    torch.use_deterministic_algorithms) and its plain version; its device
    time from a profile, split into the sort, the reduce and the rest; and
    its bound: the bytes it must move (the cotangents and int32 keys and
    lanes read once, the gradient table written once) over the memory
    rate."""
    import torch

    from nerf_rs_tpu_torch.kernels import gather_rows as k4

    rows = {}
    for layout, (g, key, lane0, lanes, shape) in inputs.items():
        got = k4.scatter_rows(g, key, lane0, lanes, shape)
        torch.cuda.synchronize()
        err = float((got - k4.scatter_rows_reference(g, key, lane0, lanes, shape)).abs().max())
        col = torch.tensor(lanes, device=g.device)[None, :]
        pos = (key.long()[:, None] * shape[1]
               + (col if lane0 is None else lane0.long()[:, None] + col)).reshape(-1)

        def index_add():
            return g.new_zeros(shape[0] * shape[1]).index_add_(0, pos, g.reshape(-1))
        atomics = index_add().view(shape)
        index_add_err = float((atomics - got).abs().max())

        def index_put():  # PyTorch's deterministic route: a sort, then ordered sums
            return g.new_zeros(shape[0] * shape[1]).index_put_((pos,), g.reshape(-1),
                                                                accumulate=True)
        was = torch.are_deterministic_algorithms_enabled()
        torch.use_deterministic_algorithms(True)
        try:
            ordered = index_put().view(shape)
            if not torch.equal(ordered, index_put().view(shape)):
                fail(f"index_put_ [{layout}] under use_deterministic_algorithms differs "
                     f"across calls")
            det_ms = event_ms(index_put)
        finally:
            torch.use_deterministic_algorithms(was)
        det_err = float((ordered - got).abs().max())
        del ordered
        call = lambda: k4.scatter_rows(g, key, lane0, lanes, shape)  # noqa: E731
        ms = event_ms(call)
        ms_window = per_call_ms(call, SCATTER_CALLS)
        lib_ms = event_ms(index_add)
        plain_ms = event_ms(lambda: k4.scatter_rows_reference(g, key, lane0, lanes, shape), reps=1)
        n, c = g.shape
        nbytes = n * c * 4 + n * (4 if lane0 is None else 8) + shape[0] * shape[1] * 4
        b, by = bound_ms(0.0, nbytes)
        per = profiled_split(call, SCATTER_CALLS, ms_window, b)
        sort_ms = kernel_ms = device = None
        split = f"device split {NOT_PROFILED}"
        if per is not None:
            sort_ms = sum(v for k, v in per.items() if SCATTER_SORT.search(k))
            kernel_ms = sum(v for k, v in per.items()
                            if SCATTER_REDUCE.search(k) and not SCATTER_SORT.search(k))
            device = sum(per.values())
            split = (f"device {device:.3f} ms: sort {sort_ms:.3f}, reduce {kernel_ms:.3f}, "
                     f"other {device - sort_ms - kernel_ms:.3f}")
        print(f"scatter_rows [{layout}], {n} fetches x {c} into {shape} [{card}]: {ms:.3f} ms "
              f"alone ({ms_window:.3f} ms a call in a window of {SCATTER_CALLS}; {split}), "
              f"index_add_ {lib_ms:.3f} ms (vs the fixed "
              f"order: max |diff| {index_add_err:.3g}), deterministic index_put_ {det_ms:.3f} ms "
              f"(max |diff| {det_err:.3g}), plain {plain_ms:.3f} ms, bound {b:.4f} ms ({by}, "
              f"{nbytes / 1e9:.3f} GB)")
        for k, v in sorted((per or {}).items(), key=lambda kv: -kv[1])[:12]:
            print(f"  {v:8.4f} ms  {re.sub(r'[(]anonymous namespace[)]::', '', k)[:90]}")
        rows[layout] = {"fetches": n, "values": c, "max_abs_err": err, "ms": ms,
                        "ms_window": ms_window,
                        "kernel_ms": kernel_ms, "sort_ms": sort_ms, "device_ms": device,
                        "plain_ms": plain_ms, "library_ms": lib_ms, "library_det_ms": det_ms,
                        "bound_ms": b, "bound_by": by, "index_add_vs_fixed": index_add_err,
                        "index_put_det_vs_fixed": det_err}
        del got, atomics, pos
    return rows


def ema_recurrence(seen, decay: float, ema=None) -> list:
    """The debiased EMA of the weights ``seen`` ([(step, [host leaves])],
    the weights after each Adam step) on the host in f32, by the port's
    coefficients (train/step.ema_coefficients) and its order of
    operations: e <- alpha e + beta p, from ``ema`` (zeros by default: the
    first update keeps none of it)."""
    import numpy as np

    from nerf_rs_tpu_torch.train.step import ema_coefficients

    e = ema or [np.zeros_like(p) for p in seen[0][1]]
    for t, leaves in seen:
        alpha, beta = (np.float32(x) for x in ema_coefficients(decay, t))
        e = [alpha * x + beta * p for x, p in zip(e, leaves)]
    return e


def drive_ema(argv) -> tuple:
    """One `cli train` ``argv`` with the weights after each Adam step
    copied to the host (by a wrapper of train/step.update_ema, which reads
    them): (rc, stdout, kernel_counts(), [(step, leaves)], names)."""
    from nerf_rs_tpu_torch.train import step as step_mod

    seen, names = [], []
    real = step_mod.update_ema

    def recording(state, decay):
        named = list(step_mod.named_trainable(state))
        names[:] = [n for n, _ in named]
        seen.append((state.step, [p.detach().cpu().numpy() for _, p in named]))
        real(state, decay)

    step_mod.update_ema = recording
    try:
        reset_counts()
        rc, out = run_cli(argv)
        counts = kernel_counts()
    finally:
        step_mod.update_ema = real
    return rc, out, counts, seen, names


def ema_gap(path: str, names, host) -> float:
    """The largest gap, relative to the leaf's largest entry, between the
    EMA a checkpoint holds and the host's leaves ``host``."""
    import torch

    saved = torch.load(path, map_location="cpu", weights_only=True)["ema"]
    return max(leaf_err(saved[n], torch.from_numpy(h)) for n, h in zip(names, host))


def drive_slice7(tmp: str, card: str) -> dict:
    """Phase 30, slice 7 on the card: `train --preset full --ema_decay
    0.999` for EMA_STEPS steps (K2 exactly once a step; a profiler window of
    PROFILE_STEPS steps whose trace names K2's kernel; the events of a
    logging step), its EMA against the host's recurrence from the same
    weights, a resume of EMA_RESUME steps that keeps averaging from the
    restored EMA; `eval` and `render --depth --gif` of an 800x800 sweep on
    the EMA weights (K1 by the chunk plan; the depth PNG against
    render_frame's depth / far; the GIF's frames by the port's header walk);
    `export --mesh` at 128^3; one `--accumulation_steps 4 --raw_noise_std 1`
    step (autograd: no K2), and four micro-batches' mean gradient against
    the one batch's. Then the times: the EMA step against the plain step in
    interleaved windows, the EMA update alone, the sweep and the export."""
    import dataclasses

    import numpy as np
    import torch

    from nerf_rs_tpu_torch.data.factory import make_dataset
    from nerf_rs_tpu_torch.data.images import decode_png, gif_frames
    from nerf_rs_tpu_torch.ops import rays as rays_ops
    from nerf_rs_tpu_torch.render import default_render_chunk, render_frame
    from nerf_rs_tpu_torch.train import checkpoint as ckpt, step as step_mod
    from nerf_rs_tpu_torch.utils import export as export_mod

    dev = torch.device("cuda")
    ckdir = os.path.join(tmp, "ema")
    common = ["--save_dir", ckdir, "--log_dir", ckdir]
    argv = ["train", *EMA_ARGS, *common, "--num_iter", str(EMA_STEPS), "--eval_steps", "1000",
            "--logging_steps", "25", "--save_steps", "1000", "--profile_steps",
            str(PROFILE_STEPS), "--run_name", "run"]
    rc, out, counts, seen, names = drive_ema(argv)
    k2_train = counts["K2"]
    path = ckpt.latest_checkpoint(ckdir)
    if rc != 0 or counts["K2"] != EMA_STEPS or len(seen) != EMA_STEPS:
        fail(f"EMA drive: rc {rc}, K2 launches {counts['K2']} (want {EMA_STEPS}), "
             f"{len(seen)} EMA updates")
    host = ema_recurrence(seen, 0.999)
    gap = ema_gap(path, names, host)
    run_dir = os.path.join(ckdir, "run")
    traces = [f for f in os.listdir(run_dir) if f.startswith("trace-")]
    trace_k2 = bool(traces) and "train_narrow_kernel" in open(os.path.join(run_dir,
                                                                         traces[0])).read()
    events = [f for f in os.listdir(run_dir) if f.startswith("events.out.tfevents.")]
    logged = bool(events) and b"density" in open(os.path.join(run_dir, events[0]), "rb").read()
    print(f"EMA drive, {EMA_STEPS} steps: K2 launches {counts['K2']}, the EMA against the "
          f"host's recurrence {gap:.3g} (tol {EMA_TOL:g}); profiler trace {traces} names K2's "
          f"train_narrow_kernel: {trace_k2}; events {events} hold the logging step's "
          f"diagnostics: {logged}")
    if not gap <= EMA_TOL or not trace_k2 or not logged:
        fail(f"EMA drive: EMA gap {gap} (tol {EMA_TOL}), trace names K2 {trace_k2}, "
             f"diagnostics logged {logged}")
    rc, out, counts, seen2, _ = drive_ema([a if a != str(EMA_STEPS) else
                                           str(EMA_STEPS + EMA_RESUME) for a in argv])
    k2_resume = counts["K2"]
    resumed = ckpt.latest_checkpoint(ckdir)
    saved = torch.load(path, map_location="cpu", weights_only=True)["ema"]
    host2 = ema_recurrence(seen2, 0.999, [saved[n].numpy() for n in names])
    gap2 = ema_gap(resumed, names, host2)
    print(f"EMA resume to {EMA_STEPS + EMA_RESUME}: K2 launches {counts['K2']}, the EMA "
          f"against the recurrence from the restored one {gap2:.3g}")
    if rc != 0 or counts["K2"] != EMA_RESUME or f"at step {EMA_STEPS}" not in out or \
            not gap2 <= EMA_TOL:
        fail(f"EMA resume: rc {rc}, K2 launches {counts['K2']} (want {EMA_RESUME}), gap {gap2}")

    # eval and the 800x800 sweep on the EMA weights
    reset_counts()
    rc, out = run_cli(["eval", *EMA_ARGS, *common, "--max_views", "2"])
    k1_eval = kernel_counts()["K1"]
    m = re.search(r"mean psnr over \d+ \S+ views: (\S+)", out)
    if rc != 0 or k1_eval != 2 or "using EMA weights" not in out or m is None or \
            not math.isfinite(float(m.group(1))):
        fail(f"eval on the EMA weights: rc {rc}, K1 launches {k1_eval} (want 2)")
    sweep = os.path.join(tmp, "ema-sweep")
    rargv = ["render", *EMA_ARGS, *common, "--width", str(FRAME), "--height", str(FRAME),
             "--frames", str(SWEEP_FRAMES), "--depth", "true", "--gif", "true",
             "--out_dir", sweep]
    rcfg = cli_config(rargv)
    want_k1 = math.ceil(SWEEP_FRAMES * FRAME * FRAME / default_render_chunk(
        rcfg.render, fused=True, model_cfg=rcfg.model))
    reset_counts()
    (rc, out), sweep_s = timed_call(lambda: run_cli(rargv))
    k1_sweep = kernel_counts()["K1"]
    if rc != 0 or k1_sweep != want_k1 or "using EMA weights" not in out:
        fail(f"render --depth --gif: rc {rc}, K1 launches {k1_sweep} (want {want_k1})")
    ema = ckpt.load_ema(resumed, step_mod.init_state(rcfg, dev).params)
    angles = rays_ops.spherical_render_path(SWEEP_FRAMES, math.pi / 6, dev)
    pose = rays_ops.pose_from_yaw_pitch(angles[:1, 0], angles[:1, 1])[0]
    o, d = rays_ops.maybe_ndc(*rays_ops.ray_grid(pose, rcfg.camera), rcfg.camera)
    _, depth, _ = render_frame(rcfg, ema, o, d)
    want = (torch.clamp(depth / rcfg.camera.far, 0, 1) * 255.0).to(torch.uint8).cpu().numpy()
    with open(os.path.join(sweep, "frame-000-depth.png"), "rb") as f:
        got = decode_png(f.read())[..., 0]
    depth_lsb = int(np.abs(got.astype(int) - want.astype(int)).max())
    with open(os.path.join(sweep, "sweep.gif"), "rb") as f:
        gif = gif_frames(f.read())
    print(f"render --depth --gif, {SWEEP_FRAMES} frames of {FRAME}x{FRAME}: K1 launches "
          f"{k1_sweep} (want {want_k1}), depth PNG vs render_frame's depth / far {depth_lsb} "
          f"LSB, GIF screen and frames {gif[0]} x {len(gif[1])}")
    if depth_lsb > 1 or gif != ((FRAME, FRAME), [(FRAME, FRAME)] * SWEEP_FRAMES):
        fail(f"render --depth --gif: depth PNG {depth_lsb} LSB off, GIF {gif}")

    # export --mesh at 128^3, at the default threshold where the EMA field's
    # density passes it, else halfway up its range
    sigma, _ = export_mod.sample_density_grid(ema, rcfg.model, res=EXPORT_RES)
    grid_s = timed_call(lambda: export_mod.sample_density_grid(ema, rcfg.model,
                                                               res=EXPORT_RES))[1]
    thr = 5.0 if (sigma > 5.0).any() else float(0.5 * (sigma.min() + sigma.max()))
    prefix = os.path.join(tmp, "ema-export", "field")
    (rc, out), mesh_s = timed_call(lambda: run_cli([
        "export", *EMA_ARGS, *common, "--grid_res", str(EXPORT_RES), "--out", prefix,
        "--threshold", str(thr), "--mesh", "true"]))
    grid = np.load(prefix + ".npz")
    points = int(re.search(r"element vertex (\d+)", open(prefix + ".ply").read()).group(1))
    with open(prefix + "_mesh.ply") as f:
        faces = int(re.search(r"element face (\d+)", f.read(400)).group(1))
    above = int((grid["sigma"] > thr).sum())
    print(f"export --mesh at {EXPORT_RES}^3: sigma in [{sigma.min():.3g}, {sigma.max():.3g}], "
          f"threshold {thr:.3g}: {points} points ({above} cells above), {faces} faces")
    if rc != 0 or grid["sigma"].shape != (EXPORT_RES,) * 3 or \
            grid["rgb"].shape != (EXPORT_RES,) * 3 + (3,) or points != above or above == 0 \
            or faces == 0:
        fail(f"export --mesh: rc {rc}, sigma {grid['sigma'].shape}, rgb {grid['rgb'].shape}, "
             f"{points} points of {above} cells above {thr}, {faces} faces")

    # one accumulated step with sigma noise (autograd, as in the JAX package)
    reset_counts()
    adir = os.path.join(tmp, "acc")
    rc, out = run_cli(["train", "--preset", "full", "--dataset", "sphere", "--num_iter", "1",
                       "--accumulation_steps", "4", "--raw_noise_std", "1.0",
                       "--save_dir", adir, "--log_dir", adir])
    blob = torch.load(ckpt.latest_checkpoint(adir), map_location="cpu", weights_only=True)
    finite = all(bool(torch.isfinite(v).all()) for v in blob["params"].values())
    if rc != 0 or kernel_counts()["K2"] != 0 or not finite:
        fail(f"accumulated noisy step: rc {rc}, K2 {kernel_counts()['K2']} (want 0), "
             f"finite weights {finite}")
    # with noise 0, four micro-batches' mean gradient against the one batch's
    acfg = cli_config(["train", "--preset", "full", "--dataset", "sphere", "--precision", "f32",
                       "--accumulation_steps", "4"])
    acfg = dataclasses.replace(acfg, render=dataclasses.replace(acfg.render, randomized=False))
    ds = make_dataset(acfg, dev)
    batch = ds.sample_batch(step_mod.step_generator(0, 0, dev), acfg.train.num_rays)
    state = step_mod.init_state(acfg, dev)
    acc_grads, _ = step_mod.accumulated_grads(state, batch, None, acfg)
    acc_grads = {k: v.clone() for k, v in acc_grads.items()}
    state.optimizer.zero_grad(set_to_none=True)
    step_mod.loss_fn(state.params, batch, None, acfg)[0].backward()
    acc_err = max(leaf_err(acc_grads[n], p.grad) for n, p in step_mod.named_trainable(state))
    print(f"accumulated noisy step: finite weights, K2 launches 0 (autograd); four "
          f"micro-batches against one batch of {acfg.train.num_rays} rays, f32: {acc_err:.3g} "
          f"(tol {ACC_TOL:g})")
    if not acc_err <= ACC_TOL:
        fail(f"accumulated gradients {acc_err} from the one-batch gradients (tol {ACC_TOL})")

    # times: the EMA step against the plain step in interleaved windows
    ecfg = cli_config(["train", *EMA_ARGS])
    pcfg = cli_config(["train", "--preset", "full", "--dataset", "sphere"])
    ds = make_dataset(ecfg, dev)
    runs = {}
    for name, c in (("EMA", ecfg), ("plain", pcfg)):
        st = step_mod.init_state(c, dev)
        fn = step_mod.make_train_step(c, ds)
        it = [0]

        def run(k, fn=fn, holder=[st], it=it):
            for _ in range(k):
                holder[0], _ = fn(holder[0], step_mod.step_generator(0, it[0], dev))
                it[0] += 1
        run(3)
        runs[name] = (run, st)
    best = {"EMA": math.inf, "plain": math.inf}
    for _ in range(3):
        for name in ("EMA", "plain", "plain", "EMA"):
            best[name] = min(best[name], best_of(lambda: runs[name][0](EMA_WINDOW), 1))
    ema_ms, plain_ms = (best[k] / EMA_WINDOW * 1e3 for k in ("EMA", "plain"))
    est = runs["EMA"][1]
    update_ms = event_ms(lambda: step_mod.update_ema(est, 0.999))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            step_mod.update_ema(est, 0.999)
        torch.cuda.synchronize()
    update_dev_us = sum(device_ms(prof).values()) / 10 * 1e3
    nparams = sum(p.numel() for _, p in step_mod.named_trainable(est))
    print(f"slice 7 times [{card}]: flagship step with the EMA {ema_ms:.3f} ms against "
          f"{plain_ms:.3f} ms without (best of 6 interleaved windows of {EMA_WINDOW}), the EMA "
          f"update alone {update_ms * 1e3:.1f} us over {nparams} parameters (CUDA events; "
          f"{update_dev_us:.1f} us of device time, profiled); "
          f"`render --depth --gif` of {SWEEP_FRAMES} {FRAME}x{FRAME} frames {sweep_s:.3f} s "
          f"({sweep_s / SWEEP_FRAMES:.3f} s a frame, CLI wall with the PNGs and the GIF); "
          f"`export --mesh` at {EXPORT_RES}^3 {mesh_s:.3f} s (CLI wall; the grid alone "
          f"{grid_s:.3f} s)")
    return {"k2_train": k2_train, "k2_resume": k2_resume, "k1_eval": k1_eval,
            "k1_sweep": k1_sweep, "ema_gap": max(gap, gap2), "depth_lsb": depth_lsb,
            "acc_err": acc_err, "ema_step_ms": ema_ms, "plain_step_ms": plain_ms,
            "ema_update_us": update_ms * 1e3, "ema_update_device_us": update_dev_us,
            "params": nparams, "sweep_s": sweep_s,
            "export_mesh_s": mesh_s, "grid_s": grid_s,
            "mesh_faces": faces, "export_points": points}


def witness_cfg(preset: str, seed: str, extra):
    """The config of the preset's 64x64 learning drive as learn_seeds runs
    it (--num_samples 32, 1024 rays, lr 1e-3 unless ``extra`` sets one), on
    ``seed``, with the CLI flags ``extra``: the routes of witness_steps and
    fault6_routes."""
    lr = [] if "--learning_rate" in extra else ["--learning_rate", "1e-3"]
    return preset_cfg(preset, "--width", "64", "--height", "64", "--num_samples", "32",
                      "--num_rays", "1024", "--seed", seed, *lr, *extra)


def eval_psnr(cfg, state, ds) -> float:
    """The mean PSNR of ``state``'s fields over the first LEARN_VIEWS views
    of ``ds`` (what `cli eval --max_views LEARN_VIEWS` prints)."""
    from nerf_rs_tpu_torch.ops import render as render_ops
    from nerf_rs_tpu_torch.render import make_render, render_frame

    render_fn, psnrs = make_render(cfg), []
    for v in range(LEARN_VIEWS):
        rgb, _, _ = render_frame(cfg, state.params, *ds.view_rays(v), render_fn,
                                 fine_params=state.fine_params, grid=state.grid)
        psnrs.append(float(render_ops.psnr(rgb, ds.view_gold(v))))
    return sum(psnrs) / len(psnrs)


def fault6_routes(preset: str, seed: str, steps: str, extra) -> dict:
    """Fault 6's drive in a learning pool process: the preset's 64x64
    drive (as learn_seeds runs it, with the CLI flags ``extra``) for
    ``steps`` steps from the same start and draws through K2, through K2's
    plain version in its place (plain_train_route) and through autograd,
    one route after another; each route's loss at the last step, its K2
    launches and its mean eval PSNR over LEARN_VIEWS views."""
    import dataclasses

    import torch

    from nerf_rs_tpu_torch.data.factory import make_dataset
    from nerf_rs_tpu_torch.train.loop import update_occupancy
    from nerf_rs_tpu_torch.train.step import init_state, make_train_step, step_generator

    dev = torch.device("cuda")
    cfg = witness_cfg(preset, seed, extra)
    ds = make_dataset(cfg, dev)
    out = {}
    for route in ("K2", "plain", "autograd"):
        c = cfg if route != "autograd" else dataclasses.replace(cfg, use_whole_ray_train=False)
        reset_counts()
        with plain_train_route() if route == "plain" else contextlib.nullcontext():
            state, fn = init_state(c, dev), make_train_step(c, ds)
            for it in range(int(steps)):
                state, aux = fn(state, step_generator(c.train.seed, it, dev))
                if state.grid is not None and it % c.render.occ_update_steps == 0:
                    state.grid = update_occupancy(state, c, it)
        out[route] = {"psnr": eval_psnr(c, state, ds), "loss": float(aux["loss"]),
                      "k2": kernel_counts()["K2"]}
    return out


def fault6_check(task) -> dict:
    """Waits for fault 6's drive and holds K2 and its plain version within
    FAULT6_MARGIN dB (a miss fails the run at its end)."""
    preset, seed, steps, extra = FAULT6
    routes = task.result()
    gap = abs(routes["K2"]["psnr"] - routes["plain"]["psnr"])
    print(f"fault 6: {preset} {' '.join(extra)} seed {seed}, {steps} steps from one start and "
          f"draws: mean eval psnr over {LEARN_VIEWS} views through K2 {routes['K2']['psnr']:.3f} "
          f"(K2 launches {routes['K2']['k2']}), through K2's plain version "
          f"{routes['plain']['psnr']:.3f} ({routes['plain']['k2']}), through autograd "
          f"{routes['autograd']['psnr']:.3f}; K2 - plain {gap:.3f} dB (margin {FAULT6_MARGIN}); "
          f"last losses " + ", ".join(f"{k} {r['loss']:.5f}" for k, r in routes.items()))
    if routes["K2"]["k2"] != int(steps) or routes["plain"]["k2"] or routes["autograd"]["k2"]:
        fail(f"fault 6 drive: K2 launches {[r['k2'] for r in routes.values()]} "
             f"(want {steps}, 0, 0)")
    if not gap <= FAULT6_MARGIN:
        msg = f"fault 6: K2 and its plain version {gap:.3f} dB apart (margin {FAULT6_MARGIN})"
        print(f"chip_smoke: {msg}; the run fails at its end")
        DEFERRED.append(msg)
    return {**routes, "gap_db": gap, "margin_db": FAULT6_MARGIN}


def learn_seeds(preset: str, seeds: str, extra) -> int:
    """The preset's 64x64 learning drive as the learning checks run it
    (--num_samples 32, 1024 rays, lr 1e-3 unless ``extra`` sets one, 301
    steps, then `cli eval --max_views LEARN_VIEWS`) for each seed in the
    comma-separated ``seeds``, with the CLI flags ``extra``; prints each
    seed's mean PSNR and its K2 launches. A diagnostic: it holds no bar."""
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: the learning drives run on the card only")
    from nerf_rs_tpu_torch.kernels.fused_train import fused_train_grads

    card = card_line()
    common = ["--preset", preset, "--dataset", "sphere", "--width", "64", "--height", "64",
              "--num_samples", "32", *extra]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_learn_")
    try:
        for seed in seeds.split(","):
            vdir = os.path.join(tmp, seed)
            fused_train_grads.launches = 0
            lr = [] if "--learning_rate" in extra else ["--learning_rate", "1e-3"]
            run_cli(["train", *common, "--seed", seed, "--num_rays", "1024", "--num_iter", "301",
                     "--eval_steps", "100", *lr, "--save_dir", vdir, "--log_dir", vdir])
            k2 = fused_train_grads.launches
            rc, out = run_cli(["eval", *common, "--save_dir", vdir, "--max_views",
                               str(LEARN_VIEWS)])
            m = re.search(r"mean psnr over \d+ \S+ views: (\S+)", out)
            print(f"learn {preset} {' '.join(extra)} seed {seed} [{card}]: mean psnr "
                  f"{m and m.group(1)}, K2 launches {k2}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


# the steps of a witness drive at which its relu units are counted
DEAD_STEPS = (12, 50, 100, 300)
# the route pairs a witness drive holds to KERNEL_TOL, and the ray groups
# its attribution leaves out one at a time
WITNESS_PAIRS = {"K2-witness": ("K2", "witness"), "plain-witness": ("plain", "witness"),
                 "K2-plain": ("K2", "plain")}
WITNESS_GROUPS = 16


def k2_leaves(depth: int) -> list:
    """K2's gradient leaves in kernel order (dw, then db), as k2_errs' 'grads' takes them."""
    return ([f"dW trunk {i}" for i in range(depth)]
            + ["dW skip", "dW [feature|sigma]", "dW view (feature)", "dW view (direction)",
               "dW rgb"]
            + [f"db trunk {i}" for i in range(depth)]
            + ["db [feature|sigma]", "db view", "db rgb"])


def past_tol(errs: dict) -> bool:
    from nerf_rs_tpu_torch.kernels.fused_train import KERNEL_TOL

    return any(not v <= KERNEL_TOL[k] for k, v in errs.items())


def attribute_gaps(step: int, call, outs: dict) -> None:
    """Where a witness drive's launch stands past KERNEL_TOL between two of
    its routes (K2, the plain version, the float64 witness: ``outs``, on the
    launch's arguments ``call``): per pair past it, the gradient leaf and
    entry of its largest gap with the three routes' values there; the
    gates (trunk and view pre-activations, relu sigma_raw) whose sign the
    plain version and the witness take apart, and the rays they lie on; the
    three pairs again without those rays; and, leaving out each of
    WITNESS_GROUPS groups of rays in turn, the groups without which a pair
    comes within KERNEL_TOL, with each such group's flipped gates. Prints
    one line per finding."""
    import torch

    from nerf_rs_tpu_torch.kernels import fused_train

    kern, ref = fused_train.fused_train_grads, fused_train.fused_train_grads_reference
    args, kw = call
    n, S = args[5].shape
    depth = args[0].depth

    def subset(keep):
        def cut(t):
            return t[keep].contiguous() if isinstance(t, torch.Tensor) and t.shape[:1] == (n,) \
                else t
        return [cut(t) for t in args], {k: cut(v) for k, v in kw.items()}

    def run3(a, k):
        return {"K2": kern(*a, **k), "plain": ref(*a, **k),
                "witness": ref(*a, dtype=torch.float64, **k)}

    def gaps(o):
        return {p: k2_errs(p, o[x], o[y]) for p, (x, y) in WITNESS_PAIRS.items()}

    names = k2_leaves(depth)
    head = f"attribution step {step}"
    full = gaps(outs)
    flagged = [p for p, e in full.items() if past_tol(e)]
    for p in flagged:
        x, y = WITNESS_PAIRS[p]
        leaves = lambda o: o.dw + o.db  # noqa: E731
        errs = [leaf_err(a.double(), b.double()) for a, b in zip(leaves(outs[x]),
                                                                  leaves(outs[y]))]
        li = max(range(len(errs)), key=errs.__getitem__)
        a, b = leaves(outs[x])[li].double(), leaves(outs[y])[li].double()
        flat = int((a - b).abs().argmax())
        entry = tuple(int(i) for i in torch.unravel_index(torch.tensor(flat), a.shape))
        vals = ", ".join(f"{r} {float(leaves(outs[r])[li].reshape(-1)[flat]):.6g}"
                         for r in ("K2", "plain", "witness"))
        print(f"{head}: {p} {', '.join(f'{k} {v:.3g}' for k, v in full[p].items())}; worst "
              f"leaf {names[li]} entry {entry}: {vals}; leaf max {float(b.abs().max()):.6g}")
    tp, tw = {}, {}
    ref(*args, trace=tp, **kw)
    ref(*args, dtype=torch.float64, trace=tw, **kw)
    gates = [(f"trunk {i}", tp["pre"][i], tw["pre"][i]) for i in range(depth)]
    gates.append(("view", tp["hv"], tw["hv"]))
    if "sigma_raw" in tp:
        gates.append(("sigma_raw", tp["sigma_raw"][:, None], tw["sigma_raw"][:, None]))
    flip_rows = torch.zeros(n * S, dtype=torch.int64, device=args[2].device)
    per_gate = []
    for name, gp, gw in gates:
        flips = (gp > 0) != (gw > 0)
        flip_rows += flips.sum(dim=1)
        per_gate.append(f"{name} {int(flips.sum())}")
    flips_g = flip_rows.reshape(n, S).sum(dim=1)
    flip_rays = flips_g > 0
    print(f"{head}: gates whose sign the plain version and the witness take apart: "
          f"{', '.join(per_gate)}, on {int(flip_rays.sum())} of {n} rays")
    keep = (~flip_rays).nonzero()[:, 0]
    if 0 < keep.numel() < n:
        rest = gaps(run3(*subset(keep)))
        print(f"{head}: without those rays: " + "; ".join(
            f"{p} " + ", ".join(f"{k} {v:.3g}" for k, v in e.items()) for p, e in rest.items()))
    group_rays = -(-n // WITNESS_GROUPS)
    carriers = {p: [] for p in flagged}
    for g in range(WITNESS_GROUPS):
        mask = torch.ones(n, dtype=torch.bool, device=args[2].device)
        mask[g * group_rays:(g + 1) * group_rays] = False
        left = gaps(run3(*subset(mask.nonzero()[:, 0])))
        for p in flagged:
            if not past_tol(left[p]):
                carriers[p].append(g)
    for p, groups in carriers.items():
        info = "; ".join(
            f"group {g} (rays {g * group_rays}-{min(n, (g + 1) * group_rays) - 1}): "
            f"{int(flips_g[g * group_rays:(g + 1) * group_rays].sum())} flipped gates"
            for g in groups)
        print(f"{head}: {p} comes within KERNEL_TOL without "
              + (info if groups else "no single group"))


def dead_units(params, cfg, probe) -> dict:
    """The relu units of a NeRF field that are dead on ``probe`` (rays'
    points and view directions, f32): per trunk layer and in the view
    head, the count of units whose pre-activation is at most 0 at every
    probe point; and the share of probe points where the raw density is at
    most 0 (relu density: no density, no gradient to it)."""
    import torch
    import torch.nn.functional as F

    from nerf_rs_tpu_torch.models.encoding import posenc
    from nerf_rs_tpu_torch.models.mlp import dense

    pts, vd = probe
    mc = cfg.model
    with torch.no_grad():
        x = posenc(pts, mc.pos_enc_levels, mc.include_input_in_enc)
        h, dead = x, []
        for i, layer in enumerate(params.trunk):
            if i == mc.skip_layer and i > 0:
                h = torch.cat([h, x], dim=-1)
            pre = dense(h, layer)
            dead.append(int((pre.reshape(-1, pre.shape[-1]).amax(0) <= 0).sum()))
            h = F.relu(pre)
        sigma_raw = dense(h, params.sigma)[..., 0]
        feat = dense(h, params.feature)
        d = posenc(vd, mc.dir_enc_levels, mc.include_input_in_enc).expand(*feat.shape[:-1], -1)
        pre = dense(torch.cat([feat, d], dim=-1), params.view1)
        view = int((pre.reshape(-1, pre.shape[-1]).amax(0) <= 0).sum())
    return {"trunk": dead, "trunk_total": sum(dead), "width": mc.net_width, "view": view,
            "sigma_off": float((sigma_raw <= 0).float().mean())}


def witness_steps(preset: str, seed: str, steps: str, extra) -> int:
    """The first ``steps`` steps of the preset's 64x64 learning drive (as
    learn_seeds runs it, with the CLI flags ``extra``), through K2, through
    K2's plain version in its place (the same arithmetic in another
    summation order) and through autograd, from the same weights and draws
    (the occupancy grid, where there is one, updated as the loop updates
    it): per step the losses, how far apart the K2 and autograd routes'
    weights stand (the largest leaf difference relative to the leaf's
    largest entry), and every K2 launch held to its float64 witness and its
    plain version (KERNEL_TOL's keys), and the plain version to the witness.
    At the steps of DEAD_STEPS (those below ``steps``) each route's dead
    relu units (``dead_units``, on 1,024 rays of view 0 at the preset's
    midpoint samples). At the end: the first step at which a K2 launch
    left KERNEL_TOL of its witness (or none), how many launches left it
    (K2 and its plain version, each against the witness), the largest
    witness gap of each key over the drive, and each route's mean eval
    PSNR over LEARN_VIEWS views. A diagnostic: it holds no bar."""
    import dataclasses

    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: the kernels run on the card only")
    torch.backends.cuda.matmul.allow_tf32 = False  # plain version: full f32
    from nerf_rs_tpu_torch.data.factory import make_dataset
    from nerf_rs_tpu_torch.kernels import fused_train
    from nerf_rs_tpu_torch.ops import sampling
    from nerf_rs_tpu_torch.train.loop import update_occupancy
    from nerf_rs_tpu_torch.train.step import init_state, make_train_step, step_generator

    card = card_line()
    dev = torch.device("cuda")
    cfg = witness_cfg(preset, seed, extra)
    ds = make_dataset(cfg, dev)
    routes = {"K2": cfg, "plain": cfg,
              "autograd": dataclasses.replace(cfg, use_whole_ray_train=False)}
    states = {k: init_state(c, dev) for k, c in routes.items()}
    fns = {k: make_train_step(c, ds) for k, c in routes.items()}
    real, held = fused_train.fused_train_grads, []
    o, d = (t.reshape(-1, 3)[::4] for t in ds.view_rays(0))
    ts = sampling.stratified_ts(o.shape[0], cfg.render.num_samples, cfg.camera.near,
                                cfg.camera.far, randomized=False, device=dev)
    vd = d / d.norm(dim=-1, keepdim=True)
    probe = (sampling.points_from_ts(o, d, ts), vd[:, None, :])
    first_out, worst, route, step = None, {}, ["K2"], [0]
    past = {"K2": 0, "plain": 0}  # launches past KERNEL_TOL of the witness

    def witnessed(*args, **kw):
        plain = fused_train.fused_train_grads_reference(*args, **kw)
        if route[0] == "plain":
            return plain
        got = real(*args, **kw)
        wit = fused_train.fused_train_grads_reference(*args, dtype=torch.float64, **kw)
        held.append((k2_errs("witness", got, wit), k2_errs("plain", got, plain),
                     k2_errs("plain vs witness", plain, wit)))
        if any(past_tol(e) for e in held[-1]):
            fused_train.fused_train_grads = real
            try:
                attribute_gaps(step[0], (args, kw), {"K2": got, "plain": plain, "witness": wit})
            finally:
                fused_train.fused_train_grads = witnessed
        return got

    witnessed.launches = 0  # the wrapped kernel counts its launches on this name
    fused_train.fused_train_grads = witnessed
    try:
        for it in range(int(steps)):
            step[0] = it
            held.clear()
            losses = {}
            for k, c in routes.items():
                route[0] = k
                states[k], aux = fns[k](states[k], step_generator(c.train.seed, it, dev))
                losses[k] = float(aux["loss"])
                if states[k].grid is not None and it % c.render.occ_update_steps == 0:
                    states[k].grid = update_occupancy(states[k], c, it)
            gap = max(leaf_err(a.detach(), b.detach()) for a, b in zip(
                states["K2"].params.parameters(), states["autograd"].params.parameters()))
            out_of = lambda e: any(not v <= fused_train.KERNEL_TOL[k] for k, v in e.items())
            for w, _, pw in held:
                for k, v in w.items():
                    worst[k] = max(worst.get(k, 0.0), v)
                    if first_out is None and not v <= fused_train.KERNEL_TOL[k]:
                        first_out = (it, k, v)
                past["K2"] += out_of(w)
                past["plain"] += out_of(pw)
            print(f"witness {preset} {' '.join(extra)} seed {seed} step {it} [{card}]: loss K2 "
                  f"{losses['K2']:.6f}, plain {losses['plain']:.6f}, autograd "
                  f"{losses['autograd']:.6f}; weights apart {gap:.3g}; K2 launches vs witness "
                  + "; ".join(", ".join(f"{k} {v:.3g}" for k, v in w.items()) for w, _, _ in held)
                  + " | vs plain "
                  + "; ".join(", ".join(f"{k} {v:.3g}" for k, v in p.items()) for _, p, _ in held)
                  + " | plain vs witness "
                  + "; ".join(", ".join(f"{k} {v:.3g}" for k, v in p.items()) for _, _, p in held))
            if it in DEAD_STEPS and cfg.model.arch == "nerf":
                for k in routes:
                    print(f"dead relu units {preset} seed {seed} step {it} route {k}: "
                          f"{dead_units(states[k].params, cfg, probe)}")
    finally:
        fused_train.fused_train_grads = real
    print(f"witness summary {preset} {' '.join(extra)} seed {seed} [{card}]: first K2 launch "
          f"past KERNEL_TOL of its witness: "
          + (f"step {first_out[0]} ({first_out[1]} {first_out[2]:.3g})" if first_out else "none")
          + f" in {steps} steps; launches past it: K2 {past['K2']}, its plain version "
          + f"{past['plain']}; largest K2 witness gaps "
          + ", ".join(f"{k} {v:.3g} (tol {fused_train.KERNEL_TOL[k]:g})" for k, v in worst.items()))
    for k, c in routes.items():
        print(f"witness eval {preset} seed {seed} route {k} after {steps} steps: mean psnr "
              f"{eval_psnr(c, states[k], ds):.2f} over {LEARN_VIEWS} views")
    return 0


def time_step(root: str) -> int:
    """The times of the kernels for the checkout at ``root``: ptxas' report
    of every kernel instance; the flagship train step through K2, autograd
    and the plain version, one K2 call and one K1 chunk; every K1 and K2
    call of the main paths (BRANCH_SHAPES, UNB_SHAPES and RECORD_SHAPES: K2
    at S = 192 and 193 with 4096 rays among them; LONG_SHAPES' K2 calls, the
    300- and 512-sample calls in two blocks) beside autograd's or the eager
    field's, each K2 call split by kernel, its K2b beside K2b's floor
    (k2b_floor); the calls at the wide and padded widths
    (WIDE_RUNS, PADDED_RUNS); the train steps of TIMED_STEPS through K2 and
    through autograd, each K2 step's device-idle share; then the hash grid's table gradient (scatter_rows at an ngp
    step's fetches, both layouts, split into sort and reduce), K4's two
    gathers, both ngp steps and frames, and the factored step with K3's
    calls (forward at 524,288 points under bf16 and f32 and at 4,194,304,
    backward at 524,288). Its kernels build into that checkout."""
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
    from nerf_rs_tpu_torch.data.factory import make_dataset
    from nerf_rs_tpu_torch.kernels.fused_render import pack_weights
    from nerf_rs_tpu_torch.models.mlp import init_nerf_params

    from nerf_rs_tpu_torch.kernels import build

    card = card_line()
    print(f"{root} [{card}]")
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        for name, lib in zip(KERNELS, pool.map(build.build, KERNELS)):
            ptxas_report(name, lib)
    dev = torch.device("cuda")
    time_training(card)
    mcfg = ModelConfig()
    model = init_nerf_params(mcfg, 0, dev)
    cfg, fo, fd = frame_rays(dev)
    flat_o, flat_d = fo.reshape(-1, 3), fd.reshape(-1, 3)
    packed = pack_weights(model, mcfg)
    time_chunk(card, packed, mcfg, cfg.camera, flat_o, flat_d)
    time_branches(card, model, mcfg, cfg.camera, flat_o, flat_d,
                  BRANCH_SHAPES + UNB_SHAPES + RECORD_SHAPES
                  + tuple(sh for sh in LONG_SHAPES if sh.kernel == "K2"), plain_too=False)
    for name in WIDE_RUNS + PADDED_RUNS:  # calls at other widths beside the eager field and autograd
        wcfg = width_cfg(name, cfg.model)
        width_calls(name, seeded_model(wcfg, dev), wcfg, dataclasses.replace(cfg, model=wcfg),
                    flat_o, flat_d, card)
        wide_k2_split(sys.modules[__name__], name, dev, card)
    for preset, extra in TIMED_STEPS:  # each preset's step through K2 and autograd, profiled
        preset_steps(card, preset, profiled=True, extra=extra)
    del model, packed
    time_scatter(card, scatter_inputs(dev))
    time_gather(card, ngp_fetch_inputs(dev))
    time_ngp(card, fo, fd)
    fcfg = factored_config()
    time_factored(card, make_dataset(fcfg, dev), init_nerf_params(fcfg.model, 0, dev).lines.detach())
    return 0


def state_digest(state, *extra) -> str:
    """sha256 of a train state's weights and Adam state (and ``extra``
    tensors, such as an error store): equal digests, equal bits."""
    import hashlib

    import torch

    from nerf_rs_tpu_torch.train import step as step_mod

    h = hashlib.sha256()
    tensors = [p for _, p in step_mod.named_trainable(state)]
    for per_param in state.optimizer.state_dict()["state"].values():
        tensors += [v for _, v in sorted(per_param.items()) if isinstance(v, torch.Tensor)]
    for t in tensors + list(extra):
        h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def flagship_frame_model(dev):
    """The frame check's field: the flagship's seed-0 weights with phase
    3's random biases."""
    from nerf_rs_tpu_torch import ModelConfig
    from nerf_rs_tpu_torch.models.mlp import init_nerf_params

    return random_biases_(init_nerf_params(ModelConfig(), 0, dev), 0)


def midpoint_cfg(preset: str):
    """``preset_cfg(preset)`` with midpoint samples (the reduced-gradient
    check: both sides see the same samples)."""
    import dataclasses

    cfg = preset_cfg(preset)
    return dataclasses.replace(cfg, render=dataclasses.replace(cfg.render, randomized=False))


def repeated_draws(ds, store, num_rays: int, frac: float, calls: int = DRAW_CALLS) -> int:
    """How many different pixel-id vectors ``calls`` calls of
    ``error_weighted_from_draws`` give on ``store`` with one set of draws
    (fault 11: one, if the draws repeat)."""
    import torch

    g = torch.Generator(device=store.device).manual_seed(11)
    num_err = int(num_rays * frac)
    u = torch.rand((num_err,), generator=g, device=store.device)
    idx_uni = torch.randint(0, store.shape[0], (num_rays - num_err,), generator=g,
                            device=store.device)
    seen = {tensor_digest(ds.error_weighted_from_draws(store, u, idx_uni).idx)
            for _ in range(calls)}
    return len(seen)


def tensor_digest(t) -> str:
    import hashlib

    return hashlib.sha256(t.detach().cpu().numpy().tobytes()).hexdigest()


# the calls of an error-weighted step in the order they run, as --trace-draws
# records them: the store read, its running sum, the drawn pixels, the step's
# per-ray errors, the updated weights, the store written
TRACE_CALLS = ("store_in", "cdf", "idx", "ray_err", "weights", "store_out")


def trace_draws() -> int:
    """--trace-draws, fault 11's trace on one card in one process: POD_STEPS
    steps of `--preset pod --use_whole_ray_train true` (per-ray batches, no
    ranks, no host pipeline) run twice from one start with one generator per
    step, once with the running sum of ``torch.cumsum`` (the scan before the
    repair) and once with ``fixed_order_cumsum``; after every step the
    digests of TRACE_CALLS and the loss. Prints, per scan, the first step at
    which the two runs part and the first call of that step that differs;
    then DRAW_CALLS calls of each scan, of ``update_error_store`` and of
    ``error_weighted_from_draws`` on the final store with one input each,
    and how many different results each gave."""
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: --trace-draws runs on the card only")
    card = card_line()
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    from nerf_rs_tpu_torch.data import dataset as dataset_mod
    from nerf_rs_tpu_torch.data.factory import make_dataset
    from nerf_rs_tpu_torch.kernels import build
    from nerf_rs_tpu_torch.train import step as step_mod

    build.load("fused_train")
    dev = torch.device("cuda")
    cfg = cli_config(["train", *POD_ARGS])
    ds = make_dataset(cfg, dev)
    n, frac, ema = cfg.train.num_rays, cfg.train.error_resample_frac, cfg.train.error_resample_ema
    fixed = dataset_mod.fixed_order_cumsum
    scans = {"torch.cumsum": lambda x: torch.cumsum(x, dim=0), "fixed_order_cumsum": fixed}

    def run(scan):
        cdfs = []

        def recording(x):
            out = scan(x)
            cdfs.append(tensor_digest(out))
            return out

        dataset_mod.fixed_order_cumsum = recording
        try:
            state = step_mod.init_state(cfg, dev)
            store = ds.init_error_store()
            fn = step_mod.make_train_step(
                cfg, ds, lambda g: ds.sample_batch_error_weighted(g, n, store, frac))
            trace = []
            for it in range(POD_STEPS):
                rec = {"store_in": tensor_digest(store)}
                state, aux = fn(state, step_mod.step_generator(cfg.train.seed, it, dev))
                rec.update(cdf=cdfs[-1], idx=tensor_digest(aux["batch_idx"]),
                           ray_err=tensor_digest(aux["ray_err"]), weights=state_digest(state))
                dataset_mod.update_error_store(store, aux["batch_idx"], aux["ray_err"], ema)
                rec.update(store_out=tensor_digest(store), loss=float(aux["loss"]))
                trace.append(rec)
            return trace, store, aux
        finally:
            dataset_mod.fixed_order_cumsum = fixed

    out = {}
    for name, scan in scans.items():
        (a, store, aux), (b, _, _) = run(scan), run(scan)
        parted = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
        row = {"loss": [a[-1]["loss"], b[-1]["loss"]],
               "store": [a[-1]["store_out"][:16], b[-1]["store_out"][:16]],
               "first_step": parted,
               "first_call": (None if parted is None else
                              next(k for k in TRACE_CALLS if a[parted][k] != b[parted][k]))}
        x = store + 1e-8
        row["scan_distinct"] = len({tensor_digest(scan(x)) for _ in range(DRAW_CALLS)})
        dataset_mod.fixed_order_cumsum = scan
        try:
            row["draws_distinct"] = repeated_draws(ds, store, n, frac)
        finally:
            dataset_mod.fixed_order_cumsum = fixed
        row["update_distinct"] = len({tensor_digest(dataset_mod.update_error_store(
            store.clone(), aux["batch_idx"], aux["ray_err"], ema)) for _ in range(DRAW_CALLS)})
        out[name] = row
        where = ("repeat bit for bit" if parted is None else
                 f"part at step {parted}, first at {row['first_call']}")
        print(f"fault 11, {name}: two runs of {POD_STEPS} pod steps from one start {where}; "
              f"final loss {row['loss'][0]:.6f} / {row['loss'][1]:.6f}; {DRAW_CALLS} calls on "
              f"the final {store.shape[0]}-pixel store: {row['scan_distinct']} running sums, "
              f"{row['draws_distinct']} pixel sets, {row['update_distinct']} updated stores "
              f"[{card}]")
    print(json.dumps({"trace_draws": out, "pixels": int(ds.init_error_store().shape[0]),
                      "steps": POD_STEPS}))
    if out["fixed_order_cumsum"]["first_step"] is not None or any(
            out["fixed_order_cumsum"][k] != 1
            for k in ("scan_distinct", "draws_distinct", "update_distinct")):
        fail("fault 11: the fixed-order draws do not repeat")
    return 0


def dp_rank(tmp: str) -> int:
    """Phase 31 in one of DP_RANKS ranks sharing the card over gloo, its
    counts read in its own process (each counter at 0 before its path):
    one DP step of the flagship over a given 4096-ray batch with midpoint
    samples (its reduced gradient saved), DP_STEPS in-step steps of `--preset
    full`, POD_STEPS error-weighted steps of `--preset pod` through K2 (the
    error store updated from the gathered draws), and the 800x800 frame
    through the sharded renderer (rank 0 saves it). Writes
    dp_rank{r}.json."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from nerf_rs_tpu_torch.data.dataset import update_error_store
    from nerf_rs_tpu_torch.data.factory import make_dataset
    from nerf_rs_tpu_torch.kernels import build
    from nerf_rs_tpu_torch.parallel import dist_init, dp, mesh as pmesh
    from nerf_rs_tpu_torch.render import render_frame
    from nerf_rs_tpu_torch.train import step as step_mod

    for name in KERNELS:
        build.load(name)
    rank, dev = dist_init.rank(), dist_init.device()
    mesh = pmesh.make_mesh()
    out = {"rank": rank, "device": str(dev), "counts": {}, "s": {}}

    def timed(key, fn):
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        out["s"][key] = time.perf_counter() - t0
        out["counts"][key] = kernel_counts()
        return result

    cfg = midpoint_cfg("full")
    ds = make_dataset(cfg, dev)
    batch = ds.sample_batch(torch.Generator(device=dev).manual_seed(7), 4096)
    state = step_mod.init_state(cfg, dev)
    fn = dp.make_dp_train_step(cfg, mesh)
    state, _ = timed("given_batch", lambda: fn(state, batch, step_mod.step_generator(0, 0, dev)))
    torch.save({n: p.grad.cpu() for n, p in step_mod.named_trainable(state)},
               os.path.join(tmp, f"dp_grads{rank}.pt"))

    def drive(cfg, steps, store=None):
        state = step_mod.init_state(cfg, dev)
        fn = dp.make_dp_train_step(cfg, mesh, ds, err_store=store)
        for it in range(steps):
            state, aux = fn(state, step_mod.step_generator(cfg.train.seed, it, dev))
            if store is not None:
                update_error_store(store, aux["batch_idx"], aux["ray_err"],
                                   cfg.train.error_resample_ema)
        return state, aux

    cfg = preset_cfg("full")
    state, aux = timed("step", lambda: drive(cfg, DP_STEPS))
    out["step_digest"], out["step_loss"] = state_digest(state), float(aux["loss"])
    cfg = cli_config(["train", *POD_ARGS])
    store = ds.init_error_store()
    state, aux = timed("pod", lambda: drive(cfg, POD_STEPS, store))
    out["pod_digest"], out["pod_loss"] = state_digest(state), float(aux["loss"])
    out["store_digest"] = state_digest(state, store)
    out["store_mean"] = float(store.mean())
    # fault 11: the same pod steps again from the same start
    again = ds.init_error_store()
    state2, aux2 = drive(cfg, POD_STEPS, again)
    out["pod_again_loss"], out["store_again_digest"] = (float(aux2["loss"]),
                                                        state_digest(state2, again))
    out["draws_distinct"] = repeated_draws(ds, store, cfg.train.num_rays // DP_RANKS,
                                           cfg.train.error_resample_frac)

    fcfg, fo, fd = frame_rays(dev)
    model = flagship_frame_model(dev)
    render_fn = dp.make_dp_render(fcfg, mesh)
    rgb, depth, acc = timed("render", lambda: render_frame(fcfg, model, fo, fd, render_fn))
    if rank == 0:
        torch.save({"rgb": rgb.cpu(), "depth": depth.cpu(), "acc": acc.cpu()},
                   os.path.join(tmp, "dp_frame.pt"))
    with open(os.path.join(tmp, f"dp_rank{rank}.json"), "w") as f:
        json.dump(out, f)
    return 0


def drive_dp(tmp: str, card: str) -> dict:
    """Phase 31, slice 8 on the one card: `cli train --num_devices 2` refused
    (a rank drives a card of its own), started at once in a process of its
    own; DP_RANKS ranks of dp_rank sharing the card over gloo, whose
    reduced gradient must match one K2 call over all 4096 rays (K2's
    KERNEL_TOL), whose states (and the pod run's error stores) must be
    bit-identical across ranks, whose frame must equal this process's
    800x800 frame, and whose K1 / K2 launches must be the paths' own; then
    `train --scenes sphere,flat_sphere` (MS_STEPS steps, autograd: no K2),
    `eval` and `render --scene_index 1`, with K1 launches by the chunk
    plan and the eval's PSNR of scene 1 equal to the training's."""
    import torch

    from nerf_rs_tpu_torch.data.factory import make_dataset
    from nerf_rs_tpu_torch.kernels.fused_train import KERNEL_TOL
    from nerf_rs_tpu_torch.parallel import launch
    from nerf_rs_tpu_torch.render import render_frame
    from nerf_rs_tpu_torch.train import step as step_mod

    dev = torch.device("cuda")
    refusal = subprocess.Popen(
        [sys.executable, "-m", "nerf_rs_tpu_torch.cli", "train", "--dataset", "sphere",
         "--num_devices", "2", "--num_iter", "1", "--save_dir", os.path.join(tmp, "refused")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    dp_dir = os.path.join(tmp, "dp")
    os.makedirs(dp_dir)
    t0 = time.perf_counter()
    rc = launch.run(dp_rank, (dp_dir,), DP_RANKS, "cuda", backend="gloo", same_device=True)
    ranks_s = time.perf_counter() - t0
    if rc != 0:
        fail(f"phase 31: a rank exited with {rc}")
    ranks = []
    for r in range(DP_RANKS):
        with open(os.path.join(dp_dir, f"dp_rank{r}.json")) as f:
            ranks.append(json.load(f))
    print(f"phase 31: {DP_RANKS} ranks on {ranks[0]['device']} over gloo in {ranks_s:.1f} s "
          f"(spawn and set-up included); per rank: given-batch step, {DP_STEPS} flagship "
          f"steps in {ranks[0]['s']['step']:.3f} s, {POD_STEPS} pod steps in "
          f"{ranks[0]['s']['pod']:.3f} s, the frame in {ranks[0]['s']['render']:.3f} s "
          f"[{card}] (correctness, not speed: the ranks share the card, the reduce goes "
          f"through the host)")
    for key in ("step_digest", "pod_digest", "store_digest"):
        if len({r[key] for r in ranks}) != 1:
            fail(f"phase 31: the ranks' {key} differ: {[r[key] for r in ranks]}")
    print(f"phase 31: after {DP_STEPS} steps, and after {POD_STEPS} pod steps with the error "
          f"store, both ranks hold bit-identical states (loss {ranks[0]['step_loss']:.6f}, pod "
          f"{ranks[0]['pod_loss']:.6f}, store mean {ranks[0]['store_mean']:.6f})")
    for r in ranks:
        if (r["pod_again_loss"] != r["pod_loss"]
                or r["store_again_digest"] != r["store_digest"]):
            fail(f"phase 31 (fault 11): rank {r['rank']}'s second pod drive from the same "
                 f"start ends at loss {r['pod_again_loss']} against {r['pod_loss']}, store "
                 f"{r['store_again_digest'][:12]} against {r['store_digest'][:12]}")
        if r["draws_distinct"] != 1:
            fail(f"phase 31 (fault 11): rank {r['rank']}: {DRAW_CALLS} calls of "
                 f"error_weighted_from_draws on one store and one u gave "
                 f"{r['draws_distinct']} different sets of pixels")
    print(f"phase 31 (fault 11): each rank's pod drive, run twice from one start, ends at the "
          f"same loss ({ranks[0]['pod_again_loss']:.6f}) and the same error store; "
          f"{DRAW_CALLS} calls of error_weighted_from_draws on the pod run's "
          f"store with one u give one set of pixels")
    expect = {"given_batch": ("K2", 1), "step": ("K2", DP_STEPS), "pod": ("K2", POD_STEPS),
              "render": ("K1", math.ceil(FRAME * FRAME / DP_RANKS / CHUNK))}
    for r in ranks:
        for key, (kernel, n) in expect.items():
            counts = r["counts"][key]
            if counts[kernel] != n or any(v for k, v in counts.items() if k != kernel):
                fail(f"phase 31: rank {r['rank']}'s {key} launched {counts}, expected {kernel} "
                     f"{n} and nothing else")

    # the reduced gradient against one K2 call over all the rays
    cfg = midpoint_cfg("full")
    ds = make_dataset(cfg, dev)
    batch = ds.sample_batch(torch.Generator(device=dev).manual_seed(7), 4096)
    state, _ = step_mod.train_step(step_mod.init_state(cfg, dev), batch, None, cfg)
    grads = [torch.load(os.path.join(dp_dir, f"dp_grads{r}.pt")) for r in range(DP_RANKS)]
    if any(not torch.equal(grads[0][n], g[n]) for g in grads[1:] for n in grads[0]):
        fail("phase 31: the ranks' reduced gradients differ")
    grad_err = max(leaf_err(grads[0][n].to(dev), p.grad)
                   for n, p in step_mod.named_trainable(state))
    hold("phase 31: the 2-rank reduced gradient vs one K2 call over 4096 rays",
         {"grads": grad_err}, KERNEL_TOL)

    # the sharded frame against this process's
    fcfg, fo, fd = frame_rays(dev)
    want = render_frame(fcfg, flagship_frame_model(dev), fo, fd)
    got = torch.load(os.path.join(dp_dir, "dp_frame.pt"))
    frame_err = max(float((got[k].to(dev) - w).abs().max())
                    for k, w in zip(("rgb", "depth", "acc"), want))
    if not frame_err <= TOL["rgb"]:
        fail(f"phase 31: the 2-rank frame differs from the one-process frame by {frame_err}")
    print(f"phase 31: the 800x800 frame in two blocks vs one process: max |diff| {frame_err:.3g}"
          f" ({'bit-identical' if frame_err == 0 else 'tol ' + str(TOL['rgb'])})")

    # multi-scene training on the one card, then eval and render of scene 1
    msdir = os.path.join(tmp, "scenes")
    common = [*MS_ARGS, "--save_dir", msdir, "--log_dir", msdir]
    reset_counts()
    rc, out = run_cli(["train", *common, "--num_iter", str(MS_STEPS), "--eval_steps",
                       str(MS_EVAL_EVERY), "--save_steps", "100000"])
    ms_train = kernel_counts()
    psnrs = re.findall(r"iter=\d+, per-scene eval psnr=\[([^\]]*)\]", out)
    n_evals = len(range(MS_EVAL_EVERY, MS_STEPS, MS_EVAL_EVERY)) + 1
    if rc != 0 or len(psnrs) != n_evals or f"done at step {MS_STEPS} (2 scenes)" not in out:
        fail(f"phase 31: train --scenes: rc {rc}, {len(psnrs)} evals")
    final = [float(x) for x in psnrs[-1].split(",")]
    if ms_train["K2"] != 0 or ms_train["K1"] != 2 * n_evals:
        fail(f"phase 31: train --scenes launched {ms_train}; expected K1 {2 * n_evals}, no K2")
    reset_counts()
    rc, out = run_cli(["eval", *common, "--scene_index", "1", "--max_views", "2"])
    ms_eval = kernel_counts()["K1"]
    m = re.search(r"view   0: psnr (\S+)", out)
    if rc != 0 or ms_eval != 2 or m is None or abs(float(m.group(1)) - final[1]) > 0.01:
        fail(f"phase 31: eval --scene_index 1: rc {rc}, K1 {ms_eval}, view 0 "
             f"{m.group(1) if m else None} against the training's {final[1]}")
    reset_counts()
    rc, out = run_cli(["render", *common, "--scene_index", "1", "--view", "0", "--out_dir",
                       os.path.join(msdir, "r")])
    ms_render = kernel_counts()["K1"]
    if rc != 0 or ms_render != 1 or read_png(os.path.join(msdir, "r", "view-0.png")).shape != (
            64, 64, 3):
        fail(f"phase 31: render --scene_index 1: rc {rc}, K1 {ms_render}")
    print(f"phase 31: train --scenes {MS_SCENES}: {MS_STEPS} steps, eval psnr per scene "
          f"{final}; eval and render of scene 1 (K1 {ms_eval} and {ms_render})")

    _, err = refusal.communicate(timeout=300)
    if refusal.returncode == 0 or "have 1 visible card" not in err:
        fail(f"phase 31: train --num_devices 2 on one card: rc {refusal.returncode}, "
             f"{err[-500:]}")
    print(f"phase 31: train --num_devices 2 on one card exits {refusal.returncode}: "
          f"{err.strip().splitlines()[-1]}")
    return {"k1": {"dp_render": sum(r["counts"]["render"]["K1"] for r in ranks),
                   "multiscene_train_eval": ms_train["K1"], "multiscene_eval": ms_eval,
                   "multiscene_render": ms_render},
            "k2": {"dp_step_given_batch": sum(r["counts"]["given_batch"]["K2"] for r in ranks),
                   "dp_step": sum(r["counts"]["step"]["K2"] for r in ranks),
                   "dp_pod": sum(r["counts"]["pod"]["K2"] for r in ranks),
                   "multiscene_train": ms_train["K2"]},
            "grad_err": grad_err, "frame_err": frame_err, "ranks_s": ranks_s,
            "pod_loss": [ranks[0]["pod_loss"], ranks[0]["pod_again_loss"]],
            "draws_distinct": [r["draws_distinct"] for r in ranks],
            "rank_s": ranks[0]["s"], "multiscene_psnr": final}


def reference_predict(params, points, ts, t_far):
    """The reference's compat math in numpy, tests/test_compat.py's oracle:
    eight linears with a ReLU between them and none after the last, channel
    0 the raw density; deltas to the far plane; the O(S^2) transmittance;
    the density composited as the colour (sigma, sigma, sigma, 1).
    ``params`` is the JAX layout's tree of numpy arrays."""
    import numpy as np

    n_rays, n_pts = ts.shape
    h = points.reshape(-1, 3)
    for layer in params["trunk"][:-1]:
        h = np.maximum(h @ layer["w"] + layer["b"], 0.0)
    out = (h @ params["trunk"][-1]["w"] + params["trunk"][-1]["b"]).reshape(n_rays, n_pts, -1)
    sigma = out[..., 0]
    deltas = np.concatenate([ts[:, 1:], np.full((n_rays, 1), t_far)], 1) - ts
    trans = np.ones((n_rays, n_pts))
    for i in range(1, n_pts):
        trans[:, i] = np.exp(-(sigma[:, :i] * deltas[:, :i]).sum(-1))
    w = trans * (1.0 - np.exp(-sigma * deltas))
    colors = np.stack([sigma, sigma, sigma, np.ones_like(sigma)], axis=-1)
    return (w[..., None] * colors).sum(1), sigma


def drive_compat(tmp: str, card: str) -> dict:
    """Phase 32, slice 10: `train --compat true` (COMPAT_ARGS) for
    COMPAT_STEPS steps and a resume of COMPAT_RESUME, `eval`, `render` and
    `render --use_fused_kernel true` of its checkpoint, every path with every
    kernel counter at 0; its losses finite and its radiance head's weights
    those it started from; `export` refused naming compat, with no file
    written (the JAX CLI's export fails on a compat field); one compat step on
    the card against the same step on the CPU (COMPAT_TOL, the head's
    gradient exactly 0 on both); compat_predict against the reference's math
    in numpy (ORACLE_TOL); then the compat step's time, best of 3 windows."""
    import dataclasses

    import numpy as np
    import torch

    from nerf_rs_tpu_torch.convert import params_to_numpy
    from nerf_rs_tpu_torch.data.factory import make_dataset
    from nerf_rs_tpu_torch.models.mlp import count_params, init_nerf_params
    from nerf_rs_tpu_torch.ops import render as render_ops
    from nerf_rs_tpu_torch.train import checkpoint as ckpt
    from nerf_rs_tpu_torch.train import step as step_mod

    dev = torch.device("cuda")
    cdir = os.path.join(tmp, "compat")
    common = [*COMPAT_ARGS, "--save_dir", cdir, "--log_dir", cdir]
    counts, losses = {}, []

    def path(key, argv):
        reset_counts()
        rc, out = run_cli(argv)
        counts[key] = kernel_counts()
        losses.extend(float(v) for v in re.findall(r"iter=\d+, loss=(\S+)", out))
        if rc != 0:
            fail(f"phase 32: {' '.join(argv[:3])}: rc {rc}")
        return out

    path("train", ["train", *common, "--num_iter", str(COMPAT_STEPS), "--eval_steps", "100",
                   "--save_steps", "100000"])
    out = path("resume", ["train", *common, "--num_iter", str(COMPAT_STEPS + COMPAT_RESUME),
                          "--eval_steps", "100000", "--save_steps", "100000"])
    if "resumed from" not in out or f"done at step {COMPAT_STEPS + COMPAT_RESUME}" not in out:
        fail("phase 32: the compat resume did not pick up the checkpoint")
    out = path("eval", ["eval", *common, "--max_views", "2"])
    m = re.search(r"mean psnr over 2 \S+ views: (\S+)", out)
    psnr = float(m.group(1)) if m else math.nan
    for key, extra in (("render", []), ("render_fused_asked", ["--use_fused_kernel", "true"])):
        rdir = os.path.join(cdir, key)
        path(key, ["render", *common, "--view", "0", "--out_dir", rdir, *extra])
        if read_png(os.path.join(rdir, "view-0.png")).shape != (128, 128, 3):
            fail(f"phase 32: {key} wrote no 128x128 view")
    if not losses or not all(math.isfinite(v) for v in losses) or not math.isfinite(psnr):
        fail(f"phase 32: compat losses {losses}, eval psnr {psnr}")
    reset_counts()
    ex = os.path.join(cdir, "export")
    try:
        run_cli(["export", *common, "--grid_res", "32", "--out", os.path.join(ex, "field")])
        fail("phase 32: export of a compat field did not refuse it")
    except ValueError as e:
        if "compat" not in str(e):
            fail(f"phase 32: export refused compat without naming it: {e}")
        refusal = str(e)
    counts["export"] = kernel_counts()
    if os.path.exists(ex):
        fail("phase 32: the refused compat export wrote files")
    launched = {k: {n: v for n, v in c.items() if v} for k, c in counts.items()}
    if any(launched.values()):
        fail(f"phase 32: compat paths launched kernels: {launched}")
    cfg = cli_config(["train", *COMPAT_ARGS])
    start = step_mod.init_state(cfg, dev)
    field = init_nerf_params(cfg.model, cfg.train.seed, dev)
    ckpt.restore_weights(ckpt.latest_checkpoint(cdir), field)
    for name in ("head1", "head2"):
        if any(not torch.equal(a, b) for a, b in zip(getattr(field, name).parameters(),
                                                     getattr(start.params, name).parameters())):
            fail(f"phase 32: {name} moved in training (its gradient is 0)")
    print(f"phase 32: train --compat true ({count_params(field)} weights, 84 x 64, f32) for "
          f"{COMPAT_STEPS} steps, last loss {losses[-1]:.6f}, and a resume to "
          f"{COMPAT_STEPS + COMPAT_RESUME}; eval psnr {psnr:.2f} over 2 views; render and "
          f"render --use_fused_kernel true; every kernel counter 0 on every path; head1 and "
          f"head2 as they started; export refused: {refusal}")

    # one step on the card against the same step on the CPU
    mid = dataclasses.replace(cfg, render=dataclasses.replace(cfg.render, randomized=False))
    ds = make_dataset(mid, dev)
    batch = ds.sample_batch(torch.Generator(device=dev).manual_seed(32), cfg.train.num_rays)

    def one_step(device):
        state = step_mod.init_state(mid, device)
        b = step_mod.Batch(*(None if x is None else x.to(device) for x in batch))
        grads, aux = step_mod.compute_grads(state, b, None, mid)
        return {k: v.detach().cpu() for k, v in grads.items()}, float(aux["loss"])

    reset_counts()
    g_card, loss_card = one_step(dev)
    counts["step"] = kernel_counts()
    g_cpu, loss_cpu = one_step(torch.device("cpu"))
    if any(counts["step"].values()):
        fail(f"phase 32: the compat step launched {counts['step']}")
    heads = [k for k in g_cpu if k.startswith("head")]
    if any(g_card[k].any() or g_cpu[k].any() for k in heads):
        fail("phase 32: the radiance head's gradient is not 0")
    errs = {"loss": abs(loss_card - loss_cpu) / abs(loss_cpu),
            "grads": max(leaf_err(g_card[k], g_cpu[k]) for k in g_cpu if k not in heads)}
    hold("phase 32: the compat step on the card vs on the CPU", errs, COMPAT_TOL)

    # compat_predict against the reference's math
    rng = np.random.default_rng(32)
    pts = (rng.normal(size=(16, 32, 3)) * 0.6).astype(np.float32)
    ts = np.sort(rng.uniform(size=(16, 32)) * 2.0, axis=-1).astype(np.float32)
    with torch.no_grad():
        got_rgb, got_sigma = render_ops.compat_predict(
            field, torch.from_numpy(pts).to(dev), torch.from_numpy(ts).to(dev), cfg.model, 2.0)
    want_rgb, want_sigma = reference_predict(params_to_numpy(field), pts, ts, 2.0)
    oracle_err = max(float(np.abs(got_sigma.cpu().numpy() - want_sigma).max()),
                     float(np.abs(got_rgb.cpu().numpy()[:, :3] - want_rgb[:, :3]).max()))
    if not oracle_err <= ORACLE_TOL:
        fail(f"phase 32: compat_predict vs the reference's math: {oracle_err} (tol {ORACLE_TOL})")

    # the compat step's time
    state = step_mod.init_state(cfg, dev)
    fn = step_mod.make_train_step(cfg, ds)
    it = iter(range(10 ** 6))

    def window():
        nonlocal state
        for _ in range(COMPAT_WINDOW):
            state, _ = fn(state, step_mod.step_generator(cfg.train.seed, next(it), dev))

    window()  # warm-up
    step_ms = best_of(window) / COMPAT_WINDOW * 1e3
    print(f"phase 32: compat_predict vs the reference's math in numpy: max |diff| "
          f"{oracle_err:.3g} (tol {ORACLE_TOL:g}); the compat step (84 rays x 64, autograd, "
          f"f32) {step_ms:.3f} ms, best of 3 windows of {COMPAT_WINDOW} [{card}]")
    return {"launches": counts, "step_ms": step_ms, "step_err": errs, "oracle_err": oracle_err,
            "eval_psnr": psnr, "last_loss": losses[-1]}


def dp_cards_rank(tmp: str) -> int:
    """One rank of --dp-cards: the flagship DP step (in-step draws, 4096
    rays over the ranks) timed in windows of DP_WINDOW steps after 10 to
    warm up, best of 3, and the 800x800 frame through the sharded renderer,
    best of 3; rank 0 writes dp_cards{world}.json."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    from nerf_rs_tpu_torch.data.factory import make_dataset
    from nerf_rs_tpu_torch.parallel import dist_init, dp, mesh as pmesh
    from nerf_rs_tpu_torch.render import render_frame
    from nerf_rs_tpu_torch.train import step as step_mod

    dev = dist_init.device() or torch.device("cuda")
    mesh = pmesh.make_mesh()
    cfg = preset_cfg("full")
    ds = make_dataset(cfg, dev)
    state = step_mod.init_state(cfg, dev)
    fn = dp.make_dp_train_step(cfg, mesh, ds)
    it = 0

    def steps(n):
        nonlocal state, it
        for _ in range(n):
            state, _ = fn(state, step_mod.step_generator(0, it, dev))
            it += 1

    steps(10)
    step_s = best_of(lambda: steps(DP_WINDOW)) / DP_WINDOW
    fcfg, fo, fd = frame_rays(dev)
    model = flagship_frame_model(dev)
    render_fn = dp.make_dp_render(fcfg, mesh)
    render_frame(fcfg, model, fo, fd, render_fn)
    frame_s = best_of(lambda: render_frame(fcfg, model, fo, fd, render_fn))
    world = dist_init.world_size()
    if dist_init.is_primary():
        with open(os.path.join(tmp, f"dp_cards{world}.json"), "w") as f:
            json.dump({"cards": world, "step_ms": 1000 * step_s,
                       "rays_per_sec_per_card": 4096 / step_s / world, "frame_s": frame_s}, f)
    return 0


def dp_cards(n: int) -> int:
    """--dp-cards N (see the module doc)."""
    import torch

    from nerf_rs_tpu_torch.kernels import build
    from nerf_rs_tpu_torch.parallel import launch

    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke test runs on the card only")
    card = card_line()
    print(card)
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        list(pool.map(build.build, KERNELS))
    tmp = tempfile.mkdtemp(prefix="dp_cards_")
    try:
        rows = []
        for world in (1, n):
            rc = launch.run(dp_cards_rank, (tmp,), world, "cuda")
            if rc:
                fail(f"--dp-cards: {world} rank(s) exited with {rc}")
            with open(os.path.join(tmp, f"dp_cards{world}.json")) as f:
                rows.append(json.load(f))
            print(f"{world} card(s) [{card}]: flagship DP step {rows[-1]['step_ms']:.3f} ms, "
                  f"{rows[-1]['rays_per_sec_per_card']:.0f} rays/s a card, 800x800 frame "
                  f"{rows[-1]['frame_s']:.4f} s")
        cli_s = {}
        for name, argv in (("train", ["train", "--preset", "full", "--dataset", "sphere",
                                      "--num_iter", "200", "--eval_steps", "100",
                                      "--save_dir", os.path.join(tmp, "ck"),
                                      "--log_dir", os.path.join(tmp, "logs")]),
                           ("render", ["render", "--dataset", "sphere", "--width", str(FRAME),
                                       "--height", str(FRAME), "--view", "0",
                                       "--save_dir", os.path.join(tmp, "ck"),
                                       "--out_dir", os.path.join(tmp, "r")])):
            t0 = time.perf_counter()
            proc = subprocess.run([sys.executable, "-m", "nerf_rs_tpu_torch.cli", *argv,
                                   "--num_devices", str(n)], capture_output=True, text=True)
            cli_s[name] = time.perf_counter() - t0
            print(proc.stdout.rstrip())
            if proc.returncode != 0:
                fail(f"cli {name} --num_devices {n}: {proc.stderr[-2000:]}")
            print(f"cli {name} --num_devices {n}: {cli_s[name]:.1f} s wall (start-up included)")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps({"dp_cards": rows, "cli_s": cli_s, "card": card}))
    return 0


def pin_first_card() -> None:
    """Every phase (and every entry but --dp-cards) runs on the first
    visible card, and so do the processes it starts: the CLI's
    --num_devices 0 means every visible card, and the phases' launch counts
    are one card's."""
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    if visible is None or visible:  # an empty list stays empty: no card
        os.environ["CUDA_VISIBLE_DEVICES"] = (visible or "0").split(",")[0]


def main() -> int:
    import torch

    t_start = _LAP[0] = time.perf_counter()
    # ---- 1. device ----
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke test runs on the card only")
    card = card_line()
    print(card)
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False  # plain version: full f32
    torch.backends.cudnn.allow_tf32 = False

    from nerf_rs_tpu_torch import ModelConfig
    from nerf_rs_tpu_torch import cli
    from nerf_rs_tpu_torch.data.factory import make_dataset
    from nerf_rs_tpu_torch.kernels import build
    from nerf_rs_tpu_torch.kernels.fused_ray import (
        fused_ray_render, fused_ray_render_reference)
    from nerf_rs_tpu_torch.kernels.fused_render import pack_weights
    from nerf_rs_tpu_torch.models.mlp import init_nerf_params
    from nerf_rs_tpu_torch.ops import sampling
    from nerf_rs_tpu_torch.render import make_render, render_frame
    from nerf_rs_tpu_torch.train import checkpoint as ckpt

    # ---- 2. build: one nvcc per kernel source, all started together ----
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        libs = dict(zip(KERNELS, pool.map(build.build, KERNELS)))
    print(f"build: {time.perf_counter() - t0:.1f} s for {', '.join(KERNELS)}")
    instances = {}
    for name, lib in libs.items():
        print(f"  {name} -> {lib.name}")
        instances[name] = ptxas_report(name, lib)
    _, stores, loads, serialized = instances["fused_train"]["dw_wgmma_kernel"]  # K2b
    if stores or loads or serialized:
        fail(f"ptxas: dw_wgmma_kernel spills {stores}/{loads} B"
             + (", its wgmma serialized" if serialized else ""))
    pool, warm = start_learning_pool()

    lap("phase 2")
    # ---- 3. kernel vs plain version ----
    mcfg = ModelConfig()  # flagship: 8x256, skip 4, F 256, V 128, PE 10/4
    model = random_biases_(init_nerf_params(mcfg, 0, dev), 0)
    packed = pack_weights(model, mcfg)
    (o, d, vd), gold, cam = check_rays(dev)
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

    lap("phase 3")
    # ---- 4. K2 vs its plain version and vs autograd ----
    train_err = check_train_kernel(model, mcfg, (o, d, vd), ts_jit, gold, cam.far)
    dw_err = check_dw_stashes(f"flagship, {N_RAYS} x {S}", model, mcfg, (o, d, vd), ts_jit,
                              sampling.deltas_from_ts(ts_jit, cam.far), gold)

    lap("phase 4")
    # ---- 9. the hierarchical branches: IPE, rays longer than one tile ----
    max_err = max(max_err, check_render_branches(model, mcfg, (o, d, vd), cam))
    train_err = max(train_err, check_train_branches(model, mcfg, (o, d, vd), gold, cam))
    train_err = max(train_err, check_union_rows(model, mcfg, (o, d, vd), gold, cam))
    ts192, dl192, _, _ = sample_inputs(N_RAYS, 192, False, cam, torch_generator(dev, 14))
    dw_err = max(dw_err, check_dw_stashes(f"S = 192, {N_RAYS} rays", model, mcfg, (o, d, vd),
                                          ts192, dl192, gold))

    lap("phase 9")
    # ---- 12. K3 vs its plain versions ----
    fcfg = factored_config()
    fac_ds = make_dataset(fcfg, dev)
    fac_lines = init_nerf_params(fcfg.model, 0, dev).lines.detach()
    fac_errs = check_factored_kernel(fac_ds, fcfg.model, fcfg.camera, fac_lines)

    lap("phase 12")
    # ---- 15. K4 vs its plain versions, at an ngp step's indices ----
    k4_inputs = ngp_fetch_inputs(dev)
    k4_err = check_gather_kernel(k4_inputs)
    sc_inputs = scatter_inputs(dev)
    scatter_err = check_scatter(sc_inputs, dev)

    lap("phase 15")
    # ---- 18. the unbounded-scene branches: contraction, distortion loss ----
    unb_k1_err, unb_k2_err = check_unbounded_branches(model, mcfg, (o, d, vd), gold, cam)
    max_err, train_err = max(max_err, unb_k1_err), max(train_err, unb_k2_err)

    lap("phase 18")
    # ---- 33. rays past 256 samples, deep fields, a blocked K2 call ----
    long_k1_err, long_k2_err, blocked_launches = check_long_rays(model, mcfg, (o, d, vd), gold,
                                                                 cam)
    max_err, train_err = max(max_err, long_k1_err), max(train_err, long_k2_err)

    lap("phase 33")
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

        lap("phase 5")
        # ---- 6. the training path through the CLI ----
        train_launches = drive_training(tmp)

        lap("phase 6")
        # ---- 7. learning: the verify drive, then eval and render ----
        verify_drive(tmp)

        lap("phase 7")
        # ---- 10. the hierarchical path through the CLI, per preset ----
        preset_counts = {p: drive_preset(tmp, p) for p in PRESETS}

        lap("phase 10")
        # ---- 13. the factored path: K3 through the library, the CLI's route ----
        fac_counts = drive_factored(tmp, fo, fd, card)
        drive_factored_cli(tmp)

        lap("phase 13")
        # ---- 16. the hash-grid path through the CLI, brick and flat ----
        ngp_counts = {layout: drive_ngp(tmp, layout, fo, fd) for layout in NGP_LAYOUTS}

        lap("phase 16")
        # ---- 19. the unbounded path through the CLI, per preset ----
        unb_counts = {p: drive_unbounded(tmp, p) for p in UNB_PRESETS}

        lap("phase 19")
        # ---- 21. the record path through the CLI: occupancy, IPE union ----
        rec_counts = drive_record(tmp)

        lap("phase 21")
        # ---- 22. multiscale through the CLI: a pyramid, eval at four scales ----
        ms_counts = drive_multiscale(tmp)

        lap("phase 22")
        # ---- 24. procedural scenes written by the port on the card ----
        scenes = write_scenes(tmp, card)
        lego = scenes["lego"][0]

        lap("phase 24")
        # ---- 25. Blender scenes through the CLI: full and record ----
        blender_counts = {p: drive_dataset(
            tmp, f"blender-{p}", ["--preset", p, *LEGO_DATA, "--img_dir", lego],
            BLENDER_STEPS, 2 if p == "record" else 1, 100 * 100, 4,
            eval_flags=("--split", "test")) for p in BLENDER_PRESETS}

        lap("phase 25")
        # ---- 26. the host pipeline and --preset pod with its error store ----
        host_counts = drive_host_and_pod(tmp, lego)

        lap("phase 26")
        # ---- 27. LLFF with NDC, the multiview PNG layout in multiview batches ----
        other_counts = drive_llff_and_multiview(tmp)

        lap("phase 27")
        # ---- 30. slice 7: the EMA, its eval, sweep and export, accumulation ----
        slice7 = drive_slice7(tmp, card)

        lap("phase 30")
        # ---- 31. slice 8: two ranks on the card, the sharded frame, scenes ----
        dp_run = drive_dp(tmp, card)

        lap("phase 31")
        # ---- 32. slice 10: compat mode, no kernel on its paths ----
        compat = drive_compat(tmp, card)

        lap("phase 32")
        # ---- 34. the long-ray paths through the CLI ----
        long_counts = drive_long_cli(tmp, path)

        lap("phase 34")
        # ---- 28. the learning drives of every path, LEARN_WORKERS at a time ----
        for task in warm:
            task.result()
        fault6_task = pool.submit(fault6_routes, *FAULT6[:3], FAULT6[3])
        unb_bars = {"unbounded": UNB_PSNR, "proposal": PROP_PSNR}
        rec_finish = learning_drive(pool, tmp, "record", bar=REC_PSNR, defer=True,
                                    seeds=REC_SEEDS)
        finish = {p: learning_drive(pool, tmp, p) for p in PRESETS}
        finish["factored"] = factored_learning(pool, tmp)
        finish["ngp"] = ngp_learning(pool, tmp)
        finish.update({p: learning_drive(pool, tmp, p, extra=UNB_LEARN_FLAGS[p],
                                         k2_per_step=1, bar=unb_bars[p]) for p in UNB_PRESETS})
        finish["record"] = rec_finish
        finish["mipnerf_ms"] = learning_drive(
            pool, tmp, "mipnerf", extra=("--num_fine_samples", "64", *MS_FLAGS), bar=MS_PSNR,
            name="mipnerf-ms", defer=True)
        finish["record_lego"] = learning_drive(
            pool, tmp, "record", extra=("--num_fine_samples", "64", *LEGO_DATA,
                                        "--img_dir", scenes["lego64"][0]),
            bar=LEGO_PSNR, name="record-lego", defer=True, seeds=LEGO_SEEDS)
        learned = {k: fn() for k, fn in finish.items()}
        fault6 = fault6_check(fault6_task)
        pool.shutdown()
        lap("phase 28")
        # ---- 29. the steps on the scene and the sphere, per ray and host ----
        data_times = time_datasets(card, lego)
    finally:
        pool.shutdown(cancel_futures=True)
        shutil.rmtree(tmp, ignore_errors=True)

    lap("phase 29")
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
    p_rgb, t_plain = timed_call(plain_frame)
    frame_err = float((k_rgb - p_rgb).abs().max())
    if not frame_err <= TOL["rgb"]:
        fail(f"800x800 frame: kernel path vs plain version differ by {frame_err}")
    t_kernel = best_of(kernel_frame)
    print(f"800x800 frame, S=64, 8x256 mixed [{card}]: kernel {t_kernel:.4f} s (best of 3), "
          f"plain {t_plain:.4f} s (the checked call; kernel vs plain rgb {frame_err:.3g})")

    # one main-path chunk (262,144 rays) alone: kernel vs plain version
    chunk = time_chunk(card, packed, mcfg, cfg.camera, flat_o, flat_d)

    train_times = time_training(card)

    lap("phase 8")
    # ---- 11. times of the hierarchical path and the new branches ----
    branch_rows = time_branches(card, model, mcfg, cfg.camera, flat_o, flat_d)
    max_err = max(max_err, *(r["max_abs_err"] for r in branch_rows if r["kernel"] == "K1"))
    train_err = max(train_err, *(r["max_abs_err"] for r in branch_rows if r["kernel"] == "K2"))
    preset_times = time_presets(card)
    library = library_times(card, model, mcfg, *chunk["inputs"])

    lap("phase 11")
    # ---- 14. times of the factored path and K3 ----
    fac_times = time_factored(card, fac_ds, fac_lines)
    fac_fwd, fac_bwd, fac_chunk, fac_f32, fac_bwd_shuffled, fac_bwd_f32 = fac_times.pop("calls")

    lap("phase 14")
    # ---- 17. times of the hash-grid path and K4 ----
    ngp_times = time_ngp(card, fo, fd)
    k4_times = time_gather(card, k4_inputs)
    del k4_inputs
    scatter_times = time_scatter(card, sc_inputs)
    del sc_inputs

    lap("phase 17")
    # ---- 20. times of the unbounded path and the new branches ----
    unb_rows = time_branches(card, model, mcfg, cfg.camera, flat_o, flat_d, UNB_SHAPES)
    max_err = max(max_err, *(r["max_abs_err"] for r in unb_rows if r["kernel"] == "K1"))
    train_err = max(train_err, *(r["max_abs_err"] for r in unb_rows if r["kernel"] == "K2"))
    unb_times = time_presets(card, UNB_PRESETS, profiled=UNB_PRESETS)

    lap("phase 20")
    # ---- 23. times of the record path, IPE at 193 and K3 past its former caps ----
    rec_rows = time_branches(card, model, mcfg, cfg.camera, flat_o, flat_d, RECORD_SHAPES,
                             witness=True)
    max_err = max(max_err, *(r["max_abs_err"] for r in rec_rows if r["kernel"] == "K1"))
    train_err = max(train_err, *(r["max_abs_err"] for r in rec_rows if r["kernel"] == "K2"))
    rec_times = time_presets(card, ("record",), profiled=("record",))
    wide_rows, corner_rows = fac_times["wide"], fac_times["corners"]
    if fac_times["refused"]:
        fail(f"K3 refused {fac_times['refused']}, which it takes since fault 5's repair")

    lap("phase 23")
    # ---- 35. times of the long rays: a render chunk and a blocked train call ----
    torch.cuda.empty_cache()  # the earlier phases' cached blocks: the plain versions' room
    long_rows = time_branches(card, model, mcfg, cfg.camera, flat_o, flat_d, LONG_SHAPES)
    max_err = max(max_err, *(r["max_abs_err"] for r in long_rows if r["kernel"] == "K1"))
    train_err = max(train_err, *(r["max_abs_err"] for r in long_rows if r["kernel"] == "K2"))
    long_steps = {f"{p}_{flags[1]}": preset_steps(card, p, True, flags)
                  for p, flags in (("full", ("--num_samples", "300")),
                                   ("hierarchical", ("--num_fine_samples", "256")))}

    lap("phase 35")
    # ---- 36. fields of any width: checks, trains, frames, times ----
    width_k1_err, width_k2_err, width_checks = check_widths((o, d, vd), gold, cam)
    max_err, train_err = max(max_err, width_k1_err), max(train_err, width_k2_err)
    n_w = WIDTH_ROWS // S
    for name in ("40/40/24", "512/512/256", "1024/256/128"):  # clusters of 1, 4 and 8 CTAs
        wcfg = width_cfg(name)
        dw_err = max(dw_err, check_dw_stashes(
            f"widths {name}, {n_w} x {S}", random_biases_(init_nerf_params(wcfg, 0, dev), 36),
            wcfg, tuple(r[:n_w].contiguous() for r in (o, d, vd)), ts_jit[:n_w].contiguous(),
            sampling.deltas_from_ts(ts_jit[:n_w].contiguous(), cam.far), gold[:n_w].contiguous()))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_widths_")
    try:
        wide_runs = drive_wide(tmp, card, dev)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    lap("phase 36")
    # ---- 37. the lifted caps: depth, levels, flat tables of any F, wide encodings ----
    torch.cuda.empty_cache()
    lift_k1_err, lift_k2_err, lift_checks = check_lifted((o, d, vd), gold, cam)
    max_err, train_err = max(max_err, lift_k1_err), max(train_err, lift_k2_err)
    lift_k3 = check_lifted_factored(fac_ds, fcfg.camera)
    fac_errs["enc"] = max(fac_errs["enc"], lift_k3["enc"])
    fac_errs["d_lines"] = max(fac_errs["d_lines"], lift_k3["d_lines"])
    fac_errs["d_lines_abs"] = max(fac_errs["d_lines_abs"], lift_k3["d_lines_abs"])
    tmp = tempfile.mkdtemp(prefix="chip_smoke_lifted_")
    try:
        lift_ngp = drive_lifted_features(tmp, card, fo, fd)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    pe_cfg = ModelConfig(pos_enc_levels=LIFT_PE[0][0])
    lift_pe = width_calls(f"pos_enc_levels {pe_cfg.pos_enc_levels}",
                          seeded_model(pe_cfg, dev), pe_cfg,
                          dataclasses.replace(cfg, model=pe_cfg), flat_o, flat_d, card)
    lv_cfg = ModelConfig(arch="factored", fac_levels=LIFT_LEVELS)
    lift_k3_rows = time_k3_calls(card, fac_ds, lv_cfg,
                                 init_nerf_params(lv_cfg, 0, dev).lines.detach(),
                                 (("forward", CORNER_RAYS, torch.bfloat16, "ray"),
                                  ("backward", CORNER_RAYS, torch.bfloat16, "ray")))
    torch.cuda.empty_cache()

    lap("phase 37")
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
    path_counts = {**preset_counts, **unb_counts, "record": rec_counts}

    def compat_paths(kernel: str) -> dict:
        """Phase 32's counts of ``kernel``, one a compat path (each 0)."""
        return {f"compat_{k}": c[kernel] for k, c in compat["launches"].items()}

    data_counts = {**{f"{p}_blender": c for p, c in blender_counts.items()},
                   **other_counts}
    k1_paths = {"render_flagship": launches,
                **{f"{p}_{k}": c[k] for p, c in {**path_counts, **data_counts}.items()
                   for k in ("train_eval", "render", "eval")},
                "mipnerf_ms_train_eval": ms_counts["train_eval"],
                "mipnerf_ms_eval_scales": ms_counts["eval_scales"],
                "ema_eval": slice7["k1_eval"], "ema_sweep_depth_gif": slice7["k1_sweep"],
                **dp_run["k1"], **compat_paths("K1"),
                "long_render_300": long_counts["long_render_300"],
                **{f"wide_{k}_frame": wide_runs[k]["frame_launches"] for k in WIDE_RUNS}}
    k2_paths = {"train_flagship": train_launches,
                **{f"{p}_train": c["train"] for p, c in {**path_counts, **data_counts}.items()},
                "record_resume": rec_counts["resume"], "mipnerf_ms_train": ms_counts["train"],
                **host_counts, "record_lego_learning": learned["record_lego"].pop("launches"),
                "ema_train": slice7["k2_train"], "ema_resume": slice7["k2_resume"],
                "fault6_proposal_relu_seed2": fault6["K2"]["k2"], **dp_run["k2"],
                **compat_paths("K2"),
                **{k: v for k, v in long_counts.items() if k.endswith("_train")},
                **{f"wide_{k}_train": wide_runs[k]["train_K2_launches"] for k in WIDE_RUNS}}
    scatter_paths = {f"ngp_{layout}_train": c["train_scatter"] for layout, c in ngp_counts.items()}
    scatter_paths[f"ngp_flat_F{LIFT_FEATURES}_train"] = lift_ngp["counts"].pop("train_scatter")
    scatter_paths[f"ngp_flat_F{LIFT_WIDE_F}_step"] = lift_ngp["step_counts"]["train_scatter"]
    ngp_learned, fac_learned = learned.pop("ngp"), learned.pop("factored")
    scatter_paths["ngp_brick_learning"] = ngp_learned.pop("scatter_launches")
    scatter_paths.update(compat_paths("scatter_rows"))
    k3_paths = {f"factored_{k}": fac_counts[k] for k in ("train", "frame", "eval")}
    k3_paths.update(compat_paths("K3"))
    k3b_paths = {"factored_train": fac_counts["train_backward"], **compat_paths("K3 backward")}
    k4_paths = {layout: {f"ngp_{layout}_{k}": v for k, v in c.items() if k != "train_scatter"}
                for layout, c in ngp_counts.items()}
    k4_paths["brick"]["ngp_brick_learning"] = ngp_learned.pop("launches")
    k4_paths["brick"].update({f"ngp_flat_F{LIFT_FEATURES}_{k}": v
                              for k, v in lift_ngp["counts"].items()})
    k4_paths["brick"][f"ngp_flat_F{LIFT_WIDE_F}_step"] = lift_ngp["step_counts"]["train"]
    k4_paths["brick"].update(compat_paths("gather_rows"))
    k4_paths["flat"].update(compat_paths("gather_pairs"))
    k4_rows = {"brick": ("gather_rows", ":54"), "flat": ("gather_pairs", ":133")}
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
        "instances": list(instances["fused_ray"]),
        "branches": [r for r in branch_rows + unb_rows + rec_rows + long_rows
                     if r["kernel"] == "K1"],
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
        "instances": list(instances["fused_train"]),
        "k2a": "train_narrow_kernel + train_narrow_bwd_kernel (route 'narrow wgmma', every "
               "field up to 256 wide; past it the cluster and mma.sync wide routes)",
        "k2b": "dw_wgmma_kernel (TMA, clusters sharing G by multicast, wgmma on MN-major "
               "operands) + reduce_kernel + feat_bias_kernel, every route",
        "k2b_ms": train_times["k2b_ms"],
        "k2b_bound_ms": train_times["k2b_bound_ms"],
        "k2b_max_rel_err_vs_f64": dw_err,
        "blocked_call_launches": blocked_launches,
        "branches": [r for r in branch_rows + unb_rows + rec_rows + long_rows
                     if r["kernel"] == "K2"],
    }, {
        "name": "fused_factored_encode",
        "route": "cuda",
        "source": "nerf_rs_tpu_torch/kernels/csrc/fused_factored.cu",
        "replaces": "nerf_rs_tpu/kernels/fused_factored.py:58",
        "launches": sum(k3_paths.values()),
        "launches_by_path": k3_paths,
        "max_abs_err": fac_errs["enc"],
        "ms": fac_fwd["ms"],
        "ms_window": fac_fwd["ms_window"],
        "plain_ms": fac_fwd["plain_ms"],
        "bound_ms": fac_fwd["bound_ms"],
        "bound_by": fac_fwd["bound_by"],
        "library_ms": fac_fwd["library_ms"],
        "points": fac_fwd["points"],
        "cases": [fac_chunk, fac_f32, *(r for r in wide_rows + corner_rows
                                          if r["kernel"] == "forward")],
    }, {
        "name": "fused_factored_encode_backward",
        "route": "cuda",
        "source": "nerf_rs_tpu_torch/kernels/csrc/fused_factored.cu",
        "replaces": "nerf_rs_tpu/kernels/fused_factored.py:73",
        "launches": sum(k3b_paths.values()),
        "launches_by_path": k3b_paths,
        "max_abs_err": fac_errs["d_lines_abs"],
        "max_rel_err": fac_errs["d_lines"],
        "max_rel_err_witness": fac_errs["d_lines_witness"],
        "plain_rel_err_witness": fac_errs["plain_witness"],
        **{k: fac_bwd[k] for k in ("ms", "ms_window", "plain_ms", "bound_ms", "bound_by",
                                   "library_ms", "points", "kernel_a_ms", "kernel_b_ms",
                                   "reduce_ms", "device_ms")},
        "cases": [fac_bwd_shuffled, fac_bwd_f32,
                  *(r for r in wide_rows + corner_rows if r["kernel"] == "backward")],
    }, *({
        "name": name,
        "route": "cuda",
        "source": "nerf_rs_tpu_torch/kernels/csrc/gather_rows.cu",
        "replaces": f"nerf_rs_tpu/kernels/gather_rows.py{line}",
        "launches": sum(k4_paths[layout].values()),
        "launches_by_path": k4_paths[layout],
        "max_abs_err": k4_err,
        **{k: k4_times[name][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                          "library_ms", "kernel_ms", "indices", "distinct")},
    } for layout, (name, line) in k4_rows.items()), {
        "name": "scatter_rows",
        "route": "cuda",
        "source": "nerf_rs_tpu_torch/kernels/csrc/gather_rows.cu",
        "replaces": "nerf_rs_tpu/models/hashgrid.py:296 (jnp.take's VJP, an XLA scatter-add; "
                    "the flat layout's at :212; no Pallas kernel)",
        "launches": sum(scatter_paths.values()),
        "launches_by_path": scatter_paths,
        "max_abs_err": scatter_err,
        **{k: scatter_times["brick"][k] for k in ("ms", "ms_window", "plain_ms", "bound_ms",
                                                  "bound_by", "library_ms", "library_det_ms",
                                                  "kernel_ms", "sort_ms", "device_ms",
                                                  "fetches")},
        "cases": [{"layout": "flat", **scatter_times["flat"]}],
    }],
        "presets": {**preset_times, **unb_times, **rec_times},
        "long_ray_steps": {k: {"k2_ms": v["K2"] * 1e3, "autograd_ms": v["autograd"] * 1e3,
                               "idle_pct": v["idle_pct"]} for k, v in long_steps.items()},
        "widths": {"check_launches": width_checks, "runs": wide_runs},
        "lifted": {"check_launches": lift_checks, "k3_check": lift_k3,
                   f"pos_enc_levels_{pe_cfg.pos_enc_levels}": lift_pe,
                   f"k3_levels_{LIFT_LEVELS}": lift_k3_rows, "flat_tables": lift_ngp},
        "learning": learned,
        "datasets": {"make_scene_s": {k: v[1] for k, v in scenes.items()}, **data_times},
        "multiscale": {"psnr_by_scale": ms_counts["psnr_by_scale"]},
        "factored": {**fac_times, "frame_s": fac_counts["frame_s"],
                     "learning": fac_learned},
        "ngp": {**ngp_times, "learning": ngp_learned},
        "slice7": slice7, "fault6": fault6,
        "dp": {k: v for k, v in dp_run.items() if k not in ("k1", "k2")},
        "compat": {k: v for k, v in compat.items() if k != "launches"}}))
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s wall, build included")
    if DEFERRED:
        fail("; ".join(DEFERRED))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] != ["--dp-cards"]:
        pin_first_card()
    if sys.argv[1:2] == ["--time-step"] and len(sys.argv) == 3:
        sys.exit(time_step(sys.argv[2]))
    if sys.argv[1:2] == ["--dp-cards"] and len(sys.argv) == 3:
        sys.exit(dp_cards(int(sys.argv[2])))
    if sys.argv[1:2] == ["--learn"] and len(sys.argv) >= 4:
        sys.exit(learn_seeds(sys.argv[2], sys.argv[3], sys.argv[4:]))
    if sys.argv[1:] == ["--trace-draws"]:
        sys.exit(trace_draws())
    if sys.argv[1:2] == ["--witness-steps"] and len(sys.argv) >= 5:
        sys.exit(witness_steps(sys.argv[2], sys.argv[3], sys.argv[4], sys.argv[5:]))
    if len(sys.argv) != 1:
        fail("usage: python3 chip_smoke.py [--time-step ROOT | --dp-cards N | "
             "--learn PRESET "
             "SEEDS [FLAG ...] | --witness-steps PRESET SEED STEPS [FLAG ...] | "
             "--trace-draws]")
    sys.exit(main())
