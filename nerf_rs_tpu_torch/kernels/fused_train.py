"""The whole-ray training kernel: forward (PE or IPE, of the contracted
points or Gaussians with ``cfg.contract`` -> field -> compositing -> MSE,
plus mip-NeRF 360's distortion loss with ``dist_weight``) and a
hand-written backward (loss -> compositing VJP -> head and trunk VJPs ->
dW) over whole rays. The counterpart of
``nerf_rs_tpu/kernels/fused_train.py``. Rays of any length, padded as
``kernels/fused_ray.py`` pads them: a zero-length interval has weight 0
and d sigma = da * 0 = 0, so every gradient row it gives is exactly 0, and
its distortion length is 0 too.

``fused_train_grads`` launches the CUDA kernels (``csrc/fused_train.cu``:
K2a, the per-tile forward and backward, and K2b, the dW and bias
reduction over rows) for CUDA tensors, and runs
``fused_train_grads_reference``, its plain PyTorch version, for CPU
tensors. There is no other switch: on a CUDA tensor it launches the
kernels or raises. A call over more than ``BLOCK_ROWS`` padded rows, or
more than ``BLOCK_BYTES`` of stashes, launches them once per block of rays
(``ray_blocks`` at ``block_rows``), which bounds the stashes on the card.
"""

from __future__ import annotations

import ctypes
from collections import OrderedDict
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import ModelConfig

from . import build
from .fused_ray import (_SHAPE_ERRORS, _SIGMA_ACT, _check, _check_device, encode_samples,
                        pad_samples, padded_samples, rays_per_cta)
from .fused_render import PackedWeights, PackedWeightsT, padded_widths, pe_encode


# How far the kernels may stand from their plain version on the same card
# and inputs (chip_smoke.py and tests/test_torch_cuda.py hold them to it,
# and to the float64 witness): diag columns 0-4 and weights absolute, each
# gradient leaf normalised by the plain leaf's max. Both multiply the same
# bf16 operands into f32 sums in another order, which flips the bf16
# rounding of some activations; a sample whose sigma_raw lies within that
# noise of relu's kink then gets d sigma on one side and 0 on the other.
# Largest readings on an H100 over 54 cases (3 input sets x 6 seeds of
# weights x 3 sigma/background cases): diag 4.0e-4, weights 4.6e-4, grads
# 1.2e-2 (two such kink samples of 64,064; 2.5e-3 without them, as far as
# the f32 version itself stands from the float64 witness). The bars are
# about 4x, 4x and 2x those. They hold at such inputs, weights at their
# initial scale, and do not bound a trained relu field: in the proposal
# preset's seed-2 relu drive (chip_smoke.py --witness-steps proposal 2 301
# --sigma_activation relu, an H100) the plain version leaves them against
# the witness at 16 of 301 launches and K2 at 17, each time on a few rays
# (for all pairs but one, leaving out one group of 64 of the 1,024 brings
# the pair back) where two routes take a relu gate or a bf16 rounding
# apart; a gradient leaf's gap is relative to its largest entry, 2.7e-5 for
# the last trunk layer's bias there.
KERNEL_TOL = {"diag": 1.5e-3, "weights": 2e-3, "grads": 2.5e-2}

# How far K2b alone may stand from the float64 product A^T G (and sum_rows G)
# of the call's own stashes (``stash_views``), each leaf relative to its
# largest entry (tests/test_torch_cuda.py and chip_smoke.py hold it there).
# Both sum the same bf16 products, exact in f32; K2b's sums run on the tensor
# cores over ~12,288 rows a split, 768 wgmma k16 steps into one f32 sum,
# then over the splits in f32, and its bias sums on the CUDA cores. On an
# H100 the largest reading, at 1024/256/128, stood at about half the bar
# (chip_smoke.py prints each: check_dw_stashes).
DW_TOL = 1e-4

# How far a call launched in ray blocks may stand from the same call in one
# launch, each gradient leaf normalised by its max: diag and weights are the
# same bits, and K2b sums the same f32 rows in other groups.
BLOCKED_TOL = 1e-4

# Padded sample rows of one launch: 4096 rays x 256 samples, the record
# preset's union call, whose stashes and partials take 11.0 GB at paper width
# (~10.5 KB a row). Longer calls run in blocks of at most this many.
BLOCK_ROWS = 1 << 20

# Stash bytes of one launch (csrc/fused_train.cu ``scratch_layout`` less the
# partials): 16 GiB, which every preset's call stays within (the record
# union's 1,048,576 rows stash 10.9 GB), and with the dW partials (at most 128
# x the gradient's f32) a block of a wide field still fits an 80 GB card
# beside its step: at width 1024 and depth 8 a row stashes ~35.7 KB, so a
# block takes ~481,000 rows (the flagship recipe's 4096 x 64 call at that
# width: one block of 9.4 GB).
BLOCK_BYTES = 16 << 30


def ray_blocks(n_rays: int, S: int, rows: int = BLOCK_ROWS) -> List[Tuple[int, int]]:
    """The launches of a call on ``n_rays`` rays at the padded S: ranges
    [lo, hi) of consecutive rays in whole CTA tiles (``rays_per_cta(S)``
    rays each), each at most ``rows`` padded rows (one tile at least); a
    call within ``rows`` is one block."""
    R = rays_per_cta(S)
    per = max(R, rows // (R * S) * R)
    return [(lo, min(lo + per, n_rays)) for lo in range(0, n_rays, per)]


def block_rows(packed: PackedWeights, S: int) -> int:
    """Padded rows of one launch at the padded S (card only): the kernels'
    own sizing (``nerf_fused_train_block_rows``), at most ``BLOCK_ROWS``
    rows whose stashes take at most ``BLOCK_BYTES``, one tile at least."""
    rows = _library().nerf_fused_train_block_rows(S, packed.depth, packed.W, packed.F,
                                                  packed.V, packed.P, packed.D, BLOCK_ROWS,
                                                  BLOCK_BYTES)
    if rows < 0:
        raise ValueError(f"fused_train kernel refused the call: {_SHAPE_ERRORS[-1]}"
                         if rows == -1 else f"CUDA error {-rows} sizing the blocks")
    return rows


class TrainGrads(NamedTuple):
    """Kernel outputs in the packed layout (``unpack_grads`` maps them
    onto the ``NerfMLP`` state dict)."""

    diag: torch.Tensor  # (N, 8): [r, g, b, acc, sqerr, dist, 0, 0] (dist 0 when off)
    weights: torch.Tensor  # (N, S) compositing weights (values, no gradient)
    dw: Tuple[torch.Tensor, ...]  # f32 (K, N) per packed matrix, kernel order
    db: Tuple[torch.Tensor, ...]  # f32 padded bias gradients, kernel order


def _check_train(packed: PackedWeights, packed_t: PackedWeightsT, origins, dirs, viewdirs,
                 ts, deltas, gold, cfg: ModelConfig, num_samples: int, radii=None) -> None:
    """Shape and config checks, the same on every device."""
    _check(packed, origins, dirs, viewdirs, ts, deltas, cfg, num_samples, radii)
    n = origins.shape[0]
    if n == 0:
        raise ValueError("the train kernel needs at least one ray")
    if gold.shape != (n, 3):
        raise ValueError(f"gold must be ({n}, 3), got {tuple(gold.shape)}")
    L, W, Fw, V = packed.depth, packed.W, packed.F, packed.V
    want = tuple([(W, W)] * (L - 1) + [(Fw, W), (V, Fw), (16, V)])
    if packed_t.w_shape != want or packed_t.sigma_row.shape != (W,):
        raise ValueError(f"transposed weights are {packed_t.w_shape}, the packed "
                         f"weights need {want}")


_DIST_SPACES = ("linear", "disparity")


def dist_constants(near: float, far: float, dist_space: str,
                   dist_weight: float) -> Tuple[float, float, bool]:
    """(a, b, disparity) of the distortion loss's s-coordinates, as the
    JAX wrapper forms them: linear s = (t - a) b with a = near, b = 1 /
    (far - near); disparity s = (a - 1/t) b with a = 1/near, b = 1 /
    (1/near - 1/far). Each rounded to f32, the kernel's type. With the
    loss off, (0, 0, False)."""
    if dist_space not in _DIST_SPACES:
        raise ValueError(f"dist_space must be one of {_DIST_SPACES}, got {dist_space!r}")
    if dist_weight == 0.0:
        return 0.0, 0.0, False
    if dist_space == "disparity":
        g0, g1 = 1.0 / near, 1.0 / far
        a, b = g0, 1.0 / (g0 - g1)
    else:
        a, b = near, 1.0 / (far - near)
    f32 = lambda v: float(np.float32(v))  # noqa: E731
    return f32(a), f32(b), dist_space == "disparity"


def _split(flat: torch.Tensor, packed: PackedWeights):
    """The flat gradient (matrices, then biases) -> (dw, db) views."""
    total_w = packed.w.numel()
    dw = tuple(flat[o:o + k * n].view(k, n)
               for o, (k, n) in zip(packed.w_off, packed.w_shape))
    ends = list(packed.b_off[1:]) + [packed.b.numel()]
    db = tuple(flat[total_w + o:total_w + e] for o, e in zip(packed.b_off, ends))
    return dw, db


def fused_train_grads(
    packed: PackedWeights,
    packed_t: PackedWeightsT,
    origins: torch.Tensor,
    dirs: torch.Tensor,
    viewdirs: torch.Tensor,
    ts: torch.Tensor,
    deltas: torch.Tensor,
    gold: torch.Tensor,
    cfg: ModelConfig,
    num_samples: int,
    white_bg: bool = False,
    radii: Optional[torch.Tensor] = None,
    dist_weight: float = 0.0,
    near: float = 0.0,
    far: float = 1.0,
    dist_space: str = "linear",
    scratch: Optional[torch.Tensor] = None,
) -> TrainGrads:
    """One fused forward + backward over N rays: origins/dirs/viewdirs
    and gold (N, 3), ts/deltas (N, S) f32 (with ``cfg.ipe``: interval
    midpoints and exact lengths, and ``radii`` (N,) the cone radii).
    Returns per-ray diagnostics, the weights and the packed gradients of
    loss = mean over rays and channels of (C - gold)^2, summed over all N
    rays, plus ``dist_weight`` x the mean per-ray distortion loss when
    ``dist_weight`` > 0 (its per-ray values in diag column 5; ``near``,
    ``far`` and ``dist_space`` normalise the sample positions,
    ``dist_constants``). ``cfg.contract`` contracts the points (or
    Gaussians) before the encoding.

    Any N: the kernel masks the ragged last tile (no padded ray enters
    the loss). Any S >= 1. Launches on the current stream without
    synchronising; two calls on the same inputs give identical bits. Past
    ``BLOCK_ROWS`` padded rows or ``BLOCK_BYTES`` of stashes the call
    launches the kernels once per block of ``ray_blocks`` at ``block_rows``,
    each block's means taken over all N rays (diag and weights written in
    place, the blocks' gradients summed in block order), and
    ``fused_train_grads.launches`` counts each block's launch: a call
    within ``BLOCK_ROWS`` and ``BLOCK_BYTES`` adds 1. Any widths
    (``pack_weights`` pads them to multiples of 16; up to 256 K2a runs its
    narrow instance, past 256 its cluster route, each a forward and a
    backward kernel, ``route``), any depth and any encoding (where the
    narrow layout does not hold the encodings, the cluster route runs too).
    ``scratch``, a contiguous uint8 tensor on the rays' card of at least
    the call's scratch bytes, holds the stashes and the dW partials instead
    of a buffer of the call's own: after the call it holds the last block's
    stashes (``stash_views``), which the card tests read K2b's inputs from.
    """
    _check_train(packed, packed_t, origins, dirs, viewdirs, ts, deltas, gold, cfg,
                 num_samples, radii)
    dist = dict(dist_weight=dist_weight, near=near, far=far, dist_space=dist_space)
    dist_a, dist_b, disparity = dist_constants(near, far, dist_space, dist_weight)
    if origins.device.type == "cpu":
        return fused_train_grads_reference(packed, packed_t, origins, dirs, viewdirs, ts,
                                           deltas, gold, cfg, num_samples, white_bg, radii,
                                           **dist)
    if origins.device.type != "cuda":
        raise ValueError(f"no kernel for device {origins.device}")
    dev = origins.device
    _check_device((origins, dirs, viewdirs, ts, deltas, gold)
                  + ((radii,) if radii is not None else ()), dev)
    for t, dtype in ((packed.w, torch.bfloat16), (packed.b, torch.float32),
                     (packed_t.w, torch.bfloat16), (packed_t.sigma_row, torch.float32)):
        if t.device != dev or t.dtype != dtype:
            raise ValueError("packed weights must be bf16/f32 on the rays' device")

    n = origins.shape[0]
    ts_p, dl_p = pad_samples(ts, deltas)
    S = ts_p.shape[1]
    total = packed.w.numel() + packed.b.numel()
    diag = torch.empty(n, 8, device=dev)
    w = torch.empty(n, S, device=dev)
    grads = torch.empty(total, device=dev)
    lib = _library()
    blocks = ray_blocks(n, S, block_rows(packed, S))
    nbytes = lib.nerf_fused_train_scratch_bytes(blocks[0][1], S, packed.depth, packed.W,
                                                packed.F, packed.V, packed.P, packed.D, total)
    if nbytes < 0:
        raise ValueError(f"fused_train kernel refused the call: {_SHAPE_ERRORS[-1]}"
                         if nbytes == -1 else f"CUDA error {-nbytes} sizing the scratch")
    # the stashes and dW partials of the largest block, reused by the next
    # block in stream order; freed on return while the kernels may still
    # run, which is safe: the caching allocator hands the block out again
    # only in this stream's order
    if scratch is None:
        scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    elif (scratch.device != dev or scratch.dtype != torch.uint8 or not scratch.is_contiguous()
          or scratch.numel() < nbytes):
        raise ValueError(f"scratch must be a contiguous uint8 tensor of at least {nbytes} "
                         f"bytes on {dev}")
    part = torch.empty(total, device=dev) if len(blocks) > 1 else grads
    i64 = ctypes.c_longlong
    w_off = (i64 * len(packed.w_off))(*packed.w_off)
    b_off = (i64 * len(packed.b_off))(*packed.b_off)
    wt_off = (i64 * len(packed_t.w_off))(*packed_t.w_off)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for i, (lo, hi) in enumerate(blocks):
        out = grads if i == 0 else part
        rc = lib.nerf_fused_train_grads(
            _row(origins, lo), _row(dirs, lo), _row(viewdirs, lo), _row(ts_p, lo),
            _row(dl_p, lo), None if radii is None else _row(radii, lo), _row(gold, lo),
            packed.w.data_ptr(), packed.b.data_ptr(),
            w_off, len(packed.w_off), b_off, len(packed.b_off), packed.offsets.data_ptr(),
            packed_t.w.data_ptr(), wt_off, packed_t.offsets.data_ptr(), len(packed_t.w_off),
            packed_t.sigma_row.data_ptr(),
            _row(diag, lo), _row(w, lo), out.data_ptr(), scratch.data_ptr(),
            hi - lo, S, packed.depth, packed.skip_layer, packed.W, packed.F, packed.V,
            packed.P, packed.D, packed.pos_levels, packed.dir_levels,
            _SIGMA_ACT[cfg.sigma_activation], int(cfg.ipe), int(white_bg), 1.0 / (3.0 * n),
            int(cfg.contract), dist_weight / n, dist_a, dist_b, int(disparity), stream,
        )
        if rc < 0:
            raise ValueError(f"fused_train kernel refused the call: {_SHAPE_ERRORS[rc]}")
        if rc > 0:
            msg = lib.nerf_cuda_error_string(rc).decode()
            raise RuntimeError(f"fused_train kernel launch failed: CUDA error {rc} ({msg})")
        fused_train_grads.launches += 1
        if i > 0:  # the blocks' sums in block order: the same bits on every call
            grads += part
    return TrainGrads(diag, w[:, :num_samples], *_split(grads, packed))


def _row(t: torch.Tensor, i: int) -> int:
    """The address of row ``i`` of a contiguous tensor, without a view."""
    return t.data_ptr() + i * t.stride(0) * t.element_size()


# calls that launched the kernels so far in this process; a run reads it
# to show that its path went through them
fused_train_grads.launches = 0


def _library() -> ctypes.CDLL:
    lib = build.load("fused_train")
    fn = lib.nerf_fused_train_grads
    if fn.argtypes is None:
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        p64 = ctypes.POINTER(i64)
        fn.argtypes = (
            [vp] * 9 + [p64, i32, p64, i32]
            + [vp, vp, p64, vp, i32, vp]
            + [vp] * 4
            + [i64] + [i32] * 13 + [ctypes.c_float, i32] + [ctypes.c_float] * 3 + [i32, vp]
        )
        fn.restype = i32
        size = lib.nerf_fused_train_scratch_bytes
        size.argtypes = [i64] + [i32] * 7 + [i64]
        size.restype = i64
        rows = lib.nerf_fused_train_block_rows
        rows.argtypes = [i32] * 7 + [i64, i64]
        rows.restype = i64
        lib.nerf_fused_train_route.argtypes = [i32] * 6
        lib.nerf_fused_train_route.restype = i32
        offs = lib.nerf_fused_train_stash_offsets
        offs.argtypes = [i64] + [i32] * 7 + [i64, p64]
        offs.restype = i32
        lib.nerf_cuda_error_string.argtypes = [i32]
        lib.nerf_cuda_error_string.restype = ctypes.c_char_p
    return lib


# K2a's instances by C's TrainMode (csrc/fused_train.cu), which route() reports
K2_ROUTES = ("narrow wgmma", "cluster", "mma.sync wide")

# The narrow instance's act block (csrc/fused_train.cu act_off<true>): panels
# of 64 columns, 128 rows of 128 bytes each, row r's 16-byte chunk j at chunk
# j ^ (r % 8) -- the layout wgmma reads through a 128-byte-swizzle descriptor
# and TMA stores as one {64, 64} box a panel and consumer warpgroup
# (store_tile; warpgroup w's rows 64 w .. 64 w + 63 start 8 KB into each
# panel). Its encoding tiles stay K-major 8 x 8 core matrices
# (csrc/field_wgmma.cuh), stored one {8, 128} box a k-group of 8 columns.
PANEL_COLS = 64
PANEL_BYTES = 128 * 128


def narrow_act_offset(r: int, c: int) -> int:
    """Byte offset of element (r, c) of the narrow instance's act block."""
    return ((c >> 6) << 14) + (r << 7) + ((((c >> 3) & 7) ^ (r & 7)) << 4) + ((c & 7) << 1)


def narrow_stash_boxes(cols: int, panels: bool = True) -> List[Tuple[int, int, int, int]]:
    """The Python mirror of ``store_tile``: (tile byte offset, first column,
    first row, rows) of every TMA box that stores a tile's first ``cols``
    columns to its stash: the act block's 64-column panels, each as two
    boxes of one warpgroup's 64 rows (``panels``; the last panel clipped at
    the stash's width by its tensor map), or an encoding tile's 8-column
    k-groups of 128 rows, 2 KB apart."""
    if not panels:
        return [(2048 * g, 8 * g, 0, 128) for g in range(cols // 8)]
    return [(PANEL_BYTES * b + w * PANEL_BYTES // 2, PANEL_COLS * b, 64 * w, 64)
            for w in range(2) for b in range(-(-cols // PANEL_COLS))]


def route(packed: PackedWeights, num_samples: int) -> str:
    """The K2a instance the kernels take for ``packed``'s widths and
    encodings at ``num_samples`` (C ``train_mode``, decided by shape on the
    card's shared memory): "narrow wgmma" (fields up to 256 wide whose
    encodings its layout holds), "cluster" (the wide route: column blocks of
    256 in clusters) or "mma.sync wide" (past 2,048 wide, or encodings the
    cluster layout does not hold). Needs the built library, so the card."""
    rc = _library().nerf_fused_train_route(padded_samples(num_samples), packed.W, packed.F,
                                           packed.V, packed.P, packed.D)
    if rc < 0:
        raise ValueError(_SHAPE_ERRORS[-1] if rc == -1 else f"CUDA error {-rc} asking the route")
    return K2_ROUTES[rc]


# ---- K2b (csrc/fused_train.cu, dw_wgmma_kernel): its schedule, mirrored ----
# for the CPU tests (tests/test_torch_k2b.py holds these equal to the C
# constants). A job is one weight gradient dW (K, N) = A^T G over the call's
# rows; a work item is a cluster of CTAs over one column block of G (256
# columns, the last one taking an 8-column tail where N = 256 b + 8) and one
# split of the rows, CTA r owning A's columns [128 r, 128 r + 128); its
# producer loads 64-row k-blocks of its own A columns and a share of G's
# 64-column panels, multicast to the whole cluster.
DW_ROWS = 64  # kDwRows: stash rows a k-block (a ring slot)
DW_M = 128  # kDwM: dW rows (A columns) a CTA, two warpgroups of 64
DW_N = 256  # kDwN: G columns a column block
DW_TAIL = 8  # kDwTail
DW_MAX_CLUSTER = 8  # kDwMaxCluster
DW_MAX_STAGES = 4  # kDwMaxStages
DW_PANEL = DW_ROWS * 128  # kDwPanel: bytes of a 64-column panel of a k-block
SPLIT_ROWS = 12288  # kSplitRows
MAX_SPLITS = 128  # kMaxSplits
DW_JOBS = 24  # kJobs: jobs a launch

# the stashes in the scratch's order, and their widths (columns)
STASHES = ("sx", "sh", "sfeat", "shv", "sdv", "gh", "gsf", "ghv", "grgb")


def stash_width(name: str, packed) -> int:
    """Columns of stash ``name`` (STASHES) of a field packed as ``packed``."""
    return {"sx": packed.P, "sh": packed.W, "sfeat": packed.F, "shv": packed.V,
            "sdv": packed.D, "gh": packed.W, "gsf": packed.F + 8, "ghv": packed.V,
            "grgb": 8}[name]


class DwJob(NamedTuple):
    """dW (K, N) = A^T G over the rows, A the stash ``a`` at layer
    ``a_layer``, G the stash ``g`` at ``g_layer``; dW at ``out`` in the flat
    gradient and, where ``bias_out`` >= 0, the sums of G's columns from
    ``bias_col0`` on at ``bias_out``."""

    a: str
    a_layer: int
    K: int
    g: str
    g_layer: int
    N: int
    out: int
    bias_out: int
    bias_col0: int


def dw_jobs(packed) -> List[DwJob]:
    """K2b's jobs in the packed order, as ``nerf_fused_train_grads`` builds
    them: every trunk layer (layer 0 from PE(x)), the skip layer's PE(x)
    block where it has one, the sigma block of [feature | sigma] (its bias
    from column F: d feat_b is ``feat_bias_kernel``'s), the view head's
    feature and PE(d) blocks (one bias) and the rgb head."""
    L, skip, W, F, V, P, D = (packed.depth, packed.skip_layer, packed.W, packed.F, packed.V,
                              packed.P, packed.D)
    wo, bo, tw = packed.w_off, packed.b_off, packed.w.numel()
    jobs = [DwJob("sx" if l == 0 else "sh", max(l - 1, 0), P if l == 0 else W, "gh", l, W,
                  wo[l], tw + bo[l], 0) for l in range(L)]
    if 0 < skip < L:
        jobs.append(DwJob("sx", 0, P, "gh", skip, W, wo[L], -1, 0))
    jobs += [DwJob("sh", L - 1, W, "gsf", 0, F + 8, wo[L + 1], tw + bo[L], F),
             DwJob("sfeat", 0, F, "ghv", 0, V, wo[L + 2], tw + bo[L + 1], 0),
             DwJob("sdv", 0, D, "ghv", 0, V, wo[L + 3], -1, 0),
             DwJob("shv", 0, V, "grgb", 0, 8, wo[L + 4], tw + bo[L + 2], 0)]
    return jobs


def dw_splits(rows: int) -> Tuple[int, int]:
    """(splits, rows a split) of K2b over ``rows`` rows (C ``splits_for``,
    ``rows_per_split``): at most MAX_SPLITS shares of about SPLIT_ROWS rows,
    each whole k-blocks."""
    s = min(max(-(-rows // SPLIT_ROWS), 1), MAX_SPLITS)
    rps = -(-(-(-rows // s)) // DW_ROWS) * DW_ROWS
    return -(-rows // rps), rps


def dw_cblocks(N: int) -> int:
    """G's column blocks of a job N columns wide (C ``dw_cblocks``)."""
    return N // DW_N if N > DW_N and N % DW_N == DW_TAIL else -(-N // DW_N)


def dw_cluster(jobs: List[DwJob]) -> int:
    """CTAs a cluster: the widest job's m-blocks, at most DW_MAX_CLUSTER."""
    return min(max(-(-j.K // DW_M) for j in jobs), DW_MAX_CLUSTER)


def dw_launches(jobs: List[DwJob]) -> List[List[Tuple[DwJob, int, int, int]]]:
    """Each K2b launch's jobs in their order (the heaviest bytes a row
    first, a stable sort; DW_JOBS a launch), each with (m-groups, column
    blocks, first item)."""
    c = dw_cluster(jobs)

    def cost(j):
        return (min(j.K, c * DW_M) + min(j.N, DW_N)
                + (DW_TAIL if j.N > DW_N and j.N % DW_N == DW_TAIL else 0))

    order = sorted(jobs, key=cost, reverse=True)
    out = []
    for j0 in range(0, len(order), DW_JOBS):
        launch, item = [], 0
        for j in order[j0:j0 + DW_JOBS]:
            mg, cb = -(-(-(-j.K // DW_M)) // c), dw_cblocks(j.N)
            launch.append((j, mg, cb, item))
            item += mg * cb
        out.append(launch)
    return out


class DwCta(NamedTuple):
    """One K2b CTA as the kernel decodes its block index: its job, split and
    rank in the cluster, the cluster's CTAs with rows of dW (``act``), its
    dW rows [m0, m0 + 128) and G columns [n0, n0 + 256) (+ the tail), and
    whether it sums G's bias columns."""

    job: DwJob
    split: int
    rank: int
    act: int
    m0: int
    n0: int
    tail: bool
    bias: bool
    r0: int
    r1: int


def dw_ctas(jobs: List[DwJob], rows: int) -> List[List[DwCta]]:
    """Every CTA of every K2b launch over ``rows`` rows, in block order:
    cluster c is item c // splits over split c % splits."""
    c = dw_cluster(jobs)
    splits, rps = dw_splits(rows)
    out = []
    for launch in dw_launches(jobs):
        items = sum(mg * cb for _, mg, cb, _ in launch)
        ctas = []
        for block in range(items * splits * c):
            rank, cid = block % c, block // c
            item, split = cid // splits, cid % splits
            j, mg_n, cb_n, unit0 = [x for x in launch if x[3] <= item][-1]
            v = item - unit0
            cb, mg = v // mg_n, v % mg_n
            act = min(c, -(-j.K // DW_M) - mg * c)
            tail = j.N > DW_N and j.N % DW_N == DW_TAIL and cb == cb_n - 1
            r0 = split * rps
            ctas.append(DwCta(j, split, rank, act, (mg * c + rank) * DW_M, cb * DW_N, tail,
                              j.bias_out >= 0 and mg == 0 and rank == 0, r0,
                              min(rows, r0 + rps)))
        out.append(ctas)
    return out


def dw_loads(cta: DwCta) -> List[Tuple[str, int, int]]:
    """The TMA boxes a CTA's producer issues for each of its k-blocks (rows
    [r, r + 64) for r in range(r0, r1, DW_ROWS)): (stash, layer, first
    column) of each {64, 64} box, its own A panels then the G panels it
    multicasts (panel q by rank q % act; the tail's at column n0 + 256).
    None for a CTA past its job's m-blocks (it leaves at once)."""
    if cta.rank >= cta.act:
        return []
    j = cta.job
    a_panels = 2 if j.K - cta.m0 > 64 else 1
    g_panels = min(4, -(-(j.N - cta.n0) // 64)) + (1 if cta.tail else 0)
    return ([(j.a, j.a_layer, cta.m0 + 64 * q) for q in range(a_panels)]
            + [(j.g, j.g_layer, cta.n0 + 64 * q) for q in range(g_panels)
               if q % cta.act == cta.rank])


def dw_warpgroups(cta: DwCta) -> List[int]:
    """The consumer warpgroups of a CTA that take part (``dw_consume``):
    warpgroup w multiplies A's panel w, dW rows [m0 + 64 w, m0 + 64 w + 64),
    where those rows start below K; none for a CTA past its job's m-blocks."""
    if cta.rank >= cta.act:
        return []
    return [w for w in range(DW_M // 64) if 64 * w < cta.job.K - cta.m0]


def dw_consumers(K: int, act: int, m_last: int) -> int:
    """The consumer arrivals each ring slot's `empty` barrier counts in a
    cluster of ``act`` live CTAs, the last one's dW rows from ``m_last``
    (``dw_consumers`` in the kernel; the bias warps add 2)."""
    return 2 * act - (0 if K - m_last > 64 else 1)


def dw_bias_lanes(cta: DwCta) -> List[Tuple[int, int, List[int]]]:
    """The bias sums of a bias CTA (``dw_bias``): for each of warps 9 and 10
    (h = 0, 1) and lane, (h, chunk, rows of each k-block) it adds, the chunk
    an 8-column group of the block's columns from ``bias_col0`` on (chunk
    32: the tail's). Where the block has C <= 32 chunks, ``per`` = 32 / C
    rounded down to a power of two lanes share a chunk, each taking every
    per-th row of its warp's 32; none where the block has no bias column."""
    j = cta.job
    cs = max(0, j.bias_col0 - cta.n0) // 8
    ce = (min(j.N - cta.n0, DW_N + (DW_TAIL if cta.tail else 0)) + 7) // 8
    per = 1
    if ce > cs:
        while per * 2 * (ce - cs) <= 32:
            per *= 2
    out = []
    for h in range(2):
        for lane in range(32):
            sub, c_lane = lane & (per - 1), cs + lane // per
            for c in (c_lane, c_lane + 32):
                if c < ce:
                    out.append((h, c, list(range(32 * h + sub, 32 * h + 32, per))))
    return out


def stash_views(scratch: torch.Tensor, packed: PackedWeights, n_rays: int, S: int) -> dict:
    """The stashes of a one-block call's ``scratch`` (``fused_train_grads``'s
    keyword) as bf16 tensors: (rows_pad, width) each, sh and gh (depth,
    rows_pad, W); "rows" the call's rows (n_rays x the padded S, K2b's sum
    runs over them). Card only: the offsets are the kernel library's."""
    S = padded_samples(S)
    out = (ctypes.c_longlong * (len(STASHES) + 1))()
    total = packed.w.numel() + packed.b.numel()
    rc = _library().nerf_fused_train_stash_offsets(n_rays, S, packed.depth, packed.W, packed.F,
                                                   packed.V, packed.P, packed.D, total, out)
    if rc != 0:
        raise ValueError(f"fused_train kernel refused the shape (code {rc})")
    rows_pad = out[len(STASHES)]
    views = {"rows": n_rays * S}
    for name, off in zip(STASHES, out):
        width = stash_width(name, packed)
        layered = name in ("sh", "gh")
        layers = packed.depth if layered else 1
        t = scratch[off:off + 2 * layers * rows_pad * width].view(torch.bfloat16)
        views[name] = t.view(layers, rows_pad, width) if layered else t.view(rows_pad, width)
    return views


def fused_train_grads_reference(
    packed: PackedWeights,
    packed_t: PackedWeightsT,
    origins: torch.Tensor,
    dirs: torch.Tensor,
    viewdirs: torch.Tensor,
    ts: torch.Tensor,
    deltas: torch.Tensor,
    gold: torch.Tensor,
    cfg: ModelConfig,
    num_samples: int,
    white_bg: bool = False,
    radii: Optional[torch.Tensor] = None,
    dist_weight: float = 0.0,
    near: float = 0.0,
    far: float = 1.0,
    dist_space: str = "linear",
    *,
    dtype: torch.dtype = torch.float32,
    trace: Optional[dict] = None,
) -> TrainGrads:
    """The kernels' plain PyTorch version, with their numerics: f32
    encodings (PE, or IPE with ``radii``), bf16 operands, f32 products
    and sums, bf16 activations between layers, f32 compositing, and the
    TPU kernel's bf16 rounding points in the backward (d rgb_raw, g_hv,
    dfeat, d sigma, every trunk g). The compositing VJP is written out,
    not taken from autograd, and so is the distortion loss's cotangent
    (the kernel's prefix-sum form, its f32 constants). On CUDA it needs
    full-f32 matmuls (``torch.backends.cuda.matmul.allow_tf32 = False``).

    ``dtype=torch.float64`` keeps every bf16 rounding point (and the f32
    encoding) but multiplies, sums and composites in float64: a witness
    of how far f32 summation order alone moves the result, for the kernel
    and the f32 version alike.

    A ``trace`` dict receives the pre-activations whose sign gates a
    gradient, rows in ray-major order: ``pre`` (the trunk layers'), ``hv``
    (the view layer's) and ``sigma_raw`` (under relu density)."""
    _check_train(packed, packed_t, origins, dirs, viewdirs, ts, deltas, gold, cfg,
                 num_samples, radii)
    dist_a, dist_b, disparity = dist_constants(near, far, dist_space, dist_weight)
    n, S = ts.shape
    rows = n * S
    bf = torch.bfloat16
    mats = [m.to(dtype) for m in packed.matrices()]
    mats_t = [m.to(dtype) for m in packed_t.matrices()]
    bias = [b.to(dtype) for b in packed.biases()]
    L, skip, Fw = packed.depth, packed.skip_layer, packed.F

    def mm(a, m):
        return a.to(dtype) @ m

    def tmm(a, g):  # A^T G: a weight gradient summed over rows
        return a.to(dtype).t() @ g.to(dtype)

    # ---- forward ----
    x = encode_samples(packed, origins, dirs, ts, deltas, radii, cfg.contract).to(bf)
    dv = pe_encode(viewdirs, packed.dir_levels, packed.D).to(bf).repeat_interleave(S, dim=0)
    hs, h = [], x
    for i in range(L):
        acc = mm(h, mats[i])
        if i == skip and i > 0:
            acc = acc + mm(x, mats[L])
        if trace is not None:
            trace.setdefault("pre", []).append(acc + bias[i])
        h = F.relu(acc + bias[i]).to(bf)
        hs.append(h)
    sf = mm(h, mats[L + 1]) + bias[L]
    sigma_raw = sf[:, Fw].reshape(n, S)
    deltas, gold = deltas.to(dtype), gold.to(dtype)
    feat = sf[:, :Fw].to(bf)
    hv_pre = mm(feat, mats[L + 2]) + mm(dv, mats[L + 3]) + bias[L + 1]
    hv = F.relu(hv_pre).to(bf)
    if trace is not None:
        trace.update(hv=hv_pre, sigma_raw=sigma_raw.reshape(rows))
    rgb = torch.sigmoid(mm(hv, mats[L + 4]) + bias[L + 2])[:, :3]
    rgb_rs = rgb.reshape(n, S, 3)

    if cfg.sigma_activation == "relu":
        sigma, slope = F.relu(sigma_raw), (sigma_raw > 0).float()
    else:
        sigma = torch.logaddexp(sigma_raw, torch.zeros_like(sigma_raw))
        slope = torch.sigmoid(sigma_raw)
    a = sigma * deltas
    excl = torch.cat([torch.zeros_like(a[:, :1]), torch.cumsum(a[:, :-1], dim=-1)], -1)
    trans = torch.exp(-excl)
    w = trans * (1.0 - torch.exp(-a))
    C = (w[:, :, None] * rgb_rs).sum(dim=1)
    acc = w.sum(dim=-1)
    if white_bg:
        C = C + (1.0 - acc)[:, None]
    res = C - gold
    sqerr = (res * res).mean(dim=-1)
    ldist = torch.zeros_like(acc)
    if dist_weight != 0.0:  # mip-NeRF 360's distortion loss, the kernel's prefix-sum form
        t = ts.to(dtype)
        if disparity:
            m = (dist_a - 1.0 / t) * dist_b
            den = (t - 0.5 * deltas) * (t + 0.5 * deltas) if radii is not None else t * (t + deltas)
            dn = deltas / den * dist_b
        else:
            m = (t - dist_a) * dist_b
            dn = deltas * dist_b
        cw, cwm = torch.cumsum(w, dim=-1), torch.cumsum(w * m, dim=-1)
        dist_A = m * (2.0 * cw - acc[:, None]) + (w * m).sum(dim=-1, keepdim=True) - 2.0 * cwm
        ldist = (w * dist_A + w * w * dn * (1.0 / 3.0)).sum(dim=-1)
    diag = torch.cat([C, acc[:, None], sqerr[:, None], ldist[:, None],
                      torch.zeros_like(C[:, :2])], dim=1)

    # ---- compositing VJP, f32 ----
    dC = (2.0 / (3.0 * n)) * res
    u = (rgb_rs * dC[:, None, :]).sum(dim=-1)
    if white_bg:
        u = u - dC.sum(dim=-1, keepdim=True)
    if dist_weight != 0.0:
        u = u + (dist_weight / n) * (2.0 * dist_A + (2.0 / 3.0) * w * dn)
    uw = u * w
    suffix = torch.cat([uw.flip(-1).cumsum(-1).flip(-1)[:, 1:],
                        torch.zeros_like(uw[:, :1])], dim=-1)  # sum over i > k
    da = u * (trans - w) - suffix
    dsig = (da * deltas * slope).to(bf).reshape(rows)

    # ---- head and trunk VJPs ----
    drgb = (w[:, :, None] * dC[:, None, :]).reshape(rows, 3)
    drgb_raw = (drgb * rgb * (1.0 - rgb)).to(bf)
    g_rgb = F.pad(drgb_raw, (0, 5))  # the rgb head's (rows, 8) gradient
    g_hv = (mm(F.pad(drgb_raw, (0, 13)), mats_t[L + 1]) * (hv > 0)).to(bf)
    dfeat = mm(g_hv, mats_t[L])
    dfeat_bf = dfeat.to(bf)
    dh = mm(dfeat_bf, mats_t[L - 1]) + dsig.to(dtype)[:, None] * packed_t.sigma_row.to(dtype)
    G = [None] * L
    for li in range(L - 1, -1, -1):
        G[li] = (dh * (hs[li] > 0)).to(bf)
        if li > 0:
            dh = mm(G[li], mats_t[li - 1])

    g_sf = torch.cat([dfeat_bf, dsig[:, None], torch.zeros(rows, 7, dtype=bf,
                                                           device=dsig.device)], dim=1)
    dw = [tmm(x if li == 0 else hs[li - 1], G[li]) for li in range(L)]
    dw.append(tmm(x, G[skip]) if 0 < skip < L else torch.zeros_like(mats[L]))
    dw += [tmm(hs[-1], g_sf), tmm(feat, g_hv), tmm(dv, g_hv), tmm(hv, g_rgb)]
    db = [G[li].to(dtype).sum(dim=0) for li in range(L)]
    db += [torch.cat([dfeat.sum(dim=0), g_sf[:, Fw:].to(dtype).sum(dim=0)]),
           g_hv.to(dtype).sum(dim=0), g_rgb.to(dtype).sum(dim=0)]
    return TrainGrads(diag, w, tuple(dw), tuple(db))


def unpack_grads(tg: TrainGrads, params, cfg: ModelConfig) -> "OrderedDict[str, torch.Tensor]":
    """Packed-layout gradients -> gradients keyed like the ``NerfMLP``
    state dict (the inverse of ``pack_weights``' padding and splitting,
    the widths' pads cropped; the counterpart of ``unpack_grads`` in the
    JAX package)."""
    W, Fw, V, L = cfg.net_width, cfg.feature_width, cfg.view_head_width, cfg.net_depth
    Fp = padded_widths(cfg)[1]  # sigma's column in [feature | sigma]
    out: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    for i, layer in enumerate(params.trunk):
        in_dim = layer.w.shape[0]
        if i == cfg.skip_layer and i > 0:
            gw = torch.cat([tg.dw[i][:W, :W], tg.dw[L][:in_dim - W, :W]])
        else:
            gw = tg.dw[i][:in_dim, :W]
        out[f"trunk.{i}.w"] = gw
        out[f"trunk.{i}.b"] = tg.db[i][:W]
    out["sigma.w"] = tg.dw[L + 1][:W, Fp:Fp + 1]
    out["sigma.b"] = tg.db[L][Fp:Fp + 1]
    out["feature.w"] = tg.dw[L + 1][:W, :Fw]
    out["feature.b"] = tg.db[L][:Fw]
    dir_rows = params.view1.w.shape[0] - Fw
    out["view1.w"] = torch.cat([tg.dw[L + 2][:Fw, :V], tg.dw[L + 3][:dir_rows, :V]])
    out["view1.b"] = tg.db[L + 1][:V]
    out["rgb.w"] = tg.dw[L + 4][:V, :3]
    out["rgb.b"] = tg.db[L + 2][:3]
    return OrderedDict((k, v.contiguous()) for k, v in out.items())
