"""The factored-encode kernel K3, forward and backward: per axis the
hat-basis weights of every level's two knots around the point times that
axis's line table, then the CP product of the three axes; the backward
gives the line tables' gradient. The counterpart of
``nerf_rs_tpu/kernels/fused_factored.py``.

``fused_factored_encode`` is the drop-in for
``models/factored.factored_encode`` (same output, f32, as the JAX
kernel's) as a ``torch.autograd.Function``. Its forward and backward
launch the CUDA kernels (``csrc/fused_factored.cu``) for CUDA tensors
and run the plain PyTorch versions (``fused_factored_encode_reference``,
``fused_factored_encode_backward_reference``) for CPU tensors. There is
no other switch: on a CUDA tensor they launch the kernels or raise.

Numerics, as the JAX kernel's: with a bf16 ``dtype`` the hat weights
(computed in f32) and the lines are rounded to bf16 and multiplied in
f32, which is exact, and the products are summed in f32; the features
and their CP product are f32. The backward rounds d_feat = (g * f_b) *
f_c to bf16 and sums w * d_feat over the points in f32: on the card's
tensor cores, in tiles of TILE_POINTS points whose sums are added to
nearest into fixed-order f32 partials. With the f32 ``dtype`` nothing is
rounded, and the backward's sums run on the CUDA cores.

There is no gradient for the points (the JAX kernel returns zeros for
them): in every training path the points come from the rays and samples,
which are not trained. ``models/factored.factored_encode`` differentiates
in the points.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from ..config import ModelConfig
from ..models.factored import basis_dim, fac_resolutions, hat_weights, unit_coords

from . import build

# points per call of the plain versions' gathers and of the backward's dense
# (points, sumR) hat matrix
PLAIN_CHUNK = 65536

# How far the kernels may stand from their plain versions on the same card
# and inputs (chip_smoke.py and tests/test_torch_cuda.py hold them to it):
# enc absolute, d_lines per axis relative to the axis's largest entry. Both
# multiply the same operands and sum in f32. The features sum each axis's
# 2L taps in level order on both sides, so the encoding and d_feat keep the
# kernel's bits; the backward's sums over up to N points per knot run in
# another order (the kernel's fixed-order partials -- under bf16 each a sum
# of tensor-core sums of 256 points -- against cuBLAS's order in the plain
# version). The first readings on an H100, 524,288 random points: enc
# 1.2e-6 (values up to 5.5; features then summed by a dense product),
# d_lines 1.1e-6; the bars are ~10x those.
KERNEL_TOL = {"enc": 1e-5, "d_lines": 1e-5}

# The backward's layout (csrc/fused_factored.cu's bwd_plan, which this file's
# bwd_plan mirrors for the layout tests on the CPU; the wrappers take the
# library's). bf16 lines: a tensor-core CTA has MMA_WARPS warps, each
# owning MMA_BLOCKS blocks of 16 knot rows for up to MMA_MAX_TILES tiles of 8
# channels, and walks tiles of TILE_POINTS points in steps of 16 (the mma's
# K), flushing its sums once a tile. f32 lines: WALK_CTAS point ranges per
# axis walk chunks of WALK_POINTS points, each CTA over one tile of an
# axis's table (a run of whole levels, or a run of one wide level's rows,
# times a run of columns) in shared memory (``walk_tiles``). A tensor-core
# CTA holds the taps of the levels it walks: where those of every level do
# not fit beside its channel tiles (20 levels at 6 tiles; past MMA_RUN_LEVELS
# at one) the backward launches one run of levels at a time (``level_run``).
# The kernels read the levels' resolutions and first rows from a device
# table (``build.device_table``, one per geometry and device), not from their
# launch parameters, so a geometry may have any number of levels up to
# FWD_MAX_LEVELS: the forward keeps two buffers of a tile's taps and the level
# table in shared memory, and those of one point, 80 bytes a level, must fit a CTA.
MMA_WARPS = 16
MMA_BLOCKS = 2
MMA_MAX_TILES = 6
TILE_POINTS = 256
WALK_POINTS = 64
WALK_CTAS = 44
_SMEM = 232448  # what one CTA can have on sm_90
FWD_MAX_LEVELS = _SMEM // 80
MMA_RUN_LEVELS = 47


def _mma_smem_bytes(nt: int, levels: int) -> int:
    """Shared memory of a tensor-core scatter CTA of ``nt`` 8-channel
    tiles over ``levels`` levels (the C plan's budget): the warps' f32
    sums, two buffers of a tile's d_feat (rows padded to an odd count of
    16 B) and two of its taps and bands at every level."""
    row = (nt if nt % 2 else nt + 1) * 8
    return (4 * MMA_WARPS * MMA_BLOCKS * nt * 4 * 32 + 2 * TILE_POINTS * row * 2
            + 2 * levels * TILE_POINTS * 8 + 2 * levels * (TILE_POINTS // 16) * 8)


class BwdPlan(NamedTuple):
    """The backward's layout for N points: d_feat and partial tables of
    ``stride`` columns (C padded to ``groups`` groups of ``nt`` 8-channel
    tiles under bf16, C under f32), ``slabs`` row slabs per axis (bf16),
    and ``ranges`` point ranges of ``per`` tiles (bf16: TILE_POINTS points;
    f32: chunks of WALK_POINTS), each writing one partial table per axis."""
    stride: int
    nt: int
    groups: int
    slabs: int
    ranges: int
    per: int


def bwd_plan(n: int, sum_r: int, comps: int, bf16: bool, sms: int) -> BwdPlan:
    """The layout the backward kernels take for ``n`` points on a card of
    ``sms`` SMs: under bf16 as many point ranges as give every SM one CTA
    of (range, slab, channel group, axis), in the fewest channel groups of
    at most MMA_MAX_TILES tiles (the levels whose taps do not fit beside
    them go in runs, ``level_run``); under f32 WALK_CTAS per axis."""
    if bf16:
        tiles8 = -(-comps // 8)
        groups = -(-tiles8 // MMA_MAX_TILES)
        nt = -(-tiles8 // groups)
        stride = groups * nt * 8
        blocks = -(-sum_r // 16)
        slabs = -(-blocks // (MMA_WARPS * MMA_BLOCKS))
        units = -(-n // TILE_POINTS)
        want = max(1, sms // (3 * slabs * groups))
    else:
        stride, nt, groups, slabs = comps, 0, 1, 1
        units = -(-n // WALK_POINTS)
        want = WALK_CTAS
    want = min(want, units)
    per = -(-units // want) if want > 0 else 0
    ranges = -(-units // per) if per > 0 else 0
    return BwdPlan(stride, nt, groups, slabs, ranges, per)


def level_run(nt: int, levels: int) -> int:
    """Levels of one tensor-core scatter launch (C ``level_run``): the most
    whose taps fit beside ``nt`` channel tiles, all of them where they do
    (MMA_RUN_LEVELS at one tile)."""
    run = levels
    while run > 1 and _mma_smem_bytes(nt, run) > _SMEM:
        run -= 1
    return run


def _walk_smem_bytes(rows: int, levels: int, cw: int) -> int:
    return 4 * (rows * cw + WALK_POINTS * cw) + 12 * WALK_POINTS * levels


class WalkTiles(NamedTuple):
    """The f32 scatter's table tiles (C ``walk_tiles``): level groups
    starting at ``first`` (and ending at the next entry), a group's rows cut
    into runs of at most ``row_cap`` rows, times column chunks of ``cw``."""
    first: tuple
    cw: int
    row_cap: int


def walk_tiles(res, comps: int) -> WalkTiles:
    """The f32 scatter's tiles for the level resolutions ``res``: all
    columns where the widest level's rows allow it, else as many as fit
    beside them (at least one); the levels in runs whose rows fit; a level
    too wide for one column cut into runs of ``row_cap`` rows."""
    off = [0]
    for r in res:
        off.append(off[-1] + r + 1)
    widest = max(r + 1 for r in res)
    cw = comps
    while cw > 1 and _walk_smem_bytes(widest, 1, cw) > _SMEM:
        cw -= 1
    row_cap = 1
    while _walk_smem_bytes(row_cap + 1, 1, cw) <= _SMEM:
        row_cap += 1
    first, l = [], 0
    while l < len(res):
        e = l + 1
        while e < len(res) and _walk_smem_bytes(off[e + 1] - off[l], e + 1 - l, cw) <= _SMEM:
            e += 1
        first.append(l)
        l = e
    return WalkTiles(tuple(first) + (len(res),), cw, row_cap)


def walk_tile_rows(tiles: WalkTiles, res) -> list:
    """(first row, rows, levels) of every tile of ``walk_tiles`` in launch
    order (the column chunks aside)."""
    off = [0]
    for r in res:
        off.append(off[-1] + r + 1)
    out = []
    for l0, l1 in zip(tiles.first, tiles.first[1:]):
        for r0 in range(off[l0], off[l1], tiles.row_cap):
            out.append((r0, min(tiles.row_cap, off[l1] - r0), l1 - l0))
    return out


def warp_blocks(slab: int, warp: int, slabs: int, sum_r: int) -> list:
    """The 16-row blocks that warp ``warp`` of a slab-``slab`` CTA owns
    (-1 where it owns none): block s + slabs (warp + MMA_WARPS j), so the
    coarse blocks (low rows) spread over every slab and warp."""
    blocks = -(-sum_r // 16)
    out = []
    for j in range(MMA_BLOCKS):
        b = slab + slabs * (warp + MMA_WARPS * j)
        out.append(b if b < blocks else -1)
    return out


_ERRORS = {
    -2: "fac_levels must be at least 1",
    -4: "every resolution must be at least 1",
    -5: f"fac_levels above {FWD_MAX_LEVELS}: two buffers of one point's taps at every level "
        f"and the level table outgrow a CTA's shared memory",
}


def _bf16(dtype) -> bool:
    return dtype == torch.bfloat16


def _check(lines: torch.Tensor, points: torch.Tensor, cfg: ModelConfig,
           g: Optional[torch.Tensor] = None) -> None:
    """Shape checks, the same on every device."""
    want = (3, basis_dim(cfg), cfg.fac_comps)
    if tuple(lines.shape) != want:
        raise ValueError(f"lines must be {want}, got {tuple(lines.shape)}")
    if points.dim() != 2 or points.shape[1] != 3:
        raise ValueError(f"points must be (N, 3), got {tuple(points.shape)}")
    if g is not None and tuple(g.shape) != (points.shape[0], cfg.fac_comps):
        raise ValueError(f"g must be ({points.shape[0]}, {cfg.fac_comps}), "
                         f"got {tuple(g.shape)}")


def _check_cuda(tensors, dev) -> None:
    for name, t in tensors:
        if t.device != dev or t.dtype != torch.float32:
            raise ValueError(f"{name} must be f32 on the points' device ({dev})")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


@functools.lru_cache(maxsize=64)
def _geometry(levels: int, base_res: int, max_res: int, comps: int, aabb: float):
    """A geometry's resolutions, as a tuple and as a C array, and the
    values of the kernels' level table (csrc/fused_factored.cu
    ``init_geometry``: the L resolutions, then each level's first knot row
    and the rows in all), built once per geometry: a call's host time is on
    the card's critical path when the kernel is short."""
    res = tuple(fac_resolutions(ModelConfig(arch="factored", fac_levels=levels,
                                            fac_base_res=base_res, fac_max_res=max_res,
                                            fac_comps=comps)))
    off = [0]
    for r in res:
        off.append(off[-1] + r + 1)
    return res, (ctypes.c_int * len(res))(*res), res + tuple(off)


def _launch_args(lines: torch.Tensor, cfg: ModelConfig, dtype):
    """The kernels' line operand (bf16 under a bf16 ``dtype``, as the JAX
    wrapper casts it) and the C arguments of the geometry: its resolutions
    on the host and its device table, L, C, aabb, 2 aabb, bf16."""
    operand = lines.to(torch.bfloat16).contiguous() if _bf16(dtype) else lines
    if operand.device.type == "cuda" and operand.data_ptr() % 16:
        operand = operand.clone()  # the forward's vector loads start on 16 B
    res, c_res, table = _geometry(cfg.fac_levels, cfg.fac_base_res, cfg.fac_max_res,
                                  cfg.fac_comps, cfg.fac_aabb)
    aabb = float(cfg.fac_aabb)
    return (operand, c_res, build.device_table(table, operand.device, torch.int32).data_ptr(),
            len(res),
            cfg.fac_comps, aabb, 2.0 * aabb, int(_bf16(dtype)))


def _raise_on(rc: int, lib, what: str) -> None:
    if rc < 0:
        raise ValueError(f"fused_factored {what} kernel refused the call: {_ERRORS[rc]}")
    if rc > 0:
        msg = lib.nerf_cuda_error_string(rc).decode()
        raise RuntimeError(f"fused_factored {what} kernel launch failed: CUDA error {rc} ({msg})")


def fused_factored_encode_forward(lines: torch.Tensor, points: torch.Tensor,
                                  cfg: ModelConfig, dtype=None) -> torch.Tensor:
    """The forward alone: lines (3, sumR, C) f32 and points (N, 3) f32
    -> enc (N, C) f32. Launches the forward kernel for CUDA tensors
    (counted in ``fused_factored_encode.launches``), on the current
    stream without synchronising; runs the plain version for CPU
    tensors. Any N: the kernel masks the ragged last block."""
    _check(lines, points, cfg)
    if points.device.type == "cpu":
        return fused_factored_encode_reference(lines, points, cfg, dtype)
    if points.device.type != "cuda":
        raise ValueError(f"no kernel for device {points.device}")
    dev = points.device
    _check_cuda((("points", points), ("lines", lines)), dev)
    n = points.shape[0]
    enc = torch.empty(n, cfg.fac_comps, device=dev)
    operand, *geom = _launch_args(lines, cfg, dtype)
    lib = _library()
    rc = lib.nerf_factored_encode_fwd(points.data_ptr(), operand.data_ptr(), enc.data_ptr(), n,
                                      *geom, torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, lib, "forward")
    fused_factored_encode.launches += 1
    return enc


def fused_factored_encode_backward(lines: torch.Tensor, points: torch.Tensor, g: torch.Tensor,
                                   cfg: ModelConfig, dtype=None) -> torch.Tensor:
    """The backward: the cotangent g (N, C) of the encoding -> d_lines
    (3, sumR, C) f32. Launches the backward's three kernels (d_feat, the
    scatter -- on the tensor cores under a bf16 ``dtype`` -- and the
    fixed-order reduction) for CUDA tensors, counted once in
    ``fused_factored_encode_backward.launches``; two calls on the same
    inputs give identical bits, and nothing waits on the host. Runs the
    plain version for CPU tensors."""
    _check(lines, points, cfg, g)
    if points.device.type == "cpu":
        return fused_factored_encode_backward_reference(lines, points, g, cfg, dtype)
    if points.device.type != "cuda":
        raise ValueError(f"no kernel for device {points.device}")
    dev = points.device
    _check_cuda((("points", points), ("lines", lines), ("g", g)), dev)
    if g.data_ptr() % 16:
        g = g.clone()  # the d_feat kernel's vector loads start on 16 B
    n = points.shape[0]
    d_lines = torch.empty(lines.shape, device=dev)
    operand, res, levels, L, C, aabb, two_aabb, bf16 = _launch_args(lines, cfg, dtype)
    lib = _library()
    # d_feat and the per-CTA partial tables; freed on return while the
    # kernels may still run, which is safe: the caching allocator hands the
    # block out again only in this stream's order
    nbytes = lib.nerf_factored_bwd_scratch_bytes(n, basis_dim(cfg), C, bf16)
    if nbytes < 0:
        raise RuntimeError("fused_factored backward: no CUDA device to size its scratch for")
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    rc = lib.nerf_factored_encode_bwd(
        points.data_ptr(), operand.data_ptr(), g.data_ptr(), d_lines.data_ptr(),
        scratch.data_ptr(), n, res, levels, L, C, aabb, two_aabb, bf16,
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, lib, "backward")
    fused_factored_encode_backward.launches += 1
    return d_lines


def fused_factored_dfeat(lines: torch.Tensor, points: torch.Tensor, g: torch.Tensor,
                         cfg: ModelConfig, dtype=None) -> torch.Tensor:
    """The backward's first kernel alone: d_feat (3, N, stride),
    d_feat[a] = (g * f_b) * f_c, bf16 under a bf16 ``dtype`` with
    C padded by zero columns to the plan's stride, else f32 (stride
    C). For tests and timing; the backward launches it itself. Not
    counted in the launch counters; CUDA tensors only (the plain d_feat is
    ``fused_factored_dfeat_reference``)."""
    _check(lines, points, cfg, g)
    if points.device.type != "cuda":
        raise ValueError(f"no d_feat kernel for device {points.device}")
    dev = points.device
    _check_cuda((("points", points), ("lines", lines), ("g", g)), dev)
    if g.data_ptr() % 16:
        g = g.clone()
    n = points.shape[0]
    operand, res, levels, L, C, aabb, two_aabb, bf16 = _launch_args(lines, cfg, dtype)
    lib = _library()
    plan = (ctypes.c_int * 6)()
    lib.nerf_factored_bwd_plan(n, basis_dim(cfg), C, bf16, 1, plan)
    stride = plan[0]
    d = torch.empty(3, n, stride, dtype=torch.bfloat16 if bf16 else torch.float32, device=dev)
    rc = lib.nerf_factored_dfeat(points.data_ptr(), operand.data_ptr(), g.data_ptr(), d.data_ptr(),
                                 n, res, levels, L, C, aabb, two_aabb, bf16, stride,
                                 torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, lib, "d_feat")
    return d


class _Encode(torch.autograd.Function):
    """enc = K3(lines, points); d lines from the backward kernel (or its
    plain version on the CPU), no gradient for the points."""

    @staticmethod
    def forward(ctx, lines, points, cfg, dtype):
        ctx.save_for_backward(lines, points)
        ctx.cfg, ctx.dtype = cfg, dtype
        return fused_factored_encode_forward(lines, points, cfg, dtype)

    @staticmethod
    def backward(ctx, g):
        lines, points = ctx.saved_tensors
        d_lines = fused_factored_encode_backward(lines, points, g.contiguous(), ctx.cfg,
                                                 ctx.dtype)
        return d_lines, None, None, None


def fused_factored_encode(lines: torch.Tensor, points: torch.Tensor, cfg: ModelConfig,
                          dtype=None) -> torch.Tensor:
    """(..., 3) world points -> (..., C) f32 CP-product features, the
    drop-in for ``models/factored.factored_encode`` through K3, with the
    lines' gradient from K3's backward."""
    lead = points.shape[:-1]
    enc = _Encode.apply(lines, points.reshape(-1, 3).contiguous(), cfg, dtype)
    return enc.reshape(*lead, cfg.fac_comps)


# kernel launches so far in this process (forward; backward); a run reads
# them to show that its path went through the kernels
fused_factored_encode.launches = 0
fused_factored_encode_backward.launches = 0


def _library() -> ctypes.CDLL:
    lib = build.load("fused_factored")
    fwd = lib.nerf_factored_encode_fwd
    if fwd.argtypes is None:
        vp, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        pres = ctypes.POINTER(i32)
        fwd.argtypes = [vp] * 3 + [i64, pres, vp, i32, i32, f32, f32, i32, vp]
        fwd.restype = i32
        bwd = lib.nerf_factored_encode_bwd
        bwd.argtypes = [vp] * 5 + [i64, pres, vp, i32, i32, f32, f32, i32, vp]
        bwd.restype = i32
        staged = lib.nerf_factored_fwd_staged_levels
        staged.argtypes = [pres, i32, i32, i32]
        staged.restype = i32
        size = lib.nerf_factored_bwd_scratch_bytes
        size.argtypes = [i64, i32, i32, i32]
        size.restype = i64
        plan = lib.nerf_factored_bwd_plan
        plan.argtypes = [i64, i32, i32, i32, i32, pres]
        plan.restype = None
        dfeat = lib.nerf_factored_dfeat
        dfeat.argtypes = [vp] * 4 + [i64, pres, vp, i32, i32, f32, f32, i32, i32, vp]
        dfeat.restype = i32
        lib.nerf_cuda_error_string.argtypes = [i32]
        lib.nerf_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _round(x: torch.Tensor, dtype) -> torch.Tensor:
    """The kernels' rounding point: to bf16 and back under a bf16
    ``dtype``, else nothing."""
    return x.to(torch.bfloat16).float() if _bf16(dtype) else x


def _plain_features(lines, u, cfg, dtype, dense=False):
    """The three axis features (N, C) of the plain versions: per level
    the two knots around u R (k0 = floor(u R), at most R - 1, so a point
    on the upper face reads (R - 1, weight 0) and (R, weight 1)), their
    hat weights (rounded as the kernel rounds) times the rounded line rows,
    added in f32 in level order, k0's tap first, as the kernels add them.
    ``dense``: the JAX kernel's form instead, the dense hat matrix times
    the lines (the same function, its other entries zero, summed in
    another order; on CUDA it needs full-f32 matmuls,
    ``torch.backends.cuda.matmul.allow_tf32 = False``)."""
    res = fac_resolutions(cfg)
    feats = []
    for a in range(3):
        la = _round(lines[a].float(), dtype)
        parts = []
        for i in range(0, max(u.shape[0], 1), PLAIN_CHUNK):
            ua = u[i:i + PLAIN_CHUNK, a]
            if dense:
                parts.append(_round(hat_weights(ua, cfg), dtype) @ la)
                continue
            f = torch.zeros(ua.shape[0], la.shape[1], device=la.device)
            off = 0
            for r in res:
                pos = ua * float(r)
                k0 = torch.clamp(torch.floor(pos), max=r - 1)
                w0 = _round(torch.clamp(1.0 - torch.abs(pos - k0), min=0.0), dtype)
                w1 = _round(torch.clamp(1.0 - torch.abs(pos - (k0 + 1.0)), min=0.0), dtype)
                row = off + k0.long()
                f = f + w0[:, None] * la[row]
                f = f + w1[:, None] * la[row + 1]
                off += r + 1
            parts.append(f)
        feats.append(torch.cat(parts))
    return feats


def fused_factored_encode_reference(lines: torch.Tensor, points: torch.Tensor,
                                    cfg: ModelConfig, dtype=None,
                                    dense: bool = False) -> torch.Tensor:
    """The forward kernel's plain PyTorch version: enc (N, C) f32 =
    X * Y * Z of the f32 products of the rounded operands (``dense``: the
    features by the dense hat product, ``_plain_features``)."""
    _check(lines, points, cfg)
    if points.shape[0] == 0:
        return lines.new_zeros(0, cfg.fac_comps)
    f = _plain_features(lines.detach(), unit_coords(points, cfg.fac_aabb), cfg, dtype, dense)
    return f[0] * f[1] * f[2]


def fused_factored_dfeat_reference(lines: torch.Tensor, points: torch.Tensor, g: torch.Tensor,
                                   cfg: ModelConfig, dtype=None,
                                   dense: bool = False) -> torch.Tensor:
    """The plain d_feat (3, N, C) f32: d_feat[a] = round((g * f_b) * f_c),
    the JAX kernel's order, with f_b, f_c the plain versions' features."""
    _check(lines, points, cfg, g)
    f = _plain_features(lines.detach(), unit_coords(points, cfg.fac_aabb), cfg, dtype, dense)
    return torch.stack([_round((g.float() * f[b]) * f[c], dtype)
                        for b, c in ((1, 2), (0, 2), (0, 1))])


def _plain_scatter(d_feat: torch.Tensor, points: torch.Tensor, cfg: ModelConfig,
                   dtype) -> torch.Tensor:
    """d_lines[a] = W_a^T d_feat[a], the rounded hat weights times d_feat
    summed in f32, PLAIN_CHUNK points at a time in order."""
    u = unit_coords(points, cfg.fac_aabb)
    d_lines = torch.zeros(3, basis_dim(cfg), cfg.fac_comps, device=d_feat.device)
    for a in range(3):
        for i in range(0, u.shape[0], PLAIN_CHUNK):
            w = _round(hat_weights(u[i:i + PLAIN_CHUNK, a], cfg), dtype)
            d_lines[a] += w.t() @ d_feat[a, i:i + PLAIN_CHUNK]
    return d_lines


def fused_factored_encode_backward_reference(lines: torch.Tensor, points: torch.Tensor,
                                             g: torch.Tensor, cfg: ModelConfig,
                                             dtype=None, dense: bool = False) -> torch.Tensor:
    """The backward kernel's plain PyTorch version: d_lines[a] = W_a^T
    round((g * f_b) * f_c), f32 products of the rounded operands summed
    in f32, PLAIN_CHUNK points at a time in order (``dense``: the
    features by the dense hat product)."""
    return _plain_scatter(fused_factored_dfeat_reference(lines, points, g, cfg, dtype, dense),
                          points, cfg, dtype)


def dense_order_gap(lines: torch.Tensor, points: torch.Tensor, g: torch.Tensor,
                    cfg: ModelConfig, dtype=None):
    """How far the backward may stand from the dense product's plain
    version by the order of the features' sums alone: the d_feat elements
    that the two orders round to different values, |the difference|
    scattered with the (non-negative) hat weights. Returns (the dense
    plain d_lines, that bound per element, the number of d_feat elements
    that differ)."""
    flips = (fused_factored_dfeat_reference(lines, points, g, cfg, dtype, dense=True)
             - fused_factored_dfeat_reference(lines, points, g, cfg, dtype)).abs()
    return (fused_factored_encode_backward_reference(lines, points, g, cfg, dtype, dense=True),
            _plain_scatter(flips, points, cfg, dtype), int((flips > 0).sum()))
