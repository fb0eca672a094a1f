"""K3's backward layouts, on the CPU (csrc/fused_factored.cu,
kernels/fused_factored.py):

* the plan (``bwd_plan``): C padded to whole 8-channel tiles in groups of
  at most MMA_MAX_TILES, 16-row blocks in slabs of MMA_WARPS x MMA_BLOCKS,
  as many point ranges as give every SM one CTA; ``warp_blocks`` gives
  every block of an axis to exactly one warp of one slab;
* kernel A's d_feat: the three features summed level by level as the
  forward sums them, then (g * f_b) * f_c in the JAX kernel's order,
  rounded to bf16;
* kernel B's fragments: the A fragment each lane builds from a step's taps
  (a prmt on two points' tap words) holds the hat matrix W^T's elements
  of its rows and points, in blocks that straddle two or three levels and
  for clipped points (u = 0 and u = 1) too; the B fragment ldmatrix.trans
  gives each lane from the padded d_feat tile holds D's, and the padding
  puts the 8 rows of each 8x8 matrix in 8 different bank groups;
* the skip rule: a step's band at a level never misses a block that holds
  one of the step's taps, and on ray-ordered points it skips most of the
  fine levels' blocks;
* the whole backward emulated (per block and tile the reached steps'
  products, each tile's sum added to an f32 table, the point ranges'
  tables reduced in order) against the plain version and the JAX kernel
  in interpret mode.

The kernels themselves need the card: tests/test_torch_cuda.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_rs_tpu import config as jconfig
from nerf_rs_tpu.kernels import fused_factored as jk3
from nerf_rs_tpu_torch.config import ModelConfig
from nerf_rs_tpu_torch.kernels import fused_factored as k3
from nerf_rs_tpu_torch.models import factored as fac

torch.set_num_threads(2)

SMALL = ModelConfig(arch="factored", fac_levels=3, fac_base_res=4, fac_max_res=16,
                    fac_comps=8, fac_aabb=1.0)
# aabb 2: the JAX kernel in interpret mode multiplies by 1 / (2 aabb), which
# is exact only there (tests/test_torch_factored.py)
MAIN = ModelConfig(arch="factored", fac_aabb=2.0)  # sumR 1,014, C 48
WIDTHS = {"small": SMALL, "main": MAIN}
SMS = 132  # an H100's SMs


def _bf16(x) -> np.ndarray:
    return torch.from_numpy(np.asarray(x, np.float32)).bfloat16().float().numpy()


def _bf16_bits(x) -> np.ndarray:
    return torch.from_numpy(np.asarray(x, np.float32)).bfloat16().view(torch.int16).numpy() \
        .astype(np.uint16).astype(np.uint32)


def _points(cfg, n, order, seed=0):
    """n points of rays of 128 samples each, a ray at a time as the main
    path lays them out, or shuffled; the first four on the AABB's faces and
    past it (u = 0 and u = 1 exactly)."""
    rng = np.random.default_rng(seed)
    a = cfg.fac_aabb
    rays = -(-n // 128)
    o = rng.uniform(-0.2 * a, 0.2 * a, (rays, 1, 3))
    d = rng.normal(size=(rays, 1, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t = np.sort(rng.uniform(0.0, 2.5 * a, (rays, 128, 1)), axis=1)
    p = (o + t * d).reshape(-1, 3)[:n].astype(np.float32)
    p[:4] = np.float32([[a, -a, a], [2 * a, -2 * a, 0.0], [-a, 0.5 * a, 3 * a], [0.0, a, -a]])
    if order == "shuffled":
        p = p[rng.permutation(n)]
    return p


def _inputs(cfg, n, order, seed=0):
    rng = np.random.default_rng(seed + 1)
    lines = (0.5 * rng.normal(size=(3, fac.basis_dim(cfg), cfg.fac_comps))).astype(np.float32)
    g = rng.normal(size=(n, cfg.fac_comps)).astype(np.float32)
    return lines, _points(cfg, n, order, seed), g


def _unit(p, cfg) -> np.ndarray:
    a = np.float32(cfg.fac_aabb)
    return np.clip((p + a) / np.float32(2 * cfg.fac_aabb), 0, 1).astype(np.float32)


def _taps(u, cfg):
    """make_tap for every level: (L, N) knot rows and the bf16 weights."""
    rows, w0, w1, off = [], [], [], 0
    for r in fac.fac_resolutions(cfg):
        pos = (u * np.float32(r)).astype(np.float32)
        k0 = np.minimum(np.floor(pos), r - 1).astype(np.int64)
        w0.append(_bf16(np.maximum(np.float32(1) - np.abs(pos - k0.astype(np.float32)), 0)))
        w1.append(_bf16(np.maximum(np.float32(1) - np.abs(pos - (k0 + 1).astype(np.float32)),
                                   0)))
        rows.append(off + k0)
        off += r + 1
    return np.stack(rows), np.stack(w0), np.stack(w1)


def _level_of(r, cfg) -> int:
    off = np.cumsum([0] + [x + 1 for x in fac.fac_resolutions(cfg)])
    return int(np.searchsorted(off, r, side="right") - 1)


def _features(lines, u, cfg) -> list:
    """Kernel A's features: level by level, w0 v0 then w1 v1, in f32 (each
    product of two bf16 values exact, so the fused multiply-add's sum)."""
    lb = _bf16(lines)
    feats = []
    for a in range(3):
        rows, w0, w1 = _taps(u[:, a], cfg)
        f = np.zeros((u.shape[0], cfg.fac_comps), np.float32)
        for lv in range(rows.shape[0]):
            f = f + w0[lv, :, None] * lb[a][rows[lv]]
            f = f + w1[lv, :, None] * lb[a][rows[lv] + 1]
        feats.append(f.astype(np.float32))
    return feats


def _dfeat(g, feats) -> np.ndarray:
    """Kernel A's d_feat (3, N, C): (g * f_b) * f_c, then bf16."""
    return np.stack([_bf16((g * feats[b]) * feats[c]) for b, c in ((1, 2), (0, 2), (0, 1))])


def _dense_hat(u_axis, cfg) -> np.ndarray:
    """W (N, sumR) as the plain version forms it, rounded to bf16."""
    return _bf16(fac.hat_weights(torch.from_numpy(u_axis), cfg).numpy())


# ---- the plan ----



@pytest.mark.parametrize("n,sum_r,comps,bf16,want", [
    (524_288, 1014, 48, True, k3.BwdPlan(48, 6, 1, 2, 22, 94)),
    (524_288, 1014, 48, False, k3.BwdPlan(48, 0, 1, 1, 44, 187)),
    (100_003, 7602, 8, True, k3.BwdPlan(8, 1, 1, 15, 2, 196)),
    (37, 31, 8, True, k3.BwdPlan(8, 1, 1, 1, 1, 1)),
    (1000, 1014, 12, True, k3.BwdPlan(16, 2, 1, 2, 4, 1)),
    (1000, 1014, 100, True, k3.BwdPlan(120, 5, 3, 2, 4, 1)),
])
def test_plan_pads_channels_and_fills_the_card(n, sum_r, comps, bf16, want):
    plan = k3.bwd_plan(n, sum_r, comps, bf16, SMS)
    assert plan == want
    units = -(-n // (k3.TILE_POINTS if bf16 else k3.WALK_POINTS))
    assert plan.ranges * plan.per >= units > (plan.ranges - 1) * plan.per
    if bf16:
        assert plan.stride == plan.groups * plan.nt * 8 >= comps > plan.stride - 8 * plan.groups
        assert plan.nt <= k3.MMA_MAX_TILES
        assert 3 * plan.slabs * plan.groups * plan.ranges <= max(SMS, 3 * plan.slabs * plan.groups)


# (levels, channels): the channel tiles of a group, the levels of a run
_RUNS = {(1, 48): (6, 1), (6, 48): (6, 6), (20, 48): (6, 17), (47, 48): (6, 17),
         (48, 48): (6, 17), (100, 48): (6, 17), (256, 48): (6, 17), (20, 8): (1, 20),
         (47, 8): (1, 47), (100, 16): (2, 40), (6, 192): (6, 6)}


@pytest.mark.parametrize("levels,comps", list(_RUNS))
def test_level_runs_cover_every_level_once_and_fit_a_cta(levels, comps):
    """The tensor-core scatter's runs of levels (``level_run``): the plan's
    channel groups of at most six 8-channel tiles whatever the levels; one
    run of all of them where their taps and bands (4,352 B a level) fit
    beside the group's tiles (the preset's 6 x 48), else runs of the most
    that fit (17 at six tiles, 47 at one), each CTA within the card's 227
    KB, the runs covering every level once."""
    cfg = ModelConfig(arch="factored", fac_levels=levels, fac_comps=comps)
    plan = k3.bwd_plan(524_288, fac.basis_dim(cfg), comps, True, SMS)
    run = k3.level_run(plan.nt, levels)
    assert (plan.nt, run) == _RUNS[levels, comps]
    assert plan.groups == -(-comps // (8 * k3.MMA_MAX_TILES))
    assert plan.stride == plan.groups * plan.nt * 8 >= comps
    assert run == levels or k3._mma_smem_bytes(plan.nt, run + 1) > k3._SMEM
    starts = list(range(0, levels, run))
    covered = [l for l0 in starts for l in range(l0, min(levels, l0 + run))]
    assert covered == list(range(levels))
    assert all(k3._mma_smem_bytes(plan.nt, min(levels, l0 + run) - l0) <= k3._SMEM
               for l0 in starts)
    assert k3._mma_smem_bytes(1, k3.MMA_RUN_LEVELS + 1) > k3._SMEM


@pytest.mark.parametrize("geometry", ["main", "table past a CTA", "levels 100",
                                      "60,001 knots", "two wide levels"])
def test_walk_tiles_cover_every_row_once_and_fit_a_cta(geometry):
    """The f32 scatter's tiles (``walk_tiles``): every row of the table in
    exactly one tile, each tile's table, taps and chunk within 227 KB; a
    table that fits is one tile of every level and column (the main width),
    whole levels stay whole where one column of them fits, and only a level
    wider than a CTA is cut into runs of rows (60,001 knots: two runs of one
    column, the first of ROW_CAP rows)."""
    kw = {"main": {}, "table past a CTA": dict(fac_levels=2, fac_base_res=2600,
                                               fac_max_res=5000, fac_comps=8),
          "levels 100": dict(fac_levels=100, fac_comps=16),
          "60,001 knots": dict(fac_levels=1, fac_base_res=60000, fac_comps=4),
          "two wide levels": dict(fac_levels=2, fac_base_res=30000, fac_max_res=130000,
                                  fac_comps=2)}[geometry]
    cfg = ModelConfig(arch="factored", **kw)
    res = fac.fac_resolutions(cfg)
    tiles = k3.walk_tiles(res, cfg.fac_comps)
    rows = k3.walk_tile_rows(tiles, res)
    seen = [r for r0, n, _ in rows for r in range(r0, r0 + n)]
    assert seen == list(range(fac.basis_dim(cfg)))
    assert all(k3._walk_smem_bytes(n, nl, tiles.cw) <= k3._SMEM for _, n, nl in rows)
    cut = len(rows) > len(tiles.first) - 1  # a level group in more than one tile
    if geometry == "main":
        assert len(rows) == 1 and tiles.cw == cfg.fac_comps
    if geometry == "60,001 knots":
        assert tiles.cw == 1 and tiles.row_cap == 57_856 and [n for _, n, _ in rows] == [
            57_856, 60_001 - 57_856]
    assert cut == (geometry in ("60,001 knots", "two wide levels"))


def test_row_runs_of_a_level_scatter_what_the_level_scatters():
    """The f32 scatter's rule in a run of rows: a tap whose row lies outside
    the run is dropped there, so the runs of a level (here of 7 rows, the
    taps of 300 points on a level of 21 knots, clipped points included)
    assemble to the whole level's scatter bit for bit (each row's adds in
    point order on both sides)."""
    rng = np.random.default_rng(4)
    res, comps = 20, 3
    u = np.clip(rng.uniform(-0.1, 1.1, 300), 0, 1).astype(np.float32)
    pos = u * np.float32(res)
    k0 = np.minimum(np.floor(pos).astype(np.int64), res - 1)
    w0 = np.maximum(1 - np.abs(pos - k0), 0).astype(np.float32)
    w1 = np.maximum(1 - np.abs(pos - (k0 + 1)), 0).astype(np.float32)
    d = rng.normal(size=(300, comps)).astype(np.float32)
    whole = np.zeros((res + 1, comps), np.float32)
    for p in range(300):
        whole[k0[p]] += w0[p] * d[p]
        whole[k0[p] + 1] += w1[p] * d[p]
    tiles = k3.WalkTiles((0, 1), comps, 7)
    runs = np.zeros_like(whole)
    for r0, n, _ in k3.walk_tile_rows(tiles, [res]):
        table = np.zeros((n, comps), np.float32)
        for p in range(300):
            row = k0[p] - r0
            if 0 <= row < n:
                table[row] += w0[p] * d[p]
            if 0 <= row + 1 < n:
                table[row + 1] += w1[p] * d[p]
        runs[r0:r0 + n] = table
    assert len(k3.walk_tile_rows(tiles, [res])) == 3
    np.testing.assert_array_equal(runs, whole)


@pytest.mark.parametrize("sum_r", [1, 17, 31, 1014, 1024, 1025, 7602])
def test_every_block_has_one_warp(sum_r):
    blocks = -(-sum_r // 16)
    slabs = -(-blocks // (k3.MMA_WARPS * k3.MMA_BLOCKS))
    owned = [b for s in range(slabs) for w in range(k3.MMA_WARPS)
             for b in k3.warp_blocks(s, w, slabs, sum_r) if b >= 0]
    assert sorted(owned) == list(range(blocks))


# ---- kernel A ----


@pytest.mark.parametrize("width", ["small", "main"])
def test_dfeat_keeps_the_jax_order_and_rounding(width):
    """Kernel A's features are the plain version's up to the order of
    their f32 sums; its d_feat is the JAX kernel's formula, (g * f_b) *
    f_c rounded to bf16, bit for bit on the same features (another order
    of the f32 products gives other bits), and the plain d_feat's within
    one bf16 step."""
    cfg = WIDTHS[width]
    lines, pts, g = _inputs(cfg, 1000, "ray")
    u = _unit(pts, cfg)
    feats = _features(lines, u, cfg)
    plain = k3._plain_features(torch.from_numpy(lines), torch.from_numpy(u), cfg,
                               torch.bfloat16)
    for f, want in zip(feats, plain):
        np.testing.assert_allclose(f, want.numpy(), rtol=0, atol=1e-5 * np.abs(f).max())
    d = _dfeat(g, feats)
    for a, (b, c) in enumerate(((1, 2), (0, 2), (0, 1))):
        jf = [jnp.asarray(x) for x in feats]
        want = np.asarray((jnp.asarray(g) * jf[b] * jf[c]).astype(jnp.bfloat16)).astype(np.float32)
        np.testing.assert_array_equal(d[a], want)
        assert not np.array_equal((g * feats[b]) * feats[c], g * (feats[b] * feats[c]))
    ref = k3.fused_factored_dfeat_reference(torch.from_numpy(lines), torch.from_numpy(pts),
                                            torch.from_numpy(g), cfg, torch.bfloat16).numpy()
    assert np.all(np.abs(d - ref) <= 2.0 ** -7 * np.abs(ref))


def test_dfeat_kernel_takes_cuda_tensors_only():
    """The d_feat kernel's wrapper has no CPU mode: it names the plain
    version instead of quietly running it."""
    lines, pts, g = (torch.from_numpy(x) for x in _inputs(SMALL, 8, "ray"))
    with pytest.raises(ValueError, match="no d_feat kernel"):
        k3.fused_factored_dfeat(lines, pts, g, SMALL, torch.bfloat16)
    assert k3.fused_factored_dfeat_reference(lines, pts, g, SMALL).shape == (3, 8, 8)


# ---- kernel B's fragments ----


def _prmt(a: int, b: int, sel: int) -> int:
    """PTX prmt.b32 (default mode): result byte k is source byte sel[k] & 7
    of {b, a}, or that byte's sign replicated when sel[k] & 8."""
    src = [(a >> (8 * i)) & 0xff for i in range(4)] + [(b >> (8 * i)) & 0xff for i in range(4)]
    out = 0
    for k in range(4):
        nib = (sel >> (4 * k)) & 0xf
        v = src[nib & 7]
        if nib & 8:
            v = 0xff if v & 0x80 else 0
        out |= v << (8 * k)
    return out


def _hat_pair(r: int, t) -> int:
    """hat_pair: the bf16 pair of W^T's (row r; two points) from the two
    points' (row, w, row, w) tap words."""
    d0, d1 = (r - int(t[0])) & 0xffffffff, (r - int(t[2])) & 0xffffffff
    sel = (0x10 + 0x22 * d0 if d0 < 2 else 0x99) | (0x5400 + 0x2200 * d1 if d1 < 2 else 0xdd00)
    return _prmt(int(t[1]), int(t[3]), sel)


def _tap_words(u_axis, cfg, n_pad):
    """The tile's taps as the kernel stores them, (L, n_pad) rows and
    words (bf16 w0 low, w1 high); a point past N has row -2 and weight 0."""
    rows, w0, w1 = _taps(u_axis, cfg)
    n = u_axis.shape[0]
    r = np.full((rows.shape[0], n_pad), -2, np.int64)
    w = np.zeros((rows.shape[0], n_pad), np.uint32)
    r[:, :n] = rows
    w[:, :n] = _bf16_bits(w0) | (_bf16_bits(w1) << 16)
    return r, w


def _a_fragment(rows, words, r0, s, cfg):
    """The 16 x 16 (rows r0.., points 16 s..) block each lane's A fragment
    holds, by the PTX layout of mma.m16n8k16's A: register k of lane
    (gid, q) holds rows gid (k even) or gid + 8 (k odd) and points 2q, 2q
    + 1 (k < 2) or 2q + 8, 2q + 9 (k >= 2), the first in the low half."""
    sum_r = fac.basis_dim(cfg)
    block = np.zeros((16, 16), np.uint32)
    for lane in range(32):
        gid, q = lane // 4, lane % 4
        la = _level_of(min(r0 + gid, sum_r - 1), cfg)
        lb = _level_of(min(r0 + gid + 8, sum_r - 1), cfg)

        def quad(lv, p):  # the kernel's 16 B load: taps of points p, p + 1
            return rows[lv, p], words[lv, p], rows[lv, p + 1], words[lv, p + 1]
        p0 = 16 * s
        regs = [_hat_pair(r0 + gid, quad(la, p0 + 2 * q)), _hat_pair(r0 + gid + 8,
                                                                     quad(lb, p0 + 2 * q)),
                _hat_pair(r0 + gid, quad(la, p0 + 2 * q + 8)),
                _hat_pair(r0 + gid + 8, quad(lb, p0 + 2 * q + 8))]
        for k, v in enumerate(regs):
            row, col = gid + 8 * (k % 2), 2 * q + 8 * (k // 2)
            block[row, col], block[row, col + 1] = v & 0xffff, v >> 16
    return (block << 16).view(np.float32)


@pytest.mark.parametrize("width", ["small", "main"])
def test_a_fragment_holds_the_hat_matrix(width):
    """Every lane's A fragment, as the kernel builds it from the taps, is
    W^T's block: the rows' levels from off[] (blocks straddling two or
    three levels), clipped points' taps (R - 1, 0) and (R, 1), the ragged
    step's points past N all zero."""
    cfg = WIDTHS[width]
    n = 45
    _, pts, _ = _inputs(cfg, n, "ray")
    u = _unit(pts, cfg)
    assert {0.0, 1.0} <= set(u[:4].ravel().tolist())
    sum_r = fac.basis_dim(cfg)
    for a in range(3):
        rows, words = _tap_words(u[:, a], cfg, 48)
        wt = np.zeros((-(-sum_r // 16) * 16, 48), np.float32)
        wt[:sum_r, :n] = _dense_hat(u[:, a], cfg).T
        for b in range(-(-sum_r // 16)):
            for s in range(3):
                np.testing.assert_array_equal(_a_fragment(rows, words, 16 * b, s, cfg),
                                              wt[16 * b:16 * b + 16, 16 * s:16 * s + 16])
    straddling = [b for b in range(-(-sum_r // 16))
                  if _level_of(16 * b, cfg) != _level_of(min(16 * b + 15, sum_r - 1), cfg)]
    assert straddling  # the test reached blocks of two levels


@pytest.mark.parametrize("comps", [8, 16, 24, 48])
def test_b_fragment_is_the_dfeat_tile(comps):
    """ldmatrix.x4.trans from the kernel's addresses (lane l: matrix m = l /
    8, row l % 8 of point 16 s + 8 (m % 2) + l % 8, channels 8 (t + m / 2))
    gives each lane its B fragments of n-tiles t and t + 1 (b0 b1: points
    2q, 2q + 1 of channel gid; b2 b3: points 2q + 8, 2q + 9), from rows
    padded to an odd number of 16 B units, so that each matrix's 8 rows lie
    in 8 different bank groups."""
    nt = comps // 8
    row = (nt if nt % 2 else nt + 1) * 8  # MmaLayout::kRow
    rng = np.random.default_rng(3)
    tile = rng.integers(0, 2 ** 16, (k3.TILE_POINTS, row)).astype(np.uint32)
    for s in (0, 5, k3.TILE_POINTS // 16 - 1):
        for t in range(0, nt, 2):
            mats = []
            for m in range(4 if t + 1 < nt else 2):
                addr = [((16 * s + 8 * (m % 2) + i) * row + 8 * (t + m // 2)) for i in range(8)]
                assert len({(x * 2 // 16) % 8 for x in addr}) == 8  # no bank conflict
                mats.append(np.stack([tile[x // row, x % row:x % row + 8] for x in addr]))
            for lane in range(32):
                gid, q = lane // 4, lane % 4
                # .trans: lane gets (row 2q, col gid) and (row 2q + 1, col gid)
                got = [(mt[2 * q, gid], mt[2 * q + 1, gid]) for mt in mats]
                for j, (lo_, hi_) in enumerate(got):
                    nt_j, half = t + j // 2, j % 2
                    k = 2 * q + 8 * half
                    want = tile[16 * s + k:16 * s + k + 2, 8 * nt_j + gid]
                    assert (lo_, hi_) == tuple(want)


# ---- the skip rule ----


def _bands(rows, n, cfg):
    """Each step's band at each level: (L, steps, 2) of [min row, max row +
    1] over its points before N; (huge, -huge) for a step past N."""
    lv, n_pad = rows.shape
    steps = n_pad // 16
    valid = (np.arange(n_pad) < n).reshape(steps, 16)
    r = rows.reshape(lv, steps, 16)
    lo = np.where(valid, r, 0x3fffffff).min(-1)
    hi = np.where(valid, r + 1, -0x3fffffff).max(-1)
    return np.stack([lo, hi], -1)


def _reached(bands, cfg):
    """(blocks, steps): block b's steps whose band at a level of the block
    meets rows [16 b, 16 b + 15]."""
    sum_r = fac.basis_dim(cfg)
    blocks = -(-sum_r // 16)
    out = np.zeros((blocks, bands.shape[1]), bool)
    for b in range(blocks):
        r0 = 16 * b
        for lv in range(_level_of(r0, cfg), _level_of(min(r0 + 15, sum_r - 1), cfg) + 1):
            out[b] |= (bands[lv, :, 0] <= r0 + 15) & (bands[lv, :, 1] >= r0)
    return out


@pytest.mark.parametrize("order", ["ray", "shuffled"])
@pytest.mark.parametrize("width", ["small", "main"])
def test_skip_rule_never_drops_a_tap(width, order):
    """A block a step skips holds none of its taps (so its products are all
    zero); on ray-ordered points the main width skips most block-steps,
    and the same points shuffled skip fewer."""
    cfg = WIDTHS[width]
    n = 4000
    _, pts, _ = _inputs(cfg, n, order)
    u = _unit(pts, cfg)
    sum_r = fac.basis_dim(cfg)
    n_pad = -(-n // k3.TILE_POINTS) * k3.TILE_POINTS
    blocks = -(-sum_r // 16)
    share = []
    for a in range(3):
        rows, _ = _tap_words(u[:, a], cfg, n_pad)
        reached = _reached(_bands(rows, n, cfg), cfg)
        wt = np.zeros((blocks * 16, n_pad), np.float32)
        wt[:sum_r, :n] = _dense_hat(u[:, a], cfg).T
        holds = (wt.reshape(blocks, 16, n_pad // 16, 16) != 0).any((1, 3))
        # a tap of weight 0 still counts: the step's taps reach the block
        taps = np.zeros_like(holds)
        for lv in range(rows.shape[0]):
            for rr in (rows[lv, :n], rows[lv, :n] + 1):
                taps[rr // 16, np.arange(n) // 16] = True
        assert not (holds & ~reached).any() and not (taps & ~reached).any()
        share.append(reached.mean())
    if width == "main":
        assert (max(share) < 0.4) if order == "ray" else (min(share) > 0.4)


# ---- the whole backward ----


def _emulate_backward(lines, pts, g, cfg, sms=SMS):
    """The three launches' arithmetic in numpy: d_feat (kernel A); per axis,
    point range and tile, each block's reached steps' products summed (the
    tensor cores' inner sum, here in float64, then f32) and added to the
    range's f32 table; the tables reduced in range order."""
    n = pts.shape[0]
    sum_r, comps = fac.basis_dim(cfg), cfg.fac_comps
    plan = k3.bwd_plan(n, sum_r, comps, True, sms)
    u = _unit(pts, cfg)
    d = _dfeat(g, _features(lines, u, cfg))
    tp = k3.TILE_POINTS
    tiles = -(-n // tp)
    blocks = -(-sum_r // 16)
    out = np.zeros((3, sum_r, comps), np.float32)
    for a in range(3):
        wt = np.zeros((blocks * 16, tiles * tp), np.float32)
        wt[:sum_r, :n] = _dense_hat(u[:, a], cfg).T
        rows, _ = _tap_words(u[:, a], cfg, tiles * tp)
        reached = _reached(_bands(rows, n, cfg), cfg)
        mask = np.repeat(np.repeat(reached, 16, 0), 16, 1)
        dd = np.zeros((tiles * tp, comps), np.float64)
        dd[:n] = d[a]
        partials = []
        for r in range(plan.ranges):
            table = np.zeros((blocks * 16, comps), np.float32)
            for t in range(r * plan.per, min((r + 1) * plan.per, tiles)):
                cols = slice(t * tp, (t + 1) * tp)
                tile_sum = (wt[:, cols] * mask[:, cols]).astype(np.float64) @ dd[cols]
                table = (table + tile_sum.astype(np.float32)).astype(np.float32)
            partials.append(table[:sum_r])
        total = np.zeros((sum_r, comps), np.float32)
        for p in partials:
            total = (total + p).astype(np.float32)
        out[a] = total
    return out, plan


@pytest.mark.parametrize("order", ["ray", "shuffled"])
@pytest.mark.parametrize("width", ["small", "main"])
def test_emulated_backward_matches_plain_and_jax(width, order):
    """The emulated kernels (several point ranges, a ragged last tile,
    clipped points) against the plain version and the JAX kernel in
    interpret mode, at the bars of tests/test_torch_factored.py's kernel
    test (rtol 1e-4, atol 1e-5), and per axis within KERNEL_TOL of the
    plain version relative to the axis's largest entry."""
    cfg = WIDTHS[width]
    n = 700
    lines, pts, g = _inputs(cfg, n, order, seed=2)
    got, plan = _emulate_backward(lines, pts, g, cfg, sms=12)
    assert plan.ranges > 1 and n % k3.TILE_POINTS
    want = k3.fused_factored_encode_backward_reference(
        torch.from_numpy(lines), torch.from_numpy(pts), torch.from_numpy(g), cfg,
        torch.bfloat16).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    for a in range(3):
        scale = np.abs(want[a]).max()
        assert scale > 0.1
        assert np.abs(got[a] - want[a]).max() / scale <= k3.KERNEL_TOL["d_lines"]
    jcfg = jconfig.ModelConfig(**dataclasses.asdict(cfg))
    jp = jnp.asarray(pts)
    enc = lambda l: jk3.fused_factored_encode(l, jp, jcfg, jnp.bfloat16, block=128,  # noqa: E731
                                              interpret=True)
    jgrad = np.asarray(jax.grad(lambda l: jnp.sum(enc(l) * g))(jnp.asarray(lines)))
    np.testing.assert_allclose(got, jgrad, rtol=1e-4, atol=1e-5)
