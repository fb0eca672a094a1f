"""K2b, the training kernel's dW reduction (csrc/fused_train.cu,
dw_wgmma_kernel), on the CPU, where no kernel runs: its schedule and its
shared-memory addressing, through the Python mirror in
kernels/fused_train.py (``dw_jobs``, ``dw_splits``, ``dw_launches``,
``dw_ctas``, ``dw_loads``).

- The schedule: at every call shape of the main paths (the flagship call,
  the hierarchical union at S = 192, both blocks of the 300-sample call,
  512/512/256, 1024/256/128 and the padded 40/40/24 and 100/100/50), each
  split's k-blocks tile its rows, every (row, column) of a job's A and G is
  loaded once per split (a multicast G panel once for its whole cluster;
  past 256 columns of G, A once per 256-column block), every dW and bias
  element of a split has exactly one writer, and the bias warps' lanes add
  each bias column's rows once.
- The addressing: TMA's 128-byte-swizzled {64, 64} boxes emulated in numpy,
  read back through the MN-major wgmma descriptors the consumers build
  (start, leading and stride offsets, the hardware's XOR of address bits
  4-6 with bits 7-9), give every A^T and G element where it was written, at
  each stash width the jobs have.
- The sums: the schedule's order emulated in f32 (per k16 step, per split,
  then the splits in order; the bias warps' halves) against ``tmm`` of the
  plain version.
- The C constants equal the mirror's.

The kernel itself is held to the float64 product of its stashes and to the
plain version on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from nerf_rs_tpu_torch.config import ModelConfig
from nerf_rs_tpu_torch.kernels import fused_train as ft
from nerf_rs_tpu_torch.kernels.fused_ray import padded_samples
from nerf_rs_tpu_torch.kernels.fused_render import pack_weights
from nerf_rs_tpu_torch.models.mlp import init_nerf_params

CSRC = Path(ft.__file__).resolve().parent / "csrc"


def _packed(widths, **field):
    w, f, v = widths
    cfg = ModelConfig(net_width=w, feature_width=f, view_head_width=v, **field)
    return pack_weights(init_nerf_params(cfg, 0, "cpu"), cfg)


def _launch_rows(n, s):
    """The rows of each K2 launch of a call on n rays of s samples at the
    default block size: n x the padded S within one block, else each
    ray block's."""
    S = padded_samples(s)
    return [(hi - lo) * S for lo, hi in ft.ray_blocks(n, S)]


# (widths, rays, samples): the call shapes of the main paths and the widths
# the kernels take past and below 256
CALLS = {
    "flagship": ((256, 256, 128), 4096, 64),
    "union 192": ((256, 256, 128), 4096, 192),
    "300 blocked": ((256, 256, 128), 4096, 300),
    "512/512/256": ((512, 512, 256), 4096, 64),
    "1024/256/128": ((1024, 256, 128), 4096, 64),
    "40/40/24": ((40, 40, 24), 4096, 64),
    "100/100/50": ((100, 100, 50), 4096, 64),
}
_SCHEDULES = [(name, rows) for name, (w, n, s) in CALLS.items() for rows in _launch_rows(n, s)]


def test_the_300_sample_call_is_two_blocks():
    assert _launch_rows(4096, 300) == [2730 * 384, 1366 * 384]


@pytest.mark.parametrize("name,rows", _SCHEDULES)
def test_each_split_reads_every_stash_element_once(name, rows):
    """Per split: its k-blocks tile its rows (whole 64-row blocks, none
    crossing into the next split); per job, the A boxes of a cluster's
    CTAs and the G boxes they multicast cover each (row, column) once (A
    once per 256-column block of G where G is wider; G once per cluster of
    the job's m-blocks), and across the jobs each stash is read as many
    times as jobs read it: PE(x) and the skip layer's G twice (the first
    layer and the skip block), g_hv twice (the view head's feature and PE(d)
    blocks), every other stash once."""
    packed = _packed(CALLS[name][0])
    jobs = ft.dw_jobs(packed)
    splits, rps = ft.dw_splits(rows)
    assert rps % ft.DW_ROWS == 0 and (splits - 1) * rps < rows <= splits * rps
    assert splits <= ft.MAX_SPLITS
    reads = {}  # (stash, layer) -> per-column reads of one split
    for launch in ft.dw_ctas(jobs, rows):
        by_split = {}
        for cta in launch:
            by_split.setdefault(cta.split, []).append(cta)
        assert sorted(by_split) == list(range(splits))
        for split, ctas in by_split.items():
            r0, r1 = split * rps, min(rows, (split + 1) * rps)
            assert all((c.r0, c.r1) == (r0, r1) for c in ctas)
            # the k-blocks [r, r + 64) for r in range(r0, r1, 64) end at r1
            # or past the call's rows (TMA fills those with zeros)
            k_end = r0 + ft.DW_ROWS * -(-(r1 - r0) // ft.DW_ROWS)
            assert k_end <= r0 + rps and (k_end == r1 or r1 == rows)
            per_job = {}
            for cta in ctas:
                for stash, layer, c0 in ft.dw_loads(cta):
                    per_job.setdefault(cta.job, []).append((stash, layer, c0))
            for job, boxes in per_job.items():
                for stash, layer, width, times in (
                        (job.a, job.a_layer, job.K, ft.dw_cblocks(job.N)),
                        (job.g, job.g_layer, job.N, -(-job.K // (ft.DW_M * ft.dw_cluster(jobs))))):
                    cols = np.zeros(ft.stash_width(stash, packed) + 64, np.int64)
                    for s_, l_, c0 in boxes:
                        if (s_, l_) == (stash, layer):
                            cols[c0:c0 + 64] += 1
                    assert (cols[:width] == times).all(), (job, stash)
                    if split == 0:
                        key = (stash, layer)
                        reads[key] = reads.get(key, np.zeros(width, np.int64)) + cols[:width]
    want = {key: 1 for key in reads}
    if 0 < packed.skip_layer < packed.depth:
        want[("sx", 0)] = want[("gh", packed.skip_layer)] = 2
    want[("ghv", 0)] = 2
    if packed.W <= ft.DW_N and packed.F + 8 <= ft.DW_N + ft.DW_TAIL:  # no wider G
        for key, cols in reads.items():
            assert (cols == want[key]).all(), key


@pytest.mark.parametrize("name,rows", _SCHEDULES)
def test_each_partial_element_has_one_writer(name, rows):
    """Per split, the live CTAs' dW rows [m0, m0 + 128) x columns [n0, n0 +
    256) (+ the tail's 8), clipped to the job's K x N, and the bias CTAs'
    columns from ``bias_col0`` on, write every element of every job's dW and
    bias slots once and nothing else; a cluster's CTAs past its job's
    m-blocks write nothing."""
    packed = _packed(CALLS[name][0])
    jobs = ft.dw_jobs(packed)
    total = packed.w.numel() + packed.b.numel()
    want = np.zeros(total, np.int32)
    for j in jobs:
        want[j.out:j.out + j.K * j.N] += 1
        if j.bias_out >= 0:
            want[j.bias_out + j.bias_col0:j.bias_out + j.N] += 1
    assert want.max() == 1
    splits, _ = ft.dw_splits(rows)
    by_split = {}
    for launch in ft.dw_ctas(jobs, rows):
        for cta in launch:
            by_split.setdefault(cta.split, []).append(cta)
    assert sorted(by_split) == list(range(splits))
    for split, ctas in by_split.items():
        got = np.zeros(total, np.int32)
        for cta in ctas:
            if cta.rank >= cta.act:
                assert not ft.dw_loads(cta)
                continue
            j = cta.job
            n1 = min(j.N, cta.n0 + ft.DW_N + (ft.DW_TAIL if cta.tail else 0))
            m1 = min(j.K, cta.m0 + ft.DW_M)
            block = got[j.out:j.out + j.K * j.N].reshape(j.K, j.N)
            block[cta.m0:m1, cta.n0:n1] += 1
            if cta.bias:
                rows_of = {}  # (chunk) -> rows of a k-block its lanes add
                for _, c, rr in ft.dw_bias_lanes(cta):
                    rows_of.setdefault(c, []).extend(rr)
                for c, rr in rows_of.items():
                    assert sorted(rr) == list(range(ft.DW_ROWS)), (cta, c)
                    n = cta.n0 + 8 * c
                    got[j.bias_out + n:j.bias_out + min(n + 8, n1)] += 1
        np.testing.assert_array_equal(got, want, err_msg=f"split {split}")


@pytest.mark.parametrize("name,rows", _SCHEDULES)
def test_slot_barriers_count_every_arrival(name, rows):
    """Per cluster: the consumer warpgroups that take part are exactly those
    whose A panel the producer loads (none multiplies a panel left
    unloaded), and every CTA's `empty` barriers count their arrivals: one a
    taking-part warpgroup of the cluster, two from the bias warps."""
    jobs = ft.dw_jobs(_packed(CALLS[name][0]))
    for launch in ft.dw_ctas(jobs, rows):
        clusters = {}
        for i, cta in enumerate(launch):
            clusters.setdefault(i // ft.dw_cluster(jobs), []).append(cta)
        for ctas in clusters.values():
            live = [c for c in ctas if c.rank < c.act]
            j = live[0].job
            for cta in live:
                a_cols = [col for stash, layer, col in ft.dw_loads(cta)
                          if (stash, layer) == (j.a, j.a_layer)]
                assert [(col - cta.m0) // 64 for col in a_cols] == ft.dw_warpgroups(cta)
            arrivals = (sum(len(ft.dw_warpgroups(c)) for c in live)
                        + 2 * sum(c.bias for c in live))
            # the kernel's count: its bias flag is bias_out >= 0 on m-group 0
            count = (ft.dw_consumers(j.K, live[0].act, live[-1].m0)
                     + 2 * (j.bias_out >= 0 and live[0].m0 == 0))
            assert arrivals == count, (name, live[0])


@pytest.mark.parametrize("name", list(CALLS))
def test_launches_take_the_heaviest_jobs_first(name):
    """A launch's jobs go in order of their bytes a row (stable), at most
    DW_JOBS of them; its items number each job's m-groups x column blocks
    from ``unit0`` on; the cluster is the widest job's m-blocks, at most
    DW_MAX_CLUSTER."""
    packed = _packed(CALLS[name][0])
    jobs = ft.dw_jobs(packed)
    assert len(jobs) == packed.depth + 5
    c = ft.dw_cluster(jobs)
    assert c == min(max(-(-j.K // ft.DW_M) for j in jobs), ft.DW_MAX_CLUSTER)
    launches = ft.dw_launches(jobs)
    order = [j for launch in launches for j, *_ in launch]
    assert sorted(order, key=jobs.index) == jobs
    cost = [min(j.K, c * ft.DW_M) + min(j.N, ft.DW_N)
            + (ft.DW_TAIL if j.N > ft.DW_N and j.N % ft.DW_N == ft.DW_TAIL else 0)
            for j in order]
    assert cost == sorted(cost, reverse=True)
    for launch in launches:
        assert len(launch) <= ft.DW_JOBS
        item = 0
        for j, mg, cb, unit0 in launch:
            assert unit0 == item and cb == ft.dw_cblocks(j.N) and mg == -(-j.K // (ft.DW_M * c))
            item += mg * cb


def test_deep_fields_launch_in_batches_of_jobs():
    """Past DW_JOBS jobs (depth 20 and more) K2b launches again with the
    rest; every job lands in exactly one launch."""
    packed = _packed((64, 64, 32), net_depth=30, skip_layer=4)
    jobs = ft.dw_jobs(packed)
    launches = ft.dw_launches(jobs)
    assert len(jobs) == 35 and [len(x) for x in launches] == [24, 11]


# ---- shared-memory addressing: TMA boxes in, wgmma descriptors out ----

def swizzle128(addr: int) -> int:
    """The 128-byte swizzle of a shared-memory byte address (1024-byte
    atoms): the 16-byte chunk bits 4-6 XOR the row bits 7-9."""
    return addr ^ (((addr >> 7) & 7) << 4)


def desc_mn_sw128(addr: int, lbo: int) -> int:
    """wg::desc_mn_sw128: start address >> 4 in bits 0-13, the leading byte
    offset >> 4 in bits 16-29, the stride byte offset (1024) >> 4 in bits
    32-45, layout type 1 (128-byte swizzle) in bits 62-63."""
    return ((addr & 0x3FFFF) >> 4) | ((lbo >> 4) << 16) | ((1024 >> 4) << 32) | (1 << 62)


def mn_operand_addr(desc: int, mn: int, k: int) -> int:
    """The shared-memory byte address a wgmma reads element (mn, k) of an
    MN-major bf16 operand at, from its descriptor: the canonical layout ((8,
    8, m), (8, k)) of 16-byte units with strides ((1, 8, lbo), (8, sbo)),
    i.e. 64 MN-contiguous values a 128-byte row, the next 64 `lbo` bytes on,
    k rows 128 bytes apart in 8-row groups `sbo` apart; then the swizzle."""
    assert desc >> 62 == 1
    start = (desc & 0x3FFF) << 4
    lbo = ((desc >> 16) & 0x3FFF) << 4
    sbo = ((desc >> 32) & 0x3FFF) << 4
    addr = start + (mn // 64) * lbo + (mn % 64) * 2 + (k // 8) * sbo + (k % 8) * 128
    return swizzle128(addr)


def land_box(slot: np.ndarray, off: int, mat: np.ndarray, c0: int, r0: int) -> None:
    """A {64, 64} TMA box of ``mat`` at (column c0, row r0) into the slot's
    2-byte element array at byte ``off``, 128-byte swizzled: box row i's
    16-byte chunk j at chunk j ^ (i % 8); out-of-bounds values are zeros."""
    assert off % 1024 == 0
    rows, cols = mat.shape
    for i in range(64):
        for c in range(64):
            r, cc = r0 + i, c0 + c
            v = mat[r, cc] if r < rows and cc < cols else 0.0
            slot[(off + i * 128 + (((c // 8) ^ (i % 8)) << 4) + (c % 8) * 2) // 2] = v


# the stash widths the jobs have: rgb's 8, padded widths, D, P, V, W, F + 8
WIDTHS = [8, 16, 32, 48, 64, 112, 128, 256, 264]


@pytest.mark.parametrize("width", WIDTHS)
def test_descriptors_read_what_the_boxes_wrote(width):
    """A slot filled as the producer fills it (A's panels q at q x 8 KB, G's
    at (2 + q) x 8 KB, the tail's at 6 x 8 KB) and read as the consumers'
    descriptors address it (warpgroup w's A at panel w, B over G's four
    panels 8 KB apart, k16 step ks 2 KB on) gives A^T's (m, k) = A[r0 + 16
    ks + k, m0 + 64 w + m] and G's (n, k) = G[r0 + 16 ks + k, n0 + n], zeros
    past the stash's edges, for a stash of this width as A and as G."""
    rng = np.random.default_rng(width)
    rows = 100  # the k-block at row 64 runs past the last row
    mat = rng.standard_normal((rows, width)).astype(np.float32)
    panel = ft.DW_PANEL
    for r0 in (0, 64):
        for m0 in range(0, width, ft.DW_M):
            slot = np.full(7 * panel // 2, np.nan, np.float32)
            for q in range(2 if width - m0 > 64 else 1):
                land_box(slot, q * panel, mat, m0 + 64 * q, r0)
            for w in range(2 if width - m0 > 64 else 1):
                for ks in range(ft.DW_ROWS // 16):
                    d = desc_mn_sw128(w * panel + ks * 2048, panel)
                    for m in range(64):
                        for k in range(16):
                            r, c = r0 + 16 * ks + k, m0 + 64 * w + m
                            want = mat[r, c] if r < rows and c < width else 0.0
                            assert slot[mn_operand_addr(d, m, k) // 2] == want
        tail = width > ft.DW_N and width % ft.DW_N == ft.DW_TAIL
        for n0 in range(0, ft.dw_cblocks(width) * ft.DW_N, ft.DW_N):
            slot = np.full(7 * panel // 2, np.nan, np.float32)
            g_panels = min(4, -(-(width - n0) // 64)) + (1 if tail else 0)
            for q in range(g_panels):
                land_box(slot, (2 + q) * panel, mat, n0 + 64 * q, r0)
            for ks in range(ft.DW_ROWS // 16):
                d = desc_mn_sw128(2 * panel + ks * 2048, panel)
                dt = desc_mn_sw128(6 * panel + ks * 2048, panel)
                for n in range(min(ft.DW_N, 64 * min(g_panels, 4))):
                    for k in range(16):
                        r, c = r0 + 16 * ks + k, n0 + n
                        want = mat[r, c] if r < rows and c < width else 0.0
                        assert slot[mn_operand_addr(d, n, k) // 2] == want
                for n in range(ft.DW_TAIL if tail else 0):
                    for k in range(16):
                        r = r0 + 16 * ks + k
                        want = mat[r, n0 + ft.DW_N + n] if r < rows else 0.0
                        assert slot[mn_operand_addr(dt, n, k) // 2] == want


@pytest.mark.parametrize("width", WIDTHS)
def test_bias_warps_read_whole_chunks_where_the_boxes_wrote(width):
    """The bias warps' 16-byte loads (chunk c of row r at panel 2 + c / 8,
    byte r x 128 + ((c % 8) ^ (r % 8)) x 16; chunk 32 the tail's panel) give
    G's 8 columns 8 c .. 8 c + 7 of row r of the k-block."""
    rng = np.random.default_rng(width + 1)
    mat = rng.standard_normal((64, width)).astype(np.float32)
    panel = ft.DW_PANEL
    tail = width > ft.DW_N and width % ft.DW_N == ft.DW_TAIL
    for n0 in range(0, ft.dw_cblocks(width) * ft.DW_N, ft.DW_N):
        slot = np.zeros(7 * panel // 2, np.float32)
        g_panels = min(4, -(-(width - n0) // 64)) + (1 if tail else 0)
        for q in range(g_panels):
            land_box(slot, (2 + q) * panel, mat, n0 + 64 * q, 0)
        chunks = (min(width - n0, ft.DW_N + (ft.DW_TAIL if tail else 0)) + 7) // 8
        for c in range(chunks):
            base = (2 + c // 8) * panel
            jc = c % 8 if c < 32 else 0
            for r in range(64):
                at = (base + r * 128 + ((jc ^ (r & 7)) << 4)) // 2
                cols = [n0 + 8 * c + e for e in range(8)]
                want = [mat[r, x] if x < width else 0.0 for x in cols]
                np.testing.assert_array_equal(slot[at:at + 8], want)


def test_schedule_order_sums_to_the_plain_versions_product():
    """Every job's dW and bias sums, emulated in the kernel's order and
    type (f32: each k16 step's 16 products into the CTA's sums, the splits'
    partials then summed in split order; the bias sums over each warp's half
    of every k-block, then half 0 + half 1), against the plain version's
    ``tmm`` (A^T G in f32 over all rows) within 2e-6 of each leaf's largest
    entry: the same bf16 products, summed in another association (measured
    here: up to 8.5e-7)."""
    packed = _packed((40, 40, 24), net_depth=3, skip_layer=2)
    jobs = ft.dw_jobs(packed)
    rows = 30_000  # three splits, the last k-block ragged
    gen = torch.Generator().manual_seed(0)
    stash = {}
    for name in ft.STASHES:
        layers = packed.depth if name in ("sh", "gh") else 1
        t = torch.randn(layers, rows, ft.stash_width(name, packed), generator=gen)
        stash[name] = t.to(torch.bfloat16).float().numpy()
    splits, _ = ft.dw_splits(rows)
    assert splits == 3
    total = packed.w.numel() + packed.b.numel()
    partial = np.zeros((splits, total), np.float32)
    for launch in ft.dw_ctas(jobs, rows):
        for cta in launch:
            if cta.rank >= cta.act:
                continue
            j = cta.job
            a = stash[j.a][j.a_layer]
            g = stash[j.g][j.g_layer]
            m1, n1 = min(j.K, cta.m0 + ft.DW_M), min(j.N, cta.n0 + ft.DW_N + ft.DW_TAIL)
            acc = np.zeros((m1 - cta.m0, n1 - cta.n0), np.float32)
            bias = [np.zeros(n1 - cta.n0, np.float32) for _ in range(2)]
            for r in range(cta.r0, cta.r1, ft.DW_ROWS):
                for ks in range(0, ft.DW_ROWS, 16):
                    lo, hi = r + ks, min(r + ks + 16, cta.r1)
                    if lo < hi:
                        acc += a[lo:hi, cta.m0:m1].T @ g[lo:hi, cta.n0:n1]
                for h in range(2):
                    for rr in range(r + 32 * h, min(r + 32 * h + 32, cta.r1)):
                        bias[h] += g[rr, cta.n0:n1]
            for m in range(cta.m0, m1):
                at = j.out + m * j.N
                partial[cta.split, at + cta.n0:at + n1] = acc[m - cta.m0]
            if cta.bias:
                lo = max(cta.n0, j.bias_col0)
                partial[cta.split, j.bias_out + lo:j.bias_out + n1] = (
                    bias[0] + bias[1])[lo - cta.n0:]
    out = np.zeros(total, np.float32)
    for s in range(splits):  # reduce_kernel's order
        out += partial[s]
    for j in jobs:
        a = torch.from_numpy(stash[j.a][j.a_layer])
        g = torch.from_numpy(stash[j.g][j.g_layer])
        want = (a.t() @ g).numpy()  # fused_train_grads_reference's tmm in f32
        got = out[j.out:j.out + j.K * j.N].reshape(j.K, j.N)
        assert np.abs(got - want).max() <= 2e-6 * np.abs(want).max(), j
        if j.bias_out >= 0:
            want_b = g[:, j.bias_col0:].sum(0).numpy()
            got_b = out[j.bias_out + j.bias_col0:j.bias_out + j.N]
            assert np.abs(got_b - want_b).max() <= 2e-6 * np.abs(want_b).max(), j


# ---- the C constants and formulas the mirror copies ----

def test_mirror_constants_follow_the_kernel():
    src = (CSRC / "fused_train.cu").read_text()
    consts = dict(re.findall(r"constexpr (?:int|uint32_t) (k\w+) = (\d+);", src))
    assert {k: int(consts[k]) for k in ("kDwRows", "kDwM", "kDwN", "kDwTail", "kDwMaxCluster",
                                         "kDwMaxStages", "kSplitRows", "kMaxSplits", "kJobs")} == {
        "kDwRows": ft.DW_ROWS, "kDwM": ft.DW_M, "kDwN": ft.DW_N, "kDwTail": ft.DW_TAIL,
        "kDwMaxCluster": ft.DW_MAX_CLUSTER, "kDwMaxStages": ft.DW_MAX_STAGES,
        "kSplitRows": ft.SPLIT_ROWS, "kMaxSplits": ft.MAX_SPLITS, "kJobs": ft.DW_JOBS}
    assert "constexpr uint32_t kDwPanel = kDwRows * 128;" in src and ft.DW_PANEL == 64 * 128
    assert "constexpr uint32_t kDwSlot = 7 * kDwPanel;" in src
    # the schedule's formulas: splits, column blocks, the decode of a block
    assert "return ((rows + s - 1) / s + kDwRows - 1) / kDwRows * kDwRows;" in src
    assert "return N > kDwN && N % kDwN == kDwTail ? N / kDwN : (N + kDwN - 1) / kDwN;" in src
    assert "const int item = cid / p.splits, split = cid % p.splits;" in src
    assert "const int cb = v / jb.mgroups, mg = v % jb.mgroups;" in src
    assert ("  if (ce > cs)\n    while (per * 2 * (ce - cs) <= 32) per *= 2;\n"
            "  const int sub = lane & (per - 1), c_lane = cs + lane / per;") in src
    assert "if (q % act != rank) continue;" in src
    assert "const int a_panels = jb.K - m0 > 64 ? 2 : 1;" in src
    assert "if (64 * w >= jb.K - m0) return;" in src  # dw_warpgroups
    assert "return 2 * act - (jb.K - m_last > 64 ? 0 : 1);" in src  # dw_consumers
    assert ("dw_consumers(jb, act, (mg * p.cluster + act - 1) * kDwM) + (bias ? 2 : 0));"
            in src)
    # the jobs, in nerf_fused_train_grads's order
    calls = re.findall(r"^\s*(?:if \(skip_on\) )?job\((k\w+), ([^,]+), (\w+), (k\w+), (\w+), "
                       r"([^,]+), w_off\[([^\]]+)\]", src, re.M)
    maps = {"kDwX": "sx", "kDwH": "sh", "kDwFeat": "sfeat", "kDwHv": "shv", "kDwDv": "sdv",
            "kDwGh": "gh", "kDwGsf": "gsf", "kDwGhv": "ghv", "kDwRgb": "grgb"}
    assert [(maps[c[3]], c[5]) for c in calls][-4:] == [
        ("gsf", "F + 8"), ("ghv", "V"), ("ghv", "V"), ("grgb", "8")]
    wgmma = (CSRC / "field_wgmma.cuh").read_text()
    assert ("return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4)"
            " << 16) |\n         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);") in wgmma
