"""The fixed-order table gradient ``scatter_rows``'s own layouts, on the CPU
(csrc/gather_rows.cu, kernels/gather_rows.py):

* the sort's plan (``sort_plan``) reads ``rows.bit_length()`` key bits, the
  spare value ``rows`` included, in the fewest passes of 8- or 9-bit digits,
  and ``sort_key`` maps every key outside the table to that spare value;
* a numpy emulation of the radix sort's passes as the kernels run them
  (digits of the plan's width, per-tile digit counts scanned digit-major,
  each warp ranking its 32-key steps in order with the running count of
  its digit, the warps' counts scanned in warp order, the tile sorted by
  digit and written out in runs) gives ``np.argsort(kind="stable")``'s
  permutation on random, Zipf, all-equal and out-of-table keys;
* the runs found from the sorted keys' changes, cut into chunks of
  SCATTER_CHUNK (a short run one chunk, a long one a slot per chunk), are
  the chunks cut from ``torch.unique_consecutive``'s runs;
* a numpy emulation of the reduce (a thread per pair row; a warp per lane
  row, each lane owning columns lane + 32 j and finding each fetch's value
  through the inverse of ``lanes``) gives ``scatter_rows_reference``'s bits,
  which stand within f32 rounding of the JAX package's ``jnp.take`` VJP.

The kernels themselves against their plain versions, and the kernels'
passes against ``sort_plan``'s, need the card: tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_rs_tpu_torch.kernels import gather_rows as k4
from nerf_rs_tpu_torch.models import hashgrid

torch.set_num_threads(2)

CHUNK = k4.SCATTER_CHUNK
# the emulated tile: WARPS warps, each ranking ITEMS steps of 32 keys (the
# kernels' kSortWarps and kSortItems)
WARPS, ITEMS = 8, 16
TILE = WARPS * ITEMS * 32


# (rows, key bits, digit bits): the brick table's 2^17 rows take two 9-bit
# passes, the flat table's 2^23 three 8-bit ones
@pytest.mark.parametrize("rows,bits,digit", [(1, 1, 8), (2, 2, 8), (2 ** 17, 18, 9),
                                             (2 ** 23, 24, 8), (2 ** 31 - 1, 31, 8)])
def test_sort_plan_reads_the_key_bits_of_every_row_and_the_spare(rows, bits, digit):
    got_bits, passes, d = k4.sort_plan(rows)
    assert (got_bits, d) == (bits, digit)
    assert rows < 2 ** bits  # the spare value rows fits too
    assert passes * d >= bits and (passes - 1) * d < bits
    assert passes == min(-(-bits // 8), -(-bits // 9))  # the fewest passes


def test_keys_outside_the_table_map_to_the_spare_value():
    key = torch.tensor([-2 ** 31, -7, -1, 0, 5, 9, 10, 11, 2 ** 31 - 1], dtype=torch.int32)
    got = k4.sort_key(key, 10)
    assert got.tolist() == [10, 10, 10, 0, 5, 9, 10, 10, 10]
    # read as unsigned and cut to the plan's bits, -1 would alias row 15 of 16
    assert (np.uint32(np.int32(-1)) & (2 ** k4.sort_plan(16)[0] - 1)) != 16
    assert int(k4.sort_key(torch.tensor([-1], dtype=torch.int32), 16)) == 16


def _emulate_sort(key: np.ndarray, rows: int) -> np.ndarray:
    """The kernels' passes in numpy: returns the fetch ids in sorted order."""
    n = key.shape[0]
    keys = np.where((key >= 0) & (key < rows), key, rows).astype(np.int64)
    ids = np.arange(n)
    _, passes, d = k4.sort_plan(rows)
    D = 1 << d
    tiles = -(-n // TILE)
    for p in range(passes):
        digit = (keys >> (p * d)) & (D - 1)
        # every digit's first position in each tile: the digit counts
        # scanned (radix_histogram_kernel), then the earlier tiles' counts
        # (the look-back)
        counts = np.zeros((D, tiles), np.int64)
        np.add.at(counts, (digit, np.arange(n) // TILE), 1)
        first = (np.cumsum(counts.reshape(-1)) - counts.reshape(-1)).reshape(D, tiles)
        out_k, out_id = np.empty_like(keys), np.empty_like(ids)
        for t in range(tiles):  # radix_downsweep_kernel, a tile in any order
            t0 = t * TILE
            nt = min(TILE, n - t0)
            whist = np.zeros((WARPS, D), np.int64)
            rank = np.zeros(nt, np.int64)
            for w in range(WARPS):
                for k in range(ITEMS):
                    j0 = (w * ITEMS + k) * 32
                    lanes = np.arange(j0, min(j0 + 32, nt))
                    for lane, j in enumerate(lanes):  # the ballots' peers below the lane
                        dg = digit[t0 + j]
                        below = int((digit[t0 + lanes[:lane]] == dg).sum())
                        rank[j] = whist[w, dg] + below
                    for j in lanes:
                        whist[w, digit[t0 + j]] += 1
            ttot = whist.sum(0)
            wprefix = np.cumsum(whist, 0) - whist
            tstart = np.cumsum(ttot) - ttot
            skeys = np.empty(nt, np.int64)
            sids = np.empty(nt, np.int64)
            for j in range(nt):
                dg = digit[t0 + j]
                pos = tstart[dg] + wprefix[j // (32 * ITEMS), dg] + rank[j]
                skeys[pos], sids[pos] = keys[t0 + j], ids[t0 + j]
            for j in range(nt):
                dg = (skeys[j] >> (p * d)) & (D - 1)
                out = first[dg, t] + j - tstart[dg]
                out_k[out], out_id[out] = skeys[j], sids[j]
        keys, ids = out_k, out_id
    return ids


def _keys(kind: str, n: int, rows: int, rng) -> np.ndarray:
    if kind == "random":
        return rng.integers(0, rows, n)
    if kind == "zipf":
        return rng.zipf(1.3, n) % rows
    if kind == "equal":
        return np.full(n, rows // 3)
    key = rng.integers(-rows, 2 * rows, n)  # outside the table, both sides
    key[::7] = -1
    key[1::11] = rows
    return key


# tables of 1 to 3 passes: 5 rows (one 8-bit pass), 257 and 511 (one
# 9-bit pass), 1000 (two 8-bit passes) and 2^17 (two 9-bit passes)
@pytest.mark.parametrize("kind", ["random", "zipf", "equal", "outside"])
@pytest.mark.parametrize("rows,n", [(1000, 9000), (2 ** 17, 13001), (5, 4099), (257, 5000),
                                    (511, 4097)])
def test_emulated_radix_passes_give_the_stable_order(kind, rows, n):
    rng = np.random.default_rng(n + rows)
    key = _keys(kind, n, rows, rng).astype(np.int32)
    got = _emulate_sort(key, rows)
    mapped = np.where((key >= 0) & (key < rows), key, rows)
    np.testing.assert_array_equal(got, np.argsort(mapped, kind="stable"))
    # the wrapper's plain version of the sort agrees
    sk, perm = k4.sort_keys(torch.from_numpy(key), rows)
    np.testing.assert_array_equal(perm.numpy(), got)
    np.testing.assert_array_equal(sk.numpy(), mapped[got])


def _unique_chunks(key: torch.Tensor):
    """An independent cut: each distinct key's run from
    torch.unique_consecutive, cut into SCATTER_CHUNK pieces ((row, start,
    count) per chunk, in key order), keys outside the table included."""
    _, uniq, start, count = k4._runs(key)
    nchunk = (count + CHUNK - 1) // CHUNK
    first = torch.cumsum(nchunk, 0) - nchunk
    owner = torch.repeat_interleave(torch.arange(count.shape[0]), nchunk)
    cstart = start[owner] + (torch.arange(int(nchunk.sum())) - first[owner]) * CHUNK
    ccount = torch.clamp(start[owner] + count[owner] - cstart, max=CHUNK)
    return uniq[owner].numpy(), cstart.numpy(), ccount.numpy()


def _runs_and_chunks(sorted_keys: np.ndarray, rows: int):
    """The rows' runs that the sort's last pass records (every row empty
    first, then [first, end) where the sorted key changes) and the reduce's
    chunks in row order: a run of at most SCATTER_CHUNK fetches is one
    chunk, a longer one takes a slot per chunk."""
    M = sorted_keys.shape[0]
    ranges = np.zeros((rows, 2), np.int64)
    for i, k in enumerate(sorted_keys):
        if k >= rows:
            continue
        if i == 0 or sorted_keys[i - 1] != k:
            ranges[k, 0] = i
        if i == M - 1 or sorted_keys[i + 1] != k:
            ranges[k, 1] = i + 1
    chunks = []
    for k, (beg, end) in enumerate(ranges):
        n = end - beg
        if 0 < n <= CHUNK:
            chunks.append((k, beg, n))
        for c in range(-(-n // CHUNK) if n > CHUNK else 0):
            b = beg + c * CHUNK
            chunks.append((k, b, min(end, b + CHUNK) - b))
    return ranges, chunks


@pytest.mark.parametrize("kind", ["random", "zipf", "equal", "outside"])
def test_runs_and_chunks_match_unique_consecutive(kind):
    rows, n = 700, 20011
    key = torch.from_numpy(_keys(kind, n, rows, np.random.default_rng(7)).astype(np.int32))
    sk, _ = k4.sort_keys(key, rows)
    ranges, chunks = _runs_and_chunks(sk.numpy(), rows)
    owner, cstart, ccount = _unique_chunks(key)
    inside = (owner >= 0) & (owner < rows)  # the kernels skip the rest
    shift = int((key < 0).sum())  # torch.sort puts negative keys first, sort_key last
    assert [c[0] for c in chunks] == owner[inside].tolist()
    assert [c[1] for c in chunks] == (cstart[inside] - shift).tolist()
    assert [c[2] for c in chunks] == ccount[inside].tolist()
    assert int((ranges[:, 1] - ranges[:, 0]).sum()) == int(ccount[inside].sum())


def _emulate_reduce(g, key, lane0, lanes, shape):
    """The reduce kernels in numpy, in f32, in their order of additions."""
    rows, width = shape
    g = g.numpy()
    sk, ids = (t.numpy() for t in k4.sort_keys(key, rows))
    ranges, chunks = _runs_and_chunks(sk, rows)
    inv = {c: i for i, c in enumerate(lanes)}
    l0 = np.zeros(len(sk), np.int64) if lane0 is None else lane0.numpy()
    f32 = np.float32

    def chunk_sum(beg, n):
        acc = np.zeros(width, f32)
        if lane0 is None and tuple(lanes) == (0, 1) and width == 2:  # a thread, one float2
            for j in range(beg, beg + n):
                acc = acc + g[ids[j]]
            return acc
        for j in range(beg, beg + n):  # a warp: lane + 32 q owns its column
            for col in range(width):
                c = inv.get(col - l0[ids[j]])
                if c is not None:
                    acc[col] = f32(acc[col] + g[ids[j], c])
        return acc

    out = np.zeros((rows, width), f32)
    partial = {}
    for k, beg, n in chunks:
        if ranges[k, 1] - ranges[k, 0] <= CHUNK:
            out[k] = chunk_sum(beg, n)
        else:
            partial.setdefault(k, []).append(chunk_sum(beg, n))
    for k, parts in partial.items():  # scatter_combine: the slots in chunk order
        acc = np.zeros(width, f32)
        for p in parts:
            acc = acc + p
        out[k] = acc
    return out


def _lane_case(layout: str, n: int, rng):
    """(shape, lanes, lane0) of a layout: the flat table's pairs, the brick
    table's corner lanes, the flat table at F = 3 (rows of 3, lanes 0-2), and
    40 lanes of a 160-wide row (wider than a warp's 128 columns at once) at
    random bases."""
    if layout == "flat":
        return (257, 2), (0, 1), None
    if layout == "width3":
        return (257, 3), (0, 1, 2), None
    if layout == "width160":
        lanes = tuple(int(c) for c in rng.permutation(80)[:40])
        return (97, 160), lanes, torch.from_numpy(rng.integers(0, 81, n).astype(np.int32))
    lane0 = torch.from_numpy(rng.integers(0, 43, n).astype(np.int32) * 2)
    return (97, 128), hashgrid._CORNER_LANES, lane0


@pytest.mark.parametrize("layout", ["flat", "brick", "width3", "width160"])
@pytest.mark.parametrize("kind", ["zipf", "outside", "equal"])
def test_emulated_reduce_gives_the_plain_versions_bits(layout, kind):
    rng = np.random.default_rng(11)
    n = 3001
    shape, lanes, lane0 = _lane_case(layout, n, rng)
    key = torch.from_numpy(_keys(kind, n, shape[0], rng).astype(np.int32))
    g = torch.from_numpy(rng.normal(size=(n, len(lanes))).astype(np.float32))
    want = k4.scatter_rows(g, key, lane0, lanes, shape)  # the CPU: the plain version
    got = _emulate_reduce(g, key, lane0, lanes, shape)
    np.testing.assert_array_equal(got, want.numpy())


def test_plain_version_matches_the_jax_take_vjp():
    """The flat layout's table gradient against jax.vjp of the pair fetch,
    up to the order of f32 additions (XLA's scatter-add has its own)."""
    rng = np.random.default_rng(3)
    rows, n = 4099, 50_000
    key = rng.zipf(1.4, n).astype(np.int32) % rows
    g = rng.normal(size=(n, 2)).astype(np.float32)
    table = jnp.zeros(2 * rows, jnp.float32)
    fidx = jnp.asarray(2 * key)
    _, vjp = jax.vjp(lambda t: jnp.stack([jnp.take(t, fidx), jnp.take(t, fidx + 1)], -1), table)
    want = np.asarray(vjp(jnp.asarray(g))[0]).reshape(rows, 2)
    got = k4.scatter_rows(torch.from_numpy(g), torch.from_numpy(key), None, (0, 1), (rows, 2))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("layout", ["width3", "width160"])
def test_plain_version_at_any_width_matches_the_jax_take_vjp(layout):
    """Rows of 3 (the flat table at F = 3, lanes 0-2) and 40 lanes of a
    160-wide row at random bases, the sizes the kernels took only past
    fault 16's repair: the gradient against jax.vjp of the fetch of each
    fetch's columns, up to the order of f32 additions."""
    rng = np.random.default_rng(5)
    n = 20_000
    (rows, width), lanes, lane0 = _lane_case(layout, n, rng)
    key = (rng.zipf(1.4, n) % rows).astype(np.int32)
    g = rng.normal(size=(n, len(lanes))).astype(np.float32)
    base = np.zeros(n, np.int64) if lane0 is None else lane0.numpy().astype(np.int64)
    cols = key[:, None].astype(np.int64) * width + base[:, None] + np.asarray(lanes)[None, :]
    table = jnp.zeros(rows * width, jnp.float32)
    _, vjp = jax.vjp(lambda t: jnp.take(t, jnp.asarray(cols)), table)
    want = np.asarray(vjp(jnp.asarray(g))[0]).reshape(rows, width)
    got = k4.scatter_rows(torch.from_numpy(g), torch.from_numpy(key), lane0, lanes,
                          (rows, width))
    assert np.abs(want).max() > 1.0
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)
