"""The row-gather kernel K4, the counterpart of
``nerf_rs_tpu/kernels/gather_rows.py``: ``gather_rows(table, idx)`` is
``table[idx]`` for an (R, W) f32 table, ``gather_pairs(table_flat,
fidx)`` the adjacent element pairs ``table_flat[fidx]``,
``table_flat[fidx + 1]``. They are the hash-grid field's table fetch
(``models/hashgrid.py``): the brick layout's one 128-wide row per (point,
level), and the flat layout's F features per (point, level, corner): pairs
at F = 2, rows of any other width through ``gather_rows``.

Each wrapper launches the CUDA kernel (``csrc/gather_rows.cu``) for CUDA
tensors and runs its plain PyTorch version (``gather_rows_reference``,
``gather_pairs_reference``) for CPU tensors; there is no other switch. The
port's contract is its own, not the TPU's: any N, ragged or 0, and no
``block``, ``depth`` or ``unroll`` (the TPU's DMA ring). A gather copies, so
the kernel and the plain version give the same bits.

The wrappers refuse what the kernel does not take: another device than the
CPU or CUDA, a table that is not contiguous f32 (on the card a pair table
must also start on an 8-byte boundary), and indices that are not contiguous
int32 on the table's device (on the card, pair indices also start on a
16-byte boundary). ``gather_rows`` takes any row width: the kernel reads 16
bytes at a time where the width is a multiple of 4 and the table is 16-byte
aligned, and a float at a time elsewhere. An
index outside the table gives a NaN row (or pair) on either device, and so
does an odd pair index (a pair starts on an even element): the kernel never
reads outside the table, and the wrappers never read the indices, so a call
does not wait for the card. The JAX function leaves an odd index undefined.

The fetches' backward is ``scatter_rows``: the cotangents of the fetched
values summed into the table per element in fetch order (the JAX package's
``jnp.take`` VJP, an XLA scatter-add; it has no Pallas kernel). The order is
fixed, so two calls give the same bits on the card, where ``index_add_``'s
float atomics do not: per element, each chunk of SCATTER_CHUNK fetches of its
row in fetch order, then the row's chunks in order. On the card every step
is a kernel of ``csrc/gather_rows.cu`` and reads its counts there, so a call
never waits for the host: a stable LSD radix sort of the keys (a key outside
the table mapped to the spare value ``rows``, so ``sort_plan(rows)`` needs
only ``rows.bit_length()`` bits), each row's run found from the key changes,
and one reduce that writes a run of one chunk straight into the table and
sums a longer run's chunks into slots first. The plain version
``scatter_rows_reference`` makes the same additions in the same order, so
the two give the same bits.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from . import build


def _check_table(table: torch.Tensor, dims: int, align: int) -> None:
    if table.dim() != dims or table.dtype != torch.float32 or not table.is_contiguous():
        raise ValueError(f"table must be a contiguous {dims}-D f32 tensor, got "
                         f"{table.dtype} {tuple(table.shape)}")
    if table.device.type == "cuda" and table.data_ptr() % align:
        raise ValueError(f"table must start on a {align}-byte boundary on the card")


def _check_idx(idx: torch.Tensor, table: torch.Tensor, name: str) -> None:
    if idx.dim() != 1 or idx.dtype != torch.int32 or not idx.is_contiguous():
        raise ValueError(f"{name} must be a contiguous 1-D int32 tensor, got "
                         f"{idx.dtype} {tuple(idx.shape)}")
    if idx.device != table.device:
        raise ValueError(f"{name} must lie on the table's device ({table.device})")
    if table.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {table.device}")


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]``: table (R, W) f32 of any width, idx (N,) int32 ->
    (N, W) f32. Launches the kernel for CUDA tensors (counted in
    ``gather_rows.launches``), on the current stream without
    synchronising; runs the plain version for CPU tensors."""
    _check_table(table, 2, 4)
    _check_idx(idx, table, "idx")
    if table.device.type == "cpu":
        return gather_rows_reference(table, idx)
    n, (rows, width) = idx.shape[0], table.shape
    out = torch.empty(n, width, device=table.device)
    if n == 0:
        return out
    lib = _library()
    rc = lib.nerf_gather_rows(table.data_ptr(), idx.data_ptr(), out.data_ptr(), n, rows, width,
                              torch.cuda.current_stream(table.device).cuda_stream)
    _raise_on(rc, lib, "gather_rows")
    gather_rows.launches += 1
    return out


def gather_pairs(table_flat: torch.Tensor, fidx: torch.Tensor) -> torch.Tensor:
    """``stack([table_flat[fidx], table_flat[fidx + 1]], -1)``: table_flat
    (M,) f32, fidx (N,) int32 even -> (N, 2) f32, a NaN pair for an odd
    index or one outside the table. Launches the kernel for CUDA tensors
    (counted in ``gather_pairs.launches``), on the current stream without
    synchronising; runs the plain version for CPU tensors."""
    _check_table(table_flat, 1, 8)
    _check_idx(fidx, table_flat, "fidx")
    if table_flat.device.type == "cpu":
        return gather_pairs_reference(table_flat, fidx)
    if fidx.data_ptr() % 16:
        raise ValueError("fidx must start on a 16-byte boundary on the card")
    n = fidx.shape[0]
    out = torch.empty(n, 2, device=table_flat.device)
    if n == 0:
        return out
    lib = _library()
    rc = lib.nerf_gather_pairs(table_flat.data_ptr(), table_flat.shape[0], fidx.data_ptr(),
                               out.data_ptr(), n,
                               torch.cuda.current_stream(table_flat.device).cuda_stream)
    _raise_on(rc, lib, "gather_pairs")
    gather_pairs.launches += 1
    return out


SCATTER_CHUNK = 64  # fetches per partial sum: the longest sequential walk

def sort_plan(rows: int):
    """(key bits, passes, digit bits) of the sort of keys in [0, rows], as
    csrc/gather_rows.cu plans it (``nerf_sort_passes``,
    ``nerf_sort_digit_bits``): a key outside the table becomes ``rows``,
    so the keys need ``rows.bit_length()`` bits, sorted in passes of 8- or
    9-bit digits, whichever takes fewer passes, 8 on a tie. Pass p sorts
    by bits [p d, (p + 1) d) of the key."""
    bits = max(1, int(rows).bit_length())
    digit = 9 if -(-bits // 9) < -(-bits // 8) else 8
    return bits, -(-bits // digit), digit


def sort_key(key: torch.Tensor, rows: int) -> torch.Tensor:
    """The sorted value of each key: the key, or ``rows`` for one outside
    [0, rows), so that no key aliases a row when the sort reads only the
    plan's bits."""
    return torch.where((key >= 0) & (key < rows), key, torch.full_like(key, rows))


def sort_keys(key: torch.Tensor, rows: int):
    """scatter_rows' sort alone: (the keys mapped by ``sort_key`` in stable
    order, (M,) int32; their positions in ``key``, (M,) int32), the same as
    ``torch.sort(sort_key(key, rows), stable=True)``. Launches the sort's
    kernels for CUDA tensors (counted in ``sort_keys.launches``); runs the
    plain version for CPU tensors."""
    if key.dim() != 1 or key.dtype != torch.int32 or not key.is_contiguous() or rows < 1:
        raise ValueError(f"key must be a contiguous 1-D int32 tensor and rows >= 1, got "
                         f"{key.dtype} {tuple(key.shape)}, rows {rows}")
    if key.device.type == "cpu":
        sk, perm = torch.sort(sort_key(key, rows), stable=True)
        return sk, perm.int()
    if key.device.type != "cuda":
        raise ValueError(f"no kernel for device {key.device}")
    M = key.shape[0]
    keys, ids = torch.empty_like(key), torch.empty_like(key)
    if M == 0:
        return keys, ids
    lib = _library()
    work = torch.empty(lib.nerf_scatter_workspace_bytes(M, rows, 1, 0), dtype=torch.uint8,
                       device=key.device)
    rc = lib.nerf_radix_sort(key.data_ptr(), M, rows, work.data_ptr(), keys.data_ptr(),
                             ids.data_ptr(), torch.cuda.current_stream(key.device).cuda_stream)
    _raise_on(rc, lib, "radix sort")
    sort_keys.launches += 1
    return keys, ids


def _runs(key: torch.Tensor):
    """(perm, rows, start, count): the stable order of the keys and, per
    distinct key in ascending order, its first position in that order and
    its number of entries."""
    sorted_key, perm = torch.sort(key, stable=True)
    rows, count = torch.unique_consecutive(sorted_key, return_counts=True)
    start = torch.cumsum(count, 0) - count
    return perm, rows, start, count


def scatter_rows(g: torch.Tensor, key: torch.Tensor, lane0: Optional[torch.Tensor],
                 lanes: Sequence[int], shape) -> torch.Tensor:
    """The gradient of a (rows, width) f32 table of ``shape`` whose fetch j
    read row ``key[j]`` at the columns ``lane0[j] + lanes[c]`` (``lane0``
    None: 0) and received the cotangents ``g`` (M, C) f32: out[key[j],
    lane0[j] + lanes[c]] += g[j, c], summed in a fixed order: per element,
    the fetches of each chunk of SCATTER_CHUNK fetches of its row in fetch
    order, then the chunks in order; keys outside the table are skipped.
    ``key`` and ``lane0`` are (M,) int32, M < 2^31; ``lanes`` C distinct
    columns in [0, width), and a fetch's columns inside the row. Any C and
    width (on the card, as far as one fetch's C values and the row's width
    fit a block's shared memory: C up to ~7,000). Launches the kernels for
    CUDA tensors (counted once per call in ``scatter_rows.launches``), on
    the current stream without synchronising; runs the plain version for CPU
    tensors."""
    rows_n, width = shape
    M, C = g.shape
    lanes = tuple(int(c) for c in lanes)
    if (len(lanes) != C or C < 1 or width < 1 or len(set(lanes)) != C
            or not all(0 <= c < width for c in lanes)):
        raise ValueError(f"{C} lanes {lanes} of a {width}-wide row: the kernel takes C >= 1 "
                         f"distinct lanes inside the row")
    for name, a in (("key", key), ("lane0", lane0)):
        if a is not None and (a.shape != (M,) or a.dtype != torch.int32 or a.device != g.device
                              or not a.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous ({M},) int32 tensor on g's device")
    if g.dtype != torch.float32 or not g.is_contiguous():
        raise ValueError("g must be a contiguous f32 tensor")
    if g.device.type == "cpu":
        return scatter_rows_reference(g, key, lane0, lanes, shape)
    if g.device.type != "cuda":
        raise ValueError(f"no kernel for device {g.device}")
    if M >= 2 ** 31 or not 0 < rows_n < 2 ** 31:
        raise ValueError(f"{M} fetches into {rows_n} rows: the kernels take fewer than 2^31 "
                         f"of each and at least one row")
    if M == 0:
        return torch.zeros(rows_n, width, device=g.device)
    out = torch.empty(rows_n, width, device=g.device)  # the kernels write every row
    if g.data_ptr() % 16 or key.data_ptr() % 16:
        g, key = g.clone(), key.clone()  # the kernels' vector loads
    lib = _library()
    pair = lane0 is None and tuple(lanes) == (0, 1) and width == 2  # the sort carries g
    work = torch.empty(lib.nerf_scatter_workspace_bytes(M, rows_n, width, pair),
                       dtype=torch.uint8, device=g.device)
    rc = lib.nerf_scatter_rows(g.data_ptr(), key.data_ptr(),
                               None if lane0 is None else lane0.data_ptr(),
                               (ctypes.c_int * C)(*lanes), build.device_table(lanes, g.device, torch.int32).data_ptr(),
                               C, M, rows_n, width, work.data_ptr(), out.data_ptr(),
                               torch.cuda.current_stream(g.device).cuda_stream)
    if rc == -1:
        raise ValueError("scatter_rows kernel refused the call: width, C or lanes out of range")
    if rc == -2:
        raise ValueError(f"scatter_rows kernel refused the call: one fetch's {C} values and a "
                         f"{width}-wide row's inverse of lanes outgrow a block's shared memory")
    _raise_on(rc, lib, "scatter_rows")
    scatter_rows.launches += 1
    return out


# kernel launches so far in this process; a run reads them to show that its
# path went through the kernel
gather_rows.launches = 0
gather_pairs.launches = 0
scatter_rows.launches = 0
sort_keys.launches = 0


def _inside(i: torch.Tensor, size: int) -> torch.Tensor:
    return (i >= 0) & (i < size)


def gather_rows_reference(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The plain version of ``gather_rows``: ``table[idx]``, NaN rows for
    indices outside the table."""
    i = idx.long()
    ok = _inside(i, table.shape[0])
    return torch.where(ok[:, None], table[torch.where(ok, i, 0)], torch.nan)


def gather_pairs_reference(table_flat: torch.Tensor, fidx: torch.Tensor) -> torch.Tensor:
    """The plain version of ``gather_pairs``: ``stack([table_flat[fidx],
    table_flat[fidx + 1]], -1)``, NaN pairs where fidx + 1 is outside the
    table or fidx is odd."""
    f = fidx.long()
    ok = _inside(f, table_flat.shape[0] - 1) & ((f & 1) == 0)
    f = torch.where(ok, f, 0)
    return torch.where(ok[:, None], torch.stack([table_flat[f], table_flat[f + 1]], -1),
                       torch.nan)


def _ordered_sums(keys: torch.Tensor, vals: torch.Tensor):
    """(distinct keys ascending, the sum of each key's values from 0 in
    their order in ``vals``). The runs are walked position by position,
    vectorised over the runs still going (longest first), so a call costs
    as many steps as its longest run."""
    order, uniq, start, count = _runs(keys)
    vals = vals[order]
    count, by_len = torch.sort(count, descending=True, stable=True)
    start = start[by_len]
    going = count.shape[0] - torch.cumsum(torch.bincount(count), 0)  # runs with count > step
    acc = torch.zeros(count.shape[0], dtype=vals.dtype, device=vals.device)
    for step, n in enumerate(going[:int(count[0])].tolist()):
        acc[:n] += vals[start[:n] + step]
    sums = torch.empty_like(acc)
    sums[by_len] = acc
    return uniq, sums


def scatter_rows_reference(g: torch.Tensor, key: torch.Tensor, lane0: Optional[torch.Tensor],
                           lanes: Sequence[int], shape) -> torch.Tensor:
    """The plain version of ``scatter_rows``, the kernels' additions in
    their order: per (element, chunk) the chunk's fetches in fetch order
    from 0, then per element its chunks in order from 0. A fetch's chunk is
    its rank in its row's run // SCATTER_CHUNK. Keys outside the table are
    skipped, as the kernels skip them."""
    rows_n, width = shape
    M, C = g.shape
    out = torch.zeros(rows_n * width, device=g.device)
    if M == 0:
        return out.view(rows_n, width)
    perm, _, start, count = _runs(key)
    rank = torch.empty(M, dtype=torch.int64, device=g.device)
    rank[perm] = torch.arange(M, device=g.device) - torch.repeat_interleave(start, count)
    chunk = rank // SCATTER_CHUNK
    n_ch = int(chunk.max()) + 1
    col = torch.as_tensor(list(lanes), dtype=torch.int64, device=g.device)[None, :]
    if lane0 is not None:
        col = lane0.long()[:, None] + col
    k = key.long()[:, None]
    keep = ((k >= 0) & (k < rows_n) & (col < width)).expand(M, C).reshape(-1)
    group = ((k * width + col) * n_ch + chunk[:, None]).expand(M, C).reshape(-1)[keep]
    if group.numel() == 0:
        return out.view(rows_n, width)
    groups, partial = _ordered_sums(group, g.reshape(-1)[keep])
    elems, total = _ordered_sums(groups // n_ch, partial)
    out[elems] = total
    return out.view(rows_n, width)


def _raise_on(rc: int, lib, what: str) -> None:
    if rc:
        msg = lib.nerf_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc} ({msg})")


def _library() -> ctypes.CDLL:
    lib = build.load("gather_rows")
    if lib.nerf_gather_rows.argtypes is None:
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.nerf_gather_rows.argtypes = [vp, vp, vp, i64, i64, i32, vp]
        lib.nerf_gather_rows.restype = i32
        lib.nerf_gather_pairs.argtypes = [vp, i64, vp, vp, i64, vp]
        lib.nerf_gather_pairs.restype = i32
        for plan in (lib.nerf_sort_passes, lib.nerf_sort_digit_bits):
            plan.argtypes = [i64]
            plan.restype = i32
        lib.nerf_scatter_workspace_bytes.argtypes = [i64, i64, i32, i32]
        lib.nerf_scatter_workspace_bytes.restype = i64
        lib.nerf_radix_sort.argtypes = [vp, i64, i64, vp, vp, vp, vp]
        lib.nerf_radix_sort.restype = i32
        lib.nerf_scatter_rows.argtypes = [vp, vp, vp, ctypes.POINTER(i32), vp, i32, i64, i64,
                                          i32, vp, vp, vp]
        lib.nerf_scatter_rows.restype = i32
        lib.nerf_cuda_error_string.argtypes = [i32]
        lib.nerf_cuda_error_string.restype = ctypes.c_char_p
    return lib
