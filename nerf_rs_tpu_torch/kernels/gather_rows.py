"""The row-gather kernel K4, the counterpart of
``nerf_rs_tpu/kernels/gather_rows.py``: ``gather_rows(table, idx)`` is
``table[idx]`` for an (R, W) f32 table, ``gather_pairs(table_flat,
fidx)`` the adjacent element pairs ``table_flat[fidx]``,
``table_flat[fidx + 1]``. They are the hash-grid field's table fetch
(``models/hashgrid.py``): the brick layout's one 128-wide row per (point,
level), and the flat layout's F = 2 features per (point, level, corner).

Each wrapper launches the CUDA kernel (``csrc/gather_rows.cu``) for CUDA
tensors and runs its plain PyTorch version (``gather_rows_reference``,
``gather_pairs_reference``) for CPU tensors; there is no other switch. The
port's contract is its own, not the TPU's: any N, ragged or 0, and no
``block``, ``depth`` or ``unroll`` (the TPU's DMA ring). A gather copies, so
the kernel and the plain version give the same bits.

The wrappers refuse what the kernel does not take: another device than the
CPU or CUDA, a table that is not contiguous f32 (on the card also one whose
base is not aligned for the kernel's vector loads), a width that is not a
multiple of 4, indices that are not contiguous int32 on the table's device,
and odd pair indices. An index outside the table gives a NaN row (or pair)
on either device: the kernel never reads outside the table.

There is no backward: the JAX kernel has none either (``jnp.take``'s VJP is
XLA's scatter-add). ``models/hashgrid.py`` scatter-adds the gradient with
``index_add_``.
"""

from __future__ import annotations

import ctypes

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
    """``table[idx]``: table (R, W) f32 with W % 4 == 0, idx (N,) int32 ->
    (N, W) f32. Launches the kernel for CUDA tensors (counted in
    ``gather_rows.launches``), on the current stream without
    synchronising; runs the plain version for CPU tensors."""
    _check_table(table, 2, 16)
    if table.shape[1] % 4:
        raise ValueError(f"row width {table.shape[1]} is not a multiple of 4")
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
    (M,) f32, fidx (N,) int32 even -> (N, 2) f32. Launches the kernel for
    CUDA tensors (counted in ``gather_pairs.launches``), on the current
    stream; runs the plain version for CPU tensors. The evenness check
    reads the indices, so on the card it waits for them."""
    _check_table(table_flat, 1, 8)
    _check_idx(fidx, table_flat, "fidx")
    if bool(torch.any(fidx & 1)):
        raise ValueError("fidx must be even: a pair starts on an even element")
    if table_flat.device.type == "cpu":
        return gather_pairs_reference(table_flat, fidx)
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


# kernel launches so far in this process; a run reads them to show that its
# path went through the kernel
gather_rows.launches = 0
gather_pairs.launches = 0


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
    table."""
    f = fidx.long()
    ok = _inside(f, table_flat.shape[0] - 1)
    f = torch.where(ok, f, 0)
    return torch.where(ok[:, None], torch.stack([table_flat[f], table_flat[f + 1]], -1),
                       torch.nan)


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
        lib.nerf_cuda_error_string.argtypes = [i32]
        lib.nerf_cuda_error_string.restype = ctypes.c_char_p
    return lib
