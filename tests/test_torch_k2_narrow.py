"""K2a's narrow instance (csrc/fused_train.cu, train_narrow_kernel and
train_narrow_bwd_kernel) on the CPU, where no kernel runs: the route table
against the C enum it indexes, and its shared-memory layouts emulated in
numpy. The act block lies in 128-byte-swizzled panels of 64 columns
(``narrow_act_offset``, the mirror of act_off<true>): the epilogues write it
there, wgmma's 128-byte-swizzle descriptors (the address word's panel, 32
bytes a k16 step, a warpgroup's rows 8 KB on, 8-row groups 1 KB apart, the
hardware's XOR of address bits 4-6 with bits 7-9) read the same elements
back, and TMA's 128-byte-swizzled {64, 64} boxes, one a panel and consumer
warpgroup (``narrow_stash_boxes``, the mirror of store_tile), put every
element at its place in the row-major stash once; the encoding tiles
(K-major core matrices) leave in {8, 128} boxes. The kernels themselves are held to the plain version on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import re
from pathlib import Path

import numpy as np
import pytest

from nerf_rs_tpu_torch.kernels import fused_train
from nerf_rs_tpu_torch.kernels.fused_train import (K2_ROUTES, PANEL_BYTES, PANEL_COLS,
                                                   narrow_act_offset, narrow_stash_boxes)

CSRC = Path(fused_train.__file__).resolve().parent / "csrc" / "fused_train.cu"
ROWS = 128
# the stash widths a narrow field has: padded widths, P and D, W, F, V
WIDTHS = [16, 32, 48, 64, 112, 128, 208, 256]


def tile_off(r: int, k: int) -> int:
    """Byte offset of element (r, k) in a 128-row K-major core-matrix tile
    (wg::tile_off: the encoding tiles)."""
    return ((k >> 3) << 11) + ((r >> 3) << 7) + ((r & 7) << 4) + ((k & 7) << 1)


def swizzle128(addr: int) -> int:
    """The 128-byte swizzle of a shared-memory byte address (1024-byte atoms):
    the 16-byte chunk bits 4-6 XOR the row bits 7-9."""
    return addr ^ (((addr >> 7) & 7) << 4)


def test_route_names_follow_the_kernels_modes():
    """``fused_train.route`` indexes K2_ROUTES with C's TrainMode: the
    names stand in the enum's order, one for each mode."""
    src = CSRC.read_text()
    modes = re.search(r"enum TrainMode \{([^}]*)\}", src).group(1)
    modes = [m.strip() for m in modes.split(",")]
    names = {"kResident": "resident", "kStreamed": "streamed", "kWide": "mma.sync wide",
             "kCluster": "cluster", "kNarrow": "narrow wgmma"}
    assert tuple(names[m] for m in modes) == K2_ROUTES


def test_mirrors_follow_the_kernel():
    """The offset formula, the panel size, the boxes the host's tensor maps
    give and the act block's alignment, as the kernel source has them."""
    src = CSRC.read_text()
    assert ("return ((c >> 6) << 14) + (r << 7) + ((((c >> 3) & 7) ^ (r & 7)) << 4) + "
            "((c & 7) << 1);") in src
    assert "constexpr uint32_t kPanel = kRows * 128;" in src and PANEL_BYTES == ROWS * 128
    assert ("const cuuint32_t box[3] = {sw ? 64u : 8u, sw ? kRows / 2u : kRows, 1};" in src
            and PANEL_COLS == 64)
    assert "constexpr uint32_t kNActOff = 1024;" in src


@pytest.mark.parametrize("cols", WIDTHS)
def test_act_panels_store_every_element_once(cols):
    """A random block written as the epilogues write it (narrow_act_offset)
    and stored by TMA's 128-byte-swizzled boxes, one a panel and warpgroup
    (box row i's chunk j read at chunk j ^ (i % 8) of row i of the box's
    1024-byte-aligned start, columns past ``cols`` clipped), lands in the
    stash as the row-major matrix, each element once."""
    rng = np.random.default_rng(cols)
    m = rng.standard_normal((ROWS, cols)).astype(np.float32)
    nbytes = PANEL_BYTES * (-(-cols // PANEL_COLS))
    tile = np.full(nbytes // 2, np.nan, np.float32)  # 2-byte element slots
    for r in range(ROWS):
        for c in range(cols):
            tile[narrow_act_offset(r, c) // 2] = m[r, c]
    stash = np.full((ROWS, cols), np.nan, np.float32)
    boxes = narrow_stash_boxes(cols)
    assert sorted((r0, c0) for _, c0, r0, _ in boxes) == [
        (r0, c0) for r0 in (0, 64) for c0 in range(0, cols, PANEL_COLS)]
    for off, c0, r0, rows in boxes:
        assert off % 1024 == 0 and rows == 64  # a swizzle atom; a warpgroup's rows
        for i in range(rows):
            for j in range(8):
                c = c0 + 8 * j
                if c >= cols:
                    continue
                src = (off + i * 128 + ((j ^ (i & 7)) << 4)) // 2
                assert np.isnan(stash[r0 + i, c:c + 8]).all()  # no element lands twice
                stash[r0 + i, c:c + 8] = tile[src:src + 8]
    np.testing.assert_array_equal(stash, m)


@pytest.mark.parametrize("cols", WIDTHS)
def test_act_descriptor_reads_what_the_epilogue_wrote(cols):
    """The A operand of k16 step k for warpgroup w as the swizzled descriptor
    addresses it (start: panel k / 4 at 16 KB a panel, 32 bytes a step,
    8 KB a warpgroup; 8-row groups 1024 bytes apart, 128 bytes a row, 2 a
    value, then the 128-byte swizzle) is element (64 w + m, 16 k + kk) of the
    block the epilogues wrote, for every m < 64 and kk < 16."""
    for w in range(2):
        for k in range(-(-cols // 16)):
            start = (k >> 2) * PANEL_BYTES + (k & 3) * 32 + w * (PANEL_BYTES // 2)
            for m in range(64):
                for kk in range(16):
                    addr = start + (m // 8) * 1024 + (m % 8) * 128 + kk * 2
                    assert swizzle128(addr) == narrow_act_offset(64 * w + m, 16 * k + kk)


@pytest.mark.parametrize("cols", WIDTHS)
def test_encoding_boxes_store_every_element_once(cols):
    """An encoding tile (K-major core matrices: k-group g of 8 columns is the
    dense [128][8] run at 2048 g) stored one {8, 128} box a k-group lands in
    the stash as the row-major matrix."""
    rng = np.random.default_rng(cols + 1)
    m = rng.standard_normal((ROWS, cols)).astype(np.float32)
    tile = np.full(ROWS * cols, np.nan, np.float32)
    for r in range(ROWS):
        for k in range(cols):
            tile[tile_off(r, k) // 2] = m[r, k]
    stash = np.full((ROWS, cols), np.nan, np.float32)
    boxes = narrow_stash_boxes(cols, panels=False)
    assert [c0 for _, c0, _, _ in boxes] == list(range(0, cols, 8))
    for off, c0, r0, rows in boxes:
        assert off % 128 == 0 and (r0, rows) == (0, ROWS)  # TMA's shared-memory alignment
        stash[:, c0:c0 + 8] = tile[off // 2:off // 2 + 8 * ROWS].reshape(ROWS, 8)
    np.testing.assert_array_equal(stash, m)
