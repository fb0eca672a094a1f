"""Terminal presentation, the counterpart of ``nerf_rs_tpu/utils/term.py``:
a one-line loss sparkline and an ANSI half-block image preview (the
headless form of a live prediction window, printed at eval steps with
``--live_preview``). Plain Python and numpy.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

_BLOCKS = " ▁▂▃▄▅▆▇█"


def sparkline(values: Sequence[float], width: int = 60) -> str:
    vals = [v for v in values if v == v]  # drop NaNs
    if not vals:
        return ""
    if len(vals) > width:
        # bucket-average down to width
        n = len(vals)
        vals = [
            sum(vals[i * n // width : max(i * n // width + 1, (i + 1) * n // width)])
            / max(1, (i + 1) * n // width - i * n // width)
            for i in range(width)
        ]
    lo, hi = min(vals), max(vals)
    span = (hi - lo) or 1.0
    return "".join(_BLOCKS[int((v - lo) / span * (len(_BLOCKS) - 1))] for v in vals)


def image_preview(img, width: int = 48) -> str:
    """Render an image as ANSI-truecolor half blocks (▀: foreground =
    top pixel, background = bottom pixel — two rows per text line).

    ``img``: (H, W, 3+) float in [0, 1] or uint8. Box-averaged down to
    ``width`` columns (aspect preserved, terminal cells are ~2:1 tall).
    Pure string construction — callers decide when/where to print, so
    tests can assert on content without a tty.
    """
    a = np.asarray(img)[..., :3]
    if a.dtype == np.uint8:
        a = a.astype(np.float32) / 255.0
    a = np.clip(np.nan_to_num(np.asarray(a, np.float32)), 0.0, 1.0)
    h, w = a.shape[:2]
    width = max(2, min(width, w))
    height = max(2, round(h * width / w))
    height += height % 2  # half blocks consume rows in pairs
    # box-average via bucketed reduceat (uneven buckets fine)
    ys = (np.arange(height + 1) * h) // height
    xs = (np.arange(width + 1) * w) // width
    csum = np.zeros((h + 1, w + 1, 3), np.float64)
    csum[1:, 1:] = a.cumsum(axis=0).cumsum(axis=1)
    box = (csum[ys[1:, None], xs[None, 1:]] - csum[ys[:-1, None], xs[None, 1:]]
           - csum[ys[1:, None], xs[None, :-1]] + csum[ys[:-1, None], xs[None, :-1]])
    area = ((ys[1:, None] - ys[:-1, None]) * (xs[None, 1:] - xs[None, :-1]))
    small = (box / np.maximum(area, 1)[..., None] * 255.0).astype(np.uint8)
    lines = []
    for r in range(0, height, 2):
        cells = []
        for c in range(width):
            tr, tg, tb = small[r, c]
            br, bg, bb = small[r + 1, c]
            cells.append(
                f"\x1b[38;2;{tr};{tg};{tb}m\x1b[48;2;{br};{bg};{bb}m▀"
            )
        lines.append("".join(cells) + "\x1b[0m")
    return "\n".join(lines)
