"""PNG output with the standard library only (``zlib`` + ``struct``), the
counterpart of ``save_png`` in ``nerf_rs_tpu/data/images.py``, which
needs PIL. Loading image datasets comes with slice 6 of the port.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np
import torch


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def save_png(path: str, rgb) -> None:
    """Write a float [0, 1] (H, W, 3|4) array or tensor as an 8-bit RGB
    or RGBA PNG (values scaled by 255, clipped and truncated, as the JAX
    package writes them)."""
    if isinstance(rgb, torch.Tensor):
        rgb = rgb.detach().float().cpu().numpy()
    arr = np.clip(np.asarray(rgb, np.float32) * 255.0, 0, 255).astype(np.uint8)
    h, w, c = arr.shape
    if c not in (3, 4):
        raise ValueError(f"save_png takes 3 or 4 channels, got {c}")
    # each scanline: filter type 0 (none), then the raw bytes
    raw = np.concatenate([np.zeros((h, 1), np.uint8), arr.reshape(h, w * c)], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, 2 if c == 3 else 6, 0, 0, 0)
    png = (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", header)
           + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
           + _chunk(b"IEND", b""))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(png)
