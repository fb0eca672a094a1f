"""Images with the standard library and numpy only (``zlib`` + ``struct``),
the counterpart of ``nerf_rs_tpu/data/images.py``, which needs PIL (the
card's machine has none).

``load_image`` decodes a PNG to (H, W, 4) uint8 RGBA, bit-equal to
``PIL.Image.open(path).convert("RGBA")``: colour types 0 (grey), 2 (RGB),
3 (palette), 4 (grey + alpha) and 6 (RGBA), bit depths 1, 2, 4 (grey and
palette), 8 and 16, the five scanline filters, a ``tRNS`` transparency and
every chunk's CRC. Sixteen-bit samples become 8 bits as PIL makes them: the
high byte of each sample of an RGB, RGBA or grey + alpha image, and a grey
value clipped to 255 (PIL opens 16-bit grey as a 16-bit integer image and
clips it on the way to RGBA); a grey of 1, 2 or 4 bits is scaled to 8. A
``tRNS`` colour makes a pixel transparent where the 8-bit values equal the
chunk's samples as written (a 1-bit grey's scaled to 255), as PIL compares
them. What it does not decode raises a ``ValueError``
that names the case: an interlaced (Adam7) PNG, and JPEG, which the card has
no decoder for. ``save_png`` writes 8-bit RGB or RGBA PNGs (``encode_png``
gives their bytes, for the event writer's images).

``save_gif`` writes an animated GIF89a (the JAX CLI's ``render --gif``
writes it through ``imageio``, which the card's machine lacks): a fixed
216-colour palette (six levels a channel, 51 apart), LZW-coded frames, a
frame delay of 1/fps s and the NETSCAPE2.0 loop block; ``gif_frames`` walks
a GIF's blocks and gives its screen and frame sizes.

``box_downsample``, ``get_image_paths``, ``load_images`` and
``load_multiview_dir`` are the JAX module's: the multiview layout is
``{dir}/image-{i}.png`` over ``start..end`` by ``step``, one
(N, H, W, 4) uint8 store.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import List, Tuple

import numpy as np
import torch

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(arr: np.ndarray) -> bytes:
    """The PNG bytes of an (H, W, 3|4) uint8 image: RGB or RGBA, 8 bits,
    unfiltered scanlines."""
    h, w, c = arr.shape
    if c not in (3, 4):
        raise ValueError(f"save_png takes 3 or 4 channels, got {c}")
    # each scanline: filter type 0 (none), then the raw bytes
    raw = np.concatenate([np.zeros((h, 1), np.uint8), arr.reshape(h, w * c)], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, 2 if c == 3 else 6, 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _chunk(b"IEND", b""))


def save_png(path: str, rgb) -> None:
    """Write a float [0, 1] (H, W, 3|4) array or tensor as an 8-bit RGB
    or RGBA PNG (values scaled by 255, clipped and truncated, as the JAX
    package writes them)."""
    if isinstance(rgb, torch.Tensor):
        rgb = rgb.detach().float().cpu().numpy()
    png = encode_png(np.clip(np.asarray(rgb, np.float32) * 255.0, 0, 255).astype(np.uint8))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(png)


GIF_LEVELS = 6  # palette levels a channel: 0, 51, ..., 255


def gif_palette() -> np.ndarray:
    """(256, 3) uint8: entry r * 36 + g * 6 + b is (51 r, 51 g, 51 b) for
    r, g, b in 0..5; the last 40 entries are black and unused."""
    pal = np.zeros((256, 3), np.uint8)
    i = np.arange(GIF_LEVELS ** 3)
    pal[i] = np.stack([i // 36, (i // 6) % 6, i % 6], -1) * (255 // (GIF_LEVELS - 1))
    return pal


def gif_indices(frame) -> np.ndarray:
    """A float [0, 1] (H, W, 3) frame as (H, W) uint8 palette indices: each
    channel to its nearest level."""
    if isinstance(frame, torch.Tensor):
        frame = frame.detach().float().cpu().numpy()
    q = np.rint(np.clip(np.asarray(frame, np.float32), 0.0, 1.0) * (GIF_LEVELS - 1))
    q = q.astype(np.int64)
    return (q[..., 0] * 36 + q[..., 1] * 6 + q[..., 2]).astype(np.uint8)


def lzw_encode(indices: bytes, min_size: int = 8) -> bytes:
    """GIF's variable-width LZW of a byte string (codes LSB first, from
    ``min_size`` + 1 bits up to 12; a clear code first and whenever the
    table fills; the end code last), in giflib's order: a code is written
    at the current width, the width grows once the next free code reaches
    it, then the new string takes that code."""
    clear, eoi = 1 << min_size, (1 << min_size) + 1
    out = bytearray()
    size, limit, nxt = min_size + 1, 1 << (min_size + 1), eoi + 1
    table = {}
    buf, nbits = clear, size  # the bit buffer, LSB first, holding the clear code
    prefix = indices[0]
    for c in indices[1:]:
        key = (prefix << 8) | c
        code = table.get(key)
        if code is not None:
            prefix = code
            continue
        buf |= prefix << nbits
        nbits += size
        while nbits >= 8:
            out.append(buf & 0xFF)
            buf >>= 8
            nbits -= 8
        if nxt >= limit and size < 12:
            size += 1
            limit <<= 1
        if nxt >= 4095:  # the table is full: start over
            buf |= clear << nbits
            nbits += size
            table.clear()
            size, limit, nxt = min_size + 1, 1 << (min_size + 1), eoi + 1
        else:
            table[key] = nxt
            nxt += 1
        prefix = c
    for code in (prefix, eoi):
        buf |= code << nbits
        nbits += size
        if code == prefix and nxt >= limit and size < 12:
            size += 1
            limit <<= 1
    while nbits > 0:
        out.append(buf & 0xFF)
        buf >>= 8
        nbits -= 8
    return bytes(out)


def save_gif(path: str, frames, fps: int = 10, loop: int = 0) -> None:
    """Write float [0, 1] (N, H, W, 3) frames (an array, a tensor or a list)
    as an animated GIF89a: the fixed palette (``gif_palette``), one
    LZW-coded image a frame, a delay of round(100 / fps) hundredths of a
    second, and ``loop`` repeats (0: forever)."""
    frames = [gif_indices(f) for f in frames]
    h, w = frames[0].shape
    out = bytearray(b"GIF89a")
    # logical screen: a global table of 256 colours (size field 7), 8 bits
    out += struct.pack("<HHBBB", w, h, 0xF7, 0, 0) + gif_palette().tobytes()
    out += b"\x21\xff\x0bNETSCAPE2.0\x03\x01" + struct.pack("<H", loop) + b"\x00"
    delay = int(round(100 / fps))
    for idx in frames:
        if idx.shape != (h, w):
            raise ValueError(f"GIF frames differ in size: {idx.shape} against {(h, w)}")
        out += b"\x21\xf9\x04\x00" + struct.pack("<H", delay) + b"\x00\x00"
        out += b"\x2c" + struct.pack("<HHHHB", 0, 0, w, h, 0)
        data = lzw_encode(idx.tobytes())
        out.append(8)
        for i in range(0, len(data), 255):
            block = data[i:i + 255]
            out.append(len(block))
            out += block
        out.append(0)
    out.append(0x3B)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(bytes(out))


def gif_frames(data: bytes) -> Tuple[Tuple[int, int], List[Tuple[int, int]]]:
    """((width, height) of the logical screen, [(width, height) of each
    image]) of a GIF, read by walking its blocks; raises ``ValueError`` on
    a malformed stream."""
    if data[:6] not in (b"GIF87a", b"GIF89a"):
        raise ValueError("not a GIF")
    w, h, packed = struct.unpack("<HHB", data[6:11])
    pos = 13 + (3 << ((packed & 7) + 1) if packed & 0x80 else 0)

    def skip_blocks(p):
        while True:
            if p >= len(data):
                raise ValueError("GIF data blocks run past the end")
            n = data[p]
            p += 1
            if n == 0:
                return p
            p += n

    images = []
    while pos < len(data):
        kind = data[pos]
        if kind == 0x3B:
            return (w, h), images
        if kind == 0x21:
            pos = skip_blocks(pos + 2)
        elif kind == 0x2C:
            iw, ih, ip = struct.unpack("<HHB", data[pos + 5:pos + 10])
            images.append((iw, ih))
            pos += 10 + (3 << ((ip & 7) + 1) if ip & 0x80 else 0)
            pos = skip_blocks(pos + 1)  # past the LZW code size
        else:
            raise ValueError(f"unknown GIF block 0x{kind:02x} at byte {pos}")
    raise ValueError("GIF without a trailer")


def _chunks(data: bytes, path: str):
    """(kind, payload) of every chunk, each CRC checked."""
    pos = len(_SIGNATURE)
    while pos + 12 <= len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, payload = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if len(payload) != n or zlib.crc32(kind + payload) & 0xFFFFFFFF != crc:
            raise ValueError(f"{path}: the {kind.decode('latin-1')} chunk fails its CRC")
        yield kind, payload
        if kind == b"IEND":
            return
        pos += 12 + n
    raise ValueError(f"{path}: the PNG ends before its IEND chunk")


def unfilter(raw: np.ndarray, ftype: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the PNG scanline filters (None, Sub, Up, Average, Paeth) of
    (H, rowbytes) filtered bytes, each row's type in ``ftype``; ``bpp`` is
    the bytes of one pixel (at least 1). A byte depends on its left
    neighbour (bpp bytes back), the one above and the one above-left, all
    reconstructed, so the pixels of one anti-diagonal of the image are
    independent: they are reconstructed together, one diagonal a step, in
    uint8 arithmetic modulo 256."""
    h, rowbytes = raw.shape
    if rowbytes % bpp:
        raise ValueError(f"a scanline of {rowbytes} bytes holds no whole {bpp}-byte pixels")
    if ftype.size and int(ftype.max()) > 4:
        raise ValueError(f"unknown PNG filter type {int(ftype.max())}")
    u = rowbytes // bpp
    src = raw.reshape(h, u, bpp).astype(np.int32)
    rec = np.zeros((h + 1, u + 1, bpp), np.int32)  # row 0 and column 0: the zero border
    for k in range(h + u - 1):
        ys = np.arange(max(0, k - u + 1), min(h, k + 1))
        xs = k - ys
        a, b, c = rec[ys + 1, xs], rec[ys, xs + 1], rec[ys, xs]
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        f = ftype[ys][:, None]
        pred = np.select([f == 1, f == 2, f == 3, f == 4],
                         [a, b, (a + b) >> 1, paeth], default=0)
        rec[ys + 1, xs + 1] = (src[ys, xs] + pred) & 255
    return rec[1:, 1:].reshape(h, rowbytes).astype(np.uint8)


def _samples(rows: np.ndarray, width: int, channels: int, depth: int) -> np.ndarray:
    """(H, W, channels) samples of unfiltered rows: sub-byte depths
    unpacked most significant bits first, 16-bit ones big-endian."""
    h = rows.shape[0]
    if depth == 8:
        return rows[:, :width * channels].reshape(h, width, channels)
    if depth == 16:
        v = rows[:, :width * channels * 2].reshape(h, width, channels, 2).astype(np.uint16)
        return (v[..., 0] << 8) | v[..., 1]
    bits = np.unpackbits(rows, axis=1)[:, :width * depth].reshape(h, width, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits * weights).sum(-1, dtype=np.uint8)[..., None]


def decode_png(data: bytes, path: str = "<png>") -> np.ndarray:
    """PNG bytes -> (H, W, 4) uint8 RGBA, as ``PIL.Image.open(...).convert(
    "RGBA")`` gives it (module docstring)."""
    if data[:8] != _SIGNATURE:
        kind = "a JPEG" if data[:3] == b"\xff\xd8\xff" else "not a PNG"
        raise ValueError(f"{path}: {kind} file; only PNG is decoded (the card has no JPEG "
                         f"decoder): convert the images to PNG")
    ihdr, idat, plte, trns = None, [], None, None
    for kind, payload in _chunks(data, path):
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", payload)
        elif kind == b"IDAT":
            idat.append(payload)
        elif kind == b"PLTE":
            plte = np.frombuffer(payload, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = payload
    if ihdr is None or not idat:
        raise ValueError(f"{path}: no IHDR or no IDAT chunk")
    width, height, depth, ctype, comp, filt, interlace = ihdr
    if ctype not in _CHANNELS or depth not in _DEPTHS[ctype] or comp or filt:
        raise ValueError(f"{path}: colour type {ctype} at bit depth {depth} (compression "
                         f"{comp}, filter method {filt}) is not a PNG this decoder reads")
    if interlace:
        raise ValueError(f"{path}: an interlaced (Adam7) PNG is not decoded; save it "
                         f"without interlacing")
    ch = _CHANNELS[ctype]
    rowbytes = (width * ch * depth + 7) // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size < height * (rowbytes + 1):
        raise ValueError(f"{path}: the image data ends early")
    raw = raw[:height * (rowbytes + 1)].reshape(height, rowbytes + 1)
    rows = unfilter(np.ascontiguousarray(raw[:, 1:]), raw[:, 0],
                    max(1, ch * depth // 8))
    s = _samples(rows, width, ch, depth)
    out = np.empty((height, width, 4), np.uint8)
    if ctype == 3:
        if plte is None:
            raise ValueError(f"{path}: a palette image without a PLTE chunk")
        idx = s[..., 0]
        alpha = np.full(256, 255, np.uint8)
        if trns is not None:
            alpha[:len(trns)] = np.frombuffer(trns, np.uint8)
        pal = np.zeros((256, 3), np.uint8)
        pal[:len(plte)] = plte
        out[..., :3], out[..., 3] = pal[idx], alpha[idx]
        return out
    if depth == 16:
        s8 = (np.minimum(s, 255) if ctype == 0 else s >> 8).astype(np.uint8)
    elif ctype == 0 and depth < 8:
        s8 = (s * (255 // ((1 << depth) - 1))).astype(np.uint8)
    else:
        s8 = s
    if ctype in (0, 4):
        out[..., :3] = s8[..., :1]
        out[..., 3] = s8[..., 1] if ctype == 4 else 255
    else:
        out[..., :3] = s8[..., :3]
        out[..., 3] = s8[..., 3] if ctype == 6 else 255
    if trns is not None and ctype in (0, 2):
        # as PIL: the 8-bit values against the chunk's samples as written
        # (a 1-bit grey's scaled to 0 / 255, as PIL's bilevel mode holds it)
        want = np.asarray(struct.unpack(f">{ch}H", trns[:2 * ch]))
        if depth == 1:
            want = want * 255
        out[..., 3][(s8[..., :ch] == want).all(-1)] = 0
    return out


def load_image(path: str) -> np.ndarray:
    """One PNG -> (H, W, 4) uint8 RGBA (the /255 normalisation happens on
    the device at gather time)."""
    with open(path, "rb") as f:
        return decode_png(f.read(), path)


def box_downsample(img: np.ndarray, factor: int) -> np.ndarray:
    """Area-averaged (box-filter) decimation by an integer factor: each
    output pixel is the mean of its factor x factor source block
    (trailing rows and columns past a whole block are cropped); integer
    images are rounded to nearest."""
    h, w = img.shape[:2]
    h2, w2 = h // factor, w // factor
    a = img[: h2 * factor, : w2 * factor].astype(np.float32)
    a = a.reshape(h2, factor, w2, factor, -1).mean(axis=(1, 3))
    if np.issubdtype(img.dtype, np.integer):
        return np.clip(np.rint(a), 0, 255).astype(img.dtype)
    return a.astype(img.dtype)


def get_image_paths(dir: str, start: int, end: int, step: int = 1) -> List[str]:
    """``{dir}/image-{i}.png`` for i in start..end by step."""
    if not start < end:
        raise ValueError("view_start must be < view_end")
    if (end - start) % step:
        raise ValueError("(view_end - view_start) must be divisible by view_step")
    return [os.path.join(dir, f"image-{i}.png") for i in range(start, end, step)]


def load_images(paths: List[str]) -> np.ndarray:
    """All views as one (N, H, W, 4) uint8 stack."""
    imgs = [load_image(p) for p in paths]
    shapes = {im.shape for im in imgs}
    if len(shapes) != 1:
        raise ValueError(f"inconsistent view shapes: {shapes}")
    return np.stack(imgs, axis=0)


def load_multiview_dir(dir: str, start: int, end: int,
                       step: int = 1) -> Tuple[np.ndarray, int, int]:
    """The reference's dataset layout; returns (images, H, W)."""
    imgs = load_images(get_image_paths(dir, start, end, step))
    return imgs, imgs.shape[1], imgs.shape[2]
