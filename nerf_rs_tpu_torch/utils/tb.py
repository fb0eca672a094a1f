"""TensorBoard event files, the counterpart of ``nerf_rs_tpu/utils/tb.py``,
written without ``tensorboardX`` or ``tensorboard`` (the card's machine has
neither): ``TBLogger`` frames each ``Event`` protocol buffer as a TFRecord
(its length, the masked CRC32C of the length, the bytes, their masked
CRC32C) and encodes the few messages it needs by hand.

The run directory is ``{log_dir}/{run id}`` (a unix timestamp unless a
run name is given), holding one ``events.out.tfevents.{ts}.{host}`` file
whose first event carries ``file_version`` "brain.Event:2". The tags and
methods are the JAX logger's: ``scalars`` (``simple_value``), ``hparams``
(``hparams/{k}`` scalars at step 0), ``histogram`` (``np.histogram`` over
``bins`` bins, trimmed to the support as ``tensorboardX`` trims it),
``image`` ([0, 1] floats as an 8-bit RGB PNG from ``data/images.encode_png``),
``screen_coords``, ``ray_ts`` and ``point_maps``. ``NullLogger`` is a
non-primary rank's, which writes nothing.

Messages (field numbers of tensorflow's ``event.proto`` and
``summary.proto``): Event {1 wall_time double, 2 step int64, 3
file_version string, 5 summary}; Summary {1 value (repeated)}; Value {1
tag, 2 simple_value float, 4 image, 5 histo}; Image {1 height, 2 width, 3
colorspace, 4 encoded_image_string}; HistogramProto {1 min, 2 max, 3 num,
4 sum, 5 sum_squares (doubles), 6 bucket_limit, 7 bucket (packed
doubles)}.
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Dict, Optional

import numpy as np


def _crc32c_table():
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _crc32c_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli, reflected polynomial 0x82F63B78)."""
    c = 0xFFFFFFFF
    table = _CRC_TABLE
    for b in data:
        c = table[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    """The TFRecord checksum: the CRC rotated right by 15 bits plus a
    constant, modulo 2^32."""
    c = crc32c(data)
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def tfrecord(data: bytes) -> bytes:
    """One TFRecord: uint64 length, its masked CRC, the data, its masked CRC."""
    n = struct.pack("<Q", len(data))
    return (n + struct.pack("<I", masked_crc32c(n)) + data
            + struct.pack("<I", masked_crc32c(data)))


def _varint(v: int) -> bytes:
    v &= (1 << 64) - 1  # negative int64 as its two's complement
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _int(field: int, v: int) -> bytes:
    return _key(field, 0) + _varint(int(v))


def _double(field: int, v: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", float(v))


def _float(field: int, v: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", float(v))


def _bytes(field: int, b: bytes) -> bytes:
    return _key(field, 2) + _varint(len(b)) + b


def _packed_doubles(field: int, values) -> bytes:
    return _bytes(field, np.asarray(values, "<f8").tobytes())


def event(wall_time: float, step: int = 0, summary: Optional[bytes] = None,
          file_version: Optional[str] = None) -> bytes:
    """An ``Event`` message's bytes."""
    out = _double(1, wall_time) + (_int(2, step) if step else b"")
    if file_version is not None:
        out += _bytes(3, file_version.encode())
    if summary is not None:
        out += _bytes(5, summary)
    return out


def scalar_value(tag: str, v: float) -> bytes:
    return _bytes(1, _bytes(1, tag.encode()) + _float(2, v))


def histogram_value(tag: str, values: np.ndarray, bins: int) -> bytes:
    """A histogram ``Value``: ``np.histogram`` of the values (as float64)
    over ``bins`` bins, kept from the bin before the first non-empty one
    (or an empty bin in front) to the last non-empty one, with each bin's
    right edge as its limit, as ``tensorboardX``'s ``make_histogram``
    builds it."""
    values = np.asarray(values).reshape(-1).astype(float)
    if values.size == 0:
        raise ValueError("a histogram of no values")
    counts, limits = np.histogram(values, bins=bins)
    cum = np.cumsum(np.greater(counts, 0))
    start, end = np.searchsorted(cum, [0, cum[-1] - 1], side="right")
    start, end = int(start), int(end) + 1
    counts = counts[start - 1:end] if start > 0 else np.concatenate([[0], counts[:end]])
    limits = limits[start:end + 1]
    histo = (_double(1, values.min()) + _double(2, values.max()) + _double(3, len(values))
             + _double(4, values.sum()) + _double(5, values.dot(values))
             + _packed_doubles(6, limits) + _packed_doubles(7, counts))
    return _bytes(1, _bytes(1, tag.encode()) + _bytes(5, histo))


def image_value(tag: str, img: np.ndarray) -> bytes:
    """An image ``Value`` of an (H, W, C) uint8 array, PNG-encoded."""
    from ..data.images import encode_png

    h, w, c = img.shape
    msg = _int(1, h) + _int(2, w) + _int(3, c) + _bytes(4, encode_png(img))
    return _bytes(1, _bytes(1, tag.encode()) + _bytes(4, msg))


class TBLogger:
    """The event writer of one run: ``{log_dir}/{run_id}``, made at once."""

    def __init__(self, log_dir: str, run_id: Optional[str] = None):
        run_id = run_id or str(int(time.time()))
        self.dir = f"{log_dir}/{run_id}"
        os.makedirs(self.dir, exist_ok=True)
        now = time.time()
        self.path = os.path.join(self.dir,
                                 f"events.out.tfevents.{int(now)}.{socket.gethostname()}")
        self._f = open(self.path, "wb")
        self._write(event(now, file_version="brain.Event:2"))

    def _write(self, ev: bytes) -> None:
        if self._f is not None:
            self._f.write(tfrecord(ev))

    def _summary(self, values: bytes, step: int) -> None:
        self._write(event(time.time(), step, summary=values))
        self.flush()

    def scalars(self, values: Dict[str, float], step: int):
        for k, v in values.items():
            self._write(event(time.time(), step, summary=scalar_value(k, float(v))))
        self.flush()

    def hparams(self, hp: Dict[str, float]):
        """The hparams as scalars ``hparams/{k}`` at step 0."""
        self.scalars({f"hparams/{k}": v for k, v in hp.items()}, 0)

    def histogram(self, tag: str, values: np.ndarray, step: int, bins: int = 100):
        self._summary(histogram_value(tag, values, bins), step)

    def screen_coords(self, coords_xy: np.ndarray, step: int):
        """``screen_x`` / ``screen_y`` histograms of the batch's pixels."""
        c = np.asarray(coords_xy)
        self.histogram("screen_x", c[..., 0], step)
        self.histogram("screen_y", c[..., 1], step)

    def ray_ts(self, ts: np.ndarray, step: int):
        """The ``t`` histogram of sample distances."""
        self.histogram("t", ts, step)

    def image(self, tag: str, rgb: np.ndarray, step: int):
        """An (H, W) or (H, W, 1|3) float [0, 1] image: clipped, scaled
        by 255 and truncated to 8 bits; a grey one as RGB, as
        ``tensorboardX`` writes it."""
        img = np.clip(np.asarray(rgb, np.float32), 0.0, 1.0)
        if img.ndim == 2:
            img = img[..., None]
        if img.shape[-1] == 1:
            img = np.repeat(img, 3, axis=-1)
        self._summary(image_value(tag, (img * 255.0).astype(np.uint8)), step)

    def point_maps(self, points: np.ndarray, step: int, weights=None, res: int = 100,
                   prefix: str = "world"):
        """Occupancy (or weighted) maps of points projected on the yx, zx
        and yz world planes over [-2, 2]^2, res x res, normalised to their
        largest bin."""
        p = np.asarray(points).reshape(-1, 3)
        w = None if weights is None else np.asarray(weights).reshape(-1)
        for name, (a, b) in {"yx": (1, 0), "zx": (2, 0), "yz": (1, 2)}.items():
            img, _, _ = np.histogram2d(p[:, a], p[:, b], bins=res, range=[[-2, 2], [-2, 2]],
                                       weights=w)
            m = img.max()
            if m > 0:
                img = img / m
            self.image(f"{prefix}_{name}", img[..., None], step)

    def flush(self):
        if self._f is not None:
            self._f.flush()

    def close(self):
        if self._f is not None:
            self._f.close()
            self._f = None



class NullLogger(TBLogger):
    """The logger of a rank that is not the primary: no run directory, no
    file, and no event encoded (``train/loop`` gates on
    ``dist_init.is_primary``), the JAX package's ``NullLogger``."""

    def __init__(self):  # no directory, no file
        self.dir = self.path = self._f = None

    def scalars(self, values: Dict[str, float], step: int):
        pass

    def histogram(self, tag: str, values: np.ndarray, step: int, bins: int = 100):
        pass

    def image(self, tag: str, rgb: np.ndarray, step: int):
        pass
