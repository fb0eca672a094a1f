"""ctypes binding to the port's C++ host batch assembler
(``data/batch_loader.cc``), the counterpart of
``nerf_rs_tpu/data/native_loader.py``.

``load`` builds the source with ``g++`` at first use into
``kernels/_build/`` (git-ignored; the library's name carries a hash of the
source and flags, so an unchanged source is not rebuilt) and raises when
the build fails: a run that asks for the native loader
(``--use_native_loader true``) gets it or an error, never a quiet numpy
fallback. ``gather_gold`` is the gather of ``pipeline.HostSampler``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "batch_loader.cc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "kernels" / "_build"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")


def library_path() -> Path:
    """Where the library of the current source and flags lands."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode() + SRC.read_bytes())
    return BUILD_DIR / f"libnerf_host-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``batch_loader.cc`` unless its library exists; raises with
    the compiler's output when the build fails."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    try:
        proc = subprocess.run(["g++", *GXX_FLAGS, str(SRC), "-o", str(tmp)],
                              capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError("the native batch loader needs g++, which is not on the PATH "
                           "(run with --use_native_loader false)") from e
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed on {SRC.name} (exit {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent build never sees a torn file
    return lib


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """The built library, built on first use (raises if it cannot be)."""
    lib = ctypes.CDLL(str(build()))
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.nerf_gather_gold.argtypes = [
        u8p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        i32p, i32p, i32p, ctypes.c_int64, ctypes.c_int32, f32p,
    ]
    lib.nerf_gather_gold.restype = None
    return lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _store(images: np.ndarray) -> np.ndarray:
    if images.dtype != np.uint8 or images.ndim != 4 or images.shape[-1] != 4:
        raise ValueError(f"the native loader takes a (V, H, W, 4) uint8 store, got "
                         f"{images.dtype} {images.shape}")
    return np.ascontiguousarray(images)


def gather_gold(images: np.ndarray, view_idx: np.ndarray, xi: np.ndarray, yi: np.ndarray,
                white_background: bool) -> np.ndarray:
    """HostSampler's gather: (n,) indices -> (n, 3) f32 gold."""
    lib = load()
    images = _store(images)
    view_idx, xi, yi = (np.ascontiguousarray(a, np.int32) for a in (view_idx, xi, yi))
    v, h, w = images.shape[:3]
    if len(view_idx) and (view_idx.min() < 0 or view_idx.max() >= v or xi.min() < 0
                          or xi.max() >= w or yi.min() < 0 or yi.max() >= h):
        raise ValueError("a pixel index lies outside the store")
    out = np.empty((view_idx.shape[0], 3), np.float32)
    lib.nerf_gather_gold(_ptr(images, ctypes.c_uint8), v, h, w,
                         _ptr(view_idx, ctypes.c_int32), _ptr(xi, ctypes.c_int32),
                         _ptr(yi, ctypes.c_int32), view_idx.shape[0], int(white_background),
                         _ptr(out, ctypes.c_float))
    return out
