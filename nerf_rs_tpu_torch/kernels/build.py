"""Build the port's CUDA kernels at first use, from the sources under
``kernels/csrc/`` only.

Each kernel file compiles with ``nvcc`` into a shared library with a
plain C entry point, loaded with ``ctypes`` (no PyTorch headers: a build
takes seconds). Libraries land in ``kernels/_build/`` (git-ignored)
under a name that carries a hash of the sources and flags, so a rerun
with unchanged sources does not rebuild. A failed build raises with
nvcc's stderr; ptxas' register and spill report of a successful build
is kept beside the library as ``.log``.

``device_table`` holds the small integer tables that the kernels read from
device memory instead of their launch parameters (K1's and K2's matrix
offsets, K3's levels, ``scatter_rows``' lanes), so that no depth, level
count or lane count outgrows the parameters.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        nvcc = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(nvcc):
            return nvcc
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return nvcc


def library_path(name: str) -> Path:
    """Where the library of ``csrc/{name}.cu`` lands for the current
    sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/{name}.cu`` unless the library for the current
    sources exists; returns the library's path."""
    lib = library_path(name)
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    src = CSRC / f"{name}.cu"
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed on {src.name} (exit {proc.returncode}):\n{proc.stderr}")
    lib.with_suffix(".log").write_text(proc.stderr)
    os.replace(tmp, lib)  # atomic: concurrent builders never see a torn file
    return lib


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/{name}.cu``, built on first use."""
    return ctypes.CDLL(str(build(name)))


@functools.lru_cache(maxsize=256)
def device_table(values: tuple, device, dtype):
    """``values`` as a 1-D ``dtype`` tensor on ``device``, copied once per
    values, device and dtype: a launch that reads it adds no host-to-device
    copy."""
    import torch

    return torch.tensor(values, dtype=dtype).to(device)
