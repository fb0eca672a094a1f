"""nerf_rs_tpu_torch — the PyTorch / CUDA port of nerf_rs_tpu for one
NVIDIA H100.

The module tree mirrors ``nerf_rs_tpu`` so each counterpart is found by
name. Plain tensor code is PyTorch; the whole-ray render kernel that the
JAX package wrote in Pallas (``nerf_rs_tpu/kernels/fused_ray.py``) is a
CUDA C++ kernel for ``sm_90a`` here (``kernels/csrc/fused_ray.cu``).

The configuration dataclasses are shared with the JAX package rather
than copied: ``nerf_rs_tpu.config`` is plain dataclasses and importing it
loads no JAX. This package itself never imports ``jax``.
"""

from nerf_rs_tpu.config import (
    CameraConfig,
    Config,
    ModelConfig,
    RenderConfig,
)

__version__ = "0.1.0"

__all__ = ["CameraConfig", "Config", "ModelConfig", "RenderConfig"]
