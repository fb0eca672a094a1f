"""nerf_rs_tpu_torch — the PyTorch / CUDA port of nerf_rs_tpu for one
NVIDIA H100.

The module tree mirrors ``nerf_rs_tpu`` so each counterpart is found by
name. Plain tensor code is PyTorch; the Pallas kernels the ported paths
run are CUDA C++ kernels for ``sm_90a`` here: the whole-ray render
kernel (``nerf_rs_tpu/kernels/fused_ray.py`` -> ``kernels/csrc/fused_ray.cu``),
the whole-ray train kernel (``nerf_rs_tpu/kernels/fused_train.py`` ->
``kernels/csrc/fused_train.cu``) and the factored-encode kernel, forward
and backward (``nerf_rs_tpu/kernels/fused_factored.py`` ->
``kernels/csrc/fused_factored.cu``, taken with ``ModelConfig.fac_fused``)
and the row gather of the hash grid's table fetch
(``nerf_rs_tpu/kernels/gather_rows.py`` -> ``kernels/csrc/gather_rows.cu``).
The whole-ray kernels carry mip-NeRF 360's contraction and (the train
kernel) its distortion loss; the hash grid's table gradient is a
fixed-order scatter beside the row gather. Every path of the JAX package
is ported: ``cli train``, ``eval``, ``render`` and ``export`` on every
dataset and preset, data parallelism over cards and scenes, and the
reference's ``--compat`` math, which runs through the eager field and
autograd (no kernel takes it, as in the JAX package).

The configuration dataclasses are the port's own copy (``config.py``).
This package imports neither ``jax`` nor anything of ``nerf_rs_tpu``.
"""

from .config import (
    CameraConfig,
    Config,
    DataConfig,
    ModelConfig,
    ProposalConfig,
    RenderConfig,
    TrainConfig,
)

__version__ = "0.1.0"

__all__ = ["CameraConfig", "Config", "DataConfig", "ModelConfig", "ProposalConfig",
           "RenderConfig", "TrainConfig"]
