"""The whole-ray render kernel (csrc/fused_ray.cu) and train kernel
(csrc/fused_train.cu) against their plain PyTorch versions, on a CUDA
card. Every case skips without one.

This file imports neither JAX nor the JAX package's tests, so it runs on
a machine with torch and CUDA alone (the repo's conftest.py needs JAX):

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from nerf_rs_tpu.config import ModelConfig
from nerf_rs_tpu_torch.kernels.fused_ray import (
    fused_ray_render, fused_ray_render_reference)
from nerf_rs_tpu_torch.kernels.fused_render import pack_weights, pack_weights_t
from nerf_rs_tpu_torch.kernels.fused_train import (
    KERNEL_TOL, fused_train_grads, fused_train_grads_reference)
from nerf_rs_tpu_torch.models.mlp import init_nerf_params

SMALL = dict(net_depth=4, net_width=64, skip_layer=2, feature_width=64,
             view_head_width=32)


def _device() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version: full f32
    return torch.device("cuda")


def _rays(n, s, dev, seed=0):
    rng = np.random.default_rng(seed)
    o = torch.from_numpy((rng.normal(size=(n, 3)) * 0.2).astype(np.float32)).to(dev)
    d = torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32)).to(dev)
    vd = torch.nn.functional.normalize(d, dim=-1)
    ts = torch.from_numpy(np.sort(rng.uniform(0.05, 2.0, (n, s)), -1).astype(np.float32)).to(dev)
    dl = torch.cat([ts[:, 1:], torch.full_like(ts[:, :1], 2.0)], -1) - ts
    return o, d, vd, ts, dl


# (field, sigma, rays, samples): flagship and small widths, both sigma
# activations, tiles of 2, 8 and 1 rays, ragged tails
CASES = [
    ({}, "relu", 1001, 64),
    ({}, "softplus", 3, 64),
    (SMALL, "relu", 37, 16),
    (SMALL, "softplus", 5, 128),
]


@pytest.mark.parametrize("field,sigma_act,n,s", CASES)
def test_kernel_matches_plain_version(field, sigma_act, n, s):
    dev = _device()
    cfg = ModelConfig(sigma_activation=sigma_act, **field)
    model = init_nerf_params(cfg, 0, dev)
    args = (pack_weights(model, cfg), *_rays(n, s, dev), cfg, s)
    before = fused_ray_render.launches
    got = fused_ray_render(*args)
    torch.cuda.synchronize()
    assert fused_ray_render.launches == before + 1
    want = fused_ray_render_reference(*args)
    # same bf16 operands and f32 sums; the summation order can flip one
    # bf16 ulp of a hidden activation (chip_smoke.py's bars)
    for name, g, w, tol in zip(("rgb", "acc", "depth", "weights", "sigma"), got, want,
                               (1e-3, 1e-3, 2e-3, 1e-3, 2e-2)):
        assert g.shape == w.shape, name
        assert bool(torch.isfinite(g).all()), name
        assert float((g - w).abs().max()) <= tol, name


def _train_args(field, sigma_act, n, s, dev):
    cfg = ModelConfig(sigma_activation=sigma_act, **field)
    model = init_nerf_params(cfg, 0, dev)
    pk = pack_weights(model, cfg)
    gold = torch.from_numpy(np.random.default_rng(1).uniform(size=(n, 3)).astype(np.float32))
    return (pk, pack_weights_t(pk), *_rays(n, s, dev), gold.to(dev), cfg, s)


# (field, sigma, white background, rays, samples): flagship and small
# widths, both sigma activations, background on and off, ragged tails
TRAIN_CASES = [
    ({}, "relu", False, 1001, 64),
    ({}, "softplus", True, 37, 64),
    (SMALL, "relu", True, 37, 16),
    (SMALL, "softplus", False, 5, 128),
]


@pytest.mark.parametrize("field,sigma_act,white,n,s", TRAIN_CASES)
def test_train_kernel_matches_plain_version(field, sigma_act, white, n, s):
    dev = _device()
    args = _train_args(field, sigma_act, n, s, dev)
    before = fused_train_grads.launches
    got = fused_train_grads(*args, white_bg=white)
    torch.cuda.synchronize()
    assert fused_train_grads.launches == before + 1
    # the plain version, and the float64 witness with its rounding points
    for dtype in (torch.float32, torch.float64):
        want = fused_train_grads_reference(*args, white_bg=white, dtype=dtype)
        diag_err = float((got.diag[:, :5].double() - want.diag[:, :5]).abs().max())
        assert diag_err <= KERNEL_TOL["diag"], dtype
        assert float((got.weights.double() - want.weights).abs().max()) <= KERNEL_TOL["weights"]
        for i, (g, w) in enumerate(zip(got.dw + got.db, want.dw + want.db)):
            assert bool(torch.isfinite(g).all()), i
            scale = max(float(w.abs().max()), 1e-12)
            assert float((g.double() - w).abs().max()) / scale <= KERNEL_TOL["grads"], (i, dtype)


def test_train_kernel_is_deterministic():
    dev = _device()
    args = _train_args({}, "relu", 333, 64, dev)
    a = fused_train_grads(*args)
    b = fused_train_grads(*args)
    for x, y in zip((a.diag, a.weights, *a.dw, *a.db), (b.diag, b.weights, *b.dw, *b.db)):
        assert torch.equal(x, y)


def test_wrapper_refuses_non_contiguous_rays():
    dev = _device()
    cfg = ModelConfig(**SMALL)
    model = init_nerf_params(cfg, 0, dev)
    o, d, vd, ts, dl = _rays(8, 16, dev)
    strided = torch.zeros(8, 6, device=dev)[:, ::2]
    with pytest.raises(ValueError, match="contiguous"):
        fused_ray_render(pack_weights(model, cfg), strided, d, vd, ts, dl, cfg, 16)
