"""The whole-ray render kernel (csrc/fused_ray.cu), the train kernel
(csrc/fused_train.cu), the factored-encode kernel (csrc/fused_factored.cu)
and the row gather (csrc/gather_rows.cu) against their plain PyTorch
versions, on a CUDA card: PE and IPE, rays that fit a 128-row tile and rays
padded to 256 samples; the factored encode forward and backward at the main
path's widths and at small ones; the row gather at ragged N, with repeated
and out-of-table indices, and the hash-grid encodes through it. Every case
skips without one.

This file imports neither JAX nor the JAX package's tests, so it runs on
a machine with torch and CUDA alone (the repo's conftest.py needs JAX):

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from nerf_rs_tpu_torch.config import ModelConfig
from nerf_rs_tpu_torch.kernels import fused_factored as k3
from nerf_rs_tpu_torch.kernels import gather_rows as k4
from nerf_rs_tpu_torch.kernels.fused_ray import (
    fused_ray_render, fused_ray_render_reference)
from nerf_rs_tpu_torch.kernels.fused_render import pack_weights, pack_weights_t
from nerf_rs_tpu_torch.kernels.fused_train import (
    KERNEL_TOL, fused_train_grads, fused_train_grads_reference)
from nerf_rs_tpu_torch.models import hashgrid
from nerf_rs_tpu_torch.models.factored import basis_dim
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


def _intervals(n, s, dev, seed=0):
    """IPE inputs: rays, interval midpoints and exact lengths from sorted
    jittered edges, and cone radii around a pixel's footprint."""
    o, d, vd, _, _ = _rays(n, s, dev, seed)
    rng = np.random.default_rng(seed + 7)
    edges = torch.from_numpy(np.sort(rng.uniform(0.05, 2.0, (n, s + 1)), -1)
                             .astype(np.float32)).to(dev)
    mids = 0.5 * (edges[:, :-1] + edges[:, 1:])
    radii = torch.from_numpy(rng.uniform(2e-3, 2e-2, n).astype(np.float32)).to(dev)
    return o, d, vd, mids, edges[:, 1:] - edges[:, :-1], radii


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


# (field, sigma, IPE, rays, samples): the IPE branch, and rays padded to
# 256 samples (192: the hierarchical union pass; 193: the record preset's)
# or to a power of two (48)
BRANCH_CASES = [
    ({}, "softplus", True, 301, 64),
    (SMALL, "relu", True, 9, 128),
    (SMALL, "softplus", True, 5, 192),
    ({}, "relu", False, 37, 192),
    (SMALL, "softplus", False, 6, 193),
    (SMALL, "relu", False, 11, 48),
]


def _branch_rays(ipe, n, s, dev):
    if ipe:
        o, d, vd, mids, dl, radii = _intervals(n, s, dev)
        return (o, d, vd, mids, dl), radii
    return _rays(n, s, dev), None


@pytest.mark.parametrize("field,sigma_act,ipe,n,s", BRANCH_CASES)
def test_kernel_branches_match_plain_version(field, sigma_act, ipe, n, s):
    dev = _device()
    cfg = ModelConfig(sigma_activation=sigma_act, ipe=ipe, **field)
    model = init_nerf_params(cfg, 0, dev)
    rays, radii = _branch_rays(ipe, n, s, dev)
    args = (pack_weights(model, cfg), *rays, cfg, s)
    got = fused_ray_render(*args, radii=radii)
    torch.cuda.synchronize()
    want = fused_ray_render_reference(*args, radii=radii)
    for name, g, w, tol in zip(("rgb", "acc", "depth", "weights", "sigma"), got, want,
                               (1e-3, 1e-3, 2e-3, 1e-3, 2e-2)):
        assert g.shape == w.shape, name
        assert bool(torch.isfinite(g).all()), name
        assert float((g - w).abs().max()) <= tol, name


def _train_args(field, sigma_act, n, s, dev, ipe=False):
    cfg = ModelConfig(sigma_activation=sigma_act, ipe=ipe, **field)
    model = init_nerf_params(cfg, 0, dev)
    pk = pack_weights(model, cfg)
    gold = torch.from_numpy(np.random.default_rng(1).uniform(size=(n, 3)).astype(np.float32))
    rays, radii = _branch_rays(ipe, n, s, dev)
    return (pk, pack_weights_t(pk), *rays, gold.to(dev), cfg, s), radii


def _check_train(got, args, white, radii):
    """K2 against the plain version and the float64 witness at KERNEL_TOL."""
    for dtype in (torch.float32, torch.float64):
        want = fused_train_grads_reference(*args, white_bg=white, radii=radii, dtype=dtype)
        diag_err = float((got.diag[:, :5].double() - want.diag[:, :5]).abs().max())
        assert diag_err <= KERNEL_TOL["diag"], dtype
        assert got.weights.shape == want.weights.shape
        assert float((got.weights.double() - want.weights).abs().max()) <= KERNEL_TOL["weights"]
        for i, (g, w) in enumerate(zip(got.dw + got.db, want.dw + want.db)):
            assert bool(torch.isfinite(g).all()), i
            scale = max(float(w.abs().max()), 1e-12)
            assert float((g.double() - w).abs().max()) / scale <= KERNEL_TOL["grads"], (i, dtype)


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
    args, _ = _train_args(field, sigma_act, n, s, dev)
    before = fused_train_grads.launches
    got = fused_train_grads(*args, white_bg=white)
    torch.cuda.synchronize()
    assert fused_train_grads.launches == before + 1
    # the plain version, and the float64 witness with its rounding points
    _check_train(got, args, white, None)


@pytest.mark.parametrize("field,sigma_act,ipe,n,s", BRANCH_CASES)
def test_train_kernel_branches_match_plain_version(field, sigma_act, ipe, n, s):
    dev = _device()
    args, radii = _train_args(field, sigma_act, n, s, dev, ipe)
    got = fused_train_grads(*args, white_bg=True, radii=radii)
    torch.cuda.synchronize()
    _check_train(got, args, True, radii)


@pytest.mark.parametrize("s,ipe", [(64, False), (192, False), (128, True)])
def test_train_kernel_is_deterministic(s, ipe):
    dev = _device()
    args, radii = _train_args({}, "relu", 333, s, dev, ipe)
    a = fused_train_grads(*args, radii=radii)
    b = fused_train_grads(*args, radii=radii)
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


FAC_MAIN = ModelConfig(arch="factored", sigma_activation="softplus")  # sumR 1,014, C 48
FAC_SMALL = ModelConfig(arch="factored", fac_levels=3, fac_base_res=4, fac_max_res=16,
                        fac_comps=8, fac_aabb=1.0)


def _factored_inputs(cfg, n, dev, seed=0):
    """Lines, points inside and outside the AABB (a corner, a clipped
    point among them) and an encoding cotangent."""
    rng = np.random.default_rng(seed)
    lines = (0.25 * rng.normal(size=(3, basis_dim(cfg), cfg.fac_comps))).astype(np.float32)
    a = cfg.fac_aabb
    pts = rng.uniform(-1.2 * a, 1.2 * a, (n, 3)).astype(np.float32)
    pts[:2] = [[a, -a, a], [2 * a, 0.0, -2 * a]]
    g = rng.normal(size=(n, cfg.fac_comps)).astype(np.float32)
    return tuple(torch.from_numpy(x).to(dev) for x in (lines, pts, g))


def _check_factored(enc, d, lines, pts, g, cfg, dtype):
    """K3 against its plain versions at k3.KERNEL_TOL: enc absolute,
    d_lines per axis relative to the axis's largest entry."""
    want = k3.fused_factored_encode_reference(lines, pts, cfg, dtype)
    assert enc.shape == want.shape and bool(torch.isfinite(enc).all())
    assert float((enc - want).abs().max()) <= k3.KERNEL_TOL["enc"]
    want_d = k3.fused_factored_encode_backward_reference(lines, pts, g, cfg, dtype)
    for a in range(3):
        scale = float(want_d[a].abs().max())
        assert scale > 0
        assert float((d[a] - want_d[a]).abs().max()) / scale <= k3.KERNEL_TOL["d_lines"], a


@pytest.mark.parametrize("dtype", [torch.bfloat16, None], ids=["bf16", "f32"])
@pytest.mark.parametrize("cfg,n", [(FAC_MAIN, 100_003), (FAC_SMALL, 37)], ids=["main", "small"])
def test_factored_kernels_match_plain_versions(cfg, n, dtype):
    """Forward and backward, through the wrappers and through the
    autograd.Function (whose backward launches the backward kernel)."""
    dev = _device()
    lines, pts, g = _factored_inputs(cfg, n, dev)
    before = (k3.fused_factored_encode.launches, k3.fused_factored_encode_backward.launches)
    enc = k3.fused_factored_encode_forward(lines, pts, cfg, dtype)
    d = k3.fused_factored_encode_backward(lines, pts, g, cfg, dtype)
    torch.cuda.synchronize()
    assert (k3.fused_factored_encode.launches,
            k3.fused_factored_encode_backward.launches) == (before[0] + 1, before[1] + 1)
    _check_factored(enc, d, lines, pts, g, cfg, dtype)
    leaf = lines.clone().requires_grad_()
    out = k3.fused_factored_encode(leaf, pts.reshape(-1, 1, 3), cfg, dtype)
    assert out.shape == (n, 1, cfg.fac_comps)
    out.backward(g.reshape(n, 1, -1))
    assert torch.equal(out.detach().reshape(n, -1), enc) and torch.equal(leaf.grad, d)


def test_factored_backward_is_deterministic():
    dev = _device()
    lines, pts, g = _factored_inputs(FAC_MAIN, 300_001, dev, seed=1)
    a = k3.fused_factored_encode_backward(lines, pts, g, FAC_MAIN, torch.bfloat16)
    b = k3.fused_factored_encode_backward(lines, pts, g, FAC_MAIN, torch.bfloat16)
    assert torch.equal(a, b)


def test_factored_wrappers_refuse_what_the_kernels_do_not_take():
    dev = _device()
    lines, pts, g = _factored_inputs(FAC_SMALL, 8, dev)
    strided = torch.zeros(8, 6, device=dev)[:, ::2]
    with pytest.raises(ValueError, match="contiguous"):
        k3.fused_factored_encode_forward(lines, strided, FAC_SMALL)
    with pytest.raises(ValueError, match="f32"):
        k3.fused_factored_encode_forward(lines, pts.double(), FAC_SMALL)
    with pytest.raises(ValueError, match="f32"):
        k3.fused_factored_encode_backward(lines, pts, g.half(), FAC_SMALL)


@pytest.mark.parametrize("n", [0, 1, 37, 100_003])
def test_gather_kernels_match_plain_versions(n):
    """A gather copies: the kernels give the plain versions' bits, at
    ragged N, with repeated indices, and NaN where an index leaves the
    table (the kernel reads nothing there)."""
    dev = _device()
    rng = np.random.default_rng(n)
    table = torch.from_numpy(rng.normal(size=(5003, 128)).astype(np.float32)).to(dev)
    idx = rng.integers(0, 5003, n).astype(np.int32)
    idx[: n // 3] = idx[0] if n else 0  # a run of one repeated row
    idx[1::97] = -5  # outside the table
    idx[2::89] = 5003
    idx = torch.from_numpy(idx).to(dev)
    before = (k4.gather_rows.launches, k4.gather_pairs.launches)
    rows = k4.gather_rows(table, idx)
    flat = table.view(-1)
    pairs = k4.gather_pairs(flat, 2 * idx + 6)
    torch.cuda.synchronize()
    assert (k4.gather_rows.launches, k4.gather_pairs.launches) == (
        before[0] + (n > 0), before[1] + (n > 0))
    want_rows = k4.gather_rows_reference(table, idx)
    want_pairs = k4.gather_pairs_reference(flat, 2 * idx + 6)
    assert rows.shape == (n, 128) and pairs.shape == (n, 2)
    assert torch.equal(rows.isnan(), want_rows.isnan())
    assert torch.equal(rows.nan_to_num(), want_rows.nan_to_num())
    assert torch.equal(pairs.isnan(), want_pairs.isnan())
    assert torch.equal(pairs.nan_to_num(), want_pairs.nan_to_num())
    assert int(rows.isnan().any(-1).sum()) == int(((idx < 0) | (idx >= 5003)).sum())


def test_gather_wrappers_refuse_what_the_kernel_does_not_take():
    dev = _device()
    table = torch.zeros(64, 128, device=dev)
    idx = torch.zeros(8, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="even"):
        k4.gather_pairs(table.view(-1), idx + 1)
    with pytest.raises(ValueError, match="int32"):
        k4.gather_rows(table, idx.long())
    with pytest.raises(ValueError, match="contiguous"):
        k4.gather_rows(torch.zeros(64, 256, device=dev)[:, ::2], idx)
    with pytest.raises(ValueError, match="boundary"):
        k4.gather_rows(torch.zeros(64 * 128 + 1, device=dev)[1:].view(64, 128), idx)
    with pytest.raises(ValueError, match="boundary"):
        k4.gather_pairs(torch.zeros(65, device=dev)[1:], idx)
    with pytest.raises(ValueError, match="device"):
        k4.gather_rows(table, idx.cpu())


@pytest.mark.parametrize("brick", [True, False], ids=["brick", "flat"])
def test_hash_encodes_through_k4_match_the_cpu(brick):
    """The main widths' encode and its table gradient on the card (K4 on
    every fetch, index_add_'s atomics for the gradient) against the CPU's
    plain route: the same cells and weights, corner sums and gradient sums
    in another order."""
    dev = _device()
    cfg = ModelConfig(arch="hashgrid", hash_brick=brick)
    rng = np.random.default_rng(7)
    table = rng.normal(size=hashgrid.table_shape(cfg)).astype(np.float32)
    pts = rng.uniform(-2.0, 2.0, (300_001, 3)).astype(np.float32)
    g = rng.normal(size=(300_001, 32)).astype(np.float32)
    out = []
    for d in ("cpu", dev):
        t = torch.from_numpy(table).to(d).requires_grad_()
        before = (k4.gather_rows.launches, k4.gather_pairs.launches)
        enc = (hashgrid.brick_encode if brick else hashgrid.hash_encode)(
            t, torch.from_numpy(pts).to(d), cfg)
        (enc * torch.from_numpy(g).to(d)).sum().backward()
        launched = (k4.gather_rows.launches - before[0], k4.gather_pairs.launches - before[1])
        out.append((enc.detach().cpu(), t.grad.cpu(), launched))
    (enc_c, grad_c, none), (enc_g, grad_g, launched) = out
    assert none == (0, 0) and launched == ((3, 0) if brick else (0, 1))
    assert float((enc_g - enc_c).abs().max()) <= 1e-6 * float(enc_c.abs().max())
    assert float((grad_g - grad_c).abs().max()) <= 1e-5 * float(grad_c.abs().max())
