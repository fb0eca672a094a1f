"""The whole-ray render kernel (csrc/fused_ray.cu), the train kernel
(csrc/fused_train.cu), the factored-encode kernel (csrc/fused_factored.cu)
and the row gather (csrc/gather_rows.cu) against their plain PyTorch
versions, on a CUDA card: PE and IPE, rays that fit a 128-row tile and rays
padded to 256 samples, the contraction and distortion-loss branches of both
whole-ray kernels; the factored encode forward and backward at the main
path's widths and at small ones, the backward also on ray-ordered and
shuffled points, with every level staged and with a per-axis table larger
than a CTA's shared memory, and its d_feat kernel alone; the row gather at
ragged N, with repeated and out-of-table indices, the hash-grid encodes
through it, its fixed-order scatter, and the hash grid's table bits across
two train steps; since the repairs of faults 15-17, K1 and K2 past depth 123 and at
position encodings no narrow layout holds, K3 past 256 levels, the gather at
any row width and the scatter at any lane count and width. Every case skips
without one.

This file imports neither JAX nor the JAX package's tests, so it runs on
a machine with torch and CUDA alone (the repo's conftest.py needs JAX):

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import ctypes
import re

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
    BLOCKED_TOL, DW_TOL, KERNEL_TOL, fused_train_grads, fused_train_grads_reference)
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


def _biased_model(cfg, dev, seed=0):
    """init_nerf_params' seed-0 field with every bias drawn from N(0, 0.1^2)
    (numpy, ``seed``): its own biases are all zero, so a kernel that left
    one out would still match its plain version on them."""
    model = init_nerf_params(cfg, 0, dev)
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.rsplit(".", 1)[-1] == "b":
                p.copy_(torch.from_numpy(rng.normal(0.0, 0.1, tuple(p.shape))
                                         .astype(np.float32)))
    return model


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
    model = _biased_model(cfg, dev)
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


# (field, sigma, IPE, rays, samples): the IPE branch, rays run as 192
# samples, two a CTA in three passes (192: the hierarchical union pass;
# 150 padded to 192), rays padded to 256 (193: the record preset's) or to a
# power of two (48)
BRANCH_CASES = [
    ({}, "softplus", True, 301, 64),
    (SMALL, "relu", True, 9, 128),
    (SMALL, "softplus", True, 5, 192),
    ({}, "relu", False, 37, 192),
    (SMALL, "softplus", False, 6, 193),
    (SMALL, "relu", False, 11, 48),
    ({}, "softplus", False, 4103, 150),
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
    model = _biased_model(cfg, dev)
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


# K1's wgmma kernel on every branch (field, sigma, IPE, contraction, rays,
# samples): S as padded_samples takes them (1, 64, 128; 150 and 192 run as
# 192, two rays a CTA in three passes; 193 and 256 as 256; 300 as 384 and
# 640, one ray a CTA in S / 128 passes on the streamed instance), one ray,
# 4,103 rays and odd CTA counts (a cluster's second CTA past the last ray),
# and the instances for other widths than the paper's (SMALL)
K1_CASES = [
    ({}, "relu", False, False, 4103, 1),  # 33 CTAs
    ({}, "relu", False, False, 1, 64),
    ({}, "softplus", False, False, 4103, 64),
    ({}, "softplus", True, False, 5, 128),  # 5 CTAs
    ({}, "relu", False, True, 4103, 150),
    ({}, "softplus", True, True, 5, 192),  # 3 CTAs
    ({}, "relu", True, False, 1, 193),
    ({}, "softplus", False, True, 4103, 256),
    (SMALL, "relu", False, False, 7, 64),
    (SMALL, "softplus", True, True, 9, 192),
    ({}, "relu", False, False, 5, 300),
    ({}, "softplus", True, True, 37, 640),
    (SMALL, "relu", False, False, 7, 384),
]


@pytest.mark.parametrize("field,sigma_act,ipe,contract,n,s", K1_CASES)
def test_wgmma_kernel_matches_plain_version_on_every_branch(field, sigma_act, ipe, contract, n,
                                                             s):
    """K1 against its plain version at chip_smoke.TOL's bars (two bf16
    roundings may flip between the two summation orders; the depth bar is
    for t up to 2), and a rerun bit-identical."""
    dev = _device()
    cfg = ModelConfig(sigma_activation=sigma_act, ipe=ipe, contract=contract, **field)
    model = init_nerf_params(cfg, 0, dev)
    rays, radii = _branch_rays(ipe, n, s, dev)
    args = (pack_weights(model, cfg), *rays, cfg, s)
    got = fused_ray_render(*args, radii=radii)
    again = fused_ray_render(*args, radii=radii)
    torch.cuda.synchronize()
    want = fused_ray_render_reference(*args, radii=radii)
    for name, g, a, w, tol in zip(("rgb", "acc", "depth", "weights", "sigma"), got, again, want,
                                  (1e-3, 1e-3, 2e-3, 1e-3, 2e-2)):
        assert g.shape == w.shape, name
        assert bool(torch.isfinite(g).all()), name
        assert float((g - w).abs().max()) <= tol, name
        assert torch.equal(g, a), name


@pytest.mark.parametrize("field,sigma_act,ipe,contract,n,s", K1_CASES)
def test_wgmma_kernel_starts_every_sum_from_its_bias(field, sigma_act, ipe, contract, n, s):
    """K1 with random biases in every layer (init_nerf_params' are all
    zero, and a kernel that left a column's bias out would match its plain
    version on them), on every branch: the mean of each output's |K1 -
    plain| within a tenth of chip_smoke.TOL's bar. A bias left out moves
    every ray (~1e-1 of rgb); what the two summation orders part by is
    isolated: a bf16 rounding of a hidden activation that lands on the
    other side, which with biases can reach past the bars at S = 1, where
    one sample carries the whole ray."""
    dev = _device()
    cfg = ModelConfig(sigma_activation=sigma_act, ipe=ipe, contract=contract, **field)
    pk = pack_weights(_biased_model(cfg, dev), cfg)
    rays, radii = _branch_rays(ipe, n, s, dev)
    got = fused_ray_render(pk, *rays, cfg, s, radii=radii)
    torch.cuda.synchronize()
    want = fused_ray_render_reference(pk, *rays, cfg, s, radii=radii)
    for name, g, w, tol in zip(("rgb", "acc", "depth", "weights", "sigma"), got, want,
                               (1e-3, 1e-3, 2e-3, 1e-3, 2e-2)):
        assert g.shape == w.shape, name
        assert bool(torch.isfinite(g).all()), name
        assert float((g - w).abs().mean()) <= tol / 10, name


def _train_args(field, sigma_act, n, s, dev, ipe=False):
    cfg = ModelConfig(sigma_activation=sigma_act, ipe=ipe, **field)
    model = init_nerf_params(cfg, 0, dev)
    pk = pack_weights(model, cfg)
    gold = torch.from_numpy(np.random.default_rng(1).uniform(size=(n, 3)).astype(np.float32))
    rays, radii = _branch_rays(ipe, n, s, dev)
    return (pk, pack_weights_t(pk), *rays, gold.to(dev), cfg, s), radii


def _check_train(got, args, white, radii, **dist):
    """K2 against the plain version and the float64 witness at KERNEL_TOL
    (diag slot 5, the distortion loss, among the diag columns)."""
    for dtype in (torch.float32, torch.float64):
        want = fused_train_grads_reference(*args, white_bg=white, radii=radii, dtype=dtype,
                                           **dist)
        diag_err = float((got.diag[:, :6].double() - want.diag[:, :6]).abs().max())
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
    ({}, "relu", True, 37, 300),
    (SMALL, "softplus", False, 5, 512),
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


@pytest.mark.parametrize("s,ipe", [(64, False), (192, False), (128, True), (300, False),
                                  (300, True)])
def test_train_kernel_is_deterministic(s, ipe):
    dev = _device()
    args, radii = _train_args({}, "relu", 333, s, dev, ipe)
    a = fused_train_grads(*args, radii=radii)
    b = fused_train_grads(*args, radii=radii)
    for x, y in zip((a.diag, a.weights, *a.dw, *a.db), (b.diag, b.weights, *b.dw, *b.db)):
        assert torch.equal(x, y)



# (net, feature, view head widths, rays, samples): the flagship call, the
# hierarchical union pass (192), one block of the 300-sample call, 512 and
# 1024 wide (clusters of four and eight CTAs), the padded widths
K2B_CASES = [
    ((256, 256, 128), 4096, 64),
    ((256, 256, 128), 4096, 192),
    ((256, 256, 128), 2048, 300),
    ((512, 512, 256), 1024, 64),
    ((1024, 256, 128), 1024, 64),
    ((40, 40, 24), 4096, 64),
    ((100, 100, 50), 1001, 192),
]


def _k2b_args(widths, n, s, dev):
    w, f, v = widths
    field = dict(net_width=w, feature_width=f, view_head_width=v)
    cfg = ModelConfig(**field)
    model = _biased_model(cfg, dev)
    pk = pack_weights(model, cfg)
    gold = torch.from_numpy(np.random.default_rng(1).uniform(size=(n, 3)).astype(np.float32))
    rays, _ = _branch_rays(False, n, s, dev)
    return (pk, pack_weights_t(pk), *rays, gold.to(dev), cfg, s)


@pytest.mark.parametrize("widths,n,s", K2B_CASES)
def test_dw_kernel_matches_the_float64_product_of_its_stashes(widths, n, s):
    """K2b alone: every job's dW (and its bias sums from ``bias_col0`` on)
    against the float64 A^T G (sum_rows G) of the stashes K2a left in the
    call's scratch, read back through ``stash_views``, at DW_TOL."""
    from nerf_rs_tpu_torch.kernels import fused_train
    from nerf_rs_tpu_torch.kernels.fused_ray import padded_samples

    dev = _device()
    args = _k2b_args(widths, n, s, dev)
    pk = args[0]
    S = padded_samples(s)
    assert len(fused_train.ray_blocks(n, S, fused_train.block_rows(pk, S))) == 1
    total = pk.w.numel() + pk.b.numel()
    nbytes = fused_train._library().nerf_fused_train_scratch_bytes(
        n, S, pk.depth, pk.W, pk.F, pk.V, pk.P, pk.D, total)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    got = fused_train_grads(*args, scratch=scratch)
    torch.cuda.synchronize()
    views = fused_train.stash_views(scratch, pk, n, s)
    rows = views["rows"]

    def stash(name, layer):
        t = views[name]
        return (t[layer] if t.dim() == 3 else t)[:rows].double()

    for job in fused_train.dw_jobs(pk):
        a, g = stash(job.a, job.a_layer), stash(job.g, job.g_layer)
        want = a.t() @ g
        dw = got.dw[pk.w_off.index(job.out)]
        assert dw.shape == want.shape, job
        err = float((dw.double() - want).abs().max()) / max(float(want.abs().max()), 1e-30)
        assert err <= DW_TOL, (job, err)
        if job.bias_out >= 0:
            db = got.db[pk.b_off.index(job.bias_out - pk.w.numel())]
            want_b = g[:, job.bias_col0:].sum(0)
            err = (float((db[job.bias_col0:job.N].double() - want_b).abs().max())
                   / max(float(want_b.abs().max()), 1e-30))
            assert err <= DW_TOL, (job, "bias", err)


@pytest.mark.parametrize("widths,n,s", K2B_CASES[:2] + [((256, 256, 128), 4096, 300)]
                         + K2B_CASES[3:])
def test_dw_kernel_reruns_bit_for_bit(widths, n, s):
    """Two calls on the same inputs give the same gradient bits (no float
    atomics: each partial element has one writer, the splits and blocks are
    summed in a fixed order), at the flagship call, S = 192, the 300-sample
    call in its two blocks, 512 and 1024 wide and the padded widths."""
    dev = _device()
    args = _k2b_args(widths, n, s, dev)
    a = fused_train_grads(*args)
    b = fused_train_grads(*args)
    for x, y in zip((*a.dw, *a.db), (*b.dw, *b.db)):
        assert torch.equal(x, y)


# K2a's narrow instance (train_narrow_kernel, then train_narrow_bwd_kernel: the
# route C takes for every field up to 256 wide): (field, sigma, IPE, the
# contraction with the disparity distortion loss, white background, rays, S):
# one pass (64, 128), 150 and 192 as 192 (two rays a tile, three passes), 193
# and 256 as 256, 300 as 384, 4,103 ragged rays (an odd tile count: a cluster's
# second tile past the last ray), padded widths, the widest encoding of the
# paper widths' tests (P = 128)
NARROW_CASES = [
    ({}, "relu", False, False, True, 4103, 64),
    ({}, "softplus", False, False, False, 4103, 150),
    ({}, "relu", False, False, True, 4103, 192),
    ({}, "softplus", True, False, True, 1001, 193),
    ({}, "relu", False, False, False, 37, 256),
    ({}, "softplus", False, False, True, 37, 300),
    ({}, "softplus", True, False, False, 4103, 128),
    ({}, "softplus", False, True, False, 301, 64),
    ({}, "relu", True, True, True, 37, 192),
    (dict(net_width=40, feature_width=40, view_head_width=24), "softplus", False, False, True,
     37, 64),
    (dict(net_width=100, feature_width=100, view_head_width=50), "relu", True, False, True, 37,
     192),
    (dict(pos_enc_levels=20), "softplus", False, False, True, 37, 64),
]


@pytest.mark.parametrize("field,sigma_act,ipe,contract,white,n,s", NARROW_CASES)
def test_narrow_instance_matches_plain_version(field, sigma_act, ipe, contract, white, n, s):
    """K2 on its narrow instance, random biases: against the plain version
    and the float64 witness at KERNEL_TOL (with the contraction, samples
    from inside the unit ball to far outside it, the distortion loss in
    disparity), one launch a call, reruns bit-identical, the route "narrow
    wgmma"."""
    from nerf_rs_tpu_torch.kernels import fused_train

    dev = _device()
    cfg = ModelConfig(sigma_activation=sigma_act, ipe=ipe, contract=contract, **field)
    pk = pack_weights(_biased_model(cfg, dev), cfg)
    assert fused_train.route(pk, s) == "narrow wgmma"
    if contract:
        rays, radii = _unbounded_rays(n, s, ipe, dev)
        dist = dict(dist_weight=0.01, near=NEAR, far=FAR, dist_space="disparity")
    else:
        rays, radii = _branch_rays(ipe, n, s, dev)
        dist = {}
    gold = torch.from_numpy(np.random.default_rng(1).uniform(size=(n, 3))
                            .astype(np.float32)).to(dev)
    args = (pk, pack_weights_t(pk), *rays, gold, cfg, s)
    before = fused_train_grads.launches
    got = fused_train_grads(*args, white_bg=white, radii=radii, **dist)
    again = fused_train_grads(*args, white_bg=white, radii=radii, **dist)
    torch.cuda.synchronize()
    assert fused_train_grads.launches == before + 2
    _check_train(got, args, white, radii, **dist)
    for x, y in zip((got.diag, got.weights, *got.dw, *got.db),
                    (again.diag, again.weights, *again.dw, *again.db)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("s", [150, 191, 192])
def test_union_rows_match_a_call_padded_to_256(s):
    """K2 at S = 150, 191 and 192 (run as 192: two rays a CTA, three
    passes) on 4,103 ragged rays at the flagship width: against the plain
    version and the float64 witness, against the same samples padded to
    256 (one ray a CTA, two passes) at KERNEL_TOL, and bit-identical across
    two launches, K2b's folded bias sums among the outputs."""
    dev = _device()
    n = 4103
    args, _ = _train_args({}, "relu", n, s, dev)
    got = fused_train_grads(*args, white_bg=True)
    torch.cuda.synchronize()
    _check_train(got, args, True, None)
    pk, pkt, o, d, vd, ts, dl, gold, cfg, _ = args
    pad = 256 - s
    wide = fused_train_grads(pk, pkt, o, d, vd, torch.cat([ts, ts[:, -1:].expand(-1, pad)], 1),
                             torch.cat([dl, dl.new_zeros(n, pad)], 1), gold, cfg, 256,
                             white_bg=True)
    assert not wide.weights[:, s:].any()
    assert float((got.diag[:, :6] - wide.diag[:, :6]).abs().max()) <= KERNEL_TOL["diag"]
    assert float((got.weights - wide.weights[:, :s]).abs().max()) <= KERNEL_TOL["weights"]
    for i, (g, w) in enumerate(zip(got.dw + got.db, wide.dw + wide.db)):
        scale = max(float(w.abs().max()), 1e-12)
        assert float((g - w).abs().max()) / scale <= KERNEL_TOL["grads"], i
    again = fused_train_grads(*args, white_bg=True)
    for x, y in zip((got.diag, got.weights, *got.dw, *got.db),
                    (again.diag, again.weights, *again.dw, *again.db)):
        assert torch.equal(x, y)


def test_blocked_train_call_equals_its_blocks(monkeypatch):
    """K2 over more rays than a block holds (the block cap lowered to 3,072
    rows: 8 rays of 384 a block) launches once per block; against the same
    call in one launch (the cap as shipped), diag and weights are the same
    bits, and the gradients, whose rows K2b sums in other groups, stand
    within BLOCKED_TOL of each leaf's max; against the plain version at
    KERNEL_TOL."""
    from nerf_rs_tpu_torch.kernels import fused_train

    dev = _device()
    n, s = 37, 300
    args, _ = _train_args({}, "relu", n, s, dev)
    assert fused_train.route(args[0], s) == "narrow wgmma"
    before = fused_train_grads.launches
    whole = fused_train_grads(*args, white_bg=True)
    assert fused_train_grads.launches - before == 1
    monkeypatch.setattr(fused_train, "BLOCK_ROWS", 3072)
    before = fused_train_grads.launches
    got = fused_train_grads(*args, white_bg=True)
    again = fused_train_grads(*args, white_bg=True)
    assert fused_train_grads.launches - before == 2 * len(fused_train.ray_blocks(n, 384, 3072))
    assert len(fused_train.ray_blocks(n, 384, 3072)) == 5
    _check_train(got, args, True, None)
    for x, y in zip((got.diag, got.weights, *got.dw, *got.db),
                    (again.diag, again.weights, *again.dw, *again.db)):
        assert torch.equal(x, y)
    assert torch.equal(got.diag, whole.diag)
    assert torch.equal(got.weights, whole.weights)
    for i, (g, w) in enumerate(zip(got.dw + got.db, whole.dw + whole.db)):
        scale = max(float(w.abs().max()), 1e-12)
        assert float((g - w).abs().max()) / scale <= BLOCKED_TOL, i


# fields past K1's resident layouts (and K2's before its narrow instance):
# depth 21 (K1's biases no longer fit beside its tiles at S = 192) and IPE at
# 16 levels (112 encoding columns at S = 150), softplus density. The deep
# field runs on 4,103 rays, as chip_smoke.py's phase 33: its first layers'
# gradients are ~1e-5 of the heads' at this scale, and on 37 rays the bf16
# rounding flips of 21 trunk G's put even the f32 plain version 3.2e-2 of
# the first leaf's max from its float64 witness (K2 3.8e-2), past
# KERNEL_TOL; on 4,103 rays 2.9e-3 (K2 4.3e-3; an H100).
@pytest.mark.parametrize("field,ipe,n,s", [(dict(net_depth=21, skip_layer=4), False, 4103, 64),
                                           (dict(net_depth=21, skip_layer=4), False, 4103, 192),
                                           (dict(pos_enc_levels=16), True, 37, 150)])
def test_streamed_instances_match_plain_version(field, ipe, n, s):
    dev = _device()
    cfg = ModelConfig(sigma_activation="softplus", ipe=ipe, **field)
    model = _biased_model(cfg, dev)
    rays, radii = _branch_rays(ipe, n, s, dev)
    args = (pack_weights(model, cfg), *rays, cfg, s)
    got = fused_ray_render(*args, radii=radii)
    torch.cuda.synchronize()
    want = fused_ray_render_reference(*args, radii=radii)
    for name, g, w, tol in zip(("rgb", "acc", "depth", "weights", "sigma"), got, want,
                               (1e-3, 1e-3, 2e-3, 1e-3, 2e-2)):
        assert float((g - w).abs().max()) <= tol, name
    pk = args[0]
    gold = torch.from_numpy(np.random.default_rng(1).uniform(size=(n, 3))
                            .astype(np.float32)).to(dev)
    targs = (pk, pack_weights_t(pk), *rays, gold, cfg, s)
    _check_train(fused_train_grads(*targs, white_bg=True, radii=radii), targs, True, radii)


def test_wrappers_refuse_widths_above_256():
    """Widths above 256 were the one shape both kernels refused (fault 13),
    and widths that are no multiple of 16 did not pack (fault 14); the JAX
    kernels take both. Now no width from 1 to 1024 draws a refusal: a field
    of one layer at W = F = V = w, one ray of 16 samples, through K1 and K2
    for every w, each call launching its kernel once (K2 at least once: a
    call within the block budget is one launch)."""
    from nerf_rs_tpu_torch.kernels import fused_ray

    dev = _device()
    scratch_bytes = fused_ray._library().nerf_fused_ray_scratch_bytes
    o, d, vd, ts, dl = _rays(1, 16, dev)
    gold = torch.zeros(1, 3, device=dev)
    for w in range(1, 1025):
        cfg = ModelConfig(net_depth=1, skip_layer=4, net_width=w, feature_width=w,
                          view_head_width=w, pos_enc_levels=2, dir_enc_levels=1)
        pk = pack_weights(init_nerf_params(cfg, 0, dev), cfg)
        assert pk.widths == (w, w, w) and pk.W == -(-w // 16) * 16
        # K1's wide instance, and its layout, where the kernel asks for a scratch
        assert (scratch_bytes(1, 16, pk.depth, pk.W, pk.F, pk.V, pk.P, pk.D) > 0) == (pk.W > 256)
        k1, k2 = fused_ray_render.launches, fused_train_grads.launches
        fused_ray_render(pk, o, d, vd, ts, dl, cfg, 16)
        fused_train_grads(pk, pack_weights_t(pk), o, d, vd, ts, dl, gold, cfg, 16)
        assert (fused_ray_render.launches - k1, fused_train_grads.launches - k2) == (1, 1), w
    torch.cuda.synchronize()


# (net, feature, view head) widths the narrow instances did not take: not
# multiples of 16 (padded: 40/40/24, 100/100/50) and past 256 (the cluster
# route: 384/384/128, 512/512/256, 1024/256/128, mip-NeRF 360's trunk; at its
# edges a ragged last column block, 264, a padded width, 1000 -> 1008, and
# the widest it holds, 2048, eight CTAs a row group; one past it, 2064, on
# the mma.sync wide instances; view heads of two and three column blocks,
# 384 and 520 -> 528, whose rgb reads the other CTAs' blocks, over several
# passes a tile), on PE and IPE, relu and softplus, the
# contraction with the distortion loss in either space, S = 64, 192, 193 (->
# 256) and 300 (one ray of three passes a tile), ragged ray counts: (widths, sigma, IPE,
# distortion space or None, rays, S)
WIDTH_CASES = [
    ((40, 40, 24), "softplus", False, None, 37, 64),
    ((100, 100, 50), "relu", True, None, 37, 192),
    ((100, 100, 50), "softplus", False, "linear", 6, 193),
    ((384, 384, 128), "softplus", False, None, 37, 64),
    ((384, 384, 128), "relu", False, "linear", 37, 193),
    ((384, 384, 384), "relu", False, None, 37, 192),
    ((520, 256, 520), "softplus", True, None, 3, 300),
    ((512, 512, 256), "softplus", True, "disparity", 5, 300),
    ((512, 512, 256), "relu", False, None, 129, 64),
    ((1024, 256, 128), "softplus", False, "disparity", 37, 192),
    ((1024, 256, 128), "softplus", True, None, 3, 300),
    ((264, 264, 128), "softplus", False, None, 37, 64),
    ((1000, 256, 128), "relu", True, "linear", 9, 192),
    ((2048, 256, 128), "softplus", False, None, 5, 64),
    ((2064, 256, 128), "relu", False, None, 3, 64),
]


# the route each of WIDTH_CASES' widths takes (C k1_route, train_mode)
def _wide_route(widths) -> str:
    return "mma.sync wide" if max(widths) > 2048 else "cluster"



@pytest.mark.parametrize("widths,sigma_act,ipe,space,n,s", WIDTH_CASES)
def test_kernels_take_every_width(widths, sigma_act, ipe, space, n, s):
    """K1 and K2 at widths that are no multiple of 16 or are past 256 (faults
    13 and 14), random biases: each against its plain version (K1 at
    chip_smoke.TOL's bars; K2 also against its float64 witness, at KERNEL_TOL,
    with the contraction and the distortion loss in ``space`` when it is
    given), one launch a call, reruns bit-identical; past 256 on the route C
    picks by shape (the cluster route up to 2048, the mma.sync wide
    instances past it)."""
    from nerf_rs_tpu_torch.kernels import fused_ray, fused_train

    dev = _device()
    w, f, v = widths
    contract = space is not None
    cfg = ModelConfig(net_depth=4, skip_layer=2, net_width=w, feature_width=f,
                      view_head_width=v, sigma_activation=sigma_act, ipe=ipe, contract=contract)
    pk = pack_weights(_biased_model(cfg, dev), cfg)
    if max(widths) > 256:  # decided in C by shape
        want = _wide_route(widths)
        assert (fused_ray.route(pk, s), fused_train.route(pk, s)) == (want, want)
    rays, radii = _branch_rays(ipe, n, s, dev)
    if contract:  # samples from inside the unit ball to far outside it
        rays = (rays[0], rays[1], rays[2], rays[3] * 6.0, rays[4] * 6.0)
    args = (pk, *rays, cfg, s)
    before = fused_ray_render.launches
    got = fused_ray_render(*args, radii=radii)
    again = fused_ray_render(*args, radii=radii)
    torch.cuda.synchronize()
    assert fused_ray_render.launches == before + 2
    want = fused_ray_render_reference(*args, radii=radii)
    for name, g, a, ww, tol in zip(("rgb", "acc", "depth", "weights", "sigma"), got, again, want,
                                   (1e-3, 1e-3, 2e-3 * (6.0 if contract else 1.0), 1e-3, 2e-2)):
        assert g.shape == ww.shape, name
        assert bool(torch.isfinite(g).all()), name
        assert float((g - ww).abs().max()) <= tol, name
        assert torch.equal(g, a), name
    gold = torch.from_numpy(np.random.default_rng(1).uniform(size=(n, 3))
                            .astype(np.float32)).to(dev)
    targs = (pk, pack_weights_t(pk), *rays, gold, cfg, s)
    dist = dict(dist_weight=0.01, near=0.3, far=12.0, dist_space=space) if contract else {}
    before = fused_train_grads.launches
    tg = fused_train_grads(*targs, white_bg=True, radii=radii, **dist)
    tg2 = fused_train_grads(*targs, white_bg=True, radii=radii, **dist)
    torch.cuda.synchronize()
    assert fused_train_grads.launches == before + 2
    _check_train(tg, targs, True, radii, **dist)
    for x, y in zip((tg.diag, tg.weights, *tg.dw, *tg.db), (tg2.diag, tg2.weights, *tg2.dw,
                                                            *tg2.db)):
        assert torch.equal(x, y)


def _unit_variance_(model, cfg, o, d, ts):
    """Scales each trunk layer's weights so that its relu output has an RMS
    of 1 on the rays' samples (layer-sequential unit variance), as
    tests/test_torch_long_rays.py scales its 130-layer field: a trunk of
    124 or 130 layers then keeps its signal and its gradients, which at the
    initial scale fade to ~1e-12 of the heads' by the first layer."""
    from nerf_rs_tpu_torch.models.encoding import posenc

    with torch.no_grad():
        x = posenc((o[:, None] + ts[..., None] * d[:, None]).reshape(-1, 3).double(),
                   cfg.pos_enc_levels, True)
        h = x
        for i, layer in enumerate(model.trunk):
            inp = torch.cat([h, x], -1) if i == cfg.skip_layer and i > 0 else h
            out = torch.relu(inp @ layer.w.double())
            rms = out.square().mean().sqrt()
            layer.w.div_(rms.float())
            h = out / rms
    return model


# depths past the offset tables' former cap of 123 (fault 15), at width 64,
# and position encodings that no wgmma layout of K1 holds beside its ring
# (fault 17: 19 and 20 levels, P = 128; 34 levels, P = 208, which K2's
# narrow layout holds), at the paper widths: (field, rays, S)
DEPTH_ENC_CASES = [
    (dict(net_depth=124, skip_layer=4, net_width=64, feature_width=64, view_head_width=32),
     4103, 64),
    (dict(net_depth=130, skip_layer=4, net_width=64, feature_width=64, view_head_width=32),
     4103, 64),
    (dict(pos_enc_levels=19), 37, 64),
    (dict(pos_enc_levels=20), 37, 64),
    (dict(pos_enc_levels=34), 37, 64),
]


# How far from the float64 witness a kernel may stand on a trunk of 124 or 130
# layers, as a multiple of the plain version's own distance from it (per output,
# per gradient leaf relative to its max; at least the usual bars): the bf16
# rounding of every activation, flipped by the f32 summation order, compounds
# through the trunk, and on an H100 (4,103 rays, 64 samples, width 64, unit
# variance) the plain version stood up to 2.1e-2 (weights), 0.34 (sigma) and
# 1.4e-2 (a leaf) from its witness, the kernels at most 1.81x as far (K1's depth
# at 124 layers) and mostly closer.
DEEP_WITNESS_FACTOR = 2.5
RENDER_TOL = (1e-3, 1e-3, 2e-3, 1e-3, 2e-2)  # chip_smoke.TOL: rgb, acc, depth, weights, sigma


def _hold_deep(got, args, tg, targs):
    """K1's outputs and K2's diag, weights and leaves against the float64
    witness at DEEP_WITNESS_FACTOR times the plain version's distance."""
    for k, (g, p, w) in enumerate(zip(got, fused_ray_render_reference(*args),
                                      fused_ray_render_reference(*args, dtype=torch.float64))):
        bar = max(RENDER_TOL[k], DEEP_WITNESS_FACTOR * float((p.double() - w).abs().max()))
        assert float((g.double() - w).abs().max()) <= bar, k
    plain = fused_train_grads_reference(*targs, white_bg=True)
    wit = fused_train_grads_reference(*targs, white_bg=True, dtype=torch.float64)
    for g, p, w, tol in ((tg.diag[:, :6], plain.diag[:, :6], wit.diag[:, :6], KERNEL_TOL["diag"]),
                         (tg.weights, plain.weights, wit.weights, KERNEL_TOL["weights"])):
        bar = max(tol, DEEP_WITNESS_FACTOR * float((p.double() - w).abs().max()))
        assert float((g.double() - w).abs().max()) <= bar
    for i, (g, p, w) in enumerate(zip(tg.dw + tg.db, plain.dw + plain.db, wit.dw + wit.db)):
        scale = max(float(w.abs().max()), 1e-12)
        bar = max(KERNEL_TOL["grads"], DEEP_WITNESS_FACTOR * float((p.double() - w).abs().max())
                  / scale)
        assert bool(torch.isfinite(g).all()), i
        assert float((g.double() - w).abs().max()) / scale <= bar, i


@pytest.mark.parametrize("field,n,s", DEPTH_ENC_CASES)
def test_kernels_take_any_depth_and_encoding(field, n, s):
    """K1 and K2 at the depths and encodings they refused before faults 15
    and 17 were repaired (code -2 past depth 123, -5 for the wide
    encodings), softplus density, random biases, the deep trunks scaled to
    unit variance: at the wide encodings K1 against its plain version at
    chip_smoke.TOL's bars, K2 against its plain version and its float64
    witness at KERNEL_TOL; at the depths both against the witness at
    DEEP_WITNESS_FACTOR times the plain version's own distance; K1's reruns
    bit-identical; one launch a call. K1 takes the wide instance (its
    scratch) exactly where the encodings outgrow the wgmma layouts."""
    from nerf_rs_tpu_torch.kernels import fused_ray, fused_train

    dev = _device()
    cfg = ModelConfig(sigma_activation="softplus", **field)
    rays = _rays(n, s, dev)
    model = _biased_model(cfg, dev)
    if cfg.net_depth > 100:
        _unit_variance_(model, cfg, rays[0], rays[1], rays[3])
    pk = pack_weights(model, cfg)
    scratch = fused_ray._library().nerf_fused_ray_scratch_bytes(n, s, pk.depth, pk.W, pk.F, pk.V,
                                                                pk.P, pk.D)
    assert (scratch > 0) == (cfg.pos_enc_levels >= 19), scratch
    args = (pk, *rays, cfg, s)
    before = fused_ray_render.launches
    got = fused_ray_render(*args)
    again = fused_ray_render(*args)
    torch.cuda.synchronize()
    assert fused_ray_render.launches == before + 2
    deep = cfg.net_depth > 100
    want = fused_ray_render_reference(*args)
    for name, g, a, w, tol in zip(("rgb", "acc", "depth", "weights", "sigma"), got, again, want,
                                  RENDER_TOL):
        assert bool(torch.isfinite(g).all()), name
        assert deep or float((g - w).abs().max()) <= tol, name
        assert torch.equal(g, a), name
    gold = torch.from_numpy(np.random.default_rng(1).uniform(size=(n, 3))
                            .astype(np.float32)).to(dev)
    targs = (pk, pack_weights_t(pk), *rays, gold, cfg, s)
    assert fused_train.route(pk, s) == "narrow wgmma"  # every field up to 256 wide
    before = fused_train_grads.launches
    tg = fused_train_grads(*targs, white_bg=True)
    tg2 = fused_train_grads(*targs, white_bg=True)
    torch.cuda.synchronize()
    assert fused_train_grads.launches == before + 2
    for x, y in zip((tg.diag, tg.weights, *tg.dw, *tg.db), (tg2.diag, tg2.weights, *tg2.dw,
                                                            *tg2.db)):
        assert torch.equal(x, y)
    if deep:
        _hold_deep(got, args, tg, targs)
    else:
        _check_train(tg, targs, True, None)


def test_train_blocks_are_bounded_by_their_stash_bytes():
    """K2's launches are bounded by BLOCK_BYTES of stashes (the kernels' own
    sizing, ``block_rows``) as well as by BLOCK_ROWS: at the flagship widths
    the flagship's 4096 x 64 call and the record union's 4096 x 256 stay one
    launch each (BLOCK_ROWS binds); at 1024/256/128 (depth 8) a row stashes
    ~35.7 KB, the flagship recipe's 4096 x 64 call is one launch (~9.4 GB),
    and 16,384 x 64 rays (1,048,576 rows, within BLOCK_ROWS; ~37.5 GB) run
    as three blocks of whole tiles, every ray in one, each block's stashes
    (the scratch less its partials) within BLOCK_BYTES and one more tile
    past it."""
    import dataclasses

    from nerf_rs_tpu_torch.kernels import fused_train

    dev = _device()
    stash = fused_train._library().nerf_fused_train_scratch_bytes
    flagship = ModelConfig()
    pk = pack_weights(init_nerf_params(flagship, 0, dev), flagship)
    for s in (64, 256):
        assert fused_train.block_rows(pk, s) == fused_train.BLOCK_ROWS
        assert fused_train.ray_blocks(4096, s, fused_train.block_rows(pk, s)) == [(0, 4096)]
    wide = dataclasses.replace(flagship, net_width=1024)
    pk = pack_weights(init_nerf_params(wide, 0, dev), wide)
    rows = fused_train.block_rows(pk, 64)
    assert rows % 128 == 0 and 4096 * 64 <= rows < fused_train.BLOCK_ROWS
    assert 35_000 < stash(rows // 64, 64, 8, pk.W, pk.F, pk.V, pk.P, pk.D, 0) / rows < 36_500
    assert fused_train.ray_blocks(4096, 64, rows) == [(0, 4096)]
    blocks = fused_train.ray_blocks(16384, 64, rows)
    assert len(blocks) == 3 and blocks[0][0] == 0 and blocks[-1][1] == 16384
    assert all(a[1] == b[0] for a, b in zip(blocks, blocks[1:]))
    for lo, hi in blocks:
        assert lo % 2 == 0
        assert stash(hi - lo, 64, 8, pk.W, pk.F, pk.V, pk.P, pk.D, 0) <= fused_train.BLOCK_BYTES
    assert stash(rows // 64 + 2, 64, 8, pk.W, pk.F, pk.V, pk.P, pk.D, 0) > fused_train.BLOCK_BYTES


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
# past the kernels' former caps (16 levels; levels x channels 1,024): 20
# levels of the preset's ladder (the bf16 scatter in two runs of levels, 17
# and 3, since the taps of 20 levels do not fit beside six channel tiles),
# and 6 levels at 192 channels
FAC_WIDE = {"levels 20": ModelConfig(arch="factored", fac_levels=20),
            "6 x 192": ModelConfig(arch="factored", fac_comps=192)}


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


# geometries of K3's forward, with the levels that its CTAs hold in shared
# memory beside two buffers of a tile's taps (the coarsest first) under bf16
# and f32 lines: the main width (0-4 of 6 under bf16, 0-3 under f32), every
# level, and none under f32 (a first level of 2,601 knots x 8 channels x 3
# axes is more than a CTA holds)
FAC_ALL = ModelConfig(arch="factored", fac_levels=4, fac_base_res=8, fac_max_res=64, fac_comps=16)
FAC_NONE = ModelConfig(arch="factored", fac_levels=2, fac_base_res=2600, fac_max_res=5000,
                       fac_comps=8)
FAC_STAGED = {"main": (FAC_MAIN, 5, 4), "all staged": (FAC_ALL, 4, 4), "none": (FAC_NONE, 1, 0)}


@pytest.mark.parametrize("dtype", [torch.bfloat16, None], ids=["bf16", "f32"])
@pytest.mark.parametrize("geometry", list(FAC_STAGED))
def test_factored_forward_matches_plain_version_at_every_staging(geometry, dtype):
    cfg, bf16_levels, f32_levels = FAC_STAGED[geometry]
    dev = _device()
    lines, pts, g = _factored_inputs(cfg, 100_003, dev, seed=2)
    res = k3.fac_resolutions(cfg)
    c_res = (ctypes.c_int * len(res))(*res)
    assert k3._library().nerf_factored_fwd_staged_levels(
        c_res, len(res), cfg.fac_comps, int(dtype is not None)) == (
            bf16_levels if dtype is not None else f32_levels)
    enc = k3.fused_factored_encode_forward(lines, pts, cfg, dtype)
    torch.cuda.synchronize()
    want = k3.fused_factored_encode_reference(lines, pts, cfg, dtype)
    assert bool(torch.isfinite(enc).all())
    assert float((enc - want).abs().max()) <= k3.KERNEL_TOL["enc"]


@pytest.mark.parametrize("dtype", [torch.bfloat16, None], ids=["bf16", "f32"])
def test_factored_forward_is_deterministic(dtype):
    dev = _device()
    lines, pts, _ = _factored_inputs(FAC_MAIN, 300_001, dev, seed=3)
    a = k3.fused_factored_encode_forward(lines, pts, FAC_MAIN, dtype)
    b = k3.fused_factored_encode_forward(lines, pts, FAC_MAIN, dtype)
    assert torch.equal(a, b)


@pytest.mark.parametrize("geometry", list(FAC_WIDE))
def test_factored_kernels_past_the_former_caps_are_deterministic(geometry):
    """At 20 levels and at 6 x 192: the forward under bf16 and f32 lines and
    the bf16 backward give the same bits on a rerun, and match their plain
    versions (_check_factored)."""
    cfg = FAC_WIDE[geometry]
    dev = _device()
    lines, pts, g = _ray_inputs(cfg, 100_003, dev, seed=8)
    for dtype in (torch.bfloat16, None):
        a = k3.fused_factored_encode_forward(lines, pts, cfg, dtype)
        assert torch.equal(a, k3.fused_factored_encode_forward(lines, pts, cfg, dtype))
    d = k3.fused_factored_encode_backward(lines, pts, g, cfg, torch.bfloat16)
    assert torch.equal(d, k3.fused_factored_encode_backward(lines, pts, g, cfg, torch.bfloat16))
    _check_factored(k3.fused_factored_encode_forward(lines, pts, cfg, torch.bfloat16), d, lines,
                    pts, g, cfg, torch.bfloat16)


def test_factored_backward_is_deterministic():
    dev = _device()
    lines, pts, g = _factored_inputs(FAC_MAIN, 300_001, dev, seed=1)
    a = k3.fused_factored_encode_backward(lines, pts, g, FAC_MAIN, torch.bfloat16)
    b = k3.fused_factored_encode_backward(lines, pts, g, FAC_MAIN, torch.bfloat16)
    assert torch.equal(a, b)


def _ray_inputs(cfg, n, dev, seed=0):
    """Lines, n points of rays of 128 samples each laid out a ray at a time
    (as the main path lays them out), the first two pushed out of the AABB
    (clipped), and an encoding cotangent."""
    rng = np.random.default_rng(seed)
    lines = (0.25 * rng.normal(size=(3, basis_dim(cfg), cfg.fac_comps))).astype(np.float32)
    a = cfg.fac_aabb
    rays = -(-n // 128) or 1
    o = rng.uniform(-0.2 * a, 0.2 * a, (rays, 1, 3))
    d = rng.normal(size=(rays, 1, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t = np.sort(rng.uniform(0.0, 2.5 * a, (rays, 128, 1)), axis=1)
    pts = (o + t * d).reshape(-1, 3)[:n].astype(np.float32)
    pts[:2] = np.float32([[2 * a, -a, a], [a, 0.0, -2 * a]])[:n]
    g = rng.normal(size=(n, cfg.fac_comps)).astype(np.float32)
    return tuple(torch.from_numpy(x).to(dev) for x in (lines, pts, g))


# the backward's geometries: the main width, a small one, every level
# staged, a per-axis table larger than a CTA's shared memory (the f32
# scatter tiles it by levels), two whose C the bf16 scatter pads: 12
# channels (two 8-channel tiles, the last half zeros) and 100 (three groups
# of five tiles, 120 columns), and those past the former caps
FAC_BWD = {"main": FAC_MAIN, "small": FAC_SMALL, "all staged": FAC_ALL, "none": FAC_NONE,
           "padded": ModelConfig(arch="factored", fac_levels=4, fac_base_res=8,
                                 fac_max_res=64, fac_comps=12),
           "groups": ModelConfig(arch="factored", fac_levels=3, fac_base_res=16,
                                 fac_max_res=128, fac_comps=100), **FAC_WIDE}


@pytest.mark.parametrize("order", ["ray", "shuffled"])
@pytest.mark.parametrize("n", [0, 1, 37, 100_003])
@pytest.mark.parametrize("dtype", [torch.bfloat16, None], ids=["bf16", "f32"])
@pytest.mark.parametrize("geometry", list(FAC_BWD))
def test_factored_backward_matches_plain_version(geometry, dtype, n, order):
    """K3's backward against its plain version at k3.KERNEL_TOL (per axis,
    relative to the axis's largest entry), on ray-ordered points (a
    narrow band of knots a step) and on the same points shuffled."""
    cfg = FAC_BWD[geometry]
    dev = _device()
    lines, pts, g = _ray_inputs(cfg, n, dev, seed=4)
    if order == "shuffled":
        pts = pts[torch.from_numpy(np.random.default_rng(5).permutation(n)).to(dev)].contiguous()
    d = k3.fused_factored_encode_backward(lines, pts, g, cfg, dtype)
    torch.cuda.synchronize()
    want = k3.fused_factored_encode_backward_reference(lines, pts, g, cfg, dtype)
    assert d.shape == want.shape and bool(torch.isfinite(d).all())
    if n == 0:
        assert not bool(d.any())
        return
    for a in range(3):
        scale = float(want[a].abs().max())
        assert scale > 0
        assert float((d[a] - want[a]).abs().max()) / scale <= k3.KERNEL_TOL["d_lines"], a


@pytest.mark.parametrize("dtype", [torch.bfloat16, None], ids=["bf16", "f32"])
@pytest.mark.parametrize("geometry", list(FAC_WIDE))
def test_factored_kernels_stand_from_the_dense_product_by_its_flips(geometry, dtype):
    """Beside the plain versions, which sum the taps in the kernels' level
    order, the JAX kernel's own form: the dense hat product. The encoding
    stands from it at k3.KERNEL_TOL of its largest magnitude (at least 1:
    its f32 sums of 2L taps an axis run in another order, on values that
    reach tens at 20 levels); d_lines at k3.KERNEL_TOL of its scale
    plus what the d_feat elements that the two orders round differently
    move it by (``dense_order_gap``), elementwise."""
    cfg = FAC_WIDE[geometry]
    dev = _device()
    lines, pts, g = _ray_inputs(cfg, 100_003, dev, seed=8)
    enc = k3.fused_factored_encode_forward(lines, pts, cfg, dtype)
    d = k3.fused_factored_encode_backward(lines, pts, g, cfg, dtype)
    torch.cuda.synchronize()
    want = k3.fused_factored_encode_reference(lines, pts, cfg, dtype, dense=True)
    assert float((enc - want).abs().max()) <= k3.KERNEL_TOL["enc"] * max(
        1.0, float(want.abs().max()))
    want_d, bound, _ = k3.dense_order_gap(lines, pts, g, cfg, dtype)
    tol = k3.KERNEL_TOL["d_lines"] * want_d.abs().amax(dim=(1, 2), keepdim=True)
    assert bool(((d - want_d).abs() <= tol + bound).all())


@pytest.mark.parametrize("dtype", [torch.bfloat16, None], ids=["bf16", "f32"])
@pytest.mark.parametrize("geometry", list(FAC_BWD))
def test_factored_dfeat_matches_plain_dfeat(geometry, dtype):
    """The backward's first kernel: d_feat[a] = (g * f_b) * f_c from the
    forward's features, against the plain version's. Under bf16 both round
    to bf16 and the features differ only in the order of their f32 sums,
    so an element may fall on the other side of a rounding boundary: one
    bf16 step at most, on few elements. The padding columns are zero."""
    cfg = FAC_BWD[geometry]
    dev = _device()
    lines, pts, g = _ray_inputs(cfg, 100_003, dev, seed=6)
    d = k3.fused_factored_dfeat(lines, pts, g, cfg, dtype)
    torch.cuda.synchronize()
    want = k3.fused_factored_dfeat_reference(lines, pts, g, cfg, dtype)
    C = cfg.fac_comps
    stride = k3.bwd_plan(100_003, basis_dim(cfg), C, dtype is not None, 132).stride
    assert d.shape == (3, 100_003, stride)
    assert not bool(d[:, :, C:].any())
    got = d[:, :, :C].float()
    diff = (got - want).abs()
    if dtype is None:
        assert float(diff.max()) <= 1e-5 * float(want.abs().max())
    else:
        assert bool((diff <= 2.0 ** -7 * want.abs()).all())
        assert float((diff > 0).float().mean()) < 1e-3


@pytest.mark.parametrize("dtype", [torch.bfloat16, None], ids=["bf16", "f32"])
def test_factored_backward_does_not_synchronise(dtype):
    """The backward sizes its scratch from N, sumR and C on the host: a
    call under set_sync_debug_mode("error") does not raise."""
    dev = _device()
    lines, pts, g = _ray_inputs(FAC_MAIN, 100_003, dev, seed=7)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        d = k3.fused_factored_encode_backward(lines, pts, g, FAC_MAIN, dtype)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(d).all())


def test_bwd_plan_matches_the_kernels():
    """The kernels' layout (nerf_factored_bwd_plan) is bwd_plan's."""
    _device()
    lib = k3._library()
    out = (ctypes.c_int * 6)()
    for n in (1, 37, 100_003, 524_288):
        for cfg in (*FAC_BWD.values(), ModelConfig(arch="factored", fac_levels=47)):
            sum_r, comps = basis_dim(cfg), cfg.fac_comps
            for bf16 in (0, 1):
                for sms in (1, 132):
                    lib.nerf_factored_bwd_plan(n, sum_r, comps, bf16, sms, out)
                    assert tuple(out) == k3.bwd_plan(n, sum_r, comps, bool(bf16), sms)


def test_factored_wrappers_refuse_what_the_kernels_do_not_take():
    """The refusals that stand: strided or non-f32 inputs, and more levels
    than the forward's two tap buffers of one point hold (FWD_MAX_LEVELS,
    code -5). Past 256 levels the kernels take a geometry since fault 15's
    repair (test_factored_kernels_take_any_level_count), and the former
    corners of fault 7 (test_factored_kernels_take_the_former_corners)."""
    dev = _device()
    lines, pts, g = _factored_inputs(FAC_SMALL, 8, dev)
    strided = torch.zeros(8, 6, device=dev)[:, ::2]
    with pytest.raises(ValueError, match="contiguous"):
        k3.fused_factored_encode_forward(lines, strided, FAC_SMALL)
    with pytest.raises(ValueError, match="f32"):
        k3.fused_factored_encode_forward(lines, pts.double(), FAC_SMALL)
    with pytest.raises(ValueError, match="f32"):
        k3.fused_factored_encode_backward(lines, pts, g.half(), FAC_SMALL)
    cfg = ModelConfig(arch="factored", fac_levels=k3.FWD_MAX_LEVELS + 1, fac_base_res=4,
                      fac_max_res=8, fac_comps=4)
    lines, pts, g = _factored_inputs(cfg, 37, dev)
    for dtype, backward in ((None, False), (torch.bfloat16, True), (None, True)):
        with pytest.raises(ValueError, match=re.escape(k3._ERRORS[-5])):
            if backward:
                k3.fused_factored_encode_backward(lines, pts, g, cfg, dtype)
            else:
                k3.fused_factored_encode_forward(lines, pts, cfg, dtype)


@pytest.mark.parametrize("levels", [257, 300])
def test_factored_kernels_take_any_level_count(levels):
    """Past 256 levels (refused with -2 until fault 15's repair moved the
    per-level arrays out of the launch parameters into a device table):
    forward and backward under bf16 and f32 lines, bit-identical reruns,
    the plain versions' values within KERNEL_TOL (_check_factored), one
    launch each a call. The tensor-core scatter walks its runs of levels
    (level_run) from the same device table."""
    cfg = ModelConfig(arch="factored", fac_levels=levels, fac_comps=8)
    nt = k3.bwd_plan(20_003, basis_dim(cfg), cfg.fac_comps, True, 132).nt
    assert k3.level_run(nt, levels) < levels
    dev = _device()
    lines, pts, g = _ray_inputs(cfg, 20_003, dev, seed=8)
    for dtype in (torch.bfloat16, None):
        before = (k3.fused_factored_encode.launches, k3.fused_factored_encode_backward.launches)
        enc = k3.fused_factored_encode_forward(lines, pts, cfg, dtype)
        d = k3.fused_factored_encode_backward(lines, pts, g, cfg, dtype)
        assert (k3.fused_factored_encode.launches, k3.fused_factored_encode_backward.launches) == (
            before[0] + 1, before[1] + 1)
        assert torch.equal(enc, k3.fused_factored_encode_forward(lines, pts, cfg, dtype))
        assert torch.equal(d, k3.fused_factored_encode_backward(lines, pts, g, cfg, dtype))
        _check_factored(enc, d, lines, pts, g, cfg, dtype)


# the corners fault 7 lifted: 100 levels (the tensor-core scatter in runs of
# 40 levels at two channel tiles, the f32 scatter in level groups) and one
# level of 60,001 knots
# (the f32 scatter in runs of rows)
FAC_CORNERS = {"levels 100": ModelConfig(arch="factored", fac_levels=100, fac_comps=16),
               "60,001 knots": ModelConfig(arch="factored", fac_levels=1, fac_base_res=60000,
                                           fac_comps=4)}


@pytest.mark.parametrize("geometry", list(FAC_CORNERS))
def test_factored_kernels_take_the_former_corners(geometry):
    """Forward and backward under bf16 and f32 lines at the geometries the
    kernels refused before fault 7's repair: bit-identical reruns, and the
    plain versions' values within KERNEL_TOL (_check_factored). The layouts
    are the mirrors' (level_run, walk_tiles): more than one run of levels,
    more than one run of rows."""
    cfg = FAC_CORNERS[geometry]
    res = k3.fac_resolutions(cfg)
    if geometry == "levels 100":
        nt = k3.bwd_plan(20_003, basis_dim(cfg), cfg.fac_comps, True, 132).nt
        assert k3.level_run(nt, cfg.fac_levels) < cfg.fac_levels
    else:
        assert len(k3.walk_tile_rows(k3.walk_tiles(res, cfg.fac_comps), res)) > 1
    dev = _device()
    lines, pts, g = _ray_inputs(cfg, 20_003, dev, seed=8)
    for dtype in (torch.bfloat16, None):
        enc = k3.fused_factored_encode_forward(lines, pts, cfg, dtype)
        d = k3.fused_factored_encode_backward(lines, pts, g, cfg, dtype)
        assert torch.equal(enc, k3.fused_factored_encode_forward(lines, pts, cfg, dtype))
        assert torch.equal(d, k3.fused_factored_encode_backward(lines, pts, g, cfg, dtype))
        _check_factored(enc, d, lines, pts, g, cfg, dtype)


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


@pytest.mark.parametrize("width", [1, 3, 8])
def test_gather_rows_takes_any_width(width):
    """Rows of any width (the flat hash table's F features; a multiple of 4
    only until fault 16's repair): the kernel gives the plain version's
    bits, NaN rows for indices outside the table, both from an aligned
    table (16-byte loads where W % 4 == 0) and from one a float off the
    16-byte boundary (a float at a time)."""
    dev = _device()
    rng = np.random.default_rng(width)
    base = torch.from_numpy(rng.normal(size=5003 * width + 1).astype(np.float32)).to(dev)
    idx = rng.integers(0, 5003, 100_003).astype(np.int32)
    idx[1::97] = -5
    idx[2::89] = 5003
    idx = torch.from_numpy(idx).to(dev)
    for table in (base[:-1].view(5003, width), base[1:].view(5003, width)):
        before = k4.gather_rows.launches
        got = k4.gather_rows(table, idx)
        torch.cuda.synchronize()
        assert k4.gather_rows.launches == before + 1 and got.shape == (100_003, width)
        want = k4.gather_rows_reference(table, idx)
        assert torch.equal(got.isnan(), want.isnan())
        assert torch.equal(got.nan_to_num(), want.nan_to_num())


# (C values a fetch, row width, base columns up to): the flat hash table's
# rows at F = 1, 3, 8, 40 (lanes 0..F-1, no base), 300 lanes of a 700-wide
# row (a batch of 4 fetches a warp, the row in column blocks of 128) and
# 2,000 of a 2,000-wide row (a batch of 2, past the default 48 KB: the opt-in
# shared memory)
SCATTER_WIDTHS = [(1, 1, 0), (3, 3, 0), (8, 8, 0), (40, 40, 0), (300, 700, 400),
                  (2000, 2000, 0)]


@pytest.mark.parametrize("c,width,bases", SCATTER_WIDTHS)
def test_scatter_rows_takes_any_width(c, width, bases):
    """scatter_rows past its former caps of 32 values a fetch and 128
    columns (fault 16's repair: the lanes in a device table, the shared
    memory sized at launch): the plain version's bits, keys crowded onto
    few rows (chunked runs) and outside the table, reruns bit-identical,
    one launch a call."""
    dev = _device()
    rng = np.random.default_rng(c)
    n, rows = (20_003, 4099) if c < 300 else (3001, 257)
    key = _scatter_keys("zipf", n, rows, rng)
    key[::13] = -1
    key = torch.from_numpy(key.astype(np.int32)).to(dev)
    lanes = tuple(int(x) for x in rng.permutation(width - bases)[:c]) if bases else tuple(range(c))
    lane0 = (torch.from_numpy(rng.integers(0, bases + 1, n).astype(np.int32)).to(dev)
             if bases else None)
    g = torch.from_numpy(rng.normal(size=(n, c)).astype(np.float32)).to(dev)
    before = k4.scatter_rows.launches
    got = k4.scatter_rows(g, key, lane0, lanes, (rows, width))
    again = k4.scatter_rows(g, key, lane0, lanes, (rows, width))
    torch.cuda.synchronize()
    assert k4.scatter_rows.launches == before + 2
    assert torch.equal(got, k4.scatter_rows_reference(g, key, lane0, lanes, (rows, width)))
    assert torch.equal(got, again)


def test_scatter_rows_refuses_a_fetch_no_block_holds():
    """The refusal that stands: one fetch's C values (with the row's
    inverse of lanes) past the card's opt-in shared memory (8,000 values:
    256 KB a warp-batch of one)."""
    dev = _device()
    key = torch.zeros(37, dtype=torch.int32, device=dev)
    g = torch.zeros(37, 8000, device=dev)
    with pytest.raises(ValueError, match="shared memory"):
        k4.scatter_rows(g, key, None, tuple(range(8000)), (3, 8000))


@pytest.mark.parametrize("n", [1, 37, 100_003])
def test_gather_pairs_gives_nan_for_odd_and_outside_indices(n):
    """Odd indices and indices outside the table mixed into a flat fetch:
    the kernel's bits are the plain version's, NaN pairs exactly there."""
    dev = _device()
    rng = np.random.default_rng(n + 1)
    flat = torch.from_numpy(rng.normal(size=2 * 5003).astype(np.float32)).to(dev)
    fidx = 2 * rng.integers(0, 5003, n).astype(np.int32)
    fidx[::3] += 1  # odd
    fidx[1::7] = -4
    fidx[2::11] = 2 * 5003
    want = k4.gather_pairs_reference(flat, torch.from_numpy(fidx).to(dev))
    got = k4.gather_pairs(flat, torch.from_numpy(fidx).to(dev))
    torch.cuda.synchronize()
    bad = (fidx % 2 == 1) | (fidx < 0) | (fidx + 1 >= 2 * 5003)
    assert torch.equal(got.isnan(), want.isnan())
    assert torch.equal(got.nan_to_num(), want.nan_to_num())
    assert torch.equal(got.isnan().all(-1).cpu(), torch.from_numpy(bad))


@pytest.mark.parametrize("fetch", ["gather_pairs", "hash_encode"])
def test_flat_fetch_does_not_synchronise(fetch):
    """gather_pairs, and the flat encode's forward around it, launch without
    waiting for the card: no call under set_sync_debug_mode("error")
    raises."""
    dev = _device()
    cfg = ModelConfig(arch="hashgrid", hash_brick=False)
    rng = np.random.default_rng(3)
    table = torch.from_numpy(rng.normal(size=hashgrid.table_shape(cfg)).astype(np.float32)).to(dev)
    pts = torch.from_numpy(rng.uniform(-2.0, 2.0, (4096, 3)).astype(np.float32)).to(dev)
    fidx = torch.from_numpy(2 * rng.integers(0, table.numel() // 2, 4096).astype(np.int32)).to(dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        if fetch == "gather_pairs":
            k4.gather_pairs(table.view(-1), fidx)
        else:
            hashgrid.hash_encode(table, pts, cfg)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


def test_gather_wrappers_refuse_what_the_kernel_does_not_take():
    dev = _device()
    table = torch.zeros(64, 128, device=dev)
    idx = torch.zeros(8, dtype=torch.int32, device=dev)
    assert bool(k4.gather_pairs(table.view(-1), idx + 1).isnan().all())  # odd: NaN pairs
    with pytest.raises(ValueError, match="16-byte"):
        k4.gather_pairs(table.view(-1), torch.zeros(9, dtype=torch.int32, device=dev)[1:])
    with pytest.raises(ValueError, match="int32"):
        k4.gather_rows(table, idx.long())
    with pytest.raises(ValueError, match="contiguous"):
        k4.gather_rows(torch.zeros(64, 256, device=dev)[:, ::2], idx)
    # a table off the 16-byte boundary: the element-wise kernel (fault 16's repair)
    shifted = torch.randn(64 * 128 + 1, device=dev)[1:].view(64, 128)
    assert torch.equal(k4.gather_rows(shifted, idx + 3), shifted[3].expand(8, 128))
    with pytest.raises(ValueError, match="boundary"):
        k4.gather_pairs(torch.zeros(65, device=dev)[1:], idx)
    with pytest.raises(ValueError, match="device"):
        k4.gather_rows(table, idx.cpu())


@pytest.mark.parametrize("brick,features", [(True, 2), (False, 2), (False, 8)],
                         ids=["brick", "flat", "flat-8"])
def test_hash_encodes_through_k4_match_the_cpu(brick, features):
    """The main widths' encode and its table gradient on the card (K4 on
    every fetch, scatter_rows for the gradient) against the CPU's plain
    route: the same cells and weights, corner sums and gradient sums in
    another order. The flat table at F = 8 fetches (F,) rows through
    gather_rows (fault 16's repair)."""
    dev = _device()
    cfg = ModelConfig(arch="hashgrid", hash_brick=brick, hash_features=features)
    rng = np.random.default_rng(7)
    table = rng.normal(size=hashgrid.table_shape(cfg)).astype(np.float32)
    pts = rng.uniform(-2.0, 2.0, (300_001, 3)).astype(np.float32)
    g = rng.normal(size=(300_001, 16 * features)).astype(np.float32)
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
    assert none == (0, 0) and launched == ((3, 0) if brick else (0, 1) if features == 2
                                           else (1, 0))
    assert float((enc_g - enc_c).abs().max()) <= 1e-6 * float(enc_c.abs().max())
    assert float((grad_g - grad_c).abs().max()) <= 1e-5 * float(grad_c.abs().max())


NEAR, FAR = 0.3, 12.0  # disparity spacing from inside the unit ball to far outside it


def _unbounded_rays(n, s, ipe, dev, seed=3):
    """Rays from near the origin with samples over [NEAR, FAR] even in
    disparity, jittered: (o, d, vd, ts or midpoints, deltas), radii. Both
    branches of the contraction are taken."""
    rng = np.random.default_rng(seed)
    o = torch.from_numpy((rng.normal(size=(n, 3)) * 0.2).astype(np.float32)).to(dev)
    d = torch.nn.functional.normalize(
        torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32)), dim=-1).to(dev)
    u = np.sort(rng.uniform(size=(n, s + int(ipe))), -1)
    t = torch.from_numpy((1.0 / (1.0 / NEAR + u * (1.0 / FAR - 1.0 / NEAR))).astype(np.float32))
    t = t.to(dev)
    if ipe:
        radii = torch.from_numpy(rng.uniform(2e-3, 2e-2, n).astype(np.float32)).to(dev)
        return (o, d, d, 0.5 * (t[:, :-1] + t[:, 1:]), t[:, 1:] - t[:, :-1]), radii
    dl = torch.cat([t[:, 1:], torch.full_like(t[:, :1], FAR)], -1) - t
    return (o, d, d, t, dl), None


# (field, sigma, IPE, contract, distortion space or None, rays, samples):
# contraction under PE and IPE, the distortion loss in both spaces (with
# exact IPE lengths), rays of one tile and rays padded to 256
UNBOUNDED_CASES = [
    ({}, "softplus", False, True, None, 301, 64),
    (SMALL, "softplus", True, True, None, 37, 128),
    (SMALL, "relu", False, False, "linear", 37, 64),
    ({}, "softplus", False, True, "disparity", 101, 64),
    (SMALL, "softplus", True, True, "disparity", 9, 192),
    (SMALL, "relu", False, True, "disparity", 6, 193),
    (SMALL, "softplus", False, True, "disparity", 7, 150),
]


@pytest.mark.parametrize("field,sigma_act,ipe,contract,space,n,s", UNBOUNDED_CASES)
def test_unbounded_branches_match_plain_version(field, sigma_act, ipe, contract, space, n, s):
    dev = _device()
    cfg = ModelConfig(sigma_activation=sigma_act, ipe=ipe, contract=contract, **field)
    model = _biased_model(cfg, dev)
    rays, radii = _unbounded_rays(n, s, ipe, dev)
    pk = pack_weights(model, cfg)
    got = fused_ray_render(pk, *rays, cfg, s, radii=radii)
    torch.cuda.synchronize()
    want = fused_ray_render_reference(pk, *rays, cfg, s, radii=radii)
    for name, g, w, tol in zip(("rgb", "acc", "depth", "weights", "sigma"), got, want,
                               (1e-3, 1e-3, 2e-3 * FAR, 1e-3, 2e-2)):
        assert g.shape == w.shape and bool(torch.isfinite(g).all()), name
        assert float((g - w).abs().max()) <= tol, name
    gold = torch.from_numpy(np.random.default_rng(1).uniform(size=(n, 3)).astype(np.float32))
    args = (pk, pack_weights_t(pk), *rays, gold.to(dev), cfg, s)
    dist = ({} if space is None
            else dict(dist_weight=0.01, near=NEAR, far=FAR, dist_space=space))
    tg = fused_train_grads(*args, radii=radii, **dist)
    torch.cuda.synchronize()
    assert (float(tg.diag[:, 5].abs().max()) > 0) == (space is not None)
    _check_train(tg, args, False, radii, **dist)


def test_unbounded_train_kernel_is_deterministic():
    dev = _device()
    cfg = ModelConfig(sigma_activation="softplus", contract=True)
    model = init_nerf_params(cfg, 0, dev)
    rays, _ = _unbounded_rays(333, 192, False, dev)
    pk = pack_weights(model, cfg)
    gold = torch.rand(333, 3, device=dev)
    args = (pk, pack_weights_t(pk), *rays, gold, cfg, 192)
    dist = dict(dist_weight=0.01, near=NEAR, far=FAR, dist_space="disparity")
    a, b = fused_train_grads(*args, **dist), fused_train_grads(*args, **dist)
    for x, y in zip((a.diag, a.weights, *a.dw, *a.db), (b.diag, b.weights, *b.dw, *b.db)):
        assert torch.equal(x, y)


def _scatter_keys(kind, n, rows, rng):
    if kind == "zipf":  # keys crowded onto few rows (long runs)
        return rng.zipf(1.5, n) % rows
    if kind == "one row":  # a single run of n fetches: thousands of chunks at n = 300,001
        return np.full(n, rows // 2)
    key = rng.integers(-rows, 2 * rows, n)  # outside the table, below 0 and past the last row
    key[::7] = -1
    key[1::11] = rows
    return key


@pytest.mark.parametrize("kind", ["zipf", "one row", "outside", "small tables"])
@pytest.mark.parametrize("n", [1, 37, 300_001])
def test_scatter_matches_plain_version_bit_for_bit(n, kind):
    """scatter_rows against its plain version on the card, both table
    layouts' shapes: keys crowded onto few rows, one row of every fetch,
    keys outside the table (skipped), and tables whose keys take one pass of
    the sort (1 row: 8-bit digits; 257 rows: 9-bit), its last pass writing
    the rows' runs; two launches give the same bits."""
    dev = _device()
    rng = np.random.default_rng(n)
    shapes = (((4096, 128), hashgrid._CORNER_LANES, True), ((65536, 2), (0, 1), False))
    if kind == "small tables":
        shapes = tuple(((rows, width), lanes, with_lane0) for rows in (1, 257)
                       for (_, width), lanes, with_lane0 in shapes)
    for (rows, width), lanes, with_lane0 in shapes:
        keys = "outside" if kind == "small tables" else kind
        key = torch.from_numpy(_scatter_keys(keys, n, rows, rng).astype(np.int32)).to(dev)
        lane0 = (torch.from_numpy(rng.integers(0, 22, n).astype(np.int32) * 2).to(dev)
                 if with_lane0 else None)
        g = torch.from_numpy(rng.normal(size=(n, len(lanes))).astype(np.float32)).to(dev)
        before = k4.scatter_rows.launches
        got = k4.scatter_rows(g, key, lane0, lanes, (rows, width))
        again = k4.scatter_rows(g, key, lane0, lanes, (rows, width))
        torch.cuda.synchronize()
        assert k4.scatter_rows.launches == before + 2
        assert torch.equal(got, k4.scatter_rows_reference(g, key, lane0, lanes, (rows, width)))
        assert torch.equal(got, again)


@pytest.mark.parametrize("rows", [1, 200, 257, 2 ** 17, 2 ** 23],
                         ids=["1 bit", "8 bits", "9 bits", "18 bits", "24 bits"])
@pytest.mark.parametrize("n", [1, 37, 300_001])
def test_sort_matches_torch_sort(n, rows):
    """scatter_rows' radix sort alone: the keys mapped by sort_key (outside
    the table: the spare value rows) in stable order and their positions,
    the same as torch.sort(stable=True)'s."""
    dev = _device()
    rng = np.random.default_rng(n + rows)
    key = rng.zipf(1.3, n) % (rows + 9) - 4  # a few below 0 and past the last row
    key = torch.from_numpy(key.astype(np.int32)).to(dev)
    before = k4.sort_keys.launches
    got_keys, got_perm = k4.sort_keys(key, rows)
    torch.cuda.synchronize()
    assert k4.sort_keys.launches == before + 1
    want_keys, want_perm = torch.sort(k4.sort_key(key, rows), stable=True)
    assert torch.equal(got_keys, want_keys)
    assert torch.equal(got_perm.long(), want_perm)


def test_sort_plan_matches_the_kernels():
    """The wrapper's mirror of the sort's plan gives the kernels' passes and
    digit bits."""
    _device()
    lib = k4._library()
    for rows in (1, 2, 255, 256, 257, 511, 512, 65535, 65536, 2 ** 17, 2 ** 23, 2 ** 31 - 1):
        assert (lib.nerf_sort_passes(rows), lib.nerf_sort_digit_bits(rows)) == \
            k4.sort_plan(rows)[1:], rows


@pytest.mark.parametrize("brick", [True, False], ids=["brick", "flat"])
def test_scatter_does_not_synchronise(brick):
    """scatter_rows finds its runs and chunks on the card: a call under
    set_sync_debug_mode("error") does not raise."""
    dev = _device()
    rng = np.random.default_rng(5)
    n = 100_003
    rows, width, lanes = (4096, 128, hashgrid._CORNER_LANES) if brick else (65536, 2, (0, 1))
    key = torch.from_numpy(_scatter_keys("zipf", n, rows, rng).astype(np.int32)).to(dev)
    lane0 = (torch.from_numpy(rng.integers(0, 22, n).astype(np.int32) * 2).to(dev)
             if brick else None)
    g = torch.from_numpy(rng.normal(size=(n, len(lanes))).astype(np.float32)).to(dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = k4.scatter_rows(g, key, lane0, lanes, (rows, width))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(got, k4.scatter_rows_reference(g, key, lane0, lanes, (rows, width)))


@pytest.mark.parametrize("brick", [True, False], ids=["brick", "flat"])
def test_hash_grid_table_gradient_is_deterministic(brick):
    """Two train steps of the hash grid on the same inputs from the same
    state give the same table bits: the table's gradient is summed in a
    fixed order (index_add_'s float atomics did not give that)."""
    from nerf_rs_tpu_torch.config import Config, DataConfig, RenderConfig, TrainConfig
    from nerf_rs_tpu_torch.data.factory import make_dataset
    from nerf_rs_tpu_torch.train import step

    dev = _device()
    cfg = Config(model=ModelConfig(arch="hashgrid", hash_brick=brick,
                                   sigma_activation="softplus"),
                 render=RenderConfig(num_samples=64, white_background=True),
                 train=TrainConfig(num_rays=2048, learning_rate=1e-2),
                 data=DataConfig(dataset="sphere"))
    ds = make_dataset(cfg, dev)
    tables = []
    for _ in range(2):
        state = step.init_state(cfg, dev)
        fn = step.make_train_step(cfg, ds)
        for it in range(2):
            state, _ = fn(state, step.step_generator(0, it, dev))
        tables.append(state.params.table.detach().clone())
    assert torch.equal(tables[0], tables[1])
