"""How the whole-ray kernels lay rays out on their CTAs, on the CPU: the
padded sample counts (a power of two up to 128, 192 for 129 to 192, 256 for
193 to 256, the next multiple of 128 above), the row-to-ray mapping of a
CTA's 128-row passes (one to five of them here), the train kernel's blocks
of rays past 1,048,576 padded rows (every ray once; the blocks' gradients
sum to one call's), and the plain versions of K1 and K2 on rays padded to
192 against the JAX package's Pallas kernels in interpret mode on the
unpadded rays.

Small widths (depth 3, width 32), a few rays, inputs from numpy seeds.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_rs_tpu.kernels import fused_ray as jray
from nerf_rs_tpu.kernels import fused_render as jrender
from nerf_rs_tpu.kernels import fused_train as jtrain
from nerf_rs_tpu.models import mlp as jmlp
from nerf_rs_tpu_torch.config import ModelConfig
from nerf_rs_tpu_torch.convert import params_from_numpy, params_to_numpy
from nerf_rs_tpu_torch.kernels import fused_render
from nerf_rs_tpu_torch.kernels.fused_ray import (TILE_ROWS, cta_rows, fused_ray_render_reference,
                                                 pad_samples, padded_samples, rays_per_cta)
from nerf_rs_tpu_torch.kernels.fused_train import (BLOCK_ROWS, fused_train_grads,
                                                   fused_train_grads_reference, ray_blocks,
                                                   unpack_grads)
from nerf_rs_tpu_torch.models.mlp import NerfMLP

torch.set_num_threads(2)

MODEL = ModelConfig(net_depth=3, net_width=32, skip_layer=2, feature_width=32,
                    view_head_width=16, pos_enc_levels=4, dir_enc_levels=2)
N = 8


def test_padded_samples_for_every_count():
    """1 to 2048 samples: the next power of two up to 128, 192 for 129 to
    192, 256 for 193 to 256, the next multiple of 128 above (one ray a CTA);
    every CTA's rows are whole 128-row passes."""
    for s in range(1, 2049):
        want = (1 << (s - 1).bit_length() if s <= 128 else 192 if s <= 192 else 256 if s <= 256
                else -(-s // 128) * 128)
        sp = padded_samples(s)
        assert sp == want, s
        assert padded_samples(sp) == sp
        assert rays_per_cta(sp) * sp % TILE_ROWS == 0, s


@pytest.mark.parametrize("s,rays,passes", [(1, 128, 1), (64, 2, 1), (128, 1, 1), (192, 2, 3),
                                           (256, 1, 2), (384, 1, 3), (512, 1, 4),
                                           (640, 1, 5)])
def test_cta_rows_take_whole_rays(s, rays, passes):
    """The CTA's passes cover each (ray, sample) of its whole rays once, in
    row order; at 192 the second pass ends ray 0 and starts ray 1; past 256
    one ray takes S / 128 passes."""
    m = cta_rows(s)
    assert rays_per_cta(s) == rays
    assert m.shape == (passes, TILE_ROWS, 2)
    flat = m.reshape(-1, 2)
    assert torch.equal(flat[:, 0] * s + flat[:, 1], torch.arange(rays * s))
    assert int(flat[:, 0].max()) == rays - 1 and int(flat[:, 1].max()) == s - 1
    if s == 192:
        assert m[1, :, 0].unique().tolist() == [0, 1]
        assert m[1, 63].tolist() == [0, 191] and m[1, 64].tolist() == [1, 0]


@pytest.mark.parametrize("n,s", [(1, 64), (4096, 64), (4096, 192), (4103, 192), (4096, 256),
                                 (4097, 256), (4096, 384), (4096, 512), (1000, 2048),
                                 (9000, 128)])
def test_ray_blocks_take_every_ray_once(n, s):
    """The train kernel's launches: consecutive blocks of whole CTA tiles,
    every ray in one, each at most BLOCK_ROWS padded rows; a call within
    BLOCK_ROWS (every preset's, up to 4096 x 256) is one launch."""
    R = rays_per_cta(s)
    blocks = ray_blocks(n, s)
    assert blocks[0][0] == 0 and blocks[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(blocks, blocks[1:]))
    for lo, hi in blocks:
        assert lo % R == 0 and hi > lo
        assert -(-(hi - lo) // R) * R * s <= BLOCK_ROWS
    assert (len(blocks) == 1) == (-(-n // R) * R * s <= BLOCK_ROWS)
    if len(blocks) > 1:  # as few launches as the cap allows
        assert len(blocks) == -(-n // (BLOCK_ROWS // (R * s) * R))


@pytest.mark.parametrize("s,white,space", [(300, False, None), (192, True, "disparity")])
def test_blocked_gradients_sum_to_one_call(s, white, space):
    """The plain version on the blocks of ray_blocks at a small row cap (four
    blocks of two rays), each with its own means, against one call on every
    ray: diag and weights per ray at f32 rounding (atol 1e-6); a quarter of
    the blocks' gradients, summed in block order, within 1e-5 of each leaf's
    max (a block's loss scale is four times the call's, a power of two, so
    every bf16 rounding scales with it; only the f32 sums of the rows group
    otherwise). The CPU wrapper is the plain version: the same bits."""
    cfg = dataclasses.replace(MODEL, sigma_activation="softplus")
    _, model = _model(cfg, 25)
    n = 8
    rays, _ = _rays(n, s, 26, False)
    o, d, vd, ts, deltas, gold = map(_t, rays)
    pk = fused_render.pack_weights(model, cfg)
    pkt = fused_render.pack_weights_t(pk)
    dist = ({} if space is None
            else dict(dist_weight=0.05, near=0.05, far=2.0, dist_space=space))
    tp, dp = pad_samples(ts, deltas)
    sp = tp.shape[1]
    blocks = ray_blocks(n, sp, rows=2 * sp)
    assert [hi - lo for lo, hi in blocks] == [2] * 4
    whole = fused_train_grads_reference(pk, pkt, o, d, vd, tp, dp, gold, cfg, sp, white,
                                        **dist)
    parts = [fused_train_grads_reference(pk, pkt, o[lo:hi], d[lo:hi], vd[lo:hi], tp[lo:hi],
                                         dp[lo:hi], gold[lo:hi], cfg, sp, white, **dist)
             for lo, hi in blocks]
    torch.testing.assert_close(torch.cat([p.diag for p in parts]), whole.diag, atol=1e-6,
                               rtol=0)
    torch.testing.assert_close(torch.cat([p.weights for p in parts]), whole.weights, atol=1e-6,
                               rtol=0)
    for i, want in enumerate(whole.dw + whole.db):
        got = (parts[0].dw + parts[0].db)[i].clone()
        for p in parts[1:]:
            got += (p.dw + p.db)[i]
        got *= 0.25
        scale = float(want.abs().max())
        assert float((got - want).abs().max()) <= 1e-5 * max(scale, 1e-12), i
    again = fused_train_grads(pk, pkt, o, d, vd, tp, dp, gold, cfg, sp, white, **dist)
    assert all(torch.equal(a, b) for a, b in zip((again.diag, again.weights, *again.dw,
                                                  *again.db),
                                                 (whole.diag, whole.weights, *whole.dw,
                                                  *whole.db)))


def _model(cfg, seed):
    params = jmlp.init_nerf_params(jax.random.PRNGKey(seed), cfg)
    params["sigma"]["b"] = params["sigma"]["b"] + 0.3  # an opaque-enough field
    model = NerfMLP(cfg)
    model.load_state_dict(params_from_numpy(jax.tree.map(np.asarray, params)))
    return params, model


def _rays(n, s, seed, ipe):
    rng = np.random.default_rng(seed)
    o = (rng.normal(size=(n, 3)) * 0.2).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    vd = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    gold = rng.uniform(size=(n, 3)).astype(np.float32)
    if ipe:
        edges = np.sort(rng.uniform(0.05, 1.9, (n, s + 1)), -1).astype(np.float32)
        ts = (0.5 * (edges[:, 1:] + edges[:, :-1])).astype(np.float32)
        deltas = (edges[:, 1:] - edges[:, :-1]).astype(np.float32)
        radii = rng.uniform(0.005, 0.05, n).astype(np.float32)
    else:
        ts = np.sort(rng.uniform(0.05, 1.85, (n, s)), -1).astype(np.float32)
        deltas = np.diff(np.concatenate([ts, np.full((n, 1), 2.0, np.float32)], -1), axis=-1)
        radii = None
    return (o, d, vd, ts, deltas.astype(np.float32), gold), radii


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("ipe,s", [(False, 150), (True, 191)])
def test_plain_versions_on_rays_padded_to_192_match_jax(ipe, s):
    """K1's and K2's plain versions on the rays padded as the kernels run
    them (to 192) against the JAX kernels in interpret mode on the rays as
    they are, at tests/test_torch_hierarchical.py's bars (K2's weights at
    K1's); the pads' weights are exactly 0."""
    cfg = dataclasses.replace(MODEL, ipe=ipe, sigma_activation="softplus")
    params, model = _model(cfg, 21)
    rays, radii = _rays(N, s, 22, ipe)
    o, d, vd, ts, deltas, gold = map(_t, rays)
    tp, dp = pad_samples(ts, deltas)
    assert tp.shape == (N, 192)
    jpk = jrender.pack_weights(params, cfg)
    want = jray.fused_ray_render(jpk, *map(_j, rays[:5]), cfg, s, rays_per_block=N,
                                 interpret=True, radii=_j(radii))
    pk = fused_render.pack_weights(model, cfg)
    got = fused_ray_render_reference(pk, o, d, vd, tp, dp, cfg, 192, _t(radii))
    for name, g, w, tol in zip(("rgb", "acc", "depth", "weights", "sigma"), got, want,
                               (3e-3, 3e-3, 5e-3, 3e-3, 2e-2)):
        g = g if name in ("rgb", "acc", "depth") else g[:, :s]
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=tol, err_msg=name)
    assert not got[3][:, s:].any()

    tg = jtrain.fused_train_grads(jpk, jtrain.pack_weights_t(jpk, cfg), *map(_j, rays), cfg, s,
                                  white_bg=True, rays_per_block=N, interpret=True,
                                  radii=_j(radii))
    mine = fused_train_grads_reference(pk, fused_render.pack_weights_t(pk), o, d, vd, tp, dp,
                                       gold, cfg, 192, True, _t(radii))
    np.testing.assert_allclose(mine.diag.numpy(), np.asarray(tg.diag), atol=1e-5)
    # the weights at K1's bar: at S = 150 one sample's sigma moves by 4.7e-4
    # between the two (a hidden activation's bf16 rounding flips with the
    # summation order), and its weight by 1.2e-5
    np.testing.assert_allclose(mine.weights[:, :s].numpy(), np.asarray(tg.weights), atol=3e-3)
    assert not mine.weights[:, s:].any()
    leaves = params_to_numpy(unpack_grads(mine, model, cfg))
    want_leaves = jax.tree.map(np.asarray, jtrain.unpack_grads(tg, params, cfg))
    assert jax.tree_util.tree_structure(leaves) == jax.tree_util.tree_structure(want_leaves)
    for g, w in zip(jax.tree_util.tree_leaves(leaves), jax.tree_util.tree_leaves(want_leaves)):
        scale = np.abs(w).max()
        assert scale > 1e-6
        np.testing.assert_allclose(g / scale, w / scale, atol=5e-4)
