"""How the whole-ray kernels lay rays out on their CTAs, on the CPU: the
padded sample counts (a power of two up to 128, 192 for 129 to 192, 256
above), the row-to-ray mapping of a CTA's 128-row passes (one, two or three
of them), and the plain versions of K1 and K2 on rays padded to 192 against
the JAX package's Pallas kernels in interpret mode on the unpadded rays.

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
from nerf_rs_tpu_torch.kernels.fused_train import fused_train_grads_reference, unpack_grads
from nerf_rs_tpu_torch.models.mlp import NerfMLP

torch.set_num_threads(2)

MODEL = ModelConfig(net_depth=3, net_width=32, skip_layer=2, feature_width=32,
                    view_head_width=16, pos_enc_levels=4, dir_enc_levels=2)
N = 8


def test_padded_samples_for_every_count():
    """1 to 256 samples: the next power of two up to 128, 192 for 129 to
    192, 256 above; every CTA's rows are whole 128-row passes."""
    for s in range(1, 257):
        want = 1 << (s - 1).bit_length() if s <= 128 else (192 if s <= 192 else 256)
        sp = padded_samples(s)
        assert sp == want, s
        assert padded_samples(sp) == sp
        assert rays_per_cta(sp) * sp % TILE_ROWS == 0, s


@pytest.mark.parametrize("s,rays,passes", [(1, 128, 1), (64, 2, 1), (128, 1, 1), (192, 2, 3),
                                           (256, 1, 2)])
def test_cta_rows_take_whole_rays(s, rays, passes):
    """The CTA's passes cover each (ray, sample) of its whole rays once, in
    row order; at 192 the second pass ends ray 0 and starts ray 1."""
    m = cta_rows(s)
    assert rays_per_cta(s) == rays
    assert m.shape == (passes, TILE_ROWS, 2)
    flat = m.reshape(-1, 2)
    assert torch.equal(flat[:, 0] * s + flat[:, 1], torch.arange(rays * s))
    assert int(flat[:, 0].max()) == rays - 1 and int(flat[:, 1].max()) == s - 1
    if s == 192:
        assert m[1, :, 0].unique().tolist() == [0, 1]
        assert m[1, 63].tolist() == [0, 191] and m[1, 64].tolist() == [1, 0]


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
