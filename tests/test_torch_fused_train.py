"""The PyTorch port's whole-ray train kernel (kernels/fused_train.py,
csrc/fused_train.cu) on the CPU: its plain version against the JAX
package's Pallas kernel in interpret mode (as tests/test_fused_train.py
runs it), against autograd of the eager path, and the packing around it.

The CUDA kernels against the plain version need the card:
tests/test_torch_cuda.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_rs_tpu.kernels import fused_render as jrender
from nerf_rs_tpu.kernels import fused_train as jtrain
from nerf_rs_tpu.models import mlp as jmlp
from nerf_rs_tpu.ops import sampling as jsamp
from nerf_rs_tpu_torch.config import ModelConfig
from nerf_rs_tpu_torch.convert import params_from_numpy, params_to_numpy
from nerf_rs_tpu_torch.kernels import fused_render
from nerf_rs_tpu_torch.kernels.fused_train import (
    fused_train_grads, fused_train_grads_reference, unpack_grads)
from nerf_rs_tpu_torch.models.mlp import NerfMLP, apply_nerf
from nerf_rs_tpu_torch.ops import render as render_ops

torch.set_num_threads(2)

CFG = ModelConfig(net_depth=4, net_width=32, skip_layer=2, feature_width=32,
                  view_head_width=16, pos_enc_levels=3, dir_enc_levels=1)
S, N = 8, 16


def _cfg(sigma_act):
    return dataclasses.replace(CFG, sigma_activation=sigma_act)


def _case(cfg, n=N, seed=2):
    """Converted JAX weights and numpy rays; rays through the field's
    busy region, so no case compares all-zero gradients."""
    params = jmlp.init_nerf_params(jax.random.PRNGKey(seed), cfg)
    tree = jax.tree.map(np.asarray, params)
    model = NerfMLP(cfg)
    model.load_state_dict(params_from_numpy(tree))
    rng = np.random.default_rng(seed + 10)
    o = (rng.normal(size=(n, 3)) * 0.2).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    vd = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    ts = np.sort(rng.uniform(0.05, 1.85, (n, S)), axis=-1).astype(np.float32)
    deltas = np.array(jsamp.deltas_from_ts(jnp.asarray(ts), 2.0))
    gold = rng.uniform(size=(n, 3)).astype(np.float32)
    return params, model, (o, d, vd, ts, deltas, gold)


def _port(model, cfg, rays, white_bg=False, fn=fused_train_grads_reference):
    pk = fused_render.pack_weights(model, cfg)
    return fn(pk, fused_render.pack_weights_t(pk), *map(torch.from_numpy, rays), cfg, S,
              white_bg=white_bg)


def _leaves(tree):
    return jax.tree_util.tree_flatten(tree)[0]


@pytest.mark.parametrize("white_bg", [False, True])
@pytest.mark.parametrize("sigma_act", ["relu", "softplus"])
def test_reference_matches_jax_kernel(sigma_act, white_bg):
    """diag, weights and every gradient leaf against the JAX kernel in
    interpret mode, leaves named through unpack_grads -> params_to_numpy.
    Both sides round to bf16 at the same points and sum in f32; at these
    widths the two agree to f32 rounding (seen: ~3e-7 normalised), so
    the bars are f32-level: diag/weights atol 1e-5, leaves 1e-4 of the
    leaf's max."""
    cfg = _cfg(sigma_act)
    params, model, rays = _case(cfg)
    pk = jrender.pack_weights(params, cfg)
    tg = jtrain.fused_train_grads(pk, jtrain.pack_weights_t(pk, cfg), *map(jnp.asarray, rays),
                                  cfg, S, white_bg=white_bg, rays_per_block=8, interpret=True)
    got = _port(model, cfg, rays, white_bg)
    np.testing.assert_allclose(got.diag.numpy(), np.asarray(tg.diag), atol=1e-5)
    np.testing.assert_allclose(got.weights.numpy(), np.asarray(tg.weights), atol=1e-5)
    want = jax.tree.map(np.asarray, jtrain.unpack_grads(tg, params, cfg))
    mine = params_to_numpy(unpack_grads(got, model, cfg))
    assert jax.tree_util.tree_structure(mine) == jax.tree_util.tree_structure(want)
    for g, w in zip(_leaves(mine), _leaves(want)):
        assert g.shape == w.shape
        scale = np.abs(w).max()
        assert scale > 1e-5  # a live field: no vacuous comparison
        np.testing.assert_allclose(g / scale, w / scale, atol=1e-4)


@pytest.mark.parametrize("white_bg", [False, True])
def test_reference_matches_autograd(white_bg):
    """Against autograd of the eager path (apply_nerf at bf16 ->
    composite -> mse) on the same inputs, at the JAX package's bar for
    its kernel against autodiff: rgb 2e-2, loss 2e-3, leaves 4e-2 of the
    leaf's max (bf16 rounds at other points in autograd)."""
    cfg = _cfg("softplus")
    _, model, rays = _case(cfg)
    o, d, vd, ts, deltas, gold = map(torch.from_numpy, rays)
    got = _port(model, cfg, rays, white_bg)
    pts = o[:, None, :] + ts[:, :, None] * d[:, None, :]
    sigma, rgb = apply_nerf(model, pts, vd[:, None, :], cfg, torch.bfloat16)
    out = render_ops.composite(sigma, rgb, deltas, white_background=white_bg)
    loss = render_ops.mse(out.rgb, gold)
    loss.backward()
    np.testing.assert_allclose(got.diag[:, :3].numpy(), out.rgb.detach().numpy(), atol=2e-2)
    assert abs(float(got.diag[:, 4].mean()) - float(loss.detach())) < 2e-3
    for name, g in unpack_grads(got, model, cfg).items():
        ref = dict(model.named_parameters())[name].grad
        scale = float(ref.abs().max())
        assert scale > 1e-5, name
        assert float((g - ref).abs().max()) / scale < 4e-2, name


def test_grads_accumulate_over_ray_blocks():
    """A call on 2R rays equals the mean of two R-ray calls (the loss is
    a mean over the call's rays)."""
    _, model, rays = _case(CFG, n=2 * N)
    whole = _port(model, CFG, rays)
    halves = [_port(model, CFG, tuple(a[sl] for a in rays))
              for sl in (slice(0, N), slice(N, None))]
    for a, h0, h1 in zip(whole.dw + whole.db, halves[0].dw + halves[0].db,
                         halves[1].dw + halves[1].db):
        torch.testing.assert_close(a, 0.5 * (h0 + h1), atol=1e-6, rtol=1e-4)
    torch.testing.assert_close(whole.diag, torch.cat([halves[0].diag, halves[1].diag]))


def test_sgd_step_lowers_the_loss():
    cfg = _cfg("relu")
    _, model, rays = _case(cfg, n=13)  # ragged
    tg = _port(model, cfg, rays)
    grads = unpack_grads(tg, model, cfg)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p -= 0.1 * grads[name]
    after = _port(model, cfg, rays)
    assert float(after.diag[:, 4].mean()) < float(tg.diag[:, 4].mean())


def test_cpu_wrapper_runs_the_plain_version():
    _, model, rays = _case(CFG)
    before = fused_train_grads.launches
    got = _port(model, CFG, rays, fn=fused_train_grads)
    want = _port(model, CFG, rays)
    assert fused_train_grads.launches == before  # no kernel launched on the CPU
    for g, w in zip((got.diag, got.weights, *got.dw, *got.db),
                    (want.diag, want.weights, *want.dw, *want.db)):
        assert torch.equal(g, w)


def test_transposed_packing_round_trips():
    _, model, _ = _case(CFG)
    pk = fused_render.pack_weights(model, CFG)
    pkt = fused_render.pack_weights_t(pk)
    mats, mats_t = pk.matrices(), pkt.matrices()
    L, F = CFG.net_depth, CFG.feature_width
    assert [tuple(m.shape) for m in mats_t] == [(32, 32)] * 3 + [(32, 32), (16, 32), (16, 16)]
    for i in range(1, L):
        assert torch.equal(mats_t[i - 1].t(), mats[i])
    assert torch.equal(mats_t[L - 1].t(), mats[L + 1][:, :F])
    assert torch.equal(mats_t[L].t(), mats[L + 2])
    assert torch.equal(mats_t[L + 1][:8].t(), mats[L + 4]) and not mats_t[L + 1][8:].any()
    assert torch.equal(pkt.sigma_row, mats[L + 1][:, F].float())
    # each swizzled matrix un-swizzles to itself
    flat = fused_render._swizzle(mats_t[L])
    assert torch.equal(fused_render._unswizzle(flat, 16, 32), mats_t[L])


def test_wrapper_refuses_what_the_kernel_does_not_take():
    _, model, rays = _case(CFG)
    pk = fused_render.pack_weights(model, CFG)
    pkt = fused_render.pack_weights_t(pk)
    o, d, vd, ts, dl, gold = map(torch.from_numpy, rays)
    # rays of any length: 257 samples run (padded to 384 on the card)
    ts257 = torch.linspace(0.1, 1.9, 257).expand(N, 257).contiguous()
    long = fused_train_grads(pk, pkt, o, d, vd, ts257, torch.full((N, 257), 1.8 / 256), gold,
                             CFG, 257)
    assert long.weights.shape == (N, 257) and bool(torch.isfinite(long.dw[0]).all())
    with pytest.raises(ValueError, match="one sample per ray or more"):
        fused_train_grads(pk, pkt, o, d, vd, ts[:, :0], dl[:, :0], gold, CFG, 0)
    with pytest.raises(ValueError, match="gold"):
        fused_train_grads(pk, pkt, o, d, vd, ts, dl, gold[:, :2], CFG, S)
    with pytest.raises(ValueError, match="radii"):  # IPE needs the cone radii
        fused_train_grads(pk, pkt, o, d, vd, ts, dl, gold, dataclasses.replace(CFG, ipe=True), S)
    with pytest.raises(ValueError, match="dist_space"):  # the contraction branch is ported
        fused_train_grads(pk, pkt, o, d, vd, ts, dl, gold,
                          dataclasses.replace(CFG, contract=True), S, dist_space="cube")
    with pytest.raises(ValueError, match="no kernel"):
        fused_train_grads(pk, pkt, *(a.to("meta") for a in (o, d, vd, ts, dl, gold)), CFG, S)
