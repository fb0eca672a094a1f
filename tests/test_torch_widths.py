"""Fields of any width through the whole-ray kernels' packing and plain
versions, on the CPU:

* ``pack_weights`` pads net_width, feature_width and view_head_width to
  multiples of 16 with zero rows, columns and biases (40/40/24 -> 48/48/32,
  100/100/50 -> 112/112/64; 384, 512 and 1024 are multiples already), in
  ``PackedWeights``, ``pack_weights_t`` and K1's layout alike;
  ``unpack_grads`` crops the pads, so the gradients keep the ``NerfMLP``
  shapes, and the plain version's gradient is exactly 0 on every pad;
* at 100/100/50 one ``train_step`` through the whole-ray route and one
  ``render_rays`` through the render kernel's route, called through the API,
  against the JAX package's step and render (its Pallas kernels in interpret
  mode) on the same weights and midpoint samples.

The plain versions at every width against the JAX kernels are
tests/test_torch_long_rays.py's ``test_plain_versions_of_deep_and_wide_fields
_match_jax``; the kernels themselves need the card (tests/test_torch_cuda.py,
chip_smoke.py phase 36).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_rs_tpu import config as jconfig
from nerf_rs_tpu.models import mlp as jmlp
from nerf_rs_tpu.ops import rays as jrays
from nerf_rs_tpu.ops import render as jrender
from nerf_rs_tpu.train import step as jstep
from nerf_rs_tpu_torch.config import (CameraConfig, Config, DataConfig, ModelConfig,
                                      RenderConfig, TrainConfig)
from nerf_rs_tpu_torch.convert import params_from_numpy, params_to_numpy
from nerf_rs_tpu_torch.kernels import fused_ray, fused_render, fused_train
from nerf_rs_tpu_torch.models.mlp import NerfMLP
from nerf_rs_tpu_torch.ops import rays
from nerf_rs_tpu_torch.ops import render as render_ops
from nerf_rs_tpu_torch.train import step

torch.set_num_threads(2)

BASE = ModelConfig(net_depth=3, net_width=32, skip_layer=2, feature_width=32,
                   view_head_width=16, pos_enc_levels=4, dir_enc_levels=2)
WIDTHS = {"40-40-24": (40, 40, 24), "100-100-50": (100, 100, 50),
          "384-384-128": (384, 384, 128), "512-512-256": (512, 512, 256),
          "1024-256-128": (1024, 256, 128)}
N, S = 4, 16


def _cfg(widths) -> ModelConfig:
    w, f, v = widths
    return dataclasses.replace(BASE, net_width=w, feature_width=f, view_head_width=v)


def _model(cfg, seed=5):
    """The JAX package's initial weights with every bias drawn from a numpy
    seed (the initial ones are 0, which would not show a pad that took a
    bias)."""
    tree = jax.tree.map(np.asarray, jmlp.init_nerf_params(jax.random.PRNGKey(seed), cfg))
    rng = np.random.default_rng(seed)
    for layer in [*tree["trunk"], *(tree[k] for k in ("feature", "sigma", "view1", "rgb"))]:
        layer["b"] = rng.normal(0.0, 0.1, layer["b"].shape).astype(np.float32)
    model = NerfMLP(cfg)
    model.load_state_dict(params_from_numpy(tree))
    return model


def _rays(seed=7):
    rng = np.random.default_rng(seed)
    o = (rng.normal(size=(N, 3)) * 0.2).astype(np.float32)
    d = rng.normal(size=(N, 3)).astype(np.float32)
    vd = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    ts = np.sort(rng.uniform(0.05, 2.0, (N, S)), -1).astype(np.float32)
    deltas = np.diff(np.concatenate([ts, np.full((N, 1), 2.0, np.float32)], -1), axis=-1)
    gold = rng.uniform(size=(N, 3)).astype(np.float32)
    return tuple(map(torch.from_numpy, (o, d, vd, ts, deltas.astype(np.float32), gold)))


def _real(cfg):
    """Each packed matrix's real (rows, columns) in kernel order and each
    bias's real entries: the rest is pad. [feature | sigma] keeps sigma at
    column F padded, so its real columns are [0, F) and F padded."""
    W, Fw, V = cfg.net_width, cfg.feature_width, cfg.view_head_width
    pos, _, dird, _ = fused_render.enc_dims(cfg)
    L = cfg.net_depth
    mats = [(pos, W)] + [(W, W)] * (L - 1) + [(pos, W), (W, None), (Fw, V), (dird, V), (V, 3)]
    biases = [W] * L + [None, V, 3]
    return mats, biases


@pytest.mark.parametrize("name", list(WIDTHS))
def test_packed_pads_are_zero_and_gradients_crop_to_the_field(name):
    cfg = dataclasses.replace(_cfg(WIDTHS[name]), sigma_activation="softplus")  # no dead ray
    model = _model(cfg)
    pk = fused_render.pack_weights(model, cfg)
    Wp, Fp, Vp = (-(-x // 16) * 16 for x in WIDTHS[name])
    assert (pk.W, pk.F, pk.V) == (Wp, Fp, Vp) and pk.widths == WIDTHS[name]
    mats, biases = _real(cfg)
    Fw = cfg.feature_width
    sf = cfg.net_depth + 1
    for i, (m, (k, n)) in enumerate(zip(pk.matrices(), mats)):
        if i == sf:  # [feature | sigma]: pads between F and F padded, and after sigma
            assert not m[k:].any() and not m[:, Fw:Fp].any() and not m[:, Fp + 1:].any(), i
            assert m[:k, :Fw].any() and m[:k, Fp].any(), i
        else:
            assert not m[k:].any() and not m[:, n:].any() and m[:k, :n].any(), i
    for i, (b, n) in enumerate(zip(pk.biases(), biases)):
        if i == cfg.net_depth:
            assert not b[Fw:Fp].any() and not b[Fp + 1:].any() and b[:Fw].any(), i
        else:
            assert not b[n:].any() and b[:n].any(), i
    pt = fused_render.pack_weights_t(pk)
    for m_t, m in zip(pt.matrices()[:-1], pk.matrices()[1:cfg.net_depth]):
        assert torch.equal(m_t, m.t())
    assert not pt.sigma_row[cfg.net_width:].any() and pt.sigma_row[:cfg.net_width].any()
    # K1's wgmma layout (which the kernel reads up to 256 wide): the same
    # entries, more zeros
    for pm, m, want in zip(pk.k1.padded_matrices(), pk.k1.matrices(), pk.matrices()):
        assert torch.equal(m, want) and torch.count_nonzero(pm) == torch.count_nonzero(m)

    # the plain version's gradient is exactly 0 on every pad; unpack_grads crops
    # the pads back to the NerfMLP's shapes
    tg = fused_train.fused_train_grads_reference(pk, pt, *_rays(), cfg, S, True)
    for i, (g, (k, n)) in enumerate(zip(tg.dw, mats)):
        if i == sf:
            assert not g[k:].any() and not g[:, Fw:Fp].any() and not g[:, Fp + 1:].any(), i
        else:
            assert not g[k:].any() and not g[:, n:].any(), i
    for i, (g, n) in enumerate(zip(tg.db, biases)):
        if i == cfg.net_depth:
            assert not g[Fw:Fp].any() and not g[Fp + 1:].any(), i
        else:
            assert not g[n:].any(), i
    grads = fused_train.unpack_grads(tg, model, cfg)
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in grads.items()} == shapes
    assert all(bool(torch.isfinite(g).all()) and g.any() for g in grads.values())


ODD = _cfg(WIDTHS["100-100-50"])
LR = 1e-3


def _step_cfg() -> Config:
    return Config(
        camera=CameraConfig(width=8, height=8),
        model=dataclasses.replace(ODD, pos_enc_levels=3, dir_enc_levels=1),
        render=RenderConfig(num_samples=8, randomized=False),
        train=TrainConfig(num_rays=16, learning_rate=LR, precision="mixed", whole_ray_block=8),
        data=DataConfig(dataset="sphere"),
        use_whole_ray_train=True,
    )


def test_train_step_at_an_odd_width_matches_jax(monkeypatch):
    """One step at widths 100/100/50 from the same weights and rays (midpoint
    samples) through the whole-ray route of both packages: the JAX kernel in
    interpret mode, the port's plain version of K2 (once, on the padded
    pack). The bars are tests/test_torch_train.py's kernel-path bars: both
    kernels agree to f32 rounding (loss, psnr rtol 1e-4, per-ray error 1e-5),
    and the first Adam update is ~lr * sign(g), so the new weights agree to
    0.1 lr."""
    cfg = _step_cfg()
    jcfg = jconfig.Config.from_dict(cfg.to_dict())
    assert step.whole_ray_supported(cfg)
    jstate = jstep.init_state(jax.random.PRNGKey(2), jcfg)
    state = step.init_state(cfg)
    state.params.load_state_dict(params_from_numpy(jax.tree.map(np.asarray, jstate.params)))
    rng = np.random.default_rng(0)
    o = (rng.normal(size=(16, 3)) * 0.2).astype(np.float32)
    d = rng.normal(size=(16, 3)).astype(np.float32)
    gold = rng.uniform(size=(16, 3)).astype(np.float32)
    new_j, aux_j = jstep.train_step(jstate, jstep.Batch(*map(jnp.asarray, (o, d, gold))),
                                    jax.random.PRNGKey(0), jcfg)
    calls = []
    real = fused_train.fused_train_grads_reference
    monkeypatch.setattr(fused_train, "fused_train_grads_reference",
                        lambda pk, *a, **k: calls.append(pk.widths) or real(pk, *a, **k))
    state, aux = step.train_step(state, step.Batch(*map(torch.from_numpy, (o, d, gold))),
                                 None, cfg)
    assert calls == [(100, 100, 50)]
    for key in ("loss", "loss_coarse", "psnr"):
        np.testing.assert_allclose(float(aux[key]), float(aux_j[key]), rtol=1e-4, err_msg=key)
    np.testing.assert_allclose(aux["ray_err"].numpy(), np.asarray(aux_j["ray_err"]), atol=1e-5)
    got = params_to_numpy(state.params)
    want = jax.tree.map(np.asarray, new_j.params)
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    for g, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=0.1 * LR)


def test_render_rays_at_an_odd_width_matches_jax(monkeypatch):
    """render_rays at widths 100/100/50 with the render kernel's route
    (use_fused) on an 8x8 grid of rays, midpoint samples, white background:
    the JAX kernel in interpret mode against the port's plain version of K1
    (once, on the padded pack), at the JAX package's kernel-vs-XLA bars
    (tests/test_torch_long_rays.py: rgb, acc and weights 3e-3, depth 5e-3,
    sigma 2e-2)."""
    mcfg = ODD
    rcfg = RenderConfig(num_samples=S, white_background=True)
    cam = CameraConfig(width=8, height=8)
    model = _model(mcfg, 9)
    params = jax.tree.map(jnp.asarray, params_to_numpy(model.state_dict()))
    pose = np.eye(3, dtype=np.float32)
    o_j, d_j = jrays.ray_grid(jnp.asarray(pose), jconfig.CameraConfig(
        **dataclasses.asdict(cam)))
    o, d = rays.ray_grid(torch.from_numpy(pose), cam)
    want, _ = jrender.render_rays(
        params, o_j, d_j, jax.random.PRNGKey(0),
        jconfig.ModelConfig(**dataclasses.asdict(mcfg)),
        jconfig.RenderConfig(**dataclasses.asdict(rcfg)),
        jconfig.CameraConfig(**dataclasses.asdict(cam)), randomized=False, use_fused=True)
    calls = []
    real = fused_ray.fused_ray_render_reference
    monkeypatch.setattr(fused_ray, "fused_ray_render_reference",
                        lambda pk, *a, **k: calls.append(pk.widths) or real(pk, *a, **k))
    with torch.no_grad():
        got, fine = render_ops.render_rays(model, o, d, mcfg, rcfg, cam, randomized=False,
                                           use_fused=True)
    assert fine is None and calls == [(100, 100, 50)]
    for name, tol in (("rgb", 3e-3), ("acc", 3e-3), ("depth", 5e-3), ("weights", 3e-3),
                      ("sigma", 2e-2), ("ts", 1e-6)):
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, atol=tol, err_msg=name)
