"""Rays longer than 256 samples, deep fields and wide ones through the
whole-ray kernels' plain versions, on the CPU:

* K1's and K2's plain versions, on rays padded as the kernels run them (300
  -> 384, 512 as it is), against the JAX package's Pallas kernels in
  interpret mode on the rays as they are, with relu and softplus density, a
  white background, IPE, and the contraction with the disparity-space
  distortion loss; the pads' weights are exactly 0;
* both at net_depth 21 (skip 4: 26 packed matrices) and at widths the JAX
  kernels take: 512 (feature 512, view head 256), 384/384/128, 1024/256/128
  (the card's wide instances) and 40/40/24, 100/100/50 (padded to multiples
  of 16); the kernels themselves at these widths need the card
  (tests/test_torch_cuda.py, chip_smoke.py phase 36);
* the CLI's long-ray paths to step 2: `train --preset full --num_samples
  300`, `train --preset hierarchical --num_fine_samples 256` (a union of 320
  samples) and `render --num_samples 300`, each through the kernels' plain
  versions at the long S.

Narrow widths, 4 rays, inputs from numpy seeds. The kernels themselves
against their plain versions need the card: chip_smoke.py.
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
from nerf_rs_tpu_torch import cli
from nerf_rs_tpu_torch.config import ModelConfig
from nerf_rs_tpu_torch.convert import params_from_numpy, params_to_numpy
from nerf_rs_tpu_torch.kernels import fused_ray, fused_render, fused_train
from nerf_rs_tpu_torch.kernels.fused_ray import (fused_ray_render, fused_ray_render_reference,
                                                 pad_samples, padded_samples)
from nerf_rs_tpu_torch.kernels.fused_train import (fused_train_grads,
                                                   fused_train_grads_reference, unpack_grads)
from nerf_rs_tpu_torch.models.encoding import posenc
from nerf_rs_tpu_torch.models.mlp import NerfMLP

torch.set_num_threads(2)

MODEL = ModelConfig(net_depth=3, net_width=32, skip_layer=2, feature_width=32,
                    view_head_width=16, pos_enc_levels=4, dir_enc_levels=2)
DEEP = ModelConfig(net_depth=21, net_width=32, skip_layer=4, feature_width=32,
                   view_head_width=16, pos_enc_levels=4, dir_enc_levels=2)
# past depth 123, where the offset tables outgrew the launch parameters
# until fault 15's repair (135 packed matrices)
DEEPER = dataclasses.replace(DEEP, net_depth=130)
WIDE = ModelConfig(net_depth=3, net_width=512, skip_layer=2, feature_width=512,
                   view_head_width=256, pos_enc_levels=4, dir_enc_levels=2)
# (net, feature, view head) widths the port pads (pack_weights: to multiples
# of 16) or runs on the kernels' wide routes (past 256): the odd ones, a
# ragged last column block of the cluster route (264: 256 + 8) and mip-NeRF
# 360's 1024-wide trunk with this package's 256 / 128 heads
WIDTHS = {"width40": (40, 40, 24), "width100": (100, 100, 50), "width264": (264, 264, 128),
          "width384": (384, 384, 128), "width1024": (1024, 256, 128)}
FIELDS = {"depth21": DEEP, "depth130": DEEPER, "width512": WIDE,
          **{k: dataclasses.replace(MODEL, net_width=w, feature_width=f, view_head_width=v)
             for k, (w, f, v) in WIDTHS.items()}}
N = 4
NEAR, FAR = 0.05, 2.0
# the contraction case samples over [0.3, 12] in disparity, as the unbounded
# tests do: from inside the unit ball to far outside it
C_NEAR, C_FAR = 0.3, 12.0

# (id, S, model changes, white background, distortion space or None)
CASES = [
    ("300-relu", 300, dict(), False, None),
    ("300-softplus-white", 300, dict(sigma_activation="softplus"), True, None),
    ("512-relu-white", 512, dict(), True, None),
    ("512-softplus", 512, dict(sigma_activation="softplus"), False, None),
    ("300-ipe", 300, dict(ipe=True, sigma_activation="softplus"), True, None),
    ("300-contract-disparity", 300, dict(contract=True, sigma_activation="softplus"), False,
     "disparity"),
]


def _model(cfg, seed, rays=None):
    """JAX-initialised weights and the port's model on them; with ``rays``
    each trunk layer's weights are first scaled so that its relu output has
    an RMS of 1 on the rays' samples (layer-sequential unit variance), which
    keeps a 130-layer trunk's signal and gradients alive: at its initial
    scale the first layers' gradients are ~1e-12."""
    params = jax.tree.map(np.asarray, jmlp.init_nerf_params(jax.random.PRNGKey(seed), cfg))
    params["sigma"]["b"] = params["sigma"]["b"] + 0.3  # an opaque-enough field
    if rays is not None:
        o, d, _, ts = (torch.from_numpy(a).double() for a in rays[:4])
        x = posenc((o[:, None] + ts[..., None] * d[:, None]).reshape(-1, 3),
                   cfg.pos_enc_levels, True)
        h = x
        for i, layer in enumerate(params["trunk"]):
            inp = torch.cat([h, x], -1) if i == cfg.skip_layer and i > 0 else h
            out = torch.relu(inp @ torch.tensor(layer["w"], dtype=torch.float64))
            rms = float(out.square().mean().sqrt())
            layer["w"] = (layer["w"] / np.float32(rms)).astype(np.float32)
            h = out / rms
    model = NerfMLP(cfg)
    model.load_state_dict(params_from_numpy(params))
    return jax.tree.map(jnp.asarray, params), model


def _rays(n, s, seed, ipe, near=NEAR, far=FAR, disparity=False):
    """numpy rays: (o, d, vd, ts, deltas, gold) and the IPE radii or None;
    IPE takes interval midpoints and lengths, else sorted points whose
    last interval runs to far."""
    rng = np.random.default_rng(seed)
    o = (rng.normal(size=(n, 3)) * 0.2).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    vd = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    gold = rng.uniform(size=(n, 3)).astype(np.float32)
    u = np.sort(rng.uniform(0.0, 1.0, (n, s + 1 if ipe else s)), -1)
    t = 1.0 / (1.0 / near + u * (1.0 / far - 1.0 / near)) if disparity else near + u * (far - near)
    t = np.sort(t, -1).astype(np.float32)
    if ipe:
        ts = (0.5 * (t[:, 1:] + t[:, :-1])).astype(np.float32)
        deltas = (t[:, 1:] - t[:, :-1]).astype(np.float32)
        return (o, d, vd, ts, deltas, gold), rng.uniform(0.005, 0.05, n).astype(np.float32)
    deltas = np.diff(np.concatenate([t, np.full((n, 1), far, np.float32)], -1), axis=-1)
    return (o, d, vd, t, deltas.astype(np.float32), gold), None


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


def _case(case_id):
    name, s, changes, white, space = next(c for c in CASES if c[0] == case_id)
    cfg = dataclasses.replace(MODEL, **changes)
    contract = changes.get("contract", False)
    near, far = (C_NEAR, C_FAR) if contract else (NEAR, FAR)
    rays, radii = _rays(N, s, 31 + s, cfg.ipe, near, far, disparity=space == "disparity")
    dist = ({} if space is None
            else dict(dist_weight=0.05, near=near, far=far, dist_space=space))
    return cfg, s, white, rays, radii, dist, far


def _hold_render(got, want, s, far):
    """K1's plain version against the JAX kernel at the JAX package's own
    kernel-vs-XLA bars (its interpret-mode bf16 dot does not sum exactly in
    f32): 3e-3, depth 5e-3 (scaled to the range), sigma 2e-2."""
    for name, g, w, tol in zip(("rgb", "acc", "depth", "weights", "sigma"), got, want,
                               (3e-3, 3e-3, 5e-3 * max(1.0, far / 2.0), 3e-3, 2e-2)):
        g = g if name in ("rgb", "acc", "depth") else g[:, :s]
        assert g.shape == np.asarray(w).shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=tol, err_msg=name)


def _hold_train(mine, tg, model, params, cfg, s, bars=(1e-5, 1e-4)):
    """K2's plain version against the JAX kernel at
    tests/test_torch_fused_train.py's bars: diag and weights atol 1e-5,
    every gradient leaf 1e-4 of the leaf's max (``bars``: the first two,
    then the last)."""
    np.testing.assert_allclose(mine.diag.numpy(), np.asarray(tg.diag), atol=bars[0])
    np.testing.assert_allclose(mine.weights[:, :s].numpy(), np.asarray(tg.weights),
                               atol=bars[0])
    leaves = params_to_numpy(unpack_grads(mine, model, cfg))
    want = jax.tree.map(np.asarray, jtrain.unpack_grads(tg, params, cfg))
    assert jax.tree_util.tree_structure(leaves) == jax.tree_util.tree_structure(want)
    for g, w in zip(jax.tree_util.tree_leaves(leaves), jax.tree_util.tree_leaves(want)):
        assert g.shape == w.shape
        scale = np.abs(w).max()
        assert scale > 1e-6  # a live field: no vacuous comparison
        np.testing.assert_allclose(g / scale, w / scale, atol=bars[1])


@pytest.mark.parametrize("case_id", [c[0] for c in CASES])
def test_render_plain_version_on_long_rays_matches_jax(case_id):
    """K1's plain version on the rays padded as the kernel runs them (300 ->
    384) against the JAX kernel in interpret mode on the rays as they are;
    the pads' weights are exactly 0, and the CPU wrapper on the unpadded rays
    is the plain version."""
    cfg, s, _, rays, radii, _, far = _case(case_id)
    params, model = _model(cfg, 41)
    o, d, vd, ts, deltas, _ = map(_t, rays)
    tp, dp = pad_samples(ts, deltas)
    assert tp.shape == (N, padded_samples(s)) == (N, -(-s // 128) * 128)
    pk = fused_render.pack_weights(model, cfg)
    got = fused_ray_render_reference(pk, o, d, vd, tp, dp, cfg, tp.shape[1], _t(radii))
    want = jray.fused_ray_render(jrender.pack_weights(params, cfg), *map(_j, rays[:5]), cfg, s,
                                 rays_per_block=N, interpret=True, radii=_j(radii))
    _hold_render(got, want, s, far)
    assert not got[3][:, s:].any()
    before = fused_ray_render.launches
    cpu = fused_ray_render(pk, o, d, vd, ts, deltas, cfg, s, radii=_t(radii))
    assert fused_ray_render.launches == before and cpu[3].shape == (N, s)
    _hold_render(cpu, want, s, far)


@pytest.mark.parametrize("case_id", [c[0] for c in CASES])
def test_train_plain_version_on_long_rays_matches_jax(case_id):
    """K2's plain version on the rays padded as the kernels run them against
    the JAX kernel in interpret mode on the rays as they are (diag slot 5,
    the per-ray distortion loss, included); the pads' weights are exactly
    0."""
    cfg, s, white, rays, radii, dist, _ = _case(case_id)
    params, model = _model(cfg, 43)
    o, d, vd, ts, deltas, gold = map(_t, rays)
    tp, dp = pad_samples(ts, deltas)
    pk = fused_render.pack_weights(model, cfg)
    mine = fused_train_grads_reference(pk, fused_render.pack_weights_t(pk), o, d, vd, tp, dp,
                                       gold, cfg, tp.shape[1], white, _t(radii), **dist)
    jpk = jrender.pack_weights(params, cfg)
    tg = jtrain.fused_train_grads(jpk, jtrain.pack_weights_t(jpk, cfg), *map(_j, rays), cfg, s,
                                  white_bg=white, rays_per_block=N, interpret=True,
                                  radii=_j(radii), **dist)
    _hold_train(mine, tg, model, params, cfg, s)
    assert not mine.weights[:, s:].any()
    if dist:
        assert float(mine.diag[:, 5].abs().min()) > 0.0


@pytest.mark.parametrize("name", list(FIELDS))
def test_plain_versions_of_deep_and_wide_fields_match_jax(name):
    """K1's and K2's plain versions against the JAX kernels in interpret mode
    at net_depth 21 and 130 (skip 4; the deeper at 64 samples and its trunk
    scaled to unit variance), at net_width 512 (feature 512, view head 256),
    at widths that are not multiples of 16 (40/40/24, 100/100/50: the port
    pads them, the JAX package to its own lanes) and at 264/264/128,
    384/384/128 and 1024/256/128, 16 samples a ray, softplus density, white background for
    K2. Up to width 256 the bars are the narrow cases'. Past it the f32 sums
    of 384 to 1024 products flip the bf16 rounding of some hidden activations
    with their order: at 512 the plain version and the JAX kernel each stand
    ~1.3e-5 (diag) and ~1.5e-3 (leaves) from the float64 witness, and 1.2e-5
    and 4.1e-4 from each other, so K2 is held at K1's bars for diag and
    weights (3e-3) and at 2e-3 of each leaf's max, and the plain version to
    its witness at 5e-3. At depth 130 the same flips compound through the
    trunk: the plain version reads 3.0e-5 (weights) and 2.7e-3 of a leaf's
    max from the JAX kernel, and 2.7e-3 from its float64 witness, so K2 is
    held at 1e-4 and 1e-2 of each leaf's max, and to its witness at 1e-2."""
    cfg = dataclasses.replace(FIELDS[name], sigma_activation="softplus")
    s = 64 if name == "depth130" else 16
    rays, _ = _rays(N, s, 48, False)
    params, model = _model(cfg, 47, rays if name == "depth130" else None)
    o, d, vd, ts, deltas, gold = map(_t, rays)
    pk = fused_render.pack_weights(model, cfg)
    assert len(pk.w_off) == cfg.net_depth + 5
    jpk = jrender.pack_weights(params, cfg)
    got = fused_ray_render_reference(pk, o, d, vd, ts, deltas, cfg, s)
    want = jray.fused_ray_render(jpk, *map(_j, rays[:5]), cfg, s, rays_per_block=N,
                                 interpret=True)
    _hold_render(got, want, s, FAR)
    mine = fused_train_grads_reference(pk, fused_render.pack_weights_t(pk), o, d, vd, ts,
                                       deltas, gold, cfg, s, True)
    tg = jtrain.fused_train_grads(jpk, jtrain.pack_weights_t(jpk, cfg), *map(_j, rays), cfg, s,
                                  white_bg=True, rays_per_block=N, interpret=True)
    wide, deep = cfg.net_width > 256, cfg.net_depth > 100
    bars = (3e-3, 2e-3) if wide else (1e-4, 1e-2) if deep else (1e-5, 1e-4)
    _hold_train(mine, tg, model, params, cfg, s, bars)
    if wide or deep:
        witness = fused_train_grads_reference(pk, fused_render.pack_weights_t(pk), o, d, vd, ts,
                                              deltas, gold, cfg, s, True, dtype=torch.float64)
        for a, b in zip(mine.dw + mine.db, witness.dw + witness.db):
            assert float((a.double() - b).abs().max()) <= (5e-3 if wide else 1e-2) * float(
                b.abs().max())


def _count(monkeypatch, module, name):
    """Wraps module.name, recording the S (the ts' columns) of each call."""
    seen = []
    real = getattr(module, name)

    def spy(*args, **kwargs):
        seen.append(args[4 if name == "fused_ray_render_reference" else 5].shape[1])
        return real(*args, **kwargs)
    monkeypatch.setattr(module, name, spy)
    return seen


@pytest.mark.parametrize("preset,flags,want", [
    ("full", ("--num_samples", "300"), [300, 300]),
    ("hierarchical", ("--num_fine_samples", "256"), [64, 320, 64, 320]),
], ids=["full-300", "hierarchical-fine-256"])
def test_cli_trains_long_rays_on_the_cpu(preset, flags, want, tmp_path, monkeypatch, capsys):
    """`cli train` to step 2 at full width on a 16x16 sphere with 64 rays, each
    step through the train kernel's plain version at the long S (the
    hierarchical union: 64 coarse + 256 fine samples)."""
    seen = _count(monkeypatch, fused_train, "fused_train_grads_reference")
    rc = cli.main(["train", "--device", "cpu", "--preset", preset, "--dataset", "sphere",
                   *flags, "--width", "16", "--height", "16", "--num_rays", "64",
                   "--num_iter", "2", "--save_dir", str(tmp_path), "--log_dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert rc == 0 and "done at step 2" in out
    assert seen == want


def test_cli_renders_long_rays_on_the_cpu(tmp_path, monkeypatch, capsys):
    """`cli render --num_samples 300` of a 16x16 view through the render
    kernel's plain version at S = 300 (one chunk), a finite image."""
    ck = tmp_path / "ck"
    assert cli.main(["train", "--device", "cpu", "--dataset", "sphere", "--width", "16",
                     "--height", "16", "--num_samples", "8", "--num_rays", "32", "--num_iter",
                     "1", "--save_dir", str(ck), "--log_dir", str(ck)]) == 0
    capsys.readouterr()
    seen = _count(monkeypatch, fused_ray, "fused_ray_render_reference")
    rc = cli.main(["render", "--device", "cpu", "--dataset", "sphere", "--width", "16",
                   "--height", "16", "--num_samples", "300", "--save_dir", str(ck), "--view",
                   "0", "--out_dir", str(tmp_path / "r")])
    out = capsys.readouterr().out
    assert rc == 0 and "psnr" in out
    assert seen == [300]
    assert (tmp_path / "r" / "view-0.png").exists()
