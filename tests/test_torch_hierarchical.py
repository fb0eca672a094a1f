"""The PyTorch port's hierarchical slice on the CPU (ROADMAP slices 2 and
3 without multiscale): the kernels' plain versions with IPE and with
rays longer than one 128-row tile against the JAX package's Pallas
kernels in interpret mode, the zero-length pad those rays take, the
fine pass of ``render_rays``, the coarse kernel -> resample -> fine
kernel chain of ``whole_ray_grads`` and one train step of both presets'
settings against the JAX package on converted weights, and checkpoints
with a fine field.

Small widths (depth 3, width 32), a few rays, inputs from numpy seeds.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_rs_tpu import config as jconfig
from nerf_rs_tpu.kernels import fused_ray as jray
from nerf_rs_tpu.kernels import fused_render as jrender
from nerf_rs_tpu.kernels import fused_train as jtrain
from nerf_rs_tpu.models import mlp as jmlp
from nerf_rs_tpu.ops import render as jrender_ops
from nerf_rs_tpu.ops import sampling as jsamp
from nerf_rs_tpu.train import step as jstep
from nerf_rs_tpu_torch.config import (CameraConfig, Config, DataConfig, ModelConfig,
                                      RenderConfig, TrainConfig)
from nerf_rs_tpu_torch.convert import params_from_numpy, params_to_numpy
from nerf_rs_tpu_torch.kernels import fused_render
from nerf_rs_tpu_torch.kernels.fused_ray import (fused_ray_render_reference, pad_samples,
                                                 padded_samples)
from nerf_rs_tpu_torch.kernels.fused_train import fused_train_grads_reference, unpack_grads
from nerf_rs_tpu_torch.models.mlp import NerfMLP
from nerf_rs_tpu_torch.ops import render as render_ops
from nerf_rs_tpu_torch.ops import sampling
from nerf_rs_tpu_torch.train import checkpoint as ckpt
from nerf_rs_tpu_torch.train import step

torch.set_num_threads(2)

MODEL = ModelConfig(net_depth=3, net_width=32, skip_layer=2, feature_width=32,
                    view_head_width=16, pos_enc_levels=4, dir_enc_levels=2)
N = 8


def _model(cfg, seed):
    """JAX-drawn weights and the port's field holding the same values."""
    params = jmlp.init_nerf_params(jax.random.PRNGKey(seed), cfg)
    params["sigma"]["b"] = params["sigma"]["b"] + 0.3  # an opaque-enough field
    model = NerfMLP(cfg)
    model.load_state_dict(params_from_numpy(jax.tree.map(np.asarray, params)))
    return params, model


def _rays(n, s, seed, ipe):
    """(o, d, viewdir, ts, deltas, gold) and radii; with IPE the ts are
    interval midpoints and the deltas exact lengths of jittered edges.
    The rays start near the origin, where the field is busy."""
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


# (IPE, S): the IPE branch at the mipnerf preset's pass sizes, and rays
# longer than one tile (192: the hierarchical union pass; 193: the record
# preset's), both PE and IPE
_KERNEL_CASES = [(True, 64), (True, 128), (False, 192), (False, 193), (True, 192)]


@pytest.mark.parametrize("sigma_act", ["relu", "softplus"])
@pytest.mark.parametrize("ipe,s", _KERNEL_CASES)
def test_render_kernel_reference_matches_jax(ipe, s, sigma_act):
    """K1's plain version against the JAX kernel in interpret mode, at
    the K1 PE test's bars (tests/test_torch_fused_ray.py: JAX's
    interpret-mode bf16 dot does not sum exactly in f32)."""
    cfg = dataclasses.replace(MODEL, ipe=ipe, sigma_activation=sigma_act)
    params, model = _model(cfg, 3)
    rays, radii = _rays(N, s, 4, ipe)
    want = jray.fused_ray_render(jrender.pack_weights(params, cfg), *map(_j, rays[:5]), cfg, s,
                                 rays_per_block=N, interpret=True, radii=_j(radii))
    got = fused_ray_render_reference(fused_render.pack_weights(model, cfg),
                                     *map(_t, rays[:5]), cfg, s, radii=_t(radii))
    for name, g, w, tol in zip(("rgb", "acc", "depth", "weights", "sigma"), got, want,
                               (3e-3, 3e-3, 5e-3, 3e-3, 2e-2)):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=tol, err_msg=name)
    assert float(got[1].min()) > 0.05  # the rays see the field


def _leaves(tree):
    return jax.tree_util.tree_leaves(tree)


def _assert_leaves(mine, want, atol):
    assert jax.tree_util.tree_structure(mine) == jax.tree_util.tree_structure(want)
    for g, w in zip(_leaves(mine), _leaves(want)):
        assert g.shape == w.shape
        scale = np.abs(w).max()
        assert scale > 1e-6  # a live field: no vacuous comparison
        np.testing.assert_allclose(g / scale, w / scale, atol=atol)


@pytest.mark.parametrize("sigma_act", ["relu", "softplus"])
@pytest.mark.parametrize("ipe,s", _KERNEL_CASES)
def test_train_kernel_reference_matches_jax(ipe, s, sigma_act):
    """K2's plain version against the JAX kernel in interpret mode: diag
    and weights atol 1e-5, as the K2 PE test (tests/test_torch_fused_train.py);
    every leaf 5e-4 of its max, not the PE test's 1e-4. Both sides sum
    the compositing scans in f32 in another order, and a d sigma that
    lies on a bf16 rounding boundary can round the other way: in the
    relu IPE case at S = 64, 2 of 512 samples do (4e-7 apart before
    rounding; the float64 witness rounds as JAX does), which moves the
    sigma and trunk leaves by up to 1.8e-4 of their max."""
    cfg = dataclasses.replace(MODEL, ipe=ipe, sigma_activation=sigma_act)
    params, model = _model(cfg, 5)
    rays, radii = _rays(N, s, 6, ipe)
    pk = jrender.pack_weights(params, cfg)
    tg = jtrain.fused_train_grads(pk, jtrain.pack_weights_t(pk, cfg), *map(_j, rays), cfg, s,
                                  white_bg=True, rays_per_block=N, interpret=True,
                                  radii=_j(radii))
    ppk = fused_render.pack_weights(model, cfg)
    got = fused_train_grads_reference(ppk, fused_render.pack_weights_t(ppk), *map(_t, rays),
                                      cfg, s, True, _t(radii))
    np.testing.assert_allclose(got.diag.numpy(), np.asarray(tg.diag), atol=1e-5)
    np.testing.assert_allclose(got.weights.numpy(), np.asarray(tg.weights), atol=1e-5)
    _assert_leaves(params_to_numpy(unpack_grads(got, model, cfg)),
                   jax.tree.map(np.asarray, jtrain.unpack_grads(tg, params, cfg)), 5e-4)


@pytest.mark.parametrize("ipe,s", [(False, 193), (True, 192), (False, 48), (True, 5),
                                   (False, 150)])
def test_zero_length_pad_changes_nothing(ipe, s):
    """The kernels' pad (zero-length intervals at the far end, up to a
    power of two, to 192 or to 256) leaves rgb, acc, depth, the loss and
    every gradient leaf as they were, and the pads' weights are exactly 0:
    the port's counterpart of tests/test_fused_train.py's unaligned-S
    tests."""
    cfg = dataclasses.replace(MODEL, ipe=ipe, sigma_activation="softplus")
    _, model = _model(cfg, 7)
    rays, radii = _rays(N, s, 8, ipe)
    o, d, vd, ts, deltas, gold = map(_t, rays)
    tp, dp = pad_samples(ts, deltas)
    sp = padded_samples(s)
    assert tp.shape == (N, sp) and sp in (8, 64, 192, 256) and sp >= s
    assert torch.equal(tp[:, :s], ts) and not dp[:, s:].any()
    pk = fused_render.pack_weights(model, cfg)
    a = fused_ray_render_reference(pk, o, d, vd, ts, deltas, cfg, s, _t(radii))
    b = fused_ray_render_reference(pk, o, d, vd, tp, dp, cfg, sp, _t(radii))
    for x, y in zip(a[:3], b[:3]):
        torch.testing.assert_close(x, y, atol=1e-6, rtol=0)
    assert torch.equal(b[3][:, s:], torch.zeros(N, sp - s))
    pkt = fused_render.pack_weights_t(pk)
    ga = fused_train_grads_reference(pk, pkt, o, d, vd, ts, deltas, gold, cfg, s, True, _t(radii))
    gb = fused_train_grads_reference(pk, pkt, o, d, vd, tp, dp, gold, cfg, sp, True, _t(radii))
    torch.testing.assert_close(ga.diag, gb.diag, atol=1e-6, rtol=0)
    for x, y in zip(ga.dw + ga.db, gb.dw + gb.db):  # the same sums, rows in another grouping
        torch.testing.assert_close(x, y, atol=1e-6 * max(float(y.abs().max()), 1e-6), rtol=0)


# the two presets' settings at small size (the samples are the presets')
_PRESETS = {
    "hierarchical": dict(model=MODEL, render=RenderConfig(
        num_samples=64, num_fine_samples=128, white_background=True, randomized=False)),
    "mipnerf": dict(model=dataclasses.replace(MODEL, ipe=True, sigma_activation="softplus"),
                    render=RenderConfig(num_samples=64, num_fine_samples=128, share_network=True,
                                        fine_mode="standalone", white_background=True,
                                        randomized=False)),
}


def _cfg(preset, kernel=True, precision="mixed", **render) -> Config:
    kw = _PRESETS[preset]
    return Config(camera=CameraConfig(width=8, height=8), model=kw["model"],
                  render=dataclasses.replace(kw["render"], **render),
                  train=TrainConfig(num_rays=N, learning_rate=1e-3, precision=precision,
                                    whole_ray_block=N),
                  data=DataConfig(dataset="sphere"), use_whole_ray_train=kernel)


def _states(cfg: Config, seed=11):
    """The JAX state drawn from a key and the port's state holding the
    same weights (both nets when there are two)."""
    jcfg = jconfig.Config.from_dict(cfg.to_dict())
    jstate = jstep.init_state(jax.random.PRNGKey(seed), jcfg)
    bump = lambda p: {**p, "sigma": {**p["sigma"], "b": p["sigma"]["b"] + 0.3}}
    jstate = jstate._replace(params=bump(jstate.params), fine_params=(
        None if jstate.fine_params is None else bump(jstate.fine_params)))
    jstate = jstate._replace(opt_state=jstep.make_optimizer(jcfg).init(
        jstep._trainable(jstate, jcfg)))
    state = step.init_state(cfg)
    state.params.load_state_dict(params_from_numpy(jax.tree.map(np.asarray, jstate.params)))
    assert (state.fine_params is None) == (jstate.fine_params is None)
    if state.fine_params is not None:
        state.fine_params.load_state_dict(
            params_from_numpy(jax.tree.map(np.asarray, jstate.fine_params)))
    return jcfg, jstate, state


def _batch(seed=12):
    rays, _ = _rays(N, 1, seed, False)
    o, d, _, _, _, gold = rays
    o = o + np.array([0.0, 0.0, -1.0], np.float32)  # the sphere scene's camera distance
    d = d * 0.2 + np.array([0.0, 0.0, 1.0], np.float32)
    return o, d, gold


# the coarse weight above which a fine draw's bin is held to the ts bar of
# 1e-4; below it the inverse CDF is steep (its denominator is the bin's
# weight plus sample_pdf's eps), the draw's position moves by up to 1.8e-4
# under an ulp of the coarse weights, and it carries a weight of ~0: such
# draws take the grid case's 5e-4
TS_WEIGHT_FLOOR = 1e-4


def _assert_ts_close(got_ts, want_ts, coarse_ts, coarse_w, tol, steep_tol=5e-4):
    """Fine ts at ``tol`` where the draw's coarse bin (the one around the
    nearest coarse sample: sample_pdf's bins run from midpoint to
    midpoint, and IPE's coarse intervals are even, so their midpoints
    are the coarse ts) carries weight above TS_WEIGHT_FLOOR, at
    ``steep_tol`` elsewhere."""
    got_ts, want_ts = np.asarray(got_ts), np.asarray(want_ts)
    coarse_ts, coarse_w = np.asarray(coarse_ts), np.asarray(coarse_w)
    near = np.abs(want_ts[..., :, None] - coarse_ts[..., None, :]).argmin(-1)
    heavy = np.take_along_axis(coarse_w, near, -1) > TS_WEIGHT_FLOOR
    gap = np.abs(got_ts - want_ts)
    assert (gap[heavy] <= tol).all(), ("ts where the bin has weight", float(gap[heavy].max()))
    assert (gap <= steep_tol).all(), ("ts where the bin has ~0 weight", float(gap.max()))
    assert heavy.mean() > 0.5  # most draws are held at the tight bar


# the CDF's rounding in f32 epsilons: twice sqrt(B), the random-walk size
# of B = 64 roundings (the sides read 4.6 at most here; the worst case of B
# roundings in one direction, 64, no pair of summation orders comes near)
CDF_EPS_MULT = 16.0


def _sample_pdf_f64(bins, weights, num_samples, eps=1e-5):
    """sample_pdf(randomized=False) in float64 (the formula of both
    packages' ops/sampling.py), and the slope of the inverse CDF at each
    draw: (bin width) / (the bin's CDF step)."""
    w = weights.astype(np.float64) + eps
    cdf = np.cumsum(w / w.sum(-1, keepdims=True), axis=-1)
    cdf = np.concatenate([np.zeros_like(cdf[..., :1]), cdf], axis=-1)
    u = np.broadcast_to(np.linspace(0.0, 1.0 - 1e-6, num_samples, dtype=np.float32),
                        weights.shape[:-1] + (num_samples,)).astype(np.float64)
    above = np.stack([np.searchsorted(c, uu, side="right") for c, uu in zip(cdf, u)])
    below = np.clip(above - 1, 0, None)
    above = np.clip(above, None, cdf.shape[-1] - 1)
    take = lambda x, i: np.take_along_axis(x, i, -1)
    c_lo, c_hi = take(cdf, below), take(cdf, above)
    b_lo, b_hi = take(bins.astype(np.float64), below), take(bins.astype(np.float64), above)
    denom = np.where(c_hi - c_lo < eps, 1.0, c_hi - c_lo)
    return b_lo + (u - c_lo) / denom * (b_hi - b_lo), (b_hi - b_lo) / denom


@pytest.mark.parametrize("num_samples", [64, 128])
@pytest.mark.parametrize("preset", ["hierarchical", "mipnerf"])
def test_sample_pdf_matches_jax_on_the_same_coarse_pass(preset, num_samples):
    """The fine sampler on identical inputs: the JAX package's coarse
    pass (midpoint samples, on the fine-pass test's weights and rays)
    goes in as numpy to both packages' ``sample_pdf`` (randomized=False),
    with the bins render_rays builds (midpoint bins of the coarse ts) and
    the coarse weights. Each side's fine ts stand within 1e-6 plus the
    inverse CDF's slope times CDF_EPS_MULT f32 epsilons of a float64
    evaluation, and the two sides within the same bar of each other: the
    CDF is a cumulative sum of B = 64 terms, and XLA sums it in another
    order than torch.cumsum (their CDFs part by up to 1.8e-7 on these
    inputs), which a steep slope multiplies (in a bin of ~0 weight the
    step is sample_pdf's eps). Where the slope is small the bar is a few
    1e-6, and most draws sit there. ``merge_ts`` of the coarse and fine
    ts agrees exactly."""
    cfg = _cfg(preset)
    jcfg, jstate, _ = _states(cfg)
    o, d, _ = _batch()
    coarse, _ = jrender_ops.render_rays(jstate.params, jnp.asarray(o), jnp.asarray(d),
                                        jax.random.PRNGKey(0), jcfg.model,
                                        dataclasses.replace(jcfg.render, num_fine_samples=0),
                                        jcfg.camera, randomized=False, use_fused=False)
    ts, w = np.asarray(coarse.ts), np.asarray(coarse.weights)
    mids = 0.5 * (ts[..., 1:] + ts[..., :-1])
    bins = np.concatenate([ts[..., :1], mids, ts[..., -1:]], axis=-1)
    want = np.asarray(jsamp.sample_pdf(jax.random.PRNGKey(0), jnp.asarray(bins),
                                       jnp.asarray(w), num_samples, randomized=False))
    got = sampling.sample_pdf(torch.from_numpy(bins), torch.from_numpy(w), num_samples,
                              randomized=False).numpy()
    assert got.shape == (N, num_samples)
    ref, slope = _sample_pdf_f64(bins, w, num_samples)
    bar = 1e-6 + slope * CDF_EPS_MULT * np.finfo(np.float32).eps
    for name, side in (("torch", got), ("JAX", want)):
        gap = np.abs(side - ref)
        assert (gap <= bar).all(), (name, float((gap / bar).max()))
    assert (np.abs(got - want) <= bar).all()
    assert (bar < 5e-6).mean() > 0.5  # most draws are held at a few 1e-6
    merged = sampling.merge_ts(torch.from_numpy(ts), torch.from_numpy(got)).numpy()
    np.testing.assert_array_equal(
        merged, np.asarray(jsamp.merge_ts(jnp.asarray(ts), jnp.asarray(got))))


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("fine_mode", ["union", "standalone"])
@pytest.mark.parametrize("preset", ["hierarchical", "mipnerf"])
def test_render_rays_fine_pass_matches_jax(preset, fine_mode, fused):
    """Coarse and fine passes of render_rays (midpoint samples) against
    the JAX package's, on the eager f32 field and through the kernel's
    plain version (the JAX kernel in interpret mode), both fine modes, at
    tests/test_fused_ray.py's bars."""
    cfg = _cfg(preset, fine_mode=fine_mode)
    jcfg, jstate, state = _states(cfg)
    o, d, _ = _batch()
    kw = dict(randomized=False, use_fused=fused)
    want = jrender_ops.render_rays(jstate.params, jnp.asarray(o), jnp.asarray(d),
                                   jax.random.PRNGKey(0), jcfg.model, jcfg.render, jcfg.camera,
                                   fine_params=jstate.fine_params, **kw)
    with torch.no_grad():
        got = render_ops.render_rays(state.params, torch.from_numpy(o), torch.from_numpy(d),
                                     cfg.model, cfg.render, cfg.camera,
                                     fine_params=state.fine_params, **kw)
    # union: 64 + 128 samples, or 65 + 129 edges = 193 intervals (IPE)
    want_s = {"standalone": 128, "union": 193 if cfg.model.ipe else 192}[fine_mode]
    assert got[1].weights.shape == (N, want_s)
    for g, w in zip(got, want):
        for name, tol in (("rgb", 3e-3), ("acc", 3e-3), ("depth", 5e-3), ("weights", 3e-3)):
            np.testing.assert_allclose(getattr(g, name).numpy(), np.asarray(getattr(w, name)),
                                       atol=tol, err_msg=name)
    # ts: 1e-4 where the draw's coarse bin carries weight, 5e-4 where the
    # inverse CDF is steep (tests the sampler itself on identical inputs:
    # test_sample_pdf_matches_jax_on_the_same_coarse_pass)
    np.testing.assert_allclose(got[0].ts.numpy(), np.asarray(want[0].ts), atol=1e-4)
    _assert_ts_close(got[1].ts, want[1].ts, want[0].ts, want[0].weights, 1e-4)
    assert float(got[0].acc.mean()) > 0.1  # the coarse pass sees the field


@pytest.mark.parametrize("grid", [False, True])
@pytest.mark.parametrize("white", [False, True])
def test_shared_network_fast_fine_pass_matches_jax(white, grid):
    """The shared-network fast fine pass (one field, union, point samples,
    eager field; nerf_rs_tpu/ops/render.py:506-569): the coarse samples
    evaluated once, the fine draws, only the fine samples evaluated, one
    stable sort of (ts, sigma, r, g, b) and channel-wise compositing,
    against the JAX function at midpoint samples on converted weights, at
    tests/test_fused_ray.py's bars; with an occupancy grid guiding the
    coarse samples too. The fine pass holds the union's 64 + 128 samples
    in depth order."""
    render = RenderConfig(num_samples=64, num_fine_samples=128, share_network=True,
                          fine_mode="union", white_background=white, randomized=False,
                          occ_res=8 if grid else 0, occ_aabb=1.6)
    cfg = Config(camera=CameraConfig(width=8, height=8), model=MODEL, render=render,
                 train=TrainConfig(num_rays=N, precision="f32"), data=DataConfig(dataset="sphere"))
    jcfg, jstate, state = _states(cfg)
    o, d, _ = _batch()
    g = None
    if grid:
        c = np.linspace(-1.6, 1.6, 8, endpoint=False) + 0.2
        gx, gy, gz = np.meshgrid(c, c, c, indexing="ij")
        g = (np.sqrt(gx ** 2 + gy ** 2 + gz ** 2) < 0.7).astype(np.float32)
    want = jrender_ops.render_rays(jstate.params, jnp.asarray(o), jnp.asarray(d),
                                   jax.random.PRNGKey(0), jcfg.model, jcfg.render, jcfg.camera,
                                   randomized=False, grid=None if g is None else jnp.asarray(g))
    with torch.no_grad():
        got = render_ops.render_rays(state.params, torch.from_numpy(o), torch.from_numpy(d),
                                     cfg.model, cfg.render, cfg.camera, randomized=False,
                                     grid=None if g is None else torch.from_numpy(g))
        assert render_ops._shared_fast(cfg.render, cfg.model, None, False)
    assert got[1].weights.shape == (N, 192) and got[1].ts.shape == (N, 192)
    assert bool((torch.diff(got[1].ts, dim=-1) >= 0).all())
    # with the grid, the occupancy bins come from each package's own f32
    # linspace (an ulp apart at some knots), and the last fine draws sit
    # where the coarse weights are ~0 and the inverse CDF is steep: ts
    # there move by up to 3e-4 (bar 5e-4), the weights they carry by ~0.
    # Without the grid the same holds of the draws in bins of ~0 coarse
    # weight; those with weight keep 1e-4
    for gg, w in zip(got, want):
        for name, tol in (("rgb", 3e-3), ("acc", 3e-3), ("depth", 5e-3), ("weights", 3e-3),
                          ("sigma", 2e-2)):
            np.testing.assert_allclose(getattr(gg, name).numpy(), np.asarray(getattr(w, name)),
                                       atol=tol, err_msg=name)
    if grid:
        for gg, w in zip(got, want):
            np.testing.assert_allclose(gg.ts.numpy(), np.asarray(w.ts), atol=5e-4)
    else:
        np.testing.assert_allclose(got[0].ts.numpy(), np.asarray(want[0].ts), atol=1e-4)
        _assert_ts_close(got[1].ts, want[1].ts, want[0].ts, want[0].weights, 1e-4)
    assert float(got[0].acc.mean()) > 0.1


@pytest.mark.parametrize("preset", ["hierarchical", "mipnerf"])
def test_whole_ray_grads_chain_matches_jax(preset):
    """One whole_ray_grads of each preset (coarse kernel -> resample ->
    fine kernel, midpoint samples) against the JAX package's on
    converted weights: coarse and fine losses and every leaf of both
    nets (the mipnerf preset's one shared net sums both passes), at
    tests/test_fused_train.py:174-229's bars (loss 4e-3, leaves 5e-2 of
    the leaf's max)."""
    cfg = _cfg(preset)
    jcfg, jstate, state = _states(cfg)
    o, d, gold = _batch()
    grads_j, aux_j = jstep.whole_ray_grads(jstep._trainable(jstate, jcfg),
                                           jstep.Batch(*map(jnp.asarray, (o, d, gold))),
                                           jax.random.PRNGKey(0), jcfg)
    grads, aux = step.whole_ray_grads(state.params, step.Batch(*map(torch.from_numpy,
                                                                    (o, d, gold))),
                                      None, cfg, state.fine_params)
    for key in ("loss", "loss_coarse", "loss_fine", "psnr"):
        assert abs(float(aux[key]) - float(aux_j[key])) < 4e-3, key
    np.testing.assert_allclose(aux["ray_err"].numpy(), np.asarray(aux_j["ray_err"]), atol=4e-3)
    if state.fine_params is not None:
        coarse = {k: v for k, v in grads.items() if not k.startswith("fine.")}
        fine = {k[5:]: v for k, v in grads.items() if k.startswith("fine.")}
        mine, want = (params_to_numpy(coarse), params_to_numpy(fine)), grads_j
    else:
        mine, want = params_to_numpy(grads), grads_j
    _assert_leaves(mine, jax.tree.map(np.asarray, want), 5e-2)


@pytest.mark.parametrize("kernel", [True, False])
@pytest.mark.parametrize("preset", ["hierarchical", "mipnerf"])
def test_train_step_of_each_preset_matches_jax(preset, kernel):
    """One Adam step over both nets (the kernel chain, or autograd of the
    two-pass loss at f32), against the JAX step. The first Adam update is
    ~lr sign(g) where |g| >> eps, so the new weights agree to a fraction
    of lr."""
    cfg = _cfg(preset, kernel=kernel, precision="mixed" if kernel else "f32")
    jcfg, jstate, state = _states(cfg)
    o, d, gold = _batch()
    new_j, aux_j = jstep.train_step(jstate, jstep.Batch(*map(jnp.asarray, (o, d, gold))),
                                    jax.random.PRNGKey(0), jcfg)
    state, aux = step.train_step(state, step.Batch(*map(torch.from_numpy, (o, d, gold))),
                                 None, cfg)
    assert state.step == 1
    for key in ("loss", "loss_coarse", "loss_fine"):
        np.testing.assert_allclose(float(aux[key]), float(aux_j[key]), rtol=1e-3, err_msg=key)
    nets = [(state.params, new_j.params)]
    if state.fine_params is not None:
        nets.append((state.fine_params, new_j.fine_params))
    lr = cfg.train.learning_rate
    for mine, want in nets:
        for g, w in zip(_leaves(params_to_numpy(mine)), _leaves(jax.tree.map(np.asarray, want))):
            np.testing.assert_allclose(g, w, atol=0.1 * lr)


def test_checkpoint_round_trip_with_a_fine_net(tmp_path):
    cfg = _cfg("hierarchical")
    state = step.init_state(cfg)
    assert state.fine_params is not None
    # the fine field is its own draw, the same on every call
    assert not torch.equal(state.params.trunk[0].w, state.fine_params.trunk[0].w)
    assert torch.equal(step.init_state(cfg).fine_params.trunk[0].w, state.fine_params.trunk[0].w)
    o, d, gold = _batch()
    batch = step.Batch(*map(torch.from_numpy, (o, d, gold)))
    state, _ = step.train_step(state, batch, None, cfg)
    path = ckpt.save(state, str(tmp_path))
    coarse, fine = NerfMLP(MODEL), NerfMLP(MODEL)
    assert ckpt.restore_weights(path, coarse, fine) == 1
    fresh = ckpt.restore(path, step.init_state(cfg))
    assert fresh.step == 1
    for a, b, c in ((state.params, fresh.params, coarse),
                    (state.fine_params, fresh.fine_params, fine)):
        for (k, x), y, z in zip(a.state_dict().items(), b.state_dict().values(),
                                c.state_dict().values()):
            assert torch.equal(x, y) and torch.equal(x, z), k
    # the optimizer state covers both nets: the next steps agree
    s1, _ = step.train_step(state, batch, None, cfg)
    s2, _ = step.train_step(fresh, batch, None, cfg)
    for (k, x), (_, y) in zip(step.named_trainable(s1), step.named_trainable(s2)):
        assert torch.equal(x, y), k
    with pytest.raises(ValueError, match="fine"):
        ckpt.restore_weights(path, NerfMLP(MODEL))  # a two-field file into one field
    single = ckpt.save(state.params, str(tmp_path / "one"), step=3)
    with pytest.raises(ValueError, match="fine"):
        ckpt.restore_weights(single, NerfMLP(MODEL), NerfMLP(MODEL))
