"""The PyTorch port's unbounded-scene slice on the CPU (ROADMAP slice 5,
with tests/test_torch_proposal.py): mip-NeRF 360's contraction of points
and Gaussians, disparity stratification and the distortion loss against
the JAX package; apply_nerf with the contraction for every field family;
the whole-ray kernels' plain versions with the contraction and distortion
branches against the JAX package's Pallas kernels in interpret mode (as
tests/test_contract_kernel.py runs them), diag slot 5 included; one
train step of ``--preset unbounded`` at small width against the JAX step;
and the CLI preset.

Small widths, a few rays, inputs from numpy seeds; every tolerance is
stated where it is used.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_rs_tpu import cli as jcli
from nerf_rs_tpu import config as jconfig
from nerf_rs_tpu.kernels import fused_ray as jray
from nerf_rs_tpu.kernels import fused_render as jrender
from nerf_rs_tpu.kernels import fused_train as jtrain
from nerf_rs_tpu.models import mlp as jmlp
from nerf_rs_tpu.ops import contract as jcontract
from nerf_rs_tpu.ops import render as jrender_ops
from nerf_rs_tpu.ops import sampling as jsamp
from nerf_rs_tpu.train import step as jstep
from nerf_rs_tpu_torch import cli
from nerf_rs_tpu_torch.config import ModelConfig
from nerf_rs_tpu_torch.convert import params_from_numpy, params_to_numpy
from nerf_rs_tpu_torch.kernels import fused_render
from nerf_rs_tpu_torch.kernels.fused_ray import fused_ray_render, fused_ray_render_reference
from nerf_rs_tpu_torch.kernels.fused_train import (fused_train_grads,
                                                   fused_train_grads_reference, unpack_grads)
from nerf_rs_tpu_torch.models.mlp import apply_nerf, init_nerf_params
from nerf_rs_tpu_torch.ops import contract, render as render_ops, sampling
from nerf_rs_tpu_torch.train import step

torch.set_num_threads(2)

MODEL = ModelConfig(net_depth=4, net_width=32, skip_layer=2, feature_width=32,
                    view_head_width=16, pos_enc_levels=3, dir_enc_levels=1, contract=True)
MODEL_IPE = dataclasses.replace(MODEL, ipe=True, sigma_activation="softplus")
S, N = 8, 16
NEAR, FAR = 0.3, 12.0  # samples from inside the unit ball to far outside it


def _points(n=4096, seed=0):
    """Points inside, on and far outside the unit ball (the origin too),
    and positive variances."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 3)) * np.exp(rng.uniform(-3.0, 3.0, (n, 1)))
    x[0] = 0.0
    x[1] = [1.0, 0.0, 0.0]
    var = rng.uniform(1e-6, 0.5, (n, 3))
    return x.astype(np.float32), var.astype(np.float32)


def test_contract_matches_jax():
    """The same steps in the same order. Each side is first held to the
    same steps in float64 at rtol 1e-6 (both read 2.9e-7 relative at
    most), so a disagreement names the side at fault. Then the two are
    held to each other in ulps, at most 2: each is within a few ulp of
    float64, and two compilers may place one f32 rounding of the same
    steps differently (a fused multiply-add, or 1/safe taken once), which
    parts the results by an ulp, or by 2 at the bottom of a binade. A
    relative bar of 2e-7 sits below that there (it failed 1 of 12,288 on
    one host at 2.05e-7)."""
    x, _ = _points()
    got = contract.contract(torch.from_numpy(x)).numpy()
    want = np.asarray(jcontract.contract(jnp.asarray(x)))
    x64 = x.astype(np.float64)
    r = np.sqrt(np.maximum((x64 * x64).sum(-1, keepdims=True), 1e-16))
    safe = np.maximum(r, 1.0)
    ref = np.where(r <= 1.0, x64, (2.0 - 1.0 / safe) * x64 / safe)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-30, err_msg="torch vs float64")
    np.testing.assert_allclose(want, ref, rtol=1e-6, atol=1e-30, err_msg="JAX vs float64")
    np.testing.assert_array_max_ulp(got, want, maxulp=2)
    assert np.linalg.norm(got, axis=-1).max() < 2.0


# the variance's bar: a multiple of f32's epsilon times the sum of the
# absolute values of its three terms, the error bound of a sum that cancels
# (each term carries a few roundings of its own; 16 covers them with room)
_VAR_EPS_MULT = 16.0


def _contract_gaussian_f64(x: np.ndarray, var: np.ndarray):
    """The linearised contraction of ops/contract.py's docstring, in
    float64: the mean g(r) x and the variance's three terms g^2 s_i,
    2 g (g'/r) x_i^2 s_i and (g'/r)^2 x_i^2 sum_j x_j^2 s_j, returned
    apart (inside the unit ball: x, and var as its one term)."""
    x = x.astype(np.float64)
    var = var.astype(np.float64)
    r = np.sqrt(np.maximum((x * x).sum(-1, keepdims=True), 1e-16))
    inside = r <= 1.0
    safe = np.maximum(r, 1.0)
    g = 2.0 / safe - 1.0 / safe ** 2
    gp_over_r = (-2.0 / safe ** 2 + 2.0 / safe ** 3) / safe
    x2 = x * x
    quad = (x2 * var).sum(-1, keepdims=True)
    terms = np.stack([g * g * var, 2.0 * g * gp_over_r * x2 * var,
                      gp_over_r * gp_over_r * x2 * quad])
    terms = np.where(inside[None], np.stack([var, 0 * var, 0 * var]), terms)
    return np.where(inside, x, g * x), terms


def test_contract_gaussian_matches_jax():
    """Mean and variance of the linearised contraction. The mean at f32
    rounding (rtol 1e-6). The variance sums three terms of both signs, so
    a relative bar on it measures the cancellation: each side is held to a
    float64 evaluation of the same terms within _VAR_EPS_MULT f32 epsilons
    of the terms' absolute sum, and the port to JAX within the same bar
    (at rtol 1e-5 3 of 12,288 variances read 8.3e-5 apart on one host, an
    absolute 9.3e-10)."""
    x, var = _points(seed=1)
    mean, v = contract.contract_gaussian(torch.from_numpy(x), torch.from_numpy(var))
    jm, jv = jcontract.contract_gaussian(jnp.asarray(x), jnp.asarray(var))
    np.testing.assert_allclose(mean.numpy(), np.asarray(jm), rtol=1e-6, atol=1e-30)
    m64, terms = _contract_gaussian_f64(x, var)
    np.testing.assert_allclose(mean.numpy(), m64, rtol=1e-6, atol=1e-30,
                               err_msg="torch mean vs float64")
    ref = np.maximum(terms.sum(0), 0.0)
    bar = _VAR_EPS_MULT * np.finfo(np.float32).eps * np.abs(terms).sum(0)
    for name, side in (("torch", v.numpy()), ("JAX", np.asarray(jv))):
        gap = np.abs(side - ref)
        assert (gap <= bar).all(), (name, float((gap / bar).max()))
    assert (np.abs(v.numpy() - np.asarray(jv)) <= bar).all()
    # the kernels' plain versions are these functions
    assert fused_render.contract_points is contract.contract
    assert fused_render.contract_gaussian is contract.contract_gaussian


@pytest.mark.parametrize("num_samples", [8, 64])
def test_disparity_stratification_matches_jax(num_samples):
    """Bin midpoints even in 1/t (randomized=False: no draw), ascending,
    at f32 rounding of the two linspaces (rtol 1e-6)."""
    got = sampling.stratified_ts(3, num_samples, NEAR, 60.0, False, space="disparity")
    want = jsamp.stratified_ts(jax.random.PRNGKey(0), 3, num_samples, NEAR, 60.0, False,
                               space="disparity")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    assert bool((got[:, 1:] > got[:, :-1]).all()) and float(got.min()) > NEAR
    with pytest.raises(ValueError, match="space"):
        sampling.stratified_ts(3, 8, NEAR, FAR, False, space="log")


def _weights(n=N, s=S, seed=3):
    rng = np.random.default_rng(seed)
    w = rng.uniform(size=(n, s)).astype(np.float32)
    w /= w.sum(-1, keepdims=True) * rng.uniform(1.0, 2.0, (n, 1))
    u = np.sort(rng.uniform(size=(n, s + 1)), -1)
    edges = (1.0 / (1.0 / NEAR + u * (1.0 / FAR - 1.0 / NEAR))).astype(np.float32)
    return w.astype(np.float32), edges


@pytest.mark.parametrize("ipe", [False, True], ids=["points", "ipe"])
@pytest.mark.parametrize("space", ["linear", "disparity"])
def test_distortion_loss_matches_jax(space, ipe):
    """The loss and its gradient in the weights, with point deltas or
    exact IPE interval lengths, against the JAX function: rtol 1e-5 (f32
    prefix sums in another order)."""
    w, edges = _weights()
    if ipe:
        ts, deltas = 0.5 * (edges[:, 1:] + edges[:, :-1]), edges[:, 1:] - edges[:, :-1]
    else:
        ts, deltas = edges[:, :-1], None
    tw = torch.from_numpy(w).requires_grad_()
    loss = render_ops.distortion_loss(tw, torch.from_numpy(ts), NEAR, FAR, space,
                                      None if deltas is None else torch.from_numpy(deltas))
    loss.backward()
    jfn = lambda ww: jrender_ops.distortion_loss(  # noqa: E731
        ww, jnp.asarray(ts), NEAR, FAR, space, None if deltas is None else jnp.asarray(deltas))
    want, jgrad = jax.value_and_grad(jfn)(jnp.asarray(w))
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jgrad), rtol=1e-5, atol=1e-7)


def _jax_model(cfg, seed=5):
    """JAX-drawn weights (sigma bias raised: an opaque-enough field) and
    the port's field of that family holding the same values."""
    params = jmlp.init_nerf_params(jax.random.PRNGKey(seed), cfg)
    if "sigma" in params:
        params["sigma"]["b"] = params["sigma"]["b"] + 0.3
    if "table" in params:  # a trained-looking table: the init's 1e-4 hides position
        params["table"] = jnp.asarray(np.random.default_rng(seed).normal(
            size=params["table"].shape).astype(np.float32))
    model = init_nerf_params(cfg, 0)
    model.load_state_dict(params_from_numpy(jax.tree.map(np.asarray, params)))
    return params, model


_FAMILIES = {
    "nerf": MODEL,
    "ipe": MODEL_IPE,
    "factored": ModelConfig(arch="factored", fac_levels=2, fac_base_res=4, fac_max_res=8,
                            fac_comps=8, fac_aabb=2.0, hash_mlp_width=16, hash_geo_feats=7,
                            dir_enc_levels=2, sigma_activation="softplus", contract=True),
    "hashgrid": ModelConfig(arch="hashgrid", hash_levels=3, hash_table_log2=10, hash_base_res=4,
                            hash_max_res=16, hash_aabb=2.0, hash_mlp_width=16, hash_geo_feats=7,
                            dir_enc_levels=2, sigma_activation="softplus", contract=True),
}


@pytest.mark.parametrize("family", sorted(_FAMILIES))
def test_apply_nerf_contracts_every_family_like_jax(family):
    """apply_nerf with cfg.contract (the Gaussian branch for IPE) at f32
    against the JAX apply_nerf on converted weights: sigma and rgb at
    atol 1e-4 (f32 products summed in another order); and the
    contraction matters at these points."""
    cfg = _FAMILIES[family]
    params, model = _jax_model(cfg)
    x, var = _points(512, seed=4)
    rng = np.random.default_rng(6)
    vd = rng.normal(size=(512, 3)).astype(np.float32)
    vd /= np.linalg.norm(vd, axis=-1, keepdims=True)
    pos_var = var if cfg.ipe else None
    with torch.no_grad():
        sigma, rgb = apply_nerf(model, torch.from_numpy(x), torch.from_numpy(vd), cfg,
                                pos_var=None if pos_var is None else torch.from_numpy(pos_var))
        flat, _ = apply_nerf(model, torch.from_numpy(x), torch.from_numpy(vd),
                             dataclasses.replace(cfg, contract=False),
                             pos_var=None if pos_var is None else torch.from_numpy(pos_var))
    js, jr = jmlp.apply_nerf(params, jnp.asarray(x), jnp.asarray(vd), cfg,
                             pos_var=None if pos_var is None else jnp.asarray(pos_var))
    np.testing.assert_allclose(sigma.numpy(), np.asarray(js), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(rgb.numpy(), np.asarray(jr), atol=1e-4)
    assert float((sigma - flat).abs().max()) > 1e-3


def _rays(n, s, ipe, seed=7):
    """Rays from near the origin, samples over [NEAR, FAR] even in
    disparity (jittered): (o, d, vd, ts or midpoints, deltas, gold), radii."""
    rng = np.random.default_rng(seed)
    o = (rng.normal(size=(n, 3)) * 0.2).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    vd = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    gold = rng.uniform(size=(n, 3)).astype(np.float32)
    u = np.sort(rng.uniform(size=(n, s + int(ipe))), -1)
    t = (1.0 / (1.0 / NEAR + u * (1.0 / FAR - 1.0 / NEAR))).astype(np.float32)
    if ipe:
        return (o, d, vd, (0.5 * (t[:, 1:] + t[:, :-1])).astype(np.float32),
                (t[:, 1:] - t[:, :-1]).astype(np.float32), gold), \
            rng.uniform(0.005, 0.05, n).astype(np.float32)
    deltas = np.diff(np.concatenate([t, np.full((n, 1), FAR, np.float32)], -1), axis=-1)
    return (o, d, vd, t, deltas.astype(np.float32), gold), None


def _t(a):
    return None if a is None else torch.from_numpy(a)


@pytest.mark.parametrize("cfg", [MODEL, MODEL_IPE], ids=["pe", "ipe"])
def test_render_kernel_plain_version_contracts_like_jax(cfg):
    """K1's plain version with the contraction (PE points, IPE Gaussians)
    against the JAX kernel in interpret mode on converted weights: rgb,
    acc and weights atol 1e-5, depth 1e-5 x FAR, sigma 1e-4 (both round
    to bf16 at the same points and sum in f32); the contraction changes
    the result; and the CPU wrapper is the plain version."""
    params, model = _jax_model(cfg)
    rays, radii = _rays(N, S, cfg.ipe)
    o, d, vd, ts, deltas, _ = rays
    pk = fused_render.pack_weights(model, cfg)
    got = fused_ray_render_reference(pk, *map(_t, (o, d, vd, ts, deltas)), cfg, S,
                                     radii=_t(radii))
    want = jray.fused_ray_render(jrender.pack_weights(params, cfg),
                                 *map(jnp.asarray, (o, d, vd, ts, deltas)), cfg, S,
                                 rays_per_block=8, interpret=True,
                                 radii=None if radii is None else jnp.asarray(radii))
    for name, g, w, tol in zip(("rgb", "acc", "depth", "weights", "sigma"), got, want,
                               (1e-5, 1e-5, 1e-5 * FAR, 1e-5, 1e-4)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=tol, err_msg=name)
    flat = dataclasses.replace(cfg, contract=False)
    unc = fused_ray_render_reference(pk, *map(_t, (o, d, vd, ts, deltas)), flat, S,
                                     radii=_t(radii))
    assert float((got[0] - unc[0]).abs().max()) > 1e-3
    again = fused_ray_render(pk, *map(_t, (o, d, vd, ts, deltas)), cfg, S, radii=_t(radii))
    assert all(torch.equal(a, b) for a, b in zip(again, got))


# (model, distortion space or None): the contraction alone, the distortion
# loss alone in linear space, both in disparity space under PE and IPE
_TRAIN_CASES = [
    (MODEL, None),
    (dataclasses.replace(MODEL, contract=False), "linear"),
    (MODEL, "disparity"),
    (MODEL_IPE, "disparity"),
    (MODEL_IPE, "linear"),
]


@pytest.mark.parametrize("cfg,space", _TRAIN_CASES,
                         ids=["contract", "linear", "contract-disparity", "ipe-disparity",
                              "ipe-linear"])
def test_train_kernel_plain_version_matches_jax(cfg, space):
    """K2's plain version with the contraction and the distortion loss
    against the JAX kernel in interpret mode: diag (slot 5, the per-ray
    distortion loss, included) and weights atol 1e-5, every gradient leaf
    1e-4 of the leaf's max (both round to bf16 at the same points and sum
    in f32); with the loss on, diag slot 5 is the per-ray distortion loss
    of ops/render.distortion_loss on the kernel's weights (rtol 1e-4)."""
    params, model = _jax_model(cfg)
    rays, radii = _rays(N, S, cfg.ipe)
    dist = ({} if space is None
            else dict(dist_weight=0.05, near=NEAR, far=FAR, dist_space=space))
    pk = fused_render.pack_weights(model, cfg)
    got = fused_train_grads_reference(pk, fused_render.pack_weights_t(pk), *map(_t, rays), cfg,
                                      S, radii=_t(radii), **dist)
    jpk = jrender.pack_weights(params, cfg)
    tg = jtrain.fused_train_grads(jpk, jtrain.pack_weights_t(jpk, cfg), *map(jnp.asarray, rays),
                                  cfg, S, rays_per_block=8, interpret=True,
                                  radii=None if radii is None else jnp.asarray(radii), **dist)
    np.testing.assert_allclose(got.diag.numpy(), np.asarray(tg.diag), atol=1e-5)
    np.testing.assert_allclose(got.weights.numpy(), np.asarray(tg.weights), atol=1e-5)
    want = jax.tree.map(np.asarray, jtrain.unpack_grads(tg, params, cfg))
    mine = params_to_numpy(unpack_grads(got, model, cfg))
    for g, w in zip(jax.tree_util.tree_leaves(mine), jax.tree_util.tree_leaves(want)):
        scale = np.abs(w).max()
        assert scale > 1e-6
        np.testing.assert_allclose(g / scale, w / scale, atol=1e-4)
    if space is None:
        assert float(got.diag[:, 5].abs().max()) == 0.0
        return
    o, d, vd, ts, deltas, _ = rays
    per_ray = [float(render_ops.distortion_loss(
        got.weights[i:i + 1], torch.from_numpy(ts[i:i + 1]), NEAR, FAR, space,
        torch.from_numpy(deltas[i:i + 1]) if cfg.ipe else None)) for i in range(N)]
    np.testing.assert_allclose(got.diag[:, 5].numpy(), per_ray, rtol=1e-4, atol=1e-7)
    # the CPU wrapper is the plain version, distortion included
    again = fused_train_grads(pk, fused_render.pack_weights_t(pk), *map(_t, rays), cfg, S,
                              radii=_t(radii), **dist)
    assert torch.equal(again.diag, got.diag)


def test_train_kernel_plain_version_matches_autograd():
    """K2's plain version with the contraction and a heavy distortion loss
    (weight 0.5, disparity space) against autograd of the eager loss
    (apply_nerf at bf16 with the contraction -> composite -> mse + 0.5
    distortion_loss) on the same samples, at the JAX package's bars for
    its kernel against autodiff: rgb 2e-2, both losses 2e-3, every leaf
    4e-2 of the leaf's max (bf16 rounds at other points in autograd)."""
    cfg = dataclasses.replace(MODEL, sigma_activation="softplus")
    _, model = _jax_model(cfg)
    rays, _ = _rays(N, S, False)
    o, d, vd, ts, deltas, gold = map(_t, rays)
    pk = fused_render.pack_weights(model, cfg)
    got = fused_train_grads_reference(pk, fused_render.pack_weights_t(pk), o, d, vd, ts, deltas,
                                      gold, cfg, S, dist_weight=0.5, near=NEAR, far=FAR,
                                      dist_space="disparity")
    sigma, rgb = apply_nerf(model, sampling.points_from_ts(o, d, ts), vd[:, None, :], cfg,
                            torch.bfloat16)
    out = render_ops.composite(sigma, rgb, deltas, ts=ts)
    mse = render_ops.mse(out.rgb, gold)
    dist = render_ops.distortion_loss(out.weights, ts, NEAR, FAR, "disparity")
    (mse + 0.5 * dist).backward()
    np.testing.assert_allclose(got.diag[:, :3].numpy(), out.rgb.detach().numpy(), atol=2e-2)
    assert abs(float(got.diag[:, 4].mean()) - float(mse.detach())) < 2e-3
    assert abs(float(got.diag[:, 5].mean()) - float(dist.detach())) < 2e-3
    assert float(dist.detach()) > 1e-3  # a live distortion term
    params = dict(model.named_parameters())
    for name, g in unpack_grads(got, model, cfg).items():
        scale = float(params[name].grad.abs().max())
        assert scale > 1e-6, name
        assert float((g - params[name].grad).abs().max()) / scale < 4e-2, name


def _preset_cfg(preset, *extra, mod=cli):
    argv = ["train", "--preset", preset, "--dataset", "sphere", *extra]
    args = mod.build_parser().parse_args(argv)
    args._explicit = mod.explicit_dests(argv)
    return mod.config_from_args(args)


@pytest.mark.parametrize("preset", ["unbounded", "proposal"])
def test_cli_presets_resolve_like_the_jax_cli(preset):
    """The preset's model, render, camera, proposal and distortion settings
    are the JAX CLI's; an explicit --far beats the preset."""
    mine, want = _preset_cfg(preset).to_dict(), _preset_cfg(preset, mod=jcli).to_dict()
    for key in ("model", "render", "camera", "proposal", "use_whole_ray_train",
                "use_fused_kernel"):
        assert mine[key] == want[key], key
    for k in ("distortion_weight", "num_rays", "learning_rate", "precision"):
        assert mine["train"][k] == want["train"][k], k
    far = _preset_cfg(preset, "--far", "30", "--proposal_levels", "3")
    assert far.camera.far == 30.0 and far.proposal.num_levels == 3
    assert far.proposal.enabled and far.use_whole_ray_train


def test_unbounded_preset_values():
    cfg = _preset_cfg("unbounded")
    assert cfg.model.contract and cfg.render.sampling_space == "disparity"
    assert (cfg.camera.near, cfg.camera.far) == (0.3, 60.0)
    assert (cfg.proposal.num_levels, cfg.proposal.num_samples, cfg.proposal.anneal_steps) == (
        2, 64, 1000)
    assert cfg.train.distortion_weight == 0.01 and cfg.model.sigma_activation == "softplus"


def test_cli_drives_the_unbounded_preset_on_the_cpu(tmp_path, capsys):
    """train, eval and render of --preset unbounded at full width on a tiny
    frame, on the CPU (the kernels' plain versions); without --device cpu
    and without a card the CLI raises instead of falling back."""
    common = ["--preset", "unbounded", "--dataset", "sphere", "--width", "8", "--height", "8",
              "--num_samples", "8", "--proposal_samples", "8", "--save_dir", str(tmp_path)]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(["train", *common, "--num_iter", "2"])
    assert cli.main(["train", *common, "--num_rays", "32", "--num_iter", "3", "--eval_steps",
                     "2", "--log_dir", str(tmp_path), "--device", "cpu"]) == 0
    assert "eval psnr=" in capsys.readouterr().out
    assert cli.main(["eval", *common, "--max_views", "1", "--device", "cpu"]) == 0
    assert "mean psnr over 1" in capsys.readouterr().out
    assert cli.main(["render", *common, "--view", "0", "--out_dir", str(tmp_path / "r"),
                     "--device", "cpu"]) == 0
    assert (tmp_path / "r" / "view-0.png").exists()
    # the checkpoint holds the proposal net: eval needs the preset it was trained with
    with pytest.raises(ValueError, match="preset"):
        cli.main(["eval", "--dataset", "sphere", "--width", "8", "--height", "8",
                  "--num_samples", "8", "--save_dir", str(tmp_path), "--device", "cpu"])


def _small_preset(preset, kernel=True):
    """The preset's settings from the CLI at small width, midpoint
    samples, f32 eager precision (the proposal net's and the autograd
    path's bf16 rounding would otherwise separate the two packages), the
    sphere scene."""
    cfg = _preset_cfg(preset, "--num_rays", str(N))
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, **{k: getattr(MODEL, k) for k in (
            "net_depth", "net_width", "skip_layer", "feature_width", "view_head_width",
            "pos_enc_levels", "dir_enc_levels")}),
        render=dataclasses.replace(cfg.render, num_samples=S, randomized=False),
        proposal=dataclasses.replace(cfg.proposal, num_samples=S, net_width=16,
                                     pos_enc_levels=4),
        train=dataclasses.replace(cfg.train, precision="f32", whole_ray_block=N,
                                  learning_rate=1e-3),
        use_whole_ray_train=kernel)


def preset_states(cfg, seed=11):
    """The JAX state and the port's state holding the same weights (the
    main field, and the proposal net in the second slot)."""
    jcfg = jconfig.Config.from_dict(cfg.to_dict())
    jstate = jstep.init_state(jax.random.PRNGKey(seed), jcfg)
    bump = {**jstate.params, "sigma": {**jstate.params["sigma"],
                                       "b": jstate.params["sigma"]["b"] + 0.3}}
    jstate = jstate._replace(params=bump)
    jstate = jstate._replace(opt_state=jstep.make_optimizer(jcfg).init(
        jstep._trainable(jstate, jcfg)))
    state = step.init_state(cfg)
    state.params.load_state_dict(params_from_numpy(jax.tree.map(np.asarray, jstate.params)))
    state.fine_params.load_state_dict(
        params_from_numpy(jax.tree.map(np.asarray, jstate.fine_params)))
    return jcfg, jstate, state


def preset_batch(seed=12):
    """Rays of the sphere scene's camera distance, pointing at it."""
    rng = np.random.default_rng(seed)
    o = (rng.normal(size=(N, 3)) * 0.2 + [0.0, 0.0, -1.0]).astype(np.float32)
    d = (rng.normal(size=(N, 3)) * 0.2 + [0.0, 0.0, 1.0]).astype(np.float32)
    return o, d, rng.uniform(size=(N, 3)).astype(np.float32)


def assert_step_matches_jax(preset, kernel):
    """One train step of the preset against the JAX step on converted
    weights (both nets), midpoint samples, the same batch: the losses at
    rtol 2e-3 (the interlevel loss compares histograms that rounded
    through both packages), and the new weights of both nets within a
    fraction of lr (the first Adam update is ~lr sign(g))."""
    cfg = _small_preset(preset, kernel)
    jcfg, jstate, state = preset_states(cfg)
    o, d, gold = preset_batch()
    new_j, aux_j = jstep.train_step(jstate, jstep.Batch(*map(jnp.asarray, (o, d, gold))),
                                    jax.random.PRNGKey(0), jcfg)
    state, aux = step.train_step(state, step.Batch(*map(torch.from_numpy, (o, d, gold))),
                                 None, cfg)
    assert state.step == 1
    keys = ["loss", "loss_coarse", "loss_prop"] + (
        ["loss_dist"] if cfg.train.distortion_weight > 0 else [])
    for key in keys:
        np.testing.assert_allclose(float(aux[key]), float(aux_j[key]), rtol=2e-3, atol=1e-7,
                                   err_msg=key)
    assert float(aux["loss_prop"]) > 0
    lr = cfg.train.learning_rate
    for mine, want in ((state.params, new_j.params), (state.fine_params, new_j.fine_params)):
        for g, w in zip(jax.tree_util.tree_leaves(params_to_numpy(mine)),
                        jax.tree_util.tree_leaves(jax.tree.map(np.asarray, want))):
            np.testing.assert_allclose(g, w, atol=0.1 * lr)


@pytest.mark.parametrize("kernel", [True, False], ids=["kernel", "autograd"])
def test_unbounded_train_step_matches_jax(kernel):
    assert_step_matches_jax("unbounded", kernel)
