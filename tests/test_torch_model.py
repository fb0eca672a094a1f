"""Parity of the PyTorch port's field with the JAX package on the CPU:
positional encoding, the paper MLP at f32 and "mixed" (bf16) precision,
the seeded init, and the exact param conversion between the two.

Inputs are made with numpy from a seed and handed to both packages; JAX
params reach the port through ``convert.params_from_numpy``, and the
JAX side gets the port's config as its own (``_jcfg``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_rs_tpu import config as jconfig
from nerf_rs_tpu.models import encoding as jenc
from nerf_rs_tpu.models import mlp as jmlp
from nerf_rs_tpu_torch.config import ModelConfig
from nerf_rs_tpu_torch.convert import params_from_numpy, params_to_numpy
from nerf_rs_tpu_torch.models import encoding, mlp

torch.set_num_threads(2)

# small field: depth 4, width 64, skip 2, F 64, V 32 (PE 10 / 4)
CFG = ModelConfig(net_depth=4, net_width=64, skip_layer=2, feature_width=64,
                  view_head_width=32)


def _jcfg(cfg: ModelConfig) -> "jconfig.ModelConfig":
    return jconfig.ModelConfig(**dataclasses.asdict(cfg))


def _jax_tree(cfg, seed=0):
    return jax.tree.map(np.asarray, jmlp.init_nerf_params(jax.random.PRNGKey(seed), _jcfg(cfg)))


def _port_model(tree, cfg):
    model = mlp.NerfMLP(cfg)
    model.load_state_dict(params_from_numpy(tree))
    return model


def _inputs(n=48, s=8, seed=1):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1.5, 1.5, (n, s, 3)).astype(np.float32)
    d = rng.normal(size=(n, 1, 3))
    vd = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return pts, vd


@pytest.mark.parametrize("levels", [0, 4, 10])
def test_posenc_matches_jax(levels):
    # f32 on both sides; atol 1e-4 because sin(2^9 x) turns one ulp of
    # x into ~512 ulps of phase
    x = np.random.default_rng(0).uniform(-2, 2, (257, 3)).astype(np.float32)
    got = encoding.posenc(torch.from_numpy(x), levels).numpy()
    want = np.asarray(jenc.posenc(jnp.asarray(x), levels))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4)
    assert encoding.posenc_dim(3, levels) == jenc.posenc_dim(3, levels)


@pytest.mark.parametrize("sigma_act", ["relu", "softplus"])
def test_apply_nerf_f32_matches_jax(sigma_act):
    # f32 products and sums on both sides; only summation order differs
    # -> atol 1e-4
    cfg = ModelConfig(**{**CFG.__dict__, "sigma_activation": sigma_act})
    tree = _jax_tree(cfg)
    pts, vd = _inputs()
    s_j, c_j = jmlp.apply_nerf(jax.tree.map(jnp.asarray, tree), jnp.asarray(pts),
                               jnp.asarray(vd), _jcfg(cfg))
    s_p, c_p = mlp.apply_nerf(_port_model(tree, cfg), torch.from_numpy(pts),
                              torch.from_numpy(vd), cfg)
    np.testing.assert_allclose(s_p.detach().numpy(), np.asarray(s_j), atol=1e-4)
    np.testing.assert_allclose(c_p.detach().numpy(), np.asarray(c_j), atol=1e-4)


def test_apply_nerf_mixed_matches_jax():
    # "mixed": every layer (product output and bias add) is rounded to
    # bf16 on both sides, but the two frameworks sum the products in
    # different orders, so one bf16 ulp (0.4%) can flip in any hidden
    # activation and propagate -> bf16-level bars: sigma (unsquashed,
    # |sigma| < 2 here, where one bf16 ulp is 7.8e-3) 2e-2, sigmoid rgb
    # 5e-3
    tree = _jax_tree(CFG)
    pts, vd = _inputs()
    s_j, c_j = jmlp.apply_nerf(jax.tree.map(jnp.asarray, tree), jnp.asarray(pts),
                               jnp.asarray(vd), _jcfg(CFG), dtype=jnp.bfloat16)
    s_p, c_p = mlp.apply_nerf(_port_model(tree, CFG), torch.from_numpy(pts),
                              torch.from_numpy(vd), CFG, dtype=torch.bfloat16)
    assert s_p.dtype == torch.float32 and c_p.dtype == torch.float32
    np.testing.assert_allclose(s_p.detach().numpy(), np.asarray(s_j), atol=2e-2)
    np.testing.assert_allclose(c_p.detach().numpy(), np.asarray(c_j), atol=5e-3)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_apply_nerf_ipe_matches_jax(dtype):
    """The pos_var branch: Gaussian means encoded with the integrated
    encoding, the weights unchanged. Bars as the PE path's: f32 1e-4,
    bf16 ("mixed") sigma 2e-2 and rgb 5e-3."""
    cfg = ModelConfig(**{**CFG.__dict__, "ipe": True, "sigma_activation": "softplus"})
    tree = _jax_tree(cfg)
    pts, vd = _inputs()
    var = (np.random.default_rng(2).uniform(0, 1, pts.shape) ** 3 * 0.02).astype(np.float32)
    jd, td = (jnp.bfloat16, torch.bfloat16) if dtype == "bf16" else (None, None)
    s_j, c_j = jmlp.apply_nerf(jax.tree.map(jnp.asarray, tree), jnp.asarray(pts),
                               jnp.asarray(vd), _jcfg(cfg), jd, pos_var=jnp.asarray(var))
    s_p, c_p = mlp.apply_nerf(_port_model(tree, cfg), torch.from_numpy(pts),
                              torch.from_numpy(vd), cfg, td, pos_var=torch.from_numpy(var))
    tol_s, tol_c = (2e-2, 5e-3) if dtype == "bf16" else (1e-4, 1e-4)
    np.testing.assert_allclose(s_p.detach().numpy(), np.asarray(s_j), atol=tol_s)
    np.testing.assert_allclose(c_p.detach().numpy(), np.asarray(c_j), atol=tol_c)
    # the variance damps the field's input: not the PE's answer
    s_pe, _ = mlp.apply_nerf(_port_model(tree, cfg), torch.from_numpy(pts),
                             torch.from_numpy(vd), cfg, td)
    assert float((s_pe - s_p).detach().abs().max()) > 1e-3


def test_convert_round_trip_is_exact():
    tree = _jax_tree(CFG)
    state = params_from_numpy(tree)
    # JAX names and the (in, out) layout, nothing transposed
    assert list(state) == (
        [f"trunk.{i}.{leaf}" for i in range(4) for leaf in ("w", "b")]
        + [f"{n}.{leaf}" for n in ("sigma", "feature", "view1", "rgb")
           for leaf in ("w", "b")])
    assert tuple(state["trunk.2.w"].shape) == tree["trunk"][2]["w"].shape == (64 + 63, 64)
    back = params_to_numpy(_port_model(tree, CFG))
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def test_init_is_seeded_he_truncated_normal():
    m1 = mlp.init_nerf_params(CFG, 0)
    m2 = mlp.init_nerf_params(CFG, 0)
    m3 = mlp.init_nerf_params(CFG, 1)
    assert set(m1.state_dict()) == set(params_from_numpy(_jax_tree(CFG)))
    for (k, a), b, c in zip(m1.state_dict().items(), m2.state_dict().values(),
                            m3.state_dict().values()):
        assert torch.equal(a, b), k
        if k.endswith(".b"):
            assert not a.any(), k
            continue
        assert not torch.equal(a, c), k
        std = (2.0 / a.shape[0]) ** 0.5
        assert a.abs().max() <= 2.0 * std + 1e-6, k
    w = m1.trunk[1].w.detach()
    assert 0.8 < float(w.std()) / (2.0 / 64) ** 0.5 < 1.0  # cut at 2 std: 0.88
    # the draw is numpy's, so a seed gives these weights under any torch
    # version: the first layer is the first draws of default_rng(seed)
    first = np.random.default_rng(0).standard_normal(m1.trunk[0].w.numel())
    first = first[np.abs(first) <= 2.0][:8] * (2.0 / m1.trunk[0].w.shape[0]) ** 0.5
    np.testing.assert_allclose(m1.trunk[0].w.detach().reshape(-1)[:8].numpy(), first, rtol=1e-6)


# the factored and hashgrid archs are ported (tests/test_torch_factored.py,
# tests/test_torch_hashgrid.py); compat wins over any arch, as in the JAX
# package
@pytest.mark.parametrize("kw", [{"compat": True}, {"compat": True, "arch": "hashgrid"},
                                {"compat": True, "arch": "factored"},
                                {"ipe": True, "contract": True}, {"contract": True}])
def test_unported_models_raise(kw):
    with pytest.raises(NotImplementedError, match="slice"):
        mlp.NerfMLP(ModelConfig(**kw))
