"""The PyTorch port's hierarchical and mip-NeRF sampling on the CPU
(ops/sampling.py, models/encoding.py, kernels/fused_render.py) against
the JAX package on the same numpy inputs: inverse-CDF resampling, the
sorted merge of two sample sets, conical-frustum Gaussians, the pixel
cone radius, and the integrated encoding in both its forms.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_rs_tpu.kernels import fused_render as jrender
from nerf_rs_tpu.models import encoding as jenc
from nerf_rs_tpu.ops import sampling as jsamp
from nerf_rs_tpu_torch.config import CameraConfig
from nerf_rs_tpu_torch.kernels import fused_render
from nerf_rs_tpu_torch.models.encoding import integrated_posenc
from nerf_rs_tpu_torch.ops import sampling

torch.set_num_threads(2)


def _hist(seed, n=12, bins=16, zero_rows=(3,)):
    """Sorted bin edges and non-negative weights; some rays all zero (the
    eps keeps their PDF flat), some with a single spike."""
    rng = np.random.default_rng(seed)
    edges = np.sort(rng.uniform(0.05, 2.0, (n, bins + 1)), axis=-1).astype(np.float32)
    w = rng.exponential(size=(n, bins)).astype(np.float32) * (rng.uniform(size=(n, bins)) > 0.4)
    for r in zero_rows:
        w[r] = 0.0
    w[5] = 0.0
    w[5, 7] = 3.0
    return edges, w.astype(np.float32)


@pytest.mark.parametrize("num", [1, 16, 129])
def test_sample_pdf_deterministic_matches_jax(num):
    edges, w = _hist(0)
    want = jsamp.sample_pdf(jax.random.PRNGKey(0), jnp.asarray(edges), jnp.asarray(w), num,
                            randomized=False)
    got = sampling.sample_pdf(torch.from_numpy(edges), torch.from_numpy(w), num,
                              randomized=False)
    assert got.shape == (12, num)
    # the same f32 arithmetic, but XLA's cumsum rounds in another order:
    # a CDF one ulp off moves a sample by ulp / pdf of its bin (seen 6e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    assert bool((got[:, 1:] >= got[:, :-1]).all())  # sorted by construction


def test_sample_pdf_inversion_at_jax_draws():
    """Randomized draws: the uniforms JAX draws (its key's stream), fed
    to the port's inversion step, give JAX's samples."""
    edges, w = _hist(1)
    num = 33
    key = jax.random.PRNGKey(7)
    want = jsamp.sample_pdf(key, jnp.asarray(edges), jnp.asarray(w), num, randomized=True)
    u = (np.arange(num, dtype=np.float32)
         + np.asarray(jax.random.uniform(key, (12, num)))) / num
    got = sampling.invert_cdf(torch.from_numpy(edges), torch.from_numpy(w),
                              torch.from_numpy(u.astype(np.float32)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    # the port's own randomized draw: stratified in CDF space, so sorted
    g = torch.Generator().manual_seed(3)
    mine = sampling.sample_pdf(torch.from_numpy(edges), torch.from_numpy(w), num, True, g)
    assert bool((mine[:, 1:] >= mine[:, :-1]).all())
    assert bool((mine >= torch.from_numpy(edges[:, :1])).all())
    assert bool((mine <= torch.from_numpy(edges[:, -1:])).all())


def test_merge_ts_matches_jax_exactly_with_ties():
    rng = np.random.default_rng(2)
    a = np.sort(rng.integers(0, 20, (9, 13)), axis=-1).astype(np.float32) * 0.1
    b = np.sort(rng.integers(0, 20, (9, 27)), axis=-1).astype(np.float32) * 0.1
    b[:, 0] = a[:, 0]  # a tie in every ray
    b = np.sort(b, axis=-1)  # both inputs sorted, as merge_ts requires
    got = sampling.merge_ts(torch.from_numpy(a), torch.from_numpy(b))
    want = np.asarray(jsamp.merge_ts(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), np.sort(np.concatenate([a, b], -1), -1))


def test_merge_ts_puts_the_coarse_sample_first_on_a_tie():
    """+0.0 and -0.0 compare equal but keep their sign bits, so they show
    which array a tied element came from: the coarse one comes first.
    (The JAX merge sums a one-hot row, which turns -0.0 into +0.0, so it
    is held to the values only.)"""
    a = np.array([[0.0, 1.0, 3.0]], np.float32)
    b = np.array([[-0.0, 1.0, 2.0]], np.float32)
    got = sampling.merge_ts(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    want = np.asarray(jsamp.merge_ts(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_array_equal(got, [[0.0, 0.0, 1.0, 1.0, 2.0, 3.0]])
    np.testing.assert_array_equal(np.signbit(got), [[False, True, False, False, False, False]])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("radius", ["scalar", "per_ray"])
def test_conical_gaussians_match_jax(radius):
    rng = np.random.default_rng(3)
    n, s = 7, 11
    o = (rng.normal(size=(n, 3)) * 0.3).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    edges = np.sort(rng.uniform(0.05, 2.0, (n, s + 1)), -1).astype(np.float32)
    r = (0.004 if radius == "scalar"
         else rng.uniform(0.001, 0.02, (n, 1)).astype(np.float32))
    got = sampling.conical_gaussians(torch.from_numpy(o), torch.from_numpy(d),
                                     torch.from_numpy(edges),
                                     r if radius == "scalar" else torch.from_numpy(r))
    want = jsamp.conical_gaussians(jnp.asarray(o), jnp.asarray(d), jnp.asarray(edges),
                                   r if radius == "scalar" else jnp.asarray(r))
    for name, g, w in zip(("mean", "var", "mids", "deltas"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-9, err_msg=name)


def test_pixel_radius_matches_jax():
    for cam in (CameraConfig(), CameraConfig(width=800, height=800),
                CameraConfig(width=64, height=64, focal=55.5)):
        assert sampling.pixel_radius(cam) == jsamp.pixel_radius(cam)


@pytest.mark.parametrize("levels", [0, 4, 10])
def test_integrated_posenc_matches_jax(levels):
    rng = np.random.default_rng(4)
    mean = rng.uniform(-2, 2, (50, 3)).astype(np.float32)
    var = (rng.uniform(0, 1, (50, 3)) ** 4 * 0.05).astype(np.float32)
    got = integrated_posenc(torch.from_numpy(mean), torch.from_numpy(var), levels).numpy()
    want = np.asarray(jenc.integrated_posenc(jnp.asarray(mean), jnp.asarray(var), levels))
    # f32 level: sin/cos of the same exact-scaled arguments (2^9 phase
    # amplification as in the PE), exp of an exactly scaled variance
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=2e-6)


def test_kernel_ipe_helpers_match_jax():
    """ipe_expand / ipe_encode, the kernels' plain IPE, against the JAX
    kernels' in-register _ipe_expand / _ipe_encode."""
    rng = np.random.default_rng(5)
    n, s = 6, 9
    o = (rng.normal(size=(n, 3)) * 0.3).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    edges = np.sort(rng.uniform(0.05, 2.0, (n, s + 1)), -1).astype(np.float32)
    mids = (0.5 * (edges[:, 1:] + edges[:, :-1])).astype(np.float32)
    deltas = (edges[:, 1:] - edges[:, :-1]).astype(np.float32)
    radii = rng.uniform(0.001, 0.02, n).astype(np.float32)
    mean, var = fused_render.ipe_expand(*map(torch.from_numpy, (o, d, mids, deltas, radii)))
    jmean, jvar = jrender._ipe_expand(*map(jnp.asarray, (o, d, mids, deltas)),
                                      jnp.asarray(radii[:, None]), n * s)
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(var.numpy(), np.asarray(jvar), rtol=1e-6, atol=1e-12)
    got = fused_render.ipe_encode(mean, var, 10, 64).numpy()
    want = np.asarray(jrender._ipe_encode(jmean, jvar, 64))
    np.testing.assert_allclose(got[:, :63], want[:, :63], atol=1e-4)  # PE's 2^9 bar
    assert not got[:, 63:].any()
    # var -> 0 is the PE
    flat = fused_render.ipe_encode(mean, torch.zeros_like(var), 10, 64)
    assert torch.equal(flat, fused_render.pe_encode(mean, 10, 64))
