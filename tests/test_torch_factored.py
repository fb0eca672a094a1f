"""The PyTorch port's factored field family on the CPU (ROADMAP slice 9,
the factored half): the resolution ladder and hat weights, both encode
routes (the dense hat matrix of ``models/factored.factored_encode``, and
the plain versions of the factored-encode kernel K3 with the line
gradients of its ``autograd.Function``) against the JAX package's (its
Pallas kernel in interpret mode, as tests/test_factored.py runs it), the
two-tap form the CUDA kernel computes against the dense plain version,
the field through ``apply_nerf``, one whole train step, conversion,
checkpoints, the seeded init and the CLI's preset.

Small widths as tests/test_factored.py's (3 levels 4..16, C 8, AABB 1),
and the main path's widths (sumR 1,014, C 48) on 256 points; inputs from
numpy seeds, JAX-initialised weights converted to the port.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_rs_tpu import config as jconfig
from nerf_rs_tpu.kernels import fused_factored as jk3
from nerf_rs_tpu.models import factored as jfac
from nerf_rs_tpu.models import mlp as jmlp
from nerf_rs_tpu.train import step as jstep
from nerf_rs_tpu_torch import cli
from nerf_rs_tpu_torch.config import (CameraConfig, Config, DataConfig, ModelConfig,
                                      RenderConfig, TrainConfig)
from nerf_rs_tpu_torch.convert import params_from_numpy, params_to_numpy
from nerf_rs_tpu_torch.kernels import fused_factored as k3
from nerf_rs_tpu_torch.models import factored as fac
from nerf_rs_tpu_torch.models import mlp
from nerf_rs_tpu_torch.train import checkpoint as ckpt
from nerf_rs_tpu_torch.train import step

torch.set_num_threads(2)

SMALL = ModelConfig(arch="factored", fac_levels=3, fac_base_res=4, fac_max_res=16,
                    fac_comps=8, fac_aabb=1.0, sigma_activation="softplus")
MAIN = ModelConfig(arch="factored", sigma_activation="softplus")  # sumR 1,014, C 48
WIDTHS = {"small": SMALL, "main": MAIN}
DTYPES = {"f32": (None, None), "bf16": (torch.bfloat16, jnp.bfloat16)}


def _jcfg(cfg: ModelConfig) -> "jconfig.ModelConfig":
    return jconfig.ModelConfig(**dataclasses.asdict(cfg))


def _lines(cfg, seed=0):
    rng = np.random.default_rng(seed)
    return (0.5 * rng.normal(size=(3, fac.basis_dim(cfg), cfg.fac_comps))).astype(np.float32)


def _points(cfg, n, seed=1):
    """Points inside and outside the AABB (clipped), with the corners and
    faces (u = 0 and u = 1 exactly) among them."""
    a = cfg.fac_aabb
    rng = np.random.default_rng(seed)
    p = rng.uniform(-1.3 * a, 1.3 * a, (n, 3)).astype(np.float32)
    p[:4] = np.float32([[a, -a, a], [-a, a, 0.0], [2 * a, -2 * a, 0.5 * a], [0.0, 0.0, 0.0]])
    return p


@pytest.mark.parametrize("kw", [{}, dict(fac_levels=3, fac_base_res=4, fac_max_res=16),
                                dict(fac_levels=1, fac_base_res=7), dict(fac_levels=5,
                                                                          fac_max_res=100)])
def test_ladder_and_knots_match_jax(kw):
    cfg = ModelConfig(arch="factored", **kw)
    assert fac.fac_resolutions(cfg) == jfac.fac_resolutions(_jcfg(cfg))
    assert fac.basis_dim(cfg) == jfac.basis_dim(_jcfg(cfg))
    for mine, theirs in zip(fac.knot_constants(cfg), jfac.knot_constants(_jcfg(cfg))):
        np.testing.assert_array_equal(mine, theirs)
    if not kw:
        assert fac.fac_resolutions(cfg) == [16, 32, 64, 128, 256, 512]
        assert fac.basis_dim(cfg) == 1014


@pytest.mark.parametrize("width", ["small", "main"])
def test_hat_weights_match_jax_exactly(width):
    """f32 on both sides, the same operations: the same bits, at u = 0 and
    u = 1 too; each level's block is 2-hot and sums to 1."""
    cfg = WIDTHS[width]
    u = np.concatenate([[0.0, 1.0, 0.5], np.random.default_rng(2).uniform(size=61)])
    u = u.astype(np.float32)
    got = fac.hat_weights(torch.from_numpy(u), cfg).numpy()
    want = np.asarray(jfac.hat_weights(jnp.asarray(u), _jcfg(cfg)))
    np.testing.assert_array_equal(got, want)
    off = 0
    for r in fac.fac_resolutions(cfg):
        block = got[:, off:off + r + 1]
        np.testing.assert_allclose(block.sum(-1), 1.0, atol=1e-5)
        assert int((block > 0).sum(-1).max()) <= 2
        off += r + 1


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("width", ["small", "main"])
def test_factored_encode_matches_jax(width, dtype):
    """The dense-hat route. f32: tests/test_factored.py's bars (rtol 1e-5,
    atol 1e-6). bf16: both return bf16 features and a bf16 CP product;
    the f32 sums of the two matmuls run in another order, which can move
    a feature across a bf16 rounding boundary, so one bf16 ulp (2^-8
    relative) per rounding point, three points: rtol 2^-6."""
    cfg = WIDTHS[width]
    dt, jdt = DTYPES[dtype]
    lines, pts = _lines(cfg), _points(cfg, 256)
    got = fac.factored_encode(torch.from_numpy(lines), torch.from_numpy(pts).reshape(16, 16, 3),
                              cfg, dt)
    want = np.asarray(jfac.factored_encode(jnp.asarray(lines), jnp.asarray(pts), _jcfg(cfg), jdt))
    assert got.shape == (16, 16, cfg.fac_comps)
    assert got.dtype == (torch.bfloat16 if dt else torch.float32)
    got = got.float().reshape(256, -1).numpy()
    want = want.astype(np.float32)
    if dt is None:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    else:
        np.testing.assert_allclose(got, want, rtol=2.0 ** -6, atol=1e-6)
    assert np.abs(want).max() > 0.1  # a live encoding


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("width", ["small", "main"])
def test_kernel_plain_version_matches_jax_kernel(width, dtype):
    """K3's plain versions through the wrapper and its autograd.Function
    (the CPU takes them, and launches nothing) against the JAX kernel in
    interpret mode: values rtol 1e-5 / atol 1e-6 and line gradients rtol
    1e-4 / atol 1e-5, the bars of tests/test_factored.py:105,120. Both
    multiply the same rounded operands exactly in f32; only the order of
    the f32 sums differs. No gradient reaches the points.

    The JAX kernel in interpret mode divides by 2 aabb as a product with
    its reciprocal (XLA folds the constant), where the XLA route and the
    port divide: at aabb 1.6 that moves u by an ulp, which the 512-knot
    level turns into 4e-4 of the encoding. With aabb 2 both are exact, so
    the main widths run at aabb 2 here (the XLA-route test above holds
    aabb 1.6)."""
    cfg = WIDTHS[width]
    if width == "main":
        cfg = dataclasses.replace(cfg, fac_aabb=2.0)
    dt, jdt = DTYPES[dtype]
    lines, pts = _lines(cfg), _points(cfg, 256)
    g = np.random.default_rng(3).normal(size=(256, cfg.fac_comps)).astype(np.float32)
    jl, jp = jnp.asarray(lines), jnp.asarray(pts)
    enc_fn = lambda l: jk3.fused_factored_encode(l, jp, _jcfg(cfg), jdt, block=128,  # noqa: E731
                                                 interpret=True)
    want = np.asarray(enc_fn(jl))
    want_grad = np.asarray(jax.grad(lambda l: jnp.sum(enc_fn(l) * g))(jl))

    launches = (k3.fused_factored_encode.launches, k3.fused_factored_encode_backward.launches)
    lt = torch.from_numpy(lines).requires_grad_()
    pt = torch.from_numpy(pts).requires_grad_()
    got = k3.fused_factored_encode(lt, pt, cfg, dt)
    assert got.dtype == torch.float32 and got.shape == (256, cfg.fac_comps)
    (got * torch.from_numpy(g)).sum().backward()
    assert (k3.fused_factored_encode.launches,
            k3.fused_factored_encode_backward.launches) == launches
    assert pt.grad is None
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(lt.grad.numpy(), want_grad, rtol=1e-4, atol=1e-5)
    assert np.abs(want_grad).max() > 0.1


def _two_tap(lines, pts, g, cfg, bf16):
    """A numpy float64 emulation of what the CUDA kernel computes per point
    and axis: k0 = min(floor(u R), R - 1), its two weights (f32, then bf16
    under bf16), two row reads per level; the backward adds w * d_feat to
    those two rows."""
    rd = (lambda x: torch.from_numpy(np.asarray(x, np.float32)).bfloat16().float().numpy()
          ) if bf16 else (lambda x: np.asarray(x, np.float32))
    u = np.clip((pts + np.float32(cfg.fac_aabb)) / np.float32(2 * cfg.fac_aabb), 0, 1)
    u = u.astype(np.float32)
    L = rd(lines).astype(np.float64)
    n = pts.shape[0]
    taps = []  # per axis: (rows (n, levels), w0, w1)
    for a in range(3):
        rows, w0s, w1s, off = [], [], [], 0
        for r in fac.fac_resolutions(cfg):
            pos = (u[:, a] * np.float32(r)).astype(np.float32)
            k0 = np.minimum(np.floor(pos).astype(np.int64), r - 1)
            w0 = np.maximum(np.float32(1) - np.abs(pos - k0.astype(np.float32)), 0)
            w1 = np.maximum(np.float32(1) - np.abs(pos - (k0 + 1).astype(np.float32)), 0)
            rows.append(off + k0)
            w0s.append(rd(w0))
            w1s.append(rd(w1))
            off += r + 1
        taps.append((np.stack(rows, 1), np.stack(w0s, 1).astype(np.float64),
                     np.stack(w1s, 1).astype(np.float64)))
    feats = []
    for a, (rows, w0, w1) in enumerate(taps):
        feats.append((w0[:, :, None] * L[a][rows] + w1[:, :, None] * L[a][rows + 1]).sum(1))
    enc = feats[0] * feats[1] * feats[2]
    d_lines = np.zeros(lines.shape)
    for a, (b, c) in enumerate(((1, 2), (0, 2), (0, 1))):
        d_feat = rd(g * feats[b] * feats[c]).astype(np.float64)
        rows, w0, w1 = taps[a]
        for lv in range(rows.shape[1]):
            np.add.at(d_lines[a], rows[:, lv], w0[:, lv, None] * d_feat)
            np.add.at(d_lines[a], rows[:, lv] + 1, w1[:, lv, None] * d_feat)
    assert n == enc.shape[0]
    return enc, d_lines


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("width", ["small", "main"])
def test_two_tap_form_matches_the_plain_versions(width, dtype):
    """The sparse form the CUDA kernel computes (two taps per level, k0
    clamped for points on the upper face) gives the dense plain versions'
    encoding and line gradient: values within 1e-5 of their scale,
    gradients within 1e-5 of each axis's largest entry (f32 sums against
    float64)."""
    cfg = WIDTHS[width]
    dt, _ = DTYPES[dtype]
    lines, pts = _lines(cfg), _points(cfg, 256)
    g = np.random.default_rng(4).normal(size=(256, cfg.fac_comps)).astype(np.float32)
    enc, d_lines = _two_tap(lines, pts, g, cfg, dt is not None)
    lt, pt = torch.from_numpy(lines), torch.from_numpy(pts)
    got = k3.fused_factored_encode_reference(lt, pt, cfg, dt).numpy()
    got_d = k3.fused_factored_encode_backward_reference(lt, pt, torch.from_numpy(g), cfg,
                                                       dt).numpy()
    np.testing.assert_allclose(got, enc, atol=1e-5 * np.abs(enc).max(), rtol=0)
    for a in range(3):
        scale = np.abs(d_lines[a]).max()
        assert scale > 0.1
        np.testing.assert_allclose(got_d[a], d_lines[a], atol=1e-5 * scale, rtol=0)


def test_kernel_wrappers_check_shapes():
    lines = torch.zeros(3, fac.basis_dim(SMALL), SMALL.fac_comps)
    pts = torch.zeros(5, 3)
    with pytest.raises(ValueError, match="lines"):
        k3.fused_factored_encode_forward(lines[:, :-1], pts, SMALL)
    with pytest.raises(ValueError, match="points"):
        k3.fused_factored_encode_forward(lines, pts[:, :2], SMALL)
    with pytest.raises(ValueError, match="g must be"):
        k3.fused_factored_encode_backward(lines, pts, torch.zeros(5, 3), SMALL)
    with pytest.raises(ValueError, match="no kernel"):
        k3.fused_factored_encode_forward(lines.to("meta"), pts.to("meta"), SMALL)


# geometries past the kernels' former caps (16 levels; levels x channels
# 1,024): 20 levels of the preset's ladder, and the preset's 6 levels at
# 192 channels (L x C = 1,152); AABB 2 for the reason given above
PAST_CAPS = {"levels 20": ModelConfig(arch="factored", fac_levels=20, fac_aabb=2.0),
             "6 x 192": ModelConfig(arch="factored", fac_comps=192, fac_aabb=2.0)}


def _jax_k3_xla(lines, pts, g, cfg, jdt):
    """The JAX kernel's arithmetic (nerf_rs_tpu/kernels/fused_factored.py
    ::_fwd_kernel, ::_bwd_kernel) on the XLA route, from the JAX package's
    own hat weights: per axis feat = W @ lines with both operands rounded
    to the matmul dtype and f32 sums, enc = X * Y * Z; d_lines[a] = W_a^T
    round((g * f_b) * f_c)."""
    jcfg, f32 = _jcfg(cfg), jnp.float32
    mm = jdt or f32
    u = jnp.clip((jnp.asarray(pts) + cfg.fac_aabb) / (2.0 * cfg.fac_aabb), 0.0, 1.0)
    ws = [jfac.hat_weights(u[:, a], jcfg).astype(mm) for a in range(3)]
    feats = [jnp.dot(ws[a], jnp.asarray(lines[a]).astype(mm), preferred_element_type=f32)
             for a in range(3)]
    d = [jnp.dot(ws[a].T, (jnp.asarray(g) * feats[b] * feats[c]).astype(mm),
                 preferred_element_type=f32)
         for a, (b, c) in enumerate(((1, 2), (0, 2), (0, 1)))]
    return np.asarray(feats[0] * feats[1] * feats[2]), np.stack([np.asarray(x) for x in d])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("geometry", list(PAST_CAPS))
def test_kernel_plain_version_matches_jax_kernel_past_the_former_caps(geometry, dtype):
    """K3's plain versions at 20 levels and at 6 x 192 channels on 64
    points, against the JAX kernel's arithmetic through its XLA reference
    (as tests/test_factored.py holds the kernel): values rtol 1e-5 and
    atol 1e-6 of the encoding's largest magnitude, line gradients rtol 1e-4
    / atol 1e-5. (A feature sums 2L taps in another order on each side; at
    20 levels an element whose sum cancels misses a 1e-6 absolute bar by
    its rounding alone, so the absolute bar scales with the values, which
    reach 84 at 20 levels and 15 at 6 x 192 here.) Where every resolution is
    a power of two (6 x 192) they are also held to the JAX kernel in
    interpret mode; at 20 levels that mode contracts u R into the hat's
    subtraction (one fused multiply-add on the CPU), which moves a weight
    by an ulp where R is not a power of two (7e-4 of the encoding), and
    tests/test_factored.py holds it to the XLA route only at powers of
    two."""
    cfg = PAST_CAPS[geometry]
    dt, jdt = DTYPES[dtype]
    lines, pts = _lines(cfg, seed=5), _points(cfg, 64, seed=6)
    g = np.random.default_rng(7).normal(size=(64, cfg.fac_comps)).astype(np.float32)
    lt = torch.from_numpy(lines).requires_grad_()
    got = k3.fused_factored_encode(lt, torch.from_numpy(pts), cfg, dt)
    (got * torch.from_numpy(g)).sum().backward()
    want, want_grad = _jax_k3_xla(lines, pts, g, cfg, jdt)
    wants = [(want, want_grad)]
    if all(r & (r - 1) == 0 for r in fac.fac_resolutions(cfg)):
        jl, jp = jnp.asarray(lines), jnp.asarray(pts)
        enc_fn = lambda l: jk3.fused_factored_encode(  # noqa: E731
            l, jp, _jcfg(cfg), jdt, block=64, interpret=True)
        wants.append((np.asarray(enc_fn(jl)),
                      np.asarray(jax.grad(lambda l: jnp.sum(enc_fn(l) * g))(jl))))
    for w, wg in wants:
        np.testing.assert_allclose(got.detach().numpy(), w, rtol=1e-5,
                                   atol=1e-6 * np.abs(w).max())
        np.testing.assert_allclose(lt.grad.numpy(), wg, rtol=1e-4, atol=1e-5)
    assert np.abs(want_grad).max() > 0.01 and len(wants) == 1 + (geometry == "6 x 192")


@pytest.mark.parametrize("kw,code", [
    (dict(fac_levels=47), {"fwd": 0, "bf16": 0, "f32": 0}),
    (dict(fac_levels=48), {"fwd": 0, "bf16": 0, "f32": 0}),
    (dict(fac_levels=2, fac_base_res=2600, fac_max_res=5000, fac_comps=8),
     {"fwd": 0, "bf16": 0, "f32": 0}),
    (dict(fac_levels=1, fac_base_res=60000, fac_comps=4), {"fwd": 0, "bf16": 0, "f32": 0}),
    (dict(fac_levels=257, fac_comps=8), {"fwd": 0, "bf16": 0, "f32": 0}),
    (dict(fac_levels=300, fac_comps=8), {"fwd": 0, "bf16": 0, "f32": 0}),
])
def test_kernels_refuse_only_what_they_cannot_hold(kw, code):
    """What the card takes, by its ``_ERRORS`` code (the CUDA test
    test_factored_kernels_take_any_level_count drives the kernels there).
    Since fault 15's repair the per-level arrays lie in a device table, not
    in the launch parameters, so 257 and 300 levels are taken (they were
    refused with -2 past 256); only more levels than the forward's tap
    buffers hold (FWD_MAX_LEVELS, code -5) stay refused. Since fault 7's
    repair 48 levels are taken (the tensor-core scatter walks runs of
    levels) and so is an f32 level of 60,001 knots (the f32 scatter cuts it
    into runs of rows), as a per-axis table larger than a CTA (2 levels of
    2,601 and 5,001 knots) already was. The wrappers on CPU tensors run the
    plain versions, which take every geometry: forward and backward, under
    both dtypes, agree with the dense hat product's form."""
    cfg = ModelConfig(arch="factored", **kw)
    assert set(code.values()) <= {0, *k3._ERRORS}
    lines = torch.from_numpy(_lines(cfg, seed=8))
    pts = torch.from_numpy(_points(cfg, 16, seed=9))
    g = torch.from_numpy(np.random.default_rng(10).normal(size=(16, cfg.fac_comps))
                         .astype(np.float32))
    for dt in (torch.bfloat16, None):
        enc = k3.fused_factored_encode_forward(lines, pts, cfg, dt)
        d = k3.fused_factored_encode_backward(lines, pts, g, cfg, dt)
        want = k3.fused_factored_encode_reference(lines, pts, cfg, dt, dense=True)
        want_d, bound, _ = k3.dense_order_gap(lines, pts, g, cfg, dt)
        np.testing.assert_allclose(enc.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-6 * float(want.abs().max()))
        assert bool(((d - want_d).abs() <= bound + 1e-6 * float(want_d.abs().max())).all())
        assert bool(torch.isfinite(d).all()) and float(d.abs().max()) > 0


@pytest.mark.parametrize("geometry", list(PAST_CAPS))
def test_level_order_stands_from_the_dense_product_by_its_flips(geometry):
    """The plain versions sum each axis's taps in level order, as the
    kernels do; the JAX kernel's dense hat product sums them in another
    order. Under bf16 an element of d_feat then rounds to a neighbouring
    bf16 now and then, and d_lines moves by those flips scattered with the
    hat weights: ``dense_order_gap``'s bound holds the level order's
    d_lines to the dense form's, elementwise, with 1e-6 of the scale for
    the f32 sums (chip_smoke.py and tests/test_torch_cuda.py hold the
    kernels to the dense form the same way, with KERNEL_TOL for that)."""
    cfg = PAST_CAPS[geometry]
    n = 2048
    lines = torch.from_numpy(_lines(cfg, seed=11))
    pts = torch.from_numpy(_points(cfg, n, seed=12))
    g = torch.from_numpy(np.random.default_rng(13).normal(size=(n, cfg.fac_comps))
                         .astype(np.float32))
    got = k3.fused_factored_encode_backward_reference(lines, pts, g, cfg, torch.bfloat16)
    want, bound, flips = k3.dense_order_gap(lines, pts, g, cfg, torch.bfloat16)
    scale = float(want.abs().max())
    gap = (got - want).abs()
    assert bool((gap <= bound + 1e-6 * scale).all())
    assert flips <= 1e-3 * 3 * n * cfg.fac_comps
    assert (float(bound.max()) > 0) == (flips > 0)


def _jax_tree(cfg, seed=0):
    """JAX-initialised factored weights with the sigma head's bias raised,
    so the field is opaque enough that every leaf gets a gradient."""
    tree = jax.tree.map(np.asarray, jmlp.init_nerf_params(jax.random.PRNGKey(seed), _jcfg(cfg)))
    tree["sigma2"]["b"] = tree["sigma2"]["b"] + np.float32(0.5)
    return tree


def _field(cfg, tree):
    model = mlp.init_nerf_params(cfg)
    model.load_state_dict(params_from_numpy(tree))
    return model


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("precision", ["f32", "mixed"])
def test_apply_nerf_matches_jax(precision, fused):
    """sigma and rgb after their activations, from converted weights.
    f32: rtol 1e-5 / atol 1e-5 (f32 sums in another order). mixed: the
    heads run in bf16 in both packages, and a sum in another order can
    flip one bf16 rounding of sigma_raw or a hidden activation: one bf16
    ulp at unit scale, 2^-8 (the largest reading on these inputs is
    1.2e-7, every route and precision)."""
    cfg = dataclasses.replace(SMALL, fac_fused=fused)
    tree = _jax_tree(cfg)
    model = _field(cfg, tree)
    rng = np.random.default_rng(5)
    pts = rng.uniform(-1.2, 1.2, (24, 16, 3)).astype(np.float32)
    d = rng.normal(size=(24, 1, 3))
    vd = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    dt, jdt = (torch.bfloat16, jnp.bfloat16) if precision == "mixed" else (None, None)
    with torch.no_grad():
        sigma, rgb = mlp.apply_nerf(model, torch.from_numpy(pts), torch.from_numpy(vd), cfg, dt)
    jsig, jrgb = jmlp.apply_nerf(tree, jnp.asarray(pts), jnp.asarray(vd), _jcfg(cfg), jdt)
    assert sigma.shape == (24, 16) and rgb.shape == (24, 16, 3)
    assert sigma.dtype == torch.float32 and rgb.dtype == torch.float32
    tol = 1e-5 if precision == "f32" else 2.0 ** -8
    np.testing.assert_allclose(sigma.numpy(), np.asarray(jsig), rtol=tol, atol=tol)
    np.testing.assert_allclose(rgb.numpy(), np.asarray(jrgb), rtol=tol, atol=tol)
    assert float(sigma.std()) > 0.01 and float(rgb.std()) > 0.01  # a live field


def _train_cfg(precision, fused=True, l1=1e-3) -> Config:
    model = dataclasses.replace(SMALL, fac_aabb=1.2, fac_fused=fused, fac_l1=l1)
    return Config(camera=CameraConfig(width=8, height=8), model=model,
                  render=RenderConfig(num_samples=16, white_background=True, randomized=False),
                  train=TrainConfig(num_rays=8, learning_rate=1e-2, precision=precision),
                  data=DataConfig(dataset="sphere"))


def _batch(seed=6):
    rng = np.random.default_rng(seed)
    o = (rng.normal(size=(8, 3)) * 0.2 + [0.0, 0.0, -1.0]).astype(np.float32)
    d = (rng.normal(size=(8, 3)) * 0.2 + [0.0, 0.0, 1.0]).astype(np.float32)
    gold = rng.uniform(size=(8, 3)).astype(np.float32)
    return o, d, gold


def _states(cfg):
    """The JAX state with _jax_tree's weights and the port's state holding
    the same values."""
    jcfg = jconfig.Config.from_dict(cfg.to_dict())
    jstate = jstep.init_state(jax.random.PRNGKey(7), jcfg)
    tree = _jax_tree(cfg.model, 7)
    jparams = jax.tree.map(jnp.asarray, tree)
    jstate = jstate._replace(params=jparams, opt_state=jstep.make_optimizer(jcfg).init(jparams))
    state = step.init_state(cfg)
    state.params.load_state_dict(params_from_numpy(tree))
    return jcfg, jstate, state


# per leaf, the largest gradient difference over the leaf's largest entry:
# f32, sums in another order (largest reading 6.6e-7); mixed, the heads' bf16
# rounding points: the weight leaves read up to 3.9e-3 (sigma1 through K3's
# plain version), and the bias leaves, whose gradients are bf16 sums over the
# rows in both packages, differ by a few bf16 ulps: 1.4e-2 (color1.b)
_GRAD_TOL = {"f32": 1e-5, "mixed": 3e-2}


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("precision", ["f32", "mixed"])
def test_train_step_matches_jax(precision, fused):
    """The slice as a whole: one train step on converted weights, explicit
    rays, midpoint samples, fac_l1 > 0 and (the main path) fac_fused: the
    loss, every leaf's gradient (the line tables' through K3's plain
    backward), and the weights after one Adam update, against the JAX
    package's train_step (its kernel in interpret mode). The first Adam
    update is ~lr sign(g), so the new weights agree to a small fraction of
    lr wherever |g| >> eps; the L1 term keeps every line entry's |g| above
    fac_l1 / lines.size."""
    cfg = _train_cfg(precision, fused)
    jcfg, jstate, state = _states(cfg)
    o, d, gold = _batch()
    jb = jstep.Batch(*map(jnp.asarray, (o, d, gold)))
    tb = step.Batch(*map(torch.from_numpy, (o, d, gold)))
    (jloss, jaux), jgrads = jax.value_and_grad(jstep.loss_fn, has_aux=True)(
        jstate.params, jb, jax.random.PRNGKey(0), jcfg)
    loss, aux = step.loss_fn(state.params, tb, None, cfg)
    loss.backward()
    # f32 sums of 8 rays' errors (largest reading 7.6e-8 relative)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(aux["loss_coarse"].detach()), float(jaux["loss_coarse"]),
                               rtol=1e-5)
    grads = params_to_numpy({k: p.grad for k, p in state.params.named_parameters()})
    jgrads = jax.tree.map(np.asarray, jgrads)
    assert jax.tree_util.tree_structure(grads) == jax.tree_util.tree_structure(jgrads)
    for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(grads),
                            jax.tree_util.tree_leaves(jgrads)):
        scale = np.abs(w).max()
        assert scale > 1e-6, path  # every leaf is live
        np.testing.assert_allclose(g / scale, w / scale, atol=_GRAD_TOL[precision],
                                   err_msg=str(path))

    state = step.init_state(cfg)
    state.params.load_state_dict(params_from_numpy(_jax_tree(cfg.model, 7)))
    new_j, aux_j = jstep.train_step(jstate, jb, jax.random.PRNGKey(0), jcfg)
    state, aux = step.train_step(state, tb, None, cfg)
    assert state.step == 1
    lr = cfg.train.learning_rate
    for g, w in zip(jax.tree_util.tree_leaves(params_to_numpy(state.params)),
                    jax.tree_util.tree_leaves(jax.tree.map(np.asarray, new_j.params))):
        np.testing.assert_allclose(g, w, atol=0.1 * lr)


def test_l1_regulariser_enters_the_loss():
    """fac_l1 adds fac_l1 * mean|lines| to the loss and nothing to the
    psnr, as in nerf_rs_tpu/train/step.py:_reg_loss."""
    o, d, gold = _batch()
    tb = step.Batch(*map(torch.from_numpy, (o, d, gold)))
    state = step.init_state(_train_cfg("f32", l1=0.0))
    with torch.no_grad():
        l0, a0 = step.loss_fn(state.params, tb, None, _train_cfg("f32", l1=0.0))
        l1, a1 = step.loss_fn(state.params, tb, None, _train_cfg("f32", l1=0.1))
    want = 0.1 * float(state.params.lines.detach().abs().mean())
    np.testing.assert_allclose(float(l1 - l0), want, rtol=1e-4)
    assert float(a1["psnr"]) == float(a0["psnr"])


def test_convert_round_trip_of_a_factored_tree():
    """JAX tree -> state dict -> JAX tree, exactly; the bare ``lines``
    leaf keeps its name and no ``trunk`` appears."""
    tree = _jax_tree(SMALL)
    sd = params_from_numpy(tree)
    assert set(sd) == {"lines"} | {f"{n}.{x}" for n in ("sigma1", "sigma2", "color1",
                                                        "color2", "rgb") for x in "wb"}
    model = _field(SMALL, tree)
    back = params_to_numpy(model)
    assert "trunk" not in back
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(tree)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(a, b)


def test_checkpoint_round_trip_of_a_factored_state(tmp_path):
    cfg = _train_cfg("mixed")
    state = step.init_state(cfg)
    o, d, gold = _batch()
    batch = step.Batch(*map(torch.from_numpy, (o, d, gold)))
    state, _ = step.train_step(state, batch, None, cfg)
    path = ckpt.save(state, str(tmp_path))
    fresh = ckpt.restore(path, step.init_state(cfg))
    field = fac.FactoredField(cfg.model)
    assert fresh.step == 1 and ckpt.restore_weights(path, field) == 1
    for (k, a), b, c in zip(state.params.state_dict().items(), fresh.params.state_dict().values(),
                            field.state_dict().values()):
        assert torch.equal(a, b) and torch.equal(a, c), k
    s1, _ = step.train_step(state, batch, None, cfg)  # the optimizer state came back too
    s2, _ = step.train_step(fresh, batch, None, cfg)
    for (k, a), (_, b) in zip(step.named_trainable(s1), step.named_trainable(s2)):
        assert torch.equal(a, b), k


def test_init_is_seeded():
    """The same numpy draw on every call; lines N(0, fac_init_scale); the
    heads He truncated-normal with zero biases; another seed or stream
    draws other weights."""
    a = mlp.init_nerf_params(MAIN, 0)
    b = mlp.init_nerf_params(MAIN, 0)
    assert isinstance(a, fac.FactoredField)
    for (k, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(x, y), k
    lines = a.lines.detach()
    assert lines.shape == (3, 1014, 48)
    assert abs(float(lines.std()) / MAIN.fac_init_scale - 1.0) < 0.01
    assert abs(float(lines.mean())) < 0.01
    first = np.random.default_rng(0).standard_normal(8) * MAIN.fac_init_scale
    np.testing.assert_allclose(lines.reshape(-1)[:8].numpy(), first, rtol=1e-6)
    for name in ("sigma1", "sigma2", "color1", "color2", "rgb"):
        layer = getattr(a, name)
        std = (2.0 / layer.w.shape[0]) ** 0.5
        assert float(layer.w.detach().abs().max()) <= 2.0 * std + 1e-6, name
        assert not layer.b.any(), name
    assert a.sigma1.w.shape == (48, 64) and a.sigma2.w.shape == (64, 16)
    assert a.color1.w.shape == (15 + 27, 64) and a.rgb.w.shape == (64, 3)
    for other in (mlp.init_nerf_params(MAIN, 1), mlp.init_nerf_params(MAIN, 0, stream=1)):
        assert not torch.equal(other.lines, a.lines)
    # about 157K parameters, as the JAX tree
    n = sum(p.numel() for p in a.parameters())
    assert n == sum(x.size for x in jax.tree_util.tree_leaves(
        jmlp.init_nerf_params(jax.random.PRNGKey(0), _jcfg(MAIN))))
    assert 150_000 < n < 160_000


def test_paper_field_refuses_a_factored_config():
    with pytest.raises(ValueError, match="paper field"):
        mlp.NerfMLP(MAIN)


def test_cli_factored_preset_trains_evaluates_and_renders(tmp_path, capsys):
    """`train --preset factored` for 12 steps at 24x24 with tiny widths on
    the CPU, then `eval` and `render` of its checkpoint; the CLI's route
    is the dense-hat encode (no fac_fused flag), as in the JAX CLI."""
    save = str(tmp_path / "ckpt")
    common = ["--preset", "factored", "--dataset", "sphere", "--width", "24", "--height", "24",
              "--num_samples", "16", "--fac_levels", "3", "--fac_base_res", "4",
              "--fac_max_res", "16", "--fac_comps", "8", "--fac_aabb", "1.2",
              "--save_dir", save, "--device", "cpu"]
    launches = k3.fused_factored_encode.launches
    assert cli.main(["train", *common, "--num_rays", "128", "--num_iter", "12",
                     "--save_steps", "10", "--eval_steps", "10", "--logging_steps", "100",
                     "--fac_l1", "1e-4", "--log_dir", str(tmp_path / "logs")]) == 0
    out = capsys.readouterr().out
    assert "iter=10, eval psnr=" in out and "done at step 12" in out
    assert ckpt.latest_checkpoint(save).endswith("-12.pt")
    assert cli.main(["eval", *common, "--max_views", "1"]) == 0
    assert "mean psnr over 1 test views" in capsys.readouterr().out
    assert cli.main(["render", *common, "--view", "0", "--out_dir",
                     str(tmp_path / "renders")]) == 0
    assert "psnr=" in capsys.readouterr().out
    assert (tmp_path / "renders" / "view-0.png").exists()
    assert k3.fused_factored_encode.launches == launches
