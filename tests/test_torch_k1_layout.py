"""The render kernel K1's own layouts, on the CPU (csrc/fused_ray.cu,
csrc/field_wgmma.cuh, kernels/fused_render.pack_weights_k1,
kernels/fused_ray.k1_cta_rays):

* its weight layout unpacks to the bf16 matrices of the JAX package's
  packing, for every matrix, at the paper width, at narrow ones and at
  depth 21;
* its biases, read as each quad lane of an accumulator fragment reads
  them (csrc/fused_ray.cu ``product``), start every column of every
  trunk, feature and view-head layer from that column's bias;
* the wgmma descriptors' addressing (K-major 8 x 8 core matrices, leading
  byte offset = rows * 16, stride byte offset = 128, a k16 step two k
  groups on) read from those bytes and from an activation tile gives the
  layer's product, and the accumulator fragment covers each (row, column)
  of a warpgroup's tile once;
* the persistent CTA grid, in clusters of K1_CLUSTER, takes every ray
  exactly once for every padded S up to 256 and for rays of 300 to 2048
  samples (one ray a CTA in S / 128 passes), ragged N and number of
  clusters the card holds.

The kernel itself against its plain version needs the card:
tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_rs_tpu.kernels import fused_render as jrender
from nerf_rs_tpu.models import mlp as jmlp
from nerf_rs_tpu_torch.config import ModelConfig
from nerf_rs_tpu_torch.convert import params_from_numpy
from nerf_rs_tpu_torch.kernels import fused_render
from nerf_rs_tpu_torch.kernels.fused_ray import (K1_CLUSTER, TILE_ROWS, cta_rows, k1_cta_rays,
                                                 k1_grid, padded_samples, rays_per_cta)
from nerf_rs_tpu_torch.models.mlp import NerfMLP

torch.set_num_threads(2)

PAPER = ModelConfig()
NARROW = ModelConfig(net_depth=3, net_width=32, skip_layer=2, feature_width=32,
                     view_head_width=16, pos_enc_levels=4, dir_enc_levels=2)
ODD = ModelConfig(net_depth=3, net_width=48, skip_layer=2, feature_width=80,
                  view_head_width=16, pos_enc_levels=4, dir_enc_levels=2)  # padded products
DEEP = ModelConfig(net_depth=21, net_width=32, skip_layer=4, feature_width=32,
                   view_head_width=16, pos_enc_levels=4, dir_enc_levels=2)  # 26 matrices
# the padded sample counts: every one up to 256, then rays of 300 to 2048 samples
LONG_S = sorted({padded_samples(s) for s in (*range(1, 257), 300, 384, 512, 577, 2048)})


def _packed(cfg, seed=0):
    tree = jax.tree.map(np.asarray, jmlp.init_nerf_params(jax.random.PRNGKey(seed), cfg))
    model = NerfMLP(cfg)
    model.load_state_dict(params_from_numpy(tree))
    jpk = jrender.pack_weights(jax.tree.map(jnp.asarray, tree), cfg)
    return fused_render.pack_weights(model, cfg), jpk


def _jax_matrices(jpk, cfg):
    """The JAX package's packed matrices in K1's kernel order, cut to the
    port's columns: trunk, skip, [feature | sigma] to F + 8 columns, view
    (feature and direction parts), rgb to 8 columns (the JAX package pads
    the encodings' rows to its own widths)."""
    F = cfg.feature_width
    mats = list(jpk.trunk_w) + [jpk.skip_w, jpk.sf_w[:, :F + 8], jpk.view_w, jpk.view_dir_w,
                                jpk.rgb_w[:, :8]]
    return [torch.from_numpy(np.asarray(m, np.float32)) for m in mats]


@pytest.mark.parametrize("cfg", [PAPER, NARROW, ODD, DEEP],
                         ids=["paper", "narrow", "odd", "deep"])
def test_k1_layout_unpacks_to_the_jax_matrices(cfg):
    pk, jpk = _packed(cfg)
    k1 = pk.k1
    want = _jax_matrices(jpk, cfg)
    got = k1.matrices()
    assert len(got) == len(want) == cfg.net_depth + 5
    assert k1.w.dtype == torch.bfloat16
    assert k1.w.numel() == sum(k * n for k, n in k1.w_shape) >= pk.w.numel()
    for i, (g, w) in enumerate(zip(got, want)):
        k, n = g.shape
        assert tuple(k1.shape[i]) == (k, n) and n == w.shape[1] and k <= w.shape[0], i
        assert torch.equal(g.float(), w[:k]) and not w[k:].any(), i
    # the padded products: zero columns, each a power of two from 16 wide
    # ([feature | sigma]: the feature block padded, sigma's 8 after it)
    for i, (pm, m) in enumerate(zip(k1.padded_matrices(), got)):
        n = m.shape[1]
        if i == k1.sf:
            fp = fused_render.k1_width(cfg.feature_width)
            assert pm.shape[1] == fp + 8 and torch.equal(pm[:, fp:], m[:, -8:])
            assert torch.equal(pm[:, :cfg.feature_width], m[:, :-8])
            assert not pm[:, cfg.feature_width:fp].any()
        else:
            want_n = 8 if n == 8 else fused_render.k1_width(n)
            assert pm.shape[1] == want_n and torch.equal(pm[:, :n], m) and not pm[:, n:].any()
    assert pk.k1 is k1  # packed once per PackedWeights


def _fragment_bias_reads(b: np.ndarray, n: int) -> np.ndarray:
    """One layer's n biases in K1's order (``b``, from the layer's offset in
    PackedK1.b) read as csrc/fused_ray.cu ``product`` reads them: quad lane
    q's 16-byte load jj (jj < n / 16) is floats 16 jj + 4 q .. + 3, and
    starts the sums of columns 16 jj + 2 q + {0, 1} (n8 tile 2 jj) and 16
    jj + 8 + 2 q + {0, 1} (tile 2 jj + 1). Returns the bias each column
    starts from (NaN: none)."""
    out = np.full(n, np.nan)
    for q in range(4):
        for jj in range(n >> 4):
            quad = b[16 * jj + 4 * q:16 * jj + 4 * q + 4]
            for h in range(2):
                for e in range(2):
                    c = 16 * jj + 8 * h + 2 * q + e
                    assert np.isnan(out[c])
                    out[c] = quad[2 * h + e]
    return out


@pytest.mark.parametrize("cfg", [PAPER, NARROW, ODD, DEEP],
                         ids=["paper", "narrow", "odd", "deep"])
def test_fragment_bias_order_starts_every_column_from_its_bias(cfg):
    """Random biases through pack_weights_k1: every column of every trunk
    layer, the feature layer and the view head starts from its own bias,
    and _fragment_order puts each of a layer's biases in one place."""
    rng = np.random.default_rng(11)
    model = NerfMLP(cfg)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.rsplit(".", 1)[-1] == "b":
                p.copy_(torch.from_numpy(rng.normal(size=tuple(p.shape)).astype(np.float32)))
    k1 = fused_render.pack_weights(model, cfg).k1
    flat = k1.b.numpy()
    W, F, V = cfg.net_width, cfg.feature_width, cfg.view_head_width
    layers = [(model.trunk[i].b, i * W) for i in range(cfg.net_depth)]
    layers += [(model.feature.b, cfg.net_depth * W), (model.view1.b, cfg.net_depth * W + F)]
    assert flat.shape == (cfg.net_depth * W + F + V,)
    for want, off in layers:
        n = want.shape[0]
        got = _fragment_bias_reads(flat[off:off + n], n)
        np.testing.assert_array_equal(got, want.detach().numpy())
        order = fused_render._fragment_order(torch.arange(n, dtype=torch.float32))
        assert torch.equal(torch.sort(order).values, torch.arange(n, dtype=torch.float32))


def _b_at(flat: np.ndarray, off: int, step: int, k: int, n: int, ntot: int) -> float:
    """Element (k, n) of k16 step `step` of a matrix packed ntot wide at
    element offset `off`, read the way a B descriptor addresses a ring
    slot: the slice is the step's contiguous run, k group k // 8 at
    ntot * 16 bytes, row group n // 8 at 128 bytes, row n % 8 at 16 and k
    % 8 at 2."""
    byte = step * 32 * ntot + (k // 8) * ntot * 16 + (n // 8) * 128 + (n % 8) * 16 + (k % 8) * 2
    return flat[off + byte // 2]


def _tile_off(r: int, k: int) -> int:
    """field_wgmma.cuh tile_off: element (r, k) of a 128-row tile, bytes."""
    return (k >> 3) * 2048 + (r >> 3) * 128 + (r & 7) * 16 + (k & 7) * 2


@pytest.mark.parametrize("cfg", [PAPER, NARROW, ODD, DEEP],
                         ids=["paper", "narrow", "odd", "deep"])
def test_descriptor_addressing_reads_every_matrix(cfg):
    """Every matrix read element by element through the B descriptor's
    addressing, one k16 step at a time, is the packed matrix."""
    pk, _ = _packed(cfg)
    k1 = pk.k1
    flat = k1.w.float().numpy()
    rng = np.random.default_rng(3)
    for off, (K, N), m in zip(k1.w_off, k1.w_shape, k1.padded_matrices()):
        ks, ns = rng.integers(0, K, 256), rng.integers(0, N, 256)
        got = [_b_at(flat, off, k // 16, k % 16, n, N) for k, n in zip(ks, ns)]
        assert np.array_equal(got, m.float().numpy()[ks, ns])


def test_warpgroup_product_through_both_descriptors():
    """A 128-row activation tile written at tile_off and a packed matrix,
    multiplied k16 step by k16 step as the two warpgroups' descriptors
    address them (A: leading offset 2048, stride 128, warpgroup g from
    row 64 g; B as above), with the sums scattered through the m64nN
    accumulator fragment, give A @ W; each (row, column) is written once."""
    rng = np.random.default_rng(7)
    K, N = 48, 40
    w = torch.from_numpy(rng.normal(size=(K, N)).astype(np.float32)).bfloat16()
    a = rng.normal(size=(TILE_ROWS, K)).astype(np.float32)
    a = torch.from_numpy(a).bfloat16().float().numpy()
    tile = np.zeros(TILE_ROWS * K)
    for r in range(TILE_ROWS):
        for k in range(K):
            tile[_tile_off(r, k) // 2] = a[r, k]
    flat = fused_render._core_k_major(w).float().numpy()
    out = np.full((TILE_ROWS, N), np.nan)
    for g in range(2):  # consumer warpgroup: rows 64 g .. 64 g + 63
        acc = np.zeros((128, N // 2))  # thread t, register
        for step in range(K // 16):
            a_blk = np.array([[tile[(_tile_off(64 * g + r, 16 * step + k)) // 2]
                               for k in range(16)] for r in range(64)])
            b_blk = np.array([[_b_at(flat, 0, step, k, n, N) for n in range(N)]
                              for k in range(16)])
            d = a_blk @ b_blk  # (64, N), scattered to the fragment below
            for t in range(128):
                w_, lane = t // 32, t % 32
                r = 16 * w_ + lane // 4
                for j in range(N // 8):
                    c = 8 * j + 2 * (lane % 4)
                    acc[t, 4 * j:4 * j + 4] += [d[r, c], d[r, c + 1], d[r + 8, c],
                                                d[r + 8, c + 1]]
        for t in range(128):  # the epilogue's (r0, c0) reading of the fragment
            w_, lane = t // 32, t % 32
            r0, c0 = 64 * g + 16 * w_ + lane // 4, 2 * (lane % 4)
            for j in range(N // 8):
                for e in range(4):
                    r, c = r0 + 8 * (e >> 1), 8 * j + c0 + (e & 1)
                    assert np.isnan(out[r, c])
                    out[r, c] = acc[t, 4 * j + e]
    np.testing.assert_allclose(out, a.astype(np.float64) @ w.double().numpy(), atol=1e-9)


@pytest.mark.parametrize("clusters", [1, 3, 66])
@pytest.mark.parametrize("n", [1, 127, 4103])
@pytest.mark.parametrize("s", LONG_S)
def test_k1_grid_takes_every_ray_once(s, n, clusters):
    """Every padded S, ragged N and number of clusters the card holds: the
    persistent grid is a whole number of clusters, no more than the tiles
    need, every CTA runs the same number of tiles, CTA b's k-th tile takes
    rays R (b + k grid) .. + R - 1, each ray once, -1 only past the last
    ray; with cta_rows each (ray, sample) row is run once."""
    grid, iters = k1_grid(n, s, clusters)
    m = k1_cta_rays(n, s, clusters)
    R = rays_per_cta(s)
    tiles = -(-n // R)
    assert grid % K1_CLUSTER == 0 and m.shape == (grid, iters, R)
    assert grid <= K1_CLUSTER * min(clusters, -(-tiles // K1_CLUSTER))
    assert (iters - 1) * grid < tiles <= iters * grid
    real = m[m >= 0]
    assert torch.equal(torch.sort(real).values, torch.arange(n))
    assert torch.equal(m.permute(1, 0, 2).reshape(-1)[:n], torch.arange(n))
    rows = cta_rows(s).reshape(-1, 2)  # (ray within the tile, sample)
    ray = m.reshape(-1, R)[:, rows[:, 0]]  # (tiles, rows of a tile)
    sample = rows[:, 1].expand_as(ray)
    ok = ray >= 0
    hits = torch.zeros(n, s, dtype=torch.int64)
    hits.index_put_((ray[ok], sample[ok]), torch.ones(int(ok.sum()), dtype=torch.int64),
                    accumulate=True)
    assert bool((hits == 1).all())
