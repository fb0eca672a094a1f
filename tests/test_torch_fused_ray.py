"""The PyTorch port's whole-ray render kernel (kernels/fused_ray.py,
kernels/fused_render.py, csrc/fused_ray.cu) on the CPU.

* Its plain version against the JAX package's Pallas kernel, run in
  interpret mode as tests/test_fused_ray.py runs it, on a ragged ray
  count with relu and softplus sigma.
* The weight packing, and the CUDA kernel's fragment addressing emulated
  in numpy against the PTX m16n8k16 fragment layouts: the one part of
  the kernel's arithmetic a CPU can check.

The kernel itself against its plain version needs the card:
tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_rs_tpu.kernels import fused_ray as jfused
from nerf_rs_tpu.kernels import fused_render as jrender
from nerf_rs_tpu.models import mlp as jmlp
from nerf_rs_tpu.ops import sampling as jsamp
from nerf_rs_tpu_torch.config import ModelConfig
from nerf_rs_tpu_torch.convert import params_from_numpy
from nerf_rs_tpu_torch.kernels import fused_render
from nerf_rs_tpu_torch.kernels.fused_ray import (
    fused_ray_render, fused_ray_render_reference)
from nerf_rs_tpu_torch.models.mlp import NerfMLP, init_nerf_params

torch.set_num_threads(2)

CFG = ModelConfig(net_depth=4, net_width=64, skip_layer=2, feature_width=64,
                  view_head_width=32)
N, S = 37, 16  # ragged: not a multiple of the kernel's tile or the JAX block


def _case(cfg, seed=0):
    tree = jax.tree.map(np.asarray, jmlp.init_nerf_params(jax.random.PRNGKey(seed), cfg))
    model = NerfMLP(cfg)
    model.load_state_dict(params_from_numpy(tree))
    rng = np.random.default_rng(seed + 1)
    o = (rng.normal(size=(N, 3)) * 0.2).astype(np.float32)
    d = rng.normal(size=(N, 3)).astype(np.float32)
    vd = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    ts = np.sort(rng.uniform(0.05, 2.0, (N, S)), axis=-1).astype(np.float32)
    deltas = np.array(jsamp.deltas_from_ts(jnp.asarray(ts), 2.0))
    return tree, model, (o, d, vd, ts, deltas)


@pytest.mark.parametrize("sigma_act", ["relu", "softplus"])
def test_reference_matches_jax_kernel(sigma_act):
    cfg = ModelConfig(**{**CFG.__dict__, "sigma_activation": sigma_act})
    tree, model, rays = _case(cfg)
    # the JAX wrapper needs whole blocks: pad 37 -> 40 rays, drop after
    pad = [np.concatenate([a, np.repeat(a[-1:], 3, axis=0)]) for a in rays]
    want = jfused.fused_ray_render(
        jrender.pack_weights(jax.tree.map(jnp.asarray, tree), cfg),
        *map(jnp.asarray, pad), cfg, S, rays_per_block=8, interpret=True)
    got = fused_ray_render_reference(
        fused_render.pack_weights(model, cfg), *map(torch.from_numpy, rays), cfg, S)
    # both sides: bf16 operands, f32 sums, bf16 activations. JAX's
    # interpret-mode bf16 dot does not sum exactly in f32 (the port's
    # plain version agrees with a float64-sum oracle to ~5e-6, the JAX
    # kernel to ~7e-3 in sigma), so the bars are the JAX package's own
    # kernel-vs-XLA bars: 3e-3, depth 5e-3, sigma 2e-2
    for name, g, w, tol in zip(("rgb", "acc", "depth", "weights", "sigma"), got, want,
                               (3e-3, 3e-3, 5e-3, 3e-3, 2e-2)):
        assert g.shape == w[:N].shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w)[:N], atol=tol, err_msg=name)


def test_cpu_wrapper_runs_the_plain_version():
    _, model, rays = _case(CFG)
    args = (fused_render.pack_weights(model, CFG), *map(torch.from_numpy, rays), CFG, S)
    before = fused_ray_render.launches
    got = fused_ray_render(*args)
    want = fused_ray_render_reference(*args)
    assert fused_ray_render.launches == before  # no kernel launched on the CPU
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_pe_encode_matches_jax():
    # same f32 arguments and exact power-of-two scales; atol 1e-4 for
    # the 2^9 phase amplification. Pad columns: zero in the port (the
    # JAX helper leaves garbage there that meets zero weight rows)
    p = np.random.default_rng(4).uniform(-2, 2, (300, 3)).astype(np.float32)
    got = fused_render.pe_encode(torch.from_numpy(p), 10, 64).numpy()
    want = np.asarray(jrender._pe_encode(jnp.asarray(p), 64))
    np.testing.assert_allclose(got[:, :63], want[:, :63], atol=1e-4)
    assert not got[:, 63:].any()
    assert fused_render.enc_dims(ModelConfig()) == (63, 64, 27, 32)


def test_pack_weights_layout():
    tree, model, _ = _case(CFG)
    pk = fused_render.pack_weights(model, CFG)
    mats = pk.matrices()
    bf = lambda a: torch.from_numpy(np.array(a, np.float32)).bfloat16()
    assert [tuple(m.shape) for m in mats] == [
        (64, 64), (64, 64), (64, 64), (64, 64),  # trunk (layer 0 padded 63 -> 64)
        (64, 64),  # skip x-part
        (64, 72),  # [feature | sigma | pad]
        (64, 32), (32, 32), (32, 8)]  # view (feature part, dir part), rgb
    t = tree["trunk"]
    assert torch.equal(mats[0][:63], bf(t[0]["w"])) and not mats[0][63:].any()
    assert torch.equal(mats[2], bf(t[2]["w"][:64]))  # skip layer: hidden rows
    assert torch.equal(mats[4][:63], bf(t[2]["w"][64:]))  # ... and PE rows
    assert torch.equal(mats[5][:, :64], bf(tree["feature"]["w"]))
    assert torch.equal(mats[5][:, 64:65], bf(tree["sigma"]["w"]))
    assert not mats[5][:, 65:].any()
    assert torch.equal(mats[7][:27], bf(tree["view1"]["w"][64:]))
    assert torch.equal(mats[8][:, :3], bf(tree["rgb"]["w"]))
    assert [tuple(b.shape) for b in pk.biases()] == [(64,)] * 4 + [(72,), (32,), (8,)]


def _emulate_kernel_layer(a: np.ndarray, w_flat: torch.Tensor, k: int, n: int):
    """One layer computed the way csrc/fused_ray.cu addresses it: A
    fragments through the ldmatrix.x4 row addresses of mma_accumulate,
    each lane's B fragment as the 8 bytes at ((nt * KT + kt) * 32 + lane)
    of the packed matrix, read through the PTX ISA's m16n8k16 (.bf16)
    fragment layouts (g = lane / 4, t = lane % 4)."""
    m = a.shape[0]
    kt_n, nt_n = k // 16, n // 8
    b_regs = w_flat.float().numpy().reshape(nt_n, kt_n, 32, 2, 2)  # lane, reg, half
    lanes = np.arange(32)
    g, t = lanes // 4, lanes % 4
    out = np.zeros((m, n))
    for m0 in range(0, m, 16):
        for kt in range(kt_n):
            # ldmatrix.x4: lane l points at row m0 + (l & 15), column
            # 16 kt + 8 (l >> 4); matrix q is lanes 8q..8q+7's rows, and
            # lane l receives row l / 4, elements 2 (l % 4) + {0, 1} of it
            rows, cols = m0 + (lanes & 15), 16 * kt + 8 * (lanes >> 4)
            mats = [np.stack([a[rows[8 * q + i], cols[8 * q + i]:cols[8 * q + i] + 8]
                              for i in range(8)]) for q in range(4)]
            a_tile = np.zeros((16, 16))
            b_tiles = np.zeros((nt_n, 16, 8))
            for l in lanes:
                for r in range(4):  # A reg r: row g + 8 (r % 2), cols 2t + 8 (r / 2)
                    a_tile[g[l] + 8 * (r % 2), 2 * t[l] + 8 * (r // 2) + np.arange(2)] = \
                        mats[r][l // 4, 2 * (l % 4):2 * (l % 4) + 2]
                for r in range(2):  # B reg r: rows (k) 2t + 8r + {0, 1}, column g
                    b_tiles[:, 2 * t[l] + 8 * r + np.arange(2), g[l]] = b_regs[:, kt, l, r]
            for nt in range(nt_n):
                # C regs: (g, 2t + {0,1}) and (g + 8, 2t + {0,1}) -> the
                # epilogue's (row0 + 16 mt + g [+ 8], 8 nt + 2t)
                out[m0:m0 + 16, 8 * nt:8 * nt + 8] += a_tile @ b_tiles[nt]
    return out


def test_packed_layout_feeds_mma_fragments():
    rng = np.random.default_rng(5)
    k, n, m = 48, 24, 32
    w = torch.from_numpy(rng.normal(size=(k, n)).astype(np.float32))
    a = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)).bfloat16().double().numpy()
    flat = fused_render._swizzle(w)
    assert torch.equal(fused_render._unswizzle(flat, k, n), w.bfloat16())
    got = _emulate_kernel_layer(a, flat, k, n)
    np.testing.assert_allclose(got, a @ w.bfloat16().double().numpy(), atol=1e-9)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    _, model, rays = _case(CFG)
    pk = fused_render.pack_weights(model, CFG)
    o, d, vd, ts, dl = map(torch.from_numpy, rays)
    with pytest.raises(ValueError, match="ts/deltas"):
        fused_ray_render(pk, o, d, vd, ts, dl, CFG, S // 2)
    # rays of any length: 257 samples run (padded to 384 on the card)
    ts257 = torch.linspace(0.1, 1.9, 257).expand(N, 257).contiguous()
    dl257 = torch.full((N, 257), 1.8 / 256)
    long = fused_ray_render(pk, o, d, vd, ts257, dl257, CFG, 257)
    assert long[3].shape == (N, 257) and all(bool(torch.isfinite(a).all()) for a in long)
    with pytest.raises(ValueError, match="one sample per ray or more"):  # on every device
        fused_ray_render(pk, o, d, vd, ts[:, :0], dl[:, :0], CFG, 0)
    with pytest.raises(ValueError, match="radii"):
        fused_ray_render(pk, o, d, vd, ts, dl, ModelConfig(**{**CFG.__dict__, "ipe": True}), S)
    with pytest.raises(ValueError, match="radii"):
        fused_ray_render(pk, o, d, vd, ts, dl, CFG, S, radii=torch.ones(N))
    # the contraction branch is ported (tests/test_torch_unbounded.py): it runs
    contracted = fused_ray_render(pk, o * 4.0, d, vd, ts, dl,
                                  ModelConfig(**{**CFG.__dict__, "contract": True}), S)
    assert all(bool(torch.isfinite(a).all()) for a in contracted)
    with pytest.raises(ValueError, match="packed weights"):
        fused_ray_render(pk, o, d, vd, ts, dl, ModelConfig(), S)
    with pytest.raises(ValueError, match="sigma_activation"):
        cfg = ModelConfig(**{**CFG.__dict__, "sigma_activation": "none"})
        fused_ray_render(pk, o, d, vd, ts, dl, cfg, S)
    with pytest.raises(ValueError, match="no kernel"):
        fused_ray_render(pk, *(a.to("meta") for a in (o, d, vd, ts, dl)), CFG, S)
    # a width that is no multiple of 16 packs, padded with zeros (fault 14), and
    # its pack is refused for the config of the padded width
    cfg24 = ModelConfig(**{**CFG.__dict__, "view_head_width": 24})
    pk24 = fused_render.pack_weights(init_nerf_params(cfg24, 0, torch.device("cpu")), cfg24)
    assert (pk24.V, pk24.widths) == (32, (64, 64, 24))
    with pytest.raises(ValueError, match="packed weights"):
        fused_ray_render(pk24, o, d, vd, ts, dl, ModelConfig(**{**CFG.__dict__,
                                                                "view_head_width": 32}), S)

