"""The PyTorch port's hash-grid field family on the CPU (ROADMAP slice 9,
the hashgrid half): the row-gather kernel K4's plain versions against the
JAX kernel in interpret mode (as tests/test_gather_rows.py runs it) and the
wrappers' refusals; the level ladder; both encodes (flat through
``gather_pairs``, brick through ``gather_rows``) and their table gradients
against the JAX package's; the field through ``apply_nerf``; one whole
train step per layout; conversion, checkpoints, the seeded init, the render
chunk, and the CLI's ``--preset ngp`` in both layouts.

Small widths as tests/test_hashgrid.py's (4 levels 4..32, T 2^10), and the
main path's widths (16 levels 16..1023, T 2^19, AABB 1.6) on 4096 points;
inputs from numpy seeds, JAX-initialised weights converted to the port.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_rs_tpu import config as jconfig
from nerf_rs_tpu.kernels import gather_rows as jgr
from nerf_rs_tpu.models import hashgrid as jhash
from nerf_rs_tpu.models import mlp as jmlp
from nerf_rs_tpu.parallel import dp as jdp
from nerf_rs_tpu.train import step as jstep
from nerf_rs_tpu_torch import cli
from nerf_rs_tpu_torch.config import (CameraConfig, Config, DataConfig, ModelConfig,
                                      RenderConfig, TrainConfig)
from nerf_rs_tpu_torch.convert import params_from_numpy, params_to_numpy
from nerf_rs_tpu_torch.kernels import gather_rows as k4
from nerf_rs_tpu_torch.models import hashgrid as hg
from nerf_rs_tpu_torch.models import mlp
from nerf_rs_tpu_torch.render import default_render_chunk
from nerf_rs_tpu_torch.train import checkpoint as ckpt
from nerf_rs_tpu_torch.train import step

torch.set_num_threads(2)

SMALL = ModelConfig(arch="hashgrid", hash_levels=4, hash_table_log2=10, hash_base_res=4,
                    hash_max_res=32, hash_aabb=1.0, sigma_activation="softplus")
MAIN = ModelConfig(arch="hashgrid", sigma_activation="softplus")  # 16 levels, T 2^19
LAYOUTS = {"flat": False, "brick": True}


def _cfg(base: ModelConfig, layout: str) -> ModelConfig:
    return dataclasses.replace(base, hash_brick=LAYOUTS[layout])


def _jcfg(cfg: ModelConfig) -> "jconfig.ModelConfig":
    return jconfig.ModelConfig(**dataclasses.asdict(cfg))


def _launches():
    return k4.gather_rows.launches, k4.gather_pairs.launches


# ---- K4's plain versions against the JAX kernel (interpret mode) ---------

@pytest.mark.parametrize("n,block", [(256, 64), (512, 128), (128, 128)])
def test_gather_rows_matches_the_jax_kernel(n, block):
    """tests/test_gather_rows.py's cases through the port's wrapper (the
    CPU takes the plain version and launches nothing): the same bits."""
    rng = np.random.default_rng(0)
    table = rng.normal(size=(300, 128)).astype(np.float32)
    idx = rng.integers(0, 300, n).astype(np.int32)
    want = np.asarray(jgr.gather_rows(jnp.asarray(table), jnp.asarray(idx), block=block,
                                      interpret=True))
    before = _launches()
    got = k4.gather_rows(torch.from_numpy(table), torch.from_numpy(idx))
    assert _launches() == before
    assert got.shape == (n, 128) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_gather_rows_repeated_indices():
    table = np.arange(64 * 128, dtype=np.float32).reshape(64, 128)
    idx = np.asarray([3, 3, 3, 3, 7, 7, 7, 7] * 16, np.int32)
    want = np.asarray(jgr.gather_rows(jnp.asarray(table), jnp.asarray(idx), block=128,
                                      depth=4, interpret=True))
    np.testing.assert_array_equal(k4.gather_rows(torch.from_numpy(table),
                                                 torch.from_numpy(idx)).numpy(), want)


def test_gather_pairs_matches_the_jax_kernel():
    rng = np.random.default_rng(2)
    table = rng.normal(size=4096).astype(np.float32)
    fidx = (rng.integers(0, 2048, 256) * 2).astype(np.int32)
    fidx[:3] = [0, 4094, 4094]  # the first and the last pair, repeated
    want = np.asarray(jgr.gather_pairs(jnp.asarray(table), jnp.asarray(fidx), block=256,
                                       interpret=True))
    got = k4.gather_pairs(torch.from_numpy(table), torch.from_numpy(fidx))
    assert got.shape == (256, 2)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), np.stack([table[fidx], table[fidx + 1]], -1))


@pytest.mark.parametrize("n", [0, 1, 37])
def test_gathers_take_any_n(n):
    """Ragged and empty N, which the TPU kernel's block refuses."""
    rng = np.random.default_rng(n)
    table = rng.normal(size=(50, 12)).astype(np.float32)
    idx = rng.integers(0, 50, n).astype(np.int32)
    got = k4.gather_rows(torch.from_numpy(table), torch.from_numpy(idx))
    assert got.shape == (n, 12)
    np.testing.assert_array_equal(got.numpy(), table[idx])
    flat = table.reshape(-1)
    pairs = k4.gather_pairs(torch.from_numpy(flat), torch.from_numpy(2 * idx))
    np.testing.assert_array_equal(pairs.numpy(), flat.reshape(-1, 2)[idx])


def test_indices_outside_the_table_give_nan():
    """What the kernel writes for them, without reading outside the table."""
    table = torch.arange(40, dtype=torch.float32).reshape(10, 4)
    rows = k4.gather_rows(table, torch.tensor([-1, 3, 10], dtype=torch.int32))
    assert rows[0].isnan().all() and rows[2].isnan().all()
    assert torch.equal(rows[1], table[3])
    pairs = k4.gather_pairs(table.view(-1), torch.tensor([-2, 38, 40], dtype=torch.int32))
    assert pairs[0].isnan().all() and pairs[2].isnan().all()
    assert pairs[1].tolist() == [38.0, 39.0]


_TABLE = torch.zeros(8, 128)
_IDX = torch.zeros(4, dtype=torch.int32)


@pytest.mark.parametrize("call,match", [
    (lambda: k4.gather_rows(_TABLE.double(), _IDX), "f32"),
    (lambda: k4.gather_rows(torch.zeros(8, 256)[:, ::2], _IDX), "contiguous"),
    (lambda: k4.gather_rows(torch.zeros(8, 6), _IDX), "multiple of 4"),
    (lambda: k4.gather_rows(_TABLE, _IDX.long()), "int32"),
    (lambda: k4.gather_rows(_TABLE, torch.zeros(8, dtype=torch.int32)[::2]), "contiguous"),
    (lambda: k4.gather_rows(_TABLE, _IDX[None]), "1-D"),
    (lambda: k4.gather_rows(_TABLE.to("meta"), _IDX.to("meta")), "no kernel"),
    (lambda: k4.gather_pairs(_TABLE, _IDX), "1-D"),
    (lambda: k4.gather_pairs(_TABLE.view(-1), torch.tensor([0, 3], dtype=torch.int32)), "even"),
    (lambda: k4.gather_pairs(_TABLE.view(-1), _IDX.long()), "int32"),
    (lambda: k4.gather_pairs(_TABLE.view(-1).double(), _IDX), "f32"),
])
def test_wrappers_refuse_what_the_kernel_does_not_take(call, match):
    with pytest.raises(ValueError, match=match):
        call()


# ---- the level ladder and the encodes ------------------------------------

@pytest.mark.parametrize("kw", [{}, dict(hash_levels=4, hash_table_log2=10, hash_base_res=4,
                                         hash_max_res=32),
                                dict(hash_levels=1, hash_base_res=7),
                                dict(hash_levels=8, hash_table_log2=12, hash_max_res=64)])
def test_ladder_and_brick_entries_match_jax(kw):
    cfg = ModelConfig(arch="hashgrid", **kw)
    assert hg.level_resolutions(cfg) == jhash.level_resolutions(_jcfg(cfg))
    assert hg.brick_table_entries(cfg) == jhash.brick_table_entries(_jcfg(cfg))
    if not kw:
        assert hg.level_resolutions(cfg) == [16, 21, 27, 36, 48, 63, 84, 111, 147, 194, 255,
                                             337, 445, 588, 776, 1023]
        assert hg.brick_table_entries(cfg) == 8192
        for brick, rows in ((True, 16 * 8192), (False, 16 << 19)):
            shape = hg.table_shape(dataclasses.replace(cfg, hash_brick=brick))
            assert shape[0] == rows and shape[0] * shape[1] * 4 == 64 << 20  # 64 MiB each


def _table(cfg, seed=0):
    return np.random.default_rng(seed).normal(size=hg.table_shape(cfg)).astype(np.float32)


def _points(cfg, n, seed=1):
    """Points inside and outside the AABB (clipped onto its faces), with
    grid vertices of every level (the center, quarter points), the corners
    and faces (u = 0 and u = 1 exactly) among them."""
    a = cfg.hash_aabb
    rng = np.random.default_rng(seed)
    p = rng.uniform(-1.3 * a, 1.3 * a, (n, 3)).astype(np.float32)
    p[:6] = np.float32([[a, a, a], [-a, -a, -a], [a, -a, 0.0], [0.0, 0.0, 0.0],
                        [0.5 * a, -0.5 * a, 0.5 * a], [2 * a, -2 * a, 0.25 * a]])
    return p


def _encode(cfg):
    return hg.brick_encode if cfg.hash_brick else hg.hash_encode


def _jencode(cfg):
    return jhash.brick_encode if cfg.hash_brick else jhash.hash_encode


@pytest.mark.parametrize("layout", ["flat", "brick"])
@pytest.mark.parametrize("width", ["small", "main"])
def test_encode_matches_jax(width, layout):
    """Both encodes through K4's plain versions against the JAX encodes.
    The same f32 coordinates, cells, indices and weights; only the order of
    the 8-term corner sums differs (a 0/1 matmul and a 128-lane reduction
    in the JAX package): within 1e-6 of the features' scale."""
    cfg = _cfg(SMALL if width == "small" else MAIN, layout)
    table, pts = _table(cfg), _points(cfg, 4096)
    before = _launches()
    got = _encode(cfg)(torch.from_numpy(table), torch.from_numpy(pts).reshape(64, 64, 3), cfg)
    assert _launches() == before
    want = np.asarray(_jencode(cfg)(jnp.asarray(table), jnp.asarray(pts), _jcfg(cfg)))
    assert got.shape == (64, 64, cfg.hash_levels * 2) and got.dtype == torch.float32
    scale = np.abs(want).max()
    assert scale > 0.5 and np.isfinite(want).all()
    np.testing.assert_allclose(got.reshape(4096, -1).numpy(), want, rtol=0, atol=1e-6 * scale)


def test_encode_at_a_dense_vertex_is_its_table_entry():
    """tests/test_hashgrid.py's vertex checks: vertex (1, 2, 3) of a
    res-4 dense level is flat entry 1 + 5 (2 + 5 3), and in the brick
    layout brick (0, 0, 1) = row 4, lanes 48, 49."""
    pt = torch.tensor([[2 * 0.25 - 1, 2 * 0.5 - 1, 2 * 0.75 - 1]])
    flat = ModelConfig(arch="hashgrid", hash_levels=1, hash_table_log2=10, hash_base_res=4,
                       hash_max_res=4, hash_aabb=1.0)
    table = torch.arange(2048, dtype=torch.float32).reshape(1024, 2)
    assert hg.hash_encode(table, pt, flat)[0].tolist() == table[1 + 5 * (2 + 5 * 3)].tolist()
    brick = dataclasses.replace(flat, hash_table_log2=13, hash_brick=True)
    table = torch.arange(128 * 128, dtype=torch.float32).reshape(128, 128)
    assert hg.brick_encode(table, pt, brick)[0].tolist() == table[4, 48:50].tolist()


def test_flat_index_past_the_table_is_clamped():
    """A point on the far face of a dense last level reaches corner res + 1
    at weight 0, whose flat index runs past the table: jnp.take fills NaN
    and the JAX encoding of that point is NaN; the port reads the last pair
    instead and stays finite, equal to the JAX encoding of a table padded
    past its end (where the index lands on a pad entry at weight 0)."""
    cfg = ModelConfig(arch="hashgrid", hash_levels=2, hash_table_log2=10, hash_base_res=4,
                      hash_max_res=9, hash_aabb=1.0)  # res 9: (10)^3 <= 1024, dense
    table = _table(cfg)
    pts = np.float32([[1.0, 1.0, 1.0], [0.3, -0.2, 0.1]])
    got = hg.hash_encode(torch.from_numpy(table), torch.from_numpy(pts), cfg).numpy()
    jp = jnp.asarray(pts)
    want = np.asarray(jhash.hash_encode(jnp.asarray(table), jp, _jcfg(cfg)))
    assert np.isnan(want[0]).all() and np.isfinite(got).all()
    padded = np.concatenate([table, np.zeros_like(table)])
    want = np.asarray(jhash.hash_encode(jnp.asarray(padded), jp, _jcfg(cfg)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_brick_encode_chunked_matches_direct(monkeypatch):
    """The chunked call (3 calls of 32 points, the last ragged) gives the
    unchunked one's bits, and launches gather_rows once per call on the
    card (here: the plain version, counted by calls of the fetch)."""
    cfg = ModelConfig(arch="hashgrid", hash_levels=2, hash_table_log2=13, hash_base_res=4,
                      hash_max_res=16, hash_aabb=1.0, hash_brick=True)
    table, pts = torch.from_numpy(_table(cfg)), torch.from_numpy(_points(cfg, 70))
    direct = hg.brick_encode(table, pts, cfg)
    calls = []
    real = hg._BrickFetch.apply
    monkeypatch.setattr(hg._BrickFetch, "apply", lambda *a: calls.append(a[1].shape[0]) or real(*a))
    monkeypatch.setattr(hg, "_BRICK_CHUNK", 32)
    chunked = hg.brick_encode(table, pts, cfg)
    assert torch.equal(chunked, direct)
    assert calls == [32 * 2, 32 * 2, 6 * 2]  # rows: points x levels


@pytest.mark.parametrize("layout", ["flat", "brick"])
def test_table_gradient_matches_jax(layout):
    """d sum(enc * g) / d table through the fetch's index_add_ against
    jax.grad (jnp.take's scatter-add), at the small widths: the same
    products summed per entry in another order, within 1e-5 of the
    gradient's largest entry; entries no point touched are 0 in both."""
    cfg = _cfg(SMALL, layout)
    table, pts = _table(cfg), _points(cfg, 512)
    g = np.random.default_rng(3).normal(size=(512, cfg.hash_levels * 2)).astype(np.float32)
    want = np.asarray(jax.grad(lambda t: jnp.sum(
        _jencode(cfg)(t, jnp.asarray(pts), _jcfg(cfg)) * g))(jnp.asarray(table)))
    tt = torch.from_numpy(table).requires_grad_()
    (_encode(cfg)(tt, torch.from_numpy(pts), cfg) * torch.from_numpy(g)).sum().backward()
    scale = np.abs(want).max()
    assert scale > 1.0
    np.testing.assert_allclose(tt.grad.numpy(), want, rtol=0, atol=1e-5 * scale)
    np.testing.assert_array_equal(tt.grad.numpy() == 0, want == 0)


# ---- the field, the train step, conversion, checkpoints, init ------------

def _jax_tree(cfg, seed=0):
    """JAX-initialised hash-grid weights with the table drawn at unit scale
    (the init's 1e-4 would leave the heads all but blind to it) and the
    sigma head's bias raised, so every leaf gets a gradient."""
    tree = jax.tree.map(np.asarray, jmlp.init_nerf_params(jax.random.PRNGKey(seed), _jcfg(cfg)))
    tree["table"] = _table(cfg, seed) * np.float32(0.5)
    tree["sigma2"]["b"] = tree["sigma2"]["b"] + np.float32(0.5)
    return tree


def _field(cfg, tree):
    model = mlp.init_nerf_params(cfg)
    model.load_state_dict(params_from_numpy(tree))
    return model


@pytest.mark.parametrize("precision", ["f32", "mixed"])
@pytest.mark.parametrize("layout", ["flat", "brick"])
def test_apply_nerf_matches_jax(layout, precision):
    """sigma and rgb after their activations, from converted weights. f32:
    rtol 1e-5 / atol 1e-5 (f32 sums in another order). mixed: the heads run
    in bf16 in both packages, and a sum in another order can flip one bf16
    rounding of a hidden activation: one bf16 ulp at unit scale, 2^-8."""
    cfg = _cfg(SMALL, layout)
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


def _train_cfg(layout, precision) -> Config:
    model = dataclasses.replace(_cfg(SMALL, layout), hash_aabb=1.2)
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


# per leaf, the largest gradient difference over the leaf's largest entry,
# and the loss's relative difference: f32, sums in another order; mixed, the
# heads' bf16 rounding points, where a sum in another order can round a
# hidden activation the other way and move a bias gradient (a bf16 sum over
# the rows in both packages) by a few bf16 ulps: readings up to 3.0e-2
# (color2.b, flat) and 1.9e-5 on the loss
_GRAD_TOL = {"f32": 1e-5, "mixed": 6e-2}
_LOSS_TOL = {"f32": 1e-5, "mixed": 1e-4}


# each layout once, and each precision once: the JAX step's compile is what
# costs here
@pytest.mark.parametrize("layout,precision", [("flat", "f32"), ("brick", "mixed")])
def test_train_step_matches_jax(layout, precision):
    """The slice as a whole: one train step on converted weights, explicit
    rays, midpoint samples, the autograd path (the kernel paths do not
    take this arch in either package): the loss, every leaf's gradient
    (the table's through the fetch's scatter-add), and the weights after
    one Adam update, against the JAX package's train_step. The first Adam
    update is ~lr sign(g), so the new weights agree to a small fraction of
    lr wherever |g| >> eps, and exactly where g = 0 (untouched entries)."""
    cfg = _train_cfg(layout, precision)
    assert not step.whole_ray_supported(dataclasses.replace(cfg, use_whole_ray_train=True))
    jcfg = jconfig.Config.from_dict(cfg.to_dict())
    tree = _jax_tree(cfg.model, 7)
    jparams = jax.tree.map(jnp.asarray, tree)
    jstate = jstep.init_state(jax.random.PRNGKey(7), jcfg)
    jstate = jstate._replace(params=jparams, opt_state=jstep.make_optimizer(jcfg).init(jparams))
    o, d, gold = _batch()
    jb = jstep.Batch(*map(jnp.asarray, (o, d, gold)))
    tb = step.Batch(*map(torch.from_numpy, (o, d, gold)))

    state = step.init_state(cfg)
    state.params.load_state_dict(params_from_numpy(tree))
    (jloss, _), jgrads = jax.value_and_grad(jstep.loss_fn, has_aux=True)(
        jstate.params, jb, jax.random.PRNGKey(0), jcfg)
    loss, _ = step.loss_fn(state.params, tb, None, cfg)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=_LOSS_TOL[precision])
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
    state.params.load_state_dict(params_from_numpy(tree))
    new_j, aux_j = jstep.train_step(jstate, jb, jax.random.PRNGKey(0), jcfg)
    state, aux = step.train_step(state, tb, None, cfg)
    assert state.step == 1
    np.testing.assert_allclose(float(aux["loss"]), float(aux_j["loss"]),
                               rtol=_LOSS_TOL[precision])
    lr = cfg.train.learning_rate
    for g, w in zip(jax.tree_util.tree_leaves(params_to_numpy(state.params)),
                    jax.tree_util.tree_leaves(jax.tree.map(np.asarray, new_j.params))):
        np.testing.assert_allclose(g, w, atol=0.1 * lr)
    moved = params_to_numpy(state.params)["table"] != tree["table"]
    assert 0 < moved.sum() < moved.size  # a sparse update of the table


@pytest.mark.parametrize("layout", ["flat", "brick"])
def test_convert_round_trip_of_a_hashgrid_tree(layout):
    """JAX tree -> state dict -> JAX tree, exactly; the bare ``table`` leaf
    keeps its name and shape and comes first, as in HashGridField."""
    cfg = _cfg(SMALL, layout)
    tree = _jax_tree(cfg)
    sd = params_from_numpy(tree)
    model = _field(cfg, tree)
    assert list(sd) == list(model.state_dict())
    assert list(sd)[0] == "table" and tuple(sd["table"].shape) == hg.table_shape(cfg)
    back = params_to_numpy(model)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(tree)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("layout", ["flat", "brick"])
def test_checkpoint_round_trip_of_a_hashgrid_state(layout, tmp_path):
    """The table and its Adam moments come back: a step from the restored
    state gives the same bits as a step from the saved one."""
    cfg = _train_cfg(layout, "mixed")
    state = step.init_state(cfg)
    o, d, gold = _batch()
    batch = step.Batch(*map(torch.from_numpy, (o, d, gold)))
    state, _ = step.train_step(state, batch, None, cfg)
    path = ckpt.save(state, str(tmp_path))
    fresh = ckpt.restore(path, step.init_state(dataclasses.replace(
        cfg, train=dataclasses.replace(cfg.train, seed=3))))
    field = hg.HashGridField(cfg.model)
    assert fresh.step == 1 and ckpt.restore_weights(path, field) == 1
    for (k, a), b, c in zip(state.params.state_dict().items(), fresh.params.state_dict().values(),
                            field.state_dict().values()):
        assert torch.equal(a, b) and torch.equal(a, c), k
    table = fresh.params.table
    assert torch.equal(fresh.optimizer.state[table]["exp_avg_sq"],
                       state.optimizer.state[state.params.table]["exp_avg_sq"])
    s1, _ = step.train_step(state, batch, None, cfg)
    s2, _ = step.train_step(fresh, batch, None, cfg)
    for (k, a), (_, b) in zip(step.named_trainable(s1), step.named_trainable(s2)):
        assert torch.equal(a, b), k


@pytest.mark.parametrize("layout", ["flat", "brick"])
def test_init_is_seeded(layout):
    """The same numpy draw on every call; the table U(-1e-4, 1e-4) at the
    main widths; the heads He truncated-normal with zero biases; another
    seed or stream draws other weights; the JAX tree's parameter count."""
    cfg = _cfg(MAIN, layout)
    a, b = mlp.init_nerf_params(cfg, 0), mlp.init_nerf_params(cfg, 0)
    assert isinstance(a, hg.HashGridField)
    for (k, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(x, y), k
    table = a.table.detach()
    assert tuple(table.shape) == hg.table_shape(cfg)
    assert float(table.abs().max()) <= 1e-4 and float(table.std()) > 5e-5
    first = np.random.default_rng(0).uniform(-1e-4, 1e-4, 8).astype(np.float32)
    np.testing.assert_array_equal(table.reshape(-1)[:8].numpy(), first)
    for name in ("sigma1", "sigma2", "color1", "color2", "rgb"):
        layer = getattr(a, name)
        std = (2.0 / layer.w.shape[0]) ** 0.5
        assert float(layer.w.detach().abs().max()) <= 2.0 * std + 1e-6, name
        assert not layer.b.any(), name
    assert a.sigma1.w.shape == (32, 64) and a.color1.w.shape == (15 + 27, 64)
    for other in (mlp.init_nerf_params(cfg, 1), mlp.init_nerf_params(cfg, 0, stream=1)):
        assert not torch.equal(other.table, a.table)
    n = sum(p.numel() for p in a.parameters())
    jtree = jax.eval_shape(lambda: jmlp.init_nerf_params(jax.random.PRNGKey(0), _jcfg(cfg)))
    assert n == sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(jtree))


def test_render_chunk_matches_jax():
    """dp.default_render_chunk for both layouts: brick 32,768 rays of 128
    samples (20 per 800x800 frame), flat 4096 (157 per frame)."""
    rc = RenderConfig(num_samples=128)
    for layout, want in (("flat", 4096), ("brick", 32768)):
        mc = _cfg(MAIN, layout)
        for r in (rc, RenderConfig(num_samples=32), RenderConfig(num_samples=64,
                                                                 num_fine_samples=128)):
            assert default_render_chunk(r, False, mc) == jdp.default_render_chunk(
                jconfig.RenderConfig(**dataclasses.asdict(r)), False, _jcfg(mc))
        assert default_render_chunk(rc, False, mc) == want


def test_brick_needs_two_features():
    cfg = dataclasses.replace(SMALL, hash_features=4)
    for layout in ("flat", "brick"):
        c = _cfg(cfg, layout)
        with pytest.raises(ValueError, match="hash_features=2"):
            _encode(c)(torch.zeros(hg.table_shape(c)), torch.zeros(4, 3), c)


@pytest.mark.parametrize("layout", ["flat", "brick"])
def test_cli_ngp_preset_trains_evaluates_and_renders(layout, tmp_path, capsys):
    """`train --preset ngp` for 12 steps at 24x24 with tests/test_hashgrid.py's
    tiny flags on the CPU, then `eval` and `render` of its checkpoint; the
    brick layout is the preset's, `--hash_brick false` the flat one."""
    save = str(tmp_path / "ckpt")
    common = ["--preset", "ngp", "--dataset", "sphere", "--width", "24", "--height", "24",
              "--num_samples", "16", "--hash_levels", "4", "--hash_table_log2", "10",
              "--hash_base_res", "4", "--hash_max_res", "32", "--hash_aabb", "1.2",
              "--precision", "f32", "--save_dir", save, "--device", "cpu",
              *([] if layout == "brick" else ["--hash_brick", "false"])]
    before = _launches()
    assert cli.main(["train", *common, "--num_rays", "128", "--num_iter", "12",
                     "--save_steps", "10", "--eval_steps", "10", "--logging_steps", "100",
                     "--log_dir", str(tmp_path / "logs")]) == 0
    out = capsys.readouterr().out
    assert "iter=10, eval psnr=" in out and "done at step 12" in out
    assert ckpt.latest_checkpoint(save).endswith("-12.pt")
    blob = torch.load(ckpt.latest_checkpoint(save), weights_only=True)
    assert tuple(blob["params"]["table"].shape) == (4 * (16 if layout == "brick" else 1024),
                                                    128 if layout == "brick" else 2)
    assert cli.main(["eval", *common, "--max_views", "1"]) == 0
    assert "mean psnr over 1 test views" in capsys.readouterr().out
    assert cli.main(["render", *common, "--view", "0", "--out_dir",
                     str(tmp_path / "renders")]) == 0
    assert "psnr=" in capsys.readouterr().out
    assert (tmp_path / "renders" / "view-0.png").exists()
    assert _launches() == before  # the CPU runs the plain versions
