"""The PyTorch port's occupancy grid and the record preset on the CPU
(ROADMAP slice 4, items 16-17), mirroring tests/test_occupancy.py: the
bin lookup's geometry (and its outside-the-AABB case), ``occupancy_ts``
and ``occupancy_edges`` against the JAX functions on a given grid in both
sample spacings, a fresh grid's uniform draw, ``update_grid`` on JAX's
jitter, a train step with a grid (autograd and the train kernel's plain
version) against the JAX step, checkpoints with and without a grid, the
loop's update cadence and its resume, a grid-guided render against the
direct one, IPE with occupancy and a union fine pass, and the record
preset: its resolved config against the JAX CLI's, one
``whole_ray_grads`` of its settings against the JAX function, and six
Adam steps of its settings against the JAX steps.

Small widths (depth 3, width 32), a few rays, inputs from numpy seeds;
samples at bin midpoints (``randomized=False``) wherever both packages
draw, since torch and threefry streams differ.
"""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_rs_tpu import cli as jcli
from nerf_rs_tpu import config as jconfig
from nerf_rs_tpu.models import mlp as jmlp
from nerf_rs_tpu.ops import occupancy as jocc
from nerf_rs_tpu.ops import render as jrender
from nerf_rs_tpu.train import step as jstep
from nerf_rs_tpu_torch import cli
from nerf_rs_tpu_torch.config import (CameraConfig, Config, DataConfig, ModelConfig,
                                      RenderConfig, TrainConfig)
from nerf_rs_tpu_torch.convert import params_from_numpy, params_to_numpy
from nerf_rs_tpu_torch.models.mlp import NerfMLP
from nerf_rs_tpu_torch.ops import occupancy
from nerf_rs_tpu_torch.ops import render as render_ops
from nerf_rs_tpu_torch.ops import sampling
from nerf_rs_tpu_torch.render import make_render
from nerf_rs_tpu_torch.train import checkpoint as ckpt
from nerf_rs_tpu_torch.train import loop, step

torch.set_num_threads(2)

CAM = CameraConfig(width=16, height=16)  # near 0.05, far 2.0
MODEL = ModelConfig(net_depth=3, net_width=32, skip_layer=2, feature_width=32,
                    view_head_width=16, pos_enc_levels=3, dir_enc_levels=1)


def _j(cfg):
    """The JAX package's dataclass of the same values."""
    return getattr(jconfig, type(cfg).__name__)(**dataclasses.asdict(cfg))


def _centre_grid(res=16, aabb=1.0, radius=0.3):
    """An occupied ball of ``radius`` around the origin (numpy)."""
    c = np.linspace(-aabb, aabb, res, endpoint=False) + aabb / res
    gx, gy, gz = np.meshgrid(c, c, c, indexing="ij")
    return (np.sqrt(gx ** 2 + gy ** 2 + gz ** 2) < radius).astype(np.float32)


def _rays(n, seed=0):
    """Rays from the canonical camera's distance towards the scene centre,
    spread a little."""
    rng = np.random.default_rng(seed)
    o = (rng.normal(size=(n, 3)) * 0.05 + [0.0, 0.0, -1.0]).astype(np.float32)
    d = (rng.normal(size=(n, 3)) * 0.15 + [0.0, 0.0, 1.0]).astype(np.float32)
    return o, d


def _t(*xs):
    return tuple(torch.from_numpy(x) for x in xs)


def test_bin_occupancy_matches_jax_and_its_geometry():
    """``_bin_occupancy`` (ops/occupancy.py:78): the same cell reads as
    the JAX function's (floor of (x + aabb) res / 2 aabb, in the same f32
    order), and on axis rays through a central ball the bins near t = 1
    are occupied and the rest empty."""
    grid = _centre_grid()
    o, d = _rays(64)
    mids = np.linspace(0.1, 1.9, 32).astype(np.float32)
    got = occupancy._bin_occupancy(*_t(o, d, mids, grid), 1.0).numpy()
    want = np.asarray(jocc._bin_occupancy(*map(jnp.asarray, (o, d, mids, grid)), 1.0))
    np.testing.assert_array_equal(got, want)
    axis_o = np.tile(np.float32([[0.0, 0.0, -1.0]]), (4, 1))
    axis_d = np.tile(np.float32([[0.0, 0.0, 1.0]]), (4, 1))
    occ = occupancy._bin_occupancy(*_t(axis_o, axis_d, mids, grid), 1.0)[0].numpy()
    assert (occ[np.abs(mids - 1.0) < 0.25] > 0).all()
    assert (occ[np.abs(mids - 1.0) > 0.4] == 0).all()


def test_bin_occupancy_outside_the_aabb_is_empty():
    grid = np.ones((8, 8, 8), np.float32)
    o = np.tile(np.float32([[0.0, 0.0, -5.0]]), (2, 1))
    d = np.tile(np.float32([[0.0, 0.0, -1.0]]), (2, 1))
    mids = np.linspace(0.1, 1.9, 8).astype(np.float32)
    assert float(occupancy._bin_occupancy(*_t(o, d, mids, grid), 1.0).max()) == 0.0
    want = jocc._bin_occupancy(*map(jnp.asarray, (o, d, mids, grid)), 1.0)
    assert float(jnp.max(want)) == 0.0


@pytest.mark.parametrize("space", ["linear", "disparity"])
def test_occupancy_ts_and_edges_match_jax(space):
    """``occupancy_ts`` (:106) and ``occupancy_edges`` (:138) through
    ``_occ_pdf`` (:165, bins even in t or in 1/t) and the port's
    ``sample_pdf``, on a given grid at the bin midpoints, against the JAX
    functions: within 1e-5 + 1e-5 relative (f32 inverse CDFs on both
    sides; the two linspaces of the bins can differ by an ulp, which the
    widest disparity bin, ~0.3 at the far plane, carries to a draw there).
    On axis rays most of the budget lands in the occupied ball; the
    uniform floor keeps some outside it."""
    cam = CAM if space == "linear" else dataclasses.replace(CAM, near=0.3)
    rc = RenderConfig(num_samples=32, occ_res=16, occ_bins=64, sampling_space=space)
    grid = _centre_grid()
    o, d = _rays(48, seed=1)
    args = (*map(jnp.asarray, (o, d, grid)),)
    for fn, jfn, s in ((occupancy.occupancy_ts, jocc.occupancy_ts, 32),
                       (occupancy.occupancy_edges, jocc.occupancy_edges, 33)):
        got = fn(*_t(o, d, grid), 32, cam, rc, randomized=False).numpy()
        want = np.asarray(jfn(jax.random.PRNGKey(0), *args, 32, _j(cam), _j(rc),
                              randomized=False))
        assert got.shape == (48, s)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        assert (np.diff(got, axis=-1) >= 0).all()
    axis_o = np.tile(np.float32([[0.0, 0.0, -1.0]]), (64, 1))
    axis_d = np.tile(np.float32([[0.0, 0.0, 1.0]]), (64, 1))
    ts = occupancy.occupancy_ts(*_t(axis_o, axis_d, grid), 32, cam, rc, randomized=True,
                                generator=torch.Generator().manual_seed(0)).numpy()
    assert float(np.mean(np.abs(ts - 1.0) < 0.35)) > 1.0 - rc.occ_uniform_frac - 0.08
    assert float(np.mean(np.abs(ts - 1.0) > 0.5)) > 0.05


def test_a_fresh_grid_draws_uniformly():
    """``init_grid`` (:36) is empty, so the PDF is the uniform floor
    alone: the deterministic draws are evenly spaced over [near, far],
    and jittered draws cover the span."""
    rc = RenderConfig(num_samples=64, occ_res=8, occ_bins=32)
    grid = occupancy.init_grid(8)
    assert grid.shape == (8, 8, 8) and not bool(grid.any())
    np.testing.assert_array_equal(np.asarray(jocc.init_grid(8)), grid.numpy())
    o, d = _t(*_rays(128, seed=2))
    ts = occupancy.occupancy_ts(o, d, grid, 64, CAM, rc, randomized=True,
                                generator=torch.Generator().manual_seed(1))
    assert abs(float(ts.mean()) - (CAM.near + CAM.far) / 2) < 0.1
    assert float(ts.min()) < 0.2 and float(ts.max()) > 1.8
    mid = occupancy.occupancy_ts(o, d, grid, 64, CAM, rc, randomized=False)
    # the inverse CDF's deterministic draws, evenly spaced in [0, 1 - 1e-6]
    np.testing.assert_allclose(np.diff(mid.numpy(), axis=-1),
                               (CAM.far - CAM.near) * (1 - 1e-6) / 63, rtol=1e-3)


def _model(cfg, seed=0, bias=0.0):
    params = jmlp.init_nerf_params(jax.random.PRNGKey(seed), _j(cfg))
    params["sigma"]["b"] = params["sigma"]["b"] + bias
    model = NerfMLP(cfg)
    model.load_state_dict(params_from_numpy(jax.tree.map(np.asarray, params)))
    return params, model


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_update_grid_matches_jax_on_its_jitter(dtype):
    """``update_grid`` (:44): EMA-max of sigma at the jittered cell
    centres, with JAX's jitter passed in, against the JAX function: f32
    within 1e-5 of the grid's scale (the same field at f32), bf16 within
    2e-2 (the two packages round the field's activations to bf16 at the
    same points, and one flip moves sigma by ~1%). A dense field marks
    every cell; a transparent one decays the grid by ``decay``."""
    dt, jdt = {"f32": (None, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}[dtype]
    params, model = _model(MODEL, bias=2.0)
    grid = np.random.default_rng(3).uniform(0, 3, (8, 8, 8)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    cell = 2.0 * 1.0 / 8
    jitter = np.asarray(jax.random.uniform(key, (8 ** 3, 3), minval=-cell / 2, maxval=cell / 2))
    want = np.asarray(jocc.update_grid(jnp.asarray(grid), params, key, _j(MODEL), 1.0, 0.9, jdt))
    got = occupancy.update_grid(torch.from_numpy(grid), model, MODEL, 1.0, 0.9, dt,
                                jitter=torch.from_numpy(jitter)).numpy()
    tol = 1e-5 if dt is None else 2e-2
    np.testing.assert_allclose(got, want, atol=tol * np.abs(want).max(), rtol=tol)
    assert got.min() > 0.0
    _, dark = _model(MODEL, bias=-48.0)
    decayed = occupancy.update_grid(torch.from_numpy(got), dark, MODEL, 1.0, 0.5, dt,
                                    generator=torch.Generator().manual_seed(5))
    np.testing.assert_allclose(decayed.numpy(), got * 0.5, rtol=1e-6)


def _occ_cfg(kernel=False, precision="f32", ipe=False, **render):
    model = dataclasses.replace(MODEL, ipe=ipe, sigma_activation="softplus" if ipe else "relu")
    return Config(camera=CAM, model=model,
                  render=RenderConfig(**{**dict(num_samples=16, occ_res=8, occ_bins=32,
                                                randomized=False), **render}),
                  train=TrainConfig(num_rays=8, precision=precision, learning_rate=1e-2,
                                    whole_ray_block=8),
                  data=DataConfig(dataset="sphere"), use_whole_ray_train=kernel)


def _states(cfg, seed=11, grid=None):
    jcfg = jconfig.Config.from_dict(cfg.to_dict())
    jstate = jstep.init_state(jax.random.PRNGKey(seed), jcfg)
    params = jstate.params
    params["sigma"]["b"] = params["sigma"]["b"] + 0.3
    grid = _centre_grid(cfg.render.occ_res, cfg.render.occ_aabb, 0.4) if grid is None else grid
    jstate = jstate._replace(params=params, grid=jnp.asarray(grid))
    state = step.init_state(cfg)
    state.params.load_state_dict(params_from_numpy(jax.tree.map(np.asarray, params)))
    state.grid.copy_(torch.from_numpy(grid))
    return jcfg, jstate, state


def _batch(n=8, seed=12):
    o, d = _rays(n, seed)
    gold = np.random.default_rng(seed).uniform(size=(n, 3)).astype(np.float32)
    return o, d, gold


@pytest.mark.parametrize("kernel", [False, True])
def test_train_step_with_a_grid_matches_jax(kernel):
    """One Adam step with a grid (``TrainState.grid``; train/step.py:486-518):
    the grid-guided samples through autograd of the eager loss at f32, or
    through the train kernel's plain version, against the JAX step on
    converted weights and the same grid (losses rtol 1e-3; the first Adam
    update is ~lr sign(g), so the weights agree to 0.1 lr). The grid is
    the state's and the step leaves it alone."""
    cfg = _occ_cfg(kernel=kernel, precision="mixed" if kernel else "f32")
    jcfg, jstate, state = _states(cfg)
    o, d, gold = _batch()
    new_j, aux_j = jstep.train_step(jstate, jstep.Batch(*map(jnp.asarray, (o, d, gold))),
                                    jax.random.PRNGKey(0), jcfg)
    grid0 = state.grid.clone()
    state, aux = step.train_step(state, step.Batch(*_t(o, d, gold)), None, cfg)
    np.testing.assert_allclose(float(aux["loss"]), float(aux_j["loss"]), rtol=1e-3)
    for g, w in zip(jax.tree_util.tree_leaves(params_to_numpy(state.params)),
                    jax.tree_util.tree_leaves(jax.tree.map(np.asarray, new_j.params))):
        np.testing.assert_allclose(g, w, atol=0.1 * cfg.train.learning_rate)
    assert torch.equal(state.grid, grid0)
    # the grid moved the samples: the same step without it differs
    _, _, bare = _states(cfg)
    bare.grid = None
    _, aux_u = step.train_step(bare, step.Batch(*_t(o, d, gold)), None, cfg)
    assert abs(float(aux_u["loss"]) - float(aux["loss"])) > 1e-6


def test_checkpoints_keep_the_grid_and_name_a_missing_one(tmp_path):
    """``save``/``restore`` carry the grid (nerf_rs_tpu/train/checkpoint.py
    :76-151); a file without a grid for a run with one, or with one for a
    run without, warns instead of dropping to uniform sampling in silence,
    and ``restore_weights`` (eval, render) reads the grid too."""
    cfg = _occ_cfg()
    state = step.init_state(cfg)
    state.grid += 0.25
    state.step = 7
    path = ckpt.save(state, str(tmp_path / "a"))
    fresh = step.init_state(cfg)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        ckpt.restore(path, fresh)
        grid = occupancy.init_grid(8)
        assert ckpt.restore_weights(path, step.init_state(cfg).params, None, grid) == 7
    assert torch.equal(fresh.grid, state.grid) and torch.equal(grid, state.grid)
    bare = dataclasses.replace(cfg, render=dataclasses.replace(cfg.render, occ_res=0))
    with pytest.warns(UserWarning, match="carries an occupancy grid"):
        ckpt.restore(path, step.init_state(bare))
    no_grid = ckpt.save(step.init_state(bare), str(tmp_path / "b"))
    with pytest.warns(UserWarning, match="has no occupancy grid"):
        ckpt.restore_weights(no_grid, step.init_state(cfg).params, None, occupancy.init_grid(8))
    with pytest.raises(ValueError, match="occ_res"):
        ckpt.restore(path, step.init_state(dataclasses.replace(
            cfg, render=dataclasses.replace(cfg.render, occ_res=4))))


def test_loop_updates_the_grid_every_occ_update_steps_and_resumes(tmp_path, monkeypatch):
    """``train`` updates the grid after every step ``it`` with ``it %
    occ_update_steps == 0`` (nerf_rs_tpu/train/loop.py:477-490): at 0, 5
    and 10 of 12 steps here, and the grid is non-zero after the first.
    The update's draw is its own stream of (seed, step): a run stopped at
    step 6 and resumed to 12 ends with the unbroken run's grid and
    weights, bit for bit."""
    cfg = _occ_cfg(randomized=True, occ_update_steps=5)
    cfg = dataclasses.replace(cfg, eval_on_train=False, log_dir=str(tmp_path / "logs"),
                              train=dataclasses.replace(cfg.train, num_iter=12,
                                                        logging_steps=1000, save_steps=1000))
    seen = []
    real = loop.update_occupancy

    def spy(state, c, it):
        seen.append(it)
        return real(state, c, it)

    monkeypatch.setattr(loop, "update_occupancy", spy)
    whole = loop.train(dataclasses.replace(cfg, save_dir=str(tmp_path / "whole")),
                       device="cpu")
    assert seen == [0, 5, 10]
    assert whole.grid.shape == (8, 8, 8) and float(whole.grid.max()) > 0
    split = dataclasses.replace(cfg, save_dir=str(tmp_path / "split"))
    loop.train(dataclasses.replace(split, train=dataclasses.replace(cfg.train, num_iter=6)),
               device="cpu")
    resumed = loop.train(split, device="cpu")
    assert resumed.step == 12
    assert torch.equal(resumed.grid, whole.grid)
    for a, b in zip(resumed.params.parameters(), whole.params.parameters()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("fused", [False, True])
def test_grid_guided_render_matches_the_direct_call(fused):
    """``make_render`` carries the grid to every chunk's draws
    (nerf_rs_tpu/train/loop.py:90-93): a frame in chunks equals one
    ``render_rays(grid=...)`` call (eager field, or the render kernel's
    plain version), and differs from the uniform render; the direct call
    matches the JAX function (rgb 3e-3)."""
    cfg = dataclasses.replace(_occ_cfg(), use_fused_kernel=fused)
    jcfg, jstate, state = _states(cfg)
    o, d = _rays(40, seed=5)
    rgb, depth, acc = make_render(cfg, chunk=16)(state.params, *_t(o, d), grid=state.grid)
    with torch.no_grad():  # the f32 eager field, as make_render runs it at precision f32
        direct, _ = render_ops.render_rays(state.params, *_t(o, d), cfg.model, cfg.render, CAM,
                                           randomized=False, use_fused=fused, grid=state.grid)
    np.testing.assert_allclose(rgb.numpy(), direct.rgb.numpy(), atol=1e-6)
    uniform, _, _ = make_render(cfg, chunk=16)(state.params, *_t(o, d))
    assert float((uniform - rgb).abs().max()) > 1e-4
    want, _ = jrender.render_rays(jstate.params, *map(jnp.asarray, (o, d)), jax.random.PRNGKey(0),
                                  jcfg.model, jcfg.render, jcfg.camera, randomized=False,
                                  use_fused=fused, grid=jstate.grid)
    np.testing.assert_allclose(rgb.numpy(), np.asarray(want.rgb), atol=3e-3)


@pytest.mark.parametrize("fused", [False, True])
def test_ipe_with_occupancy_and_a_union_fine_pass(fused):
    """IPE on occupancy-guided coarse edges with a union fine pass
    (ops/render.py:300-304, :407-411): 16 coarse intervals, and a fine
    pass over the merged 16 + 8 + 1 edges, every coarse edge among them;
    the passes match the JAX function's (rgb and weights 3e-3, ts 1e-4)."""
    cfg = _occ_cfg(ipe=True, num_fine_samples=8, share_network=True, fine_mode="union")
    jcfg, jstate, state = _states(cfg)
    o, d = _rays(8, seed=6)
    with torch.no_grad():
        coarse, fine = render_ops.render_rays(state.params, *_t(o, d), cfg.model, cfg.render,
                                              CAM, randomized=False, use_fused=fused,
                                              grid=state.grid)
    want = jrender.render_rays(jstate.params, *map(jnp.asarray, (o, d)), jax.random.PRNGKey(0),
                               jcfg.model, jcfg.render, jcfg.camera, randomized=False,
                               use_fused=fused, grid=jstate.grid)
    assert coarse.weights.shape == (8, 16) and fine.weights.shape == (8, 16 + 8 + 1)
    for g, w in zip((coarse, fine), want):
        for name, tol in (("rgb", 3e-3), ("weights", 3e-3), ("ts", 1e-4)):
            np.testing.assert_allclose(getattr(g, name).numpy(), np.asarray(getattr(w, name)),
                                       atol=tol, err_msg=name)
    c_edges = torch.cat([coarse.ts - coarse.deltas / 2, (coarse.ts + coarse.deltas / 2)[:, -1:]],
                        -1)
    f_edges = torch.cat([fine.ts - fine.deltas / 2, (fine.ts + fine.deltas / 2)[:, -1:]], -1)
    gap = (c_edges[:, :, None] - f_edges[:, None, :]).abs().min(dim=-1).values
    assert float(gap.max()) < 1e-5


def test_occupancy_config_checks():
    """The port's config keeps the JAX checks with their messages:
    ``occ_update_steps`` >= 1 with a grid (RenderConfig), and no proposal
    net with a grid (Config; also tests/test_torch_config.py)."""
    for kw in (dict(render=dict(occ_res=8, occ_update_steps=0)),
               dict(render=dict(occ_res=8), proposal=dict(enabled=True))):
        errs = []
        for mod in (__import__("nerf_rs_tpu_torch.config", fromlist=["Config"]), jconfig):
            with pytest.raises(ValueError) as e:
                mod.Config(**{k: getattr(mod, f"{k.capitalize()}Config")(**v)
                              for k, v in kw.items()})
            errs.append(str(e.value))
        assert errs[0] == errs[1]
    assert RenderConfig(occ_res=0, occ_update_steps=0).occ_update_steps == 0


def _resolve(mod, argv):
    args = mod.build_parser().parse_args(argv)
    args._explicit = mod.explicit_dests(argv)
    return mod.config_from_args(args)


@pytest.mark.parametrize("extra", [[], ["--occ_res", "16", "--num_samples", "32"]])
def test_record_preset_resolves_as_the_jax_cli(extra):
    """``--preset record`` takes exactly the JAX preset's values
    (nerf_rs_tpu/cli.py:384-388: IPE, one shared field, union 64 + 128,
    softplus, white background, the train kernel, occ_res 32, occ_aabb 1.6,
    occ_uniform_frac 0.10), and explicit flags beat it."""
    argv = ["train", "--preset", "record", "--dataset", "sphere", *extra]
    mine, theirs = _resolve(cli, argv).to_dict(), _resolve(jcli, argv).to_dict()
    for section in ("camera", "model", "render", "proposal"):
        assert {k: v for k, v in theirs[section].items() if k in mine[section]} == mine[section]
    assert mine["use_whole_ray_train"] is theirs["use_whole_ray_train"] is True
    assert mine["train"]["num_rays"] == theirs["train"]["num_rays"]
    r = mine["render"]
    assert (r["occ_res"], r["occ_aabb"], r["occ_uniform_frac"]) == (
        (16 if extra else 32), 1.6, 0.10)


def test_record_step_through_the_kernel_chain_matches_jax():
    """One ``whole_ray_grads`` of the record preset's settings (IPE,
    shared field, occupancy-guided coarse edges, union fine pass) on the
    train kernel's plain version, against the JAX function on converted
    weights, the same grid and midpoint draws: losses within 4e-3, every
    leaf within 5e-2 of its largest entry (tests/test_fused_train.py's
    bars). The fine call runs 16 + 8 + 1 = 25 intervals, the record
    preset's union shape at this width."""
    cfg = _occ_cfg(kernel=True, precision="mixed", ipe=True, num_fine_samples=8,
                   share_network=True, fine_mode="union", white_background=True,
                   occ_aabb=1.6, occ_uniform_frac=0.10)
    jcfg, jstate, state = _states(cfg, grid=_centre_grid(8, 1.6, 0.5))
    o, d, gold = _batch()
    grads_j, aux_j = jstep.whole_ray_grads(jstate.params,
                                           jstep.Batch(*map(jnp.asarray, (o, d, gold))),
                                           jax.random.PRNGKey(0), jcfg, grid=jstate.grid)
    grads, aux = step.whole_ray_grads(state.params, step.Batch(*_t(o, d, gold)), None, cfg,
                                      grid=state.grid)
    for key in ("loss", "loss_coarse", "loss_fine"):
        assert abs(float(aux[key]) - float(aux_j[key])) < 4e-3, key
    for g, w in zip(jax.tree_util.tree_leaves(params_to_numpy(grads)),
                    jax.tree_util.tree_leaves(jax.tree.map(np.asarray, grads_j))):
        np.testing.assert_allclose(g, w, atol=5e-2 * max(np.abs(w).max(), 1e-6))
    edges = occupancy.occupancy_edges(*_t(o, d), state.grid, 16, CAM, cfg.render,
                                      randomized=False)
    uniform = sampling.stratified_ts(8, 17, CAM.near, CAM.far, randomized=False)
    assert float((edges - uniform).abs().max()) > 1e-3  # the grid moved the edges


def test_record_steps_track_the_jax_steps():
    """Six Adam steps of the record preset's settings (IPE, one shared
    field, a union fine pass, the occupancy grid, white background,
    softplus) through autograd at f32, on converted weights, the same grid
    and the same batches at midpoint samples, against the JAX package's
    ``train_step``: every step's loss within 2e-3 relative, and the weights
    after the last step within 0.5 lr of each other (each update is ~lr
    sign(g) per weight, so a sign flip of a near-zero gradient element moves
    a weight by up to 2 lr; none did here)."""
    cfg = _occ_cfg(ipe=True, num_fine_samples=8, share_network=True, fine_mode="union",
                   white_background=True, occ_aabb=1.6, occ_uniform_frac=0.10)
    jcfg, jstate, state = _states(cfg, grid=_centre_grid(8, 1.6, 0.5))
    for it in range(6):
        o, d, gold = _batch(seed=20 + it)
        jstate, aux_j = jstep.train_step(jstate, jstep.Batch(*map(jnp.asarray, (o, d, gold))),
                                         jax.random.PRNGKey(it), jcfg)
        state, aux = step.train_step(state, step.Batch(*_t(o, d, gold)), None, cfg)
        np.testing.assert_allclose(float(aux["loss"]), float(aux_j["loss"]), rtol=2e-3,
                                   err_msg=f"step {it}")
    for g, w in zip(jax.tree_util.tree_leaves(params_to_numpy(state.params)),
                    jax.tree_util.tree_leaves(jax.tree.map(np.asarray, jstate.params))):
        np.testing.assert_allclose(g, w, atol=0.5 * cfg.train.learning_rate)
