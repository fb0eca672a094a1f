"""The port's EMA of the weights (``--ema_decay``, slice 7) on the CPU,
against the JAX package's (``tests/test_ema.py``): Adam and the debiased
EMA over three steps from the same gradients, one net and two; the update's
coefficients; ``with_ema_params``; the checkpoint round trip, the two-net
"0"/"1" form, a template without an EMA and the warnings of a missing one;
and the CLI, whose eval and render take the EMA weights.
"""

import re
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_rs_tpu import config as jconfig
from nerf_rs_tpu.train import step as jstep
from nerf_rs_tpu_torch import cli
from nerf_rs_tpu_torch.config import (CameraConfig, Config, DataConfig, ModelConfig,
                                      RenderConfig, TrainConfig)
from nerf_rs_tpu_torch.convert import params_from_numpy, params_to_numpy
from nerf_rs_tpu_torch.train import checkpoint as ckpt
from nerf_rs_tpu_torch.train import step

torch.set_num_threads(2)

SMALL = ModelConfig(net_depth=2, net_width=16, skip_layer=1, feature_width=16,
                    view_head_width=8, pos_enc_levels=2, dir_enc_levels=1)
LR = 5e-3
# Adam's update and the EMA's in f32, the same operations in the same
# order on both sides (JAX's test_ema.py bars)
RTOL, ATOL = 1e-5, 1e-6


def _cfg(decay, fine=0) -> Config:
    return Config(camera=CameraConfig(width=8, height=8), model=SMALL,
                  render=RenderConfig(num_samples=8, num_fine_samples=fine, randomized=False),
                  train=TrainConfig(num_rays=16, learning_rate=LR, precision="f32",
                                    ema_decay=decay),
                  data=DataConfig(dataset="sphere"))


def _j(cfg):
    return jconfig.Config.from_dict(cfg.to_dict())


def _leaves(tree):
    return jax.tree_util.tree_leaves(jax.tree.map(np.asarray, tree))


def _pair(cfg):
    """The JAX state and the port's on its converted weights (the EMA
    starting from them, as both packages' init_state starts it)."""
    jstate = jstep.init_state(jax.random.PRNGKey(1), _j(cfg))
    state = step.init_state(cfg)
    state.params.load_state_dict(params_from_numpy(jax.tree.map(np.asarray, jstate.params)))
    if state.fine_params is not None:
        state.fine_params.load_state_dict(
            params_from_numpy(jax.tree.map(np.asarray, jstate.fine_params)))
        state.ema = (step.ema_copy(state.params), step.ema_copy(state.fine_params))
    else:
        state.ema = step.ema_copy(state.params)
    return jstate, state


def _ema_trees(state):
    return [params_to_numpy(net) for net in step.ema_nets(state.ema)]


@pytest.mark.parametrize("fine", [0, 8])
def test_adam_and_ema_track_jax_over_three_steps(fine):
    """Three updates from the same random gradients through JAX's
    ``apply_grads`` (optax Adam, the debiased EMA) and the port's: weights
    and EMA within RTOL/ATOL; after the first update the EMA is the
    weights (debiased: no initial weights left in it); with a fine field
    the EMA is a pair covering both nets."""
    cfg = _cfg(0.9, fine)
    jcfg = _j(cfg)
    jstate, state = _pair(cfg)
    assert isinstance(state.ema, tuple) == bool(fine)
    assert isinstance(jstate.ema, tuple) == bool(fine)
    opt = jstep.make_optimizer(jcfg)
    rng = np.random.default_rng(0)
    for it in range(3):
        trainable = jstep._trainable(jstate, jcfg)
        grads = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32), trainable)
        jstate = jstep.apply_grads(jstate, trainable, jax.tree.map(jnp.asarray, grads), opt, jcfg)
        nets = (grads,) if not fine else grads
        named = {}
        for prefix, g in zip(("", "fine."), nets):
            named.update({prefix + k: v for k, v in params_from_numpy(g).items()})
        step.apply_grads(state, named, cfg)
        want_ema = [jstate.ema] if not fine else list(jstate.ema)
        for got, want in zip(_ema_trees(state), want_ema):
            for g, w in zip(_leaves(got), _leaves(want)):
                np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
        if it == 0:  # debiased: the first update's EMA is the weights
            for g, w in zip(_leaves(_ema_trees(state)[0]), _leaves(params_to_numpy(state.params))):
                np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
    for g, w in zip(_leaves(params_to_numpy(state.params)), _leaves(jstate.params)):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
    assert state.step == int(jstate.step) == 3


def test_ema_coefficients_are_the_jax_f32_ones():
    """(alpha, beta) of e <- alpha e + beta p against JAX's f32 arithmetic
    on the device, d (1 - d^t) / (1 - d^(t+1)) and (1 - d) / (1 - d^(t+1)),
    within 4 f32 ulp (a power's last bit may round apart, and the port
    divides once where JAX divides the sum); the first update keeps no old
    EMA (alpha = 0)."""
    eps = np.finfo(np.float32).eps
    for decay in (0.9, 0.995, 0.999):
        d = jnp.float32(decay)
        for t in (0, 1, 2, 7, 300, 29_999):
            tp = jnp.float32(t)
            c = 1.0 - d ** (tp + 1.0)
            want = (float(d * (1.0 - d ** tp) / c), float((1.0 - d) / c))
            got = step.ema_coefficients(decay, t)
            np.testing.assert_allclose(got, want, rtol=4 * eps, atol=0)
    assert step.ema_coefficients(0.9, 0)[0] == 0.0


def test_with_ema_params_swaps_and_is_off_by_default():
    cfg = _cfg(0.0)
    state = step.init_state(cfg)
    assert state.ema is None and step.with_ema_params(state) is state
    batch = step.Batch(torch.zeros(16, 3), torch.ones(16, 3), torch.full((16, 3), 0.5))
    state, _ = step.train_step(state, batch, None, cfg)
    assert state.ema is None
    cfg = _cfg(0.5, fine=8)
    state = step.init_state(cfg)
    for _ in range(3):
        state, _ = step.train_step(state, batch, None, cfg)
    ev = step.with_ema_params(state)
    assert ev.params is state.ema[0] and ev.fine_params is state.ema[1]
    assert ev.step == state.step and ev.grid is state.grid
    raw, avg = state.params.trunk[0].w, ev.params.trunk[0].w
    assert not torch.allclose(raw, avg) and not avg.requires_grad


def test_ema_checkpoint_round_trip(tmp_path):
    """A full restore keeps the EMA (one net: the field's state dict; two:
    the "0"/"1" form); ``load_ema`` gives it to a run configured without
    one; a file without an EMA restores into an EMA run with a warning
    (its EMA starts from the run's initial weights, as JAX backfills it),
    and an EMA file into a run without one warns that it is dropped."""
    batch = step.Batch(torch.zeros(16, 3), torch.ones(16, 3), torch.full((16, 3), 0.5))
    for fine in (0, 8):
        cfg = _cfg(0.9, fine)
        state = step.init_state(cfg)
        state, _ = step.train_step(state, batch, None, cfg)
        path = ckpt.save(state, str(tmp_path / f"f{fine}"))
        blob = torch.load(path, weights_only=True)
        assert (set(blob["ema"]) == {"0", "1"}) == bool(fine)
        full = ckpt.restore(path, step.init_state(cfg))
        for a, b in zip(step.ema_nets(full.ema), step.ema_nets(state.ema)):
            for x, y in zip(a.parameters(), b.parameters()):
                assert torch.equal(x, y)
        plain = step.init_state(_cfg(0.0, fine))  # eval side: no --ema_decay
        ema = ckpt.load_ema(path, plain.params, plain.fine_params)
        for a, b in zip(step.ema_nets(ema), step.ema_nets(state.ema)):
            for x, y in zip(a.parameters(), b.parameters()):
                assert torch.equal(x, y)
        with pytest.warns(UserWarning, match="dropped"):
            ckpt.restore(path, step.init_state(_cfg(0.0, fine)))
    pre = ckpt.save(step.init_state(_cfg(0.0)), str(tmp_path / "pre"))
    assert ckpt.load_ema(pre, step.init_state(_cfg(0.0)).params) is None
    fresh = step.init_state(_cfg(0.9))
    init = [p.clone() for p in fresh.ema.parameters()]
    with pytest.warns(UserWarning, match="no EMA"):
        ckpt.restore(pre, fresh)
    assert all(torch.equal(a, b) for a, b in zip(fresh.ema.parameters(), init))
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # a plain file into a plain run: silent
        ckpt.restore(pre, step.init_state(_cfg(0.0)))


def test_cli_train_with_ema_then_eval_and_render_use_it(tmp_path, capsys):
    """``train --ema_decay`` then ``eval`` and ``render``: both announce the
    EMA weights, and eval's PSNR is the one the EMA weights render."""
    from nerf_rs_tpu_torch.data.factory import make_dataset
    from nerf_rs_tpu_torch.ops import render as render_ops
    from nerf_rs_tpu_torch.render import render_frame

    common = ["--dataset", "sphere", "--width", "8", "--height", "8", "--num_samples", "8",
              "--save_dir", str(tmp_path / "ck"), "--device", "cpu"]
    assert cli.main(["train", *common, "--num_rays", "32", "--num_iter", "6", "--eval_steps",
                     "100", "--learning_rate", "5e-3", "--ema_decay", "0.9",
                     "--log_dir", str(tmp_path / "logs")]) == 0
    capsys.readouterr()
    assert cli.main(["eval", *common, "--max_views", "1"]) == 0
    out = capsys.readouterr().out
    assert "using EMA weights for inference" in out
    psnr = float(re.search(r"view   0: psnr (\S+)", out).group(1))
    argv = ["eval", *common]
    args = cli.build_parser().parse_args(argv)
    args._explicit = cli.explicit_dests(argv)
    cfg = cli.config_from_args(args)
    ds = make_dataset(cfg)
    ema = ckpt.load_ema(ckpt.latest_checkpoint(cfg.save_dir), step.init_state(cfg).params)
    rgb, _, _ = render_frame(cfg, ema, *ds.view_rays(0))
    assert f"{float(render_ops.psnr(rgb, ds.view_gold(0))):.2f}" == f"{psnr:.2f}"
    assert cli.main(["render", *common, "--view", "0", "--out_dir", str(tmp_path / "r")]) == 0
    assert "using EMA weights for inference" in capsys.readouterr().out
