"""The PyTorch port's training slice on the CPU: one train step against
the JAX package's ``train_step`` on converted weights (kernel path, with
the JAX kernel in interpret mode, and autograd path), Adam and its decay
schedule against optax, the per-ray sampler, checkpoint resume, and the
port's ``cli train`` / ``cli eval`` with their presets.
"""

import dataclasses
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import bench
from nerf_rs_tpu import cli as jcli
from nerf_rs_tpu import config as jconfig
from nerf_rs_tpu.data import factory as jfactory
from nerf_rs_tpu.train import step as jstep
from nerf_rs_tpu_torch import cli
from nerf_rs_tpu_torch.config import (CameraConfig, Config, DataConfig, ModelConfig,
                                      RenderConfig, TrainConfig)
from nerf_rs_tpu_torch.convert import params_from_numpy, params_to_numpy
from nerf_rs_tpu_torch.data.factory import make_dataset
from nerf_rs_tpu_torch.kernels import fused_train
from nerf_rs_tpu_torch.train import checkpoint as ckpt
from nerf_rs_tpu_torch.train import step

torch.set_num_threads(2)

MODEL = ModelConfig(net_depth=4, net_width=32, skip_layer=2, feature_width=32,
                    view_head_width=16, pos_enc_levels=3, dir_enc_levels=1)
N, S, LR = 16, 8, 1e-3


def _cfg(kernel: bool, precision="mixed", **train) -> Config:
    return Config(
        camera=CameraConfig(width=8, height=8),
        model=MODEL,
        render=RenderConfig(num_samples=S, randomized=False),
        train=TrainConfig(num_rays=N, learning_rate=LR, precision=precision,
                          whole_ray_block=8, **train),
        data=DataConfig(dataset="sphere"),
        use_whole_ray_train=kernel,
    )


def _j(cfg: Config) -> "jconfig.Config":
    """The JAX package's config with the port's values."""
    return jconfig.Config.from_dict(cfg.to_dict())


def _rays(seed=0):
    rng = np.random.default_rng(seed)
    o = (rng.normal(size=(N, 3)) * 0.2).astype(np.float32)
    d = rng.normal(size=(N, 3)).astype(np.float32)
    gold = rng.uniform(size=(N, 3)).astype(np.float32)
    return o, d, gold


def _converted_state(cfg, seed=2):
    jstate = jstep.init_state(jax.random.PRNGKey(seed), _j(cfg))
    state = step.init_state(cfg)
    state.params.load_state_dict(params_from_numpy(jax.tree.map(np.asarray, jstate.params)))
    return jstate, state


@pytest.mark.parametrize("kernel", [True, False])
def test_train_step_matches_jax(kernel):
    """One step from the same weights and rays (midpoint samples). Kernel
    path: both sides' kernels agree to f32 rounding. Autograd path at f32
    precision (bf16 rounds at other points in the two autodiffs). The
    first Adam update is ~lr * sign(g) wherever |g| >> eps, so the new
    weights agree to a small fraction of lr; a flipped sign of a
    vanishing gradient would show as a 2 lr jump."""
    cfg = _cfg(kernel, precision="mixed" if kernel else "f32")
    assert step.whole_ray_supported(cfg) == kernel
    jstate, state = _converted_state(cfg)
    o, d, gold = _rays()
    new_j, aux_j = jstep.train_step(jstate, jstep.Batch(*map(jnp.asarray, (o, d, gold))),
                                    jax.random.PRNGKey(0), _j(cfg))
    calls = fused_train.fused_train_grads.launches
    state, aux = step.train_step(state, step.Batch(*map(torch.from_numpy, (o, d, gold))),
                                 None, cfg)
    assert fused_train.fused_train_grads.launches == calls  # the CPU runs the plain version
    assert state.step == 1 and int(new_j.step) == 1
    for key in ("loss", "loss_coarse", "psnr"):
        np.testing.assert_allclose(float(aux[key]), float(aux_j[key]), rtol=1e-4, err_msg=key)
    np.testing.assert_allclose(aux["ray_err"].numpy(), np.asarray(aux_j["ray_err"]), atol=1e-5)
    got = params_to_numpy(state.params)
    want = jax.tree.map(np.asarray, new_j.params)
    for g, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(g, w, atol=0.1 * LR)


def test_kernel_path_is_taken_when_supported(monkeypatch):
    calls = []
    real = fused_train.fused_train_grads
    monkeypatch.setattr(fused_train, "fused_train_grads",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    o, d, gold = _rays()
    batch = step.Batch(*map(torch.from_numpy, (o, d, gold)))
    for kernel in (True, False):
        cfg = _cfg(kernel)
        step.train_step(step.init_state(cfg), batch, None, cfg)
        assert calls == [1]  # the kernel path once, then autograd


def _adam_tracks_optax(cfg, steps=3):
    state = step.init_state(cfg)
    tree = params_to_numpy(state.params)
    opt = optax.adam(optax.exponential_decay(LR, cfg.train.lr_decay_steps,
                                             cfg.train.lr_final / LR)
                     if cfg.train.lr_decay_steps > 0 else LR)
    jparams = jax.tree.map(jnp.asarray, tree)
    jopt = opt.init(jparams)
    rng = np.random.default_rng(0)
    for _ in range(steps):
        grads = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32), tree)
        updates, jopt = opt.update(jax.tree.map(jnp.asarray, grads), jopt, jparams)
        jparams = optax.apply_updates(jparams, updates)
        step.apply_grads(state, params_from_numpy(grads), cfg)
    for g, w in zip(jax.tree_util.tree_leaves(params_to_numpy(state.params)),
                    jax.tree_util.tree_leaves(jparams)):
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-6, rtol=1e-5)
    assert state.step == steps


def test_three_adam_steps_track_optax():
    _adam_tracks_optax(_cfg(False))


def test_lr_decay_schedule_matches_optax():
    cfg = _cfg(False, lr_decay_steps=4, lr_final=1e-5)
    sched = optax.exponential_decay(LR, 4, 1e-5 / LR)
    for count in range(10):
        np.testing.assert_allclose(step.learning_rate(cfg, count), float(sched(count)),
                                   rtol=1e-6)
    _adam_tracks_optax(cfg)


def test_batch_from_idx_matches_jax():
    cfg = _cfg(False)
    jds = jfactory.make_dataset(_j(cfg))
    ds = make_dataset(cfg)
    idx = np.random.default_rng(3).integers(0, ds.num_views * 64, size=50)
    want = jds.batch_from_idx(jnp.asarray(idx, jnp.int32))
    got = ds.batch_from_idx(torch.from_numpy(idx))
    np.testing.assert_allclose(got.origins.numpy(), np.asarray(want.origins), atol=1e-6)
    np.testing.assert_allclose(got.dirs.numpy(), np.asarray(want.dirs), atol=1e-6)
    np.testing.assert_array_equal(got.gold.numpy(), np.asarray(want.gold))
    # a drawn batch is the batch its indices denote
    drawn = ds.sample_batch(torch.Generator().manual_seed(0), 40)
    again = ds.batch_from_idx(drawn.idx)
    for a, b in zip(drawn, again):
        assert torch.equal(a, b)


def test_resume_gives_the_unbroken_next_step(tmp_path):
    cfg = dataclasses.replace(_cfg(True), render=RenderConfig(num_samples=S))  # jittered
    ds = make_dataset(cfg)
    fn = step.make_train_step(cfg, ds)
    unbroken = step.init_state(cfg)
    for it in range(3):
        unbroken, aux = fn(unbroken, step.step_generator(0, it, "cpu"))
    resumed = step.init_state(cfg)
    for it in range(2):
        resumed, _ = fn(resumed, step.step_generator(0, it, "cpu"))
    path = ckpt.save(resumed, str(tmp_path))
    fresh = ckpt.restore(path, step.init_state(cfg))
    assert fresh.step == 2
    fresh, aux2 = fn(fresh, step.step_generator(0, fresh.step, "cpu"))
    assert torch.equal(aux2["batch_idx"], aux["batch_idx"])
    for (k, a), b in zip(unbroken.params.state_dict().items(), fresh.params.state_dict().values()):
        assert torch.equal(a, b), k
    # a weights-only file (a bare field's save) still loads for inference
    wpath = ckpt.save(fresh.params, str(tmp_path / "w"), step=7)
    assert ckpt.restore_weights(wpath, step.init_state(cfg).params) == 7


def test_cli_train_then_eval(tmp_path, capsys):
    common = ["--dataset", "sphere", "--width", "8", "--height", "8", "--num_samples", "8",
              "--save_dir", str(tmp_path / "ckpt")]
    assert cli.main(["train", *common, "--num_rays", "32", "--num_iter", "3",
                     "--eval_steps", "2", "--log_dir", str(tmp_path / "logs"),
                     "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "iter=2, eval psnr=" in out and "done at step 3" in out
    assert ckpt.latest_checkpoint(str(tmp_path / "ckpt")).endswith("-3.pt")
    assert len(os.listdir(tmp_path / "logs")) == 1  # the run dir with its config.json
    assert cli.main(["eval", *common, "--max_views", "1", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert re.search(r"view   0: psnr \d+\.\d\d", out)
    assert "mean psnr over 1 test views" in out


def _resolve(mod, argv):
    args = mod.build_parser().parse_args(argv)
    args._explicit = mod.explicit_dests(argv)
    return mod.config_from_args(args)


def test_presets_resolve_like_the_jax_cli():
    full = _resolve(cli, ["train", "--preset", "full"]).to_dict()
    flag = bench.flagship_config().to_dict()
    for get in (lambda c: c["use_whole_ray_train"], lambda c: c["use_fused_kernel"],
                lambda c: c["train"]["precision"], lambda c: c["train"]["num_rays"],
                lambda c: c["render"]["num_samples"], lambda c: c["render"]["num_fine_samples"],
                lambda c: c["model"], lambda c: c["camera"]):
        assert get(full) == get(flag)
    for argv in (["train"], ["train", "--preset", "tiny", "--num_samples", "32"],
                 ["train", "--preset", "full", "--use_whole_ray_train", "false"]):
        mine, jaxs = _resolve(cli, argv).to_dict(), _resolve(jcli, argv).to_dict()
        assert mine["use_whole_ray_train"] == jaxs["use_whole_ray_train"]
        assert mine["camera"] == jaxs["camera"] and mine["render"] == jaxs["render"]
        assert mine["train"]["num_rays"] == jaxs["train"]["num_rays"]
    assert _resolve(cli, ["train"]).use_whole_ray_train is False


@pytest.mark.parametrize("argv,slice_no", [
    (["train", "--multiscale_levels", "2"], 3),
    (["train", "--ema_decay", "0.9"], 7),
    (["eval", "--scales", "1,2"], 3),
    (["train", "--preset", "record"], 4),
    (["train", "--occ_res", "64"], 4),
    (["render", "--contract", "true"], 5),
])
def test_cli_names_the_slice_of_what_it_refuses(argv, slice_no, capsys):
    try:
        rc = cli.main([*argv, "--dataset", "sphere"])
    except SystemExit as e:
        rc = e.code
    assert rc == 2
    assert f"slice {slice_no}" in capsys.readouterr().err
