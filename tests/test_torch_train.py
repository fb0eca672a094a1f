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
    for a, b in zip(drawn, again):  # radii: None on both (a single-scale store)
        assert (a is None and b is None) or torch.equal(a, b)


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


# --compat (slice 10) beside the flags of every other slice resolves to the
# JAX CLI's Config, key for key
@pytest.mark.parametrize("argv", [
    ["export", "--compat", "true", "--scene_index", "1"],
    ["train", "--compat", "true", "--ema_decay", "0.9"],
    ["eval", "--compat", "true", "--scenes", "a,b"],
    ["train", "--compat", "true", "--num_devices", "2"],
    ["train", "--compat", "true", "--shard_pixel_store", "true"],
    ["render", "--compat", "true"],
    ["render", "--scene_index", "1", "--depth", "true", "--compat", "true"],
    ["render", "--shard_pixel_store", "true", "--compat", "true"],
    ["render", "--compat", "true"],
    ["train", "--accumulation_steps", "2", "--num_devices", "2", "--compat", "true"],
    ["eval", "--scenes", "a,b", "--compat", "true"],
    ["export", "--mesh", "true", "--scene_index", "0", "--compat", "true"],
])
def test_compat_argv_resolves_like_the_jax_cli(argv):
    argv = [*argv, "--dataset", "sphere"]
    mine, jaxs = _resolve(cli, argv), _resolve(jcli, argv)
    assert mine.to_dict() == jaxs.to_dict()
    assert mine.model.compat and mine.render.compat_sampling and mine.render.compat_density_color
    assert mine.use_fused_kernel == ("--use_fused_kernel" in argv)


# --- slice 7: gradient accumulation ---

def _acc_cfg(acc, **kw):
    cfg = _cfg(False, precision="f32", accumulation_steps=acc)
    return dataclasses.replace(cfg, **kw) if kw else cfg


@pytest.mark.parametrize("acc", [2, 4])
def test_accumulated_step_matches_jax(acc):
    """An accumulated step (the batch cut into ``acc`` micro-batches, their
    autograd gradients averaged, one Adam update) against the JAX
    package's ``train_step`` (its ``train_step_core`` scan), midpoint
    samples, f32: the same bars as test_train_step_matches_jax's autograd
    path; aux the micro-batches' means, ray_err per ray in batch order.
    The kernel route is off under accumulation in both packages."""
    cfg = _acc_cfg(acc, use_whole_ray_train=True)
    assert not step.whole_ray_supported(cfg)
    jstate, state = _converted_state(cfg)
    o, d, gold = _rays(1)
    new_j, aux_j = jstep.train_step(jstate, jstep.Batch(*map(jnp.asarray, (o, d, gold))),
                                    jax.random.PRNGKey(0), _j(cfg))
    state, aux = step.train_step(state, step.Batch(*map(torch.from_numpy, (o, d, gold))),
                                 None, cfg)
    for key in ("loss", "loss_coarse", "psnr"):
        np.testing.assert_allclose(float(aux[key]), float(aux_j[key]), rtol=1e-4, err_msg=key)
    assert aux["ray_err"].shape == (N,)
    np.testing.assert_allclose(aux["ray_err"].numpy(), np.asarray(aux_j["ray_err"]), atol=1e-5)
    for g, w in zip(jax.tree_util.tree_leaves(params_to_numpy(state.params)),
                    jax.tree_util.tree_leaves(jax.tree.map(np.asarray, new_j.params))):
        np.testing.assert_allclose(g, w, atol=0.1 * LR)


def test_accumulation_of_one_batch_is_its_mean_gradient():
    """With the same rays in every micro-batch, the accumulated gradient is
    the one-batch gradient (the mean of equal terms), and the aux the
    one-batch aux: within f32 rounding of the sum and the division."""
    from nerf_rs_tpu_torch.train.step import accumulated_grads, loss_fn, named_trainable

    o, d, gold = _rays(2)
    one = step.Batch(*map(torch.from_numpy, (o[:4], d[:4], gold[:4])))
    four = step.Batch(*(torch.cat([t] * 4) for t in one[:3]))
    cfg = _acc_cfg(4)
    state = step.init_state(cfg)
    loss, aux1 = loss_fn(state.params, one, None, cfg)
    loss.backward()
    want = {k: p.grad.clone() for k, p in named_trainable(state)}
    grads, aux4 = accumulated_grads(state, four, None, cfg)
    for k, g in grads.items():
        torch.testing.assert_close(g, want[k], rtol=1e-6, atol=1e-9)
    torch.testing.assert_close(aux4["loss"], aux1["loss"].detach(), rtol=1e-6, atol=0)
    assert torch.equal(aux4["ray_err"], torch.cat([aux1["ray_err"]] * 4))


def test_accumulation_drops_the_proposal_anneal_as_jax_does():
    """The JAX scan body calls ``loss_fn`` without the step, so under
    accumulation the proposal's draws are not annealed: at step 5 of a
    10-step anneal the accumulated step equals the accumulated step of the
    same config without an anneal, bit for bit, where the plain step's
    anneal moves the proposal's draws; and it matches the JAX package's
    accumulated step on the same state (midpoint samples, f32)."""
    from nerf_rs_tpu_torch.config import ProposalConfig

    prop = ProposalConfig(enabled=True, num_samples=8, net_width=16, anneal_steps=10)
    cfg = _acc_cfg(2, proposal=prop, render=RenderConfig(num_samples=16, randomized=False))
    flat = dataclasses.replace(cfg, proposal=dataclasses.replace(prop, anneal_steps=0))
    o, d, gold = _rays(3)
    batch = step.Batch(*map(torch.from_numpy, (o, d, gold)))
    outs = []
    for c in (cfg, flat):
        state = step.init_state(c)
        state.step = 5
        state, aux = step.train_step(state, batch, None, c)
        outs.append((params_to_numpy(state.params), aux))
    for a, b in zip(jax.tree_util.tree_leaves(outs[0][0]), jax.tree_util.tree_leaves(outs[1][0])):
        np.testing.assert_array_equal(a, b)
    plain = [step.loss_fn(step.init_state(c).params, batch, None, c,
                          step.init_state(c).fine_params, step=5)[1]["loss"].detach()
             for c in (dataclasses.replace(cfg, train=dataclasses.replace(cfg.train,
                                                                           accumulation_steps=1)),
                       flat)]
    assert float(plain[0]) != float(plain[1])  # without accumulation the anneal counts

    jcfg = _j(cfg)
    jstate = jstep.init_state(jax.random.PRNGKey(4), jcfg)
    jstate = jstate._replace(step=jnp.asarray(5, jnp.int32))
    state = step.init_state(cfg)
    state.params.load_state_dict(params_from_numpy(jax.tree.map(np.asarray, jstate.params)))
    state.fine_params.load_state_dict(
        params_from_numpy(jax.tree.map(np.asarray, jstate.fine_params)))
    state.step = 5
    new_j, aux_j = jstep.train_step(jstate, jstep.Batch(*map(jnp.asarray, (o, d, gold))),
                                    jax.random.PRNGKey(0), jcfg)
    state, aux = step.train_step(state, batch, None, cfg)
    for key in ("loss", "loss_coarse", "loss_prop"):
        np.testing.assert_allclose(float(aux[key]), float(aux_j[key]), rtol=1e-4, err_msg=key)
    for g, w in zip(jax.tree_util.tree_leaves(params_to_numpy(state.params)),
                    jax.tree_util.tree_leaves(jax.tree.map(np.asarray, new_j.params))):
        np.testing.assert_allclose(g, w, atol=0.1 * LR)


@pytest.mark.parametrize("argv", [
    ["train", "--ema_decay", "0.9"],
    ["train", "--accumulation_steps", "2", "--raw_noise_std", "1.0"],
    ["train", "--profile_steps", "1", "--log_densities_only", "true"],
    ["render", "--depth", "true", "--gif", "true", "--frames", "2"],
    ["export", "--grid_res", "8", "--mesh", "true"],
])
def test_slice7_flags_run_on_the_cpu_and_need_the_card_otherwise(argv, tmp_path):
    """Each slice-7 entry point and flag runs with ``--device cpu`` (export
    and render on a checkpoint of a 2-step run) and, without a card, raises
    rather than fall back to the CPU."""
    common = ["--dataset", "sphere", "--width", "8", "--height", "8", "--num_samples", "8",
              "--num_rays", "32", "--save_dir", str(tmp_path / "ck"), "--log_dir",
              str(tmp_path / "logs")]
    if argv[0] != "train":
        assert cli.main(["train", *common, "--num_iter", "2", "--device", "cpu"]) == 0
    extra = {"train": ["--num_iter", "2"], "render": ["--out_dir", str(tmp_path / "r")],
             "export": ["--out", str(tmp_path / "x" / "field")]}[argv[0]]
    assert cli.main([*argv, *common, *extra, "--device", "cpu"]) == 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main([*argv, *common, *extra])
