"""Slice 10 of the port on the CPU: compat mode (the reference's committed
math: the 8 x 100 raw-xyz field with its discarded radiance head, t = u *
far samples, the density composited as grey), the reference's screen-space
encodings, the analytic sphere oracles and ``count_params``, each against
the JAX package's function on identical inputs (JAX weights converted with
``convert.params_from_numpy``, midpoint or given samples: threefry's draws
cannot be reproduced) and compat's numpy oracle (``tests/test_compat.py``).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_rs_tpu import config as jconfig
from nerf_rs_tpu.data import synthetic as jsyn
from nerf_rs_tpu.models import encoding as jenc
from nerf_rs_tpu.models import mlp as jmlp
from nerf_rs_tpu.ops import render as jrender
from nerf_rs_tpu.ops import sampling as jsampling
from nerf_rs_tpu.train import step as jstep
from nerf_rs_tpu.utils import export as jexport
from nerf_rs_tpu_torch import cli
from nerf_rs_tpu_torch.config import (CameraConfig, Config, DataConfig, ModelConfig,
                                      RenderConfig, TrainConfig, reference_compat_config)
from nerf_rs_tpu_torch.convert import params_from_numpy
from nerf_rs_tpu_torch.data import synthetic
from nerf_rs_tpu_torch.kernels import fused_ray, fused_train
from nerf_rs_tpu_torch.models import encoding, mlp
from nerf_rs_tpu_torch.ops import render as render_ops
from nerf_rs_tpu_torch.ops import sampling
from nerf_rs_tpu_torch.render import make_render
from nerf_rs_tpu_torch.train import checkpoint as ckpt
from nerf_rs_tpu_torch.train import step
from nerf_rs_tpu_torch.utils import export
from test_compat import _numpy_reference_predict

torch.set_num_threads(2)

N, S, FAR = 16, 16, 2.0
LR = 5e-4


def _cfg(**train) -> Config:
    """The reference's compat config at a small batch: 16 rays x 16
    midpoint samples, f32."""
    base = reference_compat_config()
    return dataclasses.replace(
        base, camera=CameraConfig(width=8, height=8, far=FAR),
        render=dataclasses.replace(base.render, num_samples=S, randomized=False),
        train=TrainConfig(num_rays=N, learning_rate=LR, precision="f32", **train),
        data=DataConfig(dataset="sphere"))


def _j(cfg: Config) -> "jconfig.Config":
    return jconfig.Config.from_dict(cfg.to_dict())


def _jax_tree(model_cfg: ModelConfig, seed=0):
    jcfg = jconfig.ModelConfig(**dataclasses.asdict(model_cfg))
    return jax.tree.map(np.asarray, jmlp.init_nerf_params(jax.random.PRNGKey(seed), jcfg))


def _converted(model_cfg: ModelConfig, seed=0):
    tree = _jax_tree(model_cfg, seed)
    model = mlp.init_nerf_params(model_cfg, 0)
    model.load_state_dict(params_from_numpy(tree))
    return tree, model


def _rays(seed=3):
    """Rays from about z = -1 towards +z (the sphere's scale)."""
    rng = np.random.default_rng(seed)
    o = (rng.normal(size=(N, 3)) * 0.1).astype(np.float32)
    o[:, 2] -= 1.0
    d = np.zeros((N, 3), np.float32)
    d[:, 2] = 1.0
    d[:, :2] = rng.normal(size=(N, 2)) * 0.05
    gold = rng.uniform(size=(N, 3)).astype(np.float32)
    return o, d, gold


# --- the field ---

def test_compat_init_is_seeded_libtorch_uniform():
    """libtorch's nn::Linear default, drawn with numpy from the seed:
    every weight and bias U(-1/sqrt(fan_in), 1/sqrt(fan_in)), in module
    order, weights before biases; one seed gives the same field, another
    stream another. The shapes are the JAX package's compat tree's."""
    cfg = reference_compat_config().model
    a, b = mlp.init_nerf_params(cfg, 0), mlp.init_nerf_params(cfg, 0)
    other = mlp.init_nerf_params(cfg, 0, stream=1)
    tree = params_from_numpy(_jax_tree(cfg))
    assert list(a.state_dict()) == list(tree)
    for (k, x), y, z, t in zip(a.state_dict().items(), b.state_dict().values(),
                               other.state_dict().values(), tree.values()):
        assert x.shape == t.shape and torch.equal(x, y) and not torch.equal(x, z), k
        bound = 1.0 / np.sqrt(a.state_dict()[k.rsplit(".", 1)[0] + ".w"].shape[0])
        assert float(x.abs().max()) <= bound, k
    w = a.trunk[1].w.detach()  # 100 x 100 draws of U(-0.1, 0.1): std 0.1 / sqrt(3)
    assert abs(float(w.std()) / (0.1 / np.sqrt(3.0)) - 1.0) < 0.03
    first = np.random.default_rng(0).uniform(-1 / np.sqrt(3), 1 / np.sqrt(3), 300)
    np.testing.assert_allclose(a.trunk[0].w.detach().reshape(-1).numpy(), first, rtol=1e-6)


@pytest.mark.parametrize("arch", ["nerf", "factored", "hashgrid", "compat"])
def test_count_params_matches_jax(arch):
    """``count_params`` of each family's field, the port's module against
    the JAX tree of the same config (small tables)."""
    small = dict(net_depth=2, net_width=16, skip_layer=1, feature_width=16, view_head_width=8,
                 fac_levels=2, fac_base_res=4, fac_max_res=8, fac_comps=4,
                 hash_levels=2, hash_table_log2=8, hash_base_res=4, hash_max_res=16)
    cfg = ModelConfig(arch="nerf" if arch == "compat" else arch, compat=arch == "compat",
                      **small)
    assert mlp.count_params(mlp.init_nerf_params(cfg, 0)) == jmlp.count_params(_jax_tree(cfg))


# --- sampling ---

def test_compat_ts_deterministic_matches_jax():
    """Without draws, t = i / n * far from t = 0, bit for bit."""
    got = sampling.compat_ts(5, 64, 6.0, randomized=False)
    want = jsampling.compat_ts(jax.random.PRNGKey(0), 5, 64, 6.0, randomized=False)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert float(got[0, 0]) == 0.0


def test_compat_ts_randomized_statistics():
    """The randomized draw, held by its statistics as the JAX package's
    test holds its own: uniform over [0, far) with no near plane, sorted
    per ray, from the caller's generator."""
    g = torch.Generator().manual_seed(0)
    ts = sampling.compat_ts(4096, 64, far=2.0, generator=g)
    assert bool((ts[:, 1:] >= ts[:, :-1]).all())
    t = ts.numpy().ravel()
    assert t.min() < 0.01 and t.max() < 2.0
    assert abs(t.mean() - 1.0) < 0.01
    hist, _ = np.histogram(t, bins=10, range=(0, 2))
    assert hist.std() / hist.mean() < 0.05
    again = sampling.compat_ts(4096, 64, far=2.0, generator=torch.Generator().manual_seed(0))
    assert torch.equal(ts, again)


# --- compat_predict and the render ---

def test_compat_predict_matches_the_numpy_oracle_and_jax():
    """The reference's predict on the JAX package's compat weights: the
    numpy oracle of tests/test_compat.py at its bar (1e-4), and the JAX
    ``compat_predict`` at f32 rounding (1e-5); colour 4 is the acc."""
    cfg = reference_compat_config().model
    tree, model = _converted(cfg)
    rng = np.random.default_rng(1)
    pts = (rng.normal(size=(16, 32, 3)) * 0.6).astype(np.float32)
    ts = np.sort(rng.uniform(size=(16, 32)) * 2.0, axis=-1).astype(np.float32)
    with torch.no_grad():
        rgb, sigma = render_ops.compat_predict(model, torch.from_numpy(pts),
                                               torch.from_numpy(ts), cfg, far=2.0)
    want_rgb, want_sigma = _numpy_reference_predict(tree, pts, ts, 2.0)
    np.testing.assert_allclose(sigma.numpy(), want_sigma, atol=1e-4)
    np.testing.assert_allclose(rgb.numpy()[:, :3], want_rgb[:, :3], atol=1e-4)
    j_rgb, j_sigma = jrender.compat_predict(tree, jnp.asarray(pts), jnp.asarray(ts),
                                            jconfig.ModelConfig(**dataclasses.asdict(cfg)),
                                            far=2.0)
    np.testing.assert_allclose(rgb.numpy(), np.asarray(j_rgb), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(sigma.numpy(), np.asarray(j_sigma), atol=1e-5, rtol=1e-5)
    assert bool((sigma < 0).any())  # the raw density goes negative: nothing clamps it
    # the radiance head is evaluated and discarded: zeroing it changes nothing
    with torch.no_grad():
        model.head2.w.zero_()
        again, _ = render_ops.compat_predict(model, torch.from_numpy(pts),
                                             torch.from_numpy(ts), cfg, far=2.0)
    assert torch.equal(rgb, again)


@pytest.mark.parametrize("num_fine", [0, 8])
def test_render_rays_under_compat_matches_jax(num_fine):
    """``render_rays`` with the compat config (t = i / n * far without
    draws, the density as grey), alone and with a union fine pass through
    the same field, against the JAX function on converted weights: every
    output within f32 rounding."""
    cfg = _cfg()
    rc = dataclasses.replace(cfg.render, num_fine_samples=num_fine)
    tree, model = _converted(cfg.model)
    o, d, _ = _rays()
    with torch.no_grad():
        coarse, fine = render_ops.render_rays(model, torch.from_numpy(o), torch.from_numpy(d),
                                              cfg.model, rc, cfg.camera, randomized=False)
    jc = _j(dataclasses.replace(cfg, render=rc))
    jcoarse, jfine = jrender.render_rays(tree, jnp.asarray(o), jnp.asarray(d),
                                         jax.random.PRNGKey(0), jc.model, jc.render, jc.camera,
                                         randomized=False)
    assert (fine is None) == (jfine is None) == (num_fine == 0)
    for got, want in ((coarse, jcoarse), (fine, jfine)) if fine is not None else (
            (coarse, jcoarse),):
        for field in ("rgb", "weights", "sigma", "depth", "acc", "ts"):
            np.testing.assert_allclose(getattr(got, field).numpy(),
                                       np.asarray(getattr(want, field)), atol=1e-5, rtol=1e-5,
                                       err_msg=field)
    assert torch.equal(coarse.rgb[:, 0], coarse.rgb[:, 1])  # grey


def test_compat_renders_and_trains_without_the_kernels(monkeypatch):
    """The kernels do not take the compat field (``fused_supported`` and
    ``train_fused_supported`` are false, as in the JAX package): a frame
    asked for through the render kernel and a step asked for through the
    train kernel run the eager field and autograd, the same numbers as
    without asking; a paper field does reach both wrappers."""
    calls = []
    for mod, name in ((fused_ray, "fused_ray_render"), (fused_train, "fused_train_grads")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _r=real, _n=name, **k: calls.append(_n)
                            or _r(*a, **k))
    cfg = _cfg()
    model = mlp.init_nerf_params(cfg.model, 0)
    o, d, gold = map(torch.from_numpy, _rays())
    asked = dataclasses.replace(cfg, use_fused_kernel=True, use_whole_ray_train=True)
    assert not render_ops.fused_supported(cfg.model) and not step.whole_ray_supported(asked)
    rgb = make_render(asked)(model, o, d)[0]
    assert torch.equal(rgb, make_render(cfg)(model, o, d)[0])
    batch = step.Batch(o, d, gold)
    g1, _ = step.compute_grads(step.init_state(asked), batch, None, asked)
    g2, _ = step.compute_grads(step.init_state(cfg), batch, None, cfg)
    assert all(torch.equal(g1[k], g2[k]) for k in g2)
    assert calls == []
    paper = Config(model=ModelConfig(net_depth=2, net_width=16, skip_layer=1, feature_width=16,
                                     view_head_width=16, pos_enc_levels=2, dir_enc_levels=1),
                   render=RenderConfig(num_samples=8, randomized=False),
                   train=TrainConfig(num_rays=N), use_whole_ray_train=True)
    make_render(paper)(mlp.init_nerf_params(paper.model, 0), o, d)
    step.compute_grads(step.init_state(paper), batch, None, paper)
    assert calls == ["fused_ray_render", "fused_train_grads"]


# --- training ---

def test_compat_train_step_matches_jax():
    """One compat step from the same weights and rays (midpoint samples,
    f32): the loss and every gradient against ``jax.value_and_grad`` of the
    JAX ``loss_fn`` (f32 rounding, 1e-5 of each leaf's largest entry); the
    radiance head's gradient exactly 0 on both sides; then the updated
    weights against the JAX ``train_step``'s within a tenth of the rate
    (Adam's first step is about lr * sign(g)), the head's bit for bit."""
    cfg = _cfg()
    jcfg = _j(cfg)
    jstate = jstep.init_state(jax.random.PRNGKey(2), jcfg)
    state = step.init_state(cfg)
    state.params.load_state_dict(params_from_numpy(jax.tree.map(np.asarray, jstate.params)))
    start = {k: v.clone() for k, v in state.params.state_dict().items()}
    o, d, gold = _rays()
    jbatch = jstep.Batch(*map(jnp.asarray, (o, d, gold)))
    batch = step.Batch(*map(torch.from_numpy, (o, d, gold)))
    (jloss, _), jgrads = jax.value_and_grad(jstep.loss_fn, has_aux=True)(
        jstate.params, jbatch, jax.random.PRNGKey(0), jcfg)
    grads, aux = step.compute_grads(state, batch, None, cfg)
    np.testing.assert_allclose(float(aux["loss"]), float(jloss), rtol=1e-5)
    want = params_from_numpy(jax.tree.map(np.asarray, jgrads))
    assert list(grads) == list(want)
    for k, w in want.items():
        scale = max(float(w.abs().max()), 1e-12)
        if k.startswith("head"):
            assert not grads[k].any() and not w.any(), k
        else:
            assert float((grads[k] - w).abs().max()) <= 1e-5 * scale, k
    assert float(grads["trunk.0.w"].abs().max()) > 0.0  # the trunk does train
    new_j, _ = jstep.train_step(jstate, jbatch, jax.random.PRNGKey(0), jcfg)
    state = step.apply_grads(state, grads, cfg)
    got = state.params.state_dict()
    for k, w in params_from_numpy(jax.tree.map(np.asarray, new_j.params)).items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), atol=0.1 * LR, err_msg=k)
        if k.startswith("head"):
            assert torch.equal(got[k], start[k]) and torch.equal(w, start[k]), k


def test_compat_heads_keep_their_bits_over_steps():
    """Three randomized compat steps with an EMA: the trunk moves, the
    radiance head keeps its bits (a zero gradient from zero moments is a
    zero Adam update), its Adam moments stay 0, and its EMA stays the
    initial weights to f32 rounding."""
    cfg = _cfg(ema_decay=0.9)
    cfg = dataclasses.replace(cfg, render=dataclasses.replace(cfg.render, randomized=True))
    state = step.init_state(cfg)
    start = {k: v.clone() for k, v in state.params.state_dict().items()}
    batch = step.Batch(*map(torch.from_numpy, _rays()))
    for it in range(3):
        state, aux = step.train_step(state, batch, step.step_generator(0, it, "cpu"), cfg)
        assert bool(torch.isfinite(aux["loss"]))
    now, ema = state.params.state_dict(), state.ema.state_dict()
    for k, v in start.items():
        if k.startswith("head"):
            assert torch.equal(now[k], v), k
            torch.testing.assert_close(ema[k], v, rtol=1e-6, atol=1e-7)
        elif k.endswith(".w"):
            assert not torch.equal(now[k], v), k
    for p, name in zip(state.params.parameters(), state.params.state_dict()):
        if name.startswith("head"):
            adam = state.optimizer.state[p]
            assert not adam["exp_avg"].any() and not adam["exp_avg_sq"].any(), name


def test_compat_checkpoint_round_trip(tmp_path):
    """A compat state with its EMA saves and resumes (weights, Adam state
    and EMA, the next step the same bits); loading it into a non-compat run
    fails as loading a factored checkpoint into one does (the field's keys
    differ)."""
    cfg = _cfg(ema_decay=0.9)
    batch = step.Batch(*map(torch.from_numpy, _rays()))
    state, _ = step.train_step(step.init_state(cfg), batch, None, cfg)
    path = ckpt.save(state, str(tmp_path / "compat"))
    fresh = ckpt.restore(path, step.init_state(cfg))
    assert fresh.step == 1
    for a, b in ((state.params, fresh.params), (state.ema, fresh.ema)):
        for (k, x), y in zip(a.state_dict().items(), b.state_dict().values()):
            assert torch.equal(x, y), k
    s1, _ = step.train_step(state, batch, None, cfg)
    s2, _ = step.train_step(fresh, batch, None, cfg)
    for (k, a), (_, b) in zip(step.named_trainable(s1), step.named_trainable(s2)):
        assert torch.equal(a, b), k
    paper = Config(model=ModelConfig(net_depth=2, net_width=16, skip_layer=1, feature_width=16,
                                     view_head_width=8))
    factored = Config(model=ModelConfig(arch="factored", fac_levels=2, fac_base_res=4,
                                        fac_max_res=8, fac_comps=4))
    fpath = ckpt.save(step.init_state(factored), str(tmp_path / "factored"))
    for p in (path, fpath):
        with pytest.raises(RuntimeError, match="Missing key"):
            ckpt.restore(p, step.init_state(paper))


def test_export_refuses_compat_as_the_jax_export_fails(tmp_path):
    """The JAX export's reshape of the compat field's four channels into
    three fails (a TypeError) before it writes anything; the port refuses
    the field by name (a ValueError), in ``sample_density_grid`` and
    through ``cli export``, and writes nothing either."""
    cfg = reference_compat_config().model
    tree, model = _converted(cfg)
    with pytest.raises(TypeError, match="reshape"):
        jexport.sample_density_grid(tree, jconfig.ModelConfig(**dataclasses.asdict(cfg)),
                                    res=4, aabb=1.0)
    with pytest.raises(ValueError, match="compat"):
        export.sample_density_grid(model, cfg, res=4, aabb=1.0)
    ckpt.save(model, str(tmp_path / "ck"))
    out = tmp_path / "ex"
    with pytest.raises(ValueError, match="compat"):
        cli.main(["export", "--compat", "true", "--dataset", "sphere", "--save_dir",
                  str(tmp_path / "ck"), "--grid_res", "4", "--out", str(out / "field"),
                  "--device", "cpu"])
    assert not out.exists()


def test_cli_compat_runs_end_to_end(tmp_path, capsys):
    """``train --compat true --device cpu`` (two gloo ranks: compat goes
    through the data-parallel step as the paper field does), its resume,
    ``eval``, ``render`` and ``render --use_fused_kernel true`` (the same
    frame: the kernel does not take compat) on the CPU: finite losses,
    the radiance head as it started."""
    common = ["--compat", "true", "--dataset", "sphere", "--width", "8", "--height", "8",
              "--num_samples", "8", "--save_dir", str(tmp_path / "ck"), "--log_dir",
              str(tmp_path / "logs"), "--device", "cpu"]
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    assert cli.main(["train", *common, "--num_rays", "32", "--num_iter", "4", "--eval_steps",
                     "2", "--num_devices", "2"]) == 0
    assert cli.main(["train", *common, "--num_rays", "32", "--num_iter", "6",
                     "--eval_steps", "100"]) == 0
    out = capsys.readouterr().out
    assert "resumed from" in out and "done at step 6" in out
    assert cli.main(["eval", *common, "--max_views", "2"]) == 0
    assert "mean psnr over 2" in capsys.readouterr().out
    frames = []
    for extra in ([], ["--use_fused_kernel", "true"]):
        rdir = tmp_path / f"r{len(frames)}"
        assert cli.main(["render", *common, "--view", "0", "--out_dir", str(rdir), *extra]) == 0
        frames.append((rdir / "view-0.png").read_bytes())
    assert frames[0] == frames[1]
    cfg = cli.config_from_args(cli.build_parser().parse_args(["train", *common]))
    field = mlp.init_nerf_params(cfg.model, 0)
    assert ckpt.restore_weights(ckpt.latest_checkpoint(str(tmp_path / "ck")), field) == 6
    start = mlp.init_nerf_params(cfg.model, 0)
    for name in ("head1", "head2"):
        for a, b in zip(getattr(field, name).parameters(), getattr(start, name).parameters()):
            assert torch.equal(a, b), name
    assert not torch.equal(field.trunk[0].w, start.trunk[0].w)


def test_diagnostics_sample_the_compat_ts():
    """The logging step's ray-t histogram under ``compat_sampling``: the
    reference's draws over [0, far), none of them pushed to the near plane
    (the JAX loop's compat branch)."""
    from nerf_rs_tpu_torch.data.factory import make_dataset
    from nerf_rs_tpu_torch.train.loop import log_diagnostics

    class Recorder:
        def __init__(self):
            self.ts = None

        def ray_ts(self, ts, it):
            self.ts = ts

        def __getattr__(self, name):
            return lambda *a, **k: None

    base = _cfg()
    cfg = dataclasses.replace(base, camera=dataclasses.replace(base.camera, near=1.5, far=6.0))
    tb = Recorder()
    log_diagnostics(tb, make_dataset(cfg), cfg, 1)
    assert tb.ts.shape[1] == S and tb.ts.min() < 1.5 and tb.ts.max() < 6.0
    stratified = dataclasses.replace(cfg, render=dataclasses.replace(cfg.render,
                                                                     compat_sampling=False))
    log_diagnostics(tb, make_dataset(stratified), stratified, 1)
    assert tb.ts.min() >= 1.5


# --- the screen encodings and the sphere oracles ---

SCREEN = {
    "identity": lambda m, e: m.screen_identity(e),
    "scale": lambda m, e: m.screen_scale(e, 48, 64),
    "center": lambda m, e: m._center(m.screen_scale(e, 48, 64)),
    "scale_center": lambda m, e: m.screen_scale_center(e, 48, 64),
    "coconet": lambda m, e: m.screen_coconet(e, 48, 64),
    "fourier": lambda m, e: m.screen_fourier(e, 48, 64, 11),
}


@pytest.mark.parametrize("name", list(SCREEN))
def test_screen_encodings_match_jax(name):
    """The reference's screen-space encodings on (row, col) pixel
    coordinates of a 48 x 64 screen, against the JAX package's (f32
    rounding; ``fourier`` fills 5 of its 11 slots and leaves the rest 0)."""
    rng = np.random.default_rng(5)
    e = np.stack([rng.integers(0, 48, 200), rng.integers(0, 64, 200)], -1)
    got = SCREEN[name](encoding, torch.from_numpy(e)).numpy()
    want = np.asarray(SCREEN[name](jenc, jnp.asarray(e)))
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    if name == "fourier":
        assert not got[:, 5:].any() and got[:, :5].any()


def test_sphere_oracles_match_jax():
    """``sphere_density`` (1 inside radius 0.5) and ``render_sphere_gold``
    (per-sample density, per-ray hit) on the same points and rays, bit for
    bit."""
    rng = np.random.default_rng(6)
    pts = rng.uniform(-1.0, 1.0, (500, 3)).astype(np.float32)
    np.testing.assert_array_equal(synthetic.sphere_density(torch.from_numpy(pts)).numpy(),
                                  np.asarray(jsyn.sphere_density(jnp.asarray(pts))))
    o, d, _ = _rays()
    ts = np.tile(np.linspace(0.0, 2.0, 32, dtype=np.float32), (N, 1))
    sigma, hit = synthetic.render_sphere_gold(*map(torch.from_numpy, (o, d, ts)), radius=0.4)
    jsigma, jhit = jsyn.render_sphere_gold(*map(jnp.asarray, (o, d, ts)), radius=0.4)
    np.testing.assert_array_equal(sigma.numpy(), np.asarray(jsigma))
    np.testing.assert_array_equal(hit.numpy(), np.asarray(jhit))
    assert 0 < float(hit.sum()) < N or float(hit.sum()) == N
