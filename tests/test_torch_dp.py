"""The port's data parallelism (``nerf_rs_tpu_torch/parallel/``) on the CPU,
in gloo ranks, against the JAX package's ``parallel/dp.py`` on as many of
``tests/conftest.py``'s virtual devices (``make_mesh(n)``), from the same
converted weights and the same rays, midpoint samples (JAX's threefry
streams cannot be reproduced in torch): the DP step through K2's plain
version (the flagship settings at a narrow width) and through autograd
(the factored field), at 2 and 4 ranks, against JAX and against the
port's own one-rank step on the reduced gradients; the slice mesh's step;
the sharded render; the in-step forms (per-ray draws, the sharded pixel
store, error-weighted draws) keeping every rank's state bit-identical; the
process-sharded factory; the launcher's count check; one rank untouched;
and the CLI's ``--num_devices``.

The ranks run in ``tests/torch_dp_ranks.py`` (no JAX), started once per
world size for the whole file. The reduced gradient is compared, not the
weights after the update alone: Adam's first step is close to lr x
sign(g), which turns rounding into +-lr. JAX's reduced gradient is read
off its first moment (mu = (1 - b1) g after one step from zero). Every
tolerance is stated where it is used.
"""

import dataclasses
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from nerf_rs_tpu import config as jconfig
from nerf_rs_tpu.data import factory as jfactory
from nerf_rs_tpu.parallel import dp as jdp
from nerf_rs_tpu.parallel import mesh as jmesh
from nerf_rs_tpu.train import step as jstep
from nerf_rs_tpu_torch import cli
from nerf_rs_tpu_torch.config import (CameraConfig, Config, DataConfig, ModelConfig,
                                      RenderConfig, TrainConfig)
from nerf_rs_tpu_torch.convert import params_from_numpy, params_to_numpy
from nerf_rs_tpu_torch.data.dataset import update_error_store
from nerf_rs_tpu_torch.data.factory import make_dataset
from nerf_rs_tpu_torch.data.images import load_image
from nerf_rs_tpu_torch.parallel import dp, launch, mesh as mesh_mod
from nerf_rs_tpu_torch.render import render_frame
from nerf_rs_tpu_torch.train import checkpoint as ckpt
from nerf_rs_tpu_torch.train import loop, step

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = ModelConfig(net_depth=4, net_width=32, skip_layer=2, feature_width=32,
                    view_head_width=16, pos_enc_levels=3, dir_enc_levels=1)
FACTORED = ModelConfig(arch="factored", fac_levels=3, fac_base_res=4, fac_max_res=16,
                       fac_comps=8, fac_aabb=1.2, sigma_activation="softplus")
N, S, LR = 32, 8, 1e-3
WORLDS = (2, 4)
# reduced gradients, port vs JAX, largest |diff| over the leaf's largest |g|:
# K2's plain versions on both sides round at the same bf16 points and sum in
# f32 in other orders (8.1e-8 measured on this CPU at 2 and 4 ranks);
# autograd at f32 differs by summation order (3.5e-7)
GRAD_TOL = {"kernel": 1e-6, "factored": 5e-6}
# the ranks' mean of per-rank means against one rank's mean over every ray,
# the same measure: the same gradient summed in another order (7.1e-9 and
# 5.4e-7 measured)
ONE_RANK_TOL = {"kernel": 1e-7, "factored": 5e-6}


def _cfg(kind: str) -> Config:
    kernel = kind == "kernel"
    return Config(
        camera=CameraConfig(width=8, height=8),
        model=MODEL if kernel else FACTORED,
        render=RenderConfig(num_samples=S, randomized=False),
        train=TrainConfig(num_rays=N, learning_rate=LR if kernel else 1e-2,
                          precision="mixed" if kernel else "f32", whole_ray_block=8),
        data=DataConfig(dataset="sphere"),
        use_whole_ray_train=kernel,
    )


def _j(cfg: Config) -> "jconfig.Config":
    return jconfig.Config.from_dict(cfg.to_dict())


def _rays(seed=0, n=N):
    rng = np.random.default_rng(seed)
    o = (rng.normal(size=(n, 3)) * 0.2).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    gold = rng.uniform(size=(n, 3)).astype(np.float32)
    return o, d, gold


def _jax_params(cfg: Config, seed=2):
    return jax.tree.map(np.asarray, jstep.init_state(jax.random.PRNGKey(seed), _j(cfg)).params)


def _instep_cfg(variant: str) -> Config:
    """Per-ray draws on the 84-view sphere with jittered samples, 64 rays
    (16 a rank at 4: ceil(64 / 4)); half of them error-weighted in the
    ``err`` variant."""
    cfg = dataclasses.replace(_cfg("kernel"), render=RenderConfig(num_samples=S),
                              train=TrainConfig(num_rays=64, learning_rate=LR, whole_ray_block=8,
                                                seed=3))
    if variant == "err":
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train,
                                                                 error_resample_frac=0.5))
    return cfg


def _cases(world: int) -> list:
    cases = [{"kind": "step", "name": kind, "cfg": _cfg(kind).to_dict(),
              "params": _jax_params(_cfg(kind)), "batch": _rays()} for kind in GRAD_TOL]
    o, d = _frame_rays()
    cases.append({"kind": "render", "name": "render", "cfg": _cfg("kernel").to_dict(),
                  "params": _jax_params(_cfg("kernel")), "rays": (o.numpy(), d.numpy())})
    cases += [{"kind": "instep", "name": v, "variant": v, "cfg": _instep_cfg(v).to_dict()}
              for v in ("per_ray", "shard_store", "err")]
    if world == 4:
        cases.append({"kind": "slice", "name": "slice", "slices": 2,
                      "cfg": _cfg("kernel").to_dict(), "params": _jax_params(_cfg("kernel")),
                      "batch": _rays()})
    return cases


def _frame_rays():
    """A 12x10 frame's rays (120: not a multiple of 4 x 7, so the sharded
    render pads)."""
    from nerf_rs_tpu_torch.ops import rays

    cam = CameraConfig(width=10, height=12)
    return rays.ray_grid(rays.pose_from_yaw_pitch(0.3, 0.2), cam)


def _launch(world: int, cases: list, tmp) -> list:
    """Runs the cases on ``world`` gloo ranks (a process with no JAX) and
    returns each rank's results."""
    path = os.path.join(tmp, "cases.pkl")
    with open(path, "wb") as f:
        pickle.dump(cases, f)
    env = dict(os.environ, OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, os.path.join(REPO, "tests", "torch_dp_ranks.py"),
                           str(world), path, str(tmp)], env=env, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = []
    for r in range(world):
        with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
            out.append(dict(zip((c["name"] for c in cases), pickle.load(f))))
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """world -> [rank 0's results, rank 1's, ...], each a dict by case name."""
    return {w: _launch(w, _cases(w), tmp_path_factory.mktemp(f"world{w}")) for w in WORLDS}


def _jax_dp_step(cfg: Config, world: int, slices: int = 0):
    jcfg = _j(cfg)
    mesh = jmesh.make_slice_mesh(slices, world) if slices else jmesh.make_mesh(world)
    state = jstep.init_state(jax.random.PRNGKey(2), jcfg)
    batch = jstep.Batch(*map(jnp.asarray, _rays()))
    if slices:
        from jax.sharding import NamedSharding, PartitionSpec as P

        state = jax.device_put(state, NamedSharding(mesh, P()))
        batch = jax.device_put(batch, NamedSharding(mesh, P((jmesh.DCN_AXIS,
                                                             jmesh.DATA_AXIS))))
        fn = jdp.make_slice_dp_train_step(jcfg, mesh)
    else:
        state, batch = jdp.place_state(state, mesh), jdp.place_batch(batch, mesh)
        fn = jdp.make_dp_train_step(jcfg, mesh)
    new, aux = fn(state, batch, jax.random.PRNGKey(0))
    mu = jax.tree.map(lambda m: np.asarray(m) / np.float32(0.1), new.opt_state[0].mu)
    return jax.tree.map(np.asarray, new.params), mu, {k: float(np.asarray(v).mean())
                                                       for k, v in aux.items()}


def _tree(arrays: dict) -> dict:
    """A rank's state-dict arrays as the JAX package's tree."""
    return params_to_numpy({k: torch.from_numpy(v) for k, v in arrays.items()})


def _leaf_errs(got_tree, want_tree) -> list:
    return [float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-12))
            for g, w in zip(jax.tree_util.tree_leaves(got_tree),
                            jax.tree_util.tree_leaves(want_tree))]


def _one_rank(cfg: Config):
    """The port's one-rank step over every ray of the batch: (grads, aux)."""
    state = step.init_state(cfg)
    state.params.load_state_dict(params_from_numpy(_jax_params(cfg)))
    state, aux = step.train_step(state, step.Batch(*map(torch.from_numpy, _rays())), None, cfg)
    return {n: p.grad.numpy() for n, p in step.named_trainable(state)}, aux


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("kind", list(GRAD_TOL))
def test_dp_step_matches_jax(ranks, world, kind):
    """Every rank's reduced gradient against JAX's at the same shard count
    (``GRAD_TOL``), the loss at rtol 1e-5 (the JAX package's own DP test
    bar, ``tests/test_parallel.py``), the weights after Adam within a tenth
    of the learning rate, and every rank's state bit-identical."""
    cfg = _cfg(kind)
    params_j, grads_j, aux_j = _jax_dp_step(cfg, world)
    res = [r[kind] for r in ranks[world]]
    for r in res:
        errs = _leaf_errs(_tree(r["grads"]), grads_j)
        assert max(errs) <= GRAD_TOL[kind], errs
        np.testing.assert_allclose(r["aux"]["loss"], aux_j["loss"], rtol=1e-5)
        for g, w in zip(jax.tree_util.tree_leaves(_tree(r["params"])),
                        jax.tree_util.tree_leaves(params_j)):
            np.testing.assert_allclose(g, w, atol=0.1 * cfg.train.learning_rate)
    assert len({r["digest"] for r in res}) == 1


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("kind", list(GRAD_TOL))
def test_dp_step_matches_the_one_rank_step(ranks, world, kind):
    """The reduced gradient is the one-rank gradient over every ray
    (``ONE_RANK_TOL``, relative to each leaf's largest |g|), and the mean
    loss its loss (rtol 1e-6); each rank's ray errors are its block's."""
    grads, aux = _one_rank(_cfg(kind))
    for r, res in enumerate(ranks[world]):
        res = res[kind]
        errs = [float(np.abs(res["grads"][n] - g).max() / max(np.abs(g).max(), 1e-12))
                for n, g in grads.items()]
        assert max(errs) <= ONE_RANK_TOL[kind], errs
        np.testing.assert_allclose(res["aux"]["loss"], float(aux["loss"]), rtol=1e-6)
        per = N // world
        np.testing.assert_allclose(res["ray_err"], aux["ray_err"][r * per:(r + 1) * per].numpy(),
                                   rtol=1e-5, atol=1e-7)


def test_slice_dp_step_matches_jax_and_the_one_rank_step(ranks):
    """Four ranks as 2 slices x 2 (the mean over the slice, then over the
    slices) against JAX's ``make_slice_dp_train_step`` on
    ``make_slice_mesh(2, 4)`` and against the one-rank step, at the 1-D
    step's bars; every rank bit-identical."""
    cfg = _cfg("kernel")
    params_j, grads_j, aux_j = _jax_dp_step(cfg, 4, slices=2)
    grads, _ = _one_rank(cfg)
    res = [r["slice"] for r in ranks[4]]
    for r in res:
        assert max(_leaf_errs(_tree(r["grads"]), grads_j)) <= GRAD_TOL["kernel"]
        assert max(float(np.abs(r["grads"][n] - g).max() / np.abs(g).max())
                   for n, g in grads.items()) <= ONE_RANK_TOL["kernel"]
        np.testing.assert_allclose(r["aux"]["loss"], aux_j["loss"], rtol=1e-5)
    assert len({r["digest"] for r in res}) == 1


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_render_matches_the_one_rank_frame(ranks, world):
    """The frame rendered in blocks by the ranks (padded 120 -> 120 or 124
    rays, through K1's plain version) and gathered to every rank equals the
    one-rank frame: every ray is computed on its own, but a block's
    matmuls have other row counts, so a CPU's BLAS may round otherwise:
    atol 1e-6 (bit-equal on the CPU these tests were written on)."""
    cfg = _cfg("kernel")
    model = step.init_state(cfg).params
    model.load_state_dict(params_from_numpy(_jax_params(cfg)))
    o, d = _frame_rays()
    want = render_frame(cfg, model, o, d)
    for r in ranks[world]:
        for got, w in zip((r["render"][k] for k in ("rgb", "depth", "acc")), want):
            assert got.shape == tuple(w.shape)
            np.testing.assert_allclose(got, w.numpy(), atol=1e-6, rtol=0)


@pytest.mark.parametrize("world", WORLDS)
def test_in_step_draws_keep_every_rank_identical(ranks, world):
    """Three in-step steps with jittered samples: each rank draws its own
    rays (ceil(64 / ranks) of them), and after every step every rank's
    weights, Adam state and (with error resampling) error store are
    bit-identical."""
    for variant in ("per_ray", "shard_store", "err"):
        res = [r[variant] for r in ranks[world]]
        for it in range(3):
            assert len({r["digests"][it] for r in res}) == 1, (variant, it)
            assert res[0]["batch_idx"][it].shape == ((64,) if variant == "err" else (64 // world,))
        if variant == "per_ray":  # the ranks' draws differ
            assert not np.array_equal(res[0]["batch_idx"][0], res[1]["batch_idx"][0])


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_store_keeps_batch_idx_global(ranks, world):
    """With the sharded store a rank holds ceil(84 / ranks) views (padded
    by repetition) and draws only from them; its ``batch_idx`` is offset
    by its views' base, so the ids name the padded global store."""
    pixels = 8 * 8
    for r, res in enumerate(ranks[world]):
        res = res["shard_store"]
        views = res["views"]
        assert views == -(-84 // world)
        for idx in res["batch_idx"]:
            view = idx // pixels
            assert view.min() >= r * views and view.max() < (r + 1) * views


@pytest.mark.parametrize("world", WORLDS)
def test_error_store_is_one_update_of_the_gathered_draws(ranks, world):
    """Error-weighted draws: the step's ``batch_idx`` is every rank's own
    draws concatenated in rank order; each rank's store after the step is
    one ``update_error_store`` of the store before over that concatenation
    and the gathered ray errors, and bit-equal on every rank."""
    res = [r["err"] for r in ranks[world]]
    for it in range(3):
        gathered = np.concatenate([r["local_idx"][it] for r in res])
        want = update_error_store(torch.from_numpy(res[0]["stores"][it].copy()),
                                  torch.from_numpy(gathered),
                                  torch.from_numpy(res[0]["ray_err"][it])).numpy()
        for r in res:
            np.testing.assert_array_equal(r["batch_idx"][it], gathered)
            np.testing.assert_array_equal(r["stores"][it + 1], want)


@pytest.mark.parametrize("kind", ["in-step", "given batch"])
def test_one_rank_is_the_single_device_step(kind):
    """On one rank ``make_dp_train_step`` is ``train/step``'s own step: no
    process group, the same draws, bit-identical over three steps."""
    cfg = _instep_cfg("per_ray")
    ds = make_dataset(cfg)
    mesh = mesh_mod.make_mesh(1)
    a, b = step.init_state(cfg), step.init_state(cfg)
    if kind == "in-step":
        fa, fb = dp.make_dp_train_step(cfg, mesh, ds), step.make_train_step(cfg, ds)
        for it in range(3):
            a, aux_a = fa(a, step.step_generator(3, it, "cpu"))
            b, aux_b = fb(b, step.step_generator(3, it, "cpu"))
            assert torch.equal(aux_a["batch_idx"], aux_b["batch_idx"])
    else:
        fa = dp.make_dp_train_step(cfg, mesh)
        for it in range(3):
            batch = ds.sample_batch(torch.Generator().manual_seed(it), 64)
            a, aux_a = fa(a, batch, step.step_generator(3, it, "cpu"))
            b, aux_b = step.train_step(b, batch, step.step_generator(3, it, "cpu"), cfg)
    assert not dist.is_initialized()
    assert torch.equal(aux_a["loss"], aux_b["loss"])
    for (k, x), y in zip(a.params.state_dict().items(), b.params.state_dict().values()):
        assert torch.equal(x, y), k


def test_bare_train_on_one_device_creates_no_group_and_keeps_its_stream(tmp_path):
    """A bare ``train`` on one device (``num_devices`` 0 on the CPU: one
    rank) creates no process group and takes today's stream: the weights
    of ``make_train_step`` driven by ``step_generator(seed, it)``, bit for
    bit."""
    cfg = dataclasses.replace(_instep_cfg("per_ray"), eval_on_train=False,
                              save_dir=str(tmp_path / "ckpt"), log_dir=str(tmp_path / "logs"),
                              train=dataclasses.replace(_instep_cfg("per_ray").train, num_iter=3))
    got = loop.train(cfg, device="cpu")
    assert not dist.is_initialized()
    ds = make_dataset(cfg)
    want, fn = step.init_state(cfg), step.make_train_step(cfg, ds)
    for it in range(3):
        want, _ = fn(want, step.step_generator(cfg.train.seed, it, "cpu"))
    for (k, x), y in zip(got.params.state_dict().items(), want.params.state_dict().values()):
        assert torch.equal(x, y), k


@pytest.mark.parametrize("dataset", ["sphere", "llff"])
@pytest.mark.parametrize("shard,multiple", [(None, 4), ((0, 2), 1), ((1, 3), 1), ((2, 5), 2),
                                            ((1, 2), 4)])
def test_factory_slices_views_as_jax_does(dataset, shard, multiple):
    """``make_dataset(process_shard, local_multiple)``: the same views in the
    same order as the JAX factory's ``_slice``, padding by cyclic
    repetition included (84 sphere views; 6 LLFF views, all of the split,
    so 5 processes pad)."""
    d = DataConfig(dataset=dataset, img_dir=os.path.join(REPO, "tests", "data", "llff_mini"),
                   llff_holdout=0)
    cfg = dataclasses.replace(_cfg("kernel"), data=d)
    got = make_dataset(cfg, process_shard=shard, local_multiple=multiple)
    want = jfactory.make_dataset(_j(cfg), process_shard=shard, local_multiple=multiple)
    np.testing.assert_array_equal(got.images.numpy(), np.asarray(want.host_images))
    np.testing.assert_allclose(got.pose_data.numpy(), np.asarray(want.host_poses), atol=1e-6)


def test_launcher_refuses_more_cards_than_are_visible(monkeypatch):
    """NCCL puts one rank on a card: asking for more cards than are visible
    raises, naming both counts; nothing falls back to fewer or to the CPU.
    On the CPU a count is that many gloo ranks (0: one)."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="requested 2 devices, have 1"):
        launch.local_ranks(2, "cuda")
    assert launch.local_ranks(0, "cuda") == 1
    assert launch.local_ranks(0, "cpu") == 1 and launch.local_ranks(3, "cpu") == 3


def test_cli_num_devices_without_a_card_exits_non_zero(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device is available")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["train", "--dataset", "sphere", "--num_devices", "2", "--device", "cuda",
                  "--save_dir", str(tmp_path)])
    assert not os.listdir(tmp_path)


def _cli(argv, tmp) -> subprocess.CompletedProcess:
    env = dict(os.environ, OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    return subprocess.run([sys.executable, "-m", "nerf_rs_tpu_torch.cli", *argv], cwd=tmp,
                          env=env, capture_output=True, text=True, timeout=600)


def test_cli_train_and_render_on_two_ranks(tmp_path, capsys):
    """``train --device cpu --num_devices 2``: the primary alone writes (one
    run directory, one checkpoint) and prints; then ``render --num_devices
    2`` of a view writes the PNG that ``render --num_devices 1`` writes
    (within one 8-bit level: the frames' floats agree to 1e-6, see
    ``test_sharded_render_matches_the_one_rank_frame``)."""
    common = ["--dataset", "sphere", "--width", "8", "--height", "8", "--num_samples", "8",
              "--save_dir", str(tmp_path / "ckpt"), "--device", "cpu"]
    proc = _cli(["train", *common, "--num_rays", "32", "--num_iter", "3", "--eval_steps", "2",
                 "--log_dir", str(tmp_path / "logs"), "--num_devices", "2"], tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.count("done at step 3") == 1
    assert proc.stdout.count("iter=2, eval psnr=") == 1
    assert len(os.listdir(tmp_path / "ckpt")) == 1
    assert ckpt.latest_checkpoint(str(tmp_path / "ckpt")).endswith("-3.pt")
    assert len(os.listdir(tmp_path / "logs")) == 1
    proc = _cli(["render", *common, "--view", "0", "--out_dir", str(tmp_path / "r2"),
                 "--num_devices", "2"], tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.count("view-0.png") == 1
    assert cli.main(["render", *common, "--view", "0", "--out_dir", str(tmp_path / "r1"),
                     "--num_devices", "1"]) == 0
    one, two = (load_image(str(tmp_path / r / "view-0.png")).astype(int) for r in ("r1", "r2"))
    assert one.shape == two.shape and np.abs(one - two).max() <= 1  # 8-bit rounding


def test_cli_exits_non_zero_when_a_rank_raises(tmp_path):
    """A rank that raises (here both: no such image directory) makes the
    launcher raise and the CLI exit non-zero, with the rank's error."""
    proc = _cli(["train", "--dataset", "multiview_png", "--img_dir", str(tmp_path / "none"),
                 "--device", "cpu", "--num_devices", "2", "--save_dir", str(tmp_path / "ck")],
                tmp_path)
    assert proc.returncode != 0
    assert "FileNotFoundError" in proc.stderr or "No such file" in proc.stderr, proc.stderr[-2000:]
    assert not os.path.exists(tmp_path / "ck")
