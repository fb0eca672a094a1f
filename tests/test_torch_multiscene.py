"""The port's multi-scene training (``nerf_rs_tpu_torch/parallel/multiscene.py``,
``train/loop.train_multiscene``, the stacked checkpoint and ``--scenes`` /
``--scene_index``) on the CPU: the step on 4 gloo ranks as 2 scene groups
x 2 (2 scenes) and as 1 x 4 (3 scenes), against the JAX package's
``make_multiscene_train_step`` on ``make_scene_mesh(n, 4)`` from JAX's
stacked initial weights (converted) and the same per-scene batches,
midpoint samples, through autograd at f32 (the JAX loop trains scenes
without the whole-ray kernel); 2 scenes on one rank against two
independent one-scene steps; the stacked checkpoint; and the CLI.

The ranks run in ``tests/torch_dp_ranks.py`` (no JAX). The reduced
gradient is compared (JAX's read off its first Adam moment), then the
weights after Adam within a tenth of the learning rate.
"""

import dataclasses
import os
import pickle
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_rs_tpu import config as jconfig
from nerf_rs_tpu.parallel import mesh as jmesh
from nerf_rs_tpu.parallel import multiscene as jms
from nerf_rs_tpu.train.step import Batch as JBatch
from nerf_rs_tpu_torch import cli
from nerf_rs_tpu_torch.config import (CameraConfig, Config, DataConfig, ModelConfig,
                                      RenderConfig, TrainConfig)
from nerf_rs_tpu_torch.convert import params_to_numpy
from nerf_rs_tpu_torch.parallel import mesh as mesh_mod, multiscene
from nerf_rs_tpu_torch.train import checkpoint as ckpt
from nerf_rs_tpu_torch.train import loop, step

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, LR = 32, 1e-3
# reduced gradients, port vs JAX, largest |diff| over the leaf's largest
# |g|: autograd at f32 on both sides, other summation orders (the DP
# step's bar, tests/test_torch_dp.py)
GRAD_TOL = 5e-6
SCENE_MESHES = {2: (2, 2), 3: (1, 4)}  # scenes -> (scene groups, data ranks) on 4 ranks


def _cfg() -> Config:
    return Config(
        camera=CameraConfig(width=8, height=8),
        model=ModelConfig(net_depth=2, net_width=16, skip_layer=9, feature_width=16,
                          view_head_width=8, pos_enc_levels=2, dir_enc_levels=1),
        render=RenderConfig(num_samples=8, randomized=False),
        train=TrainConfig(num_rays=N, learning_rate=LR, precision="f32"),
        data=DataConfig(dataset="sphere"),
    )


def _batches(n_scenes: int):
    out = []
    for s in range(n_scenes):
        rng = np.random.default_rng(10 + s)
        out.append(((rng.normal(size=(N, 3)) * 0.2).astype(np.float32),
                    rng.normal(size=(N, 3)).astype(np.float32),
                    rng.uniform(size=(N, 3)).astype(np.float32)))
    return out


def _jax_run(n_scenes: int):
    """JAX's stacked initial weights (per scene, numpy), then its step on
    the (scene, data) mesh of 4 devices: (params, reduced grads, losses)
    per scene."""
    jcfg = jconfig.Config.from_dict(_cfg().to_dict())
    ms = jms.init_multiscene_state(jax.random.PRNGKey(5), jcfg, n_scenes)
    start = [jax.tree.map(lambda x: np.asarray(x[i]), ms.params) for i in range(n_scenes)]
    mesh = jmesh.make_scene_mesh(n_scenes, 4)
    assert (mesh.shape[jmesh.SCENE_AXIS], mesh.shape[jmesh.DATA_AXIS]) == SCENE_MESHES[n_scenes]
    batch = jms.stack_batches([JBatch(*map(jnp.asarray, b)) for b in _batches(n_scenes)])
    new, aux = jms.make_multiscene_train_step(jcfg, mesh, n_scenes)(ms, batch,
                                                                   jax.random.PRNGKey(0))
    mu = new.opt_state[0].mu
    return (start,
            [jax.tree.map(lambda x: np.asarray(x[i]), new.params) for i in range(n_scenes)],
            [jax.tree.map(lambda m: np.asarray(m[i]) / np.float32(0.1), mu)
             for i in range(n_scenes)],
            np.asarray(aux["loss"]))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's runs and 4 gloo ranks' results of both scene meshes."""
    jax_runs = {n: _jax_run(n) for n in SCENE_MESHES}
    cases = [{"kind": "multiscene", "name": n, "cfg": _cfg().to_dict(),
              "scene_params": jax_runs[n][0], "batches": _batches(n)} for n in SCENE_MESHES]
    tmp = tmp_path_factory.mktemp("ranks")
    path = os.path.join(tmp, "cases.pkl")
    with open(path, "wb") as f:
        pickle.dump(cases, f)
    env = dict(os.environ, OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, os.path.join(REPO, "tests", "torch_dp_ranks.py"),
                           "4", path, str(tmp)], env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    ranks = []
    for r in range(4):
        with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
            ranks.append(dict(zip(SCENE_MESHES, pickle.load(f))))
    return jax_runs, ranks


def _tree(arrays: dict) -> dict:
    return params_to_numpy({k: torch.from_numpy(v) for k, v in arrays.items()})


def _max_rel(got: dict, want: dict) -> float:
    return max(float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-12))
               for g, w in zip(jax.tree_util.tree_leaves(_tree(got)),
                               jax.tree_util.tree_leaves(want)))


@pytest.mark.parametrize("n_scenes", list(SCENE_MESHES))
def test_multiscene_step_matches_jax(runs, n_scenes):
    """Each rank holds its scene group's scenes (2 scenes: ranks 0-1 scene
    0, ranks 2-3 scene 1; 3 scenes: every rank all three, the rays split 4
    ways); each scene's reduced gradient matches JAX's (``GRAD_TOL``), its
    loss at rtol 1e-5 (the JAX package's DP bar), its weights after Adam
    within lr / 10; the ranks of a group hold bit-identical states."""
    jax_runs, ranks = runs
    _, params_j, grads_j, loss_j = jax_runs[n_scenes]
    rows, cols = SCENE_MESHES[n_scenes]
    k = n_scenes // rows
    digests = {}
    for r, res in enumerate(ranks):
        res = res[n_scenes]
        assert res["mesh"] == ({"scene": rows, "data": cols})
        assert res["scenes"] == list(range((r // cols) * k, (r // cols + 1) * k))
        for scene, out in zip(res["scenes"], res["results"]):
            assert _max_rel(out["grads"], grads_j[scene]) <= GRAD_TOL
            np.testing.assert_allclose(out["aux"]["loss"], loss_j[scene], rtol=1e-5)
            for g, w in zip(jax.tree_util.tree_leaves(_tree(out["params"])),
                            jax.tree_util.tree_leaves(params_j[scene])):
                np.testing.assert_allclose(g, w, atol=0.1 * LR)
            digests.setdefault(scene, set()).add(out["digest"])
    assert sorted(digests) == list(range(n_scenes))
    assert all(len(d) == 1 for d in digests.values())


def test_two_scenes_on_one_rank_are_two_independent_steps():
    """On one rank (a 1 x 1 scene mesh) the step holds both scenes and
    steps each as ``train_step`` would alone, with its own generator
    (``shard_generator(g, scene, 0)``): bit-identical, twice."""
    cfg = dataclasses.replace(_cfg(), render=RenderConfig(num_samples=8))  # jittered
    mesh = mesh_mod.make_scene_mesh(2)
    assert mesh.shape == {"scene": 1, "data": 1}
    states = multiscene.init_multiscene_state(cfg, mesh, 2)
    alone = [step.init_state(multiscene.scene_config(cfg, i)) for i in range(2)]
    fn = multiscene.make_multiscene_train_step(cfg, mesh, 2)
    from nerf_rs_tpu_torch.parallel.dp import shard_generator

    for it in range(2):
        g = step.step_generator(0, it, "cpu")
        batches = [step.Batch(*map(torch.from_numpy, b)) for b in _batches(2)]
        states, auxes = fn(states, batches, g)
        for i in range(2):
            alone[i], aux = step.train_step(alone[i], batches[i], shard_generator(g, i, 0), cfg)
            assert torch.equal(aux["loss"], auxes[i]["loss"])
    for a, b in zip(states, alone):
        for (k, x), y in zip(a.params.state_dict().items(), b.params.state_dict().values()):
            assert torch.equal(x, y), k
    # each scene's weights come from its own stream
    assert not torch.equal(states[0].params.trunk[0].w, states[1].params.trunk[0].w)


def test_stacked_checkpoint_round_trip(tmp_path):
    """``save_scenes`` stacks every tensor of the scenes' files on a leading
    scene axis; scene i reads back as its own state (weights, Adam, step),
    and a one-scene file and a stacked one refuse each other's reads."""
    cfg = _cfg()
    states = [step.init_state(multiscene.scene_config(cfg, i)) for i in range(3)]
    for i, st in enumerate(states):
        st, _ = step.train_step(st, step.Batch(*map(torch.from_numpy, _batches(3)[i])), None, cfg)
    path = ckpt.save_scenes([ckpt.state_blob(st) for st in states], str(tmp_path))
    blob = torch.load(path, weights_only=True)
    assert blob["scenes"] == 3 and blob["params"]["trunk.0.w"].shape[0] == 3
    for i, st in enumerate(states):
        fresh = ckpt.restore(path, step.init_state(cfg), scene=i)
        assert fresh.step == 1
        for (k, x), y in zip(fresh.params.state_dict().items(), st.params.state_dict().values()):
            assert torch.equal(x, y), k
        assert torch.equal(fresh.optimizer.state_dict()["state"][0]["exp_avg"],
                           st.optimizer.state_dict()["state"][0]["exp_avg"])
    with pytest.raises(ValueError, match="--scene_index"):
        ckpt.restore_weights(path, step.init_state(cfg).params)
    with pytest.raises(ValueError, match="scene index 3"):
        ckpt.restore_weights(path, step.init_state(cfg).params, scene=3)
    single = ckpt.save(states[0], str(tmp_path / "one"))
    with pytest.raises(ValueError, match="one scene"):
        ckpt.restore_weights(single, step.init_state(cfg).params, scene=0)


def test_cli_scenes_then_scene_index(tmp_path, capsys):
    """``train --scenes sphere,flat_sphere`` on one rank writes one stacked
    checkpoint; ``eval``, ``render`` and ``export`` with ``--scene_index 1``
    read scene 1's weights (those ``train_multiscene`` ends with) and run."""
    common = ["--scenes", "sphere,flat_sphere", "--width", "8", "--height", "8",
              "--num_samples", "8", "--device", "cpu", "--save_dir", str(tmp_path / "ckpt")]
    assert cli.main(["train", *common, "--num_rays", "32", "--num_iter", "3", "--eval_steps",
                     "2", "--log_dir", str(tmp_path / "logs")]) == 0
    out = capsys.readouterr().out
    assert "iter=2, per-scene eval psnr=[" in out and "done at step 3 (2 scenes)" in out
    assert len(os.listdir(tmp_path / "ckpt")) == 1
    path = ckpt.latest_checkpoint(str(tmp_path / "ckpt"))
    cfg = cli.config_from_args(cli.build_parser().parse_args(["eval", *common]))
    states = loop.train_multiscene(dataclasses.replace(cfg, do_train=False,
                                                       log_dir=str(tmp_path / "l2")),
                                   scene_specs=["sphere", "flat_sphere"], device="cpu")
    params, _, _, loaded = cli._load_params(cfg, "cpu", scene=1)
    assert loaded == path
    for (k, x), y in zip(params.state_dict().items(), states[1].params.state_dict().values()):
        assert torch.equal(x, y), k
    assert not torch.equal(states[0].params.trunk[0].w, states[1].params.trunk[0].w)
    assert cli.main(["eval", *common, "--scene_index", "1", "--max_views", "1"]) == 0
    assert re.search(r"view   0: psnr \d+\.\d\d", capsys.readouterr().out)
    assert cli.main(["render", *common, "--scene_index", "1", "--view", "0", "--out_dir",
                     str(tmp_path / "r")]) == 0
    assert os.path.exists(tmp_path / "r" / "view-0.png")
    assert cli.main(["export", *common, "--scene_index", "1", "--grid_res", "8", "--out",
                     str(tmp_path / "x" / "f")]) == 0
    assert os.path.exists(tmp_path / "x" / "f.npz")
    with pytest.raises(ValueError, match="--scenes"):  # a stacked file needs its scene
        cli.main(["eval", "--dataset", "sphere", *common[2:], "--max_views", "1"])


def test_cli_scenes_on_four_ranks(tmp_path):
    """``train --scenes sphere,flat_sphere --num_devices 4`` on the CPU: a
    2 x 2 scene mesh whose primary gathers both scene groups' states into
    one stacked checkpoint and prints per-scene losses once."""
    env = dict(os.environ, OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run(
        [sys.executable, "-m", "nerf_rs_tpu_torch.cli", "train", "--scenes", "sphere,flat_sphere",
         "--width", "8", "--height", "8", "--num_samples", "8", "--num_rays", "32",
         "--num_iter", "2", "--eval_on_train", "false", "--device", "cpu", "--num_devices", "4",
         "--save_dir", str(tmp_path / "ckpt"), "--log_dir", str(tmp_path / "logs")],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.count("iter=0, per-scene loss=[") == 1
    assert proc.stdout.count("done at step 2 (2 scenes)") == 1
    (name,) = os.listdir(tmp_path / "ckpt")
    blob = torch.load(tmp_path / "ckpt" / name, weights_only=True)
    assert blob["scenes"] == 2 and blob["step"] == 2
    w = blob["params"]["trunk.0.w"]
    assert w.shape[0] == 2 and not torch.equal(w[0], w[1])
