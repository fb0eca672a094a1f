"""The PyTorch port stands without JAX and without the JAX package: every
module of nerf_rs_tpu_torch imports, a frame renders, two train steps run
(kernel path and autograd path), one step each of the hierarchical and
mipnerf settings, of the factored field (both encode routes), of the
hash grid (both table layouts), of the unbounded and proposal
settings (with a frame through the proposal) and of the record preset's
settings with a multiscale batch and an occupancy grid (its update and a
frame through it), and the shared-network fast fine pass; slice 6's
datasets (the PNG decoder, Blender, LLFF, a procedural scene written by
the port, one step in each batch mode on it, the host pipeline through the
port's own copy of the C++ gather, the NDC warp); slice 7's EMA,
accumulated and noisy steps, the event writer, the profiler window, the
diagnostics, the GIF writer, the density export and its mesh;
slice 8's ``parallel/`` (the meshes of one rank, and one step of ``cli
train --device cpu --num_devices 2``: two gloo ranks spawned by the port's
launcher); slice 10's compat step and frame, screen encodings and sphere
oracles, in a process that never loads jax, jaxlib, flax, optax or any
module of nerf_rs_tpu, nor tensorboard, tensorboardX, PIL or imageio, which
the card's machine lacks; jax, jaxlib, flax and optax cannot even be
imported there, nor in the ranks it spawns (a blocker package first on
their path). Plus checks of chip_smoke.py, which
runs only on the card: an undefined-name lint (the idea of
test_bench_lint.py), no import of the JAX package in any form, and that
without a card it exits non-zero instead of falling back to the CPU.
"""

import ast
import builtins
import os
import pathlib
import subprocess
import symtable
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent

_PROBE = r"""
import importlib, pkgutil, sys
import torch
torch.set_num_threads(1)
import nerf_rs_tpu_torch
names = [m.name for m in pkgutil.walk_packages(nerf_rs_tpu_torch.__path__, "nerf_rs_tpu_torch.")
         if m.name != "nerf_rs_tpu_torch.__main__"]
for name in names:
    importlib.import_module(name)
from nerf_rs_tpu_torch import CameraConfig, Config, RenderConfig
from nerf_rs_tpu_torch.models.mlp import init_nerf_params
from nerf_rs_tpu_torch.ops import rays
from nerf_rs_tpu_torch.render import render_frame
cfg = Config(camera=CameraConfig(width=8, height=8), render=RenderConfig(num_samples=8))
model = init_nerf_params(cfg.model, 0)
o, d = rays.ray_grid(rays.pose_from_yaw_pitch(0.3, 0.2), cfg.camera)
rgb, depth, acc = render_frame(cfg, model, o, d)
assert rgb.shape == (8, 8, 3) and bool(torch.isfinite(rgb).all())
import dataclasses
from nerf_rs_tpu_torch import DataConfig, ModelConfig, TrainConfig
from nerf_rs_tpu_torch.data.factory import make_dataset
from nerf_rs_tpu_torch.train import step
small = ModelConfig(net_depth=2, net_width=16, skip_layer=1, feature_width=16, view_head_width=16)
for kernel in (True, False):  # the train kernel's plain version, then autograd
    tcfg = dataclasses.replace(cfg, model=small, train=TrainConfig(num_rays=16),
                               data=DataConfig(dataset="sphere"), use_whole_ray_train=kernel)
    state = step.init_state(tcfg)
    fn = step.make_train_step(tcfg, make_dataset(tcfg))
    for it in range(2):
        state, aux = fn(state, step.step_generator(0, it, "cpu"))
    assert state.step == 2 and bool(torch.isfinite(aux["loss"]))
# one step of each hierarchical preset's settings, through the kernel chain
hier = RenderConfig(num_samples=8, num_fine_samples=16, white_background=True)
for model, render in ((small, hier),
                      (dataclasses.replace(small, ipe=True, sigma_activation="softplus"),
                       dataclasses.replace(hier, share_network=True, fine_mode="standalone"))):
    tcfg = dataclasses.replace(cfg, model=model, render=render, train=TrainConfig(num_rays=16),
                               data=DataConfig(dataset="sphere"), use_whole_ray_train=True)
    state = step.init_state(tcfg)
    fn = step.make_train_step(tcfg, make_dataset(tcfg))
    state, aux = fn(state, step.step_generator(0, 0, "cpu"))
    assert state.step == 1 and bool(torch.isfinite(aux["loss_fine"]))
    assert (state.fine_params is None) == render.share_network
# one step of the factored field, through K3's plain versions and through
# the dense-hat encode
fac = ModelConfig(arch="factored", fac_levels=2, fac_base_res=4, fac_max_res=8, fac_comps=4,
                  sigma_activation="softplus")
for fused in (True, False):
    tcfg = dataclasses.replace(cfg, model=dataclasses.replace(fac, fac_fused=fused),
                               train=TrainConfig(num_rays=16, learning_rate=1e-2),
                               data=DataConfig(dataset="sphere"))
    state = step.init_state(tcfg)
    fn = step.make_train_step(tcfg, make_dataset(tcfg))
    state, aux = fn(state, step.step_generator(0, 0, "cpu"))
    assert state.step == 1 and bool(torch.isfinite(aux["loss"]))
# one step of the hash grid in each table layout, through K4's plain versions
for brick in (True, False):
    hcfg = ModelConfig(arch="hashgrid", hash_levels=2, hash_table_log2=8, hash_base_res=4,
                       hash_max_res=8, sigma_activation="softplus", hash_brick=brick)
    tcfg = dataclasses.replace(cfg, model=hcfg, train=TrainConfig(num_rays=16, learning_rate=1e-2),
                               data=DataConfig(dataset="sphere"))
    state = step.init_state(tcfg)
    fn = step.make_train_step(tcfg, make_dataset(tcfg))
    state, aux = fn(state, step.step_generator(0, 0, "cpu"))
    assert state.step == 1 and bool(torch.isfinite(aux["loss"]))
# one step of each unbounded-scene preset's settings through the kernel
# route (the proposal net, the contraction, the distortion loss), then
# a frame through the proposal
from nerf_rs_tpu_torch import ProposalConfig
unb = dataclasses.replace(cfg, model=dataclasses.replace(small, contract=True),
                          camera=CameraConfig(width=8, height=8, near=0.3, far=60.0),
                          render=RenderConfig(num_samples=8, sampling_space="disparity"),
                          proposal=ProposalConfig(enabled=True, num_samples=8, num_levels=2,
                                                  net_width=16, anneal_steps=10),
                          train=TrainConfig(num_rays=16, distortion_weight=0.01),
                          data=DataConfig(dataset="sphere"), use_whole_ray_train=True)
prop = dataclasses.replace(unb, model=small, camera=cfg.camera, render=RenderConfig(num_samples=16),
                           proposal=ProposalConfig(enabled=True, num_samples=8, net_width=16),
                           train=TrainConfig(num_rays=16))
for tcfg in (unb, prop):
    state = step.init_state(tcfg)
    fn = step.make_train_step(tcfg, make_dataset(tcfg))
    state, aux = fn(state, step.step_generator(0, 0, "cpu"))
    assert state.step == 1 and bool(torch.isfinite(aux["loss"])) and "loss_prop" in aux
    rgb, _, _ = render_frame(tcfg, state.params, o, d, fine_params=state.fine_params)
    assert bool(torch.isfinite(rgb).all())
# the record preset's settings (IPE, one shared field, a union fine pass, an
# occupancy grid guiding the coarse edges) through the kernel chain, the
# grid's update, a multiscale batch, and the shared-network fast fine pass
from nerf_rs_tpu_torch.ops import occupancy, render as render_ops
from nerf_rs_tpu_torch.train.loop import update_occupancy
rec = dataclasses.replace(cfg, model=dataclasses.replace(small, ipe=True, sigma_activation="softplus"),
                          render=RenderConfig(num_samples=8, num_fine_samples=8, share_network=True,
                                              white_background=True, occ_res=8, occ_aabb=1.6),
                          train=TrainConfig(num_rays=16),
                          data=DataConfig(dataset="sphere", multiscale_levels=2),
                          use_whole_ray_train=True)
state = step.init_state(rec)
fn = step.make_train_step(rec, make_dataset(rec))
state, aux = fn(state, step.step_generator(0, 0, "cpu"))
state.grid = update_occupancy(state, rec, 0)
state, aux = fn(state, step.step_generator(0, 1, "cpu"))
assert state.step == 2 and bool(torch.isfinite(aux["loss_fine"])) and state.grid.shape == (8, 8, 8)
rgb, _, _ = render_frame(rec, state.params, o, d, grid=state.grid)
assert bool(torch.isfinite(rgb).all())
_, fine = render_ops.render_rays(init_nerf_params(small, 0), o, d, small,
                                 RenderConfig(num_samples=8, num_fine_samples=8,
                                              share_network=True), cfg.camera, randomized=False)
assert fine.weights.shape == (8, 8, 16)
# slice 6: the port's PNG decoder on the fixtures, the Blender and LLFF
# loaders, a procedural scene written by the port's make-scene entry, one
# step on it through the c2w rays (per ray, multiview, error-weighted, the
# host pipeline through the port's own C++ gather) and the NDC warp
import os, tempfile
import numpy as np
from nerf_rs_tpu_torch.data import blender, images, llff, native_loader, procedural
from nerf_rs_tpu_torch.data.dataset import update_error_store
from nerf_rs_tpu_torch.data.pipeline import PrefetchPipeline
from nerf_rs_tpu_torch.tools import make_scene
assert images.load_image("tests/data/blender_mini/train/r_0.png").shape == (32, 32, 4)
assert blender.load_blender("tests/data/blender_mini").images.shape[0] == 4
assert llff.load_llff("tests/data/llff_mini", split="all").c2w.shape == (6, 4, 4)
assert native_loader.SRC.parent.name == "data" and native_loader.SRC.parent.parent.name == "nerf_rs_tpu_torch"
assert native_loader.library_path().parent.parent.name == "kernels"
with tempfile.TemporaryDirectory() as tmp:
    assert make_scene.main(["--out", tmp, "--size", "8", "--n_train", "2", "--n_val", "1",
                            "--n_test", "1", "--num_samples", "16", "--device", "cpu"]) == 0
    bcfg = dataclasses.replace(cfg, model=small, train=TrainConfig(num_rays=16),
                               data=DataConfig(dataset="blender", img_dir=tmp))
    bds = make_dataset(bcfg)
    assert bds.mode == "c2w" and bds.camera.focal is not None
    err = bds.init_error_store()
    for sample in (lambda g: bds.sample_batch(g, 16),
                   lambda g: bds.sample_multiview_batch(g, 16, 4),
                   lambda g: bds.sample_batch_error_weighted(g, 16, err, 0.5)):
        state = step.init_state(bcfg)
        state, aux = step.make_train_step(bcfg, bds, sample)(state, step.step_generator(0, 0, "cpu"))
        assert bool(torch.isfinite(aux["loss"]))
    update_error_store(err, aux["batch_idx"], aux["ray_err"])
    with PrefetchPipeline(bds.host_images, bds.camera, c2w=bds.host_poses, num_rays=16,
                          use_native=True) as pipe:
        batch = next(pipe)
    assert batch.origins.shape == (16, 3) and bool(torch.isfinite(batch.gold).all())
    o2, d2 = rays.ndc_rays(*rays.ray_grid_c2w(procedural.look_at_c2w((0.1, 0.0, 0.5), (0, 0, -4), (0, 1, 0)),
                                              4, 4, 5.0),
                           CameraConfig(width=4, height=4, focal=5.0, near=0.0, far=1.0, ndc=True))
    assert bool(torch.isfinite(o2).all() and torch.isfinite(d2).all())
# slice 7: an EMA step, an accumulated step with sigma noise, the event
# writer, the profiler window, the diagnostics, the GIF, the export and its
# mesh, the intersections
from nerf_rs_tpu_torch.ops import intersect
from nerf_rs_tpu_torch.train.loop import log_diagnostics
from nerf_rs_tpu_torch.utils import export, mesh, profiling, tb
ecfg = dataclasses.replace(cfg, model=small, data=DataConfig(dataset="sphere"),
                           render=RenderConfig(num_samples=8, raw_noise_std=1.0),
                           train=TrainConfig(num_rays=16, ema_decay=0.9, accumulation_steps=4))
state = step.init_state(ecfg)
eds = make_dataset(ecfg)
state, aux = step.make_train_step(ecfg, eds)(state, step.step_generator(0, 0, "cpu"))
assert bool(torch.isfinite(aux["loss"])) and aux["ray_err"].shape == (16,)
assert step.with_ema_params(state).params is state.ema
with tempfile.TemporaryDirectory() as tmp:
    logger = tb.TBLogger(tmp, "run")
    with profiling.trace(logger.dir) as trace_path:
        log_diagnostics(logger, eds, ecfg, 1, state=state)
    logger.close()
    assert os.path.getsize(logger.path) > 0 and os.path.exists(trace_path)
    images.save_gif(os.path.join(tmp, "a.gif"), rgb[None].expand(2, 8, 8, 3))
    with open(os.path.join(tmp, "a.gif"), "rb") as f:
        assert images.gif_frames(f.read()) == ((8, 8), [(8, 8), (8, 8)])
sigma, crgb = export.sample_density_grid(state.params, small, res=8)
verts, faces, _ = mesh.marching_tetrahedra(sigma, float(np.median(sigma)), 1.6, rgb=crgb)
assert sigma.shape == (8, 8, 8) and faces.shape[1] == 3
inter = intersect.pairwise_view_intersections(o.reshape(-1, 3), d.reshape(-1, 3),
                                              o.reshape(-1, 3), d.reshape(-1, 3), 2.0)
assert intersect.trace_intersections_to_screen(inter, 8, 8).shape == (100, 100)
# slice 8: the meshes of one rank, then one data-parallel step on two gloo
# ranks spawned by the CLI's launcher (they inherit the blocked path)
from nerf_rs_tpu_torch import cli
from nerf_rs_tpu_torch.parallel import mesh as pmesh
assert pmesh.make_scene_mesh(3).shape == {"scene": 1, "data": 1}
assert pmesh.pad_to_shards(13, pmesh.make_mesh()) == 13
with tempfile.TemporaryDirectory() as tmp:
    assert cli.main(["train", "--dataset", "sphere", "--width", "8", "--height", "8",
                     "--num_samples", "8", "--num_rays", "16", "--num_iter", "1",
                     "--eval_on_train", "false", "--device", "cpu", "--num_devices", "2",
                     "--save_dir", tmp + "/ck", "--log_dir", tmp + "/logs"]) == 0
    assert len(os.listdir(tmp + "/ck")) == 1 and len(os.listdir(tmp + "/logs")) == 1
# slice 10: a compat step and frame, the screen encodings, the sphere oracles
from nerf_rs_tpu_torch.config import reference_compat_config
from nerf_rs_tpu_torch.data import synthetic
from nerf_rs_tpu_torch.models import encoding, mlp
ccfg = dataclasses.replace(reference_compat_config(), camera=cfg.camera,
                           render=dataclasses.replace(reference_compat_config().render,
                                                      num_samples=8),
                           train=TrainConfig(num_rays=16, precision="f32"))
cstate = step.init_state(ccfg)
cstate, aux = step.train_step(cstate, eds.sample_batch(torch.Generator().manual_seed(0), 16),
                              torch.Generator().manual_seed(1), ccfg)
assert bool(torch.isfinite(aux["loss"])) and mlp.count_params(cstate.params) == 76455
rgb, _, _ = render_frame(ccfg, cstate.params, o, d)
assert rgb.shape == (8, 8, 3) and bool(torch.isfinite(rgb).all())
assert encoding.screen_fourier(torch.tensor([[3, 4]]), 8, 8, 6).shape == (1, 6)
sig, hit = synthetic.render_sphere_gold(o.reshape(-1, 3), d.reshape(-1, 3),
                                        torch.linspace(0.0, 4.0, 8).expand(64, 8))
assert sig.shape == (64, 8) and hit.shape == (64,)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "nerf_rs_tpu",
                                    "tensorboard", "tensorboardX", "PIL", "imageio"))
print("modules", len(names), "jax-family", bad)
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    env["CUDA_VISIBLE_DEVICES"] = ""
    return env


def test_port_imports_and_renders_without_jax(tmp_path):
    env = _env()
    for name in ("jax", "jaxlib", "flax", "optax"):
        (tmp_path / name).mkdir()
        (tmp_path / name / "__init__.py").write_text(
            f"raise ImportError('the port imports {name}')\n")
    env["PYTHONPATH"] = str(tmp_path) + os.pathsep + env["PYTHONPATH"]
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr
    last = proc.stdout.strip().splitlines()[-1]
    assert last.endswith("jax-family []"), last
    assert int(last.split()[1]) >= 30  # every module was walked


def _bound_names(tab):
    return {s.get_name() for s in tab.get_symbols()
            if s.is_local() or s.is_parameter() or s.is_imported()}


def _undefined(tab, enclosing, problems):
    for child in tab.get_children():
        bound = enclosing
        if child.get_type() == "function":
            bound = enclosing | _bound_names(child)
            for s in child.get_symbols():
                n = s.get_name()
                if s.is_referenced() and n not in bound and not hasattr(builtins, n):
                    problems.append(f"{child.get_name()}(): {n}")
        _undefined(child, bound, problems)


def test_chip_smoke_has_no_undefined_names():
    src = (REPO / "chip_smoke.py").read_text()
    tab = symtable.symtable(src, "chip_smoke.py", "exec")
    problems = []
    _undefined(tab, {s.get_name() for s in tab.get_symbols()}, problems)
    assert not problems, f"chip_smoke.py would raise NameError: {problems}"
    assert "import jax" not in src and "from nerf_rs_tpu." not in src


def test_chip_smoke_imports_nothing_of_jax_or_the_jax_package():
    """Every import in chip_smoke.py, in any form (import x, import x.y,
    from x import y, from x.y import z, importlib by name)."""
    src = (REPO / "chip_smoke.py").read_text()
    names = []
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append(node.module or "")
        elif isinstance(node, ast.Call) and node.args and isinstance(node.args[0], ast.Constant):
            fn = node.func
            if getattr(fn, "attr", getattr(fn, "id", "")) in ("import_module", "__import__"):
                names.append(str(node.args[0].value))
    bad = [n for n in names
           if n.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "nerf_rs_tpu")]
    assert not bad, bad
    assert "nerf_rs_tpu_torch" in names


def test_chip_smoke_refuses_to_run_without_a_card():
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=_env(),
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "no CUDA device" in proc.stderr
