"""The PyTorch port stands without JAX and without the JAX package: every
module of nerf_rs_tpu_torch imports, a frame renders, two train steps run
(kernel path and autograd path), one step each of the hierarchical and
mipnerf settings, of the factored field (both encode routes) and of the
hash grid (both table layouts), in a
process that never loads jax, jaxlib, flax,
optax or any module of nerf_rs_tpu. Plus checks of chip_smoke.py, which
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
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "nerf_rs_tpu"))
print("modules", len(names), "jax-family", bad)
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    env["CUDA_VISIBLE_DEVICES"] = ""
    return env


def test_port_imports_and_renders_without_jax():
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=_env(),
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr
    last = proc.stdout.strip().splitlines()[-1]
    assert last.endswith("jax-family []"), last
    assert int(last.split()[1]) >= 22  # every module was walked


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
