"""Multi-scene training: one radiance field per scene, the scenes spread
over the ranks, the counterpart of ``nerf_rs_tpu/parallel/multiscene.py``.

The JAX package stacks every leaf on a leading scene axis and shards that
axis over the mesh. Here each rank holds the scenes of its scene group as a
list of ``TrainState``s: on a 1-D (data) mesh rank r holds scenes [r k, (r
+ 1) k) of n = k x ranks and no rank talks to another; on a 2-D (scene,
data) mesh (``mesh.make_scene_mesh``) scene group g holds scenes [g k, (g
+ 1) k) and each scene's rays are data-parallel within the group
(``dp.reduce_grads`` over ``data``); groups never talk.

Scene i's initial weights are those of the seed ``scene_seed(seed, i)``,
the first draw of numpy's ``default_rng([seed, i])`` in [0, 2^31): every
scene has its own numpy stream, the same on every rank and device.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..config import Config
from ..train import step as step_mod
from ..train.step import Batch, TrainState
from . import dist_init
from .dp import dp_step, place_batch, shard_generator
from .mesh import DATA_AXIS, SCENE_AXIS, Mesh


def scene_seed(seed: int, scene: int) -> int:
    return int(np.random.default_rng([seed, scene]).integers(0, 2 ** 31))


def scene_config(cfg: Config, scene: int) -> Config:
    """``cfg`` with scene ``scene``'s seed (its weights' stream)."""
    return dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, seed=scene_seed(cfg.train.seed, scene)))


def _scene_axis(mesh: Mesh) -> str:
    return SCENE_AXIS if SCENE_AXIS in mesh.shape else DATA_AXIS


def local_scenes(mesh: Mesh, n_scenes: int) -> range:
    """The scenes this rank holds: its scene group's contiguous block."""
    axis = _scene_axis(mesh)
    if n_scenes % mesh.shape[axis]:
        raise ValueError(f"{n_scenes} scenes must divide over {mesh.shape[axis]} scene shards")
    k = n_scenes // mesh.shape[axis]
    return range(mesh.coords[axis] * k, (mesh.coords[axis] + 1) * k)


def init_multiscene_state(cfg: Config, mesh: Mesh, n_scenes: int,
                          device=None) -> List[TrainState]:
    """This rank's scenes' fresh states (scene i from ``scene_seed``)."""
    return [step_mod.init_state(scene_config(cfg, i), device)
            for i in local_scenes(mesh, n_scenes)]


def make_multiscene_train_step(cfg: Config, mesh: Mesh, n_scenes: int):
    """fn(states, batches, generator) -> (states, auxes) over this rank's
    scenes: ``batches`` holds each scene's global batch (a rank of a 2-D
    mesh keeps its block of each), and scene i's draws come from the step's
    generator with (i, data shard) mixed in. On a 2-D mesh each scene's
    gradients are averaged over the data group between the backward pass
    and Adam (JAX's ``pmean`` over ``data``); on a 1-D mesh each scene steps
    alone."""
    two_d = SCENE_AXIS in mesh.shape
    scenes = local_scenes(mesh, n_scenes)
    dshard = mesh.coords[DATA_AXIS] if two_d else 0

    def step(states: List[TrainState], batches: Sequence[Batch], generator: torch.Generator):
        out_states, auxes = [], []
        for state, batch, scene in zip(states, batches, scenes):
            g = shard_generator(generator, scene, dshard)
            if two_d:
                state, aux = dp_step(state, place_batch(batch, mesh), g, cfg, mesh)
            else:
                state, aux = step_mod.train_step(state, batch, g, cfg)
            out_states.append(state)
            auxes.append(aux)
        return out_states, auxes

    return step


class MultiSceneSampler:
    """Per-ray batches of the given scenes' datasets (every scene of one
    camera size), scene i's from the generator with i mixed in: the same
    global batch on every rank of its group."""

    def __init__(self, datasets: List, scenes: Sequence[int]):
        if not datasets or len(datasets) != len(scenes):
            raise ValueError("one dataset per scene")
        self.datasets, self.scenes = datasets, list(scenes)

    def sample(self, generator: torch.Generator, num_rays: int) -> List[Batch]:
        return [ds.sample_batch(shard_generator(generator, s), num_rays)
                for ds, s in zip(self.datasets, self.scenes)]


def _leaders(mesh: Mesh) -> range:
    """The global ranks of the scene groups' first data ranks, in scene
    order (a group's ranks hold the same states)."""
    axis = _scene_axis(mesh)
    stride = dist_init.world_size() // mesh.shape[axis]
    return range(0, dist_init.world_size(), stride)


def gather_scenes(values: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every scene's value, in scene order, on every rank, from each rank's
    values of its own scenes (its group leader's count)."""
    if dist_init.world_size() == 1:
        return values
    parts = [torch.empty_like(values) for _ in range(dist_init.world_size())]
    dist.all_gather(parts, values.contiguous())
    return torch.cat([parts[r] for r in _leaders(mesh)])


def gather_scene_objects(objs: list, mesh: Mesh):
    """Every scene's object, in scene order, on the primary rank (None on
    the others), from each rank's objects of its own scenes."""
    if dist_init.world_size() == 1:
        return objs
    leader = mesh.coords[DATA_AXIS] == 0 or SCENE_AXIS not in mesh.shape
    parts = [None] * dist_init.world_size() if dist_init.is_primary() else None
    dist.gather_object(objs if leader else None, parts, dst=0)
    if parts is None:
        return None
    return [o for r in _leaders(mesh) for o in parts[r]]
