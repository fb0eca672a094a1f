"""The JAX package's device meshes as process groups, the counterpart of
``nerf_rs_tpu/parallel/mesh.py``.

A ``Mesh`` is one rank's view of a JAX mesh: the mesh's axes and sizes
(``shape``, in the JAX mesh's axis order), this rank's index along each
(``coords``) and the process group it shares each axis with (``groups``;
None for an axis of one rank, which needs no collective). The ranks fill
the mesh in row-major order, as ``np.asarray(devices).reshape(...)`` lays
the JAX devices out: global rank r sits at (r // cols, r % cols) of a 2-D
mesh. JAX's "shard on the data axis" is "rank in the data group", and its
``pmean`` over an axis is ``mean_``: an ``all_reduce`` (sum) over the
axis's group, then a division by its size. Every rank creates every group
in the same order (``torch.distributed.new_group`` asks that of all ranks).
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.distributed as dist

from . import dist_init

DATA_AXIS = "data"
SCENE_AXIS = "scene"
DCN_AXIS = "dcn"


class Mesh:
    """One rank's axes, coordinates and groups (see the module doc)."""

    def __init__(self, shape: Dict[str, int], coords: Dict[str, int],
                 groups: Dict[str, Optional[object]]):
        self.shape, self.coords, self.groups = shape, coords, groups


def _world(num_devices: int) -> int:
    world = dist_init.world_size()
    if num_devices and num_devices != world:
        raise ValueError(f"requested {num_devices} devices, the run has {world} rank(s)")
    return world


def _grid(rows: int, cols: int, axes) -> Mesh:
    """The (rows, cols) mesh over the world, with a group per row (the
    second axis) and per column (the first)."""
    r = dist_init.rank()
    row, col = divmod(r, cols)
    world = rows * cols

    def groups(members):  # every rank creates every group, in this order
        if len(members[0]) == 1:
            return [None] * len(members)
        if len(members[0]) == world:
            return [dist.group.WORLD]
        return [dist.new_group(m) for m in members]

    row_groups = groups([list(range(i * cols, (i + 1) * cols)) for i in range(rows)])
    col_groups = groups([list(range(j, world, cols)) for j in range(cols)])
    return Mesh({axes[0]: rows, axes[1]: cols}, {axes[0]: row, axes[1]: col},
                {axes[0]: col_groups[col % len(col_groups)],
                 axes[1]: row_groups[row % len(row_groups)]})


def make_mesh(num_devices: int = 0) -> Mesh:
    """The 1-D data mesh over the world (``num_devices`` 0: every rank; a
    count must be the world's, which the launcher made of it)."""
    world = _world(num_devices)
    return Mesh({DATA_AXIS: world}, {DATA_AXIS: dist_init.rank()},
                {DATA_AXIS: dist.group.WORLD if world > 1 else None})


def make_scene_mesh(n_scenes: int, num_devices: int = 0) -> Mesh:
    """The 2-D (scene, data) mesh of multi-scene training: gcd(n_scenes,
    world) scene groups, the rays of each group's scenes data-parallel
    within it (2 scenes on 4 ranks: (2, 2); 3 on 4: (1, 4))."""
    world = _world(num_devices)
    rows = math.gcd(n_scenes, world)
    return _grid(rows, world // rows, (SCENE_AXIS, DATA_AXIS))


def make_slice_mesh(n_slices: int, num_devices: int = 0) -> Mesh:
    """The 2-D (dcn, data) mesh of multi-slice data parallelism: a row is
    a slice, whose gradients meet first (``dp.make_slice_dp_train_step``)."""
    world = _world(num_devices)
    if world % n_slices:
        raise ValueError(f"{world} devices do not split into {n_slices} equal slices")
    return _grid(n_slices, world // n_slices, (DCN_AXIS, DATA_AXIS))


def num_shards(mesh: Mesh) -> int:
    return mesh.shape[DATA_AXIS]


def pad_to_shards(n: int, mesh: Mesh) -> int:
    """Smallest multiple of the data axis' size >= n (every rank takes an
    equal share of a batch)."""
    k = num_shards(mesh)
    return ((n + k - 1) // k) * k


def mean_(t: torch.Tensor, mesh: Mesh, axis: str = DATA_AXIS) -> torch.Tensor:
    """JAX's ``pmean`` over ``axis``, in place: the sum over the axis'
    group, divided by its size. Every rank of the group gets the same
    bits."""
    group = mesh.groups[axis]
    if group is not None:
        dist.all_reduce(t, group=group)
        t.div_(mesh.shape[axis])
    return t


def gather(t: torch.Tensor, mesh: Mesh, axis: str = DATA_AXIS) -> torch.Tensor:
    """JAX's tiled ``all_gather`` over ``axis``: every rank's ``t``
    concatenated along dim 0 in the axis' order, on every rank."""
    group = mesh.groups[axis]
    if group is None:
        return t
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(mesh.shape[axis])]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts)
