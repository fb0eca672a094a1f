"""Data-parallel training and rendering over the ranks, the counterpart of
``nerf_rs_tpu/parallel/dp.py``.

Every rank holds the whole train state: the same weights from the same
numpy seed, and after every step the same update, so every rank's weights,
optimizer state, EMA, occupancy grid and error store stay bit-identical.
A step: each rank computes the gradients of its share of the rays
(``train/step.compute_grads``: the whole-ray train kernel, K3/K4 through
autograd, or autograd), then one ``all_reduce`` of every gradient
flattened into one buffer in ``named_trainable`` order and one of the
stacked aux scalars, each divided by the ranks' count (JAX's ``pmean``;
every rank averaged over equally many rays); ``ray_err`` stays per rank;
Adam runs on every rank (``train/step.apply_grads``). The reduce is
written by hand, not ``DistributedDataParallel``: the train kernel's
gradients come back as a dict, not through ``.backward()``, so DDP's
autograd hooks would never see them.

A rank's random draws come from its own generator, the step's generator
with the rank mixed into its seed (``shard_generator``, JAX's ``fold_in``
of the shard index); one rank keeps the step's generator, and its step is
exactly ``train/step.make_train_step``'s (no group, no collective).

The rendered frame is split into equal blocks of rays, one per rank, each
rendered in chunks through the render kernel (``render.make_render``), and
gathered to every rank, as JAX's replicated output is.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from ..config import Config
from ..render import RenderFn, make_render
from ..train import step as step_mod
from ..train.step import Aux, Batch, Grads, TrainState
from .mesh import DATA_AXIS, DCN_AXIS, Mesh, gather, mean_, num_shards

_M64 = (1 << 64) - 1


def _mix(seed: int, *coords: int) -> int:
    """A 64-bit seed from ``seed`` and mesh coordinates (splitmix64's
    finalizer after each coordinate)."""
    x = seed & _M64
    for c in coords:
        x = (x ^ ((c + 1) * 0x9E3779B97F4A7C15)) & _M64
        x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
        x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
        x ^= x >> 31
    return x


def shard_generator(generator: torch.Generator, *coords: int) -> torch.Generator:
    """A generator on ``generator``'s device whose seed mixes ``generator``'s
    seed with ``coords`` (JAX's ``fold_in``): read on the host, no draw, no
    device sync."""
    g = torch.Generator(device=generator.device)
    g.manual_seed(_mix(generator.initial_seed(), *coords))
    return g


def _flat_coord(mesh: Mesh, axes: Sequence[str]) -> tuple:
    """(this rank's index, the count) over ``axes`` in row-major order."""
    index, count = 0, 1
    for axis in axes:
        index, count = index * mesh.shape[axis] + mesh.coords[axis], count * mesh.shape[axis]
    return index, count


def place_batch(batch: Batch, mesh: Mesh, axes: Sequence[str] = (DATA_AXIS,)) -> Batch:
    """This rank's contiguous block of a global batch, the rays split evenly
    over ``axes`` (JAX's batch sharded ``P(axes)``)."""
    index, count = _flat_coord(mesh, axes)
    n = batch.origins.shape[0]
    if n % count:
        raise ValueError(f"{n} rays do not split over {count} ranks (pad_to_shards)")
    per = n // count
    return Batch(*(None if x is None else x[index * per:(index + 1) * per] for x in batch))


def reduce_grads(state: TrainState, grads: Grads, aux: Aux, mesh: Mesh,
                 axes: Sequence[str] = (DATA_AXIS,)):
    """The mean over ``axes``, one axis after another, of every gradient
    (one flat buffer in ``named_trainable`` order) and of the aux scalars
    (one stacked buffer); ``ray_err`` stays this rank's."""
    named = list(step_mod.named_trainable(state))
    flat = torch.cat([grads[name].reshape(-1).float() for name, _ in named])
    keys = sorted(k for k in aux if k != "ray_err")
    scalars = torch.stack([aux[k].float().reshape(()) for k in keys])
    for axis in axes:
        mean_(flat, mesh, axis)
        mean_(scalars, mesh, axis)
    out, offset = {}, 0
    for name, p in named:
        out[name] = flat[offset:offset + p.numel()].view_as(p).to(p.dtype)
        offset += p.numel()
    reduced = dict(zip(keys, scalars.unbind()))
    reduced["ray_err"] = aux["ray_err"]
    return out, reduced


def dp_step(state: TrainState, batch: Batch, generator: torch.Generator, cfg: Config,
            mesh: Mesh, axes: Sequence[str] = (DATA_AXIS,)):
    """One step of this rank's share ``batch``: its gradients, their mean
    over ``axes`` (``reduce_grads``), then Adam."""
    grads, aux = step_mod.compute_grads(state, batch, generator, cfg)
    grads, aux = reduce_grads(state, grads, aux, mesh, axes)
    return step_mod.apply_grads(state, grads, cfg), aux


def make_dp_train_step(cfg: Config, mesh: Mesh, dataset=None, shard_store: bool = False,
                       sample: Optional[Callable[[torch.Generator], Batch]] = None,
                       err_store: Optional[torch.Tensor] = None) -> Callable:
    """The data-parallel step, as the JAX function builds it.

    Without ``dataset``: fn(state, batch, generator) -> (state, aux) over a
    global batch, of which every rank takes its block (``place_batch``).
    With ``dataset``: fn(state, generator) -> (state, aux), the batch drawn
    in the step (aux carries ``batch_idx``): with per-ray batches each rank
    draws ceil(num_rays / ranks) rays from its own generator (from the
    error store ``err_store`` when given; ``shard_store``: from its own
    views, ``batch_idx`` offset by its views' base, so ids stay global);
    in the other batch modes every rank draws the global batch
    ``sample(generator)`` and keeps its block. With an error store, aux's
    ``batch_idx`` and ``ray_err`` are every rank's, all-gathered in rank
    order, so each rank's ``update_error_store`` applies the same update.
    One rank: ``train/step``'s own step."""
    n = num_shards(mesh)
    if dataset is None:
        if n == 1:
            return lambda state, batch, generator: step_mod.train_step(state, batch, generator,
                                                                       cfg)
        rank = mesh.coords[DATA_AXIS]
        return lambda state, batch, generator: dp_step(
            state, place_batch(batch, mesh), shard_generator(generator, rank), cfg, mesh)
    if n == 1:
        return step_mod.make_train_step(cfg, dataset, sample)
    rank = mesh.coords[DATA_AXIS]
    per_shard = -(-cfg.train.num_rays // n)
    base = rank * dataset.num_views * dataset.height * dataset.width if shard_store else 0
    per_ray = cfg.data.batch_mode == "per_ray"
    frac = cfg.train.error_resample_frac

    def step(state: TrainState, generator: torch.Generator):
        g = shard_generator(generator, rank)
        if not per_ray:
            batch = place_batch(sample(generator), mesh)
        elif err_store is not None:
            batch = dataset.sample_batch_error_weighted(g, per_shard, err_store, frac)
        else:
            batch = dataset.sample_batch(g, per_shard)
            if base:
                batch = batch._replace(idx=batch.idx + base)
        state, aux = dp_step(state, batch, g, cfg, mesh)
        aux["batch_idx"] = batch.idx
        if err_store is not None:
            aux["batch_idx"] = gather(batch.idx, mesh)
            aux["ray_err"] = gather(aux["ray_err"], mesh)
        return state, aux

    return step


def make_slice_dp_train_step(cfg: Config, mesh: Mesh) -> Callable:
    """The step over a (dcn, data) mesh (``mesh.make_slice_mesh``):
    fn(state, batch, generator) over a global batch split over both axes;
    the gradients' mean over the slice first, then over the slices (one
    pre-reduced copy a slice crosses between them). The same numbers as
    the 1-D step: a mean of means over equal shares."""
    axes = (DCN_AXIS, DATA_AXIS)
    coords = (mesh.coords[DCN_AXIS], mesh.coords[DATA_AXIS])
    return lambda state, batch, generator: dp_step(
        state, place_batch(batch, mesh, axes), shard_generator(generator, *coords), cfg, mesh,
        (DATA_AXIS, DCN_AXIS))


def make_dp_render(cfg: Config, mesh: Mesh, camera=None, chunk: int = 0) -> RenderFn:
    """The sharded renderer, with ``render.make_render``'s signature:
    fn(params, origins, dirs, fine_params=None, grid=None) -> rgb, depth,
    acc over flat rays. The rays are padded to a multiple of the ranks
    (origin 0, direction 1, as JAX pads them), each rank renders its block
    in chunks, and the frame is gathered to every rank. One rank:
    ``make_render``'s renderer."""
    local = make_render(cfg, camera, chunk)
    k = num_shards(mesh)
    if k == 1:
        return local
    rank = mesh.coords[DATA_AXIS]

    def render(params, origins, dirs, fine_params=None, grid=None):
        n = origins.shape[0]
        per = -(-n // k)
        if per * k != n:
            pad = per * k - n
            origins = torch.cat([origins, origins.new_zeros(pad, 3)])
            dirs = torch.cat([dirs, dirs.new_ones(pad, 3)])
        rgb, depth, acc = local(params, origins[rank * per:(rank + 1) * per],
                                dirs[rank * per:(rank + 1) * per], fine_params, grid)
        out = gather(torch.cat([rgb, depth[:, None], acc[:, None]], dim=1), mesh)[:n]
        return out[:, :3].contiguous(), out[:, 3].contiguous(), out[:, 4].contiguous()

    return render
