"""Checkpoints, the counterpart of ``nerf_rs_tpu/train/checkpoint.py``.

The JAX package writes flax msgpack; the port writes ``torch.save``
files under the same name pattern, ``checkpoint-{unix_ts}-{step}.pt``,
and ``latest_checkpoint`` picks the newest by (timestamp, step). A file
holds the step, the field's weights, the second net's when the run has
one (the fine field of hierarchical sampling with two nets, or the
proposal net; under the key ``fine_params``), and, when saved from a
``TrainState``, the optimizer's state over both (``restore`` resumes
training from it; ``restore_weights`` reads the weights of either
kind) and the occupancy grid when the run has one (``grid``). A grid
that the file and the run do not both have is not dropped in silence:
resuming or rendering without it means uniform samples where the field
learned grid-guided ones, so a warning names the flag. Loading uses
``weights_only=True``. Weights trained by the JAX package enter through
``convert.params_from_numpy``. A run with error-weighted resampling saves
its per-pixel error store beside the file as an ``.err.npy`` sidecar (the
JAX package's), which a resume reads back (``load_err_store``).

A run with ``--ema_decay`` saves its EMA weights under ``ema``: the
field's state dict, or with a second net ``{"0": field, "1": second
net}``, the form the JAX package's tuple takes. ``restore`` resumes it;
``load_ema`` hands inference the EMA even when the run reading the file
was configured without one. An EMA that the file and a resuming run do
not both have warns, as a missing grid does: the resumed EMA starts from
the run's fresh one (its initial weights), or is dropped.
"""

from __future__ import annotations

import os
import re
import time
import warnings
from typing import Optional, Union

import numpy as np
import torch
from torch import nn

_CKPT_RE = re.compile(r"checkpoint-(\d+)-(\d+)\.pt$")


def checkpoint_path(save_dir: str, step: int, ts: Optional[int] = None) -> str:
    ts = int(time.time()) if ts is None else ts
    return os.path.join(save_dir, f"checkpoint-{ts}-{step}.pt")


def _cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cpu(v) for v in tree)
    return tree


def state_blob(state: "TrainState") -> dict:  # noqa: F821
    """What a checkpoint holds of ``state``, on the host."""
    blob = {"step": state.step, "params": _cpu(state.params.state_dict()),
            "optimizer": _cpu(state.optimizer.state_dict())}
    if state.fine_params is not None:
        blob["fine_params"] = _cpu(state.fine_params.state_dict())
    if state.grid is not None:
        blob["grid"] = _cpu(state.grid)
    if state.ema is not None:
        blob["ema"] = ({str(i): _cpu(net.state_dict()) for i, net in enumerate(state.ema)}
                       if isinstance(state.ema, tuple) else _cpu(state.ema.state_dict()))
    return blob


def _write(blob: dict, save_dir: str, step: int, ts: Optional[int]) -> str:
    os.makedirs(save_dir, exist_ok=True)
    path = checkpoint_path(save_dir, step, ts)
    tmp = path + ".tmp"
    torch.save(blob, tmp)
    os.replace(tmp, path)  # atomic: no torn checkpoints
    return path


def save(state: Union["TrainState", nn.Module], save_dir: str,  # noqa: F821
         step: Optional[int] = None, ts: Optional[int] = None,
         err_store: Optional[torch.Tensor] = None) -> str:
    """Write a ``TrainState`` (step, weights, optimizer state) or a bare
    field's weights (``step`` defaults to 0); returns the path. An
    ``err_store`` (error-weighted resampling's per-pixel distribution, part
    of the training trajectory) goes beside it as ``.err.npy``."""
    if isinstance(state, nn.Module):
        blob = {"step": step or 0, "params": _cpu(state.state_dict())}
    else:
        blob = state_blob(state)
        if step is not None:
            blob["step"] = step
    path = _write(blob, save_dir, blob["step"], ts)
    if err_store is not None:
        err_path = err_store_path(path)
        np.save(err_path + ".tmp.npy", err_store.detach().cpu().numpy())
        os.replace(err_path + ".tmp.npy", err_path)
    return path


def _stack(trees):
    first = trees[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(trees)
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_stack(list(xs)) for xs in zip(*trees))
    if any(t != first for t in trees):
        raise ValueError(f"the scenes' checkpoints differ in a setting: {trees}")
    return first


def _unstack(tree, i: int):
    if isinstance(tree, torch.Tensor):
        return tree[i].clone()
    if isinstance(tree, dict):
        return {k: _unstack(v, i) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unstack(v, i) for v in tree)
    return tree


def save_scenes(blobs, save_dir: str, ts: Optional[int] = None) -> str:
    """Write the scenes' ``state_blob``s as one file: every tensor stacked
    on a leading scene axis, ``scenes`` their count; returns the path."""
    stacked = _stack(list(blobs))
    stacked["scenes"] = len(blobs)
    return _write(stacked, save_dir, stacked["step"], ts)


def err_store_path(ckpt_path: str) -> str:
    """The error-store sidecar of a checkpoint: ``checkpoint-{ts}-{step}.err.npy``."""
    return re.sub(r"\.pt$", ".err.npy", ckpt_path)


def load_err_store(ckpt_path: str) -> Optional[np.ndarray]:
    """The error store saved beside ``ckpt_path``, or None when the run
    that wrote it had no error resampling."""
    err_path = err_store_path(ckpt_path)
    return np.load(err_path) if os.path.exists(err_path) else None


def _load(path: str, scene: Optional[int] = None) -> dict:
    """The file at ``path``; of a multi-scene file, scene ``scene``'s part
    (the file and the caller must agree on whether it is one)."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    n = blob.pop("scenes", None)
    if n is None and scene is not None:
        raise ValueError(f"{path} holds one scene, not a --scenes run's")
    if n is None:
        return blob
    if scene is None:
        raise ValueError(f"{path} holds the {n} scenes of a --scenes run: pass --scenes and "
                         f"--scene_index")
    if not 0 <= scene < n:
        raise ValueError(f"{path} holds {n} scenes, scene index {scene} is not one")
    return _unstack(blob, scene)


def _load_fine(ckpt: dict, path: str, fine: Optional[nn.Module]) -> None:
    """The second net's weights (fine field or proposal) into ``fine``;
    the file and the caller must agree on whether there is one, which is
    why eval and render need the preset a run was trained with."""
    if (fine is None) != ("fine_params" not in ckpt):
        raise ValueError(f"{path} {'has' if fine is None else 'has no'} second-net weights "
                         f"(a fine field or a proposal net), the run "
                         f"{'has none' if fine is None else 'has one'}: use the preset the "
                         f"checkpoint was trained with")
    if fine is not None:
        fine.load_state_dict(ckpt["fine_params"])


def _load_grid(ckpt: dict, path: str, grid: Optional[torch.Tensor]) -> None:
    """The occupancy grid into ``grid`` in place. A file with a grid for a
    run without one, or the other way round, warns: the JAX package's
    ``restore_weights`` warns for the first, and a run that keeps its
    fresh grid samples uniformly until the grid's next update."""
    if grid is None:
        if "grid" in ckpt:
            warnings.warn(f"checkpoint {path} carries an occupancy grid but the run has "
                          f"none: it is ignored. Pass the --occ_res it was trained with, or "
                          f"the field is sampled where it did not learn")
        return
    if "grid" not in ckpt:
        warnings.warn(f"checkpoint {path} has no occupancy grid: the run starts from an "
                      f"empty one (uniform samples until its next update); it was trained "
                      f"without --occ_res")
        return
    if tuple(ckpt["grid"].shape) != tuple(grid.shape):
        raise ValueError(f"{path} holds a {tuple(ckpt['grid'].shape)} occupancy grid, the "
                         f"run a {tuple(grid.shape)} one: use the --occ_res it was trained with")
    grid.copy_(ckpt["grid"])


def _load_ema_into(sd, ema) -> None:
    """An EMA state dict (a field's, or ``{"0": ..., "1": ...}``) into the
    EMA module or pair ``ema``, in place."""
    if isinstance(ema, tuple):
        if set(sd) != {"0", "1"}:
            raise ValueError("the checkpoint's EMA covers one net, the run's two")
        for i, net in enumerate(ema):
            net.load_state_dict(sd[str(i)])
    elif set(sd) == {"0", "1"}:
        raise ValueError("the checkpoint's EMA covers two nets, the run's one")
    else:
        ema.load_state_dict(sd)


def restore(path: str, state: "TrainState",  # noqa: F821
            scene: Optional[int] = None) -> "TrainState":  # noqa: F821
    """Resume: the weights (both fields' with a fine field), the step,
    the occupancy grid, the EMA and (when the file has it) the optimizer
    state into ``state``, in place (of a multi-scene file, scene
    ``scene``'s); returns it."""
    ckpt = _load(path, scene)
    state.params.load_state_dict(ckpt["params"])
    _load_fine(ckpt, path, state.fine_params)
    _load_grid(ckpt, path, state.grid)
    if state.ema is not None and "ema" in ckpt:
        _load_ema_into(ckpt["ema"], state.ema)
    elif state.ema is not None:
        warnings.warn(f"checkpoint {path} has no EMA: the run's EMA starts from its initial "
                      f"weights (the JAX package's backfill); it was trained without "
                      f"--ema_decay")
    elif "ema" in ckpt:
        warnings.warn(f"checkpoint {path} carries EMA weights but the run keeps none: they "
                      f"are dropped. Pass the --ema_decay it was trained with to keep them")
    if "optimizer" in ckpt:
        state.optimizer.load_state_dict(ckpt["optimizer"])
    state.step = int(ckpt["step"])
    return state


def restore_weights(path: str, params: nn.Module, fine_params: Optional[nn.Module] = None,
                    grid: Optional[torch.Tensor] = None, scene: Optional[int] = None) -> int:
    """Load the weights at ``path`` (of a multi-scene file, scene
    ``scene``'s) into ``params`` (and the fine field's into
    ``fine_params``, the occupancy grid into ``grid``) in place; returns
    the checkpoint's step."""
    ckpt = _load(path, scene)
    params.load_state_dict(ckpt["params"])
    _load_fine(ckpt, path, fine_params)
    _load_grid(ckpt, path, grid)
    return int(ckpt["step"])


def load_ema(path: str, params: nn.Module, fine_params: Optional[nn.Module] = None,
             scene: Optional[int] = None):
    """The EMA weights of the file at ``path`` for inference, or None when
    it has none: copies of ``params`` (and ``fine_params``, for a file
    whose EMA covers two nets) holding them. Needs no ``--ema_decay`` in
    the reading run, as the JAX package's ``restore_weights``."""
    from .step import ema_copy

    ckpt = _load(path, scene)
    if "ema" not in ckpt:
        return None
    two = set(ckpt["ema"]) == {"0", "1"}
    if two and fine_params is None:
        raise ValueError(f"{path} holds the EMA of two nets, the run has one: use the preset "
                         f"the checkpoint was trained with")
    ema = (ema_copy(params), ema_copy(fine_params)) if two else ema_copy(params)
    _load_ema_into(ckpt["ema"], ema)
    return ema


def latest_checkpoint(save_dir: str) -> Optional[str]:
    """Most recent checkpoint by (timestamp, step), or None."""
    if not os.path.isdir(save_dir):
        return None
    best = None
    for name in os.listdir(save_dir):
        m = _CKPT_RE.search(name)
        if m:
            key = (int(m.group(1)), int(m.group(2)))
            if best is None or key > best[0]:
                best = (key, os.path.join(save_dir, name))
    return best[1] if best else None
