"""Carry parameters between the JAX package and the port.

The JAX field keeps its weights as a pytree: ``{"trunk": [{"w", "b"},
...], "sigma": {...}, "feature": {...}, "view1": {...}, "rgb": {...}}``
with (in, out) weights (``nerf_rs_tpu/models/mlp.init_nerf_params``).
The port's ``NerfMLP`` keeps the same layout under the same names, so
the conversion renames and copies and never transposes:

    tree = jax.tree.map(np.asarray, params)
    model = NerfMLP(cfg)
    model.load_state_dict(params_from_numpy(tree))

A hierarchical run's second field (``TrainState.fine_params`` in both
packages) is a tree of the same layout and converts the same way.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Union

import numpy as np
import torch
from torch import nn


def params_from_numpy(tree: dict, device=None) -> "OrderedDict[str, torch.Tensor]":
    """A numpy param pytree -> the port's state dict (f32 tensors)."""
    out: "OrderedDict[str, torch.Tensor]" = OrderedDict()

    def put(prefix: str, layer: dict) -> None:
        for leaf in ("w", "b"):
            a = np.asarray(layer[leaf], dtype=np.float32)
            out[f"{prefix}.{leaf}"] = torch.from_numpy(a.copy()).to(device)

    for i, layer in enumerate(tree["trunk"]):
        put(f"trunk.{i}", layer)
    for name in ("sigma", "feature", "view1", "rgb"):
        if name in tree:
            put(name, tree[name])
    return out


def params_to_numpy(state: Union[nn.Module, Dict[str, torch.Tensor]]) -> dict:
    """The port's module or state dict -> a numpy param pytree in the
    JAX layout (the inverse of ``params_from_numpy``)."""
    if isinstance(state, nn.Module):
        state = state.state_dict()
    tree: dict = {"trunk": []}
    for key, value in state.items():
        a = value.detach().to("cpu", torch.float32).numpy().copy()
        name, leaf = key.rsplit(".", 1)
        if name.startswith("trunk."):
            i = int(name.split(".", 1)[1])
            while len(tree["trunk"]) <= i:
                tree["trunk"].append({})
            tree["trunk"][i][leaf] = a
        else:
            tree.setdefault(name, {})[leaf] = a
    return tree
