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

The factored field's tree (``nerf_rs_tpu/models/factored.py``) holds a
bare ``lines`` array (3, sumR, C) beside the heads' ``{w, b}`` dicts
(``sigma1``, ``sigma2``, ``color1``, ``color2``, ``rgb``); its state dict
has the keys ``lines`` and ``sigma1.w`` ...; ``FactoredField`` takes it.
The hash grid's tree (``nerf_rs_tpu/models/hashgrid.py``) is the same with
a bare ``table`` leaf, (L T, F) or (L Tb, 128), for ``HashGridField``.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Union

import numpy as np
import torch
from torch import nn


# the fields' state-dict order (NerfMLP's, then FactoredField's and HashGridField's)
_ORDER = ("trunk", "sigma", "feature", "view1", "lines", "table", "sigma1", "sigma2", "color1",
          "color2", "rgb")


def params_from_numpy(tree: dict, device=None) -> "OrderedDict[str, torch.Tensor]":
    """A numpy param pytree -> the port's state dict (f32 tensors), keyed
    in the field's state-dict order."""
    out: "OrderedDict[str, torch.Tensor]" = OrderedDict()

    def put(key: str, value) -> None:
        a = np.asarray(value, dtype=np.float32)
        out[key] = torch.from_numpy(a.copy()).to(device)

    rank = {name: i for i, name in enumerate(_ORDER)}
    for name in sorted(tree, key=lambda k: (rank.get(k, len(_ORDER)), k)):
        value = tree[name]
        if name == "trunk":
            for i, layer in enumerate(value):
                for leaf in ("w", "b"):
                    put(f"trunk.{i}.{leaf}", layer[leaf])
        elif isinstance(value, dict):
            for leaf in ("w", "b"):
                put(f"{name}.{leaf}", value[leaf])
        else:  # a bare leaf: the factored field's lines, the hash grid's table
            put(name, value)
    return out


def params_to_numpy(state: Union[nn.Module, Dict[str, torch.Tensor]]) -> dict:
    """The port's module or state dict -> a numpy param pytree in the
    JAX layout (the inverse of ``params_from_numpy``)."""
    if isinstance(state, nn.Module):
        state = state.state_dict()
    tree: dict = {}
    for key, value in state.items():
        a = value.detach().to("cpu", torch.float32).numpy().copy()
        if "." not in key:  # a bare leaf
            tree[key] = a
            continue
        name, leaf = key.rsplit(".", 1)
        if name.startswith("trunk."):
            i = int(name.split(".", 1)[1])
            trunk = tree.setdefault("trunk", [])
            while len(trunk) <= i:
                trunk.append({})
            trunk[i][leaf] = a
        else:
            tree.setdefault(name, {})[leaf] = a
    return tree
