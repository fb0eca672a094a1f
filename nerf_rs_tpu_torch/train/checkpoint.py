"""Weight checkpoints, the counterpart of the weights half of
``nerf_rs_tpu/train/checkpoint.py``.

The JAX package writes flax msgpack; the port writes ``torch.save``
files under the same name pattern, ``checkpoint-{unix_ts}-{step}.pt``,
and ``latest_checkpoint`` picks the newest by (timestamp, step).
Loading uses ``weights_only=True``. Weights trained by the JAX package
enter through ``convert.params_from_numpy``. Optimizer state comes with
the training slice.
"""

from __future__ import annotations

import os
import re
import time
from typing import Optional

import torch
from torch import nn

_CKPT_RE = re.compile(r"checkpoint-(\d+)-(\d+)\.pt$")


def checkpoint_path(save_dir: str, step: int, ts: Optional[int] = None) -> str:
    ts = int(time.time()) if ts is None else ts
    return os.path.join(save_dir, f"checkpoint-{ts}-{step}.pt")


def save(params: nn.Module, save_dir: str, step: int = 0,
         ts: Optional[int] = None) -> str:
    """Write the field's weights and the step; returns the path."""
    os.makedirs(save_dir, exist_ok=True)
    path = checkpoint_path(save_dir, step, ts)
    state = {k: v.detach().cpu() for k, v in params.state_dict().items()}
    tmp = path + ".tmp"
    torch.save({"step": step, "params": state}, tmp)
    os.replace(tmp, path)  # atomic: no torn checkpoints
    return path


def restore_weights(path: str, params: nn.Module) -> int:
    """Load the weights at ``path`` into ``params`` in place; returns
    the checkpoint's step."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    params.load_state_dict(ckpt["params"])
    return int(ckpt["step"])


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
