"""The tiny sigma and color heads that the grid-encoding field families
share, the counterparts of ``init_tiny_heads`` and ``apply_tiny_heads``
in ``nerf_rs_tpu/models/hashgrid.py``:

    enc -> W -> 1 + G          (sigma net; channel 0 is sigma_raw)
    [G, PE(dir)] -> W -> W -> 3   (color net)

with W = ``hash_mlp_width`` and G = ``hash_geo_feats``. Each layer is a
``Dense`` named as the JAX leaf (``sigma1``, ``sigma2``, ``color1``,
``color2``, ``rgb``). The hash encode itself, ``--arch hashgrid`` and
``--preset ngp`` come with the hashgrid half of slice 9 of the port.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config import ModelConfig

from .encoding import posenc, posenc_dim
from .mlp import Dense, dense


def init_tiny_heads(module: nn.Module, enc_dim: int, cfg: ModelConfig, device=None) -> None:
    """Add the heads' ``Dense`` layers to ``module`` (zeros; the caller
    draws the weights)."""
    W, G = cfg.hash_mlp_width, cfg.hash_geo_feats
    dir_dim = posenc_dim(3, cfg.dir_enc_levels, cfg.include_input_in_enc)
    module.sigma1 = Dense(enc_dim, W, device)
    module.sigma2 = Dense(W, 1 + G, device)
    module.color1 = Dense(G + dir_dim if cfg.use_viewdirs else G, W, device)
    module.color2 = Dense(W, W, device)
    module.rgb = Dense(W, 3, device)


def apply_tiny_heads(
    params: nn.Module,
    enc: torch.Tensor,
    viewdirs: Optional[torch.Tensor],
    cfg: ModelConfig,
    dtype=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """enc (..., enc_dim) -> (sigma_raw (...,), rgb_raw (..., 3)), both
    f32, before the activations (``apply_nerf`` applies them). With a
    bf16 ``dtype`` the encoding is cast to bf16 first and every layer
    runs in bf16."""
    low = dtype is not None and dtype != torch.float32
    if low:
        enc = enc.to(dtype)
    h = F.relu(dense(enc, params.sigma1, dtype))
    out = dense(h, params.sigma2, dtype)
    sigma_raw = out[..., 0].float()
    geo = out[..., 1:]
    if cfg.use_viewdirs:
        d = posenc(viewdirs, cfg.dir_enc_levels, cfg.include_input_in_enc)
        d = d.expand(*geo.shape[:-1], d.shape[-1])
        if low:
            d = d.to(dtype)
        hc = torch.cat([geo, d], dim=-1)
    else:
        hc = geo
    hc = F.relu(dense(hc, params.color1, dtype))
    hc = F.relu(dense(hc, params.color2, dtype))
    rgb_raw = dense(hc, params.rgb, dtype).float()
    return sigma_raw, rgb_raw
