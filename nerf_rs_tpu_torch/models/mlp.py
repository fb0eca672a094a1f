"""The paper NeRF field as an ``nn.Module``, the counterpart of the
``nerf`` arch in ``nerf_rs_tpu/models/mlp.py``, and the dispatch over
the field families (``init_nerf_params``, ``apply_nerf``).

gamma(x) -> depth x width ReLU trunk, with the encoded position
re-injected (concatenated after the hidden state) before layer
``skip_layer`` -> sigma head (1) + feature head -> [feature, gamma(d)]
-> view head -> sigmoid RGB.

Weights keep the JAX layout and names so that a parameter tree converts
one to one (``convert.py``): every layer is a ``Dense`` holding ``w`` of
shape (in, out) and ``b`` of shape (out,); the state-dict keys are
``trunk.{i}.w/b``, ``sigma``, ``feature``, ``view1`` and ``rgb``.

Ported so far: the paper arch (with PE, or mip-NeRF's integrated
encoding of Gaussians), the factored arch (``models/factored.py``) and
the hash grid (``models/hashgrid.py``, both table layouts), each with
mip-NeRF 360's scene contraction in front of it (``cfg.contract``) and
the paper's sigma noise on its raw density; compat mode raises
``NotImplementedError`` naming the slice that brings it.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..config import ModelConfig

from .encoding import integrated_posenc, posenc, posenc_dim


def check_supported(cfg: ModelConfig) -> None:
    """Raise for the model options later slices of the port bring."""
    if cfg.compat:
        raise NotImplementedError("--compat comes with slice 10 of the port")


class Dense(nn.Module):
    """y = x @ w + b with the JAX (in, out) weight layout."""

    def __init__(self, in_dim: int, out_dim: int, device=None):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(in_dim, out_dim, device=device))
        self.b = nn.Parameter(torch.zeros(out_dim, device=device))


class NerfMLP(nn.Module):
    """Parameters of the paper field; ``forward`` is ``apply_nerf``."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        check_supported(cfg)
        if cfg.arch != "nerf":
            raise ValueError(f"NerfMLP is the paper field; arch={cfg.arch!r} is built by "
                             f"init_nerf_params")
        self.cfg = cfg
        pos_dim = posenc_dim(3, cfg.pos_enc_levels, cfg.include_input_in_enc)
        dir_dim = posenc_dim(3, cfg.dir_enc_levels, cfg.include_input_in_enc)
        trunk = []
        in_dim = pos_dim
        for i in range(cfg.net_depth):
            if i == cfg.skip_layer and i > 0:
                in_dim += pos_dim
            trunk.append(Dense(in_dim, cfg.net_width, device))
            in_dim = cfg.net_width
        self.trunk = nn.ModuleList(trunk)
        self.sigma = Dense(cfg.net_width, 1, device)
        self.feature = Dense(cfg.net_width, cfg.feature_width, device)
        if cfg.use_viewdirs:
            self.view1 = Dense(cfg.feature_width + dir_dim,
                               cfg.view_head_width, device)
            self.rgb = Dense(cfg.view_head_width, 3, device)
        else:
            self.rgb = Dense(cfg.feature_width, 3, device)

    def forward(self, points, viewdirs, dtype=None):
        return apply_nerf(self, points, viewdirs, self.cfg, dtype)


def _truncated_normal(rng: np.random.Generator, shape) -> np.ndarray:
    """Standard normal draws cut at +-2, outliers redrawn (the
    distribution of ``jax.random.truncated_normal(key, -2, 2)``)."""
    x = rng.standard_normal(shape)
    bad = np.abs(x) > 2.0
    while bad.any():
        x[bad] = rng.standard_normal(int(bad.sum()))
        bad = np.abs(x) > 2.0
    return x


def seed_rng(seed: int, stream: int = 0) -> np.random.Generator:
    """numpy's generator for the draw of net ``stream`` from ``seed``."""
    return np.random.default_rng(seed if stream == 0 else [seed, stream])


def he_init_(model: nn.Module, rng: np.random.Generator) -> None:
    """He truncated-normal weights (fan_in, ReLU gain, cut at 2 std) into
    every ``Dense`` of ``model``, in module order; biases stay 0."""
    with torch.no_grad():
        for layer in model.modules():
            if isinstance(layer, Dense):
                std = math.sqrt(2.0 / layer.w.shape[0])
                layer.w.copy_(torch.from_numpy(std * _truncated_normal(rng, tuple(layer.w.shape))))


def init_nerf_params(cfg: ModelConfig, seed: int = 0, device=None, stream: int = 0) -> nn.Module:
    """The field of ``cfg.arch``: a ``NerfMLP``, a ``FactoredField``
    (``models/factored.init_factored_params``) or a ``HashGridField``
    (``models/hashgrid.init_hash_params``). He truncated-normal
    weights (fan_in, ReLU gain, cut at 2 std) and zero biases, drawn with
    numpy from ``seed``: one seed gives the same weights on every device
    and under every torch version (torch's own truncated-normal draw
    changed between releases). ``stream`` > 0 draws an independent net
    from the same seed (the hierarchical fine field takes stream 1).

    Variance-preserving init is load-bearing for the deep trunk: with
    shrinking activations the sigma head's bias dominates, and if it
    lands negative relu(sigma) is 0 everywhere and the field is dead at
    init (see ``nerf_rs_tpu/models/mlp._init_linear``).
    """
    check_supported(cfg)
    if cfg.arch == "factored":
        from .factored import init_factored_params

        return init_factored_params(cfg, seed, device, stream)
    if cfg.arch == "hashgrid":
        from .hashgrid import init_hash_params

        return init_hash_params(cfg, seed, device, stream)
    model = NerfMLP(cfg)
    he_init_(model, seed_rng(seed, stream))
    return model.to(device)


def dense(x: torch.Tensor, layer: Dense, dtype=None) -> torch.Tensor:
    """x @ w + b. With a bf16 ``dtype`` the whole layer runs in bf16:
    inputs, weights, the product's output and the bias add, as the JAX
    ``dense`` does (``nerf_rs_tpu/models/mlp.py:68-87``)."""
    if dtype is not None and dtype != torch.float32:
        return x.to(dtype) @ layer.w.to(dtype) + layer.b.to(dtype)
    return x @ layer.w + layer.b


def sigma_activation(raw: torch.Tensor, act: str) -> torch.Tensor:
    if act == "relu":
        return F.relu(raw)
    if act == "softplus":
        # jax.nn.softplus is logaddexp(x, 0): no linear cut-over
        return torch.logaddexp(raw, torch.zeros_like(raw))
    return raw


def apply_nerf(
    params: nn.Module,
    points: torch.Tensor,
    viewdirs: Optional[torch.Tensor],
    cfg: ModelConfig,
    dtype=None,
    pos_var: Optional[torch.Tensor] = None,
    noise_std: float = 0.0,
    noise: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Evaluate the field at (..., 3) points with (..., 3) unit view
    directions (broadcastable to the points). Returns sigma (...,) after
    ``cfg.sigma_activation`` and rgb (..., 3), both f32.

    ``dtype=torch.bfloat16`` is the "mixed" precision: bf16 layers, and
    the heads cast back to f32 on the way out.

    ``pos_var`` (..., 3) with ``cfg.ipe``: ``points`` are Gaussian means
    and ``pos_var`` their diagonal variances, encoded with mip-NeRF's
    integrated encoding (same width and layout as the PE, so the same
    weights take either).

    The factored arch (``models/factored.apply_factored``) and the hash
    grid (``models/hashgrid.apply_hashgrid``) encode the points with their
    tables and tiny heads; ``pos_var`` does not apply to them, as in the
    JAX package.

    ``cfg.contract``: the points (or, with ``pos_var``, the Gaussians,
    through the closed-form linearisation) are contracted into the
    radius-2 ball first (``ops/contract.py``), before the dispatch over
    the families, as in the JAX package.

    ``noise`` (the points' leading shape, standard normal draws) with
    ``noise_std`` > 0: the paper's density regulariser, ``noise_std *
    noise`` added to the raw density before its activation, in every
    family (``_sigma_noise`` in the JAX package). The caller draws it,
    from its generator or, in a test, from the JAX package's key.
    """
    check_supported(cfg)
    if cfg.contract:
        from ..ops.contract import contract, contract_gaussian

        if pos_var is not None:
            points, pos_var = contract_gaussian(points, pos_var)
        else:
            points = contract(points)
    if cfg.arch in ("factored", "hashgrid"):
        from .factored import apply_factored
        from .hashgrid import apply_hashgrid

        apply = apply_factored if cfg.arch == "factored" else apply_hashgrid
        sigma_raw, rgb_raw = apply(params, points, viewdirs, cfg, dtype)
        rgb = torch.sigmoid(rgb_raw) if cfg.rgb_activation == "sigmoid" else rgb_raw
        sigma_raw = _sigma_noise(sigma_raw, noise_std, noise)
        return sigma_activation(sigma_raw, cfg.sigma_activation), rgb
    low = dtype is not None and dtype != torch.float32
    if cfg.ipe and pos_var is not None:
        x = integrated_posenc(points, pos_var, cfg.pos_enc_levels, cfg.include_input_in_enc)
    else:
        x = posenc(points, cfg.pos_enc_levels, cfg.include_input_in_enc)
    if low:
        x = x.to(dtype)
    h = x
    for i, layer in enumerate(params.trunk):
        if i == cfg.skip_layer and i > 0:
            h = torch.cat([h, x], dim=-1)
        h = F.relu(dense(h, layer, dtype))
    sigma_raw = dense(h, params.sigma, dtype)[..., 0].float()
    feat = dense(h, params.feature, dtype)
    if cfg.use_viewdirs:
        d = posenc(viewdirs, cfg.dir_enc_levels, cfg.include_input_in_enc)
        d = d.expand(*feat.shape[:-1], d.shape[-1])
        if low:
            d = d.to(dtype)
        hv = F.relu(dense(torch.cat([feat, d], dim=-1), params.view1, dtype))
        rgb_raw = dense(hv, params.rgb, dtype).float()
    else:
        rgb_raw = dense(feat, params.rgb, dtype).float()
    rgb = torch.sigmoid(rgb_raw) if cfg.rgb_activation == "sigmoid" else rgb_raw
    sigma_raw = _sigma_noise(sigma_raw, noise_std, noise)
    return sigma_activation(sigma_raw, cfg.sigma_activation), rgb


def _sigma_noise(sigma_raw: torch.Tensor, noise_std: float,
                 noise: Optional[torch.Tensor]) -> torch.Tensor:
    if noise_std > 0.0 and noise is not None:
        return sigma_raw + noise_std * noise
    return sigma_raw
