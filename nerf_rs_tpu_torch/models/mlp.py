"""The paper NeRF field and the reference's compat field as
``nn.Module``s, the counterparts of the ``nerf`` arch and compat mode in
``nerf_rs_tpu/models/mlp.py``, and the dispatch over the field families
(``init_nerf_params``, ``apply_nerf``).

gamma(x) -> depth x width ReLU trunk, with the encoded position
re-injected (concatenated after the hidden state) before layer
``skip_layer`` -> sigma head (1) + feature head -> [feature, gamma(d)]
-> view head -> sigmoid RGB.

Weights keep the JAX layout and names so that a parameter tree converts
one to one (``convert.py``): every layer is a ``Dense`` holding ``w`` of
shape (in, out) and ``b`` of shape (out,); the state-dict keys are
``trunk.{i}.w/b``, ``sigma``, ``feature``, ``view1`` and ``rgb``
(compat: ``trunk.{i}``, ``head1``, ``head2``).

The families: the paper arch (with PE, or mip-NeRF's integrated encoding
of Gaussians), the factored arch (``models/factored.py``) and the hash
grid (``models/hashgrid.py``, both table layouts), each with mip-NeRF
360's scene contraction in front of it (``cfg.contract``) and the paper's
sigma noise on its raw density; and ``cfg.compat``, the reference's
committed field (``CompatMLP``), which wins over every other setting.
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


class CompatMLP(nn.Module):
    """The reference's committed field (its DensityNet, then its
    RadianceNet): raw xyz -> ``trunk.0`` 3 -> W, ``trunk.1..6`` W -> W,
    ``trunk.7`` W -> W + 1 (channel 0 the raw density, the rest features),
    then ``head1`` W -> H and ``head2`` H -> 4 (RGBA), W = ``compat_width``
    and H = ``compat_head_width``. ``forward`` is ``apply_nerf``."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        w = cfg.compat_width
        self.cfg = cfg
        self.trunk = nn.ModuleList([Dense(3, w, device)]
                                   + [Dense(w, w, device) for _ in range(6)]
                                   + [Dense(w, w + 1, device)])
        self.head1 = Dense(w, cfg.compat_head_width, device)
        self.head2 = Dense(cfg.compat_head_width, 4, device)

    def forward(self, points, viewdirs=None, dtype=None):
        return apply_nerf(self, points, viewdirs, self.cfg, dtype)


def linear_default_init_(model: nn.Module, rng: np.random.Generator) -> None:
    """libtorch's ``nn::Linear`` default into every ``Dense`` of ``model``,
    in module order, weights then bias: both U(-1/sqrt(fan_in),
    1/sqrt(fan_in)) (kaiming_uniform with a = sqrt(5) gives the weights'
    bound), the draw of the reference's VarStore that compat mode keeps
    (``_init_linear_torch`` in the JAX package)."""
    with torch.no_grad():
        for layer in model.modules():
            if isinstance(layer, Dense):
                bound = 1.0 / math.sqrt(layer.w.shape[0])
                for t in (layer.w, layer.b):
                    t.copy_(torch.from_numpy(rng.uniform(-bound, bound, tuple(t.shape))))


def count_params(model: nn.Module) -> int:
    """The number of weights of a field (or any module)."""
    return sum(p.numel() for p in model.parameters())


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

    ``cfg.compat`` wins over ``arch``, ``ipe`` and ``contract``: a
    ``CompatMLP`` with libtorch's default draw (``linear_default_init_``).
    """
    if cfg.compat:
        model = CompatMLP(cfg)
        linear_default_init_(model, seed_rng(seed, stream))
        return model.to(device)
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
    return raw  # "none" (compat): the raw density, which may be negative


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

    ``cfg.compat`` (a ``CompatMLP``): ``_apply_compat``, which takes the
    raw points and no view direction and returns rgba (..., 4); nothing
    above (contraction, encodings) applies to it.
    """
    if cfg.compat:
        return _apply_compat(params, points, cfg, dtype, noise_std, noise)
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


def _apply_compat(params: nn.Module, points: torch.Tensor, cfg: ModelConfig, dtype=None,
                  noise_std: float = 0.0,
                  noise: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's forward: the raw points through the eight trunk
    layers with a ReLU between them and none after the last; channel 0 of
    its output is the raw density (the sigma noise added to it), the rest
    the features, which go through ``head1``, a ReLU, ``head2`` and a
    sigmoid to RGBA (..., 4). The view direction is no input (the
    reference's own gap). With ``cfg.sigma_activation`` "none" the density
    stays raw and may be negative."""
    h = points
    for layer in params.trunk[:-1]:
        h = F.relu(dense(h, layer, dtype))
    out = dense(h, params.trunk[-1], dtype)
    sigma_raw = _sigma_noise(out[..., 0].float(), noise_std, noise)
    h2 = F.relu(dense(out[..., 1:], params.head1, dtype))
    rgba = torch.sigmoid(dense(h2, params.head2, dtype).float())
    return sigma_activation(sigma_raw, cfg.sigma_activation), rgba
