"""The Instant-NGP radiance field (multiresolution hash encoding + tiny
heads, arXiv 2201.05989), the counterpart of ``nerf_rs_tpu/models/hashgrid.py``,
and the tiny sigma and color heads that the grid-encoding field families
share:

    enc -> W -> 1 + G          (sigma net; channel 0 is sigma_raw)
    [G, PE(dir)] -> W -> W -> 3   (color net)

with W = ``hash_mlp_width`` and G = ``hash_geo_feats``. Each layer is a
``Dense`` named as the JAX leaf (``sigma1``, ``sigma2``, ``color1``,
``color2``, ``rgb``).

The field is a ``HashGridField`` holding ``table`` and the heads. Level l
has the resolution ``level_resolutions(cfg)[l]``; a level whose grid fits
its block of the table is indexed densely, the others through the spatial
hash of ``_PRIMES``. Two table layouts, as in the JAX package:
  * flat (``hash_encode``): (L T, F) entries, the 8 trilinear corners of a
    (point, level) fetched as F = 2 pairs through K4's ``gather_pairs``, or
    as rows of any other F through K4's ``gather_rows``;
  * brick (``brick_encode``, ``--preset ngp``): (L Tb, 128) rows, each a
    4^3-vertex brick of F = 2 features, one row per (point, level) through
    K4's ``gather_rows``, the 8 corners then picked from its lanes.
The fetch is a ``torch.autograd.Function`` whose backward sums the
cotangents of the fetched values into the table (the JAX package's
``jnp.take`` VJP) through ``kernels/gather_rows.scatter_rows``, in a fixed
order, so the table's gradient has the same bits on every run. It saves the
indices, not the rows.

The encode is f32 under every precision; the heads cast it to bf16 under
"mixed". Hash arithmetic is the JAX package's uint32 product with
wraparound, computed in int64 and masked with ``& (T - 1)``: T is a power of
two, so the low bits are the wrapped product's.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..config import ModelConfig

from .encoding import posenc, posenc_dim
from .mlp import Dense, dense, he_init_, seed_rng

# instant-ngp's spatial-hash primes (pi_1 = 1 keeps x-major dense locality)
_PRIMES = (1, 2654435761, 805459861)

# points per brick_encode call (the JAX package's): bounds the (chunk L, 128)
# f32 rows that one gather_rows call writes (1.07 GB at L = 16)
_BRICK_CHUNK = 1 << 17

# the 8 trilinear corners (dx, dy, dz), x-major, as the JAX package orders them
_CORNERS = [(dx, dy, dz) for dx in (0, 1) for dy in (0, 1) for dz in (0, 1)]


def level_resolutions(cfg: ModelConfig) -> List[int]:
    """N_l = floor(N_min b^l), b chosen so that level L - 1 hits N_max
    (paper eq. 2-3)."""
    L = cfg.hash_levels
    if L == 1:
        return [cfg.hash_base_res]
    b = math.exp((math.log(cfg.hash_max_res) - math.log(cfg.hash_base_res)) / (L - 1))
    return [int(math.floor(cfg.hash_base_res * (b ** l))) for l in range(L)]


def brick_table_entries(cfg: ModelConfig) -> int:
    """Bricks per level at the flat layout's parameter budget: a 128-wide
    row holds 64 vertices x F features, so T_b = T F / 128."""
    return max(1, ((1 << cfg.hash_table_log2) * cfg.hash_features) // 128)


def table_shape(cfg: ModelConfig) -> Tuple[int, int]:
    if cfg.hash_brick:
        return cfg.hash_levels * brick_table_entries(cfg), 128
    return cfg.hash_levels * (1 << cfg.hash_table_log2), cfg.hash_features


def unit_coords(points: torch.Tensor, aabb: float) -> torch.Tensor:
    """(N, 3) world points -> clip((p + aabb) / (2 aabb), 0, 1), with an
    IEEE f32 division (a CUDA division by a Python scalar multiplies by
    its reciprocal instead, which can move a point across a cell)."""
    two = torch.full((), 2.0 * aabb, dtype=torch.float32, device=points.device)
    return torch.clamp((points + aabb) / two, 0.0, 1.0)


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


class HashGridField(nn.Module):
    """Parameters of the hash-grid field; ``forward`` is ``apply_nerf``."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.table = nn.Parameter(torch.zeros(table_shape(cfg), device=device))
        init_tiny_heads(self, cfg.hash_levels * cfg.hash_features, cfg, device)

    def forward(self, points, viewdirs, dtype=None):
        from .mlp import apply_nerf

        return apply_nerf(self, points, viewdirs, self.cfg, dtype)


def init_hash_params(cfg: ModelConfig, seed: int = 0, device=None,
                     stream: int = 0) -> HashGridField:
    """The table U(-1e-4, 1e-4) (paper section 4), then the heads He
    truncated-normal with zero biases, all drawn with numpy from ``seed``
    (``stream`` as in ``mlp.init_nerf_params``): the same weights on every
    device and torch version."""
    rng = seed_rng(seed, stream)
    model = HashGridField(cfg)
    with torch.no_grad():
        table = rng.uniform(-1e-4, 1e-4, tuple(model.table.shape)).astype(np.float32)
        model.table.copy_(torch.from_numpy(table))
    he_init_(model, rng)
    return model.to(device)


def _check_int32(table: torch.Tensor) -> None:
    if table.numel() >= 2 ** 31:
        raise ValueError(f"K4 takes int32 indices: a table of {table.numel()} elements is too big")


class _PairFetch(torch.autograd.Function):
    """(L T, 2) table, (M,) even flat element indices -> (M, 2) pairs
    through ``gather_pairs``; the backward sums the cotangents into rows
    fidx / 2 (``scatter_rows``)."""

    @staticmethod
    def forward(ctx, table, fidx):
        from ..kernels.gather_rows import gather_pairs

        ctx.save_for_backward(fidx)
        ctx.shape = table.shape
        return gather_pairs(table.view(-1), fidx)

    @staticmethod
    def backward(ctx, g):
        from ..kernels.gather_rows import scatter_rows

        (fidx,) = ctx.saved_tensors
        return scatter_rows(g.float().contiguous(), fidx // 2, None, (0, 1), ctx.shape), None


class _RowFetch(torch.autograd.Function):
    """(L T, F) table, (M,) row indices -> (M, F) rows through
    ``gather_rows`` (the flat layout at F != 2); the backward sums the
    cotangents into those rows at lanes 0..F-1 (``scatter_rows``)."""

    @staticmethod
    def forward(ctx, table, ridx):
        from ..kernels.gather_rows import gather_rows

        ctx.save_for_backward(ridx)
        ctx.shape = table.shape
        return gather_rows(table, ridx)

    @staticmethod
    def backward(ctx, g):
        from ..kernels.gather_rows import scatter_rows

        (ridx,) = ctx.saved_tensors
        return (scatter_rows(g.float().contiguous(), ridx, None, tuple(range(ctx.shape[1])),
                             ctx.shape), None)


# lane of corner c's feature f in a brick row, less the point's base lane
# ((o_x 4 + o_y) 4 + o_z) 2: ((dx 4 + dy) 4 + dz) 2 + f, in (corner, feature) order
_CORNER_LANES = [((dx * 4 + dy) * 4 + dz) * 2 + f for dx, dy, dz in _CORNERS for f in (0, 1)]


class _BrickFetch(torch.autograd.Function):
    """(L Tb, 128) table, (M,) row indices and (M,) base lanes -> (M, 16):
    the 8 corners' F = 2 features, one ``gather_rows`` row each then picked
    from its lanes; the backward sums the cotangents into the rows at those
    lanes (``scatter_rows``)."""

    @staticmethod
    def forward(ctx, table, rows_idx, base_lane):
        from ..kernels.gather_rows import gather_rows

        ctx.save_for_backward(rows_idx, base_lane)
        ctx.shape = table.shape
        return gather_rows(table, rows_idx).gather(1, _lanes(base_lane))

    @staticmethod
    def backward(ctx, g):
        from ..kernels.gather_rows import scatter_rows

        rows_idx, base_lane = ctx.saved_tensors
        return (scatter_rows(g.float().contiguous(), rows_idx, base_lane, _CORNER_LANES,
                             ctx.shape), None, None)


def _constant(values, dtype, device) -> torch.Tensor:
    """A small host constant on ``device``. Copied without waiting: a
    blocking host-to-card copy would wait for the card's queue on every
    call of an encode."""
    return torch.tensor(values, dtype=dtype).to(device, non_blocking=True)


def _lanes(base_lane: torch.Tensor) -> torch.Tensor:
    return base_lane.long()[:, None] + _constant(_CORNER_LANES, torch.int64, base_lane.device)


def _level_constants(cfg: ModelConfig, device):
    """(res (L,) f32, res (L,) int64, level index (L,) int64) on ``device``."""
    res = level_resolutions(cfg)
    return (_constant(res, torch.float32, device), _constant(res, torch.int64, device),
            torch.arange(len(res), device=device))


def _index(cx, cy, cz, side, dense, size: int) -> torch.Tensor:
    """Entry of vertex (cx, cy, cz) in its level's block: dense
    cx + side (cy + side cz) where the level's grid fits (``dense``), else
    the spatial hash masked to ``size`` entries."""
    flat_dense = cx + side * (cy + side * cz)
    flat_hash = (cx * _PRIMES[0] ^ cy * _PRIMES[1] ^ cz * _PRIMES[2]) & (size - 1)
    return torch.where(dense, flat_dense, flat_hash)


def _trilinear(fr: torch.Tensor) -> torch.Tensor:
    """(..., 3) cell fractions -> (..., 8) corner weights in ``_CORNERS``
    order, each the product (w_x w_y) w_z as the JAX package forms it."""
    w = [torch.stack([1.0 - fr[..., a], fr[..., a]], -1) for a in range(3)]
    prod = w[0][..., :, None, None] * w[1][..., None, :, None] * w[2][..., None, None, :]
    return prod.reshape(*fr.shape[:-1], 8)


def hash_encode(table: torch.Tensor, points: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Flat layout: (..., 3) world points -> (..., L F) f32 features, the
    trilinear sum over each level's 8 grid vertices, fetched as F = 2 pairs
    through K4's ``gather_pairs``, or at any other F as whole (F,) rows
    through K4's ``gather_rows``. Differentiable in the table.

    A point on the far face (u = 1) has floor(u res) = res, so its upper
    corners sit at res + 1 with weight 0; on a dense level their flat
    index runs past the level's grid into the next level's block, as in
    the JAX package. Past the table's end it is clamped to the last entry
    (where ``jnp.take`` would fill NaN and the JAX encoding turns NaN): the
    value is multiplied by 0 and never read outside the table."""
    L, Fe = cfg.hash_levels, cfg.hash_features
    _check_int32(table)
    T = 1 << cfg.hash_table_log2
    lead = points.shape[:-1]
    u = unit_coords(points.reshape(-1, 3), cfg.hash_aabb)
    res_f, res_i, lv = _level_constants(cfg, u.device)
    scaled = u[:, None, :] * res_f[None, :, None]  # (N, L, 3)
    lo = torch.floor(scaled)
    fr = scaled - lo
    c = lo.long()[..., None] + torch.arange(2, device=u.device)  # (N, L, 3, 2) corner coords
    side = (res_i + 1)[None, :, None, None, None]
    dense = ((res_i + 1) ** 3 <= T)[None, :, None, None, None]
    entry = _index(c[:, :, 0, :, None, None], c[:, :, 1, None, :, None],
                   c[:, :, 2, None, None, :], side, dense, T)  # (N, L, 2, 2, 2)
    ridx = (entry + (lv * T)[None, :, None, None, None]).clamp_max(table.shape[0] - 1)
    if Fe == 2:
        vals = _PairFetch.apply(table, (ridx * Fe).to(torch.int32).reshape(-1))
    else:
        vals = _RowFetch.apply(table, ridx.to(torch.int32).reshape(-1))
    vals = vals.view(*fr.shape[:2], 8, Fe)
    enc = (vals * _trilinear(fr)[..., None]).sum(2)  # (N, L, F)
    return enc.reshape(*lead, L * Fe)


def brick_encode(table: torch.Tensor, points: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Brick layout: (..., 3) world points -> (..., L F) f32 features. Each
    table row is a 4^3-vertex brick covering 3^3 cells of a level's grid,
    so a (point, level)'s 8 corners lie in one row: K4's ``gather_rows``
    fetches it and ``torch.gather`` picks the corners' lanes (the JAX
    package's one-hot lane reductions are a TPU workaround). Dense where
    the level's brick grid fits the level's Tb rows, hashed elsewhere.
    Points beyond ``_BRICK_CHUNK`` go in calls of that many, as the JAX
    package's ``lax.map`` does. Differentiable in the table."""
    L, Fe = cfg.hash_levels, cfg.hash_features
    if Fe != 2:
        raise ValueError("brick layout packs 64 vertices x F into one "
                         f"128-lane row: needs hash_features=2, got {Fe}")
    _check_int32(table)
    lead = points.shape[:-1]
    p = points.reshape(-1, 3)
    if p.shape[0] > _BRICK_CHUNK:
        enc = torch.cat([brick_encode(table, p[i:i + _BRICK_CHUNK], cfg)
                         for i in range(0, p.shape[0], _BRICK_CHUNK)])
        return enc.reshape(*lead, L * Fe)
    Tb = brick_table_entries(cfg)
    u = unit_coords(p, cfg.hash_aabb)
    res_f, res_i, lv = _level_constants(cfg, u.device)
    scaled = u[:, None, :] * res_f[None, :, None]  # (N, L, 3)
    v0 = torch.minimum(torch.floor(scaled).long().clamp_min(0), (res_i - 1)[None, :, None])
    fr = scaled - v0.float()  # in [0, 1]: 1 on the far face
    b = v0 // 3
    o = v0 - 3 * b  # the vertex's offset in its brick, {0, 1, 2}
    nb = (res_i - 1) // 3 + 1  # bricks per axis
    flat = _index(b[..., 0], b[..., 1], b[..., 2], nb[None, :], (nb ** 3 <= Tb)[None, :], Tb)
    rows_idx = (flat + lv * Tb).to(torch.int32).reshape(-1)
    base_lane = (((o[..., 0] * 4 + o[..., 1]) * 4 + o[..., 2]) * 2).to(torch.int32).reshape(-1)
    picked = _BrickFetch.apply(table, rows_idx, base_lane).view(*fr.shape[:2], 8, Fe)
    enc = (picked * _trilinear(fr)[..., None]).sum(2)  # (N, L, F)
    return enc.reshape(*lead, L * Fe)


def apply_hashgrid(
    params: HashGridField,
    points: torch.Tensor,
    viewdirs: Optional[torch.Tensor],
    cfg: ModelConfig,
    dtype=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sigma_raw (...,), rgb_raw (..., 3)), f32, before the activations:
    the encode of the table's layout, then the tiny heads."""
    encode = brick_encode if cfg.hash_brick else hash_encode
    return apply_tiny_heads(params, encode(params.table, points, cfg), viewdirs, cfg, dtype)
