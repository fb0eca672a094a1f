"""The whole-ray render kernel: PE or IPE (of the contracted points or
Gaussians with ``cfg.contract``) -> field -> alpha compositing for whole
rays, reading only per-ray inputs. The counterpart of
``nerf_rs_tpu/kernels/fused_ray.py``.

``fused_ray_render`` launches the CUDA kernel (``csrc/fused_ray.cu``)
for CUDA tensors, and runs ``fused_ray_render_reference``, its plain
PyTorch version, for CPU tensors. There is no other switch: on a CUDA
tensor it launches the kernel or raises.

Rays of any length. The kernel takes whole rays in 128-row passes
(``cta_rows``: 128 / S rays per CTA up to 128 samples, two rays of 192 in
three passes, one of 256 or more in S / 128) as tiles of persistent CTAs, in
clusters of ``K1_CLUSTER`` that share every weight slice (``k1_cta_rays``
mirrors the grid), and
multiplies by the weights in its own layout (``PackedWeights.k1``). So the
wrapper pads S to
``padded_samples(S)`` with zero-length intervals at the far end (``pad_samples``, the JAX wrappers' pad): such
an interval has alpha = 1 - exp(-sigma * 0) = 0, so its weight is
exactly 0, and the pads are trimmed from the weights and sigma. The
plain version needs no pad. The pads repeat the last t, so 1/t (the
distortion loss's disparity) and the IPE moments stay finite.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..config import ModelConfig

from . import build
from .fused_render import (PackedWeights, contract_gaussian, contract_points, ipe_encode,
                           ipe_expand, pe_encode)

_SIGMA_ACT = {"relu": 0, "softplus": 1}
TILE_ROWS = 128  # sample rows per CTA pass (kRows in csrc/field.cuh)
K1_CLUSTER = 2  # K1's CTAs per cluster, each weight slice shared (kCluster in csrc/fused_ray.cu)

_SHAPE_ERRORS = {
    -1: "padded num_samples must divide 128, or be 192 or a multiple of 128",
    -2: "the packed weights do not match the kernel's layer list",
    -3: "packed layer widths and padded encodings must be multiples of 16 (pack_weights pads "
        "every width to one)",
    -4: "the encoding does not fit its padded width",
    -5: "the CTA's layout needs more shared memory than the card gives a block, even the "
        "mma.sync wide instance's (which keeps the activations and encodings in device memory)",
    -6: "sigma_activation must be relu or softplus",
    -7: "radii must come with cfg.ipe and only with it",
    -8: "contract must be 0 or 1",
    -9: "dist_disparity must be 0 or 1",
}

Out = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def padded_samples(S: int) -> int:
    """The samples per ray the kernels run for S: the next power of two
    up to 128 (a divisor of the pass), 192 for 129 to 192 (two rays fill
    three passes), 256 for 193 to 256, else the next multiple of 128 (one
    ray in S / 128 passes)."""
    if S <= TILE_ROWS:
        return 1 << (S - 1).bit_length()
    if S <= 192:
        return 192
    return -(-S // TILE_ROWS) * TILE_ROWS


def rays_per_cta(S: int) -> int:
    """Whole rays a CTA takes at the padded S (csrc/field.cuh
    ``rays_per_cta``): 128 / S, 2 at 192, else 1."""
    if S <= TILE_ROWS:
        return TILE_ROWS // S
    return 2 if S == 192 else 1


def cta_rows(S: int) -> torch.Tensor:
    """The CTA's row-to-ray mapping at the padded S, as the kernels walk
    it: (passes, 128, 2) int64 of (ray within the CTA, sample) for each
    128-row pass, CTA row s0 + r being ray (s0 + r) // S, sample (s0 + r)
    % S. A pass may end one ray and start the next (S = 192's second)."""
    rows = torch.arange(rays_per_cta(S) * S).reshape(-1, TILE_ROWS)
    return torch.stack([rows // S, rows % S], dim=-1)


def k1_grid(n_rays: int, S: int, clusters: int) -> Tuple[int, int]:
    """K1's persistent grid for n_rays rays at the padded S when the card
    holds ``clusters`` clusters at once (cudaOccupancyMaxActiveClusters in
    csrc/fused_ray.cu): (CTAs, tiles each CTA takes). A tile is the
    rays_per_cta(S) rays a CTA takes at a time; the grid is whole clusters,
    no more than the tiles need."""
    tiles = -(-n_rays // rays_per_cta(S))
    grid = min(-(-tiles // K1_CLUSTER), clusters) * K1_CLUSTER
    return grid, -(-tiles // grid)


def k1_cta_rays(n_rays: int, S: int, clusters: int) -> torch.Tensor:
    """K1's grid as it maps rays: (CTAs, iterations, rays_per_cta) int64;
    CTA b's k-th tile is tile b + k CTAs, whose whole rays are R t .. R t +
    R - 1, -1 past the last ray (such a tile runs on zero rows and stores
    nothing). Every CTA, and so both CTAs of a cluster, runs the same
    number of tiles."""
    R = rays_per_cta(S)
    grid, iters = k1_grid(n_rays, S, clusters)
    tile = torch.arange(grid)[:, None] + torch.arange(iters)[None, :] * grid
    rays = tile[:, :, None] * R + torch.arange(R)
    return torch.where(rays < n_rays, rays, -1)


def pad_samples(ts: torch.Tensor, deltas: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, S) -> (N, padded_samples(S)): zero-length intervals at the far
    end whose ts repeat the last one (so IPE moments stay finite). Their
    weight is exactly 0 and so is every gradient they give."""
    n, S = ts.shape
    pad = padded_samples(S) - S
    if pad == 0:
        return ts, deltas
    return (torch.cat([ts, ts[:, -1:].expand(n, pad)], dim=1),
            torch.cat([deltas, deltas.new_zeros(n, pad)], dim=1))


def _check(packed: PackedWeights, origins, dirs, viewdirs, ts, deltas,
           cfg: ModelConfig, num_samples: int, radii=None) -> None:
    """Shape and config checks, the same on every device."""
    n = origins.shape[0]
    if num_samples < 1:
        raise ValueError(f"num_samples={num_samples}: the kernels take one sample per ray "
                         f"or more")
    if ts.shape != (n, num_samples) or deltas.shape != (n, num_samples):
        raise ValueError(f"ts/deltas must be ({n}, {num_samples}), got "
                         f"{tuple(ts.shape)} / {tuple(deltas.shape)}")
    for name, a in (("origins", origins), ("dirs", dirs),
                    ("viewdirs", viewdirs)):
        if a.shape != (n, 3):
            raise ValueError(f"{name} must be ({n}, 3), got {tuple(a.shape)}")
    if cfg.ipe and (radii is None or radii.shape != (n,)):
        raise ValueError(f"cfg.ipe needs per-ray radii of shape ({n},), got "
                         f"{None if radii is None else tuple(radii.shape)}")
    if not cfg.ipe and radii is not None:
        raise ValueError("radii are for cfg.ipe (interval midpoints and lengths) only")
    if cfg.sigma_activation not in _SIGMA_ACT:
        raise ValueError(
            f"sigma_activation={cfg.sigma_activation!r}: the kernel takes "
            f"{sorted(_SIGMA_ACT)}")
    got = (packed.depth, packed.skip_layer, packed.pos_levels,
           packed.dir_levels, *packed.widths)
    want = (cfg.net_depth, cfg.skip_layer, cfg.pos_enc_levels,
            cfg.dir_enc_levels, cfg.net_width, cfg.feature_width,
            cfg.view_head_width)
    if got != want:
        raise ValueError(f"packed weights are for {got}, cfg asks {want}")


def _check_device(tensors, dev) -> None:
    for a in tensors:
        if a.device != dev or a.dtype != torch.float32:
            raise ValueError("ray inputs must be f32 on one CUDA device")
        if not a.is_contiguous():
            raise ValueError("ray inputs must be contiguous")


def fused_ray_render(
    packed: PackedWeights,
    origins: torch.Tensor,
    dirs: torch.Tensor,
    viewdirs: torch.Tensor,
    ts: torch.Tensor,
    deltas: torch.Tensor,
    cfg: ModelConfig,
    num_samples: int,
    radii: Optional[torch.Tensor] = None,
) -> Out:
    """Render N rays whole: origins/dirs/viewdirs (N, 3), ts/deltas
    (N, S) f32. Returns (rgb (N, 3), acc (N,), depth (N,), weights
    (N, S), sigma (N, S)); a white background stays with the caller.

    ``cfg.ipe``: ts are interval midpoints, deltas exact interval
    lengths, and ``radii`` (N,) f32 the cones' radii at unit distance;
    the kernel encodes each interval's conical-frustum Gaussian.
    ``cfg.contract``: the points (or Gaussians) are contracted into the
    radius-2 ball before the encoding (mip-NeRF 360).

    Any N: the kernel masks the ragged last tile. Any S >= 1 (past 256
    samples, or where a CTA's per-sample values do not fit beside its tiles,
    the kernel's streamed instance composites pass by pass). Any widths
    (``pack_weights`` pads them to multiples of 16; past 256 the kernel's
    cluster route runs, the packed weights repacked into a scratch:
    ``route``), any depth and any encoding (where no wgmma layout fits the
    encodings, the cluster route runs too). Launches
    on the current stream without synchronising.
    """
    _check(packed, origins, dirs, viewdirs, ts, deltas, cfg, num_samples, radii)
    if origins.device.type == "cpu":
        return fused_ray_render_reference(
            packed, origins, dirs, viewdirs, ts, deltas, cfg, num_samples, radii)
    if origins.device.type != "cuda":
        raise ValueError(f"no kernel for device {origins.device}")
    dev = origins.device
    _check_device((origins, dirs, viewdirs, ts, deltas)
                  + ((radii,) if radii is not None else ()), dev)
    if (packed.w.device != dev or packed.w.dtype != torch.bfloat16
            or packed.b.device != dev or packed.b.dtype != torch.float32):
        raise ValueError("packed weights must be bf16/f32 on the rays' device")

    n = origins.shape[0]
    ts_p, dl_p = pad_samples(ts, deltas)
    S = ts_p.shape[1]
    rgb = torch.empty(n, 3, device=dev)
    acc = torch.empty(n, device=dev)
    depth = torch.empty(n, device=dev)
    w = torch.empty(n, S, device=dev)
    sigma = torch.empty(n, S, device=dev)
    lib = _library()
    # the wgmma instances read K1's own layout; the wide routes, which the
    # kernel takes where it asks for a scratch (past width 256, or where no
    # wgmma layout fits the encodings), the packed weights' (K2's)
    nbytes = lib.nerf_fused_ray_scratch_bytes(n, S, packed.depth, packed.W, packed.F, packed.V,
                                              packed.P, packed.D)
    if nbytes < 0:
        raise ValueError(f"fused_ray kernel refused the call: {_SHAPE_ERRORS[-1]}"
                         if nbytes == -1 else f"CUDA error {-nbytes} sizing the scratch")
    if nbytes > 0:
        kw, kw_off, offsets, kb = packed.w, packed.w_off, packed.offsets, None
        scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    else:
        k1 = packed.k1
        kw, kw_off, offsets, kb, scratch = k1.w, k1.w_off, packed.k1_offsets, k1.b.data_ptr(), None
    i64 = ctypes.c_longlong
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.nerf_fused_ray_render(
        origins.data_ptr(), dirs.data_ptr(), viewdirs.data_ptr(), ts_p.data_ptr(),
        dl_p.data_ptr(), None if radii is None else radii.data_ptr(),
        kw.data_ptr(), packed.b.data_ptr(), kb,
        offsets.data_ptr(), len(packed.w_off), len(packed.b_off),
        (i64 * len(kw_off))(*kw_off), (i64 * len(packed.b_off))(*packed.b_off),
        rgb.data_ptr(), acc.data_ptr(), depth.data_ptr(), w.data_ptr(),
        sigma.data_ptr(), n, S, packed.depth, packed.skip_layer, packed.W,
        packed.F, packed.V, packed.P, packed.D, packed.pos_levels,
        packed.dir_levels, _SIGMA_ACT[cfg.sigma_activation], int(cfg.ipe),
        int(cfg.contract), None if scratch is None else scratch.data_ptr(), stream,
    )
    if rc < 0:
        raise ValueError(f"fused_ray kernel refused the call: {_SHAPE_ERRORS[rc]}")
    if rc > 0:
        msg = lib.nerf_cuda_error_string(rc).decode()
        raise RuntimeError(f"fused_ray kernel launch failed: CUDA error {rc} ({msg})")
    fused_ray_render.launches += 1
    return rgb, acc, depth, w[:, :num_samples], sigma[:, :num_samples]


# kernel launches so far in this process; a run reads it to show that
# its path went through the kernel
fused_ray_render.launches = 0


def _library() -> ctypes.CDLL:
    lib = build.load("fused_ray")
    fn = lib.nerf_fused_ray_render
    if fn.argtypes is None:
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = (
            [vp] * 10 + [i32, i32, ctypes.POINTER(i64), ctypes.POINTER(i64)]
            + [vp] * 5
            + [i64] + [i32] * 13
            + [vp, vp]
        )
        fn.restype = i32
        size = lib.nerf_fused_ray_scratch_bytes
        size.argtypes = [i64] + [i32] * 7
        size.restype = i64
        lib.nerf_fused_ray_route.argtypes = [i32] * 6
        lib.nerf_fused_ray_route.restype = i32
        lib.nerf_cuda_error_string.argtypes = [i32]
        lib.nerf_cuda_error_string.restype = ctypes.c_char_p
    return lib


K1_ROUTES = ("wgmma", "cluster", "mma.sync wide")


def route(packed: PackedWeights, num_samples: int) -> str:
    """The K1 instance the kernel takes for ``packed``'s widths and encodings
    at ``num_samples`` (C ``k1_route``, decided by shape on the card's shared
    memory): "wgmma" (fields up to 256 wide), "cluster" (the wide route:
    column blocks of 256 in clusters) or "mma.sync wide" (past 2,048 wide,
    or encodings the cluster layout does not hold). Needs the built
    library, so the card."""
    rc = _library().nerf_fused_ray_route(padded_samples(num_samples), packed.W, packed.F,
                                         packed.V, packed.P, packed.D)
    if rc < 0:
        raise ValueError(_SHAPE_ERRORS[-1] if rc == -1 else f"CUDA error {-rc} asking the route")
    return K1_ROUTES[rc]


def fused_ray_render_reference(
    packed: PackedWeights,
    origins: torch.Tensor,
    dirs: torch.Tensor,
    viewdirs: torch.Tensor,
    ts: torch.Tensor,
    deltas: torch.Tensor,
    cfg: ModelConfig,
    num_samples: int,
    radii: Optional[torch.Tensor] = None,
    *,
    dtype: torch.dtype = torch.float32,
) -> Out:
    """The kernel's plain PyTorch version, with its numerics: bf16
    operands, f32 products and sums (bf16 x bf16 products are exact in
    f32), f32 bias and relu, then rounding to bf16 between layers; f32
    encodings (PE, or IPE from ``ipe_expand``, after the contraction with
    ``cfg.contract``) and compositing. On CUDA it needs full-f32 matmuls
    (``torch.backends.cuda.matmul.allow_tf32 = False``).

    ``dtype=torch.float64`` keeps every bf16 rounding point (and the f32
    encoding) but multiplies, sums and composites in float64: a witness of
    how far f32 summation order alone moves the result, as
    ``fused_train_grads_reference``'s."""
    _check(packed, origins, dirs, viewdirs, ts, deltas, cfg, num_samples, radii)
    n, S = ts.shape
    bf = torch.bfloat16
    mats = [m.to(dtype) for m in packed.matrices()]
    bias = [b.to(dtype) for b in packed.biases()]
    depth, skip, Fw = packed.depth, packed.skip_layer, packed.F

    x = encode_samples(packed, origins, dirs, ts, deltas, radii, cfg.contract).to(bf)
    dv = pe_encode(viewdirs, packed.dir_levels, packed.D).to(bf)
    dv = dv.repeat_interleave(S, dim=0)

    def mm(a, w):
        return a.to(dtype) @ w

    h = x
    for i in range(depth):
        acc = mm(h, mats[i])
        if i == skip and i > 0:
            acc = acc + mm(x, mats[depth])
        h = F.relu(acc + bias[i]).to(bf)
    sf = mm(h, mats[depth + 1]) + bias[depth]
    sigma_raw = sf[:, Fw]
    feat = sf[:, :Fw].to(bf)
    hv = mm(feat, mats[depth + 2]) + mm(dv, mats[depth + 3])
    hv = F.relu(hv + bias[depth + 1]).to(bf)
    rgb = torch.sigmoid(mm(hv, mats[depth + 4]) + bias[depth + 2])[:, :3]

    if cfg.sigma_activation == "relu":
        sigma = F.relu(sigma_raw)
    else:
        sigma = torch.logaddexp(sigma_raw, torch.zeros_like(sigma_raw))
    sigma = sigma.reshape(n, S)
    a = sigma * deltas
    excl = torch.cat([torch.zeros_like(a[:, :1]), torch.cumsum(a[:, :-1], dim=-1)], -1)
    w = torch.exp(-excl) * (1.0 - torch.exp(-a))
    rgb = (w[:, :, None] * rgb.reshape(n, S, 3)).sum(dim=1)
    return rgb, w.sum(dim=-1), (w * ts).sum(dim=-1), w, sigma


def encode_samples(packed: PackedWeights, origins, dirs, ts, deltas, radii=None,
                   contract: bool = False) -> torch.Tensor:
    """The kernels' f32 encoding of every sample row, (N * S, P): PE of
    o + t d, or with ``radii`` the IPE of each interval's frustum; with
    ``contract`` the point or the Gaussian is contracted first
    (``contract_points``, ``contract_gaussian``)."""
    if radii is not None:
        mean, var = ipe_expand(origins, dirs, ts, deltas, radii)
        if contract:
            mean, var = contract_gaussian(mean, var)
        return ipe_encode(mean, var, packed.pos_levels, packed.P)
    pts = (origins[:, None, :] + ts[:, :, None] * dirs[:, None, :]).reshape(-1, 3)
    if contract:
        pts = contract_points(pts)
    return pe_encode(pts, packed.pos_levels, packed.P)
