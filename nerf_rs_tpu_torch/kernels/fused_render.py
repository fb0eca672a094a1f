"""Weight packing and the encodings of the whole-ray kernels (PE, and
mip-NeRF's conical-frustum moments with the integrated encoding, each
after mip-NeRF 360's contraction when the config asks for it), the
counterpart of ``nerf_rs_tpu/kernels/fused_render.py``.

The train kernel K2 (``csrc/fused_train.cu`` with ``csrc/field.cuh``)
multiplies with ``mma.sync.m16n8k16`` bf16 tensor-core instructions.
``pack_weights`` lays every matrix out so that each warp reads its B
fragments as one coalesced 8-byte load per lane:

    for each 8-column n-tile, for each 16-row k-step, for each lane
    (g = lane // 4, t = lane % 4): the bf16 pairs
    W[16k + 2t + {0,1}, 8n + g] and W[16k + 8 + 2t + {0,1}, 8n + g]

All matrices share one flat bf16 buffer and all biases one flat f32
buffer; ``w_off``/``b_off`` give each one's start. Padding follows the
tensor-core tile, not the TPU's lanes: the encodings pad to a multiple
of 16 rows (PE(x) 63 -> 64, PE(d) 27 -> 32), the [feature | sigma] head
to F + 8 columns (sigma in column F) and rgb to 8 columns. The widths
themselves pad to a multiple of 16 too (``padded_widths``: net_width 100
runs as 112, with zero rows, columns and biases): a pad column of a hidden
layer is relu(0) = 0 and meets only zero weights, the feature head is
linear, and sigma and rgb keep their columns, so the field computes the
same numbers; ``unpack_grads`` crops the pads from the gradients.

As in the JAX packing, the skip layer's weight splits in two: rows
[:W] multiply the hidden state and rows [W:] (the encoded input) become
``skip_w``. ``pack_weights_t`` packs the transposed matrices the train
kernel's backward multiplies by, in the same layout.

The render kernel K1 multiplies with ``wgmma`` and reads its weights from
a ring that bulk copies fill (``csrc/field_wgmma.cuh``), so it has a layout
of its own, ``pack_weights_k1`` (``PackedWeights.k1``, built once per packed
field on first use): each (K, N) matrix transposed to K-major 8 x 8 core
matrices, k group outermost,

    for each 8-row k group kg, for each 8-column group ng, for each column
    8 ng + nr, for each row 8 kg + kr: W[8 kg + kr, 8 ng + nr]

so every k-slice is one contiguous run of bytes, laid out in shared memory
as the wgmma descriptors read it. A product's width is a compile-time wgmma
shape, so each matrix's columns are padded with zeros to the next power of
two from 16 (``k1_width``; the rgb head keeps its 8, and [feature | sigma]
pads the feature block, sigma's 8 columns after it): no preset pads. A field
wider than 256 takes K1's and K2's wide routes, which read ``PackedWeights.w``
(and ``PackedWeightsT.w``) and repack it on the card into their own blocks of
256 columns (``csrc/field_cluster.cuh``; the kernel decides: ``fused_ray_render``).

The kernels read the matrices' and biases' offsets from a small int64
table in device memory (``build.device_table``; ``PackedWeights.offsets``,
``.k1_offsets``, ``PackedWeightsT.offsets``), not from their launch
parameters, so a field of any depth launches. A table depends on the
layout only: it is copied to the card once per layout and device, and a
step that packs new weights of the same layout adds no copy.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import List, Tuple

import torch
import torch.nn.functional as F

from ..config import ModelConfig

from ..models.encoding import integrated_posenc, posenc
# the plain versions of csrc/field.cuh's contract_points and
# contract_gaussian (the JAX package's _contract_points and
# _contract_gaussian) are ops/contract's functions: they take the device
# functions' steps in the same order
from ..ops.contract import contract as contract_points, contract_gaussian  # noqa: F401
from . import build


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def padded_widths(cfg: ModelConfig) -> Tuple[int, int, int]:
    """(net_width, feature_width, view_head_width) as the kernels run them:
    each padded to a multiple of 16 (the tensor-core k-step)."""
    return (_round_up(cfg.net_width, 16), _round_up(cfg.feature_width, 16),
            _round_up(cfg.view_head_width, 16))


def enc_dims(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    """(pos_dim, pos_pad, dir_dim, dir_pad): true encoding widths and
    the widths padded to the tensor-core k-step of 16."""
    pos = 3 + 6 * cfg.pos_enc_levels
    dird = 3 + 6 * cfg.dir_enc_levels
    return pos, _round_up(pos, 16), dird, _round_up(dird, 16)


def pe_encode(p: torch.Tensor, levels: int, pad: int) -> torch.Tensor:
    """posenc of (ROWS, 3) points -> (ROWS, pad) f32 with zero pad
    columns: raw p, then per level [sin(2^l p), cos(2^l p)]. The scales
    are exact powers of two and the arguments f32; a low-precision
    argument loses the high-frequency phases (sin(2^9 x))."""
    enc = posenc(p, levels, include_input=True)
    return F.pad(enc, (0, pad - enc.shape[-1]))


def ipe_encode(mean: torch.Tensor, var: torch.Tensor, levels: int, pad: int) -> torch.Tensor:
    """The integrated encoding of (ROWS, 3) Gaussians (mean, var) ->
    (ROWS, pad) f32 with zero pad columns, in ``pe_encode``'s layout:
    raw mean, then per level [sin, cos](2^l mean) * exp(-4^l var / 2)
    (``_ipe_encode`` in the JAX package). The damping is computed in f32
    from the f32 variance: at 4^9 a low-precision var would swamp it."""
    enc = integrated_posenc(mean, var, levels, include_input=True)
    return F.pad(enc, (0, pad - enc.shape[-1]))


def ipe_expand(origins: torch.Tensor, dirs: torch.Tensor, mids: torch.Tensor,
               deltas: torch.Tensor, radii: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Conical-frustum Gaussians for the whole-ray kernels: per-ray
    origins/dirs (N, 3), interval midpoints and exact lengths (N, S) and
    cone radii (N,) -> means and diagonal variances (N * S, 3), with
    ``ops/sampling.conical_gaussians``' closed forms in the order of the
    JAX package's ``_ipe_expand`` (``csrc/field.cuh``'s ``ipe_moments``
    rounds the same operations in the same order)."""
    mu = mids
    hw = 0.5 * deltas
    mu2, hw2 = mu * mu, hw * hw
    denom = 3.0 * mu2 + hw2
    t_mean = mu + 2.0 * mu * hw2 / denom
    t_var = hw2 / 3.0 - (4.0 / 15.0) * (hw2 * hw2 * (12.0 * mu2 - hw2) / (denom * denom))
    r = radii[:, None]
    r_var = r * r * (mu2 / 4.0 + (5.0 / 12.0) * hw2 - (4.0 / 15.0) * hw2 * hw2 / denom)
    d2 = dirs * dirs
    dn2 = torch.clamp(d2[:, 0] + d2[:, 1] + d2[:, 2], min=1e-10)[:, None]
    mean = origins[:, None, :] + t_mean[:, :, None] * dirs[:, None, :]
    var = t_var[:, :, None] * d2[:, None, :] + r_var[:, :, None] * (1.0 - d2 / dn2)[:, None, :]
    return mean.reshape(-1, 3), var.reshape(-1, 3)


@dataclass(frozen=True)
class PackedWeights:
    """All kernel weights in two flat buffers (see the module note)."""

    # flat bf16, swizzled matrices in kernel order:
    # trunk[0..depth), skip, sf, view (feature part), view (dir part), rgb
    w: torch.Tensor
    b: torch.Tensor  # flat f32, padded biases: trunk[0..depth), sf, view, rgb
    w_off: Tuple[int, ...]  # element offset of each matrix in w
    w_shape: Tuple[Tuple[int, int], ...]  # (K, N) of each matrix
    b_off: Tuple[int, ...]  # element offset of each bias in b
    depth: int
    skip_layer: int
    W: int  # trunk width, padded (padded_widths)
    F: int  # feature width, padded
    V: int  # view-head width, padded
    P: int  # padded PE(x) width
    D: int  # padded PE(d) width
    pos_levels: int
    dir_levels: int
    widths: Tuple[int, int, int]  # the config's (net, feature, view head) widths

    def matrices(self) -> List[torch.Tensor]:
        """The (K, N) bf16 matrices in kernel order, un-swizzled."""
        return [
            _unswizzle(self.w[o:o + k * n], k, n)
            for o, (k, n) in zip(self.w_off, self.w_shape)
        ]

    def biases(self) -> List[torch.Tensor]:
        """The padded f32 biases in kernel order."""
        ends = list(self.b_off[1:]) + [self.b.numel()]
        return [self.b[o:e] for o, e in zip(self.b_off, ends)]

    @functools.cached_property
    def k1(self) -> "PackedK1":
        """The same matrices in the render kernel's layout, packed on first
        use (``pack_weights_k1``)."""
        return pack_weights_k1(self)

    @functools.cached_property
    def offsets(self) -> torch.Tensor:
        """``w_off`` then ``b_off`` on the weights' device (``build.device_table``):
        K2's table, and K1's wide routes'."""
        return build.device_table(self.w_off + self.b_off, self.w.device, torch.int64)

    @functools.cached_property
    def k1_offsets(self) -> torch.Tensor:
        """``k1.w_off`` then ``b_off`` on the weights' device: the wgmma
        instances' table."""
        return build.device_table(self.k1.w_off + self.b_off, self.w.device, torch.int64)


def _swizzle(w: torch.Tensor) -> torch.Tensor:
    """(K, N) -> flat bf16 in the kernel's fragment order. K % 16 == 0,
    N % 8 == 0. Index (kt, h, t, p, nt, g) of the view below is row
    16kt + 8h + 2t + p, column 8nt + g."""
    k, n = w.shape
    v = w.to(torch.bfloat16).reshape(k // 16, 2, 4, 2, n // 8, 8)
    return v.permute(4, 0, 5, 2, 1, 3).reshape(-1)


def _unswizzle(flat: torch.Tensor, k: int, n: int) -> torch.Tensor:
    """Inverse of ``_swizzle``."""
    v = flat.reshape(n // 8, k // 16, 8, 4, 2, 2)
    return v.permute(1, 4, 3, 5, 0, 2).reshape(k, n)


def _core_k_major(w: torch.Tensor) -> torch.Tensor:
    """(K, N) -> flat bf16 in K1's order (module note): index (kg, ng, nr,
    kr) of the view below is W[8 kg + kr, 8 ng + nr]. K % 16 == 0, N % 8
    == 0."""
    k, n = w.shape
    return w.to(torch.bfloat16).reshape(k // 8, 8, n // 8, 8).permute(0, 2, 3, 1).reshape(-1)


def _uncore_k_major(flat: torch.Tensor, k: int, n: int) -> torch.Tensor:
    """Inverse of ``_core_k_major``."""
    return flat.reshape(k // 8, n // 8, 8, 8).permute(0, 3, 1, 2).reshape(k, n)


def k1_width(n: int) -> int:
    """K1's product width for n columns: the next power of two from 16
    (csrc/fused_ray.cu ``padded_width``)."""
    return max(16, 1 << (n - 1).bit_length())


@dataclass(frozen=True)
class PackedK1:
    """The render kernel's weights: ``PackedWeights``' matrices in kernel
    order, each with its columns padded (``k1_width``) and in K1's K-major
    core-matrix layout (module note), in one flat bf16 buffer; and the
    trunk's, feature's and view head's biases in the order its epilogues
    read them (``_fragment_order``)."""

    w: torch.Tensor
    b: torch.Tensor  # f32: trunk[0..depth) (W each), feature (F), view (V)
    w_off: Tuple[int, ...]
    w_shape: Tuple[Tuple[int, int], ...]  # (K, padded N) of each matrix
    shape: Tuple[Tuple[int, int], ...]  # (K, N) as PackedWeights has it
    sf: int  # the [feature | sigma] matrix's index
    F: int  # feature width

    def padded_matrices(self) -> List[torch.Tensor]:
        """The (K, padded N) bf16 matrices as the kernel multiplies them."""
        return [_uncore_k_major(self.w[o:o + k * n], k, n)
                for o, (k, n) in zip(self.w_off, self.w_shape)]

    def matrices(self) -> List[torch.Tensor]:
        """The (K, N) bf16 matrices in kernel order, pad columns dropped."""
        out = []
        for i, (m, (_, n)) in enumerate(zip(self.padded_matrices(), self.shape)):
            out.append(torch.cat([m[:, :self.F], m[:, -8:]], 1) if i == self.sf else m[:, :n])
        return out


def _fragment_order(b: torch.Tensor) -> torch.Tensor:
    """A layer's n biases (n % 16 == 0) in the order the quad lane q of a
    wgmma accumulator fragment (columns 8 j + 2 q + {0, 1}) reads them, two
    n8 tiles a 16-byte load, the quad's four loads contiguous: column c =
    8 j + 2 q + e at 16 (j // 2) + 4 q + 2 (j % 2) + e (csrc/fused_ray.cu
    ``Params::bias``)."""
    c = torch.arange(b.shape[0], device=b.device)
    j, q, e = c // 8, (c % 8) // 2, c % 2
    out = torch.empty_like(b)
    out[16 * (j // 2) + 4 * q + 2 * (j % 2) + e] = b
    return out


def pack_weights_k1(packed: PackedWeights) -> PackedK1:
    """``packed``'s matrices in K1's layout: the same bf16 values, so K1
    multiplies by the numbers the plain version and K2 use."""
    mats = packed.matrices()
    sf, Fw = packed.depth + 1, packed.F
    padded = []
    for i, m in enumerate(mats):
        n = m.shape[1]
        if i == sf:  # the feature block to its width, sigma's 8 columns after it
            m = torch.cat([F.pad(m[:, :Fw], (0, k1_width(Fw) - Fw)), m[:, Fw:]], 1)
        elif n > 8:  # rgb keeps its 8
            m = F.pad(m, (0, k1_width(n) - n))
        padded.append(m)
    biases = packed.biases()
    b = [biases[i] for i in range(packed.depth)] + [biases[packed.depth][:Fw],
                                                    biases[packed.depth + 1]]
    return PackedK1(w=torch.cat([_core_k_major(m) for m in padded]).contiguous(),
                    b=torch.cat([_fragment_order(x.float()) for x in b]).contiguous(),
                    w_off=_offsets(m.numel() for m in padded),
                    w_shape=tuple(tuple(m.shape) for m in padded),
                    shape=packed.w_shape, sf=sf, F=Fw)


def pack_weights(params, cfg: ModelConfig) -> PackedWeights:
    """Repack a ``NerfMLP`` into the kernel layout (bf16 weights, f32
    biases), its widths padded to multiples of 16 (``padded_widths``; the
    pads are zero). Inference only: the result carries no gradient."""
    if cfg.compat or not cfg.use_viewdirs or not cfg.include_input_in_enc:
        raise ValueError("the fused kernel covers the paper architecture")
    pos, P, dird, D = enc_dims(cfg)
    W, Fw = cfg.net_width, cfg.feature_width
    Wp, Fp, Vp = padded_widths(cfg)
    dev = params.sigma.w.device

    def padw(w, rows, cols):
        w = w.detach().float()
        return F.pad(w, (0, cols - w.shape[1], 0, rows - w.shape[0]))

    def padb(b, cols):
        return F.pad(b.detach().float(), (0, cols - b.shape[0]))

    mats, biases = [], []
    skip_w = torch.zeros(P, Wp, device=dev)
    for i, layer in enumerate(params.trunk):
        if i == 0:
            mats.append(padw(layer.w, P, Wp))
        elif i == cfg.skip_layer:
            mats.append(padw(layer.w[:W], Wp, Wp))
            skip_w = padw(layer.w[W:], P, Wp)
        else:
            mats.append(padw(layer.w, Wp, Wp))
        biases.append(padb(layer.b, Wp))
    sf_w = torch.cat([padw(params.feature.w, Wp, Fp),
                      padw(params.sigma.w, Wp, 8)], dim=1)
    sf_b = torch.cat([padb(params.feature.b, Fp), padb(params.sigma.b, 8)])
    vw = params.view1.w
    mats += [skip_w, sf_w, padw(vw[:Fw], Fp, Vp), padw(vw[Fw:], D, Vp),
             padw(params.rgb.w, Vp, 8)]
    biases += [sf_b, padb(params.view1.b, Vp), padb(params.rgb.b, 8)]
    return PackedWeights(
        w=torch.cat([_swizzle(m) for m in mats]).contiguous(),
        b=torch.cat(biases).contiguous(),
        w_off=_offsets(m.numel() for m in mats),
        w_shape=tuple(tuple(m.shape) for m in mats),
        b_off=_offsets(b.numel() for b in biases),
        depth=cfg.net_depth,
        skip_layer=cfg.skip_layer,
        W=Wp, F=Fp, V=Vp, P=P, D=D,
        pos_levels=cfg.pos_enc_levels,
        dir_levels=cfg.dir_enc_levels,
        widths=(W, Fw, cfg.view_head_width),
    )


def _offsets(sizes) -> Tuple[int, ...]:
    out, at = [], 0
    for s in sizes:
        out.append(at)
        at += s
    return tuple(out)


@dataclass(frozen=True)
class PackedWeightsT:
    """The transposed matrices the training kernel's backward multiplies
    by, in the same fragment layout (the counterpart of
    ``nerf_rs_tpu/kernels/fused_train.PackedWeightsT``)."""

    # flat bf16, swizzled, in kernel order: trunk[1..depth)^T (W, W),
    # feature part of [feature | sigma]^T (F, W), view (feature part)^T
    # (V, F), rgb^T (16, V) with rows 3.. zero (the k-step of 16)
    w: torch.Tensor
    w_off: Tuple[int, ...]
    w_shape: Tuple[Tuple[int, int], ...]
    sigma_row: torch.Tensor  # (padded W,) f32: the sigma head's bf16 column, 0 on the pads

    @functools.cached_property
    def offsets(self) -> torch.Tensor:
        """``w_off`` on the weights' device (``build.device_table``)."""
        return build.device_table(self.w_off, self.w.device, torch.int64)

    def matrices(self) -> List[torch.Tensor]:
        """The (K, N) bf16 matrices in kernel order, un-swizzled."""
        return [
            _unswizzle(self.w[o:o + k * n], k, n)
            for o, (k, n) in zip(self.w_off, self.w_shape)
        ]


def pack_weights_t(packed: PackedWeights) -> PackedWeightsT:
    """Transpose the packed matrices the backward needs (the counterpart
    of ``pack_weights_t`` in ``nerf_rs_tpu/kernels/fused_train.py``). The
    values are the packed bf16 weights, so forward and backward multiply
    by the same numbers."""
    mats = packed.matrices()
    L, Fw = packed.depth, packed.F
    rgb_t = mats[L + 4].t()  # (8, V)
    mats_t = [m.t() for m in mats[1:L]] + [
        mats[L + 1][:, :Fw].t(),
        mats[L + 2].t(),
        F.pad(rgb_t, (0, 0, 0, 16 - rgb_t.shape[0])),
    ]
    return PackedWeightsT(
        w=torch.cat([_swizzle(m) for m in mats_t]).contiguous(),
        w_off=_offsets(m.numel() for m in mats_t),
        w_shape=tuple(tuple(m.shape) for m in mats_t),
        sigma_row=mats[L + 1][:, Fw].float().contiguous(),
    )
