// Device code of the whole-ray kernels, K1 (fused_ray.cu) and K2
// (fused_train.cu): the field's description (Field, init_field,
// takes_samples, rays_per_cta), the encodings, the IPE moments, the
// contraction, smem_optin and set_smem, which every instance takes; and the
// mma.sync machinery (dense_layer, field_forward_wide) of the wide
// instances past the cluster route. The narrow instances run on wgmma (K1:
// fused_ray.cu with field_wgmma.cuh; K2: fused_train.cu's narrow section),
// the wide route on field_cluster.cuh.
//
// Rays per CTA. A CTA takes whole rays: 128 / S of them when S divides
// 128, two rays of S = 192 samples in three passes of 128 rows, or one ray
// of S = 256 or of any longer S, a multiple of 128, in S / 128 passes
// (field.S is what the wrappers pad S to, with zero-length intervals at the
// far end: a power of two up to 128, 192 for 129 to 192, 256 for 193 to
// 256, else the next multiple of 128; kernels/fused_ray.padded_samples). A
// pass may hold the end of one ray and the start of the next: every row
// finds its ray as (CTA row) / S.
//
// The mma.sync instances' products. 16 warps tile the 128 rows 4 ways (32
// rows each) and the output columns in chunks of 64. A operands come
// through ldmatrix; B operands (weights, pre-packed by
// kernels/fused_render._swizzle so each lane's fragment is 8 contiguous
// bytes) through a ring of k16 slices in shared memory that cp.async
// fills two slices ahead of the products: each slice leaves L2 once per
// CTA instead of once per row-group warp, and no warp waits on L2 for its
// fragments.
//
// Wide fields. Past kNarrowWidth (256) a warpgroup's sums and the act block
// no longer fit a CTA; the JAX kernels take any width. Such fields, and
// fields whose encodings no narrow layout holds beside its tiles, take the
// cluster route (field_cluster.cuh: wgmma, the activations spread over a
// cluster's shared memory) up to 2,048 wide and where its layout holds the
// encodings (fused_ray.cu k1_route, fused_train.cu train_mode). Past that
// the mma.sync wide instances (K1's fused_ray_wide_kernel, K2's
// train_wide_kernel) run field_forward_wide: every activation and encoding
// tile lies in device memory (K2: its stashes, which it writes anyway; K1:
// two buffers a CTA of a persistent grid), each product stages its A
// operand's k-slices into shared memory beside the weight slices, and the
// epilogues store to device memory. Shared memory stays ~60 KB at any
// width, so no field is refused; the products and their order are the
// narrow instances'.
//
// Numerics: no fast math. sinf/cosf with exact ldexpf scales for the PE
// (sin(2^9 x) loses its phase with a low-precision argument or sine);
// points are o + t*d with the multiply and add rounded separately, as the
// plain versions compute them. IPE: the conical-frustum moments
// (ipe_moments) round every operation on its own, in the plain version's
// order, and the damping exp(-4^l var / 2) is expf of an exact ldexpf
// scaling of the f32 variance (4^9 would swamp a bf16 one). Contraction
// (contract_points, contract_gaussian): IEEE divisions and __fsqrt_rn, each
// operation rounded on its own in ops/contract.py's order, no contraction
// of a product into a later sum.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace nerf {

typedef __nv_bfloat16 bf16;

constexpr int kRows = 128;                       // sample rows per CTA
constexpr int kThreads = 512;                    // 16 warps
constexpr int kWarps = kThreads / 32;
constexpr int kRowGroups = 4;                    // warps tile rows 4 ways ...
constexpr int kColGroups = kWarps / kRowGroups;  // ... and column chunks 4 ways
constexpr int kWarpRows = kRows / kRowGroups;    // 32 rows per warp
constexpr int kMT = kWarpRows / 16;              // m16 tiles per warp
constexpr int kChunk = 8;                        // n8 tiles per warp pass (64 columns)
constexpr int kLdr = 24;                         // row stride of K2's 16-wide rgb-gradient tile
constexpr int kMaxResident = 256;                // longest padded ray of K1's resident layouts
constexpr int kWStages = 3;                      // weight slices in the ring
constexpr int kRoundTiles = kColGroups * kChunk; // n8 tiles of a product per round: 32
constexpr int kWSlice = kRoundTiles * 32;        // uint2 per slice: 32 lanes a tile (8 KB)
constexpr int kRayStride = 10;                   // per ray in shared memory: o, d, viewdir, radius
constexpr int kParamOffs = 16;                   // leading offsets also in the parameters
// the widest layer the narrow instances take: K1's and K2's warpgroup sums
// (64 x 256 f32) and their act block of 128 x 256 bf16; wider fields take
// the wide instances (below)
constexpr int kNarrowWidth = 256;
constexpr int kALd = 24;                         // row stride of a staged A slice: 16 + 8 bf16
constexpr int kASlice = kRows * kALd;            // bf16 per staged A slice (6 KB)

// The field's inputs, packed weights and widths.
struct Field {
  const float* o;
  const float* d;
  const float* vd;
  const float* ts;
  const float* deltas;
  const float* radii;  // IPE: per-ray cone radius at unit distance; else null
  const bf16* w;
  const float* b;
  // in device memory, n_layers + 5 matrix offsets into w (trunk[0..n_layers),
  // skip, sf, view, view_dir, rgb), then n_layers + 3 bias offsets into b
  // (trunk[0..n_layers), sf, view, rgb): sized by the depth, so no depth is
  // too deep for the launch parameters (w_off, b_off read them)
  const long long* off;
  // the first kParamOffs matrix and bias offsets again (every one to depth
  // 11), read from the parameters' constant bank: a table load in the
  // weight stream's path cost K1's chunk ~0.3% and K2's multi-pass
  // instances spills on an H100
  long long w_head[kParamOffs], b_head[kParamOffs];
  long long n_rays;
  int S, n_layers, skip, W, F, V, P, D, pos_levels, dir_levels, sigma_act, ipe;
  int R;     // whole rays per CTA
  int rows;  // sample rows per CTA, R * S: 128, 384 (S = 192), or S (S = 256 and longer)
  int ldb, ldx, ldd;  // shared-memory row strides in bf16 elements
};

// The padded sample counts the kernels take: a divisor of 128, 192, or a
// multiple of 128.
inline bool takes_samples(int S) {
  return S > 0 && (S <= kRows ? kRows % S == 0 : (S == 192 || S % kRows == 0));
}

// Whole rays per CTA for a padded S: 128 / S, 2 at S = 192, else 1. Every
// CTA's rows, R * S, are whole 128-row passes.
inline int rays_per_cta(int S) { return S <= kRows ? kRows / S : (S == 192 ? 2 : 1); }

// Matrix i's and bias i's offsets: from the parameters for the first
// kParamOffs, else from the device table through the read-only path.
__device__ __forceinline__ long long w_off(const Field& f, int i) {
  return i < kParamOffs ? f.w_head[i] : __ldg(f.off + i);
}
__device__ __forceinline__ long long b_off(const Field& f, int i) {
  return i < kParamOffs ? f.b_head[i] : __ldg(f.off + f.n_layers + 5 + i);
}

__host__ __device__ inline int widest(const Field& f) {
  const int a = f.W > f.F ? f.W : f.F;
  return a > f.V ? a : f.V;
}

// The members of f that size its shared memory, from the padded S and the
// widths (init_field sets them so too).
inline void set_layout(Field* f, int S, int W, int F, int V, int P, int D) {
  f->S = S;
  f->W = W;
  f->F = F;
  f->V = V;
  f->P = P;
  f->D = D;
  f->R = rays_per_cta(S);
  f->rows = f->R * S;
  int widest = W > F ? W : F;
  widest = widest > V ? widest : V;
  f->ldb = widest + 8;  // +8 bf16 per row: conflict-free ldmatrix
  f->ldx = P + 8;
  f->ldd = D + 8;
}

// Fills f from the C entry point's arguments; `offsets` is the device
// table of the n_w matrix and n_b bias offsets (Field::off), w_off and
// b_off the same offsets in host memory. Returns 0 or a negative code for
// a shape the kernels do not take (kernels/fused_ray.py maps the codes to
// messages).
inline int init_field(Field* f, const void* o, const void* d, const void* vd, const void* ts,
                      const void* deltas, const void* radii, const void* w, const void* b,
                      const void* offsets, const long long* w_off, int n_w,
                      const long long* b_off, int n_b, long long n_rays, int S, int depth_l,
                      int skip, int W, int F, int V, int P, int D, int pos_levels,
                      int dir_levels, int sigma_act, int ipe) {
  if (!takes_samples(S)) return -1;
  if (n_w != depth_l + 5 || n_b != depth_l + 3 || depth_l < 1 || offsets == nullptr) return -2;
  if (W % 16 || F % 16 || V % 16 || P % 16 || D % 16) return -3;
  if (3 + 6 * pos_levels > P || 3 + 6 * dir_levels > D) return -4;
  if (sigma_act != 0 && sigma_act != 1) return -6;
  if ((ipe != 0 && ipe != 1) || (ipe == 1) != (radii != nullptr)) return -7;
  f->o = static_cast<const float*>(o);
  f->d = static_cast<const float*>(d);
  f->vd = static_cast<const float*>(vd);
  f->ts = static_cast<const float*>(ts);
  f->deltas = static_cast<const float*>(deltas);
  f->radii = static_cast<const float*>(radii);
  f->w = static_cast<const bf16*>(w);
  f->b = static_cast<const float*>(b);
  f->off = static_cast<const long long*>(offsets);
  for (int i = 0; i < kParamOffs; ++i) {
    f->w_head[i] = i < n_w ? w_off[i] : 0;
    f->b_head[i] = i < n_b ? b_off[i] : 0;
  }
  f->n_rays = n_rays;
  f->n_layers = depth_l;
  f->skip = skip;
  f->pos_levels = pos_levels;
  f->dir_levels = dir_levels;
  f->sigma_act = sigma_act;
  f->ipe = ipe;
  set_layout(f, S, W, F, V, P, D);
  return 0;
}

__host__ __device__ inline size_t take(size_t* at, size_t bytes) {
  const size_t here = *at;
  *at += (bytes + 15) & ~static_cast<size_t>(15);
  return here;
}

// The CTA's shared-memory regions.
struct Tile {
  bf16* buf0;
  bf16* buf1;
  bf16* xs;      // PE(points), bf16, row stride ldx
  bf16* ds;      // PE(viewdir) per row, bf16, row stride ldd
  float* mv;     // per pass row: the point (or the Gaussian's mean), then its variance
  float* sig_raw;
  float* rgb;    // 4 floats per row
  float* ts;
  float* dl;
  float* w;
  float* sg;
  float* ray;    // per ray: o, d, viewdir, radius (kRayStride floats)
  float* dpe;    // per ray: PE(viewdir), f32
  bf16* drgb;    // K2: d rgb_raw, 16 columns, row stride kLdr
  float* dsig;   // K2: d sigma_raw rounded to bf16
  uint2* wring;  // kWStages k16 slices of a product's packed weights
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// PE column c of the scalar x: c < 3 is the raw value; otherwise with
// r = c - 3 the level is r / 6 and the column sin (r % 6 < 3) or cos of
// 2^level * x -- the layout of models/encoding.posenc.
__device__ __forceinline__ float pe_value(float x, int c) {
  if (c < 3) return x;
  const int r = c - 3;
  const float t = ldexpf(x, r / 6);
  return (r % 6 < 3) ? sinf(t) : cosf(t);
}

// IPE column c of the Gaussian (mean, var) of one coordinate: c < 3 is the
// mean; otherwise sin or cos of 2^level * mean, as pe_value, damped by
// exp(-4^level var / 2) -- kernels/fused_render.ipe_encode.
__device__ __forceinline__ float ipe_value(float mean, float var, int c) {
  if (c < 3) return mean;
  const int r = c - 3, level = r / 6;
  const float t = ldexpf(mean, level);
  const float s = (r % 6 < 3) ? sinf(t) : cosf(t);
  return __fmul_rn(s, expf(-ldexpf(var, 2 * level - 1)));
}

// The conical frustum [mu - delta / 2, mu + delta / 2] of a ray (o, d) with
// cone radius `radius` as a Gaussian: mean into mv[0:3], diagonal variance
// into mv[3:6] (ops/sampling.conical_gaussians' stable closed forms, the
// order of kernels/fused_render.ipe_expand, every operation rounded).
__device__ inline void ipe_moments(const float* o, const float* d, float mu, float delta,
                                   float radius, float* mv) {
  const float hw = __fmul_rn(0.5f, delta);
  const float mu2 = __fmul_rn(mu, mu), hw2 = __fmul_rn(hw, hw);
  const float denom = __fadd_rn(__fmul_rn(3.f, mu2), hw2);
  const float t_mean = __fadd_rn(mu, __fdiv_rn(__fmul_rn(__fmul_rn(2.f, mu), hw2), denom));
  const float hw4 = __fmul_rn(hw2, hw2);
  const float t_var = __fsub_rn(
      __fdiv_rn(hw2, 3.f),
      __fmul_rn(4.f / 15.f, __fdiv_rn(__fmul_rn(hw4, __fsub_rn(__fmul_rn(12.f, mu2), hw2)),
                                      __fmul_rn(denom, denom))));
  const float r_var = __fmul_rn(
      __fmul_rn(radius, radius),
      __fsub_rn(__fadd_rn(__fdiv_rn(mu2, 4.f), __fmul_rn(5.f / 12.f, hw2)),
                __fdiv_rn(__fmul_rn(__fmul_rn(4.f / 15.f, hw2), hw2), denom)));
  float d2[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) d2[k] = __fmul_rn(d[k], d[k]);
  const float dn2 = fmaxf(__fadd_rn(__fadd_rn(d2[0], d2[1]), d2[2]), 1e-10f);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    mv[k] = __fadd_rn(o[k], __fmul_rn(t_mean, d[k]));
    mv[3 + k] = __fadd_rn(__fmul_rn(t_var, d2[k]),
                          __fmul_rn(r_var, __fsub_rn(1.f, __fdiv_rn(d2[k], dn2))));
  }
}

// mip-NeRF 360's contraction of one point (ops/contract.contract; the JAX
// package's _contract_points), in place: x where ||x|| <= 1, else
// (2 - 1/||x||) x / ||x||. Positions carry no gradient, so there is no
// backward. eps^2 = 1e-16 clamps the norm under the sqrt, as the JAX code.
__device__ inline void contract_points(float* x) {
  const float r2 =
      __fadd_rn(__fadd_rn(__fmul_rn(x[0], x[0]), __fmul_rn(x[1], x[1])), __fmul_rn(x[2], x[2]));
  const float r = __fsqrt_rn(fmaxf(r2, 1e-16f));
  if (r <= 1.f) return;
  const float g = __fsub_rn(2.f, __fdiv_rn(1.f, r));  // r > 1: max(r, 1) = r
#pragma unroll
  for (int k = 0; k < 3; ++k) x[k] = __fdiv_rn(__fmul_rn(g, x[k]), r);
}

// The contraction of a diagonal Gaussian, mean mv[0:3] and variance mv[3:6]
// in place, by its closed-form linearisation (ops/contract.contract_gaussian;
// the JAX package's _contract_gaussian), term for term: with
// g = 2/r - 1/r^2 and gp = (-2/r^2 + 2/r^3) / r,
//   var_k = max(g^2 s_k + 2 g gp x_k^2 s_k + gp^2 x_k^2 sum_j x_j^2 s_j, 0).
__device__ inline void contract_gaussian(float* mv) {
  float x2[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) x2[k] = __fmul_rn(mv[k], mv[k]);
  const float r = __fsqrt_rn(fmaxf(__fadd_rn(__fadd_rn(x2[0], x2[1]), x2[2]), 1e-16f));
  if (r <= 1.f) return;
  const float s2 = __fmul_rn(r, r);
  const float g = __fsub_rn(__fdiv_rn(2.f, r), __fdiv_rn(1.f, s2));
  const float gp = __fdiv_rn(__fadd_rn(__fdiv_rn(-2.f, s2), __fdiv_rn(2.f, __fmul_rn(r, s2))), r);
  const float quad = __fadd_rn(__fadd_rn(__fmul_rn(x2[0], mv[3]), __fmul_rn(x2[1], mv[4])),
                               __fmul_rn(x2[2], mv[5]));
  const float gg = __fmul_rn(g, g), g2gp = __fmul_rn(__fmul_rn(2.f, g), gp), gpgp = __fmul_rn(gp, gp);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float s = mv[3 + k];
    const float v = __fadd_rn(__fadd_rn(__fmul_rn(gg, s), __fmul_rn(__fmul_rn(g2gp, x2[k]), s)),
                              __fmul_rn(__fmul_rn(gpgp, x2[k]), quad));
    mv[k] = __fmul_rn(g, mv[k]);
    mv[3 + k] = fmaxf(v, 0.f);
  }
}

// 16 bytes from global to shared memory, in flight until a wait_group;
// zeros (and no read) when !ok
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

typedef float Acc[kMT][kChunk][4];

// out = epi(A1 @ W1 [+ A2 @ W2]) for the CTA's 128 rows and N columns.
// The columns go in rounds of up to kRoundTiles n8 tiles (one chunk of 64
// per column-group warp; N = F + 8 takes a second round for the sigma
// tile). A round walks the k-steps of A1, then of A2: slice k (the round's
// tiles at that k-step, 256 B each) is copied into ring slot k % kWStages
// kWStages - 1 steps ahead; one barrier per k-step says the slice has
// landed for every thread and that the slot the next copy refills has
// been read by all. Callers put a barrier between products, so a
// product's first copies never overwrite a slot another warp still reads.
// kStageA (the wide instances): A1 and A2 lie in device memory, row-major,
// and each k-step's 128 x 16 slice of them rides beside its weights in
// `aring` (kWStages slices of kASlice, row stride kALd), so the A operand
// of any width costs 6 KB of shared memory; a round re-reads A from L2.
template <class Epi, bool kStageA = false>
__device__ __forceinline__ void dense_layer(const bf16* A1, int lda1, int K1, const uint2* W1,
                                            const bf16* A2, int lda2, int K2, const uint2* W2,
                                            int N, uint2* ring, const Epi& epi,
                                            bf16* aring = nullptr) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = (warp % kRowGroups) * kWarpRows;
  const int g = lane >> 2, t = lane & 3;
  const int NT = N / 8;
  const int KT1 = K1 / 16, KT2 = A2 != nullptr ? K2 / 16 : 0, KT = KT1 + KT2;
  const int nt_w = (warp / kRowGroups) * kChunk;  // the warp's first tile in a round
  // ldmatrix x4 row addresses: lanes 0-15 rows 0-15 at k, lanes 16-31 rows 0-15 at k + 8
  const bf16* a1 = A1 + (row0 + (lane & 15)) * lda1 + (lane >> 4) * 8;
  const bf16* a2 = A2 != nullptr ? A2 + (row0 + (lane & 15)) * lda2 + (lane >> 4) * 8 : nullptr;
  for (int base = 0; base < NT; base += kRoundTiles) {
    const int tiles = min(kRoundTiles, NT - base);
    const int nts = min(kChunk, tiles - nt_w);  // <= 0: no columns for this warp this round
    auto fill = [&](int k) {
      uint2* slot = ring + (k % kWStages) * kWSlice;
      const bool first = k < KT1;
      const uint2* Wm = first ? W1 : W2;
      const int ktn = first ? KT1 : KT2, kt = first ? k : k - KT1;
      for (int i = threadIdx.x; i < tiles * 16; i += kThreads) {  // 16 B pieces, 16 a tile
        const int nt = i >> 4, q = (i & 15) * 2;
        cp_async16(slot + nt * 32 + q,
                   Wm + (static_cast<size_t>(base + nt) * ktn + kt) * 32 + q, true);
      }
      if constexpr (kStageA) {  // the k-step's 128 rows x 16 columns of A, two pieces a row
        const bf16* src = (first ? A1 : A2) + kt * 16;
        const int lda = first ? lda1 : lda2;
        bf16* dst = aring + (k % kWStages) * kASlice;
        for (int i = threadIdx.x; i < kRows * 2; i += kThreads) {
          const int r = i >> 1, h = (i & 1) * 8;
          cp_async16(dst + r * kALd + h, src + static_cast<long long>(r) * lda + h, true);
        }
      }
    };
    if (base > 0) __syncthreads();  // the last round's slots are free
#pragma unroll
    for (int s = 0; s < kWStages - 1; ++s) {
      if (s < KT) fill(s);
      cp_async_commit();
    }
    Acc acc;
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int j = 0; j < kChunk; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;
    for (int k = 0; k < KT; ++k) {
      cp_async_wait<kWStages - 2>();
      __syncthreads();
      if (k + kWStages - 1 < KT) fill(k + kWStages - 1);
      cp_async_commit();
      if (nts > 0) {
        const bool first = k < KT1;
        const bf16* ap = first ? a1 + k * 16 : a2 + (k - KT1) * 16;
        int lda = first ? lda1 : lda2;
        if constexpr (kStageA) {
          ap = aring + (k % kWStages) * kASlice + (row0 + (lane & 15)) * kALd + (lane >> 4) * 8;
          lda = kALd;
        }
        const uint2* slot = ring + (k % kWStages) * kWSlice + nt_w * 32 + lane;
        uint32_t a[kMT][4];
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) ldmatrix_x4(a[mt], ap + mt * 16 * lda);
#pragma unroll
        for (int j = 0; j < kChunk; ++j) {
          if (j < nts) {
            const uint2 bw = slot[j * 32];
#pragma unroll
            for (int mt = 0; mt < kMT; ++mt) mma_16816(acc[mt][j], a[mt], bw.x, bw.y);
          }
        }
      }
    }
    // accumulator fragment: c0, c1 at (row g, cols 2t, 2t + 1); c2, c3 at row g + 8
    if (nts > 0) {
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int j = 0; j < kChunk; ++j) {
          if (j < nts) {
            const int col = (base + nt_w + j) * 8 + 2 * t;
            const int row = row0 + mt * 16 + g;
            epi(row, col, acc[mt][j][0], acc[mt][j][1]);
            epi(row + 8, col, acc[mt][j][2], acc[mt][j][3]);
          }
        }
    }
  }
}

__device__ __forceinline__ void store_pair(bf16* p, __nv_bfloat162 v) {
  *reinterpret_cast<__nv_bfloat162*>(p) = v;
}

// hidden layer: bf16(relu(acc + b)) into an activation buffer
struct ReluStore {
  bf16* out;
  int ldo;
  const float* b;
  __device__ void operator()(int r, int c, float v0, float v1) const {
    v0 = fmaxf(v0 + b[c], 0.f);
    v1 = fmaxf(v1 + b[c + 1], 0.f);
    store_pair(out + r * ldo + c, __floats2bfloat162_rn(v0, v1));
  }
};

// [feature | sigma] head: bf16 feature (no activation), f32 raw sigma at
// column F
struct FeatSigmaStore {
  bf16* feat;
  int ldo;
  const float* b;
  float* sig_raw;
  int F;
  __device__ void operator()(int r, int c, float v0, float v1) const {
    if (c < F) {
      store_pair(feat + r * ldo + c, __floats2bfloat162_rn(v0 + b[c], v1 + b[c + 1]));
    } else if (c == F) {
      sig_raw[r] = v0 + b[c];
    }
  }
};

// rgb head: sigmoid in f32, three real columns of the 8
struct RgbStore {
  float* rgb;
  const float* b;
  __device__ void operator()(int r, int c, float v0, float v1) const {
    if (c < 3) rgb[r * 4 + c] = 1.f / (1.f + expf(-(v0 + b[c])));
    if (c + 1 < 3) rgb[r * 4 + c + 1] = 1.f / (1.f + expf(-(v1 + b[c + 1])));
  }
};

// The mma.sync wide instances' relu masks (value > 0) of the pass's 128
// rows of a tile, `cols` columns, as bits: word w of row r holds columns 32
// w .. 32 w + 31, bit j column 32 w + j; one __ballot_sync per word, lane w
// % 32 keeping word w and each 32 words of a row leaving in one coalesced
// store.
__device__ __forceinline__ void relu_bits_wide(uint32_t* mask, int mw, const bf16* src, int lds,
                                               int cols) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < kRows; r += kWarps) {
    for (int w0 = 0; w0 < mw; w0 += 32) {
      const int nw = mw - w0 < 32 ? mw - w0 : 32;
      uint32_t mine = 0;
      for (int w = 0; w < nw; ++w) {
        const int c = (w0 + w) * 32 + lane;
        const bool on = c < cols && __bfloat162float(src[r * lds + c]) > 0.f;
        const uint32_t word = __ballot_sync(0xffffffffu, on);
        if (lane == w) mine = word;
      }
      if (lane < nw) mask[static_cast<long long>(r) * mw + w0 + lane] = mine;
    }
  }
}

// Where the wide forward leaves each product's bf16 output for the pass's
// 128 rows, row-major at the output's own width from the pass's first row:
// the encodings x (P) and dv (D), trunk layer l at h + (l % h_cycle) *
// h_stride (W), feat (F) and hv (V); with mask, the relu bits (mw words a
// row, layer l at mask + l * mask_stride, hv at layer n_layers), as K2b reads
// them. K2's are its stashes (h_cycle = depth); K1's a CTA's two
// activation buffers in device memory (h_cycle = 2, feat and hv in the one
// the last trunk layer did not write, then in the one it did).
struct WideOut {
  bf16* x;
  bf16* dv;
  bf16* h;
  long long h_stride;
  int h_cycle;
  bf16* feat;
  bf16* hv;
  uint32_t* mask;  // or null
  long long mask_stride;
  int mw;
};

// The wide instances' shared memory: the per-row moments, the per-ray
// inputs and PE(viewdir), K2's one-pass rgb-gradient tile, the weight ring
// and the staged A slices (dense_layer's kStageA) -- ~60 KB at any width.
// Every activation and encoding tile lies in device memory (WideOut), and
// so do the per-sample values (ts, deltas, raw sigma, rgb; K2's scratch).
struct WideSmem {
  size_t mv, ray, dpe, drgb, wring, aring, total;
};

__host__ __device__ inline WideSmem wide_layout(const Field& f) {
  WideSmem L;
  size_t at = 0;
  L.mv = take(&at, sizeof(float) * kRows * 6);
  L.ray = take(&at, sizeof(float) * f.R * kRayStride);
  L.dpe = take(&at, sizeof(float) * f.R * f.D);
  L.drgb = take(&at, sizeof(bf16) * kRows * kLdr);
  L.wring = take(&at, sizeof(uint2) * kWStages * kWSlice);
  L.aring = take(&at, sizeof(bf16) * kWStages * kASlice);
  L.total = at;
  return L;
}

// The wide instances' Tile: its shared-memory regions; the per-sample
// pointers are the caller's to set, the activation tiles stay null.
__device__ inline Tile carve_wide(unsigned char* smem, const WideSmem& L) {
  Tile t = {};
  t.mv = reinterpret_cast<float*>(smem + L.mv);
  t.ray = reinterpret_cast<float*>(smem + L.ray);
  t.dpe = reinterpret_cast<float*>(smem + L.dpe);
  t.drgb = reinterpret_cast<bf16*>(smem + L.drgb);
  t.wring = reinterpret_cast<uint2*>(smem + L.wring);
  return t;
}

// The field on one 128-row pass for the mma.sync wide instances (fields
// wider than the cluster route takes): the inputs, moments, encodings and
// products in the paper field's order, with every product's A staged from
// device memory (dense_layer's kStageA, ring `aring`) and its epilogue
// writing to device memory (WideOut), so no tile grows with the width. A layer's output goes to another buffer than its
// input and the barrier after each product orders the two; the stores
// reach the next product's cp.async reads through L2.
template <bool kContract>
__device__ inline void field_forward_wide(const Field& p, const Tile& t, bf16* aring,
                                          long long ray0, int n_valid, int s0, const WideOut& o) {
  const int S = p.S;
  const int tid = threadIdx.x;

  // ---- inputs; zeros past the last ray ----
  for (int i = tid; i < p.R * kRayStride; i += kThreads) {
    const int j = i / kRayStride, k = i % kRayStride;
    float v = 0.f;
    if (j < n_valid) {
      if (k < 9) {
        const float* src = k < 3 ? p.o : (k < 6 ? p.d : p.vd);
        v = src[(ray0 + j) * 3 + k % 3];
      } else if (p.ipe) {
        v = p.radii[ray0 + j];
      }
    }
    t.ray[i] = v;
  }
  for (int r = tid; r < kRows; r += kThreads) {
    const int cr = s0 + r;
    const bool ok = cr / S < n_valid;
    t.ts[cr] = ok ? p.ts[ray0 * S + cr] : 0.f;
    t.dl[cr] = ok ? p.deltas[ray0 * S + cr] : 0.f;
  }
  __syncthreads();

  // ---- per row: the point o + t d, or (IPE) the frustum's mean and variance ----
  for (int r = tid; r < kRows; r += kThreads) {
    const int cr = s0 + r;
    const float* ray = t.ray + (cr / S) * kRayStride;
    float* mv = t.mv + r * 6;
    if (p.ipe && cr / S < n_valid) {
      ipe_moments(ray, ray + 3, t.ts[cr], t.dl[cr], ray[9], mv);
    } else {
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        mv[k] = __fadd_rn(ray[k], __fmul_rn(t.ts[cr], ray[3 + k]));
        mv[3 + k] = 0.f;
      }
    }
    if (kContract) {
      if (p.ipe)
        contract_gaussian(mv);
      else
        contract_points(mv);
    }
  }
  __syncthreads();

  // ---- encodings: PE or IPE per row, PE(viewdir) once per ray ----
  const int pos_dim = 3 + 6 * p.pos_levels;
  for (int i = tid; i < kRows * p.P; i += kThreads) {
    const int r = i / p.P, c = i % p.P;
    float v = 0.f;
    if (c < pos_dim) {
      const float* mv = t.mv + r * 6;
      const int dim = c < 3 ? c : (c - 3) % 3;
      v = p.ipe ? ipe_value(mv[dim], mv[3 + dim], c) : pe_value(mv[dim], c);
    }
    o.x[i] = __float2bfloat16_rn(v);
  }
  const int dir_dim = 3 + 6 * p.dir_levels;
  for (int i = tid; i < p.R * p.D; i += kThreads) {
    const int j = i / p.D, c = i % p.D;
    float v = 0.f;
    if (c < dir_dim) v = pe_value(t.ray[j * kRayStride + 6 + (c < 3 ? c : (c - 3) % 3)], c);
    t.dpe[i] = v;
  }
  __syncthreads();
  for (int i = tid; i < kRows * p.D; i += kThreads) {
    const int r = i / p.D, c = i % p.D;
    o.dv[i] = __float2bfloat16_rn(t.dpe[((s0 + r) / S) * p.D + c]);
  }
  __syncthreads();

  // ---- trunk ----
  const uint2* skip_w = reinterpret_cast<const uint2*>(p.w + w_off(p, p.n_layers));
  const bf16* h = o.x;
  int ldh = p.P;
  for (int i = 0; i < p.n_layers; ++i) {
    bf16* out = o.h + (i % o.h_cycle) * o.h_stride;
    const bool skip = i == p.skip && i > 0;
    dense_layer<ReluStore, true>(h, ldh, ldh, reinterpret_cast<const uint2*>(p.w + w_off(p, i)),
                                 skip ? o.x : nullptr, p.P, p.P, skip_w, p.W, t.wring,
                                 ReluStore{out, p.W, p.b + b_off(p, i)}, aring);
    __syncthreads();
    if (o.mask != nullptr) relu_bits_wide(o.mask + i * o.mask_stride, o.mw, out, p.W, p.W);
    h = out;
    ldh = p.W;
  }
  const int m = p.n_layers;

  // ---- heads ----
  dense_layer<FeatSigmaStore, true>(h, p.W, p.W,
                                    reinterpret_cast<const uint2*>(p.w + w_off(p, m + 1)),
                                    nullptr, 0, 0, nullptr, p.F + 8, t.wring,
                                    FeatSigmaStore{o.feat, p.F, p.b + b_off(p, m),
                                                   t.sig_raw + s0, p.F}, aring);
  __syncthreads();
  dense_layer<ReluStore, true>(o.feat, p.F, p.F,
                               reinterpret_cast<const uint2*>(p.w + w_off(p, m + 2)), o.dv, p.D,
                               p.D, reinterpret_cast<const uint2*>(p.w + w_off(p, m + 3)), p.V,
                               t.wring, ReluStore{o.hv, p.V, p.b + b_off(p, m + 1)}, aring);
  __syncthreads();
  if (o.mask != nullptr) relu_bits_wide(o.mask + m * o.mask_stride, o.mw, o.hv, p.V, p.V);
  dense_layer<RgbStore, true>(o.hv, p.V, p.V, reinterpret_cast<const uint2*>(p.w + w_off(p, m + 4)),
                              nullptr, 0, 0, nullptr, 8, t.wring,
                              RgbStore{t.rgb + s0 * 4, p.b + b_off(p, m + 2)}, aring);
  __syncthreads();
}

// The card's per-block opt-in maximum of shared memory, into *bytes,
// queried once a device and process (a launch reads it up to four times);
// returns 0 or a cudaError_t.
inline int smem_optin(size_t* bytes) {
  constexpr int kDevices = 64;
  static std::atomic<int> known[kDevices];  // 0: not asked yet
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  int optin = dev < kDevices ? known[dev].load(std::memory_order_relaxed) : 0;
  if (optin == 0) {
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < kDevices) known[dev].store(optin, std::memory_order_relaxed);
  }
  *bytes = static_cast<size_t>(optin);
  return 0;
}

// Sets the kernel's dynamic shared memory to `bytes`, or returns -5 when
// the card's per-block opt-in maximum is smaller.
template <class Kernel>
inline int set_smem(Kernel kernel, size_t bytes) {
  size_t optin = 0;
  int rc = smem_optin(&optin);
  if (rc != 0) return rc;
  if (bytes > optin) return -5;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}

}  // namespace nerf
