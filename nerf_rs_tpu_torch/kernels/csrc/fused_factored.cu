// Factored-encode kernel for Hopper (sm_90a), K3: forward and backward.
//
// Replaces nerf_rs_tpu/kernels/fused_factored.py::_fwd_kernel (:58) and
// ::_bwd_kernel (:73), the Pallas TPU kernels of the factored field's
// encode (models/factored.py). Per point p and axis a, with
// u = clip((p + aabb) / (2 aabb), 0, 1) and for every level l of
// resolution R_l the hat weights w = relu(1 - |u R_l - knot|):
//   forward   enc[n, c] = X[n, c] Y[n, c] Z[n, c],
//             X[n, c] = sum_j W_x[n, j] lines[0][j, c] (and Y, Z alike);
//   backward  d_lines[a] = W_a^T d_feat_a, d_feat_a = (g * f_b) * f_c,
//             with no gradient for the points.
//
// The work is sparse. A hat row has at most two non-zeros per level (the
// knots k0 = floor(u R) and k0 + 1), so an axis needs 2L taps: 12 row reads
// of C values at the default 6 levels, not the dense 1,014-deep product the
// TPU ran because it cannot gather. So neither the dense hat matrix, nor
// the TPU's 128-padded knot columns, nor its VMEM tiling is carried over.
//
// What bounds it on this card. Per point the forward reads 12 B of
// coordinates and writes 4C B of encoding (192 B at C = 48) against ~72C
// FLOP of taps and sums: by the card's peaks it is bound by bytes, the
// encoding's write. The backward reads the points and g and writes the
// (3, sumR, C) gradient against ~150C FLOP per point (the three features
// again, d_feat, the scatter of w d_feat): bound by operations at the f32
// rate. What limited the first, simple kernels was neither: each point
// gathered 6L rows of C values from the line tables in L2 (3.5 KB at the
// defaults, 17x its device-memory bytes), and the first backward did so
// twice per axis, then walked a shared-memory table with one thread per
// (level, channel) while the CTA's other threads waited.
//
// Forward design. Persistent CTAs of 1024 threads, as many as the card
// holds at once. Each CTA first copies into shared memory the line-table
// levels that fit, in the call's dtype, from level 0 (the coarsest for every
// preset: the ladder rises) for all three axes: the rows [0, off[s]) of each
// axis, the split s computed on the host from the geometry and the 227 KB a
// CTA can have beside two buffers of taps (staged_levels; at the defaults
// levels 0-4 under bf16, 144 KB, and 0-3 under f32, 140 KB). The rest
// (level 5's 513 knots at the defaults) is read from L2; a geometry where no
// level fits reads every level from L2 in the same kernel. Then the CTA
// walks tiles of P points: their taps (knot row, two weights per point,
// axis and level) go into one of two shared buffers, one barrier a tile,
// and each thread takes one point and a group of V channels (V = 8 where C
// allows: one 16 B load per tap row under bf16, two under f32, and 32 B of
// encoding stored). It issues the L2 loads of the first unstaged level of
// all three axes before it sums the staged levels from shared memory, two
// levels' loads at a time, so those loads are in flight meanwhile; later
// unstaged levels go out kBatch at a time. bf16 values stay packed until
// they are used. Per channel the additions are the first kernel's, in the
// same level order, so the encoding keeps its bits (under bf16 a product of
// two bf16 values is exact in f32, so a fused multiply-add rounds as the
// separate product and sum did).
//
// Backward design: three launches, no float atomics (reruns give the same
// bits; at level 0 the whole batch lands on the 17 knots of each axis).
// 1. factored_dfeat_kernel, the forward's walk with another epilogue:
//    each point's three features once, then d_feat_a = (g * f_b) * f_c for
//    a = 0, 1, 2 (the JAX kernel's order), rounded to bf16 under bf16, into
//    a scratch of (3, N, stride): bf16 with C padded by zero columns to the
//    scatter's channel tiles, or f32 with stride C.
// 2. bf16 lines: factored_scatter_mma_kernel, d_lines[a] = W_a^T D_a on the
//    tensor cores (mma.sync m16n8k16, bf16 in, f32 sums). M is the axis's
//    knot rows in 16-row blocks, N the channels in 8-wide tiles, K the
//    points, 16 a step. W is never in memory: each lane builds its A
//    fragment from the step's taps (element (row r, point p) is w0 when r
//    is p's tap row at r's level, w1 at that row + 1, else 0; one prmt per
//    pair of points). The work is sparse: a block is skipped in a step
//    whose band (the span of its 16 points' tap rows at a level of the
//    block) misses the block's rows, which drops only all-zero products.
//    On the main path the points come a ray at a time, so a step's band is
//    narrow at every level. (An exact test, a ballot over each step's taps
//    per block, skips more blocks of shuffled points but costs more than it
//    saves on both orders: on an H100, 0.72 against 0.45 ms at 524,288
//    ray-ordered points.)
//    A CTA is (point range, row slab, channel group, axis): 16 warps, each
//    owning two blocks of the slab (interleaved across slabs, so the coarse
//    blocks, reached in every step, spread over the CTAs) for the group's
//    channels, its sums in registers. The tensor cores do not round each
//    addition to nearest, so once a tile of 256 points (16 steps) the warp
//    adds its sums into an f32 table in shared memory with IEEE adds and
//    starts again from zero: two levels of sums, the inner one short. One
//    barrier a tile: the next tile's d_feat comes in by cp.async (rows
//    padded to an odd count of 16 B, so ldmatrix's 8 rows hit 8 different
//    bank groups) and its coordinates into registers while this tile is
//    summed; then its taps and bands are made.
//    A CTA keeps the taps and bands of every level it walks (4,352 B a
//    level beside its channel tiles, mma_smem_bytes): where those of all L
//    levels do not fit beside the group's tiles (20 levels at 6 tiles, or
//    past 47 at one), the levels go in runs of the most that fit
//    (level_run), one launch a run on the run's rows of the table.
//    f32 lines (no preset): factored_scatter_walk_kernel keeps the first
//    kernel's walk on the CUDA cores, reading kernel 1's d_feat: a CTA
//    holds a tile of one axis's (sumR, C) table in shared memory, the rows
//    of a run of whole levels and a run of columns (WalkTiles: one tile
//    where the table fits, as at the presets' widths), and each thread
//    owns (level, channel) columns of the tile, adding the chunk's points
//    to their rows in order. A level whose knots of one channel do not fit
//    a CTA (past ~57,800 knots) is cut into runs of rows, and a tap outside
//    the run's rows is dropped there (the run that holds it adds it).
// 3. factored_reduce_kernel sums each entry's partial tables (one per point
//    range) in range order.
//
// Numerics, as the JAX kernel's. u, u R, and the weights are computed op by
// op with round-to-nearest intrinsics (an IEEE division, no contraction of
// u R into a later subtraction), so the weights are those of the JAX
// formula bit for bit. A point clipped to u = 1 gives u R = R: k0 is
// clamped to R - 1, so the taps are (R - 1, weight 0) and (R, weight 1) and
// no read passes the level's last knot. Under bf16 the weights and the
// lines (cast by the wrapper) are bf16, each product is exact in f32, and
// the sums are f32; d_feat is rounded to bf16 as the JAX kernel rounds it.

#include <algorithm>
#include <vector>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "field.cuh"  // nerf::mma_16816, ldmatrix_x4_trans, cp_async16, smem_addr

namespace {

constexpr int kFwdThreads = 1024;
constexpr int kFwdTapBytes = 81920;  // two buffers of a forward tile's taps, at most
constexpr int kBatch = 4;            // levels whose line loads are in flight together
constexpr size_t kMaxSmem = 232448;  // what one CTA can have on sm_90
// the tensor-core scatter (bf16 lines)
constexpr int kMmaWarps = 16;     // warps of a CTA
constexpr int kMmaBlocks = 2;     // 16-row blocks a warp owns
constexpr int kMmaMaxTiles = 6;   // 8-channel tiles of a CTA: 48 channels, 48 sums a thread
constexpr int kTilePoints = 256;  // points a tile: 16 steps of 16, one flush of the sums
constexpr int kSteps = kTilePoints / 16;
static_assert(kMmaWarps * 32 % kTilePoints == 0 && kSteps <= 32, "a tile's taps and steps");
// the CUDA-core scatter (f32 lines)
constexpr int kWalkPoints = 64;     // points per chunk
constexpr int kWalkCtas = 44;       // point ranges per axis: 3 x 44 = 132, one per SM
constexpr int kWalkThreads = 1024;  // each owns (level, channel) columns of the CTA's tile

// Shared memory of a tensor-core scatter CTA of nt 8-channel tiles over L
// levels: the warps' f32 sums, two buffers of a tile's d_feat (rows padded
// to an odd count of 16 B), and two of its taps and bands at every level.
constexpr size_t mma_smem_bytes(int nt, int L) {
  return sizeof(float) * kMmaWarps * kMmaBlocks * nt * 4 * 32 +
         size_t{2} * kTilePoints * (nt % 2 ? nt : nt + 1) * 8 * 2 +
         size_t{2} * L * kTilePoints * 8 + size_t{2} * L * kSteps * 8;
}

// The per-level arrays (resolutions, first rows) lie in a device table the
// wrapper builds once per geometry (Geometry::res, ::off), not in the launch
// parameters, and the scatters walk the levels in runs and tiles: no level
// count is too large for a launch. What bounds L is the forward's tap
// buffers: two of one point's 3 L taps and the level table take 80 L bytes
// of a CTA's shared memory (fwd_tap_bytes), so the kernels take up to 2,905
// levels.
// the most levels of one tensor-core scatter launch (at one channel tile)
constexpr int kMmaRunLevels = 47;
static_assert(mma_smem_bytes(1, kMmaRunLevels) <= kMaxSmem &&
              mma_smem_bytes(1, kMmaRunLevels + 1) > kMaxSmem, "kMmaRunLevels");

// A geometry. The kernels read its levels from the device table (res_of,
// off_of); the host functions from its host copy (hres, hoff). A run of
// levels (run_geometry) points into the same table, its rows counted from
// `base`.
struct Geometry {
  int L;
  int C;
  int sumR;
  const int* res;   // device: each level's resolution
  const int* off;   // device: each level's first knot row, then sumR (L + 1)
  int base;         // the row off[0] holds: 0, or a run's first row
  const int* hres;  // host: the resolutions (L), for the host's plans
  const int* hoff;  // host: the first rows (L + 1)
  float aabb;
  float two_aabb;
  int staged;       // the forward's levels in shared memory (staged_levels)
  int staged_rows;  // their rows of each axis, hoff[staged]
};

__device__ __forceinline__ int res_of(const Geometry& g, int l) { return __ldg(g.res + l); }
__device__ __forceinline__ int off_of(const Geometry& g, int l) {
  return __ldg(g.off + l) - g.base;
}

struct Tap {
  int row;  // knot row of k0 in the axis's table; k0 + 1 is the next row
  float w0;
  float w1;
};

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float unit_coord(float x, const Geometry& g) {
  return fminf(fmaxf(__fdiv_rn(__fadd_rn(x, g.aabb), g.two_aabb), 0.f), 1.f);
}

template <bool kBf16>
__device__ __forceinline__ Tap make_tap(float u, int R, int off) {
  const float pos = __fmul_rn(u, static_cast<float>(R));
  const int k0 = min(static_cast<int>(floorf(pos)), R - 1);  // u = 1: pos = R
  float w0 = fmaxf(__fsub_rn(1.f, fabsf(__fsub_rn(pos, static_cast<float>(k0)))), 0.f);
  float w1 = fmaxf(__fsub_rn(1.f, fabsf(__fsub_rn(pos, static_cast<float>(k0 + 1)))), 0.f);
  if (kBf16) {
    w0 = round_bf16(w0);
    w1 = round_bf16(w1);
  }
  return Tap{off + k0, w0, w1};
}

// V consecutive line values as loaded: bf16 pairs or f32 words, turned into
// f32 where they are used (so values in flight hold half the registers
// under bf16).
template <bool kBf16, int V>
struct Line {
  static constexpr int kWords = kBf16 ? (V + 1) / 2 : V;
  unsigned w[kWords];
  __device__ __forceinline__ float operator[](int j) const {
    if constexpr (!kBf16 || V == 1) return __uint_as_float(w[kBf16 ? 0 : j]);
    else return __uint_as_float((j & 1) ? (w[j >> 1] & 0xffff0000u) : (w[j >> 1] << 16));
  }
};

// The V values from element `at` of a line table in global memory (through
// the read-only path) or in shared memory: one vector load of V bf16 or f32
// (two 16 B loads for 8 f32).
template <bool kBf16, int V, bool kShared>
__device__ __forceinline__ Line<kBf16, V> load_line(const void* base, long long at) {
  Line<kBf16, V> r;
  const unsigned char* bytes = static_cast<const unsigned char*>(base) + at * (kBf16 ? 2 : 4);
  constexpr int W = Line<kBf16, V>::kWords;
  if constexpr (kBf16 && V == 1) {  // a bf16 is the high half of its f32
    const unsigned short* h = reinterpret_cast<const unsigned short*>(bytes);
    r.w[0] = static_cast<unsigned>(kShared ? *h : __ldg(h)) << 16;
  } else if constexpr (W >= 4) {
    const uint4* q = reinterpret_cast<const uint4*>(bytes);
#pragma unroll
    for (int i = 0; i < W / 4; ++i) {
      const uint4 x = kShared ? q[i] : __ldg(q + i);
      r.w[4 * i] = x.x, r.w[4 * i + 1] = x.y, r.w[4 * i + 2] = x.z, r.w[4 * i + 3] = x.w;
    }
  } else if constexpr (W == 2) {
    const uint2* q = reinterpret_cast<const uint2*>(bytes);
    const uint2 x = kShared ? *q : __ldg(q);
    r.w[0] = x.x, r.w[1] = x.y;
  } else {
    const unsigned* q = reinterpret_cast<const unsigned*>(bytes);
    r.w[0] = kShared ? *q : __ldg(q);
  }
  return r;
}

// f += w0 v0, then f += w1 v1, per channel: one level's two taps. Under bf16
// a product of two bf16 values is exact in f32, so one fused multiply-add
// gives the bits of the rounded product's sum; under f32 the product is
// rounded first, as the JAX kernel rounds it.
template <bool kBf16, int V>
__device__ __forceinline__ void add_level(float (&f)[V], const Tap& t, const Line<kBf16, V>& v0,
                                          const Line<kBf16, V>& v1) {
#pragma unroll
  for (int j = 0; j < V; ++j) {
    if constexpr (kBf16) {
      f[j] = __fmaf_rn(t.w0, v0[j], f[j]);
      f[j] = __fmaf_rn(t.w1, v1[j], f[j]);
    } else {
      f[j] = __fadd_rn(f[j], __fmul_rn(t.w0, v0[j]));
      f[j] = __fadd_rn(f[j], __fmul_rn(t.w1, v1[j]));
    }
  }
}

// V f32 values from global memory, or to it: vector loads and stores (V
// divides C, so every group starts aligned to its width)
template <int V>
__device__ __forceinline__ void load_f32(const float* src, float (&v)[V]) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int j = 0; j < V; j += 4) {
      const float4 x = __ldg(reinterpret_cast<const float4*>(src) + j / 4);
      v[j] = x.x, v[j + 1] = x.y, v[j + 2] = x.z, v[j + 3] = x.w;
    }
  } else if constexpr (V == 2) {
    const float2 x = __ldg(reinterpret_cast<const float2*>(src));
    v[0] = x.x, v[1] = x.y;
  } else {
    v[0] = __ldg(src);
  }
}

template <int V>
__device__ __forceinline__ void store_f32(float* dst, const float (&v)[V]) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int j = 0; j < V; j += 4)
      reinterpret_cast<float4*>(dst)[j / 4] = make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]);
  } else if constexpr (V == 2) {
    *reinterpret_cast<float2*>(dst) = make_float2(v[0], v[1]);
  } else {
    dst[0] = v[0];
  }
}

// two bf16 (round to nearest) in one word, a in the low half
__device__ __forceinline__ unsigned pack_bf16(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const unsigned*>(&h);
}

// V values rounded to bf16 and stored: one 16 B store for V = 8
template <int V>
__device__ __forceinline__ void store_bf16(__nv_bfloat16* dst, const float (&v)[V]) {
  if constexpr (V == 1) {
    dst[0] = __float2bfloat16_rn(v[0]);
  } else {
    unsigned w[V / 2];
#pragma unroll
    for (int j = 0; j < V / 2; ++j) w[j] = pack_bf16(v[2 * j], v[2 * j + 1]);
    if constexpr (V == 8) *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
    else if constexpr (V == 4) *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
    else *reinterpret_cast<unsigned*>(dst) = w[0];
  }
}

// The forward's channel group: the widest of 8, 4, 2, 1 that divides C.
int fwd_vec(int C) { return C % 8 == 0 ? 8 : C % 4 == 0 ? 4 : C % 2 == 0 ? 2 : 1; }

// Points a forward CTA takes at once: enough (point, group) items for its
// threads, as far as two buffers of their taps fit kFwdTapBytes.
// One point at least: past 1,137 levels its taps alone outgrow
// kFwdTapBytes, and the forward takes one point a tile.
int fwd_points(const Geometry& g) {
  const int groups = g.C / fwd_vec(g.C);
  const int want = kFwdThreads / groups > 1 ? kFwdThreads / groups : 1;
  const int cap = kFwdTapBytes / (2 * 3 * g.L * static_cast<int>(sizeof(Tap)));
  return want < cap ? want : (cap > 1 ? cap : 1);
}

// Two buffers of a tile's taps, then the level table (res, then first rows:
// 2 L ints), which the tap loop reads from shared memory.
size_t fwd_tap_bytes(const Geometry& g) {
  return 2 * sizeof(Tap) * fwd_points(g) * 3 * g.L + 2 * sizeof(int) * g.L;
}

// Levels [0, staged) of every axis in shared memory, (3, off[staged], C) in
// the call's dtype, then two buffers of the tile's taps.
__host__ __device__ inline size_t fwd_lines_bytes(const Geometry& g, bool bf16) {
  return (size_t{3} * g.staged_rows * g.C * (bf16 ? 2 : 4) + 15) / 16 * 16;
}

// The forward's walk: stage the coarse levels, then per tile of P points
// the three axis features f[a][j] of each (point, V-channel group) item,
// handed to out(point, c0, f).
template <bool kBf16, int V, class Out>
__device__ __forceinline__ void walk_features(const float* __restrict__ pts,
                                              const void* __restrict__ lines, long long n,
                                              const Geometry& g, int P, const Out& out) {
  extern __shared__ __align__(16) unsigned char fwd_smem[];
  const int C = g.C, L = g.L, Ls = g.staged;
  const int S = g.staged_rows;  // staged rows of each axis
  const long long axis = static_cast<long long>(g.sumR) * C;
  {  // stage: V-element vectors (V divides C, so every one is aligned)
    constexpr int kBytes = V * (kBf16 ? 2 : 4);
    const int per_axis = S * C / V;
    for (int i = threadIdx.x; i < 3 * per_axis; i += kFwdThreads) {
      const int a = i / per_axis;
      const long long src = a * axis + static_cast<long long>(i - a * per_axis) * V;
      const unsigned char* from = static_cast<const unsigned char*>(lines) + src * (kBytes / V);
      unsigned char* to = fwd_smem + static_cast<long long>(i) * kBytes;
      if constexpr (kBytes >= 16) {
#pragma unroll
        for (int k = 0; k < kBytes / 16; ++k)
          reinterpret_cast<uint4*>(to)[k] = __ldg(reinterpret_cast<const uint4*>(from) + k);
      } else if constexpr (kBytes == 8) {
        *reinterpret_cast<uint2*>(to) = __ldg(reinterpret_cast<const uint2*>(from));
      } else if constexpr (kBytes == 4) {
        *reinterpret_cast<unsigned*>(to) = __ldg(reinterpret_cast<const unsigned*>(from));
      } else {
        *reinterpret_cast<unsigned short*>(to) =
            __ldg(reinterpret_cast<const unsigned short*>(from));
      }
    }
  }
  Tap* taps = reinterpret_cast<Tap*>(fwd_smem + fwd_lines_bytes(g, kBf16));
  int* levels = reinterpret_cast<int*>(taps + 2 * P * 3 * L);  // res, then first rows
  for (int i = threadIdx.x; i < 2 * L; i += kFwdThreads)
    levels[i] = i < L ? res_of(g, i) : off_of(g, i - L);
  __syncthreads();
  const int groups = C / V;
  const int per_point = 3 * L;
  int buf = 0;
  for (long long p0 = static_cast<long long>(blockIdx.x) * P; p0 < n;
       p0 += static_cast<long long>(gridDim.x) * P, buf ^= 1) {
    const int np = static_cast<int>(min(static_cast<long long>(P), n - p0));
    // the tile's taps, (point, axis, level), into the buffer the last tile
    // did not use: one barrier a tile
    Tap* tb = taps + buf * P * per_point;
    for (int t = threadIdx.x; t < np * 3; t += kFwdThreads) {
      const float u = unit_coord(pts[p0 * 3 + t], g);
      for (int l = 0; l < L; ++l) tb[t * L + l] = make_tap<kBf16>(u, levels[l], levels[L + l]);
    }
    __syncthreads();
    for (int it = threadIdx.x; it < np * groups; it += kFwdThreads) {
      const int pl = it / groups;
      const int c0 = (it - pl * groups) * V;
      const Tap* tp = tb + pl * per_point;
      // the first unstaged level of every axis, from L2, in flight while the
      // staged levels are summed
      Line<kBf16, V> p0v[3], p1v[3];
      if (Ls < L) {
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          const long long r = a * axis + static_cast<long long>(tp[a * L + Ls].row) * C + c0;
          p0v[a] = load_line<kBf16, V, false>(lines, r);
          p1v[a] = load_line<kBf16, V, false>(lines, r + C);
        }
      }
      float f[3][V];
#pragma unroll
      for (int a = 0; a < 3; ++a) {
#pragma unroll
        for (int j = 0; j < V; ++j) f[a][j] = 0.f;
        int l = 0;
        for (; l + 2 <= Ls; l += 2) {  // two levels' loads in flight, then their sums
          const Tap t0 = tp[a * L + l], t1 = tp[a * L + l + 1];
          const long long r0 = (static_cast<long long>(a) * S + t0.row) * C + c0;
          const long long r1 = (static_cast<long long>(a) * S + t1.row) * C + c0;
          const Line<kBf16, V> v00 = load_line<kBf16, V, true>(fwd_smem, r0);
          const Line<kBf16, V> v01 = load_line<kBf16, V, true>(fwd_smem, r0 + C);
          const Line<kBf16, V> v10 = load_line<kBf16, V, true>(fwd_smem, r1);
          const Line<kBf16, V> v11 = load_line<kBf16, V, true>(fwd_smem, r1 + C);
          add_level(f[a], t0, v00, v01);
          add_level(f[a], t1, v10, v11);
        }
        if (l < Ls) {
          const Tap t = tp[a * L + l];
          const long long r = (static_cast<long long>(a) * S + t.row) * C + c0;
          add_level(f[a], t, load_line<kBf16, V, true>(fwd_smem, r),
                    load_line<kBf16, V, true>(fwd_smem, r + C));
        }
        if (Ls < L) add_level(f[a], tp[a * L + Ls], p0v[a], p1v[a]);
        for (int l0 = Ls + 1; l0 < L; l0 += kBatch) {  // a level past L is loaded, not summed
          Line<kBf16, V> v0[kBatch], v1[kBatch];
#pragma unroll
          for (int j = 0; j < kBatch; ++j) {
            const long long r =
                a * axis + static_cast<long long>(tp[a * L + min(l0 + j, L - 1)].row) * C + c0;
            v0[j] = load_line<kBf16, V, false>(lines, r);
            v1[j] = load_line<kBf16, V, false>(lines, r + C);
          }
#pragma unroll
          for (int j = 0; j < kBatch; ++j)
            if (l0 + j < L) add_level(f[a], tp[a * L + l0 + j], v0[j], v1[j]);
        }
      }
      out(p0 + pl, c0, f);
    }
  }
}

// the forward's epilogue: enc = (X * Y) * Z
struct EncodeOut {
  float* enc;
  int C;
  template <int V>
  __device__ __forceinline__ void operator()(long long p, int c0, const float (&f)[3][V]) const {
    float e[V];
#pragma unroll
    for (int j = 0; j < V; ++j) e[j] = __fmul_rn(__fmul_rn(f[0][j], f[1][j]), f[2][j]);
    store_f32<V>(enc + p * C + c0, e);
  }
};

// the backward's first epilogue: d_feat[a][p] = (g * f_b) * f_c, rounded to
// bf16 under bf16, and zeros in the padding columns [C, stride)
template <bool kBf16>
struct DFeatOut {
  const float* gout;
  void* dfeat;
  long long n;
  int C;
  int stride;
  template <int V>
  __device__ __forceinline__ void operator()(long long p, int c0, const float (&f)[3][V]) const {
    float gv[V];
    load_f32<V>(gout + p * C + c0, gv);
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const int b = a == 0 ? 1 : 0;  // the other two axes, in the JAX kernel's order
      const int c = a == 2 ? 1 : 2;
      float d[V];
#pragma unroll
      for (int j = 0; j < V; ++j) d[j] = __fmul_rn(__fmul_rn(gv[j], f[b][j]), f[c][j]);
      const long long row = (a * n + p) * stride;
      if constexpr (kBf16) {
        __nv_bfloat16* dst = static_cast<__nv_bfloat16*>(dfeat) + row;
        store_bf16<V>(dst + c0, d);
        if (c0 + V == C)
          for (int k = C; k < stride; ++k) dst[k] = __float2bfloat16_rn(0.f);
      } else {
        store_f32<V>(static_cast<float*>(dfeat) + row + c0, d);
      }
    }
  }
};

template <bool kBf16, int V>
__global__ void __launch_bounds__(kFwdThreads, 1) factored_fwd_kernel(
    const float* __restrict__ pts, const void* __restrict__ lines, float* __restrict__ enc,
    long long n, const Geometry g, int P) {
  walk_features<kBf16, V>(pts, lines, n, g, P, EncodeOut{enc, g.C});
}

template <bool kBf16, int V>
__global__ void __launch_bounds__(kFwdThreads, 1) factored_dfeat_kernel(
    const float* __restrict__ pts, const void* __restrict__ lines, const float* __restrict__ gout,
    void* __restrict__ dfeat, long long n, const Geometry g, int P, int stride) {
  walk_features<kBf16, V>(pts, lines, n, g, P, DFeatOut<kBf16>{gout, dfeat, n, g.C, stride});
}

// ---- the tensor-core scatter (bf16 lines) ----

struct MmaTap {
  int row;     // knot row of k0 at this level; a point past n has a row no block reaches
  unsigned w;  // bf16 w0 in the low half, w1 in the high half
};

// 8-channel tiles of a scatter CTA: the padded row of its d_feat tile in
// shared memory is an odd number of 16 B units
template <int NT>
struct MmaLayout {
  static constexpr int kRow = (NT % 2 ? NT : NT + 1) * 8;       // bf16 per staged point
  static constexpr int kSums = kMmaWarps * kMmaBlocks * NT * 4 * 32;  // f32 sums, a CTA
  static constexpr size_t kTileBytes = size_t{2} * kTilePoints * kRow * 2;
};

static_assert(sizeof(MmaTap) == 8 && sizeof(int2) == 8, "mma_smem_bytes");

__device__ __forceinline__ int level_of(int r, const Geometry& g) {
  int l = 0;
  while (l + 1 < g.L && off_of(g, l + 1) <= r) ++l;
  return l;
}

// W^T's elements (row r; points p, p + 1) from the two points' taps at r's
// level, (row, w, row, w) as one 16 B load: a0a1 of an A fragment. Per
// point the bf16 is w0 (bytes 0-1 of its tap word) at r = its tap row, w1
// (bytes 2-3) at the row after, else 0: a byte selector of prmt whose sign
// bit replicates the sign of the high byte of w0, which is 0 (w0 >= 0).
__device__ __forceinline__ unsigned hat_pair(int r, const uint4& t) {
  const unsigned d0 = static_cast<unsigned>(r - static_cast<int>(t.x));
  const unsigned d1 = static_cast<unsigned>(r - static_cast<int>(t.z));
  const unsigned sel = (d0 < 2 ? 0x10u + 0x22u * d0 : 0x99u) |
                       (d1 < 2 ? 0x5400u + 0x2200u * d1 : 0xdd00u);
  unsigned out;
  asm("prmt.b32 %0, %1, %2, %3;\n" : "=r"(out) : "r"(t.y), "r"(t.w), "r"(sel));
  return out;
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(nerf::smem_addr(p))
               : "memory");
}

// CTA (range, slab * groups + group, axis): partials[axis][range] (sumR,
// stride) f32, rows of the slab's blocks and the group's channels, summed
// over tiles [range * per, (range + 1) * per) of kTilePoints points.
// g is the geometry of one run of levels (level_run): its rows are the rows
// [0, g.sumR) of the run, written at ``partials`` (the run's first row of
// tables of ``table_rows`` rows).
template <int NT>
__global__ void __launch_bounds__(kMmaWarps * 32, 1) factored_scatter_mma_kernel(
    const float* __restrict__ pts, const __nv_bfloat16* __restrict__ dfeat,
    float* __restrict__ partials, long long n, int per, const Geometry g, int stride, int slabs,
    int groups, int table_rows) {
  using Lay = MmaLayout<NT>;
  extern __shared__ __align__(16) unsigned char mma_smem[];
  float* sums = reinterpret_cast<float*>(mma_smem);
  __nv_bfloat16* dtile = reinterpret_cast<__nv_bfloat16*>(sums + Lay::kSums);
  MmaTap* taps = reinterpret_cast<MmaTap*>(mma_smem + sizeof(float) * Lay::kSums + Lay::kTileBytes);
  int2* band = reinterpret_cast<int2*>(taps + 2 * g.L * kTilePoints);  // [2][L][kSteps]
  const int L = g.L;
  const int a = blockIdx.z;
  const int slab = blockIdx.y / groups, c_first = (blockIdx.y - slab * groups) * NT * 8;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, q = lane & 3;
  const int nblocks = (g.sumR + 15) / 16;
  const long long tiles = (n + kTilePoints - 1) / kTilePoints;
  const long long t_first = static_cast<long long>(blockIdx.x) * per;
  const long long t_end = min(t_first + per, tiles);

  // this warp's blocks: the first row (-1: none), the levels of its first
  // and last rows, and of this lane's two rows r0 + gid and r0 + gid + 8
  int r0[kMmaBlocks], lo[kMmaBlocks], hi[kMmaBlocks], la[kMmaBlocks], lb[kMmaBlocks];
#pragma unroll
  for (int j = 0; j < kMmaBlocks; ++j) {
    const int b = slab + slabs * (warp + kMmaWarps * j);
    r0[j] = b < nblocks ? 16 * b : -1;
    const int last = g.sumR - 1, r = max(r0[j], 0);
    lo[j] = level_of(r, g);
    hi[j] = level_of(min(r + 15, last), g);
    la[j] = level_of(min(r + gid, last), g);
    lb[j] = level_of(min(r + gid + 8, last), g);
  }
  float* my_sums = sums + warp * (kMmaBlocks * NT * 4 * 32) + lane;
  for (int i = 0; i < kMmaBlocks * NT * 4; ++i) my_sums[i * 32] = 0.f;
  float acc[kMmaBlocks][NT][4];
#pragma unroll
  for (int j = 0; j < kMmaBlocks; ++j)
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][t][i] = 0.f;

  // thread i computes the taps of point i % kTilePoints at levels i /
  // kTilePoints + k kTapLevels
  constexpr int kTapLevels = kMmaWarps * 32 / kTilePoints;
  const int tap_p = threadIdx.x % kTilePoints, tap_l = threadIdx.x / kTilePoints;
  auto coord = [&](long long t) {
    const long long p = t * kTilePoints + tap_p;
    return p < n ? pts[p * 3 + a] : 0.f;
  };
  auto make_taps = [&](long long t, float x, int buf) {
    MmaTap* tb = taps + buf * L * kTilePoints + tap_p;
    const bool in = t * kTilePoints + tap_p < n;
    const float u = unit_coord(x, g);
    for (int l = tap_l; l < L; l += kTapLevels) {
      const Tap tp = make_tap<true>(u, res_of(g, l), off_of(g, l));
      tb[l * kTilePoints] = in ? MmaTap{tp.row, pack_bf16(tp.w0, tp.w1)} : MmaTap{-2, 0u};
      // the step's band at this level: its 16 points' tap rows span
      // [mn, mx] (a warp's lanes are 32 points of one level: two steps)
      int mn = in ? tp.row : 0x3fffffff, mx = in ? tp.row + 1 : -0x3fffffff;
#pragma unroll
      for (int o = 1; o < 16; o <<= 1) {
        mn = min(mn, __shfl_xor_sync(0xffffffffu, mn, o));
        mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      }
      if ((tap_p & 15) == 0) band[(buf * L + l) * kSteps + tap_p / 16] = make_int2(mn, mx);
    }
  };
  // the group's d_feat columns of tile t by cp.async (zeros past n)
  auto load_dfeat = [&](long long t, int buf) {
    const long long p0 = t * kTilePoints;
    __nv_bfloat16* db = dtile + buf * kTilePoints * Lay::kRow;
    for (int i = threadIdx.x; i < kTilePoints * NT; i += kMmaWarps * 32) {
      const int p = i / NT, k = i - p * NT;
      const bool in = p0 + p < n;
      const __nv_bfloat16* src =
          dfeat + (a * n + (in ? p0 + p : 0)) * stride + c_first + k * 8;
      nerf::cp_async16(db + p * Lay::kRow + k * 8, src, in);
    }
    nerf::cp_async_commit();
  };
  // one step (16 points) of block j: A from the taps, B from the d_feat tile
  auto step = [&](int j, int s, const __nv_bfloat16* db, const MmaTap* tb) {
    uint32_t bf[NT][2];
    const int m = lane >> 3;
    const __nv_bfloat16* row = db + (s * 16 + (m & 1) * 8 + (lane & 7)) * Lay::kRow;
#pragma unroll
    for (int t2 = 0; t2 + 1 < NT; t2 += 2) {
      uint32_t r[4];
      nerf::ldmatrix_x4_trans(r, row + (t2 + (m >> 1)) * 8);
      bf[t2][0] = r[0], bf[t2][1] = r[1], bf[t2 + 1][0] = r[2], bf[t2 + 1][1] = r[3];
    }
    if constexpr (NT % 2) ldmatrix_x2_trans(bf[NT - 1], row + (NT - 1) * 8);
    // A: rows r0 + gid (a0a1, a4a5) and + 8 (a2a3, a6a7); points 2q, 2q + 1
    // (a0-a3) and 2q + 8, 2q + 9 (a4-a7)
    const uint4* ta = reinterpret_cast<const uint4*>(tb + la[j] * kTilePoints + s * 16);
    const uint4* tc = reinterpret_cast<const uint4*>(tb + lb[j] * kTilePoints + s * 16);
    const int r = r0[j] + gid;
    const uint32_t af[4] = {hat_pair(r, ta[q]), hat_pair(r + 8, tc[q]), hat_pair(r, ta[q + 4]),
                            hat_pair(r + 8, tc[q + 4])};
#pragma unroll
    for (int t2 = 0; t2 < NT; ++t2) nerf::mma_16816(acc[j][t2], af, bf[t2][0], bf[t2][1]);
  };

  // one barrier a tile: tile t + 1's d_feat is in flight and its
  // coordinates in registers while tile t is summed, then its taps are
  // made into the other buffers
  if (t_first < t_end) {
    load_dfeat(t_first, 0);
    make_taps(t_first, coord(t_first), 0);
  }
  nerf::cp_async_wait<0>();
  __syncthreads();
  for (long long t = t_first; t < t_end; ++t) {
    const int buf = static_cast<int>(t - t_first) & 1;
    const bool next = t + 1 < t_end;
    float x_next = 0.f;
    if (next) {
      load_dfeat(t + 1, buf ^ 1);
      x_next = coord(t + 1);
    }
    const __nv_bfloat16* db = dtile + buf * kTilePoints * Lay::kRow;
    const MmaTap* tb = taps + buf * L * kTilePoints;
    unsigned steps[kMmaBlocks] = {};
    // block j's steps: bit s when step s's band at a level of the block
    // meets the block's rows (lane i looks at step i % kSteps, at levels
    // lo + i / kSteps, + 32 / kSteps, ...); each such step's products go
    // into the block's sums
#pragma unroll
    for (int j = 0; j < kMmaBlocks; ++j) {
      if (r0[j] < 0) continue;
      bool hit = false;
      const int2* bd = band + buf * L * kSteps + lane % kSteps;
      for (int l = lo[j] + lane / kSteps; l <= hi[j]; l += 32 / kSteps) {
        const int2 b = bd[l * kSteps];
        hit |= b.x <= r0[j] + 15 && b.y >= r0[j];
      }
      const unsigned v = __ballot_sync(0xffffffffu, hit);
#pragma unroll
      for (int k = 0; k < 32; k += kSteps) steps[j] |= v >> k;
      steps[j] &= 0xffffffffu >> (32 - kSteps);
      for (unsigned bits = steps[j]; bits; bits &= bits - 1) step(j, __ffs(bits) - 1, db, tb);
    }
    // the tile's sums into the f32 table, added to nearest
#pragma unroll
    for (int j = 0; j < kMmaBlocks; ++j) {
      if (!steps[j]) continue;
#pragma unroll
      for (int t2 = 0; t2 < NT; ++t2)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float* s = my_sums + ((j * NT + t2) * 4 + i) * 32;
          *s = __fadd_rn(*s, acc[j][t2][i]);
          acc[j][t2][i] = 0.f;
        }
    }
    if (next) make_taps(t + 1, x_next, buf ^ 1);
    nerf::cp_async_wait<0>();
    __syncthreads();  // tile t + 1 is in; buffer buf is free for tile t + 2
  }
  // C fragment (i): row gid + 8 (i >> 1), column 2q + (i & 1) of the tile
  float* out = partials + (static_cast<long long>(a) * gridDim.x + blockIdx.x) * table_rows * stride;
#pragma unroll
  for (int j = 0; j < kMmaBlocks; ++j) {
    if (r0[j] < 0) continue;
#pragma unroll
    for (int t2 = 0; t2 < NT; ++t2)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r0[j] + gid + 8 * h;
        if (row < g.sumR) {
          const float* s = my_sums + ((j * NT + t2) * 4 + 2 * h) * 32;
          *reinterpret_cast<float2*>(out + static_cast<long long>(row) * stride + c_first +
                                     t2 * 8 + 2 * q) = make_float2(s[0], s[32]);
        }
      }
  }
}

// ---- the CUDA-core scatter (f32 lines) ----

// The table tiles of the f32 scatter: level groups (each from the level
// where the last one ended to group_end's), a group's rows cut into runs of
// at most row_cap rows (tiles in all; more than one only for a single level
// wider than a CTA), times column chunks of cw (the last one ragged). A CTA
// takes one tile of one axis and finds its group by walking the groups
// again, on the device table: the groups ride in no launch parameter.
struct WalkTiles {
  int cw;
  int row_cap;
  int tiles;
};

__host__ __device__ inline size_t walk_smem_bytes(int rows, int levels, int cw) {
  return sizeof(float) * (static_cast<size_t>(rows) * cw + size_t{kWalkPoints} * cw) +
         sizeof(Tap) * kWalkPoints * levels;
}

// The end of the level group that starts at level l: the most levels from l
// whose rows (from the first rows `off`, in host or device memory as the
// caller runs) fit a CTA beside cw columns, one at least.
__host__ __device__ inline int group_end(const int* off, int L, int l, int cw) {
  int e = l + 1;
  while (e < L && walk_smem_bytes(off[e + 1] - off[l], e + 1 - l, cw) <= kMaxSmem) ++e;
  return e;
}

// The fewest tiles: all columns where the finest level's rows allow it, else
// as many as fit beside them (at least one), and the levels in runs whose
// rows fit beside those columns; a level whose rows of one column do not fit
// is cut into runs of row_cap rows (kernels/fused_factored.py::walk_tiles
// mirrors it).
void walk_tiles(const Geometry& g, WalkTiles* t) {
  int widest = 0;
  for (int l = 0; l < g.L; ++l) widest = std::max(widest, g.hres[l] + 1);
  t->cw = g.C;
  while (t->cw > 1 && walk_smem_bytes(widest, 1, t->cw) > kMaxSmem) --t->cw;
  t->row_cap = 1;
  while (walk_smem_bytes(t->row_cap + 1, 1, t->cw) <= kMaxSmem) ++t->row_cap;
  t->tiles = 0;
  for (int l = 0; l < g.L;) {
    const int e = group_end(g.hoff, g.L, l, t->cw);
    t->tiles += (g.hoff[e] - g.hoff[l] + t->row_cap - 1) / t->row_cap;
    l = e;
  }
}

// CTA (b, tile, a): axis a's gradient at the tile's rows and columns over
// chunks [b * per, (b + 1) * per) of 64 points, into partials[a][b] (sumR, C).
__global__ void __launch_bounds__(kWalkThreads, 1) factored_scatter_walk_kernel(
    const float* __restrict__ pts, const float* __restrict__ dfeat, float* __restrict__ partials,
    long long n, int per, const Geometry g, const WalkTiles wt) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = g.C, a = blockIdx.z, tid = threadIdx.x;
  const int c0 = (blockIdx.y / wt.tiles) * wt.cw;
  const int cn = min(wt.cw, C - c0);
  // the tile's level group [l0, l0 + nl) and its run of rows
  int l0 = 0, e = 0, run = blockIdx.y % wt.tiles;
  for (;; l0 = e) {
    e = group_end(g.off, g.L, l0, wt.cw);
    const int runs = (off_of(g, e) - off_of(g, l0) + wt.row_cap - 1) / wt.row_cap;
    if (run < runs) break;
    run -= runs;
  }
  const int nl = e - l0;
  const int r0 = off_of(g, l0) + run * wt.row_cap;
  const int rows = min(wt.row_cap, off_of(g, l0 + nl) - r0);
  float* table = reinterpret_cast<float*>(smem);
  Tap* taps = reinterpret_cast<Tap*>(table + rows * cn);
  float* chunk = reinterpret_cast<float*>(taps + kWalkPoints * nl);
  const int items = nl * cn;  // (level, channel) columns of the tile

  for (int i = tid; i < rows * cn; i += blockDim.x) table[i] = 0.f;
  for (int k = 0; k < per; ++k) {
    const long long p0 = (static_cast<long long>(blockIdx.x) * per + k) * kWalkPoints;
    if (p0 >= n) break;  // the same for the whole CTA
    const int np = static_cast<int>(min(static_cast<long long>(kWalkPoints), n - p0));
    __syncthreads();  // the last chunk's taps and d_feat are consumed
    for (int t = tid; t < np * nl; t += blockDim.x) {
      const int l = l0 + t % nl;
      const float u = unit_coord(pts[(p0 + t / nl) * 3 + a], g);
      taps[t] = make_tap<false>(u, res_of(g, l), off_of(g, l) - r0);
    }
    const float* src = dfeat + (a * n + p0) * C + c0;
    if (cn == C) {  // every column: the chunk's rows are contiguous
      for (int t = tid; t < np * C; t += blockDim.x) chunk[t] = src[t];
    } else {
      for (int t = tid; t < np * cn; t += blockDim.x) chunk[t] = src[(t / cn) * C + t % cn];
    }
    __syncthreads();
    for (int it = tid; it < items; it += blockDim.x) {
      const int l = it / cn, c = it - l * cn;
      // a tap's rows outside this run (only where a level is cut into runs
      // of rows) belong to the runs beside it
      for (int p = 0; p < np; ++p) {
        const Tap t = taps[p * nl + l];
        const float d = chunk[p * cn + c];
        if (static_cast<unsigned>(t.row) < static_cast<unsigned>(rows)) {
          float* row = table + t.row * cn + c;
          *row = __fadd_rn(*row, __fmul_rn(t.w0, d));
        }
        if (static_cast<unsigned>(t.row + 1) < static_cast<unsigned>(rows)) {
          float* row = table + (t.row + 1) * cn + c;
          *row = __fadd_rn(*row, __fmul_rn(t.w1, d));
        }
      }
    }
  }
  __syncthreads();
  float* out = partials + ((static_cast<long long>(a) * gridDim.x + blockIdx.x) * g.sumR + r0) * C + c0;
  if (cn == C) {
    for (int i = tid; i < rows * C; i += blockDim.x) out[i] = table[i];
  } else {
    for (int i = tid; i < rows * cn; i += blockDim.x) out[(i / cn) * C + i % cn] = table[i];
  }
}

// d_lines[a][r][c] = sum over b, in order, of partials[a][b][r][c] (rows of
// stride columns, the first C of them summed)
__global__ void factored_reduce_kernel(const float* __restrict__ partials,
                                       float* __restrict__ d_lines, int ctas, int rows, int C,
                                       int stride) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long RC = static_cast<long long>(rows) * C;
  if (i >= 3 * RC) return;
  const long long a = i / RC;
  const int r = static_cast<int>((i - a * RC) / C), c = static_cast<int>(i - a * RC - r * C);
  const long long table = static_cast<long long>(rows) * stride;
  const float* src = partials + a * ctas * table + static_cast<long long>(r) * stride + c;
  float s = 0.f;
  for (int b = 0; b < ctas; ++b) s = __fadd_rn(s, src[b * table]);
  d_lines[i] = s;
}

// Fills g from the host resolutions `res` (L of them) and `levels`, their
// device table: res, then each level's first row and the rows in all (L + 1;
// fused_factored.py builds it); *hoff holds the host's first rows. Returns
// 0, or -2 for no level (or no table), -4 for a resolution below 1, -5 for
// more levels than the forward's tap buffers take (fwd_tap_bytes).
int init_geometry(Geometry* g, std::vector<int>* hoff, const int* res, const void* levels, int L,
                  int C, float aabb, float two_aabb) {
  if (L < 1 || levels == nullptr) return -2;
  g->L = L;
  g->C = C;
  g->aabb = aabb;
  g->two_aabb = two_aabb;
  hoff->assign(L + 1, 0);
  int off = 0;
  for (int l = 0; l < L; ++l) {
    if (res[l] < 1) return -4;
    (*hoff)[l] = off;
    off += res[l] + 1;
  }
  (*hoff)[L] = off;
  g->sumR = off;
  g->res = static_cast<const int*>(levels);
  g->off = g->res + L;
  g->base = 0;
  g->hres = res;
  g->hoff = hoff->data();
  g->staged = 0;
  g->staged_rows = 0;
  return fwd_tap_bytes(*g) > kMaxSmem ? -5 : 0;
}

// Sets the forward's staged levels (staged_levels) and their rows.
void set_staged(Geometry* g, int staged) {
  g->staged = staged;
  g->staged_rows = g->hoff[staged];
}

// The most levels, from level 0, whose rows of all three axes fit one CTA's
// shared memory in the call's dtype (nerf_factored_fwd_staged_levels reports it).
int staged_levels(const Geometry& g, bool bf16) {
  const long long budget =
      static_cast<long long>(kMaxSmem) - static_cast<long long>(fwd_tap_bytes(g)) - 15;
  int s = 0;
  while (s < g.L && 3LL * g.hoff[s + 1] * g.C * (bf16 ? 2 : 4) <= budget) ++s;
  return s;
}

// The SMs of the current device, asked once per device (a call's host time
// is on the card's critical path).
int sm_count(int* sms) {
  static int known_dev = -1, known_sms = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && dev != known_dev) {
    err = cudaDeviceGetAttribute(&known_sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) known_dev = dev;
  }
  *sms = known_sms;
  return static_cast<int>(err);
}

// The forward's walk with either epilogue on a persistent grid: as many
// CTAs as the card holds at once, asked once per device and shared memory
// size.
template <bool kBf16, int V, bool kDFeat>
int launch_walk(const float* pts, const void* lines, void* out, const float* gout, int stride,
                long long n, const Geometry& g, cudaStream_t st) {
  const size_t smem = fwd_lines_bytes(g, kBf16) + fwd_tap_bytes(g);
  const int P = fwd_points(g);
  static int known_dev = -1, known_cap = 0;
  static size_t known_smem = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev != known_dev || smem != known_smem) {
    int sms = 132, resident = 1;
    const void* fn = kDFeat ? reinterpret_cast<const void*>(factored_dfeat_kernel<kBf16, V>)
                            : reinterpret_cast<const void*>(factored_fwd_kernel<kBf16, V>);
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, fn, kFwdThreads, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    known_dev = dev;
    known_smem = smem;
    known_cap = sms * (resident > 0 ? resident : 1);
  }
  const long long want = (n + P - 1) / P;
  const long long cap = known_cap;
  const unsigned grid = static_cast<unsigned>(want < cap ? want : cap);
  if constexpr (kDFeat)
    factored_dfeat_kernel<kBf16, V><<<grid, kFwdThreads, smem, st>>>(pts, lines, gout, out, n, g,
                                                                      P, stride);
  else
    factored_fwd_kernel<kBf16, V><<<grid, kFwdThreads, smem, st>>>(
        pts, lines, static_cast<float*>(out), n, g, P);
  return static_cast<int>(cudaGetLastError());
}

template <bool kBf16, bool kDFeat>
int launch_walk_any(const float* pts, const void* lines, void* out, const float* gout, int stride,
                    long long n, const Geometry& g, cudaStream_t st) {
  switch (fwd_vec(g.C)) {
    case 8: return launch_walk<kBf16, 8, kDFeat>(pts, lines, out, gout, stride, n, g, st);
    case 4: return launch_walk<kBf16, 4, kDFeat>(pts, lines, out, gout, stride, n, g, st);
    case 2: return launch_walk<kBf16, 2, kDFeat>(pts, lines, out, gout, stride, n, g, st);
    default: return launch_walk<kBf16, 1, kDFeat>(pts, lines, out, gout, stride, n, g, st);
  }
}

// The backward's layout for n points (kernels/fused_factored.py::bwd_plan
// mirrors it): bf16 lines take 8-channel tiles in `groups` groups of nt
// (C padded to stride = groups * nt * 8), 16-row blocks in `slabs` slabs
// of kMmaWarps * kMmaBlocks, and points in `ranges` ranges of `per` tiles
// of kTilePoints, as many ranges as give every SM one CTA; f32 lines take
// kWalkCtas ranges of chunks of kWalkPoints per axis. Under bf16 the groups
// are the fewest of at most kMmaMaxTiles tiles; the levels whose taps do not
// fit beside them go in runs (level_run).
struct BwdPlan {
  int stride, nt, groups, slabs, ranges, per;
};

BwdPlan bwd_plan(long long n, int sumR, int C, bool bf16, int sms) {
  BwdPlan p{C, 0, 1, 1, 0, 0};
  long long units, want;
  if (bf16) {
    const int tiles8 = (C + 7) / 8;
    p.groups = (tiles8 + kMmaMaxTiles - 1) / kMmaMaxTiles;
    p.nt = (tiles8 + p.groups - 1) / p.groups;
    p.stride = p.groups * p.nt * 8;
    const int blocks = (sumR + 15) / 16;
    p.slabs = (blocks + kMmaWarps * kMmaBlocks - 1) / (kMmaWarps * kMmaBlocks);
    units = (n + kTilePoints - 1) / kTilePoints;
    want = sms / (3 * p.slabs * p.groups);
    if (want < 1) want = 1;
  } else {
    units = (n + kWalkPoints - 1) / kWalkPoints;
    want = kWalkCtas;
  }
  if (want > units) want = units;
  p.per = want > 0 ? static_cast<int>((units + want - 1) / want) : 0;
  p.ranges = p.per > 0 ? static_cast<int>((units + p.per - 1) / p.per) : 0;
  return p;
}

size_t align256(size_t b) { return (b + 255) / 256 * 256; }

size_t dfeat_bytes(long long n, const BwdPlan& p, bool bf16) {
  return align256(3 * static_cast<size_t>(n) * p.stride * (bf16 ? 2 : 4));
}

template <int NT>
int launch_mma_run(const float* pts, const __nv_bfloat16* dfeat, float* partials, long long n,
                   const Geometry& g, const BwdPlan& p, int table_rows, cudaStream_t st) {
  static int known_dev = -1;
  static size_t known_smem = 0;
  static_assert(sizeof(float) * MmaLayout<NT>::kSums + MmaLayout<NT>::kTileBytes ==
                mma_smem_bytes(NT, 0), "mma_smem_bytes is MmaLayout's");
  const size_t smem = mma_smem_bytes(NT, g.L);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && (dev != known_dev || smem != known_smem)) {
    err = cudaFuncSetAttribute(factored_scatter_mma_kernel<NT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err == cudaSuccess) known_dev = dev, known_smem = smem;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(p.ranges), static_cast<unsigned>(p.slabs * p.groups), 3);
  factored_scatter_mma_kernel<NT><<<grid, kMmaWarps * 32, smem, st>>>(
      pts, dfeat, partials, n, p.per, g, p.stride, p.slabs, p.groups, table_rows);
  return static_cast<int>(cudaGetLastError());
}

// The levels of one tensor-core scatter launch: the most whose taps fit
// beside nt channel tiles, all L where they do (kMmaRunLevels at one tile;
// kernels/fused_factored.py::level_run mirrors it).
int level_run(int nt, int L) {
  int k = L;
  while (k > 1 && mma_smem_bytes(nt, k) > kMaxSmem) --k;
  return k;
}

// Levels [l0, l1) of g as a geometry of their own, rows from 0: the same
// device table from level l0 on, its rows counted from g's row of l0 (the
// host copy's offsets stay g's, so no host plan reads it).
Geometry run_geometry(const Geometry& g, int l0, int l1) {
  Geometry r = g;
  r.L = l1 - l0;
  r.res = g.res + l0;
  r.off = g.off + l0;
  r.base = g.base + g.hoff[l0];
  r.hres = nullptr;
  r.hoff = nullptr;
  r.sumR = g.hoff[l1] - g.hoff[l0];
  return r;
}

// One launch per run of levels (level_run), each on its rows of the
// partial tables; the point ranges are the plan's for every run.
template <int NT>
int launch_mma(const float* pts, const __nv_bfloat16* dfeat, float* partials, long long n,
               const Geometry& g, const BwdPlan& p, cudaStream_t st) {
  const int run = level_run(NT, g.L);
  for (int l0 = 0; l0 < g.L; l0 += run) {
    const Geometry r = run_geometry(g, l0, std::min(g.L, l0 + run));
    const int blocks = (r.sumR + 15) / 16;
    BwdPlan q = p;
    q.slabs = (blocks + kMmaWarps * kMmaBlocks - 1) / (kMmaWarps * kMmaBlocks);
    const int rc = launch_mma_run<NT>(
        pts, dfeat, partials + static_cast<long long>(g.hoff[l0]) * p.stride, n, r, q, g.sumR, st);
    if (rc != 0) return rc;
  }
  return 0;
}

}  // namespace

extern "C" {

// Returns 0, a cudaError_t from the launch, or a negative code for a shape
// the kernel does not take (see nerf_rs_tpu_torch/kernels/fused_factored.py).
// pts (n, 3) f32; lines (3, sumR, C), bf16 with bf16 = 1, else f32; enc (n, C) f32;
// res the L resolutions in host memory, levels their device table
// (init_geometry).
int nerf_factored_encode_fwd(const void* pts, const void* lines, void* enc, long long n,
                             const int* res, const void* levels, int L, int C, float aabb,
                             float two_aabb, int bf16, void* stream) {
  Geometry g;
  std::vector<int> hoff;
  const int rc = init_geometry(&g, &hoff, res, levels, L, C, aabb, two_aabb);
  if (rc != 0) return rc;
  if (n == 0) return 0;
  set_staged(&g, staged_levels(g, bf16 != 0));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* p = static_cast<const float*>(pts);
  return bf16 ? launch_walk_any<true, false>(p, lines, enc, nullptr, C, n, g, st)
              : launch_walk_any<false, false>(p, lines, enc, nullptr, C, n, g, st);
}

// The forward's levels in shared memory (staged_levels) for this geometry.
int nerf_factored_fwd_staged_levels(const int* res, int L, int C, int bf16) {
  Geometry g;
  std::vector<int> hoff;
  const int rc = init_geometry(&g, &hoff, res, res, L, C, 1.f, 2.f);  // no kernel reads g
  return rc != 0 ? rc : staged_levels(g, bf16 != 0);
}

// The backward's layout on `sms` SMs, as the six ints of BwdPlan (stride,
// nt, groups, slabs, ranges, per).
void nerf_factored_bwd_plan(long long n, int sumR, int C, int bf16, int sms, int* out) {
  const BwdPlan p = bwd_plan(n, sumR, C, bf16 != 0, sms);
  const int v[6] = {p.stride, p.nt, p.groups, p.slabs, p.ranges, p.per};
  for (int i = 0; i < 6; ++i) out[i] = v[i];
}

// Bytes of the backward's scratch for n points on the current device: the
// d_feat scratch, then the partial tables; -1 with no device.
long long nerf_factored_bwd_scratch_bytes(long long n, int sumR, int C, int bf16) {
  int sms = 0;
  if (sm_count(&sms) != 0) return -1;
  const BwdPlan p = bwd_plan(n, sumR, C, bf16 != 0, sms);
  return static_cast<long long>(dfeat_bytes(n, p, bf16 != 0)) +
         3LL * p.ranges * sumR * p.stride * static_cast<long long>(sizeof(float));
}

// The backward's first kernel alone: g (n, C) f32 -> dfeat (3, n, stride),
// bf16 with bf16 = 1 (stride from nerf_factored_bwd_plan, the columns past C
// zero), else f32 with stride C.
int nerf_factored_dfeat(const void* pts, const void* lines, const void* gout, void* dfeat,
                        long long n, const int* res, const void* levels, int L, int C, float aabb,
                        float two_aabb, int bf16, int stride, void* stream) {
  Geometry g;
  std::vector<int> hoff;
  const int rc = init_geometry(&g, &hoff, res, levels, L, C, aabb, two_aabb);
  if (rc != 0) return rc;
  if (n == 0) return 0;
  set_staged(&g, staged_levels(g, bf16 != 0));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* p = static_cast<const float*>(pts);
  const float* go = static_cast<const float*>(gout);
  return bf16 ? launch_walk_any<true, true>(p, lines, dfeat, go, stride, n, g, st)
              : launch_walk_any<false, true>(p, lines, dfeat, go, stride, n, g, st);
}

// g (n, C) f32 -> d_lines (3, sumR, C) f32; scratch of
// nerf_factored_bwd_scratch_bytes(n, sumR, C, bf16) bytes.
int nerf_factored_encode_bwd(const void* pts, const void* lines, const void* gout, void* d_lines,
                             void* scratch, long long n, const int* res, const void* levels, int L,
                             int C, float aabb, float two_aabb, int bf16, void* stream) {
  Geometry g;
  std::vector<int> hoff;
  int rc = init_geometry(&g, &hoff, res, levels, L, C, aabb, two_aabb);
  if (rc != 0) return rc;
  const bool b16 = bf16 != 0;
  WalkTiles wt;
  if (!b16) walk_tiles(g, &wt);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n == 0)
    return static_cast<int>(cudaMemsetAsync(d_lines, 0, 3LL * g.sumR * C * sizeof(float), st));
  int sms = 0;
  rc = sm_count(&sms);
  if (rc != 0) return rc;
  set_staged(&g, staged_levels(g, b16));
  const BwdPlan p = bwd_plan(n, g.sumR, C, b16, sms);
  const float* pt = static_cast<const float*>(pts);
  const float* go = static_cast<const float*>(gout);
  void* dfeat = scratch;
  float* part = reinterpret_cast<float*>(static_cast<unsigned char*>(scratch) +
                                         dfeat_bytes(n, p, b16));
  rc = b16 ? launch_walk_any<true, true>(pt, lines, dfeat, go, p.stride, n, g, st)
           : launch_walk_any<false, true>(pt, lines, dfeat, go, p.stride, n, g, st);
  if (rc != 0) return rc;
  if (b16) {
    const __nv_bfloat16* d = static_cast<const __nv_bfloat16*>(dfeat);
    switch (p.nt) {
      case 1: rc = launch_mma<1>(pt, d, part, n, g, p, st); break;
      case 2: rc = launch_mma<2>(pt, d, part, n, g, p, st); break;
      case 3: rc = launch_mma<3>(pt, d, part, n, g, p, st); break;
      case 4: rc = launch_mma<4>(pt, d, part, n, g, p, st); break;
      case 5: rc = launch_mma<5>(pt, d, part, n, g, p, st); break;
      default: rc = launch_mma<6>(pt, d, part, n, g, p, st); break;
    }
  } else {
    size_t walk_smem = 0;  // the largest tile's
    for (int l = 0; l < g.L;) {
      const int e = group_end(g.hoff, g.L, l, wt.cw);
      walk_smem = std::max(walk_smem, walk_smem_bytes(
          std::min(wt.row_cap, g.hoff[e] - g.hoff[l]), e - l, wt.cw));
      l = e;
    }
    rc = static_cast<int>(cudaFuncSetAttribute(factored_scatter_walk_kernel,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(walk_smem)));
    if (rc != 0) return rc;
    const dim3 grid(static_cast<unsigned>(p.ranges),
                    static_cast<unsigned>(wt.tiles * ((C + wt.cw - 1) / wt.cw)), 3);
    factored_scatter_walk_kernel<<<grid, kWalkThreads, walk_smem, st>>>(
        pt, static_cast<const float*>(dfeat), part, n, p.per, g, wt);
    rc = static_cast<int>(cudaGetLastError());
  }
  if (rc != 0) return rc;
  const unsigned rgrid = static_cast<unsigned>((3LL * g.sumR * C + 255) / 256);
  factored_reduce_kernel<<<rgrid, 256, 0, st>>>(part, static_cast<float*>(d_lines), p.ranges,
                                                g.sumR, C, p.stride);
  return static_cast<int>(cudaGetLastError());
}

const char* nerf_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
