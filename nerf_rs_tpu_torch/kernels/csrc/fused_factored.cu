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
// rate. What limited the first, simple forward was neither: each point
// gathered 6L rows of C values from the line tables in L2 (3.5 KB at the
// defaults, 17x its device-memory bytes). The backward still does (its
// d_feat), and walks its shared-memory table with one thread per (level,
// channel).
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
// Backward design: a private gradient table per CTA. Reruns must give
// identical bits, so no float atomics: at level 0 the whole batch lands on
// the 17 knots of each axis, where atomics would also serialise. A CTA
// owns one axis and a contiguous run of points, and keeps that axis's whole
// (sumR, C) f32 gradient table in shared memory (195 KB at the default
// widths, of the 227 KB a CTA can have). Per chunk of 64 points
// the CTA computes the taps, then d_feat for every (point, channel) from the
// other two axes' features; then thread (level, channel) -- the sole owner
// of that level's rows in that column -- walks the chunk's points in order
// and adds w0 d_feat and w1 d_feat to its two rows. 44 CTAs per axis (132,
// one per SM) write their tables as partials, and a second launch sums the
// partials of each entry in CTA order. The dense W^T G in split partials (the
// train kernel's K2b way) would do 85x the products for the same result.
//
// Numerics, as the JAX kernel's. u, u R, and the weights are computed op by
// op with round-to-nearest intrinsics (an IEEE division, no contraction of
// u R into a later subtraction), so the weights are those of the JAX
// formula bit for bit. A point clipped to u = 1 gives u R = R: k0 is
// clamped to R - 1, so the taps are (R - 1, weight 0) and (R, weight 1) and
// no read passes the level's last knot. Under bf16 the weights and the
// lines (cast by the wrapper) are bf16, each product is exact in f32, and
// the sums are f32; d_feat is rounded to bf16 as the JAX kernel rounds it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxLevels = 16;
constexpr int kFwdThreads = 1024;
constexpr int kFwdTapBytes = 81920;  // two buffers of a forward tile's taps, at most
constexpr int kBwdPoints = 64;    // points per backward chunk
constexpr int kBwdCtas = 44;      // backward CTAs per axis: 3 x 44 = 132, one per SM
constexpr int kBwdThreads = 1024;  // phase A's gathers need many warps in flight
constexpr int kBatch = 4;          // levels whose line loads are in flight together
constexpr size_t kMaxSmem = 232448;  // what one CTA can have on sm_90

struct Geometry {
  int L;
  int C;
  int sumR;
  int res[kMaxLevels];
  int off[kMaxLevels + 1];  // first knot row of each level; off[L] = sumR
  float aabb;
  float two_aabb;
  int staged;  // the forward's levels in shared memory (staged_levels)
};

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

template <bool kBf16>
__device__ __forceinline__ float line_at(const void* lines, long long i) {
  if (kBf16) return __bfloat162float(__ldg(static_cast<const __nv_bfloat16*>(lines) + i));
  return __ldg(static_cast<const float*>(lines) + i);
}

// sum over the L levels of w0 lines[a][row] + w1 lines[a][row + 1], column c,
// level by level in order; each product is exact under bf16. The loads of
// kBatch levels go out together (a level past L re-reads the last one and
// is not summed), so a thread has 2 kBatch gathers in flight.
template <bool kBf16>
__device__ __forceinline__ float axis_feature(const void* lines, int a, const Tap* taps,
                                              const Geometry& g, int c) {
  const long long base = static_cast<long long>(a) * g.sumR * g.C + c;
  float f = 0.f;
  for (int l0 = 0; l0 < g.L; l0 += kBatch) {
    Tap t[kBatch];
    float v0[kBatch], v1[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      t[j] = taps[min(l0 + j, g.L - 1)];
      const long long r = base + static_cast<long long>(t[j].row) * g.C;
      v0[j] = line_at<kBf16>(lines, r);
      v1[j] = line_at<kBf16>(lines, r + g.C);
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      if (l0 + j < g.L) {
        f = __fadd_rn(f, __fmul_rn(t[j].w0, v0[j]));
        f = __fadd_rn(f, __fmul_rn(t[j].w1, v1[j]));
      }
    }
  }
  return f;
}

// taps[(p * 3 + a) * L + l] of the np points from p0, every thread helping
template <bool kBf16>
__device__ __forceinline__ void fill_taps(Tap* taps, const float* __restrict__ pts, long long p0,
                                          int np, const Geometry& g) {
  const int L = g.L;
  for (int t = threadIdx.x; t < np * 3 * L; t += blockDim.x) {
    const int l = t % L;
    const int pa = t / L;  // p * 3 + a
    const float u = unit_coord(pts[p0 * 3 + pa], g);
    taps[t] = make_tap<kBf16>(u, g.res[l], g.off[l]);
  }
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

// The forward's channel group: the widest of 8, 4, 2, 1 that divides C.
int fwd_vec(int C) { return C % 8 == 0 ? 8 : C % 4 == 0 ? 4 : C % 2 == 0 ? 2 : 1; }

// Points a forward CTA takes at once: enough (point, group) items for its
// threads, as far as two buffers of their taps fit kFwdTapBytes.
int fwd_points(const Geometry& g) {
  const int groups = g.C / fwd_vec(g.C);
  const int want = kFwdThreads / groups > 1 ? kFwdThreads / groups : 1;
  const int cap = kFwdTapBytes / (2 * 3 * g.L * static_cast<int>(sizeof(Tap)));
  return want < cap ? want : cap;
}

size_t fwd_tap_bytes(const Geometry& g) { return 2 * sizeof(Tap) * fwd_points(g) * 3 * g.L; }

// Levels [0, staged) of every axis in shared memory, (3, off[staged], C) in
// the call's dtype, then two buffers of the tile's taps.
__host__ __device__ inline size_t fwd_lines_bytes(const Geometry& g, bool bf16) {
  return (size_t{3} * g.off[g.staged] * g.C * (bf16 ? 2 : 4) + 15) / 16 * 16;
}

template <bool kBf16, int V>
__global__ void __launch_bounds__(kFwdThreads, 1) factored_fwd_kernel(
    const float* __restrict__ pts, const void* __restrict__ lines, float* __restrict__ enc,
    long long n, const Geometry g, int P) {
  extern __shared__ __align__(16) unsigned char fwd_smem[];
  const int C = g.C, L = g.L, Ls = g.staged;
  const int S = g.off[Ls];  // staged rows of each axis
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
      for (int l = 0; l < L; ++l) tb[t * L + l] = make_tap<kBf16>(u, g.res[l], g.off[l]);
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
      float e[V];
#pragma unroll
      for (int j = 0; j < V; ++j) e[j] = __fmul_rn(__fmul_rn(f[0][j], f[1][j]), f[2][j]);
      float* dst = enc + (p0 + pl) * C + c0;
      if constexpr (V % 4 == 0) {
#pragma unroll
        for (int j = 0; j < V; j += 4)
          reinterpret_cast<float4*>(dst)[j / 4] = make_float4(e[j], e[j + 1], e[j + 2], e[j + 3]);
      } else if constexpr (V == 2) {
        *reinterpret_cast<float2*>(dst) = make_float2(e[0], e[1]);
      } else {
        dst[0] = e[0];
      }
    }
  }
}

size_t bwd_smem_bytes(const Geometry& g) {
  return sizeof(float) * static_cast<size_t>(g.sumR) * g.C
         + sizeof(Tap) * kBwdPoints * 3 * g.L + sizeof(float) * kBwdPoints * g.C;
}

// CTA (b, a): axis a's gradient over chunks [b * per, (b + 1) * per) of 64
// points, into partials[a][b] (sumR, C).
template <bool kBf16>
__global__ void __launch_bounds__(kBwdThreads, 1) factored_bwd_kernel(
    const float* __restrict__ pts, const void* __restrict__ lines, const float* __restrict__ gout,
    float* __restrict__ partials, long long n, int per, const Geometry g) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int L = g.L, C = g.C;
  const int RC = g.sumR * C;
  float* table = reinterpret_cast<float*>(smem);
  Tap* taps = reinterpret_cast<Tap*>(table + RC);
  float* dfeat = reinterpret_cast<float*>(taps + kBwdPoints * 3 * L);
  const int a = blockIdx.y;
  const int ob = a == 0 ? 1 : 0;  // the other two axes, in the JAX kernel's order
  const int oc = a == 2 ? 1 : 2;
  const int tid = threadIdx.x;
  const bool owner = tid < L * C;  // thread (l, c) owns level l's rows of column c
  const int own_l = tid / C, own_c = tid % C;

  for (int i = tid; i < RC; i += blockDim.x) table[i] = 0.f;
  for (int k = 0; k < per; ++k) {
    const long long p0 = (static_cast<long long>(blockIdx.x) * per + k) * kBwdPoints;
    if (p0 >= n) break;  // the same for the whole CTA
    const int np = static_cast<int>(min(static_cast<long long>(kBwdPoints), n - p0));
    __syncthreads();  // the last chunk's taps and d_feat are consumed
    fill_taps<kBf16>(taps, pts, p0, np, g);
    __syncthreads();
    for (int t = tid; t < np * C; t += blockDim.x) {
      const int p = t / C;
      const int c = t % C;
      const Tap* tp = taps + p * 3 * L;
      const float fb = axis_feature<kBf16>(lines, ob, tp + ob * L, g, c);
      const float fc = axis_feature<kBf16>(lines, oc, tp + oc * L, g, c);
      float d = __fmul_rn(__fmul_rn(gout[(p0 + p) * C + c], fb), fc);
      if (kBf16) d = round_bf16(d);
      dfeat[t] = d;
    }
    __syncthreads();
    if (owner) {
      for (int p = 0; p < np; ++p) {
        const Tap t = taps[(p * 3 + a) * L + own_l];
        const float d = dfeat[p * C + own_c];
        float* row = table + t.row * C + own_c;
        row[0] = __fadd_rn(row[0], __fmul_rn(t.w0, d));
        row[C] = __fadd_rn(row[C], __fmul_rn(t.w1, d));
      }
    }
  }
  __syncthreads();
  float* out = partials + (static_cast<long long>(a) * gridDim.x + blockIdx.x) * RC;
  for (int i = tid; i < RC; i += blockDim.x) out[i] = table[i];
}

// d_lines[a][i] = sum over b, in order, of partials[a][b][i]
__global__ void factored_reduce_kernel(const float* __restrict__ partials,
                                       float* __restrict__ d_lines, int ctas, int RC) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= 3LL * RC) return;
  const long long a = i / RC;
  const float* src = partials + a * ctas * RC + (i - a * RC);
  float s = 0.f;
  for (int b = 0; b < ctas; ++b) s = __fadd_rn(s, src[static_cast<long long>(b) * RC]);
  d_lines[i] = s;
}

int init_geometry(Geometry* g, const int* res, int L, int C, float aabb, float two_aabb) {
  if (L < 1 || L > kMaxLevels) return -2;
  if (L * C > kBwdThreads) return -3;
  g->L = L;
  g->C = C;
  g->aabb = aabb;
  g->two_aabb = two_aabb;
  int off = 0;
  for (int l = 0; l < L; ++l) {
    if (res[l] < 1) return -4;
    g->res[l] = res[l];
    g->off[l] = off;
    off += res[l] + 1;
  }
  g->off[L] = off;
  g->sumR = off;
  g->staged = 0;
  return 0;
}

// The most levels, from level 0, whose rows of all three axes fit one CTA's
// shared memory in the call's dtype (nerf_factored_fwd_staged_levels reports it).
int staged_levels(const Geometry& g, bool bf16) {
  const long long budget = static_cast<long long>(kMaxSmem - fwd_tap_bytes(g)) - 15;
  int s = 0;
  while (s < g.L && 3LL * g.off[s + 1] * g.C * (bf16 ? 2 : 4) <= budget) ++s;
  return s;
}

template <bool kBf16, int V>
int launch_fwd(const float* pts, const void* lines, float* enc, long long n, const Geometry& g,
               cudaStream_t st) {
  const size_t smem = fwd_lines_bytes(g, kBf16) + fwd_tap_bytes(g);
  const int P = fwd_points(g);
  // the CTAs the card holds at once, asked once per device and shared
  // memory size (a call's host time is on the card's critical path)
  static int known_dev = -1, known_cap = 0;
  static size_t known_smem = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev != known_dev || smem != known_smem) {
    int sms = 132, resident = 1;
    err = cudaFuncSetAttribute(factored_fwd_kernel<kBf16, V>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, factored_fwd_kernel<kBf16, V>,
                                                          kFwdThreads, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    known_dev = dev;
    known_smem = smem;
    known_cap = sms * (resident > 0 ? resident : 1);
  }
  const long long want = (n + P - 1) / P;
  const long long cap = known_cap;
  const unsigned grid = static_cast<unsigned>(want < cap ? want : cap);
  factored_fwd_kernel<kBf16, V><<<grid, kFwdThreads, smem, st>>>(pts, lines, enc, n, g, P);
  return static_cast<int>(cudaGetLastError());
}

template <bool kBf16>
int launch_fwd_any(const float* pts, const void* lines, float* enc, long long n, const Geometry& g,
               cudaStream_t st) {
  if (fwd_vec(g.C) == 8) return launch_fwd<kBf16, 8>(pts, lines, enc, n, g, st);
  if (fwd_vec(g.C) == 4) return launch_fwd<kBf16, 4>(pts, lines, enc, n, g, st);
  if (fwd_vec(g.C) == 2) return launch_fwd<kBf16, 2>(pts, lines, enc, n, g, st);
  return launch_fwd<kBf16, 1>(pts, lines, enc, n, g, st);
}

// (CTAs per axis, chunks per CTA) of the backward over n points
void bwd_grid(long long n, int* ctas, int* per) {
  const long long chunks = (n + kBwdPoints - 1) / kBwdPoints;
  const long long c = chunks < kBwdCtas ? chunks : kBwdCtas;
  *per = c > 0 ? static_cast<int>((chunks + c - 1) / c) : 0;
  *ctas = *per > 0 ? static_cast<int>((chunks + *per - 1) / *per) : 0;
}

}  // namespace

extern "C" {

// Returns 0, a cudaError_t from the launch, or a negative code for a shape
// the kernel does not take (see nerf_rs_tpu_torch/kernels/fused_factored.py).
// pts (n, 3) f32; lines (3, sumR, C), bf16 with bf16 = 1, else f32; enc (n, C) f32.
int nerf_factored_encode_fwd(const void* pts, const void* lines, void* enc, long long n,
                             const int* res, int L, int C, float aabb, float two_aabb, int bf16,
                             void* stream) {
  Geometry g;
  const int rc = init_geometry(&g, res, L, C, aabb, two_aabb);
  if (rc != 0) return rc;
  if (n == 0) return 0;
  g.staged = staged_levels(g, bf16 != 0);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* p = static_cast<const float*>(pts);
  float* e = static_cast<float*>(enc);
  return bf16 ? launch_fwd_any<true>(p, lines, e, n, g, st)
              : launch_fwd_any<false>(p, lines, e, n, g, st);
}

// The forward's levels in shared memory (staged_levels) for this geometry.
int nerf_factored_fwd_staged_levels(const int* res, int L, int C, int bf16) {
  Geometry g;
  const int rc = init_geometry(&g, res, L, C, 1.f, 2.f);
  return rc != 0 ? rc : staged_levels(g, bf16 != 0);
}

// Bytes of the backward's partial tables for n points.
long long nerf_factored_bwd_scratch_bytes(long long n, int sumR, int C) {
  int ctas, per;
  bwd_grid(n, &ctas, &per);
  return 3LL * ctas * sumR * C * static_cast<long long>(sizeof(float));
}

// g (n, C) f32 -> d_lines (3, sumR, C) f32; scratch of
// nerf_factored_bwd_scratch_bytes(n, sumR, C) bytes.
int nerf_factored_encode_bwd(const void* pts, const void* lines, const void* gout, void* d_lines,
                             void* scratch, long long n, const int* res, int L, int C, float aabb,
                             float two_aabb, int bf16, void* stream) {
  Geometry g;
  int rc = init_geometry(&g, res, L, C, aabb, two_aabb);
  if (rc != 0) return rc;
  const size_t smem = bwd_smem_bytes(g);
  if (smem > kMaxSmem) return -1;
  rc = static_cast<int>(bf16 ? cudaFuncSetAttribute(factored_bwd_kernel<true>,
                                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                    static_cast<int>(smem))
                             : cudaFuncSetAttribute(factored_bwd_kernel<false>,
                                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                    static_cast<int>(smem)));
  if (rc != 0) return rc;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int RC = g.sumR * C;
  if (n == 0) return static_cast<int>(cudaMemsetAsync(d_lines, 0, 3LL * RC * sizeof(float), st));
  int ctas, per;
  bwd_grid(n, &ctas, &per);
  const dim3 grid(static_cast<unsigned>(ctas), 3);
  const float* p = static_cast<const float*>(pts);
  const float* go = static_cast<const float*>(gout);
  float* part = static_cast<float*>(scratch);
  if (bf16)
    factored_bwd_kernel<true><<<grid, kBwdThreads, smem, st>>>(p, lines, go, part, n, per, g);
  else
    factored_bwd_kernel<false><<<grid, kBwdThreads, smem, st>>>(p, lines, go, part, n, per, g);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  const unsigned rgrid = static_cast<unsigned>((3LL * RC + 255) / 256);
  factored_reduce_kernel<<<rgrid, 256, 0, st>>>(part, static_cast<float*>(d_lines), ctas, RC);
  return static_cast<int>(cudaGetLastError());
}

const char* nerf_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
