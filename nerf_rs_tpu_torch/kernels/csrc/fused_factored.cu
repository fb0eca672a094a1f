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
// rate. What limits this simple form is neither: the line tables (292 KB in
// bf16) stay in L2, and each point gathers 6L rows of C values from there
// (3.5 KB at the defaults, 17x its device-memory bytes), as does the
// backward's d_feat; the backward then walks its shared-memory table with
// one thread per (level, channel). Staging the coarse levels in shared
// memory, and more owners per table, are the next steps.
//
// Forward design. One CTA of 256 threads takes 64 points. It first
// computes each (point, axis, level)'s tap -- the knot row and its two
// weights -- into shared memory, then each thread takes (point, channel)
// pairs: 6L loads and products, the CP product, one f32 store. Neighbouring
// threads take neighbouring channels of one point, so the line loads and
// the encoding's stores are coalesced.
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
constexpr int kFwdThreads = 256;
constexpr int kFwdPoints = 64;    // points per forward CTA
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
  int off[kMaxLevels];  // first knot row of each level
  float aabb;
  float two_aabb;
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

template <bool kBf16>
__global__ void __launch_bounds__(kFwdThreads) factored_fwd_kernel(
    const float* __restrict__ pts, const void* __restrict__ lines, float* __restrict__ enc,
    long long n, const Geometry g) {
  __shared__ Tap taps[kFwdPoints * 3 * kMaxLevels];
  const long long p0 = static_cast<long long>(blockIdx.x) * kFwdPoints;
  const int np = static_cast<int>(min(static_cast<long long>(kFwdPoints), n - p0));
  fill_taps<kBf16>(taps, pts, p0, np, g);
  __syncthreads();
  const int C = g.C;
  for (int t = threadIdx.x; t < np * C; t += blockDim.x) {
    const int p = t / C;
    const int c = t % C;
    const Tap* tp = taps + p * 3 * g.L;
    const float x = axis_feature<kBf16>(lines, 0, tp, g, c);
    const float y = axis_feature<kBf16>(lines, 1, tp + g.L, g, c);
    const float z = axis_feature<kBf16>(lines, 2, tp + 2 * g.L, g, c);
    enc[(p0 + p) * C + c] = __fmul_rn(__fmul_rn(x, y), z);
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
  g->sumR = off;
  return 0;
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
  const unsigned grid = static_cast<unsigned>((n + kFwdPoints - 1) / kFwdPoints);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* p = static_cast<const float*>(pts);
  float* e = static_cast<float*>(enc);
  if (bf16)
    factored_fwd_kernel<true><<<grid, kFwdThreads, 0, st>>>(p, lines, e, n, g);
  else
    factored_fwd_kernel<false><<<grid, kFwdThreads, 0, st>>>(p, lines, e, n, g);
  return static_cast<int>(cudaGetLastError());
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
