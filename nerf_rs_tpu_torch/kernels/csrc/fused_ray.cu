// Whole-ray NeRF render kernel for Hopper (sm_90a).
//
// Replaces nerf_rs_tpu/kernels/fused_ray.py::_ray_kernel, the Pallas TPU
// kernel, for the paper field (PE, trunk with skip, [feature | sigma]
// head, view head, sigmoid rgb) and alpha compositing. Per ray it reads
// (o, d, viewdir, ts, deltas) and writes rgb, acc, depth and the
// per-sample weights and sigma; per-sample activations never leave the
// SM.
//
// Design. One CTA of 16 warps takes a tile of 128 sample rows, which is
// 128 / S whole rays (2 at S = 64). It expands the points, encodes them
// into a bf16 tile in shared memory, and runs every layer as bf16 x bf16
// -> f32 tensor-core products (mma.sync.m16n8k16). After each layer the
// f32 bias and relu are applied in registers and the result is rounded
// to bf16 into the other of two activation buffers (double buffering: no
// warp overwrites rows another warp still reads). Warps tile the rows
// 4 x 32 and the output columns in chunks of 64. A operands come from
// shared memory through ldmatrix; B operands (weights) from global
// memory, where the ~1.2 MB of bf16 weights stay L2-resident, pre-packed
// by kernels/fused_render.pack_weights so each lane reads its fragment
// as one coalesced 8-byte load. Compositing is one sequential exclusive
// scan per ray in f32: the TPU kernel's triangular-matmul prefix sum
// exists only because Mosaic has no cumsum.
//
// What bounds it. Per sample row the field costs ~1.29 MFLOP of bf16
// products (flops_row in the JAX wrapper) against ~36 B of input per ray
// (0.6 B per row at S = 64): the kernel is compute-bound, and its limit
// is the tensor-core rate. This simple form leaves for later: wgmma
// (mma.sync reaches only part of Hopper's bf16 rate), TMA or cp.async
// staging of the weights in shared memory, persistent CTAs, and a
// parallel scan.
//
// Numerics and traps:
//  * no --use_fast_math and no __sinf/__cosf/__expf: the top PE level is
//    sin(2^9 x), whose phase a low-precision argument or sine destroys
//    (the JAX package lost it once to a bf16 matmul PE). sinf/cosf with
//    ldexpf scales, and expf in compositing.
//  * points are o + t*d with the multiply and add rounded separately
//    (no fused multiply-add), as the plain version computes them.
//  * rows of rays past the end of the batch compute on zero inputs,
//    which gives finite values that are never stored.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kRows = 128;                       // sample rows per CTA
constexpr int kThreads = 512;                    // 16 warps
constexpr int kWarps = kThreads / 32;
constexpr int kRowGroups = 4;                    // warps tile rows 4 ways ...
constexpr int kColGroups = kWarps / kRowGroups;  // ... and column chunks 4 ways
constexpr int kWarpRows = kRows / kRowGroups;    // 32 rows per warp
constexpr int kMT = kWarpRows / 16;              // m16 tiles per warp
constexpr int kChunk = 8;                        // n8 tiles per warp pass (64 columns)
constexpr int kMaxMats = 24;

struct Params {
  const float* o;
  const float* d;
  const float* vd;
  const float* ts;
  const float* deltas;
  const bf16* w;
  const float* b;
  float* rgb;
  float* acc;
  float* depth;
  float* wts;
  float* sigma;
  long long w_off[kMaxMats];  // matrices: trunk[0..n_layers), skip, sf, view, view_dir, rgb
  long long b_off[kMaxMats];  // biases: trunk[0..n_layers), sf, view, rgb
  long long n_rays;
  int S, n_layers, skip, W, F, V, P, D, pos_levels, dir_levels, sigma_act;
  int ldb, ldx, ldd;  // shared-memory row strides in bf16 elements
};

struct SmemLayout {
  size_t buf0, buf1, xs, ds, sig_raw, rgb, ts, dl, w, sg, ray, dpe, total;
};

__host__ __device__ inline size_t take(size_t* at, size_t bytes) {
  const size_t here = *at;
  *at += (bytes + 15) & ~static_cast<size_t>(15);
  return here;
}

__host__ __device__ inline SmemLayout smem_layout(int ldb, int ldx, int ldd, int rays, int D) {
  SmemLayout L;
  size_t at = 0;
  L.buf0 = take(&at, sizeof(bf16) * kRows * ldb);
  L.buf1 = take(&at, sizeof(bf16) * kRows * ldb);
  L.xs = take(&at, sizeof(bf16) * kRows * ldx);
  L.ds = take(&at, sizeof(bf16) * kRows * ldd);
  L.sig_raw = take(&at, sizeof(float) * kRows);
  L.rgb = take(&at, sizeof(float) * kRows * 4);
  L.ts = take(&at, sizeof(float) * kRows);
  L.dl = take(&at, sizeof(float) * kRows);
  L.w = take(&at, sizeof(float) * kRows);
  L.sg = take(&at, sizeof(float) * kRows);
  L.ray = take(&at, sizeof(float) * rays * 9);
  L.dpe = take(&at, sizeof(float) * rays * D);
  L.total = at;
  return L;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
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

typedef float Acc[kMT][kChunk][4];

// acc += A[row0 : row0 + 32, 0 : K] @ Wm[:, 8 nt0 : 8 (nt0 + nts)]
__device__ __forceinline__ void mma_accumulate(Acc& acc, const bf16* A, int lda, int K,
                                               const uint2* Wm, int nt0, int nts, int row0,
                                               int lane) {
  const int KT = K / 16;
  // ldmatrix x4 row addresses: lanes 0-15 rows 0-15 at k, lanes 16-31 rows 0-15 at k + 8
  const bf16* a_row = A + (row0 + (lane & 15)) * lda + (lane >> 4) * 8;
  for (int kt = 0; kt < KT; ++kt) {
    uint32_t a[kMT][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) ldmatrix_x4(a[mt], a_row + mt * 16 * lda + kt * 16);
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      if (j < nts) {
        const uint2 bw = __ldg(Wm + (static_cast<size_t>(nt0 + j) * KT + kt) * 32 + lane);
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) mma_16816(acc[mt][j], a[mt], bw.x, bw.y);
      }
    }
  }
}

// out = epi(A1 @ W1 [+ A2 @ W2]) for the CTA's 128 rows and N columns
template <class Epi>
__device__ __forceinline__ void dense_layer(const bf16* A1, int lda1, int K1, const uint2* W1,
                                            const bf16* A2, int lda2, int K2, const uint2* W2,
                                            int N, const Epi& epi) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = (warp % kRowGroups) * kWarpRows;
  const int g = lane >> 2, t = lane & 3;
  const int NT = N / 8;
  const int chunks = (NT + kChunk - 1) / kChunk;
  for (int ch = warp / kRowGroups; ch < chunks; ch += kColGroups) {
    const int nt0 = ch * kChunk;
    const int nts = min(kChunk, NT - nt0);
    Acc acc;
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int j = 0; j < kChunk; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;
    mma_accumulate(acc, A1, lda1, K1, W1, nt0, nts, row0, lane);
    if (A2 != nullptr) mma_accumulate(acc, A2, lda2, K2, W2, nt0, nts, row0, lane);
    // accumulator fragment: c0, c1 at (row g, cols 2t, 2t + 1); c2, c3 at row g + 8
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        if (j < nts) {
          const int col = (nt0 + j) * 8 + 2 * t;
          const int row = row0 + mt * 16 + g;
          epi(row, col, acc[mt][j][0], acc[mt][j][1]);
          epi(row + 8, col, acc[mt][j][2], acc[mt][j][3]);
        }
      }
  }
}

// hidden layer: bf16(relu(acc + b)) into an activation buffer
struct ReluStore {
  bf16* out;
  int ldo;
  const float* b;
  __device__ void operator()(int r, int c, float v0, float v1) const {
    v0 = fmaxf(v0 + b[c], 0.f);
    v1 = fmaxf(v1 + b[c + 1], 0.f);
    *reinterpret_cast<__nv_bfloat162*>(out + r * ldo + c) = __floats2bfloat162_rn(v0, v1);
  }
};

// [feature | sigma] head: bf16 feature (no activation), f32 raw sigma at column F
struct FeatSigmaStore {
  bf16* feat;
  int ldo;
  const float* b;
  float* sig_raw;
  int F;
  __device__ void operator()(int r, int c, float v0, float v1) const {
    if (c < F) {
      *reinterpret_cast<__nv_bfloat162*>(feat + r * ldo + c) =
          __floats2bfloat162_rn(v0 + b[c], v1 + b[c + 1]);
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

__global__ void __launch_bounds__(kThreads, 1) fused_ray_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int S = p.S;
  const int R = kRows / S;
  const int tid = threadIdx.x;
  const long long ray0 = static_cast<long long>(blockIdx.x) * R;
  const long long left = p.n_rays - ray0;
  const int n_valid = left < R ? static_cast<int>(left) : R;
  const int rows_valid = n_valid * S;

  const SmemLayout L = smem_layout(p.ldb, p.ldx, p.ldd, R, p.D);
  bf16* buf0 = reinterpret_cast<bf16*>(smem + L.buf0);
  bf16* buf1 = reinterpret_cast<bf16*>(smem + L.buf1);
  bf16* xs = reinterpret_cast<bf16*>(smem + L.xs);
  bf16* ds = reinterpret_cast<bf16*>(smem + L.ds);
  float* sig_raw = reinterpret_cast<float*>(smem + L.sig_raw);
  float* rgb_s = reinterpret_cast<float*>(smem + L.rgb);
  float* ts_s = reinterpret_cast<float*>(smem + L.ts);
  float* dl_s = reinterpret_cast<float*>(smem + L.dl);
  float* w_s = reinterpret_cast<float*>(smem + L.w);
  float* sg_s = reinterpret_cast<float*>(smem + L.sg);
  float* ray_s = reinterpret_cast<float*>(smem + L.ray);  // per ray: o, d, viewdir
  float* dpe = reinterpret_cast<float*>(smem + L.dpe);    // per ray: PE(viewdir)

  // ---- inputs; zeros past the last ray ----
  for (int i = tid; i < R * 9; i += kThreads) {
    const int j = i / 9, k = i % 9;
    float v = 0.f;
    if (j < n_valid) {
      const float* src = k < 3 ? p.o : (k < 6 ? p.d : p.vd);
      v = src[(ray0 + j) * 3 + k % 3];
    }
    ray_s[i] = v;
  }
  for (int r = tid; r < kRows; r += kThreads) {
    const bool ok = r < rows_valid;
    ts_s[r] = ok ? p.ts[ray0 * S + r] : 0.f;
    dl_s[r] = ok ? p.deltas[ray0 * S + r] : 0.f;
  }
  __syncthreads();

  // ---- encodings: PE(o + t d) per row, PE(viewdir) once per ray ----
  const int pos_dim = 3 + 6 * p.pos_levels;
  for (int i = tid; i < kRows * p.P; i += kThreads) {
    const int r = i / p.P, c = i % p.P;
    float v = 0.f;
    if (c < pos_dim) {
      const float* ray = ray_s + (r / S) * 9;
      const int dim = c < 3 ? c : (c - 3) % 3;
      v = pe_value(__fadd_rn(ray[dim], __fmul_rn(ts_s[r], ray[3 + dim])), c);
    }
    xs[r * p.ldx + c] = __float2bfloat16_rn(v);
  }
  const int dir_dim = 3 + 6 * p.dir_levels;
  for (int i = tid; i < R * p.D; i += kThreads) {
    const int j = i / p.D, c = i % p.D;
    float v = 0.f;
    if (c < dir_dim) v = pe_value(ray_s[j * 9 + 6 + (c < 3 ? c : (c - 3) % 3)], c);
    dpe[i] = v;
  }
  __syncthreads();
  for (int i = tid; i < kRows * p.D; i += kThreads) {
    const int r = i / p.D, c = i % p.D;
    ds[r * p.ldd + c] = __float2bfloat16_rn(dpe[(r / S) * p.D + c]);
  }
  __syncthreads();

  // ---- trunk ----
  const uint2* skip_w = reinterpret_cast<const uint2*>(p.w + p.w_off[p.n_layers]);
  const bf16* h = xs;
  int ldh = p.ldx, kh = p.P;
  for (int i = 0; i < p.n_layers; ++i) {
    bf16* out = (i & 1) ? buf1 : buf0;
    const bool skip = i == p.skip && i > 0;
    dense_layer(h, ldh, kh, reinterpret_cast<const uint2*>(p.w + p.w_off[i]),
                skip ? xs : nullptr, p.ldx, p.P, skip_w, p.W,
                ReluStore{out, p.ldb, p.b + p.b_off[i]});
    __syncthreads();
    h = out;
    ldh = p.ldb;
    kh = p.W;
  }
  bf16* hbuf = const_cast<bf16*>(h);
  bf16* other = hbuf == buf0 ? buf1 : buf0;
  const int m = p.n_layers;  // w_off[m] is skip; heads follow; b_off[m] is the first head's

  // ---- heads ----
  dense_layer(hbuf, p.ldb, p.W, reinterpret_cast<const uint2*>(p.w + p.w_off[m + 1]),
              nullptr, 0, 0, nullptr, p.F + 8,
              FeatSigmaStore{other, p.ldb, p.b + p.b_off[m], sig_raw, p.F});
  __syncthreads();
  dense_layer(other, p.ldb, p.F, reinterpret_cast<const uint2*>(p.w + p.w_off[m + 2]),
              ds, p.ldd, p.D, reinterpret_cast<const uint2*>(p.w + p.w_off[m + 3]), p.V,
              ReluStore{hbuf, p.ldb, p.b + p.b_off[m + 1]});
  __syncthreads();
  dense_layer(hbuf, p.ldb, p.V, reinterpret_cast<const uint2*>(p.w + p.w_off[m + 4]),
              nullptr, 0, 0, nullptr, 8, RgbStore{rgb_s, p.b + p.b_off[m + 2]});
  __syncthreads();

  // ---- compositing: one sequential exclusive scan per ray, f32 ----
  if (tid < n_valid) {
    float excl = 0.f, cr = 0.f, cg = 0.f, cb = 0.f, acc = 0.f, dep = 0.f;
    for (int s = 0; s < S; ++s) {
      const int r = tid * S + s;
      const float raw = sig_raw[r];
      const float sigma = p.sigma_act == 0
                              ? fmaxf(raw, 0.f)
                              : fmaxf(raw, 0.f) + log1pf(expf(-fabsf(raw)));
      const float a = sigma * dl_s[r];
      const float w = expf(-excl) * (1.f - expf(-a));
      excl += a;
      cr += w * rgb_s[r * 4 + 0];
      cg += w * rgb_s[r * 4 + 1];
      cb += w * rgb_s[r * 4 + 2];
      acc += w;
      dep += w * ts_s[r];
      w_s[r] = w;
      sg_s[r] = sigma;
    }
    const long long ray = ray0 + tid;
    p.rgb[ray * 3 + 0] = cr;
    p.rgb[ray * 3 + 1] = cg;
    p.rgb[ray * 3 + 2] = cb;
    p.acc[ray] = acc;
    p.depth[ray] = dep;
  }
  __syncthreads();
  for (int r = tid; r < rows_valid; r += kThreads) {
    p.wts[ray0 * S + r] = w_s[r];
    p.sigma[ray0 * S + r] = sg_s[r];
  }
}

}  // namespace

extern "C" {

// Returns 0, a cudaError_t from the launch, or a negative code for a
// shape the kernel does not take (see nerf_rs_tpu_torch/kernels/fused_ray.py).
int nerf_fused_ray_render(const void* o, const void* d, const void* vd, const void* ts,
                          const void* deltas, const void* w, const void* b,
                          const long long* w_off, int n_w, const long long* b_off, int n_b,
                          void* rgb, void* acc, void* depth, void* wts, void* sigma,
                          long long n_rays, int S, int depth_l, int skip, int W, int F, int V,
                          int P, int D, int pos_levels, int dir_levels, int sigma_act,
                          void* stream) {
  if (S <= 0 || S > kRows || kRows % S != 0) return -1;
  if (n_w != depth_l + 5 || n_b != depth_l + 3 || n_w > kMaxMats || depth_l < 1) return -2;
  if (W % 16 || F % 16 || V % 16 || P % 16 || D % 16) return -3;
  if (3 + 6 * pos_levels > P || 3 + 6 * dir_levels > D) return -4;
  if (sigma_act != 0 && sigma_act != 1) return -6;

  Params p;
  p.o = static_cast<const float*>(o);
  p.d = static_cast<const float*>(d);
  p.vd = static_cast<const float*>(vd);
  p.ts = static_cast<const float*>(ts);
  p.deltas = static_cast<const float*>(deltas);
  p.w = static_cast<const bf16*>(w);
  p.b = static_cast<const float*>(b);
  p.rgb = static_cast<float*>(rgb);
  p.acc = static_cast<float*>(acc);
  p.depth = static_cast<float*>(depth);
  p.wts = static_cast<float*>(wts);
  p.sigma = static_cast<float*>(sigma);
  for (int i = 0; i < kMaxMats; ++i) {
    p.w_off[i] = i < n_w ? w_off[i] : 0;
    p.b_off[i] = i < n_b ? b_off[i] : 0;
  }
  p.n_rays = n_rays;
  p.S = S;
  p.n_layers = depth_l;
  p.skip = skip;
  p.W = W;
  p.F = F;
  p.V = V;
  p.P = P;
  p.D = D;
  p.pos_levels = pos_levels;
  p.dir_levels = dir_levels;
  p.sigma_act = sigma_act;
  int widest = W > F ? W : F;
  widest = widest > V ? widest : V;
  p.ldb = widest + 8;  // +8 bf16 per row: conflict-free ldmatrix
  p.ldx = P + 8;
  p.ldd = D + 8;

  const int rays = kRows / S;
  const SmemLayout L = smem_layout(p.ldb, p.ldx, p.ldd, rays, D);
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (L.total > static_cast<size_t>(optin)) return -5;
  err = cudaFuncSetAttribute(fused_ray_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(L.total));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_rays == 0) return 0;
  const long long grid = (n_rays + rays - 1) / rays;
  fused_ray_kernel<<<static_cast<unsigned>(grid), kThreads, L.total,
                     static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

const char* nerf_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
