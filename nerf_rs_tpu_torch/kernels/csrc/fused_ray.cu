// Whole-ray NeRF render kernel for Hopper (sm_90a), K1.
//
// Replaces nerf_rs_tpu/kernels/fused_ray.py::_ray_kernel, the Pallas TPU
// kernel, for the paper field (PE or mip-NeRF's IPE, trunk with skip,
// [feature | sigma] head, view head, sigmoid rgb) and alpha compositing.
// Per ray it reads (o, d, viewdir, ts, deltas, and with IPE the cone
// radius) and writes rgb, acc, depth and the per-sample weights and
// sigma; per-sample activations never leave the SM.
//
// Design. One CTA of 16 warps takes the sample rows of whole rays -- 128 /
// S rays when S divides 128 (2 at S = 64), two rays of S = 192 in three
// 128-row passes, or one ray of S = 256 in two -- and runs the field on
// each 128-row pass with the shared tensor-core machinery of field.cuh
// (mma.sync.m16n8k16, bf16 operands, f32 sums, epilogues in registers,
// weights in a fragment-native packing streamed through a cp.async ring
// in shared memory). Compositing is one sequential exclusive scan
// per ray in f32, after every pass: the TPU kernel's triangular-matmul
// prefix sum exists only because Mosaic has no cumsum.
//
// IPE (cfg.ipe). ts are interval midpoints and deltas exact lengths; per
// row the kernel forms the conical frustum's Gaussian (ipe_moments) and
// encodes it as sin / cos damped by exp(-4^l var / 2) (ipe_value), in the
// PE's column layout, so the packed weights and the trunk are the same.
// It adds ~40 scalar operations (five divisions) per row and one expf per
// encoded column: noise beside the ~1.3 MFLOP of products per row.
//
// Contraction (cfg.contract, mip-NeRF 360's unbounded scenes; the TPU
// kernel's contract branch, fused_ray.py:95-105). Each row's point, or its
// IPE Gaussian, is contracted into the radius-2 ball before the encoding
// (field.cuh's contract_points / contract_gaussian): ~20 scalar operations
// and one sqrt per row, elementwise work that changes no bound. It is a
// template parameter like the pass count, so the instances without it are
// the kernels they were.
//
// Long rays. The wrapper (kernels/fused_ray.py) pads S with zero-length
// intervals at the far end to a power of two up to 128, to 192 for 129 to
// 192 samples, else to 256: such an interval has a = sigma * 0 = 0, so its
// weight is exactly 0 and the real samples' outputs are unchanged. S = 192
// (the hierarchical union pass) runs unpadded, two rays per CTA, their
// 384 rows in three passes (the second pass holds the end of one ray and
// the start of the other); 193 (the record preset) still pads to 256.
//
// What bounds it. Per sample row the field costs ~1.29 MFLOP of bf16
// products (flops_row in the JAX wrapper) against ~36 B of input per ray
// (0.6 B per row at S = 64): the kernel is compute-bound, and its limit
// is the tensor-core rate. Left for later: wgmma (mma.sync reaches only
// part of Hopper's bf16 rate, and its 32 x 64 warp tiles read 3 KB of
// operands per k-step from shared memory), persistent CTAs, and a
// parallel scan.
//
// Numerics and traps: see field.cuh (no fast math, sinf/cosf with exact
// ldexpf scales, o + t*d without FMA, IPE moments rounded op by op); expf
// in compositing. Rows of rays past the end of the batch compute on zero
// inputs, which gives finite values that are never stored.

#include "field.cuh"

namespace {

using namespace nerf;

struct Params {
  Field f;
  float* rgb;
  float* acc;
  float* depth;
  float* wts;
  float* sigma;
};

// kPasses: 128-row passes per CTA, 1 (S divides 128), 2 (S = 256) or 3
// (S = 192). A compile-time count, so the one-pass kernel inlines the
// field once: with a second inlined call, or a loop around it, nvcc keeps
// less of it in registers and the kernel runs up to 1.8x slower.
// kContract: the contraction branch.
template <int kPasses, bool kContract>
__global__ void __launch_bounds__(kThreads, 1) fused_ray_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Field& f = p.f;
  const int S = f.S;
  const int R = f.R;
  const int tid = threadIdx.x;
  const long long ray0 = static_cast<long long>(blockIdx.x) * R;
  const long long left = f.n_rays - ray0;
  const int n_valid = left < R ? static_cast<int>(left) : R;
  const int rows_valid = n_valid * S;

  const Tile t = carve(smem, smem_layout(f, false));
  bf16* hv;
  bf16* feat;
  field_forward<kContract>(f, t, ray0, n_valid, 0, Stash{}, &hv, &feat);
  if (kPasses >= 2) field_forward<kContract>(f, t, ray0, n_valid, kRows, Stash{}, &hv, &feat);
  if (kPasses >= 3)
    field_forward<kContract>(f, t, ray0, n_valid, 2 * kRows, Stash{}, &hv, &feat);

  // ---- compositing: one sequential exclusive scan per ray, f32 ----
  if (tid < n_valid) {
    float excl = 0.f, cr = 0.f, cg = 0.f, cb = 0.f, acc = 0.f, dep = 0.f;
    for (int s = 0; s < S; ++s) {
      const int r = tid * S + s;
      const float raw = t.sig_raw[r];
      const float sigma = f.sigma_act == 0
                              ? fmaxf(raw, 0.f)
                              : fmaxf(raw, 0.f) + log1pf(expf(-fabsf(raw)));
      const float a = sigma * t.dl[r];
      const float w = expf(-excl) * (1.f - expf(-a));
      excl += a;
      cr += w * t.rgb[r * 4 + 0];
      cg += w * t.rgb[r * 4 + 1];
      cb += w * t.rgb[r * 4 + 2];
      acc += w;
      dep += w * t.ts[r];
      t.w[r] = w;
      t.sg[r] = sigma;
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
    p.wts[ray0 * S + r] = t.w[r];
    p.sigma[ray0 * S + r] = t.sg[r];
  }
}

}  // namespace

extern "C" {

// Returns 0, a cudaError_t from the launch, or a negative code for a
// shape the kernel does not take (see nerf_rs_tpu_torch/kernels/fused_ray.py).
// radii: (n_rays,) f32 with ipe = 1, else null. contract: 0 or 1.
int nerf_fused_ray_render(const void* o, const void* d, const void* vd, const void* ts,
                          const void* deltas, const void* radii, const void* w, const void* b,
                          const long long* w_off, int n_w, const long long* b_off, int n_b,
                          void* rgb, void* acc, void* depth, void* wts, void* sigma,
                          long long n_rays, int S, int depth_l, int skip, int W, int F, int V,
                          int P, int D, int pos_levels, int dir_levels, int sigma_act, int ipe,
                          int contract, void* stream) {
  Params p;
  int rc = init_field(&p.f, o, d, vd, ts, deltas, radii, w, b, w_off, n_w, b_off, n_b, n_rays,
                      S, depth_l, skip, W, F, V, P, D, pos_levels, dir_levels, sigma_act, ipe);
  if (rc != 0) return rc;
  if (contract != 0 && contract != 1) return -8;
  p.rgb = static_cast<float*>(rgb);
  p.acc = static_cast<float*>(acc);
  p.depth = static_cast<float*>(depth);
  p.wts = static_cast<float*>(wts);
  p.sigma = static_cast<float*>(sigma);

  const size_t smem = smem_layout(p.f, false).total;
  const int passes = p.f.rows / kRows;
  auto kernel = passes == 3 ? (contract ? fused_ray_kernel<3, true> : fused_ray_kernel<3, false>)
                : passes == 2 ? (contract ? fused_ray_kernel<2, true> : fused_ray_kernel<2, false>)
                              : (contract ? fused_ray_kernel<1, true> : fused_ray_kernel<1, false>);
  rc = set_smem(kernel, smem);
  if (rc != 0) return rc;
  if (n_rays == 0) return 0;
  const int rays = p.f.R;
  const unsigned grid = static_cast<unsigned>((n_rays + rays - 1) / rays);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

const char* nerf_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
