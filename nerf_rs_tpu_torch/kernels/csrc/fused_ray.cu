// Whole-ray NeRF render kernel for Hopper (sm_90a), K1.
//
// Replaces nerf_rs_tpu/kernels/fused_ray.py::_ray_kernel, the Pallas TPU
// kernel, for the paper field (PE, trunk with skip, [feature | sigma]
// head, view head, sigmoid rgb) and alpha compositing. Per ray it reads
// (o, d, viewdir, ts, deltas) and writes rgb, acc, depth and the
// per-sample weights and sigma; per-sample activations never leave the
// SM.
//
// Design. One CTA of 16 warps takes a tile of 128 sample rows, which is
// 128 / S whole rays (2 at S = 64), and runs the field on it with the
// shared tensor-core machinery of field.cuh (mma.sync.m16n8k16, bf16
// operands, f32 sums, epilogues in registers, weights L2-resident in a
// fragment-native packing). Compositing is one sequential exclusive scan
// per ray in f32: the TPU kernel's triangular-matmul prefix sum exists
// only because Mosaic has no cumsum.
//
// What bounds it. Per sample row the field costs ~1.29 MFLOP of bf16
// products (flops_row in the JAX wrapper) against ~36 B of input per ray
// (0.6 B per row at S = 64): the kernel is compute-bound, and its limit
// is the tensor-core rate. This simple form leaves for later: wgmma
// (mma.sync reaches only part of Hopper's bf16 rate), TMA or cp.async
// staging of the weights in shared memory, persistent CTAs, and a
// parallel scan.
//
// Numerics and traps: see field.cuh (no fast math, sinf/cosf with exact
// ldexpf scales, o + t*d without FMA); expf in compositing. Rows of rays
// past the end of the batch compute on zero inputs, which gives finite
// values that are never stored.

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

__global__ void __launch_bounds__(kThreads, 1) fused_ray_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Field& f = p.f;
  const int S = f.S;
  const int R = kRows / S;
  const int tid = threadIdx.x;
  const long long ray0 = static_cast<long long>(blockIdx.x) * R;
  const long long left = f.n_rays - ray0;
  const int n_valid = left < R ? static_cast<int>(left) : R;
  const int rows_valid = n_valid * S;

  const Tile t = carve(smem, smem_layout(f, false));
  bf16* hv;
  bf16* feat;
  field_forward(f, t, ray0, n_valid, Stash{}, &hv, &feat);

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
int nerf_fused_ray_render(const void* o, const void* d, const void* vd, const void* ts,
                          const void* deltas, const void* w, const void* b,
                          const long long* w_off, int n_w, const long long* b_off, int n_b,
                          void* rgb, void* acc, void* depth, void* wts, void* sigma,
                          long long n_rays, int S, int depth_l, int skip, int W, int F, int V,
                          int P, int D, int pos_levels, int dir_levels, int sigma_act,
                          void* stream) {
  Params p;
  int rc = init_field(&p.f, o, d, vd, ts, deltas, w, b, w_off, n_w, b_off, n_b, n_rays, S,
                      depth_l, skip, W, F, V, P, D, pos_levels, dir_levels, sigma_act);
  if (rc != 0) return rc;
  p.rgb = static_cast<float*>(rgb);
  p.acc = static_cast<float*>(acc);
  p.depth = static_cast<float*>(depth);
  p.wts = static_cast<float*>(wts);
  p.sigma = static_cast<float*>(sigma);

  const size_t smem = smem_layout(p.f, false).total;
  rc = set_smem(fused_ray_kernel, smem);
  if (rc != 0) return rc;
  if (n_rays == 0) return 0;
  const int rays = kRows / S;
  const long long grid = (n_rays + rays - 1) / rays;
  fused_ray_kernel<<<static_cast<unsigned>(grid), kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

const char* nerf_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
