// Whole-ray NeRF training kernel for Hopper (sm_90a), K2: one fused
// forward + backward of the paper field over a batch of whole rays.
//
// Replaces nerf_rs_tpu/kernels/fused_train.py::_train_kernel, the Pallas
// TPU kernel, for PE and mip-NeRF's IPE, each with or without mip-NeRF
// 360's contraction and distortion loss, with relu or softplus sigma. Per
// ray it reads (o, d, viewdir, ts, deltas, gold, and with IPE the cone
// radius) and writes diag = [r, g, b, acc, sqerr, dist, 0, 0] and the
// compositing weights; over the whole call it writes the f32 gradient of
// loss = mean over rays and channels of (C - gold)^2, plus dist_weight x
// the mean per-ray distortion loss when that is on, for every packed
// matrix and bias.
//
// Contraction and the distortion loss (the TPU kernel's branches at
// fused_train.py:183-199, :276-311 and :329-334). The contraction is K1's
// (field.cuh), forward only: positions carry no gradient. The distortion
// loss needs sums over the whole ray, so it lives in the per-ray scans that
// already run after every pass's forward (at S = 256 both passes): with m
// the sample's s-coordinate and dn its s-space length, the forward scan
// takes the inclusive prefix sums cw of w and cwm of w m and forms
//   A_i = m_i (2 cw_i - acc) + sum(w m) - 2 cwm_i,
// writes the per-ray loss sum_i w_i A_i + w_i^2 dn_i / 3 to diag slot 5 and
// keeps A_i in the dsigma column until the backward scan reads it; the
// backward scan adds dist_scale (2 A_i + (2/3) w_i dn_i) to the compositing
// cotangent u before the existing VJP. s is linear, (t - near) / (far -
// near), or disparity, (1/near - 1/t) / (1/near - 1/far); under IPE the
// interval's s-length is exact, dt / ((mid - dt/2)(mid + dt/2)). The pads'
// repeated t keeps 1/t finite, and their w = 0 and dn = 0 add nothing. The
// scans run a warp per ray: the distortion adds ~15 scalar operations per
// sample row to them.
//
// Rays and passes. A tile is whole rays (field.cuh rays_per_cta): 128 / S
// of them in one 128-row pass up to S = 128, two of S = 192 in three passes
// (the wrapper pads 129-192 to 192), one of S = 256 in two (193-256), one of
// any longer S, a multiple of 128, in S / 128 passes. A ray's compositing VJP
// needs the whole ray (the suffix sums of u_i w_i need the final colour), so
// K2a runs every pass's forward, then the per-ray scans, then each pass's
// backward. Zero-length pad intervals have w = 0 and d sigma = da * 0 = 0,
// so every gradient row they give is exactly 0. The wrapper
// (kernels/fused_train.fused_train_grads) launches K2 over blocks of at most
// 1,048,576 padded rows (4096 rays x 256 samples, ~11 GB of stashes at paper
// width) and sums the blocks' gradients in order.
//
// Why two kernels. The TPU kernel keeps a ray block's activations and the
// dW accumulators in VMEM (120 MB). An H100 SM has 227 KB of shared
// memory: at flagship width a 128-row tile's 8 x 128 x 256 bf16 post-relu
// activations are 512 KB, and the dW accumulators ~600 k f32 (2.4 MB).
// Neither fits on chip, so:
//  * K2a computes the forward, the loss and every layer's input gradient,
//    and leaves each product's A operand (x, h_0..h_{L-1}, feat, hv, PE(d))
//    and output gradient (G_l, [dfeat | dsigma], g_hv, d rgb_raw) in global
//    stashes, with every relu's mask as bits. Its instances, chosen in C by
//    shape (train_mode, reported by fused_train.route):
//     - narrow (fields up to kNarrowWidth = 256, the presets' route):
//       train_narrow_kernel, then train_narrow_bwd_kernel, on wgmma with
//       the act block in 128-byte-swizzled panels, four tiles a cluster
//       sharing each weight slot, TMA stores of every product's output to
//       its stash (the narrow section below);
//     - cluster (wider fields, fault 13; field_cluster.cuh): a row
//       group of ceil(width / 256) CTAs of a cluster a tile, each holding
//       its 256 columns of every layer in shared memory;
//     - mma.sync wide (past 2,048 wide, or encodings no wgmma layout holds):
//       train_wide_kernel, every activation in its stash (field_forward_wide).
//    Each scans a warp per ray (scan_rays_warp) over the per-sample values
//    (raw sigma, rgb, ts, deltas, w, T, d sigma: 40 B a row in the scratch;
//    the narrow forward keeps them in shared memory while it runs).
//  * K2b (dw_wgmma_kernel, the K2b section below): dW_l = A_l^T G_l as a
//    reduction over rows on Hopper's TMA, clusters and wgmma, for every
//    K2a route: a cluster of CTAs a G block, each owning 128 rows of dW,
//    reads each stash byte once per split (its A columns into its own
//    ring, G's panels multicast to the cluster), the bias sums db_l =
//    sum_rows G_l from the same slots; per-split f32 partials that
//    reduce_kernel sums in a fixed order. No float atomics: two calls on
//    the same inputs give bit-identical gradients.
// At flagship size (4096 rays x 64 samples) the stashes are ~5 KB per
// sample row each way, ~2.7 GB per call with the partials, on an 80 GB
// card; the hierarchical union pass (4096 x 192 rows) takes ~8.3 GB.
//
// What bounds each. K2a's products (the forward, then the input gradients:
// ~2.3 MFLOP a sample row at paper width) and its stashes (~10 KB a row)
// are about equal on an H100: at the flagship shape ~0.61 ms of bf16
// operations and ~0.80 ms of bytes. K2b is bound by reading the stashes
// once (2.61 GB at the flagship shape, >= 0.78 ms at 3.35 TB/s, beside
// ~0.32 ms of products).
//
// The matrices' and biases' offsets, and the transposed matrices', lie in
// device tables built once per layout by the wrapper (Field::off,
// TrainParams::wt_off), not in the launch parameters, and K2b's jobs in a
// host vector: a field of any depth launches. The first kParamOffs of each
// also ride in the parameters (Field::w_head, b_head, TrainParams::wt_head).
//
// Numerics, mirrored by kernels/fused_train.fused_train_grads_reference:
// bf16 operands with f32 products and sums; compositing, the loss and
// both scans in f32 with expf; no fast math (sinf/cosf PE, see field.cuh).
// Rounded to bf16 as in the TPU kernel: d rgb_raw = w dC rgb (1 - rgb);
// g_hv = (d rgb_raw @ rgb_w^T) [hv > 0]; dfeat (for d feat_w and dh); d
// sigma (its selector matmul ran at bf16); every trunk layer's
// g = dh [h_l > 0]. d feat_b sums dfeat in f32, computed here as
// view_w @ (sum_rows g_hv), the same sum in another association.

#include <cudaTypedefs.h>

#include <algorithm>
#include <vector>

#include "field.cuh"
#include "field_cluster.cuh"

namespace {

using namespace nerf;

struct TrainParams {
  Field f;
  const float* gold;
  const bf16* wt;              // transposed matrices, packed like f.w
  const long long* wt_off;     // device: trunk[1..L)^T at [0, L - 1), then feat^T, view^T, rgb^T
  long long wt_head[kParamOffs];  // its first kParamOffs, again in the parameters
  const float* sigma_row;      // (W,) the sigma head's column
  float* diag;                 // (N, 8)
  float* wts;                  // (N, S)
  long long rows_pad;          // rows of every stash: whole tiles
  bf16* sx;                    // A stashes: PE(x) (P), h_l (W each), feat (F), hv (V), PE(d) (D)
  bf16* sh;
  bf16* sfeat;
  bf16* shv;
  bf16* sdv;
  bf16* gh;                    // G stashes: G_l (W each), [dfeat | dsigma | 0] (F + 8), g_hv (V),
  bf16* gsf;                   // d rgb_raw (8)
  bf16* ghv;
  bf16* grgb;
  uint32_t* mask;              // relu bits: (n_layers + 1) x rows_pad x mw words, bit j of
                               // word w of a row: column 32 w + j > 0; hv at layer n_layers
  int mw;
  float* vals;                 // per-sample values, kVals arrays of rows_pad (ValOff)
  float loss_scale;            // d loss / d (sum of squared residuals) = 1 / (3 N)
  int white_bg;
  float dist_scale;            // distortion-loss weight / N rays; 0: off
  float dist_a, dist_b;        // linear: near, 1 / (far - near); disparity: 1 / near, 1 / (1/near - 1/far)
  int dist_disparity;          // 1: s in disparity
};

// Transposed matrix i's offset into wt: from the parameters for the first
// kParamOffs, else from the device table through the read-only path.
__device__ __forceinline__ long long wt_at(const TrainParams& p, int i) {
  return i < kParamOffs ? p.wt_head[i] : __ldg(p.wt_off + i);
}

// The distortion loss's s-coordinate m and s-space length dn of the sample
// (t, dt): t is a point sample whose interval runs to t + dt, or with IPE
// the midpoint of an interval of length dt
__device__ __forceinline__ void dist_coords(const TrainParams& p, float t, float dt, float* m,
                                            float* dn) {
  if (p.dist_disparity) {
    *m = (p.dist_a - 1.f / t) * p.dist_b;
    const float den = p.f.ipe ? (t - 0.5f * dt) * (t + 0.5f * dt) : t * (t + dt);
    *dn = dt / den * p.dist_b;
  } else {
    *m = (t - p.dist_a) * p.dist_b;
    *dn = dt * p.dist_b;
  }
}

// g = bf16((acc [+ dsig[r] sigma_row[c]]) * [act > 0]) into the next
// product's A buffer; [act > 0] is the forward's relu bit (c is even, so
// c and c + 1 share a word)
struct GradStore {
  bf16* out;
  int ldo;
  const uint32_t* mask;  // this layer's bits from the pass's first row, mw words a row
  int mw;
  const float* dsig;
  const float* srow;
  __device__ void operator()(int r, int c, float v0, float v1) const {
    if (dsig != nullptr) {
      v0 = __fadd_rn(v0, __fmul_rn(dsig[r], srow[c]));
      v1 = __fadd_rn(v1, __fmul_rn(dsig[r], srow[c + 1]));
    }
    const uint32_t bits = mask[r * mw + (c >> 5)] >> (c & 31);
    v0 = (bits & 1u) ? v0 : 0.f;
    v1 = (bits & 2u) ? v1 : 0.f;
    store_pair(out + r * ldo + c, __floats2bfloat162_rn(v0, v1));
  }
};

// dfeat rounded to bf16 into the next product's A buffer
struct BfStore {
  bf16* out;
  int ldo;
  __device__ void operator()(int r, int c, float v0, float v1) const {
    store_pair(out + r * ldo + c, __floats2bfloat162_rn(v0, v1));
  }
};

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The per-sample values in the scratch (p.vals): kVals f32 arrays of
// rows_pad rows, rgb four floats a row. Every instance keeps them there (the
// narrow forward kernel in its shared memory while it runs, where they fit).
constexpr int kVals = 10;
enum ValOff { kValSig = 0, kValRgb = 1, kValTs = 5, kValDl = 6, kValW = 7, kValT = 8, kValDsig = 9 };

// The CTA's tile with its per-sample values in the scratch, from stash row
// row0 on: generic pointers, which every loop over them takes as they are.
__device__ __forceinline__ Tile streamed_tile(Tile t, const TrainParams& p, long long row0) {
  float* v = p.vals;
  const long long n = p.rows_pad;
  t.sig_raw = v + kValSig * n + row0;
  t.rgb = v + kValRgb * n + row0 * 4;
  t.ts = v + kValTs * n + row0;
  t.dl = v + kValDl * n + row0;
  t.w = v + kValW * n + row0;
  t.sg = v + kValT * n + row0;
  t.dsig = v + kValDsig * n + row0;
  return t;
}

__device__ __forceinline__ float warp_incl_scan(float x, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float v = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += v;
  }
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float sigma_of(int act, float raw) {
  return act == 0 ? fmaxf(raw, 0.f) : fmaxf(raw, 0.f) + log1pf(expf(-fabsf(raw)));
}

// The per-ray scans, a warp per ray, 32 samples a step, f32: the forward
// (weights, T, colour, acc, and with the distortion loss its prefix sums
// and A_i) with the exclusive sum of sigma * delta carried between steps,
// diag, then the backward from the far end with the suffix sum of u w
// carried, each sample's d sigma into t.dsig. Rays past the end get d sigma
// = 0.
// kNW: the warps that share the rays (the cluster instance's consumers: 8).
template <int kNW = kWarps>
__device__ void scan_rays_warp(const TrainParams& p, const Tile& t, long long ray0, int n_valid) {
  const Field& f = p.f;
  const int S = f.S, lane = threadIdx.x & 31;
  const bool dist = p.dist_scale != 0.f;
  for (int j = threadIdx.x >> 5; j < f.R; j += kNW) {
    const int r0 = j * S;
    if (j >= n_valid) {
      for (int s = lane; s < S; s += 32) t.dsig[r0 + s] = 0.f;
      continue;
    }
    const long long ray = ray0 + j;
    float carry = 0.f, c0 = 0.f, c1 = 0.f, c2 = 0.f, acc = 0.f;
    for (int c = 0; c < S; c += 32) {
      const int s = c + lane, r = r0 + s;
      float a = 0.f;
      if (s < S) a = sigma_of(f.sigma_act, t.sig_raw[r]) * t.dl[r];
      const float incl = warp_incl_scan(a, lane);
      const float before = __shfl_up_sync(0xffffffffu, incl, 1);
      const float excl = carry + (lane == 0 ? 0.f : before);
      carry += __shfl_sync(0xffffffffu, incl, 31);
      if (s < S) {
        const float T = expf(-excl);
        const float w = T * (1.f - expf(-a));
        c0 += w * t.rgb[r * 4 + 0];
        c1 += w * t.rgb[r * 4 + 1];
        c2 += w * t.rgb[r * 4 + 2];
        acc += w;
        t.w[r] = w;
        t.sg[r] = T;
      }
    }
    c0 = warp_sum(c0);
    c1 = warp_sum(c1);
    c2 = warp_sum(c2);
    acc = warp_sum(acc);
    if (p.white_bg) {
      c0 += 1.f - acc;
      c1 += 1.f - acc;
      c2 += 1.f - acc;
    }
    const float e0 = c0 - p.gold[ray * 3 + 0];
    const float e1 = c1 - p.gold[ray * 3 + 1];
    const float e2 = c2 - p.gold[ray * 3 + 2];
    float ldist = 0.f;
    if (dist) {  // the distortion loss: prefix sums of w and w m over the whole ray
      float wm = 0.f;
      for (int s = lane; s < S; s += 32) {
        float m, dn;
        dist_coords(p, t.ts[r0 + s], t.dl[r0 + s], &m, &dn);
        wm += t.w[r0 + s] * m;
      }
      const float wm_tot = warp_sum(wm);
      float cw0 = 0.f, cwm0 = 0.f;
      for (int c = 0; c < S; c += 32) {
        const int s = c + lane, r = r0 + s;
        float m = 0.f, dn = 0.f, w = 0.f;
        if (s < S) {
          dist_coords(p, t.ts[r], t.dl[r], &m, &dn);
          w = t.w[r];
        }
        const float iw = warp_incl_scan(w, lane), iwm = warp_incl_scan(w * m, lane);
        const float cw = cw0 + iw, cwm = cwm0 + iwm;
        cw0 += __shfl_sync(0xffffffffu, iw, 31);
        cwm0 += __shfl_sync(0xffffffffu, iwm, 31);
        if (s < S) {
          const float A = m * (2.f * cw - acc) + wm_tot - 2.f * cwm;
          ldist += w * A + w * w * dn * (1.f / 3.f);
          t.dsig[r] = A;
        }
      }
      ldist = warp_sum(ldist);
    }
    if (lane == 0) {
      float* dg = p.diag + ray * 8;
      dg[0] = c0;
      dg[1] = c1;
      dg[2] = c2;
      dg[3] = acc;
      dg[4] = (e0 * e0 + e1 * e1 + e2 * e2) / 3.f;
      dg[5] = ldist;
      dg[6] = 0.f;
      dg[7] = 0.f;
    }

    // dC = 2 res / (3 N); u_k = dL/dw_k; da_k = u_k (T_k - w_k) - sum_{i>k} u_i w_i
    const float k = 2.f * p.loss_scale;
    const float dc[3] = {k * e0, k * e1, k * e2};
    const float dsum = dc[0] + dc[1] + dc[2];
    float after = 0.f;  // sum of u w over the steps already taken, all past this one
    for (int c = (S - 1) / 32 * 32; c >= 0; c -= 32) {
      const int s = c + lane, r = r0 + s;
      float u = 0.f, w = 0.f;
      if (s < S) {
        const float* rgb = t.rgb + r * 4;
        u = rgb[0] * dc[0] + rgb[1] * dc[1] + rgb[2] * dc[2];
        if (p.white_bg) u -= dsum;
        w = t.w[r];
        if (dist) {  // d L_dist / d w = 2 A + (2/3) w dn, into the same cotangent
          float m, dn;
          dist_coords(p, t.ts[r], t.dl[r], &m, &dn);
          u += p.dist_scale * (2.f * t.dsig[r] + (2.f / 3.f) * w * dn);
        }
      }
      float incl = u * w;  // suffix sums within the step: lanes >= lane
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_down_sync(0xffffffffu, incl, o);
        if (lane + o < 32) incl += v;
      }
      const float later = __shfl_down_sync(0xffffffffu, incl, 1);
      const float suffix = after + (lane == 31 ? 0.f : later);
      after += __shfl_sync(0xffffffffu, incl, 0);
      if (s < S) {
        const float da = u * (t.sg[r] - w) - suffix;
        const float raw = t.sig_raw[r];
        const float slope =
            f.sigma_act == 0 ? (raw > 0.f ? 1.f : 0.f) : 1.f / (1.f + expf(-raw));
        t.dsig[r] = round_bf16(da * t.dl[r] * slope);
      }
    }
  }
}

// The mma.sync wide instance's d rgb_raw = bf16(w dC rgb (1 - rgb)) for the pass
// at CTA row s0, into the one-pass tile (columns 0-7; 8-15 stay 0) and
// its rows of the grgb stash, and the pass's dsigma column of the gsf
// stash; dC from diag, as the scan formed it. Zeros past the last ray.
__device__ void pass_drgb(const TrainParams& p, const Tile& t, long long ray0, int n_valid,
                          int s0, bf16* grgb, bf16* gsf) {
  const Field& f = p.f;
  const float k = 2.f * p.loss_scale;
  for (int i = threadIdx.x; i < kRows * 8; i += kThreads) {
    const int r = i / 8, c = i % 8, cr = s0 + r, j = cr / f.S;
    float v = 0.f;
    if (c < 3 && j < n_valid) {
      const long long ray = ray0 + j;
      const float dc = k * (p.diag[ray * 8 + c] - p.gold[ray * 3 + c]);
      const float rgb = t.rgb[cr * 4 + c];
      v = t.w[cr] * dc * rgb * (1.f - rgb);
    }
    const bf16 b = __float2bfloat16_rn(v);
    t.drgb[r * kLdr + c] = b;
    grgb[static_cast<long long>(cr) * 8 + c] = b;
    gsf[static_cast<long long>(cr) * (f.F + 8) + f.F + c] =
        __float2bfloat16_rn(c == 0 ? t.dsig[cr] : 0.f);
  }
  __syncthreads();
}

// The mma.sync wide instance, past the cluster route (train_mode): the
// per-sample values in the scratch and the warp scans,
// with field_forward_wide's products, whose activations are the stashes
// themselves: each forward epilogue writes its layer's stash, each backward
// one its G stash, and the next product stages its A from there. Only d
// rgb_raw's one-pass tile (16 columns) is read from shared memory.
template <bool kContract>
__global__ void __launch_bounds__(kThreads, 1) train_wide_kernel(const TrainParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Field& f = p.f;
  const int S = f.S;
  const int R = f.R;
  const int rows = f.rows;
  const int tid = threadIdx.x;
  const long long ray0 = static_cast<long long>(blockIdx.x) * R;
  const long long left = f.n_rays - ray0;
  const int n_valid = left < R ? static_cast<int>(left) : R;
  const int rows_valid = n_valid * S;
  const long long row0 = static_cast<long long>(blockIdx.x) * rows;
  const int W = f.W, F = f.F, V = f.V, L = f.n_layers;
  const long long hs = p.rows_pad * W;    // layer stride of the h and G stashes
  const long long ms = p.rows_pad * p.mw; // layer stride of the relu bits

  const WideSmem ws = wide_layout(f);
  const Tile t = streamed_tile(carve_wide(smem, ws), p, row0);
  bf16* aring = reinterpret_cast<bf16*>(smem + ws.aring);
  for (int s0 = 0; s0 < rows; s0 += kRows) {
    const long long r = row0 + s0;
    field_forward_wide<kContract>(f, t, aring, ray0, n_valid, s0,
                                  WideOut{p.sx + r * f.P, p.sdv + r * f.D, p.sh + r * W, hs, L,
                                          p.sfeat + r * F, p.shv + r * V, p.mask + r * p.mw, ms,
                                          p.mw});
  }

  // ---- per ray: compositing, loss and the compositing VJP, f32 ----
  scan_rays_warp(p, t, ray0, n_valid);
  for (int i = tid; i < kRows * 8; i += kThreads)  // the k16 pad of the one-pass tile
    t.drgb[(i / 8) * kLdr + 8 + i % 8] = __float2bfloat16_rn(0.f);
  __syncthreads();
  for (int r = tid; r < rows_valid; r += kThreads) p.wts[ray0 * S + r] = t.w[r];

  // ---- backward products, heads then trunk, pass by pass, stash to stash ----
  auto wt = [&](int i) { return reinterpret_cast<const uint2*>(p.wt + wt_at(p, i)); };
  bf16* grgb = p.grgb + row0 * 8;
  bf16* gsf = p.gsf + row0 * (F + 8);
  for (int s0 = 0; s0 < rows; s0 += kRows) {
    const long long r = row0 + s0;
    const uint32_t* bits = p.mask + r * p.mw;
    bf16* gh = p.gh + r * W;
    bf16* ghv = p.ghv + r * V;
    bf16* g_sf = gsf + s0 * (F + 8);
    pass_drgb(p, t, ray0, n_valid, s0, grgb, gsf);
    // g_hv = bf16((d rgb_raw @ rgb_w^T) [hv > 0])
    dense_layer(t.drgb, kLdr, 16, wt(L + 1), nullptr, 0, 0, nullptr, V, t.wring,
                GradStore{ghv, V, bits + L * ms, p.mw, nullptr, nullptr});
    __syncthreads();
    // dfeat = bf16(g_hv @ view_w^T), beside d sigma in [dfeat | dsigma | 0]
    dense_layer<BfStore, true>(ghv, V, V, wt(L), nullptr, 0, 0, nullptr, F, t.wring,
                               BfStore{g_sf, F + 8}, aring);
    __syncthreads();
    // g_{L-1} = bf16((dfeat @ feat_w^T + dsigma sigma_row) [h_{L-1} > 0])
    dense_layer<GradStore, true>(g_sf, F + 8, F, wt(L - 1), nullptr, 0, 0, nullptr, W, t.wring,
                                 GradStore{gh + (L - 1) * hs, W, bits + (L - 1) * ms, p.mw,
                                           t.dsig + s0, p.sigma_row},
                                 aring);
    __syncthreads();
    for (int l = L - 1; l >= 1; --l) {  // g_{l-1} = bf16((g_l @ W_l^T) [h_{l-1} > 0])
      dense_layer<GradStore, true>(gh + l * hs, W, W, wt(l - 1), nullptr, 0, 0, nullptr, W,
                                   t.wring,
                                   GradStore{gh + (l - 1) * hs, W, bits + (l - 1) * ms, p.mw,
                                             nullptr, nullptr},
                                   aring);
      __syncthreads();
    }
  }
}

// ---- the cluster instance: the wide route (field_cluster.cuh) ----

struct TrainClusterParams {
  TrainParams t;
  cl::Geo geo;
  cl::CSmem L;
};

// The pass's 128 rows of `cols` columns of a K-major tile (the act block,
// or an encoding tile) to a row-major stash from dst (row stride ld):
// 16-byte loads and evict-first stores; then the consumers'
// barrier, so that no epilogue overwrites a row another thread still reads.
__device__ __forceinline__ void stash_block(const unsigned char* tile, bf16* dst, int ld, int cols,
                                            int tid) {
  const int vecs = cols / 8;
  for (int i = tid; i < kRows * vecs; i += cl::kConsumerThreads) {
    const int r = i / vecs, v = i % vecs;
    __stcs(reinterpret_cast<uint4*>(dst + static_cast<long long>(r) * ld + 8 * v),
           *reinterpret_cast<const uint4*>(tile + wg::tile_off(r, 8 * v)));
  }
  cl::consumers_sync();
}

// Byte offset of element (r, c) of an act block: the cluster route's K-major
// core-matrix tile (wg::tile_off), or with kSw the narrow instance's
// 128-byte-swizzled panels (64 columns a panel of 16 KB, row r's 128 bytes
// at 128 r, its 16-byte chunk j at chunk j ^ (r % 8)): the layout wgmma
// reads with a 128-byte-swizzle descriptor and TMA stores row by row.
template <bool kSw>
__device__ __forceinline__ uint32_t act_off(int r, int c) {
  if constexpr (kSw)
    return ((c >> 6) << 14) + (r << 7) + ((((c >> 3) & 7) ^ (r & 7)) << 4) + ((c & 7) << 1);
  else
    return wg::tile_off(r, c);
}

// store_block<true> (relu, bf16, into the act block) that also keeps the
// relu bits (bf16 value > 0) as relu_bits does, from the registers: word w
// of the block (its columns 32 w .. 32 w + 31, n8 tiles 4 w .. 4 w + 3) is
// each quad's bits OR-ed over its four lanes, and lane w % 4 of the quad
// stores it for both of the quad's rows (mask: the pass's first row's words
// of this layer, mw a row, the block's first at w0; nw real words).
// With kBias (the narrow instance) the bias is added first, in the plain
// version's order (the sums, then the bias): bias[c] for c < n, 0 past it.
template <bool kSw = false, bool kBias = false>
__device__ __forceinline__ void relu_block_bits(const float* acc, unsigned char* act, int r0, int c0,
                                                uint32_t* mask, int mw, int w0, int nw,
                                                const float* bias = nullptr, int n = 0) {
  const int q = threadIdx.x & 3;
#pragma unroll
  for (int w = 0; w < cl::kBlock / 32; ++w) {
    uint32_t ma = 0, mb = 0;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int jj = 4 * w + u, c = 8 * jj + c0;
      float b0 = 0.f, b1 = 0.f;
      if constexpr (kBias) {
        if (c < n) {
          const float2 bb = *reinterpret_cast<const float2*>(bias + c);
          b0 = bb.x;
          b1 = bb.y;
        }
      }
      const __nv_bfloat162 a = __floats2bfloat162_rn(fmaxf(acc[4 * jj] + b0, 0.f),
                                                     fmaxf(acc[4 * jj + 1] + b1, 0.f));
      const __nv_bfloat162 b = __floats2bfloat162_rn(fmaxf(acc[4 * jj + 2] + b0, 0.f),
                                                     fmaxf(acc[4 * jj + 3] + b1, 0.f));
      *reinterpret_cast<__nv_bfloat162*>(act + act_off<kSw>(r0, c)) = a;
      *reinterpret_cast<__nv_bfloat162*>(act + act_off<kSw>(r0 + 8, c)) = b;
      const uint32_t ua = *reinterpret_cast<const uint32_t*>(&a);
      const uint32_t ub = *reinterpret_cast<const uint32_t*>(&b);
      const int bit = 8 * u + c0;  // relu's output is >= 0: a value is > 0 where its magnitude is
      ma |= ((ua & 0x7fffu) != 0u ? 1u : 0u) << bit | ((ua & 0x7fff0000u) != 0u ? 2u : 0u) << bit;
      mb |= ((ub & 0x7fffu) != 0u ? 1u : 0u) << bit | ((ub & 0x7fff0000u) != 0u ? 2u : 0u) << bit;
    }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      ma |= __shfl_xor_sync(0xffffffffu, ma, o);
      mb |= __shfl_xor_sync(0xffffffffu, mb, o);
    }
    if ((w & 3) == q && w < nw) {
      mask[static_cast<long long>(r0) * mw + w0 + w] = ma;
      mask[static_cast<long long>(r0 + 8) * mw + w0 + w] = mb;
    }
  }
}

// GradStore on the warpgroup's sums: g = bf16((acc [+ dsig[r] srow[c]])
// [bit]) into the act block, for the block's columns 8 jj + c0 (c = 256 j +
// that); bits: the layer's relu bits from the pass's first row; zeros past
// the n real columns. kTop: with d sigma (ds0, ds8: rows r0 and r0 + 8).
template <bool kTop, bool kSw = false>
__device__ __forceinline__ void grad_block(const float* acc, unsigned char* act, int r0, int c0,
                                           int j, int n, const uint32_t* bits, int mw, float ds0,
                                           float ds8, const float* srow) {
  uint32_t wa = 0, wb = 0;  // the rows' bits of columns 32 (jj / 4) .. + 31
#pragma unroll
  for (int jj = 0; jj < cl::kBlock / 8; ++jj) {
    const int cb = 8 * jj + c0, col = cl::kBlock * j + cb;
    if ((jj & 3) == 0 && col < n) {  // a word a row every four n8 tiles
      wa = bits[static_cast<long long>(r0) * mw + (col >> 5)];
      wb = bits[static_cast<long long>(r0 + 8) * mw + (col >> 5)];
    }
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = acc[4 * jj + e];
    if (col < n) {
      if (kTop) {
        const float s0 = srow[col], s1 = srow[col + 1];
        v[0] = __fadd_rn(v[0], __fmul_rn(ds0, s0));
        v[1] = __fadd_rn(v[1], __fmul_rn(ds0, s1));
        v[2] = __fadd_rn(v[2], __fmul_rn(ds8, s0));
        v[3] = __fadd_rn(v[3], __fmul_rn(ds8, s1));
      }
      const uint32_t a = wa >> (col & 31), b = wb >> (col & 31);
      v[0] = (a & 1u) ? v[0] : 0.f;
      v[1] = (a & 2u) ? v[1] : 0.f;
      v[2] = (b & 1u) ? v[2] : 0.f;
      v[3] = (b & 2u) ? v[3] : 0.f;
    } else {
      v[0] = v[1] = v[2] = v[3] = 0.f;
    }
    *reinterpret_cast<__nv_bfloat162*>(act + act_off<kSw>(r0, cb)) = __floats2bfloat162_rn(v[0], v[1]);
    *reinterpret_cast<__nv_bfloat162*>(act + act_off<kSw>(r0 + 8, cb)) =
        __floats2bfloat162_rn(v[2], v[3]);
  }
}

// pass_drgb for the cluster instance: d rgb_raw of the pass at CTA row s0
// into the K-major 16-column tile (columns 3-15 zero) the g_hv product
// reads; with lead (CTA 0) also its rows of the grgb stash and the pass's
// d sigma column of the gsf stash. The values the scans left in the
// scratch, read through L2 (another CTA wrote them).
__device__ __forceinline__ void drgb_block(const TrainParams& p, const Tile& t, unsigned char* tile,
                                  long long ray0, int n_valid, int s0, bf16* grgb, bf16* gsf,
                                  bool lead, int tid) {
  const Field& f = p.f;
  const float k = 2.f * p.loss_scale;
  for (int i = tid; i < kRows * 16; i += cl::kConsumerThreads) {
    const int r = i / 16, c = i % 16, cr = s0 + r, j = cr / f.S;
    float v = 0.f;
    if (c < 3 && j < n_valid) {
      const long long ray = ray0 + j;
      const float dc = k * (__ldcg(p.diag + ray * 8 + c) - p.gold[ray * 3 + c]);
      const float rgb = __ldcg(t.rgb + cr * 4 + c);
      v = __ldcg(t.w + cr) * dc * rgb * (1.f - rgb);
    }
    const bf16 b = __float2bfloat16_rn(v);
    *reinterpret_cast<bf16*>(tile + wg::tile_off(r, c)) = b;
    if (lead && c < 8) {
      grgb[static_cast<long long>(cr) * 8 + c] = b;
      gsf[static_cast<long long>(cr) * (f.F + 8) + f.F + c] =
          __float2bfloat16_rn(c == 0 ? __ldcg(t.dsig + cr) : 0.f);
    }
  }
  wg::fence_proxy_async();
  cl::consumers_sync();
}

// The cluster instance's tile: its first ray, its rays in the batch, its
// first stash row, and array k (ValOff) of its per-sample values.
__device__ __forceinline__ long long ct_ray0(const TrainClusterParams& p) {
  return cl::tile_of(p.geo) * p.t.f.R;
}
__device__ __forceinline__ int ct_rays(const TrainClusterParams& p) {
  const long long left = p.t.f.n_rays - ct_ray0(p);
  return left <= 0 ? 0 : (left < p.t.f.R ? static_cast<int>(left) : p.t.f.R);
}
__device__ __forceinline__ long long ct_row0(const TrainClusterParams& p) {
  return cl::tile_of(p.geo) * p.t.f.rows;
}
__device__ __forceinline__ float* ct_vals(const TrainClusterParams& p, int k) {
  return p.t.vals + k * p.t.rows_pad + ct_row0(p) * (k == kValRgb ? 4 : 1);
}

// The CTA's columns of an n-column layer: 256, or fewer in the last block.
__device__ __forceinline__ int block_cols(int n, int j) {
  return n - cl::kBlock * j < cl::kBlock ? n - cl::kBlock * j : cl::kBlock;
}

// The consumers of K2a's forward cluster kernel: every pass's encodings,
// then its products in cl::prod_at's order (trunk, [feature | sigma], view:
// each call site of one compile-time shape), each epilogue's block also to
// its stash and its relu bits; CTA 0 writes the per-sample values to the
// scratch and computes rgb (rgb_rows); then CTA 0 runs the scans. What a
// product needs is recomputed from the parameters and the thread's index
// rather than kept across it (the wgmma pipeline needs the registers).
template <bool kContract>
__device__ void consume_fwd(const TrainClusterParams& p) {
  const TrainParams& tp = p.t;
  const Field& f = tp.f;
  const int j = __shfl_sync(0xffffffffu, cl::block_j(p.geo), 0);
  const bool lead = j == 0;
  const int L = f.n_layers, passes = f.rows / kRows;
  unsigned char* act = cl::smem + cl::kActOff;
  cl::Ring rg{0, 0};
  float acc[cl::kBlock / 2];
  float sig[4];
  const int tid = threadIdx.x;
  int q = 0;
  for (int pass = 0; pass < passes; ++pass) {
    const int s0 = pass * kRows;
    cl::encode_pass<kContract>(f, p.L, ct_ray0(p), ct_rays(p), s0, tid);
    if (lead) {
      float* ts = ct_vals(p, kValTs);
      float* dl = ct_vals(p, kValDl);
      const long long r = ct_row0(p) + s0;  // the pass's first stash row
      const int rows_valid = ct_rays(p) * f.S;
      const long long g0 = ct_ray0(p) * f.S;
      for (int i = tid; i < kRows; i += cl::kConsumerThreads) {
        const int cr = s0 + i;
        const bool ok = cr < rows_valid;
        ts[cr] = ok ? f.ts[g0 + cr] : 0.f;
        dl[cr] = ok ? f.deltas[g0 + cr] : 0.f;
      }
      stash_block(cl::smem + p.L.xs, tp.sx + r * f.P, f.P, f.P, tid);
      stash_block(cl::smem + p.L.ds, tp.sdv + r * f.D, f.D, f.D, tid);
    }
    // ---- trunk ----
    for (int i = 0; i < L; ++i, ++q) {
      const cl::Prod pr = cl::prod_at(f, p.geo, q);
      const bool part = j < pr.nblk;
      cl::prefetch_bias(p.geo, cl::prod_at(f, p.geo, q + 1), j);
      if (part)
        cl::product<cl::kBlock, false>(rg, acc, sig, (pr.k1 + pr.k2) / 16, p.geo,
                                       cl::bias_quads(p.geo, pr, j));
      wg::mbar_wait_cluster(cl::sa(cl::kFreeOff), q & 1);
      if (part)
        relu_block_bits(acc, act, cl::frag_row(), cl::frag_col(),
                        tp.mask + i * tp.rows_pad * tp.mw + (ct_row0(p) + s0) * tp.mw, tp.mw,
                        8 * j, (block_cols(f.W, j) + 31) / 32);
      cl::publish(p.geo);
      if (part)
        stash_block(act, tp.sh + i * tp.rows_pad * f.W + (ct_row0(p) + s0) * f.W + cl::kBlock * j,
                    f.W, block_cols(f.W, j), tid);
    }
    // ---- [feature | sigma] ----
    {
      const cl::Prod pr = cl::prod_at(f, p.geo, q);
      const bool part = j < pr.nblk;
      cl::prefetch_bias(p.geo, cl::prod_at(f, p.geo, q + 1), j);
      if (part)
        cl::product<cl::kBlock, true>(rg, acc, sig, (pr.k1 + pr.k2) / 16, p.geo,
                                      cl::bias_quads(p.geo, pr, j));
      wg::mbar_wait_cluster(cl::sa(cl::kFreeOff), q & 1);
      if (part) {
        const int rr = cl::frag_row();
        cl::store_block<false>(acc, act, rr, cl::frag_col());
        if (lead) {
          const int ld = (threadIdx.x & 31) & ~3;
          const float s_a = __shfl_sync(0xffffffffu, sig[0], ld);
          const float s_b = __shfl_sync(0xffffffffu, sig[2], ld);
          const float bs = f.b[b_off(f, L) + f.F];
          float* sig_raw = ct_vals(p, kValSig);
          sig_raw[s0 + rr] = s_a + bs;
          sig_raw[s0 + rr + 8] = s_b + bs;
        }
      }
      cl::publish(p.geo);
      if (part)
        stash_block(act, tp.sfeat + (ct_row0(p) + s0) * f.F + cl::kBlock * j, f.F,
                    block_cols(f.F, j), tid);
      ++q;
    }
    // ---- view head ----
    {
      const cl::Prod pr = cl::prod_at(f, p.geo, q);
      const bool part = j < pr.nblk;
      cl::prefetch_bias(p.geo, cl::prod_at(f, p.geo, q + 1), j);
      if (part)
        cl::product<cl::kBlock, false>(rg, acc, sig, (pr.k1 + pr.k2) / 16, p.geo,
                                       cl::bias_quads(p.geo, pr, j));
      wg::mbar_wait_cluster(cl::sa(cl::kFreeOff), q & 1);
      if (part)
        relu_block_bits(acc, act, cl::frag_row(), cl::frag_col(),
                        tp.mask + L * tp.rows_pad * tp.mw + (ct_row0(p) + s0) * tp.mw, tp.mw,
                        8 * j, (block_cols(f.V, j) + 31) / 32);
      cl::publish(p.geo);
      if (part)
        stash_block(act, tp.shv + (ct_row0(p) + s0) * f.V + cl::kBlock * j, f.V,
                    block_cols(f.V, j), tid);
      ++q;
    }
    // ---- CTA 0: rgb on the CUDA cores (the other CTAs' hv blocks, where
    // there are any, after the view product's `ready`: see consume_cluster) ----
    if (lead) {
      if (p.geo.cv > 1) wg::mbar_wait_cluster(cl::sa(cl::kReadyOff), (q - 1) & 1);
      cl::rgb_rows(f, p.geo, f.b + b_off(f, L + 2), ct_vals(p, kValRgb) + 4 * s0);
      cl::hv_read(p.geo);
    }
  }

  // ---- CTA 0: compositing, loss and the compositing VJP, a warp per ray ----
  if (lead) {
    cl::consumers_sync();
    const Tile v = streamed_tile(Tile{}, tp, ct_row0(p));
    scan_rays_warp<cl::kConsumerThreads / 32>(tp, v, ct_ray0(p), ct_rays(p));
    cl::consumers_sync();
    const long long g0 = ct_ray0(p) * f.S;
    for (int i = tid; i < ct_rays(p) * f.S; i += cl::kConsumerThreads) tp.wts[g0 + i] = v.w[i];
  }
}

// The consumers of K2a's backward cluster kernel, every pass: d rgb_raw
// (the CTAs that take g_hv: drgb_block, from what the forward kernel's
// scans left), then the products g_hv, dfeat, g_{L-1} and down the trunk to
// g_0 through one call site (one compile-time shape), each epilogue's G
// block to the act block and its stash.
__device__ void consume_bwd(const TrainClusterParams& p) {
  const TrainParams& tp = p.t;
  const Field& f = tp.f;
  const int j = __shfl_sync(0xffffffffu, cl::block_j(p.geo), 0);
  const int passes = f.rows / kRows, nb = cl::bwd_products(f);
  const int q0 = cl::fwd_products(f) * passes;
  unsigned char* act = cl::smem + cl::kActOff;
  cl::Ring rg{0, 0};
  float acc[cl::kBlock / 2];
  const int tid = threadIdx.x;
  int q = q0;
  for (int pass = 0; pass < passes; ++pass) {
    const int s0 = pass * kRows;
    const long long r = ct_row0(p) + s0, hs = tp.rows_pad * f.W, ms = tp.rows_pad * tp.mw;
    if (j < p.geo.cv)
      drgb_block(tp, streamed_tile(Tile{}, tp, ct_row0(p)), cl::smem + p.L.drgb, ct_ray0(p),
                 ct_rays(p), s0, tp.grgb + ct_row0(p) * 8, tp.gsf + ct_row0(p) * (f.F + 8),
                 j == 0, tid);
    for (int i = 0; i < nb; ++i, ++q) {
      const cl::Prod pr = cl::prod_at(f, p.geo, q);
      const bool part = j < pr.nblk;
      if (part && pr.kind != cl::kDfeat && threadIdx.x < kRows)  // the epilogue's relu bits
        asm volatile("prefetch.global.L1 [%0];\n" ::"l"(tp.mask + pr.layer * ms +
                                                         (r + threadIdx.x) * tp.mw + 8 * j));
      if (part)
        cl::product<cl::kBlock, false>(rg, acc, nullptr, (pr.k1 + pr.k2) / 16, p.geo, nullptr);
      wg::mbar_wait_cluster(cl::sa(cl::kFreeOff), (q - q0) & 1);
      if (part) {
        const int rr = cl::frag_row(), cc = cl::frag_col();
        if (pr.kind == cl::kDfeat) {  // dfeat = bf16(g_hv @ view_w^T)
          cl::store_block<false>(acc, act, rr, cc);
        } else if (pr.kind == cl::kGtop) {  // + dsigma sigma_row, [h_{L-1} > 0]
          const float* dsig = ct_vals(p, kValDsig) + s0;
          grad_block<true>(acc, act, rr, cc, j, f.W, tp.mask + pr.layer * ms + r * tp.mw, tp.mw,
                           dsig[rr], dsig[rr + 8], tp.sigma_row);
        } else {  // g_hv = (d rgb_raw @ rgb_w^T) [hv > 0]; g_{l-1} = (g_l W_l^T) [h_{l-1} > 0]
          grad_block<false>(acc, act, rr, cc, j, pr.n, tp.mask + pr.layer * ms + r * tp.mw, tp.mw,
                            0.f, 0.f, nullptr);
        }
      }
      cl::publish(p.geo);
      if (part) {
        if (pr.kind == cl::kGhv)
          stash_block(act, tp.ghv + r * f.V + cl::kBlock * j, f.V, block_cols(f.V, j), tid);
        else if (pr.kind == cl::kDfeat)
          stash_block(act, tp.gsf + r * (f.F + 8) + cl::kBlock * j, f.F + 8, block_cols(f.F, j),
                      tid);
        else
          stash_block(act, tp.gh + pr.layer * hs + r * f.W + cl::kBlock * j, f.W,
                      block_cols(f.W, j), tid);
      }
    }
  }
}

// K2a's wide route, forward: a row group of C CTAs per tile (cluster of C
// G CTAs), one tile a CTA.
template <bool kContract>
__global__ void __launch_bounds__(cl::kThreads, 1) train_cluster_kernel(const TrainClusterParams p) {
  const Field& f = p.t.f;
  cl::init(p.geo);
  const int q1 = f.rows / kRows * cl::fwd_products(f);
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
  if (warp >= cl::kProducerWarp) {
    if (warp == cl::kProducerWarp) {
      if ((threadIdx.x & 31) == 0) cl::produce(f, p.geo, 0, q1);
    } else {
      cl::load_a(f, p.geo, p.L, 0, q1, warp - cl::kLoaderWarp);
    }
  } else {
    consume_fwd<kContract>(p);
  }
  wg::cluster_sync_any();  // no CTA leaves while another reads its shared memory
}

// K2a's wide route, backward: the same grid, after the forward kernel (its
// stashes, relu bits and scans are what it reads). Its own kernel, so that
// ptxas pipelines the wgmma of each (in one function the forward's and the
// backward's call sites left it too few registers).
__global__ void __launch_bounds__(cl::kThreads, 1) train_cluster_bwd_kernel(
    const TrainClusterParams p) {
  const Field& f = p.t.f;
  cl::init(p.geo);
  const int passes = f.rows / kRows;
  const int q0 = cl::fwd_products(f) * passes, q1 = q0 + cl::bwd_products(f) * passes;
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
  if (warp >= cl::kProducerWarp) {
    if (warp == cl::kProducerWarp) {
      if ((threadIdx.x & 31) == 0) cl::produce(f, p.geo, q0, q1);
    } else {
      cl::load_a(f, p.geo, p.L, q0, q1, warp - cl::kLoaderWarp);
    }
  } else {
    consume_bwd(p);
  }
  wg::cluster_sync_any();
}

// ---- the narrow instance: K2a on wgmma for fields up to kNarrowWidth ----
//
// The cluster route's products at C = 1 (one CTA holds every column of a
// 128-row pass), redesigned around what bounds them at narrow widths: the
// weight stream from L2 (8.4 KB a k16 step for 1 MFLOP of a 128-row tile)
// and the stashes' bytes (~10 KB a sample row each call), both of which the
// narrow instance keeps off the consumers' path:
//  * four tiles a cluster (kNarrowG CTAs) share every weight slot: the
//    producer thread of each bulk-copies a quarter of the slot, multicast to
//    all four, so a weight byte read from L2 serves 512 rows;
//  * two consumer warpgroups (warps 0-7) run the products, 64 rows each,
//    through one call site a kernel (wgmma.m64n256k16, the sums in
//    registers); each epilogue adds the bias after the sums, in the plain
//    version's order (started from the bias, the sums' other association
//    moved relu gates enough that a relu drive which stalls through the
//    plain version learned through K2: chip_smoke.py's fault 6 check), and
//    writes its rows of the act block, which lies in 128-byte-swizzled
//    panels of 64 columns (act_off): wgmma reads it through a 128-byte-swizzle
//    descriptor and TMA stores it in whole 128-byte rows. Relu bits come from
//    the registers (relu_block_bits, a shuffle-OR a quad), raw sigma from the
//    last trunk layer's sums on the CUDA cores (sigma_rows), and the
//    backward masks with the bits (grad_block). setmaxnreg gives the
//    consumers 224 registers, where the epilogues run without spills;
//  * warp 9 hands each k16 step's A address over (all local at C = 1), with
//    the act block's swizzle flag in its top bit;
//  * the first thread of warps 10 and 11, one a consumer warpgroup, stores
//    that warpgroup's rows of every product's output to its stash with TMA
//    (cp.async.bulk.tensor, one tensor map a stash): four boxes of {64, 64}
//    for a 256-column output, no warp copying; the pass's encodings
//    (K-major, unswizzled) leave with its first trunk layer in {8, 128}
//    boxes. A warpgroup's `ready` (its epilogue of product q written) starts
//    them while it runs product q + 1; its `free` (the TMA engine has read
//    its rows) lets its epilogue of q + 1 overwrite them. Neither warpgroup
//    waits on the other's rows; the weight slots they share keep them in
//    step.
// The encodings (narrow_encode: a sincosf a level and coordinate, PE(viewdir)
// once a ray), the scans (a warp per ray, the per-sample values in shared
// memory where they fit), d rgb_raw (narrow_drgb, a row a thread) and the
// rgb head (narrow_rgb) run on the consumers. K2b then reads the stashes
// (the K2b section).

constexpr int kAddrWarp = 9;    // hands the consumers each step's A address
constexpr int kStoreWarp = 10;  // the first threads of warps 10 and 11 issue the TMA stores
constexpr int kBarWg = 2;       // named barriers 2 and 3: one a consumer warpgroup
constexpr int kNarrowG = 4;     // tiles a cluster, every weight slot multicast to all
// The narrow layout's fixed regions: the barriers and slot words as the
// cluster route's (below cl::kActOff), the act block at a 1024-byte boundary
// (the 128-byte swizzle's), the weight ring after it.
constexpr uint32_t kNActOff = 1024;
constexpr uint32_t kNRingOff = kNActOff + 2 * kRows * cl::kBlock;
constexpr uint32_t kPanel = kRows * 128;  // bytes of a 64-column panel
constexpr uint32_t kSwFlag = 0x80000000u; // an A address word's flag: the swizzled act block
// Per consumer warpgroup w: `ready` (its epilogue of a product written) at
// kNReadyOff + 16 w and `free` (its rows of that output read by TMA) at
// kNFreeOff + 16 w; then each ring slot's A address word.
constexpr uint32_t kNReadyOff = cl::kReadyOff, kNFreeOff = cl::kReadyOff + 8;
constexpr uint32_t kNAddrOff = cl::kReadyOff + 64;
static_assert(kNAddrOff + 4 * cl::kMaxStages <= kNActOff, "the slot words overlap the act block");

// The stashes' tensor maps (bf16, row-major at their own widths over
// rows_pad rows; boxes of 8 columns x 128 rows; the h and G stashes 3-D
// over the layers), built on the host at every launch.
enum StashMap { kMapX = 0, kMapDv, kMapH, kMapFeat, kMapHv, kMapGhv, kMapGsf, kMapGh, kMaps };

// The narrow layout's regions past the cluster layout's (byte offsets).
struct NarrowSmem {
  uint32_t dpe;   // PE(viewdir) of the tile's rays, bf16
  uint32_t vals;  // the tile's per-sample values (kVals arrays of f.rows), or 0: in the scratch
  uint32_t rgbw;  // the rgb head's matrix (the repacked rgb block, V x 8 bf16)
  uint32_t srow;  // the sigma column of [feature | sigma] (f32, zero past W to 256)
  uint32_t bias;  // the forward's repacked biases (Geo::bp's first (L + 2) x 256), or 0: from L2
};

// The tile's rows in shared memory above which its per-sample values stay
// in the scratch (long rays): 15 KB at 384 rows.
constexpr int kSmemValRows = 384;

struct NarrowParams {
  TrainClusterParams c;
  NarrowSmem s;
  CUtensorMap map[kMaps];
};

__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, uint32_t src, int c0, int c1) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
                   map),
               "r"(src), "r"(c0), "r"(c1)
               : "memory");
}
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(map),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// the shared memory of every committed bulk store has been read
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// every committed bulk store has been written
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// The narrow instance's shared memory: the act block and the weight ring at
// fixed offsets (kNActOff, kNRingOff), then the cluster layout's tiles at C =
// 1 without the A ring (every operand lies in this CTA), the encoding tiles
// aligned to 128 bytes for TMA, then (into *ns) PE(viewdir) of the tile's
// rays, its per-sample values where it has at most kSmemValRows rows, the
// rgb head's matrix, the sigma column and (bias_floats > 0) the biases.
inline cl::CSmem narrow_layout(const Field& f, int stages, NarrowSmem* ns = nullptr,
                               int bias_floats = 0) {
  cl::CSmem L;
  size_t at = kNRingOff + static_cast<size_t>(stages) * cl::kSlotBytes;
  at = (at + 127) & ~static_cast<size_t>(127);
  L.aring = static_cast<uint32_t>(at);
  L.xs = static_cast<uint32_t>(take(&at, sizeof(bf16) * kRows * f.P));
  L.ds = static_cast<uint32_t>(take(&at, sizeof(bf16) * kRows * f.D));
  L.drgb = static_cast<uint32_t>(take(&at, cl::kStep));
  L.mv = static_cast<uint32_t>(take(&at, sizeof(float) * kRows * 6));
  L.ray = static_cast<uint32_t>(take(&at, sizeof(float) * f.R * kRayStride));
  NarrowSmem x;
  x.dpe = static_cast<uint32_t>(take(&at, sizeof(bf16) * f.R * f.D));
  x.vals = f.rows <= kSmemValRows ? static_cast<uint32_t>(take(&at, sizeof(float) * kVals * f.rows))
                                  : 0u;
  x.rgbw = static_cast<uint32_t>(take(&at, sizeof(bf16) * f.V * 8));
  x.srow = static_cast<uint32_t>(take(&at, sizeof(float) * cl::kBlock));
  x.bias = bias_floats > 0 ? static_cast<uint32_t>(take(&at, sizeof(float) * bias_floats)) : 0u;
  if (ns != nullptr) *ns = x;
  L.sig = L.rgb = L.carry = static_cast<uint32_t>(at);
  L.total = static_cast<uint32_t>(at);
  return L;
}

// The most ring stages (at most cl::kMaxStages) whose narrow layout (with
// bias_floats of staged biases) fits the card's opt-in shared memory, or 0
// where not even cl::kMinStages do. The route asks without the biases.
inline int narrow_stages(const Field& f, size_t optin, int bias_floats = 0) {
  for (int s = cl::kMaxStages; s >= cl::kMinStages; --s)
    if (narrow_layout(f, s, nullptr, bias_floats).total <= optin) return s;
  return 0;
}

// Inits the narrow instance's barriers: full (the producer's bytes and the
// address warp's arrival), empty (both warpgroups of every tile it feeds),
// and each warpgroup's ready (its leader's arrival) and free (its storing
// thread's).
__device__ inline void narrow_init(const cl::Geo& geo) {
  if (threadIdx.x == 0) {
    if (cl::sa(kNActOff) & 1023u) __trap();  // the 128-byte swizzle needs 1024-byte panels
    for (int s = 0; s < geo.stages; ++s) {
      wg::mbar_init(cl::sa(cl::kFullOff) + 8 * s, 2);
      wg::mbar_init(cl::sa(cl::kEmptyOff) + 8 * s, 2 * kNarrowG);
    }
    for (int w = 0; w < 2; ++w) {
      wg::mbar_init(cl::sa(kNReadyOff) + 16 * w, 1);
      wg::mbar_init(cl::sa(kNFreeOff) + 16 * w, 1);
    }
    wg::mbar_init_fence();
  }
  __syncwarp();
  wg::cluster_sync();
}

// The first thread of warp 8: every product's weight slots in cl::prod_at's
// order (cl::produce at C = 1), each slot's quarter g (the CTA's rank in the
// cluster) bulk-copied from L2 and multicast to the kNarrowG tiles' rings.
__device__ inline void narrow_produce(const Field& f, const cl::Geo& geo, int q0, int q1) {
  const uint32_t g = wg::cluster_rank();
  constexpr uint16_t kAll = (1u << kNarrowG) - 1;
  int slot = 0;
  uint32_t phase = 0;
  for (int q = q0; q < q1; ++q) {
    const cl::Prod pr = cl::prod_at(f, geo, q);
    const uint32_t bytes = 32u * pr.ntot, part = bytes / kNarrowG;
    for (int h = 0; h < 2; ++h) {
      const int steps = (h ? pr.k2 : pr.k1) / 16;
      const char* src = reinterpret_cast<const char*>(geo.wp + (h ? pr.w2 : pr.w1));
      for (int t = 0; t < steps; ++t) {
        wg::mbar_wait(cl::sa(cl::kEmptyOff) + 8 * slot, phase ^ 1);
        wg::mbar_arrive_expect_tx(cl::sa(cl::kFullOff) + 8 * slot, bytes);
        wg::bulk_copy_multicast(cl::sa(kNRingOff) + slot * cl::kSlotBytes + g * part,
                                src + static_cast<size_t>(t) * bytes + g * part, part,
                                cl::sa(cl::kFullOff) + 8 * slot, kAll);
        if (++slot == geo.stages) {
          slot = 0;
          phase ^= 1;
        }
      }
    }
  }
  // every slot freed by every consumer it feeds: no arrival from another
  // tile is still on its way when the CTA exits
  for (int i = 0; i < geo.stages; ++i) {
    wg::mbar_wait(cl::sa(cl::kEmptyOff) + 8 * slot, phase ^ 1);
    if (++slot == geo.stages) {
      slot = 0;
      phase ^= 1;
    }
  }
}

// A wgmma descriptor of a K-major operand in 128-byte-swizzled rows, 8-row
// groups 1024 bytes apart (layout type 1 in bits 62-63; the leading offset
// unused).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1024 >> 4) << 32) |
         (1ull << 62);
}

// cl::product for the narrow instance: acc = A1 B1 [+ A2 B2] over `steps`
// k16 steps (the epilogues add the bias after the sums, as the plain
// version does), each step's A address from its slot's word (swizzled
// where kSwFlag is set: this warpgroup's rows 8 KB on; else 1 KB on), B from
// the narrow ring (k groups lbo bytes apart: the slot's columns x 16); a
// slot is released, in every tile of the cluster, once the next step's group
// has started. One call site serves every product of a kernel.
template <int N>
__device__ __forceinline__ void narrow_product(cl::Ring& rg, float* acc, int steps,
                                               const cl::Geo& geo, uint32_t lbo) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  const uint32_t w = static_cast<uint32_t>(__shfl_sync(0xffffffffu, threadIdx.x >> 7, 0));
  const uint32_t signal = (threadIdx.x & 127) == 0;
  int prev = -1;
  for (int t = 0; t < steps; ++t) {
    wg::mbar_wait(cl::sa(cl::kFullOff) + 8 * rg.slot, rg.phase);
    wg::fence_regs<N / 2>(acc);
    wg::fence();
    const uint32_t word =
        *reinterpret_cast<volatile const uint32_t*>(cl::smem + kNAddrOff + 4 * rg.slot);
    const uint32_t a = word & ~kSwFlag;
    const uint64_t da = (word & kSwFlag) ? desc_sw128(a + w * (kPanel / 2))
                                         : wg::desc(a + w * 1024, 2048, 128);
    const uint64_t db = wg::desc(cl::sa(kNRingOff) + rg.slot * cl::kSlotBytes, lbo, 128);
    wg::mma<N>(acc, da, db, 1);
    wg::commit();
    wg::fence_regs<N / 2>(acc);
    if (prev >= 0) {
      wg::wait<1>();
#pragma unroll
      for (int c = 0; c < kNarrowG; ++c)
        wg::mbar_arrive_cluster(cl::sa(cl::kEmptyOff) + 8 * prev, c, signal);
    }
    prev = rg.slot;
    if (++rg.slot == geo.stages) {
      rg.slot = 0;
      rg.phase ^= 1;
    }
  }
  wg::wait<0>();
  wg::fence_regs<N / 2>(acc);
#pragma unroll
  for (int c = 0; c < kNarrowG; ++c)
    wg::mbar_arrive_cluster(cl::sa(cl::kEmptyOff) + 8 * prev, c, signal);
}

// The warpgroup's sums (rows r0 and r0 + 8, columns 8 jj + c0) plus their
// bias (bias[c] for c < n, after the sums as the plain version adds it; none
// where bias is null) as bf16 into the swizzled act block
// (cl::store_block<false>'s narrow counterpart).
__device__ __forceinline__ void store_block_sw(const float* acc, unsigned char* act, int r0, int c0,
                                               const float* bias, int n) {
#pragma unroll
  for (int jj = 0; jj < cl::kBlock / 8; ++jj) {
    const int c = 8 * jj + c0;
    float b0 = 0.f, b1 = 0.f;
    if (bias != nullptr && c < n) {
      const float2 bb = *reinterpret_cast<const float2*>(bias + c);
      b0 = bb.x;
      b1 = bb.y;
    }
    *reinterpret_cast<__nv_bfloat162*>(act + act_off<true>(r0, c)) =
        __floats2bfloat162_rn(acc[4 * jj] + b0, acc[4 * jj + 1] + b1);
    *reinterpret_cast<__nv_bfloat162*>(act + act_off<true>(r0 + 8, c)) =
        __floats2bfloat162_rn(acc[4 * jj + 2] + b0, acc[4 * jj + 3] + b1);
  }
}

// Warp 9: every k16 step's A address, in the producer's order, into its
// slot's word (the act block's with kSwFlag); then one arrival on the
// slot's full barrier.
__device__ inline void narrow_hand_a(const Field& f, const cl::Geo& geo, const cl::CSmem& L,
                                     int q0, int q1) {
  const int lane = threadIdx.x & 31;
  int t = 0;
  for (int q = q0; q < q1; ++q) {
    const cl::Prod pr = cl::prod_at(f, geo, q);
    for (int h = 0; h < 2; ++h) {
      const int src = h ? pr.a2 : pr.a1, steps = (h ? pr.k2 : pr.k1) / 16;
      const uint32_t base = src == cl::kXs  ? cl::sa(L.xs)
                            : src == cl::kDs  ? cl::sa(L.ds)
                                              : cl::sa(L.drgb);
      for (int k = 0; k < steps; ++k, ++t) {
        const int slot = t % geo.stages;
        // the act block's step k: panel k / 4, 32 bytes a step along its rows
        const uint32_t a = src == cl::kAct
                               ? (cl::sa(kNActOff) + (k >> 2) * kPanel + (k & 3) * 32) | kSwFlag
                               : base + k * cl::kStep;
        wg::mbar_wait(cl::sa(cl::kEmptyOff) + 8 * slot, ((t / geo.stages) & 1) ^ 1);
        __syncwarp();
        if (lane == 0) {
          *reinterpret_cast<volatile uint32_t*>(cl::smem + kNAddrOff + 4 * slot) = a;
          wg::mbar_arrive(cl::sa(cl::kFullOff) + 8 * slot);
        }
      }
    }
  }
}

// A tile's first `cols` columns to a stash through tensor map `map`
// (`layer`: the 3-D maps' third coordinate, or -1), from stash row `row`
// on: with kSw a warpgroup's 64 rows of the swizzled act block (tile: its
// first panel's rows, 8 KB in), one {64, 64} box a 64-column panel (the map
// swizzles 128 bytes and clips the last panel at the stash's width); else
// an encoding tile's 128 rows (K-major core matrices), one {8, 128} box a
// k-group, each a dense 2 KB run of the tile.
template <bool kSw>
__device__ __forceinline__ void store_tile(const CUtensorMap* map, uint32_t tile, int cols, int row,
                                           int layer) {
  constexpr int kCols = kSw ? 64 : 8;
  constexpr uint32_t kBytes = kSw ? kPanel : cl::kStep / 2;
  for (int b = 0; b < (cols + kCols - 1) / kCols; ++b) {
    if (layer < 0)
      tma_store_2d(map, tile + b * kBytes, kCols * b, row);
    else
      tma_store_3d(map, tile + b * kBytes, kCols * b, row, layer);
  }
}

// The first thread of warp 10 + w, for consumer warpgroup w: for every
// product q after the first, once the warpgroup has written its 64 rows of
// product q - 1 (its `ready`), those rows from the act block to their stash
// rows (and with a pass's first trunk layer, by warpgroup 0's thread, the
// pass's encodings, which the consumers rewrite only after both
// warpgroups' last epilogue of the pass); once the TMA engine has read
// them, one arrival on the warpgroup's `free`, which lets its epilogue of q
// overwrite them. Products q0 .. q1 - 1 (forward or backward), fwd_products
// of them a pass. Every store has landed when it returns.
__device__ inline void narrow_store(const NarrowParams& np, int q0, int q1, int w) {
  const TrainClusterParams& p = np.c;
  const TrainParams& tp = p.t;
  const Field& f = tp.f;
  const int per = cl::fwd_products(f);
  const uint32_t act = cl::sa(kNActOff) + w * (kPanel / 2);
  for (int q = q0; q <= q1; ++q) {
    if (q > q0) {
      wg::mbar_wait_cluster(cl::sa(kNReadyOff) + 16 * w, (q - 1 - q0) & 1);
      const cl::Prod pr = cl::prod_at(f, p.geo, q - 1);
      const int r = static_cast<int>(ct_row0(p)) + (q - 1 - q0) / per * kRows;
      const int rw = r + 64 * w;  // the warpgroup's first row
      switch (pr.kind) {
        case cl::kTrunk:
          if (pr.layer == 0 && w == 0) {
            store_tile<false>(&np.map[kMapX], cl::sa(p.L.xs), f.P, r, -1);
            store_tile<false>(&np.map[kMapDv], cl::sa(p.L.ds), f.D, r, -1);
          }
          store_tile<true>(&np.map[kMapH], act, f.W, rw, pr.layer);
          break;
        case cl::kFeat:
          store_tile<true>(&np.map[kMapFeat], act, f.F, rw, -1);
          break;
        case cl::kView:
          store_tile<true>(&np.map[kMapHv], act, f.V, rw, -1);
          break;
        case cl::kGhv:
          store_tile<true>(&np.map[kMapGhv], act, f.V, rw, -1);
          break;
        case cl::kDfeat:
          store_tile<true>(&np.map[kMapGsf], act, f.F, rw, -1);
          break;
        default:  // kGtop, kGtrunk
          store_tile<true>(&np.map[kMapGh], act, f.W, rw, pr.layer);
      }
      bulk_commit();
      bulk_wait_read();
    }
    if (q < q1) wg::mbar_arrive(cl::sa(kNFreeOff) + 16 * w);
  }
  bulk_wait();
}

// The consumer warpgroup of this thread (warp-uniform).
__device__ __forceinline__ int narrow_wg() {
  return __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) >> 7, 0);
}

// Before a warpgroup's epilogue of product q (its q - q0'th of the kernel):
// its rows of product q - 1 have been read by TMA.
__device__ __forceinline__ void narrow_wait_free(int i) {
  wg::mbar_wait_cluster(cl::sa(kNFreeOff) + 16 * narrow_wg(), i & 1);
}

// After a warpgroup's epilogue: its rows visible to its own next wgmma and
// to the TMA engine (the warpgroup's named barrier), and one arrival on its
// `ready`.
__device__ __forceinline__ void narrow_publish() {
  wg::fence_proxy_async();
  const int w = narrow_wg();
  wg::named_sync(kBarWg + w, 128);
  if ((threadIdx.x & 127) == 0) wg::mbar_arrive(cl::sa(kNReadyOff) + 16 * w);
}

// sigma_raw of the warpgroup's rows r0 and r0 + 8 from the last trunk
// layer's sums (and its bias, bias[c] for c < n): the sigma bias bs plus
// the bf16 relu values (as relu_block_bits stores them) dotted with the
// sigma column (srow, f32 of its bf16 values,
// zero past the width), each lane's 64 columns in order, then the quad's
// four partial sums; on the CUDA cores, so that [feature | sigma] runs as a
// 256-column product through the kernel's one call site.
__device__ __forceinline__ void sigma_rows(const float* acc, const float* srow, int r0, int c0,
                                           float bs, float* sig_raw, const float* bias, int n) {
  float sa = 0.f, sb = 0.f;
#pragma unroll
  for (int jj = 0; jj < cl::kBlock / 8; ++jj) {
    const int c = 8 * jj + c0;
    const float w0 = srow[c], w1 = srow[c + 1];
    float b0 = 0.f, b1 = 0.f;
    if (c < n) {
      const float2 bb = *reinterpret_cast<const float2*>(bias + c);
      b0 = bb.x;
      b1 = bb.y;
    }
    sa = fmaf(round_bf16(fmaxf(acc[4 * jj] + b0, 0.f)), w0, sa);
    sa = fmaf(round_bf16(fmaxf(acc[4 * jj + 1] + b1, 0.f)), w1, sa);
    sb = fmaf(round_bf16(fmaxf(acc[4 * jj + 2] + b0, 0.f)), w0, sb);
    sb = fmaf(round_bf16(fmaxf(acc[4 * jj + 3] + b1, 0.f)), w1, sb);
  }
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    sa += __shfl_xor_sync(0xffffffffu, sa, o);
    sb += __shfl_xor_sync(0xffffffffu, sb, o);
  }
  if ((threadIdx.x & 3) == 0) {
    sig_raw[r0] = sa + bs;
    sig_raw[r0 + 8] = sb + bs;
  }
}

// rgb = sigmoid(hv rgb_w + b) for the pass's 128 rows, by the consumers on
// the CUDA cores: cl::rgb_rows reading hv from this CTA's act block and
// rgb_w (w, the repacked rgb block) from its shared memory. Two
// threads a row, each summing every other 8 columns in f32, then the pair's
// two sums; rgb of row r at out[4 r + c].
__device__ __forceinline__ void narrow_rgb(const Field& f, const bf16* w, const float* b,
                                           float* out) {
  const int r = threadIdx.x >> 1, half = threadIdx.x & 1;
  const unsigned char* act = cl::smem + kNActOff;
  float s[3] = {0.f, 0.f, 0.f};
#pragma unroll 4
  for (int c8 = half; c8 < f.V / 8; c8 += 2) {
    const uint4 hv = *reinterpret_cast<const uint4*>(act + act_off<true>(r, 8 * c8));
    const bf16* h = reinterpret_cast<const bf16*>(&hv);
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      const uint4 wv = *reinterpret_cast<const uint4*>(w + c8 * 64 + 8 * ch);
      const bf16* wk = reinterpret_cast<const bf16*>(&wv);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        s[ch] = fmaf(__bfloat162float(h[e]), __bfloat162float(wk[e]), s[ch]);
    }
  }
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    const float both = s[ch] + __shfl_xor_sync(0xffffffffu, s[ch], 1);
    if (half == 0) out[4 * r + ch] = 1.f / (1.f + expf(-(both + b[ch])));
  }
}

// drgb_block for the narrow instance, a row a thread: d rgb_raw of the pass
// at CTA row s0 (w dC rgb (1 - rgb), bf16) into the K-major 16-column tile
// the g_hv product reads (columns 3-15 zero) and the row's 8 columns of the
// grgb stash, and [d sigma, 0 x 7] after the F dfeat columns of the gsf
// stash row; each a 16-byte store. The values the forward kernel's scans
// left in the scratch, read through L2.
__device__ __forceinline__ void narrow_drgb(const TrainParams& p, const Tile& t, unsigned char* tile,
                                            long long ray0, int n_valid, int s0, bf16* grgb,
                                            bf16* gsf, int tid) {
  const Field& f = p.f;
  if (tid < kRows) {
    const int cr = s0 + tid, j = cr / f.S;
    const float k = 2.f * p.loss_scale;
    const float ds = __ldcg(t.dsig + cr);
    __align__(16) bf16 v[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) v[c] = __float2bfloat16_rn(0.f);
    if (j < n_valid) {
      const long long ray = ray0 + j;
      const float4 rgb = __ldcg(reinterpret_cast<const float4*>(t.rgb + cr * 4));
      const float w = __ldcg(t.w + cr);
      const float c3[3] = {rgb.x, rgb.y, rgb.z};
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float dc = k * (__ldcg(p.diag + ray * 8 + c) - p.gold[ray * 3 + c]);
        v[c] = __float2bfloat16_rn(w * dc * c3[c] * (1.f - c3[c]));
      }
    }
    const uint4 row = *reinterpret_cast<const uint4*>(v);
    *reinterpret_cast<uint4*>(tile + wg::tile_off(tid, 0)) = row;
    *reinterpret_cast<uint4*>(tile + wg::tile_off(tid, 8)) = make_uint4(0u, 0u, 0u, 0u);
    *reinterpret_cast<uint4*>(grgb + static_cast<long long>(cr) * 8) = row;
    __align__(16) bf16 g[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) g[c] = __float2bfloat16_rn(c == 0 ? ds : 0.f);
    *reinterpret_cast<uint4*>(gsf + static_cast<long long>(cr) * (f.F + 8) + f.F) =
        *reinterpret_cast<const uint4*>(g);
  }
  wg::fence_proxy_async();
  cl::consumers_sync();
}

// The per-sample values of the forward kernel's tile: in shared memory where
// the layout holds them (NarrowSmem::vals; kVals arrays of f.rows, ValOff's
// order), else in the scratch as the cluster route keeps them.
__device__ __forceinline__ Tile narrow_vals(const NarrowParams& np) {
  const TrainClusterParams& p = np.c;
  if (np.s.vals == 0u) return streamed_tile(Tile{}, p.t, ct_row0(p));
  float* v = reinterpret_cast<float*>(cl::smem + np.s.vals);
  const int n = p.t.f.rows;
  Tile t = {};
  t.sig_raw = v + kValSig * n;
  t.rgb = v + kValRgb * n;
  t.ts = v + kValTs * n;
  t.dl = v + kValDl * n;
  t.w = v + kValW * n;
  t.sg = v + kValT * n;
  t.dsig = v + kValDsig * n;
  return t;
}

// The pass's inputs and encodings for the narrow instance, by the
// consumers: cl::encode_pass's values, computed as K1's encoder computes
// them (one sincosf per level and coordinate from one scaled argument; IPE:
// one damping factor), and PE(viewdir) once a ray (bf16, at np.s.dpe), then
// copied to the pass's rows; ts and deltas into the per-sample values.
template <bool kContract>
__device__ void narrow_encode(const NarrowParams& np, const Tile& v, int s0, int tid) {
  const TrainClusterParams& p = np.c;
  const Field& f = p.t.f;
  const cl::CSmem& L = p.L;
  const int S = f.S, n_valid = ct_rays(p);
  const long long ray0 = ct_ray0(p), g0 = ray0 * S;
  float* ray = reinterpret_cast<float*>(cl::smem + L.ray);
  float* mv_all = reinterpret_cast<float*>(cl::smem + L.mv);
  bf16* dpe = reinterpret_cast<bf16*>(cl::smem + np.s.dpe);
  unsigned char* xs = cl::smem + L.xs;
  unsigned char* ds = cl::smem + L.ds;
  const int rows_valid = n_valid * S;
  float tv = 0.f, dv = 0.f;  // thread r's row: its loads in flight beside the rays'
  if (tid < kRows && s0 + tid < rows_valid) {
    tv = f.ts[g0 + s0 + tid];
    dv = f.deltas[g0 + s0 + tid];
  }
  for (int i = tid; i < f.R * kRayStride; i += cl::kConsumerThreads) {
    const int j = i / kRayStride, k = i % kRayStride;
    float x = 0.f;
    if (j < n_valid) {
      if (k < 9) {
        const float* src = k < 3 ? f.o : (k < 6 ? f.d : f.vd);
        x = src[(ray0 + j) * 3 + k % 3];
      } else if (f.ipe) {
        x = f.radii[ray0 + j];
      }
    }
    ray[i] = x;
  }
  cl::consumers_sync();
  if (tid < kRows) {
    const int r = tid, cr = s0 + r;
    const float* ry = ray + (cr / S) * kRayStride;
    float* mv = mv_all + r * 6;
    const bool ok = cr < rows_valid;
    v.ts[cr] = tv;
    v.dl[cr] = dv;
    if (f.ipe && ok) {
      ipe_moments(ry, ry + 3, tv, dv, ry[9], mv);
    } else {
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        mv[k] = __fadd_rn(ry[k], __fmul_rn(tv, ry[3 + k]));
        mv[3 + k] = 0.f;
      }
    }
    if (kContract) {
      if (f.ipe)
        contract_gaussian(mv);
      else
        contract_points(mv);
    }
  }
  // PE(viewdir) of the pass's rays (every ray of the tile: R of them)
  const int dir_dim = 3 + 6 * f.dir_levels;
  for (int i = tid; i < f.R * f.D; i += cl::kConsumerThreads) {
    const int j = i / f.D, col = i % f.D;
    float x = 0.f;
    if (col < dir_dim) x = pe_value(ray[j * kRayStride + 6 + (col < 3 ? col : (col - 3) % 3)], col);
    dpe[i] = __float2bfloat16_rn(x);
  }
  cl::consumers_sync();
  // xs: the raw coordinates and the zero pad columns, then one sincosf per
  // (row, level, axis) for its sin and cos columns (damped alike under IPE),
  // as K1's encoder computes them
  const int levels = f.pos_levels, pos_dim = 3 + 6 * levels;
  for (int i = tid; i < kRows * (3 + f.P - pos_dim); i += cl::kConsumerThreads) {
    const int r = i % kRows, u = i / kRows;
    cl::store_bf1(xs, r, u < 3 ? u : pos_dim + u - 3, u < 3 ? mv_all[r * 6 + u] : 0.f);
  }
#pragma unroll 2
  for (int i = tid; i < kRows * 3 * levels; i += cl::kConsumerThreads) {
    const int r = i % kRows, u = i / kRows, l = u / 3, d = u % 3;
    const float* mv = mv_all + r * 6;
    float sn, cs;
    sincosf(ldexpf(mv[d], l), &sn, &cs);
    if (f.ipe) {
      const float damp = expf(-ldexpf(mv[3 + d], 2 * l - 1));
      sn = __fmul_rn(sn, damp);
      cs = __fmul_rn(cs, damp);
    }
    cl::store_bf1(xs, r, 3 + 6 * l + d, sn);
    cl::store_bf1(xs, r, 6 + 6 * l + d, cs);
  }
  for (int i = tid; i < kRows * f.D; i += cl::kConsumerThreads) {
    const int r = i % kRows, col = i / kRows;
    *reinterpret_cast<bf16*>(ds + wg::tile_off(r, col)) = dpe[((s0 + r) / S) * f.D + col];
  }
  wg::fence_proxy_async();
  cl::consumers_sync();
}

// The consumers of the narrow forward kernel: every pass's encodings (and
// its ts and deltas), its products in cl::prod_at's order through two call
// sites (the trunk and the view head; [feature | sigma] with its sigma
// tile), each epilogue waiting for `free` before it overwrites the act
// block; rgb on the CUDA cores; then the scans, a warp per ray, on the
// per-sample values in shared memory where the layout holds them (then
// the values the backward kernel reads are copied to the scratch).
template <bool kContract>
__device__ void narrow_fwd(const NarrowParams& np) {
  const TrainClusterParams& p = np.c;
  const TrainParams& tp = p.t;
  const Field& f = tp.f;
  const int L = f.n_layers, passes = f.rows / kRows;
  unsigned char* act = cl::smem + kNActOff;
  bf16* rgbw = reinterpret_cast<bf16*>(cl::smem + np.s.rgbw);
  float* srow = reinterpret_cast<float*>(cl::smem + np.s.srow);
  cl::Ring rg{0, 0};
  float acc[cl::kBlock / 2];
  const int tid = threadIdx.x;
  for (int i = tid; i < f.V; i += cl::kConsumerThreads)  // synced by the encode's barriers
    reinterpret_cast<uint4*>(rgbw)[i] =
        __ldg(reinterpret_cast<const uint4*>(p.geo.wp + p.geo.w_rgb) + i);
  for (int i = tid; i < cl::kBlock; i += cl::kConsumerThreads)
    srow[i] = i < f.W ? tp.sigma_row[i] : 0.f;
  // the epilogues' biases, in column order: trunk layer i's at block i,
  // the feature's at L, the view head's at L + 1, zero past each width, a
  // copy in shared memory where the layout holds them (else from L2)
  float* sbias = reinterpret_cast<float*>(cl::smem + np.s.bias);
  if (np.s.bias != 0u)
    for (int i = tid; i < (L + 2) * cl::kBlock; i += cl::kConsumerThreads) {
      const int l = i / cl::kBlock, c = i % cl::kBlock;
      const int n = l < L ? f.W : (l == L ? f.F : f.V);
      sbias[i] = c < n ? f.b[b_off(f, l) + c] : 0.f;
    }
  int q = 0;
  for (int pass = 0; pass < passes; ++pass) {
    const int s0 = pass * kRows;
    narrow_encode<kContract>(np, narrow_vals(np), s0, tid);
    for (int i = 0; i < L + 2; ++i, ++q) {
      {  // nothing of the product's description lives across its k-loop
        const cl::Prod pr = cl::prod_at(f, p.geo, q);
        narrow_product<cl::kBlock>(rg, acc, (pr.k1 + pr.k2) / 16, p.geo, 16u * pr.ntot);
      }
      narrow_wait_free(q);
      // the epilogue's place, from i: trunk layer i < L, the feature at L, the
      // view head at L + 1 (its bias block i, its relu bits' layer min(i, L))
      const int n = i < L ? f.W : (i == L ? f.F : f.V);
      const float* bias = np.s.bias != 0u ? sbias + i * cl::kBlock : f.b + b_off(f, i);
      const int rr = cl::frag_row(), cc = cl::frag_col();
      if (i == L) {  // the feature, bf16, no activation
        store_block_sw(acc, act, rr, cc, bias, n);
      } else {  // a trunk layer or the view head: relu and its bits
        relu_block_bits<true, true>(
            acc, act, rr, cc, tp.mask + ((i < L ? i : L) * tp.rows_pad + ct_row0(p) + s0) * tp.mw,
            tp.mw, 0, (n + 31) / 32, bias, n);
        if (i == L - 1)  // raw sigma from the last trunk layer
          sigma_rows(acc, srow, rr, cc, f.b[b_off(f, L) + f.F], narrow_vals(np).sig_raw + s0,
                     bias, n);
      }
      narrow_publish();
    }
    // ---- rgb on the CUDA cores, from both warpgroups' hv rows ----
    cl::consumers_sync();
    narrow_rgb(f, rgbw, f.b + b_off(f, L + 2), narrow_vals(np).rgb + 4 * s0);
    cl::consumers_sync();
  }

  // ---- compositing, loss and the compositing VJP, a warp per ray ----
  const Tile v = narrow_vals(np);
  scan_rays_warp<cl::kConsumerThreads / 32>(tp, v, ct_ray0(p), ct_rays(p));
  cl::consumers_sync();
  const long long g0 = ct_ray0(p) * f.S;
  for (int i = tid; i < ct_rays(p) * f.S; i += cl::kConsumerThreads) tp.wts[g0 + i] = v.w[i];
  if (np.s.vals != 0u) {  // what the backward kernel reads: w, rgb and d sigma
    const Tile g = streamed_tile(Tile{}, tp, ct_row0(p));
    for (int i = tid; i < f.rows; i += cl::kConsumerThreads) {
      g.w[i] = v.w[i];
      g.dsig[i] = v.dsig[i];
      reinterpret_cast<float4*>(g.rgb)[i] = reinterpret_cast<const float4*>(v.rgb)[i];
    }
  }
}

// The consumers of the narrow backward kernel, every pass: d rgb_raw
// (narrow_drgb, from what the forward kernel's scans left), then g_hv,
// dfeat, g_{L-1} (its sigma column from shared memory) and down the trunk
// to g_0 through one call site.
__device__ void narrow_bwd(const NarrowParams& np) {
  const TrainClusterParams& p = np.c;
  const TrainParams& tp = p.t;
  const Field& f = tp.f;
  float* srow = reinterpret_cast<float*>(cl::smem + np.s.srow);
  for (int i = threadIdx.x; i < f.W; i += cl::kConsumerThreads)  // synced by d rgb_raw's barrier
    srow[i] = tp.sigma_row[i];
  const int passes = f.rows / kRows, nb = cl::bwd_products(f);
  const int q0 = cl::fwd_products(f) * passes;
  unsigned char* act = cl::smem + kNActOff;
  cl::Ring rg{0, 0};
  float acc[cl::kBlock / 2];
  const int tid = threadIdx.x;
  int q = q0;
  for (int pass = 0; pass < passes; ++pass) {
    const int s0 = pass * kRows;
    const long long r = ct_row0(p) + s0, ms = tp.rows_pad * tp.mw;
    narrow_drgb(tp, streamed_tile(Tile{}, tp, ct_row0(p)), cl::smem + p.L.drgb, ct_ray0(p),
                ct_rays(p), s0, tp.grgb + ct_row0(p) * 8, tp.gsf + ct_row0(p) * (f.F + 8), tid);
    for (int i = 0; i < nb; ++i, ++q) {
      const cl::Prod pr = cl::prod_at(f, p.geo, q);
      if (pr.kind != cl::kDfeat && threadIdx.x < kRows)  // the epilogue's relu bits
        asm volatile("prefetch.global.L1 [%0];\n" ::"l"(tp.mask + pr.layer * ms +
                                                         (r + threadIdx.x) * tp.mw));
      narrow_product<cl::kBlock>(rg, acc, (pr.k1 + pr.k2) / 16, p.geo, 16u * pr.ntot);
      narrow_wait_free(q - q0);
      const int rr = cl::frag_row(), cc = cl::frag_col();
      if (pr.kind == cl::kDfeat) {  // dfeat = bf16(g_hv @ view_w^T)
        store_block_sw(acc, act, rr, cc, nullptr, 0);
      } else if (pr.kind == cl::kGtop) {  // + dsigma sigma_row, [h_{L-1} > 0]
        const float* dsig = ct_vals(p, kValDsig) + s0;
        grad_block<true, true>(acc, act, rr, cc, 0, f.W, tp.mask + pr.layer * ms + r * tp.mw,
                               tp.mw, dsig[rr], dsig[rr + 8], srow);
      } else {  // g_hv = (d rgb_raw @ rgb_w^T) [hv > 0]; g_{l-1} = (g_l W_l^T) [h_{l-1} > 0]
        grad_block<false, true>(acc, act, rr, cc, 0, pr.n, tp.mask + pr.layer * ms + r * tp.mw,
                                tp.mw, 0.f, 0.f, nullptr);
      }
      narrow_publish();
    }
    cl::consumers_sync();  // both warpgroups past the pass's last product: d rgb_raw's tile is free
  }
}

// The registers of the kernel's 384 threads (168 each at launch) moved to
// the consumers: warps 8-11 (producer, address, stores) keep 56, the two
// consumer warpgroups take 224, where the sums, the epilogue's values and
// the bias fit without spills. Each runs once, by a whole warpgroup, at the
// top of its role's path.
__device__ __forceinline__ void narrow_regs_other() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n" ::: "memory");
}
__device__ __forceinline__ void narrow_regs_consumers() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n" ::: "memory");
}

// K2a's narrow instance, forward: a tile of whole rays a CTA (one to three
// 128-row passes, or S / 128 for long rays), clusters of kNarrowG tiles.
template <bool kContract>
__global__ void __launch_bounds__(cl::kThreads, 1)
    train_narrow_kernel(const __grid_constant__ NarrowParams p) {
  const Field& f = p.c.t.f;
  narrow_init(p.c.geo);
  const int q1 = f.rows / kRows * cl::fwd_products(f);
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
  if (warp >= cl::kProducerWarp) {  // the paths never reconverge: setmaxnreg holds
    narrow_regs_other();
    if (warp == cl::kProducerWarp) {
      if ((threadIdx.x & 31) == 0) narrow_produce(f, p.c.geo, 0, q1);
    } else if (warp == kAddrWarp) {
      narrow_hand_a(f, p.c.geo, p.c.L, 0, q1);
    } else if ((threadIdx.x & 31) == 0) {
      narrow_store(p, 0, q1, warp - kStoreWarp);
    }
    wg::cluster_sync_any();  // no CTA leaves while another tile's multicast may still land
  } else {
    narrow_regs_consumers();
    narrow_fwd<kContract>(p);
    wg::cluster_sync_any();
  }
}

// K2a's narrow instance, backward: the same grid, after the forward kernel
// (its own kernel, as the cluster route's, so that ptxas pipelines each).
__global__ void __launch_bounds__(cl::kThreads, 1)
    train_narrow_bwd_kernel(const __grid_constant__ NarrowParams p) {
  const Field& f = p.c.t.f;
  narrow_init(p.c.geo);
  const int passes = f.rows / kRows;
  const int q0 = cl::fwd_products(f) * passes, q1 = q0 + cl::bwd_products(f) * passes;
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
  if (warp >= cl::kProducerWarp) {
    narrow_regs_other();
    if (warp == cl::kProducerWarp) {
      if ((threadIdx.x & 31) == 0) narrow_produce(f, p.c.geo, q0, q1);
    } else if (warp == kAddrWarp) {
      narrow_hand_a(f, p.c.geo, p.c.L, q0, q1);
    } else if ((threadIdx.x & 31) == 0) {
      narrow_store(p, q0, q1, warp - kStoreWarp);
    }
    wg::cluster_sync_any();
  } else {
    narrow_regs_consumers();
    narrow_bwd(p);
    wg::cluster_sync_any();
  }
}

// The tensor map of a bf16 stash at base: `cols` columns at row stride ld
// elements over `rows` rows (and `layers` of them at a stride of layer_rows
// x ld, or rows x ld where layer_rows is 0, a 3-D map, where layers > 0),
// boxes of 64 rows and 64 columns swizzled by 128 bytes (sw: a warpgroup's
// rows of the act block's panels, K2b's k-block panels) or of 128 rows and
// 8 columns (the encoding tiles' k-groups). Returns 0, or cudaErrorUnknown
// where the CUDA library has no encoder or refuses.
int stash_map(CUtensorMap* map, const bf16* base, long long cols, long long ld, long long rows,
              long long layers, bool sw, long long layer_rows = 0) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess || fn == nullptr)
      return static_cast<int>(cudaErrorUnknown);
    encode = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
  }
  const cuuint32_t rank = layers > 0 ? 3 : 2;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(layers > 0 ? layers : 1)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(ld * 2),
                                 static_cast<cuuint64_t>((layer_rows > 0 ? layer_rows : rows) *
                                                         ld * 2)};
  const cuuint32_t box[3] = {sw ? 64u : 8u, sw ? kRows / 2u : kRows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult rc = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<bf16*>(base),
                             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                             sw ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
                             CU_TENSOR_MAP_L2_PROMOTION_NONE,
                             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorUnknown);
}

// ---- K2b: dW = A^T G over rows, the bias sums db = sum_rows G folded in ----
//
// dw_wgmma_kernel, for every K2a route. A job is one product's weight
// gradient dW (K x N) = A^T G over the call's rows (A a stash of K columns,
// G one of N), split over rows into per-split f32 partials that
// reduce_kernel sums in split order. What bounds it is reading the stashes
// (~10 KB a sample row at paper width, ~0.3 of the operations' time on the
// tensor cores), so its design reads each stash byte from device memory
// once per split and job:
//  * a work item is a job's column block of G (all of N up to 256; wider G
//    in blocks of 256, the last one taking an 8-column tail where N = 256 b
//    + 8, as [dfeat | dsigma | 0] has at F = 256) over one split's rows
//    (~kSplitRows). It is a cluster of ceil(K / 128) CTAs (at most
//    kDwMaxCluster; a launch's clusters all take the widest job's size, and
//    the CTAs past a job's K leave at once), CTA r owning dW rows [128 r,
//    128 r + 128): A's columns [128 r, 128 r + 128) and every column of the
//    block;
//  * the first thread of warp 8 keeps TMA loads (cp.async.bulk.tensor, 3-D
//    maps over the h and G stashes' layers) of 64-row k-blocks in flight
//    into a ring of kDwMaxStages slots: its own CTA's two 64-column A
//    panels, and a share of G's panels (panel p by CTA p % C) multicast to
//    every CTA of the cluster, so a G byte is read once for all of A's
//    columns. TMA's zero fill covers the ragged edges (rows past the call's,
//    columns past a stash's width); the boxes land 128-byte swizzled;
//  * two consumer warpgroups run wgmma.m64n256k16 (and m64n8k16 on the
//    tail) with both operands MN-major from shared memory (A^T's M and G's
//    N run along the stash rows' columns, K along the rows: the transpose
//    bits set), 64 dW rows each, the sums in registers for the whole split;
//    each slot is freed, in every CTA of the cluster, once the next k-block's
//    group has started;
//  * warps 9 and 10 of the item's first CTA sum the bias columns of G
//    (db_l = sum_rows G_l) from the same slots on the CUDA cores, each warp
//    over its half of every k-block, in a fixed order (dw_bias).
// Each partial element is written by one CTA (no float atomics): two calls
// on the same inputs give bit-identical gradients. Jobs launch in order of
// their bytes a row (the heaviest first, so the light ones fill the last
// wave), kJobs a launch, every item of a job over every split.

constexpr int kDwRows = 64;        // stash rows a ring slot: a k-block
constexpr int kDwM = 128;          // dW rows (A columns) a CTA: two warpgroups of 64
constexpr int kDwN = 256;          // G columns a column block (wgmma n256) ...
constexpr int kDwTail = 8;         // ... and the tail past them (wgmma n8) where N = 256 b + 8
constexpr int kDwMaxCluster = 8;   // CTAs a cluster: the m-blocks a G block's multicast feeds
constexpr int kDwMaxStages = 4;
constexpr int kDwThreads = 384;    // warps 0-7 consumers, 8 producer, 9-10 the bias sums
constexpr int kDwProducerWarp = 8, kDwBiasWarp = 9;
constexpr uint32_t kDwPanel = kDwRows * 128;  // a 64-column panel of a k-block: 8 KB
constexpr uint32_t kDwSlot = 7 * kDwPanel;    // A's two panels, G's four, the tail's one
// the barriers (full at 0, empty at 64), the bias sums' second halves (33
// chunks of 8 f32) at 128, the ring at a 1024-byte boundary (the swizzle's)
constexpr uint32_t kDwFullOff = 0, kDwEmptyOff = 64, kDwHalfOff = 128, kDwRingOff = 2048;
static_assert(kDwHalfOff + 4 * (kDwN + kDwTail) <= kDwRingOff, "the bias halves overlap the ring");
constexpr int kSplitRows = 12288;  // rows per split (at most kMaxSplits splits)
// a launch's rows: at most the wrapper's block of 1,048,576 (4096 rays x 256
// samples), 86 splits of ~12,288; a longer call would take longer splits
constexpr int kMaxSplits = 128;
constexpr int kJobs = 24;  // K2b jobs a launch: their table rides in the launch parameters

// The stashes' tensor maps (3-D: columns, the call's rows, layers).
enum DwMap { kDwX = 0, kDwH, kDwFeat, kDwHv, kDwDv, kDwGh, kDwGsf, kDwGhv, kDwRgb, kDwMaps };

struct Job {  // dW (K, N) = A^T G over the rows; with bias_out >= 0 also db = sum_rows G
  long long out;       // offset of dW in the flat gradient
  long long bias_out;  // offset of db in the flat gradient, or -1
  int a_map, a_layer;  // A: map and layer
  int g_map, g_layer;  // G: map and layer
  int bias_col0;       // the first column of G whose sum is kept
  int K, N;
  int mgroups;  // clusters a column block (ceil(K / 128 / cluster))
  int cblocks;  // column blocks (the tail rides on the last)
  int unit0;    // the job's first item among the launch's (item: a column block's cluster)
};

struct DwParams {
  CUtensorMap map[kDwMaps];
  Job jobs[kJobs];
  int n_jobs, cluster, stages, splits;
  long long rows, rows_per_split;
  long long total;  // elements of the flat gradient
  float* partial;   // (splits, total)
};

// G's column blocks of a job N columns wide: blocks of kDwN, the last one
// taking the kDwTail columns past 256 b where N = 256 b + 8.
inline int dw_cblocks(int N) {
  return N > kDwN && N % kDwN == kDwTail ? N / kDwN : (N + kDwN - 1) / kDwN;
}

// The first thread of warp 8: k-block kb's loads into slot kb % stages,
// once every consumer of every CTA of the cluster has freed the slot.
__device__ inline void dw_produce(const DwParams& p, const Job& jb, int rank, int act, int m0,
                                  int n0, bool tail, long long r0, int nk) {
  const uint16_t mask = static_cast<uint16_t>((1u << act) - 1);
  const int a_panels = jb.K - m0 > 64 ? 2 : 1;
  const int g_panels = min(4, (jb.N - n0 + 63) / 64);
  const uint32_t bytes = (a_panels + g_panels + (tail ? 1 : 0)) * kDwPanel;
  const CUtensorMap* amap = &p.map[jb.a_map];
  const CUtensorMap* gmap = &p.map[jb.g_map];
  int slot = 0;
  uint32_t phase = 0;
  for (int kb = 0; kb < nk; ++kb) {
    const int r = static_cast<int>(r0) + kb * kDwRows;
    const uint32_t full = cl::sa(kDwFullOff) + 8 * slot;
    const uint32_t base = cl::sa(kDwRingOff) + slot * kDwSlot;
    wg::mbar_wait_cluster(cl::sa(kDwEmptyOff) + 8 * slot, phase ^ 1);
    wg::mbar_arrive_expect_tx(full, bytes);
    for (int q = 0; q < a_panels; ++q)
      wg::tma_load_3d(base + q * kDwPanel, amap, m0 + 64 * q, r, jb.a_layer, full);
    for (int q = 0; q < g_panels + (tail ? 1 : 0); ++q) {
      if (q % act != rank) continue;
      const uint32_t dst = base + (2 + q) * kDwPanel;  // the tail's panel follows G's four
      if (act > 1)
        wg::tma_load_3d_multicast(dst, gmap, n0 + 64 * q, r, jb.g_layer, full, mask);
      else
        wg::tma_load_3d(dst, gmap, n0 + 64 * q, r, jb.g_layer, full);
    }
    if (++slot == p.stages) {
      slot = 0;
      phase ^= 1;
    }
  }
  // every slot freed by every consumer it feeds: no arrival from another
  // CTA is still on its way when the CTA exits
  for (int i = 0; i < p.stages; ++i) {
    wg::mbar_wait_cluster(cl::sa(kDwEmptyOff) + 8 * slot, phase ^ 1);
    if (++slot == p.stages) {
      slot = 0;
      phase ^= 1;
    }
  }
}

// The consumer warpgroups: warpgroup w's 64 dW rows (A's panel w) times the
// block's 256 columns (and the tail's 8 where the block has them) over the
// split's k-blocks, then into the split's partial. A warpgroup whose rows
// lie past K (the second, where K - m0 <= 64: its panel is never loaded)
// takes no part, and the slots' barriers do not count it (dw_consumers).
__device__ inline void dw_consume(const DwParams& p, const Job& jb, int act, int split, int m0,
                                  int n0, bool tail, int nk) {
  const int w = threadIdx.x >> 7;
  if (64 * w >= jb.K - m0) return;
  const uint32_t signal = (threadIdx.x & 127) == 0;
  float acc[128], tacc[4];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) tacc[i] = 0.f;
  int slot = 0, prev = -1;
  uint32_t phase = 0;
  for (int kb = 0; kb < nk; ++kb) {
    wg::mbar_wait_cluster(cl::sa(kDwFullOff) + 8 * slot, phase);
    wg::fence_regs<128>(acc);
    wg::fence_regs<4>(tacc);
    wg::fence();
    const uint32_t base = cl::sa(kDwRingOff) + slot * kDwSlot;
#pragma unroll
    for (int ks = 0; ks < kDwRows / 16; ++ks) {
      const uint64_t da = wg::desc_mn_sw128(base + w * kDwPanel + ks * 2048, kDwPanel);
      wg::wgmma_n256<1>(acc, da, wg::desc_mn_sw128(base + 2 * kDwPanel + ks * 2048, kDwPanel), 1);
      if (tail)
        wg::wgmma_n8<1>(tacc, da, wg::desc_mn_sw128(base + 6 * kDwPanel + ks * 2048, kDwPanel), 1);
    }
    wg::commit();
    wg::fence_regs<128>(acc);
    wg::fence_regs<4>(tacc);
    if (prev >= 0) {
      wg::wait<1>();
      for (int c = 0; c < act; ++c)
        wg::mbar_arrive_cluster(cl::sa(kDwEmptyOff) + 8 * prev, c, signal);
    }
    prev = slot;
    if (++slot == p.stages) {
      slot = 0;
      phase ^= 1;
    }
  }
  wg::wait<0>();
  wg::fence_regs<128>(acc);
  wg::fence_regs<4>(tacc);
  if (prev >= 0)
    for (int c = 0; c < act; ++c)
      wg::mbar_arrive_cluster(cl::sa(kDwEmptyOff) + 8 * prev, c, signal);

  // the accumulator fragment (wg::wgmma_n256): rows 16 warp + lane / 4 (+ 8),
  // columns 8 j + 2 (lane % 4) (+ 1)
  const int lane = threadIdx.x & 31;
  const int m = m0 + 64 * w + 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
  const int c0 = n0 + 2 * (lane & 3);
  const int K = jb.K, N = jb.N;
  float* out = p.partial + static_cast<long long>(split) * p.total + jb.out;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (m + 8 * h >= K) continue;
    float* row = out + static_cast<long long>(m + 8 * h) * N;
#pragma unroll
    for (int j = 0; j < kDwN / 8; ++j) {
      const int n = c0 + 8 * j;
      if (n < N) row[n] = acc[4 * j + 2 * h];
      if (n + 1 < N) row[n + 1] = acc[4 * j + 2 * h + 1];
    }
    if (tail) {
      row[c0 + kDwN] = tacc[2 * h];
      row[c0 + kDwN + 1] = tacc[2 * h + 1];
    }
  }
}

// Warps 9 and 10 of the item's first CTA: the sums over the split's rows of
// G's columns [max(n0, bias_col0), N) of the block, in 8-column chunks.
// Warp h takes rows [32 h, 32 h + 32) of every k-block; where the block has
// C <= 32 chunks, L = 32 / C (rounded down to a power of two) lanes share a
// chunk, lane c L + t summing rows 32 h + t, 32 h + t + L, ... in row order
// (past 32 chunks, lane l takes chunks l and l + 32: the tail's, past G's
// four panels). At the end each chunk's L lanes are added by a shuffle
// butterfly and warp 1's sums to warp 0's, in that order, into the split's
// partial: a fixed order whatever the timing.
__device__ inline void dw_bias(const DwParams& p, const Job& jb, int act, int split, int n0,
                               bool tail, int nk) {
  const int h = (threadIdx.x >> 5) - kDwBiasWarp, lane = threadIdx.x & 31;
  const int cs = max(0, jb.bias_col0 - n0) / 8;
  const int ce = (min(jb.N - n0, kDwN + (tail ? kDwTail : 0)) + 7) / 8;
  int per = 1;  // lanes a chunk (a block with no bias columns: ce <= cs, no chunk)
  if (ce > cs)
    while (per * 2 * (ce - cs) <= 32) per *= 2;
  const int sub = lane & (per - 1), c_lane = cs + lane / per;
  float s[2][8];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int e = 0; e < 8; ++e) s[i][e] = 0.f;
  int slot = 0;
  uint32_t phase = 0;
  for (int kb = 0; kb < nk; ++kb) {
    wg::mbar_wait_cluster(cl::sa(kDwFullOff) + 8 * slot, phase);
    const uint32_t base = kDwRingOff + slot * kDwSlot;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = c_lane + 32 * i;
      if (c >= ce) continue;
      const uint32_t panel = base + (2 + c / 8) * kDwPanel;  // chunk 32: the tail's panel
      const int jc = c < 32 ? c % 8 : 0;
      for (int r = 32 * h + sub; r < 32 * h + 32; r += 4 * per) {  // four rows' loads in flight
        uint4 v[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int rr = r + k * per;
          v[k] = rr < 32 * h + 32 ? *reinterpret_cast<const uint4*>(
                                        cl::smem + panel + rr * 128 + ((jc ^ (rr & 7)) << 4))
                                  : make_uint4(0, 0, 0, 0);
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const uint32_t u[4] = {v[k].x, v[k].y, v[k].z, v[k].w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[i][2 * e] += __uint_as_float(u[e] << 16);
            s[i][2 * e + 1] += __uint_as_float(u[e] & 0xffff0000u);
          }
        }
      }
    }
    __syncwarp();
    for (int c = 0; c < act; ++c)
      wg::mbar_arrive_cluster(cl::sa(kDwEmptyOff) + 8 * slot, c, lane == 0);
    if (++slot == p.stages) {
      slot = 0;
      phase ^= 1;
    }
  }
  for (int d = 1; d < per; d *= 2)  // the chunk's lanes, a butterfly
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 8; ++e) s[i][e] += __shfl_xor_sync(0xffffffffu, s[i][e], d);
  float* half = reinterpret_cast<float*>(cl::smem + kDwHalfOff);
  const bool owner = sub == 0;
  if (h == 1 && owner) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = c_lane + 32 * i;
      if (c < ce)
#pragma unroll
        for (int e = 0; e < 8; ++e) half[(c - cs) * 8 + e] = s[i][e];
    }
  }
  wg::named_sync(1, 64);
  if (h == 0 && owner) {
    float* out = p.partial + static_cast<long long>(split) * p.total + jb.bias_out;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = c_lane + 32 * i;
      if (c >= ce) continue;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int n = n0 + 8 * c + e;
        if (n < jb.N) out[n] = s[i][e] + half[(c - cs) * 8 + e];
      }
    }
  }
}

// The consumer warpgroups of a cluster of `act` live CTAs that take part
// (dw_consume): two a CTA, less the last CTA's second where its rows of dW
// past m0 are 64 or fewer. Each frees every slot of every CTA.
__device__ inline int dw_consumers(const Job& jb, int act, int m_last) {
  return 2 * act - (jb.K - m_last > 64 ? 0 : 1);
}

// One CTA of a work item: cluster c of the launch is item c / splits (its
// job's column block and m-group) over split c % splits.
__global__ void __launch_bounds__(kDwThreads, 1) dw_wgmma_kernel(const __grid_constant__ DwParams p) {
  const int rank = static_cast<int>(blockIdx.x) % p.cluster;  // = %cluster_ctarank (1-D clusters)
  const int cid = static_cast<int>(blockIdx.x) / p.cluster;
  const int item = cid / p.splits, split = cid % p.splits;
  int j = 0;
  while (j + 1 < p.n_jobs && p.jobs[j + 1].unit0 <= item) ++j;
  const Job& jb = p.jobs[j];
  const int v = item - jb.unit0;
  const int cb = v / jb.mgroups, mg = v % jb.mgroups;
  const int mblocks = (jb.K + kDwM - 1) / kDwM;
  const int act = min(p.cluster, mblocks - mg * p.cluster);  // the cluster's CTAs with rows of dW
  const bool live = rank < act;
  const int m0 = (mg * p.cluster + rank) * kDwM, n0 = cb * kDwN;
  const bool tail = jb.N > kDwN && jb.N % kDwN == kDwTail && cb == jb.cblocks - 1;
  const bool bias = jb.bias_out >= 0 && mg == 0;  // the first CTA sums G's bias columns
  const long long r0 = static_cast<long long>(split) * p.rows_per_split;
  const long long r1 = min(p.rows, r0 + p.rows_per_split);
  const int nk = r1 > r0 ? static_cast<int>((r1 - r0 + kDwRows - 1) / kDwRows) : 0;
  // a CTA past the job's m-blocks leaves at once, freeing its SM: the live
  // CTAs never touch its shared memory, and the cluster barriers wait only
  // for threads that have not exited
  if (!live) return;
  if (threadIdx.x == 0) {
    if (cl::sa(kDwRingOff) & 1023u) __trap();  // the 128-byte swizzle needs 1024-byte panels
    for (int s = 0; s < p.stages; ++s) {
      wg::mbar_init(cl::sa(kDwFullOff) + 8 * s, 1);
      wg::mbar_init(cl::sa(kDwEmptyOff) + 8 * s,
                    dw_consumers(jb, act, (mg * p.cluster + act - 1) * kDwM) + (bias ? 2 : 0));
    }
    wg::mbar_init_fence();
  }
  __syncwarp();
  wg::cluster_sync();  // every CTA's barriers exist before any remote arrival or multicast
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
  if (warp >= kDwProducerWarp) {  // the paths never reconverge: setmaxnreg holds
    narrow_regs_other();
    if (warp == kDwProducerWarp) {
      if ((threadIdx.x & 31) == 0) dw_produce(p, jb, rank, act, m0, n0, tail, r0, nk);
    } else if (bias && rank == 0 && warp < kDwBiasWarp + 2) {
      dw_bias(p, jb, act, split, n0, tail, nk);
    }
    wg::cluster_sync_any();  // no CTA leaves while another's multicast or arrival may still land
  } else {
    narrow_regs_consumers();
    dw_consume(p, jb, act, split, m0, n0, tail, nk);
    wg::cluster_sync_any();
  }
}

__global__ void reduce_kernel(const float* partial, int splits, long long total, float* out) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += partial[k * total + i];
  out[i] = s;
}

// d feat_b[f] = sum_j view_w[f, j] db_view[j] (view_w packed, K = F, N = V)
__global__ void feat_bias_kernel(const bf16* view_w, int F, int V, const float* db_view,
                                 float* db_feat) {
  const int f = blockIdx.x * blockDim.x + threadIdx.x;
  if (f >= F) return;
  const int KT = F / 16, kt = f / 16, rem = f % 16;
  const int h = rem / 8, t4 = (rem % 8) / 2, e = rem % 2;
  float s = 0.f;
  for (int n = 0; n < V; ++n) {
    const int lane = (n % 8) * 4 + t4;
    const long long idx = ((static_cast<long long>(n / 8) * KT + kt) * 32 + lane) * 4 + h * 2 + e;
    s += __bfloat162float(view_w[idx]) * db_view[n];
  }
  db_feat[f] = s;
}

// ---- scratch: the stashes and the partials, carved from one buffer ----

struct Scratch {
  bf16 *sx, *sh, *sfeat, *shv, *sdv, *gh, *gsf, *ghv, *grgb;
  uint32_t* mask;
  float* vals;  // the per-sample values
  float* partial;
  size_t bytes;
};

long long splits_for(long long rows) {
  long long s = (rows + kSplitRows - 1) / kSplitRows;
  return s < 1 ? 1 : (s > kMaxSplits ? kMaxSplits : s);
}

// Rows of a K2b split: splits_for's share rounded up to whole k-blocks (no
// k-block crosses a split); ceil(rows / rows_per_split) splits launch, at
// most splits_for(rows).
long long rows_per_split(long long rows) {
  const long long s = splits_for(rows);
  return ((rows + s - 1) / s + kDwRows - 1) / kDwRows * kDwRows;
}

constexpr int kDwDevices = 64;  // devices whose K2b set-up is kept

// K2b's ring stages (at most kDwMaxStages) in the card's opt-in shared
// memory and its dynamic shared memory, set on the kernel once a device and
// kept, as smem_optin keeps the opt-in size. Returns 0, -5 where not two
// stages fit, or a cudaError_t.
int dw_setup(int* stages, size_t* smem) {
  static std::atomic<int> known[kDwDevices];  // the stages once set; 0: not yet
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  int n = dev < kDwDevices ? known[dev].load(std::memory_order_relaxed) : 0;
  if (n == 0) {
    size_t optin = 0;
    int rc = smem_optin(&optin);
    if (rc != 0) return rc;
    const long long fit = (static_cast<long long>(optin) - kDwRingOff) / kDwSlot;
    if (fit < 2) return -5;
    n = static_cast<int>(fit < kDwMaxStages ? fit : kDwMaxStages);
    rc = set_smem(dw_wgmma_kernel, kDwRingOff + static_cast<size_t>(n) * kDwSlot);
    if (rc != 0) return rc;
    if (dev < kDwDevices) known[dev].store(n, std::memory_order_relaxed);
  }
  *stages = n;
  *smem = kDwRingOff + static_cast<size_t>(n) * kDwSlot;
  return 0;
}

// Launches K2b's `ctas` CTAs in clusters of p.cluster, after checking that
// the card holds one such cluster at once (asked once a device and cluster
// size, at dw_setup's shared memory). Returns 0 or a cudaError_t, or -5
// where no cluster fits.
int dw_launch(const DwParams& p, long long ctas, size_t smem, cudaStream_t stream) {
  static std::atomic<int> fits[kDwDevices][kDwMaxCluster + 1];  // 1 fits, -1 not, 0 not asked
  if (ctas == 0) return 0;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(kDwThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  int fit = dev < kDwDevices ? fits[dev][p.cluster].load(std::memory_order_relaxed) : 0;
  if (fit == 0) {
    cfg.gridDim = dim3(p.cluster);
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, dw_wgmma_kernel, &cfg);
    if (err != cudaSuccess) return static_cast<int>(err);
    fit = clusters >= 1 ? 1 : -1;
    if (dev < kDwDevices) fits[dev][p.cluster].store(fit, std::memory_order_relaxed);
  }
  if (fit < 0) return -5;
  cfg.gridDim = dim3(static_cast<unsigned>(ctas));
  err = cudaLaunchKernelEx(&cfg, dw_wgmma_kernel, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// 32-bit words of relu bits per row: the widest masked layer's columns
int mask_words(int W, int V) { return ((W > V ? W : V) + 31) / 32; }

Scratch scratch_layout(unsigned char* base, long long rows_pad, long long rows, int L, int W,
                       int F, int V, int P, int D, long long total) {
  Scratch s;
  size_t at = 0;
  auto bf = [&](long long elems) {
    unsigned char* here = base + at;
    at += (static_cast<size_t>(elems) * sizeof(bf16) + 255) & ~static_cast<size_t>(255);
    return reinterpret_cast<bf16*>(here);
  };
  s.sx = bf(rows_pad * P);
  s.sh = bf(rows_pad * W * L);
  s.sfeat = bf(rows_pad * F);
  s.shv = bf(rows_pad * V);
  s.sdv = bf(rows_pad * D);
  s.gh = bf(rows_pad * W * L);
  s.gsf = bf(rows_pad * (F + 8));
  s.ghv = bf(rows_pad * V);
  s.grgb = bf(rows_pad * 8);
  s.mask = reinterpret_cast<uint32_t*>(base + at);
  at += (static_cast<size_t>((L + 1) * rows_pad * mask_words(W, V)) * sizeof(uint32_t) + 255) &
        ~static_cast<size_t>(255);
  s.vals = reinterpret_cast<float*>(base + at);
  at += (static_cast<size_t>(kVals * rows_pad) * sizeof(float) + 255) & ~static_cast<size_t>(255);
  s.partial = reinterpret_cast<float*>(base + at);
  at += static_cast<size_t>(splits_for(rows) * total) * sizeof(float);
  s.bytes = at;
  return s;
}

// rows of every stash: the CTAs' whole tiles (R rays of S samples each),
// a multiple of `group` tiles (the cluster instance's row groups a cluster)
long long rows_padded(long long n_rays, int S, int group = 1) {
  const int rays = rays_per_cta(S);
  const long long tiles = (n_rays + rays - 1) / rays;
  return (tiles + group - 1) / group * group * (rays * S);
}

// K2a's instances: narrow (train_narrow_kernel, wgmma, up to kNarrowWidth),
// cluster (train_cluster_kernel, the wide route) or mma.sync wide
// (train_wide_kernel). fused_train.K2_ROUTES names them in this order.
enum TrainMode { kNarrow, kCluster, kWide };

// Which instance K2a takes: up to kNarrowWidth the narrow one where its
// layout fits; past that (wider fields, or encodings the narrow layout
// does not hold beside its ring) the cluster one where cl::takes, else the
// mma.sync wide one (past 2,048 wide, or encodings too wide for the
// cluster layout too). Sets *mode; returns 0 or a cudaError_t.
int train_mode(const Field& f, TrainMode* mode) {
  size_t optin = 0;
  const int rc = smem_optin(&optin);
  if (rc != 0) return rc;
  if (widest(f) <= kNarrowWidth && narrow_stages(f, optin) > 0) {
    *mode = kNarrow;
    return 0;
  }
  *mode = cl::takes(f, true, optin) ? kCluster : kWide;
  return 0;
}

// The tiles a cluster of the mode's instance takes together (rows_padded's
// group): the cluster instance's row groups, the narrow instance's
// kNarrowG, else 1.
int tile_group(const Field& f, TrainMode mode) {
  if (mode == kNarrow) return kNarrowG;
  if (mode != kCluster) return 1;
  long long w_elems = 0, b_elems = 0;
  return cl::make_geo(f, true, &w_elems, &b_elems).G;
}

// Bytes of the cluster instance's repacked weights and biases, after the
// scratch_layout's bytes (0 for the other modes).
size_t pack_scratch(const Field& f, TrainMode mode, size_t* b_at) {
  *b_at = 0;
  if (mode != kCluster && mode != kNarrow) return 0;
  long long w_elems = 0, b_elems = 0;
  cl::make_geo(f, true, &w_elems, &b_elems);
  return cl::pack_bytes(w_elems, b_elems, b_at);
}

size_t align256(size_t bytes) { return (bytes + 255) & ~static_cast<size_t>(255); }

}  // namespace

extern "C" {

// Bytes of scratch nerf_fused_train_grads needs; `total` is the number of
// gradient elements (packed matrices, then packed biases). Negative: -1 for
// a sample count the kernels do not take, else a cudaError_t negated.
long long nerf_fused_train_scratch_bytes(long long n_rays, int S, int depth_l, int W, int F,
                                         int V, int P, int D, long long total) {
  if (!takes_samples(S)) return -1;
  Field f;
  set_layout(&f, S, W, F, V, P, D);
  f.n_layers = depth_l;
  TrainMode mode = kNarrow;
  const int rc = train_mode(f, &mode);
  if (rc != 0) return -static_cast<long long>(rc);
  size_t b_at = 0;
  const size_t stash = scratch_layout(nullptr, rows_padded(n_rays, S, tile_group(f, mode)),
                                      n_rays * S, depth_l, W, F, V, P, D, total)
                           .bytes;
  const size_t packed = pack_scratch(f, mode, &b_at);
  return static_cast<long long>(packed > 0 ? align256(stash) + packed : stash);
}

// The instance nerf_fused_train_grads takes for these shapes (TrainMode: 0
// narrow, 1 cluster, 2 mma.sync wide); negative as
// nerf_fused_train_scratch_bytes.
int nerf_fused_train_route(int S, int W, int F, int V, int P, int D) {
  if (!takes_samples(S)) return -1;
  Field f;
  set_layout(&f, S, W, F, V, P, D);
  TrainMode mode = kNarrow;
  const int rc = train_mode(f, &mode);
  if (rc != 0) return -rc;
  return static_cast<int>(mode);
}

// The byte offsets in nerf_fused_train_grads's scratch of its stashes (sx,
// sh, sfeat, shv, sdv, gh, gsf, ghv, grgb: fused_train.STASHES), then the
// stashes' rows (rows_pad), into out[0..9], for the card tests that read
// K2b's inputs back. Returns 0, or negative as
// nerf_fused_train_scratch_bytes.
int nerf_fused_train_stash_offsets(long long n_rays, int S, int depth_l, int W, int F, int V,
                                   int P, int D, long long total, long long* out) {
  if (!takes_samples(S)) return -1;
  Field f;
  set_layout(&f, S, W, F, V, P, D);
  f.n_layers = depth_l;
  TrainMode mode = kNarrow;
  const int rc = train_mode(f, &mode);
  if (rc != 0) return -rc;
  const long long rows_pad = rows_padded(n_rays, S, tile_group(f, mode));
  const Scratch s =
      scratch_layout(nullptr, rows_pad, n_rays * S, depth_l, W, F, V, P, D, total);
  const bf16* at[9] = {s.sx, s.sh, s.sfeat, s.shv, s.sdv, s.gh, s.gsf, s.ghv, s.grgb};
  for (int i = 0; i < 9; ++i)  // the layout from a null base: offsets
    out[i] = static_cast<long long>(reinterpret_cast<uintptr_t>(at[i]));
  out[9] = rows_pad;
  return 0;
}

// Padded rows of one launch at the padded S: the most whole tiles within
// max_rows rows whose scratch less the partials (the stashes, and on the
// cluster route the repacked weights) takes at most max_bytes, one tile at
// least (fused_train.BLOCK_ROWS, BLOCK_BYTES).
// Negative: -1 for a sample count the kernels do not take, else a
// cudaError_t negated.
long long nerf_fused_train_block_rows(int S, int depth_l, int W, int F, int V, int P, int D,
                                      long long max_rows, long long max_bytes) {
  if (!takes_samples(S)) return -1;
  Field f;
  set_layout(&f, S, W, F, V, P, D);
  f.n_layers = depth_l;
  TrainMode mode = kNarrow;
  const int rc = train_mode(f, &mode);
  if (rc != 0) return -static_cast<long long>(rc);
  const long long tile = rows_padded(1, S);
  const int group = tile_group(f, mode);
  size_t b_at = 0;
  const size_t packed = pack_scratch(f, mode, &b_at);
  // nerf_fused_train_scratch_bytes less the partials: the stashes of the
  // tiles rounded to the cluster's tiles, and the repacked weights
  auto stash = [&](long long tiles) {
    const long long rows = (tiles + group - 1) / group * group * tile;
    const size_t bytes = scratch_layout(nullptr, rows, rows, depth_l, W, F, V, P, D, 0).bytes;
    return static_cast<long long>(packed > 0 ? align256(bytes) + packed : bytes);
  };
  long long lo = 1, hi = max_rows / tile;  // the most tiles lies in [lo, hi]
  while (lo < hi) {
    const long long mid = hi - (hi - lo) / 2;
    if (stash(mid) <= max_bytes) lo = mid;
    else hi = mid - 1;
  }
  return lo * tile;
}

// Returns 0, a cudaError_t from a launch, or a negative code for a shape
// the kernels do not take (see nerf_rs_tpu_torch/kernels/fused_ray.py).
// grads: f32, the packed matrices' gradients at w_off, then the biases'
// at (matrix elements) + b_off. w_off and b_off lie in host memory;
// `offsets` is their device table (Field::off); wt_off (host) and
// `wt_offsets` (device) hold the n_wt transposed matrices' offsets into wt.
// radii: (n_rays,) f32 with ipe = 1, else null.
int nerf_fused_train_grads(const void* o, const void* d, const void* vd, const void* ts,
                           const void* deltas, const void* radii, const void* gold,
                           const void* w, const void* b, const long long* w_off, int n_w,
                           const long long* b_off, int n_b, const void* offsets, const void* wt,
                           const long long* wt_off, const void* wt_offsets, int n_wt,
                           const void* sigma_row, void* diag,
                           void* wts, void* grads, void* scratch, long long n_rays, int S,
                           int depth_l, int skip, int W, int F, int V, int P, int D,
                           int pos_levels, int dir_levels, int sigma_act, int ipe, int white_bg,
                           float loss_scale, int contract, float dist_scale, float dist_a,
                           float dist_b, int dist_disparity, void* stream) {
  TrainParams p;
  int rc = init_field(&p.f, o, d, vd, ts, deltas, radii, w, b, offsets, w_off, n_w, b_off, n_b,
                      n_rays, S, depth_l, skip, W, F, V, P, D, pos_levels, dir_levels,
                      sigma_act, ipe);
  if (rc != 0) return rc;
  if (n_wt != depth_l + 2 || wt_offsets == nullptr) return -2;
  if (contract != 0 && contract != 1) return -8;
  if (dist_disparity != 0 && dist_disparity != 1) return -9;
  const int L = depth_l;
  const long long total_w = w_off[L + 4] + static_cast<long long>(V) * 8;
  const long long total = total_w + b_off[L + 2] + 8;
  TrainMode mode = kNarrow;
  rc = train_mode(p.f, &mode);
  if (rc != 0) return rc;
  const long long rows_pad = rows_padded(n_rays, S, tile_group(p.f, mode));
  const long long rows = n_rays * S;
  const Scratch s = scratch_layout(static_cast<unsigned char*>(scratch), rows_pad, rows, L, W,
                                   F, V, P, D, total);
  p.gold = static_cast<const float*>(gold);
  p.wt = static_cast<const bf16*>(wt);
  p.wt_off = static_cast<const long long*>(wt_offsets);
  for (int i = 0; i < kParamOffs; ++i) p.wt_head[i] = i < n_wt ? wt_off[i] : 0;
  p.sigma_row = static_cast<const float*>(sigma_row);
  p.diag = static_cast<float*>(diag);
  p.wts = static_cast<float*>(wts);
  p.rows_pad = rows_pad;
  p.sx = s.sx;
  p.sh = s.sh;
  p.sfeat = s.sfeat;
  p.shv = s.shv;
  p.sdv = s.sdv;
  p.gh = s.gh;
  p.gsf = s.gsf;
  p.ghv = s.ghv;
  p.grgb = s.grgb;
  p.mask = s.mask;
  p.mw = mask_words(W, V);
  p.vals = s.vals;
  p.loss_scale = loss_scale;
  p.white_bg = white_bg;
  p.dist_scale = dist_scale;
  p.dist_a = dist_a;
  p.dist_b = dist_b;
  p.dist_disparity = dist_disparity;

  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
  int dw_stages = 0;
  size_t dw_smem = 0;
  rc = dw_setup(&dw_stages, &dw_smem);
  if (rc != 0) return rc;
  if (mode == kCluster || mode == kNarrow) {  // the weights repacked after the stashes
    TrainClusterParams q;
    q.t = p;
    long long w_elems = 0, b_elems = 0;
    q.geo = cl::make_geo(p.f, true, &w_elems, &b_elems);
    size_t b_at = 0;
    cl::pack_bytes(w_elems, b_elems, &b_at);
    unsigned char* at = static_cast<unsigned char*>(scratch) + align256(s.bytes);
    q.geo.wp = reinterpret_cast<const bf16*>(at);
    q.geo.bp = reinterpret_cast<const float*>(at + b_at);
    size_t optin = 0;
    rc = smem_optin(&optin);
    if (rc != 0) return rc;
    const bool narrow = mode == kNarrow;
    // the narrow forward's biases in shared memory where they fit at kMinStages or more
    int bias_floats = (L + 2) * cl::kBlock;
    q.geo.stages = narrow ? narrow_stages(p.f, optin, bias_floats) : 0;
    if (narrow && q.geo.stages == 0) {
      bias_floats = 0;
      q.geo.stages = narrow_stages(p.f, optin);
    }
    if (!narrow) q.geo.stages = cl::fit_stages(p.f, true, optin);
    NarrowSmem ns = {};
    q.L = narrow ? narrow_layout(p.f, q.geo.stages, &ns, bias_floats)
                 : cl::cluster_layout(p.f, true, q.geo.stages);
    if (narrow) {
      q.geo.G = kNarrowG;  // four tiles a cluster (rows_padded's group: tile_group)
      auto kernel = contract ? train_narrow_kernel<true> : train_narrow_kernel<false>;
      rc = set_smem(kernel, q.L.total);
      if (rc == 0) rc = set_smem(train_narrow_bwd_kernel, q.L.total);
      if (rc != 0 || n_rays == 0) return rc;
      NarrowParams np;
      np.c = q;
      np.s = ns;
      rc = stash_map(&np.map[kMapX], s.sx, P, P, rows_pad, 0, false);
      if (rc == 0) rc = stash_map(&np.map[kMapDv], s.sdv, D, D, rows_pad, 0, false);
      if (rc == 0) rc = stash_map(&np.map[kMapH], s.sh, W, W, rows_pad, L, true);
      if (rc == 0) rc = stash_map(&np.map[kMapFeat], s.sfeat, F, F, rows_pad, 0, true);
      if (rc == 0) rc = stash_map(&np.map[kMapHv], s.shv, V, V, rows_pad, 0, true);
      if (rc == 0) rc = stash_map(&np.map[kMapGhv], s.ghv, V, V, rows_pad, 0, true);
      if (rc == 0) rc = stash_map(&np.map[kMapGsf], s.gsf, F, F + 8, rows_pad, 0, true);
      if (rc == 0) rc = stash_map(&np.map[kMapGh], s.gh, W, W, rows_pad, L, true);
      if (rc == 0) rc = cl::pack(p.f, q.geo, p.f.w, w_off, p.f.b, b_off, p.wt, wt_off, st);
      if (rc != 0) return rc;
      const long long tiles = (n_rays + p.f.R - 1) / p.f.R;
      rc = cl::launch(kernel, np, q.geo, tiles, q.L.total, st);
      if (rc == 0) rc = cl::launch(train_narrow_bwd_kernel, np, q.geo, tiles, q.L.total, st);
      if (rc != 0) return rc;
    } else {
      auto kernel = contract ? train_cluster_kernel<true> : train_cluster_kernel<false>;
      rc = set_smem(kernel, q.L.total);
      if (rc != 0) return rc;
      rc = set_smem(train_cluster_bwd_kernel, q.L.total);
      if (rc != 0) return rc;
      if (n_rays == 0) return 0;
      rc = cl::pack(p.f, q.geo, p.f.w, w_off, p.f.b, b_off, p.wt, wt_off, st);
      if (rc != 0) return rc;
      const long long tiles = (n_rays + p.f.R - 1) / p.f.R;
      rc = cl::launch(kernel, q, q.geo, tiles, q.L.total, st);
      if (rc != 0) return rc;
      rc = cl::launch(train_cluster_bwd_kernel, q, q.geo, tiles, q.L.total, st);
      if (rc != 0) return rc;
    }
  } else {
    const size_t smem = wide_layout(p.f).total;  // the mma.sync wide instance
    auto tile = contract ? train_wide_kernel<true> : train_wide_kernel<false>;
    rc = set_smem(tile, smem);
    if (rc != 0) return rc;
    if (n_rays == 0) return 0;
    const unsigned ctas = static_cast<unsigned>(rows_pad / p.f.rows);
    tile<<<ctas, kThreads, smem, st>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }

  // K2b's jobs, in the packed order (depth + 4 or + 5 of them), each
  // writing its own slots of the partials; launched heaviest first, kJobs
  // at a time (one launch up to depth 19)
  const bool skip_on = skip > 0 && skip < L;
  std::vector<Job> jobs;
  jobs.reserve(L + 5);
  // bias: the offset of db among the biases, or -1 where another job sums this G
  auto job = [&](int a_map, int a_layer, int K, int g_map, int g_layer, int N, long long out,
                 long long bias, int bias_col0) {
    Job& jb = jobs.emplace_back();
    jb.out = out;
    jb.bias_out = bias < 0 ? -1 : total_w + bias;
    jb.a_map = a_map;
    jb.a_layer = a_layer;
    jb.g_map = g_map;
    jb.g_layer = g_layer;
    jb.bias_col0 = bias_col0;
    jb.K = K;
    jb.N = N;
  };
  for (int l = 0; l < L; ++l)
    job(l == 0 ? kDwX : kDwH, l == 0 ? 0 : l - 1, l == 0 ? P : W, kDwGh, l, W, w_off[l], b_off[l],
        0);
  if (skip_on) job(kDwX, 0, P, kDwGh, skip, W, w_off[L], -1, 0);
  // the sigma block of [dfeat | dsigma | 0] only: no partial holds d feat_b,
  // which feat_bias_kernel writes over reduce_kernel's sum of those slots
  job(kDwH, L - 1, W, kDwGsf, 0, F + 8, w_off[L + 1], b_off[L], F);
  job(kDwFeat, 0, F, kDwGhv, 0, V, w_off[L + 2], b_off[L + 1], 0);
  job(kDwDv, 0, D, kDwGhv, 0, V, w_off[L + 3], -1, 0);
  job(kDwHv, 0, V, kDwRgb, 0, 8, w_off[L + 4], b_off[L + 2], 0);
  int cluster = 1;
  for (const Job& jb : jobs) cluster = std::max(cluster, (jb.K + kDwM - 1) / kDwM);
  cluster = std::min(cluster, kDwMaxCluster);
  // a work item's bytes a row: its cluster's A columns and its G block's
  auto cost = [&](const Job& jb) {
    const int tail = jb.N > kDwN && jb.N % kDwN == kDwTail ? kDwTail : 0;
    return std::min(jb.K, cluster * kDwM) + std::min(jb.N, kDwN) + tail;
  };
  std::stable_sort(jobs.begin(), jobs.end(),
                   [&](const Job& x, const Job& y) { return cost(x) > cost(y); });

  DwParams q;
  const long long rows_pad_l = rows_pad;
  rc = stash_map(&q.map[kDwX], s.sx, P, P, rows, 1, true, rows_pad_l);
  if (rc == 0) rc = stash_map(&q.map[kDwH], s.sh, W, W, rows, L, true, rows_pad_l);
  if (rc == 0) rc = stash_map(&q.map[kDwFeat], s.sfeat, F, F, rows, 1, true, rows_pad_l);
  if (rc == 0) rc = stash_map(&q.map[kDwHv], s.shv, V, V, rows, 1, true, rows_pad_l);
  if (rc == 0) rc = stash_map(&q.map[kDwDv], s.sdv, D, D, rows, 1, true, rows_pad_l);
  if (rc == 0) rc = stash_map(&q.map[kDwGh], s.gh, W, W, rows, L, true, rows_pad_l);
  if (rc == 0) rc = stash_map(&q.map[kDwGsf], s.gsf, F + 8, F + 8, rows, 1, true, rows_pad_l);
  if (rc == 0) rc = stash_map(&q.map[kDwGhv], s.ghv, V, V, rows, 1, true, rows_pad_l);
  if (rc == 0) rc = stash_map(&q.map[kDwRgb], s.grgb, 8, 8, rows, 1, true, rows_pad_l);
  if (rc != 0) return rc;
  q.rows = rows;
  q.rows_per_split = rows_per_split(rows);
  const long long splits = (rows + q.rows_per_split - 1) / q.rows_per_split;
  q.splits = static_cast<int>(splits);
  q.cluster = cluster;
  q.stages = dw_stages;
  q.total = total;
  q.partial = s.partial;
  const int n_jobs = static_cast<int>(jobs.size());
  for (int j0 = 0; j0 < n_jobs; j0 += kJobs) {
    int items = 0;
    q.n_jobs = n_jobs - j0 < kJobs ? n_jobs - j0 : kJobs;
    for (int i = 0; i < q.n_jobs; ++i) {
      Job& jb = q.jobs[i];
      jb = jobs[j0 + i];
      jb.mgroups = ((jb.K + kDwM - 1) / kDwM + cluster - 1) / cluster;
      jb.cblocks = dw_cblocks(jb.N);
      jb.unit0 = items;
      items += jb.mgroups * jb.cblocks;
    }
    rc = dw_launch(q, static_cast<long long>(items) * splits * cluster, dw_smem, st);
    if (rc != 0) return rc;
  }
  float* out = static_cast<float*>(grads);
  reduce_kernel<<<static_cast<unsigned>((total + 255) / 256), 256, 0, st>>>(
      s.partial, static_cast<int>(splits), total, out);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  feat_bias_kernel<<<(F + 127) / 128, 128, 0, st>>>(p.f.w + w_off[L + 2], F, V,
                                                    out + total_w + b_off[L + 1],
                                                    out + total_w + b_off[L]);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!skip_on) {  // no skip layer: its matrix gets no gradient
    err = cudaMemsetAsync(out + w_off[L], 0, sizeof(float) * P * W, st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

const char* nerf_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
