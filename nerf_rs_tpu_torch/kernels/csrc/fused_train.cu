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
//  * K2b (dw_partial_kernel): dW_l = A_l^T G_l as a hand-written mma.sync
//    reduction over rows, 128 x 128 tiles of 8 warps fed by a 3-stage
//    cp.async ring of 32-row slices (A^T and G fragments through
//    ldmatrix.trans), split over rows into per-split f32 partials that
//    reduce_kernel sums in a fixed order. The blocks of a job's first
//    m-tile also sum the staged G columns over their rows: the bias sums
//    db_l = sum_rows G_l land in the same partials, so G is read once for
//    them. No float atomics: two calls on the same inputs give
//    bit-identical gradients.
// At flagship size (4096 rays x 64 samples) the stashes are ~5 KB per
// sample row each way, ~2.7 GB per call with the partials, on an 80 GB
// card; the hierarchical union pass (4096 x 192 rows) takes ~8.3 GB.
//
// What bounds each. K2a's products (the forward, then the input gradients:
// ~2.3 MFLOP a sample row at paper width) and its stashes (~10 KB a row)
// are about equal on an H100: at the flagship shape ~0.61 ms of bf16
// operations and ~0.80 ms of bytes. K2b is bound by reading the stashes
// (each A is read once per 128-column tile of G, and each G once per
// 128-row tile of A).
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
// rgb head (narrow_rgb) run on the consumers. K2b reads the stashes as
// before.

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
// 128-row passes, or S / 128 for long rays), clusters of two tiles.
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
// elements over `rows` rows (and `layers` of them at a stride of rows x ld,
// a 3-D map, where layers > 0), boxes of 64 rows and 64 columns swizzled by
// 128 bytes (sw: a warpgroup's rows of the act block's panels) or of 128
// rows and 8 columns (the encoding tiles' k-groups). Returns 0, or
// cudaErrorUnknown where the CUDA library has no encoder or refuses.
int stash_map(CUtensorMap* map, const bf16* base, long long cols, long long ld, long long rows,
              long long layers, bool sw) {
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
                                 static_cast<cuuint64_t>(rows * ld * 2)};
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

constexpr int kBT = 128;     // dW tile: kBT x kBT, 8 warps of 64 x 32
constexpr int kBK = 32;      // rows per stage
constexpr int kStages = 3;   // the cp.async ring
constexpr int kLdt = kBT + 8;
constexpr int kStageElems = 2 * kBK * kLdt;  // A's rows, then G's
constexpr size_t kRedSmem = sizeof(bf16) * kStages * kStageElems;  // 52,224 B
constexpr int kRedThreads = 256;
constexpr int kSplitRows = 8192;  // rows per split (at most kMaxSplits splits)
// a launch's rows: at most the wrapper's block of 1,048,576 (4096 rays x 256
// samples), 128 splits of 8,192; a longer call would take longer splits
constexpr int kMaxSplits = 128;
constexpr int kJobs = 24;  // K2b jobs a launch: their table rides in the launch parameters

struct Job {  // dW (K, N) = A^T G over the rows; with bias_out >= 0 also db = sum_rows G
  const bf16* a;
  const bf16* g;
  long long out;       // offset of dW in the flat gradient
  long long bias_out;  // offset of db in the flat gradient, or -1
  int bias_col0;       // the first column of G whose sum is kept
  int K, N, tiles_n, tile0;
};

struct ReduceParams {
  Job jobs[kJobs];
  int n_jobs;
  long long rows, rows_per_split;
  long long total;  // elements of the flat gradient
  float* partial;   // (splits, total)
};

__global__ void __launch_bounds__(kRedThreads, 2) dw_partial_kernel(const ReduceParams p) {
  extern __shared__ __align__(16) unsigned char red_smem[];
  bf16* ring = reinterpret_cast<bf16*>(red_smem);
  __shared__ float upper[kBT];  // the bias sums of the stages' upper 16 rows
  int j = 0;
  while (j + 1 < p.n_jobs && p.jobs[j + 1].tile0 <= static_cast<int>(blockIdx.x)) ++j;
  const Job& job = p.jobs[j];
  const int tile = blockIdx.x - job.tile0;
  const int m0 = (tile / job.tiles_n) * kBT, n0 = (tile % job.tiles_n) * kBT;
  const long long r_begin = blockIdx.y * p.rows_per_split;
  const long long r_end = min(p.rows, r_begin + p.rows_per_split);
  const int steps = r_end > r_begin ? static_cast<int>((r_end - r_begin + kBK - 1) / kBK) : 0;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp & 1) * 64, wn = (warp >> 1) * 32;
  const bool busy = m0 + wm < job.K && n0 + wn < job.N;  // the warp's tile has real columns
  const bool bias = m0 == 0 && job.bias_out >= 0;        // block-uniform
  const int bc = tid % kBT, bh = tid / kBT;              // bias: column, half of the rows

  // one stage: kBK rows x kBT columns of A and of G, zeros past the edges
  auto load = [&](int step) {
    bf16* as = ring + (step % kStages) * kStageElems;
    bf16* gs = as + kBK * kLdt;
    const long long r = r_begin + static_cast<long long>(step) * kBK;
    for (int i = tid; i < kBK * (kBT / 8); i += kRedThreads) {
      const int row = i / (kBT / 8), c8 = (i % (kBT / 8)) * 8;
      const long long gr = r + row;
      const bool a_ok = gr < r_end && m0 + c8 < job.K;
      const bool g_ok = gr < r_end && n0 + c8 < job.N;
      cp_async16(as + row * kLdt + c8, a_ok ? job.a + gr * job.K + m0 + c8 : job.a, a_ok);
      cp_async16(gs + row * kLdt + c8, g_ok ? job.g + gr * job.N + n0 + c8 : job.g, g_ok);
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
  float bsum = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) load(s);
    cp_async_commit();
  }
  for (int step = 0; step < steps; ++step) {
    cp_async_wait<kStages - 2>();  // this step's stage has landed (for this thread) ...
    __syncthreads();               // ... and for all; the slot refilled below is free
    if (step + kStages - 1 < steps) load(step + kStages - 1);
    cp_async_commit();
    const bf16* as = ring + (step % kStages) * kStageElems;
    const bf16* gs = as + kBK * kLdt;
    if (busy) {
#pragma unroll
      for (int ks = 0; ks < kBK; ks += 16) {
        // A operand = A^T (m = A column, k = row): ldmatrix.trans of 8x8 blocks
        // (rows k, columns m); lanes 8-15 take m + 8, lanes 16-31 k + 8
        uint32_t a[4][4], b[2][4];
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
          ldmatrix_x4_trans(a[mt], as + (ks + (lane & 7) + ((lane >> 4) << 3)) * kLdt + wm +
                                       mt * 16 + ((lane >> 3) & 1) * 8);
        // B operand = G (k = row, n = G column): lanes 8-15 take k + 8, lanes
        // 16-31 the next n8 tile
#pragma unroll
        for (int np = 0; np < 2; ++np)
          ldmatrix_x4_trans(b[np], gs + (ks + (lane & 7) + ((lane >> 3) & 1) * 8) * kLdt + wn +
                                       np * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
            mma_16816(acc[mt][nt], a[mt], b[nt >> 1][(nt & 1) * 2], b[nt >> 1][(nt & 1) * 2 + 1]);
      }
    }
    if (bias) {  // rows bh * 16 .. bh * 16 + 15 of the stage, in order
#pragma unroll
      for (int k = 0; k < kBK / 2; ++k)
        bsum += __bfloat162float(gs[(bh * (kBK / 2) + k) * kLdt + bc]);
    }
  }

  float* out = p.partial + blockIdx.y * p.total;
  if (busy) {
    const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = m0 + wm + mt * 16 + g + 8 * h;
          const int n = n0 + wn + nt * 8 + 2 * t4;
          float* o = out + job.out + static_cast<long long>(m) * job.N + n;
          if (m < job.K) {
            if (n < job.N) o[0] = acc[mt][nt][2 * h];
            if (n + 1 < job.N) o[1] = acc[mt][nt][2 * h + 1];
          }
        }
  }
  if (bias) {  // lower half + upper half, in that order
    if (bh == 1) upper[bc] = bsum;
    __syncthreads();
    const int n = n0 + bc;
    if (bh == 0 && n < job.N && n >= job.bias_col0) out[job.bias_out + n] = bsum + upper[bc];
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
      if (rc == 0) rc = set_smem(dw_partial_kernel, kRedSmem);
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
      rc = set_smem(dw_partial_kernel, kRedSmem);
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
    rc = set_smem(dw_partial_kernel, kRedSmem);
    if (rc != 0) return rc;
    if (n_rays == 0) return 0;
    const unsigned ctas = static_cast<unsigned>(rows_pad / p.f.rows);
    tile<<<ctas, kThreads, smem, st>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }

  // K2b's jobs, in the packed order (depth + 4 or + 5 of them), launched
  // kJobs at a time (one launch up to depth 19); each job writes its own
  // slots of the partials
  std::vector<Job> jobs;
  jobs.reserve(L + 5);
  const long long hs = rows_pad * W;
  const bool skip_on = skip > 0 && skip < L;
  // bias: the offset of db among the biases, or -1 where another job sums this G
  auto job = [&](const bf16* a, int K, const bf16* g, int N, long long out, long long bias,
                 int bias_col0) {
    Job& jb = jobs.emplace_back();
    jb.a = a;
    jb.g = g;
    jb.out = out;
    jb.bias_out = bias < 0 ? -1 : total_w + bias;
    jb.bias_col0 = bias_col0;
    jb.K = K;
    jb.N = N;
    jb.tiles_n = (N + kBT - 1) / kBT;
  };
  for (int l = 0; l < L; ++l)
    job(l == 0 ? s.sx : s.sh + (l - 1) * hs, l == 0 ? P : W, s.gh + l * hs, W, w_off[l],
        b_off[l], 0);
  if (skip_on) job(s.sx, P, s.gh + skip * hs, W, w_off[L], -1, 0);
  // the sigma block of [dfeat | dsigma | 0] only: no partial holds d feat_b,
  // which feat_bias_kernel writes over reduce_kernel's sum of those slots
  job(s.sh + (L - 1) * hs, W, s.gsf, F + 8, w_off[L + 1], b_off[L], F);
  job(s.sfeat, F, s.ghv, V, w_off[L + 2], b_off[L + 1], 0);
  job(s.sdv, D, s.ghv, V, w_off[L + 3], -1, 0);
  job(s.shv, V, s.grgb, 8, w_off[L + 4], b_off[L + 2], 0);
  const long long splits = splits_for(rows);
  ReduceParams q;
  q.rows = rows;
  q.rows_per_split = (rows + splits - 1) / splits;
  q.total = total;
  q.partial = s.partial;
  const int n_jobs = static_cast<int>(jobs.size());
  for (int j0 = 0; j0 < n_jobs; j0 += kJobs) {
    int tiles = 0;
    q.n_jobs = n_jobs - j0 < kJobs ? n_jobs - j0 : kJobs;
    for (int i = 0; i < q.n_jobs; ++i) {
      q.jobs[i] = jobs[j0 + i];
      q.jobs[i].tile0 = tiles;
      tiles += ((q.jobs[i].K + kBT - 1) / kBT) * q.jobs[i].tiles_n;
    }
    dw_partial_kernel<<<dim3(tiles, static_cast<unsigned>(splits)), kRedThreads, kRedSmem, st>>>(
        q);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
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
