// Whole-ray NeRF render kernel for Hopper (sm_90a), K1.
//
// Replaces nerf_rs_tpu/kernels/fused_ray.py::_ray_kernel, the Pallas TPU
// kernel, for the paper field (PE or mip-NeRF's IPE, trunk with skip,
// [feature | sigma] head, view head, sigmoid rgb) and alpha compositing.
// Per ray it reads (o, d, viewdir, ts, deltas, and with IPE the cone
// radius) and writes rgb, acc, depth and the per-sample weights and
// sigma; per-sample activations never leave the SM.
//
// What bounds it. Per sample row the field costs ~1.29 MFLOP of bf16
// products (flops_row in the JAX wrapper) against ~36 B of input per ray
// (0.6 B per row at S = 64): the products bound it, at the tensor cores'
// rate (20.1 ms for a 262,144 x 64 chunk on an H100 SXM at 989 TFLOP/s).
// What stood between them and that rate: mma.sync tiles that re-read their
// operands from shared memory, a CTA-wide barrier on every k-step, a
// second round over K for the sigma column, one thread per ray in the
// scan, and the weights (1.19 MB at paper width) leaving L2 once per 128
// rows, ~156 GB per chunk.
//
// Design: persistent CTAs of 384 threads, one per SM, in clusters of
// kCluster = 2, each taking tiles b, b + grid, ... (a tile: whole rays in
// 128-row passes, below).
//  * Two consumer warpgroups take each 128-row pass, 64 rows each, and run
//    every layer as wgmma.m64nNk16 products (field_wgmma.cuh): A from the
//    activation, PE and view-encoding tiles in shared memory, B from a ring
//    of weight slices, the sums (64 x 256 f32 a warpgroup, 128 registers a
//    thread) in registers. The [feature | sigma] head is one k-loop of an
//    n256 and an n8 product. The sums start from the bias; each epilogue
//    (relu or none, bf16) writes the warpgroup's own rows back over the tile
//    the product read, so one activation tile serves every layer, and a
//    proxy fence and a warpgroup barrier order it before the next product.
//  * One producer warp (one thread copying) streams the weights, one k16
//    step a slot, through kStages slots with bulk copies, a full and an
//    empty mbarrier per slot: no CTA-wide barrier in the products, and the
//    next layer's, pass's or tile's steps are in flight through every
//    epilogue.
//  * Three encoder warps read the next tile's rays and samples and encode
//    each of its passes (points or IPE moments, contraction, PE / IPE,
//    PE(viewdir)) into the free one of two encoding buffers, handed over by
//    mbarriers, while the consumers multiply the current one: the tensor
//    cores no longer wait for a tile's inputs and encode, except the first.
//  * The two CTAs of a cluster share every weight slice: each producer
//    copies half of it and multicasts it to both, so a weight byte read
//    from L2 serves 256 rows (~78 GB a chunk). A consumer warpgroup frees a
//    slot in both CTAs (an empty barrier counts 2 warpgroups x 2 CTAs).
//    The grid is as many whole clusters as the card holds at once, and
//    every CTA takes the same number of tiles; a tile past the last ray
//    runs on zero rows and stores nothing (kernels/fused_ray.k1_cta_rays
//    mirrors the mapping).
//  * The scan runs a warp per ray: a shuffle prefix sum of sigma * delta 32
//    samples at a time, f32 (the TPU kernel's triangular-matmul prefix sum
//    exists only because Mosaic has no cumsum).
// What ptxas needs to pipeline the products, and what it did without it
// (every wgmma waited for the last): products of compile-time shapes in
// straight-line stages, the roles and trip counts warp-uniform to it, and
// no accumulator live from one product into the next. So the paper's
// widths (trunk 256, feature 256, view 128) have their own instance; other
// widths (each product padded to a power of two from 16, pack_weights_k1)
// take one that picks the shape at run time and runs serialized.
// Rays per tile: 128 / S rays when S divides 128, two rays of S =
// 192 in three passes of 128 rows, or one ray of S = 256 or longer in S /
// 128 passes (the wrapper pads S to a power of two up to 128, to 192 for
// 129 to 192, to 256 for 193 to 256, else to the next multiple of 128, with
// zero-length intervals whose weight is exactly 0; a pass may end one ray
// and start the next: a row's ray is (tile row) / S).
// Streamed instances (kStream): past 256 samples, or where the resident
// layout (the tile's per-sample values, ~44 B a row, and the biases, which
// grow with depth) does not fit beside the ~204 KB of ring, activation and
// encoding tiles. Raw sigma and rgb then hold one pass, double-buffered by
// pass; after each pass the consumers composite the rays it holds, a warp
// per ray as below, and a ray that goes on into the next pass leaves its
// running sums (the exclusive sum of sigma * delta and each lane's shares
// of the colour, acc and depth) in a carry buffer; the weights and sigma go
// to device memory as each pass is composited, ts and deltas are read from
// device memory where they are used, and the biases from device memory. A
// ray's segments start at multiples of 32 samples, so each lane sums the
// same samples in the same order as in the resident scan. The resident
// instances are as they were.
//
// IPE (cfg.ipe): per row the conical frustum's Gaussian (ipe_moments),
// encoded as sin / cos damped by exp(-4^l var / 2), in the PE's column
// layout. Contraction (cfg.contract, mip-NeRF 360; the TPU kernel's
// contract branch, fused_ray.py:95-105): each row's point or Gaussian is
// contracted into the radius-2 ball before the encoding (field.cuh), a
// template parameter.
//
// Numerics and traps: see field.cuh (no fast math, sinf/cosf with exact
// ldexpf scales, o + t*d without FMA, IPE moments rounded op by op); expf
// in compositing.
//
// Wide fields (fault 13). The wgmma instances take widths up to kMaxWidth =
// 256: a warpgroup's 64 x 256 f32 sums fill 128 registers a thread, and the
// one activation tile, which each epilogue overwrites in place, would have
// to hold a wider product's input until its last column round. A wider
// field (the JAX kernel takes any width) runs the cluster instance
// (fused_ray_cluster_kernel, field_cluster.cuh): the same scheme lifted to a
// row group of ceil(width / 256) CTAs of a cluster, each holding its 256
// columns of the activation tile and computing those columns of every
// product, reading the other columns' k-steps from the other CTAs' shared
// memory, with two tiles a cluster sharing each weight slot by multicast;
// then a warp per ray composites each pass as the streamed instance does.
// Past 2,048 wide (more than 8 CTAs a row group), or where even its layout
// does not hold the encodings, fused_ray_wide_kernel runs: K2's mma.sync
// machinery in column rounds of 256 with its A operands staged from two
// activation buffers a CTA in device memory (field.cuh's
// field_forward_wide), on a persistent grid of one CTA an SM, then the
// resident compositing; its shared memory (~60 KB) does not grow with the
// width or the encodings, so no field is refused. PERF.md has the times.
//
// Wide encodings (fault 17). The streamed instance keeps two buffers of
// each pass's encodings beside the ring and the activation tile, 512 (P +
// D) bytes: past P = 112 at the paper widths (pos_enc_levels 19 and more)
// no wgmma layout fits the card's opt-in shared memory, while the JAX
// kernel takes any encoding. Such a field takes the wide routes too (the
// cluster instance holds P + D up to ~300): k1_route decides, for the
// launch and for nerf_fused_ray_scratch_bytes alike, so the wrapper follows
// the scratch's size (the cluster route's repacked weights, or the mma.sync
// instance's activations) and never decides on its own.
//
// The offsets of the packed matrices and biases lie in a device table
// (Field::off, one per packing, built and kept by the wrapper), not in the
// launch parameters: a field of any depth launches. The first kParamOffs
// offsets also ride in the parameters (Field::w_head, b_head), and the
// wgmma instances take the two heads' bias offsets there (Params), where
// the producer and the consumers read them from the constant bank, as
// before the table.

#include "field.cuh"
#include "field_cluster.cuh"
#include "field_wgmma.cuh"

namespace {

using namespace nerf;

constexpr int kConsumers = 2;                   // consumer warpgroups: 64 rows each
constexpr int kEncoders = 96;                   // encoder threads: three warps
constexpr int kK1Threads = 128 * kConsumers + 32 + kEncoders;  // + the producer warp
constexpr int kStages = 9;                      // weight slices (one k16 step each) in the ring
constexpr int kCluster = 2;                     // CTAs sharing each weight slice
constexpr int kMaxWidth = kNarrowWidth;         // widest product a warpgroup sums
constexpr int kConsumerBar = 1;                 // named barriers: consumers, then per warpgroup
constexpr int kEncoderBar = kConsumerBar + 1 + kConsumers;

// Byte offsets of the CTA's shared-memory regions, computed on the host
// (k1_layout) and read from the kernel's parameter space: kept out of the
// consumers' registers, which the wgmma pipeline needs.
struct K1Smem {
  uint32_t ring, bars, act, xs[2], ds[2], mv, sig_raw, rgb, ts[2], dl[2], w, sg, ray, dpe, bias,
      carry, total;
};

// The products' widths, each padded to a power of two from 16 to 256 (a
// compile-time wgmma shape; kernels/fused_render.pack_weights_k1 pads the
// matrices' columns with zeros alike): trunk, feature, view.
struct Widths {
  int w, f, v;
};

struct Params {
  Field f;
  K1Smem L;
  Widths n;
  // The trunk's, feature's and view head's biases, each layer's n in the
  // order the quad lane q of an accumulator fragment (columns 8 j + 2 q +
  // {0, 1}) reads them, two n8 tiles a 16-byte load, the quad's four loads
  // contiguous (no bank conflict): column c = 8 j + 2 q + e at 16 (j / 2)
  // + 4 q + 2 (j % 2) + e (fused_render.pack_weights_k1).
  const float* bias;
  // The [feature | sigma] and rgb heads' bias offsets in f.b, read from the
  // parameters at any depth (the consumers' loads from the device table
  // sat in their paths)
  long long b_sf, b_rgb;
  int iters;  // tiles each CTA takes: CTA b's k-th is b + k gridDim
  float* rgb;
  float* acc;
  float* depth;
  float* wts;
  float* sigma;
};

// The product sequence of one pass, as the producer streams it: trunk
// layers 0..skip, the skip input's matrix, the rest of the trunk, then
// [feature | sigma], view (feature part), view (direction part), rgb. Mat
// is a matrix's index in the packed offsets, its K and its packed N.
struct Mat {
  int m, K, N;
};

__host__ __device__ inline int n_products(const Field& f) {
  return f.n_layers + 4 + (f.skip > 0 && f.skip < f.n_layers ? 1 : 0);
}

__host__ __device__ inline Mat mat_at(const Field& f, const Widths& n, int q) {
  const int L = f.n_layers;
  int m;
  if (f.skip > 0 && f.skip < L)
    m = q <= f.skip ? q : (q == f.skip + 1 ? L : (q <= L ? q - 1 : q));
  else
    m = q < L ? q : q + 1;
  if (m < L) return {m, m == 0 ? f.P : f.W, n.w};
  if (m == L) return {m, f.P, n.w};
  if (m == L + 1) return {m, f.W, n.f + 8};
  if (m == L + 2) return {m, f.F, n.v};
  if (m == L + 3) return {m, f.D, n.v};
  return {m, f.V, 8};
}

// a product's width: the next power of two from 16
inline int padded_width(int n) {
  int p = 16;
  while (p < n) p *= 2;
  return p;
}

// bytes of one ring slot: one k16 step of the widest packed matrix
__host__ __device__ inline uint32_t slot_bytes(const Widths& n) {
  const int a = n.w > n.f + 8 ? n.w : n.f + 8;
  return static_cast<uint32_t>(32 * (a > n.v ? a : n.v));
}

// stream: the streamed instance's layout (a pass's raw sigma and rgb twice,
// the carry buffer; no ts, deltas, weights, sigma or biases)
inline K1Smem k1_layout(const Field& f, const Widths& n, bool stream) {
  const int rows = stream ? 0 : f.rows, pass_rows = stream ? 2 * kRows : f.rows;
  K1Smem L;
  size_t at = 0;
  L.ring = take(&at, static_cast<size_t>(kStages) * slot_bytes(n));
  L.bars = take(&at, sizeof(uint64_t) * (2 * kStages + 6));
  L.act = take(&at, sizeof(bf16) * kRows * widest(f));
  for (int b = 0; b < 2; ++b) {
    L.xs[b] = take(&at, sizeof(bf16) * kRows * f.P);
    L.ds[b] = take(&at, sizeof(bf16) * kRows * f.D);
    L.ts[b] = take(&at, sizeof(float) * rows);
    L.dl[b] = take(&at, sizeof(float) * rows);
  }
  L.mv = take(&at, sizeof(float) * kRows * 6);
  L.sig_raw = take(&at, sizeof(float) * pass_rows);
  L.rgb = take(&at, sizeof(float) * pass_rows * 4);
  L.w = take(&at, sizeof(float) * rows);
  L.sg = take(&at, sizeof(float) * rows);
  L.ray = take(&at, sizeof(float) * f.R * kRayStride);
  L.dpe = take(&at, sizeof(float) * f.R * f.D);
  L.bias = take(&at, stream ? 0 : sizeof(float) * (f.n_layers * f.W + f.F + f.V));
  L.carry = take(&at, stream ? sizeof(float) * 2 * 6 * 32 : 0);
  L.total = static_cast<uint32_t>(at);
  return L;
}

// ---- the producer: one thread streams every k16 step of the CTA's passes ----
__device__ void produce(const Params& p, uint32_t ring, uint32_t full, uint32_t empty) {
  const Field& f = p.f;
  const uint32_t slot_b = slot_bytes(p.n);
  const uint32_t rank = wg::cluster_rank();
  int slot = 0;
  uint32_t phase = 0;
  const int np = n_products(f), passes = f.rows / kRows * p.iters;
  for (int pass = 0; pass < passes; ++pass) {
    for (int q = 0; q < np; ++q) {
      const Mat mt = mat_at(f, p.n, q);
      const char* src = reinterpret_cast<const char*>(f.w + w_off(f, mt.m));
      const uint32_t bytes = static_cast<uint32_t>(32 * mt.N), half = bytes / kCluster;
      for (int k = 0; k < mt.K / 16; ++k) {
        wg::mbar_wait(empty + 8 * slot, phase ^ 1);
        wg::mbar_arrive_expect_tx(full + 8 * slot, bytes);
        wg::bulk_copy_multicast(ring + slot * slot_b + rank * half,
                                src + static_cast<size_t>(k) * bytes + rank * half, half,
                                full + 8 * slot, (1u << kCluster) - 1);
        if (++slot == kStages) {
          slot = 0;
          phase ^= 1;
        }
      }
    }
  }
  // every slot freed by every consumer of the cluster: no remote arrival is
  // still on its way to this CTA's barriers when it exits
  for (int i = 0; i < kStages; ++i) {
    wg::mbar_wait(empty + 8 * slot, phase ^ 1);
    if (++slot == kStages) {
      slot = 0;
      phase ^= 1;
    }
  }
}

// The consumers' view of the ring.
struct Ring {
  uint32_t base, full, empty, slot_b;
  int slot;
  uint32_t phase;
};

// acc = b + A1 W1 [+ A2 W2] over the N columns of matrices packed ntot wide
// (the A operands: this warpgroup's rows of 128-row tiles at a1 and a2, k1
// and k2 columns, k2 = 0 for none; the matrices' k16 steps come next in
// the ring, one a slot); with kSigma also sig = A1 W1[:, N:N+8] (the
// [feature | sigma] head's n8 tile). b4: this lane's bias quads
// (Params::bias order, lane q's first at 4 q, the next 16 floats on), one
// for two n8 tiles, nb of them real (the layer's width / 16), or null for
// none: the sums start
// from the bias, whose loads overlap the wait for the first slice, so the
// epilogues only apply the activation. A slot is released once the next
// step's group has started (wait_group 1). The shape is a template
// parameter and each stage one straight-line group: ptxas serializes every
// wgmma of a function that has one on a path it cannot prove uniform, or
// products whose shapes are chosen at run time.
template <int N, bool kSigma>
__device__ __forceinline__ void product(Ring& rg, float* acc, float* sig, uint32_t a1, int k1,
                                        uint32_t a2, int k2, int ntot, const float4* b4, int nb) {
  const uint32_t lbo_b = static_cast<uint32_t>(ntot) * 16;
  const uint32_t signal = (threadIdx.x & 127) == 0;  // one arrival per warpgroup
  // the sums start here, so no accumulator is live between products (left
  // live across the pass loop, ptxas found no registers to pipeline the
  // products of different shapes)
  if constexpr (N >= 16) {
#pragma unroll
    for (int jj = 0; jj < N / 16; ++jj) {
      const float4 b = b4 != nullptr && jj < nb ? b4[4 * jj] : make_float4(0.f, 0.f, 0.f, 0.f);
      acc[8 * jj] = acc[8 * jj + 2] = b.x;
      acc[8 * jj + 1] = acc[8 * jj + 3] = b.y;
      acc[8 * jj + 4] = acc[8 * jj + 6] = b.z;
      acc[8 * jj + 5] = acc[8 * jj + 7] = b.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  }
  if (kSigma)
#pragma unroll
    for (int i = 0; i < 4; ++i) sig[i] = 0.f;
  int prev = -1;
  for (int pi = 0; pi < 2; ++pi) {
    const uint32_t a = pi == 0 ? a1 : a2;
    const int steps = (pi == 0 ? k1 : k2) / 16;
    for (int k = 0; k < steps; ++k) {
      wg::mbar_wait(rg.full + 8 * rg.slot, rg.phase);
      wg::fence_regs<N / 2>(acc);
      if (kSigma) wg::fence_regs<4>(sig);
      wg::fence();
      const uint64_t da = wg::desc(a + k * 4096, 2048, 128);
      const uint64_t db = wg::desc(rg.base + rg.slot * rg.slot_b, lbo_b, 128);
      wg::mma<N>(acc, da, db, 1);
      if (kSigma) wg::mma<8>(sig, da, db + static_cast<uint64_t>(N), 1);
      wg::commit();
      wg::fence_regs<N / 2>(acc);
      if (kSigma) wg::fence_regs<4>(sig);
      if (prev >= 0) {
        wg::wait<1>();
        for (int c = 0; c < kCluster; ++c)
          wg::mbar_arrive_cluster(rg.empty + 8 * prev, c, signal);
      }
      prev = rg.slot;
      if (++rg.slot == kStages) {
        rg.slot = 0;
        rg.phase ^= 1;
      }
    }
  }
  wg::wait<0>();
  wg::fence_regs<N / 2>(acc);
  if (kSigma) wg::fence_regs<4>(sig);
  for (int c = 0; c < kCluster; ++c) wg::mbar_arrive_cluster(rg.empty + 8 * prev, c, signal);
}

// product<kN> when kN > 0 (the paper width's instance), else product<N>
// for the padded width np (a uniform kernel parameter). A function that
// chooses its products' shapes at run time gets serialized wgmma from
// ptxas, so only widths other than the paper's take that path.
template <int kN, bool kSigma>
__device__ __forceinline__ void product_w(int np, Ring& rg, float* acc, float* sig, uint32_t a1,
                                          int k1, uint32_t a2, int k2, int ntot,
                                          const float4* b4, int nb) {
  if constexpr (kN > 0) {
    product<kN, kSigma>(rg, acc, sig, a1, k1, a2, k2, ntot, b4, nb);
    return;
  }
  switch (np) {
    case 256:
      product<256, kSigma>(rg, acc, sig, a1, k1, a2, k2, ntot, b4, nb);
      break;
    case 128:
      product<128, kSigma>(rg, acc, sig, a1, k1, a2, k2, ntot, b4, nb);
      break;
    case 64:
      product<64, kSigma>(rg, acc, sig, a1, k1, a2, k2, ntot, b4, nb);
      break;
    case 32:
      product<32, kSigma>(rg, acc, sig, a1, k1, a2, k2, ntot, b4, nb);
      break;
    default:
      product<16, kSigma>(rg, acc, sig, a1, k1, a2, k2, ntot, b4, nb);
  }
}

__device__ __forceinline__ void store_bf2(unsigned char* tile, int r, int c, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(tile + wg::tile_off(r, c)) = __floats2bfloat162_rn(v0, v1);
}

__device__ __forceinline__ void store_bf1(unsigned char* tile, int r, int c, float v) {
  *reinterpret_cast<bf16*>(tile + wg::tile_off(r, c)) = __float2bfloat16_rn(v);
}

// The warpgroup's sums (rows r0 and r0 + 8 of every n8 tile, columns c0 +
// 8 j; the bias already in them) through relu, bf16, back into the
// activation tile. kN > 0: the width n at compile time.
template <int kN>
__device__ __forceinline__ void relu_epilogue(const float* acc, int n, unsigned char* act, int r0,
                                              int c0) {
#pragma unroll
  for (int j = 0; j < kMaxWidth / 8; ++j) {
    if (kN > 0 ? 8 * j < kN : 8 * j < n) {
      const int c = 8 * j + c0;
      store_bf2(act, r0, c, fmaxf(acc[4 * j], 0.f), fmaxf(acc[4 * j + 1], 0.f));
      store_bf2(act, r0 + 8, c, fmaxf(acc[4 * j + 2], 0.f), fmaxf(acc[4 * j + 3], 0.f));
    }
  }
}

// The products' end: generic stores visible to the next wgmma, then the
// warpgroup's barrier.
__device__ __forceinline__ void wg_sync(int wgi) {
  wg::fence_proxy_async();
  wg::named_sync(kConsumerBar + 1 + wgi, 128);
}

__device__ __forceinline__ void consumers_sync() { wg::named_sync(kConsumerBar, 128 * kConsumers); }

// The encoder's barriers: enc_full[b] / enc_empty[b] per encoding buffer
// (xs[b], ds[b]), tile_free[b] per samples buffer (ts[b], dl[b]).
struct TileBars {
  uint32_t enc_full, enc_empty, tile_free;
};

// The CTA's k-th tile: its first ray and its rays in the batch (0 past the
// last ray: zero rows that nothing stores).
__device__ __forceinline__ long long tile_ray0(const Field& f, int k) {
  return (static_cast<long long>(blockIdx.x) + static_cast<long long>(k) * gridDim.x) * f.R;
}

__device__ __forceinline__ int tile_rays(const Field& f, long long ray0) {
  const long long left = f.n_rays - ray0;
  return left <= 0 ? 0 : (left < f.R ? static_cast<int>(left) : f.R);
}

// ---- the encoder: three warps read the next tile's rays and samples and
// encode each of its passes into a free encoding buffer, while the
// consumers multiply the current one ----
template <bool kContract, bool kStream>
__device__ void encode(const Params& p, unsigned char* smem, const TileBars& tb) {
  const Field& f = p.f;
  const K1Smem& L = p.L;
  const int S = f.S, R = f.R, P = f.P, D = f.D;
  const int tid = threadIdx.x - (128 * kConsumers + 32);  // 0 .. kEncoders - 1
  float* mv_all = reinterpret_cast<float*>(smem + L.mv);
  float* ray = reinterpret_cast<float*>(smem + L.ray);
  float* dpe = reinterpret_cast<float*>(smem + L.dpe);
  const int pos_dim = 3 + 6 * f.pos_levels, dir_dim = 3 + 6 * f.dir_levels;
  const int passes = f.rows / kRows;
  int unit = 0;  // passes encoded so far
  for (int k = 0; k < p.iters; ++k) {
    const long long ray0 = tile_ray0(f, k);
    const int n_valid = tile_rays(f, ray0), rows_valid = n_valid * S;
    const int b = k & 1;
    float* ts = reinterpret_cast<float*>(smem + L.ts[b]);
    float* dl = reinterpret_cast<float*>(smem + L.dl[b]);
    // the consumers have composited tile k - 2 out of ts[b] and dl[b]
    if (k >= 2) wg::mbar_wait(tb.tile_free + 8 * b, ((k >> 1) - 1) & 1);
    for (int i = tid; i < R * kRayStride; i += kEncoders) {
      const int j = i / kRayStride, c = i % kRayStride;
      float v = 0.f;
      if (j < n_valid) {
        if (c < 9) {
          const float* src = c < 3 ? f.o : (c < 6 ? f.d : f.vd);
          v = src[(ray0 + j) * 3 + c % 3];
        } else if (f.ipe) {
          v = f.radii[ray0 + j];
        }
      }
      ray[i] = v;
    }
    if (!kStream) {
      for (int r = tid; r < f.rows; r += kEncoders) {
        const bool ok = r < rows_valid;
        ts[r] = ok ? f.ts[ray0 * S + r] : 0.f;
        dl[r] = ok ? f.deltas[ray0 * S + r] : 0.f;
      }
    }
    wg::named_sync(kEncoderBar, kEncoders);
    for (int i = tid; i < R * D; i += kEncoders) {
      const int j = i / D, c = i % D;
      float v = 0.f;
      if (c < dir_dim) v = pe_value(ray[j * kRayStride + 6 + (c < 3 ? c : (c - 3) % 3)], c);
      dpe[i] = v;
    }
    for (int pass = 0; pass < passes; ++pass, ++unit) {
      const int s0 = pass * kRows, e = unit & 1;
      unsigned char* xs = smem + L.xs[e];
      unsigned char* ds = smem + L.ds[e];
      // the consumers are done with encoding buffer e (two units ago)
      if (unit >= 2) wg::mbar_wait(tb.enc_empty + 8 * e, ((unit >> 1) - 1) & 1);
      // ---- per row: the point o + t d, or (IPE) the frustum's mean and variance ----
      for (int r = tid; r < kRows; r += kEncoders) {
        const int cr = s0 + r;
        const float* ry = ray + (cr / S) * kRayStride;
        float* mv = mv_all + r * 6;
        float tv, dv;  // the row's t and delta (0 past the last ray)
        if (kStream) {
          const bool ok = cr < rows_valid;
          tv = ok ? f.ts[ray0 * S + cr] : 0.f;
          dv = ok ? f.deltas[ray0 * S + cr] : 0.f;
        } else {
          tv = ts[cr];
          dv = dl[cr];
        }
        if (f.ipe && cr < rows_valid) {
          ipe_moments(ry, ry + 3, tv, dv, ry[9], mv);
        } else {
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            mv[c] = __fadd_rn(ry[c], __fmul_rn(tv, ry[3 + c]));
            mv[3 + c] = 0.f;
          }
        }
        if (kContract) {
          if (f.ipe)
            contract_gaussian(mv);
          else
            contract_points(mv);
        }
      }
      wg::named_sync(kEncoderBar, kEncoders);
      // ---- the K-major tiles: the raw coordinates and the zero pad columns,
      // then one sincosf per (row, level, axis) for its sin and cos columns
      // (damped alike under IPE), then PE(viewdir) per row ----
      for (int i = tid; i < kRows * (3 + P - pos_dim); i += kEncoders) {
        const int r = i % kRows, u = i / kRows;
        store_bf1(xs, r, u < 3 ? u : pos_dim + u - 3, u < 3 ? mv_all[r * 6 + u] : 0.f);
      }
      for (int i = tid; i < kRows * 3 * f.pos_levels; i += kEncoders) {
        const int r = i % kRows, u = i / kRows, level = u / 3, dim = u % 3;
        const float* mv = mv_all + r * 6;
        float sn, cs;
        sincosf(ldexpf(mv[dim], level), &sn, &cs);
        if (f.ipe) {
          const float damp = expf(-ldexpf(mv[3 + dim], 2 * level - 1));
          sn = __fmul_rn(sn, damp);
          cs = __fmul_rn(cs, damp);
        }
        store_bf1(xs, r, 3 + 6 * level + dim, sn);
        store_bf1(xs, r, 6 + 6 * level + dim, cs);
      }
      for (int i = tid; i < kRows * (D / 2); i += kEncoders) {
        const int r = (((i >> 5) & 15) << 3) | (i & 7), c = 2 * (((i >> 9) << 2) | ((i >> 3) & 3));
        const float* src = dpe + ((s0 + r) / S) * D + c;
        store_bf2(ds, r, c, src[0], src[1]);
      }
      wg::fence_proxy_async();
      wg::named_sync(kEncoderBar, kEncoders);
      if (tid == 0) wg::mbar_arrive_cluster(tb.enc_full + 8 * e, wg::cluster_rank(), 1);
    }
  }
}

// The streamed instance's compositing of the pass at tile row s0 (the
// CTA's unit-th pass; its raw sigma and rgb at pass row r of buffer unit &
// 1): a warp per ray that the pass holds, the resident scan's steps over
// the ray's samples in this pass, from the running sums the pass before
// left in the carry buffer where the ray started there, into the other
// carry buffer where it goes on into the next pass, else reduced and
// stored. Weights and sigma go to device memory here.
__device__ __forceinline__ void composite_pass(const Params& p, unsigned char* smem,
                                               long long ray0, int n_valid, int s0, int unit,
                                               int tid) {
  constexpr int kT = 128 * kConsumers;
  const unsigned full = 0xffffffffu;
  const Field& f = p.f;
  const K1Smem& L = p.L;
  const int S = f.S, lane = tid & 31, b = unit & 1;
  const float* sig_raw = reinterpret_cast<const float*>(smem + L.sig_raw) + b * kRows;
  const float* rgb = reinterpret_cast<const float*>(smem + L.rgb) + b * kRows * 4;
  const float* cin = reinterpret_cast<const float*>(smem + L.carry) + b * 6 * 32;
  float* cout = reinterpret_cast<float*>(smem + L.carry) + (b ^ 1) * 6 * 32;
  const int first = s0 / S, last_row = (s0 + kRows - 1) / S;
  const int last = last_row < n_valid - 1 ? last_row : n_valid - 1;
  for (int j = first + (tid >> 5); j <= last; j += kT / 32) {
    const int lo = s0 > j * S ? s0 - j * S : 0;
    const int hi = s0 + kRows - j * S < S ? s0 + kRows - j * S : S;
    float carry = 0.f, cr = 0.f, cg = 0.f, cb = 0.f, a_sum = 0.f, dep = 0.f;
    if (lo > 0) {
      carry = cin[lane];
      cr = cin[32 + lane];
      cg = cin[64 + lane];
      cb = cin[96 + lane];
      a_sum = cin[128 + lane];
      dep = cin[160 + lane];
    }
    const long long g0 = (ray0 + j) * S;  // the ray's first sample in device memory
    for (int c = lo; c < hi; c += 32) {
      const int s = c + lane, r = j * S + s - s0;
      float sigma = 0.f, a = 0.f;
      if (s < hi) {
        const float raw = sig_raw[r];
        sigma = f.sigma_act == 0 ? fmaxf(raw, 0.f) : fmaxf(raw, 0.f) + log1pf(expf(-fabsf(raw)));
        a = sigma * f.deltas[g0 + s];
      }
      float incl = a;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_up_sync(full, incl, o);
        if (lane >= o) incl += v;
      }
      const float before = __shfl_up_sync(full, incl, 1);
      const float excl = carry + (lane == 0 ? 0.f : before);
      carry += __shfl_sync(full, incl, 31);
      if (s < hi) {
        const float w = expf(-excl) * (1.f - expf(-a));
        cr += w * rgb[r * 4 + 0];
        cg += w * rgb[r * 4 + 1];
        cb += w * rgb[r * 4 + 2];
        a_sum += w;
        dep += w * f.ts[g0 + s];
        p.wts[g0 + s] = w;
        p.sigma[g0 + s] = sigma;
      }
    }
    if (hi < S) {
      cout[lane] = carry;
      cout[32 + lane] = cr;
      cout[64 + lane] = cg;
      cout[96 + lane] = cb;
      cout[128 + lane] = a_sum;
      cout[160 + lane] = dep;
      continue;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      cr += __shfl_xor_sync(full, cr, o);
      cg += __shfl_xor_sync(full, cg, o);
      cb += __shfl_xor_sync(full, cb, o);
      a_sum += __shfl_xor_sync(full, a_sum, o);
      dep += __shfl_xor_sync(full, dep, o);
    }
    if (lane == 0) {
      const long long rr = ray0 + j;
      p.rgb[rr * 3 + 0] = cr;
      p.rgb[rr * 3 + 1] = cg;
      p.rgb[rr * 3 + 2] = cb;
      p.acc[rr] = a_sum;
      p.depth[rr] = dep;
    }
  }
}

// kPaper: the products at the paper's widths (trunk 256, feature 256, view
// 128) as compile-time shapes. kStream: the streamed instance (above).
template <bool kPaper, bool kStream>
__device__ void consume(const Params& p, unsigned char* smem, Ring rg, const TileBars& tb) {
  constexpr int kNW = kPaper ? 256 : 0, kNF = kPaper ? 256 : 0, kNV = kPaper ? 128 : 0;
  const Field& f = p.f;
  const K1Smem& L = p.L;
  const int S = f.S, P = f.P, D = f.D;
  const int tid = threadIdx.x;  // 0 .. 255
  constexpr int kT = 128 * kConsumers;
  const int wgi = __shfl_sync(0xffffffffu, tid >> 7, 0), t = tid & 127;  // warp-uniform
  const uint32_t signal = t == 0, rank = wg::cluster_rank();

  unsigned char* act = smem + L.act;
  float* sig_raw = reinterpret_cast<float*>(smem + L.sig_raw);
  float* rgb = reinterpret_cast<float*>(smem + L.rgb);
  float* wts = reinterpret_cast<float*>(smem + L.w);
  float* sg = reinterpret_cast<float*>(smem + L.sg);
  float* bias_s = reinterpret_cast<float*>(smem + L.bias);
  const float* bias = kStream ? p.bias : bias_s;

  // the trunk's, feature's and view head's biases, already in the
  // epilogues' order (fused_render.pack_weights_k1): 16-byte copies (the
  // streamed instance reads them from device memory)
  if (!kStream) {
    for (int i = tid; i < (f.n_layers * f.W + f.F + f.V) / 4; i += kT)
      reinterpret_cast<float4*>(bias_s)[i] = reinterpret_cast<const float4*>(p.bias)[i];
  }
  consumers_sync();

  // the warpgroup's operand tiles (its 64 rows start 8 row groups in) and
  // its fragment's rows and first column
  const uint32_t off = wgi * 1024;
  const uint32_t act_a = wg::smem_u32(act) + off;
  const int r0 = wgi * 64 + (t >> 5) * 16 + ((t & 31) >> 2);
  const int c0 = 2 * (t & 3);
  const int m = f.n_layers;  // w_off[m] is skip; heads follow; b_off[m] is the first head's
  const int passes = f.rows / kRows;
  float acc[kMaxWidth / 2];
  float sig[4];

  int unit = 0;
  for (int k = 0; k < p.iters; ++k) {
    const long long ray0 = tile_ray0(f, k);
    const int n_valid = tile_rays(f, ray0), rows_valid = n_valid * S;
    const float* ts = reinterpret_cast<const float*>(smem + L.ts[k & 1]);
    const float* dl = reinterpret_cast<const float*>(smem + L.dl[k & 1]);
    for (int pass = 0; pass < passes; ++pass, ++unit) {
      const int s0 = pass * kRows, e = unit & 1;
      const int prow = kStream ? e * kRows : s0;  // the pass's first row in sig_raw and rgb
      const uint32_t xs_a = wg::smem_u32(smem + L.xs[e]) + off;
      const uint32_t ds_a = wg::smem_u32(smem + L.ds[e]) + off;
      wg::mbar_wait(tb.enc_full + 8 * e, (unit >> 1) & 1);

      // ---- trunk ----
      for (int i = 0; i < m; ++i) {
        product_w<kNW, false>(p.n.w, rg, acc, sig, i == 0 ? xs_a : act_a, i == 0 ? P : f.W, xs_a,
                              i == f.skip && i > 0 ? P : 0, p.n.w,
                              reinterpret_cast<const float4*>(bias + i * f.W) + (t & 3),
                              f.W >> 4);
        relu_epilogue<kNW>(acc, f.W, act, r0, c0);
        wg_sync(wgi);
      }

      // ---- [feature | sigma]: bf16 feature (no activation), f32 raw sigma ----
      {
        product_w<kNF, true>(p.n.f, rg, acc, sig, act_a, f.W, 0, 0, p.n.f + 8,
                             reinterpret_cast<const float4*>(bias + m * f.W) + (t & 3),
                             f.F >> 4);
#pragma unroll
        for (int j = 0; j < kMaxWidth / 8; ++j) {
          if (kNF > 0 ? 8 * j < kNF : 8 * j < f.F) {
            const int c = 8 * j + c0;
            store_bf2(act, r0, c, acc[4 * j], acc[4 * j + 1]);
            store_bf2(act, r0 + 8, c, acc[4 * j + 2], acc[4 * j + 3]);
          }
        }
        const float* b = f.b + p.b_sf;
        // sigma is column 0 of the n8 tile: the quad's first lane holds it;
        // every lane of the quad stores it (the same value), so no branch
        // reads a wgmma accumulator
        const int lead = (t & 31) & ~3;
        const float s_a = __shfl_sync(0xffffffffu, sig[0], lead);
        const float s_b = __shfl_sync(0xffffffffu, sig[2], lead);
        sig_raw[prow + r0] = s_a + b[f.F];
        sig_raw[prow + r0 + 8] = s_b + b[f.F];
        wg_sync(wgi);
      }

      // ---- view head: relu(feat W_f + PE(viewdir) W_d + b) ----
      {
        product_w<kNV, false>(p.n.v, rg, acc, sig, act_a, f.F, ds_a, D, p.n.v,
                              reinterpret_cast<const float4*>(bias + m * f.W + f.F) + (t & 3),
                              f.V >> 4);
        // the encoding buffer is read no more: the encoder may refill it
        wg::mbar_arrive_cluster(tb.enc_empty + 8 * e, rank, signal);
        relu_epilogue<kNV>(acc, f.V, act, r0, c0);
        wg_sync(wgi);
      }

      // ---- rgb: sigmoid in f32, three real columns of the 8 ----
      {
        product<8, false>(rg, acc, sig, act_a, f.V, 0, 0, 8, nullptr, 0);
        // lane q of a quad writes column q of its two rows (column 3 is a
        // pad column the scan never reads), fetched from the quad's lane q / 2
        const float* b = f.b + p.b_rgb;
        const int q = t & 3, src = ((t & 31) & ~3) | (q >> 1);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float x0 = __shfl_sync(0xffffffffu, acc[2 * h], src);
          const float x1 = __shfl_sync(0xffffffffu, acc[2 * h + 1], src);
          rgb[(prow + r0 + 8 * h) * 4 + q] = 1.f / (1.f + expf(-((q & 1 ? x1 : x0) + b[q])));
        }
      }
      if (kStream) {
        consumers_sync();  // the pass's raw sigma and rgb are in
        composite_pass(p, smem, ray0, n_valid, s0, unit, tid);
      }
    }
    if (kStream) {  // each pass was composited as it ended
      wg::mbar_arrive_cluster(tb.tile_free + 8 * (k & 1), rank, tid == 0);
      continue;
    }
    consumers_sync();

    // ---- compositing: a warp per ray, 32 samples a step: the exclusive
    // prefix sum of sigma * delta by shuffles (carried between steps), each
    // lane's share of the sums, then one reduction, all f32 ----
    {
      const unsigned full = 0xffffffffu;
      const int lane = tid & 31;
      for (int j = tid >> 5; j < n_valid; j += kT / 32) {
        float carry = 0.f, cr = 0.f, cg = 0.f, cb = 0.f, a_sum = 0.f, dep = 0.f;
        for (int c = 0; c < S; c += 32) {
          const int s = c + lane, r = j * S + s;
          float sigma = 0.f, a = 0.f;
          if (s < S) {
            const float raw = sig_raw[r];
            sigma = f.sigma_act == 0 ? fmaxf(raw, 0.f)
                                     : fmaxf(raw, 0.f) + log1pf(expf(-fabsf(raw)));
            a = sigma * dl[r];
          }
          float incl = a;
#pragma unroll
          for (int o = 1; o < 32; o <<= 1) {
            const float v = __shfl_up_sync(full, incl, o);
            if (lane >= o) incl += v;
          }
          const float before = __shfl_up_sync(full, incl, 1);
          const float excl = carry + (lane == 0 ? 0.f : before);
          carry += __shfl_sync(full, incl, 31);
          if (s < S) {
            const float w = expf(-excl) * (1.f - expf(-a));
            cr += w * rgb[r * 4 + 0];
            cg += w * rgb[r * 4 + 1];
            cb += w * rgb[r * 4 + 2];
            a_sum += w;
            dep += w * ts[r];
            wts[r] = w;
            sg[r] = sigma;
          }
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          cr += __shfl_xor_sync(full, cr, o);
          cg += __shfl_xor_sync(full, cg, o);
          cb += __shfl_xor_sync(full, cb, o);
          a_sum += __shfl_xor_sync(full, a_sum, o);
          dep += __shfl_xor_sync(full, dep, o);
        }
        if (lane == 0) {
          const long long rr = ray0 + j;
          p.rgb[rr * 3 + 0] = cr;
          p.rgb[rr * 3 + 1] = cg;
          p.rgb[rr * 3 + 2] = cb;
          p.acc[rr] = a_sum;
          p.depth[rr] = dep;
        }
      }
    }
    consumers_sync();
    // ts and dl of this tile are read no more
    wg::mbar_arrive_cluster(tb.tile_free + 8 * (k & 1), rank, tid == 0);
    for (int r = tid; r < rows_valid; r += kT) {
      p.wts[ray0 * S + r] = wts[r];
      p.sigma[ray0 * S + r] = sg[r];
    }
    consumers_sync();  // wts and sg are free for the next tile's scan
  }
}

// kContract: the contraction branch; kPaper: the paper's widths; kStream:
// the streamed instance. The CTA's 128-row passes (1, 2 at S = 256, 3 at
// S = 192, S / 128 past 256) are a loop with a runtime count: instances
// specialised on the count compiled the one-pass kernel 1.5x slower.
template <bool kContract, bool kPaper, bool kStream>
__global__ void __launch_bounds__(kK1Threads, 1) fused_ray_wgmma_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const K1Smem& L = p.L;
  const uint32_t full = wg::smem_u32(smem + L.bars), empty = full + 8 * kStages;
  const TileBars tb{empty + 8 * kStages, empty + 8 * kStages + 16, empty + 8 * kStages + 32};
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      wg::mbar_init(full + 8 * s, 1);
      wg::mbar_init(empty + 8 * s, kConsumers * kCluster);
    }
    for (int b = 0; b < 2; ++b) {
      wg::mbar_init(tb.enc_full + 8 * b, 1);
      wg::mbar_init(tb.enc_empty + 8 * b, kConsumers);
      wg::mbar_init(tb.tile_free + 8 * b, 1);
    }
    wg::mbar_init_fence();
  }
  wg::cluster_sync();  // barriers ready in both CTAs before any copy or remote arrival
  // the role, broadcast from lane 0 so ptxas sees it warp-uniform: on a
  // divergent path it serializes every wgmma
  const int role = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (role == kConsumers) {
    const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
    if (warp > 4 * kConsumers)
      encode<kContract, kStream>(p, smem, tb);
    else if (threadIdx.x == 128 * kConsumers)
      produce(p, wg::smem_u32(smem + L.ring), full, empty);
    return;
  }
  consume<kPaper, kStream>(
      p, smem, Ring{wg::smem_u32(smem + L.ring), full, empty, slot_bytes(p.n), 0, 0}, tb);
}

// ---- the mma.sync wide instance: past the cluster route (k1_route) ----

// Its launch: the field, the outputs, and every CTA's slice of the scratch
// (cta_bytes each): two activation buffers of 128 rows x the widest layer,
// the encodings x (P) and dv (D), and the tile's per-sample values (ts,
// deltas, raw sigma, rgb x 4: kWideVals f32 arrays of f.rows).
constexpr int kWideVals = 7;

struct WideParams {
  Field f;
  float* rgb;
  float* acc;
  float* depth;
  float* wts;
  float* sigma;
  unsigned char* scratch;
  long long cta_bytes, off_x, off_dv, off_vals;
};

__host__ __device__ inline size_t wide_align(size_t bytes) { return (bytes + 255) & ~size_t(255); }

// A CTA's scratch bytes, and the offsets of its regions (buffers at 0).
inline long long wide_cta_bytes(const Field& f, long long* off_x, long long* off_dv,
                                long long* off_vals) {
  size_t at = wide_align(sizeof(bf16) * 2 * kRows * static_cast<size_t>(widest(f)));
  *off_x = static_cast<long long>(at);
  at += wide_align(sizeof(bf16) * kRows * f.P);
  *off_dv = static_cast<long long>(at);
  at += wide_align(sizeof(bf16) * kRows * f.D);
  *off_vals = static_cast<long long>(at);
  at += wide_align(sizeof(float) * kWideVals * static_cast<size_t>(f.rows));
  return static_cast<long long>(at);
}

// The card's streaming multiprocessors, queried once a device and process.
inline int sm_count(int* n) {
  constexpr int kDevices = 64;
  static std::atomic<int> known[kDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = dev < kDevices ? known[dev].load(std::memory_order_relaxed) : 0;
  if (sms == 0) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < kDevices) known[dev].store(sms, std::memory_order_relaxed);
  }
  *n = sms;
  return 0;
}

// The wide instance's persistent grid: one CTA an SM (its 512 threads hold
// the SM's registers), or one a tile where there are fewer tiles.
inline int wide_grid(const Field& f, long long* grid) {
  int sms = 0;
  const int rc = sm_count(&sms);
  if (rc != 0) return rc;
  const long long tiles = (f.n_rays + f.R - 1) / f.R;
  *grid = tiles < sms ? tiles : sms;
  return 0;
}

// K2's machinery on K1's job: 16 warps of mma.sync products through
// field_forward_wide on each 128-row pass of the CTA's tiles b, b + grid, ...,
// its activations in the CTA's two buffers in device memory (2 x 128 x W
// bf16 a CTA: ~34 MB over 132 CTAs at W = 512, but 69 MB at 1024 and more
// past it, above the 50 MB L2: they round-trip through device memory, one
// reason the cluster route replaced it up to 2,048 wide), then the resident
// instances' compositing, a warp per ray, on the
// tile's raw sigma and rgb. The weights are PackedWeights.w (K2's layout),
// not K1's: the wgmma instances' layout pads each product to a power of two
// and their sums to 256 columns, which a wide field outgrows.
template <bool kContract>
__global__ void __launch_bounds__(kThreads, 1) fused_ray_wide_kernel(const WideParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Field& f = p.f;
  const int S = f.S, R = f.R, rows = f.rows, tid = threadIdx.x, lane = tid & 31;
  unsigned char* mine = p.scratch + static_cast<long long>(blockIdx.x) * p.cta_bytes;
  bf16* buf = reinterpret_cast<bf16*>(mine);
  float* vals = reinterpret_cast<float*>(mine + p.off_vals);
  const WideSmem ws = wide_layout(f);
  Tile t = carve_wide(smem, ws);
  t.ts = vals;
  t.dl = vals + rows;
  t.sig_raw = vals + 2 * rows;
  t.rgb = vals + 3 * rows;
  bf16* aring = reinterpret_cast<bf16*>(smem + ws.aring);
  const long long bs = static_cast<long long>(kRows) * widest(f);
  const int L = f.n_layers;
  const WideOut o{reinterpret_cast<bf16*>(mine + p.off_x), reinterpret_cast<bf16*>(mine + p.off_dv),
                  buf, bs, 2, buf + (L & 1) * bs, buf + ((L - 1) & 1) * bs, nullptr, 0, 0};
  const unsigned full = 0xffffffffu;
  for (long long tile = blockIdx.x; tile * R < f.n_rays; tile += gridDim.x) {
    const long long ray0 = tile * R;
    const long long left = f.n_rays - ray0;
    const int n_valid = left < R ? static_cast<int>(left) : R;
    for (int s0 = 0; s0 < rows; s0 += kRows)
      field_forward_wide<kContract>(f, t, aring, ray0, n_valid, s0, o);

    // ---- compositing: the resident instances' warp per ray, f32 ----
    for (int j = tid >> 5; j < n_valid; j += kWarps) {
      float carry = 0.f, cr = 0.f, cg = 0.f, cb = 0.f, a_sum = 0.f, dep = 0.f;
      for (int c = 0; c < S; c += 32) {
        const int s = c + lane, r = j * S + s;
        float sigma = 0.f, a = 0.f;
        if (s < S) {
          const float raw = t.sig_raw[r];
          sigma = f.sigma_act == 0 ? fmaxf(raw, 0.f) : fmaxf(raw, 0.f) + log1pf(expf(-fabsf(raw)));
          a = sigma * t.dl[r];
        }
        float incl = a;
#pragma unroll
        for (int o2 = 1; o2 < 32; o2 <<= 1) {
          const float v = __shfl_up_sync(full, incl, o2);
          if (lane >= o2) incl += v;
        }
        const float before = __shfl_up_sync(full, incl, 1);
        const float excl = carry + (lane == 0 ? 0.f : before);
        carry += __shfl_sync(full, incl, 31);
        if (s < S) {
          const float w = expf(-excl) * (1.f - expf(-a));
          cr += w * t.rgb[r * 4 + 0];
          cg += w * t.rgb[r * 4 + 1];
          cb += w * t.rgb[r * 4 + 2];
          a_sum += w;
          dep += w * t.ts[r];
          p.wts[ray0 * S + r] = w;
          p.sigma[ray0 * S + r] = sigma;
        }
      }
#pragma unroll
      for (int o2 = 16; o2 > 0; o2 >>= 1) {
        cr += __shfl_xor_sync(full, cr, o2);
        cg += __shfl_xor_sync(full, cg, o2);
        cb += __shfl_xor_sync(full, cb, o2);
        a_sum += __shfl_xor_sync(full, a_sum, o2);
        dep += __shfl_xor_sync(full, dep, o2);
      }
      if (lane == 0) {
        const long long rr = ray0 + j;
        p.rgb[rr * 3 + 0] = cr;
        p.rgb[rr * 3 + 1] = cg;
        p.rgb[rr * 3 + 2] = cb;
        p.acc[rr] = a_sum;
        p.depth[rr] = dep;
      }
    }
    __syncthreads();  // the next tile's passes overwrite ts, deltas, raw sigma and rgb
  }
}

// ---- the cluster instance: the wide route (field_cluster.cuh) ----

struct ClusterParams {
  Field f;
  cl::Geo geo;
  cl::CSmem L;
  long long b_sf, b_rgb;  // sigma's and rgb's bias offsets in f.b
  float* rgb;
  float* acc;
  float* depth;
  float* wts;
  float* sigma;
};

// The pass's compositing on CTA 0 of the row group: composite_pass's steps
// (a warp per ray of the pass, carrying a spanning ray's running sums from
// pass to pass) on the pass's raw sigma and rgb in shared memory.
__device__ __forceinline__ void composite_cluster(const ClusterParams& p, long long ray0,
                                                  int n_valid, int s0, int pass, int tid) {
  constexpr int kT = cl::kConsumerThreads;
  const unsigned full = 0xffffffffu;
  const Field& f = p.f;
  const int S = f.S, lane = tid & 31, b = pass & 1;
  const float* sig_raw = reinterpret_cast<const float*>(cl::smem + p.L.sig);
  const float* rgb = reinterpret_cast<const float*>(cl::smem + p.L.rgb);
  const float* cin = reinterpret_cast<const float*>(cl::smem + p.L.carry) + b * 6 * 32;
  float* cout = reinterpret_cast<float*>(cl::smem + p.L.carry) + (b ^ 1) * 6 * 32;
  const int first = s0 / S, last_row = (s0 + kRows - 1) / S;
  const int last = last_row < n_valid - 1 ? last_row : n_valid - 1;
  for (int j = first + (tid >> 5); j <= last; j += kT / 32) {
    const int lo = s0 > j * S ? s0 - j * S : 0;
    const int hi = s0 + kRows - j * S < S ? s0 + kRows - j * S : S;
    float carry = 0.f, cr = 0.f, cg = 0.f, cb = 0.f, a_sum = 0.f, dep = 0.f;
    if (lo > 0) {
      carry = cin[lane];
      cr = cin[32 + lane];
      cg = cin[64 + lane];
      cb = cin[96 + lane];
      a_sum = cin[128 + lane];
      dep = cin[160 + lane];
    }
    const long long g0 = (ray0 + j) * S;
    for (int c = lo; c < hi; c += 32) {
      const int s = c + lane, r = j * S + s - s0;
      float sigma = 0.f, a = 0.f;
      if (s < hi) {
        const float raw = sig_raw[r];
        sigma = f.sigma_act == 0 ? fmaxf(raw, 0.f) : fmaxf(raw, 0.f) + log1pf(expf(-fabsf(raw)));
        a = sigma * f.deltas[g0 + s];
      }
      float incl = a;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_up_sync(full, incl, o);
        if (lane >= o) incl += v;
      }
      const float before = __shfl_up_sync(full, incl, 1);
      const float excl = carry + (lane == 0 ? 0.f : before);
      carry += __shfl_sync(full, incl, 31);
      if (s < hi) {
        const float w = expf(-excl) * (1.f - expf(-a));
        cr += w * rgb[r * 4 + 0];
        cg += w * rgb[r * 4 + 1];
        cb += w * rgb[r * 4 + 2];
        a_sum += w;
        dep += w * f.ts[g0 + s];
        p.wts[g0 + s] = w;
        p.sigma[g0 + s] = sigma;
      }
    }
    if (hi < S) {
      cout[lane] = carry;
      cout[32 + lane] = cr;
      cout[64 + lane] = cg;
      cout[96 + lane] = cb;
      cout[128 + lane] = a_sum;
      cout[160 + lane] = dep;
      continue;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      cr += __shfl_xor_sync(full, cr, o);
      cg += __shfl_xor_sync(full, cg, o);
      cb += __shfl_xor_sync(full, cb, o);
      a_sum += __shfl_xor_sync(full, a_sum, o);
      dep += __shfl_xor_sync(full, dep, o);
    }
    if (lane == 0) {
      const long long rr = ray0 + j;
      p.rgb[rr * 3 + 0] = cr;
      p.rgb[rr * 3 + 1] = cg;
      p.rgb[rr * 3 + 2] = cb;
      p.acc[rr] = a_sum;
      p.depth[rr] = dep;
    }
  }
}

// The CTA's tile's first ray and its rays in the batch (0 past the last).
__device__ __forceinline__ long long cluster_ray0(const ClusterParams& p) {
  return cl::tile_of(p.geo) * p.f.R;
}
__device__ __forceinline__ int cluster_rays(const ClusterParams& p) {
  const long long left = p.f.n_rays - cluster_ray0(p);
  return left <= 0 ? 0 : (left < p.f.R ? static_cast<int>(left) : p.f.R);
}

// The consumers: per pass, the encodings, then the products in the order
// the producer and the loaders walk them (cl::prod_at), each call site of
// one compile-time shape (trunk, [feature | sigma], view), each
// product waiting for `free` before its epilogue overwrites the act block
// and publishing it after; then CTA 0 composites the pass. What a product
// needs is recomputed from the parameters and the thread's index rather
// than kept across it: the sums take 128 registers a thread, and the wgmma
// pipeline needs the rest.
template <bool kContract>
__device__ void consume_cluster(const ClusterParams& p) {
  const Field& f = p.f;
  const int j = __shfl_sync(0xffffffffu, cl::block_j(p.geo), 0);
  cl::Ring rg{0, 0};
  float acc[cl::kBlock / 2];
  float sig[4];
  const int L = f.n_layers, passes = f.rows / kRows;
  unsigned char* act = cl::smem + cl::kActOff;
  int q = 0;
  for (int pass = 0; pass < passes; ++pass) {
    cl::encode_pass<kContract>(f, p.L, cluster_ray0(p), cluster_rays(p), pass * kRows,
                               threadIdx.x);
    // ---- trunk ----
    for (int i = 0; i < L; ++i, ++q) {
      const cl::Prod pr = cl::prod_at(f, p.geo, q);
      const bool part = j < pr.nblk;
      cl::prefetch_bias(p.geo, cl::prod_at(f, p.geo, q + 1), j);
      if (part)
        cl::product<cl::kBlock, false>(rg, acc, sig, (pr.k1 + pr.k2) / 16, p.geo,
                                       cl::bias_quads(p.geo, pr, j));
      wg::mbar_wait_cluster(cl::sa(cl::kFreeOff), q & 1);
      if (part) cl::store_block<true>(acc, act, cl::frag_row(), cl::frag_col());
      cl::publish(p.geo);
    }
    // ---- [feature | sigma]: bf16 feature, f32 raw sigma (CTA 0's n8 tile) ----
    {
      const cl::Prod pr = cl::prod_at(f, p.geo, q);
      const bool part = j < pr.nblk;
      cl::prefetch_bias(p.geo, cl::prod_at(f, p.geo, q + 1), j);
      if (part)
        cl::product<cl::kBlock, true>(rg, acc, sig, (pr.k1 + pr.k2) / 16, p.geo,
                                      cl::bias_quads(p.geo, pr, j));
      wg::mbar_wait_cluster(cl::sa(cl::kFreeOff), q & 1);
      if (part) {
        const int r0 = cl::frag_row();
        cl::store_block<false>(acc, act, r0, cl::frag_col());
        if (j == 0) {
          const int lead = (threadIdx.x & 31) & ~3;
          const float s_a = __shfl_sync(0xffffffffu, sig[0], lead);
          const float s_b = __shfl_sync(0xffffffffu, sig[2], lead);
          const float bs = f.b[p.b_sf + f.F];
          float* sig_raw = reinterpret_cast<float*>(cl::smem + p.L.sig);
          sig_raw[r0] = s_a + bs;
          sig_raw[r0 + 8] = s_b + bs;
        }
      }
      cl::publish(p.geo);
      ++q;
    }
    // ---- view head: relu(feat W_f + PE(viewdir) W_d + b) ----
    {
      const cl::Prod pr = cl::prod_at(f, p.geo, q);
      const bool part = j < pr.nblk;
      cl::prefetch_bias(p.geo, cl::prod_at(f, p.geo, q + 1), j);
      if (part)
        cl::product<cl::kBlock, false>(rg, acc, sig, (pr.k1 + pr.k2) / 16, p.geo,
                                       cl::bias_quads(p.geo, pr, j));
      wg::mbar_wait_cluster(cl::sa(cl::kFreeOff), q & 1);
      if (part) cl::store_block<true>(acc, act, cl::frag_row(), cl::frag_col());
      cl::publish(p.geo);
      ++q;
    }
    // ---- CTA 0: rgb on the CUDA cores (the other CTAs' hv blocks, where
    // there are any, after the view product's `ready`: the phase before it
    // has completed, as this CTA's loaders waited for it before the view's
    // `free`, and the next cannot, as this CTA has not published its
    // product, so the parity names the view's phase), then the pass's
    // compositing ----
    if (j == 0) {
      if (p.geo.cv > 1) wg::mbar_wait_cluster(cl::sa(cl::kReadyOff), (q - 1) & 1);
      cl::rgb_rows(f, p.geo, f.b + p.b_rgb, reinterpret_cast<float*>(cl::smem + p.L.rgb));
      cl::hv_read(p.geo);
      composite_cluster(p, cluster_ray0(p), cluster_rays(p), pass * kRows, pass, threadIdx.x);
      cl::consumers_sync();  // raw sigma, rgb and the carry are free for the next pass
    }
  }
}

// K1's wide route: a row group of C CTAs per tile (cluster of C G CTAs),
// one tile a CTA (not persistent: a CTA's start, its encodings and its
// first weight slots, costs a few microseconds of a tile's ~100).
template <bool kContract>
__global__ void __launch_bounds__(cl::kThreads, 1) fused_ray_cluster_kernel(const ClusterParams p) {
  const Field& f = p.f;
  cl::init(p.geo);
  const int nprod = f.rows / kRows * cl::fwd_products(f);
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
  if (warp >= cl::kProducerWarp) {
    if (warp == cl::kProducerWarp) {
      if ((threadIdx.x & 31) == 0) cl::produce(f, p.geo, 0, nprod);
    } else {
      cl::load_a(f, p.geo, p.L, 0, nprod, warp - cl::kLoaderWarp);
    }
  } else {
    consume_cluster<kContract>(p);
  }
  wg::cluster_sync_any();  // no CTA leaves while another reads its shared memory
}

// K1's routes, decided by shape: 0 the wgmma instances (fields up to
// kMaxWidth whose streamed layout fits), 1 the cluster instance (wider
// fields, and encodings the wgmma layouts do not hold, where cl::takes),
// 2 the mma.sync wide instance (the rest: past 2,048 wide, or encodings
// too wide for the cluster layout too).
enum K1Route { kK1Wgmma = 0, kK1Cluster = 1, kK1Wide = 2 };

inline K1Route k1_route(const Field& f, size_t optin) {
  if (widest(f) <= kMaxWidth) {
    const Widths n{padded_width(f.W), padded_width(f.F), padded_width(f.V)};
    if (k1_layout(f, n, true).total <= optin) return kK1Wgmma;
  }
  return cl::takes(f, false, optin) ? kK1Cluster : kK1Wide;
}

}  // namespace

extern "C" {

// Returns 0, a cudaError_t from the launch, or a negative code for a
// shape the kernel does not take (see nerf_rs_tpu_torch/kernels/fused_ray.py).
// w: the weights in K1's layout, b_k1 its biases (fused_render.pack_weights_k1);
// where k1_route takes a wide route, the packed weights' own (PackedWeights.w,
// K2's layout; b_k1 unused) and `scratch` nerf_fused_ray_scratch_bytes of
// device memory (else null). offsets: the device table of the n_w matrix
// offsets into w, then the n_b bias offsets into b (Field::off); w_off and
// b_off: the same offsets in host memory.
// radii: (n_rays,) f32 with ipe = 1, else null. contract: 0 or 1.
int nerf_fused_ray_render(const void* o, const void* d, const void* vd, const void* ts,
                          const void* deltas, const void* radii, const void* w, const void* b,
                          const void* b_k1, const void* offsets, int n_w, int n_b,
                          const long long* w_off, const long long* b_off,
                          void* rgb, void* acc, void* depth, void* wts, void* sigma,
                          long long n_rays, int S, int depth_l, int skip, int W, int F, int V,
                          int P, int D, int pos_levels, int dir_levels, int sigma_act, int ipe,
                          int contract, void* scratch, void* stream) {
  Params p;
  int rc = init_field(&p.f, o, d, vd, ts, deltas, radii, w, b, offsets, w_off, n_w, b_off, n_b,
                      n_rays, S, depth_l, skip, W, F, V, P, D, pos_levels, dir_levels,
                      sigma_act, ipe);
  if (rc != 0) return rc;
  if (contract != 0 && contract != 1) return -8;
  size_t optin = 0;
  rc = smem_optin(&optin);
  if (rc != 0) return rc;
  const K1Route route = k1_route(p.f, optin);
  if (route == kK1Cluster) {  // the cluster instance, on PackedWeights.w repacked into the scratch
    ClusterParams q;
    q.f = p.f;
    long long w_elems = 0, b_elems = 0;
    q.geo = cl::make_geo(q.f, false, &w_elems, &b_elems);
    size_t b_at = 0;
    cl::pack_bytes(w_elems, b_elems, &b_at);
    q.geo.wp = static_cast<const bf16*>(scratch);
    q.geo.bp = reinterpret_cast<const float*>(static_cast<unsigned char*>(scratch) + b_at);
    q.geo.stages = cl::fit_stages(q.f, false, optin);
    q.L = cl::cluster_layout(q.f, false, q.geo.stages);
    q.b_sf = b_off[depth_l];
    q.b_rgb = b_off[depth_l + 2];
    q.rgb = static_cast<float*>(rgb);
    q.acc = static_cast<float*>(acc);
    q.depth = static_cast<float*>(depth);
    q.wts = static_cast<float*>(wts);
    q.sigma = static_cast<float*>(sigma);
    auto kernel = contract ? fused_ray_cluster_kernel<true> : fused_ray_cluster_kernel<false>;
    rc = set_smem(kernel, q.L.total);
    if (rc != 0) return rc;
    if (n_rays == 0) return 0;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    rc = cl::pack(q.f, q.geo, q.f.w, w_off, q.f.b, b_off, nullptr, nullptr, st);
    if (rc != 0) return rc;
    return cl::launch(kernel, q, q.geo, (n_rays + q.f.R - 1) / q.f.R, q.L.total, st);
  }
  if (route == kK1Wide) {  // the mma.sync wide instance, on PackedWeights.w and the scratch
    WideParams q;
    q.f = p.f;
    q.rgb = static_cast<float*>(rgb);
    q.acc = static_cast<float*>(acc);
    q.depth = static_cast<float*>(depth);
    q.wts = static_cast<float*>(wts);
    q.sigma = static_cast<float*>(sigma);
    q.scratch = static_cast<unsigned char*>(scratch);
    q.cta_bytes = wide_cta_bytes(q.f, &q.off_x, &q.off_dv, &q.off_vals);
    auto kernel = contract ? fused_ray_wide_kernel<true> : fused_ray_wide_kernel<false>;
    const size_t smem = wide_layout(q.f).total;
    rc = set_smem(kernel, smem);
    if (rc != 0) return rc;
    if (n_rays == 0) return 0;
    long long grid = 0;
    rc = wide_grid(q.f, &grid);
    if (rc != 0) return rc;
    kernel<<<static_cast<unsigned>(grid), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(q);
    return static_cast<int>(cudaGetLastError());
  }
  p.rgb = static_cast<float*>(rgb);
  p.acc = static_cast<float*>(acc);
  p.depth = static_cast<float*>(depth);
  p.wts = static_cast<float*>(wts);
  p.sigma = static_cast<float*>(sigma);
  p.bias = static_cast<const float*>(b_k1);
  p.b_sf = b_off[depth_l];
  p.b_rgb = b_off[depth_l + 2];
  p.n = {padded_width(W), padded_width(F), padded_width(V)};
  // the resident instance where it fits, else the streamed one (k1_route:
  // that one fits)
  const bool streamed = S > kMaxResident || k1_layout(p.f, p.n, false).total > optin;
  p.L = k1_layout(p.f, p.n, streamed);

  const size_t smem = p.L.total;
  const bool paper = p.n.w == 256 && p.n.f == 256 && p.n.v == 128;
  auto kernel =
      streamed ? (contract ? (paper ? fused_ray_wgmma_kernel<true, true, true>
                                    : fused_ray_wgmma_kernel<true, false, true>)
                           : (paper ? fused_ray_wgmma_kernel<false, true, true>
                                    : fused_ray_wgmma_kernel<false, false, true>))
               : (contract ? (paper ? fused_ray_wgmma_kernel<true, true, false>
                                    : fused_ray_wgmma_kernel<true, false, false>)
                           : (paper ? fused_ray_wgmma_kernel<false, true, false>
                                    : fused_ray_wgmma_kernel<false, false, false>));
  rc = set_smem(kernel, smem);
  if (rc != 0) return rc;
  if (n_rays == 0) return 0;
  // persistent CTAs: as many whole clusters as the card holds at once (or as
  // the tiles need), each CTA taking tiles b, b + grid, ... (iters of them)
  const long long tiles = (n_rays + p.f.R - 1) / p.f.R;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(kK1Threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cfg.gridDim = dim3(kCluster);
  int clusters = 0;
  cudaError_t err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (clusters < 1) return -5;
  const long long need = (tiles + kCluster - 1) / kCluster;
  const long long grid = (need < clusters ? need : clusters) * kCluster;
  cfg.gridDim = dim3(static_cast<unsigned>(grid));
  p.iters = static_cast<int>((tiles + grid - 1) / grid);
  err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Bytes of scratch nerf_fused_ray_render needs: 0 where a wgmma instance
// takes the field; on the cluster route the repacked weights and biases
// (cl::pack_bytes); on the mma.sync wide route its grid (one CTA at least)
// x its CTA's bytes. A positive size is what marks the wide routes and
// their input layout (PackedWeights.w) to the wrapper. depth_l: the trunk's
// layers. Negative: -1 for a sample count the kernels do not take, else a
// cudaError_t negated.
long long nerf_fused_ray_scratch_bytes(long long n_rays, int S, int depth_l, int W, int F, int V,
                                       int P, int D) {
  if (!takes_samples(S)) return -1;
  Field f;
  set_layout(&f, S, W, F, V, P, D);
  f.n_layers = depth_l;
  size_t optin = 0;
  int rc = smem_optin(&optin);
  if (rc != 0) return -static_cast<long long>(rc);
  const K1Route route = k1_route(f, optin);
  if (route == kK1Wgmma) return 0;
  if (route == kK1Cluster) {
    long long w_elems = 0, b_elems = 0;
    size_t b_at = 0;
    cl::make_geo(f, false, &w_elems, &b_elems);
    return static_cast<long long>(cl::pack_bytes(w_elems, b_elems, &b_at));
  }
  f.n_rays = n_rays;
  long long grid = 0, off_x = 0, off_dv = 0, off_vals = 0;
  rc = wide_grid(f, &grid);
  if (rc != 0) return -static_cast<long long>(rc);
  return (grid > 0 ? grid : 1) * wide_cta_bytes(f, &off_x, &off_dv, &off_vals);
}

// The route nerf_fused_ray_render takes for these shapes: 0 the wgmma
// instances, 1 the cluster instance, 2 the mma.sync wide instance (K1Route);
// negative as nerf_fused_ray_scratch_bytes.
int nerf_fused_ray_route(int S, int W, int F, int V, int P, int D) {
  if (!takes_samples(S)) return -1;
  Field f;
  set_layout(&f, S, W, F, V, P, D);
  size_t optin = 0;
  const int rc = smem_optin(&optin);
  if (rc != 0) return -rc;
  return static_cast<int>(k1_route(f, optin));
}

const char* nerf_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
