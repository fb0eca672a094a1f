// The wide route of the whole-ray kernels: K1's fused_ray_cluster_kernel
// (fused_ray.cu) and K2a's train_cluster_kernel and train_cluster_bwd_kernel
// (fused_train.cu), for fields wider than kNarrowWidth (256) and for
// encodings no narrow layout holds.
//
// What bounds it. At 1024/256/128 a sample row costs ~15.8 MFLOP of bf16
// products each way: the tensor cores bound it. What held the mma.sync
// instances this route replaces at 16-18% of that bound: mma.sync in place
// of wgmma, a CTA-wide barrier on every k16 step, each product's A operand
// re-read from L2 for every 256-column round, the activations round-tripping
// through device memory (2 x 128 x 1024 bf16 a CTA, 69 MB over the card at
// width 1024, more than the 50 MB L2), and all of a field's weights (15.6 MB
// at 1024) read from L2 for every 128 rows.
//
// Design. A 128-row pass belongs to a row group of C = ceil(widest / 256)
// CTAs of one cluster. CTA j of the group keeps columns [256 j, 256 j + 256)
// of the current layer's output in its own shared memory (`act`, 64 KB of
// bf16, K-major core matrices as field_wgmma.cuh lays them out) and computes
// exactly those columns of every product (a block of the product's columns;
// a product with fewer blocks than C runs on CTAs j < its block count only,
// the others idle through it: the heads run on CTA 0 at 1024/256/128).
//  * Two consumer warpgroups take 64 rows each and run wgmma.m64n256k16
//    products, the f32 sums in registers, started from the bias; each
//    epilogue (relu or none, bf16) writes the CTA's block back over `act`:
//    the narrow K1's one-tile scheme, lifted to the row group. The rgb head
//    (3 columns) runs on the CUDA cores of CTA 0 (rgb_rows).
//  * A product's A operand at k16 step k lies in CTA k / 16 of the group.
//    Three loader warps hand the consumers each step's A address through a
//    word in shared memory: the CTA's own block or encoding tile where it
//    lies, or the A ring, into which they copy the steps of the other CTAs'
//    blocks (4 KB each, distributed shared memory: mapa and
//    ld.shared::cluster). A CTA starts each product on its own block. No
//    activation touches device memory (K2 still writes the stashes its dW
//    kernel reads).
//  * One producer thread streams the CTA's block of each matrix, a k16 step
//    (8 KB) a slot, with bulk copies into a ring of up to 16 slots (full and
//    empty mbarriers; no CTA-wide barrier in a k-loop). Where 2 C <= 8, a
//    cluster holds two row groups (two tiles) and each weight slot is
//    multicast to both: a weight byte read from L2 serves 256 rows, and a
//    CTA reads only its column block, so the 1024-wide field's weights leave
//    L2 once per 256 rows of the card (~1 TB for a 262,144 x 64 chunk where
//    the mma.sync instance read ~2 TB and its A operands on top).
//  * Three mbarriers order the shared activations across the group: `ready`
//    (every CTA of the group has written its block of product q: the
//    loaders may copy it for product q + 1), `free` (every loader of the
//    group has copied what it needs of product q: the epilogue of q may
//    overwrite `act`) and, in CTA 0, `hv` (its consumers have read the
//    group's hv blocks in rgb_rows: its loaders hold the next pass's first
//    `free` until then, so no CTA overwrites its hv block while CTA 0 reads
//    it). Each is waited in every phase by the same threads, with acquire
//    at cluster scope against arrivals that release at cluster scope.
// The products and their order are the narrow instances': the trunk with
// the skip input, [feature | sigma] (sigma in CTA 0's extra n8 tile), the
// view head over [feature | PE(viewdir)]; then rgb; K2's backward (its own
// kernel): g_hv, dfeat, g_{L-1} (with d sigma times the sigma column), then
// the trunk down to g_0. The sums are f32 from the bias, each epilogue
// rounds to bf16 where the plain versions do, and nothing sums with atomics:
// reruns are bit-identical.
//
// What ptxas needs to pipeline the wgmma here (it serializes them all
// otherwise, and did): one k-loop a product with every operand address
// handed over in shared memory, few product call sites in a kernel (the
// rgb head's was one too many for K1, and K2's forward and backward sites
// together too many for one kernel), and no value the consumers keep across
// a product but the sums (the regions' offsets are compile-time constants
// or launch parameters). 384 threads leave each 168 registers.
//
// The weights: pack rewrites PackedWeights.w (and K2's transposed
// PackedWeightsT.w) on the card into this route's layout in the scratch at
// every call (~31 MB at 1024 wide: ~0.15 ms): for every matrix, each block
// of 256 columns (264 for [feature | sigma]: the sigma column's n8 tile
// after block 0's, zeros after the others; 8 for rgb) in K1's K-major
// core-matrix order (fused_render.pack_weights_k1), k16 steps contiguous;
// and the trunk's, feature's and view head's biases in blocks of 256 in the
// wgmma fragment's order (fused_render._fragment_order).
//
// Limits, decided in C by shape: C <= kMaxCtas (8, the portable cluster
// size: widths up to 2048), and the layout within the card's opt-in shared
// memory at kMinStages (the encodings: P + D up to ~300 at two rays a tile).
// Shapes past either take the mma.sync instances (fused_ray_wide_kernel,
// train_wide_kernel).

#pragma once

#include "field.cuh"
#include "field_wgmma.cuh"

namespace nerf {
namespace cl {

constexpr int kBlock = 256;                        // a CTA's columns of a layer
// k16 steps in each ring: as many as the layout leaves room for (Geo::
// stages, fit_stages), at least kMinStages: the rings' round trip (a
// consumer frees a slot in both row groups' CTAs, the producer refills it
// from L2, the loader copies its A) is a few microseconds, and the card
// runs a step in ~0.15, so the steps in flight set the pace
constexpr int kMinStages = 6;
constexpr int kMaxStages = 16;
constexpr int kThreads = 384;                      // 2 consumer warpgroups, producer, loaders
constexpr int kConsumerThreads = 256;
constexpr int kProducerWarp = 8;
constexpr int kLoaderWarp = 9;                     // warps 9, 10 and 11
constexpr int kLoaders = 3;
constexpr int kMaxCtas = 8;                        // portable cluster size
constexpr uint32_t kStep = 4096;                   // a k16 step of a 128-row K-major tile
constexpr int kSlotCols = kBlock + 8;              // [feature | sigma]: the sigma n8 tile
constexpr uint32_t kSlotBytes = 32u * kSlotCols;   // 8,448 B a weight slot
constexpr int kBarConsumers = 1;                   // named barrier of the consumers

// The route's geometry and the offsets of the repacked weights (bf16
// elements into wp) and biases (f32 into bp), computed on the host
// (make_geo) and read from the parameters.
struct Geo {
  int C, G;        // CTAs a row group (column blocks); row groups a cluster
  int stages;      // k16 steps in each ring (fit_stages)
  int cw, cf, cv;  // column blocks of W, F and V
  long long w_trunk0, w_trunk1, w_trunk_step, w_skip, w_sf, w_vf, w_vd, w_rgb;
  long long t_trunk1, t_trunk_step, t_sf, t_view, t_rgb;  // K2: the transposed matrices
  long long b_feat, b_view;  // trunk layer i's biases at i * cw * kBlock
  const bf16* wp;
  const float* bp;
};

__host__ __device__ inline int blocks(int n) { return (n + kBlock - 1) / kBlock; }

// The geometry of field f (train: with K2's transposed matrices); the
// repacked weights' and biases' sizes in elements into *w_elems, *b_elems.
inline Geo make_geo(const Field& f, bool train, long long* w_elems, long long* b_elems) {
  Geo g = {};
  g.C = blocks(widest(f));
  g.G = 2 * g.C <= kMaxCtas ? 2 : 1;
  g.cw = blocks(f.W);
  g.cf = blocks(f.F);
  g.cv = blocks(f.V);
  const long long bw = static_cast<long long>(g.cw) * kBlock, L = f.n_layers;
  long long at = 0;
  g.w_trunk0 = at;
  at += f.P * bw;
  g.w_trunk1 = at;
  g.w_trunk_step = f.W * bw;
  at += (L - 1) * g.w_trunk_step;
  g.w_skip = at;
  at += f.P * bw;
  g.w_sf = at;
  at += static_cast<long long>(f.W) * g.cf * kSlotCols;
  g.w_vf = at;
  at += static_cast<long long>(f.F) * g.cv * kBlock;
  g.w_vd = at;
  at += static_cast<long long>(f.D) * g.cv * kBlock;
  g.w_rgb = at;
  at += static_cast<long long>(f.V) * 8;
  if (train) {
    g.t_trunk1 = at;
    g.t_trunk_step = f.W * bw;
    at += (L - 1) * g.t_trunk_step;
    g.t_sf = at;
    at += f.F * bw;
    g.t_view = at;
    at += static_cast<long long>(f.V) * g.cf * kBlock;
    g.t_rgb = at;
    at += 16LL * g.cv * kBlock;
  }
  *w_elems = at;
  g.b_feat = L * bw;
  g.b_view = g.b_feat + static_cast<long long>(g.cf) * kBlock;
  *b_elems = g.b_view + static_cast<long long>(g.cv) * kBlock;
  return g;
}

// The regions every layout shares, at fixed offsets, so that their
// addresses are compile-time constants that no consumer keeps in a
// register (the wgmma pipeline needs them): the barriers, the slots' A
// addresses, the CTA's activation block, the weight ring.
constexpr uint32_t kFullOff = 0, kEmptyOff = 8 * kMaxStages, kReadyOff = 16 * kMaxStages,
                   kFreeOff = kReadyOff + 8, kHvOff = kFreeOff + 8;
constexpr uint32_t kAddrOff = kHvOff + 8;  // each slot's A address (4 B), loaders to consumers
constexpr uint32_t kActOff = 512;
constexpr uint32_t kRingOff = kActOff + 2 * kRows * kBlock;
static_assert(kAddrOff + 4 * kMaxStages <= kActOff, "the barriers overlap the act block");

// Byte offsets of the regions that depend on the field and the stages
// (cluster_layout), read from the launch parameters: the A ring, the xs (PE
// or IPE) and PE(viewdir) tiles, K2's d rgb_raw tile, the per-row moments,
// the tile's rays; K1 also a pass's raw sigma and rgb and the carry of a
// ray that spans passes.
struct CSmem {
  uint32_t aring, xs, ds, drgb, mv, ray, sig, rgb, carry, total;
};

inline CSmem cluster_layout(const Field& f, bool train, int stages) {
  CSmem L;
  size_t at = kRingOff + static_cast<size_t>(stages) * kSlotBytes;
  L.aring = static_cast<uint32_t>(take(&at, static_cast<size_t>(stages) * kStep));
  L.xs = static_cast<uint32_t>(take(&at, sizeof(bf16) * kRows * f.P));
  L.ds = static_cast<uint32_t>(take(&at, sizeof(bf16) * kRows * f.D));
  L.drgb = static_cast<uint32_t>(take(&at, train ? kStep : 0));
  L.mv = static_cast<uint32_t>(take(&at, sizeof(float) * kRows * 6));
  L.ray = static_cast<uint32_t>(take(&at, sizeof(float) * f.R * kRayStride));
  L.sig = static_cast<uint32_t>(take(&at, train ? 0 : sizeof(float) * kRows));
  L.rgb = static_cast<uint32_t>(take(&at, train ? 0 : sizeof(float) * kRows * 4));
  L.carry = static_cast<uint32_t>(take(&at, train ? 0 : sizeof(float) * 2 * 6 * 32));
  L.total = static_cast<uint32_t>(at);
  return L;
}

// The most ring stages (at most kMaxStages) whose layout fits the card's
// opt-in shared memory, or 0 where not even kMinStages do.
inline int fit_stages(const Field& f, bool train, size_t optin) {
  for (int s = kMaxStages; s >= kMinStages; --s)
    if (cluster_layout(f, train, s).total <= optin) return s;
  return 0;
}

// Whether the route takes field f: at most kMaxCtas column blocks, and its
// layout within the card's opt-in shared memory.
inline bool takes(const Field& f, bool train, size_t optin) {
  return blocks(widest(f)) <= kMaxCtas && fit_stages(f, train, optin) > 0;
}

// ---- the products ----

enum Src { kNone = 0, kAct, kXs, kDs, kDrgb };
enum Kind { kTrunk = 0, kFeat, kView, kGhv, kDfeat, kGtop, kGtrunk };

// Product q of a CTA's sequence: A1 (k1 columns) and A2 (k2, 0 for none)
// and their sources, the B matrices' block 0 in Geo::wp (CTA j's block at +
// j K ntot), the slot's columns, the blocks (the CTAs j < nblk take part),
// the output's real columns and the bias's block 0 in Geo::bp (-1: none).
// `layer`: the trunk layer (forward) or the G layer it writes (backward).
struct Prod {
  int kind, layer, a1, k1, a2, k2, ntot, nblk, n;
  long long w1, w2, bias;
};

// The rgb head (3 of 8 columns) is no product: rgb_rows computes it on the
// CUDA cores (a fourth wgmma call site left ptxas too few registers to
// pipeline the others).
__host__ __device__ inline int fwd_products(const Field& f) { return f.n_layers + 2; }
__host__ __device__ inline int bwd_products(const Field& f) { return f.n_layers + 2; }

// Every pass's forward products in order, then (K2) every pass's backward.
__device__ inline Prod prod_at(const Field& f, const Geo& g, int q) {
  const int L = f.n_layers, nf = fwd_products(f) * (f.rows / kRows);
  Prod p;
  p.a2 = kNone;
  p.k2 = 0;
  p.w2 = 0;
  p.ntot = kBlock;
  p.bias = -1;
  if (q < nf) {
    const int i = q % fwd_products(f);
    p.layer = i < L ? i : L;
    if (i < L) {
      p.kind = kTrunk;
      p.a1 = i == 0 ? kXs : kAct;
      p.k1 = i == 0 ? f.P : f.W;
      if (i == f.skip && i > 0) {
        p.a2 = kXs;
        p.k2 = f.P;
        p.w2 = g.w_skip;
      }
      p.w1 = i == 0 ? g.w_trunk0 : g.w_trunk1 + (i - 1) * g.w_trunk_step;
      p.nblk = g.cw;
      p.n = f.W;
      p.bias = static_cast<long long>(i) * g.cw * kBlock;
    } else if (i == L) {
      p.kind = kFeat;
      p.a1 = kAct;
      p.k1 = f.W;
      p.w1 = g.w_sf;
      p.ntot = kSlotCols;
      p.nblk = g.cf;
      p.n = f.F;
      p.bias = g.b_feat;
    } else {
      p.kind = kView;
      p.a1 = kAct;
      p.k1 = f.F;
      p.a2 = kDs;
      p.k2 = f.D;
      p.w1 = g.w_vf;
      p.w2 = g.w_vd;
      p.nblk = g.cv;
      p.n = f.V;
      p.bias = g.b_view;
    }
    return p;
  }
  const int i = (q - nf) % bwd_products(f);
  p.a1 = kAct;
  if (i == 0) {  // g_hv = (d rgb_raw @ rgb_w^T) [hv > 0]
    p.kind = kGhv;
    p.layer = L;
    p.a1 = kDrgb;
    p.k1 = 16;
    p.w1 = g.t_rgb;
    p.nblk = g.cv;
    p.n = f.V;
  } else if (i == 1) {  // dfeat = g_hv @ view_w^T
    p.kind = kDfeat;
    p.layer = L;
    p.k1 = f.V;
    p.w1 = g.t_view;
    p.nblk = g.cf;
    p.n = f.F;
  } else if (i == 2) {  // g_{L-1} = (dfeat @ feat_w^T + dsigma sigma_row) [h_{L-1} > 0]
    p.kind = kGtop;
    p.layer = L - 1;
    p.k1 = f.F;
    p.w1 = g.t_sf;
    p.nblk = g.cw;
    p.n = f.W;
  } else {  // g_{l-1} = (g_l @ W_l^T) [h_{l-1} > 0], l = L - 1 down to 1
    const int l = L - 1 - (i - 3);
    p.kind = kGtrunk;
    p.layer = l - 1;
    p.k1 = f.W;
    p.w1 = g.t_trunk1 + static_cast<long long>(l - 1) * g.t_trunk_step;
    p.nblk = g.cw;
    p.n = f.W;
  }
  return p;
}

// ---- the CTA's place, its barriers and regions ----

// The cluster instances' dynamic shared memory (every extern __shared__
// array of a kernel starts at the same address).
extern __shared__ __align__(128) unsigned char smem[];

// The shared-window address of byte `off` of the CTA's shared memory.
__device__ __forceinline__ uint32_t sa(uint32_t off) { return wg::smem_u32(smem) + off; }

// Cluster rank g C + j: row group g, column block j.
__device__ __forceinline__ int block_j(const Geo& geo) {
  return static_cast<int>(wg::cluster_rank()) % geo.C;
}
__device__ __forceinline__ int group_g(const Geo& geo) {
  return static_cast<int>(wg::cluster_rank()) / geo.C;
}

// The CTA's tile (whole rays, f.rows rows in 128-row passes): cluster k's
// row groups take tiles k G .. k G + G - 1.
__device__ __forceinline__ long long tile_of(const Geo& geo) {
  return static_cast<long long>(blockIdx.x / (geo.C * geo.G)) * geo.G + group_g(geo);
}

// Inits the barriers; every thread of the cluster returns after all of
// them are ready.
__device__ inline void init(const Geo& geo) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < geo.stages; ++s) {
      wg::mbar_init(sa(kFullOff) + 8 * s, 2);           // the producer's bytes, the loader's A
      wg::mbar_init(sa(kEmptyOff) + 8 * s, 2 * geo.G);  // both warpgroups of each CTA it feeds
    }
    wg::mbar_init(sa(kReadyOff), geo.C);                // one arrival from each CTA of the group
    wg::mbar_init(sa(kFreeOff), kLoaders * geo.C);      // each loader warp of each CTA
    wg::mbar_init(sa(kHvOff), 1);                       // CTA 0's consumers, once a pass
    wg::mbar_init_fence();
  }
  __syncwarp();
  wg::cluster_sync();
}

// The first k16 step of an operand of `steps` steps from source src: a
// CTA takes an act operand's steps from its own block on (16 j), wrapping
// round, so that a product starts on what its own epilogue wrote while the
// other CTAs' blocks are published and copied; a local tile from step 0.
// The producer, the loaders and the consumers walk the same order.
__host__ __device__ __forceinline__ int first_step(int src, int steps, int j) {
  return src == kAct && steps > 0 ? (16 * j) % steps : 0;
}

// ---- the producer: one thread streams the CTA's block of every matrix ----
__device__ inline void produce(const Field& f, const Geo& geo, int q0, int q1) {
  const int j = block_j(geo), g = group_g(geo);
  int slot = 0;
  uint32_t phase = 0;
  const uint16_t mask = static_cast<uint16_t>(
      geo.G == 2 ? (1u << j) | (1u << (geo.C + j)) : (1u << (g * geo.C + j)));
  for (int q = q0; q < q1; ++q) {
    const Prod pr = prod_at(f, geo, q);
    if (j >= pr.nblk) continue;
    const uint32_t bytes = 32u * pr.ntot, part = bytes / geo.G;
    for (int h = 0; h < 2; ++h) {
      const int K = h ? pr.k2 : pr.k1, steps = K / 16;
      const int k0 = first_step(h ? pr.a2 : pr.a1, steps, j);
      const char* src = reinterpret_cast<const char*>(
          geo.wp + (h ? pr.w2 : pr.w1) + static_cast<long long>(j) * K * pr.ntot);
      for (int t = 0; t < steps; ++t) {
        const int k = k0 + t < steps ? k0 + t : k0 + t - steps;
        wg::mbar_wait(sa(kEmptyOff) + 8 * slot, phase ^ 1);
        wg::mbar_arrive_expect_tx(sa(kFullOff) + 8 * slot, bytes);
        wg::bulk_copy_multicast(sa(kRingOff) + slot * kSlotBytes + g * part,
                                src + static_cast<size_t>(k) * bytes + g * part, part,
                                sa(kFullOff) + 8 * slot, mask);
        if (++slot == geo.stages) {
          slot = 0;
          phase ^= 1;
        }
      }
    }
  }
  // every slot freed by every consumer it feeds: no arrival from the other
  // row group is still on its way when the CTA exits
  for (int i = 0; i < geo.stages; ++i) {
    wg::mbar_wait(sa(kEmptyOff) + 8 * slot, phase ^ 1);
    if (++slot == geo.stages) {
      slot = 0;
      phase ^= 1;
    }
  }
}

// ---- the loaders: warp lw (0 .. kLoaders - 1) takes the CTA's k16 steps
// t with t % kLoaders == lw and puts the step's A address in its slot's
// word of kAddrOff: where the A lies in this CTA (its own act block, whose
// steps come first (first_step), or a local tile: xs, ds, d rgb_raw) that
// address, else it copies the step (4 KB: 128 rows x 16 columns, K-major)
// from the owner's act block through distributed shared memory into the A
// ring's slot; then it arrives on the step's full barrier. Once a product,
// before its first step from another CTA (or at the product's end where
// there is none), it waits for the group's `ready` (product q - 1 is
// written), and after it tells every CTA of the group that it reads that
// CTA's block no more (`free`); in CTA 0, where the view head spans several
// blocks, the first product of a later pass tells it only after the
// consumers have read the previous pass's hv blocks (`hv`, hv_read) ----
__device__ inline void load_a(const Field& f, const Geo& geo, const CSmem& L, int q0, int q1,
                              int lw) {
  const int lane = threadIdx.x & 31, j = block_j(geo), g = group_g(geo);
  int t = 0;
  for (int q = q0; q < q1; ++q) {
    bool waited = q == q0;  // the first product reads nothing another CTA wrote
    const Prod pr = prod_at(f, geo, q);
    if (j < pr.nblk) {
      for (int h = 0; h < 2; ++h) {
        const int src = h ? pr.a2 : pr.a1, steps = (h ? pr.k2 : pr.k1) / 16;
        const int k0 = first_step(src, steps, j);
        for (int u = 0; u < steps; ++u, ++t) {
          if (t % kLoaders != lw) continue;
          const int k = k0 + u < steps ? k0 + u : k0 + u - steps;
          const int slot = t % geo.stages;
          const bool remote = src == kAct && (k >> 4) != j;
          if (remote && !waited) {
            wg::mbar_wait_cluster(sa(kReadyOff), (q - q0 - 1) & 1);
            waited = true;
          }
          uint32_t a;
          if (remote) {  // the copy's loads in flight while the slot frees
            const uint32_t from = wg::mapa(sa(kActOff) + (k & 15) * kStep,
                                           static_cast<uint32_t>(g * geo.C + (k >> 4)));
            uint4 v[8];
#pragma unroll
            for (int i = 0; i < 8; ++i) v[i] = wg::ld_cluster16(from + (i * 32 + lane) * 16);
            wg::mbar_wait(sa(kEmptyOff) + 8 * slot, ((t / geo.stages) & 1) ^ 1);
            a = sa(L.aring) + slot * kStep;
#pragma unroll
            for (int i = 0; i < 8; ++i) wg::st_shared16(a + (i * 32 + lane) * 16, v[i]);
            wg::fence_proxy_async();
          } else {
            wg::mbar_wait(sa(kEmptyOff) + 8 * slot, ((t / geo.stages) & 1) ^ 1);
            a = src == kAct ? sa(kActOff) + (k & 15) * kStep
                            : (src == kXs ? sa(L.xs) : sa(src == kDs ? L.ds : L.drgb)) + k * kStep;
          }
          __syncwarp();
          if (lane == 0) {
            *reinterpret_cast<volatile uint32_t*>(smem + kAddrOff + 4 * slot) = a;
            wg::mbar_arrive(sa(kFullOff) + 8 * slot);
          }
        }
      }
    }
    if (!waited) wg::mbar_wait_cluster(sa(kReadyOff), (q - q0 - 1) & 1);
    const int nf = fwd_products(f);
    if (j == 0 && geo.cv > 1 && q > 0 && q % nf == 0 && q < nf * (f.rows / kRows))
      wg::mbar_wait_cluster(sa(kHvOff), (q / nf - 1) & 1);
    __syncwarp();
    if (lane == 0)
      for (int r = 0; r < geo.C; ++r) wg::mbar_arrive_release(sa(kFreeOff), g * geo.C + r);
  }
}

// ---- the consumers ----

// The consumers' place in the weight ring.
struct Ring {
  int slot;
  uint32_t phase;
};

// The slot `s` read: one arrival from each warpgroup on its empty barrier
// in this CTA and (two row groups) in the other row group's CTA of this
// column block, which the same slot fed.
__device__ __forceinline__ void release(int s, uint32_t pair, uint32_t signal,
                                        uint32_t pair_signal) {
  wg::mbar_arrive_pred(sa(kEmptyOff) + 8 * s, signal);
  wg::mbar_arrive_cluster(sa(kEmptyOff) + 8 * s, pair, pair_signal);
}

// acc = bias + A1 B1 [+ A2 B2] for the warpgroup's 64 rows and the CTA's N
// = 256 (or 8) columns of a product of `steps` k16 steps (A1's and A2's),
// each step's A and B in the rings' slot; with kSigma also sig = A1 B1[:,
// 256:264] (the sigma n8 tile). b4: this lane's bias quads (lane q's first
// at 4 q), or null for none. A slot is released once the next step's group
// has started (wait_group 1), in every CTA it feeds. The narrow K1's product
// with the operands' addresses left to the loaders.
template <int N, bool kSigma>
__device__ __forceinline__ void product(Ring& rg, float* acc, float* sig, int steps,
                                        const Geo& geo, const float4* b4) {
  if constexpr (N >= 16) {
#pragma unroll
    for (int jj = 0; jj < N / 16; ++jj) {
      const float4 b = b4 != nullptr ? b4[4 * jj] : make_float4(0.f, 0.f, 0.f, 0.f);
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
  const uint32_t wg_off = static_cast<uint32_t>(__shfl_sync(0xffffffffu, threadIdx.x >> 7, 0)) * 1024;
  const uint32_t signal = (threadIdx.x & 127) == 0;
  const uint32_t self = wg::cluster_rank();
  const uint32_t pair = geo.G == 2 ? (self < static_cast<uint32_t>(geo.C) ? self + geo.C : self - geo.C)
                                   : self;
  const uint32_t pair_signal = geo.G == 2 ? signal : 0u;
  constexpr uint32_t kLbo = (kSigma ? kSlotCols : N) * 16;  // the slot's k-group stride
  int prev = -1;
  for (int t = 0; t < steps; ++t) {
    wg::mbar_wait(sa(kFullOff) + 8 * rg.slot, rg.phase);
    wg::fence_regs<N / 2>(acc);
    if (kSigma) wg::fence_regs<4>(sig);
    wg::fence();
    const uint32_t a = *reinterpret_cast<volatile const uint32_t*>(smem + kAddrOff + 4 * rg.slot);
    const uint64_t da = wg::desc(a + wg_off, 2048, 128);
    const uint64_t db = wg::desc(sa(kRingOff) + rg.slot * kSlotBytes, kLbo, 128);
    wg::mma<N>(acc, da, db, 1);
    if (kSigma) wg::mma<8>(sig, da, db + static_cast<uint64_t>(N), 1);
    wg::commit();
    wg::fence_regs<N / 2>(acc);
    if (kSigma) wg::fence_regs<4>(sig);
    if (prev >= 0) {
      wg::wait<1>();
      release(prev, pair, signal, pair_signal);
    }
    prev = rg.slot;
    if (++rg.slot == geo.stages) {
      rg.slot = 0;
      rg.phase ^= 1;
    }
  }
  wg::wait<0>();
  wg::fence_regs<N / 2>(acc);
  if (kSigma) wg::fence_regs<4>(sig);
  release(prev, pair, signal, pair_signal);
}

// rgb = sigmoid(hv rgb_w + b) for the pass's 128 rows, by the consumers of
// CTA 0 on the CUDA cores: hv (V columns, bf16) lies in the act blocks of
// the group's CTAs 0 .. cv - 1 (read through distributed shared memory,
// this CTA's own included; the caller has waited for the others'), rgb_w in
// the repacked weights' rgb block (K-major core order: element (k, n) at (k
// / 8) 64 + 8 n + k % 8). Two threads a row, each summing every other 8
// columns in f32, then the pair's two sums; rgb of row r at out[4 r + c].
__device__ __forceinline__ void rgb_rows(const Field& f, const Geo& geo, const float* b,
                                         float* out) {
  const int r = threadIdx.x >> 1, half = threadIdx.x & 1, g = group_g(geo);
  const bf16* w = geo.wp + geo.w_rgb;
  float s[3] = {0.f, 0.f, 0.f};
  for (int c8 = half; c8 < f.V / 8; c8 += 2) {
    const int c = 8 * c8;
    const uint4 hv = wg::ld_cluster16(
        wg::mapa(sa(kActOff) + wg::tile_off(r, c & (kBlock - 1)), g * geo.C + (c >> 8)));
    const bf16* h = reinterpret_cast<const bf16*>(&hv);
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      const uint4 wv = __ldg(reinterpret_cast<const uint4*>(w + (c >> 3) * 64 + 8 * ch));
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

// The consumer's accumulator fragment: its rows r0 and r0 + 8 and first
// column c0 of every n8 tile.
__device__ __forceinline__ int frag_row() {
  const int t = threadIdx.x & 127;
  return (threadIdx.x >> 7) * 64 + (t >> 5) * 16 + ((t & 31) >> 2);
}
__device__ __forceinline__ int frag_col() { return 2 * (static_cast<int>(threadIdx.x) & 3); }

// This lane's bias quads of product pr's block j (product's b4).
__device__ __forceinline__ const float4* bias_quads(const Geo& geo, const Prod& pr, int j) {
  return reinterpret_cast<const float4*>(geo.bp + pr.bias + j * kBlock) + (threadIdx.x & 3);
}

__device__ __forceinline__ void consumers_sync() {
  wg::named_sync(kBarConsumers, kConsumerThreads);
}

// After rgb_rows, by every consumer of CTA 0: the pass's rgb written and,
// where the view head spans several blocks, the group's hv blocks read, so
// one arrival on `hv` releases the next pass's first `free` (load_a): the
// other CTAs' next epilogue cannot overwrite a block rgb_rows still reads.
__device__ __forceinline__ void hv_read(const Geo& geo) {
  consumers_sync();
  if (geo.cv > 1 && threadIdx.x == 0) wg::mbar_arrive_release(sa(kHvOff), wg::cluster_rank());
}

// After an epilogue: the CTA's new block visible to its own next wgmma and,
// through `ready`, to every CTA of the group (the consumers' barrier orders
// every thread's stores before thread 0's arrivals, which release at
// cluster scope).
__device__ __forceinline__ void publish(const Geo& geo) {
  wg::fence_proxy_async();
  consumers_sync();
  if (threadIdx.x == 0) {
    const int g = group_g(geo);
    for (int r = 0; r < geo.C; ++r) wg::mbar_arrive_release(sa(kReadyOff), g * geo.C + r);
  }
}

// Prefetches product pr's bias block (1 KB: eight 128-byte lines) into L1,
// a product ahead of its sums' start, where its loads sat on the path
// between two products.
__device__ __forceinline__ void prefetch_bias(const Geo& geo, const Prod& pr, int j) {
  if (pr.bias >= 0 && j < pr.nblk && threadIdx.x < 8)
    asm volatile("prefetch.global.L1 [%0];\n" ::"l"(geo.bp + pr.bias + j * kBlock + 32 * threadIdx.x));
}

__device__ __forceinline__ void store_bf2(unsigned char* tile, int r, int c, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(tile + wg::tile_off(r, c)) = __floats2bfloat162_rn(v0, v1);
}

__device__ __forceinline__ void store_bf1(unsigned char* tile, int r, int c, float v) {
  *reinterpret_cast<bf16*>(tile + wg::tile_off(r, c)) = __float2bfloat16_rn(v);
}

// The warpgroup's sums (rows r0 and r0 + 8, columns 8 jj + c0 of the block)
// through relu (kRelu) or none, bf16, into the act block.
template <bool kRelu>
__device__ __forceinline__ void store_block(const float* acc, unsigned char* act, int r0, int c0) {
#pragma unroll
  for (int jj = 0; jj < kBlock / 8; ++jj) {
    const int c = 8 * jj + c0;
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = kRelu ? fmaxf(acc[4 * jj + e], 0.f) : acc[4 * jj + e];
    store_bf2(act, r0, c, v[0], v[1]);
    store_bf2(act, r0 + 8, c, v[2], v[3]);
  }
}

// The pass's inputs and encodings, by the consumers: the tile's rays (o, d,
// viewdir, radius; zeros past the last ray), each row's point o + t d or
// (IPE) conical-frustum Gaussian, contracted with kContract, then PE or IPE
// into the xs tile and PE(viewdir) into the ds tile, K-major: the values of
// field.cuh's pe_value and ipe_value, rounded to bf16 once.
template <bool kContract>
__device__ __forceinline__ void encode_pass(const Field& f, const CSmem& L, long long ray0, int n_valid,
                                   int s0, int tid) {
  const int S = f.S;
  float* ray = reinterpret_cast<float*>(smem + L.ray);
  float* mv_all = reinterpret_cast<float*>(smem + L.mv);
  unsigned char* xs = smem + L.xs;
  unsigned char* ds = smem + L.ds;
  for (int i = tid; i < f.R * kRayStride; i += kConsumerThreads) {
    const int j = i / kRayStride, k = i % kRayStride;
    float v = 0.f;
    if (j < n_valid) {
      if (k < 9) {
        const float* src = k < 3 ? f.o : (k < 6 ? f.d : f.vd);
        v = src[(ray0 + j) * 3 + k % 3];
      } else if (f.ipe) {
        v = f.radii[ray0 + j];
      }
    }
    ray[i] = v;
  }
  consumers_sync();
  const int rows_valid = n_valid * S;
  for (int r = tid; r < kRows; r += kConsumerThreads) {
    const int cr = s0 + r;
    const float* ry = ray + (cr / S) * kRayStride;
    float* mv = mv_all + r * 6;
    const bool ok = cr < rows_valid;
    const float tv = ok ? f.ts[ray0 * S + cr] : 0.f;
    const float dv = ok ? f.deltas[ray0 * S + cr] : 0.f;
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
  consumers_sync();
  const int pos_dim = 3 + 6 * f.pos_levels, dir_dim = 3 + 6 * f.dir_levels;
  for (int i = tid; i < kRows * f.P; i += kConsumerThreads) {
    const int r = i % kRows, col = i / kRows;
    float v = 0.f;
    if (col < pos_dim) {
      const float* mv = mv_all + r * 6;
      const int dim = col < 3 ? col : (col - 3) % 3;
      v = f.ipe ? ipe_value(mv[dim], mv[3 + dim], col) : pe_value(mv[dim], col);
    }
    store_bf1(xs, r, col, v);
  }
  for (int i = tid; i < kRows * f.D; i += kConsumerThreads) {
    const int r = i % kRows, col = i / kRows;
    float v = 0.f;
    if (col < dir_dim)
      v = pe_value(ray[((s0 + r) / S) * kRayStride + 6 + (col < 3 ? col : (col - 3) % 3)], col);
    store_bf1(ds, r, col, v);
  }
  wg::fence_proxy_async();
  consumers_sync();
}

// ---- the weights in the route's layout (module note), on the card ----

// Matrix `src` of PackedWeights' fragment layout (K x nsrc, fused_render
// _swizzle) into nblk blocks of ntot columns at dst: block b's columns 256 b
// .. 256 b + 255 where below nreal (else 0), and with sig_col >= 0 block
// 0's n8 tile after them from columns sig_col .. sig_col + 7.
__global__ void pack_kernel(const bf16* src, int K, int nreal, int sig_col, bf16* dst, int ntot,
                            int nblk) {
  const long long per_block = static_cast<long long>(K) * ntot;
  const long long total = per_block * nblk;
  const int KT = K / 16;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < total;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int b = static_cast<int>(i / per_block);
    const int rem = static_cast<int>(i % per_block);
    const int ks = rem / (16 * ntot), e = rem % (16 * ntot);
    const int kgl = e / (ntot * 8), e2 = e % (ntot * 8);
    const int ng = e2 / 64, nr = (e2 / 8) % 8, kr = e2 % 8;
    const int k = 16 * ks + 8 * kgl + kr;
    int n = -1;
    if (ng < kBlock / 8) {
      n = kBlock * b + 8 * ng + nr;
      if (n >= nreal) n = -1;
    } else if (b == 0 && sig_col >= 0) {
      n = sig_col + nr;
    }
    bf16 v = __float2bfloat16_rn(0.f);
    if (n >= 0) {
      const int kt = k / 16, hh = (k % 16) / 8, t = (k % 8) / 2, pp = k % 2;
      v = src[((((static_cast<long long>(n / 8) * KT + kt) * 8 + n % 8) * 4 + t) * 2 + hh) * 2 +
              pp];
    }
    dst[i] = v;
  }
}

// n biases at src into nblk blocks of 256 in the fragment order (quad lane
// q reads columns 8 jj + 2 q + {0, 1}: column 8 jj + 2 q + e at 16 (jj / 2)
// + 4 q + 2 (jj % 2) + e), zeros past n.
__global__ void pack_bias_kernel(const float* src, int n, float* dst, int nblk) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nblk * kBlock) return;
  const int b = i / kBlock, x = i % kBlock;
  const int jj = 2 * (x / 16) + (x % 4) / 2, q = (x % 16) / 4, e = x % 2;
  const int c = kBlock * b + 8 * jj + 2 * q + e;
  dst[i] = c < n ? src[c] : 0.f;
}

// Rewrites the field's matrices (w at the host offsets w_off; with wt, K2's
// transposed ones at wt_off) and biases (b at b_off) into g's layout at
// g.wp and g.bp, on `stream`. Returns 0 or a cudaError_t.
inline int pack(const Field& f, const Geo& g, const bf16* w, const long long* w_off, const float* b,
                const long long* b_off, const bf16* wt, const long long* wt_off,
                cudaStream_t stream) {
  const int L = f.n_layers;
  bf16* wp = const_cast<bf16*>(g.wp);
  float* bp = const_cast<float*>(g.bp);
  auto mat = [&](const bf16* src, int K, int nreal, int sig, long long dst, int ntot, int nblk) {
    const long long total = static_cast<long long>(K) * ntot * nblk;
    const long long grid = (total + 255) / 256 < 4096 ? (total + 255) / 256 : 4096;
    pack_kernel<<<static_cast<unsigned>(grid), 256, 0, stream>>>(src, K, nreal, sig, wp + dst,
                                                                  ntot, nblk);
    return static_cast<int>(cudaGetLastError());
  };
  auto bias = [&](const float* src, int n, long long dst, int nblk) {
    pack_bias_kernel<<<nblk, kBlock, 0, stream>>>(src, n, bp + dst, nblk);
    return static_cast<int>(cudaGetLastError());
  };
  int rc = mat(w + w_off[0], f.P, f.W, -1, g.w_trunk0, kBlock, g.cw);
  for (int i = 1; i < L && rc == 0; ++i)
    rc = mat(w + w_off[i], f.W, f.W, -1, g.w_trunk1 + (i - 1) * g.w_trunk_step, kBlock, g.cw);
  if (rc == 0) rc = mat(w + w_off[L], f.P, f.W, -1, g.w_skip, kBlock, g.cw);
  if (rc == 0) rc = mat(w + w_off[L + 1], f.W, f.F, f.F, g.w_sf, kSlotCols, g.cf);
  if (rc == 0) rc = mat(w + w_off[L + 2], f.F, f.V, -1, g.w_vf, kBlock, g.cv);
  if (rc == 0) rc = mat(w + w_off[L + 3], f.D, f.V, -1, g.w_vd, kBlock, g.cv);
  if (rc == 0) rc = mat(w + w_off[L + 4], f.V, 8, -1, g.w_rgb, 8, 1);
  if (wt != nullptr) {
    for (int l = 1; l < L && rc == 0; ++l)
      rc = mat(wt + wt_off[l - 1], f.W, f.W, -1, g.t_trunk1 + (l - 1) * g.t_trunk_step, kBlock,
               g.cw);
    if (rc == 0) rc = mat(wt + wt_off[L - 1], f.F, f.W, -1, g.t_sf, kBlock, g.cw);
    if (rc == 0) rc = mat(wt + wt_off[L], f.V, f.F, -1, g.t_view, kBlock, g.cf);
    if (rc == 0) rc = mat(wt + wt_off[L + 1], 16, f.V, -1, g.t_rgb, kBlock, g.cv);
  }
  for (int i = 0; i < L && rc == 0; ++i)
    rc = bias(b + b_off[i], f.W, static_cast<long long>(i) * g.cw * kBlock, g.cw);
  if (rc == 0) rc = bias(b + b_off[L], f.F, g.b_feat, g.cf);
  if (rc == 0) rc = bias(b + b_off[L + 1], f.V, g.b_view, g.cv);
  return rc;
}

// Bytes of the repacked weights and biases (256-aligned parts), the weights first.
inline size_t pack_bytes(long long w_elems, long long b_elems, size_t* b_at) {
  *b_at = (static_cast<size_t>(w_elems) * sizeof(bf16) + 255) & ~static_cast<size_t>(255);
  return *b_at + ((static_cast<size_t>(b_elems) * sizeof(float) + 255) & ~static_cast<size_t>(255));
}

// Launches `kernel` on the route's cluster grid for n_tiles tiles (whole
// clusters of C G CTAs; a tile past the last runs on zero rows), after
// checking that the card holds one such cluster at once. Returns 0 or a
// cudaError_t, or -5 where no cluster fits.
template <class Kernel, class Params>
inline int launch(Kernel kernel, const Params& p, const Geo& g, long long n_tiles, size_t smem,
                  cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = g.C * g.G;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cfg.gridDim = dim3(g.C * g.G);
  int clusters = 0;
  cudaError_t err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (clusters < 1) return -5;
  const long long n_clusters = (n_tiles + g.G - 1) / g.G;
  cfg.gridDim = dim3(static_cast<unsigned>(n_clusters * g.C * g.G));
  err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace cl
}  // namespace nerf
