// Row gather for Hopper (sm_90a), K4: gather_rows and gather_pairs, and the
// fixed-order scatter of their backward, scatter_rows.
//
// Replaces nerf_rs_tpu/kernels/gather_rows.py::gather_rows (:54, the Pallas
// TPU kernel at :88, pallas_call :115) and ::gather_pairs (:133, which
// reaches the same pallas_call):
//   gather_rows   out[i, :] = table[idx[i], :]        (R, W) f32, any W
//   gather_pairs  out[i, :] = table[fidx[i] + {0, 1}]  (M,) f32, fidx even
//                 (an odd fidx gives a NaN pair, as one outside the table)
// They are the hash-grid field's table fetch: the brick layout's one 512 B
// row per (point, level), and the flat layout's F = 2 feature pair per
// (point, level, corner) (nerf_rs_tpu_torch/models/hashgrid.py).
//
// What bounds it on this card: bytes. A gather does no arithmetic; every
// output byte is one table byte read and one written, plus 4 B of index per
// row or pair. At a brick sub-chunk (2^21 rows of 512 B) that is 2.16 GB,
// 0.64 ms at 3.35 TB/s; at a flat train step (2^26 pairs) 1.34 GB, 0.40 ms.
//
// What the TPU kernel did and this one does not. The TPU's HBM is tiled, so
// its smallest random access was one 128-lane row; the kernel kept a block of
// indices in SMEM and a ring of per-row DMAs in flight, issued from the scalar
// core, and gather_pairs fetched a whole 512 B row for 8 useful bytes. On
// Hopper a gather is plain loads: the access unit is a 32 B sector, and the
// latency is hidden by many warps in flight, not by a DMA ring.
//   * gather_rows: one warp per row, a 16 B float4 per lane, so a 128-wide
//     row is one coalesced 512 B load and one 512 B store (wider rows loop).
//     Every lane reads the row's index (one broadcast load). A grid-stride
//     loop over the rows, with the grid capped at what the SMs hold at once.
//     A row narrower than 128 (a warp's 32 float4), as the flat hash table's
//     rows of F features, takes gather_elems_kernel instead: a thread per
//     float4 of the output where the width is a multiple of 4 and the table
//     16 B aligned, else a thread per float.
//   * gather_pairs: bytes per pair are 4 B of index in, 8 B of table, 8 B
//     out; a thread takes four pairs per step with one 16 B index load, four
//     independent aligned 8 B float2 loads in flight (a pair costs one
//     sector) and two 16 B stores, the streamed indices and output with the
//     evict-first hint so the table's hot entries keep L2. No check on the
//     host: the wrapper never reads the indices (an odd one gives NaN).
// The table is read through the read-only path (__ldg). An index outside the
// table is never read: its row or pair is written as NaN, as the wrapper's
// plain version writes it.
//
// scatter_rows, the fetches' backward (no TPU kernel: jnp.take's VJP is
// XLA's scatter-add, nerf_rs_tpu/models/hashgrid.py):
//   out[key[j], lane0[j] + lanes[c]] += g[j, c]   (M fetches of C values)
// summed in a fixed order, so that two calls give the same bits (float
// atomics, as index_add_ uses, sum in a different order on every run): per
// element, each chunk of kScatterChunk fetches of its row in fetch order
// from 0, then the row's chunks in order from 0. Every step runs on the
// card and reads its counts there, so a call never waits for the host.
//   * The sort: a stable LSD radix sort written here (onesweep). A key
//     outside [0, rows) is first mapped to the spare value rows, so the sort
//     reads only bit_length(rows) bits (18 for the brick table, 24 for the
//     flat one) in the fewest passes of 8- or 9-bit digits (two of 9 bits
//     for the brick table, three of 8 for the flat one; the width is a
//     template argument, so the digit loops unroll), and the skipped keys
//     land after every row.
//     radix_histogram_kernel counts every pass's digits in one read of the
//     keys. A pass is then one radix_downsweep_kernel: blocks take tiles of
//     kSortTile keys in order from a counter; each warp ranks its 32 x
//     kSortItems keys in order with one ballot a digit bit (the peers below
//     a lane, plus the warp's running count of the digit), the warps' counts
//     are scanned in warp order, and the tile publishes its digit counts
//     and looks back through the earlier tiles' for where its keys go, so
//     each digit's output grows as one front; the tile is sorted by digit
//     in shared memory and written out in runs. A key's place depends on
//     its digit and its position only: stable. The payload is the 32-bit
//     fetch id, or for the pair layout the fetch's two values, copied to
//     shared memory with cp.async while the keys are ranked (so the reduce
//     reads the values in order instead of at random ids).
//   * The runs: the last pass writes each row's [first, end) in the sorted
//     order instead of the sorted keys, from where the key changes in its
//     tile (an integer atomic max where a row's run may cross into a
//     neighbouring tile; an empty row keeps the zeroed empty range).
//     Where the rows are wider than 128 (kColBlock), a warp takes a row's
//     columns a block of 128 at a time, staging the batch again for each.
//     The per-warp batch holds fewer fetches where C values a fetch would
//     not fit (lane_batch; the shared memory is sized by C and the width at
//     launch, and the lanes lie in a device table): any C and any width
//     whose batch of one fetch fits the card's opt-in shared memory.
//   * One reduce, a row of at most kScatterChunk fetches written straight
//     into out (an empty row as zeros: out is not zeroed first). Pair layout
//     (lane0 null, lanes (0, 1), width 2: the flat table):
//     scatter_rows_pair_kernel takes a thread per row and sums its sorted
//     values in order. Lane layout (the brick table's 16 values at lane0 +
//     lanes[c] of a 128-wide row): scatter_rows_lane_kernel takes a warp per
//     row: each lane owns columns lane + 32 j, a batch of 32 fetches' value
//     rows is copied into shared memory asynchronously (16 B each), and each
//     lane walks the batch in fetch order, finding which value of a fetch
//     lands on each of its columns from the inverse of lanes: no __syncwarp
//     per fetch. In both, a run longer than kScatterChunk (the coarse levels'
//     dense cells) takes slots for its chunks from a device counter (an
//     integer atomic: where a row's slots lie changes between runs, what is
//     summed into them does not); scatter_chunks_*_kernel sums each chunk
//     into its slot and scatter_combine_*_kernel each long row's slots in
//     chunk order.
// What bounds it: bytes, g read once (M C 4 B) plus the keys and lanes, the
// gradient table written once. The sort moves 4 B of key and 4 or 8 B of
// payload per fetch and pass (three passes at the flat table's 24 bits).

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSm = 2048 / kThreads;  // resident blocks at full occupancy
constexpr int kColBlock = 128;                 // columns a warp sums at once (one brick row)

__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const float4* __restrict__ table, const int* __restrict__ idx,
                   float4* __restrict__ out, long long n, long long rows, int w4) {
  const int lane = threadIdx.x & 31;
  const long long first = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  const long long stride = static_cast<long long>(gridDim.x) * kWarps;
  const float4 nan4 = make_float4(NAN, NAN, NAN, NAN);
  for (long long i = first; i < n; i += stride) {
    const long long r = __ldg(idx + i);
    float4* dst = out + i * w4;
    if (r < 0 || r >= rows) {
      for (int j = lane; j < w4; j += 32) dst[j] = nan4;
      continue;
    }
    const float4* src = table + r * w4;
    for (int j = lane; j < w4; j += 32) dst[j] = __ldg(src + j);
  }
}

__device__ __forceinline__ float nan_of(float) { return NAN; }
__device__ __forceinline__ float4 nan_of(float4) { return make_float4(NAN, NAN, NAN, NAN); }

// Rows narrower than a warp's float4s, or of any width: a thread per output
// element T (a float4, or a float where the width is not a multiple of 4 or
// the table not 16 B aligned), consecutive threads on consecutive elements,
// so the stores coalesce; width counts T. A row outside the table is written
// as NaN.
template <typename T>
__global__ void __launch_bounds__(kThreads)
gather_elems_kernel(const T* __restrict__ table, const int* __restrict__ idx,
                    T* __restrict__ out, long long n, long long rows, int width) {
  const long long total = n * width;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long e = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; e < total;
       e += stride) {
    const long long i = e / width;
    const long long r = __ldg(idx + i);
    out[e] = (r < 0 || r >= rows) ? nan_of(T{}) : __ldg(table + r * width + (e - i * width));
  }
}

// One pair, or NaNs for an index outside the table or an odd one (a pair
// starts on an even element).
__device__ __forceinline__ float2 pair_at(const float* __restrict__ table, long long m, int f) {
  return (f < 0 || f + 1LL >= m || (f & 1)) ? make_float2(NAN, NAN)
                                           : __ldg(reinterpret_cast<const float2*>(table + f));
}

// Four pairs a thread per step: one 16 B index load, four independent 8 B
// table loads in flight, two 16 B stores. The indices and the output
// stream through once, so they are read and written with the evict-first
// hint (__ldcs / __stcs) and leave the table's hot entries in L2. The last
// n % 4 pairs take the scalar loop. fidx is 16 B aligned (the wrapper
// checks); out is a fresh allocation.
__global__ void __launch_bounds__(kThreads)
gather_pairs_kernel(const float* __restrict__ table, long long m, const int* __restrict__ fidx,
                    float2* __restrict__ out, long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long first = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long n4 = n >> 2;
  const int4* idx4 = reinterpret_cast<const int4*>(fidx);
  float4* out4 = reinterpret_cast<float4*>(out);
  for (long long i = first; i < n4; i += stride) {
    const int4 f = __ldcs(idx4 + i);
    const float2 a = pair_at(table, m, f.x), b = pair_at(table, m, f.y);
    const float2 c = pair_at(table, m, f.z), d = pair_at(table, m, f.w);
    __stcs(out4 + 2 * i, make_float4(a.x, a.y, b.x, b.y));
    __stcs(out4 + 2 * i + 1, make_float4(c.x, c.y, d.x, d.y));
  }
  for (long long i = 4 * n4 + first; i < n; i += stride)
    __stcs(out + i, pair_at(table, m, __ldcs(fidx + i)));
}

// Blocks for `work` items at `per_block` items a block, capped at one full
// wave of resident blocks (the grid-stride loops take the rest).
unsigned grid_for(long long work, int per_block) {
  static int known_dev = -1, sms = 132;
  int dev = 0;
  if (cudaGetDevice(&dev) == cudaSuccess && dev != known_dev &&
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) == cudaSuccess)
    known_dev = dev;
  const long long want = (work + per_block - 1) / per_block;
  const long long cap = static_cast<long long>(sms) * kBlocksPerSm;
  return static_cast<unsigned>(want < cap ? want : cap);
}


// ---- scatter_rows: the sort ----

constexpr int kSortThreads = 256;
constexpr int kSortWarps = kSortThreads / 32;
constexpr int kSortItems = 16;                         // keys a thread ranks per tile
constexpr int kSortTile = kSortThreads * kSortItems;  // keys a block takes at once
// A pass sorts by a digit of kBits bits, 8 or 9: whichever takes fewer
// passes over the table's key bits, 8 on a tie (sort_digit_bits). So the
// flat table's 24 bits take three 8-bit passes (with 9-bit digits the
// downsweep holds two blocks an SM instead of three: 4.24 ms a flat call
// instead of 3.25 on an H100), the brick table's 18 two 9-bit ones.
template <int kBits>
struct Digits {
  static constexpr int kCount = 1 << kBits;
  static constexpr unsigned kMask = kCount - 1;
  static constexpr int kMaxPasses = (31 + kBits - 1) / kBits;  // keys below 2^31
  static constexpr int kPerThread = (kCount + kSortThreads - 1) / kSortThreads;  // in a scan
  // the digit of `key` that pass `pass` sorts by
  static __device__ __forceinline__ unsigned of(unsigned key, int pass) {
    return (key >> (pass * kBits)) & kMask;
  }
};
constexpr int kScatterChunk = 64;  // fetches per partial sum: the longest sequential walk
constexpr int kScatterBatch = 32;  // fetches a warp stages at once (lane layout)
constexpr unsigned kFull = 0xffffffffu;

// The exclusive prefix sum of v over the block's kT threads, and the block's
// total in *total. scratch holds kT / 32 + 1 ints.
template <int kT>
__device__ __forceinline__ int block_exclusive_sum(int v, int* scratch, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) scratch[warp] = x;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < kT / 32 ? scratch[lane] : 0;
    int s = w;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, s, o);
      if (lane >= o) s += y;
    }
    if (lane < kT / 32) scratch[lane] = s - w;
    if (lane == 31) scratch[kT / 32] = s;
  }
  __syncthreads();
  const int r = scratch[warp] + x - v;
  *total = scratch[kT / 32];
  __syncthreads();  // scratch may be reused
  return r;
}

struct SortPass {
  const int* raw;            // first pass: the (n,) int32 keys, mapped on read
  const void* first_vals;    // first pass: the payload of fetch i, or null (the id i)
  const unsigned* keys;      // later passes: the keys and payloads of the last pass
  const void* vals;
  unsigned* keys_out;
  void* vals_out;
  const int* hist;           // (passes, 2^kBits): every pass's digit counts
  unsigned long long* status;  // (tiles, 2^kBits): (flag << 32) | count, zeroed per call
  int* next_tile;            // (passes,): tiles taken so far, zeroed per call
  int2* ranges;              // last pass: each row's run instead of the keys (or null)
  int last;                  // the last pass
  long long n;
  int rows;                  // keys outside [0, rows) become rows
  int pass, tiles;
};

template <bool kFirst>
__device__ __forceinline__ unsigned key_at(const SortPass& p, long long i) {
  if (kFirst) {
    const int k = __ldg(p.raw + i);
    return (k < 0 || k >= p.rows) ? static_cast<unsigned>(p.rows) : static_cast<unsigned>(k);
  }
  return p.keys[i];
}

// The lanes holding the same digit as this one among `valid`: one ballot a
// bit (__match_any_sync serializes on this card). Kept a loop: unrolled
// into the downsweep's 16 ranked keys, the flat table's first pass took
// 1.10 ms instead of 0.95 on an H100.
template <int kBits>
__device__ __forceinline__ unsigned match_digit(unsigned digit, unsigned valid) {
  unsigned peers = valid;
#pragma unroll 1
  for (int b = 0; b < kBits; ++b) {
    const unsigned set = __ballot_sync(kFull, (digit >> b) & 1u);
    peers &= ((digit >> b) & 1u) ? set : ~set;
  }
  return peers;
}

// An asynchronous copy of sizeof(P) bytes from global to shared memory.
template <typename P>
__device__ __forceinline__ void copy_async(P* dst, const P* src) {
  const unsigned to = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (sizeof(P) == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(to), "l"(src));
  else if constexpr (sizeof(P) == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(to), "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(to), "l"(src));
}

// hist[q * D + d] += the keys whose pass-q digit is d, for every pass at
// once: one read of the keys (integer atomics: the counts are exact).
template <int kBits>
__global__ void __launch_bounds__(kSortThreads) radix_histogram_kernel(const SortPass p,
                                                                       int passes, int* hist) {
  using Dg = Digits<kBits>;
  constexpr int D = Dg::kCount;
  __shared__ int local[Dg::kMaxPasses * D];
  for (int i = threadIdx.x; i < passes * D; i += kSortThreads) local[i] = 0;
  __syncthreads();
  const long long stride = static_cast<long long>(gridDim.x) * kSortThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kSortThreads + threadIdx.x; i < p.n;
       i += stride) {
    const unsigned k = key_at<true>(p, i);
    for (int q = 0; q < passes; ++q) atomicAdd(local + q * D + Dg::of(k, q), 1);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < passes * D; i += kSortThreads)
    if (local[i]) atomicAdd(hist + i, local[i]);
}

template <int kBits>
constexpr size_t downsweep_smem(int payload) {
  return sizeof(int) * ((4 + kSortWarps) * Digits<kBits>::kCount + kSortThreads / 32 + 4)
         + (4 + 2 + static_cast<size_t>(payload)) * kSortTile;
}

// A tile's status word: (flag << 32) | count, the flag 2 pass + 1 for the
// tile's own count, 2 pass + 2 for the count of every tile up to it, 0 (or
// an earlier pass's) while nothing is published.
constexpr unsigned long long kAggregate = 1ull << 32;

// One pass, tile by tile in the order the tiles are taken (an atomic
// counter), to keys_out / vals_out: a key goes to its digit's first position
// (the digit counts, scanned) plus the keys of its digit in earlier tiles
// (looked back through the tiles' published counts: onesweep) plus those
// before it in its tile. So every digit's output grows as one front. The
// payload never enters registers: it is copied into shared memory
// asynchronously while the keys are ranked, and the sorted tile carries
// each key's position in the tile.
template <bool kFirst, typename P, int kBits>
__global__ void __launch_bounds__(kSortThreads, 3) radix_downsweep_kernel(const SortPass p) {
  using Dg = Digits<kBits>;
  constexpr int kDigits = Dg::kCount;
  constexpr int kDigitsPerThread = Dg::kPerThread;
  extern __shared__ __align__(16) int smem[];
  // the payload in shared memory: none for the first pass's ids (the
  // position is the id), else a tile's worth in input order
  constexpr bool kStaged = !(kFirst && sizeof(P) == sizeof(int));
  int* gbase = smem;                  // kDigits: each digit's first output position
  int* base = gbase + kDigits;        // kDigits: the tile's first output position of each digit
  int* ttot = base + kDigits;         // kDigits: the tile's keys of each digit
  int* tstart = ttot + kDigits;       // kDigits: where each digit starts in the sorted tile
  int* whist = tstart + kDigits;      // kSortWarps x kDigits: per warp, then the warps before it
  int* scratch = whist + kSortWarps * kDigits;  // kSortThreads / 32 + 1, then the tile index
  int* tile_at = scratch + kSortThreads / 32 + 1;
  P* svals = reinterpret_cast<P*>(scratch + kSortThreads / 32 + 4);  // input order, 8 B aligned
  unsigned* skeys = reinterpret_cast<unsigned*>(svals + kSortTile);   // sorted order
  unsigned short* sidx = reinterpret_cast<unsigned short*>(skeys + kSortTile);
  const P* vals_in = static_cast<const P*>(kFirst ? p.first_vals : p.vals);
  P* vals_out = static_cast<P*>(p.vals_out);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1;
  int* wh = whist + warp * kDigits;
  {  // gbase: the pass's digit counts, scanned
    const int* h = p.hist + p.pass * kDigits;
    const int d0 = threadIdx.x * kDigitsPerThread;
    int s = 0;
#pragma unroll
    for (int i = 0; i < kDigitsPerThread; ++i) s += d0 + i < kDigits ? h[d0 + i] : 0;
    int total;
    int run = block_exclusive_sum<kSortThreads>(s, scratch, &total);
#pragma unroll
    for (int i = 0; i < kDigitsPerThread; ++i) {
      if (d0 + i < kDigits) {
        gbase[d0 + i] = run;
        run += h[d0 + i];
      }
    }
  }
  const unsigned long long aggregate = kAggregate * (2 * p.pass + 1);  // this pass's flags
  const unsigned long long prefix = kAggregate * (2 * p.pass + 2);
  for (int i = threadIdx.x; i < kDigits; i += kSortThreads) ttot[i] = 0;
  for (;;) {
    if (threadIdx.x == 0) *tile_at = atomicAdd(p.next_tile + p.pass, 1);
    __syncthreads();
    const int t = *tile_at;
    if (t >= p.tiles) break;
    const long long t0 = static_cast<long long>(t) * kSortTile;
    const int nt = static_cast<int>(min(static_cast<long long>(kSortTile), p.n - t0));
    if constexpr (kStaged) {
      for (int j = threadIdx.x; j < nt; j += kSortThreads) copy_async(svals + j, vals_in + t0 + j);
      asm volatile("cp.async.commit_group;\n" ::);
    }
    for (int i = lane; i < kDigits; i += 32) wh[i] = 0;
    unsigned key[kSortItems];
    int rank[kSortItems];
#pragma unroll
    for (int k = 0; k < kSortItems; ++k) {
      const int j = (warp * kSortItems + k) * 32 + lane;  // the warp's keys, in order
      key[k] = j < nt ? key_at<kFirst>(p, t0 + j) : 0u;
    }
    // the tile's digit counts first (ttot was zeroed after the last tile)
#pragma unroll
    for (int k = 0; k < kSortItems; ++k)
      if ((warp * kSortItems + k) * 32 + lane < nt) atomicAdd(ttot + Dg::of(key[k], p.pass), 1);
    __syncthreads();
    // publish this tile's counts now; look back after the ranking
    unsigned long long* mine = p.status + static_cast<long long>(t) * kDigits;
    for (int dg = threadIdx.x; dg < kDigits; dg += kSortThreads)
      atomicExch(mine + dg, (t == 0 ? prefix : aggregate) | static_cast<unsigned>(ttot[dg]));
#pragma unroll
    for (int k = 0; k < kSortItems; ++k) {
      const bool valid = (warp * kSortItems + k) * 32 + lane < nt;
      const unsigned digit = Dg::of(key[k], p.pass);
      const unsigned peers = match_digit<kBits>(digit, __ballot_sync(kFull, valid));
      rank[k] = valid ? wh[digit] + __popc(peers & below) : 0;
      __syncwarp();
      if (valid && lane == __ffs(peers) - 1) wh[digit] += __popc(peers);
      __syncwarp();
    }
    __syncthreads();
    for (int dg = threadIdx.x; dg < kDigits; dg += kSortThreads) {
      int s = 0;
#pragma unroll
      for (int w = 0; w < kSortWarps; ++w) {
        const int c = whist[w * kDigits + dg];
        whist[w * kDigits + dg] = s;
        s += c;
      }
      int before = 0;  // the earlier tiles' keys of this digit
      for (int u = t - 1; u >= 0;) {
        const unsigned long long st = *reinterpret_cast<volatile unsigned long long*>(
            p.status + static_cast<long long>(u) * kDigits + dg);
        if (st < aggregate) continue;  // not published yet in this pass
        before += static_cast<int>(st & 0xffffffffu);
        if (st >= prefix) break;
        --u;
      }
      if (t > 0) atomicExch(mine + dg, prefix | static_cast<unsigned>(before + s));
      base[dg] = gbase[dg] + before;
    }
    __syncthreads();
    {
      const int d0 = threadIdx.x * kDigitsPerThread;
      int s = 0;
#pragma unroll
      for (int i = 0; i < kDigitsPerThread; ++i) s += d0 + i < kDigits ? ttot[d0 + i] : 0;
      int total;
      int run = block_exclusive_sum<kSortThreads>(s, scratch, &total);
#pragma unroll
      for (int i = 0; i < kDigitsPerThread; ++i) {
        if (d0 + i < kDigits) {
          tstart[d0 + i] = run;
          run += ttot[d0 + i];
        }
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kSortItems; ++k) {
      const int j = (warp * kSortItems + k) * 32 + lane;
      if (j < nt) {
        const unsigned digit = Dg::of(key[k], p.pass);
        const int pos = tstart[digit] + wh[digit] + rank[k];
        skeys[pos] = key[k];
        sidx[pos] = static_cast<unsigned short>(j);
      }
    }
    if constexpr (kStaged) asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    for (int j = threadIdx.x; j < nt; j += kSortThreads) {
      const unsigned k = skeys[j];
      const unsigned digit = Dg::of(k, p.pass);
      const long long out = static_cast<long long>(base[digit]) + (j - tstart[digit]);
      if (p.pass != p.last || p.ranges == nullptr) {
        p.keys_out[out] = k;
      } else if (k < static_cast<unsigned>(p.rows)) {
        // each row's run, as (n - first, end) from zero: where the key changes
        // inside this tile's run of the digit, the tile owns the bound; at the
        // run's ends a neighbouring tile may hold the row too
        const int seg0 = tstart[digit], seg1 = digit + 1 < kDigits ? tstart[digit + 1] : nt;
        int* r = reinterpret_cast<int*>(p.ranges + k);
        if (j == seg0)
          atomicMax(r, static_cast<int>(p.n - out));
        else if (skeys[j - 1] != k)
          r[0] = static_cast<int>(p.n - out);
        if (j == seg1 - 1)
          atomicMax(r + 1, static_cast<int>(out + 1));
        else if (skeys[j + 1] != k)
          r[1] = static_cast<int>(out + 1);
      }
      if constexpr (kStaged)
        vals_out[out] = svals[sidx[j]];
      else
        vals_out[out] = static_cast<P>(t0 + sidx[j]);
    }
    for (int i = threadIdx.x; i < kDigits; i += kSortThreads) ttot[i] = 0;
    __syncthreads();
  }
}

// ---- scatter_rows: the runs and the reduce ----

struct ScatterParams {
  const float* g;          // (M, C) cotangents, fetch-major
  const int* ids;          // lane layout: (M,) fetch ids in stable key order
  const float2* sorted_g;  // pair layout: (M,) the fetches' values in that order
  const int* lane0;        // (M,) base column per fetch, or null (0)
  long long M;
  int rows, width, C;
  int vec4;                // C % 4 == 0 and g 16 B aligned: value rows as float4
  int batch;               // lane layout: fetches a warp stages at once (lane_batch)
  const int* lanes;        // (C,) in device memory
  int2* ranges;            // (rows,) each row's run in the sorted order (run_of)
  int* counters;           // [slots taken, long rows]
  int2* slot_row;          // per slot: (row, chunk)
  int4* long_rows;         // per long row: (row, first slot, chunks, 0)
  float* partial;          // (slots, width)
  float* out;              // (rows, width), every row written here
};

// Row k's run [first, end) in the sorted order, from the last pass's
// (n - first, end); an empty row gives end <= first.
__device__ __forceinline__ int2 run_of(const ScatterParams& p, long long k) {
  const int2 r = p.ranges[k];
  return make_int2(static_cast<int>(p.M - r.x), r.y);
}

// A run of more than kScatterChunk fetches: its chunks take consecutive
// slots, returned; one thread calls it.
__device__ __forceinline__ int take_slots(const ScatterParams& p, int row, int chunks) {
  const int slot = atomicAdd(p.counters, chunks);
  const int m = atomicAdd(p.counters + 1, 1);
  p.long_rows[m] = make_int4(row, slot, chunks, 0);
  return slot;
}

// pair layout: the sum of the sorted values at [beg, end), in order from 0
__device__ __forceinline__ float2 pair_sum(const ScatterParams& p, int beg, int end) {
  float2 acc = make_float2(0.f, 0.f);
  for (int j = beg; j < end; j += 16) {
    float2 v[16];
#pragma unroll
    for (int u = 0; u < 16; ++u) v[u] = j + u < end ? p.sorted_g[j + u] : make_float2(0.f, 0.f);
#pragma unroll
    for (int u = 0; u < 16; ++u) {
      if (j + u < end) {
        acc.x = __fadd_rn(acc.x, v[u].x);
        acc.y = __fadd_rn(acc.y, v[u].y);
      }
    }
  }
  return acc;
}

// pair layout, a thread per row: a run of at most kScatterChunk fetches
// straight into out (an empty row as zeros: out is not zeroed first), a
// longer one's chunks to slots
__global__ void __launch_bounds__(kThreads) scatter_rows_pair_kernel(const ScatterParams p) {
  float2* out = reinterpret_cast<float2*>(p.out);
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long k = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; k < p.rows;
       k += stride) {
    const int2 r = run_of(p, k);
    const int n = r.y - r.x;
    if (n <= kScatterChunk) {
      out[k] = n > 0 ? pair_sum(p, r.x, r.y) : make_float2(0.f, 0.f);
      continue;
    }
    const int chunks = (n + kScatterChunk - 1) / kScatterChunk;
    const int slot = take_slots(p, static_cast<int>(k), chunks);
    for (int c = 0; c < chunks; ++c) p.slot_row[slot + c] = make_int2(static_cast<int>(k), c);
  }
}

__global__ void __launch_bounds__(kThreads) scatter_chunks_pair_kernel(const ScatterParams p) {
  const int slots = p.counters[0];
  float2* partial = reinterpret_cast<float2*>(p.partial);
  for (int s = blockIdx.x * kThreads + threadIdx.x; s < slots; s += gridDim.x * kThreads) {
    const int2 rc = p.slot_row[s];
    const int2 r = run_of(p, rc.x);
    const int beg = r.x + rc.y * kScatterChunk;
    partial[s] = pair_sum(p, beg, min(r.y, beg + kScatterChunk));
  }
}

// The row's slots in chunk order; 8 slots' loads in flight at once.
__global__ void __launch_bounds__(kThreads) scatter_combine_pair_kernel(const ScatterParams p) {
  const int n = p.counters[1];
  const float2* partial = reinterpret_cast<const float2*>(p.partial);
  float2* out = reinterpret_cast<float2*>(p.out);
  for (int m = blockIdx.x * kThreads + threadIdx.x; m < n; m += gridDim.x * kThreads) {
    const int4 lr = p.long_rows[m];
    float2 acc = make_float2(0.f, 0.f);
    for (int c = 0; c < lr.z; c += 8) {
      float2 v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        v[u] = c + u < lr.z ? partial[lr.y + c + u] : make_float2(0.f, 0.f);
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        if (c + u < lr.z) {
          acc.x = __fadd_rn(acc.x, v[u].x);
          acc.y = __fadd_rn(acc.y, v[u].y);
        }
      }
    }
    out[lr.x] = acc;
  }
}

// Lane layout: per warp, a batch of staged value rows (C floats each) and
// their ids and base columns; per block, the inverse of lanes (inv[col] = c
// with lanes[c] == col, or -1). Dynamic shared memory, sized for C, the
// batch and the inverse's columns (lane_smem_bytes).
struct LaneSmem {
  float* vals;  // kWarps x batch x C, 16 B aligned
  int* ids;     // kWarps x batch
  int* l0;      // kWarps x batch
  int* inv;     // kColBlock, or the row's width (kWide)
  __device__ LaneSmem(int C, int batch) {
    extern __shared__ __align__(16) float lane_smem[];
    vals = lane_smem;
    ids = reinterpret_cast<int*>(vals + kWarps * batch * C);
    l0 = ids + kWarps * batch;
    inv = l0 + kWarps * batch;
  }
};

size_t lane_smem_bytes(int C, int batch, int inv) {
  return sizeof(float) * kWarps * batch * static_cast<size_t>(C) +
         sizeof(int) * (2 * kWarps * batch + static_cast<size_t>(inv));
}

// The lane kernels come in two instances. The narrow one (kWide false) takes
// rows of at most kColBlock columns and a batch of kScatterBatch fetches,
// both at compile time (the brick table's 16 values of a 128-wide row, the
// flat table's rows of F values). The wide one takes any C and width: a
// warp sums a row kColBlock columns at a time, staging the batch again for
// each, the batch is lane_batch's and the inverse has the row's width.
template <bool kWide>
__device__ __forceinline__ void init_inverse(const ScatterParams& p, LaneSmem& sm) {
  const int cols = kWide ? p.width : kColBlock;
  for (int c = threadIdx.x; c < cols; c += kThreads) sm.inv[c] = -1;
  __syncthreads();
  for (int c = threadIdx.x; c < p.C; c += kThreads) sm.inv[__ldg(p.lanes + c)] = c;
  __syncthreads();
}

// lane layout: acc[j] (column col0 + lane + 32 j) += the values that the
// fetches at [beg, end) put on it, in fetch order. The whole warp calls it.
template <bool kWide>
__device__ __forceinline__ void lane_sum(const ScatterParams& p, LaneSmem& sm, int beg, int end,
                                         int col0, float acc[4]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int batch = kWide ? p.batch : kScatterBatch;
  const int cols = kWide ? p.width : kColBlock;  // the inverse's
  float* vals = sm.vals + warp * batch * p.C;
  int* ids = sm.ids + warp * batch;
  int* l0 = sm.l0 + warp * batch;
  const int C = p.C;
  for (int b = beg; b < end; b += batch) {
    const int nb = min(batch, end - b);
    __syncwarp();  // the last batch is consumed
    const int id = lane < nb ? __ldg(p.ids + b + lane) : 0;
    if (lane < nb) ids[lane] = id;
    __syncwarp();
    // the value rows go to shared memory asynchronously (no register holds
    // them, so every load of the batch is in flight at once), the base
    // columns meanwhile
    if (p.vec4) {
      const int nv = C / 4;
      for (int t = lane; t < nb * nv; t += 32) {
        const int f = t / nv, v = t - f * nv;
        copy_async(reinterpret_cast<float4*>(vals + f * C) + v,
                   reinterpret_cast<const float4*>(p.g + static_cast<long long>(ids[f]) * C) + v);
      }
    } else {
      for (int t = lane; t < nb * C; t += 32) {
        const int f = t / C, c = t - f * C;
        copy_async(vals + t, p.g + static_cast<long long>(ids[f]) * C + c);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
    if (lane < nb) l0[lane] = p.lane0 != nullptr ? __ldg(p.lane0 + id) : 0;
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncwarp();
    for (int f = 0; f < nb; ++f) {
      const int base = l0[f];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = col0 + lane + 32 * j, delta = col - base;
        if (col < p.width && delta >= 0 && delta < cols) {
          const int c = sm.inv[delta];
          if (c >= 0) acc[j] = __fadd_rn(acc[j], vals[f * C + c]);
        }
      }
    }
  }
}

// columns col0 + lane + 32 j of a row
__device__ __forceinline__ void store_row(float* dst, int width, int col0, const float acc[4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (col0 + lane + 32 * j < width) dst[col0 + lane + 32 * j] = acc[j];
}

// fn(col0) for each block of kColBlock columns of a row: once, at 0, in the
// narrow instances
template <bool kWide, class Fn>
__device__ __forceinline__ void each_block(int width, const Fn& fn) {
  if constexpr (kWide) {
    for (int col0 = 0; col0 < width; col0 += kColBlock) fn(col0);
  } else {
    fn(0);
  }
}

// lane layout, a warp per row: short runs straight into out
template <bool kWide>
__global__ void __launch_bounds__(kThreads) scatter_rows_lane_kernel(const ScatterParams p) {
  LaneSmem sm(p.C, kWide ? p.batch : kScatterBatch);
  init_inverse<kWide>(p, sm);
  const int lane = threadIdx.x & 31;
  const int stride = gridDim.x * kWarps;
  for (int k = blockIdx.x * kWarps + (threadIdx.x >> 5); k < p.rows; k += stride) {
    const int2 r = run_of(p, k);
    const int n = r.y - r.x;
    if (n <= kScatterChunk) {
      each_block<kWide>(p.width, [&](int col0) {
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
        if (n > 0) lane_sum<kWide>(p, sm, r.x, r.y, col0, acc);
        store_row(p.out + static_cast<long long>(k) * p.width, p.width, col0, acc);
      });
      continue;
    }
    const int chunks = (n + kScatterChunk - 1) / kScatterChunk;
    int slot = 0;
    if (lane == 0) slot = take_slots(p, k, chunks);
    slot = __shfl_sync(kFull, slot, 0);
    for (int c = lane; c < chunks; c += 32) p.slot_row[slot + c] = make_int2(k, c);
  }
}

template <bool kWide>
__global__ void __launch_bounds__(kThreads) scatter_chunks_lane_kernel(const ScatterParams p) {
  LaneSmem sm(p.C, kWide ? p.batch : kScatterBatch);
  init_inverse<kWide>(p, sm);
  const int slots = p.counters[0];
  for (int s = blockIdx.x * kWarps + (threadIdx.x >> 5); s < slots; s += gridDim.x * kWarps) {
    const int2 rc = p.slot_row[s];
    const int2 r = run_of(p, rc.x);
    const int beg = r.x + rc.y * kScatterChunk;
    each_block<kWide>(p.width, [&](int col0) {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      lane_sum<kWide>(p, sm, beg, min(r.y, beg + kScatterChunk), col0, acc);
      store_row(p.partial + static_cast<long long>(s) * p.width, p.width, col0, acc);
    });
  }
}

// The row's slots in chunk order, a warp a row; 4 slots' loads in flight.
template <bool kWide>
__global__ void __launch_bounds__(kThreads) scatter_combine_lane_kernel(const ScatterParams p) {
  const int n = p.counters[1];
  const int lane = threadIdx.x & 31;
  for (int m = blockIdx.x * kWarps + (threadIdx.x >> 5); m < n; m += gridDim.x * kWarps) {
    const int4 lr = p.long_rows[m];
    each_block<kWide>(p.width, [&](int col0) {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      for (int c = 0; c < lr.z; c += 4) {
        float v[4][4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float* src = p.partial + static_cast<long long>(lr.y + c + u) * p.width + col0;
#pragma unroll
          for (int j = 0; j < 4; ++j)
            v[u][j] = c + u < lr.z && col0 + lane + 32 * j < p.width ? src[lane + 32 * j] : 0.f;
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (c + u < lr.z) acc[j] = __fadd_rn(acc[j], v[u][j]);
      }
      store_row(p.out + static_cast<long long>(lr.x) * p.width, p.width, col0, acc);
    });
  }
}

// The wide lane instances' batch (fetches a warp stages at once) and their
// shared memory: kScatterBatch where that fits the default 48 KB, else the
// most (a power of two) that does, else the most that fits the card's
// opt-in maximum, which both wide kernels are then given. Returns 0, -2
// where not even one fetch fits, or a cudaError_t.
int lane_batch(int C, int width, int* batch, size_t* smem) {
  constexpr size_t kDefault = 48 * 1024;
  int b = kScatterBatch;
  while (b > 1 && lane_smem_bytes(C, b, width) > kDefault) b /= 2;
  *batch = b;
  *smem = lane_smem_bytes(C, b, width);
  if (*smem <= kDefault) return 0;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  b = kScatterBatch;
  while (b > 1 && lane_smem_bytes(C, b, width) > static_cast<size_t>(optin)) b /= 2;
  *batch = b;
  *smem = lane_smem_bytes(C, b, width);
  if (*smem > static_cast<size_t>(optin)) return -2;
  err = cudaFuncSetAttribute(scatter_rows_lane_kernel<true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(*smem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(scatter_chunks_lane_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(*smem));
  return static_cast<int>(err);
}

int bit_length(long long v) {
  int b = 0;
  while (v > 0) {
    ++b;
    v >>= 1;
  }
  return b;
}

// The sort's plan for keys in [0, rows], the same as
// kernels/gather_rows.sort_plan: rows' bits (at least one) in passes of
// 8- or 9-bit digits, whichever takes fewer passes, 8 on a tie.
int sort_key_bits(long long rows) { return bit_length(rows) > 0 ? bit_length(rows) : 1; }

int sort_digit_bits(long long rows) {
  const int bits = sort_key_bits(rows);
  return (bits + 8) / 9 < (bits + 7) / 8 ? 9 : 8;
}

int sort_passes(long long rows) {
  const int d = sort_digit_bits(rows);
  return (sort_key_bits(rows) + d - 1) / d;
}

// Blocks of a pass's downsweep: as many as the card holds at once, at most
// one a tile (the rest of the tiles go to whichever block is free). The
// card's count is asked once per device and instance (a call's host time
// is on the card's critical path), which also lets the downsweep take its
// shared memory.
template <typename P, int kBits>
cudaError_t sort_blocks(long long tiles, unsigned* blocks) {
  static int known_dev = -1;
  static long long known_cap = 0;
  constexpr int smem = static_cast<int>(downsweep_smem<kBits>(sizeof(P)));
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev != known_dev) {
    int sms = 132, resident = 1;
    err = cudaFuncSetAttribute(radix_downsweep_kernel<true, P, kBits>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(radix_downsweep_kernel<false, P, kBits>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &resident, radix_downsweep_kernel<false, P, kBits>, kSortThreads, smem);
    if (err != cudaSuccess) return err;
    known_dev = dev;
    known_cap = static_cast<long long>(sms) * (resident > 0 ? resident : 1);
  }
  *blocks = static_cast<unsigned>(tiles < known_cap ? tiles : known_cap);
  return cudaSuccess;
}

// The workspace, carved in order from one buffer (each piece 256 B aligned).
// The sort's payload is the fetch id, or for the pair layout the fetch's two
// values (the reduce then reads them in order, not at random ids). The
// sort's counts, the tiles' status and the counters sit together, zeroed by
// one memset a call.
struct Workspace {
  unsigned* keys[2];
  void* vals[2];
  unsigned char* zeroed;
  long long zeroed_bytes;
  int* hist;
  int* next_tile;
  unsigned long long* status;
  int* counters;
  int2* ranges;
  int2* slot_row;
  int4* long_rows;
  float* partial;
};

long long layout(long long M, long long rows, int width, bool pair, unsigned char* base,
                 Workspace* w) {
  const int passes = sort_passes(rows);
  const long long digits = 1LL << sort_digit_bits(rows);
  const long long tiles = (M + kSortTile - 1) / kSortTile;
  long long off = 0;
  auto take = [&](long long bytes) {
    unsigned char* at = base + off;
    off += (bytes + 255) / 256 * 256;
    return static_cast<void*>(at);
  };
  const long long slots = M / 32 + 2;
  for (int i = 0; i < 2; ++i) w->keys[i] = static_cast<unsigned*>(take(4 * M));
  for (int i = 0; i < 2; ++i) w->vals[i] = take((pair ? 8 : 4) * M);
  const long long start = off;
  w->zeroed = base + off;
  w->hist = static_cast<int*>(take(4 * passes * digits));
  w->next_tile = static_cast<int*>(take(4LL * passes));
  w->counters = static_cast<int*>(take(8));
  w->status = static_cast<unsigned long long*>(take(8 * tiles * digits));
  w->ranges = static_cast<int2*>(take(8 * rows));
  w->zeroed_bytes = off - start;
  w->slot_row = static_cast<int2*>(take(8 * slots));
  w->long_rows = static_cast<int4*>(take(16 * (M / 64 + 2)));
  w->partial = static_cast<float*>(take(4LL * width * slots));
  return off;
}

// The stable sort of the M keys (mapped: outside [0, rows) -> rows) with
// their payload (P = int: the fetch ids; P = float2: first_vals[i]); sets
// the buffers holding the result. With `ranges`, the last pass writes each
// row's run there instead of the sorted keys. The workspace's zeroed part is
// zeroed. kBits: sort_digit_bits(rows).
template <typename P, int kBits>
cudaError_t radix_sort_in(const int* key, const void* first_vals, long long M, long long rows,
                          const Workspace& w, int2* ranges, cudaStream_t st, unsigned** keys,
                          void** vals) {
  const int passes = sort_passes(rows);
  const long long tiles = (M + kSortTile - 1) / kSortTile;
  unsigned blocks;
  cudaError_t err = sort_blocks<P, kBits>(tiles, &blocks);
  if (err != cudaSuccess) return err;
  SortPass p{};
  p.raw = key;
  p.first_vals = first_vals;
  p.n = M;
  p.rows = static_cast<int>(rows);
  p.tiles = static_cast<int>(tiles);
  p.hist = w.hist;
  p.status = w.status;
  p.next_tile = w.next_tile;
  p.ranges = ranges;
  p.last = passes - 1;
  radix_histogram_kernel<kBits><<<grid_for(M, kSortThreads), kSortThreads, 0, st>>>(p, passes,
                                                                                   w.hist);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  constexpr size_t smem = downsweep_smem<kBits>(sizeof(P));
  for (int pass = 0; pass < passes; ++pass) {
    p.pass = pass;
    p.keys_out = w.keys[pass & 1];
    p.vals_out = w.vals[pass & 1];
    if (pass == 0)
      radix_downsweep_kernel<true, P, kBits><<<blocks, kSortThreads, smem, st>>>(p);
    else
      radix_downsweep_kernel<false, P, kBits><<<blocks, kSortThreads, smem, st>>>(p);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    p.keys = p.keys_out;
    p.vals = p.vals_out;
  }
  *keys = const_cast<unsigned*>(p.keys);
  *vals = const_cast<void*>(p.vals);
  return cudaSuccess;
}

template <typename P>
cudaError_t radix_sort(const int* key, const void* first_vals, long long M, long long rows,
                       const Workspace& w, int2* ranges, cudaStream_t st, unsigned** keys,
                       void** vals) {
  return sort_digit_bits(rows) == 9
             ? radix_sort_in<P, 9>(key, first_vals, M, rows, w, ranges, st, keys, vals)
             : radix_sort_in<P, 8>(key, first_vals, M, rows, w, ranges, st, keys, vals);
}

}  // namespace

extern "C" {

// table (rows, width) f32, any width; idx (n,) int32; out (n, width) f32.
// Where the width is a multiple of 4 and the table and out are 16 B
// aligned, 16 B loads: a warp a row from 128 wide (the brick table's rows),
// a thread a float4 below; else a thread a float. Returns 0 or a
// cudaError_t.
int nerf_gather_rows(const void* table, const void* idx, void* out, long long n,
                     long long rows, int width, void* stream) {
  if (n <= 0 || width <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* ix = static_cast<const int*>(idx);
  const bool vec = width % 4 == 0 && reinterpret_cast<uintptr_t>(table) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (vec && width >= 128) {
    gather_rows_kernel<<<grid_for(n, kWarps), kThreads, 0, st>>>(
        static_cast<const float4*>(table), ix, static_cast<float4*>(out), n, rows, width / 4);
  } else if (vec) {
    gather_elems_kernel<float4><<<grid_for(n * (width / 4), kThreads), kThreads, 0, st>>>(
        static_cast<const float4*>(table), ix, static_cast<float4*>(out), n, rows, width / 4);
  } else {
    gather_elems_kernel<float><<<grid_for(n * width, kThreads), kThreads, 0, st>>>(
        static_cast<const float*>(table), ix, static_cast<float*>(out), n, rows, width);
  }
  return static_cast<int>(cudaGetLastError());
}

// table (m,) f32 with an 8 B aligned base; fidx (n,) int32 with a 16 B
// aligned base; out (n, 2) f32, NaN pairs for odd or outside indices.
// Returns 0 or a cudaError_t.
int nerf_gather_pairs(const void* table, long long m, const void* fidx, void* out, long long n,
                      void* stream) {
  if (n <= 0) return 0;
  gather_pairs_kernel<<<grid_for((n + 3) / 4, kThreads), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(table), m, static_cast<const int*>(fidx),
      static_cast<float2*>(out), n);
  return static_cast<int>(cudaGetLastError());
}


// The sort's passes and digit bits for keys in [0, rows]
// (kernels/gather_rows.sort_plan).
int nerf_sort_passes(long long rows) { return sort_passes(rows); }
int nerf_sort_digit_bits(long long rows) { return sort_digit_bits(rows); }

// The bytes of scatter_rows' workspace for M fetches into a (rows, width)
// table; pair: the pair layout (lane0 null, lanes (0, 1), width 2), whose
// sort carries the values.
long long nerf_scatter_workspace_bytes(long long M, long long rows, int width, int pair) {
  Workspace w;
  return layout(M, rows, width, pair != 0, nullptr, &w);
}

// The sort alone: keys_out (M,) uint32 the mapped keys in stable order (a key
// outside [0, rows) as rows), ids_out (M,) int32 their fetch ids; workspace
// of nerf_scatter_workspace_bytes(M, rows, 1, 0) bytes. Returns 0, a
// cudaError_t, or -1 for rows < 1.
int nerf_radix_sort(const void* key, long long M, long long rows, void* workspace,
                    void* keys_out, void* ids_out, void* stream) {
  if (rows < 1) return -1;
  if (M <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  Workspace w;
  layout(M, rows, 1, false, static_cast<unsigned char*>(workspace), &w);
  unsigned* keys;
  void* ids;
  cudaError_t err = cudaMemsetAsync(w.zeroed, 0, w.zeroed_bytes, st);
  if (err == cudaSuccess)
    err = radix_sort<int>(static_cast<const int*>(key), nullptr, M, rows, w, nullptr, st, &keys,
                          &ids);
  if (err == cudaSuccess)
    err = cudaMemcpyAsync(keys_out, keys, 4 * M, cudaMemcpyDeviceToDevice, st);
  if (err == cudaSuccess)
    err = cudaMemcpyAsync(ids_out, ids, 4 * M, cudaMemcpyDeviceToDevice, st);
  return static_cast<int>(err);
}

// out (rows, width) f32 (every row is written); g (M, C) f32; key (M,) int32; lane0 (M,)
// int32 or null; lanes (C,) int32, distinct and in [0, width), in host memory and
// (lanes_dev) in device memory; workspace of nerf_scatter_workspace_bytes(M, rows,
// width, pair) bytes, g 8 B aligned. Returns 0, a cudaError_t, -1 for a width, C,
// lanes or rows the kernels do not take, or -2 where a warp's batch of one fetch
// (its C values) and the row's inverse of lanes outgrow the card's shared memory.
int nerf_scatter_rows(const void* g, const void* key, const void* lane0, const int* lanes,
                      const void* lanes_dev, int C, long long M, long long rows, int width,
                      void* workspace, void* out, void* stream) {
  if (width < 1 || C < 1 || rows < 1 || lanes_dev == nullptr) return -1;
  for (int c = 0; c < C; ++c)
    if (lanes[c] < 0 || lanes[c] >= width) return -1;
  if (M <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  bool pair = lane0 == nullptr && C == 2 && width == 2;  // the flat table's layout
  for (int c = 0; c < C; ++c)
    if (lanes[c] != c) pair = false;
  // the narrow lane instances where a row and a batch of kScatterBatch
  // fetches fit them within the default 48 KB, else the wide ones
  int batch = kScatterBatch;
  size_t smem = lane_smem_bytes(C, kScatterBatch, kColBlock);
  const bool wide = !pair && (width > kColBlock || smem > 48 * 1024);
  if (wide) {
    int rc = lane_batch(C, width, &batch, &smem);
    if (rc != 0) return rc;
  }
  Workspace w;
  layout(M, rows, width, pair, static_cast<unsigned char*>(workspace), &w);
  ScatterParams p;
  unsigned* keys;  // the last pass writes the rows' runs instead
  void* sorted;
  cudaError_t err = cudaMemsetAsync(w.zeroed, 0, w.zeroed_bytes, st);
  if (err == cudaSuccess)
    err = pair ? radix_sort<float2>(static_cast<const int*>(key), g, M, rows, w, w.ranges, st,
                                    &keys, &sorted)
               : radix_sort<int>(static_cast<const int*>(key), nullptr, M, rows, w, w.ranges, st,
                                 &keys, &sorted);
  p.ids = pair ? nullptr : static_cast<const int*>(sorted);
  p.sorted_g = pair ? static_cast<const float2*>(sorted) : nullptr;
  if (err != cudaSuccess) return static_cast<int>(err);
  p.g = static_cast<const float*>(g);
  p.lane0 = static_cast<const int*>(lane0);
  p.M = M;
  p.rows = static_cast<int>(rows);
  p.width = width;
  p.C = C;
  p.vec4 = C % 4 == 0 && reinterpret_cast<uintptr_t>(g) % 16 == 0;
  p.batch = batch;
  p.lanes = static_cast<const int*>(lanes_dev);
  p.ranges = w.ranges;
  p.counters = w.counters;
  p.slot_row = w.slot_row;
  p.long_rows = w.long_rows;
  p.partial = w.partial;
  p.out = static_cast<float*>(out);
  const long long slots = M / 32 + 2;  // at most: a long run of n fetches takes <= n / 32 slots
  if (pair) {
    scatter_rows_pair_kernel<<<grid_for(rows, kThreads), kThreads, 0, st>>>(p);
    scatter_chunks_pair_kernel<<<grid_for(slots, kThreads), kThreads, 0, st>>>(p);
    scatter_combine_pair_kernel<<<grid_for(M / 64 + 2, kThreads), kThreads, 0, st>>>(p);
  } else if (wide) {
    scatter_rows_lane_kernel<true><<<grid_for(rows, kWarps), kThreads, smem, st>>>(p);
    scatter_chunks_lane_kernel<true><<<grid_for(slots, kWarps), kThreads, smem, st>>>(p);
    scatter_combine_lane_kernel<true><<<grid_for(M / 64 + 2, kWarps), kThreads, 0, st>>>(p);
  } else {
    scatter_rows_lane_kernel<false><<<grid_for(rows, kWarps), kThreads, smem, st>>>(p);
    scatter_chunks_lane_kernel<false><<<grid_for(slots, kWarps), kThreads, smem, st>>>(p);
    scatter_combine_lane_kernel<false><<<grid_for(M / 64 + 2, kWarps), kThreads, 0, st>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* nerf_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
