// Row gather for Hopper (sm_90a), K4: gather_rows and gather_pairs, and the
// fixed-order scatter of their backward, scatter_rows.
//
// Replaces nerf_rs_tpu/kernels/gather_rows.py::gather_rows (:54, the Pallas
// TPU kernel at :88, pallas_call :115) and ::gather_pairs (:133, which
// reaches the same pallas_call):
//   gather_rows   out[i, :] = table[idx[i], :]        (R, W) f32, W % 4 == 0
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
// atomics, as index_add_ uses, sum in a different order on every run). The
// wrapper sorts the fetch keys once with a stable sort (integer work,
// deterministic), finds each distinct row's run of fetches and cuts every run
// into chunks of at most kScatterChunk fetches. Two launches:
//   * scatter_partial_kernel: each chunk's partial row, its fetches summed in
//     order. Flat rows (lane0 null, C == width: the pair layout) take a thread
//     per (chunk, column), a sequential sum; brick rows take a warp per chunk
//     that accumulates the 128-wide row in shared memory: the lanes load 32
//     fetch indices at once, every lane c < C loads its value of each, then
//     the values are added fetch by fetch, lane c into column lane0 +
//     lanes[c] (distinct within a fetch), a __syncwarp between fetches.
//   * scatter_combine_kernel: a thread per (row, column) sums the row's
//     chunk partials in chunk order and writes the row.
// The chunks bound the longest sequential walk (a coarse level's cell holds
// thousands of fetches) while the order stays fixed. Bound: bytes, g read
// once (M C 4 B) plus the keys and lanes, and the gradient table written.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSm = 2048 / kThreads;  // resident blocks at full occupancy
constexpr int kMaxScatterWidth = 128;          // columns of a scattered row (one brick row)
constexpr int kMaxScatterLanes = 32;           // values per fetch (C)

struct ScatterParams {
  const float* g;           // (M, C) cotangents, fetch-major
  const long long* perm;    // (M,) fetch indices in stable key order
  const int* lane0;         // (M,) base column per fetch, or null (0)
  const long long* cstart;  // (n_chunks,) first position in perm of each chunk
  const int* ccount;        // (n_chunks,) fetches of each chunk
  const long long* first;   // (n_uniq,) first chunk of each distinct row
  const int* nchunk;        // (n_uniq,) chunks of each distinct row
  const int* row;           // (n_uniq,) the distinct rows
  long long n_rows, n_uniq, n_chunks;
  int C, width;
  int lanes[kMaxScatterLanes];
  float* partial;           // (n_chunks, width) scratch
  float* out;               // (n_rows, width), zeroed by the wrapper
};

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

// flat rows: a thread per (chunk, column), the chunk's fetches in order
__global__ void __launch_bounds__(kThreads) scatter_partial_flat_kernel(const ScatterParams p) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
       i < p.n_chunks * p.C; i += stride) {
    const long long ch = i / p.C;
    const int c = static_cast<int>(i % p.C);
    const long long s0 = p.cstart[ch];
    const int n = p.ccount[ch];
    float acc = 0.f;
    for (int k = 0; k < n; ++k) acc += __ldg(p.g + __ldg(p.perm + s0 + k) * p.C + c);
    p.partial[ch * p.width + c] = acc;
  }
}

// brick rows: a warp per chunk, the row accumulated in shared memory
__global__ void __launch_bounds__(kThreads) scatter_partial_lane_kernel(const ScatterParams p) {
  __shared__ float acc_all[kWarps][kMaxScatterWidth];
  const int lane = threadIdx.x & 31;
  float* acc = acc_all[threadIdx.x >> 5];
  const unsigned full = 0xffffffffu;
  const long long stride = static_cast<long long>(gridDim.x) * kWarps;
  const int col_off = lane < p.C ? p.lanes[lane] : 0;
  for (long long ch = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
       ch < p.n_chunks; ch += stride) {
    for (int c = lane; c < p.width; c += 32) acc[c] = 0.f;
    __syncwarp();
    const long long s0 = p.cstart[ch];
    const int n = p.ccount[ch];
    for (int b = 0; b < n; b += 32) {
      const int nb = n - b < 32 ? n - b : 32;
      long long pj = 0;
      int l0 = 0;
      if (lane < nb) {
        pj = p.perm[s0 + b + lane];
        l0 = p.lane0 != nullptr ? p.lane0[pj] : 0;
      }
      float v[32];
#pragma unroll
      for (int k = 0; k < 32; ++k) {
        const long long pk = __shfl_sync(full, pj, k);
        v[k] = (k < nb && lane < p.C) ? __ldg(p.g + pk * p.C + lane) : 0.f;
      }
#pragma unroll
      for (int k = 0; k < 32; ++k) {
        if (k < nb) {
          const int col = __shfl_sync(full, l0, k) + col_off;
          if (lane < p.C && col < p.width) acc[col] += v[k];
          __syncwarp();
        }
      }
    }
    float* dst = p.partial + ch * p.width;
    for (int c = lane; c < p.width; c += 32) dst[c] = acc[c];
    __syncwarp();
  }
}

// a thread per (distinct row, column): the row's chunk partials in order
__global__ void __launch_bounds__(kThreads) scatter_combine_kernel(const ScatterParams p) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
       i < p.n_uniq * p.width; i += stride) {
    const long long u = i / p.width;
    const int c = static_cast<int>(i % p.width);
    const long long row = p.row[u];
    if (row < 0 || row >= p.n_rows) continue;
    const float* src = p.partial + p.first[u] * p.width + c;
    float acc = 0.f;
    for (int k = 0; k < p.nchunk[u]; ++k) acc += src[static_cast<long long>(k) * p.width];
    p.out[row * p.width + c] = acc;
  }
}

// Blocks for `work` items at `per_block` items a block, capped at one full
// wave of resident blocks (the grid-stride loops take the rest).
unsigned grid_for(long long work, int per_block) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long want = (work + per_block - 1) / per_block;
  const long long cap = static_cast<long long>(sms) * kBlocksPerSm;
  return static_cast<unsigned>(want < cap ? want : cap);
}

}  // namespace

extern "C" {

// table (rows, width) f32 with width % 4 == 0 and a 16 B aligned base; idx
// (n,) int32; out (n, width) f32. Returns 0 or a cudaError_t.
int nerf_gather_rows(const void* table, const void* idx, void* out, long long n,
                     long long rows, int width, void* stream) {
  if (n <= 0) return 0;
  gather_rows_kernel<<<grid_for(n, kWarps), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(table), static_cast<const int*>(idx),
      static_cast<float4*>(out), n, rows, width / 4);
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

// out (n_rows, width) f32, zeroed; partial (n_chunks, width) f32 scratch; g
// (M, C) f32; perm (M,) int64; lane0 (M,) int32 or null; cstart (n_chunks,)
// int64, ccount (n_chunks,) int32; first (n_uniq,) int64, nchunk (n_uniq,) int32,
// row (n_uniq,) int32; lanes (C,) int32. Returns 0, a cudaError_t, or -1 for a
// width or C the kernels do not take.
int nerf_scatter_rows(const void* g, const void* perm, const void* lane0, const void* cstart,
                      const void* ccount, long long n_chunks, const void* first,
                      const void* nchunk, const void* row, long long n_uniq, const int* lanes,
                      int C, void* partial, void* out, long long n_rows, int width,
                      void* stream) {
  if (width < 1 || width > kMaxScatterWidth || C < 1 || C > kMaxScatterLanes) return -1;
  if (n_uniq <= 0) return 0;
  ScatterParams p;
  p.g = static_cast<const float*>(g);
  p.perm = static_cast<const long long*>(perm);
  p.lane0 = static_cast<const int*>(lane0);
  p.cstart = static_cast<const long long*>(cstart);
  p.ccount = static_cast<const int*>(ccount);
  p.first = static_cast<const long long*>(first);
  p.nchunk = static_cast<const int*>(nchunk);
  p.row = static_cast<const int*>(row);
  p.n_rows = n_rows;
  p.n_uniq = n_uniq;
  p.n_chunks = n_chunks;
  p.C = C;
  p.width = width;
  bool dense = lane0 == nullptr && C == width;  // the flat layout: column c is lane c
  for (int c = 0; c < kMaxScatterLanes; ++c) {
    p.lanes[c] = c < C ? lanes[c] : 0;
    if (c < C && lanes[c] != c) dense = false;
  }
  p.partial = static_cast<float*>(partial);
  p.out = static_cast<float*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dense)
    scatter_partial_flat_kernel<<<grid_for(n_chunks * C, kThreads), kThreads, 0, st>>>(p);
  else
    scatter_partial_lane_kernel<<<grid_for(n_chunks, kWarps), kThreads, 0, st>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  scatter_combine_kernel<<<grid_for(n_uniq * width, kThreads), kThreads, 0, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

const char* nerf_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
