// Row gather for Hopper (sm_90a), K4: gather_rows and gather_pairs.
//
// Replaces nerf_rs_tpu/kernels/gather_rows.py::gather_rows (:54, the Pallas
// TPU kernel at :88, pallas_call :115) and ::gather_pairs (:133, which
// reaches the same pallas_call):
//   gather_rows   out[i, :] = table[idx[i], :]        (R, W) f32, W % 4 == 0
//   gather_pairs  out[i, :] = table[fidx[i] + {0, 1}]  (M,) f32, fidx even
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
//   * gather_pairs: one thread per pair, one aligned 8 B float2 load (the
//     index is even and the table 8 B aligned), so a pair costs one sector.
// The table is read through the read-only path (__ldg). An index outside the
// table is never read: its row or pair is written as NaN, as the wrapper's
// plain version writes it.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSm = 2048 / kThreads;  // resident blocks at full occupancy

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

__global__ void __launch_bounds__(kThreads)
gather_pairs_kernel(const float* __restrict__ table, long long m, const int* __restrict__ fidx,
                    float2* __restrict__ out, long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; i < n;
       i += stride) {
    const long long f = __ldg(fidx + i);
    out[i] = (f < 0 || f + 1 >= m || (f & 1))
                 ? make_float2(NAN, NAN)
                 : __ldg(reinterpret_cast<const float2*>(table + f));
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

// table (m,) f32 with an 8 B aligned base; fidx (n,) int32, even; out (n, 2)
// f32. Returns 0 or a cudaError_t.
int nerf_gather_pairs(const void* table, long long m, const void* fidx, void* out, long long n,
                      void* stream) {
  if (n <= 0) return 0;
  gather_pairs_kernel<<<grid_for(n, kThreads), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(table), m, static_cast<const int*>(fidx),
      static_cast<float2*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

const char* nerf_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
