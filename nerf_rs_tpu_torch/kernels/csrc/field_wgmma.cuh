// Hopper primitives of the render kernel K1 (fused_ray.cu), of both
// kernels' wide route (field_cluster.cuh), of K2a's narrow instance and of
// K2b (fused_train.cu): warpgroup matrix products (wgmma), mbarriers, bulk
// and tensor (TMA) copies into shared memory (with cluster multicast),
// named barriers, and reads of another cluster CTA's shared memory.
//
// Operand layout. Every wgmma operand but K2b's is K-major in shared memory without a
// swizzle ("interleave"): 8 x 8 bf16 core matrices of 128 contiguous bytes,
// a row's 8 k-values in 16 bytes. A tile of `rows` rows (128 for the
// activations, N for a weight slice) keeps core matrix (row group rg, k
// group kg) at kg * (rows * 16) + rg * 128 bytes, so the descriptor's
// leading byte offset (the next k group) is rows * 16 and its stride byte
// offset (the next 8 rows) is 128. A k16 step moves the start by two k
// groups. kernels/fused_render.pack_weights_k1 writes each transposed
// weight matrix in this order with kg outermost, so a k-slice of any
// length is one contiguous run of bytes that a bulk copy lands as it is.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace nerf {
namespace wg {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of element (r, k) in a 128-row K-major core-matrix tile.
__device__ __forceinline__ uint32_t tile_off(int r, int k) {
  return ((k >> 3) << 11) + ((r >> 3) << 7) + ((r & 7) << 4) + ((k & 7) << 1);
}

// Matrix descriptor: no swizzle, start address, leading (k) and stride
// (row group) byte offsets, each in 16-byte units.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32);
}

__device__ __forceinline__ void fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// generic-proxy stores to shared memory made visible to wgmma's reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;\n" ::
                   : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Spins until the phase of parity `parity` has completed. The loop is in
// the PTX: a C++ loop on the result is a divergent path to ptxas, which then
// serializes every wgmma of the function.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Arrives, when `pred` is 1, on the barrier at the same offset in cluster
// CTA `cta` (the executing CTA included). Predicated in the PTX, for the
// reason mbar_wait loops there.
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar, uint32_t cta, uint32_t pred) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b32 remote;\nsetp.eq.u32 p, %2, 1;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "@p mbarrier.arrive.shared::cluster.b64 _, [remote];\n}\n" ::"r"(bar),
      "r"(cta), "r"(pred)
      : "memory");
}

// ---- cluster-shared operands (the wide route, field_cluster.cuh) ----

// The shared::cluster address of the byte at local offset `addr` in
// cluster CTA `cta`'s shared memory.
__device__ __forceinline__ uint32_t mapa(uint32_t addr, uint32_t cta) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(cta));
  return r;
}

// 16 bytes from another CTA's shared memory (a mapa address).
__device__ __forceinline__ uint4 ld_cluster16(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared::cluster.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_shared16(uint32_t addr, uint4 v) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(v.x), "r"(v.y),
               "r"(v.z), "r"(v.w)
               : "memory");
}

// One arrival on the local barrier at `bar` (release, CTA scope).
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// mbar_arrive when `pred` is 1, predicated in the PTX (see mbar_arrive_cluster).
__device__ __forceinline__ void mbar_arrive_pred(uint32_t bar, uint32_t pred) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.eq.u32 p, %1, 1;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(bar),
      "r"(pred)
      : "memory");
}

// One arrival on the barrier at offset `bar` in cluster CTA `cta`, with
// release at cluster scope: what this thread wrote or read before it (and
// what threads it synchronised with did) is ordered before the arrival, for
// a thread of any CTA of the cluster that waits with mbar_wait_cluster.
__device__ __forceinline__ void mbar_arrive_release(uint32_t bar, uint32_t cta) {
  asm volatile(
      "{\n.reg .b32 remote;\nmapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [remote];\n}\n" ::"r"(bar),
      "r"(cta)
      : "memory");
}

// mbar_wait with acquire at cluster scope, the counterpart of
// mbar_arrive_release, for the waits between the CTAs of a cluster: bounded,
// a wait that has not completed after NERF_STALL_NS (20 s) of the card's
// clock traps, so a protocol fault ends the launch with an error instead of
// holding the card (every stall of the cluster route holds one of these).
// The loop is in the PTX, as mbar_wait's.
#define NERF_STALL_NS "20000000000"
__device__ __forceinline__ void mbar_wait_cluster(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .u64 t0, t1;\nmov.u64 t0, %%globaltimer;\nWAITC:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONEC;\nmov.u64 t1, %%globaltimer;\nsub.u64 t1, t1, t0;\n"
      "setp.lt.u64 p, t1, " NERF_STALL_NS ";\n@p bra WAITC;\ntrap;\nDONEC:\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// cluster_sync for threads of diverged roles (no .aligned): each thread of
// the cluster that has not exited arrives, then waits for all others.
__device__ __forceinline__ void cluster_sync_any() {
  asm volatile("barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;\n" ::: "memory");
}

// `bytes` from global memory to shared memory, landing at offset dst and
// completing on the barrier at offset bar in every CTA of `mask` in the
// cluster.
__device__ __forceinline__ void bulk_copy_multicast(uint32_t dst, const void* src, uint32_t bytes,
                                                    uint32_t bar, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster "
      "[%0], [%1], %2, [%3], %4;\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar), "h"(mask)
      : "memory");
}

// ---- m64nNk16 bf16 x bf16 -> f32 products, A and B from shared memory ----
// The accumulator fragment: thread t of the warpgroup (warp w = t / 32,
// lane l) holds, for each n8 tile j, d[4j], d[4j+1] at row 16 w + l / 4,
// columns 8 j + 2 (l % 4) + {0, 1}, and d[4j+2], d[4j+3] at the row 8 below.
// acc = 0 overwrites d (the first k-step of a product).

// D[64 x 256] (+)= A[64 x 16] B[16 x 256], both K-major in shared memory, or
// both MN-major (transposed) where Tnsp = 1 (K2b's operands)
template <int Tnsp = 0>
__device__ __forceinline__ void wgmma_n256(float* d, uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, %131, %131;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(acc), "n"(Tnsp));
}

// D[64 x 128] (+)= A[64 x 16] B[16 x 128], both K-major in shared memory
__device__ __forceinline__ void wgmma_n128(float* d, uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(acc));
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64], both K-major in shared memory
__device__ __forceinline__ void wgmma_n64(float* d, uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

// D[64 x 32] (+)= A[64 x 16] B[16 x 32], both K-major in shared memory
__device__ __forceinline__ void wgmma_n32(float* d, uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(acc));
}

// D[64 x 16] (+)= A[64 x 16] B[16 x 16], both K-major in shared memory
__device__ __forceinline__ void wgmma_n16(float* d, uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(acc));
}

// D[64 x 8] (+)= A[64 x 16] B[16 x 8], both K-major in shared memory (or
// both MN-major where Tnsp = 1)
template <int Tnsp = 0>
__device__ __forceinline__ void wgmma_n8(float* d, uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3"
      "}, %4, %5, p, 1, 1, %7, %7;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(acc), "n"(Tnsp));
}

// ---- K2b's operands: MN-major, 128-byte swizzled (fused_train.cu) ----
// A TMA box of 64 columns x r rows of a row-major bf16 matrix, loaded with
// the 128-byte swizzle, lies as r rows of 128 bytes, row i's 16-byte chunk j
// at chunk j ^ (i % 8), in 1024-byte atoms of 8 rows. Read as a wgmma
// operand whose M (or N) runs along the columns and K along the rows, it is
// the MN-major canonical layout ((8, 8, m), (8, k)) of 16-byte units with
// strides ((1, 8, lbo), (8, sbo)): a 64-column panel is one swizzle atom
// wide, the next 64 columns lie `lbo` bytes on (the next panel) and the next
// 8 rows sbo = 1024 bytes on; a k16 step moves the start 16 rows (2 KB).
// Layout type 1 (128-byte swizzle) in bits 62-63.
__device__ __forceinline__ uint64_t desc_mn_sw128(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// A {64, 64, 1} box of a 3-D tensor map at (c0, c1, c2) into shared memory
// at dst, completing on the barrier at bar: into this CTA only, or
// (multicast) into every CTA of `mask` in the cluster at the same offsets.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const void* map, int c0, int c1, int c2,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(map), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void tma_load_3d_multicast(uint32_t dst, const void* map, int c0, int c1,
                                                      int c2, uint32_t bar, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%2, %3, %4}], [%5], %6;\n" ::"r"(dst),
      "l"(map), "r"(c0), "r"(c1), "r"(c2), "r"(bar), "h"(mask)
      : "memory");
}

// Pins n accumulator registers where they are: without it the compiler
// may copy accumulators between wgmma stages, and ptxas then serializes
// every wgmma of the function.
template <int n>
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < n; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D[64 x N] (+)= A B for a compile-time N: one instruction.
template <int N>
__device__ __forceinline__ void mma(float* d, uint64_t da, uint64_t db, int acc) {
  if constexpr (N == 256)
    wgmma_n256(d, da, db, acc);
  else if constexpr (N == 128)
    wgmma_n128(d, da, db, acc);
  else if constexpr (N == 64)
    wgmma_n64(d, da, db, acc);
  else if constexpr (N == 32)
    wgmma_n32(d, da, db, acc);
  else if constexpr (N == 16)
    wgmma_n16(d, da, db, acc);
  else
    wgmma_n8(d, da, db, acc);
}

}  // namespace wg
}  // namespace nerf
