// Host batch assembler of the port's async pixel pipeline (data/pipeline.py
// with --use_native_loader, bound by data/native_loader.py through ctypes),
// the port's own copy of the JAX package's nerf_rs_tpu/native/batch_loader.cc:
// a multithreaded gather of gold pixels (uint8 -> f32 / 255, optionally
// composited onto white through the alpha channel), and a whole-batch
// assembler that draws (view, x, y) from its own counter-based generator, so
// batches are reproducible from a seed and a step.
//
// Built at first use with g++ -O3 into nerf_rs_tpu_torch/kernels/_build/
// (data/native_loader.build). The port binds the gather; the whole-batch
// assembler stays as the JAX package's copy has it. Host code only: the rays
// are made on the card from the indices.

#include <cstdint>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>

namespace {

// splitmix64: tiny, high-quality counter-based generator.
static inline uint64_t splitmix64(uint64_t x) {
  x += 0x9E3779B97F4A7C15ull;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ull;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBull;
  return x ^ (x >> 31);
}

static inline uint32_t bounded(uint64_t bits, uint32_t n) {
  // multiply-shift bounded draw (Lemire)
  return static_cast<uint32_t>((static_cast<__uint128_t>(bits) * n) >> 64);
}

void parallel_for(int64_t n, const std::function<void(int64_t, int64_t)>& fn) {
  unsigned hw = std::thread::hardware_concurrency();
  int64_t nthreads = hw ? static_cast<int64_t>(hw) : 4;
  if (nthreads > n) nthreads = n > 0 ? n : 1;
  std::vector<std::thread> threads;
  int64_t chunk = (n + nthreads - 1) / nthreads;
  for (int64_t t = 0; t < nthreads; ++t) {
    int64_t lo = t * chunk;
    int64_t hi = lo + chunk < n ? lo + chunk : n;
    if (lo >= hi) break;
    threads.emplace_back(fn, lo, hi);
  }
  for (auto& th : threads) th.join();
}

}  // namespace

extern "C" {

// Gather gold pixels: images (n_views, h, w, 4) uint8 (C-contiguous),
// indices (n,), output rgb f32 (n, 3) normalized /255, optionally
// composited onto white via the alpha channel.
void nerf_gather_gold(const uint8_t* images, int32_t n_views, int32_t h,
                      int32_t w, const int32_t* view_idx, const int32_t* xi,
                      const int32_t* yi, int64_t n, int32_t white_bg,
                      float* out_rgb) {
  const int64_t view_stride = static_cast<int64_t>(h) * w * 4;
  parallel_for(n, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      const uint8_t* px = images + view_idx[i] * view_stride +
                          (static_cast<int64_t>(yi[i]) * w + xi[i]) * 4;
      float r = px[0] * (1.0f / 255.0f);
      float g = px[1] * (1.0f / 255.0f);
      float b = px[2] * (1.0f / 255.0f);
      if (white_bg) {
        float a = px[3] * (1.0f / 255.0f);
        r = r * a + (1.0f - a);
        g = g * a + (1.0f - a);
        b = b * a + (1.0f - a);
      }
      out_rgb[i * 3 + 0] = r;
      out_rgb[i * 3 + 1] = g;
      out_rgb[i * 3 + 2] = b;
    }
  });
}

// Full batch assembly: draw (view, x, y) uniformly from a seed+counter
// stream, then gather. Deterministic in (seed, step).
void nerf_assemble_batch(const uint8_t* images, int32_t n_views, int32_t h,
                         int32_t w, uint64_t seed, uint64_t step, int64_t n,
                         int32_t white_bg, int32_t* out_view, int32_t* out_xi,
                         int32_t* out_yi, float* out_rgb) {
  const uint64_t base = splitmix64(seed ^ (step * 0xD1B54A32D192ED03ull));
  parallel_for(n, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      uint64_t r0 = splitmix64(base + 3 * i);
      uint64_t r1 = splitmix64(base + 3 * i + 1);
      uint64_t r2 = splitmix64(base + 3 * i + 2);
      out_view[i] = static_cast<int32_t>(bounded(r0, n_views));
      out_xi[i] = static_cast<int32_t>(bounded(r1, w));
      out_yi[i] = static_cast<int32_t>(bounded(r2, h));
    }
  });
  nerf_gather_gold(images, n_views, h, w, out_view, out_xi, out_yi, n,
                   white_bg, out_rgb);
}

}  // extern "C"
