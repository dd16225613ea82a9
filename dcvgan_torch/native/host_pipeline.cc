// Native host-pipeline kernels for the data loader: the port's own copy of
// the JAX package's library, with the same functions and arithmetic.
//
// Frame decode stays in OpenCV; this library takes over the batch-assembly
// inner loops that numpy runs on one thread per sample:
//
//   - uint8 -> float32 affine normalize (x / divisor + shift), threaded
//   - one-hot expansion for segmentation labels, threaded
//   - float32 scaling (optical flow / image size), threaded
//
// Built with plain g++ (no external deps) into dcvgan_torch/_build/ and bound
// through ctypes (see native/__init__.py). There is no fallback: a build that
// fails raises. Unlike the JAX package's copy, the calling thread works one
// chunk itself, so one thread starts none: a thread's start costs more than
// a per-sample loop (the caller picks the count by size).

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <thread>
#include <vector>

namespace {

// body(lo, hi) over [0, n) in n_threads contiguous chunks; the calling
// thread takes the first chunk and n_threads - 1 threads the rest.
template <typename Body>
void parallel_for(int64_t n, int n_threads, Body body) {
  if (n_threads < 1) n_threads = 1;
  const int64_t chunk = (n + n_threads - 1) / n_threads;
  std::vector<std::thread> workers;
  for (int t = 1; t < n_threads; ++t) {
    const int64_t lo = t * chunk;
    const int64_t hi = std::min(n, lo + chunk);
    if (lo >= hi) break;
    workers.emplace_back(body, lo, hi);
  }
  body(int64_t{0}, std::min(n, chunk));
  for (auto& w : workers) w.join();
}

}  // namespace

extern "C" {

// dst[i] = src[i] / divisor + shift: a division (not a reciprocal multiply)
// so results are bit-identical to numpy's `astype(float32) / d + s`.
void normalize_u8_to_f32(const uint8_t* src, float* dst, int64_t n,
                         float divisor, float shift, int n_threads) {
  parallel_for(n, n_threads, [=](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      dst[i] = static_cast<float>(src[i]) / divisor + shift;
    }
  });
}

// dst[i * n_classes + labels[i]] = 1.0f; dst zero-initialised by the caller;
// a label >= n_classes leaves its row zero.
void one_hot_f32(const uint8_t* labels, float* dst, int64_t n,
                 int n_classes, int n_threads) {
  parallel_for(n, n_threads, [=](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      const int c = labels[i];
      if (c < n_classes) dst[i * n_classes + c] = 1.0f;
    }
  });
}

// dst[i] = src[i] * scale (optical flow / image size)
void scale_f32(const float* src, float* dst, int64_t n, float scale,
               int n_threads) {
  parallel_for(n, n_threads, [=](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) dst[i] = src[i] * scale;
  });
}

}  // extern "C"
