// Host kernel H1: a batch of patches cropped from one (C, Z, Y, X) volume and
// collated into (N, C, pz, py, px), with an optional per-channel
// normalization, in one pass over rows on a pool of threads (port of the
// JAX package's viscy_tpu/native/crop_norm.cpp).
//
// crop_norm_f32 writes (x - mean) * (1.0f / std) where a channel's std is
// above 0 and copies the channel as it is where it is not (or where no
// statistics are given); crop_u16 copies uint16 rows unchanged. A row is px
// contiguous elements; threads take chunks of 64 rows from a shared
// counter, so the result does not depend on the number of threads.
//
// Built by viscy_tpu_torch/ops/_build.py with the host compiler and bound
// through ctypes in viscy_tpu_torch/native/__init__.py.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <thread>
#include <vector>

namespace {

constexpr int64_t kChunkRows = 64;

// Runs row_fn(row, src_offset) for every output row, on n_threads threads
// (0: one a hardware thread).
template <typename RowFn>
void for_each_row(int64_t C, int64_t Z, int64_t Y, int64_t X, const int64_t* origins, int64_t n, int64_t pz,
                  int64_t py, int64_t n_threads, RowFn row_fn) {
  const int64_t rows_per_patch = C * pz * py;
  const int64_t total_rows = n * rows_per_patch;
  if (n_threads <= 0) {
    n_threads = static_cast<int64_t>(std::thread::hardware_concurrency());
    if (n_threads <= 0) n_threads = 1;
  }
  const int64_t n_chunks = (total_rows + kChunkRows - 1) / kChunkRows;
  n_threads = std::max<int64_t>(1, std::min(n_threads, n_chunks));
  std::atomic<int64_t> next_chunk{0};

  auto worker = [&]() {
    for (;;) {
      const int64_t chunk = next_chunk.fetch_add(1);
      if (chunk >= n_chunks) return;
      const int64_t row1 = std::min(chunk * kChunkRows + kChunkRows, total_rows);
      for (int64_t row = chunk * kChunkRows; row < row1; ++row) {
        const int64_t patch = row / rows_per_patch;
        int64_t r = row % rows_per_patch;
        const int64_t c = r / (pz * py);
        r %= pz * py;
        const int64_t z = origins[patch * 3 + 0] + r / py;
        const int64_t y = origins[patch * 3 + 1] + r % py;
        row_fn(row, c, ((c * Z + z) * Y + y) * X + origins[patch * 3 + 2]);
      }
    }
  };

  if (n_threads == 1) {
    worker();
    return;
  }
  std::vector<std::thread> threads;
  threads.reserve(static_cast<size_t>(n_threads));
  for (int64_t t = 0; t < n_threads; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
}

}  // namespace

extern "C" {

// src: (C, Z, Y, X) float32, contiguous; origins: (n, 3) int64 (z0, y0, x0);
// means / stds: (C) float32 or null; out: (n, C, pz, py, px) float32.
void crop_norm_f32(const float* src, int64_t C, int64_t Z, int64_t Y, int64_t X, const int64_t* origins, int64_t n,
                   int64_t pz, int64_t py, int64_t px, const float* means, const float* stds, float* out,
                   int64_t n_threads) {
  for_each_row(C, Z, Y, X, origins, n, pz, py, n_threads, [&](int64_t row, int64_t c, int64_t offset) {
    const float* s = src + offset;
    float* d = out + row * px;
    const float mean = means ? means[c] : 0.0f;
    const float std_ = stds ? stds[c] : 0.0f;
    if (std_ > 0.0f) {
      const float inv = 1.0f / std_;
      for (int64_t i = 0; i < px; ++i) d[i] = (s[i] - mean) * inv;
    } else {
      std::copy(s, s + px, d);
    }
  });
}

// The same crop of a uint16 volume, without normalization (the device
// normalizes; uint16 moves half the bytes of float32).
void crop_u16(const uint16_t* src, int64_t C, int64_t Z, int64_t Y, int64_t X, const int64_t* origins, int64_t n,
              int64_t pz, int64_t py, int64_t px, uint16_t* out, int64_t n_threads) {
  for_each_row(C, Z, Y, X, origins, n, pz, py, n_threads, [&](int64_t row, int64_t, int64_t offset) {
    std::copy(src + offset, src + offset + px, out + row * px);
  });
}

}  // extern "C"
