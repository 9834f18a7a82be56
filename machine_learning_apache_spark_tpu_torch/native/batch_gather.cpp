// Threaded batch row-gather — the host-side loader hot path in C++.
//
// The reference's data loading rides torch DataLoader + ATen (C++ under the
// Python, SURVEY.md §2.2); this is the framework's native equivalent for the
// one operation that dominates host-side batch assembly: gathering N rows
// scattered through a big array into one contiguous buffer the device feed
// can DMA. Multi-threaded memcpy saturates host memory bandwidth on the
// large image/token arrays; Python/numpy fancy indexing is single-threaded.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// dst[i] = src[indices[i]] for row_bytes-sized rows.
void mlspark_gather_rows(const char* src, int64_t row_bytes,
                         const int64_t* indices, int64_t n_indices,
                         char* dst, int32_t n_threads) {
  if (n_indices <= 0) return;
  if (n_threads < 1) n_threads = 1;
  // Thread spawn costs ~10µs; below ~4MB total the copy is cheaper alone.
  const int64_t total = n_indices * row_bytes;
  if (n_threads > 1 && total < (4 << 20)) n_threads = 1;
  n_threads = static_cast<int32_t>(
      std::min<int64_t>(n_threads, n_indices));

  auto worker = [&](int64_t begin, int64_t end_) {
    for (int64_t i = begin; i < end_; ++i) {
      std::memcpy(dst + i * row_bytes, src + indices[i] * row_bytes,
                  static_cast<size_t>(row_bytes));
    }
  };

  if (n_threads == 1) {
    worker(0, n_indices);
    return;
  }
  std::vector<std::thread> threads;
  const int64_t chunk = (n_indices + n_threads - 1) / n_threads;
  for (int32_t t = 0; t < n_threads; ++t) {
    const int64_t begin = t * chunk;
    const int64_t end_ = std::min<int64_t>(begin + chunk, n_indices);
    if (begin >= end_) break;
    threads.emplace_back(worker, begin, end_);
  }
  for (auto& th : threads) th.join();
}

}  // extern "C"
