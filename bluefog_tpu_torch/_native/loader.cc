// Native batch-gather engine for the input pipeline.
//
// The reference feeds ranks through torch DataLoader worker *processes*
// (e.g. examples/pytorch_mnist.py) whose job is assembling index-selected
// batches off the training thread.  Here one host process feeds every rank,
// so the equivalent hot loop is "gather N rows of a big array into a staging
// buffer" once per step per source array — a pure memcpy workload that numpy
// fancy-indexing runs single-threaded under the GIL.  This implementation
// fans the row copies across a small thread pool; ctypes releases the GIL
// for the call, so the gather also overlaps Python-side work.
//
// Contract (mirrors a[idx] for row indices):
//   dst[i * row_bytes .. ] = src[idx[i] * row_bytes .. ]   for i < n_rows
//
// bft_gather_rows returns 0 on success, -1 on bad arguments.  Thread count
// is clamped to [1, 16] and to n_rows; tiny gathers run inline.

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

int bft_gather_rows(char* dst, const char* src, int64_t row_bytes,
                    const int64_t* idx, int64_t n_rows, int64_t src_rows,
                    int32_t threads) {
  if (!dst || !src || !idx || row_bytes <= 0 || n_rows < 0) return -1;
  for (int64_t i = 0; i < n_rows; ++i) {
    if (idx[i] < 0 || idx[i] >= src_rows) return -1;
  }
  // below ~4 MB the spawn cost beats the copy; run inline
  const int64_t total = n_rows * row_bytes;
  int32_t t = threads;
  if (t < 1) t = 1;
  if (t > 16) t = 16;
  if (t > n_rows) t = static_cast<int32_t>(n_rows > 0 ? n_rows : 1);
  if (t == 1 || total < (4 << 20)) {
    for (int64_t i = 0; i < n_rows; ++i) {
      std::memcpy(dst + i * row_bytes, src + idx[i] * row_bytes, row_bytes);
    }
    return 0;
  }
  std::vector<std::thread> pool;
  pool.reserve(t);
  const int64_t chunk = (n_rows + t - 1) / t;
  for (int32_t w = 0; w < t; ++w) {
    const int64_t lo = w * chunk;
    const int64_t hi = lo + chunk < n_rows ? lo + chunk : n_rows;
    if (lo >= hi) break;
    pool.emplace_back([=]() {
      for (int64_t i = lo; i < hi; ++i) {
        std::memcpy(dst + i * row_bytes, src + idx[i] * row_bytes, row_bytes);
      }
    });
  }
  for (auto& th : pool) th.join();
  return 0;
}

}  // extern "C"
