// The port's host batcher: multithreaded batch gather + seeded shuffle, the
// port's own copy of igm_tpu's native/batcher.cpp (the same functions, the
// same splitmix64 Fisher-Yates).
//
// Gathering an epoch's batch rows into one contiguous buffer (the pinned
// host copy the prefetcher sends to the card) is driven through ctypes by
// igm_tpu_torch/data/native.py, which builds this file at first use:
//   g++ -O3 -std=c++17 -shared -fPIC -pthread -o <lib>.so batcher.cpp
// numpy's fancy indexing is single-threaded; this gathers straight into the
// destination with N threads.

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// Gather rows: dst[i] = src[indices[i]] for i in [0, n_rows), each row
// `row_bytes` long.  Threads split the row range evenly.
void igm_gather_rows(const uint8_t* src, const int64_t* indices, uint8_t* dst,
                     int64_t n_rows, int64_t row_bytes, int32_t n_threads) {
  if (n_threads < 1) n_threads = 1;
  auto worker = [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      std::memcpy(dst + i * row_bytes, src + indices[i] * row_bytes,
                  static_cast<size_t>(row_bytes));
    }
  };
  if (n_threads == 1 || n_rows < 2 * n_threads) {
    worker(0, n_rows);
    return;
  }
  std::vector<std::thread> threads;
  int64_t chunk = (n_rows + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    int64_t lo = t * chunk;
    int64_t hi = lo + chunk < n_rows ? lo + chunk : n_rows;
    if (lo >= hi) break;
    threads.emplace_back(worker, lo, hi);
  }
  for (auto& th : threads) th.join();
}

static inline uint64_t splitmix64(uint64_t& s) {
  uint64_t z = (s += 0x9E3779B97f4A7C15ULL);
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
  return z ^ (z >> 31);
}

// Fisher-Yates permutation of [0, n) into out, seeded deterministically.
void igm_shuffle_perm(int64_t* out, int64_t n, uint64_t seed) {
  for (int64_t i = 0; i < n; ++i) out[i] = i;
  uint64_t s = seed;
  for (int64_t i = n - 1; i > 0; --i) {
    int64_t j = static_cast<int64_t>(splitmix64(s) % static_cast<uint64_t>(i + 1));
    int64_t tmp = out[i];
    out[i] = out[j];
    out[j] = tmp;
  }
}

}  // extern "C"
