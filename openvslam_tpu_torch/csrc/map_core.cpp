// Native host-side kernels of the map and BoW databases (the representative-
// descriptor and shared-word parts of native/map_core.cpp in the JAX
// package, copied into the port).
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -o libmapcore.so map_core.cpp
#include <algorithm>
#include <cstdint>
#include <unordered_map>
#include <vector>

extern "C" {

// Shared-word counting for BoW queries: for each unique word of the query,
// accumulate +1 for every keyframe in that word's inverted list.
//  inv_offsets: (n_words+1) CSR offsets into inv_kfs
//  query_words: (n_query) word ids (may repeat; deduplicated internally)
// Entries come out in the hash map's iteration order, as in the JAX
// package's build of the same code.
int32_t bow_shared_words(const int32_t* query_words, int64_t n_query,
                         const int64_t* inv_offsets, const int64_t* inv_kfs,
                         int64_t n_words,
                         int64_t* out_kf, int32_t* out_count, int64_t max_out) {
  std::vector<uint8_t> seen(n_words, 0);
  std::unordered_map<int64_t, int32_t> counts;
  counts.reserve(512);
  for (int64_t i = 0; i < n_query; ++i) {
    int32_t w = query_words[i];
    if (w < 0 || w >= n_words || seen[w]) continue;
    seen[w] = 1;
    for (int64_t j = inv_offsets[w]; j < inv_offsets[w + 1]; ++j)
      ++counts[inv_kfs[j]];
  }
  int64_t n = 0;
  for (auto& kv : counts) {
    if (n >= max_out) break;
    out_kf[n] = kv.first;
    out_count[n] = kv.second;
    ++n;
  }
  return static_cast<int32_t>(n);
}

// Representative-descriptor selection: index of the descriptor with minimum
// median Hamming distance to the others.  descs: (n, 8) packed u32.
int32_t min_median_hamming(const uint32_t* descs, int64_t n) {
  if (n <= 1) return 0;
  std::vector<std::vector<int32_t>> d(n, std::vector<int32_t>(n, 0));
  for (int64_t i = 0; i < n; ++i)
    for (int64_t j = i + 1; j < n; ++j) {
      int32_t h = 0;
      for (int k = 0; k < 8; ++k)
        h += __builtin_popcount(descs[i * 8 + k] ^ descs[j * 8 + k]);
      d[i][j] = h;
      d[j][i] = h;
    }
  int32_t best = 0, best_med = 1 << 30;
  for (int64_t i = 0; i < n; ++i) {
    std::vector<int32_t> row = d[i];
    std::nth_element(row.begin(), row.begin() + n / 2, row.end());
    int32_t med = row[n / 2];
    if (med < best_med) { best_med = med; best = static_cast<int32_t>(i); }
  }
  return best;
}

}  // extern "C"
