// Native host-side kernel of the map database (the representative-descriptor
// part of native/map_core.cpp in the JAX package, copied into the port).
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -o libmapcore.so map_core.cpp
#include <algorithm>
#include <cstdint>
#include <vector>

extern "C" {

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
