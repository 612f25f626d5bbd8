// K2: projection- and octave-gated Hamming matching of L landmarks against
// K keypoints, with the Lowe ratio test and the cross-check.
//
// Replaces the TPU kernel openvslam_tpu/ops/pallas/match_kernel.py
// (projection_match_pallas, body _match_kernel).
//
// What bounds it on this card: operations.  The inputs are small (32-byte
// packed descriptors, about 0.3 MB at L = 4096, K = 1032), but the full
// product is L*K 256-bit distances.  The TPU kernel ran that product on the
// MXU as an int8 matmul; here each distance is 8 XORs and 8 __popc, and the
// projection-radius gate is tested first, so only gate-passing pairs
// (a few per landmark) pay for the popcounts.
//
// Design:
// * Row pass.  A block takes 32 landmark rows and stages 256 keypoints at a
//   time in shared memory; its 256 threads are 32 rows x 8 keypoint slices.
//   Each thread keeps, for its row and slice, the best as a packed
//   (d * col_mul + k) minimum (lowest index on ties) and the second-best
//   distance; the 8 slices are merged through shared memory.
// * Column minimum for the cross-check.  The TPU kernel carried it through
//   its sequential grid; blocks here run in no order, so every gate-passing
//   pair does atomicMin(col_min[k], d * row_mul + row) into a (K,) buffer
//   that the wrapper fills with INT_MAX (lowest row on ties).
// * Epilogue kernel: max_dist, the ratio test and the cross-check, exactly
//   as match_kernel.py:177-187.
// Gated pairs count as distance 1023 (the TPU kernel's _LARGE_D), which the
// epilogue maps back to ops/match.py LARGE, so idx and dist equal the plain
// version's (ops/match.py projection_scale_match_plain), ties included.
// The radius test uses round-to-nearest intrinsics so that no fused
// multiply-add changes d^2 < r^2 against the plain version.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 32;
constexpr int SLICES = 8;
constexpr int THREADS = ROWS * SLICES;
constexpr int KTILE = 256;
constexpr int LARGE_D = 1023;
constexpr int LARGE = 1 << 20;  // ops/match.py LARGE

__global__ void __launch_bounds__(THREADS)
match_rows_kernel(const uint32_t* __restrict__ a_desc, const uint32_t* __restrict__ b_desc,
                  const float2* __restrict__ a_uv, const unsigned char* __restrict__ a_vis,
                  const float* __restrict__ a_r2, const int* __restrict__ a_pred,
                  const float2* __restrict__ b_xy, const int* __restrict__ b_level,
                  const unsigned char* __restrict__ b_valid, int L, int K, int col_mul,
                  int row_mul, int* __restrict__ row_best, int* __restrict__ row_second,
                  int* __restrict__ col_min) {
  __shared__ uint32_t s_desc[KTILE][9];  // padded row: no bank conflicts
  __shared__ float2 s_xy[KTILE];
  __shared__ int s_lvl[KTILE];
  __shared__ unsigned char s_val[KTILE];
  __shared__ int s_best[SLICES][ROWS];
  __shared__ int s_second[SLICES][ROWS];

  const int r_local = threadIdx.x % ROWS;
  const int slice = threadIdx.x / ROWS;
  const int row = blockIdx.x * ROWS + r_local;
  const bool row_ok = row < L;
  uint32_t a[8];
  float u = 0.f, v = 0.f, r2 = 0.f;
  int pred = 0;
  bool live = false;
  if (row_ok) {
#pragma unroll
    for (int w = 0; w < 8; ++w) a[w] = a_desc[row * 8 + w];
    u = a_uv[row].x;
    v = a_uv[row].y;
    r2 = a_r2[row];
    pred = a_pred[row];
    live = a_vis[row] != 0;
  }
  // gated column 0 at LARGE_D stands in for every gated pair (K >= 2)
  int best = LARGE_D * col_mul;
  int second = LARGE_D;

  for (int k0 = 0; k0 < K; k0 += KTILE) {
    __syncthreads();
    for (int i = threadIdx.x; i < KTILE * 8; i += THREADS) {
      const int kk = i >> 3, w = i & 7;
      s_desc[kk][w] = (k0 + kk < K) ? b_desc[(k0 + kk) * 8 + w] : 0u;
    }
    for (int i = threadIdx.x; i < KTILE; i += THREADS) {
      const int k = k0 + i;
      const bool in = k < K;
      s_xy[i] = in ? b_xy[k] : make_float2(0.f, 0.f);
      s_lvl[i] = in ? b_level[k] : 0;
      s_val[i] = in ? b_valid[k] : 0;
    }
    __syncthreads();
    if (!live) continue;
    const int kend = min(KTILE, K - k0);
    for (int kk = slice; kk < kend; kk += SLICES) {
      if (!s_val[kk]) continue;
      const float dx = __fsub_rn(u, s_xy[kk].x);
      const float dy = __fsub_rn(v, s_xy[kk].y);
      const float d2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
      if (!(d2 < r2)) continue;
      if (pred >= 0 && abs(s_lvl[kk] - pred) > 1) continue;
      int d = 0;
#pragma unroll
      for (int w = 0; w < 8; ++w) d += __popc(a[w] ^ s_desc[kk][w]);
      const int k = k0 + kk;
      const int p = d * col_mul + k;
      if (p < best) {
        second = min(second, best / col_mul);
        best = p;
      } else {
        second = min(second, d);
      }
      atomicMin(&col_min[k], d * row_mul + row);
    }
  }

  s_best[slice][r_local] = best;
  s_second[slice][r_local] = second;
  __syncthreads();
  if (slice == 0 && row_ok) {
    int b = s_best[0][r_local];
    int s = s_second[0][r_local];
#pragma unroll
    for (int sl = 1; sl < SLICES; ++sl) {
      const int b2 = s_best[sl][r_local];
      s = min(s, min(s_second[sl][r_local], max(b, b2) / col_mul));
      b = min(b, b2);
    }
    row_best[row] = b;
    row_second[row] = s;
  }
}

__global__ void match_epilogue_kernel(const int* __restrict__ row_best,
                                      const int* __restrict__ row_second,
                                      const int* __restrict__ col_min, int L, int col_mul,
                                      int row_mul, int max_dist, float ratio, int cross_check,
                                      int* __restrict__ idx, int* __restrict__ dist) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= L) return;
  const int p = row_best[row];
  const int bi = p % col_mul;
  int bd = p / col_mul;
  int sd = row_second[row];
  if (bd >= LARGE_D) bd = LARGE;
  if (sd >= LARGE_D) sd = LARGE;
  bool ok = bd <= max_dist;
  if (ratio >= 0.f) ok = ok && (__int2float_rn(bd) <= __fmul_rn(ratio, __int2float_rn(sd)));
  if (cross_check) ok = ok && (col_min[bi] % row_mul == row);
  idx[row] = ok ? bi : -1;
  dist[row] = ok ? bd : LARGE;
}

}  // namespace

extern "C" int projection_match(const int* a_desc, const int* b_desc, const float* a_uv,
                                const unsigned char* a_vis, const float* a_r2, const int* a_pred,
                                const float* b_xy, const int* b_level,
                                const unsigned char* b_valid, int L, int K, int col_mul,
                                int row_mul, int max_dist, float ratio, int cross_check,
                                int* row_best, int* row_second, int* col_min, int* idx,
                                int* dist, void* stream) {
  if (L <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  match_rows_kernel<<<(L + ROWS - 1) / ROWS, THREADS, 0, s>>>(
      reinterpret_cast<const uint32_t*>(a_desc), reinterpret_cast<const uint32_t*>(b_desc),
      reinterpret_cast<const float2*>(a_uv), a_vis, a_r2, a_pred,
      reinterpret_cast<const float2*>(b_xy), b_level, b_valid, L, K, col_mul, row_mul,
      row_best, row_second, col_min);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  match_epilogue_kernel<<<(L + 255) / 256, 256, 0, s>>>(row_best, row_second, col_min, L,
                                                        col_mul, row_mul, max_dist, ratio,
                                                        cross_check, idx, dist);
  return static_cast<int>(cudaGetLastError());
}
