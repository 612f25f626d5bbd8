// K2: projection- and octave-gated Hamming matching of L landmarks against
// K keypoints, with the Lowe ratio test and the cross-check.
//
// Replaces the TPU kernel openvslam_tpu/ops/pallas/match_kernel.py
// (projection_match_pallas, body _match_kernel).
//
// What bounds it on this card: latency and the work the gate lets through,
// not the L*K product.  The TPU kernel ran the whole product on the MXU as
// an int8 matmul; here the projection radius leaves each visible landmark a
// few keypoints (radius <= 14 * 1.2^7 ~ 50 px on the main path), most
// landmark rows are not visible at all (about 150 of 4096 on the main
// path), and the inputs are about 0.3 MB, so what costs is touching
// everything rather than the distances.
//
// Design: bin the keypoints, then search only the cells near each row.
// * Bin kernel (one block): each valid keypoint's cell on a grid of square
//   cells of power-of-two side over the image (ops/match.py bin_grid), with
//   coordinates outside the grid clamped into its border cells; a counting
//   sort (count with shared atomics, one-block scan, scatter of keypoint
//   indices) gives cell_start (cells + 1) and cell_kp (the keypoints, cell
//   by cell).  The same launch fills col_min with INT_MAX.
// * Row kernel: one warp per landmark row; an invisible row writes the
//   empty result and exits before it reads anything else.  The warp walks
//   the cells of the disc's bounding box, widened by one cell plus 2^-20 of
//   the coordinates' magnitude for rounding and clamped to the grid, so a
//   keypoint clamped into a border cell is still visited and a radius that
//   covers the image degrades to a full scan.  Each cell row of the box is
//   one contiguous range of cell_kp; lanes take its keypoints and apply the
//   exact gate of the plain version (round-to-nearest intrinsics, so no
//   fused multiply-add changes d^2 < r^2; the octave test; only valid
//   keypoints are binned).  The cell never decides a match, the gate does.
//   Distances are 8 __popc with the landmark's descriptor in registers.
//   Row best and second are packed (d * col_mul + k) minima merged by warp
//   shuffles; the column minimum for the cross-check is atomicMin(d *
//   row_mul + row).  Packed minima do not depend on the visiting order, so
//   ties go to the lowest index as in the plain version.
// * Epilogue kernel: max_dist, the ratio test and the cross-check, exactly
//   as match_kernel.py:177-187.
// Gated pairs count as distance 1023 (the TPU kernel's _LARGE_D), which the
// epilogue maps back to ops/match.py LARGE, so idx and dist equal the plain
// version's (ops/match.py projection_scale_match_plain), ties included.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int LARGE_D = 1023;
constexpr int LARGE = 1 << 20;  // ops/match.py LARGE
constexpr int BIN_THREADS = 1024;
constexpr int MAX_CELLS = 8192;  // ops/match.py MAX_CELLS
constexpr int ROW_WARPS = 8;
constexpr unsigned FULL = 0xffffffffu;
constexpr float SLACK = 1.f / 1048576.f;  // 2^-20

struct Grid {
  float cell, inv_cell;
  int gw, gh;
};

// floor(x / cell) clamped to [0, n): NaN goes to 0, +-inf to the edges
// (ops/match.py _grid_coord)
__device__ __forceinline__ int grid_coord(float x, float inv_cell, int n) {
  float f = floorf(__fmul_rn(x, inv_cell));
  f = fminf(fmaxf(f, 0.f), static_cast<float>(n - 1));
  return static_cast<int>(f);
}

__device__ __forceinline__ int level_at(const void* p, int i, int is64) {
  return is64 ? static_cast<int>(static_cast<const long long*>(p)[i])
              : static_cast<const int*>(p)[i];
}

__global__ void __launch_bounds__(BIN_THREADS)
match_bin_kernel(const float2* __restrict__ b_xy, const unsigned char* __restrict__ b_valid,
                 int K, Grid g, int* __restrict__ cell_start, int* __restrict__ cell_kp,
                 int* __restrict__ col_min) {
  __shared__ int s_cur[MAX_CELLS];
  __shared__ int s_warp[BIN_THREADS / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nc = g.gw * g.gh;
  for (int c = tid; c < nc; c += BIN_THREADS) s_cur[c] = 0;
  for (int k = tid; k < K; k += BIN_THREADS) col_min[k] = INT_MAX;
  __syncthreads();
  for (int k = tid; k < K; k += BIN_THREADS) {
    if (b_valid[k]) {
      const float2 xy = b_xy[k];
      atomicAdd(&s_cur[grid_coord(xy.y, g.inv_cell, g.gh) * g.gw +
                       grid_coord(xy.x, g.inv_cell, g.gw)], 1);
    }
  }
  __syncthreads();
  // exclusive scan: each thread a contiguous run of cells, then the block
  const int per = (nc + BIN_THREADS - 1) / BIN_THREADS;
  const int c0 = min(tid * per, nc), c1 = min(c0 + per, nc);
  int local = 0;
  for (int c = c0; c < c1; ++c) local += s_cur[c];
  int incl = local;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(FULL, incl, off);
    if (lane >= off) incl += y;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = s_warp[lane];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(FULL, w, off);
      if (lane >= off) w += y;
    }
    s_warp[lane] = w;
  }
  __syncthreads();
  int offset = incl - local + (warp > 0 ? s_warp[warp - 1] : 0);
  for (int c = c0; c < c1; ++c) {
    const int n = s_cur[c];
    s_cur[c] = offset;
    cell_start[c] = offset;
    offset += n;
  }
  if (tid == 0) cell_start[nc] = s_warp[BIN_THREADS / 32 - 1];
  __syncthreads();
  for (int k = tid; k < K; k += BIN_THREADS) {
    if (b_valid[k]) {
      const float2 xy = b_xy[k];
      const int c = grid_coord(xy.y, g.inv_cell, g.gh) * g.gw + grid_coord(xy.x, g.inv_cell, g.gw);
      cell_kp[atomicAdd(&s_cur[c], 1)] = k;
    }
  }
}

__global__ void __launch_bounds__(ROW_WARPS * 32)
match_rows_kernel(const uint32_t* __restrict__ a_desc, const uint32_t* __restrict__ b_desc,
                  const float2* __restrict__ a_uv, const unsigned char* __restrict__ a_vis,
                  const float* __restrict__ a_radius, const void* __restrict__ a_pred,
                  int pred64, const float2* __restrict__ b_xy, const void* __restrict__ b_level,
                  int level64, const int* __restrict__ cell_start,
                  const int* __restrict__ cell_kp, int L, Grid g, int col_mul, int row_mul,
                  int* __restrict__ row_best, int* __restrict__ row_second,
                  int* __restrict__ col_min) {
  const int row = blockIdx.x * ROW_WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= L) return;
  // gated column 0 at LARGE_D stands in for every gated pair (K >= 2)
  int best = LARGE_D * col_mul;
  int second = LARGE_D;
  if (a_vis[row]) {
    const uint32_t word = lane < 8 ? a_desc[row * 8 + lane] : 0u;
    uint32_t a[8];
#pragma unroll
    for (int w = 0; w < 8; ++w) a[w] = __shfl_sync(FULL, word, w);
    const float2 uv = a_uv[row];
    const float r = a_radius[row];
    const float r2 = __fmul_rn(r, r);
    const int pred = level_at(a_pred, row, pred64);
    // bounding box of the disc, widened for rounding (ops/match.py row_boxes)
    const float ar = fabsf(r);
    const float px = __fadd_rn(ar, __fadd_rn(g.cell, __fmul_rn(__fadd_rn(fabsf(uv.x), ar), SLACK)));
    const float py = __fadd_rn(ar, __fadd_rn(g.cell, __fmul_rn(__fadd_rn(fabsf(uv.y), ar), SLACK)));
    const int bx0 = grid_coord(__fsub_rn(uv.x, px), g.inv_cell, g.gw);
    const int bx1 = grid_coord(__fadd_rn(uv.x, px), g.inv_cell, g.gw);
    const int by0 = grid_coord(__fsub_rn(uv.y, py), g.inv_cell, g.gh);
    const int by1 = grid_coord(__fadd_rn(uv.y, py), g.inv_cell, g.gh);
    for (int cy = by0; cy <= by1; ++cy) {
      const int beg = cell_start[cy * g.gw + bx0];
      const int end = cell_start[cy * g.gw + bx1 + 1];
      for (int j = beg + lane; j < end; j += 32) {
        const int k = cell_kp[j];
        const float2 xy = b_xy[k];
        const float dx = __fsub_rn(uv.x, xy.x);
        const float dy = __fsub_rn(uv.y, xy.y);
        const float d2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
        if (!(d2 < r2)) continue;
        if (pred >= 0 && abs(level_at(b_level, k, level64) - pred) > 1) continue;
        const uint4* bd = reinterpret_cast<const uint4*>(b_desc + k * 8);
        const uint4 q0 = bd[0], q1 = bd[1];
        const int d = __popc(a[0] ^ q0.x) + __popc(a[1] ^ q0.y) + __popc(a[2] ^ q0.z) +
                      __popc(a[3] ^ q0.w) + __popc(a[4] ^ q1.x) + __popc(a[5] ^ q1.y) +
                      __popc(a[6] ^ q1.z) + __popc(a[7] ^ q1.w);
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
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const int ob = __shfl_xor_sync(FULL, best, off);
      const int os = __shfl_xor_sync(FULL, second, off);
      second = min(min(second, os), max(best, ob) / col_mul);
      best = min(best, ob);
    }
  }
  if (lane == 0) {
    row_best[row] = best;
    row_second[row] = second;
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

// a_desc (L,8) / b_desc (K,8) packed int32; a_uv (L,2) f32, a_vis (L,)
// bool, a_radius (L,) f32, a_pred (L,) int32 or int64 (pred64); b_xy (K,2)
// f32, b_level (K,) int32 or int64 (level64), b_valid (K,) bool.  The grid
// has gw x gh cells of side cell (a power of two).  scratch holds
// gw*gh + 1 + 2K + 2L int32 (ops/match.py scratch_size).  Writes idx (L,)
// and dist (L,).  Returns a cudaError_t.
extern "C" int projection_match(const int* a_desc, const int* b_desc, const float* a_uv,
                                const unsigned char* a_vis, const float* a_radius,
                                const void* a_pred, int pred64, const float* b_xy,
                                const void* b_level, int level64, const unsigned char* b_valid,
                                int L, int K, float cell, int gw, int gh, int col_mul,
                                int row_mul, int max_dist, float ratio, int cross_check,
                                int* scratch, int* idx, int* dist, void* stream) {
  if (L <= 0) return static_cast<int>(cudaGetLastError());
  if (K < 2 || gw < 1 || gh < 1 || gw * gh > MAX_CELLS || !(cell > 0.f))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Grid g{cell, 1.f / cell, gw, gh};
  int* cell_start = scratch;
  int* cell_kp = cell_start + gw * gh + 1;
  int* row_best = cell_kp + K;
  int* row_second = row_best + L;
  int* col_min = row_second + L;
  match_bin_kernel<<<1, BIN_THREADS, 0, s>>>(reinterpret_cast<const float2*>(b_xy), b_valid, K,
                                             g, cell_start, cell_kp, col_min);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  match_rows_kernel<<<(L + ROW_WARPS - 1) / ROW_WARPS, ROW_WARPS * 32, 0, s>>>(
      reinterpret_cast<const uint32_t*>(a_desc), reinterpret_cast<const uint32_t*>(b_desc),
      reinterpret_cast<const float2*>(a_uv), a_vis, a_radius, a_pred, pred64,
      reinterpret_cast<const float2*>(b_xy), b_level, level64, cell_start, cell_kp, L, g,
      col_mul, row_mul, row_best, row_second, col_min);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  match_epilogue_kernel<<<(L + 255) / 256, 256, 0, s>>>(row_best, row_second, col_min, L,
                                                        col_mul, row_mul, max_dist, ratio,
                                                        cross_check, idx, dist);
  return static_cast<int>(cudaGetLastError());
}
