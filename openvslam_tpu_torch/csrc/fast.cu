// K1: the whole FAST detection stage of every pyramid level in one launch:
// FAST-9/16 scores at two thresholds, the two-threshold preference, 3x3
// non-maximum suppression, the optional mask and the per-cell top-k, written
// straight into the per-level candidate pools.  No score map reaches device
// memory.
//
// Replaces the TPU kernel openvslam_tpu/ops/pallas/fast_kernel.py
// (fast_score_maps_pallas, body _fast_band_kernel) together with what its
// caller ran after it (openvslam_tpu/ops/fast.py detect_levels up to the
// cross-level top_k: _cell_candidates, nms3x3, topk_small).
//
// What bounds it on this card: it reads each pixel once (3.8 MB for a
// 640x480, 8-level pyramid, about a microsecond at 3.35 TB/s) and writes
// pools of a few tens of kilobytes; the work is about 110 operations per
// pixel for the segment test and the NMS, the arc sums for the few pixels
// that pass the segment test, and k_cell rounds of a 1024-wide maximum per
// cell.  Both bounds are near a microsecond; what it really costs is
// latency: barriers and the k_cell dependent rounds of each block.
//
// Design: one block per (frame, level, 32x32 cell); a per-level table passed
// by value maps a block to its level and holds each level's image and mask
// pointers, so the levels need no concatenation.  A batch of B frames of one
// geometry is the grid's second dimension: each level's images (and masks)
// lie frame after frame in one (B, h, w) block, and blockIdx.y picks the
// frame; the per-frame code is the same for every B, so a batched launch
// writes each frame's pools bit for bit as a launch of that frame alone.
// The block stages a 40x40 tile (cell + 3-px ring + 1-px NMS halo) in shared memory and scores the
// cell and a 1-px ring around it (34x34 positions).  Per position, the 16
// ring differences give bright and dark pass masks at the lower threshold;
// a pixel with no 9-contiguous run in either is not a corner at either
// threshold (the higher threshold passes a subset of the ring), so both
// scores are 0 and nothing else is computed.  Only pixels with a run take
// the 16 windowed arc sums (sliding, one add and one subtract each), shared
// by both thresholds and both polarities.  The NMS reads the scored ring
// from shared memory; the top-k is k_cell rounds of a block maximum over
// packed 32-bit keys, one barrier a round.
//
// Exactness: images are integer-valued and the thresholds integers, so every
// difference and every 9-term sum is a small integer in float32 and equals
// the plain version (ops/fast.py fast_cell_pools_plain) bit for bit,
// whatever the summation order.  A preferred score v is then an integer
// below 2^22, so the key ((v + 1) << 10) | (1023 - p) orders positions as
// topk_small does: value descending, lowest in-cell index p first on ties;
// a retired position's key is 0, below every live key.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int CELL = 32;                  // must match ops/fast.py KERNEL_CELL
constexpr int RING = 3;                   // FAST circle radius = the zeroed frame
constexpr int PAD = RING + 1;             // ring + the NMS halo
constexpr int TILE = CELL + 2 * PAD;      // 40x40 pixels staged per block
constexpr int SC = CELL + 2;              // 34x34 scores: the cell and a 1-px ring
constexpr int THREADS = 256;
constexpr int PER_THREAD = CELL * CELL / THREADS;   // in-cell positions per thread
constexpr int WARPS = THREADS / 32;
constexpr int MAX_LEVELS = 16;            // must match kernels.py MAX_LEVELS
constexpr float BONUS = 1e4f;             // must match ops/fast.py _BONUS

// the 16 ring offsets in circular order, as offsets into the tile
__constant__ int kRing[16] = {
    -3 * TILE + 0, -3 * TILE + 1, -2 * TILE + 2, -1 * TILE + 3,
    0 * TILE + 3,  1 * TILE + 3,  2 * TILE + 2,  3 * TILE + 1,
    3 * TILE + 0,  3 * TILE - 1,  2 * TILE - 2,  1 * TILE - 3,
    0 * TILE - 3, -1 * TILE - 3, -2 * TILE - 2, -3 * TILE - 1};

}  // namespace

struct LevelTable {
  int num_levels;
  int vmax;                          // pool row length: max over levels of cells * k_cell
  int height[MAX_LEVELS];
  int width[MAX_LEVELS];
  int cells_x[MAX_LEVELS];
  int k_cell[MAX_LEVELS];
  int cell_start[MAX_LEVELS + 1];    // first block of each level; the last entry is the grid
  const float* img[MAX_LEVELS];
  const unsigned char* mask[MAX_LEVELS];   // mask > 0 as bytes, or null
};

namespace {

// bit s set iff ring bits s..s+8 (circularly) are all set, s in 0..15
__device__ __forceinline__ unsigned arc_starts(unsigned m) {
  const unsigned a = m | (m << 16);
  unsigned r = a & (a >> 1);
  r &= r >> 2;
  r &= r >> 4;
  r &= a >> 8;
  return r & 0xFFFFu;
}

__device__ __forceinline__ unsigned pass_mask(const float (&d)[16], float sign, float thr) {
  unsigned m = 0;
#pragma unroll
  for (int k = 0; k < 16; ++k) m |= static_cast<unsigned>(sign * d[k] - thr > 0.f) << k;
  return m;
}

// best sum over the 9-arcs that start at the set bits of `starts`, else 0
__device__ __forceinline__ float arc_best(const float (&w)[16], unsigned starts, float sign,
                                          float nine_thr) {
  float best = 0.f;
#pragma unroll
  for (int s = 0; s < 16; ++s)
    if ((starts >> s) & 1u) best = fmaxf(best, sign * w[s] - nine_thr);
  return best;
}

__device__ __forceinline__ float fast_score(const float (&d)[16], const float (&w)[16],
                                            float thr) {
  const float nine = 9.f * thr;
  return fmaxf(arc_best(w, arc_starts(pass_mask(d, 1.f, thr)), 1.f, nine),
               arc_best(w, arc_starts(pass_mask(d, -1.f, thr)), -1.f, nine));
}

// preferred score of the pixel at tile[0] (an interior pixel of its level)
__device__ __forceinline__ float preferred_score(const float* px, float thr_hi, float thr_lo,
                                                 float thr_min) {
  const float c = px[0];
  float d[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) d[k] = px[kRing[k]] - c;
  if (!(arc_starts(pass_mask(d, 1.f, thr_min)) | arc_starts(pass_mask(d, -1.f, thr_min))))
    return 0.f;
  float w[16];                       // w[s] = sum of d over the arc s..s+8
  float acc = 0.f;
#pragma unroll
  for (int k = 0; k < 9; ++k) acc += d[k];
  w[0] = acc;
#pragma unroll
  for (int s = 1; s < 16; ++s) {
    acc += d[(s + 8) & 15] - d[s - 1];
    w[s] = acc;
  }
  const float s_hi = fast_score(d, w, thr_hi);
  return s_hi > 0.f ? s_hi + BONUS : fast_score(d, w, thr_lo);
}

__global__ void __launch_bounds__(THREADS)
fast_pools_kernel(LevelTable t, float thr_hi, float thr_lo, float* __restrict__ vals,
                  long long* __restrict__ idxs) {
  __shared__ float tile[TILE * TILE];
  __shared__ float score[SC][SC];
  __shared__ unsigned part[2][WARPS];

  const int b = blockIdx.x;
  const int frame = blockIdx.y;
  int l = 0;
  while (l + 1 < t.num_levels && b >= t.cell_start[l + 1]) ++l;
  const int c = b - t.cell_start[l];
  const int n_cells = t.cell_start[l + 1] - t.cell_start[l];
  const int y0 = (c / t.cells_x[l]) * CELL, x0 = (c % t.cells_x[l]) * CELL;
  const int h = t.height[l], w = t.width[l];
  const size_t frame_px = static_cast<size_t>(frame) * h * w;
  const float* __restrict__ img = t.img[l] + frame_px;
  const unsigned char* __restrict__ mask = t.mask[l] != nullptr ? t.mask[l] + frame_px : nullptr;

  for (int i = threadIdx.x; i < TILE * TILE; i += THREADS) {
    const int gy = y0 - PAD + i / TILE, gx = x0 - PAD + i % TILE;
    tile[i] = (gy >= 0 && gy < h && gx >= 0 && gx < w) ? __ldg(img + static_cast<size_t>(gy) * w + gx)
                                                        : 0.f;
  }
  __syncthreads();

  // scores of the cell and its 1-px ring; -inf outside the level, 0 in its
  // 3-px frame (ops/fast.py: roll + frame zeroing, max_pool2d's -inf padding)
  const float thr_min = fminf(thr_hi, thr_lo);
  for (int i = threadIdx.x; i < SC * SC; i += THREADS) {
    const int sy = i / SC, sx = i % SC;
    const int gy = y0 - 1 + sy, gx = x0 - 1 + sx;
    float s = -INFINITY;
    if (gy >= 0 && gy < h && gx >= 0 && gx < w) {
      s = 0.f;
      if (gy >= RING && gy < h - RING && gx >= RING && gx < w - RING)
        s = preferred_score(&tile[(sy + PAD - 1) * TILE + sx + PAD - 1], thr_hi, thr_lo, thr_min);
    }
    score[sy][sx] = s;
  }
  __syncthreads();

  // NMS (keep a score >= each in-level 3x3 neighbour), then the mask; cell
  // positions beyond the level hold 0, as the padded layout does
  unsigned key[PER_THREAD];
#pragma unroll
  for (int j = 0; j < PER_THREAD; ++j) {
    const int p = threadIdx.x + j * THREADS;
    const int py = p / CELL, px = p % CELL;
    float v = 0.f;
    if (y0 + py < h && x0 + px < w) {
      const float s = score[py + 1][px + 1];
      float mx = s;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) mx = fmaxf(mx, score[py + dy][px + dx]);
      v = s >= mx ? s : 0.f;
      if (mask != nullptr && !mask[static_cast<size_t>(y0 + py) * w + x0 + px]) v = 0.f;
    }
    key[j] = ((static_cast<unsigned>(v) + 1u) << 10) | static_cast<unsigned>(CELL * CELL - 1 - p);
  }

  // per-cell top-k: k rounds of a block maximum; the owner retires the winner
  const int k = t.k_cell[l];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t row = (static_cast<size_t>(frame) * t.num_levels + l) * t.vmax;
  for (int r = 0; r < k; ++r) {
    unsigned m = key[0];
#pragma unroll
    for (int j = 1; j < PER_THREAD; ++j) m = max(m, key[j]);
    m = __reduce_max_sync(0xFFFFFFFFu, m);
    if (lane == 0) part[r & 1][warp] = m;
    __syncthreads();
    unsigned best = part[r & 1][0];
#pragma unroll
    for (int i = 1; i < WARPS; ++i) best = max(best, part[r & 1][i]);
    const int p = CELL * CELL - 1 - static_cast<int>(best & 1023u);
#pragma unroll
    for (int j = 0; j < PER_THREAD; ++j)
      if (p == static_cast<int>(threadIdx.x) + j * THREADS) key[j] = 0u;
    if (threadIdx.x == 0) {
      const size_t o = row + static_cast<size_t>(c) * k + r;
      vals[o] = static_cast<float>((best >> 10) - 1u);
      idxs[o] = static_cast<long long>(c) * (CELL * CELL) + p;
    }
  }

  // the row's tail beyond this level's pool: -inf values, index 0
  for (int i = n_cells * k + c * THREADS + threadIdx.x; i < t.vmax; i += n_cells * THREADS) {
    vals[row + i] = -INFINITY;
    idxs[row + i] = 0;
  }
}

}  // namespace

// `batch` frames of one geometry: t.img[l] (and t.mask[l]) point at (batch,
// h, w) blocks; vals and idxs are (batch, num_levels, vmax).
extern "C" int fast_cell_pools(LevelTable t, int batch, float thr_hi, float thr_lo, float* vals,
                               long long* idxs, void* stream) {
  if (t.num_levels < 1 || t.num_levels > MAX_LEVELS || batch < 0 || batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = t.cell_start[t.num_levels];
  if (blocks > 0 && batch > 0) {
    fast_pools_kernel<<<dim3(blocks, batch), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        t, thr_hi, thr_lo, vals, idxs);
  }
  return static_cast<int>(cudaGetLastError());
}
