// K1: FAST-9/16 score maps at two thresholds, all pyramid levels in one launch.
//
// Replaces the TPU kernel openvslam_tpu/ops/pallas/fast_kernel.py
// (fast_score_maps_pallas, body _fast_band_kernel), and its caller's grouped
// launches in openvslam_tpu/ops/fast.py:detect_levels.
//
// What bounds it on this card: it reads each pixel once and writes two maps,
// about 12 bytes per pixel (11.4 MB for a 640x480, 8-level pyramid, a few
// microseconds at 3.35 TB/s), but each pixel costs some 700 f32 operations
// (16 ring differences, then the best 9-arc of both polarities at both
// thresholds), so it is bound by operations, not by bytes.
//
// Design: one thread per output pixel; a block of 32x8 pixels stages its
// tile plus the 3-px ring halo in shared memory, so the 16 ring reads per
// pixel hit shared memory.  The ring differences are computed once and
// shared by both thresholds.  The levels are concatenated in one flat
// buffer; a per-level table (passed by value) maps a block to its level,
// which replaces the TPU version's per-width canvases.  The 3-px frame of
// every level is written as zero (ops/fast.py _zero_border semantics).
//
// Exactness: images are integer-valued and the thresholds are integers, so
// every difference and every 9-term sum is a small integer in float32 and the
// result equals the plain version (ops/fast.py fast_score_maps) bit for bit,
// whatever the summation order.
#include <cuda_runtime.h>

namespace {

constexpr int TILE_X = 32;   // must match ops/fast.py FAST_TILE_X
constexpr int TILE_Y = 8;    // must match ops/fast.py FAST_TILE_Y
constexpr int HALO = 3;
constexpr int ARC = 9;
constexpr int MAX_LEVELS = 16;  // must match kernels.py MAX_LEVELS

__constant__ int kDY[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};
__constant__ int kDX[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};

}  // namespace

struct LevelTable {
  int num_levels;
  int offset[MAX_LEVELS];
  int height[MAX_LEVELS];
  int width[MAX_LEVELS];
  int tiles_x[MAX_LEVELS];
  int tile_start[MAX_LEVELS + 1];
};

namespace {

// best contiguous 9-of-16 arc sum of m (all 9 entries > 0), else 0
__device__ __forceinline__ float arc_score(const float (&m)[16]) {
  float best = 0.f;
#pragma unroll
  for (int s = 0; s < 16; ++s) {
    float sum = 0.f;
    bool all = true;
#pragma unroll
    for (int k = 0; k < ARC; ++k) {
      const float v = m[(s + k) & 15];
      sum += v;
      all = all && (v > 0.f);
    }
    if (all) best = fmaxf(best, sum);
  }
  return best;
}

__device__ __forceinline__ float fast_score(const float (&d)[16], float thr) {
  float bright[16], dark[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    bright[k] = fmaxf(d[k] - thr, 0.f);
    dark[k] = fmaxf(-d[k] - thr, 0.f);
  }
  return fmaxf(arc_score(bright), arc_score(dark));
}

__global__ void __launch_bounds__(TILE_X * TILE_Y)
fast_levels_kernel(const float* __restrict__ img, float* __restrict__ hi,
                   float* __restrict__ lo, LevelTable t, float thr_hi, float thr_lo) {
  __shared__ float tile[TILE_Y + 2 * HALO][TILE_X + 2 * HALO];
  const int b = blockIdx.x;
  int l = 0;
  while (l + 1 < t.num_levels && b >= t.tile_start[l + 1]) ++l;
  const int local = b - t.tile_start[l];
  const int ty0 = (local / t.tiles_x[l]) * TILE_Y;
  const int tx0 = (local % t.tiles_x[l]) * TILE_X;
  const int h = t.height[l], w = t.width[l];
  const float* src = img + t.offset[l];

  constexpr int TW = TILE_X + 2 * HALO, TH = TILE_Y + 2 * HALO;
  for (int i = threadIdx.x; i < TW * TH; i += blockDim.x) {
    const int yy = i / TW, xx = i % TW;
    const int gy = ty0 + yy - HALO, gx = tx0 + xx - HALO;
    tile[yy][xx] = (gy >= 0 && gy < h && gx >= 0 && gx < w) ? src[gy * w + gx] : 0.f;
  }
  __syncthreads();

  const int lx = threadIdx.x % TILE_X, ly = threadIdx.x / TILE_X;
  const int x = tx0 + lx, y = ty0 + ly;
  if (x >= w || y >= h) return;
  float s_hi = 0.f, s_lo = 0.f;
  if (y >= HALO && y < h - HALO && x >= HALO && x < w - HALO) {
    const float c = tile[ly + HALO][lx + HALO];
    float d[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) d[k] = tile[ly + HALO + kDY[k]][lx + HALO + kDX[k]] - c;
    s_hi = fast_score(d, thr_hi);
    s_lo = fast_score(d, thr_lo);
  }
  const size_t o = static_cast<size_t>(t.offset[l]) + static_cast<size_t>(y) * w + x;
  hi[o] = s_hi;
  lo[o] = s_lo;
}

}  // namespace

extern "C" int fast_score_maps_levels(const float* img, float* hi, float* lo, LevelTable t,
                                      float thr_hi, float thr_lo, void* stream) {
  if (t.num_levels < 1 || t.num_levels > MAX_LEVELS) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = t.tile_start[t.num_levels];
  if (blocks > 0) {
    fast_levels_kernel<<<blocks, TILE_X * TILE_Y, 0, static_cast<cudaStream_t>(stream)>>>(
        img, hi, lo, t, thr_hi, thr_lo);
  }
  return static_cast<int>(cudaGetLastError());
}
