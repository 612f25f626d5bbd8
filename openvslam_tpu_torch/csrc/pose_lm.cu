// K3: the whole pose-only Levenberg-Marquardt schedule (rounds x iterations)
// for perspective mono and stereo (u, v, u_right) observations, one thread
// block per pose problem.
//
// Replaces the TPU kernel openvslam_tpu/ops/pallas/pose_lm_kernel.py
// (pose_lm_pallas; bodies _lm_schedule, _cholesky_solve6, _se3_exp_scalars).
//
// What bounds it on this card: neither bytes (about 40 KB of observations)
// nor operations (about 16 MFLOP for 40 iterations at N = 1032) but latency:
// 40 dependent iterations, each a block-wide reduction followed by a serial
// 6x6 solve.  A launch per iteration, as a chain of library calls would
// need, would cost more than the work.
//
// Design: one block of 256 threads per problem, every iteration inside the
// kernel.  Each iteration every thread evaluates its observations at the
// current pose (residuals and the analytic Jacobian of the left increment,
// the same formulas as _lm_schedule) and accumulates its share of the 21 + 6
// entries of [J r]^T W [J r]; a warp-shuffle + shared-memory reduction sums
// them.  Thread 0 runs the damped Cholesky and the SE(3) exp exactly as
// _cholesky_solve6 / _se3_exp_scalars and publishes the trial pose through
// shared memory; the trial cost is block-reduced and every thread takes the
// same accept/reject decision from the shared sum.  Per-observation state at
// the accepted pose is recomputed rather than carried (the same values).
// The active set of each round lives in the active output buffer; each
// observation is owned by one thread, so it needs no synchronisation.
// All arithmetic is float32; sums run in another order than the plain
// version (ops/pose_lm.py), so results agree to float32 rounding.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr float EPS = 1e-9f;
constexpr int NG = 27;  // 21 lower-triangle entries of H, then 6 of J^T W r

struct Obs {
  float J[6][3];
  float r[3];
  float ok;
  float c2;
};

__device__ __forceinline__ void eval_obs(const float (&T)[12], const float* X, const float* o,
                                         float inv_s2, float fx, float fy, float cx, float cy,
                                         float fxb, Obs& e) {
  const float X0 = X[0], X1 = X[1], X2 = X[2];
  const float ou = o[0], ov = o[1], our = o[2];
  const float ur_obs = our >= 0.f ? 1.f : 0.f;
  const float px = T[0] * X0 + T[1] * X1 + T[2] * X2 + T[3];
  const float py = T[4] * X0 + T[5] * X1 + T[6] * X2 + T[7];
  const float pz = T[8] * X0 + T[9] * X1 + T[10] * X2 + T[11];
  const float ok = pz > EPS ? 1.f : 0.f;
  const float zs = pz > EPS ? pz : 1.f;
  const float iz = 1.f / zs;
  const float iz2 = iz * iz;
  const float u = fx * px * iz + cx;
  const float v = fy * py * iz + cy;
  const float ur = u - fxb * iz;
  e.r[0] = (ou - u) * ok;
  e.r[1] = (ov - v) * ok;
  e.r[2] = (our - ur) * ok * ur_obs;
  e.c2 = (e.r[0] * e.r[0] + e.r[1] * e.r[1] + e.r[2] * e.r[2]) * inv_s2;
  e.ok = ok;
  const float cpx = -fx * px * iz2;
  const float epy = -fy * py * iz2;
  const float q = fxb * iz2;
  const float cq = cpx + q;
  const float Ju[6] = {fx * px * py * iz2, -(fx + fx * px * px * iz2), fx * py * iz,
                       -fx * iz, 0.f, -cpx};
  const float Jv[6] = {fy + fy * py * py * iz2, -fy * px * py * iz2, -fy * px * iz,
                       0.f, -fy * iz, -epy};
  const float Jur[6] = {-py * cq, -(fx + fx * px * px * iz2) + px * q, fx * py * iz,
                        -fx * iz, 0.f, -cq};
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    e.J[i][0] = Ju[i] * ok;
    e.J[i][1] = Jv[i] * ok;
    e.J[i][2] = Jur[i] * ok * ur_obs;
  }
}

__device__ __forceinline__ float rho(float c, float thr) {
  return c <= thr ? c : 2.f * sqrtf(thr * fmaxf(c, 0.f)) - thr;
}

// sum v[0..n) over the block; every thread gets the sums in out[0..n)
template <int N>
__device__ __forceinline__ void block_sum(float (&v)[N], float* part, float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    float x = v[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(0xffffffffu, x, off);
    if (lane == 0) part[warp * N + k] = x;
  }
  __syncthreads();
  for (int k = threadIdx.x; k < N; k += THREADS) {
    float s = 0.f;
    for (int w = 0; w < WARPS; ++w) s += part[w * N + k];
    out[k] = s;
  }
  __syncthreads();
}

// _cholesky_solve6: H (lower triangle, damped) x = g
__device__ void cholesky_solve6(const float (&h)[6][6], const float (&g)[6], float (&x)[6]) {
  float L[6][6];
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    float s = h[j][j];
#pragma unroll
    for (int k = 0; k < j; ++k) s = s - L[j][k] * L[j][k];
    const float d = sqrtf(fmaxf(s, 1e-12f));
    L[j][j] = d;
#pragma unroll
    for (int i = j + 1; i < 6; ++i) {
      float t = h[i][j];
#pragma unroll
      for (int k = 0; k < j; ++k) t = t - L[i][k] * L[j][k];
      L[i][j] = t / d;
    }
  }
  float y[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float s = g[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s = s - L[i][k] * y[k];
    y[i] = s / L[i][i];
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float s = y[i];
#pragma unroll
    for (int k = i + 1; k < 6; ++k) s = s - L[k][i] * x[k];
    x[i] = s / L[i][i];
  }
}

// _se3_exp_scalars: exp of (omega, upsilon) -> R, t
__device__ void se3_exp(const float (&xi)[6], float (&R)[3][3], float (&t)[3]) {
  const float w0 = xi[0], w1 = xi[1], w2 = xi[2];
  const float th2 = w0 * w0 + w1 * w1 + w2 * w2;
  const float th = sqrtf(fmaxf(th2, EPS * EPS));
  const bool small = th2 < EPS;
  const float a = small ? 1.f - th2 / 6.f : sinf(th) / th;
  const float b = small ? 0.5f - th2 / 24.f : (1.f - cosf(th)) / th2;
  const float c = small ? 1.f / 6.f - th2 / 120.f : (th - sinf(th)) / (th2 * th);
  const float W[3][3] = {{0.f, -w2, w1}, {w2, 0.f, -w0}, {-w1, w0, 0.f}};
  float V[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float w2ij = W[i][0] * W[0][j] + W[i][1] * W[1][j] + W[i][2] * W[2][j];
      const float eye = i == j ? 1.f : 0.f;
      R[i][j] = eye + a * W[i][j] + b * w2ij;
      V[i][j] = eye + b * W[i][j] + c * w2ij;
    }
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) t[i] = V[i][0] * xi[3] + V[i][1] * xi[4] + V[i][2] * xi[5];
}

__global__ void __launch_bounds__(THREADS)
pose_lm_kernel(const float* __restrict__ T0, const float* __restrict__ X,
               const float* __restrict__ obs, const float* __restrict__ inv_s2,
               const float* __restrict__ mask, int N, float fx, float fy, float cx, float cy,
               float fxb, float chi2, int rounds, int iters, float* __restrict__ T_out,
               float* __restrict__ c2_out, float* __restrict__ active) {
  __shared__ float part[WARPS * NG];
  __shared__ float sums[NG];
  __shared__ float s_try[12];
  const int p = blockIdx.x;
  X += static_cast<size_t>(p) * N * 3;
  obs += static_cast<size_t>(p) * N * 3;
  inv_s2 += static_cast<size_t>(p) * N;
  mask += static_cast<size_t>(p) * N;
  c2_out += static_cast<size_t>(p) * N;
  active += static_cast<size_t>(p) * N;

  float T[12];
#pragma unroll
  for (int k = 0; k < 12; ++k) T[k] = T0[p * 12 + k];
  for (int i = threadIdx.x; i < N; i += THREADS) active[i] = mask[i];

  Obs e;
  for (int round = 0; round < rounds; ++round) {
    float c1[1] = {0.f};
    for (int i = threadIdx.x; i < N; i += THREADS) {
      eval_obs(T, X + 3 * i, obs + 3 * i, inv_s2[i], fx, fy, cx, cy, fxb, e);
      c1[0] += rho(e.c2, chi2) * active[i] * e.ok;
    }
    block_sum<1>(c1, part, sums);
    float cost = sums[0];
    float lam = 1e-3f;

    for (int it = 0; it < iters; ++it) {
      float g[NG];
#pragma unroll
      for (int k = 0; k < NG; ++k) g[k] = 0.f;
      for (int i = threadIdx.x; i < N; i += THREADS) {
        eval_obs(T, X + 3 * i, obs + 3 * i, inv_s2[i], fx, fy, cx, cy, fxb, e);
        float w = e.c2 <= chi2 ? 1.f : sqrtf(chi2 / fmaxf(e.c2, EPS));
        w = w * inv_s2[i] * active[i] * e.ok;
        int k = 0;
#pragma unroll
        for (int a = 0; a < 6; ++a) {
#pragma unroll
          for (int b = 0; b <= a; ++b) {
            g[k++] += w * (e.J[a][0] * e.J[b][0] + e.J[a][1] * e.J[b][1] + e.J[a][2] * e.J[b][2]);
          }
        }
#pragma unroll
        for (int a = 0; a < 6; ++a) {
          g[21 + a] += w * (e.J[a][0] * e.r[0] + e.J[a][1] * e.r[1] + e.J[a][2] * e.r[2]);
        }
      }
      block_sum<NG>(g, part, sums);

      if (threadIdx.x == 0) {
        float h[6][6], rhs[6], dx[6];
        int k = 0;
#pragma unroll
        for (int a = 0; a < 6; ++a) {
#pragma unroll
          for (int b = 0; b <= a; ++b) {
            const float v = sums[k++];
            h[a][b] = a == b ? v * (1.f + lam) + 1e-9f : v;
          }
        }
#pragma unroll
        for (int a = 0; a < 6; ++a) rhs[a] = sums[21 + a];
        cholesky_solve6(h, rhs, dx);
        float ndx[6], R[3][3], t[3];
#pragma unroll
        for (int a = 0; a < 6; ++a) ndx[a] = -dx[a];
        se3_exp(ndx, R, t);
#pragma unroll
        for (int i = 0; i < 3; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float v = R[i][0] * T[j] + R[i][1] * T[4 + j] + R[i][2] * T[8 + j];
            if (j == 3) v = v + t[i];
            s_try[i * 4 + j] = v;
          }
        }
      }
      __syncthreads();
      float Tt[12];
#pragma unroll
      for (int k = 0; k < 12; ++k) Tt[k] = s_try[k];

      float ct[1] = {0.f};
      for (int i = threadIdx.x; i < N; i += THREADS) {
        eval_obs(Tt, X + 3 * i, obs + 3 * i, inv_s2[i], fx, fy, cx, cy, fxb, e);
        ct[0] += rho(e.c2, chi2) * active[i] * e.ok;
      }
      block_sum<1>(ct, part, sums);
      const float cost_try = sums[0];
      float tsum = Tt[0];
#pragma unroll
      for (int k = 1; k < 12; ++k) tsum = tsum + Tt[k];
      const bool acc = (cost_try < cost) && isfinite(tsum);
      if (acc) {
#pragma unroll
        for (int k = 0; k < 12; ++k) T[k] = Tt[k];
        cost = cost_try;
      }
      lam = fminf(fmaxf(acc ? lam * 0.5f : lam * 4.f, 1e-9f), 1e6f);
    }

    for (int i = threadIdx.x; i < N; i += THREADS) {
      eval_obs(T, X + 3 * i, obs + 3 * i, inv_s2[i], fx, fy, cx, cy, fxb, e);
      active[i] = mask[i] * e.ok * (e.c2 < chi2 ? 1.f : 0.f);
    }
  }

  for (int i = threadIdx.x; i < N; i += THREADS) {
    eval_obs(T, X + 3 * i, obs + 3 * i, inv_s2[i], fx, fy, cx, cy, fxb, e);
    c2_out[i] = e.c2;
  }
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < 12; ++k) T_out[p * 12 + k] = T[k];
  }
}

}  // namespace

extern "C" int pose_lm(const float* T0, const float* X, const float* obs, const float* inv_s2,
                       const float* mask, int B, int N, float fx, float fy, float cx, float cy,
                       float fxb, float chi2, int rounds, int iters, float* T_out, float* c2_out,
                       float* active, void* stream) {
  if (B <= 0) return static_cast<int>(cudaGetLastError());
  pose_lm_kernel<<<B, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      T0, X, obs, inv_s2, mask, N, fx, fy, cx, cy, fxb, chi2, rounds, iters, T_out, c2_out,
      active);
  return static_cast<int>(cudaGetLastError());
}
