// K3: the whole pose-only Levenberg-Marquardt schedule (rounds x iterations)
// for perspective mono and stereo (u, v, u_right) observations, one thread
// block per pose problem.
//
// Replaces the TPU kernel openvslam_tpu/ops/pallas/pose_lm_kernel.py
// (pose_lm_pallas; bodies _lm_schedule, _cholesky_solve6, _se3_exp_scalars).
//
// What bounds it on this card: neither bytes (about 30 B per observation)
// nor operations (about 19 MFLOP for 40 iterations at N = 1064) but
// latency: 40 dependent iterations on one SM, each a pass over the
// observations, a block-wide 28-value reduction and a serial 6x6 solve.
// A launch per iteration, as a chain of library calls would need, would
// cost more than the work.
//
// Design (one pass and one block reduction per iteration, two barriers):
// * The load phase of the register variants (all of the main path's
//   shapes) compacts the masked observations (a block scan over the
//   mask, their indices in ascending order in shared memory) and each
//   thread loads its slots s = tid + j * THREADS, j < PER, once: X, (u, v,
//   u_right) and 1 / max(sigma2, 1e-12) stay in registers for the whole
//   launch and the round's active set is a bit mask.  No device-memory read
//   happens inside the iterations.  On the main path the mask holds a few
//   hundred of N rows, so most warps hold no slot: they skip the passes and
//   the reduction.  Masked-out and inactive observations add exact zeros to
//   every sum, so leaving them out changes no float (only where such an
//   observation's Jacobian is not finite would the plain version differ).
// * The trial pose is evaluated once, accumulating its robust cost and its
//   27 normal-equation entries (the 21 of the lower triangle of J^T W J,
//   then the 6 of J^T W r): a 28-wide reduction.  On accept those sums are
//   the next iteration's system at the new pose; on reject the pose is
//   unchanged, so the accepted pose's sums, kept in shared memory, are used
//   again and only lambda changes.  This is how the plain version
//   (ops/pose_lm.py _lm_schedule) carries J and r of the accepted trial.
// * The warp reduction is a transpose butterfly: 31 shuffles leave lane l
//   with the warp's sum of value l (the same pairing as a shfl_down tree,
//   so the same float).  Warp 0 sums the warp partials in ascending warp
//   order, takes the accept/reject decision and lambda, and thread 0 runs
//   the damped Cholesky and the SE(3) exp (sinf/cosf/sqrtf, no fast math)
//   and publishes the next trial pose; one __syncthreads follows the
//   reduction and one the publication.
// * Inliers are reclassified at the start of each later round, in the pass
//   that builds that round's first system.  A last pass over all N rows,
//   read once more from device memory, writes chi2, the inlier mask, their
//   count and the 4x4 pose.
// * Block width 512 (128 registers a thread).  The register variants hold
//   PER = 8 mono or 6 stereo slots a thread, so N <= 4096 / 3072 (8 stereo
//   slots would spill); the slot loops leave at the first slot index past
//   the masked count, a test that is the same for the whole block, so
//   empty slots cost nothing.  Above that N, the device-memory variant
//   (PER = 0) takes any N with the same mathematics: each pass reads its
//   rows i = tid + k * 512 again, and the active set lives in the inl_out
//   bytes of those rows (each row read and written by one thread only)
//   until the last pass overwrites them.
// * A batch of B problems of one shape (N and observation columns) is one
//   launch of B blocks: block b offsets every operand and output by its
//   problem and runs the code above unchanged, so each problem's pose,
//   inliers, chi2 and count are bit for bit those of a launch of it alone.
// All arithmetic is float32; block sums run in another order than the
// plain version, so results agree to float32 rounding, not bit for bit.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float EPS = 1e-9f;
constexpr int NG = 27;  // 21 lower-triangle entries of H, then 6 of J^T W r
constexpr int NS = 28;  // ... then the robust cost
constexpr unsigned FULL = 0xffffffffu;
constexpr int THREADS = 512;
constexpr int PER_MONO = 8, PER_STEREO = 6;

struct Cam {
  float fx, fy, cx, cy, fxb, chi2;
};

template <bool STEREO>
struct Eval {
  float J[6][STEREO ? 3 : 2];
  float r[STEREO ? 3 : 2];
  float ok;
  float c2;
};

// residuals and the analytic Jacobian of the left increment at pose T
// (the formulas of _lm_schedule's eval_at)
template <bool STEREO>
__device__ __forceinline__ void eval_obs(const float (&T)[12], float X0, float X1, float X2,
                                         float ou, float ov, float our, float inv_s2,
                                         const Cam& c, Eval<STEREO>& e) {
  const float px = T[0] * X0 + T[1] * X1 + T[2] * X2 + T[3];
  const float py = T[4] * X0 + T[5] * X1 + T[6] * X2 + T[7];
  const float pz = T[8] * X0 + T[9] * X1 + T[10] * X2 + T[11];
  const float ok = pz > EPS ? 1.f : 0.f;
  const float zs = pz > EPS ? pz : 1.f;
  const float iz = 1.f / zs;
  const float iz2 = iz * iz;
  const float u = c.fx * px * iz + c.cx;
  const float v = c.fy * py * iz + c.cy;
  e.r[0] = (ou - u) * ok;
  e.r[1] = (ov - v) * ok;
  e.ok = ok;
  const float cpx = -c.fx * px * iz2;
  const float epy = -c.fy * py * iz2;
  const float Ju[6] = {c.fx * px * py * iz2, -(c.fx + c.fx * px * px * iz2), c.fx * py * iz,
                       -c.fx * iz, 0.f, -cpx};
  const float Jv[6] = {c.fy + c.fy * py * py * iz2, -c.fy * px * py * iz2, -c.fy * px * iz,
                       0.f, -c.fy * iz, -epy};
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    e.J[i][0] = Ju[i] * ok;
    e.J[i][1] = Jv[i] * ok;
  }
  if constexpr (STEREO) {
    const float ur_obs = our >= 0.f ? 1.f : 0.f;
    const float ur = u - c.fxb * iz;
    e.r[2] = (our - ur) * ok * ur_obs;
    e.c2 = (e.r[0] * e.r[0] + e.r[1] * e.r[1] + e.r[2] * e.r[2]) * inv_s2;
    const float q = c.fxb * iz2;
    const float cq = cpx + q;
    const float Jur[6] = {-py * cq, -(c.fx + c.fx * px * px * iz2) + px * q, c.fx * py * iz,
                          -c.fx * iz, 0.f, -cq};
#pragma unroll
    for (int i = 0; i < 6; ++i) e.J[i][2] = Jur[i] * ok * ur_obs;
  } else {
    e.c2 = (e.r[0] * e.r[0] + e.r[1] * e.r[1]) * inv_s2;
  }
}

template <bool STEREO>
__device__ __forceinline__ float dot3(const float (&a)[STEREO ? 3 : 2],
                                      const float (&b)[STEREO ? 3 : 2]) {
  if constexpr (STEREO) return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
  return a[0] * b[0] + a[1] * b[1];
}

__device__ __forceinline__ float rho(float c, float thr) {
  return c <= thr ? c : 2.f * sqrtf(thr * fmaxf(c, 0.f)) - thr;
}

// add one observation's weighted normal-equation entries and robust cost
template <bool STEREO>
__device__ __forceinline__ void accumulate(const Eval<STEREO>& e, float inv_s2, float act,
                                           float chi2, float (&g)[32]) {
  float w = e.c2 <= chi2 ? 1.f : sqrtf(chi2 / fmaxf(e.c2, EPS));
  w = w * inv_s2 * act * e.ok;
  int k = 0;
#pragma unroll
  for (int a = 0; a < 6; ++a) {
#pragma unroll
    for (int b = 0; b <= a; ++b) g[k++] += w * dot3<STEREO>(e.J[a], e.J[b]);
  }
#pragma unroll
  for (int a = 0; a < 6; ++a) g[21 + a] += w * dot3<STEREO>(e.J[a], e.r);
  g[27] += rho(e.c2, chi2) * act * e.ok;
}

// one step of the transpose butterfly: lanes with bit OFF set keep the upper
// half of their OFF*2 values, the others the lower half; each adds its
// partner's copy of the half it keeps
template <int OFF>
__device__ __forceinline__ void butterfly_step(float (&v)[32], int lane) {
  const bool up = (lane & OFF) != 0;
#pragma unroll
  for (int k = 0; k < OFF; ++k) {
    const float send = up ? v[k] : v[k + OFF];
    const float keep = up ? v[k + OFF] : v[k];
    v[k] = keep + __shfl_xor_sync(FULL, send, OFF);
  }
}

// the 28 sums of the block: the partial of value l of each of the first nw
// warps (the others hold no observation) lands in part[warp][l]; one barrier
__device__ __forceinline__ void block_reduce(float (&g)[32], float (*part)[NS], int lane,
                                             int warp, int nw) {
  if (warp < nw) {
    butterfly_step<16>(g, lane);
    butterfly_step<8>(g, lane);
    butterfly_step<4>(g, lane);
    butterfly_step<2>(g, lane);
    butterfly_step<1>(g, lane);
    if (lane < NS) part[warp][lane] = g[0];
  }
  __syncthreads();
}

// warp 0: sums[l] = sum of the warp partials of value l, ascending warps
__device__ __forceinline__ void finish_sums(const float (*part)[NS], float* sums, int lane,
                                            int nw) {
  if (lane < NS) {
    float s = 0.f;
    for (int w = 0; w < nw; ++w) s += part[w][lane];
    sums[lane] = s;
  }
  __syncwarp();
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

// thread 0: the damped step from the sums S at pose T -> trial pose
__device__ void lm_trial(const float* S, float lam, const float* T, float* T_try) {
  float h[6][6], rhs[6], dx[6];
  int k = 0;
#pragma unroll
  for (int a = 0; a < 6; ++a) {
#pragma unroll
    for (int b = 0; b <= a; ++b) {
      const float v = S[k++];
      h[a][b] = a == b ? v * (1.f + lam) + 1e-9f : v;
    }
  }
#pragma unroll
  for (int a = 0; a < 6; ++a) rhs[a] = S[21 + a];
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
      T_try[i * 4 + j] = v;
    }
  }
}

// PER > 0: the masked observations, compacted, in registers (N <= THREADS
// * PER); PER == 0: any N, read from device memory on every pass
template <int PER, bool STEREO>
__global__ void __launch_bounds__(THREADS, 1)
pose_lm_kernel(const float* __restrict__ T_init, const float* __restrict__ X,
               const float* __restrict__ obs, const float* __restrict__ sigma2,
               const unsigned char* __restrict__ mask, int N, Cam cam, int rounds, int iters,
               float* __restrict__ T_out, float* __restrict__ c2_out,
               unsigned char* __restrict__ inl_out, long long* __restrict__ n_out) {
  static_assert(PER <= 32, "the active set is a 32-bit mask per thread");
  constexpr bool REG = PER > 0;
  constexpr int SLOTS = REG ? PER : 1;
  constexpr int WARPS = THREADS / 32;
  constexpr int OC = STEREO ? 3 : 2;
  __shared__ int s_idx[THREADS * SLOTS];  // original index of each masked observation
  __shared__ float part[WARPS][NS];
  __shared__ float sums[32];
  __shared__ float s_S[NG];      // normal equations at the accepted pose
  __shared__ float s_T[12];      // accepted pose
  __shared__ float s_try[12];    // trial pose
  __shared__ int s_cnt[WARPS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  {
    const size_t prob = blockIdx.x;
    T_init += prob * 16;
    X += prob * N * 3;
    obs += prob * N * OC;
    sigma2 += prob * N;
    mask += prob * N;
    T_out += prob * 16;
    c2_out += prob * N;
    inl_out += prob * N;
    n_out += prob;
  }
  if (tid < 12) s_T[tid] = T_init[tid];

  int M = N, cnt = 0;
  float x0[SLOTS], x1[SLOTS], x2[SLOTS], ou[SLOTS], ov[SLOTS], our[STEREO ? SLOTS : 1],
      is2[SLOTS];
  unsigned abits = 0u;
  if constexpr (REG) {
    // compact the masked observations, in ascending order: thread t reads
    // the mask over [t*PER, (t+1)*PER) into a bit mask (unrolled, so the
    // loads overlap), a block scan gives its first slot
    const int b0 = tid * PER;
    unsigned mbits = 0u;
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      if (b0 + k < N && mask[b0 + k]) mbits |= 1u << k;
    }
    cnt = __popc(mbits);
    int incl = cnt;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(FULL, incl, off);
      if (lane >= off) incl += y;
    }
    if (lane == 31) s_cnt[warp] = incl;
    __syncthreads();
    int before = 0;
    M = 0;
    for (int w = 0; w < WARPS; ++w) {
      before += w < warp ? s_cnt[w] : 0;
      M += s_cnt[w];
    }
    int pos = before + incl - cnt;
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      if ((mbits >> k) & 1u) s_idx[pos++] = b0 + k;
    }
    __syncthreads();

    // slot s = tid + j * THREADS holds masked observation s_idx[s] for s < M
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      if (j * THREADS >= M) break;  // the same for the whole block
      const int s = tid + j * THREADS;
      const int i = s < M ? s_idx[s] : 0;
      const bool in = s < M;
      x0[j] = in ? X[3 * i] : 0.f;
      x1[j] = in ? X[3 * i + 1] : 0.f;
      x2[j] = in ? X[3 * i + 2] : 0.f;
      ou[j] = in ? obs[OC * i] : 0.f;
      ov[j] = in ? obs[OC * i + 1] : 0.f;
      our[STEREO ? j : 0] = (STEREO && in) ? obs[OC * i + 2 * STEREO] : -1.f;
      is2[j] = in ? 1.f / fmaxf(sigma2[i], 1e-12f) : 0.f;
      if (in) abits |= 1u << j;
    }
  } else {
    for (int i = tid; i < N; i += THREADS) inl_out[i] = mask[i] ? 1 : 0;
    __syncthreads();
  }
  // warps that hold no slot add nothing and skip the reduction
  const int nw = min(WARPS, (M + 31) / 32);

  float cost = 0.f, lam = 1e-3f;  // meaningful in warp 0 only
  for (int round = 0; round < rounds; ++round) {
    // the round's first system at the accepted pose (and, after the first
    // round, the reclassified active set)
    {
      float T[12], g[32];
#pragma unroll
      for (int k = 0; k < 12; ++k) T[k] = s_T[k];
#pragma unroll
      for (int k = 0; k < 32; ++k) g[k] = 0.f;
      if constexpr (REG) {
#pragma unroll
        for (int j = 0; j < PER; ++j) {
          if (j * THREADS >= M) break;
          if (tid + j * THREADS < M) {
            Eval<STEREO> e;
            eval_obs<STEREO>(T, x0[j], x1[j], x2[j], ou[j], ov[j], our[STEREO ? j : 0],
                             is2[j], cam, e);
            if (round > 0) {
              const bool a = e.ok > 0.f && e.c2 < cam.chi2;
              abits = a ? (abits | (1u << j)) : (abits & ~(1u << j));
            }
            if ((abits >> j) & 1u) accumulate<STEREO>(e, is2[j], 1.f, cam.chi2, g);
          }
        }
      } else {
        for (int i = tid; i < N; i += THREADS) {
          if (!mask[i]) continue;
          Eval<STEREO> e;
          const float s2 = 1.f / fmaxf(sigma2[i], 1e-12f);
          eval_obs<STEREO>(T, X[3 * i], X[3 * i + 1], X[3 * i + 2], obs[OC * i],
                           obs[OC * i + 1], STEREO ? obs[OC * i + 2 * STEREO] : -1.f, s2, cam,
                           e);
          bool a = inl_out[i] != 0;
          if (round > 0) {
            a = e.ok > 0.f && e.c2 < cam.chi2;
            inl_out[i] = a ? 1 : 0;
          }
          if (a) accumulate<STEREO>(e, s2, 1.f, cam.chi2, g);
        }
      }
      block_reduce(g, part, lane, warp, nw);
    }
    if (warp == 0) {
      finish_sums(part, sums, lane, nw);
      if (lane < NG) s_S[lane] = sums[lane];
      cost = sums[27];
      lam = 1e-3f;
      __syncwarp();
      if (lane == 0 && iters > 0) lm_trial(s_S, lam, s_T, s_try);
    }
    __syncthreads();

    for (int it = 0; it < iters; ++it) {
      {
        float Tt[12], g[32];
#pragma unroll
        for (int k = 0; k < 12; ++k) Tt[k] = s_try[k];
#pragma unroll
        for (int k = 0; k < 32; ++k) g[k] = 0.f;
        if constexpr (REG) {
#pragma unroll
          for (int j = 0; j < PER; ++j) {
            if (j * THREADS >= M) break;
            if (tid + j * THREADS < M && ((abits >> j) & 1u)) {
              Eval<STEREO> e;
              eval_obs<STEREO>(Tt, x0[j], x1[j], x2[j], ou[j], ov[j], our[STEREO ? j : 0],
                               is2[j], cam, e);
              accumulate<STEREO>(e, is2[j], 1.f, cam.chi2, g);
            }
          }
        } else {
          for (int i = tid; i < N; i += THREADS) {
            if (!inl_out[i]) continue;
            Eval<STEREO> e;
            const float s2 = 1.f / fmaxf(sigma2[i], 1e-12f);
            eval_obs<STEREO>(Tt, X[3 * i], X[3 * i + 1], X[3 * i + 2], obs[OC * i],
                             obs[OC * i + 1], STEREO ? obs[OC * i + 2 * STEREO] : -1.f, s2,
                             cam, e);
            accumulate<STEREO>(e, s2, 1.f, cam.chi2, g);
          }
        }
        block_reduce(g, part, lane, warp, nw);
      }
      if (warp == 0) {
        finish_sums(part, sums, lane, nw);
        const float cost_try = sums[27];
        float tsum = s_try[0];
#pragma unroll
        for (int k = 1; k < 12; ++k) tsum = tsum + s_try[k];
        const bool acc = (cost_try < cost) && isfinite(tsum);
        if (acc) {
          if (lane < NG) s_S[lane] = sums[lane];
          if (lane < 12) s_T[lane] = s_try[lane];
          cost = cost_try;
        }
        lam = fminf(fmaxf(acc ? lam * 0.5f : lam * 4.f, 1e-9f), 1e6f);
        __syncwarp();
        if (lane == 0 && it + 1 < iters) lm_trial(s_S, lam, s_T, s_try);
      }
      __syncthreads();
    }
  }

  // final pass over all N in their own order (read once more from device
  // memory): chi2 and the inlier mask at the final pose, their count, pose
  float T[12];
#pragma unroll
  for (int k = 0; k < 12; ++k) T[k] = s_T[k];
  cnt = 0;
  for (int i = tid; i < N; i += THREADS) {
    Eval<STEREO> e;
    eval_obs<STEREO>(T, X[3 * i], X[3 * i + 1], X[3 * i + 2], obs[OC * i], obs[OC * i + 1],
                     STEREO ? obs[OC * i + 2 * STEREO] : -1.f,
                     1.f / fmaxf(sigma2[i], 1e-12f), cam, e);
    bool a = mask[i] != 0;
    if (rounds > 0) a = a && e.ok > 0.f && e.c2 < cam.chi2;
    c2_out[i] = e.c2;
    inl_out[i] = a ? 1 : 0;
    cnt += a ? 1 : 0;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) cnt += __shfl_xor_sync(FULL, cnt, off);
  if (lane == 0) s_cnt[warp] = cnt;
  __syncthreads();
  if (tid == 0) {
    long long n = 0;
    for (int w = 0; w < WARPS; ++w) n += s_cnt[w];
    *n_out = n;
  }
  if (tid < 16) T_out[tid] = tid < 12 ? T[tid] : (tid == 15 ? 1.f : 0.f);
}

}  // namespace

// B pose problems of one shape, each laid out after the one before it:
// T_init (B,4,4) f32, X (B,N,3), obs (B,N,obs_cols) with obs_cols 2 (mono)
// or 3 (u_right < 0 marks a mono observation), sigma2 (B,N) f32, mask (B,N)
// bool.  Writes T_out (B,4,4), c2_out (B,N), inl_out (B,N) bool and n_out
// (B int64).  Returns a cudaError_t.
extern "C" int pose_lm(int B, const float* T_init, const float* X, const float* obs,
                       int obs_cols, const float* sigma2, const unsigned char* mask, int N,
                       float fx, float fy, float cx, float cy, float fxb, float chi2, int rounds,
                       int iters, float* T_out, float* c2_out, unsigned char* inl_out,
                       long long* n_out, void* stream) {
  if (B < 0 || N < 0 || (obs_cols != 2 && obs_cols != 3))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return static_cast<int>(cudaGetLastError());
  const bool regs = N <= THREADS * (obs_cols == 3 ? PER_STEREO : PER_MONO);
  const auto fn = obs_cols == 3
                      ? (regs ? pose_lm_kernel<PER_STEREO, true> : pose_lm_kernel<0, true>)
                      : (regs ? pose_lm_kernel<PER_MONO, false> : pose_lm_kernel<0, false>);
  const Cam cam{fx, fy, cx, cy, fxb, chi2};
  fn<<<B, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      T_init, X, obs, sigma2, mask, N, cam, rounds, iters, T_out, c2_out, inl_out, n_out);
  return static_cast<int>(cudaGetLastError());
}
