"""Pose-only Levenberg-Marquardt, the whole 4 x 10 schedule in one call
(counterpart of ``openvslam_tpu/ops/pallas/pose_lm_kernel.py``).

CUDA tensors go to kernel K3 (``csrc/pose_lm.cu``): one thread block per
pose problem, every iteration inside the kernel, one pass and one block
reduction per iteration, the observations held in registers up to 4096
mono / 3072 stereo rows and read from device memory on each pass above.  The kernel
reads the caller's tensors as they are (2- or 3-column observations,
sigma2, a bool mask) and writes the 4x4 pose, the inlier mask and count
and chi2 itself, so a call is one launch.  CPU tensors go to the plain
version below, ``_lm_schedule``, which is the JAX kernel body
(``pose_lm_xla_reference``) written out in PyTorch: analytic Jacobians of
the left increment, Huber at ``chi2_thr``, the 8x8 augmented normal matrix,
a damped 6x6 Cholesky, the SE(3) exp, accept only when the cost drops and
the pose is finite, lambda 1e-3 halved on accept and quadrupled on reject
(clipped to [1e-9, 1e6]), inliers reclassified between rounds.

Observations are (u, v) or (u, v, u_right) with u_right < 0 for a mono
observation.  The kernel sums in another order than the plain version, so
the two agree to float32 rounding over 40 iterations, not bit for bit.
"""
from __future__ import annotations

import torch

from .. import kernels

_EPS = 1e-9


def _cholesky_solve6(h, g):
    """Solve H x = g for SPD 6x6 given as h[(i,j)] (i >= j) and g[i]."""
    L = {}
    for j in range(6):
        s = h[(j, j)]
        for k in range(j):
            s = s - L[(j, k)] * L[(j, k)]
        d = torch.sqrt(torch.clamp(s, min=1e-12))
        L[(j, j)] = d
        for i in range(j + 1, 6):
            s = h[(i, j)]
            for k in range(j):
                s = s - L[(i, k)] * L[(j, k)]
            L[(i, j)] = s / d
    y = [None] * 6
    for i in range(6):
        s = g[i]
        for k in range(i):
            s = s - L[(i, k)] * y[k]
        y[i] = s / L[(i, i)]
    x = [None] * 6
    for i in reversed(range(6)):
        s = y[i]
        for k in range(i + 1, 6):
            s = s - L[(k, i)] * x[k]
        x[i] = s / L[(i, i)]
    return x


def _se3_exp_scalars(w0, w1, w2, u0, u1, u2):
    """exp of twist (omega, upsilon) -> (R 3x3, t 3) as scalar tensors."""
    th2 = w0 * w0 + w1 * w1 + w2 * w2
    th = torch.sqrt(torch.clamp(th2, min=_EPS * _EPS))
    small = th2 < _EPS
    a = torch.where(small, 1.0 - th2 / 6.0, torch.sin(th) / th)
    b = torch.where(small, 0.5 - th2 / 24.0, (1.0 - torch.cos(th)) / th2)
    c = torch.where(small, 1.0 / 6.0 - th2 / 120.0, (th - torch.sin(th)) / (th2 * th))
    zero = torch.zeros_like(w0)
    W = [[zero, -w2, w1], [w2, zero, -w0], [-w1, w0, zero]]
    W2 = [[sum(W[i][k] * W[k][j] for k in range(3)) for j in range(3)] for i in range(3)]
    R = [[(1.0 if i == j else 0.0) + a * W[i][j] + b * W2[i][j] for j in range(3)]
         for i in range(3)]
    V = [[(1.0 if i == j else 0.0) + b * W[i][j] + c * W2[i][j] for j in range(3)]
         for i in range(3)]
    u = (u0, u1, u2)
    t = [sum(V[i][k] * u[k] for k in range(3)) for i in range(3)]
    return R, t


def _lm_schedule(X0, X1, X2, ou, ov, our, inv_s2, mask_f, T0,
                 fx, fy, cx, cy, fxb, chi2_thr, num_rounds, iters_per_round):
    """The full LM schedule over (N,) observation vectors; T0 is a tuple of
    12 scalar tensors (rows of the 3x4 cam<-world transform).
    Returns (T 12-tuple, c2 (N,), ok (N,) f32, active (N,) f32)."""
    f32 = torch.float32
    ur_obs = (our >= 0.0).to(f32)
    zeros = torch.zeros_like(X0)

    def rho(c):
        return torch.where(c <= chi2_thr, c,
                           2.0 * torch.sqrt(chi2_thr * torch.clamp(c, min=0.0)) - chi2_thr)

    def eval_at(T):
        r00, r01, r02, t0, r10, r11, r12, t1, r20, r21, r22, t2 = T
        px = r00 * X0 + r01 * X1 + r02 * X2 + t0
        py = r10 * X0 + r11 * X1 + r12 * X2 + t1
        pz = r20 * X0 + r21 * X1 + r22 * X2 + t2
        ok = (pz > _EPS).to(f32)
        zs = torch.where(pz > _EPS, pz, torch.ones_like(pz))
        iz = 1.0 / zs
        iz2 = iz * iz
        u = fx * px * iz + cx
        v = fy * py * iz + cy
        ur = u - fxb * iz
        ru = (ou - u) * ok
        rv = (ov - v) * ok
        rur = (our - ur) * ok * ur_obs
        c2 = (ru * ru + rv * rv + rur * rur) * inv_s2
        cpx = -fx * px * iz2
        epy = -fy * py * iz2
        q = fxb * iz2
        Ju = (fx * px * py * iz2, -(fx + fx * px * px * iz2), fx * py * iz,
              -fx * iz, zeros, -cpx)
        Jv = (fy + fy * py * py * iz2, -fy * px * py * iz2, -fy * px * iz,
              zeros, -fy * iz, -epy)
        cq = cpx + q
        Jur = (-py * cq, -(fx + fx * px * px * iz2) + px * q, fx * py * iz,
               -fx * iz, zeros, -cq)
        J = tuple((Ju[i] * ok, Jv[i] * ok, Jur[i] * ok * ur_obs) for i in range(6))
        return J, (ru, rv, rur), ok, c2

    def iter_step(state, active):
        T, J, r, ok, c2, cost, lam = state
        w = torch.where(c2 <= chi2_thr, torch.ones_like(c2),
                        torch.sqrt(chi2_thr / torch.clamp(c2, min=_EPS)))
        w = w * inv_s2 * active * ok
        wcat = torch.cat([w, w, w])
        rows = [torch.cat(J[i]) for i in range(6)]
        rows.append(torch.cat(r))
        rows.append(torch.zeros_like(rows[0]))
        A = torch.stack(rows)                                  # (8, 3N)
        G = (A * wcat) @ A.T                                   # (8, 8)
        h = {}
        for i in range(6):
            for j in range(i + 1):
                v = G[i, j]
                h[(i, j)] = v * (1.0 + lam) + 1e-9 if i == j else v
        dx = _cholesky_solve6(h, [G[i, 6] for i in range(6)])
        R, t = _se3_exp_scalars(*[-d for d in dx])
        Tm = (T[0:4], T[4:8], T[8:12])
        T_try = tuple(sum(R[i][k] * Tm[k][j] for k in range(3)) + (t[i] if j == 3 else 0.0)
                      for i in range(3) for j in range(4))
        J2, r2, ok2, c2n = eval_at(T_try)
        cost_try = torch.sum(rho(c2n) * active * ok2)
        acc = (cost_try < cost) & torch.isfinite(sum(T_try))

        def sel(new, old):
            return torch.where(acc, new, old)

        return (tuple(sel(n, o) for n, o in zip(T_try, T)),
                tuple(tuple(sel(n, o) for n, o in zip(Jn, Jo)) for Jn, Jo in zip(J2, J)),
                tuple(sel(n, o) for n, o in zip(r2, r)),
                sel(ok2, ok), sel(c2n, c2), sel(cost_try, cost),
                torch.clamp(torch.where(acc, lam * 0.5, lam * 4.0), 1e-9, 1e6))

    J, r, ok, c2 = eval_at(T0)
    T = T0
    active = mask_f
    for _ in range(num_rounds):
        cost0 = torch.sum(rho(c2) * active * ok)
        state = (T, J, r, ok, c2, cost0, X0.new_full((), 1e-3))
        for _ in range(iters_per_round):
            state = iter_step(state, active)
        T, J, r, ok, c2, _, _ = state
        active = mask_f * ok * (c2 < chi2_thr).to(f32)
    return T, c2, ok, active


def _operands(T_init, X_w, obs_uvr, sigma2, mask):
    """The plain version's operands: float32, a -1 u_right column for 2-column
    observations, 1 / max(sigma2, 1e-12) and a float mask."""
    f32 = torch.float32
    N = X_w.shape[0]
    dev = X_w.device
    obs = obs_uvr.to(f32)
    if obs.shape[1] == 2:
        obs = torch.cat([obs, torch.full((N, 1), -1.0, dtype=f32, device=dev)], 1)
    inv_s2 = 1.0 / torch.clamp(sigma2.to(f32), min=1e-12)
    return (T_init[:3, :].reshape(12).to(f32), X_w.to(f32), obs, inv_s2, mask.to(f32))


def _result(T12, active, c2):
    T = torch.zeros((4, 4), dtype=T12.dtype, device=T12.device)
    T[:3] = T12.reshape(3, 4)
    T[3, 3] = 1.0
    inl = active > 0.5
    return T, inl, inl.to(torch.int32).sum(), c2


def pose_lm_plain(T_init, X_w, obs_uvr, sigma2, mask, *, fx, fy, cx, cy, fxb,
                  chi2_thr, num_rounds=4, iters_per_round=10):
    """Plain version of K3.  Returns (T_cw (4,4), inliers (N,) bool,
    num_inliers (), chi2 (N,))."""
    T12, X, obs, inv_s2, mask_f = _operands(T_init, X_w, obs_uvr, sigma2, mask)
    T, c2, _, active = _lm_schedule(
        X[:, 0], X[:, 1], X[:, 2], obs[:, 0], obs[:, 1], obs[:, 2], inv_s2, mask_f,
        tuple(T12[k] for k in range(12)), float(fx), float(fy), float(cx), float(cy),
        float(fxb), float(chi2_thr), num_rounds, iters_per_round)
    return _result(torch.stack(T), active, c2)


def kernel_args(T_init, X_w, obs_uvr, sigma2, mask, *, fx, fy, cx, cy, fxb, chi2_thr,
                num_rounds=4, iters_per_round=10):
    """Check the operands of one K3 launch and allocate its outputs.  Returns
    (ctypes arguments of ``pose_lm`` in csrc/pose_lm.cu, (T_cw, inliers,
    num_inliers, chi2), tensors to keep alive); the arguments hold pointers
    into the given tensors and the outputs, which must outlive the launch."""
    dev = X_w.device
    N = X_w.shape[0]
    f32 = torch.float32
    ok = (T_init.shape == (4, 4) and X_w.shape == (N, 3) and obs_uvr.ndim == 2
          and obs_uvr.shape[0] == N and obs_uvr.shape[1] in (2, 3)
          and sigma2.shape == (N,) and mask.shape == (N,))
    if not ok:
        raise ValueError("pose_lm: expected T (4,4), X (N,3), obs (N,2|3), sigma2 (N,), mask (N,)")
    for name, t, dt in (("T_init", T_init, f32), ("X_w", X_w, f32), ("obs", obs_uvr, f32),
                        ("sigma2", sigma2, f32), ("mask", mask, torch.bool)):
        if t.device != dev or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"pose_lm: {name} must be a contiguous {dt} tensor on {dev}")
    T = torch.empty((4, 4), dtype=f32, device=dev)
    c2 = torch.empty(N, dtype=f32, device=dev)
    inl = torch.empty(N, dtype=torch.bool, device=dev)
    n = torch.empty((), dtype=torch.int64, device=dev)
    args = (T_init.data_ptr(), X_w.data_ptr(), obs_uvr.data_ptr(), obs_uvr.shape[1],
            sigma2.data_ptr(), mask.data_ptr(), N, float(fx), float(fy), float(cx),
            float(cy), float(fxb), float(chi2_thr), int(num_rounds), int(iters_per_round),
            T.data_ptr(), c2.data_ptr(), inl.data_ptr(), n.data_ptr(), kernels.stream_ptr(dev))
    return args, (T, inl, n, c2), [T_init, X_w, obs_uvr, sigma2, mask]


def pose_lm(T_init, X_w, obs_uvr, sigma2, mask, *, fx, fy, cx, cy, fxb,
            chi2_thr, num_rounds=4, iters_per_round=10):
    """Fused pose-only LM.  T_init (4,4), X_w (N,3), obs_uvr (N,2|3),
    sigma2 (N,), mask (N,) bool.  CPU tensors take the plain version, CUDA
    tensors launch kernel K3 (float32 contiguous operands, any N).
    Returns (T_cw, inliers, num_inliers, chi2)."""
    dev = X_w.device
    kw = dict(fx=fx, fy=fy, cx=cx, cy=cy, fxb=fxb, chi2_thr=chi2_thr,
              num_rounds=num_rounds, iters_per_round=iters_per_round)
    if dev.type == "cpu":
        return pose_lm_plain(T_init, X_w, obs_uvr, sigma2, mask, **kw)
    if dev.type != "cuda":
        raise RuntimeError(f"pose_lm: unsupported device {dev}")
    args, out, _keep = kernel_args(T_init, X_w, obs_uvr, sigma2, mask, **kw)
    kernels.check(kernels.library("pose_lm")(*args), "pose_lm")
    kernels.count_launch("pose_lm")
    return out
