"""Minimal solvers (counterpart of ``openvslam_tpu/ops/solvers.py``; ref
``solve/``): fundamental, homography and essential matrices with their
decompositions, PnP on bearings (DLT and EPnP) and the Sim3 closed form.

Every function takes leading batch dimensions, so a RANSAC round fits and
scores all its hypotheses in one call (``ops/ransac.py``).  Conventions:

* 2D keypoints are undistorted pixel coordinates (..., k, 2).
* bearings are unit 3-vectors in the camera frame (..., k, 3).
* Poses map world->camera: x_cam = R x_w + t.

Null vectors come from ``eigh`` of A^T A in float64 and the decompositions
from an SVD; both leave a sign free, and every consumer here is invariant
to it (F and H are used up to sign, E's four and H's eight hypotheses form
the same set whatever the signs) or fixes it (EPnP's eigenvectors).  Solves
use the ``_ex`` forms, which do not read their status back to the host.
"""
from __future__ import annotations

import math

import torch

_EPS = 1e-9


def _eye3(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device)


def hartley_normalize(pts: torch.Tensor, mask: torch.Tensor):
    """Isotropic normalization of (...,N,2) points -> (T (...,3,3), pts_n)."""
    w = mask.to(pts.dtype)
    n = torch.clamp(w.sum(-1), min=1.0)
    mean = (pts * w[..., None]).sum(-2) / n[..., None]
    d = torch.sqrt(((pts - mean[..., None, :]) ** 2).sum(-1))
    mean_d = (d * w).sum(-1) / n
    s = math.sqrt(2.0) / torch.clamp(mean_d, min=_EPS)
    T = torch.zeros(pts.shape[:-2] + (3, 3), dtype=pts.dtype, device=pts.device)
    T[..., 0, 0] = s
    T[..., 1, 1] = s
    T[..., 0, 2] = -s * mean[..., 0]
    T[..., 1, 2] = -s * mean[..., 1]
    T[..., 2, 2] = 1.0
    return T, (pts - mean[..., None, :]) * s[..., None, None]


def _smallest_right_singular(A: torch.Tensor) -> torch.Tensor:
    """Right singular vector of the smallest singular value of (...,m,n) A,
    from ``eigh`` of A^T A (n <= 9), formed and solved in float64: in
    float32 the squared conditioning of a near-planar 8-point sample costs
    about three digits of F, and CPU and GPU eigensolvers then disagree
    in the pose."""
    A64 = A.to(torch.float64)
    _, V = torch.linalg.eigh(A64.transpose(-1, -2) @ A64)
    return V[..., 0].to(A.dtype)


def _svd(A: torch.Tensor):
    """SVD with each singular pair's sign fixed (the largest-magnitude entry
    of each right singular vector positive), so that the decompositions list
    their hypotheses in the same order on every backend."""
    U, S, Vt = torch.linalg.svd(A)
    idx = torch.argmax(torch.abs(Vt), dim=-1, keepdim=True)
    sgn = torch.where(torch.gather(Vt, -1, idx) < 0, -1.0, 1.0).to(A.dtype)
    return U * sgn.transpose(-1, -2), S, Vt * sgn


def _normalize_pair(p1, p2):
    ones = torch.ones(p1.shape[:-1], dtype=torch.bool, device=p1.device)
    T1, p1n = hartley_normalize(p1, ones)
    T2, p2n = hartley_normalize(p2, ones)
    return T1, T2, p1n[..., 0], p1n[..., 1], p2n[..., 0], p2n[..., 1]


def _homogeneous(p):
    return torch.cat([p, torch.ones_like(p[..., :1])], -1)


# ---------------------------------------------------------------------------
# fundamental matrix (normalized 8-point) — ref solve/fundamental_solver
# ---------------------------------------------------------------------------

def fit_fundamental(p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """8-point F from (...,k,2)+(...,k,2) undistorted pixels; (...,3,3), rank 2."""
    T1, T2, x1, y1, x2, y2 = _normalize_pair(p1, p2)
    one = torch.ones_like(x1)
    A = torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, one], -1)
    F = _smallest_right_singular(A).reshape(A.shape[:-2] + (3, 3))
    U, S, Vt = torch.linalg.svd(F)
    S = torch.cat([S[..., :2], torch.zeros_like(S[..., 2:])], -1)
    F = (U * S[..., None, :]) @ Vt
    return T2.transpose(-1, -2) @ F @ T1


def score_fundamental(F, p1, p2, mask, sigma: float = 1.0):
    """ORB-SLAM-style chi2 score: sum over inliers of (thr - chi2), both
    directions.  F (...,3,3) against N pairs -> (score (...), inliers (...,N))."""
    h1, h2 = _homogeneous(p1), _homogeneous(p2)
    Fx1 = h1 @ F.transpose(-1, -2)       # epipolar lines in image 2
    Ftx2 = h2 @ F                        # epipolar lines in image 1
    num = (h2 * Fx1).sum(-1)
    d2_2 = num**2 / torch.clamp(Fx1[..., 0] ** 2 + Fx1[..., 1] ** 2, min=_EPS)
    d2_1 = num**2 / torch.clamp(Ftx2[..., 0] ** 2 + Ftx2[..., 1] ** 2, min=_EPS)
    inv_s2 = 1.0 / (sigma * sigma)
    chi1 = d2_1 * inv_s2
    chi2_ = d2_2 * inv_s2
    thr, thr_score = 3.841, 5.991
    ok = (chi1 < thr) & (chi2_ < thr) & mask
    score = torch.where(ok, (thr_score - chi1) + (thr_score - chi2_), torch.zeros_like(chi1))
    return score.sum(-1), ok


# ---------------------------------------------------------------------------
# homography (normalized DLT) — ref solve/homography_solver
# ---------------------------------------------------------------------------

def _safe(x):
    return torch.where(torch.abs(x) < _EPS, torch.full_like(x, _EPS), x)


def fit_homography(p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """DLT H (p2 ~ H p1) from (...,k,2)+(...,k,2), k >= 4; H[2,2] = 1."""
    T1, T2, x1, y1, x2, y2 = _normalize_pair(p1, p2)
    zero, one = torch.zeros_like(x1), torch.ones_like(x1)
    r1 = torch.stack([zero, zero, zero, -x1, -y1, -one, y2 * x1, y2 * y1, y2], -1)
    r2 = torch.stack([x1, y1, one, zero, zero, zero, -x2 * x1, -x2 * y1, -x2], -1)
    H = _smallest_right_singular(torch.cat([r1, r2], -2)).reshape(r1.shape[:-2] + (3, 3))
    Hn = torch.linalg.solve_ex(T2, H @ T1).result
    return Hn / _safe(Hn[..., 2:, 2:])


def score_homography(H, p1, p2, mask, sigma: float = 1.0):
    """Symmetric transfer chi2 score of H (...,3,3) over N pairs."""
    h1, h2 = _homogeneous(p1), _homogeneous(p2)
    Hp1 = h1 @ H.transpose(-1, -2)
    Hp1 = Hp1[..., :2] / _safe(Hp1[..., 2:])
    Hinv = torch.linalg.inv_ex(H).inverse
    Hp2 = h2 @ Hinv.transpose(-1, -2)
    Hp2 = Hp2[..., :2] / _safe(Hp2[..., 2:])
    inv_s2 = 1.0 / (sigma * sigma)
    chi12 = ((p2 - Hp1) ** 2).sum(-1) * inv_s2
    chi21 = ((p1 - Hp2) ** 2).sum(-1) * inv_s2
    thr = 5.991
    ok = (chi12 < thr) & (chi21 < thr) & mask
    score = torch.where(ok, (thr - chi12) + (thr - chi21), torch.zeros_like(chi12))
    return score.sum(-1), ok


# ---------------------------------------------------------------------------
# essential matrix on bearings — ref solve/essential_solver
# ---------------------------------------------------------------------------

def fit_essential(b1: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """8-point E from unit bearings (...,k,3)+(...,k,3): b2^T E b1 = 0."""
    x1, y1, z1 = b1[..., 0], b1[..., 1], b1[..., 2]
    x2, y2, z2 = b2[..., 0], b2[..., 1], b2[..., 2]
    A = torch.stack([x2 * x1, x2 * y1, x2 * z1, y2 * x1, y2 * y1, y2 * z1,
                     z2 * x1, z2 * y1, z2 * z1], -1)
    E = _smallest_right_singular(A).reshape(A.shape[:-2] + (3, 3))
    U, S, Vt = torch.linalg.svd(E)
    s = (S[..., 0] + S[..., 1]) * 0.5
    S = torch.stack([s, s, torch.zeros_like(s)], -1)
    return (U * S[..., None, :]) @ Vt


def score_essential(E, b1, b2, mask, thr: float = 1e-3):
    """Angular epipolar residual on the unit sphere (both directions)."""
    Eb1 = b1 @ E.transpose(-1, -2)
    Etb2 = b2 @ E
    n1 = Eb1 / torch.clamp(torch.linalg.norm(Eb1, dim=-1, keepdim=True), min=_EPS)
    n2 = Etb2 / torch.clamp(torch.linalg.norm(Etb2, dim=-1, keepdim=True), min=_EPS)
    r1 = (b2 * n1).sum(-1) ** 2
    r2 = (b1 * n2).sum(-1) ** 2
    ok = (r1 < thr) & (r2 < thr) & mask
    score = torch.where(ok, (thr - r1) + (thr - r2), torch.zeros_like(r1))
    return score.sum(-1), ok


def decompose_essential(E: torch.Tensor):
    """E (3,3) -> 4 hypotheses (R (4,3,3), t (4,3)), t unit norm."""
    U, _, Vt = _svd(E)
    U = U * torch.sign(torch.linalg.det(U))
    Vt = Vt * torch.sign(torch.linalg.det(Vt))
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     dtype=E.dtype, device=E.device)
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    t = U[:, 2]
    t = t / torch.clamp(torch.linalg.norm(t), min=_EPS)
    return torch.stack([R1, R1, R2, R2]), torch.stack([t, -t, t, -t])


def essential_from_F(F: torch.Tensor, K1: torch.Tensor, K2: torch.Tensor) -> torch.Tensor:
    return K2.T @ F @ K1


# ---------------------------------------------------------------------------
# homography decomposition (Faugeras) — ref initialize/perspective
# ---------------------------------------------------------------------------

def decompose_homography(H: torch.Tensor, K: torch.Tensor):
    """Faugeras decomposition of H (3,3) (image-to-image, same K both views).

    Returns (R (8,3,3), t (8,3), n (8,3)) candidate motions.  Degenerate
    branches produce harmless duplicates; cheirality selection downstream
    picks the physical one.
    """
    A = torch.linalg.solve_ex(K, H @ K).result
    U, S, Vt = _svd(A)
    V = Vt.T
    s = torch.linalg.det(U) * torch.linalg.det(V)
    d1, d2, d3 = S[0], S[1], S[2]
    den = torch.clamp(d1 * d1 - d3 * d3, min=_EPS)
    x1 = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) / den, min=0.0))
    x3 = torch.sqrt(torch.clamp((d2 * d2 - d3 * d3) / den, min=0.0))
    zero, one = torch.zeros_like(d1), torch.ones_like(d1)

    def motion(Rp, tp, np_):
        return s * U @ Rp @ Vt, U @ tp, V @ np_

    Rs, ts, ns = [], [], []
    signs = ((1.0, 1.0), (-1.0, 1.0), (1.0, -1.0), (-1.0, -1.0))
    # case d' = +d2: rotation about y by theta
    for e1, e3 in signs:
        sin_t = (d1 - d3) * x1 * x3 / torch.clamp(d2, min=_EPS) * e1 * e3
        cos_t = (d2 * d2 + d1 * d3) / torch.clamp(d2 * (d1 + d3), min=_EPS)
        Rp = torch.stack([torch.stack([cos_t, zero, -sin_t]), torch.stack([zero, one, zero]),
                          torch.stack([sin_t, zero, cos_t])])
        tp = (d1 - d3) * torch.stack([e1 * x1, zero, -e3 * x3])
        R, t, n = motion(Rp, tp, torch.stack([e1 * x1, zero, e3 * x3]))
        Rs.append(R), ts.append(t), ns.append(n)
    # case d' = -d2
    for e1, e3 in signs:
        sin_p = (d1 + d3) * x1 * x3 / torch.clamp(d2, min=_EPS) * e1 * e3
        cos_p = (d1 * d3 - d2 * d2) / torch.clamp(d2 * (d1 - d3), min=_EPS)
        Rp = torch.stack([torch.stack([cos_p, zero, sin_p]), torch.stack([zero, -one, zero]),
                          torch.stack([sin_p, zero, -cos_p])])
        tp = (d1 + d3) * torch.stack([e1 * x1, zero, e3 * x3])
        R, t, n = motion(Rp, tp, torch.stack([e1 * x1, zero, e3 * x3]))
        Rs.append(R), ts.append(t), ns.append(n)
    ts = torch.stack(ts)
    ts = ts / torch.clamp(torch.linalg.norm(ts, dim=-1, keepdim=True), min=_EPS)
    return torch.stack(Rs), ts, torch.stack(ns)


# ---------------------------------------------------------------------------
# PnP on bearings — ref solve/pnp_solver
# ---------------------------------------------------------------------------

def _pose(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    T = torch.zeros(R.shape[:-2] + (4, 4), dtype=R.dtype, device=R.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    T[..., 3, 3] = 1.0
    return T


def _hat(b: torch.Tensor) -> torch.Tensor:
    x, y, z = b[..., 0], b[..., 1], b[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack([torch.stack([zero, -z, y], -1), torch.stack([z, zero, -x], -1),
                        torch.stack([-y, x, zero], -1)], -2)


def _det_fix(U: torch.Tensor, Vt: torch.Tensor) -> torch.Tensor:
    """diag(1, 1, det(U Vt)) as a (...,3) vector: the proper-rotation fix."""
    d = torch.linalg.det(U @ Vt)
    return torch.stack([torch.ones_like(d), torch.ones_like(d), d], -1)


def fit_pnp_dlt(bearings: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Linear PnP from k >= 6 (bearing, world point) pairs -> T_cw (...,4,4).

    lambda b = R X + t  =>  hat(b) (R X + t) = 0: three rows per point.  The
    12 entries of [R|t] are the null vector (float64), the sign is fixed by
    cheirality, R is projected onto SO(3) and the scale taken from |R|."""
    k = bearings.shape[-2]
    X_h = torch.cat([points, torch.ones_like(points[..., :1])], -1)
    A = torch.einsum("...kab,...kc->...kabc", _hat(bearings), X_h).reshape(
        bearings.shape[:-2] + (3 * k, 12))
    Rt = _smallest_right_singular(A).reshape(A.shape[:-2] + (3, 4))
    Rraw, t_raw = Rt[..., :3], Rt[..., 3]
    lam = (bearings * (points @ Rraw.transpose(-1, -2) + t_raw[..., None, :])).sum(-1)
    sgn = torch.where(torch.sign(lam).sum(-1) < 0, -1.0, 1.0).to(Rraw.dtype)
    Rraw = sgn[..., None, None] * Rraw
    t_raw = sgn[..., None] * t_raw
    U, S, Vt = torch.linalg.svd(Rraw)
    R = (U * _det_fix(U, Vt)[..., None, :]) @ Vt
    return _pose(R, t_raw / torch.clamp(S.mean(-1), min=_EPS)[..., None])


def _eigh64(A: torch.Tensor):
    """Symmetric eigendecomposition in float64 with each eigenvector's sign
    fixed (its largest-magnitude entry positive); ascending eigenvalues."""
    w, V = torch.linalg.eigh(A.to(torch.float64))
    idx = torch.argmax(torch.abs(V), dim=-2, keepdim=True)
    sgn = torch.where(torch.gather(V, -2, idx) < 0, -1.0, 1.0).to(V.dtype)
    return w.to(A.dtype), (V * sgn).to(A.dtype)


def _null_basis(M: torch.Tensor, n: int) -> torch.Tensor:
    """(...,m,c) -> (...,c,n): the n smallest right singular vectors of M
    (eigh of M^T M in float64), in ascending order with their signs fixed,
    as EPnP's beta initializations expect.  Where all n are exactly null (a
    minimal set: eigenvalues within 1e-9 of the largest), the eigensolver's
    basis of that span is arbitrary and differs between backends and batch
    sizes; there the basis is a continuous function of the span instead:
    the QR (diagonal of R positive) of the projections onto it of the
    control points' depth axes (columns 2, 5, 8, 11), which start EPnP's
    Gauss-Newton better than the projector's first columns do (minimal
    sets of tests/test_solvers.py's scene: 75 % solved against 58 %)."""
    M64 = M.to(torch.float64)
    w, V = torch.linalg.eigh(M64.transpose(-1, -2) @ M64)
    Vn = V[..., :n]
    idx = torch.argmax(torch.abs(Vn), dim=-2, keepdim=True)
    ordered = Vn * torch.where(torch.gather(Vn, -2, idx) < 0, -1.0, 1.0).to(Vn.dtype)
    Q, R = torch.linalg.qr((Vn @ Vn.transpose(-1, -2))[..., 2::3])
    sgn = torch.where(torch.diagonal(R, dim1=-2, dim2=-1) < 0, -1.0, 1.0).to(Q.dtype)
    degenerate = w[..., n - 1] <= 1e-9 * w[..., -1]
    return torch.where(degenerate[..., None, None], Q * sgn[..., None, :], ordered).to(M.dtype)


_IU, _JU = (0, 0, 0, 1, 1, 2), (1, 2, 3, 2, 3, 3)   # upper-triangle pairs of 4


def _solve_sym(L: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    n = L.shape[-1]
    Lt = L.transpose(-1, -2)
    LtL = Lt @ L + 1e-9 * torch.eye(n, dtype=L.dtype, device=L.device)
    return torch.linalg.solve_ex(LtL, (Lt @ rhs[..., None])).result[..., 0]


def fit_pnp_epnp(bearings: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """EPnP on bearings from k >= 4 pairs -> T_cw (...,4,4) (ref
    solve/pnp_solver, adapted to bearing vectors).

    Four control points (centroid and PCA axes), barycentric alphas, the
    4-dimensional null space of the 3k x 12 bearing-cross system
    (``_null_basis``), the three classic beta initializations each refined by 10 Gauss-Newton steps on the six control-point distances
    and tried with both null-space signs, Kabsch alignment, and the pose
    with the least bearing error wins.  Degenerate sets give a pose that
    scores no inliers (non-finite where the Gauss-Newton diverged, as in
    the JAX package)."""
    dt, dev = points.dtype, points.device
    k = points.shape[-2]
    c0 = points.mean(-2)
    Xc = points - c0[..., None, :]
    cov = Xc.transpose(-1, -2) @ Xc / k
    evals, evecs = _eigh64(cov)
    axes = (evecs * torch.sqrt(torch.clamp(evals, min=1e-8))[..., None, :]).transpose(-1, -2)
    ctrl_w = torch.cat([c0[..., None, :], c0[..., None, :] + axes], -2)           # (...,4,3)
    eye3 = torch.eye(3, dtype=dt, device=dev)
    Ainv = torch.linalg.inv_ex(axes.transpose(-1, -2) + 1e-12 * eye3).inverse
    a123 = Xc @ Ainv.transpose(-1, -2)
    alphas = torch.cat([1.0 - a123.sum(-1, keepdim=True), a123], -1)               # (...,k,4)
    M = torch.einsum("...kab,...kj->...kajb", _hat(bearings), alphas).reshape(
        points.shape[:-2] + (3 * k, 12))
    V = _null_basis(M, 4).transpose(-1, -2).reshape(points.shape[:-2] + (4, 4, 3))  # (null, ctrl, 3)

    iu, ju = list(_IU), list(_JU)
    d2_w = ((ctrl_w[..., iu, :] - ctrl_w[..., ju, :]) ** 2).sum(-1)               # (...,6)
    dV = V[..., :, iu, :] - V[..., :, ju, :]                                         # (...,4,6,3)
    P = torch.einsum("...apx,...bpx->...abp", dV, dV)                                # (...,4,4,6)

    b0 = torch.sqrt(torch.clamp(P[..., 0, 0, :] * d2_w, min=0.0)).sum(-1) / torch.clamp(
        P[..., 0, 0, :].sum(-1), min=_EPS)
    zero = torch.zeros_like(b0)
    cand1 = torch.stack([b0, zero, zero, zero], -1)
    s2 = _solve_sym(torch.stack([P[..., 0, 0, :], 2.0 * P[..., 0, 1, :], P[..., 1, 1, :]], -1),
                    d2_w)
    b1 = torch.sqrt(torch.clamp(torch.abs(s2[..., 0]), min=_EPS))
    cand2 = torch.stack([b1, s2[..., 1] / b1, zero, zero], -1)
    s3 = _solve_sym(torch.stack([P[..., 0, 0, :], 2.0 * P[..., 0, 1, :], P[..., 1, 1, :],
                                 2.0 * P[..., 0, 2, :], 2.0 * P[..., 1, 2, :], P[..., 2, 2, :]],
                                -1), d2_w)
    c1 = torch.sqrt(torch.clamp(torch.abs(s3[..., 0]), min=_EPS))
    cand3 = torch.stack([c1, s3[..., 1] / c1, s3[..., 3] / c1, zero], -1)

    # the six starts (three inits x two signs) on a new axis before the
    # null-space axis
    betas = torch.stack([cand1, cand2, cand3, cand1, cand2, cand3], -2)            # (...,6,4)
    signs = torch.tensor([1.0, 1.0, 1.0, -1.0, -1.0, -1.0], dtype=dt, device=dev)
    dV6 = dV[..., None, :, :, :]
    eye4 = 1e-6 * torch.eye(4, dtype=dt, device=dev)
    for _ in range(10):
        e = torch.einsum("...a,...apx->...px", betas, dV6)                           # (...,6,6,3)
        f = (e * e).sum(-1) - d2_w[..., None, :]
        J = 2.0 * torch.einsum("...px,...apx->...pa", e, dV6)                        # (...,6,6,4)
        Jt = J.transpose(-1, -2)
        step = torch.linalg.solve_ex(Jt @ J + eye4, (Jt @ f[..., None])).result[..., 0]
        betas = betas - step
    ctrl_c = signs[:, None, None] * torch.einsum("...a,...apx->...px", betas,
                                                 V[..., None, :, :, :])               # (...,6,4,3)
    mu_w = ctrl_w.mean(-2)
    mu_c = ctrl_c.mean(-2)
    H = (ctrl_w - mu_w[..., None, :])[..., None, :, :].transpose(-1, -2) @ (
        ctrl_c - mu_c[..., None, :])
    # a start whose Gauss-Newton diverged (a degenerate set) has non-finite
    # control points: its SVD input is zeroed so the CPU's SVD does not
    # raise (the card's returns NaN), and its t stays non-finite, so it
    # scores no inliers on either device
    U, _, Vt = torch.linalg.svd(torch.nan_to_num(H, nan=0.0, posinf=0.0, neginf=0.0))
    Vm, Ut = Vt.transpose(-1, -2), U.transpose(-1, -2)
    Rm = (Vm * _det_fix(Vm, Ut)[..., None, :]) @ Ut
    t = mu_c - (Rm @ mu_w[..., None, :, None])[..., 0]
    pred = points[..., None, :, :] @ Rm.transpose(-1, -2) + t[..., None, :]
    pred = pred / torch.clamp(torch.linalg.norm(pred, dim=-1, keepdim=True), min=_EPS)
    err = (1.0 - (pred * bearings[..., None, :, :]).sum(-1)).sum(-1)                 # (...,6)
    best = torch.argmin(err, dim=-1)
    Rb = torch.gather(Rm, -3, best[..., None, None, None].expand(best.shape + (1, 3, 3)))[..., 0, :, :]
    tb = torch.gather(t, -2, best[..., None, None].expand(best.shape + (1, 3)))[..., 0, :]
    return _pose(Rb, tb)


def score_pnp(T_cw, bearings, points, mask, thr_cos: float = 0.9999):
    """Inliers: angle between predicted and observed bearing below the
    threshold.  T_cw (...,4,4) against (...,N,3) pairs -> (score, inliers)."""
    pc = points @ T_cw[..., :3, :3].transpose(-1, -2) + T_cw[..., None, :3, 3]
    pred = pc / torch.clamp(torch.linalg.norm(pc, dim=-1, keepdim=True), min=_EPS)
    ok = ((pred * bearings).sum(-1) > thr_cos) & mask
    return ok.to(torch.float32).sum(-1), ok


# ---------------------------------------------------------------------------
# Sim3 closed form (Horn / Umeyama) — ref solve/sim3_solver
# ---------------------------------------------------------------------------

def fit_sim3_horn(p1: torch.Tensor, p2: torch.Tensor, fix_scale: bool = False):
    """Absolute orientation: (R, t, s) with p2 ~ s R p1 + t from (...,k,3)
    pairs, k >= 3 (rotation from the SVD of the correlation)."""
    c1, c2 = p1.mean(-2), p2.mean(-2)
    q1, q2 = p1 - c1[..., None, :], p2 - c2[..., None, :]
    U, _, Vt = torch.linalg.svd(q2.transpose(-1, -2) @ q1)
    R = (U * _det_fix(U, Vt)[..., None, :]) @ Vt
    if fix_scale:
        s = torch.ones(p1.shape[:-2], dtype=p1.dtype, device=p1.device)
    else:
        s = (q2 * (q1 @ R.transpose(-1, -2))).sum((-1, -2)) / torch.clamp(
            (q1 * q1).sum((-1, -2)), min=_EPS)
    return R, c2 - s[..., None] * (R @ c1[..., None])[..., 0], s


def score_sim3(g, p1, p2, mask, thr: float):
    """Symmetric 3-D transfer error below ``thr`` (squared distance) in both
    directions.  g = (R (...,3,3), t, s) against (...,N,3) pairs."""
    R, t, s = g
    p12 = s[..., None, None] * (p1 @ R.transpose(-1, -2)) + t[..., None, :]
    p21 = ((p2 - t[..., None, :]) @ R) / torch.clamp(s, min=_EPS)[..., None, None]
    ok = (((p12 - p2) ** 2).sum(-1) < thr) & (((p21 - p1) ** 2).sum(-1) < thr) & mask
    return ok.to(torch.float32).sum(-1), ok
