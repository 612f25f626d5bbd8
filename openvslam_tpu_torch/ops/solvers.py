"""Two-view minimal solvers (counterpart of ``openvslam_tpu/ops/solvers.py``
up to the essential/homography decompositions; ref ``solve/``).

Every function takes leading batch dimensions, so a RANSAC round fits and
scores all its hypotheses in one call (``ops/ransac.py``).  Conventions:

* 2D keypoints are undistorted pixel coordinates (..., k, 2).
* bearings are unit 3-vectors in the camera frame (..., k, 3).
* Poses map world->camera: x_cam = R x_w + t.

Null vectors come from ``eigh`` of A^T A and the decompositions from an SVD;
both leave a sign free, and every consumer here is invariant to it (F and
H are used up to sign, E's four and H's eight hypotheses form the same set
whatever the signs).  Solves use the ``_ex`` forms, which do not read their
status back to the host.
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
