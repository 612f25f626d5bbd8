"""Trajectory evaluation: Umeyama Sim3/SE3 alignment, ATE RMSE, RPE (a copy
of ``openvslam_tpu/utils/evaluate.py``).

The reference delegates evaluation to external tools (evo / ATE scripts) via
``--eval-log`` dumps; the evaluator is built in so acceptance targets are
checked in-repo.  numpy, host-side.
"""
from __future__ import annotations

import numpy as np


def umeyama_alignment(src: np.ndarray, dst: np.ndarray, with_scale: bool = True):
    """Least-squares similarity transform aligning src->dst, both (N,3).

    Returns (s, R, t) with dst ~ s R src + t (Umeyama 1991).
    """
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    mu_s = src.mean(0)
    mu_d = dst.mean(0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / src.shape[0]
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    if with_scale:
        var_s = (xs**2).sum() / src.shape[0]
        s = float(np.trace(np.diag(D) @ S) / max(var_s, 1e-12))
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def ate_rmse(est_xyz: np.ndarray, gt_xyz: np.ndarray, align: str = "sim3") -> float:
    """Absolute trajectory error RMSE after alignment ('sim3'|'se3'|'none')."""
    est = np.asarray(est_xyz, np.float64)
    gt = np.asarray(gt_xyz, np.float64)
    assert est.shape == gt.shape and est.shape[1] == 3
    if align == "sim3":
        s, R, t = umeyama_alignment(est, gt, with_scale=True)
        est = (s * (R @ est.T)).T + t
    elif align == "se3":
        s, R, t = umeyama_alignment(est, gt, with_scale=False)
        est = (R @ est.T).T + t
    err = est - gt
    return float(np.sqrt((err**2).sum(-1).mean()))


def rpe(est_poses: np.ndarray, gt_poses: np.ndarray, delta: int = 1):
    """Relative pose error over pose arrays (N,4,4) cam-from-world.

    Returns (trans_rmse, rot_rmse_deg).
    """
    est = np.asarray(est_poses, np.float64)
    gt = np.asarray(gt_poses, np.float64)
    n = est.shape[0] - delta
    terr = []
    rerr = []
    for i in range(n):
        de = np.linalg.inv(est[i]) @ est[i + delta]
        dg = np.linalg.inv(gt[i]) @ gt[i + delta]
        e = np.linalg.inv(dg) @ de
        terr.append(np.linalg.norm(e[:3, 3]))
        cosang = np.clip((np.trace(e[:3, :3]) - 1.0) * 0.5, -1.0, 1.0)
        rerr.append(np.degrees(np.arccos(cosang)))
    return float(np.sqrt(np.mean(np.square(terr)))), float(np.sqrt(np.mean(np.square(rerr))))


def associate_timestamps(ts_a, ts_b, max_diff: float = 0.02):
    """Greedy nearest-neighbor timestamp association (TUM tooling behavior).

    Returns list of (idx_a, idx_b) pairs.
    """
    ts_a = np.asarray(ts_a, np.float64)
    ts_b = np.asarray(ts_b, np.float64)
    pairs = []
    used_b = set()
    for ia, ta in enumerate(ts_a):
        ib = int(np.argmin(np.abs(ts_b - ta)))
        if ib in used_b:
            continue
        if abs(ts_b[ib] - ta) <= max_diff:
            pairs.append((ia, ib))
            used_b.add(ib)
    return pairs
