"""Pose-only Levenberg-Marquardt (counterpart of
``openvslam_tpu/optimize/pose_optimizer.py``): g2o's schedule of 4 rounds
x 10 iterations, Huber at chi2 5.991 (mono) / 7.815 (stereo), inlier
reclassification between rounds.

Perspective and fisheye cameras (a fisheye's ``project`` is the pinhole
projection of undistorted pixels, with ok at z > eps: the same edge) run
the whole schedule as one call of ``ops.pose_lm.pose_lm`` (kernel K3 on
the GPU).  An equirectangular camera runs ``equirect_pose_lm``, the same
schedule in plain PyTorch over the lon/lat edge (analytic Jacobians, the
u residual wrapped across the seam, ok at |x| > eps), as the JAX package
runs that camera's LM outside its Pallas kernel: batched tensor
operations per iteration, the 6x6 damped normal equations solved with
``torch.linalg.solve_ex``, the accept decision and the damping kept as
0-d tensors, so nothing is read back to the host inside the schedule.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import se3
from ..ops.pose_lm import pose_lm
from . import residuals as R


class PoseOptResult(NamedTuple):
    T_cw: torch.Tensor        # (4,4) optimized pose
    inliers: torch.Tensor     # (N,) bool final inlier classification
    num_inliers: torch.Tensor # () int32
    chi2: torch.Tensor        # (N,) final per-obs chi2


def equirect_state(T, X, obs, inv_s2, cols: int, rows: int):
    """The equirectangular mono edge at pose T: (J (N,2,6) with respect to
    the left increment [omega, upsilon], r (N,2), ok (N,) f32, chi2 (N,)).
    With P = d(prediction)/dx (``residuals.equirect_uv_jacobian``) the
    residual's rows are -P [-hat(x) | I] = [P hat(x) | -P]."""
    x = X @ T[:3, :3].T + T[:3, 3]
    uv, depth = R.equirect_uv(x, cols, rows)
    ok = (depth > R._EPS).to(X.dtype)
    r = obs - uv
    r = torch.stack([R.wrap_seam(r[:, 0], cols), r[:, 1]], -1) * ok[:, None]
    P = R.equirect_uv_jacobian(x, cols, rows) * ok[:, None, None]
    J = torch.cat([P @ se3.hat(x), -P], -1)
    return J, r, ok, (r * r).sum(-1) * inv_s2


def equirect_pose_lm(T_init, X_w, obs_uv, sigma2, mask, *, cols: int, rows: int,
                     chi2_thr: float = R.CHI2_2D, num_rounds: int = 4, iters_per_round: int = 10):
    """The pose-only LM of an equirectangular camera, in plain PyTorch on the
    operands' device: the JAX package's schedule (lambda 1e-3 per round,
    halved on accept and quadrupled on reject within [1e-9, 1e6], accept
    only a lower Huber cost at a finite pose, inliers reclassified between
    rounds).  Returns (T_cw (4,4), inliers (N,), num_inliers, chi2 (N,))."""
    f32 = torch.float32
    T, X, obs = T_init.to(f32), X_w.to(f32), obs_uv.to(f32)
    inv_s2 = 1.0 / torch.clamp(sigma2.to(f32), min=1e-12)
    mask_f = mask.to(f32)
    eye6 = torch.eye(6, dtype=f32, device=X.device)

    def rho(c):
        return torch.where(c <= chi2_thr, c,
                           2.0 * torch.sqrt(chi2_thr * torch.clamp(c, min=0.0)) - chi2_thr)

    state = equirect_state(T, X, obs, inv_s2, cols, rows)
    active = mask_f
    for _ in range(num_rounds):
        J, r, ok, c2 = state
        cost = (rho(c2) * active * ok).sum()
        lam = torch.tensor(1e-3, dtype=f32, device=X.device)
        for _ in range(iters_per_round):
            J, r, ok, c2 = state
            w = R.huber_weight(c2, chi2_thr) * inv_s2 * active * ok
            H = torch.einsum("nri,nrj,n->ij", J, J, w)
            g = torch.einsum("nri,nr,n->i", J, r, w)
            Hd = H + lam * torch.diag(torch.diagonal(H)) + 1e-9 * eye6
            dx = -torch.linalg.solve_ex(Hd, g).result
            T_try = R.perturb_pose(dx, T)
            trial = equirect_state(T_try, X, obs, inv_s2, cols, rows)
            cost_try = (rho(trial[3]) * active * trial[2]).sum()
            acc = (cost_try < cost) & torch.isfinite(T_try).all()
            T = torch.where(acc, T_try, T)
            state = tuple(torch.where(acc, a, b) for a, b in zip(trial, state))
            cost = torch.where(acc, cost_try, cost)
            lam = torch.clamp(torch.where(acc, lam * 0.5, lam * 4.0), 1e-9, 1e6)
        _, _, ok, c2 = state
        active = mask_f * ok * (c2 < chi2_thr).to(f32)
    inl = active > 0.5
    return T, inl, inl.to(torch.int32).sum(), state[3]


def make_pose_optimizer(cam, stereo: bool = False, num_rounds: int = 4,
                        iters_per_round: int = 10):
    """fn(T_init (4,4), X_w (N,3), obs (N,2|3), sigma2 (N,), mask (N,)) ->
    PoseOptResult.  ``obs`` is uv for mono, (u, v, u_right) for stereo
    (u_right < 0 marks a mono observation inside a stereo frame).  An
    equirectangular camera is monocular: its ``obs`` is uv."""
    sched = dict(num_rounds=num_rounds, iters_per_round=iters_per_round)
    if cam.model_name == "equirectangular":
        if stereo:
            raise ValueError("an equirectangular camera has no stereo pose LM")

        def optimize_equirect(T_init, X_w, obs, sigma2, mask) -> PoseOptResult:
            return PoseOptResult(*equirect_pose_lm(T_init, X_w, obs, sigma2, mask,
                                                   cols=cam.cols, rows=cam.rows, **sched))

        return optimize_equirect
    kw = dict(fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy,
              fxb=cam.focal_x_baseline if stereo else 0.0,
              chi2_thr=R.CHI2_3D if stereo else R.CHI2_2D, **sched)

    def optimize(T_init: torch.Tensor, X_w, obs, sigma2, mask) -> PoseOptResult:
        return PoseOptResult(*pose_lm(T_init, X_w, obs, sigma2, mask, **kw))

    return optimize
