"""Reprojection residuals + robust weights (counterpart of
``openvslam_tpu/optimize/residuals.py``, perspective mono and stereo
edges).

The pose LM (``ops/pose_lm.py``) evaluates residuals and their analytic
Jacobians itself; these functions state the edge it implements and serve
tests and host code.
"""
from __future__ import annotations

import torch

from ..ops import se3

CHI2_2D = 5.991
CHI2_3D = 7.815
_EPS = 1e-9


def make_mono_residual(cam):
    """Returns residual(T_cw (4,4), X_w (N,3), uv_obs (N,2)) -> (r (N,2), ok (N,))."""

    def residual(T_cw, X_w, uv_obs):
        x_cam = se3.transform(T_cw, X_w)
        uv, _, _ = cam.project(x_cam)
        ok = x_cam[..., 2] > _EPS
        return torch.where(ok[..., None], uv_obs - uv, torch.zeros_like(uv)), ok

    return residual


def make_stereo_residual(cam):
    """Returns residual(T_cw (4,4), X_w (N,3), uvr_obs (N,3)) -> (r (N,3),
    ok (N,)) with uvr_obs = (u, v, u_right), u_right = u - focal_x_baseline
    / depth.  An observation with u_right < 0 is monocular inside a stereo
    frame: its third component is masked, so mixed batches share one edge."""

    def residual(T_cw, X_w, uvr_obs):
        x_cam = se3.transform(T_cw, X_w)
        uv, depth, _ = cam.project(x_cam)
        pred = torch.cat([uv, cam.stereo_right_u(uv, depth)[..., None]], -1)
        ok = x_cam[..., 2] > _EPS
        r = uvr_obs - pred
        r = torch.cat([r[..., :2], torch.where(uvr_obs[..., 2:] < 0, 0.0, r[..., 2:])], -1)
        return torch.where(ok[..., None], r, torch.zeros_like(r)), ok

    return residual


def huber_weight(chi2: torch.Tensor, delta2: float) -> torch.Tensor:
    """IRLS weight of the Huber kernel at squared error chi2 (threshold^2 = delta2)."""
    return torch.where(chi2 <= delta2, torch.ones_like(chi2),
                       torch.sqrt(delta2 / torch.clamp(chi2, min=_EPS)))


def perturb_pose(xi: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """Left-multiplied increment: T' = exp(xi) T (the optimizer's chart)."""
    return se3.se3_exp(xi) @ T
