"""Reprojection residuals + robust weights (counterpart of
``openvslam_tpu/optimize/residuals.py``, perspective mono edge).

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


def huber_weight(chi2: torch.Tensor, delta2: float) -> torch.Tensor:
    """IRLS weight of the Huber kernel at squared error chi2 (threshold^2 = delta2)."""
    return torch.where(chi2 <= delta2, torch.ones_like(chi2),
                       torch.sqrt(delta2 / torch.clamp(chi2, min=_EPS)))


def perturb_pose(xi: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """Left-multiplied increment: T' = exp(xi) T (the optimizer's chart)."""
    return se3.se3_exp(xi) @ T
