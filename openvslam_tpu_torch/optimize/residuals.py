"""Reprojection residuals + robust weights (counterpart of
``openvslam_tpu/optimize/residuals.py``): the mono edge (pinhole pixels
for perspective and fisheye cameras; lon/lat pixels with the u residual
wrapped across the seam for an equirectangular one), the stereo edge and
the multi-camera edge, whose intrinsics ride in each observation.

The pose LMs (``ops/pose_lm.py``, ``optimize/pose_optimizer.py``) and the
bundle adjusters evaluate residuals and their analytic Jacobians
themselves; these functions state the edges they implement and serve
tests and host code.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..ops import se3

CHI2_2D = 5.991
CHI2_3D = 7.815
_EPS = 1e-9


def mono_edge(cam, x_cam, uv_obs):
    """The mono edge at camera-frame points x_cam (N,3): (r (N,2), ok (N,)),
    r zero where not ok.  Pinhole pixels and ok at z > eps for perspective
    and fisheye cameras; for an equirectangular one the lon/lat pixels,
    the u residual wrapped across the seam and ok at |x| > eps."""
    uv, depth, _ = cam.project(x_cam)
    r = uv_obs - uv
    if cam.model_name == "equirectangular":
        r = torch.stack([wrap_seam(r[..., 0], cam.cols), r[..., 1]], -1)
        ok = depth > _EPS
    else:
        ok = x_cam[..., 2] > _EPS
    return torch.where(ok[..., None], r, torch.zeros_like(r)), ok


def stereo_edge(cam, x_cam, uvr_obs):
    """The stereo edge at camera-frame points: (r (N,3), ok (N,)) with
    uvr_obs = (u, v, u_right), u_right = u - focal_x_baseline / depth.  An
    observation with u_right < 0 is monocular inside a stereo frame: its
    third component is masked, so mixed batches share one edge."""
    uv, depth, _ = cam.project(x_cam)
    pred = torch.cat([uv, cam.stereo_right_u(uv, depth)[..., None]], -1)
    ok = x_cam[..., 2] > _EPS
    r = uvr_obs - pred
    r = torch.cat([r[..., :2], torch.where(uvr_obs[..., 2:] < 0, 0.0, r[..., 2:])], -1)
    return torch.where(ok[..., None], r, torch.zeros_like(r)), ok


def make_mono_residual(cam):
    """Returns residual(T_cw (4,4), X_w (N,3), uv_obs (N,2)) -> (r (N,2), ok (N,))."""

    def residual(T_cw, X_w, uv_obs):
        return mono_edge(cam, se3.transform(T_cw, X_w), uv_obs)

    return residual


def make_stereo_residual(cam):
    """Returns residual(T_cw (4,4), X_w (N,3), uvr_obs (N,3)) -> (r (N,3),
    ok (N,)) (``stereo_edge``)."""

    def residual(T_cw, X_w, uvr_obs):
        return stereo_edge(cam, se3.transform(T_cw, X_w), uvr_obs)

    return residual


def wrap_seam(ru: torch.Tensor, cols) -> torch.Tensor:
    """An equirectangular u residual wrapped into [-cols/2, cols/2): floor
    modulo (``torch.remainder``, as ``jnp.mod``), so +-cols/2 both give
    -cols/2."""
    half = cols * 0.5
    return torch.remainder(ru + half, cols) - half


def equirect_uv(x: torch.Tensor, cols, rows):
    """Pixel of camera-frame points x (...,3) on a cols x rows
    equirectangular image and the distance |x|: ``Equirectangular.project``'s
    uv, written out for a per-observation image size."""
    depth = torch.linalg.norm(x, dim=-1)
    b = x / torch.clamp(depth, min=_EPS)[..., None]
    lat = -torch.asin(torch.clamp(b[..., 1], -1.0, 1.0))
    lon = torch.atan2(b[..., 0], b[..., 2])
    return torch.stack([cols * (0.5 + lon / (2.0 * math.pi)),
                        rows * (0.5 - lat / math.pi)], -1), depth


def equirect_uv_jacobian(x: torch.Tensor, cols, rows) -> torch.Tensor:
    """d(u, v)/dx (...,2,3) of ``equirect_uv`` at camera-frame points x.
    With rho^2 = x0^2 + x2^2 and d^2 = rho^2 + x1^2:
    du/dx = cols / (2 pi) (x2, 0, -x0) / rho^2 and
    dv/dx = rows / pi (-x0 x1, rho^2, -x2 x1) / (d^2 rho).
    At the poles (rho = 0) the longitude has no derivative (autodiff gives
    NaN there); both rows are zero there instead."""
    x0, x1, x2 = x[..., 0], x[..., 1], x[..., 2]
    rho2 = x0 * x0 + x2 * x2
    pole = rho2 <= _EPS * _EPS
    rho2s = torch.where(pole, torch.ones_like(rho2), rho2)
    rho = torch.sqrt(rho2s)
    d2 = rho2s + x1 * x1
    zero = torch.zeros_like(x0)
    cu = cols / (2.0 * math.pi) / rho2s
    cv = rows / math.pi / (d2 * rho)
    J = torch.stack([torch.stack([cu * x2, zero, -cu * x0], -1),
                     torch.stack([-cv * x0 * x1, cv * rho2s, -cv * x2 * x1], -1)], -2)
    return torch.where(pole[..., None, None], 0.0, J)


CAMV_DIM = 8   # per-observation camera vector: fx fy cx cy cols rows is_eq pad


def make_camv(spec: dict) -> np.ndarray:
    """A camera spec (``camera.base.camera_to_config``) -> the (8,) float32
    vector of the multi-camera edge."""
    is_eq = 1.0 if spec.get("model") == "equirectangular" else 0.0
    return np.array([spec.get("fx", 0.0), spec.get("fy", 0.0), spec.get("cx", 0.0),
                     spec.get("cy", 0.0), spec["cols"], spec["rows"], is_eq, 0.0], np.float32)


def multicam_prediction(x: torch.Tensor, camv: torch.Tensor):
    """The multi-camera edge's prediction at camera-frame points x (N,3)
    with per-observation camera vectors camv (N,8): (uv (N,2), ok (N,),
    is_eq (N,)).  Perspective and fisheye keyframes observe undistorted
    pixels (the pinhole branch, ok at z > eps); equirectangular ones the
    lon/lat pixels (ok at |x| > eps)."""
    fx, fy, cx, cy, cols, rows, is_eq = camv[:, :7].unbind(-1)
    z = x[:, 2]
    zs = torch.where(z > _EPS, z, torch.ones_like(z))
    uv_pin = torch.stack([fx * x[:, 0] / zs + cx, fy * x[:, 1] / zs + cy], -1)
    uv_eq, depth = equirect_uv(x, cols, rows)
    eq = is_eq > 0.5
    uv = torch.where(eq[:, None], uv_eq, uv_pin)
    ok = torch.where(eq, depth > _EPS, z > _EPS)
    return uv, ok, eq


def multicam_edge(x_cam, obs):
    """The multi-camera edge at camera-frame points x_cam (N,3): (r (N,2),
    ok (N,)) for obs (N,2+CAMV_DIM) = [u, v, fx, fy, cx, cy, cols, rows,
    is_eq, pad].  The u residual of an equirectangular observation wraps
    across the seam."""
    uv, ok, eq = multicam_prediction(x_cam, obs[:, 2:])
    r = obs[:, :2] - uv
    r = torch.stack([torch.where(eq, wrap_seam(r[:, 0], obs[:, 6]), r[:, 0]), r[:, 1]], -1)
    return torch.where(ok[:, None], r, torch.zeros_like(r)), ok


def make_multicam_mono_residual():
    """Returns residual(T_cw (4,4), X_w (N,3), obs (N,2+CAMV_DIM)) -> (r (N,2),
    ok (N,)): the mono edge with per-observation intrinsics
    (``multicam_edge``), for bundle adjusting maps whose keyframes come
    from different cameras (ref: g2o edges carry their keyframe's
    camera)."""

    def residual(T_cw, X_w, obs):
        return multicam_edge(se3.transform(T_cw, X_w), obs)

    return residual


def huber_weight(chi2: torch.Tensor, delta2: float) -> torch.Tensor:
    """IRLS weight of the Huber kernel at squared error chi2 (threshold^2 = delta2)."""
    return torch.where(chi2 <= delta2, torch.ones_like(chi2),
                       torch.sqrt(delta2 / torch.clamp(chi2, min=_EPS)))


def perturb_pose(xi: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """Left-multiplied increment: T' = exp(xi) T (the optimizer's chart)."""
    return se3.se3_exp(xi) @ T
