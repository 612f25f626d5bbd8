"""Sim(3) operations for loop closure and pose-graph optimization
(counterpart of ``openvslam_tpu/ops/sim3.py``; ref the g2o Sim3 types of
``optimize/internal/sim3/*``).

A Sim3 element is the tuple ``(R, t, s)``; the tangent is a 7-vector
``[omega(3), upsilon(3), sigma]`` with ``s = exp(sigma)``.  Everything
broadcasts over leading batch dimensions.
"""
from __future__ import annotations

import torch

from . import se3

_EPS = 1e-7


def identity(batch_shape=(), dtype=torch.float32, device=None):
    R = torch.eye(3, dtype=dtype, device=device).expand(tuple(batch_shape) + (3, 3))
    t = torch.zeros(tuple(batch_shape) + (3,), dtype=dtype, device=device)
    s = torch.ones(tuple(batch_shape), dtype=dtype, device=device)
    return R, t, s


def from_se3(T: torch.Tensor):
    return T[..., :3, :3], T[..., :3, 3], torch.ones(T.shape[:-2], dtype=T.dtype, device=T.device)


def to_se3(R, t, s):
    """Drop the scale onto the translation: T = [R, t/s] (the reference's
    Sim3 -> SE3 rescale)."""
    return se3.from_Rt(R, t / s[..., None])


def compose(a, b):
    """(Ra,ta,sa) . (Rb,tb,sb): x -> sa*Ra*(sb*Rb*x + tb) + ta."""
    Ra, ta, sa = a
    Rb, tb, sb = b
    return Ra @ Rb, sa[..., None] * (Ra @ tb[..., None])[..., 0] + ta, sa * sb


def inverse(g):
    R, t, s = g
    Rt = R.transpose(-1, -2)
    si = 1.0 / s
    return Rt, -si[..., None] * (Rt @ t[..., None])[..., 0], si


def transform(g, pts):
    """Apply a Sim3 to points (...,N,3) or (...,3)."""
    R, t, s = g
    if pts.ndim >= 2 and pts.shape[-2] != 3:
        return s[..., None, None] * (pts @ R.transpose(-1, -2)) + t[..., None, :]
    return s[..., None] * (R @ pts[..., None])[..., 0] + t


def _W_coeffs(theta, sigma):
    """Coefficients (A, B, C) of W = A I + B hat(w) + C hat(w)^2 where
    W = integral_0^1 exp(sigma u) exp(hat(w) u) du: the closed form, with
    series in the small-theta and small-sigma regimes."""
    s = torch.exp(sigma)
    th2 = theta * theta
    sg2 = sigma * sigma
    den = torch.clamp(sg2 + th2, min=_EPS)
    small_th = theta < 1e-4
    small_sg = torch.abs(sigma) < 1e-4
    one = torch.ones_like(sigma)

    A = torch.where(small_sg, 1.0 + sigma / 2.0 + sg2 / 6.0,
                    (s - 1.0) / torch.where(small_sg, one, sigma))
    sin_t, cos_t = torch.sin(theta), torch.cos(theta)
    I_sin = (s * (sigma * sin_t - theta * cos_t) + theta) / den
    I_cos = (s * (sigma * cos_t + theta * sin_t) - sigma) / den
    B_generic = I_sin / torch.clamp(theta, min=_EPS)
    C_generic = (A - I_cos) / torch.clamp(th2, min=_EPS)

    # theta -> 0 limits (exact in sigma)
    B_th0 = torch.where(small_sg, 0.5 + sigma / 3.0 + sg2 / 8.0,
                        (s * (sigma - 1.0) + 1.0) / torch.where(small_sg, one, sg2))
    C_th0 = torch.where(small_sg, 1.0 / 6.0 + sigma / 8.0,
                        (s * (0.5 * sg2 - sigma + 1.0) - 1.0)
                        / torch.where(small_sg, one, sg2 * sigma))
    B = torch.where(small_th, B_th0, B_generic)
    C = torch.where(small_th, C_th0, C_generic)
    return A, B, C, s


def _W_matrix(w, sigma):
    theta = torch.linalg.norm(w, dim=-1)
    A, B, C, s = _W_coeffs(theta, sigma)
    Wh = se3.hat(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(Wh.shape)
    return (A[..., None, None] * eye + B[..., None, None] * Wh
            + C[..., None, None] * (Wh @ Wh)), s


def _solve3(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve (...,3,3) x = (...,3) by the adjugate: plain elementwise
    arithmetic, so forward-mode derivatives under ``torch.func.vmap`` stay
    exact (those of ``torch.linalg.solve`` do not)."""
    c0 = torch.cross(A[..., 1, :], A[..., 2, :], dim=-1)
    c1 = torch.cross(A[..., 2, :], A[..., 0, :], dim=-1)
    c2 = torch.cross(A[..., 0, :], A[..., 1, :], dim=-1)
    det = (A[..., 0, :] * c0).sum(-1)
    return (c0 * b[..., 0:1] + c1 * b[..., 1:2] + c2 * b[..., 2:3]) / det[..., None]


def exp(xi: torch.Tensor):
    """(...,7) [omega, upsilon, sigma] -> (R, t, s)."""
    w, u, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    Wm, s = _W_matrix(w, sigma)
    return se3.so3_exp(w), (Wm @ u[..., None])[..., 0], s


def log(g):
    """(R, t, s) -> (...,7) [omega, upsilon, sigma]."""
    R, t, s = g
    w = se3.so3_log(R)
    sigma = torch.log(s)
    Wm, _ = _W_matrix(w, sigma)
    u = _solve3(Wm, t)
    return torch.cat([w, u, sigma[..., None]], -1)
