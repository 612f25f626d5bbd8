"""SE(3) / SO(3) operations on batched tensors (counterpart of
``openvslam_tpu/ops/se3.py``).

Poses are camera<-world transforms ``T_cw`` as (4,4) row-major tensors;
twists are ordered [omega, upsilon].  Everything broadcasts over leading
batch dimensions.
"""
from __future__ import annotations

import torch

_EPS = 1e-8


def hat(w: torch.Tensor) -> torch.Tensor:
    """(...,3) -> (...,3,3) skew-symmetric matrix."""
    x, y, z = w[..., 0], w[..., 1], w[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], -1),
            torch.stack([z, zero, -x], -1),
            torch.stack([-y, x, zero], -1),
        ],
        -2,
    )


def _coeffs(w: torch.Tensor):
    """(...,3) -> the Rodrigues coefficients a, b, c, each (...,1,1).

    The large-angle quotients are evaluated at a substitute angle wherever
    the small-angle series is selected, so that no branch that ``where``
    discards divides by zero: its gradient stays finite at 0.  The kept
    dimensions keep a single twist's coefficients out of 0-dim tensors,
    which forward-mode autodiff promotes to float64 against Python
    constants."""
    theta2 = torch.sum(w * w, -1, keepdim=True)[..., None]
    small = theta2 < _EPS
    theta2_l = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(theta2_l)
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2_l)
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta)) / (theta2_l * theta))
    return a, b, c


def _eye_like(W: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=W.dtype, device=W.device).expand(W.shape)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: (...,3) axis-angle -> (...,3,3) rotation."""
    a, b, _ = _coeffs(w)
    W = hat(w)
    return _eye_like(W) + a * W + b * (W @ W)


def to_quat(R: torch.Tensor) -> torch.Tensor:
    """(...,3,3) -> (...,4) unit quaternion (x, y, z, w), from the best
    conditioned of the four constructions."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def half_sqrt(x):
        return torch.sqrt(torch.clamp(x, min=_EPS)) * 0.5

    qw0 = half_sqrt(1.0 + tr)
    q0 = torch.stack([(m21 - m12) / (4 * qw0), (m02 - m20) / (4 * qw0), (m10 - m01) / (4 * qw0),
                      qw0], -1)
    qx1 = half_sqrt(1.0 + m00 - m11 - m22)
    q1 = torch.stack([qx1, (m01 + m10) / (4 * qx1), (m02 + m20) / (4 * qx1),
                      (m21 - m12) / (4 * qx1)], -1)
    qy2 = half_sqrt(1.0 - m00 + m11 - m22)
    q2 = torch.stack([(m01 + m10) / (4 * qy2), qy2, (m12 + m21) / (4 * qy2),
                      (m02 - m20) / (4 * qy2)], -1)
    qz3 = half_sqrt(1.0 - m00 - m11 + m22)
    q3 = torch.stack([(m02 + m20) / (4 * qz3), (m12 + m21) / (4 * qz3), qz3,
                      (m10 - m01) / (4 * qz3)], -1)
    scores = torch.stack([tr, m00 - m11 - m22, -m00 + m11 - m22, -m00 - m11 + m22], -1)
    idx = torch.argmax(scores, -1)
    qs = torch.stack([q0, q1, q2, q3], -2)
    q = torch.gather(qs, -2, idx[..., None, None].expand(idx.shape + (1, 4)))[..., 0, :]
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """(...,3,3) rotation -> (...,3) axis-angle (principal value), through
    the quaternion, which stays accurate up to theta ~ pi."""
    q = to_quat(R)
    q = q * torch.where(q[..., 3:4] < 0, -1.0, 1.0)
    qv, qw = q[..., :3], q[..., 3]
    n = torch.linalg.norm(qv, dim=-1)
    theta = 2.0 * torch.atan2(n, qw)
    scale = torch.where(n < 1e-7, 2.0 / torch.clamp(qw, min=_EPS),
                        theta / torch.clamp(n, min=_EPS))
    return scale[..., None] * qv


def _V(w: torch.Tensor) -> torch.Tensor:
    """Left Jacobian of SO(3): integrates translation in the se(3) exp."""
    _, b, c = _coeffs(w)
    W = hat(w)
    return _eye_like(W) + b * W + c * (W @ W)


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """(...,6) twist [omega, upsilon] -> (...,4,4) transform."""
    w, u = xi[..., :3], xi[..., 3:]
    R = so3_exp(w)
    t = (_V(w) @ u[..., None])[..., 0]
    return from_Rt(R, t)


def from_Rt(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    T = torch.zeros(R.shape[:-2] + (4, 4), dtype=R.dtype, device=R.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    T[..., 3, 3] = 1.0
    return T


def compose(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    return A @ B


def inverse(T: torch.Tensor) -> torch.Tensor:
    Rt = T[..., :3, :3].transpose(-1, -2)
    return from_Rt(Rt, -(Rt @ T[..., :3, 3:])[..., 0])


def transform(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply (...,4,4) to points (...,N,3) or (...,3)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    if pts.ndim >= 2 and pts.shape[-2] != 3:
        return pts @ R.transpose(-1, -2) + t[..., None, :]
    return (R @ pts[..., None])[..., 0] + t
