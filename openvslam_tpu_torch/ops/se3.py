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
    theta2 = torch.sum(w * w, -1)
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS * _EPS))
    small = theta2 < _EPS
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta)) / (theta2 * theta))
    return a, b, c


def _eye_like(W: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=W.dtype, device=W.device).expand(W.shape)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: (...,3) axis-angle -> (...,3,3) rotation."""
    a, b, _ = _coeffs(w)
    W = hat(w)
    return _eye_like(W) + a[..., None, None] * W + b[..., None, None] * (W @ W)


def _V(w: torch.Tensor) -> torch.Tensor:
    """Left Jacobian of SO(3): integrates translation in the se(3) exp."""
    _, b, c = _coeffs(w)
    W = hat(w)
    return _eye_like(W) + b[..., None, None] * W + c[..., None, None] * (W @ W)


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
