"""Batched linear triangulation (counterpart of ``openvslam_tpu/ops/triangulate.py``;
ref ``solve/triangulator.*``).

Two-view DLT on bearing vectors: for bearing b and pose P = [R|t] (3x4,
world->cam), the constraint is hat(b) P X_h = 0 (2 independent rows).  Four
rows (2 per view) are stacked and X_h is the eigenvector of the smallest
eigenvalue of the 4x4 A^T A, batched over N correspondences.  Its sign is
arbitrary, and X = X_h[:3] / X_h[3] does not depend on it.
"""
from __future__ import annotations

import torch

from . import se3

_EPS = 1e-9


def triangulate_two_view(b1, b2, T1_cw, T2_cw):
    """b1, b2: (...,N,3) bearings; T*_cw: (...,4,4) poses.
    Returns (X_w (...,N,3), ok (...,N))."""
    A1 = se3.hat(b1) @ T1_cw[..., None, :3, :]          # (...,N,3,4)
    A2 = se3.hat(b2) @ T2_cw[..., None, :3, :]
    A = torch.cat([A1[..., :2, :], A2[..., :2, :]], -2)  # (...,N,4,4)
    _, V = torch.linalg.eigh(A.transpose(-1, -2) @ A)
    Xh = V[..., 0]
    w = Xh[..., 3]
    ok = torch.abs(w) > _EPS
    return Xh[..., :3] / torch.where(ok, w, torch.ones_like(w))[..., None], ok


def _center(T_cw):
    return -(T_cw[..., :3, :3].transpose(-1, -2) @ T_cw[..., :3, 3:])[..., 0]


def depths_and_parallax(X_w, b1, b2, T1_cw, T2_cw):
    """Cheirality/parallax helpers for triangulation gating.  Returns
    (z1, z2, cos_parallax): z is the depth along the observed bearing in
    each camera (generalizes pinhole z > 0 to all camera models)."""
    x1 = X_w @ T1_cw[..., :3, :3].transpose(-1, -2) + T1_cw[..., None, :3, 3]
    x2 = X_w @ T2_cw[..., :3, :3].transpose(-1, -2) + T2_cw[..., None, :3, 3]
    z1 = torch.sum(x1 * b1, -1)
    z2 = torch.sum(x2 * b2, -1)
    r1 = X_w - _center(T1_cw)[..., None, :]
    r2 = X_w - _center(T2_cw)[..., None, :]
    cos_par = torch.sum(r1 * r2, -1) / torch.clamp(
        torch.linalg.norm(r1, dim=-1) * torch.linalg.norm(r2, dim=-1), min=_EPS)
    return z1, z2, cos_par
