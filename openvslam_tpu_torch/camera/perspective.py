"""Pinhole camera with radial-tangential distortion (counterpart of
``openvslam_tpu/camera/perspective.py``).

A plain dataclass of Python floats: the methods take tensors on any
device and return tensors on the same device.  Undistortion is the same
fixed-iteration fixed-point inversion as the JAX model.
"""
from __future__ import annotations

import dataclasses

import torch

from .base import SetupType

_UNDIST_ITERS = 10


@dataclasses.dataclass(frozen=True)
class Perspective:
    fx: float
    fy: float
    cx: float
    cy: float
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    k3: float = 0.0
    cols: int = 640
    rows: int = 480
    fps: float = 30.0
    setup: SetupType = SetupType.MONOCULAR
    focal_x_baseline: float = 0.0
    depth_threshold: float = 40.0

    model_name = "perspective"

    def _distort_normalized(self, x, y):
        r2 = x * x + y * y
        radial = 1.0 + r2 * (self.k1 + r2 * (self.k2 + r2 * self.k3))
        xd = x * radial + 2.0 * self.p1 * x * y + self.p2 * (r2 + 2.0 * x * x)
        yd = y * radial + self.p1 * (r2 + 2.0 * y * y) + 2.0 * self.p2 * x * y
        return xd, yd

    def _undistort_normalized(self, xd, yd):
        x, y = xd, yd
        for _ in range(_UNDIST_ITERS):
            dx, dy = self._distort_normalized(x, y)
            x = x + (xd - dx)
            y = y + (yd - dy)
        return x, y

    def _normalized(self, kpts):
        return (kpts[..., 0] - self.cx) / self.fx, (kpts[..., 1] - self.cy) / self.fy

    def undistort_keypoints(self, kpts: torch.Tensor) -> torch.Tensor:
        """(...,2) pixel -> (...,2) undistorted pixel (same K)."""
        x, y = self._undistort_normalized(*self._normalized(kpts))
        return torch.stack([x * self.fx + self.cx, y * self.fy + self.cy], -1)

    def keypoints_to_bearings(self, kpts: torch.Tensor) -> torch.Tensor:
        """(...,2) raw pixel -> (...,3) unit bearing."""
        x, y = self._undistort_normalized(*self._normalized(kpts))
        v = torch.stack([x, y, torch.ones_like(x)], -1)
        return v / torch.linalg.norm(v, dim=-1, keepdim=True)

    def project(self, pts_cam: torch.Tensor):
        """(...,3) camera-frame points -> (uv (...,2), depth (...), valid (...)).
        uv is in undistorted pixel coordinates."""
        z = pts_cam[..., 2]
        zs = torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
        u = self.fx * pts_cam[..., 0] / zs + self.cx
        v = self.fy * pts_cam[..., 1] / zs + self.cy
        valid = (z > 0.0) & (u >= 0.0) & (u < self.cols) & (v >= 0.0) & (v < self.rows)
        return torch.stack([u, v], -1), z, valid
