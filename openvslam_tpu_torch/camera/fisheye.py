"""Fisheye camera, the equidistant model with 4 coefficients (counterpart
of ``openvslam_tpu/camera/fisheye.py``; ref ``camera/fisheye``).

theta_d = theta (1 + k1 th^2 + k2 th^4 + k3 th^6 + k4 th^8), inverted by a
fixed 10-step Newton iteration.  ``project`` returns *undistorted pinhole*
pixels with the same K (the space ``undistort_keypoints`` maps keypoints
into, so matching and every residual use the pinhole edge), with the
validity of the raw fisheye projection (``project_fisheye``).  A plain
dataclass of Python floats, as ``Perspective``.
"""
from __future__ import annotations

import dataclasses

import torch

from .base import SetupType

_NEWTON_ITERS = 10


@dataclasses.dataclass(frozen=True)
class Fisheye:
    fx: float
    fy: float
    cx: float
    cy: float
    k1: float = 0.0
    k2: float = 0.0
    k3: float = 0.0
    k4: float = 0.0
    cols: int = 640
    rows: int = 480
    fps: float = 30.0
    setup: SetupType = SetupType.MONOCULAR
    focal_x_baseline: float = 0.0
    depth_threshold: float = 40.0

    model_name = "fisheye"

    def _theta_d(self, theta):
        th2 = theta * theta
        return theta * (1.0 + th2 * (self.k1 + th2 * (self.k2 + th2 * (self.k3 + th2 * self.k4))))

    def _theta_from_theta_d(self, theta_d):
        th = theta_d
        for _ in range(_NEWTON_ITERS):
            th2 = th * th
            f = self._theta_d(th) - theta_d
            df = 1.0 + th2 * (3.0 * self.k1 + th2 * (5.0 * self.k2 + th2 * (
                7.0 * self.k3 + th2 * 9.0 * self.k4)))
            th = th - f / torch.where(torch.abs(df) < 1e-9, torch.full_like(df, 1e-9), df)
        return th

    def keypoints_to_bearings(self, kpts: torch.Tensor) -> torch.Tensor:
        """(...,2) raw pixel -> (...,3) unit bearing; past 90 degrees
        (cos theta < 0) the ray is flipped to keep its direction."""
        xd = (kpts[..., 0] - self.cx) / self.fx
        yd = (kpts[..., 1] - self.cy) / self.fy
        theta_d = torch.sqrt(xd * xd + yd * yd)
        theta = self._theta_from_theta_d(theta_d)
        scale = torch.where(theta_d > 1e-9, torch.tan(theta) / torch.clamp(theta_d, min=1e-9),
                            torch.ones_like(theta_d))
        x = xd * scale
        y = yd * scale
        v = torch.stack([x, y, torch.ones_like(x)], -1)
        v = torch.where((torch.cos(theta) < 0.0)[..., None], -v, v)
        return v / torch.linalg.norm(v, dim=-1, keepdim=True)

    def undistort_keypoints(self, kpts: torch.Tensor) -> torch.Tensor:
        """(...,2) raw pixel -> (...,2) undistorted (pinhole) pixel, same K."""
        return self.bearings_to_keypoints(self.keypoints_to_bearings(kpts))

    def bearings_to_keypoints(self, brg: torch.Tensor) -> torch.Tensor:
        z = brg[..., 2]
        zs = torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
        return torch.stack([self.fx * brg[..., 0] / zs + self.cx,
                            self.fy * brg[..., 1] / zs + self.cy], -1)

    def project_fisheye(self, pts_cam: torch.Tensor):
        """The raw (distorted) fisheye projection: (uv, z, valid)."""
        x, y, z = pts_cam[..., 0], pts_cam[..., 1], pts_cam[..., 2]
        r = torch.sqrt(x * x + y * y)
        theta_d = self._theta_d(torch.atan2(r, z))
        scale = torch.where(r > 1e-9, theta_d / torch.clamp(r, min=1e-9), torch.zeros_like(r))
        u = self.fx * x * scale + self.cx
        v = self.fy * y * scale + self.cy
        valid = (z > 0.0) & (u >= 0.0) & (u < self.cols) & (v >= 0.0) & (v < self.rows)
        return torch.stack([u, v], -1), z, valid

    def project(self, pts_cam: torch.Tensor):
        """(...,3) camera-frame points -> (uv (...,2) undistorted pinhole
        pixels, depth z (...), valid (...) in the raw image's bounds)."""
        _, z, valid = self.project_fisheye(pts_cam)
        zs = torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
        u = self.fx * pts_cam[..., 0] / zs + self.cx
        v = self.fy * pts_cam[..., 1] / zs + self.cy
        return torch.stack([u, v], -1), z, valid

    def stereo_right_u(self, uv: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
        return uv[..., 0] - self.focal_x_baseline / torch.clamp(depth, min=1e-9)
