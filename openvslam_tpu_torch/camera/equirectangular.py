"""Equirectangular (360 degree) camera (counterpart of
``openvslam_tpu/camera/equirectangular.py``; ref ``camera/equirectangular``).

u in [0, cols) maps to longitude [-pi, pi), v in [0, rows) to latitude
[pi/2, -pi/2).  Every bearing is valid (the full sphere): ``project``
only checks the image bounds, and its depth is the distance |x|.  The
setup is always monocular.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from .base import SetupType


@dataclasses.dataclass(frozen=True)
class Equirectangular:
    cols: int = 1920
    rows: int = 960
    fps: float = 30.0
    setup: SetupType = SetupType.MONOCULAR
    focal_x_baseline: float = 0.0
    depth_threshold: float = 40.0

    model_name = "equirectangular"

    def undistort_keypoints(self, kpts: torch.Tensor) -> torch.Tensor:
        return kpts

    def keypoints_to_bearings(self, kpts: torch.Tensor) -> torch.Tensor:
        lon = (kpts[..., 0] / self.cols - 0.5) * (2.0 * math.pi)
        lat = -(kpts[..., 1] / self.rows - 0.5) * math.pi
        return torch.stack([torch.cos(lat) * torch.sin(lon), -torch.sin(lat),
                            torch.cos(lat) * torch.cos(lon)], -1)

    def bearings_to_keypoints(self, brg: torch.Tensor) -> torch.Tensor:
        b = brg / torch.linalg.norm(brg, dim=-1, keepdim=True)
        lat = -torch.asin(torch.clamp(b[..., 1], -1.0, 1.0))
        lon = torch.atan2(b[..., 0], b[..., 2])
        return torch.stack([self.cols * (0.5 + lon / (2.0 * math.pi)),
                            self.rows * (0.5 - lat / math.pi)], -1)

    def project(self, pts_cam: torch.Tensor):
        """(...,3) camera-frame points -> (uv (...,2), depth |x| (...), valid)."""
        depth = torch.linalg.norm(pts_cam, dim=-1)
        uv = self.bearings_to_keypoints(pts_cam / torch.clamp(depth, min=1e-9)[..., None])
        valid = ((depth > 1e-9) & (uv[..., 0] >= 0.0) & (uv[..., 0] < self.cols)
                 & (uv[..., 1] >= 0.0) & (uv[..., 1] < self.rows))
        return uv, depth, valid

    def stereo_right_u(self, uv: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
        return torch.full_like(uv[..., 0], -1.0)
