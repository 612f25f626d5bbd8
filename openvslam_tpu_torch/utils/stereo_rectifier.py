"""Stereo rectification (counterpart of ``openvslam_tpu/utils/stereo_rectifier.py``;
ref ``util/stereo_rectifier``): undistort+rectify lookup maps built once
from the calibration (K, D, R_rect per camera; numpy, a copy of the
reference's map builder) and a bilinear remap of each incoming image on the
device, the ``cv::initUndistortRectifyMap`` + ``remap`` pair.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device


def _distort_radtan(xy, D):
    k1, k2, p1, p2, k3 = D
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return np.stack([xd, yd], -1)


def build_rectify_map(K, D, R_rect, P_new, rows, cols):
    """Source-pixel lookup map (rows, cols, 2) for the rectified image: each
    rectified pixel is unprojected with P_new, rotated by R_rect^-1 and
    distorted with (K, D) into the raw image."""
    K = np.asarray(K, np.float64)
    R = np.asarray(R_rect, np.float64)
    P = np.asarray(P_new, np.float64)[:3, :3]
    uu, vv = np.meshgrid(np.arange(cols), np.arange(rows))
    xn = (uu - P[0, 2]) / P[0, 0]
    yn = (vv - P[1, 2]) / P[1, 1]
    rays = np.stack([xn, yn, np.ones_like(xn)], -1) @ np.linalg.inv(R).T
    rays = rays / rays[..., 2:]
    xyd = _distort_radtan(rays[..., :2], np.asarray(D, np.float64))
    u_src = xyd[..., 0] * K[0, 0] + K[0, 2]
    v_src = xyd[..., 1] * K[1, 1] + K[1, 2]
    return np.stack([u_src, v_src], -1).astype(np.float32)


def remap_bilinear(img: torch.Tensor, src_map: torch.Tensor) -> torch.Tensor:
    """img (H,W) u8/f32, src_map (H',W',2) on one device -> (H',W') f32,
    0 where the source pixel falls outside the image."""
    im = img.to(torch.float32)
    h, w = im.shape
    x, y = src_map[..., 0], src_map[..., 1]
    inb = (x >= 0) & (x < w - 1) & (y >= 0) & (y < h - 1)
    x = torch.clamp(x, 0.0, w - 1.001)
    y = torch.clamp(y, 0.0, h - 1.001)
    x0 = torch.floor(x).to(torch.int64)
    y0 = torch.floor(y).to(torch.int64)
    fx = x - x0
    fy = y - y0
    out = (im[y0, x0] * (1 - fx) * (1 - fy) + im[y0, x0 + 1] * fx * (1 - fy)
           + im[y0 + 1, x0] * (1 - fx) * fy + im[y0 + 1, x0 + 1] * fx * fy)
    return torch.where(inb, out, 0.0)


class StereoRectifier:
    """Built from the reference YAML schema: ``StereoRectifier.K_left /
    D_left / R_left`` (and ``_right``), with the rectified intrinsics from
    the ``Camera`` section.  The maps live on ``device``."""

    def __init__(self, cam, raw_cfg, device="cuda"):
        self.device = resolve_device(device)
        sr = raw_cfg.get("StereoRectifier", {})
        P = np.array([[float(cam.fx), 0, float(cam.cx)], [0, float(cam.fy), float(cam.cy)],
                      [0, 0, 1]])
        eye = np.eye(3).ravel().tolist()
        self.map_l, self.map_r = (
            torch.from_numpy(build_rectify_map(
                np.array(sr[f"K_{side}"]).reshape(3, 3), sr[f"D_{side}"],
                np.array(sr.get(f"R_{side}", eye)).reshape(3, 3), P, cam.rows, cam.cols)
            ).to(self.device) for side in ("left", "right"))

    def rectify(self, left: np.ndarray, right: np.ndarray):
        """Raw (rows, cols) u8 pair -> rectified u8 pair (host arrays)."""
        return tuple(
            remap_bilinear(torch.from_numpy(np.ascontiguousarray(img)).to(self.device), m)
            .to(torch.uint8).cpu().numpy()
            for img, m in ((left, self.map_l), (right, self.map_r)))
