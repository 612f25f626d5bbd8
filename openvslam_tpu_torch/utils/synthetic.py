"""Synthetic scenes and trajectories (a copy of the numpy parts of
``openvslam_tpu/utils/synthetic.py`` that the tracking step's tests and
``chip_smoke.py`` use; the renderer projects with the port's camera)."""
from __future__ import annotations

import numpy as np
import torch


def landmark_cloud(rng: np.random.Generator, n: int, center=(0, 0, 6), extent=(4, 3, 2)):
    c = np.asarray(center, np.float64)
    e = np.asarray(extent, np.float64)
    return c + (rng.random((n, 3)) - 0.5) * 2 * e


def lookat_pose_cw(eye, target, up=(0, -1, 0)):
    """Camera-from-world pose with the camera at ``eye`` looking at ``target``
    (+z forward, +x right, +y down)."""
    eye = np.asarray(eye, np.float64)
    target = np.asarray(target, np.float64)
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(np.asarray(up, np.float64), fwd)
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    R_wc = np.stack([right, down, fwd], axis=1)
    T = np.eye(4)
    T[:3, :3] = R_wc.T
    T[:3, 3] = -R_wc.T @ eye
    return T


def orbit_trajectory(n_frames: int, radius=2.0, target=(0, 0, 6), arc=np.pi / 3):
    """Smooth sideways arc of camera poses looking at ``target`` -> (N,4,4) T_cw."""
    return np.stack([lookat_pose_cw([radius * np.sin(a), 0.0, radius * (1 - np.cos(a))], target)
                     for a in np.linspace(-arc / 2, arc / 2, n_frames)])


class PatchSceneRenderer:
    """A cloud of 3-D points, each carrying a fixed random texture patch; a
    frame draws every visible point's patch at its projected pixel, far
    points first."""

    def __init__(self, rng: np.random.Generator, n_points=800,
                 center=(0, 0, 6), extent=(7, 5, 2.5), patch=9, rows=480, cols=640):
        self.points = landmark_cloud(rng, n_points, center, extent)
        self.textures = rng.integers(40, 256, size=(n_points, patch, patch)).astype(np.uint8)
        self.patch = patch
        self.rows = rows
        self.cols = cols

    def render(self, cam, T_cw: np.ndarray) -> np.ndarray:
        img = np.zeros((self.rows, self.cols), np.uint8)
        pc = (T_cw[:3, :3] @ self.points.T).T + T_cw[:3, 3]
        uv, depth, valid = (t.numpy() for t in cam.project(torch.from_numpy(pc.astype(np.float32))))
        r = self.patch // 2
        for i in np.argsort(-depth):
            if not valid[i]:
                continue
            u, v = int(round(uv[i, 0])), int(round(uv[i, 1]))
            y0, y1 = v - r, v + r + 1
            x0, x1 = u - r, u + r + 1
            ty0, tx0 = max(0, -y0), max(0, -x0)
            y0, x0 = max(0, y0), max(0, x0)
            y1, x1 = min(self.rows, y1), min(self.cols, x1)
            if y1 <= y0 or x1 <= x0:
                continue
            img[y0:y1, x0:x1] = self.textures[i][ty0:ty0 + (y1 - y0), tx0:tx0 + (x1 - x0)]
        return img
