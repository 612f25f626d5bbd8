"""Trajectory writers/readers in TUM and KITTI formats (a copy of
``openvslam_tpu/io/trajectory_io.py``; ref ``io/trajectory_io.*``).

TUM:   `ts tx ty tz qx qy qz qw` per line (world<-camera translation+rotation).
KITTI: 12 floats per line, 3x4 row-major world<-camera matrix.

The reference stores poses camera<-world internally and writes the inverse
(world<-camera) to disk; we do the same.
"""
from __future__ import annotations

import numpy as np


def _invert_poses(poses_cw: np.ndarray) -> np.ndarray:
    poses_cw = np.asarray(poses_cw, np.float64)
    R = poses_cw[:, :3, :3]
    t = poses_cw[:, :3, 3]
    Rwc = np.transpose(R, (0, 2, 1))
    twc = -np.einsum("nij,nj->ni", Rwc, t)
    out = np.tile(np.eye(4), (poses_cw.shape[0], 1, 1))
    out[:, :3, :3] = Rwc
    out[:, :3, 3] = twc
    return out


def _rot_to_quat(R: np.ndarray) -> np.ndarray:
    """(3,3) -> (qx,qy,qz,qw)."""
    m = R
    tr = np.trace(m)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        qw = 0.25 * s
        qx = (m[2, 1] - m[1, 2]) / s
        qy = (m[0, 2] - m[2, 0]) / s
        qz = (m[1, 0] - m[0, 1]) / s
    elif m[0, 0] > m[1, 1] and m[0, 0] > m[2, 2]:
        s = np.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2]) * 2
        qw = (m[2, 1] - m[1, 2]) / s
        qx = 0.25 * s
        qy = (m[0, 1] + m[1, 0]) / s
        qz = (m[0, 2] + m[2, 0]) / s
    elif m[1, 1] > m[2, 2]:
        s = np.sqrt(1.0 + m[1, 1] - m[0, 0] - m[2, 2]) * 2
        qw = (m[0, 2] - m[2, 0]) / s
        qx = (m[0, 1] + m[1, 0]) / s
        qy = 0.25 * s
        qz = (m[1, 2] + m[2, 1]) / s
    else:
        s = np.sqrt(1.0 + m[2, 2] - m[0, 0] - m[1, 1]) * 2
        qw = (m[1, 0] - m[0, 1]) / s
        qx = (m[0, 2] + m[2, 0]) / s
        qy = (m[1, 2] + m[2, 1]) / s
        qz = 0.25 * s
    return np.array([qx, qy, qz, qw])


def _quat_to_rot(q: np.ndarray) -> np.ndarray:
    x, y, z, w = q / np.linalg.norm(q)
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ]
    )


def save_trajectory_tum(path, timestamps, poses_cw):
    poses_wc = _invert_poses(poses_cw)
    with open(path, "w") as f:
        for ts, T in zip(timestamps, poses_wc):
            q = _rot_to_quat(T[:3, :3])
            t = T[:3, 3]
            f.write(
                f"{ts:.9f} {t[0]:.9f} {t[1]:.9f} {t[2]:.9f} "
                f"{q[0]:.9f} {q[1]:.9f} {q[2]:.9f} {q[3]:.9f}\n"
            )


def load_trajectory_tum(path):
    """Returns (timestamps (N,), poses_cw (N,4,4))."""
    ts_list, poses = [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            v = [float(x) for x in line.split()]
            ts_list.append(v[0])
            T = np.eye(4)
            T[:3, :3] = _quat_to_rot(np.array(v[4:8]))
            T[:3, 3] = v[1:4]
            poses.append(T)
    poses_wc = np.stack(poses) if poses else np.zeros((0, 4, 4))
    return np.array(ts_list), _invert_poses(poses_wc)


def save_trajectory_kitti(path, poses_cw):
    poses_wc = _invert_poses(poses_cw)
    with open(path, "w") as f:
        for T in poses_wc:
            row = T[:3, :].reshape(-1)
            f.write(" ".join(f"{v:.9e}" for v in row) + "\n")


def load_trajectory_kitti(path):
    """Returns poses_cw (N,4,4)."""
    poses = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            v = np.array([float(x) for x in line.split()]).reshape(3, 4)
            T = np.eye(4)
            T[:3, :] = v
            poses.append(T)
    poses_wc = np.stack(poses) if poses else np.zeros((0, 4, 4))
    return _invert_poses(poses_wc)
