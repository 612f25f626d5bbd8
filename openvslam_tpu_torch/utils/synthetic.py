"""Synthetic scenes and trajectories (a copy of the numpy parts of
``openvslam_tpu/utils/synthetic.py`` that the tracking step's tests and
``chip_smoke.py`` use; the renderer projects with the port's camera), and
the matcher's adversarial inputs (``adversarial_match_cases``)."""
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


def adversarial_match_cases(rng: np.random.Generator, cols=640, rows=480):
    """Inputs that stress kernel K2's binned search, name -> the nine operands
    of ``ops.match.projection_scale_match`` (CPU tensors):

    * ``outside``: a quarter of the keypoints up to 400 px outside the image
      and a quarter some 10^4 px away, rows inside and outside;
    * ``radii``: radii log-uniform from 0.5 px to 2000 px (beyond the image);
    * ``invisible``: every row invisible;
    * ``ties``: three distinct descriptors and keypoints on a 4-px lattice,
      so most distances are equal, with int32 levels.

    L (1037, 999) is not a multiple of the kernel's rows per block.  Half the
    keypoints sit near a row and carry its descriptor with 5 % of the bits
    flipped, so every case but ``invisible`` has matches."""
    from ..ops.orb import pack_bits

    def make(L, K, uv, xy, radius, vis=None, n_desc=0, level_dtype=np.int64):
        if n_desc:
            pool = rng.integers(0, 2, (n_desc, 256))
            a, b = pool[rng.integers(0, n_desc, L)], pool[rng.integers(0, n_desc, K)]
        else:
            a, b = rng.integers(0, 2, (L, 256)), rng.integers(0, 2, (K, 256))
            near = min(L, K) // 2
            b[:near] = a[:near] ^ (rng.random((near, 256)) < 0.05)
        vis = rng.random(L) > 0.1 if vis is None else vis
        t = [pack_bits(torch.from_numpy(a.astype(np.int8))),
             pack_bits(torch.from_numpy(b.astype(np.int8))),
             torch.from_numpy(uv.astype(np.float32)), torch.from_numpy(vis),
             torch.from_numpy(radius.astype(np.float32)),
             torch.from_numpy(rng.integers(-1, 8, L).astype(level_dtype)),
             torch.from_numpy(xy.astype(np.float32)),
             torch.from_numpy(rng.integers(0, 8, K).astype(level_dtype)),
             torch.from_numpy(rng.random(K) > 0.1)]
        return t

    def layout(L, K, spread):
        uv = rng.uniform([-50, -50], [cols + 50, rows + 50], (L, 2))
        xy = rng.uniform([0, 0], [cols, rows], (K, 2))
        near = min(L, K) // 2
        xy[:near] = uv[:near] + rng.normal(0, spread, (near, 2))
        return uv, xy

    L, K = 1037, 517
    uv, xy = layout(L, K, 6.0)
    q = K // 4
    xy[K - 2 * q: K - q] = rng.uniform([-400, -400], [cols + 400, rows + 400], (q, 2))
    xy[K - q:] = rng.uniform(-1e4, 1e4, (q, 2))
    cases = {"outside": make(L, K, uv, xy, rng.uniform(4, 60, L))}
    uv, xy = layout(L, K, 20.0)
    cases["radii"] = make(L, K, uv, xy, np.exp(rng.uniform(np.log(0.5), np.log(2000.0), L)))
    uv, xy = layout(L, K, 6.0)
    cases["invisible"] = make(L, K, uv, xy, rng.uniform(4, 60, L), vis=np.zeros(L, bool))
    L, K = 999, 1000
    uv, xy = layout(L, K, 6.0)
    xy = np.round(xy / 4.0) * 4.0
    cases["ties"] = make(L, K, uv, xy, rng.uniform(5, 40, L), n_desc=3, level_dtype=np.int32)
    return cases
