"""Synthetic scenes and trajectories (a copy of the numpy parts of
``openvslam_tpu/utils/synthetic.py`` that the port's tests and
``chip_smoke.py`` use: the patch scene and orbit, and the textured n-gon
room with its lap trajectory; the renderers project with the port's
camera), and the matcher's adversarial inputs (``adversarial_match_cases``)."""
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


def lap_trajectory(n_frames: int, radius=6.0, laps=1.0, start_angle=0.0):
    """Camera circling inside the room looking radially outward -> (N,4,4)."""
    out = []
    for i in range(n_frames):
        a = start_angle + 2 * np.pi * laps * i / n_frames
        eye = np.array([radius * np.cos(a), 0.0, radius * np.sin(a)])
        out.append(lookat_pose_cw(eye, eye * 2.5))
    return np.stack(out)


def noise_texture(rng: np.random.Generator, th: int, tw: int,
                  octaves=((4, 0.2), (16, 0.4), (64, 1.0), (128, 0.6)),
                  dots=True) -> np.ndarray:
    """Multi-octave value-noise texture with FAST-friendly structure,
    float32 in [20, 245]."""
    tex = np.zeros((th, tw))
    for octave, amp in octaves:
        gh = max(2, octave * th // max(th, tw))
        gw = max(2, octave)
        coarse = rng.random((gh, gw))
        yi = np.linspace(0, gh - 1, th)
        xi = np.linspace(0, gw - 1, tw)
        y0 = np.floor(yi).astype(int)
        x0 = np.floor(xi).astype(int)
        y1 = np.minimum(y0 + 1, gh - 1)
        x1 = np.minimum(x0 + 1, gw - 1)
        fy = (yi - y0)[:, None]
        fx = (xi - x0)[None, :]
        tex += amp * (coarse[np.ix_(y0, x0)] * (1 - fy) * (1 - fx)
                      + coarse[np.ix_(y0, x1)] * (1 - fy) * fx
                      + coarse[np.ix_(y1, x0)] * fy * (1 - fx)
                      + coarse[np.ix_(y1, x1)] * fy * fx)
    if dots:
        # salt-and-pepper corners
        n_dots = tw * th // 300
        ys = rng.integers(1, th - 1, n_dots)
        xs = rng.integers(1, tw - 1, n_dots)
        tex[ys, xs] += rng.uniform(-1.5, 1.5, n_dots)
    tex -= tex.min()
    tex /= max(tex.max(), 1e-9)
    return (20 + tex * 225).astype(np.float32)


class RoomSceneRenderer:
    """Textured walls of a regular n-gon room with the camera inside: full
    laps revisit their start (the loop-closure topology).  numpy ray casting
    against the wall planes; the nearest valid hit wins."""

    def __init__(self, rng: np.random.Generator, half=10.0, y_range=(-5.0, 5.0),
                 res=40, rows=320, cols=416, n_walls=8,
                 octaves=((4, 0.2), (16, 0.4), (64, 1.0), (128, 0.6)), dots=True):
        self.half = half
        self.rows = rows
        self.cols = cols
        self.y0, self.y1 = y_range
        self.res = res
        wall_w = 2 * half * np.tan(np.pi / n_walls)
        self.walls = []
        self.defs = []
        for k in range(n_walls):
            # the JAX package draws each wall's texture as that of a plane
            # scene spanning x in [0, wall_w): the same shape and draws
            tw = int((wall_w - 0.0) * res)
            th = int((self.y1 - self.y0) * res)
            self.walls.append(noise_texture(rng, th, tw, octaves, dots))
            a = 2 * np.pi * k / n_walls
            n = np.array([np.cos(a), 0.0, np.sin(a)])
            u = np.array([-np.sin(a), 0.0, np.cos(a)])
            self.defs.append((half * n, n, u))
        self.wall_w = wall_w

    def render(self, cam, T_cw: np.ndarray) -> np.ndarray:
        uu, vv = np.meshgrid(np.arange(self.cols), np.arange(self.rows))
        pix = np.stack([uu.reshape(-1), vv.reshape(-1)], -1).astype(np.float32)
        brg = cam.keypoints_to_bearings(torch.from_numpy(pix)).numpy()
        R = T_cw[:3, :3]
        c = -R.T @ T_cw[:3, 3]
        d = brg @ R
        best_lam = np.full(len(d), np.inf)
        out = np.zeros(len(d), np.float32)
        for (p0, n, u_axis), tex in zip(self.defs, self.walls):
            denom = d @ n
            lam = ((p0 - c) @ n) / np.where(np.abs(denom) < 1e-9, 1e-9, denom)
            X = c[None, :] + lam[:, None] * d
            tu = (X @ u_axis + self.wall_w / 2) * self.res
            tv = (X[:, 1] - self.y0) * self.res
            th, tw = tex.shape
            ok = ((lam > 1e-3) & (lam < best_lam)
                  & (tu >= 0) & (tu < tw - 1) & (tv >= 0) & (tv < th - 1))
            x0 = np.clip(np.floor(tu).astype(int), 0, tw - 2)
            y0 = np.clip(np.floor(tv).astype(int), 0, th - 2)
            fx = np.clip(tu - x0, 0, 1)
            fy = np.clip(tv - y0, 0, 1)
            val = (tex[y0, x0] * (1 - fx) * (1 - fy) + tex[y0, x0 + 1] * fx * (1 - fy)
                   + tex[y0 + 1, x0] * (1 - fx) * fy + tex[y0 + 1, x0 + 1] * fx * fy)
            out = np.where(ok, val, out)
            best_lam = np.where(ok, lam, best_lam)
        return out.reshape(self.rows, self.cols).astype(np.uint8)


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
