"""Synthetic scenes and trajectories (a copy of the numpy parts of
``openvslam_tpu/utils/synthetic.py``: random poses, the patch scene and
orbit, the textured n-gon room with its lap trajectory, the street course
and its drive, and the sensor photometrics; the renderers project with the
port's camera, and the room and the street course also render with torch
ops on any device, ``RoomSceneRenderer.render_torch`` and
``CityCourseRenderer.render_sequence_torch``), and the matcher's
adversarial inputs (``adversarial_match_cases``)."""
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


def orbit_trajectory(n_frames: int, radius=2.0, height=0.0, target=(0, 0, 6),
                     arc=np.pi / 3, jitter=0.0, rng=None):
    """Smooth sideways arc of camera poses looking at ``target`` -> (N,4,4)
    T_cw; with ``jitter`` and ``rng`` each eye moves by a uniform draw in
    [-jitter/2, jitter/2)^3."""
    poses = []
    for a in np.linspace(-arc / 2, arc / 2, n_frames):
        eye = np.array([radius * np.sin(a), height, radius * (1 - np.cos(a))])
        if jitter and rng is not None:
            eye = eye + (rng.random(3) - 0.5) * jitter
        poses.append(lookat_pose_cw(eye, target))
    return np.stack(poses)


def random_pose_cw(rng: np.random.Generator, max_angle=0.5, max_trans=1.0):
    """A pose with a rotation of uniform axis-angle components in
    [-max_angle, max_angle) and a translation in [-max_trans, max_trans)."""
    w = (rng.random(3) - 0.5) * 2 * max_angle
    theta = np.linalg.norm(w)
    if theta < 1e-12:
        R = np.eye(3)
    else:
        k = w / theta
        K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
        R = np.eye(3) + np.sin(theta) * K + (1 - np.cos(theta)) * K @ K
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = (rng.random(3) - 0.5) * 2 * max_trans
    return T


def random_sim3(rng: np.random.Generator, max_angle=0.5, max_trans=1.0, scale_range=(0.5, 2.0)):
    """(R, t, s): ``random_pose_cw``'s rotation and translation and a
    uniform scale."""
    T = random_pose_cw(rng, max_angle, max_trans)
    s = rng.uniform(*scale_range)
    return T[:3, :3], T[:3, 3], s


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


class PlaneSceneRenderer:
    """A multi-octave noise texture on the world plane z = plane_z, rendered
    by per-pixel ray casting (numpy): a continuous texture whose keypoint
    neighbourhoods move rigidly with the surface; a planar scene, so the
    two-view bootstrap takes its homography path."""

    def __init__(self, rng: np.random.Generator, x_range=(-4.0, 18.0), y_range=(-6.0, 6.0),
                 plane_z=7.0, res=60, rows=320, cols=416,
                 octaves=((4, 0.2), (16, 0.4), (64, 1.0), (128, 0.6)), dots=True):
        self.x0, self.x1 = x_range
        self.y0, self.y1 = y_range
        self.plane_z = plane_z
        self.res = res
        self.rows = rows
        self.cols = cols
        tw = int((self.x1 - self.x0) * res)
        th = int((self.y1 - self.y0) * res)
        self.texture = noise_texture(rng, th, tw, octaves, dots)

    def render(self, cam, T_cw: np.ndarray) -> np.ndarray:
        uu, vv = np.meshgrid(np.arange(self.cols), np.arange(self.rows))
        pix = np.stack([uu.reshape(-1), vv.reshape(-1)], -1).astype(np.float32)
        brg = cam.keypoints_to_bearings(torch.from_numpy(pix)).numpy()
        R = T_cw[:3, :3]
        c = -R.T @ T_cw[:3, 3]                # camera centre, world
        d = brg @ R                           # ray directions, world
        dz = d[:, 2]
        lam = (self.plane_z - c[2]) / np.where(np.abs(dz) < 1e-9, 1e-9, dz)
        X = c[None, :] + lam[:, None] * d
        tx = (X[:, 0] - self.x0) * self.res
        ty = (X[:, 1] - self.y0) * self.res
        tex = self.texture
        th, tw = tex.shape
        x0 = np.clip(np.floor(tx).astype(int), 0, tw - 2)
        y0 = np.clip(np.floor(ty).astype(int), 0, th - 2)
        fx = np.clip(tx - x0, 0, 1)
        fy = np.clip(ty - y0, 0, 1)
        val = (tex[y0, x0] * (1 - fx) * (1 - fy) + tex[y0, x0 + 1] * fx * (1 - fy)
               + tex[y0 + 1, x0] * (1 - fx) * fy + tex[y0 + 1, x0 + 1] * fx * fy)
        inside = (lam > 0) & (tx >= 0) & (tx < tw - 1) & (ty >= 0) & (ty < th - 1)
        return np.where(inside, val, 0.0).reshape(self.rows, self.cols).astype(np.uint8)


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

    def render_torch(self, cam, T_cw: np.ndarray, device) -> torch.Tensor:
        """``render`` as torch ops on ``device`` (float64 rays and texture
        weights, as numpy computes them): a (rows, cols) uint8 tensor there.
        A 1920x960 frame takes seconds in numpy on the host."""
        dev = torch.device(device)
        f64 = torch.float64
        cache = self.__dict__.setdefault("_walls_dev", {})
        if dev not in cache:
            cache[dev] = [torch.from_numpy(t).to(dev).reshape(-1) for t in self.walls]
        vv, uu = torch.meshgrid(torch.arange(self.rows, device=dev),
                                torch.arange(self.cols, device=dev), indexing="ij")
        pix = torch.stack([uu.reshape(-1), vv.reshape(-1)], -1).to(torch.float32)
        brg = cam.keypoints_to_bearings(pix).to(f64)
        c_h = -T_cw[:3, :3].T @ T_cw[:3, 3]
        c = torch.as_tensor(c_h, dtype=f64, device=dev)
        d = brg @ torch.as_tensor(T_cw[:3, :3], dtype=f64, device=dev)
        best = torch.full((d.shape[0],), float("inf"), dtype=f64, device=dev)
        out = torch.zeros(d.shape[0], dtype=f64, device=dev)
        for (p0, n, u_axis), tex, flat in zip(self.defs, self.walls, cache[dev]):
            n_t, u_t = (torch.as_tensor(a, dtype=f64, device=dev) for a in (n, u_axis))
            denom = d @ n_t
            lam = float((p0 - c_h) @ n) / torch.where(
                torch.abs(denom) < 1e-9, torch.full_like(denom, 1e-9), denom)
            X = c[None, :] + lam[:, None] * d
            tu = (X @ u_t + self.wall_w / 2) * self.res
            tv = (X[:, 1] - self.y0) * self.res
            th, tw = tex.shape
            ok = ((lam > 1e-3) & (lam < best) & (tu >= 0) & (tu < tw - 1) & (tv >= 0)
                  & (tv < th - 1))
            x0 = torch.clamp(torch.floor(tu), 0, tw - 2).to(torch.int64)
            y0 = torch.clamp(torch.floor(tv), 0, th - 2).to(torch.int64)
            fx = torch.clamp(tu - x0, 0, 1)
            fy = torch.clamp(tv - y0, 0, 1)
            at = lambda y, x: flat[y * tw + x].to(f64)  # noqa: E731
            val = (at(y0, x0) * (1 - fx) * (1 - fy) + at(y0, x0 + 1) * fx * (1 - fy)
                   + at(y0 + 1, x0) * (1 - fx) * fy + at(y0 + 1, x0 + 1) * fx * fy)
            out = torch.where(ok, val, out)
            best = torch.where(ok, lam, best)
        return out.reshape(self.rows, self.cols).to(torch.uint8)


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


class RoundedRectCourse:
    """Closed centre line of a rounded-rectangle street circuit in the
    (x, z) ground plane: long straights, 90-degree corners of radius
    ``corner_r`` and an exact return to the start.  Parameterized by
    arclength s in [0, length); ``point`` and ``tangent`` take arrays of s."""

    def __init__(self, straight_x: float = 220.0, straight_z: float = 220.0,
                 corner_r: float = 20.0):
        self.sx = float(straight_x)
        self.sz = float(straight_z)
        self.r = float(corner_r)
        arc = np.pi / 2 * self.r
        # +x straight, corner, +z straight, corner, -x straight, corner,
        # -z straight, corner (counter-clockwise seen from +y)
        self.piece_len = np.array([self.sx, arc, self.sz, arc, self.sx, arc, self.sz, arc])
        self.cum = np.concatenate([[0.0], np.cumsum(self.piece_len)])
        self.length = float(self.cum[-1])
        hx, hz, r = self.sx / 2, self.sz / 2, self.r
        self.p0 = np.array([[-hx, -hz - r], [hx, -hz - r], [hx + r, -hz], [hx + r, hz],
                            [hx, hz + r], [-hx, hz + r], [-hx - r, hz], [-hx - r, -hz]])
        self.dirs = np.array([[1, 0], [0, 0], [0, 1], [0, 0],
                              [-1, 0], [0, 0], [0, -1], [0, 0]], float)
        self.corner_c = np.array([[hx, -hz], [hx, hz], [-hx, hz], [-hx, -hz]])
        # corner k turns from angle a0 to a0 + pi/2 about its centre
        self.corner_a0 = np.array([-np.pi / 2, 0.0, np.pi / 2, np.pi])

    def _locate(self, s):
        s = np.mod(np.asarray(s, float), self.length)
        piece = np.clip(np.searchsorted(self.cum, s, side="right") - 1, 0, 7)
        return piece, s - self.cum[piece]

    def point(self, s) -> np.ndarray:
        """(..., 2) (x, z) positions on the centre line."""
        piece, local = self._locate(s)
        out = np.zeros(piece.shape + (2,))
        straight = piece % 2 == 0
        out[straight] = self.p0[piece[straight]] + local[straight, None] * self.dirs[piece[straight]]
        crn = ~straight
        k = piece[crn] // 2
        ang = self.corner_a0[k] + local[crn] / self.r
        out[crn] = self.corner_c[k] + self.r * np.stack([np.cos(ang), np.sin(ang)], -1)
        return out

    def tangent(self, s) -> np.ndarray:
        """(..., 2) unit tangents, in the direction of travel."""
        piece, local = self._locate(s)
        out = np.zeros(piece.shape + (2,))
        straight = piece % 2 == 0
        out[straight] = self.dirs[piece[straight]]
        crn = ~straight
        k = piece[crn] // 2
        ang = self.corner_a0[k] + local[crn] / self.r
        out[crn] = np.stack([-np.sin(ang), np.cos(ang)], -1)
        return out


class CityCourseRenderer:
    """A street canyon along a closed course: textured building walls on
    both sides of the street and a textured road, rendered by casting a ray
    per sample against planar quads, with distance and back-face culling.
    It is the KITTI 00-class scene: a circuit of hundreds of metres whose
    end revisits its start.

    Quads are vertical wall segments of about ``seg_len`` m tangent to the
    course's offset curves and road quads spanning the street between
    them; their textures lie in one padded atlas.  Camera +y is down, so
    the road is at y = +road_y.  ``render`` is numpy on the host;
    ``render_sequence_torch`` renders a sequence with torch ops on any
    device."""

    RAY_CHUNK = 65536

    def __init__(self, rng: np.random.Generator, course,
                 street_half_w: float = 4.0, wall_y=(-4.5, 1.5),
                 road_y: float = 1.5, seg_len: float = 8.0,
                 res: float = 24.0, max_dist: float = 70.0,
                 octaves=((4, 0.2), (16, 0.4), (64, 1.0), (128, 0.6)), dots=True):
        self.course = course
        self.max_dist = float(max_dist)
        n_seg = int(np.ceil(course.length / seg_len))
        s = np.linspace(0.0, course.length, n_seg + 1)
        pts = course.point(s)
        tans = course.tangent(s)
        nrm = np.stack([-tans[:, 1], tans[:, 0]], -1)     # left normal in the ground plane
        left = pts + street_half_w * nrm
        right = pts - street_half_w * nrm
        y0, y1 = wall_y
        wall_h = y1 - y0
        quads = []        # (p0, n, u_axis, v_axis, half_u, half_v, texture)

        def wall(a2, b2, inward2):
            mid = (a2 + b2) / 2
            seg = b2 - a2
            ln = np.linalg.norm(seg)
            if ln < 1e-6:
                return
            u2 = seg / ln
            tex = noise_texture(rng, max(8, int(wall_h * res)), max(8, int(ln * res)),
                                octaves, dots)
            quads.append((np.array([mid[0], (y0 + y1) / 2, mid[1]]),
                          np.array([inward2[0], 0.0, inward2[1]]),
                          np.array([u2[0], 0.0, u2[1]]), np.array([0.0, 1.0, 0.0]),
                          ln / 2, wall_h / 2, tex))

        for i in range(n_seg):
            inward = -nrm[i]                 # from the left wall toward the street
            wall(left[i], left[i + 1], inward)
            wall(right[i], right[i + 1], -inward)
            mid = (pts[i] + pts[i + 1]) / 2
            seg = pts[i + 1] - pts[i]
            ln = np.linalg.norm(seg)
            if ln < 1e-6:
                continue
            u2 = seg / ln
            tex = noise_texture(rng, max(8, int(2 * street_half_w * res)), max(8, int(ln * res)),
                                octaves, dots)
            quads.append((np.array([mid[0], road_y, mid[1]]), np.array([0.0, -1.0, 0.0]),
                          np.array([u2[0], 0.0, u2[1]]), np.array([nrm[i][0], 0.0, nrm[i][1]]),
                          ln / 2, street_half_w, tex))

        self.quad_p0 = np.stack([q[0] for q in quads]).astype(np.float32)
        self.quad_n = np.stack([q[1] for q in quads]).astype(np.float32)
        self.quad_u = np.stack([q[2] for q in quads]).astype(np.float32)
        self.quad_v = np.stack([q[3] for q in quads]).astype(np.float32)
        self.quad_hu = np.array([q[4] for q in quads], np.float32)
        self.quad_hv = np.array([q[5] for q in quads], np.float32)
        self.textures = [q[6] for q in quads]
        th_max = max(t.shape[0] for t in self.textures)
        tw_max = max(t.shape[1] for t in self.textures)
        self.atlas = np.zeros((len(quads), th_max, tw_max), np.float32)
        self.tex_h = np.zeros(len(quads), np.int32)
        self.tex_w = np.zeros(len(quads), np.int32)
        for i, t in enumerate(self.textures):
            self.atlas[i, :t.shape[0], :t.shape[1]] = t
            self.tex_h[i], self.tex_w[i] = t.shape
        self.res = res
        self._bearing_cache = {}
        self._device_cache = {}

    def _bearings(self, cam, ss: int = 1) -> np.ndarray:
        """(rows*ss * cols*ss, 3) float64 bearings of an ss x ss grid of
        samples in each pixel (the supersampling box-filters the texture's
        minification, which would alias from frame to frame)."""
        key = (cam.rows, cam.cols, id(type(cam)), ss)
        if key not in self._bearing_cache:
            sub = (np.arange(ss) + 0.5) / ss - 0.5
            us = (np.arange(cam.cols)[:, None] + sub[None, :]).reshape(-1)
            vs = (np.arange(cam.rows)[:, None] + sub[None, :]).reshape(-1)
            uu, vv = np.meshgrid(us, vs)
            pix = np.stack([uu.reshape(-1), vv.reshape(-1)], -1).astype(np.float32)
            self._bearing_cache[key] = cam.keypoints_to_bearings(
                torch.from_numpy(pix)).numpy().astype(np.float64)
        return self._bearing_cache[key]

    def _cull(self, c: np.ndarray) -> np.ndarray:
        """Indices of the quads whose centre lies within ``max_dist`` of the
        camera centre ``c`` (float32) and that face it."""
        rel = self.quad_p0 - c[None, :]
        near = np.einsum("ij,ij->i", rel, rel) < self.max_dist ** 2
        facing = np.einsum("ij,ij->i", rel, self.quad_n) < 0
        return np.where(near & facing)[0]

    def render(self, cam, T_cw: np.ndarray, ss: int = 1) -> np.ndarray:
        R = T_cw[:3, :3].astype(np.float32)
        t = T_cw[:3, 3].astype(np.float32)
        c = -R.T @ t
        d = (self._bearings(cam, ss) @ R).astype(np.float32)     # (P, 3) rays, world
        idx = self._cull(c)
        P = len(d)
        if len(idx) == 0:
            return np.zeros((cam.rows, cam.cols), np.uint8)
        n = self.quad_n[idx]
        p0 = self.quad_p0[idx]
        denom = d @ n.T                                          # (P, V)
        denom = np.where(np.abs(denom) < 1e-9, 1e-9, denom)
        lam = np.einsum("vk,vk->v", p0 - c[None, :], n)[None, :] / denom
        # texture coordinates of the hit, (c - p0).u + lam (d.u), without a
        # (P, V, 3) intermediate
        u_ax, v_ax = self.quad_u[idx], self.quad_v[idx]
        cu = np.einsum("vk,vk->v", c[None, :] - p0, u_ax)
        cv = np.einsum("vk,vk->v", c[None, :] - p0, v_ax)
        tu = cu[None, :] + lam * (d @ u_ax.T)
        tv = cv[None, :] + lam * (d @ v_ax.T)
        ok = ((lam > 1e-3) & (np.abs(tu) < self.quad_hu[idx][None, :])
              & (np.abs(tv) < self.quad_hv[idx][None, :]))
        lam_ok = np.where(ok, lam, np.inf)
        w = np.argmin(lam_ok, axis=1)                            # the nearest visible quad
        hit = np.isfinite(lam_ok[np.arange(P), w])
        qw = idx[w]
        px = (tu[np.arange(P), w] + self.quad_hu[qw]) * self.res
        py = (tv[np.arange(P), w] + self.quad_hv[qw]) * self.res
        x0 = np.clip(np.floor(px).astype(int), 0, self.tex_w[qw] - 2)
        y0 = np.clip(np.floor(py).astype(int), 0, self.tex_h[qw] - 2)
        fx = np.clip(px - x0, 0, 1)
        fy = np.clip(py - y0, 0, 1)
        at = self.atlas
        val = (at[qw, y0, x0] * (1 - fx) * (1 - fy) + at[qw, y0, x0 + 1] * fx * (1 - fy)
               + at[qw, y0 + 1, x0] * (1 - fx) * fy + at[qw, y0 + 1, x0 + 1] * fx * fy)
        out = np.where(hit, val, 0.0)
        if ss > 1:
            out = out.reshape(cam.rows, ss, cam.cols, ss).mean(axis=(1, 3))
        return out.reshape(cam.rows, cam.cols).astype(np.uint8)

    def _on_device(self, dev: torch.device) -> dict:
        """The quads and the whole texture atlas as tensors on ``dev``."""
        if dev not in self._device_cache:
            arr = dict(n=self.quad_n, u=self.quad_u, v=self.quad_v, hu=self.quad_hu,
                       hv=self.quad_hv, tex_h=self.tex_h.astype(np.int64),
                       tex_w=self.tex_w.astype(np.int64), atlas=self.atlas.reshape(-1))
            self._device_cache[dev] = {k: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                                       for k, a in arr.items()}
        return self._device_cache[dev]

    def render_sequence_torch(self, cam, poses_cw, ss: int = 1, device="cuda") -> torch.Tensor:
        """``render`` of each of ``poses_cw`` (N, 4, 4) T_cw with torch ops on
        ``device`` -> (N, rows, cols) uint8 tensor there.

        The rules are ``render``'s: the same culling (on the host, per
        frame), the nearest visible quad per sample, the bilinear atlas
        texel at its texture coordinates, the ss x ss mean, truncated to
        uint8.  The rays go through in chunks of ``RAY_CHUNK``, so that the
        device holds one chunk's (C, V) intermediates at a time.  The
        ray-quad dot products are elementwise float32 sums: no TF32 matmul
        lowers them (texture coordinates that jitter by a fraction of a
        texel from frame to frame shimmer the textures and destabilize
        descriptors at distance).  Frames go one at a time: each has its own
        culled quads."""
        dev = torch.device(device)
        q = self._on_device(dev)
        brg = torch.from_numpy(self._bearings(cam, ss)).to(dev)         # (P, 3) float64
        poses = np.asarray(poses_cw)
        out = torch.zeros((len(poses), cam.rows, cam.cols), dtype=torch.uint8, device=dev)
        for i, T in enumerate(poses):
            R = T[:3, :3].astype(np.float32)
            c = -R.T @ T[:3, 3].astype(np.float32)
            idx = self._cull(c)
            if len(idx):
                p0 = self.quad_p0[idx]
                num, cu, cv = (torch.from_numpy(a).to(dev) for a in (
                    np.einsum("vk,vk->v", p0 - c[None, :], self.quad_n[idx]),
                    np.einsum("vk,vk->v", c[None, :] - p0, self.quad_u[idx]),
                    np.einsum("vk,vk->v", c[None, :] - p0, self.quad_v[idx])))
                d = (brg @ torch.from_numpy(R.astype(np.float64)).to(dev)).to(torch.float32)
                img = self._render_rays(q, d, torch.from_numpy(idx).to(dev), num, cu, cv)
                if ss > 1:
                    img = img.reshape(cam.rows, ss, cam.cols, ss).mean(dim=(1, 3))
                out[i] = img.reshape(cam.rows, cam.cols).to(torch.uint8)
        return out

    def _render_rays(self, q: dict, d: torch.Tensor, idx: torch.Tensor, num: torch.Tensor,
                     cu: torch.Tensor, cv: torch.Tensor) -> torch.Tensor:
        """Rays ``d`` (P, 3) float32 in the world against the culled quads
        ``idx`` (V,), given (p0 - c).n, (c - p0).u and (c - p0).v of each ->
        (P,) float64 sample values (the texel weights in float64, as
        ``render`` forms them)."""
        th, tw = self.atlas.shape[1], self.atlas.shape[2]
        n, u, v = q["n"][idx], q["u"][idx], q["v"][idx]
        hu, hv = q["hu"][idx], q["hv"][idx]
        vals = []
        for c0 in range(0, d.shape[0], self.RAY_CHUNK):
            dc = d[c0:c0 + self.RAY_CHUNK]

            def dots(a):                                          # (C, V): dc . a^T
                return dc[:, 0:1] * a[:, 0] + dc[:, 1:2] * a[:, 1] + dc[:, 2:3] * a[:, 2]

            denom = dots(n)
            denom = torch.where(denom.abs() < 1e-9, torch.full_like(denom, 1e-9), denom)
            lam = num[None, :] / denom
            du, dv = dots(u), dots(v)
            ok = ((lam > 1e-3) & ((cu[None, :] + lam * du).abs() < hu[None, :])
                  & ((cv[None, :] + lam * dv).abs() < hv[None, :]))
            lam_ok = torch.where(ok, lam, torch.full_like(lam, float("inf")))
            w = torch.argmin(lam_ok, dim=1, keepdim=True)       # (C, 1) the nearest visible quad
            hit = torch.isfinite(torch.gather(lam_ok, 1, w)[:, 0])
            # the texture coordinates again, at the winning quad only
            lam_w = torch.gather(lam, 1, w)[:, 0]
            tu = cu[w[:, 0]] + lam_w * torch.gather(du, 1, w)[:, 0]
            tv = cv[w[:, 0]] + lam_w * torch.gather(dv, 1, w)[:, 0]
            qw = idx[w[:, 0]]
            px = (tu + q["hu"][qw]) * self.res
            py = (tv + q["hv"][qw]) * self.res
            x0 = torch.minimum(torch.floor(px).clamp(min=0).to(torch.int64), q["tex_w"][qw] - 2)
            y0 = torch.minimum(torch.floor(py).clamp(min=0).to(torch.int64), q["tex_h"][qw] - 2)
            fx = torch.clamp(px.double() - x0, 0, 1)
            fy = torch.clamp(py.double() - y0, 0, 1)
            base = qw * (th * tw)
            g = lambda yy, xx: q["atlas"][base + yy * tw + xx].double()  # noqa: E731
            val = (g(y0, x0) * (1 - fx) * (1 - fy) + g(y0, x0 + 1) * fx * (1 - fy)
                   + g(y0 + 1, x0) * (1 - fx) * fy + g(y0 + 1, x0 + 1) * fx * fy)
            vals.append(torch.where(hit, val, torch.zeros_like(val)))
        return torch.cat(vals)


def course_trajectory(course, n_frames: int, laps: float = 1.0, look_ahead: float = 6.0,
                      height: float = 0.0, start_s: float = 0.0):
    """A forward-looking drive along a course's centre line -> (N, 4, 4)
    T_cw: the camera on the centre line at ``height`` (camera +y is down,
    so a negative height is above the road) looks at the centre-line point
    ``look_ahead`` m further on, the KITTI viewing geometry."""
    s = start_s + course.length * laps * np.arange(n_frames) / n_frames
    pts = course.point(s)
    tgts = course.point(s + look_ahead)
    return np.stack([lookat_pose_cw(np.array([pts[i, 0], height, pts[i, 1]]),
                                    np.array([tgts[i, 0], height, tgts[i, 1]]))
                     for i in range(n_frames)])


class Photometrics:
    """Per-frame photometric degradation of a rendered uint8 frame:

        photo = Photometrics(rng, exposure_drift=0.06, noise_sigma=4.0, motion_blur_px=5)
        img = photo(renderer.render(cam, pose))

    * motion blur: a ``motion_blur_px``-long line kernel along ``direction``
      ("h" horizontal, else vertical), as a box mean over edge-padded rows;
    * exposure: a gain that follows a random walk of step sigma
      ``exposure_drift`` per frame, clamped to [0.4, 2.0] (auto-exposure
      hunting, light that changes between visits);
    * noise: additive Gaussian noise of sigma ``noise_sigma`` gray levels.

    The stages work in float and the result is rounded and clipped to
    uint8, as a sensor quantizes."""

    def __init__(self, rng: np.random.Generator, exposure_drift: float = 0.0,
                 noise_sigma: float = 0.0, motion_blur_px: int = 0, direction: str = "h"):
        self.rng = rng
        self.exposure_drift = float(exposure_drift)
        self.noise_sigma = float(noise_sigma)
        self.motion_blur_px = int(motion_blur_px)
        self.direction = direction
        self.gain = 1.0

    def __call__(self, img: np.ndarray) -> np.ndarray:
        x = img.astype(np.float32)
        if self.motion_blur_px > 1:
            k = self.motion_blur_px
            axis = 1 if self.direction == "h" else 0
            pad = [(0, 0), (0, 0)]
            pad[axis] = (k // 2, k - 1 - k // 2)
            xp = np.pad(x, pad, mode="edge")
            # the window sums as differences of a float64 cumulative sum
            # with a leading zero slab: sum of xp[i:i+k] = c[i+k] - c[i]
            zshape = list(xp.shape)
            zshape[axis] = 1
            c = np.concatenate([np.zeros(zshape), np.cumsum(xp, axis=axis, dtype=np.float64)],
                               axis=axis)
            if axis == 1:
                x = ((c[:, k:] - c[:, :-k]) / k).astype(np.float32)
            else:
                x = ((c[k:, :] - c[:-k, :]) / k).astype(np.float32)
        if self.exposure_drift > 0:
            self.gain = float(np.clip(self.gain + self.rng.normal(0.0, self.exposure_drift),
                                      0.4, 2.0))
            x = x * self.gain
        if self.noise_sigma > 0:
            x = x + self.rng.normal(0.0, self.noise_sigma, x.shape)
        return np.clip(np.round(x), 0, 255).astype(np.uint8)


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
