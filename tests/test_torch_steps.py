"""Slice parity: the port's FrameStep and mono TrackStep against the JAX
package's FrameStep._step_impl and TrackStep._impl on the same numpy inputs
(a rendered 240x320 orbit, 4 levels, ~400 keypoints, a 512-landmark map).

Both sides are fed JAX's pyramid levels (the port's own pyramid residue is
stated by test_torch_frontend.py).  On the CPU the JAX step runs its
autodiff + LU pose LM while the port runs the analytic schedule, so the
tolerances are those the JAX package holds between those two paths:
keypoints identical; lm_kpt_idx / kp_src equal on >= 99 % of entries; T_cw
within atol 1e-3; num_inliers within 2 %."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from openvslam_tpu.camera import Perspective as JaxPerspective
from openvslam_tpu.camera.base import camera_to_config as jax_camera_to_config
from openvslam_tpu.models.frame_step import FrameStep as JaxFrameStep
from openvslam_tpu.models.frontend import OrbFrontend as JaxFrontend
from openvslam_tpu.models.track_step import TrackStep as JaxTrackStep
from openvslam_tpu.models.track_step import unpack_bits_host as jax_unpack_bits_host
from openvslam_tpu.ops import pyramid as jpyr
from openvslam_tpu_torch import convert, kernels
from openvslam_tpu_torch.models.frame_step import FrameStep
from openvslam_tpu_torch.models.frontend import OrbFrontend
from openvslam_tpu_torch.models.track_step import TrackStep, unpack_bits_host
from openvslam_tpu_torch.ops import pyramid
from openvslam_tpu_torch.ops.orb import unpack_bits_i8
from openvslam_tpu_torch.utils import synthetic

H, W, LEVELS, KPTS, LCAP = 240, 320, 4, 400, 512


@pytest.fixture(scope="module")
def world():
    """JAX camera, port camera, rendered frames and their ground-truth poses,
    with the port's pyramid replaced by JAX's levels for the whole module."""
    jitted = {}

    def build(img, num_levels, scale):
        key = (tuple(img.shape), num_levels, scale)
        if key not in jitted:
            jitted[key] = jax.jit(lambda x: jpyr.build_pyramid(x, num_levels, scale))
        return [torch.from_numpy(np.array(a)).to(img.device)
                for a in jitted[key](jnp.asarray(img.cpu().numpy()))]

    jcam = JaxPerspective.create(fx=260.0, fy=260.0, cx=160.0, cy=120.0, cols=W, rows=H)
    cam = convert.camera_from_config(jax_camera_to_config(jcam))
    scene = synthetic.PatchSceneRenderer(np.random.default_rng(5), n_points=2000,
                                         center=(0, 0, 6), extent=(7, 5, 2.5), patch=7,
                                         rows=H, cols=W)
    poses = synthetic.orbit_trajectory(40, radius=2.5, target=(0, 0, 6), arc=np.pi / 4)[:4]
    images = [scene.render(cam, p) for p in poses]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pyramid, "build_pyramid", build)
        yield dict(jcam=jcam, cam=cam, scene=scene, poses=poses, images=images)


def _local_map(fe, cam, scene, T0, img0, L):
    """bench.py's local map: scene points visible in frame 0 with the
    descriptor of the frame-0 keypoint within 3 px of their projection."""
    kp0 = fe.extract(torch.from_numpy(img0))
    kp_xy, kp_valid = kp0.xy.numpy(), kp0.valid.numpy()
    pc0 = (T0[:3, :3] @ scene.points.T).T + T0[:3, 3]
    uv0, _, vis0 = (t.numpy() for t in cam.project(torch.from_numpy(pc0.astype(np.float32))))
    pos = np.zeros((L, 3), np.float32)
    desc = np.zeros((L, 8), np.int32)
    valid = np.zeros(L, bool)
    kp_of = np.full(L, -1, np.int64)
    n = 0
    for i in np.where(vis0)[0]:
        d = np.linalg.norm(kp_xy - uv0[i], axis=-1)
        d[~kp_valid] = 1e9
        j = int(np.argmin(d))
        if d[j] < 3.0 and n < L:
            pos[n], desc[n], valid[n], kp_of[n] = scene.points[i], kp0.desc_u32[j].numpy(), True, j
            n += 1
    return pos, desc, valid, kp_of, kp0


def _agree(a, b):
    return (np.asarray(a) == np.asarray(b)).mean()


def _inliers_close(n_t, n_j):
    assert abs(int(n_t) - int(n_j)) <= 0.02 * max(int(n_j), 1), (int(n_t), int(n_j))


def test_frame_step_matches_jax(world):
    cam, jcam, poses, images = world["cam"], world["jcam"], world["poses"], world["images"]
    fs = FrameStep(cam, max_keypts=KPTS, num_levels=LEVELS, lm_capacity=LCAP, device="cpu")
    jfs = JaxFrameStep(jcam, max_keypts=KPTS, num_levels=LEVELS, lm_capacity=LCAP)
    pos, desc, valid, _, _ = _local_map(fs.frontend, cam, world["scene"], poses[0], images[0], LCAP)
    assert valid.sum() >= 120
    lvl = np.full(LCAP, -1, np.int32)
    bits = unpack_bits_i8(torch.from_numpy(desc)).numpy()
    before = kernels.launch_counts()
    for f in (1, 2):
        T_pred = poses[f - 1].astype(np.float32)
        rt = fs.step(torch.from_numpy(images[f]), torch.from_numpy(T_pred), torch.from_numpy(pos),
                     torch.from_numpy(desc), torch.from_numpy(valid), torch.from_numpy(lvl))
        rj = jfs.step(jnp.asarray(images[f]), jnp.asarray(T_pred), jnp.asarray(pos),
                      jnp.asarray(bits), jnp.asarray(valid), jnp.asarray(lvl))
        np.testing.assert_array_equal(rt.kp_xy.numpy(), np.asarray(rj.kp_xy))
        np.testing.assert_array_equal(rt.kp_valid.numpy(), np.asarray(rj.kp_valid))
        assert _agree(rt.lm_kpt_idx.numpy(), rj.lm_kpt_idx) >= 0.99
        np.testing.assert_allclose(rt.T_cw.numpy(), np.asarray(rj.T_cw), rtol=0, atol=1e-3)
        _inliers_close(rt.num_inliers, rj.num_inliers)
        assert int(rt.num_inliers) >= 30
        assert np.abs(rt.T_cw.numpy()[:3, 3] - poses[f][:3, 3]).max() < 0.05
    assert kernels.launch_counts() == before


def test_track_step_matches_jax(world):
    cam, jcam, poses, images = world["cam"], world["jcam"], world["poses"], world["images"]
    fe = OrbFrontend(H, W, max_keypts=KPTS, num_levels=LEVELS, device="cpu")
    ts = TrackStep(cam, fe, lm_capacity=LCAP, device="cpu")
    jts = JaxTrackStep(jcam, JaxFrontend(H, W, max_keypts=KPTS, num_levels=LEVELS),
                       lm_capacity=LCAP)
    P = ts.prev_capacity
    assert P == jts.prev_capacity
    pos, desc, valid, kp_of, kp0 = _local_map(fe, cam, world["scene"], poses[0], images[0], LCAP)
    loc_bits = unpack_bits_i8(torch.from_numpy(desc)).numpy()
    c0 = -poses[0][:3, :3].T @ poses[0][:3, 3]
    lvl0 = kp0.level.numpy()
    maxd = (np.linalg.norm(pos - c0, axis=-1) * 1.2 ** lvl0[np.clip(kp_of, 0, None)]).astype(np.float32)
    # last-frame table for frame 1: frame 0's keypoints that seeded the map
    prev_pos = np.zeros((P, 3), np.float32)
    prev_valid = np.zeros(P, bool)
    prev_slot = np.full(LCAP, -1, np.int64)
    rows = kp_of[valid]
    prev_pos[rows], prev_valid[rows] = pos[valid], True
    prev_slot[valid] = rows
    prev_desc = kp0.desc_u32.numpy().view(np.uint32)
    prev_level = lvl0.astype(np.int32)
    T_pred = poses[0].astype(np.float32)
    for f in (1, 2):
        last = convert.last_frame_from_numpy(prev_pos, prev_desc, prev_valid, prev_level, "cpu")
        local = convert.local_map_from_numpy(pos, loc_bits, valid, maxd, prev_slot, "cpu")
        rt = ts.step(torch.from_numpy(images[f]), None, torch.from_numpy(T_pred), last, local)
        rj = jts.step(jnp.asarray(images[f]), None, jnp.asarray(T_pred),
                      jnp.asarray(prev_pos), jnp.asarray(prev_desc), jnp.asarray(prev_valid),
                      jnp.asarray(prev_level), jnp.asarray(pos), jnp.asarray(loc_bits),
                      jnp.asarray(valid), jnp.asarray(maxd), jnp.asarray(prev_slot.astype(np.int32)))
        for fld in ("kp_xy", "kp_valid", "kp_response", "kp_level"):
            np.testing.assert_array_equal(getattr(rt, fld).numpy(), np.asarray(getattr(rj, fld)))
        # undistorted pixels up to 320: a few float32 ulps (XLA fuses the
        # fixed-point iteration into multiply-adds)
        np.testing.assert_allclose(rt.kp_und.numpy(), np.asarray(rj.kp_und), rtol=0, atol=1e-4)
        np.testing.assert_allclose(rt.kp_bearing.numpy(), np.asarray(rj.kp_bearing), rtol=0, atol=1e-5)
        np.testing.assert_array_equal(
            unpack_bits_host(rt.kp_desc_u32.numpy(), rt.kp_valid.numpy()),
            jax_unpack_bits_host(np.asarray(rj.kp_desc_u32), np.asarray(rj.kp_valid)))
        assert _agree(rt.kp_src.numpy(), rj.kp_src) >= 0.99
        assert _agree(rt.loc_visible.numpy(), rj.loc_visible) >= 0.99
        np.testing.assert_allclose(rt.T_cw.numpy(), np.asarray(rj.T_cw), rtol=0, atol=1e-3)
        _inliers_close(rt.num_inliers, rj.num_inliers)
        _inliers_close(rt.n_stage1, rj.n_stage1)
        assert int(rt.num_inliers) >= 30
        assert np.abs(rt.T_cw.numpy()[:3, 3] - poses[f][:3, 3]).max() < 0.05
        # next frame: the last-frame table is this frame's inlier matches
        src, inl = rt.kp_src.numpy(), rt.kp_inlier.numpy()
        ident = np.where(src >= P, src - P, np.where(src >= 0, prev_slot_inv(prev_slot, P)[np.clip(src, 0, P - 1)], -1))
        ident = np.where(inl, ident, -1)
        prev_pos = np.where((ident >= 0)[:, None], pos[np.clip(ident, 0, None)], 0).astype(np.float32)
        prev_valid = ident >= 0
        prev_desc = rt.kp_desc_u32.numpy().view(np.uint32)
        prev_level = rt.kp_level.numpy().astype(np.int32)
        prev_slot = np.full(LCAP, -1, np.int64)
        prev_slot[ident[prev_valid]] = np.where(prev_valid)[0]
        T_pred = rt.T_cw.numpy()


def prev_slot_inv(prev_slot, P):
    """Local slot of each last-frame row (-1 none), from local -> row."""
    inv = np.full(P, -1, np.int64)
    has = prev_slot >= 0
    inv[prev_slot[has]] = np.where(has)[0]
    return inv
