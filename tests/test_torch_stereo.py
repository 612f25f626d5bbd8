"""Stereo and RGB-D parity: the port's stereo pieces against the JAX package
on the CPU, on the same numpy inputs (tests/test_stereo_rgbd_e2e.py's
textured wall at 416x320 with a 0.2 m baseline, and KITTI 00's 1241x376
camera).

Tolerances, as stated per test:
* ``stereo_right_u`` and ``make_stereo_residual``: atol 1e-5;
* the stereo Jacobians of the BA edge against ``torch.func.jacfwd``: 1e-4
  of each block's largest entry;
* ``stereo_match`` (descriptors): identical;
* ``stereo_match_dense``: accept/reject equal on >= 99.5 % of valid
  keypoints, |x_right| within 1e-3 px where both accept.  The patch means
  and SAD means are float32 sums in another order, so a cost within a few
  ulps of ``max_cost`` or of the uniqueness ratio may flip; the tests
  count the flips (none on these frames);
* the pyramid at 1241x376: a residue of single gray levels, counted as for
  640x480 (tests/test_torch_frontend.py); ``detect_levels`` (plain path)
  fed JAX's levels: bit-exact;
* one stereo local BA: inliers identical, cost within 1e-4, T within 1e-4;
* one TrackStep step in the stereo and in the rgbd mode, fed JAX's levels
  and the same tables: keypoints identical, sources equal on >= 99 %, T
  within 1e-3, inliers within 2 %;
* the depth bootstrap on a JAX-built frame: the same landmarks, positions
  within 1e-5 relative; depth seeding of one keyframe, uncapped and
  cell-budgeted: the same seeded keypoints, positions within 1e-5
  relative.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from openvslam_tpu.camera import Perspective as JaxPerspective
from openvslam_tpu.camera.base import SetupType as JaxSetupType
from openvslam_tpu.camera.base import camera_to_config as jax_camera_to_config
from openvslam_tpu.config import Config as JaxConfig
from openvslam_tpu.data import Frame as JaxFrame
from openvslam_tpu.data import MapDatabase as JaxMapDatabase
from openvslam_tpu.models.frontend import OrbFrontend as JaxFrontend
from openvslam_tpu.models.track_step import TrackStep as JaxTrackStep
from openvslam_tpu.module.mapping_module import MappingModule as JaxMappingModule
from openvslam_tpu.module.tracking_module import TrackingModule as JaxTrackingModule
from openvslam_tpu.ops import fast as jfast
from openvslam_tpu.ops import pyramid as jpyr
from openvslam_tpu.ops.stereo import stereo_match_dense as jax_stereo_match_dense
from openvslam_tpu.optimize import residuals as JR
from openvslam_tpu.optimize.ba import BAProblem as JaxBAProblem
from openvslam_tpu.optimize.ba import make_local_ba as jax_local_ba
from openvslam_tpu_torch import convert
from openvslam_tpu_torch.config import Config
from openvslam_tpu_torch.data import Frame, MapDatabase
from openvslam_tpu_torch.models.frontend import OrbFrontend, level_budgets
from openvslam_tpu_torch.models.track_step import TrackStep
from openvslam_tpu_torch.module.mapping_module import MappingModule
from openvslam_tpu_torch.module.tracking_module import TrackingModule
from openvslam_tpu_torch.ops import fast, pyramid
from openvslam_tpu_torch.ops.orb import unpack_bits_i8
from openvslam_tpu_torch.ops.stereo import stereo_match, stereo_match_dense
from openvslam_tpu_torch.optimize import ba as BA
from openvslam_tpu_torch.optimize import residuals as R
from openvslam_tpu_torch.utils import synthetic

from test_ba import _build_problem

_t = torch.from_numpy
H, W, LEVELS, KPTS, LCAP = 320, 416, 4, 600, 1024
BASELINE = 0.2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Thousands of small tensor operations beside the suite's other worker
    processes: intra-op threads would only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg_dict(setup, **mapping):
    return {"Camera": {"name": "wall", "setup": setup, "model": "perspective",
                       "fx": 350.0, "fy": 350.0, "cx": W / 2, "cy": H / 2, "cols": W, "rows": H,
                       "fps": 10, "focal_x_baseline": 350.0 * BASELINE,
                       "depth_threshold": 30.0, "depthmap_factor": 1.0},
            "Feature": {"max_num_keypts": KPTS, "num_levels": LEVELS, "scale_factor": 1.2},
            "Mapping": dict(mapping), "LoopDetector": {"enabled": False}}


def _jax_levels(img, num_levels, scale, _jitted={}):
    key = (tuple(img.shape), num_levels, scale)
    if key not in _jitted:
        _jitted[key] = jax.jit(lambda x: jpyr.build_pyramid(x, num_levels, scale))
    return [_t(np.array(a)).to(img.device) for a in _jitted[key](jnp.asarray(img.cpu().numpy()))]


@pytest.fixture(scope="module")
def wall():
    """The wall scene's cameras (JAX's and the port's), three stereo pairs
    0.25 m apart with their poses and depth maps, and JAX's front end; the
    port's pyramid is JAX's for the whole module."""
    jcam = JaxPerspective.create(fx=350.0, fy=350.0, cx=W / 2, cy=H / 2, cols=W, rows=H,
                                 fps=10.0, setup=JaxSetupType.STEREO,
                                 focal_x_baseline=350.0 * BASELINE, depth_threshold=30.0)
    cam = convert.camera_from_config(jax_camera_to_config(jcam))
    scene = synthetic.PlaneSceneRenderer(np.random.default_rng(7), x_range=(-4, 12),
                                         y_range=(-5, 5), plane_z=7.0, rows=H, cols=W)
    poses = np.stack([synthetic.lookat_pose_cw((x, 0, 0), (x, 0, 7)) for x in (0.0, 0.25, 0.5)])
    shift = np.eye(4)
    shift[0, 3] = -BASELINE
    pairs = [(scene.render(cam, T), scene.render(cam, shift @ T)) for T in poses]
    depth = [np.full((H, W), 7.0 - (-T[:3, :3].T @ T[:3, 3])[2], np.float32) for T in poses]
    jfe = JaxFrontend(H, W, max_keypts=KPTS, num_levels=LEVELS)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pyramid, "build_pyramid", _jax_levels)
        yield dict(jcam=jcam, cam=cam, poses=poses, pairs=pairs, depth=depth, jfe=jfe,
                   kps=[jfe.extract(jnp.asarray(left)) for left, _ in pairs])


def _jax_frame(w, i, mode="stereo"):
    """JAX's Frame of wall frame ``i``: its front end's keypoints with their
    depths from the dense match (stereo) or the depth map (rgbd)."""
    kp = w["kps"][i]
    if mode == "stereo":
        left, right = w["pairs"][i]
        xr, d = jax_stereo_match_dense(jnp.asarray(left), jnp.asarray(right), kp.xy, kp.valid,
                                       jnp.float32(350.0 * BASELINE))
        xr, d = np.asarray(xr), np.asarray(d)
    else:
        xy = np.asarray(kp.xy)
        z = np.where(np.asarray(kp.valid), w["depth"][i][0, 0], -1.0).astype(np.float32)
        d, xr = z, np.where(z > 0, xy[:, 0] - 350.0 * BASELINE / np.maximum(z, 1e-6),
                            -1.0).astype(np.float32)
    return JaxFrame.from_keypoints(i, i / 10.0, kp, w["jcam"], x_right=xr, depth=d)


def _port_frame(jframe):
    return Frame(**{f.name: np.array(getattr(jframe, f.name)) if isinstance(
        getattr(jframe, f.name), np.ndarray) else getattr(jframe, f.name)
        for f in dataclasses.fields(JaxFrame)})


# ---------------------------------------------------------------- geometry

def test_stereo_right_u_and_residual_match_jax(rng):
    jcam = JaxPerspective.create(fx=500.0, fy=490.0, cx=320.0, cy=240.0,
                                 setup=JaxSetupType.STEREO, focal_x_baseline=60.0)
    cam = convert.camera_from_config(jax_camera_to_config(jcam))
    X = (rng.standard_normal((200, 3)) * [2.0, 1.5, 1.0] + [0, 0, 6]).astype(np.float32)
    T = synthetic.lookat_pose_cw((0.3, -0.2, 0.1), (0, 0, 6)).astype(np.float32)
    uv, z = rng.random((200, 2)).astype(np.float32) * 600, (rng.random(200) * 9 + 0.5).astype(np.float32)
    np.testing.assert_allclose(cam.stereo_right_u(_t(uv), _t(z)).numpy(),
                               np.asarray(jcam.stereo_right_u(jnp.asarray(uv), jnp.asarray(z))),
                               rtol=0, atol=1e-5)
    obs = np.concatenate([uv, (uv[:, :1] - 60.0 / z[:, None])], 1).astype(np.float32)
    obs[::5, 2] = -1.0                    # mono observations inside the stereo frame
    r, ok = R.make_stereo_residual(cam)(_t(T), _t(X), _t(obs))
    rj, okj = jax.vmap(JR.make_stereo_residual(jcam), (None, 0, 0))(
        jnp.asarray(T), jnp.asarray(X), jnp.asarray(obs))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(okj))
    np.testing.assert_allclose(r.numpy(), np.asarray(rj), rtol=0, atol=1e-5 * 600)
    assert (r.numpy()[::5, 2] == 0).all()


def test_stereo_jacobians_match_autodiff(rng):
    jcam, prob, _, _, _, _ = _build_problem(rng)
    cam = dataclasses.replace(convert.camera_from_config(jax_camera_to_config(jcam)),
                              focal_x_baseline=50.0)
    p = BA.BAProblem(*(_t(np.array(a)) for a in prob))
    n = int(p.obs_mask.sum())
    oc, ol = p.obs_cam[:n].long(), p.obs_lm[:n].long()
    xc = torch.einsum("oij,oj->oi", p.T_cw[oc][:, :3, :3], p.X[ol]) + p.T_cw[oc][:, :3, 3]
    ur = p.obs_uv[:n, 0] - 50.0 / xc[:, 2]
    obs = torch.cat([p.obs_uv[:n], torch.where(torch.arange(n) % 4 == 0, -1.0, ur)[:, None]], 1)
    r, ok, Jc, Jl = BA.reprojection_residuals_and_jacobians(cam, p.T_cw, p.X, oc, ol, obs)
    assert ok.all() and Jc.shape == (n, 3, 6) and Jl.shape == (n, 3, 3)

    def resid(xi, dX, T, X, o):
        w, v = xi[:3], xi[3:]
        z = torch.zeros((), dtype=xi.dtype)
        tw = torch.stack([torch.stack([z, -w[2], w[1], v[0]]), torch.stack([w[2], z, -w[0], v[1]]),
                          torch.stack([-w[1], w[0], z, v[2]]), torch.stack([z, z, z, z])])
        T = torch.linalg.matrix_exp(tw) @ T
        return R.make_stereo_residual(cam)(T, (X + dX)[None], o[None])[0][0]

    z6, z3 = torch.zeros(6), torch.zeros(3)
    To, Xo = p.T_cw[oc], p.X[ol]
    Jc_ad = torch.func.vmap(torch.func.jacfwd(lambda xi, T, X, o: resid(xi, z3, T, X, o)))(
        z6.expand(n, 6), To, Xo, obs)
    Jl_ad = torch.func.vmap(torch.func.jacfwd(lambda d, T, X, o: resid(z6, d, T, X, o)))(
        z3.expand(n, 3), To, Xo, obs)
    scale = Jc_ad.abs().amax(dim=(1, 2), keepdim=True)
    torch.testing.assert_close(Jc / scale, Jc_ad / scale, atol=1e-4, rtol=0)
    torch.testing.assert_close(Jl / scale, Jl_ad / scale, atol=1e-4, rtol=0)
    assert (Jc[::4, 2] == 0).all() and (Jl[::4, 2] == 0).all()


# ---------------------------------------------------------------- dense match

def _dense_match_agree(left, right, xy, valid, fxb):
    xr, d = stereo_match_dense(_t(left), _t(right), _t(xy), _t(valid), fxb)
    xr_j, d_j = (np.asarray(a) for a in jax_stereo_match_dense(
        jnp.asarray(left), jnp.asarray(right), jnp.asarray(xy), jnp.asarray(valid),
        jnp.float32(fxb)))
    acc, acc_j = d.numpy() > 0, d_j > 0
    flips = int((acc != acc_j)[valid].sum())
    assert flips <= 0.005 * valid.sum(), flips
    both = acc & acc_j
    assert both.sum() >= 0.5 * valid.sum(), (both.sum(), valid.sum())
    assert np.abs(xr.numpy()[both] - xr_j[both]).max() <= 1e-3
    assert np.abs(d.numpy()[both] - d_j[both]).max() <= 1e-3 * d_j[both].max()
    return flips


def test_stereo_match_dense_matches_jax_on_the_wall(wall):
    for i in (0, 2):
        kp = wall["kps"][i]
        flips = _dense_match_agree(*wall["pairs"][i], np.asarray(kp.xy), np.asarray(kp.valid),
                                   350.0 * BASELINE)
        assert flips == 0, flips           # measured: no flip on these frames


def test_stereo_match_matches_jax(wall):
    """The descriptor variant (left keypoints against right-image keypoints
    inside the epipolar band): identical x_right and depth, every left
    keypoint (integer Hamming distances: no float order involved)."""
    from openvslam_tpu.ops.stereo import stereo_match as jax_stereo_match

    left, right = wall["pairs"][1]
    kl = wall["kps"][1]
    kr = wall["jfe"].extract(jnp.asarray(right))
    args = [np.asarray(a) for a in (kl.desc_i8, kl.xy, kl.valid, kl.level,
                                    kr.desc_i8, kr.xy, kr.valid, kr.level)]
    xr, d = stereo_match(*(_t(a) for a in args), 350.0 * BASELINE)
    xr_j, d_j = jax_stereo_match(*(jnp.asarray(a) for a in args), jnp.float32(350.0 * BASELINE))
    np.testing.assert_array_equal(xr.numpy(), np.asarray(xr_j))
    np.testing.assert_allclose(d.numpy(), np.asarray(d_j), rtol=1e-6, atol=0)
    assert (d.numpy() > 0).sum() >= 100


@pytest.fixture(scope="module")
def kitti():
    """A rendered KITTI 00 pair (1241x376, fx 718.856, focal_x_baseline
    386.1448) of the wall 7 m away, and JAX's and the port's pyramids of
    its left image at 8 levels, scale 1.2."""
    jcam = JaxPerspective.create(fx=718.856, fy=718.856, cx=607.1928, cy=185.2157, cols=1241,
                                 rows=376, setup=JaxSetupType.STEREO, focal_x_baseline=386.1448)
    cam = convert.camera_from_config(jax_camera_to_config(jcam))
    scene = synthetic.PlaneSceneRenderer(np.random.default_rng(7), x_range=(-8, 8),
                                         y_range=(-5, 5), plane_z=7.0, rows=376, cols=1241)
    T = synthetic.lookat_pose_cw((0, 0, 0), (0, 0, 7))
    shift = np.eye(4)
    shift[0, 3] = -386.1448 / 718.856
    left, right = scene.render(cam, T), scene.render(cam, shift @ T)
    ref = [np.asarray(a) for a in jax.jit(lambda x: jpyr.build_pyramid(x, 8, 1.2))(
        jnp.asarray(left.astype(np.float32)))]
    return dict(left=left, right=right, ref_levels=ref,
                levels=pyramid.build_pyramid(_t(left.astype(np.float32)), 8, 1.2))


def test_pyramid_and_detect_levels_match_jax_at_kitti_size(kitti):
    """At 1241x376 no level is a multiple of 32 px wide (1241, 1034, 862,
    718, ...).  The port's pyramid against JAX's: the residue of single
    gray levels that test_pyramid_residue states at 640x480 (2 of 385,978
    pixels on rendered frames, 11 of 950,532 on noise), here 70 of
    1,226,476 pixels of this rendered frame (measured; ROADMAP Queue 3).  detect_levels (plain path) fed JAX's
    levels with KITTI's 2000-keypoint budgets: bit-exact."""
    ours, ref = kitti["levels"], kitti["ref_levels"]
    assert [tuple(o.shape) for o in ours] == [r.shape for r in ref]
    assert ref[0].shape == (376, 1241) and all(r.shape[1] % 32 for r in ref[:5])
    diff = [np.abs(o.numpy() - r) for o, r in zip(ours, ref)]
    assert max(float(d.max()) for d in diff) <= 1.0
    n_px = sum(int((d > 0).sum()) for d in diff)
    assert n_px <= 70, n_px
    budgets = level_budgets(2000, 8, 1.2)
    got = fast.detect_levels([_t(r) for r in ref], 20.0, 7.0, budgets)
    want = jax.jit(lambda lv: jfast.detect_levels(lv, 20.0, 7.0, budgets, cell=32))(
        [jnp.asarray(r) for r in ref])
    for (oxy, oresp, oval), (rxy, rresp, rval) in zip(got, want):
        np.testing.assert_array_equal(oxy.numpy(), np.asarray(rxy))
        np.testing.assert_array_equal(oresp.numpy(), np.asarray(rresp))
        np.testing.assert_array_equal(oval.numpy(), np.asarray(rval))
    assert int(got[0][2].sum()) >= 0.9 * budgets[0]
    # the dense stereo match on level 0's corners of the KITTI pair
    xy, valid = got[0][0].numpy(), got[0][2].numpy()
    flips = _dense_match_agree(kitti["left"], kitti["right"], xy, valid, 386.1448)
    assert flips == 0, flips               # measured: no flip on this pair


# ---------------------------------------------------------------- stereo local BA

@pytest.mark.parametrize("case", ["noisy", "outliers"])
def test_stereo_local_ba_matches_jax(rng, case):
    """tests/test_ba.py's problem with a third column u_right = u - fxb / z
    (0.5 px noise), a quarter of the observations monocular (u_right < 0);
    ``outliers`` corrupts 5 % of them."""
    _, prob, T_true, X_true, _, _ = _build_problem(rng)
    jcam = JaxPerspective.create(fx=500, fy=500, cx=320, cy=240, cols=640, rows=480,
                                 setup=JaxSetupType.STEREO, focal_x_baseline=50.0)
    n = int(np.asarray(prob.obs_mask).sum())
    oc, ol = np.asarray(prob.obs_cam)[:n], np.asarray(prob.obs_lm)[:n]
    Tt = T_true[oc]
    z = np.einsum("oj,oj->o", Tt[:, 2, :3], X_true[ol]) + Tt[:, 2, 3]
    ouv = np.zeros((len(prob.obs_mask), 3), np.float32)
    ouv[:, :2] = np.asarray(prob.obs_uv)
    ouv[:n, 2] = ouv[:n, 0] - 50.0 / z + rng.standard_normal(n) * 0.5
    ouv[:n:4, 2] = -1.0
    if case == "outliers":
        bad = rng.choice(n, n // 20, replace=False)
        ouv[bad] += (rng.random((len(bad), 3)) - 0.5) * 120 + 15
    prob = prob._replace(obs_uv=jnp.asarray(ouv))
    res_j = jax.device_get(jax_local_ba(jcam, stereo=True)(JaxBAProblem(*prob)))
    cam = convert.camera_from_config(jax_camera_to_config(jcam))
    res = BA.make_local_ba(cam, stereo=True)(BA.BAProblem(*(_t(np.array(a)) for a in prob)))
    np.testing.assert_array_equal(res.obs_inlier.numpy(), res_j.obs_inlier)
    assert abs(float(res.cost) - float(res_j.cost)) <= 1e-4 * abs(float(res_j.cost))
    np.testing.assert_allclose(res.T_cw.numpy(), res_j.T_cw, atol=1e-4)
    if case == "outliers":
        assert int(res.obs_inlier.sum()) < n


# ---------------------------------------------------------------- TrackStep

@pytest.mark.parametrize("mode", ["stereo", "rgbd"])
def test_track_step_matches_jax(wall, mode):
    """One step of frame 1 against tables built from frame 0's depths (the
    depth bootstrap's landmarks as the last-frame table and as the local
    map), predicted 2 cm off frame 1's pose, as a motion model would."""
    cam, jcam = wall["cam"], wall["jcam"]
    f0 = _jax_frame(wall, 0, mode)
    has = f0.valid & (f0.depth > 0)
    rows = np.where(has)[0]
    X = (f0.bearing[rows] * (f0.depth[rows] / f0.bearing[rows, 2])[:, None]).astype(np.float32)
    Tw = wall["poses"][0].astype(np.float32)
    Xw = ((X - Tw[:3, 3]) @ Tw[:3, :3]).astype(np.float32)
    fe = OrbFrontend(H, W, max_keypts=KPTS, num_levels=LEVELS, device="cpu")
    ts = TrackStep(cam, fe, lm_capacity=LCAP, mode=mode, device="cpu")
    jts = JaxTrackStep(jcam, wall["jfe"], lm_capacity=LCAP, mode=mode)
    P = ts.prev_capacity
    prev_pos = np.zeros((P, 3), np.float32)
    prev_valid = np.zeros(P, bool)
    prev_pos[rows], prev_valid[rows] = Xw, True
    prev_desc = f0.desc_u32
    prev_level = f0.level.astype(np.int32)
    loc_pos = np.zeros((LCAP, 3), np.float32)
    loc_valid = np.zeros(LCAP, bool)
    loc_bits = np.zeros((LCAP, 256), np.int8)
    loc_slot = np.full(LCAP, -1, np.int64)
    n = len(rows)
    loc_pos[:n], loc_valid[:n], loc_bits[:n], loc_slot[:n] = Xw, True, f0.desc_i8[rows], rows
    maxd = np.zeros(LCAP, np.float32)
    maxd[:n] = np.linalg.norm(Xw, axis=-1) * 1.2 ** f0.level[rows]
    aux = wall["pairs"][1][1] if mode == "stereo" else wall["depth"][1]
    last = convert.last_frame_from_numpy(prev_pos, prev_desc, prev_valid, prev_level, "cpu")
    local = convert.local_map_from_numpy(loc_pos, loc_bits, loc_valid, maxd, loc_slot, "cpu")
    img = wall["pairs"][1][0]
    T_pred = wall["poses"][1].astype(np.float32)
    T_pred[:3, 3] += [0.02, 0.0, 0.0]
    rt = ts.step(_t(img), None, _t(T_pred), last, local, _t(aux))
    rj = jts.step(jnp.asarray(img), None, jnp.asarray(T_pred), jnp.asarray(prev_pos),
                  jnp.asarray(prev_desc), jnp.asarray(prev_valid), jnp.asarray(prev_level),
                  jnp.asarray(loc_pos), jnp.asarray(loc_bits), jnp.asarray(loc_valid),
                  jnp.asarray(maxd), jnp.asarray(loc_slot.astype(np.int32)), jnp.asarray(aux))
    for fld in ("kp_xy", "kp_valid", "kp_response", "kp_level"):
        np.testing.assert_array_equal(getattr(rt, fld).numpy(), np.asarray(getattr(rj, fld)))
    acc, acc_j = rt.kp_depth.numpy() > 0, np.asarray(rj.kp_depth) > 0
    assert (acc == acc_j).mean() >= 0.995
    both = acc & acc_j
    np.testing.assert_allclose(rt.kp_x_right.numpy()[both], np.asarray(rj.kp_x_right)[both],
                               rtol=0, atol=1e-3)
    assert (np.asarray(rt.kp_src) == np.asarray(rj.kp_src)).mean() >= 0.99
    np.testing.assert_allclose(rt.T_cw.numpy(), np.asarray(rj.T_cw), rtol=0, atol=1e-3)
    for a, b in ((rt.num_inliers, rj.num_inliers), (rt.n_stage1, rj.n_stage1)):
        assert abs(int(a) - int(b)) <= 0.02 * max(int(b), 1), (int(a), int(b))
    assert int(rt.num_inliers) >= 100
    c = -rt.T_cw.numpy()[:3, :3].T @ rt.T_cw.numpy()[:3, 3]
    np.testing.assert_allclose(c, [0.25, 0, 0], atol=0.02)     # metric: no scale to align


# ---------------------------------------------------------------- bootstrap, seeding

def _modules(setup, **mapping):
    jcfg, cfg = JaxConfig.from_dict(_cfg_dict(setup, **mapping)), Config.from_dict(
        _cfg_dict(setup, **mapping))
    return jcfg, cfg


def test_initialize_with_depth_matches_jax(wall):
    jcfg, cfg = _modules("stereo")
    jframe = _jax_frame(wall, 0)
    pframe = _port_frame(jframe)
    K = jframe.capacity
    jt = JaxTrackingModule(jcfg, jcfg.camera, JaxMapDatabase(kpt_capacity=K))
    pt = TrackingModule(cfg, cfg.camera, MapDatabase(kpt_capacity=K), device="cpu")
    assert jt._initialize_with_depth(jframe) is not None
    assert pt._initialize_with_depth(pframe) is not None
    jids, pids = jt.map_db.valid_lm_ids(), pt.map_db.valid_lm_ids()
    np.testing.assert_array_equal(pids, jids)
    assert len(pids) >= 300
    Xj = jt.map_db.lm_pos[jids]
    rel = np.linalg.norm(pt.map_db.lm_pos[pids] - Xj, axis=-1) / np.linalg.norm(Xj, axis=-1)
    assert rel.max() <= 1e-5
    np.testing.assert_array_equal(pframe.lm_idx, jframe.lm_idx)
    assert pt.num_tracked == jt.num_tracked and pt.ref_kf == jt.ref_kf == 0


@pytest.mark.parametrize("budget", [0, 8])
def test_seed_landmarks_from_depth_matches_jax(wall, budget):
    """Frame 2 stored as a keyframe of the bootstrap map, its keypoints
    within 2 px of a bootstrap landmark's projection associated to it, then
    seeded from its depths: uncapped (the default) and with 8 landmarks a
    cell (closest first)."""
    jcfg, cfg = _modules("stereo", seed_cell_budget=budget)
    f0, f2 = _jax_frame(wall, 0), _jax_frame(wall, 2)
    K = f0.capacity
    jdb = JaxMapDatabase(kpt_capacity=K)
    jt = JaxTrackingModule(jcfg, jcfg.camera, jdb)
    jt._initialize_with_depth(f0)
    db = convert.map_database_from_state(convert.map_state(jdb))
    # the bootstrap put frame 0 at the map's origin
    f2.pose_cw = (wall["poses"][2] @ np.linalg.inv(wall["poses"][0])).astype(np.float32)
    ids = jdb.valid_lm_ids()
    T = f2.pose_cw
    pc = jdb.lm_pos[ids] @ T[:3, :3].T + T[:3, 3]
    uv = np.asarray(jcfg.camera.project(jnp.asarray(pc))[0])
    d = np.linalg.norm(f2.xy_undist[:, None] - uv[None], axis=-1)
    d[~f2.valid] = np.inf
    near = d.argmin(1)
    assoc = np.where((d.min(1) < 2.0) & (f2.depth > 0))[0]
    _, first = np.unique(near[assoc], return_index=True)
    assoc = assoc[first]
    assert len(assoc) >= 100
    f2p = _port_frame(f2)
    jm = JaxMappingModule(jcfg, jcfg.camera, jdb)
    pm = MappingModule(cfg, cfg.camera, db, device="cpu")
    out = []
    for m, mdb, fr in ((jm, jdb, f2), (pm, db, f2p)):
        kf = mdb.add_keyframe(fr)
        for i in assoc:
            mdb.add_observation(int(ids[near[i]]), kf, int(i))
        n0 = mdb.n_lms
        m._seed_landmarks_from_depth(fr, kf)
        out.append((kf, n0, mdb.n_lms, mdb.kf_lm_idx[kf].copy(), mdb.lm_pos[n0:mdb.n_lms].copy(),
                    m.seeds_skipped))
    (jkf, jn0, jn1, jidx, jX, jskip), (pkf, pn0, pn1, pidx, pX, pskip) = out
    assert (jkf, jn0, jn1, jskip) == (pkf, pn0, pn1, pskip)
    np.testing.assert_array_equal(pidx, jidx)
    assert jn1 - jn0 >= 50
    assert (jskip > 0) == (budget > 0)
    rel = np.linalg.norm(pX - jX, axis=-1) / np.linalg.norm(jX, axis=-1)
    assert rel.max() <= 1e-5
