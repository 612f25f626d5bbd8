"""Fisheye and equirectangular parity: the port's pose LMs, Jacobians,
bearing-E bootstrap, BA edges, fused TrackStep and System against the JAX
package on the CPU, on the same numpy inputs.

Tolerances:
* pose LM (fisheye through K3's plain version, equirectangular through
  the plain lon/lat schedule) against JAX's autodiff LM: equal inlier
  sets, pose within 1e-4;
* the analytic Jacobians (the equirectangular LM's, BA's equirectangular
  and multi-camera edges) against ``torch.func.jacfwd`` of the residual
  within 1e-4 of each row block's scale; at the poles (x = z = 0) the
  longitude has no derivative (autodiff gives NaN): the port's rows are 0
  there, by design;
* the bearing-E ``init_attempt`` fed JAX's draws on two views of the
  octagon room: match count, masks, compaction and the four support
  counts exact (as a set: the port fixes the SVD's signs, so its
  hypotheses may come in another order, as tests/test_torch_bootstrap.py
  states), T21 within 5e-3 (JAX's float32 normal-equation eigensolver);
* local and global BA with equirectangular edges (observations across
  the seam among them) as tests/test_torch_mapping.py holds the pinhole
  ones: obs_inlier identical, T_cw within 1e-4, X within 1e-4 of |X| for
  landmarks with three or more inlier observations (one left with two
  may drift along its ray: its depth is not determined) and 1e-3 for
  every landmark with an inlier observation left;
* one fused TrackStep per model (and one fisheye stereo step) as
  tests/test_torch_stereo.py holds its steps: keypoints identical, kp_src
  equal on >= 99 %, T_cw within 1e-3, inliers within 2 %;
* the port's System on tests/test_fisheye_equirect_e2e.py's two points,
  to that test's gates (fisheye: tracked > 0.8, ATE(sim3) < 0.12 m;
  equirectangular: > 0.6, < 0.15 m; fused share > 0.5), its bootstrap fed
  the RANSAC draws the JAX tracker makes (``jax.random`` from its key 42):
  on that planar scene the 8-point E on bearings is degenerate, and
  whether an attempt passes its gates depends on the draw in both
  packages alike (ROADMAP Queue 3).

The port's pyramid is JAX's for the whole module (the port's own residue
is stated by tests/test_torch_frontend.py).  Torch runs on one thread.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import jax.random as jr
import pytest
import torch

from openvslam_tpu.camera import base as jbase
from openvslam_tpu.data import Frame as JaxFrame
from openvslam_tpu.initialize import two_view as JTV
from openvslam_tpu.models.frontend import OrbFrontend as JaxFrontend
from openvslam_tpu.models.track_step import TrackStep as JaxTrackStep
from openvslam_tpu.ops import pyramid as jpyr
from openvslam_tpu.ops import ransac as jransac
from openvslam_tpu.optimize.ba import BAProblem as JaxBAProblem
from openvslam_tpu.optimize.ba import make_global_ba as jax_global_ba
from openvslam_tpu.optimize.ba import make_local_ba as jax_local_ba
from openvslam_tpu.optimize.pose_optimizer import make_pose_optimizer as jax_pose_optimizer
from openvslam_tpu.utils import synthetic as jsyn
from openvslam_tpu_torch import convert
from openvslam_tpu_torch.camera import make_camera_from_config
from openvslam_tpu_torch.config import Config
from openvslam_tpu_torch.data import Frame
from openvslam_tpu_torch.initialize import two_view as TV
from openvslam_tpu_torch.models.frontend import OrbFrontend
from openvslam_tpu_torch.models.track_step import TrackStep
from openvslam_tpu_torch.ops import pyramid
from openvslam_tpu_torch.ops.orb import unpack_bits_i8
from openvslam_tpu_torch.optimize import ba as BA
from openvslam_tpu_torch.optimize import pose_optimizer as PO
from openvslam_tpu_torch.optimize import residuals as R
from openvslam_tpu_torch.system import System
from openvslam_tpu_torch.utils import evaluate, synthetic

_t = torch.from_numpy
KPTS, LEVELS, LCAP = 500, 4, 512
FISHEYE = {"name": "TUM VI cam0 at half size", "setup": "monocular", "model": "fisheye",
           "fx": 95.489, "fy": 95.4865, "cx": 127.466, "cy": 128.4485, "k1": 0.00348239,
           "k2": 0.000715035, "k3": -0.00205324, "k4": 0.000202937, "cols": 256, "rows": 256,
           "fps": 20.0}
EQUIRECT = {"name": "equirect 512", "setup": "monocular", "model": "equirectangular",
            "cols": 512, "rows": 256, "fps": 30.0}
BASELINE = 0.2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Thousands of small tensor operations: with the suite's worker
    processes sharing the cores, intra-op threads only contend, so this
    module runs them on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_levels(img, num_levels, scale, _jitted={}):
    key = (tuple(img.shape), num_levels, scale)
    if key not in _jitted:
        _jitted[key] = jax.jit(lambda x: jpyr.build_pyramid(x, num_levels, scale))
    return [_t(np.array(a)).to(img.device) for a in _jitted[key](jnp.asarray(img.cpu().numpy()))]


def _cams(spec):
    return jbase.make_camera_from_config(spec), make_camera_from_config(spec)


def _port_frame(jframe):
    return Frame(**{f.name: np.array(getattr(jframe, f.name)) if isinstance(
        getattr(jframe, f.name), np.ndarray) else getattr(jframe, f.name)
        for f in dataclasses.fields(JaxFrame)})


def _wall_points(scene, T_cw, brg):
    """World points where rays ``brg`` (camera frame) of a camera at T_cw
    hit the room's walls (the renderer's nearest valid hit; NaN where none)."""
    R_, c = T_cw[:3, :3], -T_cw[:3, :3].T @ T_cw[:3, 3]
    d = brg.astype(np.float64) @ R_
    best = np.full(len(d), np.inf)
    for (p0, n, u_axis), tex in zip(scene.defs, scene.walls):
        denom = d @ n
        lam = ((p0 - c) @ n) / np.where(np.abs(denom) < 1e-9, 1e-9, denom)
        X = c[None, :] + lam[:, None] * d
        tu = (X @ u_axis + scene.wall_w / 2) * scene.res
        tv = (X[:, 1] - scene.y0) * scene.res
        th, tw = tex.shape
        ok = (lam > 1e-3) & (lam < best) & (tu >= 0) & (tu < tw - 1) & (tv >= 0) & (tv < th - 1)
        best = np.where(ok, lam, best)
    X = c[None, :] + best[:, None] * d
    return np.where(np.isfinite(best)[:, None], X, np.nan).astype(np.float32)


@pytest.fixture(scope="module")
def room():
    """The octagon room of chip_smoke's phases 8 and 8b (seed 7) and its
    lap, the frames of both cameras rendered by the JAX package, and the
    port's pyramid replaced by JAX's levels for the module."""
    scene = jsyn.RoomSceneRenderer(np.random.default_rng(7), half=10.0, rows=8, cols=8,
                                   n_walls=8)
    gt = jsyn.lap_trajectory(200, radius=6.0, laps=200 / 180)
    out = {"scene": scene, "gt": gt}
    for name, spec in (("fisheye", FISHEYE), ("equirect", EQUIRECT)):
        jcam, cam = _cams(spec)
        scene.rows, scene.cols = cam.rows, cam.cols
        out[name] = dict(jcam=jcam, cam=cam, spec=spec,
                         images={i: scene.render(jcam, gt[i]) for i in (0, 2, 8)},
                         jfe=JaxFrontend(cam.rows, cam.cols, max_keypts=KPTS, num_levels=LEVELS))
    shift = np.eye(4)
    shift[0, 3] = -BASELINE
    jcam = out["fisheye"]["jcam"]
    scene.rows, scene.cols = jcam.rows, jcam.cols
    out["fisheye"]["right"] = {i: scene.render(jcam, shift @ gt[i]) for i in (0, 2)}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pyramid, "build_pyramid", _jax_levels)
        yield out


# ---------------------------------------------------------------- pose LM

def _lm_problem(rng, cam, spec, stereo=False):
    """300 landmarks around the camera (in front of it for a fisheye, all
    round for an equirectangular camera, a fifth of those behind it across
    the seam), 1 px noise, 10 % outliers, a perturbed start."""
    N = 300
    X = rng.uniform(-6, 6, (N, 3)).astype(np.float32)
    if spec["model"] == "fisheye":
        X[:, 2] = np.abs(X[:, 2]) + 1.0
    else:
        X[: N // 5, 0] = rng.normal(0, 0.3, N // 5)
        X[: N // 5, 2] = -rng.uniform(2, 6, N // 5)
    uv, depth, _ = cam.project(_t(X))
    obs = (uv.numpy() + rng.normal(0, 1.0, (N, 2))).astype(np.float32)
    bad = rng.choice(N, N // 10, replace=False)
    obs[bad] += rng.uniform(15, 60, (len(bad), 2)) * rng.choice([-1, 1], (len(bad), 2))
    if spec["model"] == "equirectangular":
        obs[:, 0] = np.mod(obs[:, 0], cam.cols)
        across = np.abs(obs[: N // 5, 0] - cam.cols / 2) > cam.cols / 2 - 20
        assert across.sum() >= 5          # observations next to the seam
    if stereo:
        ur = obs[:, 0] - cam.focal_x_baseline / depth.numpy() + rng.normal(0, 1.0, N)
        ur[::4] = -1.0
        obs = np.concatenate([obs, ur[:, None].astype(np.float32)], 1)
    sig = rng.choice([1.0, 1.44, 2.0736], N).astype(np.float32)
    mask = rng.random(N) > 0.05
    T0 = jsyn.random_pose_cw(rng, max_angle=0.03, max_trans=0.1).astype(np.float32)
    return T0, X, obs, sig, mask


@pytest.mark.parametrize("spec,stereo", [(FISHEYE, False), (dict(
    FISHEYE, setup="stereo", focal_x_baseline=19.1), True), (EQUIRECT, False)],
    ids=["fisheye", "fisheye_stereo", "equirect"])
def test_pose_lm_matches_jax(rng, spec, stereo):
    jcam, cam = _cams(spec)
    args = _lm_problem(rng, cam, spec, stereo)
    rj = jax_pose_optimizer(jcam, stereo=stereo, allow_pallas=False)(
        *(jnp.asarray(a) for a in args))
    rt = PO.make_pose_optimizer(cam, stereo=stereo)(*(_t(a) for a in args))
    np.testing.assert_array_equal(rt.inliers.numpy(), np.asarray(rj.inliers))
    np.testing.assert_allclose(rt.T_cw.numpy(), np.asarray(rj.T_cw), rtol=0, atol=1e-4)
    assert int(rt.num_inliers) == int(rj.num_inliers) >= 200
    np.testing.assert_allclose(rt.chi2.numpy(), np.asarray(rj.chi2), rtol=1e-3, atol=1e-3)


# ---------------------------------------------------------------- Jacobians

def _left_increment(xi, T):
    w, v = xi[:3], xi[3:]
    z = torch.zeros((), dtype=xi.dtype)
    tw = torch.stack([torch.stack([z, -w[2], w[1], v[0]]), torch.stack([w[2], z, -w[0], v[1]]),
                      torch.stack([-w[1], w[0], z, v[2]]), torch.stack([z, z, z, z])])
    return torch.linalg.matrix_exp(tw) @ T


def _assert_rows_close(J, J_ad):
    scale = J_ad.abs().amax(dim=(1, 2), keepdim=True).clamp(min=1e-6)
    torch.testing.assert_close(J / scale, J_ad / scale, atol=1e-4, rtol=0)


def test_equirect_jacobians_match_autodiff(rng):
    _, cam = _cams(EQUIRECT)
    T0, X, obs, _, _ = _lm_problem(rng, cam, EQUIRECT)
    X64, obs64, T64 = _t(X).double(), _t(obs).double(), _t(T0).double()
    edge = R.make_mono_residual(cam)
    J_ad = torch.func.jacfwd(lambda xi: edge(_left_increment(xi, T64), X64, obs64)[0])(
        torch.zeros(6, dtype=torch.float64))                            # (N,2,6)
    # the LM's rows (float32, as it runs)
    J, _, ok, _ = PO.equirect_state(_t(T0), _t(X), _t(obs), torch.ones(len(X)), cam.cols,
                                    cam.rows)
    assert bool((ok > 0).all())
    _assert_rows_close(J.double(), J_ad)
    # BA's camera and landmark blocks, equirectangular and multi-camera edges
    n = len(X)
    oc, ol = torch.zeros(n, dtype=torch.int64), torch.arange(n)
    camv = np.tile(R.make_camv({"model": "equirectangular", "cols": cam.cols,
                                "rows": cam.rows}), (n, 1))
    camv[::2] = R.make_camv({"model": "perspective", "fx": 300.0, "fy": 300.0, "cx": 256.0,
                             "cy": 128.0, "cols": 512, "rows": 256})
    mobs = np.concatenate([obs, camv], 1)
    for multicam, o in ((False, obs64), (True, _t(mobs).double())):
        r, ok, Jc, Jl = BA.reprojection_residuals_and_jacobians(cam, T64[None], X64, oc, ol, o,
                                                                multicam)
        res = R.make_multicam_mono_residual() if multicam else edge
        Jc_ad = torch.func.jacfwd(lambda xi: res(_left_increment(xi, T64), X64, o)[0])(
            torch.zeros(6, dtype=torch.float64))
        Jl_ad = torch.func.jacfwd(lambda d: res(T64, X64 + d, o)[0])(
            torch.zeros((n, 3), dtype=torch.float64))
        Jl_ad = Jl_ad[ol, :, ol]                                      # (N,2,3) diagonal blocks
        sel = ok
        _assert_rows_close(Jc[sel], Jc_ad[sel])
        _assert_rows_close(Jl[sel], Jl_ad[sel])
        assert int(sel.sum()) >= (n // 2 if multicam else n)
    # the poles: autodiff has no derivative there, the port's rows are 0
    pole = torch.tensor([[0.0, 2.0, 0.0], [0.0, -3.0, 0.0]], dtype=torch.float64)
    J_pole = R.equirect_uv_jacobian(pole, cam.cols, cam.rows)
    assert bool((J_pole == 0).all())
    J_ad_pole = torch.func.jacfwd(lambda x: R.equirect_uv(x, cam.cols, cam.rows)[0])(pole)
    assert not bool(torch.isfinite(J_ad_pole).all())


# ---------------------------------------------------------------- bootstrap

@pytest.mark.parametrize("model", ["fisheye", "equirect"])
def test_bearing_init_attempt_with_jax_draws_matches_jax(room, model, rng):
    c = room[model]
    frames = []
    for i in (0, 8):
        kp = c["jfe"].extract(jnp.asarray(c["images"][i]))
        frames.append(JaxFrame.from_keypoints(i, i / 20.0, kp, c["jcam"]))
    ops = lambda f: [f.desc_i8, f.valid, f.xy, f.angle, f.xy_undist, f.bearing]  # noqa: E731
    args = ops(frames[0]) + ops(frames[1])
    for seed in (42,):
        key = jr.PRNGKey(seed)
        out_j = jax.device_get(JTV.init_attempt(key, *map(jnp.asarray, args), jnp.eye(3),
                                                perspective=False))
        (nm_j, use_h_j, counts_j, T21_j, X_j, good_j, m1_j, m2_j, pmask_j, ninl_j) = out_j
        se = np.asarray(jransac.sample_minimal_sets(key, jnp.asarray(pmask_j), 256, 8))
        out = TV.init_attempt_with_samples(None, _t(se), *[_t(np.asarray(a)) for a in args], None)
        assert int(out.num_matches) == int(nm_j) >= 50
        assert not bool(out.use_h) and not bool(use_h_j)
        for name, want in (("m1", m1_j), ("m2", m2_j), ("pmask", pmask_j), ("good", good_j)):
            np.testing.assert_array_equal(getattr(out, name).numpy(), want, err_msg=name)
        assert int(out.n_inl) == int(ninl_j)
        np.testing.assert_array_equal(np.sort(out.counts.numpy()), np.sort(counts_j))
        assert (out.counts.numpy()[4:] == -1).all() and counts_j.max() >= 40
        np.testing.assert_allclose(out.T21.numpy(), T21_j, atol=5e-3)
    # the whole attempt through the entry point, on the port's own draws
    res = TV.initialize_two_view(torch.Generator().manual_seed(0), _port_frame(frames[0]),
                                 _port_frame(frames[1]), c["cam"])
    res_j = JTV.initialize_two_view(jr.PRNGKey(0), frames[0], frames[1], c["jcam"])
    assert res.success and res_j.success and res.num_matches == res_j.num_matches
    np.testing.assert_array_equal(res.idx1, res_j.idx1)
    assert not res.used_homography


# ---------------------------------------------------------------- BA

def _equirect_ba_problem(rng, cols=1920, rows=960):
    """Six equirectangular cameras of the THETA S size around a cloud of
    landmarks all round them (so that some observations fall next to the
    seam), 0.5 px noise, 5 % outliers; camera 0 fixed, the rest perturbed;
    padded to C 8, L 256, O 2048."""
    _, cam = _cams(dict(EQUIRECT, cols=cols, rows=rows))
    n_pts, C, L, O = 200, 8, 256, 2048
    X_gt = rng.uniform(-6, 6, (n_pts, 3))
    X_gt = X_gt[np.linalg.norm(X_gt, axis=-1) > 2.5][:150]
    n_pts = len(X_gt)
    T = np.tile(np.eye(4, dtype=np.float32), (C, 1, 1))
    cam_opt, cam_valid = np.zeros(C, bool), np.zeros(C, bool)
    oc, ol = np.zeros(O, np.int32), np.zeros(O, np.int32)
    ouv, osg, om = np.zeros((O, 2), np.float32), np.ones(O, np.float32), np.zeros(O, bool)
    n = 0
    seam = 0
    for i in range(6):
        T_gt = jsyn.random_pose_cw(rng, max_angle=0.4, max_trans=0.8).astype(np.float32)
        uv, _, valid = (a.numpy() for a in cam.project(_t((X_gt @ T_gt[:3, :3].T
                                                           + T_gt[:3, 3]).astype(np.float32))))
        cam_valid[i] = True
        cam_opt[i] = i > 0
        pert = jsyn.random_pose_cw(rng, max_angle=0.01, max_trans=0.03) if i else np.eye(4)
        T[i] = (pert @ T_gt).astype(np.float32)
        for j in np.where(valid)[0]:
            oc[n], ol[n] = i, j
            ouv[n] = uv[j] + rng.normal(0, 0.5, 2)
            ouv[n, 0] = np.mod(ouv[n, 0], cols)
            seam += min(ouv[n, 0], cols - ouv[n, 0]) < cols / 180     # 2 degrees
            osg[n] = rng.choice([1.0, 1.44])
            om[n] = True
            n += 1
    bad = rng.choice(n, n // 20, replace=False)
    ouv[bad] += rng.uniform(10, 40, (len(bad), 2))
    ouv[bad, 0] = np.mod(ouv[bad, 0], cols)
    X0 = np.zeros((L, 3), np.float32)
    X0[:n_pts] = X_gt + rng.normal(0, 0.03, X_gt.shape)
    lm_valid = np.zeros(L, bool)
    lm_valid[:n_pts] = True
    assert seam >= 3
    return cam, (T, cam_opt, cam_valid, X0, lm_valid, oc, ol, ouv, osg, om)


def _assert_ba_close(res, res_j, prob):
    inl = res.obs_inlier.numpy()
    np.testing.assert_array_equal(inl, np.asarray(res_j.obs_inlier))
    np.testing.assert_allclose(res.T_cw.numpy(), np.asarray(res_j.T_cw), atol=1e-4)
    lv = prob[4]
    n_inl = np.bincount(prob[6][prob[9] & inl], minlength=len(lv))
    rel = (np.linalg.norm(res.X.numpy() - np.asarray(res_j.X), axis=-1)
           / np.maximum(np.linalg.norm(np.asarray(res_j.X), axis=-1), 1.0))
    assert (lv & (n_inl >= 3)).sum() >= 0.9 * lv.sum()
    assert rel[lv & (n_inl >= 3)].max() <= 1e-4
    assert rel[lv & (n_inl >= 1)].max() <= 1e-3
    assert abs(float(res.cost) - float(res_j.cost)) <= 1e-4 * abs(float(res_j.cost))


@pytest.mark.parametrize("kind", ["local", "global"])
def test_equirect_ba_matches_jax(rng, kind):
    cam, prob = _equirect_ba_problem(rng)
    jcam = jbase.make_camera_from_config(dict(EQUIRECT, cols=cam.cols, rows=cam.rows))
    if kind == "local":
        res_j = jax.device_get(jax_local_ba(jcam)(JaxBAProblem(*map(jnp.asarray, prob))))
        res = BA.make_local_ba(cam)(BA.BAProblem(*(_t(np.array(a)) for a in prob)))
    else:
        res_j = jax.device_get(jax_global_ba(jcam, iters=8, cg_iters=30)(
            JaxBAProblem(*map(jnp.asarray, prob))))
        res = BA.make_global_ba(cam, iters=8, cg_iters=30)(
            BA.BAProblem(*(_t(np.array(a)) for a in prob)))
    _assert_ba_close(res, res_j, prob)
    n = int(prob[9].sum())
    assert n // 40 <= n - int(res.obs_inlier.sum()) <= n // 10


@pytest.mark.parametrize("case,ok", [("same", True), ("camera_moved", False)])
def test_ba_agreement_any_order_fails_a_wrong_solution(rng, case, ok):
    """chip_smoke's replay of phases 8 and 8b's local BA, which accepts the
    card's result when it agrees with the CPU's in one of three summation
    orders, passes the CPU's own solution at once and fails one with a
    camera moved by 1 cm in every order."""
    import chip_smoke

    cam, prob = _equirect_ba_problem(rng)
    p = BA.BAProblem(*(_t(np.array(a)) for a in prob))
    solve = BA.make_local_ba(cam, 3, 3)
    res = BA.BAResult(*(x.clone() for x in solve(p)))
    if case == "camera_moved":
        res.T_cw[int(torch.nonzero(p.cam_opt)[0, 0]), 0, 3] += 0.01
    got, rows = chip_smoke.ba_agreement_any_order(cam, p, res, solve)
    assert got == ok and len(rows) == (1 if ok else 3), rows


# ---------------------------------------------------------------- TrackStep

@pytest.mark.parametrize("model,mode", [("fisheye", "mono"), ("equirect", "mono"),
                                        ("fisheye", "stereo")])
def test_track_step_matches_jax(room, model, mode):
    """One step of lap frame 2 against tables built from frame 0's keypoints
    at their ray's hit on the walls (the last-frame table and the local
    map), predicted 2 cm off frame 2's pose."""
    c = room[model]
    spec = dict(c["spec"], setup="stereo", focal_x_baseline=c["spec"]["fx"] * BASELINE) \
        if mode == "stereo" else c["spec"]
    jcam, cam = _cams(spec)
    gt = room["gt"]
    fe = OrbFrontend(cam.rows, cam.cols, max_keypts=KPTS, num_levels=LEVELS, device="cpu")
    ts = TrackStep(cam, fe, lm_capacity=LCAP, mode=mode, device="cpu")
    jts = JaxTrackStep(jcam, c["jfe"], lm_capacity=LCAP, mode=mode)
    P = ts.prev_capacity
    kp0 = fe.extract(_t(c["images"][0]))
    valid0 = kp0.valid.numpy()
    Xw = _wall_points(room["scene"], gt[0], cam.keypoints_to_bearings(kp0.xy).numpy())
    has = valid0 & np.isfinite(Xw).all(-1)
    rows = np.where(has)[0][:LCAP]
    prev_pos = np.zeros((P, 3), np.float32)
    prev_valid = np.zeros(P, bool)
    prev_pos[rows], prev_valid[rows] = Xw[rows], True
    prev_desc = kp0.desc_u32.numpy().view(np.uint32)
    prev_level = kp0.level.numpy().astype(np.int32)
    n = len(rows)
    loc_pos = np.zeros((LCAP, 3), np.float32)
    loc_valid = np.zeros(LCAP, bool)
    loc_bits = np.zeros((LCAP, 256), np.int8)
    loc_slot = np.full(LCAP, -1, np.int64)
    loc_pos[:n], loc_valid[:n], loc_slot[:n] = Xw[rows], True, rows
    loc_bits[:n] = unpack_bits_i8(kp0.desc_u32[_t(rows)]).numpy()
    c0 = -gt[0][:3, :3].T @ gt[0][:3, 3]
    maxd = np.zeros(LCAP, np.float32)
    maxd[:n] = np.linalg.norm(Xw[rows] - c0, axis=-1) * 1.2 ** prev_level[rows]
    last = convert.last_frame_from_numpy(prev_pos, prev_desc, prev_valid, prev_level, "cpu")
    local = convert.local_map_from_numpy(loc_pos, loc_bits, loc_valid, maxd, loc_slot, "cpu")
    img = c["images"][2]
    aux = c["right"][2] if mode == "stereo" else None
    T_pred = gt[2].astype(np.float32)
    T_pred[:3, 3] += [0.02, 0.0, 0.0]
    rt = ts.step(_t(img), None, _t(T_pred), last, local, None if aux is None else _t(aux))
    rj = jts.step(jnp.asarray(img), None, jnp.asarray(T_pred), jnp.asarray(prev_pos),
                  jnp.asarray(prev_desc), jnp.asarray(prev_valid), jnp.asarray(prev_level),
                  jnp.asarray(loc_pos), jnp.asarray(loc_bits), jnp.asarray(loc_valid),
                  jnp.asarray(maxd), jnp.asarray(loc_slot.astype(np.int32)),
                  *(() if aux is None else (jnp.asarray(aux),)))
    for fld in ("kp_xy", "kp_valid", "kp_response", "kp_level"):
        np.testing.assert_array_equal(getattr(rt, fld).numpy(), np.asarray(getattr(rj, fld)))
    np.testing.assert_allclose(rt.kp_bearing.numpy(), np.asarray(rj.kp_bearing), rtol=0,
                               atol=1e-5)
    assert (rt.kp_src.numpy() == np.asarray(rj.kp_src)).mean() >= 0.99
    np.testing.assert_allclose(rt.T_cw.numpy(), np.asarray(rj.T_cw), rtol=0, atol=1e-3)
    for a, b in ((rt.num_inliers, rj.num_inliers), (rt.n_stage1, rj.n_stage1)):
        assert abs(int(a) - int(b)) <= 0.02 * max(int(b), 1), (int(a), int(b))
    assert int(rt.num_inliers) >= 60
    if mode == "stereo":
        acc, acc_j = rt.kp_depth.numpy() > 0, np.asarray(rj.kp_depth) > 0
        assert (acc == acc_j).mean() >= 0.995 and acc.sum() >= 20
    # the map is metric here (ground-truth walls): no scale to align
    ct = -rt.T_cw.numpy()[:3, :3].T @ rt.T_cw.numpy()[:3, 3]
    np.testing.assert_allclose(ct, -gt[2][:3, :3].T @ gt[2][:3, 3], atol=0.03)


# ---------------------------------------------------------------- System

def _jax_tracker_draws(monkeypatch):
    """Feed the port's bootstrap the RANSAC draws the JAX tracker makes:
    its key 42, split once per attempt, the essential matrix's 8-point
    sets (the homography's and fundamental's for a perspective camera)."""
    state = {"key": jr.PRNGKey(42)}

    def draws(gen, pmask, n_hyp=TV.N_HYP, perspective=True):
        state["key"], k = jr.split(state["key"])
        m = jnp.asarray(pmask.cpu().numpy())
        take = lambda kk, s: _t(np.asarray(jransac.sample_minimal_sets(kk, m, n_hyp, s)))  # noqa
        if not perspective:
            return None, take(k, 8)
        k1, k2 = jr.split(k)
        return take(k1, 4), take(k2, 8)

    monkeypatch.setattr(TV, "draw_samples", draws)


@pytest.mark.parametrize("model", ["fisheye", "equirectangular"])
def test_system_e2e_point(rng, model, monkeypatch):
    """tests/test_fisheye_equirect_e2e.py's points through the port's System."""
    if model == "fisheye":
        cam_d = {"name": "fisheye-synth", "setup": "monocular", "model": "fisheye",
                 "fx": 280.0, "fy": 280.0, "cx": 208.0, "cy": 160.0, "k1": -0.02,
                 "k2": 0.006, "k3": -0.002, "k4": 0.0005, "cols": 416, "rows": 320, "fps": 20}
        feat, n, gates = {"max_num_keypts": 600, "num_levels": 4, "scale_factor": 1.2}, 22, (
            0.8, 0.12)
    else:
        cam_d = {"name": "equirect-synth", "setup": "monocular", "model": "equirectangular",
                 "cols": 640, "rows": 320, "fps": 20}
        feat, n, gates = {"max_num_keypts": 800, "num_levels": 4, "scale_factor": 1.2}, 24, (
            0.6, 0.15)
    cfg = Config.from_dict({"Camera": cam_d, "Feature": feat, "LoopDetector": {"enabled": False}})
    cam = cfg.camera
    _jax_tracker_draws(monkeypatch)
    scene = synthetic.PlaneSceneRenderer(rng, x_range=(-8, 12), y_range=(-7, 7), plane_z=6.0,
                                         res=50, rows=cam.rows, cols=cam.cols)
    poses = np.stack([synthetic.lookat_pose_cw((x, 0, 0), (x, 0, 6))
                      for x in np.linspace(0.0, 3.0, n)])
    s = System(cfg, device="cpu")
    s.startup()
    tracked = sum(s.feed_monocular_frame(scene.render(cam, poses[i]), i / 20.0) is not None
                  for i in range(n))
    s.shutdown()
    assert s._fused_frames > 0.5 * tracked, (s._fused_frames, tracked)
    _, est, mask = s.tracked_poses()
    idx = np.where(mask)[0]
    ate = evaluate.ate_rmse(np.stack([-est[i][:3, :3].T @ est[i][:3, 3] for i in idx]),
                            np.stack([-poses[i][:3, :3].T @ poses[i][:3, 3] for i in idx]),
                            align="sim3")
    assert tracked > gates[0] * n, f"tracked {tracked}/{n}"
    assert ate < gates[1], f"{model} ATE {ate:.3f}"
    assert s.stats()["worker_exceptions"] == 0


# ---------------------------------------------------------------- Sim3 validation

def test_sim3_transform_optimizer_matches_jax(rng):
    """tests/test_torch_loop.py's Sim3 refinement problem through the
    equirectangular camera against JAX (both take the camera's ``project``
    and autodiff, and neither wraps the seam there: these landmarks lie
    away from it), and through the fisheye camera against the port's own
    perspective camera of the same K: a fisheye's ``project`` is that
    pinhole projection, so the two solutions are the same bit for bit
    (the perspective one is held against JAX by test_torch_loop.py)."""
    from openvslam_tpu.ops import sim3 as jsim3
    from openvslam_tpu.optimize.sim3_transform import make_sim3_transform_optimizer as jax_opt
    from openvslam_tpu_torch.optimize.sim3_transform import make_sim3_transform_optimizer

    R_gt, t_gt, s_gt = jsyn.random_sim3(rng, max_angle=0.3, max_trans=0.5, scale_range=(0.8, 1.3))
    n = 128
    lm2 = jsyn.landmark_cloud(rng, n, center=(0, 0, 5), extent=(3, 2, 1.5))
    g_gt = (jnp.asarray(R_gt, jnp.float32), jnp.asarray(t_gt, jnp.float32), jnp.float32(s_gt))
    lm1 = np.asarray(jsim3.transform(g_gt, jnp.asarray(lm2, jnp.float32)))
    xi = np.concatenate([rng.standard_normal(3) * 0.02, rng.standard_normal(3) * 0.05, [0.03]])
    g0 = jsim3.compose(jsim3.exp(jnp.asarray(xi, jnp.float32)), g_gt)
    for spec in (EQUIRECT, FISHEYE):
        jcam, cam = _cams(spec)
        noise = lambda: rng.standard_normal((n, 2)) * 0.3  # noqa: E731
        uv1 = np.asarray(jcam.project(jnp.asarray(lm1, jnp.float32))[0]) + noise()
        uv2 = np.asarray(jcam.project(jnp.asarray(lm2, jnp.float32))[0]) + noise()
        uv2[:6] += 40.0
        args = [np.asarray(g0[0]), np.asarray(g0[1]), np.asarray(g0[2]), lm1.astype(np.float32),
                lm2.astype(np.float32), uv1.astype(np.float32), uv2.astype(np.float32),
                np.ones(n, np.float32), np.ones(n, np.float32), np.ones(n, bool)]
        res = make_sim3_transform_optimizer(cam)(*(torch.as_tensor(np.array(a)) for a in args))
        if spec is EQUIRECT:
            ref = jax.device_get(jax_opt(jcam)(*map(jnp.asarray, args)))
        else:
            pin = make_camera_from_config(dict(spec, model="perspective", k1=0.0, k2=0.0,
                                               k3=0.0))
            ref = make_sim3_transform_optimizer(pin)(
                *(torch.as_tensor(np.array(a)) for a in args))
            ref = type(ref)(*(t.numpy() for t in ref))
            np.testing.assert_array_equal(res.R.numpy(), ref.R)
        np.testing.assert_allclose(res.R.numpy(), ref.R, atol=1e-4)
        np.testing.assert_allclose(res.t.numpy(), ref.t, atol=1e-4)
        np.testing.assert_allclose(float(res.s), float(ref.s), atol=1e-4)
        np.testing.assert_array_equal(res.inliers.numpy(), ref.inliers)
        assert int(res.num_inliers) == int(ref.num_inliers) >= 100
        assert np.linalg.norm(res.R.numpy() - R_gt) < 1e-2
