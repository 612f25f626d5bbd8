"""Multi-camera bundle adjustment in the port: per-observation intrinsics
(ref: g2o edges carry their keyframe's camera).

* tests/test_multicam_ba.py's three cases (two perspective cameras of
  different focal lengths, with and without an equirectangular rig, global
  and local BA) through the port: ground truth recovered to that test's
  bounds; in the local case with the equirectangular rig also the port's
  result against JAX's on the same problem (obs_inlier identical, T_cw
  within 1e-4);
* a merged map: a second session's map with its own camera absorbed
  (``MapDatabase.absorb``) and its landmarks fused with the first's.  The
  mapping module's local BA window then spans both cameras and must take
  the multi-camera edge with each keyframe's camera (a keyframe without
  one takes the session camera): a perturbed keyframe of the second
  camera is pulled back to its ground truth, which the session camera's
  intrinsics cannot do.  The global optimization module's full-map
  problem takes the same edge.
"""
import numpy as np
import jax
import pytest
import torch

from openvslam_tpu.optimize.ba import make_local_ba as jax_local_ba
from openvslam_tpu.optimize.residuals import make_multicam_mono_residual as jax_multicam
from openvslam_tpu_torch.camera import camera_to_config, make_camera_from_config
from openvslam_tpu_torch.config import Config
from openvslam_tpu_torch.data import Frame, MapDatabase
from openvslam_tpu_torch.module.global_optimization_module import GlobalOptimizationModule
from openvslam_tpu_torch.module.mapping_module import MappingModule
from openvslam_tpu_torch.optimize import ba as BA
from openvslam_tpu_torch.optimize import residuals as R
from openvslam_tpu_torch.utils import synthetic

from test_multicam_ba import _build_multicam_problem, _check_recovery

_t = torch.from_numpy


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small tensor operations: with the suite's worker processes sharing
    the cores, intra-op threads only contend, so this module runs them on
    one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("kind,with_equirect", [("global", False), ("global", True),
                                                ("local", True)])
def test_multicam_ba_recovers(kind, with_equirect):
    prob, T_gt, X_gt, n_pts, n_rigs = _build_multicam_problem(with_equirect)
    p = BA.BAProblem(*(_t(np.array(a)) for a in prob))
    if kind == "global":
        res = BA.make_global_ba(None, iters=12, cg_iters=40, multicam=True)(p)
    else:
        res = BA.make_local_ba(None, first_iters=6, second_iters=8, multicam=True)(p)
    _check_recovery(res, T_gt, X_gt, n_pts, n_rigs)
    if kind == "local":
        res_j = jax.device_get(jax_local_ba(None, first_iters=6, second_iters=8,
                                            res_fn_override=jax_multicam())(prob))
        np.testing.assert_array_equal(res.obs_inlier.numpy(), np.asarray(res_j.obs_inlier))
        np.testing.assert_allclose(res.T_cw.numpy(), np.asarray(res_j.T_cw), atol=1e-4)


# ---------------------------------------------------------------- merged map

K = 128
SPEC_A = {"name": "cam A", "setup": "monocular", "model": "perspective", "fx": 300.0,
          "fy": 300.0, "cx": 208.0, "cy": 160.0, "cols": 416, "rows": 320, "fps": 20.0}
SPEC_B = {"name": "cam B", "setup": "monocular", "model": "perspective", "fx": 520.0,
          "fy": 500.0, "cx": 320.0, "cy": 240.0, "cols": 640, "rows": 480, "fps": 20.0}


def _config():
    return Config.from_dict({"Camera": SPEC_A, "Feature": {"max_num_keypts": 60,
                                                          "num_levels": 4},
                             "LoopDetector": {"enabled": False}})


def _keyframe(cam, T_cw, X, fid):
    """A keyframe whose keypoint j observes landmark j where it projects."""
    xc = (X @ T_cw[:3, :3].T + T_cw[:3, 3]).astype(np.float32)
    uv, _, valid = (a.numpy() for a in cam.project(_t(xc)))
    xy = np.zeros((K, 2), np.float32)
    xy[: len(X)] = uv
    ok = np.zeros(K, bool)
    ok[: len(X)] = valid
    brg = np.zeros((K, 3), np.float32)
    brg[:, 2] = 1.0
    brg[: len(X)] = cam.keypoints_to_bearings(_t(uv)).numpy()
    f = Frame(fid, fid / 20.0, xy, xy.copy(), brg, np.zeros(K, np.int32), np.zeros(K, np.float32),
              np.ones(K, np.float32), np.zeros((K, 8), np.uint32), np.zeros((K, 256), np.int8),
              ok, np.full(K, -1.0, np.float32), np.full(K, -1.0, np.float32),
              np.full(K, -1, np.int32), np.zeros(K, bool))
    f.pose_cw = T_cw.astype(np.float32)
    return f


def _session(spec, poses, X, fid0):
    """A map of one session: its camera registered, a keyframe per pose and a
    landmark for every point seen twice."""
    cam = make_camera_from_config(spec)
    db = MapDatabase(kpt_capacity=K)
    db.register_camera(spec["name"], camera_to_config(cam), make_default=True)
    kfs = [db.add_keyframe(_keyframe(cam, T, X, fid0 + i)) for i, T in enumerate(poses)]
    for j in range(len(X)):
        seen = [k for k in kfs if db.kf_kpt_valid[k][j]]
        if len(seen) >= 2:
            lm = db.add_landmark(X[j], db.kf_desc_u32[seen[0]][j], db.kf_desc_i8[seen[0]][j],
                                 seen[0])
            for k in seen:
                db.add_observation(lm, k, j)
    for k in kfs:
        db.update_connections(k)
    return db


def _merged_map(rng):
    """Session A (the System's camera) with two keyframes; session B (its own
    camera) with two, absorbed into A's map, its landmarks fused into A's
    (as a loop correction fuses duplicates).  Returns the map, the
    ground-truth poses (A's then B's), B's keyframe ids and each landmark's
    ground-truth position."""
    X = (rng.uniform(-3, 3, (100, 3)) + [0, 0, 8.0]).astype(np.float32)
    poses = ([synthetic.lookat_pose_cw((x, 0, 0), (0, 0, 8)) for x in (-1.0, -0.4)]
             + [synthetic.lookat_pose_cw((x, 0.3, 0.4), (0, 0, 8)) for x in (0.4, 1.0)])
    db = _session(SPEC_A, poses[:2], X, 0)
    kf_map, _ = db.absorb(_session(SPEC_B, poses[2:], X, 10))
    kfs_b = [kf_map[0], kf_map[1]]
    for j in range(len(X)):
        a = max(db.kf_lm_idx[0][j], db.kf_lm_idx[1][j])
        b = max(db.kf_lm_idx[kfs_b[0]][j], db.kf_lm_idx[kfs_b[1]][j])
        if a >= 0 and b >= 0:
            db.replace_landmark(int(b), int(a))
    for k in db.valid_kf_ids():
        db.update_connections(int(k))
    gt_x = {int(lm): X[next(iter(db.lm_obs[lm].values()))] for lm in db.valid_lm_ids()}
    return db, poses, kfs_b, gt_x


def _centre(T):
    return -T[:3, :3].T @ T[:3, 3]


def test_merged_map_local_ba_takes_the_multicam_edge(rng):
    db, poses, kfs_b, _ = _merged_map(rng)
    assert db.kf_camera[0] == "cam A" and db.kf_camera[kfs_b[0]] == "cam B"
    assert kfs_b[0] in db.get_top_covisible(0, 10)
    m = MappingModule(_config(), make_camera_from_config(SPEC_A), db, device="cpu")
    # perturb the second camera's last keyframe; every other quantity exact
    k = kfs_b[1]
    pert = synthetic.random_pose_cw(np.random.default_rng(1), max_angle=0.02, max_trans=0.05)
    db.kf_pose_cw[k] = (pert @ poses[3]).astype(np.float32)
    assert np.linalg.norm(_centre(db.kf_pose_cw[k]) - _centre(poses[3])) > 0.02
    before = db.kf_pose_cw.copy()
    m._run_local_ba(k)
    assert m.ba_runs == 1
    for kf, T_gt in zip([0, 1] + kfs_b, poses):
        assert np.linalg.norm(_centre(db.kf_pose_cw[kf]) - _centre(T_gt)) < 2e-3, kf
    # the window that solve saw: every keyframe's observations carry its camera
    db.kf_pose_cw[:] = before
    prob, cam_index, *_, multicam = m._build_ba_problem(k)
    assert multicam and prob.obs_uv.shape[-1] == 2 + R.CAMV_DIM
    n = int(prob.obs_mask.sum())
    for kf, i in cam_index.items():
        want = (SPEC_B if db.kf_camera[kf] == "cam B" else SPEC_A)["fx"]
        assert (prob.obs_uv[:n, 2][prob.obs_cam[:n] == i] == want).all()
    # a keyframe without a registered camera takes the session camera
    db.kf_camera[kfs_b[0]] = None
    prob, cam_index, *_, multicam = m._build_ba_problem(k)
    assert multicam
    rows = prob.obs_cam[: int(prob.obs_mask.sum())] == cam_index[kfs_b[0]]
    assert bool(rows.any()) and (prob.obs_uv[: len(rows), 2][rows] == SPEC_A["fx"]).all()


def test_merged_map_global_ba_takes_the_multicam_edge(rng):
    db, poses, kfs_b, gt_x = _merged_map(rng)
    go = GlobalOptimizationModule(_config(), make_camera_from_config(SPEC_A), db, device="cpu")
    moved = db.valid_lm_ids()[:10]
    db.lm_pos[moved] += np.float32(0.02)
    built = go._build_global_ba()
    assert built["multicam"] and built["prob"][7].shape[-1] == 2 + R.CAMV_DIM
    go.run_global_ba(iters=10)
    assert max(np.linalg.norm(db.lm_pos[lm] - x) for lm, x in gt_x.items()) < 5e-3
    for kf, T_gt in zip([0, 1] + kfs_b, poses):
        assert np.linalg.norm(_centre(db.kf_pose_cw[kf]) - _centre(T_gt)) < 2e-3, kf
