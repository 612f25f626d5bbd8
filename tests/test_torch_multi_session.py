"""Concurrent sessions and their pooled, landmark-sharded BA in the port
(``parallel/multi_session.py``), after the JAX package's
test_multi_session.py at a smaller size (320x240, 300 keypoints, 3
levels, 14 frames a session) on the CPU:

* three mono sessions run pipelined (``feed_sequence``, depth 1) with a
  joint BA every 20 frames, beside a fourth session (another camera)
  whose frame iterator raises at its 7th frame: that one is dropped into
  ``failed``, the others track > 0.8 of their frames after the first;
* the joint BA of the three lowers their pooled robust cost below 0.8 of
  its value after a perturbation; 1 and 4 shards agree within 5 %;
* the pool of the fourth session (its map as it was when it failed) and
  another takes the multi-camera edge;
* two stereo sessions (plain feed) pool with (u, v, u_right) edges and
  keep their metric scale through the joint BA;
* ``pool_sessions`` on map files loaded into both packages equals the
  JAX package's, array for array;
* a session whose map lock another thread holds makes the pool raise
  TimeoutError after the bounded wait instead of hanging.
"""
import threading
import types

import numpy as np
import pytest
import torch

from openvslam_tpu.camera.base import make_camera_from_config as jax_make_camera
from openvslam_tpu.data.map_database import MapDatabase as JMapDatabase
from openvslam_tpu.io import map_database_io as jio
from openvslam_tpu.parallel.multi_session import pool_sessions as jax_pool_sessions
from openvslam_tpu_torch.camera.base import camera_to_config
from openvslam_tpu_torch.config import Config
from openvslam_tpu_torch.data.map_database import MapDatabase
from openvslam_tpu_torch.io import map_database_io as pio
from openvslam_tpu_torch.optimize import residuals as R
from openvslam_tpu_torch.parallel import MultiSessionRunner, make_mesh
from openvslam_tpu_torch.parallel import multi_session
from openvslam_tpu_torch.parallel.distributed_ba import make_distributed_ba, partition_problem
from openvslam_tpu_torch.parallel.multi_session import pool_sessions
from openvslam_tpu_torch.system import System
from openvslam_tpu_torch.utils import synthetic

ROWS, COLS, KPTS, FRAMES = 240, 320, 300, 14
BASELINE_M = 0.2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config(fx=350.0, setup="monocular", **cam):
    return Config.from_dict({
        "Camera": {"name": f"syn{fx:.0f}{setup}", "setup": setup, "model": "perspective",
                   "fx": fx, "fy": fx, "cx": COLS / 2, "cy": ROWS / 2, "cols": COLS,
                   "rows": ROWS, "fps": 20, **cam},
        "Feature": {"max_num_keypts": KPTS, "num_levels": 3, "scale_factor": 1.2},
        "LoopDetector": {"enabled": False}})


def _session_frames(cam, seed, n=FRAMES, center=(0, 0, 6)):
    scene = synthetic.PatchSceneRenderer(np.random.default_rng(seed), n_points=600,
                                         center=center, extent=(6, 4.5, 2.5), rows=cam.rows,
                                         cols=cam.cols)
    poses = synthetic.orbit_trajectory(n, radius=2.5, target=center, arc=np.pi / 5)
    return [(scene.render(cam, poses[i]), i / 20.0) for i in range(n)]


def _failing(frames, at):
    for i, f in enumerate(frames):
        if i == at:
            raise RuntimeError("camera disconnected")
        yield f


def _pooled_cost(runner):
    """The pooled robust reprojection cost of the live maps (each
    observation under its own camera's pinhole)."""
    built = runner.snapshot_problem()
    p = built["prob"]
    T, X = p.T_cw.numpy(), p.X.numpy()
    oc, ol, uv = p.obs_cam.numpy(), p.obs_lm.numpy(), p.obs_uv.numpy()
    if built["multicam"]:
        f = uv[:, 2:6]
    else:
        c = runner.systems[0].cam
        f = np.tile(np.array([c.fx, c.fy, c.cx, c.cy], np.float32), (len(oc), 1))
    Xc = np.einsum("oij,oj->oi", T[oc][:, :3, :3], X[ol]) + T[oc][:, :3, 3]
    z = np.maximum(Xc[:, 2], 1e-9)
    pred = np.stack([f[:, 0] * Xc[:, 0] / z + f[:, 2], f[:, 1] * Xc[:, 1] / z + f[:, 3]], -1)
    c2 = np.sum((uv[:, :2] - pred) ** 2, -1) / p.obs_sigma2.numpy()
    thr = 5.991
    rho = np.where(c2 <= thr, c2, 2 * np.sqrt(thr * np.maximum(c2, 0)) - thr)
    return float(np.sum(rho * (p.obs_mask.numpy() & (Xc[:, 2] > 1e-9))))


@pytest.fixture(scope="module")
def multi_run():
    systems = [System(_config(), device="cpu") for _ in range(3)]
    frames = [_session_frames(s.cam, seed=20 + i) for i, s in enumerate(systems)]
    drop = System(_config(fx=300.0), device="cpu")
    systems.append(drop)
    frames.append(_failing(_session_frames(drop.cam, seed=23), at=6))
    runner = MultiSessionRunner(systems, mesh=make_mesh(4, "cpu"))
    tracked = runner.run(frames, joint_ba_every=20, joint_ba_iters=4, pipeline=True)
    runner.shutdown()
    return runner, tracked


def test_sessions_track_and_a_failing_one_drops(multi_run):
    runner, tracked = multi_run
    assert runner.failed == [3]
    # the depth-1 pipeline reads one frame ahead: the 7th frame's failure
    # ends the session after its 5th result
    assert len(tracked[3]) == 5
    assert runner.joint_ba_runs >= 2          # every 20 frames fed, and at the end
    for i, t in enumerate(tracked[:3]):
        t = np.array(t)
        assert len(t) == FRAMES and t.any(), f"session {i} never initialized"
        first = int(np.argmax(t))
        assert t[first:].mean() > 0.8, f"session {i}: {t}"
        s = runner.systems[i]
        assert s._fused_frames > 0, f"session {i} never took the pipelined path"
        assert s.map_db.n_kfs >= 2 and len(s.map_db.valid_lm_ids()) > 60
        for k in s.map_db.valid_kf_ids():
            assert np.isfinite(s.map_db.kf_pose_cw[int(k)]).all()
    assert all(not s._running for s in runner.systems)


def test_joint_ba_improves_and_shards_agree(multi_run):
    runner = MultiSessionRunner(multi_run[0].systems[:3], mesh=make_mesh(4, "cpu"))
    rng = np.random.default_rng(5)
    for s in runner.systems:
        db = s.map_db
        for k in db.valid_kf_ids():
            if int(k) != db.origin_kf:
                db.kf_pose_cw[int(k)][:3, 3] += rng.standard_normal(3) * 0.01
        for l in db.valid_lm_ids():
            db.lm_pos[int(l)] += rng.standard_normal(3).astype(np.float32) * 0.01
    built = runner.snapshot_problem()
    assert not built["multicam"] and not built["stereo"]
    costs = {}
    for shards in (1, 4):
        _, _, c = make_distributed_ba(runner.systems[0].cam, make_mesh(shards, "cpu"), iters=4)(
            partition_problem(built["prob"], shards))
        costs[shards] = float(c)
    assert abs(costs[1] - costs[4]) / max(costs[1], 1e-9) < 0.05, costs
    before = _pooled_cost(runner)
    cost = runner.joint_bundle_adjust(iters=8)
    assert cost is not None and np.isfinite(cost)
    after = _pooled_cost(runner)
    assert after < before * 0.8, (before, after)
    assert runner.joint_ba_runs == 1
    for s in runner.systems:
        for k in s.map_db.valid_kf_ids():
            assert np.isfinite(s.map_db.kf_pose_cw[int(k)]).all()
        for l in s.map_db.valid_lm_ids():
            assert np.isfinite(s.map_db.lm_pos[int(l)]).all()


def test_two_cameras_take_the_multicam_edge(multi_run):
    s0, drop = multi_run[0].systems[0], multi_run[0].systems[3]
    assert drop.map_db.n_kfs >= 2, "the failing session built no map before it failed"
    runner = MultiSessionRunner([s0, drop], mesh=make_mesh(2, "cpu"))
    built = runner.snapshot_problem()
    assert built["multicam"] and not built["stereo"]
    ouv, om, oc = built["prob"].obs_uv.numpy(), built["prob"].obs_mask.numpy(), \
        built["prob"].obs_cam.numpy()
    assert ouv.shape[1] == 2 + R.CAMV_DIM
    n0 = len(built["per_session"][0]["cam_index"])
    for cams, s in ((oc < n0, s0), (oc >= n0, drop)):
        np.testing.assert_array_equal(ouv[om & cams, 2:],
                                      np.broadcast_to(R.make_camv(camera_to_config(s.cam)),
                                                      ouv[om & cams, 2:].shape))
    before = _pooled_cost(runner)
    cost = runner.joint_bundle_adjust(iters=4)
    assert cost is not None and np.isfinite(cost)
    assert _pooled_cost(runner) <= before


def _stereo_frames(cam, seed, n=10, x0=0.0):
    scene = synthetic.PlaneSceneRenderer(np.random.default_rng(seed), x_range=(x0 - 4, x0 + 10),
                                         y_range=(-5, 5), plane_z=7.0, rows=cam.rows,
                                         cols=cam.cols)
    poses = np.stack([synthetic.lookat_pose_cw((x, 0, 0), (x, 0, 7))
                      for x in np.linspace(x0, x0 + 4.0, n)])
    shift = np.eye(4)
    shift[0, 3] = -BASELINE_M
    return [(scene.render(cam, p), scene.render(cam, shift @ p), i / 10.0)
            for i, p in enumerate(poses)]


def test_stereo_sessions_pooled_ba():
    cfg = _config(setup="stereo", focal_x_baseline=350.0 * BASELINE_M, depth_threshold=30.0)
    systems = [System(cfg, device="cpu") for _ in range(2)]
    streams = [_stereo_frames(s.cam, seed=60 + i, x0=30.0 * i) for i, s in enumerate(systems)]
    runner = MultiSessionRunner(systems, mesh=make_mesh(2, "cpu"))
    tracked = runner.run(streams)
    for i, t in enumerate(tracked):
        assert np.mean(t) > 0.8, f"stereo session {i}: {t}"
    built = runner.snapshot_problem()
    assert built["stereo"] and not built["multicam"]
    ouv, om = built["prob"].obs_uv.numpy(), built["prob"].obs_mask.numpy()
    assert ouv.shape[1] == 3
    assert (ouv[om, 2] >= 0).mean() > 0.5, "no stereo observations pooled"
    cost = runner.joint_bundle_adjust(iters=6)
    assert cost is not None and np.isfinite(cost)
    for s in systems:
        db = s.map_db
        ids = sorted(int(k) for k in db.valid_kf_ids())
        for k in ids:
            assert np.isfinite(db.kf_pose_cw[k]).all()
        # metric scale survives the pooled solve: the keyframes still span
        # about the rendered 4 m
        cs = np.stack([-db.kf_pose_cw[k][:3, :3].T @ db.kf_pose_cw[k][:3, 3] for k in ids])
        assert 1.0 < np.linalg.norm(cs[-1] - cs[0]) < 8.0
    runner.shutdown()


def test_pool_sessions_matches_jax(multi_run, tmp_path):
    ours, theirs = [], []
    for i, s in enumerate(multi_run[0].systems[:2]):
        path = str(tmp_path / f"map{i}.msg")
        s.save_map_database(path)
        pdb, jdb = MapDatabase(kpt_capacity=s.map_db.K), JMapDatabase(kpt_capacity=s.map_db.K)
        pio.load_map(pdb, path)
        jio.load_map(jdb, path)
        opt = types.SimpleNamespace(sigma2=s.global_optimizer.sigma2)
        ours.append(types.SimpleNamespace(map_lock=threading.RLock(), map_db=pdb, cam=s.cam,
                                          global_optimizer=opt))
        theirs.append(types.SimpleNamespace(
            map_lock=threading.RLock(), map_db=jdb, global_optimizer=opt,
            cam=jax_make_camera(camera_to_config(s.cam))))
    a, b = pool_sessions(ours), jax_pool_sessions(theirs)
    for f, x, y in zip(a["prob"]._fields, a["prob"], b["prob"]):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y), err_msg=f)
        assert x.numpy().dtype == np.asarray(y).dtype, f
    np.testing.assert_array_equal(a["cam_opt"], b["cam_opt"])
    assert (a["multicam"], a["stereo"], a["shapes"]) == (b["multicam"], b["stereo"], b["shapes"])
    for pa, pb in zip(a["per_session"], b["per_session"]):
        assert pa["cam_index"] == pb["cam_index"] and pa["lm_index"] == pb["lm_index"]


def test_a_held_map_lock_times_out(monkeypatch):
    monkeypatch.setattr(multi_session, "LOCK_TIMEOUT_S", 0.2)
    s = types.SimpleNamespace(map_lock=threading.RLock(), cam=_config().camera)
    held, release = threading.Event(), threading.Event()

    def hold():
        with s.map_lock:
            held.set()
            release.wait(10)

    t = threading.Thread(target=hold)
    t.start()
    try:
        assert held.wait(10)
        with pytest.raises(TimeoutError):
            pool_sessions([s])
    finally:
        release.set()
        t.join(10)
    assert not t.is_alive()
