"""The port's global BA with born-during-BA propagation and its background
thread, held to the gates of tests/test_global_ba_background.py on the same
plane scene: keyframes born while the BA solved keep their pose relative to
their nearest snapshotted ancestor, born landmarks stay finite, the keyframe
map stays within ATE(sim3) 0.15 m; the background thread joins; an abort
discards the result.  Also: a newer correction supersedes a running global
BA without waiting for it, and an exception on the global-BA thread is
counted.
"""
import time

import numpy as np
import pytest
import torch

from openvslam_tpu_torch.config import Config
from openvslam_tpu_torch.system import System
from openvslam_tpu_torch.utils import evaluate, synthetic


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite's worker processes share the cores
    (see tests/test_torch_system.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _make_config(rows=320, cols=416):
    return Config.from_dict({
        "Camera": {"name": "synthetic", "setup": "monocular", "model": "perspective",
                   "fx": 350.0, "fy": 350.0, "cx": cols / 2, "cy": rows / 2,
                   "cols": cols, "rows": rows, "fps": 8},
        "Feature": {"max_num_keypts": 500, "num_levels": 4, "scale_factor": 1.2},
        "LoopDetector": {"enabled": False}})


@pytest.fixture(scope="module")
def session():
    cfg = _make_config()
    cam = cfg.camera
    scene = synthetic.PlaneSceneRenderer(np.random.default_rng(21), x_range=(-4, 14),
                                         y_range=(-5, 5), plane_z=7.0, rows=cam.rows,
                                         cols=cam.cols)
    poses_gt = np.stack([synthetic.lookat_pose_cw((x, 0, 0), (x, 0, 7))
                         for x in np.linspace(0.0, 8.0, 24)])
    s = System(cfg, device="cpu")
    s.startup()
    for i in range(16):
        s.feed_monocular_frame(scene.render(cam, poses_gt[i]), i / 20.0)
    return s, scene, poses_gt


def test_born_during_ba_propagation(session):
    s, scene, poses_gt = session
    go = s.global_optimizer
    db = s.map_db
    cam = s.cam

    built = go._build_global_ba()
    assert built is not None
    snap_kfs = set(built["cam_index"].keys())
    snap_lms = set(built["lm_index"].keys())

    # "while the BA runs": keep feeding, so keyframes and landmarks appear
    for i in range(16, 24):
        s.feed_monocular_frame(scene.render(cam, poses_gt[i]), i / 20.0)
    born_kfs = [int(k) for k in db.valid_kf_ids() if int(k) not in snap_kfs]
    born_lms = [int(l) for l in db.valid_lm_ids() if int(l) not in snap_lms]
    assert born_kfs, "no keyframes born during BA: scenario broken"
    assert born_lms

    T_pre = {int(k): db.kf_pose_cw[int(k)].copy() for k in db.valid_kf_ids()}
    go._apply_global_ba(go._solve_global_ba(go.global_ba, built), built)

    # each born keyframe kept its pose relative to its nearest snapshotted
    # ancestor
    for k in born_kfs:
        anc = k
        while anc not in snap_kfs and anc >= 0:
            anc = int(db.parent[anc])
        assert anc in snap_kfs, f"born KF {k} has no snapshotted ancestor"
        rel_pre = T_pre[k] @ np.linalg.inv(T_pre[anc])
        rel_post = db.kf_pose_cw[k] @ np.linalg.inv(db.kf_pose_cw[anc])
        np.testing.assert_allclose(rel_post, rel_pre, atol=1e-4)
    # born landmarks moved with their reference keyframe and stay finite
    for lm in born_lms[:50]:
        ref = int(db.lm_ref_kf[lm])
        if ref not in T_pre:
            continue
        Xc = db.kf_pose_cw[ref][:3, :3] @ db.lm_pos[lm] + db.kf_pose_cw[ref][:3, 3]
        assert np.isfinite(Xc).all()
    # the whole map is still healthy after the splice
    ids = db.valid_kf_ids()
    est = np.stack([-db.kf_pose_cw[k][:3, :3].T @ db.kf_pose_cw[k][:3, 3] for k in ids])
    gt = np.stack([-poses_gt[f][:3, :3].T @ poses_gt[f][:3, 3] for f in db.kf_src_frame[ids]])
    assert evaluate.ate_rmse(est, gt, align="sim3") < 0.15


def test_async_thread_lifecycle(session):
    s, _, _ = session
    go = s.global_optimizer
    go.async_global_ba = True
    version = s.map_db.geom_version
    try:
        go.run_global_ba()
        assert go._gba_threads
        go.join_global_ba(timeout=300)
        assert not s.loop_BA_is_running()
        assert s.map_db.geom_version == version + 1     # the result was applied
        assert go.faults.count == 0, go.faults.first
    finally:
        go.async_global_ba = False


def test_newer_correction_supersedes_a_running_global_ba(session):
    """A second global BA started while the first still runs, from under
    the map lock as a loop correction starts it: neither call waits (the
    first needs the lock to apply), the first's result is discarded and
    only the second's is applied."""
    s, _, _ = session
    go = s.global_optimizer
    go.async_global_ba = True
    version = s.map_db.geom_version
    superseded = go.gba_superseded
    try:
        with go.map_lock:
            t0 = time.monotonic()
            go.run_global_ba()
            go.run_global_ba()
            assert time.monotonic() - t0 < 5.0
            assert len(go._gba_threads) == 2
        go.join_global_ba(timeout=300)
        assert not s.loop_BA_is_running()
        assert go.gba_superseded == superseded + 1
        assert s.map_db.geom_version == version + 1
        assert go.faults.count == 0, go.faults.first
    finally:
        go.async_global_ba = False


def test_abort_discards_result(session):
    s, _, _ = session
    go = s.global_optimizer
    db = s.map_db
    poses_before = {int(k): db.kf_pose_cw[int(k)].copy() for k in db.valid_kf_ids()}
    go.abort_global_ba = True
    go.run_global_ba()
    assert not go.abort_global_ba          # consumed
    for k, T in poses_before.items():
        np.testing.assert_array_equal(db.kf_pose_cw[k], T)


def test_background_failure_is_counted(session):
    s, _, _ = session
    go = s.global_optimizer
    go.async_global_ba = True
    poses_before = s.map_db.kf_pose_cw.copy()
    faults0 = go.faults.count

    def broken(prob):
        raise RuntimeError("planted failure")

    solver, go.global_ba = go.global_ba, broken
    try:
        go.run_global_ba()
        go.join_global_ba(timeout=60)
        assert go.faults.count == faults0 + 1
        assert "planted failure" in go.faults.first
        np.testing.assert_array_equal(s.map_db.kf_pose_cw, poses_before)
    finally:
        go.global_ba = solver
        go.async_global_ba = False
