"""The port's loop worker (``GlobalOptimizationModule.start_loop_worker``),
held to the gates of tests/test_loop_worker.py: the queue is handed over
and checked in order, stop drains what is still queued, and a correction
pauses the mapper, runs between pause and resume, and is discarded when a
whole-map geometry rewrite lands during its validation.  Also: a check
that raises on the worker is counted and the worker goes on.
"""
import threading
import time

import numpy as np

from openvslam_tpu_torch.config import Config
from openvslam_tpu_torch.data import Frame, MapDatabase
from openvslam_tpu_torch.module.global_optimization_module import GlobalOptimizationModule


def _make_go(async_worker=False):
    cfg = Config.from_dict({
        "Camera": {"setup": "monocular", "model": "perspective",
                   "fx": 200.0, "fy": 200.0, "cx": 160.0, "cy": 120.0,
                   "cols": 320, "rows": 240, "fps": 10},
        "Feature": {"max_num_keypts": 200, "num_levels": 3},
    })
    db = MapDatabase(kpt_capacity=512)
    go = GlobalOptimizationModule(cfg, cfg.camera, db, device="cpu")
    go.map_lock = threading.RLock()
    if async_worker:
        go.start_loop_worker()
    return go, db


def _enqueue(go, kfs):
    with go._loop_qlock:
        go._loop_queue.extend(kfs)
    go._loop_wake.set()


def test_worker_processes_queue_in_order_and_drains_on_stop():
    go, _ = _make_go(async_worker=True)
    seen = []
    done = threading.Event()

    def fake_check(kf):
        seen.append(kf)
        if len(seen) == 3:
            done.set()

    go._loop_check = fake_check
    for kf in (7, 8, 9):
        _enqueue(go, [kf])
    assert done.wait(timeout=10.0)
    assert seen == [7, 8, 9]
    go.stop_loop_worker(timeout=30.0)
    assert go._loop_thread is None
    assert go.loop_idle


def test_stop_drains_pending_queue():
    go, _ = _make_go(async_worker=True)
    seen = []
    gate = threading.Event()

    def fake_check(kf):
        gate.wait(timeout=10.0)
        seen.append(kf)

    go._loop_check = fake_check
    _enqueue(go, [1, 2, 3])
    time.sleep(0.1)
    gate.set()
    go.stop_loop_worker(timeout=30.0)   # checks the remaining queue first
    assert seen == [1, 2, 3]


def test_worker_counts_a_failing_check_and_goes_on():
    go, _ = _make_go(async_worker=True)
    seen = []

    def fake_check(kf):
        if kf == 2:
            raise RuntimeError("planted failure")
        seen.append(kf)

    go._loop_check = fake_check
    _enqueue(go, [1, 2, 3])
    go.stop_loop_worker(timeout=30.0)
    assert seen == [1, 3]
    assert go.faults.count == 1 and "planted failure" in go.faults.first


class _StubProxy:
    """Mapper-proxy stand-in recording the pause/resume protocol."""

    def __init__(self):
        self.events = []
        self.paused = False

    def pause(self, wait=False):
        self.events.append(("pause", wait))
        self.paused = True

    def resume(self):
        self.events.append(("resume",))
        self.paused = False


def _tiny_two_kf_map(db):
    """Two keyframes sharing landmarks (enough structure for correct_loop
    to propagate through)."""
    rng = np.random.default_rng(3)
    K = db.K
    for fid in range(2):
        n = 80
        f = Frame(
            frame_id=fid, timestamp=float(fid),
            xy=np.zeros((K, 2), np.float32),
            xy_undist=rng.uniform(0, 200, (K, 2)).astype(np.float32),
            bearing=np.tile(np.array([0, 0, 1.0], np.float32), (K, 1)),
            level=np.zeros(K, np.int32), angle=np.zeros(K, np.float32),
            response=np.zeros(K, np.float32),
            desc_u32=rng.integers(0, 2**32, (K, 8), dtype=np.uint32),
            desc_i8=rng.integers(0, 2, (K, 256)).astype(np.int8),
            valid=np.arange(K) < n,
            x_right=np.full(K, -1, np.float32),
            depth=np.full(K, -1, np.float32),
            lm_idx=np.full(K, -1, np.int32),
            outlier=np.zeros(K, bool),
        )
        T = np.eye(4, dtype=np.float32)
        T[0, 3] = 0.1 * fid
        f.pose_cw = T
        kf = db.add_keyframe(f)
        if fid == 0:
            for i in range(40):
                lm = db.add_landmark(rng.normal(0, 1, 3).astype(np.float32),
                                     f.desc_u32[i], f.desc_i8[i], kf)
                db.add_observation(lm, kf, i)
        else:
            for i, lm in enumerate(db.valid_lm_ids()[:40]):
                db.add_observation(int(lm), kf, i)
    for k in db.valid_kf_ids():
        db.update_connections(int(k))


def test_correction_pauses_mapper_and_discards_stale_sim3():
    """The correction protocol: pause(wait=True) before taking the lock,
    resume after; a geom_version bump while the validation was in flight
    discards the Sim3 instead of applying it to rewritten geometry."""
    go, db = _make_go(async_worker=False)   # drive _loop_check inline
    _tiny_two_kf_map(db)
    proxy = _StubProxy()
    go.mapper_proxy = proxy
    kf, cand = 1, 0

    corrected = []
    go.correct_loop = lambda *a, **k: corrected.append(a)
    go.loop_detector.detect = lambda k: [cand]
    # the batched first-stage gate would reject the random descriptors;
    # this test drives the correction protocol, not the matcher
    go.loop_detector.prefilter_counts = lambda snaps: np.full(len(snaps), 999, np.int32)
    go.last_loop_kf = -100        # keyframe ids are tiny; clear the cooldown

    ident = (np.eye(3, dtype=np.float32), np.zeros(3, np.float32), 1.0,
             np.arange(5), np.arange(5), np.arange(5), np.arange(5))

    # case 1: a clean validation -> the correction runs between pause/resume
    go.loop_detector.validate_snapshot = lambda snap, min_inliers=20: ident
    go._loop_check(kf)
    assert corrected, "correction did not run"
    assert proxy.events[0] == ("pause", True)
    assert proxy.events[-1] == ("resume",)
    assert go.num_loops_closed == 1
    assert go.loop_stale_discards == 0

    # case 2: a geometry rewrite lands during the validation -> discard
    corrected.clear()
    go.last_loop_kf = -100

    def bump_then_validate(snap, min_inliers=20):
        db.geom_version += 1      # a global BA / pose graph landed meanwhile
        return ident

    go.loop_detector.validate_snapshot = bump_then_validate
    go._loop_check(kf)
    assert not corrected, "a stale Sim3 must not be applied"
    assert go.loop_stale_discards == 1
    assert not proxy.paused       # resume ran on the discard path too
