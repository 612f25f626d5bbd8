"""The pipelined feed's tracker side and order, held against the JAX package.

- The port's damped lead-N prediction (``TrackingModule._predict_pose``)
  under tests/test_predict_pose.py's gates: exact on constant-twist motion
  for leads 1-4, better than the raw lead displacement under noise, and
  equal to it when the history is only ``lead`` deep.
- Parity: the port's ``_predict_pose`` equals JAX's on the same seeded pose
  histories for leads 1-4 and on a history miss (host numpy in both; equal
  to float32 rounding), with the same miss count.
- Parity: one stub tracker drives both packages' ``System.feed_sequence``
  at depths 1, 2 and 3 with a loss injected mid-flight; both make the same
  sequence of dispatches (frame id, lead), finishes and classic-ladder
  calls, and yield the same frames.
- The one divergence of the feed: the port's backpressure starts at one
  queued keyframe and waits for an idle mapper (JAX's: two, until one).
"""
import collections
import types

import numpy as np
import pytest

from openvslam_tpu.module import tracking_module as jtm
from openvslam_tpu.system import System as JaxSystem
from openvslam_tpu_torch.module import tracking_module as ptm
from openvslam_tpu_torch.system import System as PortSystem


def _turning_poses(n, yaw_per_frame=np.deg2rad(2.0), step=0.3):
    """Constant-twist (steady turn) camera trajectory -> list of T_cw."""
    D = ptm._se3_exp(np.concatenate([[0.0, yaw_per_frame, 0.0], [step, 0.0, 0.02]]))
    T = np.eye(4)
    out = []
    for _ in range(n):
        out.append(T.copy())
        T = D @ T
    return out


def _tracker_stub(cls, poses, upto, first=0):
    """A tracking-module shell of ``cls`` holding the pose history of frames
    ``first..upto``."""
    tm = cls.__new__(cls)
    tm._pose_hist = collections.deque(
        [(i, poses[i].astype(np.float32)) for i in range(first, upto + 1)], maxlen=64)
    tm.velocity = (poses[upto] @ np.linalg.inv(poses[upto - 1])).astype(np.float32)
    tm.pred_hist_misses = 0
    lf = types.SimpleNamespace(frame_id=upto, pose_cw=poses[upto].astype(np.float32))
    return tm, lf


def _err(Ta, Tb):
    return np.linalg.norm(ptm._se3_log(np.linalg.inv(Ta.astype(np.float64)) @ Tb))


def _noisy(rng, poses):
    return [ptm._se3_exp(np.concatenate([rng.normal(0, 2e-3, 3), rng.normal(0, 6e-3, 3)])) @ T
            for T in poses]


def test_constant_twist_exact():
    poses = _turning_poses(30)
    for lead in (1, 2, 3, 4):
        tm, lf = _tracker_stub(ptm.TrackingModule, poses, 20)
        assert _err(tm._predict_pose(lf, lead), poses[20 + lead]) < 1e-4, lead


def test_rotation_noise_damping():
    """With noisy pose estimates the damped prediction beats the raw
    lead-displacement prediction on average."""
    rng = np.random.default_rng(3)
    poses = _turning_poses(40)
    lead, up = 3, 24
    gains = []
    for _ in range(60):
        noisy = _noisy(rng, poses)
        tm, lf = _tracker_stub(ptm.TrackingModule, noisy, up)
        T_damped = tm._predict_pose(lf, lead)
        T_raw = noisy[up] @ np.linalg.inv(noisy[up - lead]) @ noisy[up]
        gains.append(_err(T_raw, poses[up + lead]) - _err(T_damped, poses[up + lead]))
    assert np.mean(gains) > 0, np.mean(gains)
    assert np.median(gains) > 0


def test_window_fallback_equals_raw():
    """With history only ``lead`` deep the damped path is the raw lead
    displacement (W == lead)."""
    poses = _turning_poses(10)
    lead = 3
    tm, lf = _tracker_stub(ptm.TrackingModule, poses, 5, first=2)
    T_raw = (poses[5] @ np.linalg.inv(poses[2]) @ poses[5]).astype(np.float32)
    assert np.abs(tm._predict_pose(lf, lead) - T_raw).max() < 1e-5


@pytest.mark.parametrize("lead", [1, 2, 3, 4])
@pytest.mark.parametrize("first", [0, 19, 24], ids=["full", "short", "miss"])
def test_predict_pose_matches_jax(lead, first):
    """Same seeded noisy history in both packages: the full history, one
    that reaches only part of the window, and one with no entry in it (a
    miss: the repeated one-frame velocity)."""
    rng = np.random.default_rng(100 + lead)
    noisy = _noisy(rng, _turning_poses(30))
    out = []
    for cls in (ptm.TrackingModule, jtm.TrackingModule):
        tm, lf = _tracker_stub(cls, noisy, 24, first=first)
        out.append((tm._predict_pose(lf, lead), tm.pred_hist_misses))
    (port, port_miss), (ref, ref_miss) = out
    assert port.dtype == ref.dtype == np.float32
    np.testing.assert_allclose(port, ref, rtol=0, atol=1e-6)
    assert port_miss == ref_miss
    assert port_miss == (1 if first == 24 and lead >= 2 else 0)


# ---------------------------------------------------------------------------
# feed order: both Systems driven by one stub tracker
# ---------------------------------------------------------------------------
class _StubTracker:
    """Records the tracker calls of ``feed_sequence``.  Tracking breaks when
    frame ``lose_at`` finishes and is back after ``recover_after`` classic
    frames."""

    def __init__(self, states, log, lose_at, recover_after=2):
        self.S = states
        self.state = states.TRACKING
        self.log = log
        self.lose_at = lose_at
        self.recover_after = recover_after
        self.lost_frames = 0
        self.last_frame = types.SimpleNamespace(frame_id=-1, pose_cw=np.eye(4, dtype=np.float32))
        self.ref_kf = -1

    def track_fused_dispatch(self, img, frame_id, ts, step, mask=None, aux=None):
        self.log.append(("dispatch", frame_id, frame_id - self.last_frame.frame_id))
        return frame_id

    def track_fused_finish(self, h):
        self.log.append(("finish", h))
        pose = np.eye(4, dtype=np.float32)
        if h == self.lose_at:
            self.state = self.S.LOST
            pose = None
        self.last_frame = types.SimpleNamespace(frame_id=h, pose_cw=pose)
        return pose, self.last_frame

    def classic(self, frame_id):
        self.log.append(("classic", frame_id))
        pose = None
        if self.state == self.S.LOST:
            self.lost_frames += 1
            if self.lost_frames > self.recover_after:
                self.state = self.S.TRACKING
                pose = np.eye(4, dtype=np.float32)
        else:
            pose = np.eye(4, dtype=np.float32)
        self.last_frame = types.SimpleNamespace(frame_id=frame_id, pose_cw=pose)
        return pose


def _bare_system(cls, states, lose_at):
    """A System of ``cls`` with only what the pipelined feed touches; the
    classic ladder is the stub tracker's."""
    import threading

    s = cls.__new__(cls)
    log = []
    tr = _StubTracker(states, log, lose_at)
    s.tracker = tr
    s.cfg = types.SimpleNamespace(raw={})
    s.map_lock = threading.RLock()
    s.map_db = types.SimpleNamespace(n_kfs=0)
    s._track_step = object()
    s._tracker_mapper = types.SimpleNamespace(backlog=0)
    s._static_mask = None
    s.device = "cpu"
    s._autosave = None
    s.frame_publisher = types.SimpleNamespace(publish=lambda *a, **k: None)
    s.map_publisher = types.SimpleNamespace(set_current_pose=lambda *a, **k: None)
    s.frame_id = 0
    s._fused_frames = 0
    s.trajectory, s.traj_ref, s.track_times = [], [], []
    s._pace_waits, s._pace_wait_s, s._pace_wait_max = 0, 0.0, 0.0

    def classic(image, ts, mask=None):
        pose = tr.classic(s.frame_id)
        s.frame_id += 1
        s.trajectory.append((ts, pose))
        s.traj_ref.append(None)
        return pose

    s.feed_monocular_frame = classic
    return s, log


@pytest.mark.parametrize("depth", [1, 2, 3])
@pytest.mark.parametrize("lose_at", [5, 11], ids=["early", "late"])
def test_feed_order_matches_jax(depth, lose_at):
    img = np.zeros((4, 4), np.uint8)
    items = [(img, i / 20.0) for i in range(16)]
    runs = []
    for cls, states in ((PortSystem, ptm.TrackerState), (JaxSystem, jtm.TrackerState)):
        s, log = _bare_system(cls, states, lose_at)
        out = [(t, p is not None) for t, p in s.feed_sequence(iter(items), depth=depth)]
        runs.append((log, out, s.frame_id))
    (plog, pout, pfid), (jlog, jout, jfid) = runs
    assert plog == jlog
    assert pout == jout
    assert pfid == jfid == len(items)
    assert [t for t, _ in pout] == [t for _, t in items]
    # the pipeline really ran ahead (lead depth + 1 after the first frames)
    # and the loss sent frames through the classic ladder
    assert max(e[2] for e in plog if e[0] == "dispatch") == depth + 1
    assert any(e[0] == "classic" for e in plog)


@pytest.mark.parametrize("queued", [0, 1, 2, 3])
def test_feed_pacing_against_jax(queued):
    """The feed's backpressure is the reference's: from two keyframes queued
    behind the one being mapped, wait until one is left, the wait bounded
    by twice the median keyframe time (at least 0.5 s)."""
    calls = {}
    for cls, states in ((PortSystem, ptm.TrackerState), (JaxSystem, jtm.TrackerState)):
        s, _ = _bare_system(cls, states, lose_at=-1)
        rec = []
        s._tracker_mapper = types.SimpleNamespace(
            backlog=queued, kf_proc_times=[0.1, 0.2, 0.4],
            wait_for_backlog=lambda rec=rec, **kw: rec.append(kw) or True)
        s._pace_mapper()
        calls[cls] = rec
    assert calls[PortSystem] == calls[JaxSystem]
    assert calls[PortSystem] == ([dict(max_backlog=1, timeout=0.5)] if queued >= 2 else [])
