"""The port's twin of tests/test_city_long.py (slow): the full stereo System
with loop closure drives the rendered street circuit that revisits its
start, at the reference test's size and gates.  Its frames are rendered by
``CityCourseRenderer.render_sequence_torch`` and the System runs on the
``device`` fixture's device: the CUDA card where one is present, else the
CPU (hours there)."""
import numpy as np
import pytest
import torch

from openvslam_tpu_torch.config import Config
from openvslam_tpu_torch.system import System
from openvslam_tpu_torch.utils import evaluate, synthetic

pytestmark = pytest.mark.slow

BASELINE_M = 0.5


@pytest.fixture(scope="module")
def device():
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


@pytest.fixture(scope="module")
def city_run(device):
    rows, cols = 240, 320
    cfg = Config.from_dict({
        "Camera": {"name": "city-stereo", "setup": "stereo", "model": "perspective",
                   "fx": 260.0, "fy": 260.0, "cx": cols / 2, "cy": rows / 2,
                   "cols": cols, "rows": rows, "fps": 10,
                   "focal_x_baseline": 260.0 * BASELINE_M, "depth_threshold": 40.0},
        "Feature": {"max_num_keypts": 500, "num_levels": 3, "scale_factor": 1.2},
        "LoopDetector": {"enabled": True, "min_continuity": 2},
    })
    cam = cfg.camera
    course = synthetic.RoundedRectCourse(straight_x=60, straight_z=60, corner_r=12)
    scene = synthetic.CityCourseRenderer(np.random.default_rng(7), course, street_half_w=4.0,
                                         seg_len=8.0)
    n = 700                                   # ~0.50 m/frame, 1.1 laps
    poses_gt = synthetic.course_trajectory(course, n, laps=1.1)
    shift = np.eye(4)
    shift[0, 3] = -BASELINE_M
    left = scene.render_sequence_torch(cam, poses_gt, ss=2, device=device).cpu().numpy()
    right = scene.render_sequence_torch(cam, np.stack([shift @ T for T in poses_gt]), ss=2,
                                        device=device).cpu().numpy()
    s = System(cfg, vocab_path="default", device=device)
    s.startup()
    tracked = [s.feed_stereo_frame(left[i], right[i], i / 10.0) is not None for i in range(n)]
    s.shutdown()
    return s, poses_gt, np.array(tracked)


def test_city_tracks_throughout(city_run):
    s, poses_gt, tracked = city_run
    assert tracked[5:].mean() > 0.9, tracked.mean()


def test_city_loop_closes(city_run):
    s, *_ = city_run
    assert s.global_optimizer.num_loops_closed >= 1
    db = s.map_db
    assert any(db.loop_edges[int(k)] for k in db.valid_kf_ids())


def test_city_metric_consistency(city_run):
    """SE3-aligned (no scale freedom) keyframe ATE after loop closure over
    the ~350 m driven circuit."""
    s, poses_gt, tracked = city_run
    db = s.map_db
    ids = db.valid_kf_ids()
    ek = np.stack([-db.kf_pose_cw[k][:3, :3].T @ db.kf_pose_cw[k][:3, 3] for k in ids])
    gk = np.stack([-poses_gt[f][:3, :3].T @ poses_gt[f][:3, 3] for f in db.kf_src_frame[ids]])
    ate = evaluate.ate_rmse(ek, gk, align="se3")
    assert ate < 2.0, f"metric KF ATE {ate:.2f} m over the 350 m circuit"


def test_city_no_unexplained_overflow(city_run):
    """No BA observation dropped; local-map cap overflow is allowed but
    counted."""
    s, *_ = city_run
    ov = s.stats()["overflow"]
    assert ov.get("ba_obs", 0) == 0, ov
