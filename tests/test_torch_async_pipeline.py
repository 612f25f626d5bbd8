"""The port's pipelined feed (``System.feed_sequence``) at depth 1 against its
per-frame feed, held to the gates of tests/test_pipeline_feed.py on the same
40-frame orbit (416x320, 600 keypoints, 4 levels): every frame yielded in
order, most frames on the fused path and tracked, tracking and ATE(sim3) in
the per-frame feed's class, ``System.trajectory`` mirroring the yielded
stream.  Depth 2 and the loss mid-flight are in
tests/test_torch_async_pipeline_depth.py.
"""
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


def make_config(rows=320, cols=416, n_feats=600):
    return Config.from_dict({
        "Camera": {"name": "synthetic", "setup": "monocular", "model": "perspective",
                   "fx": 350.0, "fy": 350.0, "cx": cols / 2, "cy": rows / 2,
                   "cols": cols, "rows": rows, "fps": 20},
        "Feature": {"max_num_keypts": n_feats, "num_levels": 4, "scale_factor": 1.2},
        "LoopDetector": {"enabled": False}})


def render_sequence(cfg, n_frames=40, seed=11):
    cam = cfg.camera
    scene = synthetic.PatchSceneRenderer(np.random.default_rng(seed), n_points=700,
                                         center=(0, 0, 6), extent=(6, 4.5, 2.5),
                                         rows=cam.rows, cols=cam.cols)
    poses_gt = synthetic.orbit_trajectory(n_frames, radius=2.5, target=(0, 0, 6),
                                          arc=np.pi / 4)
    return [scene.render(cam, poses_gt[i]) for i in range(n_frames)], poses_gt


def sim3_ate(sys_, poses_gt):
    _, poses, mask = sys_.tracked_poses()
    idx = np.where(mask)[0]
    est = np.stack([-poses[i][:3, :3].T @ poses[i][:3, 3] for i in idx])
    gt = np.stack([-poses_gt[i][:3, :3].T @ poses_gt[i][:3, 3] for i in idx])
    return evaluate.ate_rmse(est, gt, align="sim3")


@pytest.fixture(scope="module")
def runs():
    cfg = make_config()
    images, poses_gt = render_sequence(cfg)
    sys_ref = System(cfg, device="cpu")
    sys_ref.startup()
    for i, img in enumerate(images):
        sys_ref.feed_monocular_frame(img, i / 20.0)
    sys_ref.shutdown()

    sys_pipe = System(cfg, device="cpu")
    sys_pipe.startup()
    out = list(sys_pipe.feed_sequence(((img, i / 20.0) for i, img in enumerate(images)),
                                      kind="monocular"))
    sys_pipe.shutdown()
    return sys_ref, sys_pipe, out, poses_gt, len(images)


def test_yields_every_frame_in_order(runs):
    _, _, out, _, n = runs
    assert len(out) == n
    ts = [t for t, _ in out]
    assert ts == sorted(ts)
    np.testing.assert_allclose(ts, np.arange(n) / 20.0)


def test_pipelined_uses_fused_path(runs):
    _, sys_pipe, out, _, n = runs
    assert sys_pipe._fused_frames > 0.7 * n, sys_pipe.stats()
    tracked = sum(p is not None for _, p in out)
    assert tracked > 0.85 * n, f"tracked {tracked}/{n}"


def test_quality_matches_per_frame_api(runs):
    sys_ref, sys_pipe, out, poses_gt, n = runs
    tracked_ref = sum(p is not None for _, p in sys_ref.trajectory)
    tracked_pipe = sum(p is not None for _, p in out)
    assert tracked_pipe >= tracked_ref - 3, (tracked_pipe, tracked_ref)
    ate_ref = sim3_ate(sys_ref, poses_gt)
    ate_pipe = sim3_ate(sys_pipe, poses_gt)
    # same accuracy class: centimetres on a ~2 m trajectory
    assert ate_pipe < max(2.0 * ate_ref, 0.08), (ate_pipe, ate_ref)


def test_trajectory_state_consistent(runs):
    _, sys_pipe, out, _, n = runs
    assert len(sys_pipe.trajectory) == n
    assert len(sys_pipe.track_times) == n
    for (t_y, p_y), (t_s, p_s) in zip(out, sys_pipe.trajectory):
        assert t_y == t_s
        assert (p_y is None) == (p_s is None)
        if p_y is not None:
            np.testing.assert_allclose(p_y, p_s)
