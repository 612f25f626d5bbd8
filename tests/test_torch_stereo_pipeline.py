"""The port's pipelined stereo feed on ``device="cpu"``: the wall of
tests/test_stereo_rgbd_e2e.py through ``feed_sequence(kind="stereo",
depth=3)`` held to that test's gates, and the steps dispatched ahead of an
unknown motion model right after the depth bootstrap, which the port sends
through the classic ladder (a port-side departure from the JAX System,
ROADMAP Queue 3).
"""
import numpy as np
import pytest
import torch

import chip_smoke
from openvslam_tpu_torch.config import Config
from openvslam_tpu_torch.system import System
from openvslam_tpu_torch.utils import synthetic
from test_torch_stereo_system import se3_ate, stereo_wall  # noqa: F401 (fixture)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite's worker processes share the cores
    (see tests/test_torch_system.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_stereo_pipelined_depth3(stereo_wall):
    """The stereo feed at depth 3 on the same pairs: three fused steps in
    flight, each predicting 4 frames past the last finished one."""
    cfg, poses, pairs = stereo_wall
    s = System(cfg, device="cpu")
    s.startup()
    assert s.feed_kind() == "stereo"
    out = list(s.feed_sequence(((left, right, i / 10.0) for i, (left, right) in enumerate(pairs)),
                               kind="stereo", depth=3))
    s.shutdown()
    np.testing.assert_allclose([t for t, _ in out], np.arange(len(pairs)) / 10.0)
    tracked = sum(p is not None for _, p in out)
    assert tracked > 0.9 * len(poses), tracked
    assert s._fused_frames > 0.6 * len(poses)
    ate = se3_ate([p for _, p in out], poses)
    assert ate < 0.08, f"stereo pipelined SE3 ATE {ate:.3f} m"


def test_blind_pipelined_steps_take_the_classic_ladder():
    """chip_smoke phase 7's pairs (KITTI 00's camera, 0.1 m a frame along
    the wall, here the first 6 of a 60-frame wall) through the depth-3 feed
    right after the depth bootstrap.  Frames 2-4 are dispatched before
    frame 1 is finished, with no motion model behind their prediction (the
    velocity is the identity), so frame 3's prediction lags 0.3 m (31 px)
    and its stage 1 finds only a handful of inliers.  The JAX System
    accepts such a fused result more than half a metre off, and the
    keyframe it inserts leaves a shifted copy of the wall that later frames
    track (tools/depth_points_jax.py 7, at phase 7's point; ROADMAP Queue
    3).  The port replays blind steps through the classic ladder, which
    predicts from the frames finished by then."""
    cfg = Config.from_dict(chip_smoke.kitti_config_dict())
    cam = cfg.camera
    scene, gt = chip_smoke.wall_scene(synthetic, cam, 0.1, n=60)
    shift = np.eye(4)
    shift[0, 3] = -cam.focal_x_baseline / cam.fx
    pairs = [(scene.render(cam, T), scene.render(cam, shift @ T)) for T in gt[:6]]
    s = System(cfg, device="cpu")
    ladder, laddered = s.tracker._track_frame, []

    def spy(frame):
        laddered.append(frame.frame_id)
        return ladder(frame)

    s.tracker._track_frame = spy
    s.startup()
    out = [p for _, p in s.feed_sequence(((a, b, i / 10.0) for i, (a, b) in enumerate(pairs)),
                                         kind="stereo", depth=3)]
    s.shutdown()
    assert laddered[:3] == [2, 3, 4]
    # the map's origin is frame 0's camera
    c0 = [gt[0][:3, :3] @ (-T[:3, :3].T @ T[:3, 3]) + gt[0][:3, 3] for T in gt[:6]]
    err = [float(np.linalg.norm(-p[:3, :3].T @ p[:3, 3] - c)) for p, c in zip(out, c0)]
    assert max(err) < 0.05, err
