"""The port's async mapping (``System(async_mapping=True)``): tracking goes on
while the mapping worker processes keyframes on its own thread, held to the
gates of tests/test_async_mapping.py on the same plane scene and path: more
than 85 % of the frames tracked, ATE(sim3) below 0.12 m, at least 3
keyframes, the worker drained at shutdown; and no worker raised.
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


def _config(rows=320, cols=416):
    return Config.from_dict({
        "Camera": {"name": "synthetic", "setup": "monocular", "model": "perspective",
                   "fx": 350.0, "fy": 350.0, "cx": cols / 2, "cy": rows / 2,
                   "cols": cols, "rows": rows, "fps": 20},
        "Feature": {"max_num_keypts": 600, "num_levels": 4, "scale_factor": 1.2},
        "LoopDetector": {"enabled": False}})


def test_async_mapping_tracks_and_converges():
    cfg = _config()
    cam = cfg.camera
    n = 28
    scene = synthetic.PlaneSceneRenderer(np.random.default_rng(7), x_range=(-5, 12),
                                         y_range=(-5, 5), plane_z=7.0, rows=cam.rows,
                                         cols=cam.cols)
    poses = np.stack([synthetic.lookat_pose_cw((x, 0, 0), (x, 0, 7))
                      for x in np.linspace(0.0, 6.0, n)])
    s = System(cfg, async_mapping=True, device="cpu")
    s.startup()
    tracked = sum(s.feed_monocular_frame(scene.render(cam, poses[i]), i / 20.0) is not None
                  for i in range(n))
    s.shutdown()
    _, est_poses, mask = s.tracked_poses()
    idx = np.where(mask)[0]
    est = np.stack([-est_poses[i][:3, :3].T @ est_poses[i][:3, 3] for i in idx])
    gt = np.stack([-poses[i][:3, :3].T @ poses[i][:3, 3] for i in idx])
    ate = evaluate.ate_rmse(est, gt, align="sim3")
    assert tracked > 0.85 * n, tracked
    assert ate < 0.12, ate
    assert s.map_db.n_kfs >= 3
    # the worker drained at shutdown, ran local BA, and raised nothing
    assert s._tracker_mapper.idle
    st = s.stats()
    assert st["local_ba_runs"] >= 1
    assert st["worker_exceptions"] == 0, st["worker_first_exception"]
    assert not s.global_optimizer._loop_thread and not s.loop_BA_is_running()
