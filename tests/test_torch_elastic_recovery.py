"""Elastic recovery with the port (counterpart of
tests/test_elastic_recovery.py, at its point): a session maps with autosave
and is abandoned mid-run; a new session loads the last snapshot,
relocalizes on the restored map and goes on mapping, in the first
session's gauge."""
import os

import numpy as np
import pytest
import torch

from openvslam_tpu_torch.config import Config
from openvslam_tpu_torch.module.tracking_module import TrackerState
from openvslam_tpu_torch.system import System
from openvslam_tpu_torch.utils import synthetic


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene_and_poses():
    cfg = Config.from_dict({
        "Camera": {"name": "elastic", "setup": "monocular", "model": "perspective",
                   "fx": 350.0, "fy": 350.0, "cx": 208.0, "cy": 160.0, "cols": 416,
                   "rows": 320, "fps": 20},
        "Feature": {"max_num_keypts": 600, "num_levels": 4, "scale_factor": 1.2},
        "LoopDetector": {"enabled": False}})
    cam = cfg.camera
    scene = synthetic.PlaneSceneRenderer(np.random.default_rng(31), x_range=(-5, 10),
                                         y_range=(-5, 5), plane_z=7.0, rows=cam.rows,
                                         cols=cam.cols)
    poses = np.stack([synthetic.lookat_pose_cw((x, 0, 0), (x, 0, 7))
                      for x in np.linspace(0.0, 5.0, 34)])
    return cfg, scene, poses


def test_crash_resume_continues_mapping(scene_and_poses, tmp_path):
    cfg, scene, poses = scene_and_poses
    cam = cfg.camera
    snap = str(tmp_path / "session.msg")

    # session A: maps with autosave, then is abandoned mid-sequence
    a = System(cfg, vocab_path="default", device="cpu")
    a.startup()
    a.enable_autosave(snap, every_n_keyframes=1)
    for i in range(20):
        a.feed_monocular_frame(scene.render(cam, poses[i]), i / 20.0)
    a.join_autosave(timeout=60)
    assert os.path.exists(snap), "no autosave snapshot written"
    assert len(a.map_db.valid_kf_ids()) >= 3
    assert a.stats()["worker_exceptions"] == 0

    # session B: resumes from the snapshot
    b = System(cfg, vocab_path="default", device="cpu")
    b.load_map_database(snap)
    b.startup()
    kfs_restored = len(b.map_db.valid_kf_ids())
    assert kfs_restored >= 2
    b.tracker.state = TrackerState.LOST
    tracked = sum(b.feed_monocular_frame(scene.render(cam, poses[i]), 100 + i / 20.0)
                  is not None for i in range(14, 34))
    b.shutdown()
    assert tracked >= 14, f"tracked {tracked}/20 after resume"
    assert len(b.map_db.valid_kf_ids()) > kfs_restored, "resume did not extend the map"
    assert b.stats()["worker_exceptions"] == 0

    # the resumed poses agree with session A's over the overlap
    _, pa, ma = a.tracked_poses()
    _, pb, mb = b.tracked_poses()
    centre = lambda T: -T[:3, :3].T @ T[:3, 3]  # noqa: E731
    errs = [np.linalg.norm(centre(pa[i]) - centre(pb[i - 14]))
            for i in range(14, 20) if ma[i] and mb[i - 14]]
    assert errs and float(np.median(errs)) < 0.15, errs
