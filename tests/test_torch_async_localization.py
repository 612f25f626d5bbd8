"""Localization mode in both packages on the same frames: after
``disable_mapping_module`` the keyframe count stays frozen while frames
still track, and ``enable_mapping_module`` resumes keyframe insertion.
Both Systems run the same 30 rendered frames of a plane scene (320x240,
400 keypoints, 3 levels; mapping off for frames 14-21).
"""
import numpy as np
import pytest
import torch

from openvslam_tpu.config import Config as JaxConfig
from openvslam_tpu.system import System as JaxSystem
from openvslam_tpu_torch.config import Config
from openvslam_tpu_torch.system import System
from openvslam_tpu_torch.utils import synthetic

ROWS, COLS, N = 240, 320, 30
OFF, ON = 14, 22          # mapping disabled before frame OFF, enabled before ON


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite's worker processes share the cores
    (see tests/test_torch_system.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config_dict():
    return {"Camera": {"name": "synthetic", "setup": "monocular", "model": "perspective",
                       "fx": 270.0, "fy": 270.0, "cx": COLS / 2, "cy": ROWS / 2,
                       "cols": COLS, "rows": ROWS, "fps": 20},
            "Feature": {"max_num_keypts": 400, "num_levels": 3, "scale_factor": 1.2},
            "LoopDetector": {"enabled": False}}


def _frames():
    cam = Config.from_dict(_config_dict()).camera
    scene = synthetic.PlaneSceneRenderer(np.random.default_rng(7), x_range=(-5, 12),
                                         y_range=(-5, 5), plane_z=7.0, rows=ROWS, cols=COLS)
    return [scene.render(cam, synthetic.lookat_pose_cw((x, 0, 0), (x, 0, 7)))
            for x in np.linspace(0.0, 6.0, N)]


def _run(system, images):
    """(tracked per frame, keyframes inserted before each frame)."""
    system.startup()
    tracked, kfs = [], []
    for i, img in enumerate(images):
        if i == OFF:
            system.disable_mapping_module()
        if i == ON:
            system.enable_mapping_module()
        kfs.append(system.map_db.n_kfs)
        tracked.append(system.feed_monocular_frame(img, i / 20.0) is not None)
    system.shutdown()
    kfs.append(system.map_db.n_kfs)
    return np.array(tracked), np.array(kfs)


def test_localization_mode_freezes_the_map_in_both_packages():
    images = _frames()
    port = _run(System(Config.from_dict(_config_dict()), device="cpu"), images)
    ref = _run(JaxSystem(JaxConfig.from_dict(_config_dict())), images)
    for name, (tracked, kfs) in (("port", port), ("jax", ref)):
        assert kfs[OFF] >= 3, (name, kfs)
        # frozen: no keyframe inserted while mapping is off ...
        assert (kfs[OFF:ON + 1] == kfs[OFF]).all(), (name, kfs)
        # ... while the frames still track
        assert tracked[OFF:ON].all(), (name, tracked)
        # and insertion resumes once it is back on
        assert kfs[-1] > kfs[ON], (name, kfs)
        assert tracked[ON:].all(), (name, tracked)
