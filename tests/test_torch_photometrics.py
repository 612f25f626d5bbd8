"""The port's twin of tests/test_photometrics.py (slow): the mono System
under photometric degradation (exposure drift with sensor noise, then
motion blur), at the reference test's size and gates, on the ``device``
fixture's device: the CUDA card where one is present, else the CPU."""
import numpy as np
import pytest
import torch

from openvslam_tpu_torch.config import Config
from openvslam_tpu_torch.system import System
from openvslam_tpu_torch.utils import evaluate, synthetic

pytestmark = pytest.mark.slow


@pytest.fixture(scope="module")
def device():
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def _run(device, photo_kwargs, n_frames=40):
    cfg = Config.from_dict({
        "Camera": {"name": "synthetic", "setup": "monocular", "model": "perspective",
                   "fx": 350.0, "fy": 350.0, "cx": 208.0, "cy": 160.0,
                   "cols": 416, "rows": 320, "fps": 20},
        "Feature": {"max_num_keypts": 600, "num_levels": 4, "scale_factor": 1.2},
        "LoopDetector": {"enabled": False},
    })
    cam = cfg.camera
    scene = synthetic.PatchSceneRenderer(np.random.default_rng(11), n_points=700,
                                         center=(0, 0, 6), extent=(6, 4.5, 2.5),
                                         rows=320, cols=416)
    poses_gt = synthetic.orbit_trajectory(n_frames, radius=2.5, target=(0, 0, 6),
                                          arc=np.pi / 4)
    photo = synthetic.Photometrics(np.random.default_rng(3), **photo_kwargs)
    s = System(cfg, device=device)
    s.startup()
    tracked = []
    for i in range(n_frames):
        img = photo(scene.render(cam, poses_gt[i]))
        tracked.append(s.feed_monocular_frame(img, i / 20.0) is not None)
    s.shutdown()
    tracked = np.array(tracked)
    ts, poses, mask = s.tracked_poses()
    est = [-poses[i][:3, :3].T @ poses[i][:3, 3] for i in np.where(mask)[0]]
    gt = [-poses_gt[i][:3, :3].T @ poses_gt[i][:3, 3] for i in np.where(mask)[0]]
    ate = (float(evaluate.ate_rmse(np.stack(est), np.stack(gt), align="sim3"))
           if mask.sum() > 5 else float("inf"))
    return tracked, ate


def test_exposure_drift_and_noise(device):
    """A 6 %/frame gain walk and sigma-4 sensor noise: ORB's
    intensity-compare descriptors keep tracking."""
    tracked, ate = _run(device, {"exposure_drift": 0.06, "noise_sigma": 4.0})
    first = int(np.argmax(tracked))
    assert first < 15, f"initialized too late: {first}"
    assert tracked[first:].mean() > 0.8, tracked
    assert ate < 0.15, f"ATE {ate:.3f} m under exposure+noise"


def test_motion_blur(device):
    """A 5-pixel horizontal smear: the pyramid's coarser levels keep
    tracking alive."""
    tracked, ate = _run(device, {"motion_blur_px": 5})
    first = int(np.argmax(tracked))
    assert first < 15, f"initialized too late: {first}"
    assert tracked[first:].mean() > 0.8, tracked
    assert ate < 0.15, f"ATE {ate:.3f} m under motion blur"
