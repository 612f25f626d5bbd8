"""The port's RGB-D System on ``device="cpu"``, held to the JAX package's
own gates: test_rgbd_e2e (tests/test_stereo_rgbd_e2e.py: the textured wall
at 416x320, 25 frames fed frame by frame) and test_rgbd_pipelined
(tests/test_pipeline_feed.py: 30 frames through ``feed_sequence(kind="rgbd")``,
most of them fused): tracked share above 0.9, SE3-aligned ATE below 0.08 m.
Depth maps arrive in stored units: the System divides by ``depthmap_factor``
(TUM stores metres x 5000 as uint16).
"""
import numpy as np
import pytest
import torch

from openvslam_tpu_torch.system import System
from test_torch_stereo_system import make_config, se3_ate, wall


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite's worker processes share the cores
    (see tests/test_torch_system.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_rgbd_e2e():
    cfg = make_config("rgbd")
    cam = cfg.camera
    scene, poses, depth = wall(cam)
    s = System(cfg, device="cpu")
    s.startup()
    out = [s.feed_RGBD_frame(scene.render(cam, T), depth[i], i / 10.0)
           for i, T in enumerate(poses)]
    s.shutdown()
    assert out[0] is not None
    tracked = sum(p is not None for p in out)
    assert tracked > 0.9 * len(poses), tracked
    ate = se3_ate(out, poses)
    assert ate < 0.08, f"rgbd SE3 ATE {ate:.3f} m"


def test_rgbd_pipelined():
    """The reference's own point: a 0.1 m virtual baseline, seed 5, 30
    frames; here the depth maps in TUM's stored form (uint16, metres x
    5000) with ``depthmap_factor`` 5000."""
    cfg = make_config("rgbd", fxb=350.0 * 0.1, depthmap_factor=5000.0)
    cam = cfg.camera
    scene, poses, depth = wall(cam, seed=5, n=30)

    def items():
        for i, T in enumerate(poses):
            yield scene.render(cam, T), np.round(depth[i] * 5000.0).astype(np.uint16), i / 10.0

    s = System(cfg, device="cpu")
    s.startup()
    assert s.feed_kind() == "rgbd"
    out = list(s.feed_sequence(items(), kind="rgbd"))
    s.shutdown()
    tracked = sum(p is not None for _, p in out)
    assert tracked > 0.9 * len(poses), tracked
    assert s._fused_frames > 0.6 * len(poses)
    ate = se3_ate([p for _, p in out], poses)
    assert ate < 0.08, f"rgbd pipelined SE3 ATE {ate:.3f} m"


def test_rgbd_right_u_is_the_undistorted_keypoints():
    """With TUM fr1's distortion (configs/tum_rgbd_rgbd_fr1.yaml, here at a
    quarter of its width) the virtual right u of an RGB-D keypoint is its
    undistorted u minus focal_x_baseline / depth, on the fused step and on
    the classic path alike: the stereo residual compares it with the
    projection of the landmark, which is undistorted.  The JAX package
    subtracts from the raw u, which biases every third residual by the
    distortion at the keypoint (chip_smoke phase 7b; ROADMAP Queue 3)."""
    import chip_smoke
    from openvslam_tpu_torch import convert
    from openvslam_tpu_torch.config import Config
    from openvslam_tpu_torch.models.frontend import OrbFrontend
    from openvslam_tpu_torch.models.track_step import TrackStep
    from openvslam_tpu_torch.utils import synthetic

    raw = chip_smoke.tum_config_dict()
    c = dict(raw["Camera"], cols=160, rows=120)
    for k in ("fx", "fy", "cx", "cy"):
        c[k] = raw["Camera"][k] / 4
    cfg = Config.from_dict({"Camera": c, "Feature": {"max_num_keypts": 300, "num_levels": 2}})
    cam = cfg.camera
    scene, gt = chip_smoke.wall_scene(synthetic, cam, 0.05, n=2)
    img = scene.render(cam, gt[0])
    depth_u16 = np.full((cam.rows, cam.cols), 35000, np.uint16)       # 7 m
    z = 35000 / cfg.depthmap_factor
    fe = OrbFrontend(cam.rows, cam.cols, max_keypts=300, num_levels=2, device="cpu")
    ts = TrackStep(cam, fe, lm_capacity=16, mode="rgbd", device="cpu")
    P = ts.prev_capacity
    last = convert.last_frame_from_numpy(np.zeros((P, 3), np.float32), np.zeros((P, 8), np.uint32),
                                         np.zeros(P, bool), np.zeros(P, np.int32), "cpu")
    local = convert.local_map_from_numpy(np.zeros((16, 3), np.float32), np.zeros((16, 256), np.int8),
                                         np.zeros(16, bool), np.zeros(16, np.float32),
                                         np.full(16, -1, np.int64), "cpu")
    r = ts.step(torch.from_numpy(img), None, torch.from_numpy(gt[0].astype(np.float32)), last,
                local, torch.from_numpy(depth_u16.astype(np.float32) / cfg.depthmap_factor))
    v = r.kp_valid.numpy()
    assert v.sum() > 50
    want = r.kp_und.numpy()[:, 0] - cam.focal_x_baseline / z
    np.testing.assert_allclose(r.kp_x_right.numpy()[v], want[v], rtol=0, atol=1e-4)
    assert np.abs(r.kp_und.numpy()[v, 0] - r.kp_xy.numpy()[v, 0]).max() > 1.0
    s = System(cfg, device="cpu")
    s.startup()
    assert s.feed_RGBD_frame(img, depth_u16, 0.0) is not None     # the depth bootstrap
    s.shutdown()
    db = s.map_db
    kv = db.kf_kpt_valid[0]
    np.testing.assert_allclose(db.kf_x_right[0][kv],
                               db.kf_xy_undist[0][kv, 0] - cam.focal_x_baseline / z,
                               rtol=0, atol=1e-4)
