"""The port's stereo System on ``device="cpu"``, held to the JAX package's
own gates: tests/test_stereo_rgbd_e2e.py's textured wall (416x320, 600
keypoints, 4 levels, a 0.2 m baseline, 25 frames over 6 m) fed frame by
frame (tracked share above 0.9, SE3-aligned ATE below 0.08 m: a metric map
has no scale to align); the stereo rectifier against JAX's map builder and
remap; chip_smoke's KITTI and TUM points against the config files; and,
marked ``slow`` like its reference, tests/test_stereo_loop.py's lap
(chip_smoke phase 7c holds it on the card).  The pipelined stereo feed is
in tests/test_torch_stereo_pipeline.py.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import chip_smoke
from openvslam_tpu.utils import stereo_rectifier as jrect
from openvslam_tpu_torch.config import Config
from openvslam_tpu_torch.system import System
from openvslam_tpu_torch.utils import evaluate, stereo_rectifier, synthetic

ROWS, COLS, BASELINE = 320, 416, 0.2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite's worker processes share the cores
    (see tests/test_torch_system.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_config(setup, fxb=350.0 * BASELINE, depthmap_factor=1.0):
    return Config.from_dict({
        "Camera": {"name": "synthetic-stereo", "setup": setup, "model": "perspective",
                   "fx": 350.0, "fy": 350.0, "cx": COLS / 2, "cy": ROWS / 2,
                   "cols": COLS, "rows": ROWS, "fps": 10, "focal_x_baseline": fxb,
                   "depth_threshold": 30.0, "depthmap_factor": depthmap_factor},
        "Feature": {"max_num_keypts": 600, "num_levels": 4, "scale_factor": 1.2},
        "LoopDetector": {"enabled": False}})


def wall(cam, seed=7, n=25):
    """The reference test's scene and fronto-parallel path (``n`` frames
    over 6 m), with each frame's depth map: the wall's z-distance."""
    scene = synthetic.PlaneSceneRenderer(np.random.default_rng(seed), x_range=(-4, 12),
                                         y_range=(-5, 5), plane_z=7.0, rows=cam.rows,
                                         cols=cam.cols)
    poses = np.stack([synthetic.lookat_pose_cw((x, 0, 0), (x, 0, 7))
                      for x in np.linspace(0.0, 6.0, n)])
    depth = [np.full((cam.rows, cam.cols), 7.0 - (-T[:3, :3].T @ T[:3, 3])[2], np.float32)
             for T in poses]
    return scene, poses, depth


def se3_ate(poses, gt):
    idx = [i for i, p in enumerate(poses) if p is not None]
    est = np.stack([-poses[i][:3, :3].T @ poses[i][:3, 3] for i in idx])
    ref = np.stack([-gt[i][:3, :3].T @ gt[i][:3, 3] for i in idx])
    return evaluate.ate_rmse(est, ref, align="se3")


@pytest.fixture(scope="module")
def stereo_wall():
    cfg = make_config("stereo")
    cam = cfg.camera
    scene, poses, _ = wall(cam)
    shift = np.eye(4)
    shift[0, 3] = -BASELINE
    return cfg, poses, [(scene.render(cam, T), scene.render(cam, shift @ T)) for T in poses]


def test_stereo_e2e(stereo_wall):
    cfg, poses, pairs = stereo_wall
    s = System(cfg, device="cpu")
    s.startup()
    out = [s.feed_stereo_frame(left, right, i / 10.0) for i, (left, right) in enumerate(pairs)]
    s.shutdown()
    assert out[0] is not None                 # the depth bootstrap: a pose at frame 0
    tracked = sum(p is not None for p in out)
    assert tracked > 0.9 * len(poses), tracked
    ate = se3_ate(out, poses)
    assert ate < 0.08, f"stereo SE3 ATE {ate:.3f} m"
    st = s.stats()
    assert st["num_keyframes"] >= 2 and s.mapper.lms_created_seed > 0
    assert s.global_optimizer.stereo and s.mapper.stereo and s.tracker.stereo


def test_stereo_rectifier_matches_jax(rng):
    """The rectify maps of a calibration with distortion and a rectifying
    rotation (the map builder is a copy: equal to 1e-4 px), and the remap
    of a random image through them within 1e-4 gray levels of JAX's; the
    rectifier built from the reference YAML schema."""
    K = np.array([[458.654, 0, 367.215], [0, 457.296, 248.375], [0, 0, 1]])
    D = [-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05, 0.0]
    ang = 0.01
    R = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0], [-np.sin(ang), 0, np.cos(ang)]])
    P = np.array([[435.2, 0, 367.4], [0, 435.2, 252.2], [0, 0, 1]])
    rows, cols = 120, 160
    m = stereo_rectifier.build_rectify_map(K, D, R, P, rows, cols)
    mj = jrect.build_rectify_map(K, D, R, P, rows, cols)
    np.testing.assert_allclose(m, mj, rtol=0, atol=1e-4)
    img = rng.integers(0, 256, (rows, cols)).astype(np.uint8)
    out = stereo_rectifier.remap_bilinear(torch.from_numpy(img), torch.from_numpy(m)).numpy()
    ref = np.asarray(jrect.remap_bilinear(jnp.asarray(img), jnp.asarray(mj)))
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4)
    assert (out > 0).mean() > 0.5
    cfg = Config.from_dict({
        "Camera": {"name": "euroc", "setup": "stereo", "model": "perspective", "fx": 435.2,
                   "fy": 435.2, "cx": 367.4, "cy": 252.2, "cols": cols, "rows": rows,
                   "focal_x_baseline": 47.9},
        "StereoRectifier": {"K_left": K.ravel().tolist(), "D_left": D,
                            "R_left": R.ravel().tolist(), "K_right": K.ravel().tolist(),
                            "D_right": D}})
    rect = stereo_rectifier.StereoRectifier(cfg.camera, cfg.raw, device="cpu")
    jr = jrect.StereoRectifier(cfg.camera, cfg.raw)
    right = rng.integers(0, 256, (rows, cols)).astype(np.uint8)
    for a, b in zip(rect.rectify(img, right), jr.rectify(img, right)):
        assert a.dtype == np.uint8
        assert (a.astype(int) - b).max() <= 1 and (a == b).mean() > 0.99


@pytest.mark.slow
def test_stereo_loop_closes_with_its_scale_locked():
    """tests/test_stereo_loop.py's lap through the port at chip_smoke phase
    7c's definition (the same point): a pose within 5 frames, tracked above
    0.9, a loop closed with its Sim3 scale locked at 1, and the keyframe
    ATE(se3) within 1.25 x the JAX System's reading there."""
    cfg = Config.from_dict(chip_smoke.stereo_loop_config_dict())
    cam = cfg.camera
    scene, gt, shift = chip_smoke.stereo_loop_scene(synthetic, cam)
    s = System(cfg, device="cpu")
    go = s.global_optimizer
    scales, correct = [], go.correct_loop

    def spy(kf, cand, g, *a, **kw):
        scales.append(float(g[2]))
        return correct(kf, cand, g, *a, **kw)

    go.correct_loop = spy
    s.startup()
    tracked = np.array([s.feed_stereo_frame(scene.render(cam, gt[i]),
                                            scene.render(cam, shift @ gt[i]), i / 20.0)
                        is not None for i in range(len(gt))])
    s.shutdown()
    first = int(np.argmax(tracked))
    assert first < 5 and tracked[first:].mean() > 0.9
    assert go.num_loops_closed >= 1 and scales and all(abs(x - 1.0) <= 1e-6 for x in scales)
    ate = chip_smoke.keyframe_ate(s.map_db, gt, evaluate, align="se3")
    assert ate <= chip_smoke.LOOP_ATE_MARGIN * chip_smoke.STEREO_LOOP_REF_KF_ATE_M, ate


def test_chip_smoke_points_are_the_config_files():
    """chip_smoke phases 7 and 7b run the repository's KITTI 00 stereo and
    TUM fr1 RGB-D configurations at their full widths: their Camera and
    Feature blocks are the config files' own."""
    yaml = pytest.importorskip("yaml")
    for name, point in (("kitti_stereo_00.yaml", chip_smoke.kitti_config_dict()),
                        ("tum_rgbd_rgbd_fr1.yaml", chip_smoke.tum_config_dict())):
        with open(f"{chip_smoke.os.path.dirname(chip_smoke.__file__)}/configs/{name}") as f:
            ref = yaml.safe_load(f)
        for block in ("Camera", "Feature"):
            assert point[block] == ref[block], (name, block)
