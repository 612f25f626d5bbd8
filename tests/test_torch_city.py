"""Port parity of the city half of ``utils/synthetic.py`` against the JAX
package on the CPU: random poses and Sim(3)s, the rounded-rectangle street
course and its drive, the city renderer (its quads and texture atlas, the
numpy render and the torch render), the sensor photometrics and the orbit
trajectory, each on the same seeded inputs; and a short drive of the
port's stereo System along the start of tests/test_city_long.py's course.

Tolerances: poses, Sim(3)s, the course, the renderer's scene and the
photometrics exactly (the course at atol 1e-12); a render at most
``RENDER_TOL_LEVELS`` gray level apart from the other on at most
``RENDER_TOL_SHARE`` of the pixels (the port's camera computes the bearings
that JAX's computes, in float32, and the torch render forms its ray-quad
dot products as elementwise sums where numpy calls a matrix product)."""
import numpy as np
import pytest
import torch

from openvslam_tpu.camera import Perspective as JaxPerspective
from openvslam_tpu.utils import synthetic as jsyn
from openvslam_tpu_torch.camera import Perspective
from openvslam_tpu_torch.config import Config
from openvslam_tpu_torch.utils import evaluate, synthetic

RENDER_TOL_LEVELS = 1
RENDER_TOL_SHARE = 0.005
# tests/test_city_long.py's course and camera (tools/city_bench.py's default
# configuration at its width)
COURSE = dict(straight_x=60, straight_z=60, corner_r=12)
CITY_FRAMES, CITY_LAPS, BASELINE_M = 700, 1.1, 0.5
# The short drive: the first DRIVE_FRAMES frames of that course (its first
# straight), rendered at ss 1.  The JAX System's reading on the same frames
# (``test_short_drive_jax_reading``, slow): every frame tracked, keyframe
# count 10, ATE(se3) of the tracked frames DRIVE_JAX_ATE_M; the port is held
# to 1.25 times it.
DRIVE_FRAMES = 30
DRIVE_JAX_ATE_M = 0.03963512619584816
DRIVE_ATE_MARGIN = 1.25


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_random_poses_match_jax():
    for seed in range(5):
        a, b = np.random.default_rng(seed), np.random.default_rng(seed)
        for kw in ({}, dict(max_angle=1e-13), dict(max_angle=2.0, max_trans=5.0)):
            np.testing.assert_array_equal(synthetic.random_pose_cw(a, **kw),
                                          jsyn.random_pose_cw(b, **kw))
        R, t, s = synthetic.random_sim3(a, scale_range=(0.8, 1.2))
        Rj, tj, sj = jsyn.random_sim3(b, scale_range=(0.8, 1.2))
        np.testing.assert_array_equal(R, Rj)
        np.testing.assert_array_equal(t, tj)
        assert s == sj
        assert a.random() == b.random()          # the same draws consumed


def test_course_and_drive_match_jax():
    c, cj = synthetic.RoundedRectCourse(**COURSE), jsyn.RoundedRectCourse(**COURSE)
    assert c.length == cj.length
    s = np.concatenate([np.linspace(-10.0, 2.5 * c.length, 997), c.cum])
    np.testing.assert_allclose(c.point(s), cj.point(s), rtol=0, atol=1e-12)
    np.testing.assert_allclose(c.tangent(s), cj.tangent(s), rtol=0, atol=1e-12)
    for kw in ({}, dict(look_ahead=3.0, height=-1.5, start_s=17.0)):
        np.testing.assert_allclose(
            synthetic.course_trajectory(c, 211, laps=CITY_LAPS, **kw),
            jsyn.course_trajectory(cj, 211, laps=CITY_LAPS, **kw), rtol=0, atol=1e-12)


@pytest.fixture(scope="module")
def scenes():
    port = synthetic.CityCourseRenderer(np.random.default_rng(7),
                                        synthetic.RoundedRectCourse(**COURSE),
                                        street_half_w=4.0, seg_len=8.0)
    ref = jsyn.CityCourseRenderer(np.random.default_rng(7), jsyn.RoundedRectCourse(**COURSE),
                                  street_half_w=4.0, seg_len=8.0)
    return port, ref


def test_city_scene_matches_jax(scenes):
    port, ref = scenes
    for name in ("quad_p0", "quad_n", "quad_u", "quad_v", "quad_hu", "quad_hv", "atlas",
                 "tex_h", "tex_w"):
        a, b = getattr(port, name), getattr(ref, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert len(port.textures) == len(ref.textures) > 100
    assert port.res == ref.res and port.max_dist == ref.max_dist


def _small_cameras():
    kw = dict(fx=78.0, fy=78.0, cx=48.0, cy=36.0, cols=96, rows=72)
    return Perspective(**kw), JaxPerspective.create(**kw)


def _render_poses():
    """A straight, the first corner's middle and a frame past the start of
    the second lap."""
    poses = synthetic.course_trajectory(synthetic.RoundedRectCourse(**COURSE), CITY_FRAMES,
                                        laps=CITY_LAPS)
    return poses[[10, 137, 650]]


def _within_tolerance(a, b, tag):
    diff = np.abs(a.astype(np.int32) - b.astype(np.int32))
    share = float((diff > 0).mean())
    print(f"{tag}: {share:.5f} of the pixels differ, by at most {diff.max()} gray levels")
    assert diff.max() <= RENDER_TOL_LEVELS and share <= RENDER_TOL_SHARE, (tag, diff.max(), share)
    assert b.mean() > 20            # the frame sees the street


@pytest.mark.parametrize("ss", [1, 2])
def test_city_render_matches_jax(scenes, ss):
    port, ref = scenes
    cam, jcam = _small_cameras()
    for i, T in enumerate(_render_poses()):
        img = port.render(cam, T, ss=ss)
        assert img.shape == (72, 96) and img.dtype == np.uint8
        _within_tolerance(img, ref.render(jcam, T, ss=ss), f"numpy render, pose {i}, ss {ss}")


@pytest.mark.parametrize("ss", [1, 2])
def test_city_torch_render_matches_numpy(scenes, ss):
    port, _ = scenes
    cam, _ = _small_cameras()
    poses = _render_poses()
    seq = port.render_sequence_torch(cam, poses, ss=ss, device="cpu")
    assert seq.shape == (3, 72, 96) and seq.dtype == torch.uint8 and seq.device.type == "cpu"
    for i, T in enumerate(poses):
        _within_tolerance(seq[i].numpy(), port.render(cam, T, ss=ss),
                          f"torch render, pose {i}, ss {ss}")


@pytest.mark.parametrize("kw", [dict(exposure_drift=0.06, noise_sigma=4.0),
                                dict(motion_blur_px=5),
                                dict(motion_blur_px=4, direction="v"),
                                dict(exposure_drift=0.3, noise_sigma=9.0, motion_blur_px=3)])
def test_photometrics_match_jax(kw):
    img = np.random.default_rng(0).integers(0, 256, (40, 56)).astype(np.uint8)
    port = synthetic.Photometrics(np.random.default_rng(3), **kw)
    ref = jsyn.Photometrics(np.random.default_rng(3), **kw)
    for _ in range(6):
        a, b = port(img), ref(img)
        assert a.dtype == np.uint8
        np.testing.assert_array_equal(a, b)
        assert port.gain == ref.gain


def test_orbit_trajectory_matches_jax():
    args = (9, 1.7, -0.4, (0.5, 0.2, 5.0), np.pi / 5)
    np.testing.assert_array_equal(synthetic.orbit_trajectory(*args),
                                  jsyn.orbit_trajectory(*args))
    a, b = np.random.default_rng(4), np.random.default_rng(4)
    np.testing.assert_array_equal(synthetic.orbit_trajectory(*args, 0.3, a),
                                  jsyn.orbit_trajectory(*args, 0.3, b))
    kw = dict(radius=2.5, height=0.3, target=(0, 0, 6), arc=np.pi / 4, jitter=0.05)
    np.testing.assert_array_equal(
        synthetic.orbit_trajectory(12, rng=np.random.default_rng(5), **kw),
        jsyn.orbit_trajectory(12, rng=np.random.default_rng(5), **kw))
    # no rng: the jitter is not drawn, as in JAX
    np.testing.assert_array_equal(synthetic.orbit_trajectory(5, jitter=0.5),
                                  jsyn.orbit_trajectory(5, jitter=0.5))


def drive_config_dict() -> dict:
    """tests/test_city_long.py's stereo camera, features and loop detector."""
    rows, cols = 240, 320
    return {
        "Camera": {"name": "city-stereo", "setup": "stereo", "model": "perspective",
                   "fx": 260.0, "fy": 260.0, "cx": cols / 2, "cy": rows / 2,
                   "cols": cols, "rows": rows, "fps": 10,
                   "focal_x_baseline": 260.0 * BASELINE_M, "depth_threshold": 40.0},
        "Feature": {"max_num_keypts": 500, "num_levels": 3, "scale_factor": 1.2},
        "LoopDetector": {"enabled": True, "min_continuity": 2},
    }


@pytest.fixture(scope="module")
def drive_frames(scenes):
    """The first DRIVE_FRAMES stereo pairs of the course, rendered by the
    port's numpy renderer at ss 1, and their ground truth."""
    port, _ = scenes
    cam = Config.from_dict(drive_config_dict()).camera
    gt = synthetic.course_trajectory(port.course, CITY_FRAMES, laps=CITY_LAPS)[:DRIVE_FRAMES]
    shift = np.eye(4)
    shift[0, 3] = -BASELINE_M
    pairs = [(port.render(cam, T, ss=1), port.render(cam, shift @ T, ss=1)) for T in gt]
    return pairs, gt


def _drive_reading(System, cfg, pairs, gt, **kw):
    s = System(cfg, vocab_path="default", **kw)
    s.startup()
    poses = [s.feed_stereo_frame(l, r, i / 10.0) for i, (l, r) in enumerate(pairs)]
    s.shutdown()
    tracked = np.array([p is not None for p in poses])
    idx = np.where(tracked)[0]
    ce = np.stack([-poses[i][:3, :3].T @ poses[i][:3, 3] for i in idx])
    cg = np.stack([-gt[i][:3, :3].T @ gt[i][:3, 3] for i in idx])
    return tracked, float(evaluate.ate_rmse(ce, cg, align="se3")), s.map_db.n_kfs


def test_short_drive_tracks_as_jax(drive_frames):
    from openvslam_tpu_torch.system import System

    pairs, gt = drive_frames
    tracked, ate, kfs = _drive_reading(System, Config.from_dict(drive_config_dict()), pairs, gt,
                                       device="cpu")
    print(f"port: tracked {tracked.mean():.3f}, ATE(se3) {ate:.4f} m, {kfs} keyframes; "
          f"JAX {DRIVE_JAX_ATE_M:.4f} m")
    assert tracked[5:].mean() >= 0.9
    assert ate <= DRIVE_ATE_MARGIN * DRIVE_JAX_ATE_M


@pytest.mark.slow
def test_short_drive_jax_reading(drive_frames):
    """The JAX System on the same frames reads DRIVE_JAX_ATE_M."""
    from openvslam_tpu.config import Config as JaxConfig
    from openvslam_tpu.system import System as JaxSystem

    pairs, gt = drive_frames
    tracked, ate, kfs = _drive_reading(JaxSystem, JaxConfig.from_dict(drive_config_dict()),
                                       pairs, gt)
    assert tracked.all() and kfs == 10
    assert ate == pytest.approx(DRIVE_JAX_ATE_M, rel=1e-6)
