"""Camera parity: the port's fisheye and equirectangular models against the
JAX package's on the CPU, on the same numpy inputs.

Held: ``undistort_keypoints``, ``keypoints_to_bearings``,
``bearings_to_keypoints``, ``project`` (uv, depth, valid) and
``camera_to_config``, including the fisheye rim (rays 80 to 100 degrees
off the axis, where bearings past 90 degrees are flipped and the pinhole
``project`` has no meaning) and the equirectangular seam and poles.
Tolerance 1e-5 relative, masks exact.  Relative to each quantity's
scale: 1 for unit bearings, the larger of the value and the image size
for pixels (near the equirectangular poles arcsin, and near 90 degrees
the fisheye's pinhole pixel, fx tan(theta), turn one float32 rounding of
their argument into many of the result: there the undistorted pixels are
held through their unit direction (x, y, 1) / |.|, which is well
conditioned, and as pixels within 85 degrees of the axis).  The
equirectangular seam wrap of the residual (``torch.remainder``) equals
``jnp.mod`` bit for bit, ties at +-cols/2 included; the factory, the map
database's camera registry and ``convert.camera_from_config`` round-trip
both models; the room renderer's torch version matches its numpy one.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from openvslam_tpu.camera import base as jbase
from openvslam_tpu_torch import convert
from openvslam_tpu_torch.camera import (Equirectangular, Fisheye, ModelType, SetupType,
                                        camera_to_config, make_camera_from_config)
from openvslam_tpu_torch.data import MapDatabase
from openvslam_tpu_torch.optimize import residuals as R
from openvslam_tpu_torch.utils import synthetic

TUM_VI = {"name": "TUM VI fisheye cam0", "setup": "monocular", "model": "fisheye",
          "fx": 190.978, "fy": 190.973, "cx": 254.932, "cy": 256.897, "k1": 0.00348239,
          "k2": 0.000715035, "k3": -0.00205324, "k4": 0.000202937, "cols": 512, "rows": 512,
          "fps": 20.0}
SYNTH_FISHEYE = {"name": "fisheye-synth", "setup": "stereo", "model": "fisheye",
                 "fx": 280.0, "fy": 280.0, "cx": 208.0, "cy": 160.0, "k1": -0.02, "k2": 0.006,
                 "k3": -0.002, "k4": 0.0005, "cols": 416, "rows": 320, "fps": 20,
                 "focal_x_baseline": 28.0}
THETA_S = {"name": "RICOH THETA S 960", "setup": "monocular", "model": "equirectangular",
           "cols": 1920, "rows": 960, "fps": 30.0}
SPECS = {"tum_vi": TUM_VI, "synth_fisheye": SYNTH_FISHEYE, "theta_s": THETA_S}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """With the suite's worker processes sharing the cores, intra-op
    threads only contend, so this module runs torch on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(params=sorted(SPECS))
def cams(request):
    spec = SPECS[request.param]
    return jbase.make_camera_from_config(spec), make_camera_from_config(spec), spec


def _close(got, want, scale):
    """max |got - want| / max(|want|, scale) <= 1e-5."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    s = np.maximum(np.abs(want), scale)
    err = np.abs(got - want) / s
    assert err.max() <= 1e-5, (err.max(), np.unravel_index(err.argmax(), err.shape))


def _pixels(rng, cam, spec):
    """Keypoints over the image and past it; for a fisheye also a ring of
    pixels whose rays lie 80 to 100 degrees off the axis."""
    n = 2000
    kp = rng.uniform([-20, -20], [cam.cols + 20, cam.rows + 20], (n, 2))
    if spec["model"] == "fisheye":
        th = np.deg2rad(rng.uniform(80.0, 100.0, 500))
        th = np.concatenate([th, np.deg2rad([80.0, 89.9, 90.0, 90.1, 95.0, 100.0])])
        k = [spec[f"k{i}"] for i in range(1, 5)]
        th2 = th * th
        thd = th * (1 + th2 * (k[0] + th2 * (k[1] + th2 * (k[2] + th2 * k[3]))))
        a = rng.uniform(0, 2 * np.pi, th.shape)
        ring = np.stack([spec["cx"] + spec["fx"] * thd * np.cos(a),
                         spec["cy"] + spec["fy"] * thd * np.sin(a)], -1)
        kp = np.concatenate([kp, ring])
    else:
        # the seam (u = 0 and cols) and the poles (v = 0 and rows)
        kp = np.concatenate([kp, [[0.0, 480.0], [cam.cols, 480.0], [960.0, 0.0],
                                  [960.0, cam.rows], [0.0, 0.0], [1919.999, 959.999]]])
    return kp.astype(np.float32)


def _points(rng, spec):
    """Camera-frame points in every direction, behind the camera and on the
    optical axis; for an equirectangular camera also on the seam (x = 0,
    z < 0) and at the poles (x = z = 0)."""
    X = rng.normal(0, 4, (3000, 3))
    X = np.concatenate([X, [[0, 0, 3.0], [0, 0, -3.0], [0.1, 0.2, 1e-12]]])
    if spec["model"] == "equirectangular":
        seam = np.stack([np.zeros(50), rng.normal(0, 2, 50), -rng.uniform(0.5, 5, 50)], -1)
        seam[::2, 0] = rng.choice([-1e-6, 1e-6], 25)
        X = np.concatenate([X, seam, [[0, 2.0, 0], [0, -2.0, 0], [1e-7, 3.0, -1e-7]]])
    return X.astype(np.float32)


def test_keypoint_maps_match_jax(cams, rng):
    jcam, cam, spec = cams
    size = max(cam.cols, cam.rows)
    kp = _pixels(rng, cam, spec)
    kp_t = torch.from_numpy(kp)
    brg_j = np.asarray(jcam.keypoints_to_bearings(jnp.asarray(kp)))
    brg = cam.keypoints_to_bearings(kp_t).numpy()
    _close(brg, brg_j, 1.0)
    und_j = np.asarray(jcam.undistort_keypoints(jnp.asarray(kp)))
    und = cam.undistort_keypoints(kp_t).numpy()
    _close(cam.bearings_to_keypoints(torch.from_numpy(brg_j.copy())).numpy(),
           np.asarray(jcam.bearings_to_keypoints(jnp.asarray(brg_j))), size)
    if spec["model"] == "equirectangular":
        np.testing.assert_array_equal(und, und_j)
        np.testing.assert_array_equal(und, kp)
        return

    def direction(uv):
        v = np.stack([(uv[:, 0] - spec["cx"]) / spec["fx"], (uv[:, 1] - spec["cy"]) / spec["fy"],
                      np.ones(len(uv))], -1)
        return v / np.linalg.norm(v, axis=-1, keepdims=True)

    _close(direction(und), direction(und_j), 1.0)
    inner = np.abs(brg_j[:, 2]) >= np.cos(np.deg2rad(85.0))
    assert inner.sum() > 1000 and (~inner).sum() > 100
    _close(und[inner], und_j[inner], size)
    if spec["model"] == "fisheye":
        # past 90 degrees the ray is flipped: the bearing keeps the pixel's
        # direction and points backwards
        far = np.linalg.norm((kp - [spec["cx"], spec["cy"]]) / [spec["fx"], spec["fy"]], axis=-1)
        behind = brg_j[:, 2] < 0
        assert behind.sum() > 100 and (brg[:, 2] < 0).tolist() == behind.tolist()
        assert far[behind].min() > 1.5


def test_project_matches_jax(cams, rng):
    jcam, cam, spec = cams
    size = max(cam.cols, cam.rows)
    X = _points(rng, spec)
    uv_j, d_j, v_j = (np.asarray(a) for a in jcam.project(jnp.asarray(X)))
    uv, d, v = (a.numpy() for a in cam.project(torch.from_numpy(X)))
    np.testing.assert_array_equal(v, v_j)
    _close(d, d_j, 1.0)
    fin = np.isfinite(uv_j).all(-1)
    assert np.array_equal(np.isfinite(uv).all(-1), fin)
    _close(uv[fin], uv_j[fin], size)
    assert v.sum() > 100
    if spec["model"] == "equirectangular":
        # the full sphere: every point off the origin projects into the
        # image but those on the seam's far side (longitude +pi, u = cols)
        # and at the lower pole (v = rows)
        off = np.linalg.norm(X, axis=-1) > 1e-6
        np.testing.assert_array_equal(~v[off], (uv_j[off, 0] >= cam.cols)
                                      | (uv_j[off, 1] >= cam.rows))
        assert (~v[off]).sum() > 10
        return
    assert (~v).sum() > 100
    if spec["model"] == "fisheye":
        uv_r, z_r, v_r = (a.numpy() for a in cam.project_fisheye(torch.from_numpy(X)))
        uvj_r, zj_r, vj_r = (np.asarray(a) for a in jcam.project_fisheye(jnp.asarray(X)))
        np.testing.assert_array_equal(v_r, vj_r)
        _close(uv_r, uvj_r, size)
        # validity is the raw image's: no point behind the camera is valid
        assert not v[X[:, 2] <= 0].any()


def test_camera_to_config_and_registry_roundtrip(cams):
    jcam, cam, spec = cams
    # the same keys; the JAX camera holds its intrinsics as float32
    got, want = camera_to_config(cam), jbase.camera_to_config(jcam)
    assert got.keys() == want.keys()
    assert {k: np.float32(v) if isinstance(v, float) else v for k, v in got.items()} == want
    carried = convert.camera_from_config(want)
    assert carried == make_camera_from_config(want) and camera_to_config(carried) == want
    db = MapDatabase(kpt_capacity=64, max_kfs=2, max_lms=2)
    name = db.register_camera(spec["name"], camera_to_config(cam))
    assert db.get_camera(name) == cam
    if spec["model"] == "equirectangular":
        assert "fx" not in camera_to_config(cam) and isinstance(cam, Equirectangular)
    else:
        assert camera_to_config(cam)["k4"] == spec["k4"] and isinstance(cam, Fisheye)


def test_factory_models_and_setups():
    assert {m.value for m in ModelType} == {"perspective", "fisheye", "equirectangular"}
    for model in ("omnidirectional", "Fisheye"):
        spec = dict(TUM_VI, model=model)
        with pytest.raises(ValueError, match=model):
            jbase.make_camera_from_config(spec)
        with pytest.raises(ValueError, match=model):
            make_camera_from_config(spec)
    # an equirectangular camera is monocular whatever the config says
    eq = make_camera_from_config(dict(THETA_S, setup="stereo", focal_x_baseline=40.0))
    assert eq.setup == SetupType.MONOCULAR and eq.focal_x_baseline == 0.0
    assert camera_to_config(eq) == jbase.camera_to_config(
        jbase.make_camera_from_config(dict(THETA_S, setup="stereo")))
    fe = make_camera_from_config(SYNTH_FISHEYE)
    assert fe.setup == SetupType.STEREO and fe.focal_x_baseline == 28.0
    uv = torch.tensor([[100.0, 50.0]])
    depth = torch.tensor([2.0])
    assert float(fe.stereo_right_u(uv, depth)) == pytest.approx(100.0 - 14.0)
    assert float(eq.stereo_right_u(uv, depth)) == -1.0


def test_seam_wrap_matches_jnp_mod(rng):
    cols = 1920
    half = cols / 2
    r = np.concatenate([[half, -half, 0.0, cols, -cols, half - 1e-3, -half + 1e-3, 1.5 * cols,
                         -1.5 * cols], rng.uniform(-2 * cols, 2 * cols, 5000)]).astype(np.float32)
    want = np.asarray(jnp.mod(jnp.asarray(r) + half, cols) - half)
    got = R.wrap_seam(torch.from_numpy(r), cols).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0] == got[1] == -half
    # per-observation image widths (the multi-camera edge)
    c = rng.choice([640.0, 1920.0], r.shape).astype(np.float32)
    want = np.asarray(jnp.mod(jnp.asarray(r) + jnp.asarray(c) * 0.5, jnp.asarray(c))
                      - jnp.asarray(c) * 0.5)
    np.testing.assert_array_equal(R.wrap_seam(torch.from_numpy(r), torch.from_numpy(c)).numpy(),
                                  want)


@pytest.mark.parametrize("name", ["tum_vi", "theta_s"])
def test_room_render_torch_matches_numpy(name):
    """The room renderer's torch version (which chip_smoke runs on the card
    for phases 8 and 8b) against its numpy version at a quarter of the
    phases' sizes: gray levels within 1 on >= 99.9 % of the pixels."""
    spec = dict(SPECS[name])
    for k in ("cols", "rows", "fx", "fy", "cx", "cy"):
        if k in spec:
            spec[k] = spec[k] / 4 if k in ("fx", "fy", "cx", "cy") else spec[k] // 4
    cam = make_camera_from_config(spec)
    scene = synthetic.RoomSceneRenderer(np.random.default_rng(7), half=10.0, rows=cam.rows,
                                        cols=cam.cols, n_walls=8)
    gt = synthetic.lap_trajectory(200, radius=6.0, laps=200 / 180)
    for i in (0, 119):
        want = scene.render(cam, gt[i]).astype(np.int64)
        got = scene.render_torch(cam, gt[i], "cpu")
        assert got.dtype == torch.uint8 and tuple(got.shape) == (cam.rows, cam.cols)
        diff = np.abs(got.numpy().astype(np.int64) - want)
        assert (diff <= 1).mean() >= 0.999 and (want > 0).mean() > 0.3
