"""Port parity: SE(3), the perspective camera and the camera spec against
the JAX package, on random poses and points.  Tolerance: allclose at
atol 1e-5 (float32 rounding of the same formulas)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from openvslam_tpu.camera import Perspective as JaxPerspective
from openvslam_tpu.camera.base import camera_to_config as jax_camera_to_config
from openvslam_tpu.ops import se3 as jse3
from openvslam_tpu_torch import convert
from openvslam_tpu_torch.camera import camera_to_config
from openvslam_tpu_torch.ops import se3

ATOL = 1e-5


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=atol)


def test_se3_ops_match_jax(rng):
    xi = (rng.standard_normal((64, 6)) * [0.8, 0.8, 0.8, 2, 2, 2]).astype(np.float32)
    xi[:4, :3] *= 1e-5                                    # Taylor branch
    pts = rng.standard_normal((64, 3)).astype(np.float32) * 3
    T_j = jse3.se3_exp(jnp.asarray(xi))
    T_t = se3.se3_exp(torch.from_numpy(xi))
    _close(T_t, T_j)
    _close(se3.hat(torch.from_numpy(xi[:, :3])), jse3.hat(jnp.asarray(xi[:, :3])))
    _close(se3.so3_exp(torch.from_numpy(xi[:, :3])), jse3.so3_exp(jnp.asarray(xi[:, :3])))
    _close(se3.inverse(T_t), jse3.inverse(T_j))
    _close(se3.compose(T_t[:32], T_t[32:]), jse3.compose(T_j[:32], T_j[32:]))
    T0_t, T0_j = T_t[0], T_j[0]
    _close(se3.transform(T0_t, torch.from_numpy(pts)), jse3.transform(T0_j, jnp.asarray(pts)))
    _close(se3.transform(T0_t, torch.from_numpy(pts[0])), jse3.transform(T0_j, jnp.asarray(pts[0])))


@pytest.mark.parametrize("dist", [False, True])
def test_perspective_camera_matches_jax(rng, dist):
    k = dict(k1=-0.12, k2=0.03, p1=1e-3, p2=-5e-4, k3=-0.01) if dist else {}
    jcam = JaxPerspective.create(fx=500.0, fy=510.0, cx=320.0, cy=240.0, cols=640, rows=480, **k)
    spec = jax_camera_to_config(jcam)
    cam = convert.camera_from_config(spec)
    assert camera_to_config(cam) == spec
    kp = rng.uniform([0, 0], [640, 480], (256, 2)).astype(np.float32)
    pts = np.concatenate([rng.uniform(-3, 3, (256, 2)), rng.uniform(-1, 8, (256, 1))], 1
                         ).astype(np.float32)
    _close(cam.undistort_keypoints(torch.from_numpy(kp)),
           jcam.undistort_keypoints(jnp.asarray(kp)))
    _close(cam.keypoints_to_bearings(torch.from_numpy(kp)),
           jcam.keypoints_to_bearings(jnp.asarray(kp)))
    uv_t, z_t, v_t = cam.project(torch.from_numpy(pts))
    uv_j, z_j, v_j = jcam.project(jnp.asarray(pts))
    ok = np.asarray(v_j)
    _close(uv_t.numpy()[ok], np.asarray(uv_j)[ok])
    _close(z_t, z_j)
    np.testing.assert_array_equal(v_t.numpy(), ok)


def test_frontend_from_feature_config():
    """The reference's Feature: settings give the JAX package's budgets."""
    from openvslam_tpu.config import Config
    from openvslam_tpu.models.frontend import OrbFrontend as JaxFrontend

    feature = {"max_num_keypts": 1000, "num_levels": 8, "scale_factor": 1.2,
               "ini_fast_threshold": 20, "min_fast_threshold": 7}
    fe = convert.frontend_from_config(480, 640, feature, device="cpu")
    cfg = Config.from_dict({"Camera": {"fx": 520.0, "fy": 520.0, "cx": 320.0, "cy": 240.0,
                                       "cols": 640, "rows": 480}, "Feature": feature}).feature
    jfe = JaxFrontend(480, 640, max_keypts=cfg.max_num_keypts, num_levels=cfg.num_levels,
                      scale_factor=cfg.scale_factor, ini_fast_thr=cfg.ini_fast_threshold,
                      min_fast_thr=cfg.min_fast_threshold)
    assert fe.budgets == jfe.budgets and fe.capacity == jfe.capacity == 1032
    assert (fe.ini_fast_thr, fe.min_fast_thr, fe.pattern) == (20.0, 7.0, "learned")
