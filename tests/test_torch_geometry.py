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


def _exp_jacobian_first_order(xi: np.ndarray) -> np.ndarray:
    """(4, 4, 6) derivative of the SE(3) exp at a small twist, from the
    hat basis G_k: d R / d w_k = G_k + (G_k W + W G_k) / 2, d t / d w_k =
    G_k u / 2 + (G_k W + W G_k) u / 6, d t / d u = I + W / 2 + W^2 / 6, with
    W = hat(w); the terms left out are O(|xi|^2)."""
    G = [np.asarray(se3.hat(torch.eye(3, dtype=torch.float64)[k])) for k in range(3)]
    w, u = xi[:3], xi[3:]
    W = sum(w[k] * G[k] for k in range(3))
    J = np.zeros((4, 4, 6))
    for k in range(3):
        J[:3, :3, k] = G[k] + (G[k] @ W + W @ G[k]) / 2
        J[:3, 3, k] = G[k] @ u / 2 + (G[k] @ W + W @ G[k]) @ u / 6
    J[:3, 3, 3:] = np.eye(3) + W / 2 + W @ W / 6
    return J


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("at", [0.0, 1e-5])
def test_se3_exp_autodiff_is_finite_at_small_angles(dtype, at):
    """jacrev and jacfwd of the exp at and near 0 (the small-angle branch):
    finite, in the argument's dtype, and equal to the hat-basis derivative
    within 1e-6."""
    from torch.func import jacfwd, jacrev

    xi = torch.full((6,), at, dtype=dtype)
    ref = _exp_jacobian_first_order(np.full(6, at))
    for jac in (jacrev, jacfwd):
        J = jac(se3.se3_exp)(xi)
        assert J.dtype == dtype and bool(torch.isfinite(J).all())
        np.testing.assert_allclose(J.double().numpy(), ref, rtol=0, atol=1e-6)


def _se3_exp_before_the_guard(xi: torch.Tensor) -> torch.Tensor:
    """The exp as it was written before its small-angle branch was made
    safe to differentiate: the large-angle quotients divided by theta^2
    everywhere."""
    def coeffs(w):
        theta2 = torch.sum(w * w, -1)
        theta = torch.sqrt(torch.clamp(theta2, min=1e-16))
        small = theta2 < 1e-8
        a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
        b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
        c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                        (theta - torch.sin(theta)) / (theta2 * theta))
        return a, b, c

    w, u = xi[..., :3], xi[..., 3:]
    a, b, c = coeffs(w)
    W = se3.hat(w)
    eye = torch.eye(3, dtype=W.dtype).expand(W.shape)
    R = eye + a[..., None, None] * W + b[..., None, None] * (W @ W)
    V = eye + b[..., None, None] * W + c[..., None, None] * (W @ W)
    return se3.from_Rt(R, (V @ u[..., None])[..., 0])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_se3_exp_forward_unchanged_by_the_guard(dtype):
    """On a grid of rotation angles that spans the small-angle threshold
    (theta = 1e-4) the exp's values equal the unguarded formula's bit for
    bit, batched and one twist at a time."""
    rng = np.random.default_rng(3)
    mags = np.concatenate([np.geomspace(1e-9, 1e-1, 300), np.linspace(0.95e-4, 1.05e-4, 201),
                           [0.0, 1e-4, 0.5, 3.0]])
    d = rng.standard_normal((len(mags), 6))
    d[:, :3] *= (mags / np.linalg.norm(d[:, :3], axis=1))[:, None]
    xi = torch.tensor(d, dtype=dtype)
    assert torch.equal(se3.se3_exp(xi), _se3_exp_before_the_guard(xi))
    for x in xi[::50]:
        assert torch.equal(se3.se3_exp(x), _se3_exp_before_the_guard(x))
