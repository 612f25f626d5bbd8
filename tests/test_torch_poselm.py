"""Port parity of the pose-only LM (kernel K3's plain version) against the
JAX package.  Tolerances, as tests/test_pallas_poselm.py holds the JAX
package's own kernel to its analytic reference: T within atol 1e-3 and
inlier agreement >= 0.99 against pose_lm_xla_reference and against
pose_lm_pallas(interpret=True); against the autodiff + LU core of
make_pose_optimizer (another derivation of the same step) |dT| < 1e-3 and
agreement > 0.98.  Covers mono, stereo with mixed mono observations,
masked rows and points behind the camera."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from openvslam_tpu.camera import Perspective as JaxPerspective
from openvslam_tpu.camera.base import camera_to_config as jax_camera_to_config
from openvslam_tpu.ops import se3 as jse3
from openvslam_tpu.ops.pallas.pose_lm_kernel import pose_lm_pallas, pose_lm_xla_reference
from openvslam_tpu.optimize import residuals as JR
from openvslam_tpu.optimize.pose_optimizer import make_pose_optimizer as jax_make_pose_optimizer
from openvslam_tpu_torch import convert, kernels
from openvslam_tpu_torch.ops import pose_lm
from openvslam_tpu_torch.optimize import residuals as R
from openvslam_tpu_torch.optimize.pose_optimizer import make_pose_optimizer
from openvslam_tpu_torch.utils import synthetic


def _jcam():
    return JaxPerspective.create(fx=500, fy=500, cx=320, cy=240, cols=640, rows=480,
                                 focal_x_baseline=50.0)


def _params(stereo):
    return dict(fx=500.0, fy=500.0, cx=320.0, cy=240.0, fxb=50.0,
                chi2_thr=R.CHI2_3D if stereo else R.CHI2_2D)


def _problem(rng, n=200, stereo=False, outliers=40, mask_off=0, behind=0):
    """numpy (T_gt, T0, pts, obs (n,3), sigma2, mask), as test_pallas_poselm builds it."""
    cam = _jcam()
    pts = synthetic.landmark_cloud(rng, n, center=(0, 0, 6), extent=(4, 3, 2))
    T_gt = synthetic.lookat_pose_cw((0.3, -0.2, 0.5), (0, 0, 6))
    pc = (T_gt[:3, :3] @ pts.T).T + T_gt[:3, 3]
    uv, depth, _ = cam.project(jnp.asarray(pc, jnp.float32))
    uv = np.asarray(uv) + rng.standard_normal((n, 2)) * 0.5
    if stereo:
        ur = uv[:, 0] - 50.0 / np.maximum(np.asarray(depth), 1e-6)
        ur[rng.random(n) < 0.3] = -1.0              # mixed mono observations
        obs = np.concatenate([uv, ur[:, None]], 1)
    else:
        obs = np.concatenate([uv, np.full((n, 1), -1.0)], 1)
    if outliers:
        out = rng.choice(n, outliers, replace=False)
        obs[out, :2] += (rng.random((outliers, 2)) - 0.5) * 100 + 20
    mask = np.ones(n, bool)
    if mask_off:
        mask[rng.choice(n, mask_off, replace=False)] = False
    if behind:
        pts[:behind] = -pts[:behind]
    xi = np.array([0.03, -0.02, 0.04, 0.1, -0.08, 0.05], np.float32)
    T0 = np.asarray(jse3.se3_exp(jnp.asarray(xi))) @ T_gt
    sig = (1.2 ** rng.integers(0, 4, n)).astype(np.float32) ** 2
    return (T_gt, T0.astype(np.float32), pts.astype(np.float32), obs.astype(np.float32), sig, mask)


def _port(T0, pts, obs, sig, mask, device="cpu"):
    return [torch.from_numpy(np.ascontiguousarray(x)).to(device) for x in (T0, pts, obs, sig, mask)]


def _check(T_a, inl_a, T_b, inl_b, agree_min=0.99):
    np.testing.assert_allclose(np.asarray(T_a), np.asarray(T_b), rtol=0, atol=1e-3)
    agree = (np.asarray(inl_a) == np.asarray(inl_b)).mean()
    assert agree >= agree_min, agree


@pytest.mark.parametrize("stereo", [False, True])
def test_plain_lm_matches_jax_analytic_and_pallas(rng, stereo):
    T_gt, T0, pts, obs, sig, mask = _problem(rng, n=300, stereo=stereo, mask_off=30)
    kw = _params(stereo)
    before = kernels.launch_counts()
    T_t, inl_t, n_t, c2_t = pose_lm.pose_lm(*_port(T0, pts, obs, sig, mask), **kw)
    assert kernels.launch_counts() == before
    jargs = [jnp.asarray(x) for x in (T0, pts, obs, sig, mask)]
    T_a, inl_a, _, c2_a = pose_lm_xla_reference(*jargs, **kw)
    _check(T_t.numpy(), inl_t.numpy(), T_a, inl_a)
    T_k, inl_k, _, _ = pose_lm_pallas(*jargs, interpret=True, **kw)
    _check(T_t.numpy(), inl_t.numpy(), T_k, inl_k)
    assert int(n_t) == int(inl_t.sum())
    both = inl_t.numpy() & np.asarray(inl_a)
    np.testing.assert_allclose(c2_t.numpy()[both], np.asarray(c2_a)[both], rtol=5e-2, atol=1e-3)
    assert np.linalg.norm(T_t.numpy()[:3, 3] - T_gt[:3, 3]) < 2e-2


def test_plain_lm_masked_and_behind(rng):
    T_gt, T0, pts, obs, sig, mask = _problem(rng, n=128, outliers=0, behind=10)
    mask[20:40] = False
    T_t, inl_t, _, _ = pose_lm.pose_lm(*_port(T0, pts, obs, sig, mask), **_params(False))
    inl = inl_t.numpy()
    assert not inl[20:40].any()
    assert not inl[:10].any()
    assert inl[40:].mean() > 0.8
    T_a, inl_a, _, _ = pose_lm_xla_reference(*[jnp.asarray(x) for x in (T0, pts, obs, sig, mask)],
                                             **_params(False))
    _check(T_t.numpy(), inl, T_a, inl_a)


@pytest.mark.parametrize("stereo", [False, True])
def test_pose_optimizer_matches_jax_autodiff_core(rng, stereo):
    T_gt, T0, pts, obs, sig, mask = _problem(rng, stereo=stereo)
    jcam = _jcam()
    cam = convert.camera_from_config(jax_camera_to_config(jcam))
    obs_in = obs if stereo else obs[:, :2]
    res_j = jax_make_pose_optimizer(jcam, stereo=stereo)(
        *[jnp.asarray(x) for x in (T0, pts, obs_in, sig, mask)])
    res_t = make_pose_optimizer(cam, stereo=stereo)(*_port(T0, pts, obs_in, sig, mask))
    assert np.linalg.norm(res_t.T_cw.numpy() - np.asarray(res_j.T_cw)) < 1e-3
    assert (res_t.inliers.numpy() == np.asarray(res_j.inliers)).mean() > 0.98
    assert JR.CHI2_2D == R.CHI2_2D and JR.CHI2_3D == R.CHI2_3D


def test_two_and_three_column_observations_agree(rng):
    """2-column (u, v) observations take the mono path: the same result as
    3-column observations with u_right = -1 (K3's operand handling; on the
    card test_torch_kernels holds the kernel to the same)."""
    T_gt, T0, pts, obs, sig, mask = _problem(rng, n=150, mask_off=20, behind=5)
    kw = _params(False)
    two = pose_lm.pose_lm(*_port(T0, pts, np.ascontiguousarray(obs[:, :2]), sig, mask), **kw)
    three = pose_lm.pose_lm(*_port(T0, pts, obs, sig, mask), **kw)
    for a, b in zip(two, three):
        assert torch.equal(a, b)
    assert 80 < int(two[2]) < 130            # 20 masked, 5 behind, 40 outliers


def test_kernel_operand_checks():
    """K3's wrapper takes the caller's tensors as they are and refuses what
    the kernel does not read, whatever N (the kernel takes any N)."""
    kw = _params(False)
    for n in (8, 5000, 20000):
        good = [torch.eye(4), torch.zeros(n, 3), torch.zeros(n, 2), torch.ones(n),
                torch.ones(n, dtype=torch.bool)]
        for i, bad in ((2, torch.zeros(n, 2, dtype=torch.float64)), (4, torch.ones(n)),
                       (2, torch.zeros(n, 4)), (1, torch.zeros(3, n).T), (3, torch.ones(n + 1))):
            args = list(good)
            args[i] = bad
            with pytest.raises(ValueError):
                pose_lm.kernel_args(*args, **kw)


def test_residual_helpers_match_jax(rng):
    """The mono edge, Huber weight and left increment against the JAX
    package's (allclose at float32 rounding)."""
    T_gt, T0, pts, obs, sig, mask = _problem(rng, n=64, behind=5)
    jcam = _jcam()
    cam = convert.camera_from_config(jax_camera_to_config(jcam))
    r_t, ok_t = R.make_mono_residual(cam)(torch.from_numpy(T0), torch.from_numpy(pts),
                                          torch.from_numpy(obs[:, :2]))
    jres = JR.make_mono_residual(jcam)
    for i in range(len(pts)):
        r_j, ok_j = jres(jnp.asarray(T0), jnp.asarray(pts[i]), jnp.asarray(obs[i, :2]))
        np.testing.assert_allclose(r_t[i].numpy(), np.asarray(r_j), rtol=0, atol=1e-3)
        assert bool(ok_t[i]) == bool(ok_j)
    c2 = rng.uniform(0, 30, 100).astype(np.float32)
    np.testing.assert_allclose(R.huber_weight(torch.from_numpy(c2), R.CHI2_2D).numpy(),
                               np.asarray(JR.huber_weight(jnp.asarray(c2), JR.CHI2_2D)), rtol=1e-6)
    xi = (rng.standard_normal(6) * 0.1).astype(np.float32)
    np.testing.assert_allclose(R.perturb_pose(torch.from_numpy(xi), torch.from_numpy(T0)).numpy(),
                               np.asarray(JR.perturb_pose(jnp.asarray(xi), jnp.asarray(T0))),
                               rtol=0, atol=1e-5)
