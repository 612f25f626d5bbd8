"""Port parity of the projection matcher (kernel K2's plain version) against
the JAX package: ``idx`` and ``dist`` exactly equal, ties included, against
the XLA composition (projection_scale_match(use_pallas=False)) and against
projection_match_pallas(interpret=True), for both ratio settings, both
cross-check settings and both distance thresholds, and with everything
gated out.  Mirrors tests/test_pallas_match.py."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from openvslam_tpu.ops import match as JM
from openvslam_tpu.ops.pallas.match_kernel import projection_match_pallas
from openvslam_tpu_torch import kernels
from openvslam_tpu_torch.ops import match as M
from openvslam_tpu_torch.ops.orb import pack_bits

FLAGS = [(None, True), (0.9, True), (0.9, False), (None, False)]


def _random_problem(rng, L, K, cols=640, rows=480):
    a_desc = rng.integers(0, 2, (L, 256)).astype(np.int8)
    b_desc = rng.integers(0, 2, (K, 256)).astype(np.int8)
    for i in range(0, min(L, K), 3):                 # near-duplicates and ties
        b_desc[i % K] = a_desc[i]
    uv = rng.uniform(0, [cols, rows], (L, 2)).astype(np.float32)
    b_xy = rng.uniform(0, [cols, rows], (K, 2)).astype(np.float32)
    b_xy[: K // 2] = uv[: K // 2] + rng.normal(0, 5, (K // 2, 2))
    vis = rng.random(L) > 0.1
    b_val = rng.random(K) > 0.1
    radius = rng.uniform(4, 30, L).astype(np.float32)
    pred = rng.integers(-1, 8, L).astype(np.int32)
    b_lvl = rng.integers(0, 8, K).astype(np.int32)
    return a_desc, b_desc, uv, vis, radius, pred, b_xy, b_lvl, b_val


def _port_args(prob):
    a_desc, b_desc, uv, vis, radius, pred, b_xy, b_lvl, b_val = prob
    return [pack_bits(torch.from_numpy(a_desc)), pack_bits(torch.from_numpy(b_desc))] + [
        torch.from_numpy(np.ascontiguousarray(x)) for x in (uv, vis, radius, pred, b_xy, b_lvl, b_val)]


def _jax_xla(prob, **kw):
    return JM.projection_scale_match(*[jnp.asarray(x) for x in prob], use_pallas=False, **kw)


def test_hamming_matrix_matches_jax(rng):
    a = rng.integers(0, 2, (40, 256)).astype(np.int8)
    b = rng.integers(0, 2, (30, 256)).astype(np.int8)
    np.testing.assert_array_equal(M.hamming_matrix(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
                                  np.asarray(JM.hamming_matrix(jnp.asarray(a), jnp.asarray(b))))


@pytest.mark.parametrize("L,K", [(512, 1024), (300, 257), (1024, 512)])
@pytest.mark.parametrize("ratio,cross", FLAGS)
def test_match_equals_jax_xla(rng, L, K, ratio, cross):
    prob = _random_problem(rng, L, K)
    launches = kernels.launch_counts()
    for max_dist in (M.HAMMING_DIST_THR_HIGH, M.HAMMING_DIST_THR_LOW):
        idx_j, dist_j = _jax_xla(prob, max_dist=max_dist, ratio=ratio, cross_check=cross)
        idx_t, dist_t = M.projection_scale_match(*_port_args(prob), max_dist=max_dist,
                                                 ratio=ratio, cross_check=cross)
        np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
        np.testing.assert_array_equal(dist_t.numpy(), np.asarray(dist_j))
        assert (idx_t.numpy() >= 0).sum() > 0
    assert kernels.launch_counts() == launches       # CPU tensors never launch


@pytest.mark.parametrize("ratio,cross", FLAGS)
def test_match_equals_pallas_interpret(rng, ratio, cross):
    prob = _random_problem(rng, 300, 257)
    idx_k, dist_k = projection_match_pallas(*[jnp.asarray(x) for x in prob],
                                            ratio=ratio, cross_check=cross, interpret=True)
    idx_t, dist_t = M.projection_scale_match(*_port_args(prob), ratio=ratio, cross_check=cross)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_k))
    np.testing.assert_array_equal(dist_t.numpy(), np.asarray(dist_k))


def test_match_all_gated_out(rng):
    prob = list(_random_problem(rng, 256, 256))
    prob[3] = np.zeros(256, bool)                   # nothing visible
    idx_t, dist_t = M.projection_scale_match(*_port_args(prob))
    assert (idx_t.numpy() == -1).all() and (dist_t.numpy() == M.LARGE).all()
    idx_j, _ = _jax_xla(prob)
    assert (np.asarray(idx_j) == -1).all()

