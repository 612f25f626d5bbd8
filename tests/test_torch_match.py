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


@pytest.mark.parametrize("seed", range(6))
def test_bin_boxes_hold_every_gated_pair(seed):
    """K2's search is exact only if the cells a row walks hold every keypoint
    that the exact gate passes.  Random rows and keypoints inside and far
    outside the image, radii 0.1-800 px (log-uniform), three cell sides:
    every pair of projection_gate (float32, as the plain version gates)
    lies in the row's box of row_boxes, with the keypoint's cell from
    keypoint_cells, the same float32 arithmetic as csrc/match.cu."""
    rng = np.random.default_rng(100 + seed)
    L, K = 400, 500
    uv = rng.uniform([-120, -120], [760, 600], (L, 2)).astype(np.float32)
    xy = rng.uniform([-300, -300], [940, 780], (K, 2)).astype(np.float32)
    xy[: K // 5] = uv[: K // 5] + rng.normal(0, 30, (K // 5, 2))   # near a row
    xy[K // 5: K // 4] *= 40.0                                      # far outside
    radius = np.exp(rng.uniform(np.log(0.1), np.log(800.0), L)).astype(np.float32)
    radius[::7] = -radius[::7]                                      # r^2 is what gates
    uv_t, xy_t, r_t = (torch.from_numpy(a) for a in (uv, xy, radius))
    gate = M.projection_gate(uv_t, torch.ones(L, dtype=torch.bool), xy_t, r_t)
    assert int(gate.sum()) > 2000
    for cell in (8, 16, 64):
        grid = M.bin_grid(640, 480, cell)
        assert grid.gw * grid.gh <= M.MAX_CELLS and grid.gw * cell >= 640
        cx, cy = M.keypoint_cells(xy_t, grid)
        x0, x1, y0, y1 = M.row_boxes(uv_t, r_t, grid)
        inside = ((cx[None, :] >= x0[:, None]) & (cx[None, :] <= x1[:, None])
                  & (cy[None, :] >= y0[:, None]) & (cy[None, :] <= y1[:, None]))
        assert bool((inside | ~gate).all()), int((gate & ~inside).sum())
        # the boxes are tight: a small radius visits a few cells, not the grid
        small = np.abs(radius) < 10
        width = (x1 - x0 + 1) * (y1 - y0 + 1)
        assert int(width[torch.from_numpy(small)].max()) <= (2 * 10 // cell + 4) ** 2


def test_bin_grid_geometry():
    assert M.bin_grid(640, 480) == M.BinGrid(16, 40, 30)
    g = M.bin_grid(1e5, 1e5)                     # the side doubles up to MAX_CELLS
    assert g.gw * g.gh <= M.MAX_CELLS and g.cell & (g.cell - 1) == 0
    assert M.bin_grid(0, 0) == M.BinGrid(16, 1, 1)
    big = torch.tensor([[float("nan"), float("inf")], [-1e30, 5.0], [639.9, 479.9]])
    cx, cy = M.keypoint_cells(big, M.bin_grid(640, 480))
    assert cx.tolist() == [0, 0, 39] and cy.tolist() == [29, 0, 29]
