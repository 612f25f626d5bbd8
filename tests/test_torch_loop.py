"""Loop-closure parity: the port's Sim3 transform optimizer, Sim3 pose graph,
global BA, loop detector and loop correction against the JAX package on
the CPU, on the same numpy inputs and on a JAX System's map carried across
by ``convert``.

Tolerances:
* ``ops/sim3`` within 1e-5, in the generic regime and near zero rotation
  and scale; ``fit_sim3_horn`` within 1e-5 on full and minimal sets and
  ``score_sim3`` masks identical; the Horn RANSAC fed JAX's draws: the same
  inlier mask and score, the model within 1e-5;
* the transform optimizer on tests/test_posegraph.py's refinement problem:
  R, t, s within 1e-4, inliers identical;
* the pose graph on tests/test_posegraph.py's loop and fixed-scale
  problems: R, t, s within 1e-4; its per-edge forward-mode Jacobians
  within 1e-5 of JAX's ``jacfwd``;
* the global BA on tests/test_ba.py's problem (as the local BA is held):
  inliers identical, cost within 1e-4, reprojections within 0.05 px;
* on tests/test_loop_e2e.py's wall map: ``detect`` returns the same
  candidates keyframe by keyframe; ``validate_snapshot`` fed the JAX
  package's draws the same matches and inlier count with R and t within
  1e-4, s within 2e-3 and the mutual-reprojection cost within 1e-4 (the
  pair's s is nearly free: ROADMAP Queue 3); ``correct_loop`` from the same
  Sim3 then keyframe poses within 1e-3 of JAX's;
* the slice as a whole (``slow``): the port's System on
  tests/test_organic_loop.py's lap, held to that test's gates, with the JAX
  System's keyframe ATE on the same frames printed beside its own.
"""
import copy

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from openvslam_tpu.camera import Perspective as JaxPerspective
from openvslam_tpu.config import Config as JaxConfig
from openvslam_tpu.module.global_optimization_module import GlobalOptimizationModule as JaxGO
from openvslam_tpu.module.loop_detector import LoopDetector as JaxLoopDetector
from openvslam_tpu.ops import ransac as jransac
from openvslam_tpu.ops import sim3 as jsim3
from openvslam_tpu.ops import solvers as JS
from openvslam_tpu.optimize.ba import make_global_ba as jax_global_ba
from openvslam_tpu.optimize.pose_graph import PoseGraphProblem as JaxPGProblem
from openvslam_tpu.optimize.pose_graph import make_pose_graph_optimizer as jax_pose_graph
from openvslam_tpu.optimize.sim3_transform import make_sim3_transform_optimizer as jax_sim3_opt
from openvslam_tpu.system import System as JaxSystem
from openvslam_tpu.utils import synthetic as jsyn
from openvslam_tpu_torch import convert
from openvslam_tpu_torch.camera import Perspective
from openvslam_tpu_torch.config import Config
from openvslam_tpu_torch.data.bow import default_vocabulary
from openvslam_tpu_torch.module.global_optimization_module import GlobalOptimizationModule
from openvslam_tpu_torch.module.loop_detector import LoopDetector
from openvslam_tpu_torch.ops import ransac, sim3, solvers
from openvslam_tpu_torch.optimize import ba as BA
from openvslam_tpu_torch.optimize import pose_graph as PG
from openvslam_tpu_torch.optimize.sim3_transform import make_sim3_transform_optimizer
from openvslam_tpu_torch.system import System
from openvslam_tpu_torch.utils import evaluate, synthetic

from test_ba import _build_problem

_t = torch.from_numpy
ROWS, COLS = 320, 416


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_cam(jcam):
    return Perspective(fx=float(jcam.fx), fy=float(jcam.fy), cx=float(jcam.cx),
                       cy=float(jcam.cy), cols=int(jcam.cols), rows=int(jcam.rows))


def _g(R, t, s):
    return jnp.asarray(R, jnp.float32), jnp.asarray(t, jnp.float32), jnp.float32(s)


# ---------------------------------------------------------------- Sim3 and Horn

_REGIMES = {"generic": (0.6, 0.3), "small_rotation": (1e-6, 0.3),
            "small_scale": (0.6, 1e-6), "both_small": (1e-6, 1e-6)}


@pytest.mark.parametrize("regime", sorted(_REGIMES))
def test_sim3_ops_match_jax(rng, regime):
    """identity, from_se3/to_se3, compose, inverse, transform, exp and log
    within 1e-5 of JAX's, in each branch of ``_W_coeffs``' small-angle and
    small-scale series (|omega| and |sigma| of 1e-6 are below its 1e-4
    switch)."""
    w_sc, s_sc = _REGIMES[regime]
    n = 64
    xi = [np.concatenate([rng.standard_normal((n, 3)) * w_sc, rng.standard_normal((n, 3)),
                          rng.standard_normal((n, 1)) * s_sc], -1).astype(np.float32) for _ in range(2)]
    close = lambda a, b: np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-5)  # noqa: E731
    port = lambda g: tuple(_t(np.array(x)) for x in g)  # noqa: E731
    ga, gb = (jsim3.exp(jnp.asarray(x)) for x in xi)
    for a, b in zip(sim3.exp(_t(xi[0])), ga):
        close(a, b)
    for a, b in zip(sim3.compose(port(ga), port(gb)), jsim3.compose(ga, gb)):
        close(a, b)
    for a, b in zip(sim3.inverse(port(ga)), jsim3.inverse(ga)):
        close(a, b)
    close(sim3.log(port(ga)), jsim3.log(ga))
    pts = rng.standard_normal((n, 10, 3)).astype(np.float32)
    close(sim3.transform(port(ga), _t(pts)), jsim3.transform(ga, jnp.asarray(pts)))
    T = np.asarray(jsim3.to_se3(*ga))
    close(sim3.to_se3(*port(ga)), T)
    for a, b in zip(sim3.from_se3(_t(T)), jsim3.from_se3(jnp.asarray(T))):
        close(a, b)
    for a, b in zip(sim3.identity((3,)), jsim3.identity((3,))):
        close(a, b)


def _horn_problem(rng, n=64, n_out=16):
    """tests/test_solvers.py::test_sim3_horn's transform, with noise and
    outliers added so the RANSAC has something to reject."""
    R, t, s = synthetic.random_sim3(rng)
    p1 = rng.standard_normal((n, 3))
    p2 = (s * (R @ p1.T)).T + t + rng.standard_normal((n, 3)) * 0.005
    p2[:n_out] += rng.standard_normal((n_out, 3))
    return p1.astype(np.float32), p2.astype(np.float32)


def test_sim3_horn_fits_and_scores_match_jax(rng):
    """fit_sim3_horn on the whole set and on 128 minimal triples (both
    scale modes) within 1e-5 of JAX's; score_sim3 on JAX's models gives
    identical inlier masks."""
    p1, p2 = _horn_problem(rng)
    idx = np.stack([rng.choice(len(p1), 3, replace=False) for _ in range(128)])
    for fix_scale in (False, True):
        ref = JS.fit_sim3_horn(jnp.asarray(p1), jnp.asarray(p2), fix_scale=fix_scale)
        out = solvers.fit_sim3_horn(_t(p1), _t(p2), fix_scale=fix_scale)
        for a, b in zip(out, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=1e-5)
        ref = jax.vmap(lambda i: JS.fit_sim3_horn(jnp.asarray(p1)[i], jnp.asarray(p2)[i],
                                                  fix_scale=fix_scale))(jnp.asarray(idx))
        out = solvers.fit_sim3_horn(_t(p1)[_t(idx)], _t(p2)[_t(idx)], fix_scale=fix_scale)
        for a, b in zip(out, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=1e-5)
        mask = np.ones(len(p1), bool)
        sj, okj = jax.vmap(lambda g: JS.score_sim3(g, jnp.asarray(p1), jnp.asarray(p2),
                                                   jnp.asarray(mask), 0.01))(ref)
        sp, okp = solvers.score_sim3(tuple(_t(np.array(x)) for x in ref), _t(p1), _t(p2),
                                     _t(mask), 0.01)
        np.testing.assert_array_equal(okp.numpy(), np.asarray(okj))
        np.testing.assert_array_equal(sp.numpy(), np.asarray(sj))


def test_sim3_ransac_with_jax_draws_matches_jax(rng):
    """The 3-point Horn RANSAC fed JAX's 128 draws: the same inlier mask
    and score, the model within 1e-5."""
    p1, p2 = _horn_problem(rng)
    mask = jnp.ones(len(p1), bool)
    key = jax.random.PRNGKey(4)
    gj, sj, inl_j = jransac.run_ransac(
        key, lambda i: JS.fit_sim3_horn(jnp.asarray(p1)[i], jnp.asarray(p2)[i]),
        lambda g: JS.score_sim3(g, jnp.asarray(p1), jnp.asarray(p2), mask, 0.01), mask, 128, 3)
    samples = _t(np.asarray(jransac.sample_minimal_sets(key, mask, 128, 3)))
    g, s, inl = ransac.ransac_from_samples(
        samples, lambda i: solvers.fit_sim3_horn(_t(p1)[i], _t(p2)[i]),
        lambda g: solvers.score_sim3(g, _t(p1), _t(p2), torch.ones(len(p1), dtype=torch.bool), 0.01))
    np.testing.assert_array_equal(inl.numpy(), np.asarray(inl_j))
    assert float(s) == float(sj) == len(p1) - 16
    for a, b in zip(g, gj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------- optimizers

def test_sim3_transform_optimizer_matches_jax(rng):
    """tests/test_posegraph.py::test_sim3_transform_refine's problem."""
    jcam = JaxPerspective.create(fx=500, fy=500, cx=320, cy=240, cols=640, rows=480)
    R_gt, t_gt, s_gt = synthetic.random_sim3(rng, max_angle=0.3, max_trans=0.5, scale_range=(0.8, 1.3))
    n = 128
    lm2 = jsyn.landmark_cloud(rng, n, center=(0, 0, 5), extent=(3, 2, 1.5))
    g_gt = _g(R_gt, t_gt, s_gt)
    lm1 = np.asarray(jsim3.transform(g_gt, jnp.asarray(lm2, jnp.float32)))
    uv1 = np.asarray(jcam.project(jnp.asarray(lm1, jnp.float32))[0]) + rng.standard_normal((n, 2)) * 0.3
    uv2 = np.asarray(jcam.project(jnp.asarray(lm2, jnp.float32))[0]) + rng.standard_normal((n, 2)) * 0.3
    uv2[:6] += 40.0                                  # a few outliers
    xi = np.concatenate([rng.standard_normal(3) * 0.02, rng.standard_normal(3) * 0.05, [0.03]])
    g0 = jsim3.compose(jsim3.exp(jnp.asarray(xi, jnp.float32)), g_gt)
    args = [np.asarray(g0[0]), np.asarray(g0[1]), np.asarray(g0[2]), lm1.astype(np.float32),
            lm2.astype(np.float32), uv1.astype(np.float32), uv2.astype(np.float32),
            np.ones(n, np.float32), np.ones(n, np.float32), np.ones(n, bool)]
    for fix_scale in (False, True):
        ref = jax.device_get(jax_sim3_opt(jcam, fix_scale=fix_scale)(*map(jnp.asarray, args)))
        res = make_sim3_transform_optimizer(_port_cam(jcam), fix_scale=fix_scale)(
            *(torch.as_tensor(np.array(a)) for a in args))
        np.testing.assert_allclose(res.R.numpy(), ref.R, atol=1e-4)
        np.testing.assert_allclose(res.t.numpy(), ref.t, atol=1e-4)
        np.testing.assert_allclose(float(res.s), float(ref.s), atol=1e-4)
        np.testing.assert_array_equal(res.inliers.numpy(), ref.inliers)
        assert int(res.num_inliers) == int(ref.num_inliers) >= 115
        if fix_scale:
            assert float(res.s) == float(args[2])


def _ring_problem(rng, n, N, E, fix_scale):
    """tests/test_posegraph.py's drifted ring: noisy odometry, then the
    true relative measurements around the ring (loop edge n-1 -> 0)."""
    Rs, ts = [], []
    for k in range(n):
        a = 2 * np.pi * k / n
        T = jsyn.lookat_pose_cw(np.array([5.0 * np.cos(a), 0.0, 5.0 * np.sin(a)]), (0, 0, 0))
        Rs.append(T[:3, :3])
        ts.append(T[:3, 3])
    R_est, t_est, s_est = [Rs[0]], [ts[0]], [1.0]
    for k in range(1, n):
        rel = jsim3.compose(_g(Rs[k], ts[k], 1.0), jsim3.inverse(_g(Rs[k - 1], ts[k - 1], 1.0)))
        sig = 0.0 if fix_scale else rng.standard_normal() * 0.005
        noise = jnp.asarray(np.concatenate([rng.standard_normal(3) * 0.01,
                                            rng.standard_normal(3) * 0.02, [sig]]), jnp.float32)
        g = jsim3.compose(jsim3.compose(jsim3.exp(noise), rel), _g(R_est[-1], t_est[-1], s_est[-1]))
        R_est.append(np.asarray(g[0]))
        t_est.append(np.asarray(g[1]))
        s_est.append(float(g[2]))
    e = dict(e_i=np.zeros(E, np.int32), e_j=np.zeros(E, np.int32),
             e_R=np.tile(np.eye(3, dtype=np.float32), (E, 1, 1)), e_t=np.zeros((E, 3), np.float32),
             e_s=np.ones(E, np.float32), e_mask=np.zeros(E, bool))
    for k in range(n):
        i, j = k, (k + 1) % n
        rel = jsim3.compose(_g(Rs[j], ts[j], 1.0), jsim3.inverse(_g(Rs[i], ts[i], 1.0)))
        e["e_i"][k], e["e_j"][k] = i, j
        e["e_R"][k], e["e_t"][k], e["e_s"][k] = np.asarray(rel[0]), np.asarray(rel[1]), float(rel[2])
        e["e_mask"][k] = True
    R = np.tile(np.eye(3, dtype=np.float32), (N, 1, 1))
    t = np.zeros((N, 3), np.float32)
    s = np.ones(N, np.float32)
    R[:n], t[:n], s[:n] = np.stack(R_est), np.stack(t_est), s_est
    valid = np.arange(N) < n
    fixed = np.arange(N) == 0
    return (R, t, s, valid, fixed, e["e_i"], e["e_j"], e["e_R"], e["e_t"], e["e_s"], e["e_mask"])


@pytest.mark.parametrize("case", ["closes_loop", "fix_scale"])
def test_pose_graph_matches_jax(rng, case):
    fix = case == "fix_scale"
    arrays = _ring_problem(rng, 24 if fix else 32, 24 if fix else 40, 28 if fix else 40, fix)
    ref = jax.device_get(jax_pose_graph(iters=25, cg_iters=60, fix_scale=fix)(
        JaxPGProblem(*map(jnp.asarray, arrays))))
    out = PG.make_pose_graph_optimizer(iters=25, cg_iters=60, fix_scale=fix)(
        PG.PoseGraphProblem(*(_t(np.array(a)) for a in arrays)))
    for a, b in zip(out[:3], ref[:3]):
        np.testing.assert_allclose(a.numpy(), b, atol=1e-4)
    assert float(out[3]) < 1e-3
    if fix:
        np.testing.assert_array_equal(out[2].numpy(), 1.0)


def test_pose_graph_jacobians_match_jax(rng):
    """The batched forward-mode edge Jacobians (``torch.func.vmap`` of
    ``jacfwd``, through the adjugate solve of ``sim3.log``) against JAX's."""
    E = 24
    g = [jsim3.exp(jnp.asarray(rng.standard_normal((E, 7)) * 0.6, jnp.float32)) for _ in range(3)]
    args = [np.asarray(x) for gg in g for x in gg]
    z7 = jnp.zeros(7, jnp.float32)

    def res(xi, xj, Ri, ti, si, Rj, tj, sj, Rm, tm, sm):
        Si = jsim3.compose(jsim3.exp(xi), (Ri, ti, si))
        Sj = jsim3.compose(jsim3.exp(xj), (Rj, tj, sj))
        return jsim3.log(jsim3.compose((Rm, tm, sm), jsim3.compose(Si, jsim3.inverse(Sj))))

    Jr = [np.asarray(jax.vmap(lambda *a, n=n: jax.jacfwd(
        lambda x: res(*((x, z7) if n == 0 else (z7, x)), *a))(z7))(*map(jnp.asarray, args)))
        for n in (0, 1)]
    z = torch.zeros(7, dtype=torch.float64)
    J = PG._edge_jacobians(z, z, *(_t(np.array(a)).double() for a in args))
    for a, b in zip(J, Jr):
        np.testing.assert_allclose(a.numpy(), b, atol=1e-5)


def test_global_ba_matches_jax(rng):
    """tests/test_ba.py::test_global_ba_pcg's problem, held as the local BA
    is: the same inliers, the final cost within 1e-4, every inlier
    reprojected within 0.05 px of JAX's reprojection."""
    jcam, prob, *_ = _build_problem(rng, n_fixed=1)
    ref = jax.device_get(jax_global_ba(jcam, iters=12, cg_iters=30)(prob))
    cam = _port_cam(jcam)
    p = BA.BAProblem(*(_t(np.array(a)) for a in prob))
    res = BA.make_global_ba(cam, iters=12, cg_iters=30)(p)
    np.testing.assert_array_equal(res.obs_inlier.numpy(), ref.obs_inlier)
    assert abs(float(res.cost) - float(ref.cost)) <= 1e-4 * max(abs(float(ref.cost)), 1e-12)
    n = int(p.obs_mask.sum())
    oc, ol, uv = p.obs_cam[:n].long(), p.obs_lm[:n].long(), p.obs_uv[:n]
    pred = uv - BA.reprojection_residuals(cam, res.T_cw, res.X, oc, ol, uv)[0]
    pred_j = uv - BA.reprojection_residuals(cam, _t(ref.T_cw), _t(ref.X), oc, ol, uv)[0]
    inl = res.obs_inlier[:n]
    assert float((pred - pred_j).norm(dim=-1)[inl].max()) <= 0.05
    np.testing.assert_allclose(res.T_cw.numpy(), ref.T_cw, atol=1e-3)


# ------------------------------------------------- chip_smoke's replay checks

@pytest.fixture(scope="module")
def solved_problems():
    """A global BA (tests/test_ba.py's problem) and a pose graph (the drifted
    ring) solved once on the CPU, as chip_smoke's replays hold them."""
    rng = np.random.default_rng(7)
    jcam, prob, *_ = _build_problem(rng, n_fixed=1)
    cam = _port_cam(jcam)
    p = BA.BAProblem(*(_t(np.array(a)) for a in prob))
    pg = PG.PoseGraphProblem(*(_t(np.array(a)) for a in _ring_problem(rng, 32, 40, 40, False)))
    return (cam, p, BA.make_global_ba(cam, iters=12, cg_iters=30)(p), pg,
            PG.make_pose_graph_optimizer(iters=25, cg_iters=60)(pg))


def _near_threshold_problem(cam, p, ref):
    """``p`` with one inlier observation moved so that its chi2 under ``ref``
    sits 1 % below the threshold (the predictions do not move); returns
    (problem, that observation)."""
    from openvslam_tpu_torch.optimize.residuals import CHI2_2D

    n = int(p.obs_mask.sum())
    j = int(torch.nonzero(ref.obs_inlier[:n])[0, 0])
    r = BA.reprojection_residuals(cam, ref.T_cw, ref.X, p.obs_cam[:n].long(), p.obs_lm[:n].long(),
                          p.obs_uv[:n])[0][j]
    target = torch.tensor([np.sqrt(0.99 * CHI2_2D * float(p.obs_sigma2[j])), 0.0])
    uv = p.obs_uv.clone()
    uv[j] += target - r
    return p._replace(obs_uv=uv), j


@pytest.mark.parametrize("case,allow_flips,ok", [
    ("same", False, True), ("same", True, True),
    ("camera_moved", True, False), ("cost_off", True, False),
    ("near_flip", False, False), ("near_flip", True, True),
    ("far_flip", False, False), ("far_flip", True, False)])
def test_ba_agreement_fails_a_wrong_solution(solved_problems, case, allow_flips, ok):
    """chip_smoke's BA replay check passes the reference against itself and
    fails a planted wrong solution: a camera moved by 1 cm, a cost off by
    1e-3, an inlier flag flipped where the chi2 is far from the threshold
    and, unless flips are allowed (the global BA replay), one flipped where
    it is within 5 % of it."""
    import chip_smoke

    cam, p, ref, _, _ = solved_problems
    res = BA.BAResult(*(x.clone() for x in ref))
    if case == "camera_moved":
        i = int(torch.nonzero(p.cam_opt)[0, 0])
        res.T_cw[i, 0, 3] += 0.01
    elif case == "cost_off":
        res = res._replace(cost=res.cost * (1 + 1e-3))
    elif case == "near_flip":
        p, j = _near_threshold_problem(cam, p, ref)
        res.obs_inlier[j] = ~res.obs_inlier[j]
    elif case == "far_flip":
        res.obs_inlier[0] = ~res.obs_inlier[0]
    row = chip_smoke.ba_agreement(cam, p, res, ref, allow_flips=allow_flips)
    assert row["ok"] == ok, row
    assert row["inlier_flips"] == (1 if case.endswith("flip") else 0)


@pytest.mark.parametrize("case,ok", [("same", True), ("node_moved", False),
                                     ("scale_off", False), ("cost_off", False)])
def test_pose_graph_agreement_fails_a_wrong_solution(solved_problems, case, ok):
    """chip_smoke's pose-graph replay check passes the reference against
    itself and fails a node moved by 1e-4, a scale off by 1e-4 and a cost
    off by 2e-4 relative."""
    import chip_smoke

    *_, pg, ref = solved_problems
    R, t, s, cost = (x.clone() for x in ref)
    if case == "node_moved":
        t[5, 1] += 1e-4
    elif case == "scale_off":
        s[7] += 1e-4
    elif case == "cost_off":
        cost = cost * (1 + 2e-4)
    row = chip_smoke.pose_graph_agreement(pg, (R, t, s, cost), ref)
    assert row["ok"] == ok, row


# ---------------------------------------------------------------- the wall map

def _cfg_dict():
    return {"Camera": {"name": "synthetic", "setup": "monocular", "model": "perspective",
                       "fx": 350.0, "fy": 350.0, "cx": COLS / 2, "cy": ROWS / 2,
                       "cols": COLS, "rows": ROWS, "fps": 8},
            "Feature": {"max_num_keypts": 600, "num_levels": 4, "scale_factor": 1.2},
            "LoopDetector": {"enabled": True, "min_continuity": 2}}


@pytest.fixture(scope="module")
def wall():
    """tests/test_loop_e2e.py's out-and-back traversal of a textured wall,
    mapped by the JAX System; the map and BoW database carried across.
    Returns (JAX system, ground truth, port map, port BoW database)."""
    cfg = JaxConfig.from_dict(_cfg_dict())
    cam = cfg.camera
    scene = jsyn.PlaneSceneRenderer(np.random.default_rng(7), x_range=(-4, 18), y_range=(-5, 5),
                                    plane_z=7.0, rows=cam.rows, cols=cam.cols)
    out = np.stack([jsyn.lookat_pose_cw((x, 0, 0), (x, 0, 7)) for x in np.linspace(0.0, 12.0, 36)])
    gt = np.concatenate([out, out[::-1][1:]], 0)
    s = JaxSystem(cfg, vocab_path="default")
    for i in range(len(gt)):
        s.feed_monocular_frame(scene.render(cam, gt[i]), i / 20.0)
    db = convert.map_database_from_state(convert.map_state(s.map_db))
    bow_db = convert.bow_database_from_state(convert.bow_state(s.global_optimizer.bow_db),
                                             default_vocabulary(), db)
    return s, gt, db, bow_db


def _pair(s, gt):
    """test_sim3_validation_on_real_pair's pair: the newest back-pass
    keyframe and the out-pass keyframe nearest it."""
    db = s.map_db
    ids = db.valid_kf_ids()
    src = db.kf_src_frame[ids]
    kf_b, f_b = max(((k, f) for k, f in zip(ids, src) if f >= 36 + 3), key=lambda t: t[1])
    c = lambda f: -gt[f][:3, :3].T @ gt[f][:3, 3]  # noqa: E731
    kf_a = min(((k, f) for k, f in zip(ids, src) if f < 36),
               key=lambda t: np.linalg.norm(c(t[1]) - c(f_b)))[0]
    return int(kf_b), int(kf_a)


def _mutual_cost(cam, snap, mk, mc, pk, pc, g):
    """Sum of both reprojection chi2 of the pairs under S = (R, t, s)."""
    R, t, s = (torch.as_tensor(np.asarray(x, np.float64)) for x in g)
    p1 = s * (torch.as_tensor(pc, dtype=torch.float64) @ R.T) + t          # cand -> cur
    p2 = ((torch.as_tensor(pk, dtype=torch.float64) - t) @ R) / s          # cur -> cand
    sf = 1.2
    uv1 = torch.as_tensor(snap["k"]["und"][mk], dtype=torch.float64)
    uv2 = torch.as_tensor(snap["c"]["und"][mc], dtype=torch.float64)
    c1 = ((uv1 - cam.project(p1)[0]) ** 2).sum(-1) / sf ** (2 * snap["k"]["level"][mk])
    c2 = ((uv2 - cam.project(p2)[0]) ** 2).sum(-1) / sf ** (2 * snap["c"]["level"][mc])
    return float(torch.clamp(c1, max=10.0).sum() + torch.clamp(c2, max=10.0).sum())


@pytest.mark.slow
def test_detect_matches_jax(wall):
    s, _, db, bow_db = wall
    cfg = Config.from_dict(_cfg_dict())
    jld = JaxLoopDetector(s.cfg, s.cam, s.map_db, s.global_optimizer.bow_db)
    ld = LoopDetector(cfg, cfg.camera, db, bow_db, device="cpu")
    seen = 0
    for kf in db.valid_kf_ids():
        expect = jld.detect(int(kf))
        assert ld.detect(int(kf)) == expect
        seen += len(expect)
    assert seen >= 1


@pytest.mark.slow
def test_validation_and_correction_match_jax(wall):
    s, gt, db, bow_db = wall
    kf_b, kf_a = _pair(s, gt)
    cfg = Config.from_dict(_cfg_dict())
    # validation, fed the JAX package's draws
    jld = JaxLoopDetector(s.cfg, s.cam, s.map_db, s.global_optimizer.bow_db)
    key = jld.key
    ref = jld.validate(kf_b, kf_a, min_inliers=20)
    assert ref is not None
    ld = LoopDetector(cfg, cfg.camera, db, bow_db, device="cpu")
    snap = ld.snapshot(kf_b, kf_a)
    mk, mc = ld.bow_matches(snap)
    pmask = ld._padded(*ld._pair_points(snap, mk, mc))[2]
    samples = np.asarray(jransac.sample_minimal_sets(jax.random.split(key)[1], jnp.asarray(pmask),
                                                     128, 3))
    out = ld.validate_snapshot(snap, min_inliers=20, samples=samples)
    assert out is not None
    for a, b in zip(out[3:], ref[3:]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(out[0], np.asarray(ref[0]), atol=1e-4)
    np.testing.assert_allclose(out[1], np.asarray(ref[1]), atol=1e-4)
    # the pair views the wall from one place (t ~ 0), where s R x + t
    # projects like R x: the scale is nearly free in the mutual
    # reprojection, so it is held on what it predicts (ROADMAP Queue 3)
    assert abs(out[2] - float(ref[2])) <= 2e-3
    pk, pc = ld._pair_points(snap, out[3], out[4])
    c_port, c_jax = (_mutual_cost(cfg.camera, snap, out[3], out[4], pk, pc, g)
                     for g in (out[:3], ref[:3]))
    assert abs(c_port - c_jax) <= 1e-4 * c_jax
    # the correction from the same validated Sim3 on both maps
    jdb = copy.deepcopy(s.map_db)
    jgo = JaxGO(s.cfg, s.cam, jdb, "default")
    go = GlobalOptimizationModule(cfg, cfg.camera, db, device="cpu")
    R, t, sc, _, _, lms_k, lms_c = ref
    jgo.correct_loop(kf_b, kf_a, (np.asarray(R), np.asarray(t), float(sc)), lms_k, lms_c)
    go.correct_loop(kf_b, kf_a, (np.asarray(R), np.asarray(t), float(sc)), lms_k, lms_c)
    np.testing.assert_array_equal(db.valid_kf_ids(), jdb.valid_kf_ids())
    np.testing.assert_array_equal(db.valid_lm_ids(), jdb.valid_lm_ids())
    ids = db.valid_kf_ids()
    np.testing.assert_allclose(db.kf_pose_cw[ids], jdb.kf_pose_cw[ids], atol=1e-3)
    assert db.loop_edges[kf_b] == jdb.loop_edges[kf_b] == {kf_a}


# ---------------------------------------------------------------- the slice

@pytest.mark.slow
def test_system_closes_the_organic_lap():
    """tests/test_organic_loop.py's lap (320x240, 200 frames) through the
    port's System, held to that test's gates; the JAX System runs the same
    frames and its keyframe ATE is printed beside the port's."""
    rows, cols = 240, 320
    d = {"Camera": {"name": "synthetic", "setup": "monocular", "model": "perspective",
                    "fx": 260.0, "fy": 260.0, "cx": cols / 2, "cy": rows / 2,
                    "cols": cols, "rows": rows, "fps": 20},
         "Feature": {"max_num_keypts": 500, "num_levels": 3, "scale_factor": 1.2},
         "LoopDetector": {"enabled": True, "min_continuity": 2}}
    cfg = Config.from_dict(d)
    scene = synthetic.RoomSceneRenderer(np.random.default_rng(7), half=10.0, rows=rows,
                                        cols=cols, n_walls=8)
    gt = synthetic.lap_trajectory(200, radius=6.0, laps=200 / 180)
    imgs = [scene.render(cfg.camera, gt[i]) for i in range(len(gt))]

    def run(system):
        system.startup()
        tracked = [system.feed_monocular_frame(img, i / 20.0) is not None
                   for i, img in enumerate(imgs)]
        system.shutdown()
        db = system.map_db
        ids = db.valid_kf_ids()
        ek = np.stack([-db.kf_pose_cw[k][:3, :3].T @ db.kf_pose_cw[k][:3, 3] for k in ids])
        gk = np.stack([-gt[f][:3, :3].T @ gt[f][:3, 3] for f in db.kf_src_frame[ids]])
        edge = any(db.loop_edges[int(k)] for k in ids)
        finite = all(np.isfinite(db.kf_pose_cw[int(k)]).all() for k in ids)
        return (np.array(tracked), system.global_optimizer.num_loops_closed, edge, finite,
                float(evaluate.ate_rmse(ek, gk, align="sim3")))

    tracked, loops, edge, finite, ate = run(System(cfg, device="cpu"))
    *_, jax_loops, _, _, jax_ate = run(JaxSystem(JaxConfig.from_dict(d), vocab_path="default"))
    print(f"keyframe ATE(sim3): port {ate:.4f} m ({loops} loops), "
          f"JAX {jax_ate:.4f} m ({jax_loops} loops)")
    first = int(np.argmax(tracked))
    assert first < 10 and tracked[first:].mean() > 0.9
    assert loops >= 1 and edge
    assert ate < 0.2 and finite


def test_pose_graph_measured_from_current_poses_leaves_them_in_place():
    """A graph whose edges are measured from the current keyframe poses
    starts at its optimum, also when tracking and BA have left the float32
    rotations off SO(3) (by 2e-3 here, as over the city circuit): the graph
    is built on the rotations projected onto SO(3), so solving it moves no
    keyframe (before that projection the nodes' transposes were not their
    inverses, and the solve moved them by centimetres)."""
    from openvslam_tpu_torch.data.map_database import MapDatabase

    cfg = Config.from_dict(_cfg_dict())
    db = MapDatabase(kpt_capacity=8, max_kfs=16, max_lms=16)
    rng = np.random.default_rng(4)
    n = 12
    for k in range(n):
        a = 2 * np.pi * k / n
        T = synthetic.lookat_pose_cw((10 * np.cos(a), 0, 10 * np.sin(a)),
                                     (10 * np.cos(a + 0.3), 0, 10 * np.sin(a + 0.3)))
        S = rng.standard_normal((3, 3))
        T[:3, :3] = (np.eye(3) + 1e-3 * (S + S.T)) @ T[:3, :3]
        db.kf_pose_cw[k] = T.astype(np.float32)
        db.kf_valid[k] = True
        db.parent[k] = k - 1
        db.covis[k] = {}
        db.loop_edges[k] = set()
    db.n_kfs = n
    for k in range(n):
        for d in (1, 2):
            db.covis[k][(k + d) % n] = db.covis[(k + d) % n][k] = 150
    db.loop_edges[0].add(n - 1)
    db.loop_edges[n - 1].add(0)
    off = max(float(np.abs(T[:3, :3] @ T[:3, :3].T - np.eye(3)).max()) for T in db.kf_pose_cw[:n])
    assert off > 1e-3
    before = db.kf_pose_cw[:n].copy()
    go = GlobalOptimizationModule(cfg, cfg.camera, db, device="cpu")
    go._optimize_pose_graph(fixed_kf=0)
    after = db.kf_pose_cw[:n]
    for T in after:
        np.testing.assert_allclose(T[:3, :3] @ T[:3, :3].T, np.eye(3), atol=1e-6)
    for T0, T1 in zip(before, after):
        U, _, Vt = np.linalg.svd(T0[:3, :3].astype(np.float64))
        np.testing.assert_allclose(T1[:3, :3], U @ Vt, atol=1e-5)
        np.testing.assert_allclose(T1[:3, 3], T0[:3, 3], atol=1e-5)


def test_tracker_carries_last_frame_with_a_loop_correction():
    """When a loop correction or a global BA has moved the map since the
    last frame was tracked (``db.geom_version``), the tracker carries that
    frame with its reference keyframe, keeping the frame's pose relative to
    it, so the motion model predicts the next frame in the corrected map
    (ref tracking_module::update_last_frame).  Without such a move the last
    frame keeps its pose, and the carry happens once."""
    from types import SimpleNamespace

    s = System(Config.from_dict(_cfg_dict()), device="cpu")
    tr, db = s.tracker, s.map_db
    tr.mapper = None                      # no keyframe insertion
    T_ref = synthetic.lookat_pose_cw((0.0, 0.0, 0.0), (0.3, 0.0, 5.0))
    T_last = synthetic.lookat_pose_cw((0.4, 0.1, 0.5), (0.6, 0.0, 5.0))
    db.kf_valid[0], db.kf_pose_cw[0], db.n_kfs = True, T_ref.astype(np.float32), 1
    tr.ref_kf = 0
    tr.last_frame = SimpleNamespace(frame_id=4, pose_cw=T_ref.astype(np.float32))
    frame = SimpleNamespace(frame_id=5, pose_cw=T_last.astype(np.float32))
    tr._accept(frame, 100)
    tr.last_frame = frame
    tr._reanchor_last_frame()
    np.testing.assert_array_equal(frame.pose_cw, T_last.astype(np.float32))
    # a correction moves the keyframe by 1.2 m and 3 degrees
    corr = np.eye(4)
    corr[:3, :3] = synthetic.lookat_pose_cw((0, 0, 0), (np.tan(np.radians(3.0)), 0, 1))[:3, :3]
    corr[:3, 3] = (1.2, 0.0, -0.3)
    T_new = (T_ref @ corr).astype(np.float32)
    db.kf_pose_cw[0] = T_new
    db.geom_version += 1
    tr._reanchor_last_frame()
    want = T_last @ np.linalg.inv(T_ref) @ T_new.astype(np.float64)
    np.testing.assert_allclose(frame.pose_cw, want, atol=1e-5)
    carried = frame.pose_cw.copy()
    db.kf_pose_cw[0] = T_ref.astype(np.float32)
    db.geom_version += 1
    tr._reanchor_last_frame()
    np.testing.assert_array_equal(frame.pose_cw, carried)
