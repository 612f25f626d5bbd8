"""Mono bootstrap parity: the port's triangulation, gates, two-view solvers,
RANSAC and two-view initialisation against the JAX package on the CPU, on
the same numpy inputs.

Tolerances:
* triangulation and parallax within 1e-5; window/epipolar gates and the
  angle filter exact;
* fit_*: equal up to sign and scale (each side normalised by its
  Frobenius norm and the sign of its largest entry) to the float64
  evaluation of the same algorithm within 5e-4 (F and H within 1e-5; E
  carries the float32 SVD that projects it onto the manifold), and to JAX's float32 fits
  in the median over 64 samples (1e-5; 1e-2 for the essential fit, whose
  float32 normal equations on near-parallel bearings cost JAX up to all
  its digits); score_*: identical inlier masks, scores rtol 1e-5 on the
  same model (for homographies, on those with 20 or more inliers: the
  score goes through the inverse); decompose_*: the same
  set of (R, t) hypotheses up to order, atol 1e-5;
* RANSAC and init_attempt fed the JAX package's draws: identical match
  counts, model choice, masks and compaction; the eight support counts
  identical as a set (the port fixes the SVD's signs, so its hypotheses may
  come in another order than JAX's LAPACK gives them); T21 within 5e-3 of
  JAX's, because JAX's float32 normal-equation eigensolver puts its own
  T21 about 1e-3 from a float64 solve of the same draw on this near-planar
  scene, while the port (float64 null vectors) is within 1e-5 of its own
  float64 evaluation.
"""
import numpy as np
import jax
import jax.numpy as jnp
import jax.random as jr
import pytest
import torch

from openvslam_tpu.camera import Perspective as JaxPerspective
from openvslam_tpu.data import Frame as JaxFrame
from openvslam_tpu.initialize import two_view as JTV
from openvslam_tpu.models.frontend import OrbFrontend as JaxFrontend
from openvslam_tpu.ops import match as JM
from openvslam_tpu.ops import ransac as jransac
from openvslam_tpu.ops import solvers as JS
from openvslam_tpu.ops import triangulate as JT
from openvslam_tpu.utils import synthetic as jsyn
from openvslam_tpu_torch.camera import Perspective
from openvslam_tpu_torch.data import Frame
from openvslam_tpu_torch.initialize import two_view as TV
from openvslam_tpu_torch.ops import match as M
from openvslam_tpu_torch.ops import ransac, solvers, triangulate

_t = torch.from_numpy


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Thousands of small tensor operations: with the suite's worker
    processes sharing the cores, intra-op threads only contend, so this
    module runs them on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return np.asarray(x)


def _scene(rng, n=200, n_out=40, planar=False):
    """tests/test_solvers.py's two-view scene: pixels, bearings, poses, K."""
    pts = jsyn.landmark_cloud(rng, n, center=(0, 0, 6),
                              extent=(4, 3, 0.0) if planar else (4, 3, 2.0))
    T2 = jsyn.lookat_pose_cw(eye=(1.0, 0.2, 0.3), target=(0, 0, 6))
    K = np.array([[500.0, 0, 320.0], [0, 500.0, 240.0], [0, 0, 1]])
    pc1 = pts
    pc2 = (T2[:3, :3] @ pts.T).T + T2[:3, 3]
    uv1 = (K @ (pc1 / pc1[:, 2:]).T).T[:, :2]
    uv2 = (K @ (pc2 / pc2[:, 2:]).T).T[:, :2]
    out = rng.choice(n, n_out, replace=False)
    uv2[out] += (rng.random((n_out, 2)) - 0.5) * 200
    b1 = pc1 / np.linalg.norm(pc1, axis=-1, keepdims=True)
    b2 = pc2 / np.linalg.norm(pc2, axis=-1, keepdims=True)
    f32 = lambda a: a.astype(np.float32)  # noqa: E731
    return f32(uv1), f32(uv2), f32(b1), f32(b2), f32(T2), f32(K)


def _canon(M_):
    """Normalise a batch of matrices by Frobenius norm and the sign of the
    largest-magnitude entry."""
    M_ = np.asarray(M_, np.float64).reshape(M_.shape[0], -1)
    M_ = M_ / np.linalg.norm(M_, axis=-1, keepdims=True)
    big = np.take_along_axis(M_, np.abs(M_).argmax(-1)[:, None], -1)
    return M_ * np.sign(big)


# ---------------------------------------------------------------- geometry

def test_triangulation_and_parallax_match_jax(rng):
    uv1, uv2, b1, b2, T2, _ = _scene(rng, n_out=0)
    T1 = np.eye(4, dtype=np.float32)
    Xj, okj = JT.triangulate_two_view(jnp.asarray(b1), jnp.asarray(b2), jnp.asarray(T1),
                                      jnp.asarray(T2))
    X, ok = triangulate.triangulate_two_view(_t(b1), _t(b2), _t(T1), _t(T2))
    np.testing.assert_array_equal(ok.numpy(), _np(okj))
    np.testing.assert_allclose(X.numpy(), _np(Xj), rtol=1e-5, atol=1e-5)
    zj = JT.depths_and_parallax(Xj, jnp.asarray(b1), jnp.asarray(b2), jnp.asarray(T1),
                                jnp.asarray(T2))
    z = triangulate.depths_and_parallax(_t(_np(Xj)), _t(b1), _t(b2), _t(T1), _t(T2))
    for a, b in zip(z, zj):
        np.testing.assert_allclose(a.numpy(), _np(b), rtol=1e-5, atol=1e-5)


def test_gates_and_angle_filter_match_jax(rng):
    xa = rng.uniform(0, 400, (300, 2)).astype(np.float32)
    xb = rng.uniform(0, 400, (280, 2)).astype(np.float32)
    np.testing.assert_array_equal(M.window_gate(_t(xa), _t(xb), 100.0).numpy(),
                                  _np(JM.window_gate(jnp.asarray(xa), jnp.asarray(xb), 100.0)))
    la, lb = rng.integers(0, 8, 300), rng.integers(0, 8, 280)
    np.testing.assert_array_equal(M.scale_gate(_t(la), _t(lb)).numpy(),
                                  _np(JM.scale_gate(jnp.asarray(la), jnp.asarray(lb))))
    ba = rng.normal(size=(300, 3)).astype(np.float32)
    bb = rng.normal(size=(280, 3)).astype(np.float32)
    ba /= np.linalg.norm(ba, axis=-1, keepdims=True)
    bb /= np.linalg.norm(bb, axis=-1, keepdims=True)
    E = rng.normal(size=(3, 3)).astype(np.float32)
    ep = M.epipolar_gate(_t(ba), _t(bb), _t(E), thr=2e-2).numpy()
    assert ep.any()
    np.testing.assert_array_equal(
        ep, _np(JM.epipolar_gate(jnp.asarray(ba), jnp.asarray(bb), jnp.asarray(E), thr=2e-2)))
    # angles with many matches in few bins, some unmatched rows
    aa = rng.uniform(0, 2 * np.pi, 300).astype(np.float32)
    ab = rng.uniform(0, 2 * np.pi, 280).astype(np.float32)
    idx = rng.integers(-1, 280, 300).astype(np.int32)
    ab[idx[idx >= 0][:150]] = aa[idx >= 0][:150] - 0.3
    got = M.angle_consistency_filter(_t(aa), _t(ab), _t(idx)).numpy()
    want = _np(JM.angle_consistency_filter(jnp.asarray(aa), jnp.asarray(ab), jnp.asarray(idx)))
    np.testing.assert_array_equal(got, want)
    assert (got >= 0).sum() > 100


# ---------------------------------------------------------------- solvers

def _samples(rng, n, n_hyp, k):
    return np.stack([rng.choice(n, k, replace=False) for _ in range(n_hyp)])


# the median over 64 minimal samples of JAX's float32 fit's distance from the
# port's: JAX's float32 normal equations lose digits on some samples (its
# essential fit on near-parallel bearings by far the most: median 2.6e-3,
# worst 0.93 from a float64 solve), the port's float64 null vectors do not
FIT_MEDIAN_TOL = {"fundamental": 1e-5, "homography": 1e-5, "essential": 1e-2}


@pytest.mark.parametrize("kind", ["fundamental", "homography", "essential"])
def test_fit_and_score_match_jax(rng, kind):
    uv1, uv2, b1, b2, _, _ = _scene(rng, planar=kind == "homography")
    a1, a2 = (b1, b2) if kind == "essential" else (uv1, uv2)
    k = 4 if kind == "homography" else 8
    idx = _samples(rng, len(a1), 64, k)
    fit_j = getattr(JS, f"fit_{kind}")
    score_j = getattr(JS, f"score_{kind}")
    fit = getattr(solvers, f"fit_{kind}")
    models_j = np.stack([_np(fit_j(jnp.asarray(a1[i]), jnp.asarray(a2[i]))) for i in idx])
    models = _canon(fit(_t(a1[idx]), _t(a2[idx])).numpy())
    models64 = _canon(fit(_t(a1[idx]).double(), _t(a2[idx]).double()).numpy())
    # the port equals the float64 evaluation of the same algorithm (to the
    # float32 SVD that projects F and E onto their manifolds) ...
    np.testing.assert_allclose(models, models64, rtol=1e-4, atol=5e-4)
    # ... and JAX's float32 fits, up to their own rounding
    d = np.abs(models - _canon(models_j)).max(-1)
    assert np.median(d) <= FIT_MEDIAN_TOL[kind], np.sort(d)
    mask = np.ones(len(a1), bool)
    mask[::7] = False
    s, inl = getattr(solvers, f"score_{kind}")(_t(models_j), _t(a1), _t(a2), _t(mask))
    # a homography's score goes through its inverse: on degenerate samples
    # (at most 11 inliers here) the two float32 inverses differ beyond 1e-5,
    # so homographies with fewer than 20 inliers are held on their masks
    well = (inl.numpy().sum(-1) >= 20) | (kind != "homography")
    assert well.sum() >= 16
    for h in range(len(idx)):
        sj, inlj = score_j(jnp.asarray(models_j[h]), jnp.asarray(a1), jnp.asarray(a2),
                           jnp.asarray(mask))
        np.testing.assert_array_equal(inl[h].numpy(), _np(inlj))
        if well[h]:
            np.testing.assert_allclose(float(s[h]), float(sj), rtol=1e-5)
    assert inl.numpy().sum(-1).max() > 100


def _same_hypotheses(Rs, ts, Rs_j, ts_j, atol=1e-5):
    """Every hypothesis of one list within atol of one of the other, both ways."""
    A = np.concatenate([Rs.reshape(len(Rs), -1), ts], -1)
    B = np.concatenate([Rs_j.reshape(len(Rs_j), -1), ts_j], -1)
    d = np.abs(A[:, None] - B[None]).max(-1)
    assert d.min(1).max() <= atol and d.min(0).max() <= atol, d


def test_decompositions_match_jax(rng):
    uv1, uv2, b1, b2, T2, K = _scene(rng, n_out=0)
    E = (np.array([[0, -T2[2, 3], T2[1, 3]], [T2[2, 3], 0, -T2[0, 3]],
                   [-T2[1, 3], T2[0, 3], 0]], np.float32) @ T2[:3, :3])
    Rs, ts = solvers.decompose_essential(_t(E))
    Rs_j, ts_j = JS.decompose_essential(jnp.asarray(E))
    _same_hypotheses(Rs.numpy(), ts.numpy(), _np(Rs_j), _np(ts_j))
    puv1, puv2, _, _, _, _ = _scene(np.random.default_rng(3), n_out=0, planar=True)
    H = _np(JS.fit_homography(jnp.asarray(puv1[:40]), jnp.asarray(puv2[:40])))
    Rs, ts, _ = solvers.decompose_homography(_t(H), _t(K))
    Rs_j, ts_j, _ = JS.decompose_homography(jnp.asarray(H), jnp.asarray(K))
    _same_hypotheses(Rs.numpy(), ts.numpy(), _np(Rs_j), _np(ts_j))
    # the essential matrix of a fitted F, as the bootstrap forms it
    F = _np(JS.fit_fundamental(jnp.asarray(uv1[:60]), jnp.asarray(uv2[:60])))
    Ef = _np(JS.essential_from_F(jnp.asarray(F), jnp.asarray(K), jnp.asarray(K)))
    np.testing.assert_allclose(solvers.essential_from_F(_t(F), _t(K), _t(K)).numpy(), Ef,
                               rtol=1e-5, atol=1e-6)
    Rs, ts = solvers.decompose_essential(_t(Ef))
    Rs_j, ts_j = JS.decompose_essential(jnp.asarray(Ef))
    _same_hypotheses(Rs.numpy(), ts.numpy(), _np(Rs_j), _np(ts_j))


# ---------------------------------------------------------------- RANSAC

def test_sample_minimal_sets_draws_valid_distinct_indices():
    mask = torch.zeros(500, dtype=torch.bool)
    mask[torch.arange(0, 500, 3)] = True
    gen = torch.Generator().manual_seed(5)
    s = ransac.sample_minimal_sets(gen, mask, 256, 8)
    assert s.shape == (256, 8)
    assert mask[s].all()
    assert all(len(set(row.tolist())) == 8 for row in s)
    again = ransac.sample_minimal_sets(torch.Generator().manual_seed(5), mask, 256, 8)
    assert torch.equal(s, again)
    # every valid entry is drawn somewhere (256 x 8 draws over 167 entries)
    assert len(set(s.flatten().tolist())) == int(mask.sum())


def test_ransac_with_jax_draws_matches_jax(rng):
    uv1, uv2, _, _, _, _ = _scene(rng)
    p1, p2 = jnp.asarray(uv1), jnp.asarray(uv2)
    mask = jnp.ones(p1.shape[0], bool)
    key = jr.PRNGKey(0)
    F_j, s_j, inl_j = jransac.run_ransac(
        key, lambda i: JS.fit_fundamental(p1[i], p2[i]),
        lambda F: JS.score_fundamental(F, p1, p2, mask), mask, 256, 8)
    samples = _t(_np(jransac.sample_minimal_sets(key, mask, 256, 8)))
    F, s, inl = ransac.ransac_from_samples(
        samples, lambda i: solvers.fit_fundamental(_t(uv1)[i], _t(uv2)[i]),
        lambda F: solvers.score_fundamental(F, _t(uv1), _t(uv2), torch.ones(len(uv1), dtype=torch.bool)))
    np.testing.assert_array_equal(inl.numpy(), _np(inl_j))
    np.testing.assert_allclose(float(s), float(s_j), rtol=1e-4)
    np.testing.assert_allclose(_canon(F.numpy()[None]), _canon(_np(F_j)[None]), atol=1e-4)


# ---------------------------------------------------------------- bootstrap

@pytest.fixture(scope="module")
def init_frames():
    """tests/test_init_fused.py's two rendered views (416x320, 900 keypoints,
    4 levels), extracted by the JAX front end."""
    jcam = JaxPerspective.create(fx=350.0, fy=350.0, cx=208.0, cy=160.0, cols=416, rows=320)
    cam = Perspective(fx=350.0, fy=350.0, cx=208.0, cy=160.0, cols=416, rows=320)
    scene = jsyn.PatchSceneRenderer(np.random.default_rng(4), n_points=900, center=(0, 0, 6),
                                    extent=(6, 4.5, 2.5), rows=320, cols=416)
    fe = JaxFrontend(rows=320, cols=416, max_keypts=900, num_levels=4, scale_factor=1.2)
    frames = []
    for i, P in enumerate((jsyn.lookat_pose_cw((0, 0, 0), (0, 0, 6)),
                           jsyn.lookat_pose_cw((0.35, 0.05, 0), (0.1, 0, 6)))):
        kp = fe.extract(jnp.asarray(scene.render(jcam, P)))
        frames.append(JaxFrame.from_keypoints(i, i / 20.0, kp, jcam))
    return jcam, cam, frames


def _operands(f):
    return [f.desc_i8, f.valid, f.xy, f.angle, f.xy_undist, f.bearing]


def _K(cam):
    return np.array([[cam.fx, 0, cam.cx], [0, cam.fy, cam.cy], [0, 0, 1]], np.float32)


@pytest.mark.parametrize("seed,views", [(7, (0, 1)), (11, (0, 1)), (3, (0, 0))])
def test_init_attempt_with_jax_draws_matches_jax(init_frames, seed, views):
    jcam, _, frames = init_frames
    args = _operands(frames[views[0]]) + _operands(frames[views[1]])
    K = _K(jcam)
    key = jr.PRNGKey(seed)
    out_j = jax.device_get(JTV.init_attempt(key, *map(jnp.asarray, args), jnp.asarray(K)))
    (nm_j, use_h_j, counts_j, T21_j, X_j, good_j, m1_j, m2_j, pmask_j, ninl_j) = out_j
    k1, k2 = jr.split(key)
    sh = _np(jransac.sample_minimal_sets(k1, jnp.asarray(pmask_j), 256, 4))
    sf = _np(jransac.sample_minimal_sets(k2, jnp.asarray(pmask_j), 256, 8))
    targs = [_t(np.asarray(a)) for a in args]
    out = TV.init_attempt_with_samples(_t(sh), _t(sf), *targs, _t(K))
    assert int(out.num_matches) == int(nm_j)
    assert bool(out.use_h) == bool(use_h_j)
    for name, want in (("m1", m1_j), ("m2", m2_j), ("pmask", pmask_j), ("good", good_j)):
        np.testing.assert_array_equal(getattr(out, name).numpy(), want, err_msg=name)
    assert int(out.n_inl) == int(ninl_j)
    np.testing.assert_array_equal(np.sort(out.counts.numpy()), np.sort(counts_j))
    if counts_j.max() > 0:          # a pose exists only where some hypothesis has support
        np.testing.assert_allclose(out.T21.numpy(), T21_j, atol=5e-3)
        g = good_j
        np.testing.assert_allclose(out.X.numpy()[g], X_j[g], rtol=5e-2, atol=5e-2)
        # the port's own float32 result against its float64 evaluation
        a64 = [a.double() if a.is_floating_point() else a for a in targs]
        out64 = TV.init_attempt_with_samples(_t(sh), _t(sf), *a64, _t(K).double())
        np.testing.assert_allclose(out.T21.numpy(), out64.T21.numpy(), atol=1e-5)


def _port_frame(f):
    import dataclasses
    return Frame(**{k.name: getattr(f, k.name) for k in dataclasses.fields(JaxFrame)})


@pytest.mark.parametrize("seed,views,success", [(7, (0, 1), True), (11, (0, 1), True),
                                                (3, (0, 0), False)])
def test_initialize_two_view_same_decision_as_jax(init_frames, seed, views, success):
    jcam, cam, frames = init_frames
    f1, f2 = frames[views[0]], frames[views[1]]
    r_j = JTV.initialize_two_view(jr.PRNGKey(seed), f1, f2, jcam)
    r = TV.initialize_two_view(torch.Generator().manual_seed(seed), _port_frame(f1),
                               _port_frame(f2), cam)
    assert r.success == r_j.success == success
    assert r.num_matches == r_j.num_matches
    if success:
        np.testing.assert_array_equal(r.idx1, r_j.idx1)
        np.testing.assert_array_equal(r.idx2, r_j.idx2)
        # the draws differ (torch.Generator against JAX's key), and on this
        # short baseline so does the recovered motion: only the decision,
        # the matches and the triangulated share are held
        assert r.is_inlier.sum() >= 40 and r_j.is_inlier.sum() >= 40
