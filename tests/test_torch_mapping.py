"""Mapping parity: the port's local BA, triangulation and fusion candidates,
map database, map-state converter and mapping module against the JAX
package on the CPU, on the same numpy inputs.

Tolerances:
* local BA on tests/test_ba.py's problems: T_cw within 1e-4, obs_inlier
  identical, X within 1e-4 of |X| for landmarks seen three or more times
  and within 1e-3 for those seen twice (their depth is uncertain by
  decimetres on these problems, and float32 rounding in two summation
  orders moves them by up to 3e-4 of |X|);
* the analytic Jacobians against ``torch.func.jacfwd`` within 1e-4;
* triangulation and fusion candidates: idx exact, ok identical, X within
  5e-5 of |X| in the median and 1e-3 at worst (the 4x4 float32
  eigensolvers of the two packages round differently: 1.4e-5 in the
  median on these short baselines, up to 3e-4 on the lowest-parallax
  pairs);
* the map database: identical arrays after the same operations, and
  after a round trip of a JAX System's map through ``convert``;
* one keyframe inserted by both mapping modules into the same map: the
  same landmarks created and culled, keyframe poses within 1e-3.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from openvslam_tpu.camera import Perspective as JaxPerspective
from openvslam_tpu.config import Config as JaxConfig
from openvslam_tpu.data import Frame as JaxFrame
from openvslam_tpu.data import MapDatabase as JaxMapDatabase
from openvslam_tpu.models import tracking_ops as JTO
from openvslam_tpu.models.frontend import OrbFrontend as JaxFrontend
from openvslam_tpu.optimize.ba import make_local_ba as jax_local_ba
from openvslam_tpu.system import System as JaxSystem
from openvslam_tpu.utils import synthetic as jsyn
from openvslam_tpu_torch import convert
from openvslam_tpu_torch.camera import Perspective
from openvslam_tpu_torch.config import Config
from openvslam_tpu_torch.data import Frame, MapDatabase
from openvslam_tpu_torch.models import tracking_ops as TO
from openvslam_tpu_torch.module.mapping_module import MappingModule
from openvslam_tpu_torch.optimize import ba as BA
from openvslam_tpu_torch.utils import native

from test_ba import _build_problem

_t = torch.from_numpy
ROWS, COLS = 320, 416


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


# ---------------------------------------------------------------- local BA

def _port_cam(jcam):
    return Perspective(fx=float(jcam.fx), fy=float(jcam.fy), cx=float(jcam.cx),
                       cy=float(jcam.cy), cols=int(jcam.cols), rows=int(jcam.rows))


@pytest.mark.parametrize("case", ["noiseless", "noisy", "outliers"])
def test_local_ba_matches_jax(rng, case):
    jcam, prob, _, _, _, _ = _build_problem(rng, noise_px=0.0 if case == "noiseless" else 0.5)
    if case == "outliers":          # tests/test_ba.py's 5 % corrupted observations
        n_obs = int(_np(prob.obs_mask).sum())
        bad = rng.choice(n_obs, n_obs // 20, replace=False)
        ouv = _np(prob.obs_uv).copy()
        ouv[bad] += (rng.random((len(bad), 2)) - 0.5) * 120 + 15
        prob = prob._replace(obs_uv=jnp.asarray(ouv))
    res_j = jax.device_get(jax_local_ba(jcam)(prob))
    res = BA.make_local_ba(_port_cam(jcam))(BA.BAProblem(*(_t(np.array(a)) for a in prob)))
    np.testing.assert_array_equal(res.obs_inlier.numpy(), res_j.obs_inlier)
    np.testing.assert_allclose(res.T_cw.numpy(), res_j.T_cw, atol=1e-4)
    lv = _np(prob.lm_valid)
    nobs = np.bincount(_np(prob.obs_lm)[_np(prob.obs_mask)], minlength=len(lv))
    rel = (np.linalg.norm(res.X.numpy() - res_j.X, axis=-1)
           / np.maximum(np.linalg.norm(res_j.X, axis=-1), 1.0))
    assert rel[lv & (nobs >= 3)].max() <= 1e-4
    assert rel[lv].max() <= 1e-3
    if case == "outliers":
        assert int(res.obs_inlier.sum()) < int(_np(prob.obs_mask).sum())


def test_analytic_jacobians_match_autodiff(rng):
    jcam, prob, _, _, _, _ = _build_problem(rng)
    cam = _port_cam(jcam)
    p = BA.BAProblem(*(_t(np.array(a)) for a in prob))
    n = int(p.obs_mask.sum())
    oc, ol, uv = p.obs_cam[:n].long(), p.obs_lm[:n].long(), p.obs_uv[:n]
    r, ok, Jc, Jl = BA.reprojection_residuals_and_jacobians(cam, p.T_cw, p.X, oc, ol, uv)
    assert ok.all()

    def resid(xi, dX, T, X, o_uv):
        # the left increment exp(xi) T through the 4x4 matrix exponential of
        # the twist [omega, upsilon]
        w, v = xi[:3], xi[3:]
        z = torch.zeros((), dtype=xi.dtype)
        tw = torch.stack([torch.stack([z, -w[2], w[1], v[0]]), torch.stack([w[2], z, -w[0], v[1]]),
                          torch.stack([-w[1], w[0], z, v[2]]), torch.stack([z, z, z, z])])
        T = torch.linalg.matrix_exp(tw) @ T
        xc = T[:3, :3] @ (X + dX) + T[:3, 3]
        return o_uv - cam.project(xc)[0]

    z6, z3 = torch.zeros(6), torch.zeros(3)
    To, Xo = p.T_cw[oc], p.X[ol]
    Jc_ad = torch.func.vmap(torch.func.jacfwd(lambda xi, T, X, u: resid(xi, z3, T, X, u)))(
        z6.expand(n, 6), To, Xo, uv)
    Jl_ad = torch.func.vmap(torch.func.jacfwd(lambda d, T, X, u: resid(z6, d, T, X, u)))(
        z3.expand(n, 3), To, Xo, uv)
    scale = Jc_ad.abs().amax(dim=(1, 2), keepdim=True)
    torch.testing.assert_close(Jc / scale, Jc_ad / scale, atol=1e-4, rtol=0)
    torch.testing.assert_close(Jl / scale, Jl_ad / scale, atol=1e-4, rtol=0)


# ---------------------------------------------------------------- mapping ops

@pytest.fixture(scope="module")
def keyframes():
    """Four rendered keyframes of the e2e scene (JAX front end, 600
    keypoints, 4 levels) at their ground-truth poses."""
    jcam = JaxPerspective.create(fx=350.0, fy=350.0, cx=COLS / 2, cy=ROWS / 2, cols=COLS,
                                 rows=ROWS)
    scene = jsyn.PatchSceneRenderer(np.random.default_rng(11), n_points=700, center=(0, 0, 6),
                                    extent=(6, 4.5, 2.5), rows=ROWS, cols=COLS)
    gt = jsyn.orbit_trajectory(40, radius=2.5, target=(0, 0, 6), arc=np.pi / 4)[[20, 23, 26, 29]]
    fe = JaxFrontend(rows=ROWS, cols=COLS, max_keypts=600, num_levels=4, scale_factor=1.2)
    frames = [JaxFrame.from_keypoints(i, i / 20.0, fe.extract(jnp.asarray(scene.render(jcam, P))),
                                      jcam) for i, P in enumerate(gt)]
    return jcam, scene, gt.astype(np.float32), frames


def test_triangulation_candidates_match_jax(keyframes):
    jcam, _, gt, fr = keyframes
    sig = lambda f: (1.2 ** (2 * f.level)).astype(np.float32)  # noqa: E731
    q, nbs = fr[0], fr[1:]
    stack = lambda get: np.stack([get(f) for f in nbs])  # noqa: E731
    args = [q.desc_i8, q.valid, q.bearing, q.angle, q.xy_undist, sig(q), gt[1:],
            stack(lambda f: f.desc_i8), stack(lambda f: f.valid), stack(lambda f: f.bearing),
            stack(lambda f: f.angle), stack(lambda f: f.xy_undist), stack(sig)]
    idx_j, X_j, ok_j = jax.device_get(JTO.triangulation_candidates_multi(
        jcam, jnp.asarray(gt[0]), *map(jnp.asarray, args), jnp.float32(1e-2)))
    idx, X, ok = TO.triangulation_candidates_multi(
        _port_cam(jcam), _t(gt[0]), *(_t(np.asarray(a)) for a in args), 1e-2)
    np.testing.assert_array_equal(idx.numpy(), idx_j)
    np.testing.assert_array_equal(ok.numpy(), ok_j)
    assert ok_j.sum() > 100
    d = (np.linalg.norm(X.numpy() - X_j, axis=-1) / np.linalg.norm(X_j, axis=-1).clip(1.0))[ok_j]
    assert np.median(d) <= 5e-5 and d.max() <= 1e-3, np.sort(d)[-5:]


def test_fuse_candidates_match_jax(keyframes):
    jcam, scene, gt, fr = keyframes
    cam = _port_cam(jcam)
    # the landmark table: scene points seen in keyframe 0 with the descriptor
    # of the keypoint within 3 px of their projection
    f0 = fr[0]
    pc = (gt[0][:3, :3] @ scene.points.T).T + gt[0][:3, 3]
    uv, _, vis = (t.numpy() for t in cam.project(_t(pc.astype(np.float32))))
    rows = []
    for i in np.where(vis)[0]:
        d = np.linalg.norm(f0.xy - uv[i], axis=-1)
        d[~f0.valid] = 1e9
        if d.min() < 3.0:
            rows.append((i, int(d.argmin())))
    pos = scene.points[[i for i, _ in rows]].astype(np.float32)
    desc = f0.desc_i8[[j for _, j in rows]]
    L = len(rows)
    nbs = fr[1:]
    stack = lambda get: np.stack([get(f) for f in nbs])  # noqa: E731
    args = [gt[1:], pos, desc, np.ones(L, bool), stack(lambda f: f.desc_i8),
            stack(lambda f: f.xy_undist), stack(lambda f: f.valid), stack(lambda f: f.level)]
    sf = (1.2 ** np.arange(4)).astype(np.float32)
    pred = np.full(L, -1, np.int64)
    idx_j, dist_j = jax.device_get(JTO.fuse_candidates_multi(
        jcam, *map(jnp.asarray, args), jnp.float32(3.0), jnp.asarray(sf), jnp.asarray(pred)))
    idx, dist = TO.fuse_candidates_multi(cam, *(_t(np.asarray(a)) for a in args), 3.0, _t(sf),
                                         _t(pred))
    np.testing.assert_array_equal(idx.numpy(), idx_j)
    np.testing.assert_array_equal(dist.numpy(), dist_j)
    assert (idx_j >= 0).sum() > 20


# ---------------------------------------------------------------- map database

def _assert_same_state(a: dict, b: dict, path="db"):
    assert type(a) is type(b) or (isinstance(a, (int, np.integer)) and isinstance(b, (int, np.integer))), path
    if isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _assert_same_state(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same_state(x, y, f"{path}[{i}]")
    else:
        assert a == b, path


def _random_frame(rng, fid, K=64, frame_cls=Frame):
    bits = rng.integers(0, 2, (K, 256)).astype(np.int8)
    words = np.packbits(bits[:, ::-1].reshape(K, 8, 32), axis=-1, bitorder="big")
    desc_u32 = words.view(">u4").reshape(K, 8).astype(np.uint32)
    eye = np.eye(4, dtype=np.float32)
    eye[:3, 3] = rng.normal(size=3) * 0.3
    return frame_cls(frame_id=fid, timestamp=fid / 20.0,
                     xy=rng.uniform(0, 400, (K, 2)).astype(np.float32),
                     xy_undist=rng.uniform(0, 400, (K, 2)).astype(np.float32),
                     bearing=rng.normal(size=(K, 3)).astype(np.float32),
                     level=rng.integers(0, 4, K).astype(np.int32),
                     angle=rng.uniform(0, 6, K).astype(np.float32),
                     response=rng.uniform(0, 1, K).astype(np.float32),
                     desc_u32=desc_u32, desc_i8=bits, valid=np.ones(K, bool),
                     x_right=np.full(K, -1.0, np.float32), depth=np.full(K, -1.0, np.float32),
                     lm_idx=np.full(K, -1, np.int32), outlier=np.zeros(K, bool), pose_cw=eye)


def _drive(db, frame_cls):
    """A fixed sequence of map operations; returns what the queries gave."""
    rng = np.random.default_rng(3)
    out = []
    kfs = [db.add_keyframe(_random_frame(rng, i, frame_cls=frame_cls)) for i in range(6)]
    lms = []
    for j in range(120):
        kf = kfs[j % 6]
        lm = db.add_landmark(rng.normal(size=3).astype(np.float32) + [0, 0, 6],
                             db.kf_desc_u32[kf][j % 64], db.kf_desc_i8[kf][j % 64], kf)
        for k in rng.choice(6, 3, replace=False):
            db.add_observation(lm, kfs[k], int((j + 7 * k) % 64))
        lms.append(lm)
    for lm in lms:
        db.update_landmark_descriptor(lm)
    db.update_landmark_geometry_batch(lms, 1.2, 4)
    for kf in kfs:
        db.update_connections(kf)
    out.append([db.get_top_covisible(kf, 5) for kf in kfs])
    db.replace_landmark(lms[3], lms[4])
    db.erase_observation(lms[10], int(next(iter(db.lm_obs[lms[10]]))))
    db.erase_landmark(lms[11])
    db.erase_keyframe(kfs[4])
    for kf in kfs:
        if db.kf_valid[kf]:
            db.update_connections(kf)
    local_kfs, local_lms = db.acquire_local_map(np.asarray(lms[:30]), max_kfs=4)
    out.append((local_kfs, sorted(local_lms.tolist())))
    out.append(db.resolve_replaced(lms[3]))
    return out


def test_map_database_matches_jax():
    db, db_j = MapDatabase(kpt_capacity=64), JaxMapDatabase(kpt_capacity=64)
    assert _drive(db, Frame) == _drive(db_j, JaxFrame)
    _assert_same_state(convert.map_state(db), convert.map_state(db_j))


def test_native_min_median_hamming_matches_plain(rng):
    for n in (1, 2, 3, 4, 7, 16):
        d = rng.integers(0, 2**32, (n, 8), dtype=np.uint64).astype(np.uint32)
        d[n // 2:] = d[0] ^ (rng.random((n - n // 2, 8)) < 0.1).astype(np.uint32)
        assert native.min_median_hamming(d) == native.min_median_hamming_plain(d)


# ---------------------------------------------------------------- a JAX System's map

def _cfg_dict():
    return {"Camera": {"name": "synthetic", "setup": "monocular", "model": "perspective",
                       "fx": 350.0, "fy": 350.0, "cx": COLS / 2, "cy": ROWS / 2,
                       "cols": COLS, "rows": ROWS, "fps": 20},
            "Feature": {"max_num_keypts": 600, "num_levels": 4, "scale_factor": 1.2},
            "LoopDetector": {"enabled": False}}


@pytest.fixture(scope="module")
def jax_map():
    """The JAX System bootstrapped on the e2e scene's first two frames, then
    frames 2-6 tracked against that map with keyframe insertion off.
    Returns (system, the map's state before any later change, frame 6)."""
    cfg = JaxConfig.from_dict(_cfg_dict())
    cam = cfg.camera
    scene = jsyn.PatchSceneRenderer(np.random.default_rng(11), n_points=700, center=(0, 0, 6),
                                    extent=(6, 4.5, 2.5), rows=ROWS, cols=COLS)
    gt = jsyn.orbit_trajectory(40, radius=2.5, target=(0, 0, 6), arc=np.pi / 4)
    s = JaxSystem(cfg)
    for i in range(2):
        s.feed_monocular_frame(scene.render(cam, gt[i]), i / 20.0)
    assert s.map_db.n_kfs == 2
    state = convert.map_state(s.map_db)
    s.disable_mapping_module()
    for i in range(2, 7):
        assert s.feed_monocular_frame(scene.render(cam, gt[i]), i / 20.0) is not None
    assert s.map_db.n_kfs == 2
    return s, state, s.tracker.last_frame


def test_convert_round_trips_a_jax_system_map(jax_map):
    _, state, _ = jax_map
    db = convert.map_database_from_state(state)
    assert isinstance(db, MapDatabase)
    assert db.n_kfs == 2 and len(db.valid_lm_ids()) > 100
    _assert_same_state(convert.map_state(db), state)
    with pytest.raises(ValueError, match="missing"):
        convert.map_database_from_state({k: v for k, v in state.items() if k != "lm_pos"})


def test_mapping_module_inserts_a_keyframe_like_jax(jax_map):
    s, state, frame = jax_map
    jm = s.mapper
    db = convert.map_database_from_state(state)
    pm = MappingModule(Config.from_dict(_cfg_dict()), Perspective(
        fx=350.0, fy=350.0, cx=COLS / 2, cy=ROWS / 2, cols=COLS, rows=ROWS, fps=20.0), db,
        device="cpu")
    pm.recent_lms = list(jm.recent_lms)
    before_j = (jm.lms_created, jm.lms_culled, jm.kfs_culled, jm.ba_runs)
    pframe = Frame(**{f.name: getattr(frame, f.name) for f in dataclasses.fields(JaxFrame)})
    kf = pm.insert_keyframe(pframe)
    assert jm.insert_keyframe(frame) == kf == 2
    jdb = s.map_db
    print('created', pm.lms_created, jm.lms_created - before_j[0], 'culled', pm.lms_culled, jm.lms_culled - before_j[1])
    assert pm.lms_created == jm.lms_created - before_j[0]
    assert pm.lms_culled == jm.lms_culled - before_j[1]
    assert pm.kfs_culled == jm.kfs_culled - before_j[2]
    assert pm.ba_runs == jm.ba_runs - before_j[3] == 1
    np.testing.assert_array_equal(db.valid_lm_ids(), jdb.valid_lm_ids())
    np.testing.assert_array_equal(db.valid_kf_ids(), jdb.valid_kf_ids())
    np.testing.assert_allclose(db.kf_pose_cw[:3], jdb.kf_pose_cw[:3], atol=1e-3)
    ids = db.valid_lm_ids()
    np.testing.assert_allclose(db.lm_pos[ids], jdb.lm_pos[ids], atol=1e-3, rtol=1e-3)
    for k in db.valid_kf_ids():
        np.testing.assert_array_equal(db.kf_lm_idx[k], jdb.kf_lm_idx[k])


def test_local_ba_outcome_does_not_depend_on_summation_order(rng, capsys):
    """chip_smoke's card/CPU agreement for a local BA, held here between two
    summation orders on the CPU: tests/test_ba.py's noisy problem with one
    fixed camera (the scale is free, as in a mono window whose other
    cameras are all local) solved with its observations in two orders.
    The predictions agree (inliers, cost, reprojections); raw T and X may
    move along the free scale and the poorly determined depths."""
    import chip_smoke

    jcam, prob, _, _, _, _ = _build_problem(rng, n_fixed=1)
    cam = _port_cam(jcam)
    p = BA.BAProblem(*(_t(np.array(a)) for a in prob))
    n = int(p.obs_mask.sum())
    perm = torch.cat([torch.from_numpy(rng.permutation(n)), torch.arange(n, p.obs_mask.shape[0])])
    q = p._replace(**{f: getattr(p, f)[perm] for f in
                      ("obs_cam", "obs_lm", "obs_uv", "obs_sigma2", "obs_mask")})
    ba = BA.make_local_ba(cam)
    ref, res = ba(p), ba(q)
    res = res._replace(obs_inlier=res.obs_inlier[torch.argsort(perm)])
    row = chip_smoke.ba_agreement(cam, p, res, ref)
    with capsys.disabled():
        print(f"\nlocal BA, observations reordered: {row}")
    assert row["ok"], row


@pytest.mark.parametrize("rows,obs,tail,padded", [
    (7, 200, (6, 6), 0), (50, 400, (3,), 300), (3, 0, (6, 3), 0), (1, 64, (), 10),
    (4, 20, (2,), 20)])
def test_fixed_order_sums_match_index_add(rng, rows, obs, tail, padded):
    """The slot-grid sums the card runs (``segment_sum``, forced here on the
    CPU) against ``index_add_`` and a float64 sum, and their slot order
    against ``index_add_``'s order of additions, on repeated, missing and
    empty indices, with ``padded`` blocks outside the keep mask at index 0
    weighted zero, as a BA problem pads; the grid stays as wide as the kept
    blocks need."""
    from openvslam_tpu_torch.optimize.segment_sum import segment_sums

    idx = torch.from_numpy(rng.integers(0, rows, obs)).to(torch.int64)
    blocks = torch.from_numpy(rng.standard_normal((obs,) + tail).astype(np.float32))
    keep = torch.ones(obs, dtype=torch.bool)
    idx[obs - padded:], blocks[obs - padded:], keep[obs - padded:] = 0, 0.0, False
    fixed, = segment_sums([(idx, rows, keep)], fixed_order=True)
    plain, = segment_sums([(idx, rows, keep)], fixed_order=False)
    assert fixed.pos is not None and plain.pos is None
    assert fixed.m == max(int(torch.bincount(idx[keep], minlength=rows).max()) if keep.any()
                          else 1, 1)
    got = fixed(blocks)
    want = torch.zeros((rows,) + tail, dtype=torch.float64).index_add_(0, idx, blocks.double())
    assert got.shape == want.shape
    torch.testing.assert_close(got.double(), want, rtol=0, atol=1e-5)
    torch.testing.assert_close(plain(blocks).double(), want, rtol=0, atol=1e-5)
    # the slots hold each row's blocks in block order: added one after
    # another in float32 (as the card's cumsum adds; the CPU's accumulates
    # in float64) they give index_add_'s sums bit for bit
    grid = blocks.new_zeros((rows * fixed.m + 1,) + tail).index_copy_(0, fixed.pos, blocks)
    grid = grid[:-1].view((rows, fixed.m) + tail)
    run = torch.zeros((rows,) + tail)
    for k in range(fixed.m):
        run = run + grid[:, k]
    assert torch.equal(run, plain(blocks))


def test_local_ba_in_fixed_order_matches_index_add(rng, monkeypatch):
    """tests/test_ba.py's noisy problem solved with the card's fixed-order
    sums and with ``index_add_``: the same inliers, poses and points to
    the tolerances that hold the port to JAX (``test_local_ba_matches_jax``)."""
    import functools

    from openvslam_tpu_torch.optimize import segment_sum

    jcam, prob, _, _, _, _ = _build_problem(rng, noise_px=0.5)
    p = BA.BAProblem(*(_t(np.array(a)) for a in prob))
    ref = BA.make_local_ba(_port_cam(jcam))(p)
    monkeypatch.setattr(BA, "segment_sums",
                        functools.partial(segment_sum.segment_sums, fixed_order=True))
    res = BA.make_local_ba(_port_cam(jcam))(p)
    assert torch.equal(res.obs_inlier, ref.obs_inlier)
    torch.testing.assert_close(res.T_cw, ref.T_cw, rtol=0, atol=1e-4)
    lv = p.lm_valid.numpy()
    rel = (np.linalg.norm(res.X.numpy() - ref.X.numpy(), axis=-1)
           / np.maximum(np.linalg.norm(ref.X.numpy(), axis=-1), 1.0))
    assert rel[lv].max() <= 1e-3
