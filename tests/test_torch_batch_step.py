"""The port's batched tracking step against its single-stream step and
against the JAX package's ``BatchFrameStep``.

* The batched plain versions of K1, K2 and K3 (each problem in turn)
  equal the single plain calls exactly, and the batched detection of one
  level equals the JAX package's ``detect_level_batch``.
* ``OrbFrontend.extract_batch`` equals ``extract`` frame by frame exactly,
  and the JAX package's ``extract_batch`` fed the same pyramid levels
  (the port's own pyramid residue is stated by test_torch_frontend.py):
  keypoints identical, angles within 1e-5 rad, descriptor bits >= 99.9 %.
* ``BatchFrameStep`` equals the port's ``FrameStep`` stream by stream
  exactly, and the JAX package's ``BatchFrameStep`` at the tolerances of
  the port's FrameStep parity (test_torch_steps.py): keypoints identical,
  lm_kpt_idx equal on >= 99 %, T_cw within atol 1e-3, num_inliers
  within 2 %.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from openvslam_tpu.camera import Perspective as JaxPerspective
from openvslam_tpu.camera.base import camera_to_config as jax_camera_to_config
from openvslam_tpu.models.batch_step import BatchFrameStep as JaxBatchFrameStep
from openvslam_tpu.models.frontend import OrbFrontend as JaxFrontend
from openvslam_tpu.ops import fast as jfast
from openvslam_tpu.ops import pyramid as jpyr
from openvslam_tpu_torch import convert, kernels
from openvslam_tpu_torch.models.batch_step import BatchFrameStep
from openvslam_tpu_torch.models.frame_step import FrameStep
from openvslam_tpu_torch.ops import fast, match as M, pose_lm, pyramid
from openvslam_tpu_torch.ops.orb import unpack_bits_i8
from openvslam_tpu_torch.utils import synthetic

H, W, LEVELS, KPTS, LCAP = 240, 320, 3, 300, 256


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax_pyramid():
    """build_pyramid replaced by the JAX package's levels: a frame's
    ``build_pyramid``, and for a batch the batched resize of JAX's
    ``_extract_batch_impl``."""
    jitted = {}

    def build(img, num_levels, scale):
        key = (tuple(img.shape), num_levels, scale)
        if key not in jitted:
            if img.ndim == 2:
                fn = lambda x: jpyr.build_pyramid(x, num_levels, scale)   # noqa: E731
            else:
                def fn(x):
                    shapes = jpyr.level_shapes(x.shape[1], x.shape[2], num_levels, scale)
                    levels = [x]
                    for hl, wl in shapes[1:]:
                        levels.append(jpyr.quantize_u8_grid(jax.image.resize(
                            levels[-1], (x.shape[0], hl, wl), method="linear", antialias=True,
                            precision=jax.lax.Precision.HIGHEST)))
                    return levels
            jitted[key] = jax.jit(fn)
        return [_t(a).to(img.device) for a in jitted[key](jnp.asarray(img.cpu().numpy()))]

    return build


@pytest.fixture(scope="module")
def world():
    jcam = JaxPerspective.create(fx=350.0, fy=350.0, cx=160.0, cy=120.0, cols=W, rows=H,
                                 fps=30.0)
    cam = convert.camera_from_config(jax_camera_to_config(jcam))
    scene = synthetic.PatchSceneRenderer(np.random.default_rng(9), n_points=300,
                                         center=(0, 0, 6), extent=(4, 3, 2), rows=H, cols=W)
    poses = synthetic.orbit_trajectory(3, radius=2.0, target=(0, 0, 6), arc=np.pi / 8)
    imgs = np.stack([scene.render(cam, p) for p in poses])
    return dict(jcam=jcam, cam=cam, scene=scene, poses=poses, imgs=imgs)


def _local_map(fe, cam, scene, T0, img0):
    """test_batch_step.py's local map: scene points visible in frame 0 with
    the descriptor of the frame-0 keypoint within 3 px of their projection."""
    kp0 = fe.extract(torch.from_numpy(img0))
    kxy, kval = kp0.xy.numpy(), kp0.valid.numpy()
    pc0 = (T0[:3, :3] @ scene.points.T).T + T0[:3, 3]
    uv0, _, vis0 = (t.numpy() for t in cam.project(torch.from_numpy(pc0.astype(np.float32))))
    pos = np.zeros((LCAP, 3), np.float32)
    desc = np.zeros((LCAP, 8), np.int32)
    valid = np.zeros(LCAP, bool)
    n = 0
    for i in np.where(vis0)[0]:
        d = np.linalg.norm(kxy - uv0[i], axis=-1)
        d[~kval] = 1e9
        j = int(np.argmin(d))
        if d[j] < 3.0 and n < LCAP:
            pos[n], desc[n], valid[n] = scene.points[i], kp0.desc_u32[j].numpy(), True
            n += 1
    assert n > 15
    return pos, desc, valid


def _stack(a, B):
    return torch.from_numpy(np.broadcast_to(a, (B,) + a.shape).copy())


@pytest.mark.parametrize("masked", [False, True])
def test_batched_plain_k1_equals_single(rng, masked):
    shapes = pyramid.level_shapes(93, 128, 3, 1.2)
    budgets = [64, 48, 32]
    B = 3
    levels = [_t(rng.integers(0, 256, (B,) + s).astype(np.float32)) for s in shapes]
    masks = ([_t((rng.random((B,) + s) > 0.3).astype(np.float32)) for s in shapes]
             if masked else None)
    before = kernels.launch_counts()
    vb, ib = fast.fast_cell_pools(levels, 20.0, 7.0, budgets, masks=masks)
    db = fast.detect_levels(levels, 20.0, 7.0, budgets, masks=masks)
    for b in range(B):
        ms = None if masks is None else [m[b] for m in masks]
        v1, i1 = fast.fast_cell_pools_plain([im[b] for im in levels], 20.0, 7.0, budgets,
                                            masks=ms)
        assert torch.equal(vb[b], v1) and torch.equal(ib[b], i1)
        d1 = fast.detect_levels([im[b] for im in levels], 20.0, 7.0, budgets, masks=ms)
        for x, y in zip(d1, db):
            for u, v in zip(x, y):
                assert torch.equal(u, v[b])
    assert kernels.launch_counts() == before


def test_detect_level_batch_matches_jax(rng):
    imgs = rng.integers(0, 255, (3, 93, 128)).astype(np.float32)
    jx, jr, jv = jfast.detect_level_batch(jnp.asarray(imgs), 20.0, 7.0, 64)
    x, r, v = fast.detect_level_batch(_t(imgs), 20.0, 7.0, 64)
    np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(r.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))


def test_batched_plain_k2_k3_equal_single(rng):
    B, L, K = 3, 64, 96
    a = _t(rng.integers(-2**31, 2**31, (B, L, 8), dtype=np.int64).astype(np.int32))
    b = _t(rng.integers(-2**31, 2**31, (B, K, 8), dtype=np.int64).astype(np.int32))
    b[:, :L] = a ^ _t(rng.integers(0, 2, (B, L, 8)).astype(np.int32))    # near matches
    uv = _t(rng.uniform(0, 320, (B, L, 2)).astype(np.float32))
    bxy = _t(rng.uniform(0, 320, (B, K, 2)).astype(np.float32))
    bxy[:, :L] = uv + _t(rng.normal(0, 2, (B, L, 2)).astype(np.float32))
    ops = (a, b, uv, _t(rng.random((B, L)) > 0.2), _t(rng.uniform(5, 30, (B, L)).astype(
        np.float32)), _t(rng.integers(-1, 3, (B, L))), bxy, _t(rng.integers(0, 3, (B, K))),
        _t(rng.random((B, K)) > 0.1))
    for kw in (dict(ratio=0.9), dict(ratio=None, cross_check=False)):
        ib, db = M.projection_scale_match(*ops, **kw)
        assert int((ib >= 0).sum()) > 20
        for i in range(B):
            i1, d1 = M.projection_scale_match(*(t[i] for t in ops), **kw)
            assert torch.equal(ib[i], i1) and torch.equal(db[i], d1)
    N = 80
    X = _t(rng.uniform(-2, 2, (B, N, 3)).astype(np.float32)) + torch.tensor([0.0, 0.0, 6.0])
    T = torch.eye(4).expand(B, 4, 4).contiguous()
    obs = X[..., :2] / X[..., 2:] * 300.0 + 160.0 + _t(rng.normal(0, 1, (B, N, 2)).astype(
        np.float32))
    args = (T, X, obs.contiguous(), torch.ones(B, N), _t(rng.random((B, N)) > 0.1))
    kw = dict(fx=300.0, fy=300.0, cx=160.0, cy=160.0, fxb=0.0, chi2_thr=5.991)
    out = pose_lm.pose_lm(*args, **kw)
    assert out[0].shape == (B, 4, 4) and out[2].shape == (B,)
    for i in range(B):
        one = pose_lm.pose_lm(*(t[i] for t in args), **kw)
        for x, y in zip(one, out):
            assert torch.equal(x, y[i])


def test_extract_batch_matches_extract(world):
    fs = FrameStep(world["cam"], max_keypts=KPTS, num_levels=LEVELS, lm_capacity=LCAP,
                   device="cpu")
    mask = np.ones((3, H, W), np.float32)
    mask[1, :, : W // 4] = 0.0
    for m in (None, _t(mask)):
        kb = fs.frontend.extract_batch(_t(world["imgs"]), m)
        for i in range(len(world["imgs"])):
            k1 = fs.frontend.extract(_t(world["imgs"][i]), None if m is None else m[i])
            for f in k1._fields:
                assert torch.equal(getattr(k1, f), getattr(kb, f)[i]), f
        assert int(kb.valid.sum()) > 300


def test_extract_batch_matches_jax(world, monkeypatch):
    monkeypatch.setattr(pyramid, "build_pyramid", _jax_pyramid())
    jfe = JaxFrontend(H, W, max_keypts=KPTS, num_levels=LEVELS)
    fs = FrameStep(world["cam"], max_keypts=KPTS, num_levels=LEVELS, lm_capacity=LCAP,
                   device="cpu")
    kj = jfe.extract_batch(jnp.asarray(world["imgs"]))
    kt = fs.frontend.extract_batch(_t(world["imgs"]))
    for f in ("xy", "response", "valid", "level"):
        np.testing.assert_array_equal(getattr(kt, f).numpy(), np.asarray(getattr(kj, f)))
    v = np.asarray(kj.valid)
    assert v.sum() > 300
    np.testing.assert_allclose(kt.angle.numpy()[v], np.asarray(kj.angle)[v], rtol=0, atol=1e-5)
    bits_t = np.unpackbits(kt.desc_u32.numpy().view(np.uint32)[v].view(np.uint8))
    bits_j = np.unpackbits(np.asarray(kj.desc_u32)[v].view(np.uint8))
    assert (bits_t == bits_j).mean() >= 0.999


@pytest.fixture(scope="module")
def batch_inputs(world):
    cam, poses, imgs = world["cam"], world["poses"], world["imgs"]
    fs = FrameStep(cam, max_keypts=KPTS, num_levels=LEVELS, lm_capacity=LCAP, device="cpu")
    pos, desc, valid = _local_map(fs.frontend, cam, world["scene"], poses[0], imgs[0])
    lvl = np.full(LCAP, -1, np.int64)
    T = np.stack([p.astype(np.float32) for p in poses])
    return fs, pos, desc, valid, lvl, T


def test_batch_step_matches_frame_step(world, batch_inputs):
    fs, pos, desc, valid, lvl, T = batch_inputs
    imgs = world["imgs"]
    B = len(imgs)
    bs = BatchFrameStep(world["cam"], max_keypts=KPTS, num_levels=LEVELS, lm_capacity=LCAP,
                        device="cpu")
    before = kernels.launch_counts()
    out = bs.step(_t(imgs), _t(T), _stack(pos, B), _stack(desc, B), _stack(valid, B),
                  _stack(lvl, B))
    assert kernels.launch_counts() == before
    for i in range(B):
        o1 = fs.step(_t(imgs[i]), _t(T[i]), _t(pos), _t(desc), _t(valid), _t(lvl))
        for f in o1._fields:
            assert torch.equal(getattr(o1, f), getattr(out, f)[i]), (i, f)
    assert int(out.num_inliers[0]) > 10


def test_batch_step_matches_jax(world, batch_inputs, monkeypatch):
    _, pos, desc, valid, lvl, T = batch_inputs
    monkeypatch.setattr(pyramid, "build_pyramid", _jax_pyramid())
    imgs = world["imgs"]
    B = len(imgs)
    bs = BatchFrameStep(world["cam"], max_keypts=KPTS, num_levels=LEVELS, lm_capacity=LCAP,
                        device="cpu")
    jbs = JaxBatchFrameStep(world["jcam"], max_keypts=KPTS, num_levels=LEVELS,
                            lm_capacity=LCAP)
    bits = unpack_bits_i8(torch.from_numpy(desc)).numpy()
    rt = bs.step(_t(imgs), _t(T), _stack(pos, B), _stack(desc, B), _stack(valid, B),
                 _stack(lvl, B))
    rj = jbs.step(jnp.asarray(imgs), jnp.asarray(T), jnp.broadcast_to(jnp.asarray(pos), (B,) +
                                                                      pos.shape),
                  jnp.broadcast_to(jnp.asarray(bits), (B,) + bits.shape),
                  jnp.broadcast_to(jnp.asarray(valid), (B, LCAP)),
                  jnp.broadcast_to(jnp.asarray(lvl.astype(np.int32)), (B, LCAP)))
    np.testing.assert_array_equal(rt.kp_xy.numpy(), np.asarray(rj.kp_xy))
    np.testing.assert_array_equal(rt.kp_valid.numpy(), np.asarray(rj.kp_valid))
    for i in range(B):
        assert (rt.lm_kpt_idx[i].numpy() == np.asarray(rj.lm_kpt_idx[i])).mean() >= 0.99
        np.testing.assert_allclose(rt.T_cw[i].numpy(), np.asarray(rj.T_cw[i]), rtol=0,
                                   atol=1e-3)
        n_t, n_j = int(rt.num_inliers[i]), int(rj.num_inliers[i])
        assert abs(n_t - n_j) <= 0.02 * max(n_j, 1), (i, n_t, n_j)
    assert int(rt.num_inliers[0]) > 10
