"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card, at the main path's shapes.  Every test here needs a CUDA device
and skips without one (the kernels have no CPU mode).  This file imports no
JAX, so it runs where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py -q

Tolerances: K1's candidate pools and the selection after them bit-exact
(8 levels of noise, a rendered frame, random masks, a level smaller than a
cell, a blank image, thr_hi below thr_lo); K2 matcher idx/dist exact, also on
the adversarial inputs of ``synthetic.adversarial_match_cases`` (keypoints
outside the image, radii beyond it, invisible rows, ragged L, ties); K3
pose LM T within atol 1e-3 and inlier agreement >= 0.99 (block reductions
sum in another order than the plain version) for N from 1 to 8192, mono
and stereo (observations in registers and read from device memory), all
rows masked included; FrameStep on the GPU against the
same step on the CPU: identical keypoints, >= 99 % equal matches, T within
atol 1e-3.
"""
import numpy as np
import pytest
import torch

from openvslam_tpu_torch import kernels
from openvslam_tpu_torch.camera import Perspective
from openvslam_tpu_torch.models.frame_step import FrameStep
from openvslam_tpu_torch.models.frontend import level_budgets
from openvslam_tpu_torch.ops import fast, match as M, pose_lm, pyramid, se3
from openvslam_tpu_torch.ops.orb import pack_bits
from openvslam_tpu_torch.utils import synthetic

pytestmark = pytest.mark.cuda


@pytest.fixture
def rng():
    return np.random.default_rng(7)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels have no CPU mode")
    return torch.device("cuda")


def _k1_case(case, rng):
    """(levels, budgets, masks, thr_hi, thr_lo) of one K1 case, on the CPU."""
    noise = torch.from_numpy(rng.integers(0, 256, (480, 640)).astype(np.float32))
    budgets = level_budgets(1024, 8, 1.2)
    if case == "rendered":
        cam = Perspective(fx=520.0, fy=520.0, cx=320.0, cy=240.0, cols=640, rows=480)
        scene = synthetic.PatchSceneRenderer(np.random.default_rng(5), n_points=900,
                                             center=(0, 0, 6), extent=(7, 5, 2.5),
                                             rows=480, cols=640)
        pose = synthetic.orbit_trajectory(40, radius=2.5, target=(0, 0, 6), arc=np.pi / 4)[1]
        img = torch.from_numpy(scene.render(cam, pose)).to(torch.float32)
        return pyramid.build_pyramid(img, 8, 1.2), budgets, None, 20.0, 7.0
    if case == "small":                      # a level smaller than one 32x32 cell
        levels = [noise[:64, :96].contiguous(), noise[100:120, 200:224].contiguous()]
        return levels, [48, 16], None, 20.0, 7.0
    if case == "blank":
        return [torch.zeros(s) for s in pyramid.level_shapes(480, 640, 8, 1.2)], budgets, None, 20.0, 7.0
    levels = pyramid.build_pyramid(noise, 8, 1.2)
    if case == "mask":
        masks = [torch.from_numpy(rng.random(tuple(im.shape)) > 0.3).to(torch.float32)
                 for im in levels]
        masks[3] = torch.zeros_like(masks[3])
        return levels, budgets, masks, 20.0, 7.0
    return levels, budgets, None, *((7.0, 20.0) if case == "thr_hi_below_lo" else (20.0, 7.0))


@pytest.mark.parametrize("case", ["noise", "rendered", "mask", "small", "blank", "thr_hi_below_lo"])
def test_fast_kernel_equals_plain(rng, cuda, case):
    """K1's pools and the selection after it, bit-exact against the plain
    composition, in one launch over all levels."""
    levels, budgets, masks, thr_hi, thr_lo = _k1_case(case, rng)
    levels = [im.to(cuda) for im in levels]
    masks = None if masks is None else [m.to(cuda) for m in masks]
    before = kernels.launch_counts()["fast_score_maps"]
    vals, idxs = fast.fast_cell_pools(levels, thr_hi, thr_lo, budgets, masks=masks)
    assert kernels.launch_counts()["fast_score_maps"] == before + 1
    p_vals, p_idxs = fast.fast_cell_pools_plain(levels, thr_hi, thr_lo, budgets, masks=masks)
    assert torch.equal(vals, p_vals) and torch.equal(idxs, p_idxs)
    shapes = [im.shape for im in levels]
    got = fast.detect_levels(levels, thr_hi, thr_lo, budgets, masks=masks)
    want = fast.select_from_pools(p_vals, p_idxs, shapes, budgets)
    for g, w in zip(got, want):
        assert all(torch.equal(a, b) for a, b in zip(g, w))
    n_corners = int((vals > 0).sum())
    if case == "blank":                      # zeros at each cell's lowest in-cell indices
        geo = fast.pool_geometry(tuple(tuple(s) for s in shapes), tuple(budgets), 32)
        for l, (n, k) in enumerate(zip(geo.cells, geo.k_cell)):
            assert not bool(vals[l, :n * k].any())
            want_idx = torch.arange(n, device=cuda)[:, None] * 1024 + torch.arange(k, device=cuda)
            assert torch.equal(idxs[l, :n * k], want_idx.reshape(-1))
    else:
        assert n_corners > 0
    if case == "mask":
        assert not bool((vals[3] > 0).any())


def test_fast_kernel_refuses_bad_thresholds(rng, cuda):
    levels = [im.to(cuda) for im in _k1_case("noise", rng)[0]]
    budgets = level_budgets(1024, 8, 1.2)
    for thr in ((20.5, 7.0), (20.0, 6.9), (20.0, -1.0), (256.0, 7.0)):
        with pytest.raises(ValueError, match="integer thresholds"):
            fast.fast_cell_pools(levels, *thr, budgets)
    with pytest.raises(ValueError, match="cells"):
        fast.fast_cell_pools(levels, 20.0, 7.0, budgets, cell=16)


def _match_problem(rng, L, K, device):
    a_desc = rng.integers(0, 2, (L, 256)).astype(np.int8)
    b_desc = rng.integers(0, 2, (K, 256)).astype(np.int8)
    for i in range(0, min(L, K), 3):                 # near-duplicates and ties
        b_desc[i % K] = a_desc[i]
    uv = rng.uniform(0, [640, 480], (L, 2)).astype(np.float32)
    b_xy = rng.uniform(0, [640, 480], (K, 2)).astype(np.float32)
    b_xy[: K // 2] = uv[: K // 2] + rng.normal(0, 5, (K // 2, 2))
    t = [pack_bits(torch.from_numpy(a_desc)), pack_bits(torch.from_numpy(b_desc)),
         torch.from_numpy(uv), torch.from_numpy(rng.random(L) > 0.1),
         torch.from_numpy(rng.uniform(4, 30, L).astype(np.float32)),
         torch.from_numpy(rng.integers(-1, 8, L)), torch.from_numpy(b_xy),
         torch.from_numpy(rng.integers(0, 8, K)), torch.from_numpy(rng.random(K) > 0.1)]
    return [x.to(device) for x in t]


@pytest.mark.parametrize("ratio,cross", [(None, True), (0.9, True), (0.9, False), (None, False)])
def test_match_kernel_equals_plain(rng, cuda, ratio, cross):
    for L, K in ((4096, 1032), (300, 257)):
        args = _match_problem(rng, L, K, cuda)
        for max_dist in (M.HAMMING_DIST_THR_HIGH, M.HAMMING_DIST_THR_LOW):
            before = kernels.launch_counts()["projection_match"]
            ik, dk = M.projection_scale_match(*args, max_dist=max_dist, ratio=ratio, cross_check=cross)
            assert kernels.launch_counts()["projection_match"] == before + 1
            ip, dp = M.projection_scale_match_plain(*args, max_dist=max_dist, ratio=ratio,
                                                    cross_check=cross)
            assert torch.equal(ik, ip) and torch.equal(dk, dp)
            assert int((ik >= 0).sum()) > 0
    args[3] = torch.zeros_like(args[3])               # everything gated out
    assert bool((M.projection_scale_match(*args)[0] == -1).all())


@pytest.mark.parametrize("case", ["outside", "radii", "invisible", "ties"])
def test_match_kernel_adversarial(cuda, case):
    args = [t.to(cuda) for t in
            synthetic.adversarial_match_cases(np.random.default_rng(9))[case]]
    matched = 0
    for ratio, cross in [(None, True), (0.9, True), (0.9, False), (None, False)]:
        for max_dist in (M.HAMMING_DIST_THR_HIGH, M.HAMMING_DIST_THR_LOW):
            ip, dp = M.projection_scale_match_plain(*args, max_dist=max_dist, ratio=ratio,
                                                    cross_check=cross)
            ik, dk = M.projection_scale_match(*args, max_dist=max_dist, ratio=ratio,
                                              cross_check=cross, image_size=(640, 480))
            assert torch.equal(ik, ip) and torch.equal(dk, dp), (ratio, cross, max_dist)
            matched += int((ip >= 0).sum())
    assert (matched == 0) if case == "invisible" else (matched > 0)


def _lm_problem(rng, n, stereo, device, masked=True):
    """A pose problem of n rows as the JAX package's LM tests build it:
    noise 0.5 px, outliers, 10 points behind the camera, 10 % masked."""
    cam = Perspective(fx=500.0, fy=500.0, cx=320.0, cy=240.0, focal_x_baseline=50.0)
    pts = synthetic.landmark_cloud(rng, n, center=(0, 0, 6), extent=(4, 3, 2))
    T_gt = synthetic.lookat_pose_cw((0.3, -0.2, 0.5), (0, 0, 6))
    pc = torch.from_numpy(((T_gt[:3, :3] @ pts.T).T + T_gt[:3, 3]).astype(np.float32))
    uv, depth, _ = cam.project(pc)
    uv = uv.numpy() + rng.standard_normal((n, 2)) * 0.5
    ur = uv[:, 0] - 50.0 / np.maximum(depth.numpy(), 1e-6) if stereo else np.full(n, -1.0)
    if stereo:
        ur[rng.random(n) < 0.3] = -1.0
    obs = np.concatenate([uv, ur[:, None]], 1)
    n_out = min(200, n // 5)
    out = rng.choice(n, n_out, replace=False)
    obs[out, :2] += (rng.random((n_out, 2)) - 0.5) * 100 + 20
    pts[:10] = -pts[:10]                              # behind the camera
    mask = rng.random(n) > 0.1
    xi = torch.tensor([0.03, -0.02, 0.04, 0.1, -0.08, 0.05], dtype=torch.float64)
    T0 = (se3.se3_exp(xi).numpy() @ T_gt).astype(np.float32)
    sig = (1.2 ** rng.integers(0, 4, n)) ** 2
    if not masked:
        mask[:] = False
    args = [torch.from_numpy(np.asarray(a, dt)).to(device) for a, dt in
            ((T0, np.float32), (pts, np.float32), (obs, np.float32), (sig, np.float32), (mask, bool))]
    kw = dict(fx=500.0, fy=500.0, cx=320.0, cy=240.0, fxb=50.0, chi2_thr=7.815 if stereo else 5.991)
    return T_gt, args, kw


@pytest.mark.parametrize("stereo", [False, True])
@pytest.mark.parametrize("n", [1, 31, 1064, 4096, 5000, 8192])
def test_pose_lm_kernel_equals_plain(rng, cuda, stereo, n):
    T_gt, args, kw = _lm_problem(rng, n, stereo, cuda)
    before = kernels.launch_counts()["pose_lm"]
    T_k, inl_k, n_k, c2_k = pose_lm.pose_lm(*args, **kw)
    assert kernels.launch_counts()["pose_lm"] == before + 1
    T_p, inl_p, n_p, c2_p = pose_lm.pose_lm_plain(*args, **kw)
    assert float((T_k - T_p).abs().max()) <= 1e-3
    assert float((inl_k == inl_p).float().mean()) >= 0.99
    assert int(n_k) == int(inl_k.sum()) and T_k.shape == (4, 4) and c2_k.shape == (n,)
    assert not bool(inl_k[~args[4]].any())
    if n >= 1000:
        assert not bool(inl_k[:10].any())
        assert float(np.abs(T_k.cpu().numpy()[:3, 3] - T_gt[:3, 3]).max()) < 2e-2


@pytest.mark.parametrize("stereo", [False, True])
def test_pose_lm_kernel_all_masked(rng, cuda, stereo):
    _, args, kw = _lm_problem(rng, 1064, stereo, cuda, masked=False)
    T_k, inl_k, n_k, c2_k = pose_lm.pose_lm(*args, **kw)
    T_p, _, _, c2_p = pose_lm.pose_lm_plain(*args, **kw)
    assert torch.equal(T_k, args[0]) and torch.equal(T_p, args[0])
    assert int(n_k) == 0 and not bool(inl_k.any())
    # chi2 at the same pose: nvcc contracts the projection into fused
    # multiply-adds, and the residual obs - u (u ~ 300 px) magnifies an ulp
    # of u in an outlier's chi2 (measured on an H100: 2.2e-5 relative)
    torch.testing.assert_close(c2_k, c2_p, rtol=1e-4, atol=1e-5)


def test_pose_lm_kernel_operands(rng, cuda):
    """The kernel reads 2-column observations as mono, sigma2 and a bool
    mask as given, and refuses what it does not read."""
    _, args, kw = _lm_problem(rng, 1064, False, cuda)
    kw["fxb"] = 0.0
    three = pose_lm.pose_lm(*args, **kw)
    args2 = list(args)
    args2[2] = args[2][:, :2].contiguous()
    two = pose_lm.pose_lm(*args2, **kw)
    torch.testing.assert_close(two[0], three[0], rtol=0, atol=1e-5)
    assert torch.equal(two[1], three[1])
    for i, bad in ((4, args[4].float()), (3, args[3].double()), (2, args[2][:, :2])):
        bad_args = list(args)
        bad_args[i] = bad
        with pytest.raises(ValueError):
            pose_lm.pose_lm(*bad_args, **kw)


def test_frame_step_gpu_matches_cpu(cuda):
    H, W, L = 240, 320, 512
    cam = Perspective(fx=260.0, fy=260.0, cx=160.0, cy=120.0, cols=W, rows=H)
    scene = synthetic.PatchSceneRenderer(np.random.default_rng(5), n_points=2000, center=(0, 0, 6),
                                         extent=(7, 5, 2.5), patch=7, rows=H, cols=W)
    poses = synthetic.orbit_trajectory(40, radius=2.5, target=(0, 0, 6), arc=np.pi / 4)
    img0, img1 = (scene.render(cam, p) for p in poses[:2])
    steps = {d: FrameStep(cam, max_keypts=400, num_levels=4, lm_capacity=L, device=d)
             for d in ("cpu", cuda)}
    # local map: scene points within 3 px of a frame-0 keypoint, with its descriptor
    kp0 = steps["cpu"].frontend.extract(torch.from_numpy(img0))
    pc0 = (poses[0][:3, :3] @ scene.points.T).T + poses[0][:3, 3]
    uv0, _, vis0 = cam.project(torch.from_numpy(pc0.astype(np.float32)))
    dmin, j = torch.cdist(uv0, kp0.xy).masked_fill(~kp0.valid[None, :], 1e9).min(1)
    rows = torch.nonzero(vis0 & (dmin < 3.0))[:, 0][:L]
    n = rows.shape[0]
    assert n >= 120
    lm = dict(pos=torch.zeros(L, 3), desc=torch.zeros(L, 8, dtype=torch.int32),
              valid=torch.arange(L) < n)
    lm["pos"][:n] = torch.from_numpy(scene.points.astype(np.float32))[rows]
    lm["desc"][:n] = kp0.desc_u32[j[rows]]
    lvl = torch.full((L,), -1, dtype=torch.int64)
    T_pred = torch.from_numpy(poses[0].astype(np.float32))
    res = {}
    for d, fs in steps.items():
        kernels.reset_launch_counts()
        res[d] = fs.step(torch.from_numpy(img1).to(d), T_pred.to(d), lm["pos"].to(d),
                         lm["desc"].to(d), lm["valid"].to(d), lvl.to(d))
        counts = kernels.launch_counts()
        assert (min(counts.values()) == 1) if d == cuda else (max(counts.values()) == 0), counts
    g, c = res[cuda], res["cpu"]
    assert torch.equal(g.kp_xy.cpu(), c.kp_xy) and torch.equal(g.kp_valid.cpu(), c.kp_valid)
    assert float((g.lm_kpt_idx.cpu() == c.lm_kpt_idx).float().mean()) >= 0.99
    assert float((g.T_cw.cpu() - c.T_cw).abs().max()) <= 1e-3
