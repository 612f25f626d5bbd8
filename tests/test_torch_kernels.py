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
atol 1e-3; a map saved and loaded on the card, whose first relocalization
is replayed on the CPU from the same file with the card's RANSAC draws:
the same candidate keyframe, the same stage-1 counts, the pose within
atol 1e-3; the bundle adjustments' fixed-order sums on the card bit for bit
equal to ``index_add_`` on the CPU; a padded local BA problem solved three
times on the card, bit for bit the same, and against the CPU's solve: the
same inliers, T within atol 1e-3; one launch of K1, K2 or K3 over B = 1, 4
and 8 problems bit for bit the B single launches, and BatchFrameStep bit
for bit FrameStep on each stream.
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


def test_loaded_map_relocalizes_as_on_the_cpu(cuda, tmp_path):
    from openvslam_tpu_torch.config import Config
    from openvslam_tpu_torch.module import relocalizer as RL
    from openvslam_tpu_torch.module.tracking_module import TrackerState
    from openvslam_tpu_torch.system import System

    cfg = Config.from_dict({
        "Camera": {"name": "synthetic", "setup": "monocular", "model": "perspective",
                   "fx": 350.0, "fy": 350.0, "cx": 208.0, "cy": 160.0, "cols": 416,
                   "rows": 320, "fps": 20},
        "Feature": {"max_num_keypts": 600, "num_levels": 4, "scale_factor": 1.2},
        "LoopDetector": {"enabled": False}})
    cam = cfg.camera
    scene = synthetic.PlaneSceneRenderer(np.random.default_rng(21), x_range=(-5, 8),
                                         y_range=(-5, 5), plane_z=7.0, rows=cam.rows,
                                         cols=cam.cols)
    poses = [synthetic.lookat_pose_cw((x, 0, 0), (x, 0, 7)) for x in np.linspace(0, 4, 25)]
    s = System(cfg, device=cuda)
    for i, p in enumerate(poses):
        s.feed_monocular_frame(scene.render(cam, p), i / 20.0)
    s.shutdown()
    path = str(tmp_path / "map.msg")
    s.save_map_database(path)

    calls = []
    stage1 = RL.reloc_stage1

    def spy(gen, samples=None, **ops):
        out = stage1(gen, samples=samples, **ops)
        calls.append(out)
        return out

    frame = scene.render(cam, poses[10])
    runs = {}
    draws = []
    sample = RL.ransac.sample_minimal_sets

    def record(*a, **kw):
        draws.append(sample(*a, **kw))
        return draws[-1]

    for d in (cuda, "cpu"):
        sd = System(cfg, device=d)
        sd.load_map_database(path)
        sd.disable_mapping_module()
        sd.tracker.state = TrackerState.LOST
        calls.clear()
        if d == cuda:
            RL.ransac.sample_minimal_sets, RL.reloc_stage1 = record, spy
        else:
            RL.reloc_stage1 = lambda gen, samples=None, **ops: spy(
                gen, samples=draws[0].cpu(), **ops)
        try:
            T = sd.feed_monocular_frame(frame, 100.0)
        finally:
            RL.ransac.sample_minimal_sets, RL.reloc_stage1 = sample, stage1
        assert T is not None and calls, f"no relocalization on {d}"
        _, n_match, _, n_inl = (x.cpu().numpy() for x in calls[0])
        runs[d] = dict(kf=sd.global_optimizer.relocalizer.last_reloc_kf, n_match=n_match,
                       n_inl=n_inl, T=T)
        sd.shutdown()
    g, c = runs[cuda], runs["cpu"]
    assert g["kf"] == c["kf"]
    np.testing.assert_array_equal(g["n_match"], c["n_match"])
    np.testing.assert_array_equal(g["n_inl"], c["n_inl"])
    assert float(np.abs(g["T"] - c["T"]).max()) <= 1e-3


def _ba_problem(rng, C=8, L=300, pad=500):
    """A mono window: C cameras on an arc looking at L points, each point
    seen by every camera in front of which it projects inside the image,
    0.5 px noise, 5 % outliers, camera 0 fixed, ``pad`` padding rows at
    index 0 as the mapper pads."""
    from openvslam_tpu_torch.optimize.ba import BAProblem

    cam = Perspective(fx=300.0, fy=300.0, cx=160.0, cy=120.0, cols=320, rows=240)
    poses = synthetic.orbit_trajectory(C, radius=2.0, target=(0, 0, 6), arc=np.pi / 6)
    X = rng.uniform((-3, -2, 4), (3, 2, 8), (L, 3)).astype(np.float32)
    oc, ol, uv = [], [], []
    for c, T in enumerate(poses):
        pc = X @ T[:3, :3].T + T[:3, 3]
        u = 300.0 * pc[:, 0] / pc[:, 2] + 160.0
        v = 300.0 * pc[:, 1] / pc[:, 2] + 120.0
        ok = (pc[:, 2] > 0.1) & (u >= 0) & (u < 320) & (v >= 0) & (v < 240)
        for lm in np.nonzero(ok)[0]:
            oc.append(c), ol.append(lm), uv.append((u[lm], v[lm]))
    n = len(oc)
    uv = np.asarray(uv, np.float32) + rng.normal(0, 0.5, (n, 2)).astype(np.float32)
    bad = rng.choice(n, n // 20, replace=False)
    uv[bad] += rng.uniform(20, 60, (len(bad), 2)).astype(np.float32)
    O = n + pad
    T_init = np.stack(poses).astype(np.float32)
    T_init[1:, :3, 3] += rng.normal(0, 0.02, (C - 1, 3)).astype(np.float32)
    X_init = X + rng.normal(0, 0.05, X.shape).astype(np.float32)
    def padded(a, dtype):
        out = np.zeros((O,) + np.shape(a)[1:], dtype)
        out[:n] = a
        return torch.from_numpy(out)
    cam_opt = torch.ones(C, dtype=torch.bool)
    cam_opt[0] = False
    prob = BAProblem(torch.from_numpy(T_init), cam_opt, torch.ones(C, dtype=torch.bool),
                     torch.from_numpy(X_init), torch.ones(L, dtype=torch.bool),
                     padded(oc, np.int32), padded(ol, np.int32), padded(uv, np.float32),
                     padded(np.ones(n), np.float32), padded(np.ones(n, bool), bool))
    return cam, prob


@pytest.mark.parametrize("rows,obs,tail", [(24, 11000, (6, 6)), (2000, 11000, (3,)),
                                           (1, 3000, (7, 7))])
def test_fixed_order_sums_equal_cpu_index_add(rng, cuda, rows, obs, tail):
    from openvslam_tpu_torch.optimize.segment_sum import segment_sums

    idx = torch.from_numpy(rng.integers(0, rows, obs)).to(torch.int64)
    blocks = torch.from_numpy(rng.standard_normal((obs,) + tail).astype(np.float32))
    keep = torch.from_numpy(rng.random(obs) < 0.9)
    blocks[~keep] = 0.0
    fixed, = segment_sums([(idx.to(cuda), rows, keep.to(cuda))])
    assert fixed.pos is not None
    want = torch.zeros((rows,) + tail).index_add_(0, idx, blocks)
    assert torch.equal(fixed(blocks.to(cuda)).cpu(), want)


def test_local_ba_repeats_on_the_card(rng, cuda):
    from openvslam_tpu_torch.optimize.ba import make_local_ba

    cam, prob = _ba_problem(rng)
    ba = make_local_ba(cam)
    runs = [ba(prob.to(cuda)) for _ in range(3)]
    for r in runs[1:]:
        for a, b in zip(runs[0], r):
            assert torch.equal(a, b)
    ref = ba(prob)
    got = runs[0]
    assert torch.equal(got.obs_inlier.cpu(), ref.obs_inlier)
    assert int(ref.obs_inlier.sum()) < int(prob.obs_mask.sum())
    assert float((got.T_cw.cpu() - ref.T_cw).abs().max()) <= 1e-3


# ---------------------------------------------------------------------------
# batched launches: one launch over B problems equals B single launches bit
# for bit (the per-problem code of each kernel is the single launch's)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B", [1, 4, 8])
@pytest.mark.parametrize("masked", [False, True])
def test_fast_kernel_batch_equals_single_launches(rng, cuda, B, masked):
    frames = torch.from_numpy(rng.integers(0, 256, (B, 480, 640)).astype(np.float32)).to(cuda)
    levels = pyramid.build_pyramid(frames, 8, 1.2)
    budgets = level_budgets(1024, 8, 1.2)
    masks = ([(torch.rand(tuple(im.shape), device=cuda) > 0.3).to(torch.float32)
              for im in levels] if masked else None)
    before = kernels.launch_counts()["fast_score_maps"]
    vals, idxs = fast.fast_cell_pools(levels, 20.0, 7.0, budgets, masks=masks)
    assert kernels.launch_counts()["fast_score_maps"] == before + 1
    assert vals.shape[:2] == (B, 8)
    for b in range(B):
        one = [im[b].contiguous() for im in levels]
        ms = None if masks is None else [m[b].contiguous() for m in masks]
        v1, i1 = fast.fast_cell_pools(one, 20.0, 7.0, budgets, masks=ms)
        assert torch.equal(vals[b], v1) and torch.equal(idxs[b], i1)
    vp, ip = fast.fast_cell_pools_plain_batch([im.cpu() for im in levels], 20.0, 7.0, budgets,
                                              masks=None if masks is None else
                                              [m.cpu() for m in masks])
    assert torch.equal(vals.cpu(), vp) and torch.equal(idxs.cpu(), ip)


@pytest.mark.parametrize("B", [1, 4, 8])
def test_match_kernel_batch_equals_single_launches(rng, cuda, B):
    probs = [_match_problem(rng, 4096, 1064, cuda) for _ in range(B)]
    ops = [torch.stack(t) for t in zip(*probs)]
    for ratio, cross in ((0.9, True), (None, False)):
        before = kernels.launch_counts()["projection_match"]
        idx, dist = M.projection_scale_match(*ops, ratio=ratio, cross_check=cross)
        assert kernels.launch_counts()["projection_match"] == before + 1
        assert idx.shape == (B, 4096)
        for b, p in enumerate(probs):
            i1, d1 = M.projection_scale_match(*p, ratio=ratio, cross_check=cross)
            assert torch.equal(idx[b], i1) and torch.equal(dist[b], d1)
        assert int((idx >= 0).sum()) > 0


@pytest.mark.parametrize("B", [1, 4, 8])
@pytest.mark.parametrize("stereo,n", [(False, 1064), (True, 1064), (False, 5000)])
def test_pose_lm_kernel_batch_equals_single_launches(rng, cuda, B, stereo, n):
    probs = [_lm_problem(rng, n, stereo, cuda) for _ in range(B)]
    kw = probs[0][2]
    args = [torch.stack(t) for t in zip(*(p[1] for p in probs))]
    before = kernels.launch_counts()["pose_lm"]
    out = pose_lm.pose_lm(*args, **kw)
    assert kernels.launch_counts()["pose_lm"] == before + 1
    assert out[0].shape == (B, 4, 4) and out[2].shape == (B,)
    for b, (_, a, _) in enumerate(probs):
        one = pose_lm.pose_lm(*a, **kw)
        for x, y in zip(one, out):
            assert torch.equal(x, y[b])


def test_batch_step_gpu_equals_frame_step(cuda):
    """BatchFrameStep on the card, stream by stream bit for bit FrameStep."""
    from openvslam_tpu_torch.models.batch_step import BatchFrameStep

    H, W, L, B = 240, 320, 512, 4
    cam = Perspective(fx=260.0, fy=260.0, cx=160.0, cy=120.0, cols=W, rows=H)
    scene = synthetic.PatchSceneRenderer(np.random.default_rng(5), n_points=2000, center=(0, 0, 6),
                                         extent=(7, 5, 2.5), patch=7, rows=H, cols=W)
    poses = synthetic.orbit_trajectory(40, radius=2.5, target=(0, 0, 6), arc=np.pi / 4)
    imgs = torch.from_numpy(np.stack([scene.render(cam, p) for p in poses[:B + 1]])).to(cuda)
    fs = FrameStep(cam, max_keypts=400, num_levels=4, lm_capacity=L, device=cuda)
    bs = BatchFrameStep(cam, max_keypts=400, num_levels=4, lm_capacity=L, device=cuda)
    kp0 = fs.frontend.extract(imgs[0])
    pc0 = (poses[0][:3, :3] @ scene.points.T).T + poses[0][:3, 3]
    uv0, _, vis0 = cam.project(torch.from_numpy(pc0.astype(np.float32)).to(cuda))
    dmin, j = torch.cdist(uv0, kp0.xy).masked_fill(~kp0.valid[None, :], 1e9).min(1)
    rows = torch.nonzero(vis0 & (dmin < 3.0))[:, 0][:L]
    n = rows.shape[0]
    pos = torch.zeros(L, 3, device=cuda)
    desc = torch.zeros(L, 8, dtype=torch.int32, device=cuda)
    pos[:n] = torch.from_numpy(scene.points.astype(np.float32)).to(cuda)[rows]
    desc[:n] = kp0.desc_u32[j[rows]]
    valid = torch.arange(L, device=cuda) < n
    lvl = torch.full((L,), -1, dtype=torch.int64, device=cuda)
    T = torch.from_numpy(poses[:B].astype(np.float32)).to(cuda)
    kernels.reset_launch_counts()
    out = bs.step(imgs[1:], T, pos.expand(B, L, 3), desc.expand(B, L, 8), valid.expand(B, L),
                  lvl.expand(B, L))
    assert kernels.launch_counts() == dict.fromkeys(kernels.LAUNCHES, 1)
    assert kernels.batched_launch_counts() == dict.fromkeys(kernels.LAUNCHES, 1)
    for b in range(B):
        o1 = fs.step(imgs[b + 1], T[b], pos, desc, valid, lvl)
        for f in o1._fields:
            assert torch.equal(getattr(o1, f), getattr(out, f)[b]), (b, f)
    assert int(out.num_inliers.min()) >= 30
