#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's per-frame tracking step on one GPU.

    python3 chip_smoke.py            # from the repository root, one CUDA card

Phases:
  1. the card (nvidia-smi name and power limit) and the kernels' build;
  2. every hand-written kernel held against its plain PyTorch version on the
     card at the shapes of the main path, on a rendered 640x480 frame (K1
     also with a mask, its selection too; K2 also on adversarial inputs),
     with its time (CUDA events) through its wrapper and of its C entry
     alone, the plain version's time and its bound; K2 and K3 at both
     main-path shapes;
  3. FrameStep at bench.py's kernel working point (640x480, 1024 keypoints,
     8 levels, 4096-landmark local map) over a 40-frame rendered orbit,
     with profiles of the step and of its extract alone;
  4. the mono TrackStep at System's working point (1000 keypoints, 4096
     local landmarks), the previous frame's matches as the last-frame table,
     with its first frames re-run on the CPU through the plain versions.
Kernel launch counts are reset just before each main-path run and read just
after it.  Any mismatch, any kernel that the main path did not launch, or
any exception exits non-zero.  The last line is a JSON object with the
device; the line before it is the card's name and power limit; the line
before that lists every kernel with its numbers.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
H100_F32_OPS_PER_S = 67e12      # f32 outside the tensor cores

T0 = time.perf_counter()


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - T0:7.1f}s] {msg}", flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 3, repeats: int = 5):
    """(median, min, max) over ``repeats`` CUDA-event timings of ``reps``
    back-to-back calls, in ms per call."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return float(np.median(times)), min(times), max(times)


def bound(ops: float, ops_per_s: float, nbytes: float):
    """(least ms, "operations" or "bytes"): the larger of the two times."""
    t_ops, t_bytes = ops / ops_per_s * 1e3, nbytes / H100_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def profile_window(step, frames):
    """Run ``step(i)`` for i in frames under torch.profiler; return the
    device time of every CUDA kernel event (ms) summed by kernel name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in frames:
            step(i)
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            ms = e.time_range.elapsed_us() / 1e3
            tot, cnt = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (tot + ms, cnt + 1)
    return by_name


def profile_summary(by_name, n_frames, frame_ms, top=8):
    busy = sum(t for t, _ in by_name.values()) / n_frames
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return dict(device_busy_ms_per_frame=busy, frame_ms=frame_ms,
                device_idle_share=(1.0 - busy / frame_ms) if busy else None,
                kernels_per_frame=sum(c for _, c in by_name.values()) / n_frames,
                top=[dict(name=k[:80], ms_per_frame=t / n_frames, calls_per_frame=c / n_frames)
                     for k, (t, c) in rows])


def build_local_map(fs_or_fe, cam, scene, T0_cw, img0, L, device):
    """bench.py's local map: scene points visible in frame 0 with the
    descriptor of the frame-0 keypoint within 3 px of their projection.
    Returns numpy tables plus the frame-0 keypoint index of each slot."""
    import torch

    kp0 = fs_or_fe.extract(torch.from_numpy(img0).to(device))
    kp_xy = kp0.xy.cpu().numpy()
    kp_valid = kp0.valid.cpu().numpy()
    kp_desc = kp0.desc_u32.cpu().numpy()
    kp_level = kp0.level.cpu().numpy()
    pc0 = (T0_cw[:3, :3] @ scene.points.T).T + T0_cw[:3, 3]
    uv0, _, vis0 = (t.numpy() for t in cam.project(torch.from_numpy(pc0.astype(np.float32))))
    lm_pos = np.zeros((L, 3), np.float32)
    lm_desc = np.zeros((L, 8), np.int32)
    lm_valid = np.zeros(L, bool)
    lm_kp = np.full(L, -1, np.int64)
    n = 0
    for i in np.where(vis0)[0]:
        d = np.linalg.norm(kp_xy - uv0[i], axis=-1)
        d[~kp_valid] = 1e9
        j = int(np.argmin(d))
        if d[j] < 3.0 and n < L:
            lm_pos[n] = scene.points[i]
            lm_desc[n] = kp_desc[j]
            lm_valid[n] = True
            lm_kp[n] = j
            n += 1
    return lm_pos, lm_desc, lm_valid, lm_kp, kp_level, kp_desc, n


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs a GPU", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    try:
        from openvslam_tpu_torch import kernels
    except ImportError as e:
        print(f"chip_smoke: the port package is missing next to this script ({e})",
              file=sys.stderr)
        return 2
    from openvslam_tpu_torch.camera import Perspective
    from openvslam_tpu_torch.models.frame_step import FrameStep
    from openvslam_tpu_torch.models.frontend import OrbFrontend
    from openvslam_tpu_torch.models.track_step import TrackStep, LastFrame, LocalMap
    from openvslam_tpu_torch.ops import fast, match as M, pose_lm, pyramid, se3
    from openvslam_tpu_torch.utils import synthetic

    dev = torch.device("cuda")
    card = card_line()
    # ---------------------------------------------------------------- 1
    log(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}; "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t = time.perf_counter()
    times = kernels.build_all()
    log(f"kernels built in {time.perf_counter() - t:.1f}s "
        f"({', '.join(f'{k} {v:.1f}s' for k, v in times.items())})")
    for name, text in kernels.BUILD_LOG.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas {name}: {line.strip()}")

    # ---------------------------------------------------------------- 2
    cam = Perspective(fx=520.0, fy=520.0, cx=320.0, cy=240.0, cols=640, rows=480, fps=30.0)
    rng = np.random.default_rng(5)
    scene = synthetic.PatchSceneRenderer(rng, n_points=900, center=(0, 0, 6),
                                         extent=(7, 5, 2.5), rows=480, cols=640)
    n_frames = 40
    poses = synthetic.orbit_trajectory(n_frames, radius=2.5, target=(0, 0, 6), arc=np.pi / 4)
    images = [scene.render(cam, poses[i]) for i in range(n_frames)]
    fs = FrameStep(cam, max_keypts=1024, num_levels=8, lm_capacity=4096, device=dev)
    L = fs.lm_capacity
    lm_pos, lm_desc, lm_valid, _, _, _, n_lm = build_local_map(
        fs.frontend, cam, scene, poses[0], images[0], L, dev)
    log(f"FrameStep local map: {n_lm} landmarks of {L}; keypoint capacity {fs.frontend.capacity}")
    lm_pos_d = torch.from_numpy(lm_pos).to(dev)
    lm_desc_d = torch.from_numpy(lm_desc).to(dev)
    lm_valid_d = torch.from_numpy(lm_valid).to(dev)
    lm_lvl_d = torch.full((L,), -1, dtype=torch.int64, device=dev)
    imgs_d = [torch.from_numpy(im).to(dev) for im in images]
    poses_d = [torch.from_numpy(p.astype(np.float32)).to(dev) for p in poses]

    report = {}
    c_fast, c_match, c_lm = (kernels.library(n) for n in ("fast", "match", "pose_lm"))

    # K1 on all 8 levels of frame 1 at FrameStep's budgets, without and with
    # a random mask: the pools and the selection after them against the
    # plain composition
    levels = pyramid.build_pyramid(imgs_d[1].to(torch.float32), 8, 1.2)
    shapes = [tuple(im.shape) for im in levels]
    budgets = fs.frontend.budgets
    keep_px = torch.from_numpy(np.random.default_rng(3).random((480, 640)) > 0.3).to(dev)
    masks1 = [pyramid.resize_nearest(keep_px.to(torch.float32), s) for s in shapes]
    exact1, err1 = True, 0.0
    for tag, ms in (("no mask", None), ("mask", masks1)):
        vk, ik = fast.fast_cell_pools(levels, 20.0, 7.0, budgets, masks=ms)
        vp, ip = fast.fast_cell_pools_plain(levels, 20.0, 7.0, budgets, masks=ms)
        dk = fast.detect_levels(levels, 20.0, 7.0, budgets, masks=ms)
        dp = fast.select_from_pools(vp, ip, shapes, budgets)
        same_pools = torch.equal(vk, vp) and torch.equal(ik, ip)
        same_kp = all(torch.equal(a, b) for x, y in zip(dk, dp) for a, b in zip(x, y))
        exact1 &= same_pools and same_kp
        err1 = max(err1, float(torch.where(vk == vp, 0.0, (vk - vp).abs()).max()),
                   float((ik - ip).abs().max()))
        log(f"K1 {tag}: pools exact {same_pools}, detect_levels exact {same_kp}; "
            f"{int((vk > 0).sum())} corners in the pools, {int(dk[0][2].sum())} kept on level 0")
    px = sum(im.numel() for im in levels)
    ms1, lo1, hi1 = cuda_ms(lambda: fast.fast_cell_pools(levels, 20.0, 7.0, budgets), 200)
    args1, _, keep1 = fast.kernel_args(levels, 20.0, 7.0, budgets)
    ko1 = cuda_ms(lambda: c_fast(*args1), 200)[0]
    pms1 = cuda_ms(lambda: fast.fast_cell_pools_plain(levels, 20.0, 7.0, budgets), 10,
                   repeats=1)[0]
    # least work of the fused stage on this frame: per pixel 100 operations
    # for the lower-threshold pass masks (16 differences, 32 compares, 32 bit
    # inserts, two 10-operation 9-run tests), 8 NMS compares and 2 for the
    # preference; per pixel with a lower-threshold arc 160 (16 sliding arc
    # sums, per threshold and polarity 16 compares and 16 maxima); per cell
    # k_cell rounds of a 1024-wide maximum.  Bytes: every level read once,
    # the pools written once
    arc_px = sum(int((fast.fast_score_maps(im, [7.0])[0] > 0).sum()) for im in levels)
    geo1 = fast.pool_geometry(tuple(shapes), tuple(budgets), 32)
    topk_ops = sum(n * k * 1024 for n, k in zip(geo1.cells, geo1.k_cell))
    b1, by1 = bound(px * 110 + arc_px * 160 + topk_ops, H100_F32_OPS_PER_S,
                    px * 4 + len(levels) * geo1.vmax * (4 + 8))
    report["fast_score_maps"] = dict(
        name="fast_cell_pools", route="cuda", source="openvslam_tpu_torch/csrc/fast.cu",
        replaces="openvslam_tpu/ops/pallas/fast_kernel.py:102", max_abs_err=err1,
        ms=ms1, ms_kernel_only=ko1, plain_ms=pms1, bound_ms=b1, bound_by=by1,
        library_ms=None, arc_pixels=arc_px, pixels=px,
        check=f"pools and detect_levels bit-exact on {len(levels)} levels ({px} px), "
              f"without and with a mask: {exact1}")
    log(f"K1 fast_cell_pools: {px} px, {arc_px} with a lower-threshold arc, {len(levels)} x "
        f"{geo1.vmax} pools; exact={exact1}, max_abs_err={err1}; {ms1:.4f} ms [{lo1:.4f}, "
        f"{hi1:.4f}] through the wrapper, {ko1:.4f} ms kernel alone (plain {pms1:.3f} ms; "
        f"bound {b1:.6f} ms {by1})")
    if not exact1:
        fail("K1 differs from its plain version")

    # K2 at FrameStep's shape, L 4096 x K 1064, as FrameStep builds its inputs
    # (frame 1, T_pred = pose 0), and at TrackStep's motion match, L 1032
    # last-frame rows x K 1032 keypoints at radius 7 px, with the rows built
    # from frame 0 as TrackStep's last-frame table
    kp1 = fs.frontend.extract(imgs_d[1])
    und = cam.undistort_keypoints(kp1.xy)
    uv, _, vis = cam.project(se3.transform(poses_d[0], lm_pos_d))
    vis = vis & lm_valid_d
    radius = 7.0 * fs.scale_factors[torch.clamp(lm_lvl_d, 0, 7)]
    margs = (lm_desc_d, kp1.desc_u32, uv, vis, radius, lm_lvl_d, und, kp1.level, kp1.valid)
    fe_t = OrbFrontend(480, 640, max_keypts=1000, num_levels=8, scale_factor=1.2, device=dev)
    P = fe_t.capacity
    pos0, _, val0, kp_of, lvl0, desc0, _ = build_local_map(fe_t, cam, scene, poses[0], images[0],
                                                           P, dev)
    prev_pos = np.zeros((P, 3), np.float32)
    prev_valid = np.zeros(P, bool)
    prev_pos[kp_of[val0]] = pos0[val0]
    prev_valid[kp_of[val0]] = True
    kp1t = fe_t.extract(imgs_d[1])
    uvt, _, vist = cam.project(se3.transform(poses_d[0], torch.from_numpy(prev_pos).to(dev)))
    vist = vist & torch.from_numpy(prev_valid).to(dev)
    lvl0_d = torch.from_numpy(lvl0).to(dev)
    targs = (torch.where(vist[:, None], torch.from_numpy(desc0).to(dev), 0), kp1t.desc_u32, uvt,
             vist, 7.0 * fs.scale_factors[torch.clamp(lvl0_d, 0, 7)], lvl0_d,
             cam.undistort_keypoints(kp1t.xy), kp1t.level, kp1t.valid)
    image = dict(image_size=(cam.cols, cam.rows))
    exact2, shapes2, matched2 = True, [], {}
    for tag, a2, kw2 in (("L4096xK1064 FrameStep", margs, dict(ratio=0.9)),
                         ("L1032xK1032 TrackStep motion 7px", targs, {})):
        for ratio, cross in ((0.9, True), (None, True), (0.9, False), (None, False)):
            for md in (M.HAMMING_DIST_THR_HIGH, M.HAMMING_DIST_THR_LOW):
                ik, dk = M.projection_scale_match(*a2, max_dist=md, ratio=ratio,
                                                  cross_check=cross, **image)
                ip, dp = M.projection_scale_match_plain(*a2, max_dist=md, ratio=ratio,
                                                        cross_check=cross)
                exact2 &= torch.equal(ik, ip) and torch.equal(dk, dp)
        nomatch = M.projection_scale_match(*a2[:3], torch.zeros_like(a2[3]), *a2[4:], **image)[0]
        exact2 &= bool((nomatch == -1).all())
        ik, dk = M.projection_scale_match(*a2, **kw2, **image)
        ip, dp = M.projection_scale_match_plain(*a2, **kw2)
        err2 = float(max((ik - ip).abs().max(), (dk - dp).abs().max()))
        matched2[tag] = int((ik >= 0).sum())
        ms_w, lo_w, hi_w = cuda_ms(lambda: M.projection_scale_match(*a2, **kw2, **image), 200)
        args2, _, keep2 = M.kernel_args(*a2, **kw2, **image)
        ms_k = cuda_ms(lambda: c_match(*args2), 200)[0]
        pms = cuda_ms(lambda: M.projection_scale_match_plain(*a2, **kw2), 10, repeats=1)[0]
        Lr = a2[0].shape[0]
        # least work: the distances of the pairs the gate passes (8 XOR,
        # 8 popcount, 8 adds each); bytes: every input once, idx and dist once
        gate = M.projection_gate(a2[2], a2[3], a2[6], a2[4]) & a2[8][None, :]
        gate &= (torch.abs(a2[7][None, :] - a2[5][:, None]) <= 1) | (a2[5] < 0)[:, None]
        pairs = int(gate.sum())
        nbytes = sum(t.numel() * t.element_size() for t in a2) + 2 * 4 * Lr
        b2, by2 = bound(pairs * 24, H100_F32_OPS_PER_S, nbytes)
        shapes2.append(dict(shape=tag, ms=ms_w, ms_kernel_only=ms_k, plain_ms=pms, bound_ms=b2,
                            bound_by=by2, gate_pairs=pairs, matched=matched2[tag],
                            max_abs_err=err2))
        log(f"K2 projection_match {tag}: visible rows {int(a2[3].sum())}, gate pairs {pairs}, "
            f"matched {matched2[tag]}, {ms_w:.4f} ms [{lo_w:.4f}, {hi_w:.4f}] through the "
            f"wrapper, {ms_k:.4f} ms kernel alone (plain {pms:.3f} ms; bound {b2:.6f} ms {by2})")
    adv = synthetic.adversarial_match_cases(np.random.default_rng(9))
    for name, a2 in adv.items():
        a2 = [t.to(dev) for t in a2]
        ok_case, n_match = True, 0
        for ratio, cross in ((0.9, True), (None, True), (0.9, False), (None, False)):
            for md in (M.HAMMING_DIST_THR_HIGH, M.HAMMING_DIST_THR_LOW):
                ip, dp = M.projection_scale_match_plain(*a2, max_dist=md, ratio=ratio,
                                                        cross_check=cross)
                n_match += int((ip >= 0).sum())
                ik, dk = M.projection_scale_match(*a2, max_dist=md, ratio=ratio,
                                                  cross_check=cross, **image)
                ok_case &= torch.equal(ik, ip) and torch.equal(dk, dp)
        log(f"K2 adversarial {name}: L={a2[0].shape[0]} K={a2[1].shape[0]}, exact={ok_case}, "
            f"matches over 8 settings {n_match}")
        exact2 &= ok_case and (n_match > 0) == (name != "invisible")
    top2 = shapes2[0]
    report["projection_match"] = dict(
        name="projection_match", route="cuda", source="openvslam_tpu_torch/csrc/match.cu",
        replaces="openvslam_tpu/ops/pallas/match_kernel.py:150",
        max_abs_err=max(r["max_abs_err"] for r in shapes2), ms=top2["ms"],
        ms_kernel_only=top2["ms_kernel_only"], plain_ms=top2["plain_ms"],
        bound_ms=top2["bound_ms"], bound_by=top2["bound_by"], library_ms=None,
        shapes=shapes2,
        check=(f"idx/dist exact at both shapes (4 flag settings x 2 max_dist, all gated) and on "
               f"{len(adv)} adversarial cases: {exact2}"))
    if not exact2:
        fail("K2 differs from its plain version")

    # K3 over one observation per keypoint slot (N = 1064, TrackStep's shape)
    # and over the 4096 landmark rows (FrameStep's shape)
    kw = dict(fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy, fxb=0.0, chi2_thr=5.991)
    ik, _ = M.projection_scale_match(*margs, ratio=0.9, **image)
    kpt = torch.clamp(ik, min=0).to(torch.int64)
    sig = (fs.sigma2[kp1.level])[kpt]
    lm_args = (poses_d[0], lm_pos_d, und[kpt], sig, ik >= 0)
    # a keypoint-indexed problem: each matched keypoint observes its landmark
    Kc = kp1.desc_u32.shape[0]
    X_k = torch.zeros(Kc, 3, device=dev)
    m_k = torch.zeros(Kc, dtype=torch.bool, device=dev)
    rows = torch.nonzero(ik >= 0)[:, 0]
    X_k[ik[rows].long()] = lm_pos_d[rows]
    m_k[ik[rows].long()] = True
    kp_args = (poses_d[0], X_k, und, fs.sigma2[kp1.level], m_k)
    err3, agree3, shapes3 = 0.0, 1.0, []
    for tag, args in (("N1064 TrackStep", kp_args), ("N4096 FrameStep", lm_args)):
        Tk, ink, nk, _ = pose_lm.pose_lm(*args, **kw)
        Tp, inp, npl, _ = pose_lm.pose_lm_plain(*args, **kw)
        dT = float((Tk - Tp).abs().max())
        agree = float((ink == inp).float().mean())
        err3, agree3 = max(err3, dT), min(agree3, agree)
        ms_w, lo_w, hi_w = cuda_ms(lambda: pose_lm.pose_lm(*args, **kw), 50)
        args3, _, keep3 = pose_lm.kernel_args(*args, **kw)
        ms_k = cuda_ms(lambda: c_lm(*args3), 50)[0]
        pms = cuda_ms(lambda: pose_lm.pose_lm_plain(*args, **kw), 3, warmup=1, repeats=1)[0]
        N3, m3 = args[1].shape[0], int(args[4].sum())
        # least work: per pass over the masked rows one evaluation (~110
        # flops) and the 27 normal-equation entries (~8 flops each), 4 rounds
        # x (10 + 1) passes; one evaluation of every row for chi2.  Bytes:
        # every input once, chi2, inliers and the pose once
        ops3 = 44 * m3 * (110 + 27 * 8) + N3 * 110
        nbytes = sum(t.numel() * t.element_size() for t in args) + N3 * 5 + 64 + 8
        b3, by3 = bound(ops3, H100_F32_OPS_PER_S, nbytes)
        shapes3.append(dict(shape=tag, masked=m3, ms=ms_w, ms_kernel_only=ms_k, plain_ms=pms,
                            bound_ms=b3, bound_by=by3, max_abs_err=dT, inlier_agreement=agree))
        log(f"K3 pose_lm {tag} ({m3} masked rows): "
            f"dT={dT:.3e} inliers {int(nk)} vs plain {int(npl)}, agreement {agree:.4f}; "
            f"{ms_w:.4f} ms [{lo_w:.4f}, {hi_w:.4f}] through the wrapper, {ms_k:.4f} ms kernel "
            f"alone (plain {pms:.3f} ms; bound {b3:.6f} ms {by3})")
    top3 = shapes3[0]
    report["pose_lm"] = dict(
        name="pose_lm", route="cuda", source="openvslam_tpu_torch/csrc/pose_lm.cu",
        replaces="openvslam_tpu/ops/pallas/pose_lm_kernel.py:285", max_abs_err=err3,
        ms=top3["ms"], ms_kernel_only=top3["ms_kernel_only"], plain_ms=top3["plain_ms"],
        bound_ms=top3["bound_ms"], bound_by=top3["bound_by"], library_ms=None,
        shapes=shapes3,
        check=f"T atol 1e-3, inlier agreement >= 0.99 at both shapes: {agree3:.4f}")
    if not (err3 <= 1e-3 and agree3 >= 0.99):
        fail("K3 differs from its plain version beyond T atol 1e-3 / 0.99 inlier agreement")

    # ---------------------------------------------------------------- 3
    def fs_step(i, T):
        return fs.step(imgs_d[i], T, lm_pos_d, lm_desc_d, lm_valid_d, lm_lvl_d)

    fs_step(1, poses_d[0])
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t = time.perf_counter()
    results = [fs_step(i, poses_d[i - 1]) for i in range(1, n_frames)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
    fs_counts = kernels.launch_counts()
    inl = [int(r.num_inliers) for r in results]
    terr = [float(np.linalg.norm(
        (-r.T_cw[:3, :3].T @ r.T_cw[:3, 3]).cpu().numpy()
        - (-poses[i][:3, :3].T @ poses[i][:3, 3]))) for i, r in zip(range(1, n_frames), results)]
    reps = 3
    t = time.perf_counter()
    for _ in range(reps):
        for i in range(1, n_frames):
            out = fs_step(i, poses_d[i - 1])
    torch.cuda.synchronize()
    fs_fps = reps * (n_frames - 1) / (time.perf_counter() - t)
    t = time.perf_counter()
    for _ in range(reps):
        for i in range(1, n_frames):
            out = fs.frontend.extract(imgs_d[i])
    torch.cuda.synchronize()
    extract_ms = (time.perf_counter() - t) / (reps * (n_frames - 1)) * 1e3
    fs_prof = profile_summary(profile_window(lambda i: fs_step(i, poses_d[i - 1]), range(1, 11)),
                              10, 1e3 / fs_fps)
    ex_prof = profile_summary(profile_window(lambda i: fs.frontend.extract(imgs_d[i]),
                                             range(1, 11)), 10, extract_ms)
    log(f"extract profile: {ex_prof['kernels_per_frame']:.0f} kernels/frame, device busy "
        f"{ex_prof['device_busy_ms_per_frame']:.3f} ms/frame of {extract_ms:.2f} ms")
    log(f"FrameStep profile: extract alone {extract_ms:.2f} ms of {1e3 / fs_fps:.2f} ms/frame; "
        f"device busy {fs_prof['device_busy_ms_per_frame']:.3f} ms/frame over "
        f"{fs_prof['kernels_per_frame']:.0f} kernels; idle share {fs_prof['device_idle_share']}")
    for row in fs_prof["top"]:
        log(f"  {row['ms_per_frame']:.4f} ms/frame x{row['calls_per_frame']:.0f}  {row['name']}")
    log(f"FrameStep: {n_frames - 1} frames, first pass {dt:.2f}s, steady {fs_fps:.1f} frames/s; "
        f"inliers median {int(np.median(inl))} min {min(inl)}; translation error median "
        f"{np.median(terr):.4f} m max {max(terr):.4f} m; launches {fs_counts}")
    if not all(np.isfinite(r.T_cw.cpu().numpy()).all() for r in results):
        fail("FrameStep produced a non-finite pose")
    # the local map is frame 0's view (bench.py's kernel model), so matches
    # thin out along the orbit; the first frames must track it closely
    if min(inl[:5]) < 50 or max(terr[:5]) > 0.05:
        fail("FrameStep lost track of the rendered orbit")
    if min(fs_counts.values()) == 0:
        fail(f"FrameStep did not launch every kernel: {fs_counts}")
    del out

    # ---------------------------------------------------------------- 4
    rng = np.random.default_rng(11)
    scene2 = synthetic.PatchSceneRenderer(rng, n_points=900, center=(0, 0, 6),
                                          extent=(7, 5, 2.5), rows=480, cols=640)
    n_track = 40
    gt = synthetic.orbit_trajectory(n_track, radius=2.5, target=(0, 0, 6), 
                                      arc=np.pi / 3 * (n_track - 1) / 239)
    imgs2 = [scene2.render(cam, gt[i]) for i in range(n_track)]
    fe_cuda = OrbFrontend(480, 640, max_keypts=1000, num_levels=8, scale_factor=1.2, device=dev)
    ts_cuda = TrackStep(cam, fe_cuda, lm_capacity=4096, device=dev)
    P = ts_cuda.prev_capacity
    Lc = ts_cuda.lm_capacity
    loc_pos, loc_desc, loc_valid, loc_kp, kp0_level, kp0_desc, n_loc = build_local_map(
        fe_cuda, cam, scene2, gt[0], imgs2[0], Lc, dev)
    c0 = -gt[0][:3, :3].T @ gt[0][:3, 3]
    loc_maxd = (np.linalg.norm(loc_pos - c0, axis=-1)
                * 1.2 ** np.where(loc_kp >= 0, kp0_level[np.clip(loc_kp, 0, None)], 0)).astype(np.float32)
    log(f"TrackStep: keypoint capacity {P}, local map {n_loc} of {Lc}")
    imgs2_d = [torch.from_numpy(im).to(dev) for im in imgs2]
    gt_d = [torch.from_numpy(p.astype(np.float32)).to(dev) for p in gt]

    def first_tables():
        prev_pos = np.zeros((P, 3), np.float32)
        prev_valid = np.zeros(P, bool)
        prev_level = kp0_level.copy()
        prev_ident = np.full(P, -1, np.int64)          # local slot of each row
        for n in np.where(loc_valid)[0]:
            prev_pos[loc_kp[n]] = loc_pos[n]
            prev_valid[loc_kp[n]] = True
            prev_ident[loc_kp[n]] = n
        return prev_pos, kp0_desc.copy(), prev_valid, prev_level, prev_ident

    def next_tables(res, prev_pos, prev_ident):
        src = res.kp_src.cpu().numpy()
        inl_k = res.kp_inlier.cpu().numpy()
        ident = np.where(src >= P, src - P, np.where(src >= 0, prev_ident[np.clip(src, 0, P - 1)], -1))
        ident = np.where(inl_k, ident, -1)
        pos = np.where((ident >= 0)[:, None], loc_pos[np.clip(ident, 0, None)], 0.0).astype(np.float32)
        return (pos, res.kp_desc_u32.cpu().numpy(), ident >= 0,
                res.kp_level.cpu().numpy(), ident)

    def tables_to(device, prev_pos, prev_desc, prev_valid, prev_level, prev_ident):
        slot = np.full(Lc, -1, np.int64)
        rows_ = np.where(prev_ident >= 0)[0]
        slot[prev_ident[rows_]] = rows_
        last = LastFrame(torch.from_numpy(prev_pos).to(device),
                         torch.from_numpy(prev_desc).to(device),
                         torch.from_numpy(prev_valid).to(device),
                         torch.from_numpy(prev_level).to(device))
        local = LocalMap(torch.from_numpy(loc_pos).to(device), torch.from_numpy(loc_desc).to(device),
                         torch.from_numpy(loc_valid).to(device), torch.from_numpy(loc_maxd).to(device),
                         torch.from_numpy(slot).to(device))
        return last, local

    def run_track(ts, device, frames):
        tabs = first_tables()
        T = gt[0].astype(np.float32)
        out = []
        for i in frames:
            last, local = tables_to(device, *tabs)
            res = ts.step(torch.from_numpy(imgs2[i]).to(device), None,
                          torch.from_numpy(T).to(device), last, local)
            out.append(res)
            T = res.T_cw.cpu().numpy()
            tabs = next_tables(res, tabs[0], tabs[4])
        return out

    run_track(ts_cuda, dev, range(1, 3))            # warm-up
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t = time.perf_counter()
    tr = run_track(ts_cuda, dev, range(1, n_track))
    torch.cuda.synchronize()
    ts_time = time.perf_counter() - t
    ts_counts = kernels.launch_counts()
    terr2 = [float(np.linalg.norm((-r.T_cw[:3, :3].T @ r.T_cw[:3, 3]).cpu().numpy()
                                  - (-gt[i][:3, :3].T @ gt[i][:3, 3])))
             for i, r in zip(range(1, n_track), tr)]
    inl2 = [int(r.num_inliers) for r in tr]
    ts_fps = (n_track - 1) / ts_time
    tabs_1 = tables_to(dev, *first_tables())
    ts_prof = profile_summary(profile_window(
        lambda i: ts_cuda.step(imgs2_d[i], None, gt_d[i - 1], *tabs_1), range(1, 11)),
        10, 1e3 / ts_fps)
    log(f"TrackStep profile: device busy {ts_prof['device_busy_ms_per_frame']:.3f} ms/frame over "
        f"{ts_prof['kernels_per_frame']:.0f} kernels; idle share {ts_prof['device_idle_share']}")
    for row in ts_prof["top"]:
        log(f"  {row['ms_per_frame']:.4f} ms/frame x{row['calls_per_frame']:.0f}  {row['name']}")
    log(f"TrackStep mono: {n_track - 1} frames at {ts_fps:.1f} frames/s (host table "
        f"rebuild included); inliers median {int(np.median(inl2))} min {min(inl2)}; translation "
        f"error median {np.median(terr2):.4f} m max {max(terr2):.4f} m; launches {ts_counts}")
    if min(ts_counts.values()) == 0:
        fail(f"TrackStep did not launch every kernel: {ts_counts}")
    if min(inl2) < 20 or max(terr2) > 0.1:
        fail("TrackStep lost track of the rendered orbit")

    # the first frames again on the CPU through the plain versions
    fe_cpu = OrbFrontend(480, 640, max_keypts=1000, num_levels=8, scale_factor=1.2, device="cpu")
    ts_cpu = TrackStep(cam, fe_cpu, lm_capacity=4096, device="cpu")
    n_cmp = 3
    trc = run_track(ts_cpu, torch.device("cpu"), range(1, 1 + n_cmp))
    for i, (g, c) in enumerate(zip(tr[:n_cmp], trc)):
        same_kp = all(torch.equal(getattr(g, f).cpu(), getattr(c, f))
                      for f in ("kp_xy", "kp_level", "kp_valid", "kp_response"))
        src_agree = float((g.kp_src.cpu() == c.kp_src).float().mean())
        dT = float((g.T_cw.cpu() - c.T_cw).abs().max())
        ni, nc = int(g.num_inliers), int(c.num_inliers)
        log(f"TrackStep frame {i + 1} GPU vs CPU: keypoints identical {same_kp}, kp_src agreement "
            f"{src_agree:.4f}, |dT| {dT:.2e}, inliers {ni} vs {nc}")
        if not (same_kp and src_agree >= 0.99 and dT <= 1e-3 and abs(ni - nc) <= 0.02 * max(nc, 1)):
            fail("TrackStep on the GPU disagrees with the plain CPU path")

    # ---------------------------------------------------------------- out
    kernels_out = []
    for key, r in report.items():
        kernels_out.append(dict(
            r, launches=fs_counts[key] + ts_counts[key], launches_framestep=fs_counts[key],
            launches_trackstep=ts_counts[key]))
        log(f"kernel {r['name']}: launches FrameStep {fs_counts[key]} TrackStep {ts_counts[key]}; "
            f"max_abs_err {r['max_abs_err']}; {r['ms']:.4f} ms ({r['ms_kernel_only']:.4f} ms "
            f"kernel alone) vs plain {r['plain_ms']:.3f} ms; bound {r['bound_ms']:.6f} ms "
            f"({r['bound_by']})")
    print(json.dumps({"profile": {"framestep": fs_prof, "trackstep": ts_prof,
                                  "framestep_extract_ms": extract_ms, "extract": ex_prof}}),
          flush=True)
    summary = dict(framestep_fps=fs_fps, framestep_inliers_median=float(np.median(inl)),
                   framestep_terr_median_m=float(np.median(terr)),
                   trackstep_fps=ts_fps, trackstep_inliers_median=float(np.median(inl2)),
                   trackstep_terr_median_m=float(np.median(terr2)),
                   trackstep_terr_max_m=float(max(terr2)), seconds=time.perf_counter() - T0)
    print(json.dumps({"summary": summary}), flush=True)
    print(json.dumps({"kernels": kernels_out}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
