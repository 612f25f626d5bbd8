#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's per-frame tracking step on one GPU.

    python3 chip_smoke.py            # from the repository root, one CUDA card

Phases:
  1. the card (nvidia-smi name and power limit) and the kernels' build;
  2. every hand-written kernel held against its plain PyTorch version on the
     card at the shapes of the main path, on a rendered 640x480 frame, with
     its time (CUDA events), the plain version's time and its bound;
  3. FrameStep at bench.py's kernel working point (640x480, 1024 keypoints,
     8 levels, 4096-landmark local map) over a 40-frame rendered orbit;
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
H100_INT8_OPS_PER_S = 1979e12   # dense int8 tensor-core rate

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

    report = []

    # K1 on all 8 levels of frame 1
    levels = pyramid.build_pyramid(imgs_d[1].to(torch.float32), 8, 1.2)
    k_maps = fast.fast_score_maps_levels(levels, 20.0, 7.0)
    p_maps = [fast.fast_score_maps(im, [20.0, 7.0]) for im in levels]
    torch.cuda.synchronize()
    err1 = max(float((a - b).abs().max()) for kl, pl in zip(k_maps, p_maps) for a, b in zip(kl, pl))
    exact1 = all(torch.equal(a, b) for kl, pl in zip(k_maps, p_maps) for a, b in zip(kl, pl))
    px = sum(im.numel() for im in levels)
    ms1, lo1, hi1 = cuda_ms(lambda: fast.fast_score_maps_levels(levels, 20.0, 7.0), 200)
    pms1 = cuda_ms(lambda: [fast.fast_score_maps(im, [20.0, 7.0]) for im in levels], 10,
                   repeats=1)[0]
    # least ops per pixel (the prefix-sum formulation of ops/fast.py): 16 ring
    # differences; per threshold and polarity 16 subtract + 16 clamp, 24 + 24
    # prefix adds (sums and pass counts, with 24 compares), 16 windows of
    # 2 subtracts + compare + select, 16 maxima
    ops1 = px * (16 + 2 * 2 * (32 + 72 + 64 + 16))
    bytes1 = px * 4 * 3
    report.append(dict(
        name="fast_score_maps", route="cuda", source="openvslam_tpu_torch/csrc/fast.cu",
        replaces="openvslam_tpu/ops/pallas/fast_kernel.py:102", max_abs_err=err1,
        ms=ms1, plain_ms=pms1, ops=ops1, bytes=bytes1, rate=H100_F32_OPS_PER_S,
        library_ms=None, check=f"bit-exact on {len(levels)} levels ({px} px): {exact1}"))
    log(f"K1 fast_score_maps: {px} px, exact={exact1}, max_abs_err={err1}, "
        f"{ms1:.4f} ms [{lo1:.4f}, {hi1:.4f}] (plain {pms1:.3f} ms)")
    if not exact1:
        fail("K1 differs from its plain version")

    # K2 at L=4096 x K=capacity, inputs as FrameStep builds them (frame 1, T_pred = pose 0)
    kp1 = fs.frontend.extract(imgs_d[1])
    und = cam.undistort_keypoints(kp1.xy)
    uv, _, vis = cam.project(se3.transform(poses_d[0], lm_pos_d))
    vis = vis & lm_valid_d
    radius = 7.0 * fs.scale_factors[torch.clamp(lm_lvl_d, 0, 7)]
    margs = (lm_desc_d, kp1.desc_u32, uv, vis, radius, lm_lvl_d, und, kp1.level, kp1.valid)
    exact2 = True
    for ratio, cross in ((0.9, True), (None, True), (0.9, False), (None, False)):
        for md in (M.HAMMING_DIST_THR_HIGH, M.HAMMING_DIST_THR_LOW):
            ik, dk = M.projection_scale_match(*margs, max_dist=md, ratio=ratio, cross_check=cross)
            ip, dp = M.projection_scale_match_plain(*margs, max_dist=md, ratio=ratio,
                                                    cross_check=cross)
            exact2 &= torch.equal(ik, ip) and torch.equal(dk, dp)
    nomatch = M.projection_scale_match(*margs[:3], torch.zeros_like(vis), *margs[4:])[0]
    exact2 &= bool((nomatch == -1).all())
    ik, dk = M.projection_scale_match(*margs, ratio=0.9)
    ip, dp = M.projection_scale_match_plain(*margs, ratio=0.9)
    err2 = float(max((ik - ip).abs().max(), (dk - dp).abs().max()))
    Lm, Km = lm_desc_d.shape[0], kp1.desc_u32.shape[0]
    ms2, lo2, hi2 = cuda_ms(lambda: M.projection_scale_match(*margs, ratio=0.9), 200)
    pms2 = cuda_ms(lambda: M.projection_scale_match_plain(*margs, ratio=0.9), 10, repeats=1)[0]
    ops2 = 2 * Lm * Km * 256                # the Hamming product as int8 MACs
    bytes2 = Lm * (32 + 8 + 4 + 4 + 1 + 8) + Km * (32 + 8 + 8 + 1)
    report.append(dict(
        name="projection_match", route="cuda", source="openvslam_tpu_torch/csrc/match.cu",
        replaces="openvslam_tpu/ops/pallas/match_kernel.py:150", max_abs_err=err2,
        ms=ms2, plain_ms=pms2, ops=ops2, bytes=bytes2, rate=H100_INT8_OPS_PER_S,
        library_ms=None, check=f"idx/dist exact, 4 flag settings x 2 max_dist + all gated: {exact2}"))
    log(f"K2 projection_match: L={Lm} K={Km}, exact={exact2}, matched={int((ik >= 0).sum())}, "
        f"{ms2:.4f} ms [{lo2:.4f}, {hi2:.4f}] (plain {pms2:.3f} ms)")
    if not exact2:
        fail("K2 differs from its plain version")

    # K3 over one observation per keypoint slot (N = 1064 here, TrackStep's shape)
    # and over the 4096 landmark rows (FrameStep's shape)
    kw = dict(fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy, fxb=0.0, chi2_thr=5.991)
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
    err3 = 0.0
    agree3 = 1.0
    for args in (kp_args, lm_args):
        Tk, ink, nk, _ = pose_lm.pose_lm(*args, **kw)
        Tp, inp, npl, _ = pose_lm.pose_lm_plain(*args, **kw)
        err3 = max(err3, float((Tk - Tp).abs().max()))
        agree3 = min(agree3, float((ink == inp).float().mean()))
        log(f"K3 pose_lm N={args[1].shape[0]}: dT={float((Tk - Tp).abs().max()):.3e} "
            f"inliers {int(nk)} vs plain {int(npl)}, agreement {float((ink == inp).float().mean()):.4f}")
    ms3, lo3, hi3 = cuda_ms(lambda: pose_lm.pose_lm(*kp_args, **kw), 50)
    pms3 = cuda_ms(lambda: pose_lm.pose_lm_plain(*kp_args, **kw), 3, warmup=1, repeats=1)[0]
    N3 = Kc
    # per iteration: two evaluations (~110 flops each), 27 normal-equation
    # entries (~8 flops each per observation); 4 rounds x 10 iterations
    ops3 = 40 * N3 * (2 * 110 + 27 * 8)
    bytes3 = N3 * (12 + 12 + 4 + 4 + 4 + 4) + 48 * 2
    report.append(dict(
        name="pose_lm", route="cuda", source="openvslam_tpu_torch/csrc/pose_lm.cu",
        replaces="openvslam_tpu/ops/pallas/pose_lm_kernel.py:285", max_abs_err=err3,
        ms=ms3, plain_ms=pms3, ops=ops3, bytes=bytes3, rate=H100_F32_OPS_PER_S,
        library_ms=None, check=f"T atol 1e-3, inlier agreement >= 0.99: {agree3:.4f}"))
    log(f"K3 pose_lm: N={N3}, max |dT|={err3:.3e}, agreement {agree3:.4f}, "
        f"{ms3:.4f} ms [{lo3:.4f}, {hi3:.4f}] (plain {pms3:.3f} ms)")
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
    for r, key in zip(report, ("fast_score_maps", "projection_match", "pose_lm")):
        bound_ops = r["ops"] / r["rate"] * 1e3
        bound_bytes = r["bytes"] / H100_BYTES_PER_S * 1e3
        kernels_out.append(dict(
            name=r["name"], route=r["route"], source=r["source"], replaces=r["replaces"],
            launches=fs_counts[key] + ts_counts[key],
            launches_framestep=fs_counts[key], launches_trackstep=ts_counts[key],
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=max(bound_ops, bound_bytes),
            bound_by="operations" if bound_ops >= bound_bytes else "bytes",
            library_ms=r["library_ms"], check=r["check"]))
        log(f"kernel {r['name']}: launches FrameStep {fs_counts[key]} TrackStep {ts_counts[key]}; "
            f"max_abs_err {r['max_abs_err']}; {r['ms']:.4f} ms vs plain {r['plain_ms']:.3f} ms; "
            f"bound {kernels_out[-1]['bound_ms']:.5f} ms ({kernels_out[-1]['bound_by']})")
    print(json.dumps({"profile": {"framestep": fs_prof, "trackstep": ts_prof,
                                  "framestep_extract_ms": extract_ms}}), flush=True)
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
