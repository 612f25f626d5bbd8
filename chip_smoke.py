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
     with its first frames re-run on the CPU through the plain versions;
  5. the monocular System with synchronous mapping at bench.py's system
     point (640x480, 1000 keypoints, 8 levels; loop detection on, minimum
     continuity 3) over a 240-frame rendered orbit: two-view bootstrap,
     fused and classic tracking, keyframes, triangulation, fusion, local BA,
     keyframe culling and a loop check per keyframe.  Its first bootstrap
     attempt and its first and last local BA problems are captured during
     the run, replayed on the CPU and held against the card's results;
  6. loop closure and relocalization: the System on tests/test_organic_loop.py's
     200-frame lap inside a textured octagon room, rendered at bench.py's
     system point (640x480, 1000 keypoints, 8 levels; minimum continuity 2
     as in the organic test), then 3 blank frames and the view of frame 20
     again.  It must close a loop (Sim3 validation, correction, pose graph,
     global BA), keep the keyframe map within 1.25 times the JAX System's
     keyframe ATE(sim3) at this point, lose track on the blanks and
     relocalize.  The first relocalization's stage 1, the accepted loop's
     Sim3 validation, the pose graph and the global BA of the correction
     are captured by wrapping the functions the modules call, and replayed
     on the CPU;
  5b. bench.py's system point as bench.py runs it: phase 5's frames through
     ``System(cfg, async_mapping=True)`` and ``feed_sequence(depth=3)``
     (mapping, the loop pipeline and the global BA on worker threads, each
     on its own CUDA stream), warm-up 40 frames; phase 5's gates plus no
     pace timeout, no worker exception and a clean shutdown; it reports
     bench.py's wait decomposition and a profiler window over 10 frames;
  6b. phase 6's path over 400 frames (1 degree a frame, each frame rendered
     as it is fed, as tools/loop_point_jax.py feeds the JAX System, which
     closes this lap with async mapping; phase 6's 200 frames it loses)
     through the async System and ``feed_sequence(depth=1)``: the loop must
     be closed by the loop worker, with phase 6's gates (the System settles
     before the blank frames: the mapping queue drained, the loop worker
     idle, the global BA joined), and K2 must launch from the loop worker;
  7. the stereo System at KITTI 00's full width (configs/kitti_stereo_00.yaml:
     1241x376, 2000 keypoints, 8 levels, a 0.537 m baseline; loop detection
     on) over 120 rendered pairs along tests/test_stereo_rgbd_e2e.py's wall:
     synchronously frame by frame (depth bootstrap, dense stereo match,
     depth seeding, stereo local BA), then with async mapping through
     ``feed_sequence(kind="stereo", depth=3)``; the reference test's gates
     (tracked > 0.90, ATE(se3) < 0.08 m), the depth bootstrap and a stereo
     local BA replayed on the CPU, K1, K2 and K3 held against their plain
     versions at the shapes the run gave them;
  7b. the RGB-D System at TUM fr1's width (configs/tum_rgbd_rgbd_fr1.yaml,
     with its distortion) through ``feed_sequence(kind="rgbd", depth=3)``,
     depth maps as TUM stores them (uint16, metres x 5000); the gates of
     test_rgbd_pipelined and the kernels held at its shapes;
  7c. the stereo loop at tests/test_stereo_loop.py's own point (320x240):
     a loop closed with the Sim3 scale locked at 1 and the keyframe
     ATE(se3) within 1.25 times the JAX System's reading there;
  8. the fisheye System at full width: TUM VI's 512x512 equidistant cam0
     (1000 keypoints, 8 levels, loop detection on) over the first 120
     frames of phase 6's room lap, rendered on the card: the bearing-E
     bootstrap, the fused step with K3 on undistorted pixels, the pinhole
     BA edge; the first bootstrap attempt, the last K3 launch and the last
     local BA replayed on the CPU; gated on a pose by frame 15, tracked
     share >= 0.90 and >= the JAX System's - 0.05, ATE(sim3) <= 1.25 x the
     JAX System's reading at this point;
  8b. the equirectangular System at full width: the RICOH THETA S camera of
     OpenVSLAM's equirectangular tutorial (1920x960, 2000 keypoints, 8
     levels) on the same frames, where landmarks behind the camera cross
     the seam: the plain lon/lat pose LM (no K3 on this path, as in the
     JAX package), the equirectangular BA edge; the first bootstrap
     attempt, the first and last LM and one local BA replayed on the CPU,
     a profiler window over 10 frames; phase 8's gates.
Kernel launch counts are reset just before each main-path run and read just
after it.  Any mismatch, any kernel that a main-path run did not launch, or
any exception exits non-zero.  The last line is a JSON object with the
device; the line before it is the card's name and power limit; the line
before that lists every kernel with its numbers and its launches in the
main-path runs (FrameStep, TrackStep, System, loop-and-relocalization,
their async runs, stereo, stereo async, RGB-D, the stereo loop, fisheye
and equirectangular).
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np

H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
H100_F32_OPS_PER_S = 67e12      # f32 outside the tensor cores

T0 = time.perf_counter()

# Phase 6's working point: tests/test_organic_loop.py's octagon room and lap
# at bench.py's system point (640x480, fx = fy = 520, the organic test's
# field of view; 1000 keypoints, 8 levels).  tools/loop_point_jax.py drives
# the JAX System through this same definition.
LOOP_POINT = dict(rows=480, cols=640, keypoints=1000, levels=8, frames=200)
# The JAX System's keyframe ATE(sim3) there (tools/loop_point_jax.py, on the
# CPU): it closes its loop and ends at 0.352 m.  The organic test's 0.2 m
# gate belongs to that test's 320x240 point and does not apply here; the
# port is held to the reference's own reading with a 25 % margin.
LOOP_REF_KF_ATE_M = 0.352
LOOP_ATE_MARGIN = 1.25
# Phase 6b's lap: phase 6's path over 400 frames (1 degree a frame), each
# frame rendered as it is fed, through feed_sequence at depth 1.  The JAX
# System with async mapping closes it at depths 1 and 3
# (tools/loop_point_jax.py --async-mapping --depth D --frames 400) and loses
# phase 6's 200 frames; the port loses this lap at depth 3 (ROADMAP Queue 3).
ASYNC_LOOP_FRAMES = 400
ASYNC_LOOP_DEPTH = 1
# Phase 7c's working point: tests/test_stereo_loop.py's own (the octagon
# room of seed 11 and its 200-frame lap at 320x240, a 0.25 m baseline, 500
# keypoints, 3 levels, loop detection on with minimum continuity 2,
# synchronous mapping).  tools/depth_points_jax.py drives the JAX
# System through this same definition; its keyframe ATE(se3) there is
# STEREO_LOOP_REF_KF_ATE_M, and the port is held to LOOP_ATE_MARGIN times it.
STEREO_LOOP_POINT = dict(rows=240, cols=320, keypoints=500, levels=3, frames=200,
                         baseline=0.25, seed=11)
STEREO_LOOP_REF_KF_ATE_M = 0.3622
# Phases 7 and 7b: frames along tests/test_stereo_rgbd_e2e.py's wall
WALL_FRAMES = 120
# Phases 8 and 8b: the fisheye and the equirectangular camera on phase 6's
# octagon room over the first CAMERA_FRAMES frames of its 200-frame lap,
# synchronous mapping, loop detection on (``fisheye_config_dict``,
# ``equirect_config_dict``, ``camera_scene``).  tools/camera_points_jax.py
# drives the JAX System through these same definitions.
CAMERA_FRAMES = 120
# The JAX System's readings there (tools/camera_points_jax.py 8 and 8b, on
# the CPU): the tracked share after the first pose and the ATE(sim3) of the
# tracked trajectory.  The port is held to the share - 0.05 (and 0.90) and
# to LOOP_ATE_MARGIN times the ATE.  At phase 8's point the ATE depends on
# which RANSAC draws bootstrap the map (JAX read 0.0461-0.1073 m, the port
# on the CPU 0.0406-0.0790 m, over four tracker seeds), so both packages
# run it with the tracker seeded four ways (the JAX tool's ``--key``, the
# port's ``CAMERA_SEEDS``): the reading is the median of the four ATEs and
# the lowest tracked share.
CAMERA_SEEDS = (42, 1, 2, 3)
_FISHEYE_REF_ATES = (0.04614531987502649, 0.06816313912525392, 0.08482819435493366,
                     0.10729472880512635)
FISHEYE_REF = dict(tracked=1.0, ate_sim3_m=float(np.median(_FISHEYE_REF_ATES)),
                   ate_sim3_by_seed=_FISHEYE_REF_ATES)
EQUIRECT_REF = dict(tracked=1.0, ate_sim3_m=0.06897646688797089)


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


def window_summary(prof, wall_s: float, n_frames: int, frame_ms: float):
    """Device activity of a profiler window whose host wall time was
    ``wall_s``: kernels per frame, the summed kernel time per frame, and
    the union of the kernels' intervals per frame (the worker threads'
    streams overlap the tracker's, so the sum can exceed the union).  The
    idle share is 1 - union / ``frame_ms`` (the untraced median frame);
    the window's own idle share is reported too (tracing slows the host)."""
    import torch

    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    union, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            union += b - max(a, end)
            end = b
    busy_sum = sum(b - a for a, b in spans) / 1e3 / n_frames
    busy = union / 1e3 / n_frames
    return dict(kernels_per_frame=len(spans) / n_frames, device_busy_sum_ms_per_frame=busy_sum,
                device_busy_union_ms_per_frame=busy, frame_ms=frame_ms,
                device_idle_share=1.0 - busy / frame_ms,
                window_idle_share=1.0 - union / 1e3 / (wall_s * 1e3))


def system_config():
    """bench.py's system point (``bench.py:60-77``; loop detection on with
    minimum continuity 3)."""
    from openvslam_tpu_torch.config import Config

    return Config.from_dict({
        "Camera": {"name": "bench-mono", "setup": "monocular", "model": "perspective",
                   "fx": 520.0, "fy": 520.0, "cx": 320.0, "cy": 240.0,
                   "cols": 640, "rows": 480, "fps": 20},
        "Feature": {"max_num_keypts": 1000, "num_levels": 8, "scale_factor": 1.2},
        "LoopDetector": {"enabled": True, "min_continuity": 3},
    })


def system_frames(cam, n: int = 240):
    """bench.py's rendered orbit: (frames, ground-truth poses)."""
    from openvslam_tpu_torch.utils import synthetic

    scene = synthetic.PatchSceneRenderer(np.random.default_rng(11), n_points=900,
                                         center=(0, 0, 6), extent=(7, 5, 2.5),
                                         rows=cam.rows, cols=cam.cols)
    gt = synthetic.orbit_trajectory(n, radius=2.5, target=(0, 0, 6), arc=np.pi / 3)
    t = time.perf_counter()
    imgs = [scene.render(cam, gt[i]) for i in range(n)]
    log(f"System: {n} frames rendered in {time.perf_counter() - t:.1f}s")
    return imgs, gt


def trajectory_ate(poses, gt, evaluate) -> float:
    """ATE(sim3) of the tracked frames' centres (inf below 3 tracked)."""
    idx = [i for i, p in enumerate(poses) if p is not None]
    if len(idx) < 3:
        return float("inf")
    ce = np.stack([-poses[i][:3, :3].T @ poses[i][:3, 3] for i in idx])
    cg = np.stack([-gt[i][:3, :3].T @ gt[i][:3, 3] for i in idx])
    return float(evaluate.ate_rmse(ce, cg, align="sim3"))


def settle(s, timeout: float = 300.0) -> float:
    """Wait until the async System's workers are idle: the mapping queue
    drained, the loop worker idle, no global BA running.  Returns the
    seconds waited; fails after ``timeout``."""
    t0 = time.monotonic()
    proxy, go = s._tracker_mapper, s.global_optimizer
    while not (proxy.idle and go.loop_idle and not go.loop_BA_is_running()):
        if time.monotonic() - t0 > timeout:
            fail(f"the async System did not settle within {timeout} s")
            break
        time.sleep(0.02)
    return time.monotonic() - t0


def clean_shutdown(s) -> dict:
    """Shut the async System down and report what the workers left."""
    s.shutdown()
    st = s.stats()
    return dict(mapper_idle=s._tracker_mapper.idle, loop_backlog=st["loop_backlog"],
                loop_worker_alive=s.global_optimizer._loop_thread is not None,
                global_ba_alive=s.loop_BA_is_running(),
                worker_exceptions=st["worker_exceptions"],
                worker_first_exception=st["worker_first_exception"])


def shutdown_ok(row) -> bool:
    return (row["mapper_idle"] and row["loop_backlog"] == 0 and not row["loop_worker_alive"]
            and not row["global_ba_alive"] and row["worker_exceptions"] == 0)


def loop_config_dict() -> dict:
    """Phase 6's configuration (``Config.from_dict`` of either package)."""
    rows, cols = LOOP_POINT["rows"], LOOP_POINT["cols"]
    f = 520.0 * cols / 640
    return {"Camera": {"name": "lap-mono", "setup": "monocular", "model": "perspective",
                       "fx": f, "fy": f, "cx": cols / 2, "cy": rows / 2,
                       "cols": cols, "rows": rows, "fps": 20},
            "Feature": {"max_num_keypts": LOOP_POINT["keypoints"],
                        "num_levels": LOOP_POINT["levels"], "scale_factor": 1.2},
            "LoopDetector": {"enabled": True, "min_continuity": 2}}


def loop_scene(synthetic, cam, frames: int = LOOP_POINT["frames"]):
    """Phase 6's (scene, ground-truth poses) from a ``utils.synthetic``
    module: the port's, or the JAX package's copy of it.  ``frames`` spreads
    the same 200-degree path over that many frames."""
    scene = synthetic.RoomSceneRenderer(np.random.default_rng(7), half=10.0, rows=cam.rows,
                                        cols=cam.cols, n_walls=8)
    return scene, synthetic.lap_trajectory(frames, radius=6.0, laps=200 / 180)


def stereo_loop_config_dict() -> dict:
    """Phase 7c's configuration (``Config.from_dict`` of either package)."""
    p = STEREO_LOOP_POINT
    rows, cols = p["rows"], p["cols"]
    f = 260.0 * cols / 320
    return {"Camera": {"name": "lap-stereo", "setup": "stereo", "model": "perspective",
                       "fx": f, "fy": f, "cx": cols / 2, "cy": rows / 2,
                       "cols": cols, "rows": rows, "fps": 20,
                       "focal_x_baseline": f * p["baseline"], "depth_threshold": 40.0},
            "Feature": {"max_num_keypts": p["keypoints"], "num_levels": p["levels"],
                        "scale_factor": 1.2},
            "LoopDetector": {"enabled": True, "min_continuity": 2}}


def stereo_loop_scene(synthetic, cam):
    """Phase 7c's (scene, ground-truth left poses, left-to-right shift) from
    a ``utils.synthetic`` module: the port's, or the JAX package's copy."""
    p = STEREO_LOOP_POINT
    scene = synthetic.RoomSceneRenderer(np.random.default_rng(p["seed"]), half=10.0,
                                        rows=cam.rows, cols=cam.cols, n_walls=8)
    shift = np.eye(4)
    shift[0, 3] = -p["baseline"]
    return scene, synthetic.lap_trajectory(p["frames"], radius=6.0, laps=200 / 180), shift


def keyframe_ate(db, gt, evaluate, align: str = "sim3") -> float:
    """ATE (``align`` sim3 or se3) of the map's keyframe centres against the
    ground truth of their source frames."""
    ids = db.valid_kf_ids()
    if len(ids) < 3:
        return float("inf")
    ek = np.stack([-db.kf_pose_cw[k][:3, :3].T @ db.kf_pose_cw[k][:3, 3] for k in ids])
    gk = np.stack([-gt[j][:3, :3].T @ gt[j][:3, 3] for j in db.kf_src_frame[ids]])
    return float(evaluate.ate_rmse(ek, gk, align=align))


def check_k1(levels, budgets, masks=(None,), thr=(20.0, 7.0)):
    """K1 on one frame's pyramid ``levels`` against its plain composition,
    once per entry of ``masks`` (None or per-level masks): the candidate
    pools and the keypoints selected from them, bit-exact.  Times the
    wrapper, the C entry alone and the plain version on the first entry,
    and counts the least work of the fused stage on this frame: per pixel
    100 operations for the lower-threshold pass masks (16 differences, 32
    compares, 32 bit inserts, two 10-operation 9-run tests), 8 NMS
    compares and 2 for the preference; per pixel with a lower-threshold
    arc 160 (16 sliding arc sums, per threshold and polarity 16 compares
    and 16 maxima); per cell k_cell rounds of a 1024-wide maximum.  Bytes:
    every level read once, the pools written once."""
    import torch
    from openvslam_tpu_torch import kernels
    from openvslam_tpu_torch.ops import fast

    shapes = [tuple(im.shape) for im in levels]
    exact, err, corners = True, 0.0, 0
    for ms in masks:
        vk, ik = fast.fast_cell_pools(levels, *thr, budgets, masks=ms)
        vp, ip = fast.fast_cell_pools_plain(levels, *thr, budgets, masks=ms)
        dk = fast.detect_levels(levels, *thr, budgets, masks=ms)
        dp = fast.select_from_pools(vp, ip, shapes, budgets)
        exact &= (torch.equal(vk, vp) and torch.equal(ik, ip)
                  and all(torch.equal(a, b) for x, y in zip(dk, dp) for a, b in zip(x, y)))
        err = max(err, float(torch.where(vk == vp, 0.0, (vk - vp).abs()).max()),
                  float((ik - ip).abs().max()))
        corners = max(corners, int((vk > 0).sum()))
    m0 = masks[0]
    ms_w, lo, hi = cuda_ms(lambda: fast.fast_cell_pools(levels, *thr, budgets, masks=m0), 200)
    args, _, keep = fast.kernel_args(levels, *thr, budgets, masks=m0)
    lib = kernels.library("fast")
    ms_k = cuda_ms(lambda: lib(*args), 200)[0]
    pms = cuda_ms(lambda: fast.fast_cell_pools_plain(levels, *thr, budgets, masks=m0), 10,
                  repeats=1)[0]
    px = sum(im.numel() for im in levels)
    arc_px = sum(int((fast.fast_score_maps(im, [thr[1]])[0] > 0).sum()) for im in levels)
    geo = fast.pool_geometry(tuple(shapes), tuple(budgets), 32)
    topk_ops = sum(n * k * 1024 for n, k in zip(geo.cells, geo.k_cell))
    b, by = bound(px * 110 + arc_px * 160 + topk_ops, H100_F32_OPS_PER_S,
                  px * 4 + len(levels) * geo.vmax * (4 + 8))
    return dict(shape=f"{len(levels)} levels {shapes[0][1]}x{shapes[0][0]}", exact=exact,
                max_abs_err=err, ms=ms_w, ms_lo=lo, ms_hi=hi, ms_kernel_only=ms_k, plain_ms=pms,
                bound_ms=b, bound_by=by, pixels=px, arc_pixels=arc_px, pool_width=geo.vmax,
                corners=corners, masks=len(masks))


def check_k2(a2, kw2, image):
    """K2 on the operands ``a2`` of one guided search against its plain
    version: idx and dist exact under the 4 ratio / cross-check settings x
    2 max_dist, and no match when no row is visible; then at ``kw2`` the
    wrapper, the C entry alone and the plain version timed.  Least work:
    the distances of the pairs the gate passes (8 XOR, 8 popcount, 8 adds
    each); bytes: every input once, idx and dist once."""
    import torch
    from openvslam_tpu_torch import kernels
    from openvslam_tpu_torch.ops import match as M

    exact = True
    for ratio, cross in ((0.9, True), (None, True), (0.9, False), (None, False)):
        for md in (M.HAMMING_DIST_THR_HIGH, M.HAMMING_DIST_THR_LOW):
            ik, dk = M.projection_scale_match(*a2, max_dist=md, ratio=ratio, cross_check=cross,
                                              image_size=image)
            ip, dp = M.projection_scale_match_plain(*a2, max_dist=md, ratio=ratio,
                                                    cross_check=cross)
            exact &= torch.equal(ik, ip) and torch.equal(dk, dp)
    nomatch = M.projection_scale_match(*a2[:3], torch.zeros_like(a2[3]), *a2[4:],
                                       image_size=image)[0]
    exact &= bool((nomatch == -1).all())
    ik, dk = M.projection_scale_match(*a2, **kw2, image_size=image)
    ip, dp = M.projection_scale_match_plain(*a2, **kw2)
    err = float(max((ik - ip).abs().max(), (dk - dp).abs().max()))
    ms_w, lo, hi = cuda_ms(lambda: M.projection_scale_match(*a2, **kw2, image_size=image), 200)
    args, _, keep = M.kernel_args(*a2, **kw2, image_size=image)
    lib = kernels.library("match")
    ms_k = cuda_ms(lambda: lib(*args), 200)[0]
    pms = cuda_ms(lambda: M.projection_scale_match_plain(*a2, **kw2), 10, repeats=1)[0]
    gate = M.projection_gate(a2[2], a2[3], a2[6], a2[4]) & a2[8][None, :]
    gate &= (torch.abs(a2[7][None, :] - a2[5][:, None]) <= 1) | (a2[5] < 0)[:, None]
    pairs = int(gate.sum())
    nbytes = sum(t.numel() * t.element_size() for t in a2) + 2 * 4 * a2[0].shape[0]
    b, by = bound(pairs * 24, H100_F32_OPS_PER_S, nbytes)
    return dict(shape=f"L{a2[0].shape[0]}xK{a2[1].shape[0]} on {image[0]}x{image[1]}",
                exact=exact, max_abs_err=err, ms=ms_w, ms_lo=lo, ms_hi=hi, ms_kernel_only=ms_k,
                plain_ms=pms, bound_ms=b, bound_by=by, visible=int(a2[3].sum()),
                gate_pairs=pairs, matched=int((ik >= 0).sum()))


def check_k3(args, kw):
    """K3 on one pose problem ``args`` (T_init, X_w, obs (N,2|3), sigma2,
    mask) against its plain version: the largest pose difference and the
    share of equal inlier flags, with the wrapper, the C entry alone and
    the plain version timed.  Least work: per pass over the masked rows one
    evaluation (~110 flops) and the 27 normal-equation entries (~8 flops
    each), 4 rounds x (10 + 1) passes; one evaluation of every row for
    chi2.  Bytes: every input once, chi2, inliers and the pose once."""
    from openvslam_tpu_torch import kernels
    from openvslam_tpu_torch.ops import pose_lm

    Tk, ink, nk, _ = pose_lm.pose_lm(*args, **kw)
    Tp, inp, npl, _ = pose_lm.pose_lm_plain(*args, **kw)
    dT = float((Tk - Tp).abs().max())
    agree = float((ink == inp).float().mean())
    ms_w, lo, hi = cuda_ms(lambda: pose_lm.pose_lm(*args, **kw), 50)
    kargs, _, keep = pose_lm.kernel_args(*args, **kw)
    lib = kernels.library("pose_lm")
    ms_k = cuda_ms(lambda: lib(*kargs), 50)[0]
    pms = cuda_ms(lambda: pose_lm.pose_lm_plain(*args, **kw), 3, warmup=1, repeats=1)[0]
    N, m = args[1].shape[0], int(args[4].sum())
    ops = 44 * m * (110 + 27 * 8) + N * 110
    nbytes = sum(t.numel() * t.element_size() for t in args) + N * 5 + 64 + 8
    b, by = bound(ops, H100_F32_OPS_PER_S, nbytes)
    return dict(shape=f"N{N} {args[2].shape[1]}-column fxb {kw['fxb']}", masked=m,
                ok=dT <= 1e-3 and agree >= 0.99, max_abs_err=dT, inlier_agreement=agree,
                inliers=[int(nk), int(npl)], ms=ms_w, ms_lo=lo, ms_hi=hi, ms_kernel_only=ms_k,
                plain_ms=pms, bound_ms=b, bound_by=by)


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


def system_phase(dev, n: int = 240, frames=None):
    """Phase 5: the port's System on ``dev`` (the card) at bench.py's system
    point (``system_config``) over ``n`` rendered frames (or ``frames``,
    as ``system_frames`` returns them), fed one by one at 20 fps
    timestamps.  Returns (summary dict, launch counts of the run)."""
    import torch
    from openvslam_tpu_torch import kernels
    from openvslam_tpu_torch.initialize import two_view as TV
    from openvslam_tpu_torch.optimize.ba import BAResult, make_local_ba
    from openvslam_tpu_torch.system import System
    from openvslam_tpu_torch.utils import evaluate

    cfg = system_config()
    cam = cfg.camera
    warm = 40
    imgs, gt = frames if frames is not None else system_frames(cam, n)
    n = len(imgs)
    log("System: synchronous mapping, frame by frame; LoopDetector on, minimum continuity 3")

    # capture the first and last bootstrap attempts (operands, generator
    # state, result) and the first and last local BA problems while the
    # run drives them
    captured = {"init": [], "ba": []}
    attempt = TV.init_attempt

    def spy_attempt(gen, *args, **kw):
        state = gen.get_state()
        out = attempt(gen, *args, **kw)
        captured["init"] = captured["init"][:1] + [dict(state=state, args=args, out=out)]
        return out

    s = System(cfg, device=dev)
    local_ba = s.mapper.local_ba

    def spy_ba(prob, *stop):
        res = local_ba(prob, *stop)
        captured["ba"] = captured["ba"][:1] + [(prob, res)]
        return res

    TV.init_attempt, s.mapper.local_ba = spy_attempt, spy_ba
    s.startup()
    poses, prof_frames, by_name = [], range(120, 130), None
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    kernels.reset_launch_counts()
    t = time.perf_counter()
    try:
        i = 0
        while i < n:
            if cuda and n > prof_frames[-1] and i == prof_frames[0]:
                # a torch.profiler window over ten frames, kept out of the
                # frame-time statistics below (tracing slows the host)
                feed = lambda j: poses.append(s.feed_monocular_frame(imgs[j], j / 20.0))  # noqa: E731
                by_name = profile_window(feed, prof_frames)
                i = prof_frames[-1] + 1
                continue
            poses.append(s.feed_monocular_frame(imgs[i], i / 20.0))
            i += 1
        sync()
    finally:
        TV.init_attempt = attempt
    wall = time.perf_counter() - t
    counts = kernels.launch_counts()
    s.shutdown()
    st = s.stats()

    tracked = np.array([p is not None for p in poses])
    first = int(np.argmax(tracked)) if tracked.any() else -1
    idx = np.where(tracked)[0]
    ate = trajectory_ate(poses, gt, evaluate)
    timed = [j for j in range(warm, n) if not (by_name is not None and j in prof_frames)]
    tt = np.array(s.track_times)[timed] * 1e3
    m = s.mapper
    go = s.global_optimizer
    inserted = max(s.map_db.n_kfs - 2, 1)
    per_frame = {k: v / max(len(idx), 1) for k, v in counts.items()}
    # device time of the traced frames against the untraced median frame
    prof = (profile_summary(by_name, len(prof_frames), float(np.median(tt)))
            if by_name is not None else None)
    out = dict(
        frames=n, first_tracked=first, tracked_share=float(tracked.mean()), ate_sim3_m=ate,
        keyframes=st["num_keyframes"], keyframes_inserted=s.map_db.n_kfs,
        keyframes_culled=m.kfs_culled, landmarks=st["num_landmarks"],
        fused_frames=st["fused_frames"], classic_frames=n - st["fused_frames"],
        track_ms_median_after_40=float(np.median(tt)),
        track_ms_p90_after_40=float(np.percentile(tt, 90)),
        fps_median_after_40=float(1e3 / np.median(tt)), wall_s=wall, wall_fps=n / wall,
        local_ba_runs=m.ba_runs, local_ba_ms_mean=m.ba_wall_s / max(m.ba_runs, 1) * 1e3,
        mapping_ms_per_keyframe=sum(m.phase_s.values()) / inserted * 1e3,
        mapping_phase_ms_per_keyframe={k: v / inserted * 1e3 for k, v in m.phase_s.items()},
        lms_created=m.lms_created, lms_culled=m.lms_culled, overflow=st["overflow"],
        fetch_wait_ms_per_fused_frame=st["fetch_wait_s"] / max(st["fused_frames"], 1) * 1e3,
        launches=counts, launches_per_tracked_frame=per_frame,
        profile_frames_120_129=prof, loop_checks_run=go.loop_checks_run,
        loop_cands_seen=go.loop_cands_seen, loop_validations=go.loop_validations,
        loops_closed=go.num_loops_closed)
    log(f"System: first pose at frame {first}, tracked {tracked.mean():.3f}, ATE(sim3) {ate:.4f} m, "
        f"{st['num_keyframes']} keyframes ({s.map_db.n_kfs} inserted, {m.kfs_culled} culled), "
        f"{st['num_landmarks']} landmarks; fused {st['fused_frames']} classic "
        f"{n - st['fused_frames']}; track ms median {out['track_ms_median_after_40']:.2f} "
        f"p90 {out['track_ms_p90_after_40']:.2f} after frame {warm}; wall {wall:.1f}s; loop "
        f"checks {go.loop_checks_run}, candidates {go.loop_cands_seen}, validations "
        f"{go.loop_validations}, loops closed {go.num_loops_closed}")
    log(f"System mapping: {m.ba_runs} local BA runs at {out['local_ba_ms_mean']:.1f} ms, "
        f"{out['mapping_ms_per_keyframe']:.1f} ms per keyframe "
        f"({', '.join(f'{k} {v:.1f}' for k, v in out['mapping_phase_ms_per_keyframe'].items())}); "
        f"readback {out['fetch_wait_ms_per_fused_frame']:.2f} ms per fused frame; "
        f"overflow {st['overflow']}; launches {counts}")
    if prof is not None:
        log(f"System profile (frames 120-129): device busy {prof['device_busy_ms_per_frame']:.3f} "
            f"ms/frame over {prof['kernels_per_frame']:.0f} kernels; idle share "
            f"{prof['device_idle_share']} of the untraced median frame "
            f"({prof['frame_ms']:.2f} ms)")
        for row in prof["top"]:
            log(f"  {row['ms_per_frame']:.4f} ms/frame x{row['calls_per_frame']:.0f}  {row['name']}")

    # the first and last bootstrap attempts: their draws replayed from the
    # generator's state on the card, each attempt re-solved on the card and
    # on the CPU.  A pose is compared only where a hypothesis has support
    # (an attempt without parallax leaves every count at 0 and T21 arbitrary)
    if not captured["init"]:
        fail("System never attempted the two-view bootstrap")
    out["init_check"] = []
    ok_init = True
    exact = ("num_matches", "use_h", "counts", "good", "m1", "m2", "pmask", "n_inl")
    for tag, cap in zip(("first", "last"), captured["init"]):
        gen = torch.Generator(device=dev)
        gen.set_state(cap["state"])
        pairs = TV.init_pairs(*cap["args"][:12])
        sh, sf = TV.draw_samples(gen, pairs.pmask)
        again = TV.solve_pairs(pairs, sh, sf, cap["args"][12])
        cpu = TV.init_attempt_with_samples(sh.cpu(), sf.cpu(), *(a.cpu() for a in cap["args"]))
        card = cap["out"]
        same = all(torch.equal(getattr(card, f).cpu(), getattr(o, f).cpu())
                   for o in (again, cpu) for f in exact)
        posed = int(card.counts.max()) > 0
        dT21 = float((card.T21.cpu() - cpu.T21).abs().max()) if posed else None
        ok_init &= same and (not posed or dT21 <= 1e-4)
        out["init_check"].append(dict(attempt=tag, num_matches=int(card.num_matches),
                                      counts=card.counts.tolist(), use_h=bool(card.use_h),
                                      exact_fields_equal=same, T21_max_abs_diff=dT21,
                                      tolerance=1e-4))
        log(f"System bootstrap replay ({tag} attempt): card {card.counts.tolist()} vs CPU "
            f"{cpu.counts.tolist()}, {int(card.num_matches)} matches, counts/masks equal {same}, "
            f"|dT21| {dT21}")
    # the first and last local BA problems re-solved on the CPU
    ba_cpu = make_local_ba(cam, m.BA_FIRST_ITERS, m.BA_SECOND_ITERS)
    out["ba_check"] = []
    ok_ba = bool(captured["ba"])
    for tag, (prob, res) in zip(("first", "last"), captured["ba"]):
        row = ba_agreement(cam, prob.to("cpu"), BAResult(*(t.cpu() for t in res)),
                           ba_cpu(prob.to("cpu")))
        ok_ba &= row["ok"]
        out["ba_check"].append(dict(problem=tag, **row))
        log(f"System local BA ({tag}) card vs CPU: {row}")

    if first < 0 or first > 15:
        fail(f"System: no pose by frame 15 (first {first})")
    if tracked.mean() < 0.90:
        fail(f"System: tracked share {tracked.mean():.3f} below 0.90")
    if not ate <= 0.05:
        fail(f"System: ATE(sim3) {ate:.4f} m above 0.05 m")
    if min(counts.values()) == 0:
        fail(f"System did not launch every kernel: {counts}")
    if not ok_init:
        fail("System: the card's bootstrap attempt disagrees with the CPU's")
    if not ok_ba:
        fail("System: the card's local BA disagrees with the CPU's")
    return out, counts


class LapRender:
    """Phase 6's path over ``frames`` frames as a sequence whose items are
    rendered when they are read: fed to the System, each frame is rendered
    on the feeding thread just before it is tracked, as
    ``tools/loop_point_jax.py`` feeds the JAX System."""

    def __init__(self, cam, frames: int):
        from openvslam_tpu_torch.utils import synthetic

        self.cam = cam
        self.scene, self.gt = loop_scene(synthetic, cam, frames)

    def __len__(self) -> int:
        return len(self.gt)

    def __getitem__(self, i: int) -> np.ndarray:
        return self.scene.render(self.cam, self.gt[i])


def loop_frames(cam, frames: int = LOOP_POINT["frames"], dev=None):
    """A rendered lap (phase 6's, or the same path over ``frames`` frames):
    (frames, the view of the frame 20 degrees in, ground truth).  With
    ``dev`` the frames are rendered there (``camera_frames``: numpy's frame
    0 held within 1 gray level), else in numpy on the host."""
    lap = LapRender(cam, frames)
    t = time.perf_counter()
    if dev is None:
        imgs = [lap[i] for i in range(frames)]
    else:
        imgs, render = camera_frames(dev, cam, lap.scene, lap.gt)
        if not render["frame0_within_1_gray"] >= 0.999:
            fail(f"Loop: the card's rendering differs from numpy's: {render}")
    log(f"Loop: {frames} lap frames rendered in {time.perf_counter() - t:.1f}s "
        f"({cam.cols}x{cam.rows}{'' if dev is None else ' on ' + str(dev)})")
    return imgs, imgs[revisit_index(frames)], lap.gt


def revisit_index(frames: int) -> int:
    """The lap frame whose view the relocalization attempts show again: 20
    degrees in, frame 20 of phase 6's lap."""
    return 20 * frames // LOOP_POINT["frames"]


def loop_phase(dev, frames=None):
    """Phase 6: the System on ``dev`` over the lap at ``LOOP_POINT`` (or
    ``frames``, as ``loop_frames`` returns them), loop detection on with
    minimum continuity 2; then 3 blank frames and the rendering of frame 20
    for up to 3 attempts.  Returns (summary dict, launch counts of the
    run)."""
    import torch
    from openvslam_tpu_torch import kernels
    from openvslam_tpu_torch.config import Config
    from openvslam_tpu_torch.module import global_optimization_module as GO
    from openvslam_tpu_torch.module import relocalizer as RL
    from openvslam_tpu_torch.module.loop_detector import LoopDetector
    from openvslam_tpu_torch.module.tracking_module import TrackerState
    from openvslam_tpu_torch.ops import ransac
    from openvslam_tpu_torch.optimize.ba import make_global_ba
    from openvslam_tpu_torch.optimize.pose_graph import make_pose_graph_optimizer
    from openvslam_tpu_torch.system import System
    from openvslam_tpu_torch.utils import evaluate

    cfg = Config.from_dict(loop_config_dict())
    cam = cfg.camera
    rows, cols = cam.rows, cam.cols
    imgs, revisit, gt = frames if frames is not None else loop_frames(cam)
    n = len(imgs)

    s = System(cfg, device=dev)
    go = s.global_optimizer
    ld = go.loop_detector
    # while the run drives them, capture every RANSAC draw, every
    # relocalization stage 1 and Sim3 validation (operands and outcome), and
    # the pose graph and global BA of each correction, by wrapping the
    # functions the modules call
    cap = {"draws": [], "reloc": [], "validate": [], "pose_graph": [], "global_ba": []}
    draw, stage1, validate = ransac.sample_minimal_sets, RL.reloc_stage1, ld.validate_snapshot
    sim3_opt, pose_graph_opt, global_ba = ld.sim3_opt, go.pose_graph_opt, go.global_ba

    def spy_draw(*a, **kw):
        cap["draws"].append(draw(*a, **kw))
        return cap["draws"][-1]

    def spy_stage1(gen, samples=None, **ops):
        n0 = len(cap["draws"])
        out = stage1(gen, samples=samples, **ops)
        cap["reloc"].append(dict(ops=ops, samples=cap["draws"][n0], out=out))
        return out

    def spy_validate(snap, min_inliers=20, samples=None):
        n0, cap["sim3"] = len(cap["draws"]), None
        out = validate(snap, min_inliers, samples=samples)
        if len(cap["draws"]) > n0:
            cap["validate"].append(dict(snap=snap, min_inliers=min_inliers,
                                        samples=cap["draws"][n0], sim3=cap["sim3"], out=out))
        return out

    def spy_sim3(*a):
        cap["sim3"] = sim3_opt(*a)
        return cap["sim3"]

    def spy_pose_graph(prob):
        out = pose_graph_opt(prob)
        cap["pose_graph"].append((prob, out))
        return out

    def spy_global_ba(prob):
        res = global_ba(prob)
        cap["global_ba"].append((prob, res))
        return res

    ransac.sample_minimal_sets, RL.reloc_stage1 = spy_draw, spy_stage1
    ld.validate_snapshot, ld.sim3_opt = spy_validate, spy_sim3
    go.pose_graph_opt, go.global_ba = spy_pose_graph, spy_global_ba
    s.startup()
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    poses, attempts, reloc_ms, reloc_pose = [], 0, [], None
    try:
        sync()
        kernels.reset_launch_counts()
        t = time.perf_counter()
        for i in range(n):
            poses.append(s.feed_monocular_frame(imgs[i], i / 20.0))
        sync()
        lap_wall = time.perf_counter() - t
        counts_lap = kernels.launch_counts()
        blank = np.zeros((rows, cols), np.uint8)
        for i in range(3):
            s.feed_monocular_frame(blank, (n + i) / 20.0)
        lost = s.tracker.state == TrackerState.LOST
        for a in range(3):
            sync()
            t = time.perf_counter()
            reloc_pose = s.feed_monocular_frame(revisit, (n + 3 + a) / 20.0)
            sync()
            reloc_ms.append((time.perf_counter() - t) * 1e3)
            attempts += 1
            if reloc_pose is not None:
                break
        sync()
        counts = kernels.launch_counts()
    finally:
        ransac.sample_minimal_sets, RL.reloc_stage1 = draw, stage1
    s.shutdown()
    counts_reloc = {k: counts[k] - counts_lap[k] for k in counts}

    tracked = np.array([p is not None for p in poses])
    first = int(np.argmax(tracked)) if tracked.any() else -1
    share = float(tracked[first:].mean()) if first >= 0 else 0.0
    db = s.map_db
    ids = db.valid_kf_ids()
    kf_ate = keyframe_ate(db, gt, evaluate)
    ate_gate = LOOP_ATE_MARGIN * LOOP_REF_KF_ATE_M
    loop_edge = any(db.loop_edges[int(k)] for k in ids)
    # the System's own current estimate of frame 20 (composed through its
    # reference keyframe, so it carries the loop correction)
    _, comp, comp_mask = s.composed_poses()
    dc = dR = None
    if reloc_pose is not None and comp_mask[20]:
        ref = comp[20]
        dc = float(np.linalg.norm(-reloc_pose[:3, :3].T @ reloc_pose[:3, 3]
                                  + ref[:3, :3].T @ ref[:3, 3]))
        dR = float(np.linalg.norm(reloc_pose[:3, :3] - ref[:3, :3]))
    tm = {k: [x * 1e3 for x in v] for k, v in go.timings.items()}
    events = {"cand": sum(e[0] == "cand" for e in go.loop_events),
              "valid": sum(e[0] == "valid" for e in go.loop_events)}
    out = dict(
        frames=n, size=f"{cols}x{rows}", keypoints=LOOP_POINT["keypoints"],
        levels=LOOP_POINT["levels"], first_tracked=first,
        tracked_share_after_first=share, keyframes=int(len(ids)), landmarks=int(len(db.valid_lm_ids())),
        keyframe_ate_sim3_m=kf_ate, keyframe_ate_gate_m=ate_gate,
        keyframe_ate_jax_m=LOOP_REF_KF_ATE_M, loops_closed=go.num_loops_closed,
        loop_edge=loop_edge, loop_checks_run=go.loop_checks_run,
        loop_cands_seen=go.loop_cands_seen, loop_validations=go.loop_validations,
        loop_events=events,
        loop_check_ms_mean=float(np.mean(tm["check"])) if tm["check"] else None,
        loop_check_ms_max=float(np.max(tm["check"])) if tm["check"] else None,
        validation_ms=tm["validate"], pose_graph_ms=tm["pose_graph"], global_ba_ms=tm["global_ba"],
        lost_after_blanks=lost, reloc_attempts=attempts, reloc_ok=reloc_pose is not None,
        reloc_ms_per_attempt=reloc_ms, reloc_centre_diff=dc, reloc_rot_diff=dR,
        lap_wall_s=lap_wall, lap_track_ms_median=float(np.median(s.track_times[:n]) * 1e3),
        launches_lap=counts_lap, launches_reloc=counts_reloc,
        launches_per_lap_frame={k: v / n for k, v in counts_lap.items()})
    log(f"Loop lap: first pose {first}, tracked {share:.3f}, {len(ids)} keyframes, KF ATE(sim3) "
        f"{kf_ate:.4f} m (gate {ate_gate:.3f} m: {LOOP_ATE_MARGIN} x JAX's {LOOP_REF_KF_ATE_M} m), "
        f"loops closed {go.num_loops_closed} (edge {loop_edge}); checks "
        f"{go.loop_checks_run} at {out['loop_check_ms_mean']} ms mean, candidates "
        f"{go.loop_cands_seen}, validations {go.loop_validations}, events {events}; validation ms "
        f"{[round(x, 1) for x in tm['validate']]}; pose graph ms {tm['pose_graph']}; global BA ms "
        f"{tm['global_ba']}; lap wall {lap_wall:.1f}s; launches {counts_lap}")
    log(f"Loop relocalization: lost after blanks {lost}; {attempts} attempts, ok "
        f"{reloc_pose is not None}, ms {[round(x, 1) for x in reloc_ms]}; centre diff {dc}, "
        f"rotation diff {dR}; launches {counts_reloc}")

    cpu = torch.device("cpu")
    # the first relocalization's stage 1 on the CPU, fed the card's draws
    if not cap["reloc"]:
        fail("Loop: no relocalization reached stage 1")
    r = cap["reloc"][0]
    c_idx, c_nm, c_T, c_ni = (x.numpy() for x in RL.reloc_stage1(
        None, **{k: v.cpu() for k, v in r["ops"].items()}, samples=r["samples"].cpu()))
    g_idx, g_nm, g_T, g_ni = (x.cpu().numpy() for x in r["out"])
    good = g_ni >= 10
    same_s1 = (np.array_equal(c_idx, g_idx) and np.array_equal(c_nm, g_nm)
               and np.array_equal(c_ni, g_ni))
    # reported, not held: each T_est is a minimal 4-point EPnP fit whose
    # float32 Gauss-Newton steps the two backends round differently; stage
    # 2's LM refines it
    dT_s1 = float(np.abs(c_T - g_T)[good].max()) if good.any() else None
    out["reloc_stage1_check"] = dict(candidates=int(len(g_nm)), n_match=g_nm.tolist(),
                                     n_inl=g_ni.tolist(), idx_nmatch_ninl_equal=same_s1,
                                     T_max_abs_diff_where_ninl_ge_10=dT_s1)
    log(f"Loop reloc stage 1 replay: idx/n_match/n_inl equal {same_s1}; n_inl {g_ni.tolist()} vs "
        f"{c_ni.tolist()}; |dT| {dT_s1}")
    # the accepted loop's Sim3 validation on the CPU, fed the card's draws
    acc = [v for v in cap["validate"] if v["out"] is not None]
    ok_val, val_row = False, None
    if acc:
        v = acc[0]
        ld_cpu = LoopDetector(cfg, cam, None, None, device=cpu)
        cpu_sim3, box = ld_cpu.sim3_opt, {}
        ld_cpu.sim3_opt = lambda *a: box.setdefault("res", cpu_sim3(*a))
        cv = ld_cpu.validate_snapshot(v["snap"], v["min_inliers"], samples=v["samples"].cpu())
        n_card = int(v["sim3"].num_inliers)
        n_cpu = int(box["res"].num_inliers) if "res" in box else None
        if cv is not None:
            dRts = [float(np.abs(np.asarray(a, np.float64) - b).max())
                    for a, b in zip(cv[:3], v["out"][:3])]
            same_m = np.array_equal(cv[3], v["out"][3]) and np.array_equal(cv[4], v["out"][4])
            ok_val = same_m and n_cpu == n_card and max(dRts) <= 1e-4
            val_row = dict(kf=v["snap"]["kf"], cand=v["snap"]["cand"], matches=int(len(cv[3])),
                           num_inliers=n_card, num_inliers_cpu=n_cpu, matches_equal=same_m,
                           R_t_s_max_abs_diff=dRts)
        log(f"Loop validation replay: {val_row}")
    out["validation_check"] = val_row
    # the pose graph and the global BA of the first correction on the CPU
    ok_pg = ok_gba = False
    if cap["pose_graph"]:
        prob, res = cap["pose_graph"][0]
        prob = prob.to(cpu)
        row = pose_graph_agreement(prob, res, make_pose_graph_optimizer(iters=20, cg_iters=60)(prob))
        ok_pg = row["ok"]
        out["pose_graph_check"] = row
        log(f"Loop pose graph replay: {row}")
    if cap["global_ba"]:
        prob, res = cap["global_ba"][0]
        prob = prob.to(cpu)
        ref = make_global_ba(cam, iters=GO.GLOBAL_BA_ITERS, cg_iters=GO.GLOBAL_BA_CG_ITERS)(prob)
        row = ba_agreement(cam, prob, type(res)(*(x.cpu() for x in res)), ref, allow_flips=True)
        ok_gba = row["ok"]
        out["global_ba_check"] = row
        log(f"Loop global BA replay: {row}")

    if first < 0 or first >= 15:
        fail(f"Loop: no pose before frame 15 (first {first})")
    if share < 0.90:
        fail(f"Loop: tracked share {share:.3f} below 0.90")
    if go.num_loops_closed < 1 or not loop_edge:
        fail("Loop: no loop closed")
    if not kf_ate <= ate_gate:
        fail(f"Loop: keyframe ATE(sim3) {kf_ate:.4f} m above {ate_gate:.3f} m "
             f"({LOOP_ATE_MARGIN} x the JAX System's {LOOP_REF_KF_ATE_M} m)")
    if not lost:
        fail("Loop: tracking not lost after the blank frames")
    if reloc_pose is None:
        fail("Loop: no relocalization within 3 attempts")
    if dc is None or dc >= 0.15 or dR >= 0.1:
        fail(f"Loop: relocalized pose off the frame-20 estimate (centre {dc}, rotation {dR})")
    if min(counts.values()) == 0:
        fail(f"Loop phase did not launch every kernel: {counts}")
    if not same_s1:
        fail("Loop: relocalization stage 1 on the card disagrees with the CPU's")
    if not ok_val:
        fail("Loop: the accepted Sim3 validation disagrees with the CPU's")
    if not ok_pg:
        fail("Loop: the pose graph on the card disagrees with the CPU's")
    if not ok_gba:
        fail("Loop: the global BA on the card disagrees with the CPU's")
    return out, counts


def async_system_phase(dev, frames, warm: int = 40, prof_frames=range(120, 130)):
    """Phase 5b: bench.py's system point as bench.py runs it
    (``bench.py:79-127``): ``System(cfg, async_mapping=True)`` fed through
    ``feed_sequence(depth=3)`` with phase 5's ``frames``; the wait
    accumulators are reset at frame ``warm``.  A profiler window covers the
    frames yielded at ``prof_frames``, which the frame-time statistics
    leave out.  Returns (summary dict, launch counts of the run)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from openvslam_tpu_torch import kernels
    from openvslam_tpu_torch.system import System
    from openvslam_tpu_torch.utils import evaluate

    cfg = system_config()
    imgs, gt = frames
    n = len(imgs)
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    s = System(cfg, async_mapping=True, device=dev)
    s.startup()
    t_warm = [None]

    def items():
        for i in range(n):
            if i == warm:
                # bench.py resets the wait accumulators where its timed
                # window starts
                s.tracker.fetch_wait_s = 0.0
                s._pace_waits, s._pace_wait_s = 0, 0.0
                t_warm[0] = time.perf_counter()
            yield imgs[i], i / 20.0

    poses, prof, prof_wall = [], None, None
    sync()
    kernels.reset_launch_counts()
    t = time.perf_counter()
    depth = 3                   # bench.py's
    for k, (_, pose) in enumerate(s.feed_sequence(items(), kind="monocular", depth=depth)):
        poses.append(pose)
        if cuda and n > prof_frames[-1] and k == prof_frames[0] - 1:
            sync()
            prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            prof.__enter__()
            t_prof = time.perf_counter()
        elif prof is not None and prof_wall is None and k == prof_frames[-1]:
            sync()
            prof_wall = time.perf_counter() - t_prof
            prof.__exit__(None, None, None)
    t_end = time.perf_counter()
    fetch_wait, pace_wait = s.tracker.fetch_wait_s, s._pace_wait_s
    st = s.stats()
    down = clean_shutdown(s)
    sync()
    wall = time.perf_counter() - t
    counts = kernels.launch_counts()
    by_thread = kernels.launch_counts_by_thread()

    tracked = np.array([p is not None for p in poses])
    first = int(np.argmax(tracked)) if tracked.any() else -1
    ate = trajectory_ate(poses, gt, evaluate)
    skip = set(prof_frames) if prof is not None else set()
    tt = np.array([s.track_times[j] for j in range(warm, n) if j not in skip]) * 1e3
    wall_w = t_end - t_warm[0]
    m, go = s.mapper, s.global_optimizer
    inserted = max(s.map_db.n_kfs - 2, 1)
    per_frame = {k: v / max(int(tracked.sum()), 1) for k, v in counts.items()}
    prof_sum = (window_summary(prof, prof_wall, len(prof_frames), float(np.median(tt)))
                if prof is not None else None)
    # host ms of the feed's phases (dispatch and finish include their waits
    # for the map lock), median and p90
    pipe_ms = {k: [float(np.median(v) * 1e3), float(np.percentile(v, 90) * 1e3)]
               for k, v in s.pipe_stats.items() if v}
    out = dict(
        frames=n, depth=depth, warmup=warm, first_tracked=first,
        tracked_share=float(tracked.mean()), ate_sim3_m=ate,
        keyframes=st["num_keyframes"], keyframes_inserted=s.map_db.n_kfs,
        keyframes_culled=m.kfs_culled, landmarks=st["num_landmarks"],
        fused_frames=st["fused_frames"], classic_frames=n - st["fused_frames"],
        track_ms_median_after_40=float(np.median(tt)),
        track_ms_p90_after_40=float(np.percentile(tt, 90)),
        wall_fps_after_40=(n - warm) / wall_w,
        decomposition=dict(wall_s=wall_w, fetch_wait_s=fetch_wait, pace_wait_s=pace_wait,
                           host_other_s=max(wall_w - fetch_wait - pace_wait, 0.0)),
        pipe_ms_median_p90=pipe_ms, pace_waits=st["pace_waits"], pace_timeouts=st["pace_timeouts"],
        pace_wait_max_s=st["pace_wait_max_s"], stale_discards=st["stale_discards"],
        pred_hist_misses=st["pred_hist_misses"], local_ba_runs=m.ba_runs,
        local_ba_skipped=m.ba_skipped,
        local_ba_ms_mean=m.ba_wall_s / max(m.ba_runs, 1) * 1e3,
        mapping_ms_per_keyframe=sum(m.phase_s.values()) / inserted * 1e3,
        mapping_phase_ms_per_keyframe={k: v / inserted * 1e3 for k, v in m.phase_s.items()},
        loop_checks_run=go.loop_checks_run, loops_closed=go.num_loops_closed,
        loop_stale_discards=go.loop_stale_discards, overflow=st["overflow"],
        shutdown=down, wall_s_with_shutdown=wall, launches=counts,
        launches_by_thread=by_thread, launches_per_tracked_frame=per_frame,
        profile_frames_120_129=prof_sum)
    log(f"System async (depth {depth}): first pose at frame {first}, tracked "
        f"{tracked.mean():.3f}, ATE(sim3) {ate:.4f} m, {st['num_keyframes']} keyframes "
        f"({s.map_db.n_kfs} inserted), fused {st['fused_frames']}; per-frame ms median "
        f"{out['track_ms_median_after_40']:.2f} p90 {out['track_ms_p90_after_40']:.2f} after "
        f"frame {warm}; wall {out['wall_fps_after_40']:.2f} frames/s after frame {warm}; "
        f"decomposition {out['decomposition']}; feed phases ms (median, p90) {pipe_ms}")
    log(f"System async: pace waits {st['pace_waits']} (timeouts {st['pace_timeouts']}, max "
        f"{st['pace_wait_max_s']:.3f} s), stale discards {st['stale_discards']}, prediction "
        f"history misses {st['pred_hist_misses']}; local BA {m.ba_runs} runs "
        f"({m.ba_skipped} skipped on a backlog) at "
        f"{out['local_ba_ms_mean']:.1f} ms; mapping {out['mapping_ms_per_keyframe']:.1f} ms per "
        f"keyframe; loop checks {go.loop_checks_run}; launches per tracked frame "
        f"{ {k: round(v, 3) for k, v in per_frame.items()} }; by thread {by_thread}; "
        f"shutdown {down}")
    if prof_sum is not None:
        log(f"System async profile (frames 120-129): {prof_sum}")

    if first < 0 or first > 15:
        fail(f"System async: no pose by frame 15 (first {first})")
    if tracked.mean() < 0.90:
        fail(f"System async: tracked share {tracked.mean():.3f} below 0.90")
    if not ate <= 0.05:
        fail(f"System async: ATE(sim3) {ate:.4f} m above 0.05 m")
    if st["pace_timeouts"]:
        fail(f"System async: {st['pace_timeouts']} pace timeouts")
    if not shutdown_ok(down):
        fail(f"System async: unclean shutdown or a worker exception: {down}")
    if min(counts.values()) == 0:
        fail(f"System async did not launch every kernel: {counts}")
    return out, counts


def async_loop_phase(dev, frames, depth: int = ASYNC_LOOP_DEPTH):
    """Phase 6b: phase 6's path (``frames``: a sequence of images, the view
    to relocalize on and the ground truth, as ``loop_frames`` returns them;
    a ``LapRender`` renders each image as the feed reads it) through the
    async System and ``feed_sequence(depth)``; the System settles, then 3
    blank frames and up to 3 relocalization attempts as in phase 6.  Phase
    6's gates, with the loop closed on the loop worker's thread and K2
    launched from it.  Returns (summary dict, launch counts of the run)."""
    import torch
    from openvslam_tpu_torch import kernels
    from openvslam_tpu_torch.config import Config
    from openvslam_tpu_torch.module.tracking_module import TrackerState
    from openvslam_tpu_torch.system import System
    from openvslam_tpu_torch.utils import evaluate

    cfg = Config.from_dict(loop_config_dict())
    cam = cfg.camera
    imgs, revisit, gt = frames
    n = len(imgs)
    s = System(cfg, async_mapping=True, device=dev)
    go = s.global_optimizer
    # which thread corrects each loop (the wrapped function is the one the
    # module calls; no hook in the package)
    closers, correct = [], go.correct_loop

    def spy_correct(*a, **kw):
        closers.append(threading.current_thread().name)
        return correct(*a, **kw)

    go.correct_loop = spy_correct
    s.startup()
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    kernels.reset_launch_counts()
    t = time.perf_counter()
    poses = [p for _, p in s.feed_sequence(((imgs[i], i / 20.0) for i in range(n)),
                                           kind="monocular", depth=depth)]
    lap_wall = time.perf_counter() - t
    settle_s = settle(s)
    sync()
    counts_lap = kernels.launch_counts()
    by_thread_lap = kernels.launch_counts_by_thread()
    blank = np.zeros((cam.rows, cam.cols), np.uint8)
    for i in range(3):
        s.feed_monocular_frame(blank, (n + i) / 20.0)
    lost = s.tracker.state == TrackerState.LOST
    reloc_ms, attempts, reloc_pose = [], 0, None
    for a in range(3):
        sync()
        t = time.perf_counter()
        reloc_pose = s.feed_monocular_frame(revisit, (n + 3 + a) / 20.0)
        sync()
        reloc_ms.append((time.perf_counter() - t) * 1e3)
        attempts += 1
        if reloc_pose is not None:
            break
    st = s.stats()
    down = clean_shutdown(s)
    sync()
    counts = kernels.launch_counts()
    by_thread = kernels.launch_counts_by_thread()

    tracked = np.array([p is not None for p in poses])
    first = int(np.argmax(tracked)) if tracked.any() else -1
    share = float(tracked[first:].mean()) if first >= 0 else 0.0
    db = s.map_db
    ids = db.valid_kf_ids()
    kf_ate = keyframe_ate(db, gt, evaluate)
    ate_gate = LOOP_ATE_MARGIN * LOOP_REF_KF_ATE_M
    loop_edge = any(db.loop_edges[int(k)] for k in ids)
    _, comp, comp_mask = s.composed_poses()
    dc = dR = None
    ri = revisit_index(n)
    if reloc_pose is not None and comp_mask[ri]:
        ref = comp[ri]
        dc = float(np.linalg.norm(-reloc_pose[:3, :3].T @ reloc_pose[:3, 3]
                                  + ref[:3, :3].T @ ref[:3, 3]))
        dR = float(np.linalg.norm(reloc_pose[:3, :3] - ref[:3, :3]))
    tm = {k: [x * 1e3 for x in v] for k, v in go.timings.items()}
    k2_worker = by_thread.get("global-opt", {}).get("projection_match", 0)
    out = dict(
        frames=n, depth=depth, first_tracked=first, tracked_share_after_first=share,
        keyframes=int(len(ids)), landmarks=int(len(db.valid_lm_ids())),
        keyframe_ate_sim3_m=kf_ate, keyframe_ate_gate_m=ate_gate,
        loops_closed=go.num_loops_closed, loops_closed_on=closers, loop_edge=loop_edge,
        loop_checks_run=go.loop_checks_run, loop_cands_seen=go.loop_cands_seen,
        loop_validations=go.loop_validations, loop_stale_discards=go.loop_stale_discards,
        stale_discards=st["stale_discards"], pace_timeouts=st["pace_timeouts"],
        pred_hist_misses=st["pred_hist_misses"], local_ba_runs=s.mapper.ba_runs,
        local_ba_skipped=s.mapper.ba_skipped,
        loop_check_ms_mean=float(np.mean(tm["check"])) if tm["check"] else None,
        loop_check_ms_max=float(np.max(tm["check"])) if tm["check"] else None,
        validation_ms=tm["validate"], pose_graph_ms=tm["pose_graph"], global_ba_ms=tm["global_ba"],
        lost_after_blanks=lost, reloc_attempts=attempts, reloc_ok=reloc_pose is not None,
        reloc_ms_per_attempt=reloc_ms, reloc_centre_diff=dc, reloc_rot_diff=dR,
        lap_wall_s=lap_wall, lap_per_frame_ms_median=float(np.median(s.track_times[:n]) * 1e3),
        settle_s=settle_s, shutdown=down, launches_lap=counts_lap,
        launches_lap_by_thread=by_thread_lap, launches_by_thread=by_thread,
        launches_per_lap_frame={k: v / n for k, v in counts_lap.items()},
        k2_launches_on_loop_worker=k2_worker)
    log(f"Loop async ({n} frames, depth {depth}): first pose {first}, tracked {share:.3f}, {len(ids)} "
        f"keyframes, KF ATE(sim3) {kf_ate:.4f} m (gate {ate_gate:.3f} m), loops closed "
        f"{go.num_loops_closed} on {closers} (edge {loop_edge}); checks {go.loop_checks_run} at "
        f"{out['loop_check_ms_mean']} ms mean, candidates {go.loop_cands_seen}, validations "
        f"{go.loop_validations}, loop stale discards {go.loop_stale_discards}; validation ms "
        f"{[round(x, 1) for x in tm['validate']]}; pose graph ms {tm['pose_graph']}; global BA ms "
        f"{tm['global_ba']}; lap wall {lap_wall:.1f}s, settled in {settle_s:.2f}s; launches "
        f"{counts_lap}, by thread {by_thread_lap}")
    log(f"Loop async relocalization: lost after blanks {lost}; {attempts} attempts, ok "
        f"{reloc_pose is not None}, ms {[round(x, 1) for x in reloc_ms]}; centre diff {dc}, "
        f"rotation diff {dR}; shutdown {down}")

    if first < 0 or first >= 15:
        fail(f"Loop async: no pose before frame 15 (first {first})")
    if share < 0.90:
        fail(f"Loop async: tracked share {share:.3f} below 0.90")
    if go.num_loops_closed < 1 or not loop_edge or "global-opt" not in closers:
        fail(f"Loop async: no loop closed by the loop worker (closed on {closers})")
    if not kf_ate <= ate_gate:
        fail(f"Loop async: keyframe ATE(sim3) {kf_ate:.4f} m above {ate_gate:.3f} m")
    if not lost:
        fail("Loop async: tracking not lost after the blank frames")
    if reloc_pose is None:
        fail("Loop async: no relocalization within 3 attempts")
    if dc is None or dc >= 0.15 or dR >= 0.1:
        fail(f"Loop async: relocalized pose off the frame-{ri} estimate (centre {dc}, "
             f"rotation {dR})")
    if not shutdown_ok(down):
        fail(f"Loop async: unclean shutdown or a worker exception: {down}")
    if min(counts.values()) == 0 or k2_worker == 0:
        fail(f"Loop async: a kernel was not launched (K2 on the loop worker {k2_worker}): "
             f"{counts}")
    return out, counts


def kitti_config_dict() -> dict:
    """Phase 7's configuration: configs/kitti_stereo_00.yaml's Camera and
    Feature blocks (1241x376, fx = fy = 718.856, focal_x_baseline 386.1448,
    2000 keypoints, 8 levels), loop detection on."""
    return {"Camera": {"name": "KITTI stereo 00-02", "setup": "stereo", "model": "perspective",
                       "fx": 718.856, "fy": 718.856, "cx": 607.1928, "cy": 185.2157,
                       "k1": 0.0, "k2": 0.0, "p1": 0.0, "p2": 0.0, "fps": 10.0,
                       "cols": 1241, "rows": 376, "focal_x_baseline": 386.1448,
                       "depth_threshold": 40.0},
            "Feature": {"max_num_keypts": 2000, "scale_factor": 1.2, "num_levels": 8},
            "LoopDetector": {"enabled": True}}


def tum_config_dict() -> dict:
    """Phase 7b's configuration: configs/tum_rgbd_rgbd_fr1.yaml's Camera and
    Feature blocks (640x480 with its radial-tangential distortion, 1000
    keypoints, 8 levels, focal_x_baseline 40, depthmap_factor 5000)."""
    return {"Camera": {"name": "TUM RGBD freiburg1", "setup": "rgbd", "model": "perspective",
                       "fx": 517.306408, "fy": 516.469215, "cx": 318.643040,
                       "cy": 255.313989, "k1": 0.262383, "k2": -0.953104, "p1": -0.005358,
                       "p2": 0.002628, "k3": 1.163314, "fps": 30.0, "cols": 640, "rows": 480,
                       "focal_x_baseline": 40.0, "depth_threshold": 40.0,
                       "depthmap_factor": 5000.0},
            "Feature": {"max_num_keypts": 1000, "scale_factor": 1.2, "num_levels": 8}}


def fisheye_config_dict() -> dict:
    """Phase 8's configuration: TUM VI's 512x512 equidistant cam0 with its
    published calibration (as in stella_vslam's example/tum_vi config; 20
    fps), 1000 keypoints, 8 levels, scale 1.2, loop detection on."""
    return {"Camera": {"name": "TUM VI fisheye cam0", "setup": "monocular", "model": "fisheye",
                       "fx": 190.978, "fy": 190.973, "cx": 254.932, "cy": 256.897,
                       "k1": 0.00348239, "k2": 0.000715035, "k3": -0.00205324,
                       "k4": 0.000202937, "cols": 512, "rows": 512, "fps": 20.0},
            "Feature": {"max_num_keypts": 1000, "num_levels": 8, "scale_factor": 1.2},
            "LoopDetector": {"enabled": True}}


def equirect_config_dict() -> dict:
    """Phase 8b's configuration: the RICOH THETA S camera of OpenVSLAM's
    documented equirectangular tutorial (1920x960, 30 fps; 2000 keypoints,
    8 levels, scale 1.2; its mask rectangles hide the photographer, whom
    the rendered room does not have), loop detection on."""
    return {"Camera": {"name": "RICOH THETA S 960", "setup": "monocular",
                       "model": "equirectangular", "cols": 1920, "rows": 960, "fps": 30.0},
            "Feature": {"max_num_keypts": 2000, "num_levels": 8, "scale_factor": 1.2,
                        "ini_fast_threshold": 20, "min_fast_threshold": 7},
            "LoopDetector": {"enabled": True}}


def camera_scene(synthetic, cam):
    """Phases 8 and 8b's (scene, ground-truth poses) from a
    ``utils.synthetic`` module: phase 6's room and the first
    ``CAMERA_FRAMES`` frames of its lap."""
    scene, gt = loop_scene(synthetic, cam)
    return scene, gt[:CAMERA_FRAMES]


def wall_scene(synthetic, cam, step_m: float, n: int = WALL_FRAMES):
    """tests/test_stereo_rgbd_e2e.py's textured wall (seed 7, the plane z = 7
    m, stretched to cover the path) and its sideways path, here ``n``
    frames ``step_m`` apart, the camera looking at the wall.  Returns
    (scene, ground-truth poses)."""
    xs = np.arange(n) * step_m
    scene = synthetic.PlaneSceneRenderer(np.random.default_rng(7), x_range=(-8.0, xs[-1] + 8.0),
                                         y_range=(-5.0, 5.0), plane_z=7.0, rows=cam.rows,
                                         cols=cam.cols)
    return scene, np.stack([synthetic.lookat_pose_cw((x, 0, 0), (x, 0, 7)) for x in xs])


def stereo_pairs(cam):
    """Phase 7's rendered pairs at KITTI 00's size: (left and right images,
    ground-truth left poses), 0.1 m a frame along the wall."""
    from openvslam_tpu_torch.utils import synthetic

    scene, gt = wall_scene(synthetic, cam, 0.1)
    shift = np.eye(4)
    shift[0, 3] = -cam.focal_x_baseline / cam.fx
    t = time.perf_counter()
    pairs = [(scene.render(cam, T), scene.render(cam, shift @ T)) for T in gt]
    log(f"Stereo: {len(pairs)} pairs rendered in {time.perf_counter() - t:.1f}s "
        f"({cam.cols}x{cam.rows}, baseline {-shift[0, 3]:.3f} m)")
    return pairs, gt


def rgbd_frames(cam, depthmap_factor: float = 5000.0):
    """Phase 7b's frames at TUM fr1's camera ``cam``: (items ``(image,
    depth map, timestamp)``, ground-truth poses) along the wall at 0.05 m
    a frame.  The path is fronto-parallel, so every pixel's z-depth is the
    wall's distance; the maps are stored as TUM stores them (uint16,
    metres x ``depthmap_factor``)."""
    from openvslam_tpu_torch.utils import synthetic

    scene, gt = wall_scene(synthetic, cam, 0.05)
    items = [(scene.render(cam, T),
              np.full((cam.rows, cam.cols), round((7.0 - (-T[:3, :3].T @ T[:3, 3])[2])
                                                  * depthmap_factor), np.uint16),
              i / cam.fps) for i, T in enumerate(gt)]
    return items, gt


def se3_ate(poses, gt, evaluate) -> float:
    """ATE(se3) of the tracked frames' centres (inf below 3 tracked): a
    metric map has no scale to align."""
    idx = [i for i, p in enumerate(poses) if p is not None]
    if len(idx) < 3:
        return float("inf")
    ce = np.stack([-poses[i][:3, :3].T @ poses[i][:3, 3] for i in idx])
    cg = np.stack([-gt[i][:3, :3].T @ gt[i][:3, 3] for i in idx])
    return float(evaluate.ate_rmse(ce, cg, align="se3"))


class KernelCapture:
    """While a main-path run drives them, keep the operands of the last K1
    launch, of the last K2 launch over the local-map table and of the last
    K3 launch over observations of ``k3_cols`` columns ((u, v, u_right) by
    default), by wrapping the functions the package calls; it launches
    nothing itself.  ``check(tag)`` then holds each captured launch against
    its plain version (``check_k1``, ``check_k2``, ``check_k3``)."""

    def __init__(self, lm_capacity: int, k3_cols: int = 3):
        from openvslam_tpu_torch.ops import fast, match as M
        from openvslam_tpu_torch.optimize import pose_optimizer as PO

        self.lm_capacity = lm_capacity
        self.k1 = self.k2 = self.k3 = None
        self._wrapped = [(fast, "fast_cell_pools"), (M, "projection_scale_match"),
                         (PO, "pose_lm")]
        self._orig = [getattr(m, n) for m, n in self._wrapped]
        f1, f2, f3 = self._orig

        def k1(levels, thr_hi, thr_lo, budgets, cell=32, masks=None):
            self.k1 = (list(levels), (thr_hi, thr_lo), list(budgets), masks)
            return f1(levels, thr_hi, thr_lo, budgets, cell, masks)

        def k2(*a, **kw):
            if a[0].shape[0] == self.lm_capacity:
                self.k2 = (a, kw)
            return f2(*a, **kw)

        def k3(*a, **kw):
            if a[2].shape[1] == k3_cols:
                self.k3 = (a, kw)
            return f3(*a, **kw)

        for (m, n), w in zip(self._wrapped, (k1, k2, k3)):
            setattr(m, n, w)

    def restore(self):
        for (m, n), f in zip(self._wrapped, self._orig):
            setattr(m, n, f)

    def check(self, tag: str, with_k3: bool = True) -> dict:
        """{kernel key: its row at the captured shape}; fails on a kernel
        that was not captured or disagrees with its plain version.  Without
        ``with_k3`` (a path that has no K3) K3 is neither expected nor
        checked."""
        if self.k1 is None or self.k2 is None or (with_k3 and self.k3 is None):
            fail(f"{tag}: a kernel of the path was not captured")
        levels, thr, budgets, masks = self.k1
        r1 = check_k1(levels, budgets, masks=(masks,), thr=thr)
        a2, kw2 = self.k2
        kw2 = dict(kw2)
        image = kw2.pop("image_size")
        r2 = check_k2(a2, kw2, image)
        rows = {"fast_score_maps": dict(r1, shape=f"{tag} K1 " + r1["shape"]),
                "projection_match": dict(r2, shape=f"{tag} K2 " + r2["shape"])}
        if with_k3:
            r3 = check_k3(*self.k3)
            rows["pose_lm"] = dict(r3, shape=f"{tag} K3 " + r3["shape"])
        for r in rows.values():
            log(f"{r['shape']}: max_abs_err {r['max_abs_err']}, {r['ms']:.4f} ms through the "
                f"wrapper, {r['ms_kernel_only']:.4f} ms kernel alone (plain {r['plain_ms']:.3f} "
                f"ms; bound {r['bound_ms']:.6f} ms {r['bound_by']})")
        if not r1["exact"]:
            fail(f"{tag}: K1 differs from its plain version")
        if not r2["exact"]:
            fail(f"{tag}: K2 differs from its plain version")
        if with_k3 and not rows["pose_lm"]["ok"]:
            fail(f"{tag}: K3 differs from its plain version beyond T atol 1e-3 / 0.99 inliers")
        return rows


def depth_system_run(s, dev, feed, n, prof_frames=None):
    """Drive ``feed(i)`` for i < n on System ``s`` with the launch counts
    reset just before; a profiler window over ``prof_frames`` (kept out of
    the frame times).  Returns (poses, launch counts, wall s, profile
    summary or None)."""
    import torch
    from openvslam_tpu_torch import kernels

    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    poses, by_name, i = [], None, 0
    sync()
    kernels.reset_launch_counts()
    t = time.perf_counter()
    while i < n:
        if dev.type == "cuda" and prof_frames is not None and i == prof_frames[0]:
            by_name = profile_window(lambda j: poses.append(feed(j)), prof_frames)
            i = prof_frames[-1] + 1
            continue
        poses.append(feed(i))
        i += 1
    sync()
    return poses, kernels.launch_counts(), time.perf_counter() - t, by_name


def frame_ms(s, warm: int, skip=()) -> np.ndarray:
    return np.array([x for j, x in enumerate(s.track_times) if j >= warm and j not in skip]) * 1e3


def stereo_phase(dev, frames):
    """Phase 7: the stereo System at KITTI 00's full width (``kitti_config_dict``)
    on ``frames`` (``stereo_pairs``): synchronously frame by frame, then with
    async mapping through ``feed_sequence(kind="stereo", depth=3)``.  Gates
    of tests/test_stereo_rgbd_e2e.py: tracked > 0.90 and ATE(se3) < 0.08 m,
    the first pose at frame 0 (the depth bootstrap).  The first frame's
    bootstrap is replayed on the CPU through the same entry point (landmark
    count exact, positions within 1e-5 relative), the first and last local
    BA problems are re-solved on the CPU (``ba_agreement``), and K1, K2 and
    K3 are held against their plain versions at the shapes the run gave
    them.  Returns (summary dict, {run: launch counts}, kernel rows)."""
    import torch
    from openvslam_tpu_torch.config import Config
    from openvslam_tpu_torch.ops.stereo import stereo_match_dense
    from openvslam_tpu_torch.optimize.ba import BAResult, make_local_ba
    from openvslam_tpu_torch.system import System
    from openvslam_tpu_torch.utils import evaluate

    cfg = Config.from_dict(kitti_config_dict())
    cam = cfg.camera
    pairs, gt = frames
    n, warm, prof = len(pairs), 10, range(60, 70)
    s = System(cfg, device=dev)
    local_ba, bas = s.mapper.local_ba, []

    def spy_ba(prob):
        res = local_ba(prob)
        bas[1 if bas else 0:] = [(prob, res)]      # the first and the last
        return res

    s.mapper.local_ba = spy_ba
    s.startup()
    boot = {}

    def feed(i):
        pose = s.feed_stereo_frame(*pairs[i], i / cam.fps)
        if i == 0:
            ids = s.map_db.valid_lm_ids()
            boot.update(n=len(ids), X=s.map_db.lm_pos[ids].copy())
        return pose

    cap = KernelCapture(s.tracker.LOCAL_LM_CAP)
    try:
        poses, counts, wall, by_name = depth_system_run(s, dev, feed, n, prof)
    finally:
        cap.restore()
    s.shutdown()
    st = s.stats()
    m = s.mapper
    tracked = np.array([p is not None for p in poses])
    first = int(np.argmax(tracked)) if tracked.any() else -1
    ate = se3_ate(poses, gt, evaluate)
    tt = frame_ms(s, warm, prof)
    prof_sum = (profile_summary(by_name, len(prof), float(np.median(tt)))
                if by_name is not None else None)
    # the depth bootstrap through the same entry point on the CPU
    cs = System(cfg, device="cpu")
    cs.feed_stereo_frame(*pairs[0], 0.0)
    ids = cs.map_db.valid_lm_ids()
    Xc = cs.map_db.lm_pos[ids]
    boot_rel = (float((np.linalg.norm(boot["X"] - Xc, axis=-1)
                       / np.maximum(np.linalg.norm(Xc, axis=-1), 1e-9)).max())
                if len(ids) == boot["n"] else None)
    boot_ok = boot_rel is not None and boot_rel <= 1e-5
    # one stereo local BA and the last, re-solved on the CPU
    ba_cpu = make_local_ba(cam, m.BA_FIRST_ITERS, m.BA_SECOND_ITERS, stereo=True)
    ba_rows = [ba_agreement(cam, prob.to("cpu"), BAResult(*(t.cpu() for t in res)),
                            ba_cpu(prob.to("cpu"))) for prob, res in bas]
    # the dense stereo match alone, on frame 0's keypoints
    l0, r0 = (torch.from_numpy(im).to(dev) for im in pairs[0])
    kp0 = s.frontend.extract(l0)
    sm_ms = cuda_ms(lambda: stereo_match_dense(l0, r0, kp0.xy, kp0.valid, cam.focal_x_baseline),
                    20)[0]
    sm_n = int((stereo_match_dense(l0, r0, kp0.xy, kp0.valid, cam.focal_x_baseline)[1] > 0).sum())
    rows = cap.check("Stereo KITTI 1241x376")

    # the async System through the pipelined feed, as bench.py feeds
    sa = System(cfg, async_mapping=True, device=dev)
    sa.startup()
    items = ((pairs[i][0], pairs[i][1], i / cam.fps) for i in range(n))
    apose, acounts, awall, _ = depth_system_run(
        sa, dev, lambda i, it=iter(sa.feed_sequence(items, kind="stereo", depth=3)): next(it)[1], n)
    settle_s = settle(sa)
    ast = sa.stats()
    down = clean_shutdown(sa)
    atracked = np.array([p is not None for p in apose])
    aate = se3_ate(apose, gt, evaluate)
    att = frame_ms(sa, warm)
    out = dict(
        frames=n, first_tracked=first, tracked_share=float(tracked.mean()), ate_se3_m=ate,
        keyframes=st["num_keyframes"], landmarks=st["num_landmarks"],
        fused_frames=st["fused_frames"], track_ms_median=float(np.median(tt)),
        track_ms_p90=float(np.percentile(tt, 90)), wall_s=wall,
        stereo_match_dense_ms=sm_ms, stereo_matched_on_frame0=sm_n,
        keypoints_on_frame0=int(kp0.valid.sum()),
        local_ba_runs=m.ba_runs, local_ba_ms_mean=m.ba_wall_s / max(m.ba_runs, 1) * 1e3,
        lms_created=m.lms_created, lms_created_seed=m.lms_created_seed,
        launches=counts, launches_per_tracked_frame={k: v / max(int(tracked.sum()), 1)
                                                     for k, v in counts.items()},
        profile_frames_60_69=prof_sum, bootstrap_landmarks=[boot["n"], len(ids)],
        bootstrap_X_max_rel_diff=boot_rel, ba_check=ba_rows,
        async_tracked_share=float(atracked.mean()), async_ate_se3_m=aate,
        async_track_ms_median=float(np.median(att)), async_track_ms_p90=float(np.percentile(att, 90)),
        async_wall_s=awall, async_settle_s=settle_s, async_fused_frames=ast["fused_frames"],
        async_local_ba_runs=ast["local_ba_runs"], async_local_ba_skipped=ast["local_ba_skipped"],
        async_launches=acounts, async_shutdown=down)
    log(f"Stereo (KITTI 1241x376, sync): first pose {first}, tracked {tracked.mean():.3f}, "
        f"ATE(se3) {ate:.4f} m, {st['num_keyframes']} keyframes, {st['num_landmarks']} "
        f"landmarks ({m.lms_created_seed} seeded from depth of {m.lms_created}); fused "
        f"{st['fused_frames']}; track ms median {out['track_ms_median']:.2f} p90 "
        f"{out['track_ms_p90']:.2f}; stereo_match_dense {sm_ms:.3f} ms ({sm_n} of "
        f"{out['keypoints_on_frame0']} keypoints matched on frame 0); local BA {m.ba_runs} runs "
        f"at {out['local_ba_ms_mean']:.1f} ms; launches {counts}")
    if prof_sum is not None:
        log(f"Stereo profile (frames 60-69): device busy {prof_sum['device_busy_ms_per_frame']:.3f} "
            f"ms/frame over {prof_sum['kernels_per_frame']:.0f} kernels; idle share "
            f"{prof_sum['device_idle_share']}")
        for row in prof_sum["top"]:
            log(f"  {row['ms_per_frame']:.4f} ms/frame x{row['calls_per_frame']:.0f}  {row['name']}")
    log(f"Stereo bootstrap replay: landmarks card {boot['n']} CPU {len(ids)}, positions max rel "
        f"diff {boot_rel}; local BA card vs CPU: {ba_rows}")
    log(f"Stereo (async, feed_sequence depth 3): tracked {atracked.mean():.3f}, ATE(se3) "
        f"{aate:.4f} m; track ms median {out['async_track_ms_median']:.2f} p90 "
        f"{out['async_track_ms_p90']:.2f}; local BA {ast['local_ba_runs']} runs, "
        f"{ast['local_ba_skipped']} skipped; settled in {settle_s:.2f}s; launches {acounts}; "
        f"shutdown {down}")
    if first != 0:
        fail(f"Stereo: the depth bootstrap gave no pose at frame 0 (first {first})")
    for tag, share, err in (("sync", tracked.mean(), ate), ("async", atracked.mean(), aate)):
        if not share > 0.90:
            fail(f"Stereo {tag}: tracked share {share:.3f} not above 0.90")
        if not err < 0.08:
            fail(f"Stereo {tag}: ATE(se3) {err:.4f} m not below 0.08 m")
    if not boot_ok:
        fail("Stereo: the card's depth bootstrap disagrees with the CPU's")
    if not ba_rows or not all(r["ok"] for r in ba_rows):
        fail("Stereo: the card's stereo local BA disagrees with the CPU's")
    if not shutdown_ok(down):
        fail(f"Stereo async: unclean shutdown or a worker exception: {down}")
    for tag, c in (("sync", counts), ("async", acounts)):
        if min(c.values()) == 0:
            fail(f"Stereo {tag} did not launch every kernel: {c}")
    return out, {"stereo": counts, "stereo_async": acounts}, rows


def rgbd_phase(dev):
    """Phase 7b: the RGB-D System at TUM fr1's width (``tum_config_dict``)
    through ``feed_sequence(kind="rgbd", depth=3)`` with synchronous mapping,
    on the wall path at 0.05 m a frame, depth maps stored as TUM stores
    them (uint16, metres x 5000).  Gates of test_rgbd_pipelined: tracked >
    0.90, ATE(se3) < 0.08 m, fused share > 0.6, and the first pose at frame
    0 (the depth bootstrap); K1, K2 and K3 held against
    their plain versions at the run's shapes.  Returns (summary dict, launch
    counts, kernel rows)."""
    from openvslam_tpu_torch.config import Config
    from openvslam_tpu_torch.system import System
    from openvslam_tpu_torch.utils import evaluate

    cfg = Config.from_dict(tum_config_dict())
    cam = cfg.camera
    t = time.perf_counter()
    items, gt = rgbd_frames(cam, cfg.depthmap_factor)
    render_s = time.perf_counter() - t
    n = len(gt)
    s = System(cfg, device=dev)
    s.startup()
    cap = KernelCapture(s.tracker.LOCAL_LM_CAP)
    try:
        poses, counts, wall, _ = depth_system_run(
            s, dev, lambda i, it=iter(s.feed_sequence(iter(items), kind="rgbd", depth=3)):
            next(it)[1], n)
    finally:
        cap.restore()
    s.shutdown()
    st = s.stats()
    tracked = np.array([p is not None for p in poses])
    ate = se3_ate(poses, gt, evaluate)
    tt = frame_ms(s, 10)
    fused = st["fused_frames"] / n
    rows = cap.check("RGB-D TUM 640x480")
    out = dict(frames=n, render_s=render_s, first_tracked=int(np.argmax(tracked)),
               tracked_share=float(tracked.mean()), ate_se3_m=ate, fused_share=fused,
               keyframes=st["num_keyframes"], landmarks=st["num_landmarks"],
               track_ms_median=float(np.median(tt)), track_ms_p90=float(np.percentile(tt, 90)),
               wall_s=wall, local_ba_runs=st["local_ba_runs"], launches=counts)
    log(f"RGB-D (TUM 640x480, feed_sequence depth 3): tracked {tracked.mean():.3f}, ATE(se3) "
        f"{ate:.4f} m, fused share {fused:.3f}, {st['num_keyframes']} keyframes; track ms "
        f"median {out['track_ms_median']:.2f} p90 {out['track_ms_p90']:.2f}; wall {wall:.1f}s "
        f"(rendered in {render_s:.1f}s); launches {counts}")
    if out["first_tracked"] != 0:
        fail(f"RGB-D: the depth bootstrap gave no pose at frame 0 (first {out['first_tracked']})")
    if not tracked.mean() > 0.90:
        fail(f"RGB-D: tracked share {tracked.mean():.3f} not above 0.90")
    if not ate < 0.08:
        fail(f"RGB-D: ATE(se3) {ate:.4f} m not below 0.08 m")
    if not fused > 0.6:
        fail(f"RGB-D: fused share {fused:.3f} not above 0.6")
    if min(counts.values()) == 0:
        fail(f"RGB-D did not launch every kernel: {counts}")
    return out, counts, rows


def stereo_loop_phase(dev):
    """Phase 7c: the stereo loop at tests/test_stereo_loop.py's own point
    (``STEREO_LOOP_POINT``), synchronous mapping, frame by frame.  Gates:
    a pose within the first 5 frames, tracked > 0.90 after it, at least
    one loop closed with a loop edge, the Sim3 scale of every correction 1
    within 1e-6 (a metric map's scale is locked), and keyframe ATE(se3) at
    most ``LOOP_ATE_MARGIN`` times the JAX System's reading at this point.
    Returns (summary dict, launch counts)."""
    from openvslam_tpu_torch.config import Config
    from openvslam_tpu_torch.system import System
    from openvslam_tpu_torch.utils import evaluate, synthetic

    cfg = Config.from_dict(stereo_loop_config_dict())
    cam = cfg.camera
    scene, gt, shift = stereo_loop_scene(synthetic, cam)
    n = len(gt)
    s = System(cfg, device=dev)
    go = s.global_optimizer
    scales, correct = [], go.correct_loop

    def spy_correct(kf, cand, g, *a, **kw):
        scales.append(float(g[2]))
        return correct(kf, cand, g, *a, **kw)

    go.correct_loop = spy_correct
    s.startup()
    render = [0.0]

    def feed(i):
        t = time.perf_counter()
        pair = tuple(scene.render_torch(cam, T, dev).cpu().numpy()
                     for T in (gt[i], shift @ gt[i]))
        render[0] += time.perf_counter() - t
        return s.feed_stereo_frame(*pair, i / cam.fps)

    poses, counts, wall, _ = depth_system_run(s, dev, feed, n)
    s.shutdown()
    tracked = np.array([p is not None for p in poses])
    first = int(np.argmax(tracked)) if tracked.any() else -1
    share = float(tracked[first:].mean()) if first >= 0 else 0.0
    db = s.map_db
    kf_ate = keyframe_ate(db, gt, evaluate, align="se3")
    gate = LOOP_ATE_MARGIN * STEREO_LOOP_REF_KF_ATE_M
    loop_edge = any(db.loop_edges[int(k)] for k in db.valid_kf_ids())
    tm = {k: [x * 1e3 for x in v] for k, v in go.timings.items()}
    out = dict(frames=n, first_tracked=first, tracked_share_after_first=share,
               keyframes=int(len(db.valid_kf_ids())), loops_closed=go.num_loops_closed,
               loop_edge=loop_edge, correction_scales=scales, keyframe_ate_se3_m=kf_ate,
               keyframe_ate_gate_m=gate, wall_s=wall, render_s=render[0],
               validation_ms=tm["validate"], pose_graph_ms=tm["pose_graph"],
               global_ba_ms=tm["global_ba"], launches=counts)
    log(f"Stereo loop (320x240, sync): first pose {first}, tracked {share:.3f}, "
        f"{out['keyframes']} keyframes, loops closed {go.num_loops_closed} (edge {loop_edge}), "
        f"correction scales {scales}, KF ATE(se3) {kf_ate:.4f} m (gate {gate:.3f} m); "
        f"validation ms {[round(x, 1) for x in tm['validate']]}, pose graph ms "
        f"{tm['pose_graph']}, global BA ms {tm['global_ba']}; wall {wall:.1f}s of which render "
        f"{render[0]:.1f}s; launches {counts}")
    if first < 0 or first >= 5:
        fail(f"Stereo loop: no pose within the first 5 frames (first {first})")
    if not share > 0.90:
        fail(f"Stereo loop: tracked share {share:.3f} not above 0.90")
    if go.num_loops_closed < 1 or not loop_edge:
        fail("Stereo loop: no loop closed")
    if not all(abs(x - 1.0) <= 1e-6 for x in scales):
        fail(f"Stereo loop: a correction's Sim3 scale is not locked at 1: {scales}")
    if not kf_ate <= gate:
        fail(f"Stereo loop: keyframe ATE(se3) {kf_ate:.4f} m above {gate:.3f} m")
    if min(counts.values()) == 0:
        fail(f"Stereo loop did not launch every kernel: {counts}")
    return out, counts


def camera_frames(dev, cam, scene, gt):
    """Phases 8 and 8b's frames, rendered on the card with
    ``RoomSceneRenderer.render_torch`` (a 1920x960 frame takes seconds in
    numpy); frame 0 also in numpy on the host, as tools/camera_points_jax.py
    renders for the JAX System, and the two held within 1 gray level on
    99.9 % of the pixels.  Returns (frames, summary)."""
    import torch

    t = time.perf_counter()
    imgs = [scene.render_torch(cam, T, dev).cpu().numpy() for T in gt]
    card_s = time.perf_counter() - t
    t = time.perf_counter()
    host0 = scene.render(cam, gt[0])
    host_s = time.perf_counter() - t
    diff = np.abs(host0.astype(np.int64) - imgs[0].astype(np.int64))
    within1 = float((diff <= 1).mean())
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return imgs, dict(render_card_s=card_s, render_host_frame0_s=host_s,
                      frame0_within_1_gray=within1, frame0_max_gray_diff=int(diff.max()))


def camera_phase(dev, point: str):
    """Phase 8 (``point`` "8": TUM VI's fisheye, ``fisheye_config_dict``)
    or 8b ("8b": the THETA S equirectangular camera,
    ``equirect_config_dict``): the System on ``camera_scene``'s 120 frames
    (rendered on the card, ``camera_frames``), synchronous mapping, frame by
    frame.  Captured during the run and replayed on the CPU: the first
    bootstrap attempt (the bearing-E path; matches, masks and the support
    counts as a set exact, T21 within 1e-4), the fused step's pose LM (8:
    its last K3 launch, T within 1e-3 and 99 % of the inlier flags as K3 is
    held; 8b: the first and last equirectangular LM, inliers equal and |dT|
    <= 1e-4) and a local BA (8: the last, 8b: the first;
    ``ba_agreement_any_order``); K1 and K2 (and K3 in 8) held against their
    plain versions at the run's shapes.  8b traces frames
    60-69 with the profiler and times the equirectangular LM alone.  Phase
    8 then runs the System again with the tracker's bootstrap generator
    seeded with each further entry of ``CAMERA_SEEDS`` (no capture, no
    count).  Gates: a pose by frame 15 and tracked share after it >= 0.90
    and >= the JAX System's - 0.05 in every run, ATE(sim3) of the tracked
    trajectory (8: the median over the runs) <= 1.25 x the JAX System's
    (``FISHEYE_REF``, ``EQUIRECT_REF``), the card's frame 0 within 1 gray
    level of numpy's on 99.9 % of pixels, every replay agreeing, and
    every kernel of the path launched (K3 exempt in 8b: the JAX package runs
    the equirectangular LM outside its Pallas kernel too).  Loops are
    recorded, not gated.  Returns (summary dict, launch counts, kernel
    rows)."""
    import torch
    from openvslam_tpu_torch.config import Config
    from openvslam_tpu_torch.initialize import two_view as TV
    from openvslam_tpu_torch.ops import pose_lm as PL
    from openvslam_tpu_torch.optimize import pose_optimizer as PO
    from openvslam_tpu_torch.optimize.ba import BAResult, make_local_ba
    from openvslam_tpu_torch.system import System
    from openvslam_tpu_torch.utils import evaluate, synthetic

    fisheye = point == "8"
    cfg = Config.from_dict(fisheye_config_dict() if fisheye else equirect_config_dict())
    ref = FISHEYE_REF if fisheye else EQUIRECT_REF
    cam = cfg.camera
    tag = f"Phase {point} ({cam.model_name} {cam.cols}x{cam.rows})"
    scene, gt = camera_scene(synthetic, cam)
    n = len(gt)
    imgs, render = camera_frames(dev, cam, scene, gt)
    log(f"{tag}: {n} frames rendered on the card in {render['render_card_s']:.1f}s (frame 0 in "
        f"numpy {render['render_host_frame0_s']:.1f}s; within 1 gray level on "
        f"{render['frame0_within_1_gray']:.6f} of the pixels, max diff "
        f"{render['frame0_max_gray_diff']})")

    captured = {"init": [], "ba": [], "lm": [], "lm_calls": 0}
    attempt, eq_lm = TV.init_attempt, PO.equirect_pose_lm

    def spy_attempt(gen, *args, **kw):
        state = gen.get_state()
        out = attempt(gen, *args, **kw)
        if not captured["init"]:
            captured["init"].append(dict(state=state, args=args, out=out))
        return out

    def spy_lm(*a, **kw):
        out = eq_lm(*a, **kw)
        captured["lm"] = captured["lm"][:1] + [(a, kw, out)]
        captured["lm_calls"] += 1
        return out

    s = System(cfg, device=dev)
    local_ba = s.mapper.local_ba

    def spy_ba(prob, *stop):
        res = local_ba(prob, *stop)
        if fisheye or not captured["ba"]:
            captured["ba"] = [(prob, res)]
        return res

    TV.init_attempt, PO.equirect_pose_lm, s.mapper.local_ba = spy_attempt, spy_lm, spy_ba
    cap = KernelCapture(s.tracker.LOCAL_LM_CAP, k3_cols=2)
    prof_frames = None if fisheye else range(60, 70)
    s.startup()
    try:
        poses, counts, wall, by_name = depth_system_run(
            s, dev, lambda i: s.feed_monocular_frame(imgs[i], i / cam.fps), n, prof_frames)
    finally:
        cap.restore()
        TV.init_attempt, PO.equirect_pose_lm = attempt, eq_lm
    s.shutdown()
    st = s.stats()
    go, m = s.global_optimizer, s.mapper

    def readings(sys_, poses_):
        """(first tracked frame, tracked share after it, ATE(sim3) of the
        tracked trajectory) of one run."""
        tr = np.array([p is not None for p in poses_])
        f = int(np.argmax(tr)) if tr.any() else -1
        _, tp, mask = sys_.tracked_poses()
        return (f, float(tr[f:].mean()) if f >= 0 else 0.0,
                trajectory_ate([p if k else None for p, k in zip(tp, mask)], gt, evaluate))

    tracked = np.array([p is not None for p in poses])
    first, share, ate = readings(s, poses)
    kf_ate = keyframe_ate(s.map_db, gt, evaluate)
    runs = [dict(seed=s.tracker.INIT_SEED, first_tracked=first, tracked_share_after_first=share,
                 ate_sim3_m=ate, keyframe_ate_sim3_m=kf_ate)]
    for seed in CAMERA_SEEDS[1:] if fisheye else ():
        sr = System(cfg, device=dev)
        sr.tracker.gen.manual_seed(seed)
        sr.startup()
        pr = [sr.feed_monocular_frame(imgs[i], i / cam.fps) for i in range(n)]
        sr.shutdown()
        f_r, share_r, ate_r = readings(sr, pr)
        runs.append(dict(seed=seed, first_tracked=f_r, tracked_share_after_first=share_r,
                         ate_sim3_m=ate_r, keyframe_ate_sim3_m=keyframe_ate(sr.map_db, gt,
                                                                           evaluate)))
    log(f"{tag} runs by bootstrap seed: {runs}")
    ate_gated = float(np.median([r["ate_sim3_m"] for r in runs]))
    tt = frame_ms(s, 10, prof_frames or ())
    prof = (profile_summary(by_name, len(prof_frames), float(np.median(tt)))
            if by_name is not None else None)
    rows = cap.check(tag, with_k3=fisheye)

    # the first bootstrap attempt: its draws replayed from the generator's
    # state on the card, re-solved on the CPU
    if not captured["init"]:
        fail(f"{tag}: the System never attempted the two-view bootstrap")
    c0 = captured["init"][0]
    K = c0["args"][12]
    gen = torch.Generator(device=dev)
    gen.set_state(c0["state"])
    pairs = TV.init_pairs(*c0["args"][:12])
    sh, sf = TV.draw_samples(gen, pairs.pmask, perspective=K is not None)
    cpu = TV.init_attempt_with_samples(None if sh is None else sh.cpu(), sf.cpu(),
                                       *(a.cpu() for a in c0["args"][:12]), None)
    card = c0["out"]
    # the four E hypotheses come from the SVDs of the card's and the CPU's
    # solvers, which may order them differently: their counts are compared
    # as a set, the best one's pose, points and mask exactly as they are
    exact = ("num_matches", "use_h", "good", "m1", "m2", "pmask", "n_inl")
    same = (all(torch.equal(getattr(card, f).cpu(), getattr(cpu, f)) for f in exact)
            and torch.equal(card.counts.cpu().sort().values, cpu.counts.sort().values))
    posed = int(card.counts.max()) > 0
    dT21 = float((card.T21.cpu() - cpu.T21).abs().max()) if posed else None
    init_ok = K is None and same and (not posed or dT21 <= 1e-4)
    init_row = dict(bearing_path=K is None, num_matches=int(card.num_matches),
                    counts=card.counts.tolist(), cpu_counts=cpu.counts.tolist(),
                    exact_fields_equal=same, T21_max_abs_diff=dT21, tolerance=1e-4)
    log(f"{tag} bootstrap replay (first attempt): {init_row}")

    # the fused step's LM replayed on the CPU
    lm_rows, lm_ok = [], True
    if fisheye:
        a3, kw3 = cap.k3
        Tk, ik, nk, _ = PL.pose_lm(*a3, **kw3)
        Tc, ic, nc, _ = PL.pose_lm_plain(*(a.cpu() for a in a3), **kw3)
        dT = float((Tk.cpu() - Tc).abs().max())
        agree = float((ik.cpu() == ic).float().mean())
        lm_ok = dT <= 1e-3 and agree >= 0.99
        lm_rows.append(dict(call="last K3 launch", rows=int(a3[1].shape[0]),
                            inliers=[int(nk), int(nc)], T_max_abs_diff=dT,
                            inlier_agreement=agree))
    else:
        for which, (a, kw, out) in zip(("first", "last"), captured["lm"]):
            Tc, ic, nc, _ = PO.equirect_pose_lm(*(t.cpu() for t in a), **kw)
            dT = float((out[0].cpu() - Tc).abs().max())
            equal = bool(torch.equal(out[1].cpu(), ic))
            lm_ok &= equal and dT <= 1e-4
            lm_rows.append(dict(call=which, rows=int(a[1].shape[0]),
                                inliers=[int(out[2]), int(nc)], inliers_equal=equal,
                                T_max_abs_diff=dT))
        lm_ok &= len(lm_rows) == 2
    log(f"{tag} pose LM card vs CPU: {lm_rows}")
    # a local BA re-solved on the CPU, in up to three summation orders
    ba_cpu = make_local_ba(cam, m.BA_FIRST_ITERS, m.BA_SECOND_ITERS)
    ba_ok, ba_rows = bool(captured["ba"]), []
    for prob, res in captured["ba"]:
        ok_r, rows_r = ba_agreement_any_order(cam, prob.to("cpu"),
                                              BAResult(*(t.cpu() for t in res)), ba_cpu)
        ba_ok &= ok_r
        ba_rows += rows_r
    log(f"{tag} local BA ({'last' if fisheye else 'first'}) card vs CPU: {ba_rows}")

    out = dict(frames=n, first_tracked=first, tracked_share_after_first=share,
               tracked_share=float(tracked.mean()), ate_sim3_m=ate,
               ate_sim3_gated_m=ate_gated, runs=runs,
               ate_gate_m=LOOP_ATE_MARGIN * ref["ate_sim3_m"], jax_ref=ref,
               keyframe_ate_sim3_m=kf_ate, keyframes=st["num_keyframes"],
               landmarks=st["num_landmarks"], fused_frames=st["fused_frames"],
               loops_closed=go.num_loops_closed, loop_checks_run=go.loop_checks_run,
               track_ms_median=float(np.median(tt)), track_ms_p90=float(np.percentile(tt, 90)),
               wall_s=wall, local_ba_runs=m.ba_runs,
               local_ba_ms_mean=m.ba_wall_s / max(m.ba_runs, 1) * 1e3,
               mapping_phase_ms_per_keyframe={
                   k: v / max(s.map_db.n_kfs, 1) * 1e3 for k, v in m.phase_s.items()},
               loop_check_ms_mean=float(np.mean(go.timings["check"]) * 1e3)
               if go.timings["check"] else None,
               launches=counts, launches_per_tracked_frame={
                   k: v / max(int(tracked.sum()), 1) for k, v in counts.items()},
               init_check=init_row, lm_check=lm_rows, ba_check=ba_rows, **render)
    if not fisheye:
        a, kw, _ = captured["lm"][-1]
        lm_ms = cuda_ms(lambda: PO.equirect_pose_lm(*a, **kw), 3, warmup=1, repeats=3)[0]
        lm_kernels = (sum(c for _, c in profile_window(
            lambda _: PO.equirect_pose_lm(*a, **kw), [0]).values())
            if dev.type == "cuda" else None)
        calls = captured["lm_calls"] / max(int(tracked.sum()), 1)
        out.update(equirect_lm_ms=lm_ms, equirect_lm_rows=int(a[1].shape[0]),
                   equirect_lm_kernels_per_call=lm_kernels,
                   equirect_lm_calls_per_tracked_frame=calls,
                   equirect_lm_launches_per_tracked_frame=(
                       None if lm_kernels is None else lm_kernels * calls),
                   profile_frames_60_69=prof)
        log(f"{tag} equirectangular LM alone: {lm_ms:.3f} ms per call at N "
            f"{out['equirect_lm_rows']}, {lm_kernels} kernels per call, {calls:.2f} calls per "
            f"tracked frame")
    log(f"{tag}: first pose {first}, tracked after it {share:.3f} (JAX {ref['tracked']}), "
        f"ATE(sim3) {ate:.4f} m (over the runs {ate_gated:.4f} m; gate {out['ate_gate_m']:.4f} m), "
        f"keyframe ATE {kf_ate:.4f} m, "
        f"{st['num_keyframes']} keyframes, {st['num_landmarks']} landmarks, fused "
        f"{st['fused_frames']}, loops closed {go.num_loops_closed}; track ms median "
        f"{out['track_ms_median']:.2f} p90 {out['track_ms_p90']:.2f}; local BA {m.ba_runs} runs at "
        f"{out['local_ba_ms_mean']:.1f} ms; mapping ms per keyframe "
        f"{ {k: round(v, 1) for k, v in out['mapping_phase_ms_per_keyframe'].items()} }; "
        f"wall {wall:.1f}s; launches {counts}")
    if prof is not None:
        log(f"{tag} profile (frames 60-69): device busy {prof['device_busy_ms_per_frame']:.3f} "
            f"ms/frame over {prof['kernels_per_frame']:.0f} kernels; idle share "
            f"{prof['device_idle_share']} of the untraced median frame ({prof['frame_ms']:.2f} ms)")
        for row in prof["top"]:
            log(f"  {row['ms_per_frame']:.4f} ms/frame x{row['calls_per_frame']:.0f}  {row['name']}")
    for r in runs:
        if r["first_tracked"] < 0 or r["first_tracked"] > 15:
            fail(f"{tag}: no pose by frame 15 (seed {r['seed']}: first {r['first_tracked']})")
        sh = r["tracked_share_after_first"]
        if not (sh >= 0.90 and sh >= ref["tracked"] - 0.05):
            fail(f"{tag}: tracked share {sh:.3f} (seed {r['seed']}) below 0.90 or JAX's "
                 f"{ref['tracked']} - 0.05")
    if not ate_gated <= out["ate_gate_m"]:
        fail(f"{tag}: ATE(sim3) {ate_gated:.4f} m above {out['ate_gate_m']:.4f} m")
    if not render["frame0_within_1_gray"] >= 0.999:
        fail(f"{tag}: the card's rendering differs from numpy's")
    if not init_ok:
        fail(f"{tag}: the card's bootstrap attempt disagrees with the CPU's")
    if not lm_ok:
        fail(f"{tag}: the card's pose LM disagrees with the CPU's")
    if not ba_ok:
        fail(f"{tag}: the card's local BA disagrees with the CPU's in every summation order")
    need = ("fast_score_maps", "projection_match") + (("pose_lm",) if fisheye else ())
    if min(counts[k] for k in need) == 0:
        fail(f"{tag} did not launch every kernel of its path: {counts}")
    return out, counts, rows


def ba_agreement(cam, prob, res, ref, allow_flips: bool = False):
    """How closely a BA result ``res`` agrees with ``ref`` on the same
    problem.  Raw pose and point differences are reported; the pass
    criterion is on what the solution predicts, since a mono window with
    one fixed camera leaves the scale free and two-view landmarks of low
    parallax have no well-determined depth: the same inlier set, the
    final cost within 1e-4 of the reference's, and every inlier
    observation reprojected within 0.05 px of the reference's
    reprojection.  With ``allow_flips`` (the global BA, whose tens of
    thousands of observations the card sums in no fixed order), an
    observation whose chi2 lies within 5 % of the threshold in both
    solutions (the band a 0.05 px reprojection difference spans there)
    may change side; such flips are counted and reported."""
    import torch
    from openvslam_tpu_torch.optimize.ba import reprojection_residuals
    from openvslam_tpu_torch.optimize.residuals import CHI2_2D, CHI2_3D
    from openvslam_tpu_torch.utils import evaluate

    cv, lv = prob.cam_valid, prob.lm_valid
    n = int(prob.obs_mask.sum())
    oc, ol, uv = prob.obs_cam[:n].long(), prob.obs_lm[:n].long(), prob.obs_uv[:n]
    resid = [reprojection_residuals(cam, r.T_cw, r.X, oc, ol, uv)[0] for r in (res, ref)]
    pred = [uv - r for r in resid]
    inl = ref.obs_inlier[:n]
    reproj = float((pred[0] - pred[1]).norm(dim=-1)[inl].max()) if bool(inl.any()) else 0.0
    cost_rel = abs(float(res.cost) - float(ref.cost)) / max(abs(float(ref.cost)), 1e-12)
    same_inl = bool(torch.equal(res.obs_inlier, ref.obs_inlier))
    flip = (res.obs_inlier != ref.obs_inlier)[:n]
    near = torch.ones_like(flip)
    for r in resid:
        c2 = (r * r).sum(-1) / prob.obs_sigma2[:n]
        thr = CHI2_3D if uv.shape[-1] == 3 else CHI2_2D
        near &= (c2 - thr).abs() <= 0.05 * thr
    flips_near = bool((near | ~flip).all()) and bool(torch.equal(res.obs_inlier[n:],
                                                                 ref.obs_inlier[n:]))
    dT = float((res.T_cw - ref.T_cw)[cv].abs().max())
    Xr = ref.X[lv]
    dX = (res.X[lv] - Xr).norm(dim=-1) / Xr.norm(dim=-1).clamp(min=1.0)

    def centres(r):
        T = r.T_cw[cv].double()
        return -(T[:, :3, :3].transpose(1, 2) @ T[:, :3, 3:])[..., 0].numpy()

    scale = evaluate.umeyama_alignment(centres(res), centres(ref))[0] if int(cv.sum()) > 2 else 1.0
    inliers_ok = flips_near if allow_flips else same_inl
    return dict(cams=int(cv.sum()), fixed_cams=int((cv & ~prob.cam_opt).sum()),
                landmarks=int(lv.sum()), observations=n, inliers_equal=same_inl,
                inlier_flips=int(flip.sum()), flips_allowed=allow_flips,
                flips_within_5pct_of_threshold=flips_near,
                cost_rel_diff=cost_rel, reproj_max_px=reproj, T_max_abs_diff=dT,
                X_max_rel_diff=float(dX.max()), X_median_rel_diff=float(dX.median()),
                centres_sim3_scale=float(scale),
                ok=inliers_ok and cost_rel <= 1e-4 and reproj <= 0.05)


def ba_agreement_any_order(cam, prob, res, solve, orders: int = 3):
    """``ba_agreement`` of a card's BA result ``res`` on ``prob`` (on the
    CPU) against ``solve`` (a CPU solver) run on the problem's observations
    in ``orders`` summation orders: as given, then fixed permutations.  A
    fisheye window whose rim observations make it ill-conditioned reaches
    solutions that differ by a few inlier flags and pixels between two
    orders of the same sums on either backend (tools/camera_ba_orders.py), so
    the card's result must agree with the CPU's in at least one order; a
    wrong solve agrees with none.  Returns (ok, rows)."""
    import torch
    from openvslam_tpu_torch.optimize.ba import BAResult

    n = int(prob.obs_mask.sum())
    rows = []
    for k in range(orders):
        idx = torch.arange(len(prob.obs_mask))
        if k:
            idx[:n] = torch.randperm(n, generator=torch.Generator().manual_seed(k))
        p2 = prob._replace(obs_cam=prob.obs_cam[idx], obs_lm=prob.obs_lm[idx],
                           obs_uv=prob.obs_uv[idx], obs_sigma2=prob.obs_sigma2[idx],
                           obs_mask=prob.obs_mask[idx])
        r2 = solve(p2)
        inv = torch.empty_like(idx)
        inv[idx] = torch.arange(len(idx))
        ref = BAResult(r2.T_cw, r2.X, r2.obs_inlier[inv], r2.cost)
        rows.append(dict(order=k, **ba_agreement(cam, prob, res, ref)))
        if rows[-1]["ok"]:
            break
    return rows[-1]["ok"], rows


def pose_graph_agreement(prob, out, ref):
    """How closely a pose-graph solution ``out`` (R, t, s, cost) agrees with
    ``ref`` on the same problem: every valid node's R, t and s within 1e-5,
    and the cost within 1e-4 of the reference's."""
    v = prob.node_valid.cpu()
    c_out, c_ref = float(out[3]), float(ref[3])
    d = max(float((a.cpu() - b.cpu())[v].abs().max()) for a, b in zip(out[:3], ref[:3]))
    return dict(nodes=int(v.sum()), edges=int(prob.e_mask.sum()), cost=c_out, cost_ref=c_ref,
                cost_rel_diff=abs(c_out - c_ref) / max(abs(c_ref), 1e-12), R_t_s_max_abs_diff=d,
                ok=abs(c_out - c_ref) <= 1e-4 * abs(c_ref) and d <= 1e-5)


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

    # K1 on all 8 levels of frame 1 at FrameStep's budgets, without and with
    # a random mask: the pools and the selection after them against the
    # plain composition
    levels = pyramid.build_pyramid(imgs_d[1].to(torch.float32), 8, 1.2)
    shapes = [tuple(im.shape) for im in levels]
    budgets = fs.frontend.budgets
    keep_px = torch.from_numpy(np.random.default_rng(3).random((480, 640)) > 0.3).to(dev)
    masks1 = [pyramid.resize_nearest(keep_px.to(torch.float32), s) for s in shapes]
    k1 = check_k1(levels, budgets, masks=(None, masks1))
    exact1, err1 = k1["exact"], k1["max_abs_err"]
    report["fast_score_maps"] = dict(
        name="fast_cell_pools", route="cuda", source="openvslam_tpu_torch/csrc/fast.cu",
        replaces="openvslam_tpu/ops/pallas/fast_kernel.py:102", max_abs_err=err1,
        ms=k1["ms"], ms_kernel_only=k1["ms_kernel_only"], plain_ms=k1["plain_ms"],
        bound_ms=k1["bound_ms"], bound_by=k1["bound_by"], library_ms=None,
        arc_pixels=k1["arc_pixels"], pixels=k1["pixels"], shapes=[k1],
        check=f"pools and detect_levels bit-exact on {len(levels)} levels ({k1['pixels']} px), "
              f"without and with a mask: {exact1}")
    log(f"K1 fast_cell_pools: {k1['pixels']} px, {k1['arc_pixels']} with a lower-threshold arc, "
        f"{len(levels)} x {k1['pool_width']} pools; exact={exact1}, max_abs_err={err1}; "
        f"{k1['ms']:.4f} ms [{k1['ms_lo']:.4f}, {k1['ms_hi']:.4f}] through the wrapper, "
        f"{k1['ms_kernel_only']:.4f} ms kernel alone (plain {k1['plain_ms']:.3f} ms; bound "
        f"{k1['bound_ms']:.6f} ms {k1['bound_by']})")
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
    exact2, shapes2 = True, []
    for tag, a2, kw2 in (("L4096xK1064 FrameStep", margs, dict(ratio=0.9)),
                         ("L1032xK1032 TrackStep motion 7px", targs, {})):
        r2 = check_k2(a2, kw2, (cam.cols, cam.rows))
        exact2 &= r2["exact"]
        shapes2.append(dict(r2, shape=tag))
        log(f"K2 projection_match {tag}: visible rows {r2['visible']}, gate pairs "
            f"{r2['gate_pairs']}, matched {r2['matched']}, {r2['ms']:.4f} ms [{r2['ms_lo']:.4f}, "
            f"{r2['ms_hi']:.4f}] through the wrapper, {r2['ms_kernel_only']:.4f} ms kernel alone "
            f"(plain {r2['plain_ms']:.3f} ms; bound {r2['bound_ms']:.6f} ms {r2['bound_by']})")
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
        r3 = check_k3(args, kw)
        err3, agree3 = max(err3, r3["max_abs_err"]), min(agree3, r3["inlier_agreement"])
        shapes3.append(dict(r3, shape=tag))
        log(f"K3 pose_lm {tag} ({r3['masked']} masked rows): dT={r3['max_abs_err']:.3e} inliers "
            f"{r3['inliers'][0]} vs plain {r3['inliers'][1]}, agreement "
            f"{r3['inlier_agreement']:.4f}; {r3['ms']:.4f} ms [{r3['ms_lo']:.4f}, "
            f"{r3['ms_hi']:.4f}] through the wrapper, {r3['ms_kernel_only']:.4f} ms kernel alone "
            f"(plain {r3['plain_ms']:.3f} ms; bound {r3['bound_ms']:.6f} ms {r3['bound_by']})")
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

    # ---------------------------------------------------------------- 5
    sys_frames = system_frames(system_config().camera)
    sys_out, sys_counts = system_phase(dev, frames=sys_frames)

    # ---------------------------------------------------------------- 6
    from openvslam_tpu_torch.config import Config

    lap_frames = loop_frames(Config.from_dict(loop_config_dict()).camera, dev=dev)
    loop_out, loop_counts = loop_phase(dev, frames=lap_frames)

    del lap_frames

    # ---------------------------------------------------------------- 5b
    async_out, async_counts = async_system_phase(dev, sys_frames)
    del sys_frames

    # ---------------------------------------------------------------- 6b
    lap = LapRender(Config.from_dict(loop_config_dict()).camera, ASYNC_LOOP_FRAMES)
    aloop_out, aloop_counts = async_loop_phase(
        dev, (lap, lap[revisit_index(ASYNC_LOOP_FRAMES)], lap.gt))
    del lap

    # ---------------------------------------------------------------- 7
    pairs = stereo_pairs(Config.from_dict(kitti_config_dict()).camera)
    stereo_out, stereo_counts, stereo_rows = stereo_phase(dev, pairs)
    del pairs

    # ---------------------------------------------------------------- 7b
    rgbd_out, rgbd_counts, rgbd_rows = rgbd_phase(dev)

    # ---------------------------------------------------------------- 7c
    sloop_out, sloop_counts = stereo_loop_phase(dev)

    # ---------------------------------------------------------------- 8, 8b
    fish_out, fish_counts, fish_rows = camera_phase(dev, "8")
    eq_out, eq_counts, eq_rows = camera_phase(dev, "8b")

    # ---------------------------------------------------------------- out
    kernels_out = []
    depth_counts = dict(stereo_counts, rgbd=rgbd_counts, stereo_loop=sloop_counts,
                        fisheye=fish_counts, equirect=eq_counts)
    for key, r in report.items():
        shapes = (r["shapes"] + [stereo_rows[key], rgbd_rows[key], fish_rows[key]]
                  + ([eq_rows[key]] if key in eq_rows else []))
        kernels_out.append(dict(
            r, shapes=shapes, max_abs_err=max(x["max_abs_err"] for x in shapes),
            launches=(fs_counts[key] + ts_counts[key] + sys_counts[key] + loop_counts[key]
                      + async_counts[key] + aloop_counts[key]
                      + sum(c[key] for c in depth_counts.values())),
            **{f"launches_{run}": c[key] for run, c in depth_counts.items()},
            launches_framestep=fs_counts[key], launches_trackstep=ts_counts[key],
            launches_system=sys_counts[key],
            launches_system_per_tracked_frame=sys_out["launches_per_tracked_frame"][key],
            launches_loop=loop_counts[key], launches_system_async=async_counts[key],
            launches_system_async_per_tracked_frame=async_out["launches_per_tracked_frame"][key],
            launches_loop_async=aloop_counts[key]))
        log(f"kernel {r['name']}: launches FrameStep {fs_counts[key]} TrackStep {ts_counts[key]} "
            f"System {sys_counts[key]} Loop {loop_counts[key]} System async {async_counts[key]} "
            f"Loop async {aloop_counts[key]} "
            f"{' '.join(f'{run} {c[key]}' for run, c in depth_counts.items())}; max_abs_err {r['max_abs_err']}; {r['ms']:.4f} ms "
            f"({r['ms_kernel_only']:.4f} ms kernel alone) vs plain {r['plain_ms']:.3f} ms; "
            f"bound {r['bound_ms']:.6f} ms ({r['bound_by']})")
    print(json.dumps({"profile": {"framestep": fs_prof, "trackstep": ts_prof,
                                  "framestep_extract_ms": extract_ms, "extract": ex_prof}}),
          flush=True)
    summary = dict(framestep_fps=fs_fps, framestep_inliers_median=float(np.median(inl)),
                   framestep_terr_median_m=float(np.median(terr)),
                   trackstep_fps=ts_fps, trackstep_inliers_median=float(np.median(inl2)),
                   trackstep_terr_median_m=float(np.median(terr2)),
                   trackstep_terr_max_m=float(max(terr2)),
                   system_fps_median=sys_out["fps_median_after_40"],
                   system_ate_sim3_m=sys_out["ate_sim3_m"],
                   system_tracked_share=sys_out["tracked_share"],
                   system_loops_closed=sys_out["loops_closed"],
                   loop_loops_closed=loop_out["loops_closed"],
                   loop_keyframe_ate_sim3_m=loop_out["keyframe_ate_sim3_m"],
                   loop_reloc_attempts=loop_out["reloc_attempts"],
                   system_async_track_ms_median=async_out["track_ms_median_after_40"],
                   system_async_track_ms_p90=async_out["track_ms_p90_after_40"],
                   system_async_wall_fps=async_out["wall_fps_after_40"],
                   system_async_ate_sim3_m=async_out["ate_sim3_m"],
                   loop_async_loops_closed=aloop_out["loops_closed"],
                   loop_async_keyframe_ate_sim3_m=aloop_out["keyframe_ate_sim3_m"],
                   stereo_tracked_share=stereo_out["tracked_share"],
                   stereo_ate_se3_m=stereo_out["ate_se3_m"],
                   stereo_track_ms_median=stereo_out["track_ms_median"],
                   stereo_async_ate_se3_m=stereo_out["async_ate_se3_m"],
                   rgbd_ate_se3_m=rgbd_out["ate_se3_m"], rgbd_fused_share=rgbd_out["fused_share"],
                   stereo_loop_loops_closed=sloop_out["loops_closed"],
                   stereo_loop_keyframe_ate_se3_m=sloop_out["keyframe_ate_se3_m"],
                   fisheye_tracked_share=fish_out["tracked_share_after_first"],
                   fisheye_ate_sim3_m=fish_out["ate_sim3_gated_m"],
                   fisheye_track_ms_median=fish_out["track_ms_median"],
                   equirect_tracked_share=eq_out["tracked_share_after_first"],
                   equirect_ate_sim3_m=eq_out["ate_sim3_gated_m"],
                   equirect_track_ms_median=eq_out["track_ms_median"],
                   seconds=time.perf_counter() - T0)
    print(json.dumps({"system": sys_out}), flush=True)
    print(json.dumps({"loop": loop_out}), flush=True)
    print(json.dumps({"system_async": async_out}), flush=True)
    print(json.dumps({"loop_async": aloop_out}), flush=True)
    print(json.dumps({"stereo": stereo_out}), flush=True)
    print(json.dumps({"rgbd": rgbd_out}), flush=True)
    print(json.dumps({"stereo_loop": sloop_out}), flush=True)
    print(json.dumps({"fisheye": fish_out}), flush=True)
    print(json.dumps({"equirect": eq_out}), flush=True)
    print(json.dumps({"summary": summary}), flush=True)
    print(json.dumps({"kernels": kernels_out}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
