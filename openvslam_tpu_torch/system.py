"""System facade (counterpart of ``openvslam_tpu/system.py``; ref
``system.h/.cc``): owns the front end, the map database and the tracking,
mapping and global optimization modules, and exposes startup, shutdown,
``feed_monocular_frame``, ``feed_stereo_frame``, ``feed_RGBD_frame``, the
pipelined ``feed_sequence``, the mapping and loop-detector switches,
pause/resume, reset and the trajectory accessors.  A perspective or
fisheye camera of any setup runs: monocular, stereo (a rectified pair;
per-keypoint depth by the dense SAD match against the right image) or
RGB-D (a registered depth map, scaled by ``depthmap_factor``); an
equirectangular camera is monocular.  A monocular map starts from a
two-view bootstrap (H and F for a perspective camera, E on bearings for
the others).  Stereo and RGB-D maps are metric: the map starts from one
frame's depths and loop closure locks the Sim3 scale.

Tracking runs in the caller.  The common TRACKING path is one fused
``TrackStep`` per frame (kernels K1, K2, K3 on the card; an
equirectangular camera's pose LM is plain PyTorch); initialization,
relocalization and the rare fallbacks take the classic module ladder.

Synchronous by default: mapping runs after each keyframe insertion, and so
does the loop pipeline (BoW registration, detection, Sim3 validation,
correction, pose graph, global BA).  ``async_mapping=True`` gives the
reference's three threads: mapping runs on a worker behind
``_AsyncMapperProxy`` (tracking never waits for local BA), the loop pipeline
on the global optimization module's loop worker, and the global BA after a
correction on a thread of its own; each runs on a CUDA stream of its own,
and they share the map under one lock (``map_lock``).  The feed paces itself
to the mapper (``_pace_mapper``) so its queue stays short.

Not ported: map IO, publishers and autosave.
"""
from __future__ import annotations

import collections
import concurrent.futures
import threading
import time
from typing import List, Optional

import numpy as np
import torch

from .camera.base import SetupType, camera_to_config
from .config import Config
from .data import Frame, MapDatabase
from .device import resolve_device
from .models.frontend import OrbFrontend
from .models.track_step import TrackStep
from .module.global_optimization_module import GlobalOptimizationModule
from .module.mapping_module import MappingModule
from .module.tracking_module import TrackerState, TrackingModule
from .ops.stereo import depth_at_keypoints, stereo_match_dense
from .utils.log import get_logger
from .utils.threads import WorkerFaults, on_stream, worker_stream

_log = get_logger("system")


def equalize_histogram(img: np.ndarray) -> np.ndarray:
    """Global histogram equalization (ref util::image_converter option)."""
    hist = np.bincount(img.reshape(-1), minlength=256)
    cdf = np.cumsum(hist).astype(np.float64)
    nz = cdf[cdf > 0]
    if len(nz) == 0:
        return img
    cdf_min = nz[0]
    lut = np.clip(np.round((cdf - cdf_min) / max(cdf[-1] - cdf_min, 1) * 255), 0, 255
                  ).astype(np.uint8)
    return lut[img]


class System:
    def __init__(self, cfg: Config, vocab_path: Optional[str] = None,
                 async_mapping: bool = False, device="cuda"):
        """``vocab_path`` None or "default" takes the package's vocabulary for
        the descriptor pattern; otherwise an npz vocabulary file.
        ``async_mapping`` runs mapping, the loop pipeline and the global BA
        on worker threads (see the module docstring)."""
        self.device = resolve_device(device)
        self.cfg = cfg
        self.cam = cfg.camera
        f = cfg.feature
        self.frontend = OrbFrontend(
            rows=self.cam.rows, cols=self.cam.cols, max_keypts=f.max_num_keypts,
            num_levels=f.num_levels, scale_factor=f.scale_factor,
            ini_fast_thr=f.ini_fast_threshold, min_fast_thr=f.min_fast_threshold,
            pattern=f.descriptor_pattern, device=self.device)
        self.map_db = MapDatabase(kpt_capacity=self.frontend.capacity)
        self.camera_name = self.map_db.register_camera(
            cfg.raw.get("Camera", {}).get("name", "default"), camera_to_config(self.cam),
            make_default=True)
        # the BoW stack is always built (relocalization needs it); loop
        # detection stays gated by cfg.loop.enabled inside the module.  A
        # stereo/RGB-D map is metric: loop closure locks the Sim3 scale (ref
        # sim3_solver fix_scale for non-monocular setups)
        self.global_optimizer = GlobalOptimizationModule(
            cfg, self.cam, self.map_db, vocab_path,
            fix_scale=self.cam.setup != SetupType.MONOCULAR, device=self.device)
        self.mapper = MappingModule(cfg, self.cam, self.map_db,
                                    global_optimizer=self.global_optimizer, device=self.device)
        self.map_lock = threading.RLock()
        self.global_optimizer.map_lock = self.map_lock
        self.global_optimizer.async_global_ba = async_mapping
        self._async = async_mapping
        self._tracker_mapper = self.mapper
        if async_mapping:
            self.mapper.map_lock = self.map_lock
            self._tracker_mapper = _AsyncMapperProxy(self.mapper, self.map_lock,
                                                     self.global_optimizer.faults, self.device)
            # the loop worker pauses the mapper through the proxy for a
            # correction
            self.global_optimizer.mapper_proxy = self._tracker_mapper
        # feed-path backpressure accounting (stats())
        self._pace_waits = 0
        self._pace_wait_s = 0.0
        self._pace_wait_max = 0.0
        self.tracker = TrackingModule(cfg, self.cam, self.map_db, mapper=self._tracker_mapper,
                                      relocalizer=self.global_optimizer.relocalizer,
                                      device=self.device)
        # static mask from Feature.mask_rectangles ([y0,y1,x0,x1] ratios)
        self._static_mask = None
        if f.mask_rectangles:
            m = np.ones((self.cam.rows, self.cam.cols), np.float32)
            for y0, y1, x0, x1 in f.mask_rectangles:
                m[int(y0 * self.cam.rows):int(y1 * self.cam.rows),
                  int(x0 * self.cam.cols):int(x1 * self.cam.cols)] = 0.0
            self._static_mask = torch.from_numpy(m).to(self.device)
        mode = {SetupType.MONOCULAR: "mono", SetupType.STEREO: "stereo",
                SetupType.RGBD: "rgbd"}[self.cam.setup]
        self._track_step = TrackStep(self.cam, self.frontend,
                                     lm_capacity=TrackingModule.LOCAL_LM_CAP, mode=mode,
                                     device=self.device)
        self.frame_id = 0
        self._fused_frames = 0
        self.trajectory: List[tuple] = []   # (timestamp, pose_cw or None)
        # per-frame reference-keyframe anchor (ref trajectory_io: frame poses
        # are kept relative to their reference keyframe so that later BA
        # moves of the keyframe reach the frame): (ref_kf, T_rel) or None
        self.traj_ref: List[Optional[tuple]] = []
        self.track_times: List[float] = []  # per-frame wall time (ref track_times)
        # per-phase wall times of the last feed_sequence
        self.pipe_stats = {"prep_s": [], "dispatch_s": [], "finish_s": []}
        self.mapping_enabled = True
        if async_mapping:
            self.global_optimizer.start_loop_worker()

    # ------------------------------------------------------------------
    def startup(self):
        _log.info("system startup (%s, %dx%d, %s mapping, %s)", self.cam.setup.value, self.cam.cols,
                  self.cam.rows, "async" if self._async else "sync", self.device)

    def shutdown(self):
        """Drain the mapping worker (it queues loop checks), then stop the
        loop worker (it may start a global BA), then join the global BA.
        Every wait is bounded and raises TimeoutError when it expires."""
        try:
            if isinstance(self._tracker_mapper, _AsyncMapperProxy):
                self._tracker_mapper.drain()
        finally:
            try:
                self.global_optimizer.stop_loop_worker()
            finally:
                self.global_optimizer.join_global_ba(timeout=120)
                self.tracker.close()
        _log.info("system shutdown: %d frames, %d keyframes, %d landmarks",
                  len(self.trajectory), self.map_db.n_kfs, len(self.map_db.valid_lm_ids()))

    def enable_mapping_module(self):
        _log.info("mapping module enabled")
        self.mapping_enabled = True
        self.tracker.mapper = self._tracker_mapper

    def disable_mapping_module(self):
        """Localization mode: the map is frozen, frames are only tracked
        (ref §3.5)."""
        _log.info("mapping module disabled (localization mode)")
        self.mapping_enabled = False
        self.tracker.mapper = None

    def pause_other_threads(self):
        """Pause the mapping worker (ref system::pause_other_threads); nothing
        to pause in synchronous mode."""
        if isinstance(self._tracker_mapper, _AsyncMapperProxy):
            self._tracker_mapper.pause()

    def resume_other_threads(self):
        if isinstance(self._tracker_mapper, _AsyncMapperProxy):
            self._tracker_mapper.resume()

    def abort_loop_BA(self):
        """Skip the next global BA (ref system::abort_loop_BA)."""
        self.global_optimizer.abort_global_ba = True

    def enable_loop_detector(self):
        self.global_optimizer.loop_enabled = True

    def disable_loop_detector(self):
        self.global_optimizer.loop_enabled = False

    def loop_detector_is_enabled(self) -> bool:
        return self.global_optimizer.loop_enabled

    def loop_BA_is_running(self) -> bool:
        """Whether the background global BA is running (never in
        synchronous mode, where it runs inline)."""
        return self.global_optimizer.loop_BA_is_running()

    def request_reset(self):
        """Drop the map, the BoW database and the loop state; tracking
        starts over from initialization.  In async mode the mapping worker
        is paused and its queue dropped first."""
        _log.info("map reset requested")
        proxy = self._tracker_mapper
        if isinstance(proxy, _AsyncMapperProxy):
            proxy.pause(wait=True)
            proxy.clear()
        try:
            with self.map_lock:
                self.map_db = MapDatabase(kpt_capacity=self.frontend.capacity)
                self.camera_name = self.map_db.register_camera(
                    self.camera_name, camera_to_config(self.cam), make_default=True)
                self.mapper.reset(self.map_db)
                self.tracker.reset(self.map_db)
                self.global_optimizer.reset(self.map_db)
                self.trajectory.clear()
                self.traj_ref.clear()
        finally:
            if isinstance(proxy, _AsyncMapperProxy):
                proxy.resume()

    # ------------------------------------------------------------------
    def _use_fused(self) -> bool:
        """The fused TrackStep covers the common TRACKING path; every other
        state (init, Lost) takes the classic module ladder."""
        tr = self.tracker
        return (tr.state == TrackerState.TRACKING and tr.last_frame is not None
                and tr.last_frame.pose_cw is not None)

    def feed_kind(self) -> str:
        """Sequence kind for this camera setup ('monocular'|'stereo'|'rgbd'),
        as ``feed_sequence`` takes it."""
        return {SetupType.STEREO: "stereo", SetupType.RGBD: "rgbd"}.get(self.cam.setup,
                                                                        "monocular")

    def feed_frame(self, *args, **kwargs):
        """Setup-dispatched per-frame feed: ``feed_monocular_frame``,
        ``feed_stereo_frame`` or ``feed_RGBD_frame``."""
        return self._feed_of(self.feed_kind())(*args, **kwargs)

    def _feed_of(self, kind: str):
        return {"monocular": self.feed_monocular_frame, "stereo": self.feed_stereo_frame,
                "rgbd": self.feed_RGBD_frame}[kind]

    def _pace_mapper(self):
        """Backpressure (async mapping): before any lock is taken, block the
        feed until the mapper's keyframe queue drains to <= 1 once 2 wait.
        Pacing here, not inside keyframe insertion, matters: insertion runs
        with the map lock held, and the mapper needs that lock to drain.
        Each wait is bounded by twice the median per-keyframe mapping time
        (at least 0.5 s); ``wait_for_backlog`` returns at once while the
        mapper is paused."""
        proxy = self._tracker_mapper
        wait = getattr(proxy, "wait_for_backlog", None)
        if wait is None or proxy.backlog < 2:
            return
        times = list(proxy.kf_proc_times)
        bound = max(0.5, 2.0 * float(np.median(times))) if times else 5.0
        t0 = time.perf_counter()
        wait(max_backlog=1, timeout=bound)
        dt = time.perf_counter() - t0
        self._pace_waits += 1
        self._pace_wait_s += dt
        self._pace_wait_max = max(self._pace_wait_max, dt)

    def _mask_tensor(self, mask):
        return (self._static_mask if mask is None
                else torch.as_tensor(np.asarray(mask, np.float32), device=self.device))

    def feed_monocular_frame(self, image: np.ndarray, timestamp: float,
                             mask: Optional[np.ndarray] = None):
        """image: (rows, cols) uint8 grayscale or (rows, cols, 3) color; mask:
        optional (rows, cols), > 0 = usable.  Returns pose_cw (4,4) or None."""
        return self._feed(self._to_gray(image), None, timestamp, mask)

    def feed_stereo_frame(self, left: np.ndarray, right: np.ndarray, timestamp: float,
                          mask: Optional[np.ndarray] = None):
        """A rectified stereo pair -> pose_cw or None (ref
        system::feed_stereo_frame).  The front end runs on the left image;
        each left keypoint's right u and depth come from the dense SAD match
        against the right image."""
        return self._feed(self._to_gray(left), self._to_gray(right), timestamp, mask)

    def feed_RGBD_frame(self, rgb: np.ndarray, depthmap: np.ndarray, timestamp: float,
                        mask: Optional[np.ndarray] = None):
        """An image and its registered depth map (stored units; metres =
        value / ``depthmap_factor``) -> pose_cw or None (ref
        system::feed_RGBD_frame).  Depth is sampled at each keypoint, with a
        virtual right u from ``focal_x_baseline``."""
        return self._feed(self._to_gray(rgb), self._metric_depth(depthmap), timestamp, mask)

    def _metric_depth(self, depthmap: np.ndarray) -> np.ndarray:
        return depthmap.astype(np.float32) / max(self.cfg.depthmap_factor, 1e-9)

    def _feed(self, img: np.ndarray, aux, timestamp: float, mask):
        """Track one frame of any setup: ``aux`` is None (monocular), the
        right image (stereo) or the metric depth map (RGB-D)."""
        self._pace_mapper()
        mask_t = self._mask_tensor(mask)
        tr = self.tracker
        t0 = time.perf_counter()
        if self._use_fused():
            with self.map_lock:
                pose, _ = tr.track_fused(img, self.frame_id, timestamp, self._track_step, mask_t,
                                         aux)
            self._fused_frames += 1
        else:
            frame = self._classic_frame(img, aux, timestamp, mask_t)
            with self.map_lock:
                pose = tr.track(frame)
        self.frame_id += 1
        self.track_times.append(time.perf_counter() - t0)
        self._append_trajectory(timestamp, pose)
        return pose

    def _classic_frame(self, img: np.ndarray, aux, timestamp: float, mask_t) -> Frame:
        """The frame of the classic ladder: keypoints of ``img`` and, for a
        stereo or RGB-D camera, their right u and depth from ``aux``."""
        img_t = torch.from_numpy(img).to(self.device)
        kp = self.frontend.extract(img_t, mask_t)
        x_right = depth = None
        if aux is not None:
            aux_t = torch.from_numpy(aux).to(self.device)
            fxb = self.cam.focal_x_baseline
            x_right, depth = (
                stereo_match_dense(img_t, aux_t, kp.xy, kp.valid, fxb)
                if self.cam.setup == SetupType.STEREO else
                depth_at_keypoints(aux_t, kp.xy, self.cam.undistort_keypoints(kp.xy), kp.valid, fxb))
            x_right, depth = x_right.cpu().numpy(), depth.cpu().numpy()
        return Frame.from_keypoints(self.frame_id, timestamp, kp, self.cam, x_right=x_right,
                                    depth=depth)

    # ------------------------------------------------------------------
    # pipelined sequence feed
    # ------------------------------------------------------------------
    def feed_sequence(self, items, kind: str = "monocular", depth: int = 1):
        """Software-pipelined sequence feed.  ``items`` yields per-frame
        tuples, monocular ``(image, ts[, mask])``, stereo ``(left, right,
        ts[, mask])`` or RGB-D ``(rgb, depthmap, ts[, mask])``, and this
        generator yields ``(timestamp, pose_cw or None)`` in order.

        Up to ``depth`` fused steps stay in flight: frame N+depth is
        dispatched before frame N is finished, so frame N's host
        bookkeeping overlaps the device work of the frames behind it.  A
        dispatched step sees the map as of ``depth`` frames ago (the
        stale-map contract async mapping already grants) and predicts its
        pose ``depth + 1`` frames past the last finished one
        (``TrackingModule._predict_pose``).  A frame that leaves the common
        TRACKING path drains the pipeline and takes the classic ladder;
        when tracking breaks mid-flight, the younger in-flight steps are
        discarded and their frames replayed through the classic ladder.

        ``track_times`` records the yield-to-yield period per frame;
        ``pipe_stats`` the per-phase wall times."""
        return self._feed_sequence_timed(items, kind, depth)

    def _feed_sequence_timed(self, items, kind, depth):
        inner = self._feed_sequence_impl(items, kind, depth)
        t_last = time.perf_counter()
        for out in inner:
            now = time.perf_counter()
            # the classic path appends its own per-frame time; fused
            # finishes do not: fill in the yield-to-yield period
            if len(self.track_times) < len(self.trajectory):
                self.track_times.append(now - t_last)
            t_last = now
            yield out

    def _feed_sequence_impl(self, items, kind: str, depth: int):
        kind = kind.lower()
        if kind not in ("monocular", "stereo", "rgbd"):
            raise ValueError(f"unknown sequence kind: {kind}")
        feed_classic = self._feed_of(kind)
        depth = max(1, min(int(depth), 31))   # the tracker's pose-history bound
        tr = self.tracker
        inflight = collections.deque()        # dispatched, not finished
        self.pipe_stats = {"prep_s": [], "dispatch_s": [], "finish_s": []}

        def _finish(flight):
            t0 = time.perf_counter()
            with self.map_lock:
                pose, _ = tr.track_fused_finish(flight["h"])
            self._fused_frames += 1
            self.pipe_stats["finish_s"].append(time.perf_counter() - t0)
            self._append_trajectory(flight["ts"], pose)
            return pose

        def _discard_and_replay():
            """Tracking left the common path mid-flight: every younger step
            used a broken prediction; replay those frames through the
            classic ladder under the frame ids they consumed."""
            replay = list(inflight)
            inflight.clear()
            for fl in replay:
                self.frame_id = fl["fid"]
                yield fl["ts"], feed_classic(*fl["item"])

        def _drain(n_keep):
            while len(inflight) > n_keep:
                fl = inflight.popleft()
                yield fl["ts"], _finish(fl)
                if not self._use_fused():
                    yield from _discard_and_replay()
                    return

        for item in items:
            self._pace_mapper()      # backpressure before any lock is taken
            tp = time.perf_counter()
            n_img = 1 if kind == "monocular" else 2
            img, ts = self._to_gray(item[0]), item[n_img]
            aux = (None if kind == "monocular" else self._to_gray(item[1]) if kind == "stereo"
                   else self._metric_depth(item[1]))
            mask_t = self._mask_tensor(item[n_img + 1] if len(item) > n_img + 1 else None)
            self.pipe_stats["prep_s"].append(time.perf_counter() - tp)
            if self._use_fused():
                td = time.perf_counter()
                with self.map_lock:
                    h = tr.track_fused_dispatch(img, self.frame_id, ts, self._track_step, mask_t,
                                                aux)
                self.pipe_stats["dispatch_s"].append(time.perf_counter() - td)
                inflight.append({"h": h, "ts": ts, "fid": self.frame_id, "item": item})
                self.frame_id += 1
                yield from _drain(depth)
            else:
                # leave the common path: drain the pipeline, then feed this
                # frame through the classic ladder
                yield from _drain(0)
                yield ts, feed_classic(*item)
        yield from _drain(0)

    def _append_trajectory(self, ts: float, pose):
        """Record the frame pose plus its reference-KF-relative anchor."""
        self.trajectory.append((ts, None if pose is None else pose.copy()))
        with self.map_lock:
            db = self.map_db
            ref = self.tracker.ref_kf
            if pose is not None and 0 <= ref < db.n_kfs and db.kf_valid[ref]:
                rel = (pose @ np.linalg.inv(db.kf_pose_cw[ref])).astype(np.float32)
                self.traj_ref.append((int(ref), rel))
            else:
                self.traj_ref.append(None)

    def _to_gray(self, image: np.ndarray) -> np.ndarray:
        if image.ndim == 3:
            # reference default color order RGB; Rec.601 luma
            image = (0.299 * image[..., 0] + 0.587 * image[..., 1]
                     + 0.114 * image[..., 2]).astype(np.uint8)
        if self.cfg.raw.get("Preprocessing", {}).get("equalize_histogram", False):
            image = equalize_histogram(image)
        return image

    # ------------------------------------------------------------------
    def composed_poses(self):
        """(timestamps, poses_cw, tracked_mask) with each frame's pose composed
        from its reference keyframe's current pose: pose = T_rel @ T_refkf_cw
        (ref trajectory_io::save_frame_trajectory).  Culled reference
        keyframes compose through their cull-time spanning-tree parent chain
        (MapDatabase.culled_rel)."""
        with self.map_lock:
            return self._composed_poses_locked()

    def _composed_poses_locked(self):
        db = self.map_db
        ts = np.array([t for t, _ in self.trajectory])
        mask = np.array([p is not None for _, p in self.trajectory])
        poses = np.zeros((len(self.trajectory), 4, 4), np.float32)
        for i, (_, p) in enumerate(self.trajectory):
            if p is None:
                poses[i] = np.eye(4, dtype=np.float32)
                continue
            ref = self.traj_ref[i]
            if ref is None:
                poses[i] = p
                continue
            kf, rel = ref
            hops = 0
            while (0 <= kf < db.n_kfs and not db.kf_valid[kf] and kf in db.culled_rel
                   and hops < 256):
                parent, prel = db.culled_rel[kf]
                rel = rel @ prel
                kf = parent
                hops += 1
            poses[i] = rel @ db.kf_pose_cw[kf] if 0 <= kf < db.n_kfs and db.kf_valid[kf] else p
        return ts, poses, mask

    def tracked_poses(self):
        """(timestamps, poses_cw, tracked_mask) over all fed frames, as tracked."""
        ts = np.array([t for t, _ in self.trajectory])
        mask = np.array([p is not None for _, p in self.trajectory])
        poses = np.stack([p if p is not None else np.eye(4, dtype=np.float32)
                          for _, p in self.trajectory]) if self.trajectory \
            else np.zeros((0, 4, 4), np.float32)
        return ts, poses, mask

    def stats(self) -> dict:
        """Observability counters (tracked landmarks, KF count, frame times,
        mapping work, the async pipeline's waits and discards, worker
        exceptions, capacity overflows).  Taken under the map lock: the
        workers may be growing the map arrays."""
        with self.map_lock:
            return self._stats_locked()

    def _stats_locked(self) -> dict:
        tt = np.array(self.track_times) if self.track_times else np.zeros(1)
        m = self.mapper
        go = self.global_optimizer
        proxy = self._tracker_mapper
        return {
            "state": self.tracker.state.name,
            "frames_fed": self.frame_id,
            "frames_tracked": sum(p is not None for _, p in self.trajectory),
            "num_keyframes": int(len(self.map_db.valid_kf_ids())),
            "num_landmarks": int(len(self.map_db.valid_lm_ids())),
            "num_tracked_landmarks": self.tracker.num_tracked,
            "median_track_ms": float(np.median(tt) * 1000),
            "fps": float(1.0 / max(np.median(tt), 1e-9)),
            "fused_frames": self._fused_frames,
            "local_ba_runs": m.ba_runs,
            "local_ba_skipped": m.ba_skipped,
            "ba_iters_per_s": m.ba_iters_total / m.ba_wall_s if m.ba_wall_s > 0 else 0.0,
            "fetch_wait_s": self.tracker.fetch_wait_s,
            "loops_closed": go.num_loops_closed,
            "loop_checks_run": go.loop_checks_run,
            "loop_cands_seen": go.loop_cands_seen,
            "loop_validations": go.loop_validations,
            "reloc_attempts": go.relocalizer.attempts,
            # unlocked mapping results discarded because a whole-map geometry
            # rewrite landed meanwhile
            "stale_discards": m.stale_discards,
            "pred_hist_misses": self.tracker.pred_hist_misses,
            # feed-path backpressure
            "pace_waits": self._pace_waits,
            "pace_wait_s": self._pace_wait_s,
            "pace_wait_max_s": self._pace_wait_max,
            "pace_timeouts": getattr(proxy, "timeouts_hit", 0),
            # the loop worker (0 in synchronous mode)
            "loop_backlog": go.loop_backlog,
            "loop_stale_discards": go.loop_stale_discards,
            # exceptions raised on the worker threads, and the first one
            "worker_exceptions": go.faults.count,
            "worker_first_exception": go.faults.first,
            # entries dropped at a fixed-capacity boundary (local map cap, BA
            # windows): nonzero values mean the caps need raising
            "overflow": {**self.tracker.overflow, **m.overflow},
        }


class _AsyncMapperProxy:
    """Mapping off the tracking thread (ref: mapping runs on its own thread
    consuming a keyframe queue; tracking never waits for BA, and local BA
    is skipped when newer keyframes wait).  The tracker stores a keyframe
    on its own thread (``insert_keyframe``) and one worker processes the
    queue in order, on a CUDA stream of its own.  Exceptions the worker
    raises are recorded in ``faults`` and the worker goes on with the next
    keyframe."""

    def __init__(self, mapper, map_lock, faults: Optional[WorkerFaults] = None, device="cpu"):
        self.mapper = mapper
        self.map_lock = map_lock
        self.faults = faults if faults is not None else WorkerFaults()
        self.device = torch.device(device)
        self.pool = concurrent.futures.ThreadPoolExecutor(max_workers=1,
                                                          thread_name_prefix="mapping")
        self.queue = collections.deque()
        self._qlock = threading.Lock()
        self._future = None
        self._stream = None              # the worker's, made on its first drain
        self._resume_evt = threading.Event()
        self._resume_evt.set()
        # set after every processed keyframe: wait_for_backlog waits on it
        self._progress_evt = threading.Event()
        # per-keyframe processing times (System._pace_mapper bounds its wait
        # by twice their median)
        self.kf_proc_times = collections.deque(maxlen=32)
        self.timeouts_hit = 0

    def pause(self, wait: bool = False, timeout: float = 300.0):
        """Request a pause; with ``wait`` block until the keyframe in flight
        (if any) is done (the loop worker's handshake before a correction).
        Call it without the map lock held: the keyframe in flight needs the
        lock to finish.  Raises TimeoutError after ``timeout`` seconds."""
        self._resume_evt.clear()
        if wait:
            with self._qlock:
                fut = self._future
            if fut is not None:
                fut.result(timeout=timeout)

    def resume(self):
        self._resume_evt.set()
        with self._qlock:
            if self.queue and (self._future is None or self._future.done()):
                try:
                    self._future = self.pool.submit(self._drain)
                except RuntimeError:
                    pass        # the pool was shut down (System.shutdown)

    def clear(self):
        """Drop the queued keyframes (System.request_reset)."""
        with self._qlock:
            self.queue.clear()

    @property
    def paused(self) -> bool:
        return not self._resume_evt.is_set()

    def after_initialization(self, kf1, kf2):
        return self.mapper.after_initialization(kf1, kf2)

    def after_stereo_initialization(self, kf):
        return self.mapper.after_stereo_initialization(kf)

    @property
    def idle(self) -> bool:
        with self._qlock:
            return not self.queue and (self._future is None or self._future.done())

    @property
    def backlog(self) -> int:
        """Keyframes queued behind the one in flight (the tracker's
        keyframe-insertion gate reads this)."""
        with self._qlock:
            return len(self.queue)

    def wait_for_backlog(self, max_backlog: int = 1, timeout: float = 30.0) -> bool:
        """Block the caller until the queue drains to ``max_backlog``.  Returns
        True if it drained, False on an early out: at once while the mapper
        is paused (the queue cannot shrink), or when ``timeout`` expires
        (counted in ``timeouts_hit`` and logged)."""
        deadline = time.monotonic() + timeout
        while True:
            if self.backlog <= max_backlog:
                return True
            if not self._resume_evt.is_set():
                return False
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                self.timeouts_hit += 1
                _log.warning("wait_for_backlog timed out after %.1fs (backlog %d > %d); "
                             "feeding anyway", timeout, self.backlog, max_backlog)
                return False
            self._progress_evt.clear()
            self._progress_evt.wait(min(remaining, 0.25))

    def insert_keyframe(self, frame) -> int:
        """Store the keyframe now (the caller holds the map lock) and queue
        its processing."""
        t0 = time.perf_counter()
        kf = self.mapper.store_keyframe(frame)
        self.mapper._phase("store", t0)
        with self._qlock:
            self.queue.append(kf)
            if self._future is None or self._future.done():
                self._future = self.pool.submit(self._drain)
        return kf

    def _drain(self):
        if self._stream is None:
            self._stream = worker_stream(self.device)
        with on_stream(self._stream):
            while True:
                if not self._resume_evt.is_set():
                    return          # paused: resume() submits the drain again
                with self._qlock:
                    if not self.queue:
                        return
                    kf = self.queue.popleft()
                    backlog = len(self.queue) > 0
                t0 = time.perf_counter()
                try:
                    # local BA is skipped while newer keyframes wait
                    self.mapper.process_keyframe(kf, run_ba=not backlog)
                except Exception:
                    self.faults.record(f"mapping worker: keyframe {kf}")
                self.kf_proc_times.append(time.perf_counter() - t0)
                self._progress_evt.set()

    def drain(self, timeout: float = 300.0):
        """Process everything still queued, then stop the worker.  The loop
        worker may hold the mapper paused for a correction meanwhile: wait
        for its resume rather than drop the queue.  Raises TimeoutError if
        the queue is not empty after ``timeout`` seconds."""
        deadline = time.monotonic() + timeout
        while True:
            remaining = deadline - time.monotonic()
            with self._qlock:
                fut = self._future
            try:
                if remaining <= 0:
                    raise concurrent.futures.TimeoutError
                if fut is not None:
                    fut.result(timeout=remaining)
                with self._qlock:
                    pending = bool(self.queue)
                if not pending:
                    break
                if self._resume_evt.wait(timeout=min(5.0, max(remaining, 0.0))):
                    self.resume()
            except concurrent.futures.TimeoutError:
                self.pool.shutdown(wait=False)
                raise TimeoutError(f"mapping worker still busy after {timeout} s "
                                   f"({self.backlog} keyframes queued)") from None
        self.pool.shutdown(wait=True)
