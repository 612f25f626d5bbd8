"""System facade, mono with synchronous mapping (counterpart of
``openvslam_tpu/system.py``; ref ``system.h/.cc``): owns the front end, the
map database and the tracking, mapping and global optimization modules,
and exposes startup, shutdown, ``feed_monocular_frame``, the loop-detector
switches, reset and the trajectory accessors.

Tracking runs in the caller; mapping runs synchronously after each keyframe
insertion, and so does the loop pipeline (BoW registration, detection,
Sim3 validation, correction, pose graph, global BA).  The common TRACKING
path is one fused ``TrackStep`` per frame (kernels K1, K2, K3 on the card);
initialization, relocalization and the rare fallbacks take the classic
module ladder.

Not ported: async mapping, the pipelined ``feed_sequence``, the loop worker
and the background global BA, stereo and RGB-D, map IO, publishers and
autosave.
"""
from __future__ import annotations

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
from .utils.log import get_logger

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
    def __init__(self, cfg: Config, vocab_path: Optional[str] = None, device="cuda"):
        """``vocab_path`` None or "default" takes the package's vocabulary for
        the descriptor pattern; otherwise an npz vocabulary file."""
        self.device = resolve_device(device)
        if cfg.camera.setup != SetupType.MONOCULAR:
            raise NotImplementedError("only the monocular System is ported")
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
        # detection stays gated by cfg.loop.enabled inside the module
        self.global_optimizer = GlobalOptimizationModule(cfg, self.cam, self.map_db, vocab_path,
                                                         fix_scale=False, device=self.device)
        self.mapper = MappingModule(cfg, self.cam, self.map_db,
                                    global_optimizer=self.global_optimizer, device=self.device)
        self.tracker = TrackingModule(cfg, self.cam, self.map_db, mapper=self.mapper,
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
        self._track_step = TrackStep(self.cam, self.frontend,
                                     lm_capacity=TrackingModule.LOCAL_LM_CAP, device=self.device)
        self.frame_id = 0
        self._fused_frames = 0
        self.trajectory: List[tuple] = []   # (timestamp, pose_cw or None)
        # per-frame reference-keyframe anchor (ref trajectory_io: frame poses
        # are kept relative to their reference keyframe so that later BA
        # moves of the keyframe reach the frame): (ref_kf, T_rel) or None
        self.traj_ref: List[Optional[tuple]] = []
        self.track_times: List[float] = []  # per-frame wall time (ref track_times)

    # ------------------------------------------------------------------
    def startup(self):
        _log.info("system startup (monocular, %dx%d, sync mapping, %s)",
                  self.cam.cols, self.cam.rows, self.device)

    def shutdown(self):
        _log.info("system shutdown: %d frames, %d keyframes, %d landmarks",
                  len(self.trajectory), self.map_db.n_kfs, len(self.map_db.valid_lm_ids()))

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
        """Always False: the global BA runs inline in synchronous mode."""
        return self.global_optimizer.loop_BA_is_running()

    def request_reset(self):
        """Drop the map, the BoW database and the loop state; tracking
        starts over from initialization."""
        _log.info("map reset requested")
        self.map_db = MapDatabase(kpt_capacity=self.frontend.capacity)
        self.camera_name = self.map_db.register_camera(
            self.camera_name, camera_to_config(self.cam), make_default=True)
        self.mapper.reset(self.map_db)
        self.tracker.reset(self.map_db)
        self.global_optimizer.reset(self.map_db)
        self.trajectory.clear()
        self.traj_ref.clear()

    # ------------------------------------------------------------------
    def _use_fused(self) -> bool:
        """The fused TrackStep covers the common TRACKING path; every other
        state (init, Lost) takes the classic module ladder."""
        tr = self.tracker
        return (tr.state == TrackerState.TRACKING and tr.last_frame is not None
                and tr.last_frame.pose_cw is not None)

    def feed_monocular_frame(self, image: np.ndarray, timestamp: float,
                             mask: Optional[np.ndarray] = None):
        """image: (rows, cols) uint8 grayscale or (rows, cols, 3) color; mask:
        optional (rows, cols), > 0 = usable.  Returns pose_cw (4,4) or None."""
        img = self._to_gray(image)
        mask_t = (self._static_mask if mask is None
                  else torch.as_tensor(np.asarray(mask, np.float32), device=self.device))
        tr = self.tracker
        t0 = time.perf_counter()
        if self._use_fused():
            pose, _ = tr.track_fused(img, self.frame_id, timestamp, self._track_step, mask_t)
            self._fused_frames += 1
        else:
            kp = self.frontend.extract(torch.from_numpy(img).to(self.device), mask_t)
            frame = Frame.from_keypoints(self.frame_id, timestamp, kp, self.cam)
            pose = tr.track(frame)
        self.frame_id += 1
        self.track_times.append(time.perf_counter() - t0)
        self._append_trajectory(timestamp, pose)
        return pose

    def _append_trajectory(self, ts: float, pose):
        """Record the frame pose plus its reference-KF-relative anchor."""
        self.trajectory.append((ts, None if pose is None else pose.copy()))
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
        mapping work, capacity overflows)."""
        tt = np.array(self.track_times) if self.track_times else np.zeros(1)
        m = self.mapper
        go = self.global_optimizer
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
            "ba_iters_per_s": m.ba_iters_total / m.ba_wall_s if m.ba_wall_s > 0 else 0.0,
            "fetch_wait_s": self.tracker.fetch_wait_s,
            "loops_closed": go.num_loops_closed,
            "loop_checks_run": go.loop_checks_run,
            "loop_cands_seen": go.loop_cands_seen,
            "loop_validations": go.loop_validations,
            "reloc_attempts": go.relocalizer.attempts,
            # entries dropped at a fixed-capacity boundary (local map cap, BA
            # windows): nonzero values mean the caps need raising
            "overflow": {**self.tracker.overflow, **m.overflow},
        }
