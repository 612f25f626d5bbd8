"""Tracking module (counterpart of ``openvslam_tpu/module/tracking_module.py``;
ref ``tracking_module.*``): the per-frame state machine NotInitialized ->
Tracking <-> Lost.  A monocular camera bootstraps from two views, a stereo
or RGB-D camera from one frame's depths; their pose LM carries (u, v,
u_right) observations.

Host-side control flow over the numpy map; the numeric work runs on the
module's device: the two-view bootstrap, projection matching (kernel K2)
and the pose-only LM (kernel K3; plain PyTorch for an equirectangular
camera) of the classic ladder, and the fused TrackStep (K1, K2, K3) on the
common path.  The strategy order follows the
reference: motion-model match -> (fallback) BoW match vs the reference
keyframe -> (fallback) descriptor match vs the last frame -> local-map
tracking -> keyframe-insertion decision; a lost track relocalizes through
the BoW database (``module/relocalizer.py``).  With no mapper
(localization mode) the map stays frozen: no keyframe is inserted.

The fused step splits into ``track_fused_dispatch`` (build the tables,
launch, start the copies of the outputs to the host) and
``track_fused_finish`` (wait for the copies, host bookkeeping), so the
System's pipelined feed keeps several steps in flight; a step dispatched
``lead`` frames past the last finished one predicts its pose with the
damped lead-N twist of ``_predict_pose``.
"""
from __future__ import annotations

import collections
import enum
import time
from typing import Optional

import numpy as np
import torch

from ..camera.base import SetupType
from ..data import Frame
from ..device import resolve_device
from ..initialize.two_view import initialize_two_view
from ..models import tracking_ops as TO
from ..models.track_step import LastFrame, LocalMap, unpack_bits_host
from ..ops import bow as bow_ops
from ..ops import match as M
from ..optimize.pose_optimizer import make_pose_optimizer
from ..utils.log import get_logger

_log = get_logger("tracking")

LOST_THRESHOLD = 20      # local-map inliers below which tracking is lost


class TrackerState(enum.Enum):
    NOT_INITIALIZED = 0
    TRACKING = 1
    LOST = 2


def _u32_as_i32(desc: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(desc).view(np.int32)


def _se3_log(T: np.ndarray) -> np.ndarray:
    """4x4 rigid transform -> twist (w[3], v[3]), host numpy (the motion
    model's per-frame prediction; a device call would cost more)."""
    R = T[:3, :3].astype(np.float64)
    t = T[:3, 3].astype(np.float64)
    cos = np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)
    th = np.arccos(cos)
    if th < 1e-8:
        w = 0.5 * np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
        return np.concatenate([w, t])
    w = th / (2.0 * np.sin(th)) * np.array(
        [R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]]) / th
    # V^-1 = I - K*th/2 + (1 - th/(2 tan(th/2))) K^2
    Vinv = np.eye(3) - 0.5 * th * K + (1.0 - th / (2.0 * np.tan(th / 2.0))) * (K @ K)
    return np.concatenate([w, Vinv @ t])


def _se3_exp(xi: np.ndarray) -> np.ndarray:
    """twist (w[3], v[3]) -> 4x4 rigid transform (numpy; see _se3_log)."""
    w, v = xi[:3], xi[3:]
    th = np.linalg.norm(w)
    T = np.eye(4)
    if th < 1e-8:
        T[:3, 3] = v
        T[:3, :3] += np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
        return T
    k = w / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    s, c = np.sin(th), np.cos(th)
    T[:3, :3] = np.eye(3) + s * K + (1 - c) * (K @ K)
    V = np.eye(3) + (1 - c) / th * K + (th - s) / th * (K @ K)
    T[:3, 3] = V @ v
    return T


class TrackingModule:
    LOCAL_LM_CAP = 4096          # padded local-map landmark capacity
    # keyframe decay rule (cond_d): insert when the tracked count falls
    # below this fraction of its post-KF peak
    KF_PEAK_DECAY = 0.5
    # damped lead-N prediction window W = PRED_WINDOW_MULT * lead (see
    # _predict_pose)
    PRED_WINDOW_MULT = 2
    INIT_SEED = 42

    def __init__(self, cfg, cam, map_db, mapper=None, relocalizer=None, device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.cam = cam
        self.mapper = mapper
        self.relocalizer = relocalizer
        self.reset(map_db)
        self.gen = torch.Generator(device=self.device).manual_seed(self.INIT_SEED)
        nl = cfg.feature.num_levels
        sf = cfg.feature.scale_factor
        self.scale_factors = np.array([sf**l for l in range(nl)], np.float32)
        self.sigma2 = self.scale_factors**2
        self._scale_factors_dev = torch.from_numpy(self.scale_factors).to(self.device)
        self.stereo = cam.setup != SetupType.MONOCULAR
        self.pose_opt = make_pose_optimizer(cam, stereo=self.stereo)
        self.log_scale = float(np.log(sf))
        self.num_levels = nl
        # capacity-overflow accounting
        self.overflow: dict = {}
        # seconds the tracking thread waited for fused-step results
        self.fetch_wait_s = 0.0
        # lead-N predictions whose history entry was missing (they fell
        # back to the repeated one-frame velocity, see _predict_pose)
        self.pred_hist_misses = 0

    def reset(self, map_db):
        """Start over on ``map_db``: uninitialized, with no motion model, no
        cached local map and no relocalization bookkeeping."""
        self.map_db = map_db
        self.state = TrackerState.NOT_INITIALIZED
        self.init_frame: Optional[Frame] = None
        self.last_frame: Optional[Frame] = None
        self.velocity = np.eye(4, dtype=np.float32)   # T_cur @ inv(T_last)
        self.ref_kf = -1
        self.last_kf_frame_id = -1
        self.num_tracked = 0
        self._lm_cache = None      # device-resident local-map mirror
        self._frame_dev = None     # (frame, device columns) of the frame in hand
        self._peak_tracked = 0     # max inliers since the last keyframe
        self.frames_since_reloc = 1 << 30
        # where and how fast tracking died, for the post-loss grace window
        # of _relocalize
        self._lost_at: Optional[int] = None
        self._lost_center: Optional[np.ndarray] = None
        self._lost_speed = 0.0
        # recent (frame_id, pose_cw) of tracked frames for the lead-N
        # prediction: a dispatch at pipeline depth d looks up the pose
        # 2(d+1) frames back, and the System clamps d to 31
        self._pose_hist: collections.deque = collections.deque(maxlen=64)

    def close(self):
        """Release the device-resident caches (System.shutdown calls this)."""
        self._lm_cache = None
        self._frame_dev = None

    def _count_overflow(self, what: str, n: int):
        if what not in self.overflow:
            _log.warning("capacity overflow: %s dropped %d entries (first hit; "
                         "counted in System.stats()['overflow'])", what, n)
        self.overflow[what] = self.overflow.get(what, 0) + int(n)

    def _dev(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), device=self.device)

    def _frame_columns(self, frame: Frame) -> dict:
        """The frame's keypoint columns on the device, uploaded once."""
        if self._frame_dev is None or self._frame_dev[0] is not frame:
            obs = frame.xy_undist if not self.stereo else np.concatenate(
                [frame.xy_undist, frame.x_right[:, None]], -1).astype(np.float32)
            self._frame_dev = (frame, {
                "desc_u32": self._dev(_u32_as_i32(frame.desc_u32)),
                "und": self._dev(frame.xy_undist),
                "obs": self._dev(obs),
                "valid": self._dev(frame.valid),
                "level": self._dev(frame.level.astype(np.int64)),
                "sigma2": self._dev(self.sigma2[np.clip(frame.level, 0, self.num_levels - 1)]),
            })
        return self._frame_dev[1]

    # ------------------------------------------------------------------
    def track(self, frame: Frame) -> Optional[np.ndarray]:
        """Main entry: returns pose_cw (4,4) or None if not tracked."""
        if self.state == TrackerState.NOT_INITIALIZED:
            pose = self._try_initialize(frame)
        elif self.state == TrackerState.TRACKING:
            pose = self._track_frame(frame)
        else:
            pose = self._relocalize(frame)
        self.last_frame = frame
        return pose

    # ------------------------------------------------------------------
    # initialization
    # ------------------------------------------------------------------
    def _try_initialize(self, frame: Frame):
        if self.stereo:
            return self._initialize_with_depth(frame)
        if self.init_frame is None or self.init_frame.num_valid < 100:
            self.init_frame = frame
            return None
        res = initialize_two_view(self.gen, self.init_frame, frame, self.cam)
        if not res.success:
            # keep the reference frame while the views still overlap so the
            # baseline accumulates across attempts (ref mono initializer)
            if res.num_matches < 100 and frame.num_valid >= 100:
                self.init_frame = frame
            return None
        # normalize scale: median depth of inliers -> 1 (mono convention)
        good = res.is_inlier
        scale = 1.0 / max(np.median(res.points[good][:, 2]), 1e-6)
        T21 = res.T_21.copy()
        T21[:3, 3] *= scale
        pts = res.points * scale

        f1, f2 = self.init_frame, frame
        f1.pose_cw = np.eye(4, dtype=np.float32)
        f2.pose_cw = T21.astype(np.float32)
        db = self.map_db
        kf1 = db.add_keyframe(f1)
        kf2 = db.add_keyframe(f2)
        born = []
        for i in np.where(good)[0]:
            i1, i2 = int(res.idx1[i]), int(res.idx2[i])
            lm = db.add_landmark(pts[i].astype(np.float32), f2.desc_u32[i2], f2.desc_i8[i2], kf2)
            db.add_observation(lm, kf1, i1)
            db.add_observation(lm, kf2, i2)
            db.update_landmark_descriptor(lm)
            born.append(lm)
            f2.lm_idx[i2] = lm
            f1.lm_idx[i1] = lm
        db.update_landmark_geometry_batch(born, self.cfg.feature.scale_factor, self.num_levels)
        db.update_connections(kf1)
        db.update_connections(kf2)
        self.ref_kf = kf2
        self.last_kf_frame_id = f2.frame_id
        self.state = TrackerState.TRACKING
        _log.info("initialized map: two-view bootstrap frames %d/%d, %d landmarks",
                  f1.frame_id, f2.frame_id, int(good.sum()))
        self.velocity = np.eye(4, dtype=np.float32)
        self._pose_hist.clear()
        self._record_pose(f2)
        self.num_tracked = int(good.sum())
        # seed the decay rule's peak so the first keyframe after init does
        # not wait a full fps interval
        self._peak_tracked = self.num_tracked
        if self.mapper is not None:
            self.mapper.after_initialization(kf1, kf2)
        return f2.pose_cw

    def _initialize_with_depth(self, frame: Frame):
        """Stereo/RGB-D: bootstrap from one frame's depths (ref
        tracking_module initialization for non-monocular setups): every
        valid keypoint with a depth becomes a landmark of the first
        keyframe, at the frame's origin."""
        has_depth = frame.valid & (frame.depth > 0)
        if has_depth.sum() < 50:
            return None
        frame.pose_cw = np.eye(4, dtype=np.float32)
        db = self.map_db
        kf = db.add_keyframe(frame)
        bz = frame.bearing[:, 2]
        born = []
        for i in np.where(has_depth)[0]:
            if bz[i] <= 1e-6:
                continue
            X = frame.bearing[i] * (frame.depth[i] / bz[i])
            lm = db.add_landmark(X.astype(np.float32), frame.desc_u32[i], frame.desc_i8[i], kf)
            db.add_observation(lm, kf, int(i))
            born.append(lm)
            frame.lm_idx[i] = lm
        db.update_landmark_geometry_batch(born, self.cfg.feature.scale_factor, self.num_levels)
        db.update_connections(kf)
        self.ref_kf = kf
        self.last_kf_frame_id = frame.frame_id
        self.state = TrackerState.TRACKING
        _log.info("initialized map: depth bootstrap frame %d, %d landmarks", frame.frame_id,
                  int(has_depth.sum()))
        self.velocity = np.eye(4, dtype=np.float32)
        self._pose_hist.clear()
        self._record_pose(frame)
        self.num_tracked = int(has_depth.sum())
        self._peak_tracked = self.num_tracked
        if self.mapper is not None:
            self.mapper.after_stereo_initialization(kf)
        return frame.pose_cw

    # ------------------------------------------------------------------
    # frame-to-frame tracking (the classic ladder)
    # ------------------------------------------------------------------
    def _update_last_frame_landmarks(self):
        lf = self.last_frame
        db = self.map_db
        ids = np.where(lf.lm_idx >= 0)[0]
        if not len(ids):
            return
        lm = lf.lm_idx[ids]
        # resolve_replaced is the identity for live landmarks: only walk
        # replacement chains for the invalidated entries
        for j in np.where(~db.lm_valid[lm])[0]:
            lf.lm_idx[ids[j]] = db.resolve_replaced(int(lm[j]))

    def _pose_optimize(self, frame: Frame, T_init: np.ndarray):
        fc = self._frame_columns(frame)
        obs_mask = (frame.lm_idx >= 0) & frame.valid
        X = self.map_db.lm_pos[np.clip(frame.lm_idx, 0, None)]
        res = self.pose_opt(self._dev(np.asarray(T_init, np.float32)), self._dev(X), fc["obs"],
                            fc["sigma2"], self._dev(obs_mask))
        frame.outlier = obs_mask & ~res.inliers.cpu().numpy()
        return res.T_cw.cpu().numpy(), int(res.num_inliers)

    def _match_by_projection(self, frame: Frame, T, pos, desc_u32, valid, pred_lvl, radius,
                             kpt_valid=None):
        fc = self._frame_columns(frame)
        kv = fc["valid"] if kpt_valid is None else self._dev(kpt_valid)
        idx, _, vis = TO.match_landmarks_by_projection(
            self.cam, self._dev(np.asarray(T, np.float32)), pos, desc_u32, valid,
            fc["desc_u32"], fc["und"], kv, fc["level"], float(radius),
            self._scale_factors_dev, pred_lvl)
        return idx.cpu().numpy(), vis

    def _motion_match(self, frame: Frame, T_pred, radius):
        """Match the last frame's landmarks into the current frame by projection."""
        lf = self.last_frame
        ids = np.where((lf.lm_idx >= 0) & lf.valid & ~lf.outlier)[0]
        if len(ids) == 0:
            return 0
        L = self.LOCAL_LM_CAP
        n = min(len(ids), L)
        ids = ids[:n]
        lm_ids = lf.lm_idx[ids]
        pos = np.zeros((L, 3), np.float32)
        desc = np.zeros((L, 8), np.int32)
        valid = np.zeros(L, bool)
        pred_lvl = np.full(L, -1, np.int64)
        pos[:n] = self.map_db.lm_pos[lm_ids]
        desc[:n] = _u32_as_i32(self.map_db.lm_desc_u32[lm_ids])
        valid[:n] = True
        pred_lvl[:n] = lf.level[ids]
        idx, _ = self._match_by_projection(frame, T_pred, self._dev(pos), self._dev(desc),
                                           self._dev(valid), self._dev(pred_lvl), radius)
        nmatch = 0
        for j in np.where(idx >= 0)[0]:
            kpt = int(idx[j])
            if frame.lm_idx[kpt] < 0:
                frame.lm_idx[kpt] = lm_ids[j]
                nmatch += 1
        return nmatch

    def _refresh_local_map_cache(self, seed_lms: np.ndarray):
        """Device-resident local-map mirror, rebuilt only when the map
        changed (db.version) or the reference KF moved."""
        db = self.map_db
        key = (db.version, self.ref_kf)
        if self._lm_cache is not None and self._lm_cache["key"] == key:
            return self._lm_cache
        _, local_lms = db.acquire_local_map(seed_lms, max_kfs=60)
        L = self.LOCAL_LM_CAP
        if len(local_lms) > L:
            self._count_overflow("local_map_lms", len(local_lms) - L)
            # keep the most-established landmarks (observation count)
            local_lms = np.asarray(local_lms, np.int64)
            keep = np.argpartition(-db.lm_num_obs[local_lms], L - 1)[:L]
            local_lms = local_lms[np.sort(keep)]
        n = min(len(local_lms), L)
        cand = np.asarray(local_lms[:n], np.int64)
        pos = np.zeros((L, 3), np.float32)
        desc = np.zeros((L, 8), np.int32)
        valid = np.zeros(L, bool)
        maxd = np.zeros(L, np.float32)
        if n:
            pos[:n] = db.lm_pos[cand]
            desc[:n] = _u32_as_i32(db.lm_desc_u32[cand])
            valid[:n] = True
            maxd[:n] = db.lm_max_dist[cand]
        self._lm_cache = {"key": key, "cand": cand, "n": n, "pos": self._dev(pos),
                          "desc_u32": self._dev(desc), "valid": self._dev(valid),
                          "maxd": self._dev(maxd)}
        return self._lm_cache

    def _track_local_map(self, frame: Frame, T_cur, radius=None):
        db = self.map_db
        cache = self._refresh_local_map_cache(frame.lm_idx[frame.lm_idx >= 0])
        n = cache["n"]
        if n == 0:
            return T_cur, self.num_tracked
        pred = TO.predict_scale_levels(cache["pos"], self._dev(np.asarray(T_cur, np.float32)),
                                       cache["maxd"], self.num_levels, self.log_scale)
        # only unmatched keypoints take part (matched lms are post-filtered)
        kpt_free = frame.valid & (frame.lm_idx < 0)
        if radius is None:
            radius = 4.0 if int((frame.lm_idx >= 0).sum()) >= 50 else 9.0
        idx, vis = self._match_by_projection(frame, T_cur, cache["pos"], cache["desc_u32"],
                                             cache["valid"], pred, radius, kpt_valid=kpt_free)
        cand = cache["cand"]
        db.lm_n_visible[cand[vis.cpu().numpy()[:n]]] += 1
        already = set(int(x) for x in frame.lm_idx[frame.lm_idx >= 0])
        for j in np.where(idx[:n] >= 0)[0]:
            lm = int(cand[j])
            if lm in already or not db.lm_valid[lm]:
                continue
            kpt = int(idx[j])
            if frame.lm_idx[kpt] < 0:
                frame.lm_idx[kpt] = lm
        T_new, num_inl = self._pose_optimize(frame, T_cur)
        db.lm_n_found[frame.lm_idx[(frame.lm_idx >= 0) & ~frame.outlier]] += 1
        return T_new, num_inl

    def _rescue_with_local_map(self, frame: Frame, T_pred):
        """Wide-radius local-map association at the predicted pose, then pose
        optimization: recovers frames whose frame-to-frame matching broke
        while the local map is still valid."""
        lf = self.last_frame
        self._refresh_local_map_cache(lf.lm_idx[lf.lm_idx >= 0])
        frame.lm_idx[:] = -1
        frame.outlier[:] = False
        T_cur, num_inl = self._track_local_map(frame, T_pred, radius=15.0)
        if not (frame.lm_idx >= 0).any():
            return T_pred, 0
        return T_cur, num_inl

    def _rescue_acceptable(self, T_cur, T_pred, num_inl: int) -> bool:
        """A thin (12+) inlier set counts when the optimized pose agrees with
        the constant-velocity prediction: translation residual under
        max(1.5x the frame displacement, 0.5), rotation under 10 degrees.
        Disabled inside the 30-frame post-relocalization window, where the
        prediction is itself seeded from the relocalization that the
        stricter gate distrusts."""
        if num_inl < 12 or self.frames_since_reloc <= 30:
            return False
        d = np.linalg.inv(T_pred) @ T_cur
        dt = float(np.linalg.norm(d[:3, 3]))
        dr = float(np.arccos(np.clip((np.trace(d[:3, :3]) - 1) / 2, -1, 1)))
        v_t = float(np.linalg.norm(self.velocity[:3, 3]))
        return dt < max(1.5 * v_t, 0.5) and dr < np.deg2rad(10.0)

    def _go_lost(self, frame: Frame, why: str):
        """Transition to Lost, recording the frame, camera centre and speed
        at the loss for the post-loss grace window of _relocalize."""
        self.state = TrackerState.LOST
        _log.info("tracking lost at frame %d: %s", frame.frame_id, why)
        frame.pose_cw = None
        self._lost_at = frame.frame_id
        lp = self.last_frame.pose_cw if self.last_frame is not None else None
        if lp is not None:
            self._lost_center = (-lp[:3, :3].T @ lp[:3, 3]).astype(np.float64)
            self._lost_speed = max(float(np.linalg.norm(self.velocity[:3, 3])), 1e-3)
        else:
            self._lost_center = None

    def _lost_threshold(self) -> int:
        """Local-map inliers below which tracking is lost: stricter for 30
        frames after a relocalization."""
        return LOST_THRESHOLD if self.frames_since_reloc > 30 else 50

    def _track_frame(self, frame: Frame):
        self._update_last_frame_landmarks()
        T_pred = (self.velocity @ self.last_frame.pose_cw).astype(np.float32)
        T_mm_pred = T_pred
        nmatch = self._motion_match(frame, T_pred, radius=7.0)
        if nmatch < 20:
            frame.lm_idx[:] = -1
            nmatch = self._motion_match(frame, T_pred, radius=14.0)
        if nmatch < 20:
            # fallback 1 (ref bow_match_based_track): word-gated match against
            # the reference keyframe's landmarks
            nmatch = self._bow_match_ref_kf(frame)
            if nmatch >= 20:
                T_pred = self.last_frame.pose_cw
        if nmatch < 20:
            # fallback 2: unconstrained descriptor match against the last frame
            n2 = self._fallback_match_last_frame(frame)
            if n2 > nmatch:
                nmatch = n2
                T_pred = self.last_frame.pose_cw
        thr = self._lost_threshold()
        weak_ok = False
        if nmatch < 10:
            # frame-to-frame association collapsed while the map may still
            # be fine: one wide local-map search at the predicted pose
            T_cur, num_inl = self._rescue_with_local_map(frame, T_mm_pred)
            weak_ok = self._rescue_acceptable(T_cur, T_mm_pred, num_inl)
            if num_inl < thr and not weak_ok:
                self._go_lost(frame, f"{nmatch} matches after all strategies "
                                     f"(+rescue {num_inl} inliers)")
                return None
        else:
            T_cur, num_inl = self._pose_optimize(frame, T_pred)
            if num_inl < 10:
                T_cur, num_inl = self._rescue_with_local_map(frame, T_mm_pred)
                weak_ok = self._rescue_acceptable(T_cur, T_mm_pred, num_inl)
                if num_inl < thr and not weak_ok:
                    self._go_lost(frame, f"{num_inl} inliers after pose optimization")
                    return None
            else:
                # drop outlier associations before the local-map search
                frame.lm_idx[frame.outlier] = -1
                frame.outlier[:] = False
                T_cur, num_inl = self._track_local_map(frame, T_cur)
        if num_inl < thr and not weak_ok:
            # borderline count on the normal path: accept when the pose
            # agrees with the motion prediction
            weak_ok = self._rescue_acceptable(T_cur, T_mm_pred, num_inl)
        if num_inl < thr and not weak_ok:
            self._go_lost(frame, f"{num_inl} local-map inliers (threshold {thr})")
            return None
        frame.pose_cw = T_cur.astype(np.float32)
        self._accept(frame, num_inl)
        return frame.pose_cw

    def _accept(self, frame: Frame, num_inl: int):
        """Bookkeeping of a tracked frame: counts, velocity, keyframe."""
        self.num_tracked = num_inl
        self._peak_tracked = max(self._peak_tracked, num_inl)
        self.velocity = (frame.pose_cw @ np.linalg.inv(self.last_frame.pose_cw)).astype(np.float32)
        self._record_pose(frame)
        self.frames_since_reloc += 1
        if self._new_keyframe_needed(frame):
            self._insert_keyframe(frame)

    def _record_pose(self, frame: Frame):
        self._pose_hist.append((frame.frame_id, frame.pose_cw.copy()))

    def _predict_pose(self, lf: Frame, lead: int) -> np.ndarray:
        """Constant-velocity pose prediction ``lead`` frames past ``lf``.
        For lead >= 2 (the pipelined feed) the one-frame velocity must not
        be applied repeatedly: that multiplies the pose-estimation noise
        into the prediction, and the prediction -> match -> estimate loop
        amplifies it every cycle.  The damped form estimates the average
        per-frame twist over a window W = PRED_WINDOW_MULT * lead in SE3 log
        space and scales it to ``lead``:
            xi = log(pose(i-1) pose(i-1-W)^-1) / W
            T_pred = exp(lead xi) pose(i-1)
        exact for constant-twist motion, with the window's noise term
        scaled by lead / W.  The shortest usable window is W = lead (the
        raw lead-frame displacement); with no history entry in the window
        the one-frame velocity is applied ``lead`` times and the miss is
        counted in ``pred_hist_misses``."""
        if lead >= 2:
            best_fid = None
            lo = lf.frame_id - self.PRED_WINDOW_MULT * lead
            hi = lf.frame_id - lead
            for fid, pose in self._pose_hist:
                if lo <= fid <= hi and (best_fid is None or fid < best_fid):
                    best_fid, best_pose = fid, pose
            if best_fid is not None:
                W = lf.frame_id - best_fid
                D = lf.pose_cw @ np.linalg.inv(best_pose)
                if W == lead:
                    return (D @ lf.pose_cw).astype(np.float32)
                xi = _se3_log(D) * (lead / W)
                return (_se3_exp(xi) @ lf.pose_cw).astype(np.float32)
            self.pred_hist_misses += 1
        T_pred = lf.pose_cw
        for _ in range(max(1, lead)):
            T_pred = self.velocity @ T_pred
        return T_pred.astype(np.float32)

    def _bow_match_ref_kf(self, frame: Frame):
        """Word-gated descriptor match against the reference keyframe's
        landmarks (ref frame_tracker::bow_match_based_track)."""
        if self.relocalizer is None or self.ref_kf < 0:
            return 0
        bow_db = self.relocalizer.bow_db
        db = self.map_db
        if self.ref_kf not in bow_db.kf_words:
            return 0
        words = bow_db.compute_words(frame.desc_i8, frame.valid)
        gate = bow_ops.word_gate(self._dev(bow_db.gate_words(words)),
                                 self._dev(bow_db.gate_words(bow_db.kf_words[self.ref_kf])))
        has_lm = (db.kf_lm_idx[self.ref_kf] >= 0) & db.kf_kpt_valid[self.ref_kf]
        idx, _ = M.match_descriptors(self._dev(frame.desc_i8),
                                     self._dev(db.kf_desc_i8[self.ref_kf]),
                                     self._dev(frame.valid), self._dev(has_lm), gate=gate,
                                     max_dist=M.HAMMING_DIST_THR_LOW, ratio=0.9,
                                     cross_check=True)
        idx = idx.cpu().numpy()
        n = 0
        for i in np.where(idx >= 0)[0]:
            lm = int(db.kf_lm_idx[self.ref_kf][idx[i]])
            if lm >= 0 and db.lm_valid[lm] and frame.lm_idx[i] < 0:
                frame.lm_idx[i] = lm
                n += 1
        return n

    def _fallback_match_last_frame(self, frame: Frame):
        lf = self.last_frame
        has_lm = (lf.lm_idx >= 0) & lf.valid
        idx, _ = M.match_descriptors(self._dev(lf.desc_i8), self._dev(frame.desc_i8),
                                     self._dev(has_lm), self._dev(frame.valid),
                                     max_dist=M.HAMMING_DIST_THR_LOW, ratio=0.9,
                                     cross_check=True)
        idx = idx.cpu().numpy()
        n = 0
        for i in np.where(idx >= 0)[0]:
            kpt = int(idx[i])
            if frame.lm_idx[kpt] < 0:
                frame.lm_idx[kpt] = lf.lm_idx[i]
                n += 1
        return n

    # ------------------------------------------------------------------
    # fused tracking path (models.track_step): one step per frame
    # ------------------------------------------------------------------
    def track_fused(self, image_u8, frame_id: int, timestamp: float, step, mask=None,
                    aux=None):
        """Drive one frame through the fused TrackStep.  Preconditions:
        state == TRACKING with a tracked last frame (the caller takes the
        classic path otherwise).  Returns (pose or None, Frame)."""
        return self.track_fused_finish(self.track_fused_dispatch(
            image_u8, frame_id, timestamp, step, mask, aux))

    def track_fused_dispatch(self, image_u8, frame_id: int, timestamp: float, step, mask=None,
                             aux=None):
        """Build the step's tables, launch it and start copying its outputs
        to the host; nothing waits for the device.  ``aux`` is the step's
        right image (stereo) or metric depth map (rgbd).  The motion prediction
        reaches ``frame_id - last_frame.frame_id`` frames ahead: 1 when fed
        frame by frame, more in the pipelined feed, which dispatches frames
        before the earlier ones are finished.  Returns the in-flight handle
        for ``track_fused_finish``."""
        db = self.map_db
        self._update_last_frame_landmarks()
        lf = self.last_frame
        ids = np.where((lf.lm_idx >= 0) & lf.valid & ~lf.outlier)[0]
        lm_ids = lf.lm_idx[ids]
        keep = db.lm_valid[lm_ids]
        ids, lm_ids = ids[keep], lm_ids[keep]
        P = step.prev_capacity
        if len(lm_ids) > P:
            self._count_overflow("prev_frame_lms", len(lm_ids) - P)
        n = min(len(lm_ids), P)
        ids, lm_ids = ids[:n], lm_ids[:n]
        prev_pos = np.zeros((P, 3), np.float32)
        prev_desc = np.zeros((P, 8), np.int32)
        prev_valid = np.zeros(P, bool)
        prev_level = np.full(P, -1, np.int64)
        prev_pos[:n] = db.lm_pos[lm_ids]
        prev_desc[:n] = _u32_as_i32(db.lm_desc_u32[lm_ids])
        prev_valid[:n] = True
        prev_level[:n] = lf.level[ids]

        cache = self._refresh_local_map_cache(lm_ids)
        cand = cache["cand"]
        # map local slots to last-frame slots for exact stage-2 dedup
        loc_prev_slot = np.full(step.lm_capacity, -1, np.int64)
        if n and len(cand):
            order = np.argsort(lm_ids, kind="stable")
            sorted_ids = lm_ids[order]
            posc = np.clip(np.searchsorted(sorted_ids, cand), 0, len(sorted_ids) - 1)
            loc_prev_slot[:len(cand)] = np.where(sorted_ids[posc] == cand, order[posc], -1)

        lead = max(1, frame_id - lf.frame_id)
        T_pred = self._predict_pose(lf, lead)
        last = LastFrame(self._dev(prev_pos), self._dev(prev_desc), self._dev(prev_valid),
                         self._dev(prev_level))
        local = LocalMap(cache["pos"], cache["desc_u32"], cache["valid"], cache["maxd"],
                         self._dev(loc_prev_slot))
        res = step.step(self._dev(image_u8), mask, self._dev(T_pred), last, local,
                        None if aux is None else self._dev(aux))
        host, ready = self._start_readback(res)
        # a step more than one frame ahead with fewer than two tracked poses
        # since (re)initialization had no motion model behind its
        # prediction (the velocity is the identity): its finish replays the
        # classic ladder, which predicts from the frames finished by then
        blind = lead > 1 and len(self._pose_hist) < 2
        return {"res": host, "ready": ready, "frame_id": frame_id, "timestamp": timestamp,
                "lm_ids": lm_ids, "n": n, "cand": cand, "n_loc": cache["n"],
                "P": P, "L": step.lm_capacity, "blind": blind}

    def _start_readback(self, res):
        """On the card: copy every output into pinned host memory behind
        the step on the current stream and record an event after the
        copies, so the finish waits for this step alone and not for the
        younger steps queued behind it.  Off the card the outputs already
        are host tensors."""
        if self.device.type != "cuda":
            return res, None
        host = type(res)(*(torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
                           .copy_(x, non_blocking=True) for x in res))
        ready = torch.cuda.Event()
        ready.record()
        return host, ready

    def track_fused_finish(self, handle):
        """Wait for an in-flight step's outputs and run the host bookkeeping
        (association, counters, velocity, keyframe decision).  Between a
        pipelined dispatch and this finish the mapper may have fused or
        culled landmarks: fused ones are forwarded to their replacement,
        culled ones dropped (the stale-map contract of async mapping)."""
        db = self.map_db
        lf = self.last_frame
        lm_ids, n = handle["lm_ids"], handle["n"]
        cand, n_loc = handle["cand"], handle["n_loc"]
        P, L = handle["P"], handle["L"]
        t0 = time.perf_counter()
        if handle["ready"] is not None:
            handle["ready"].synchronize()
        res = type(handle["res"])(*(x.numpy() for x in handle["res"]))
        self.fetch_wait_s += time.perf_counter() - t0
        K = res.kp_xy.shape[0]
        desc_u32 = res.kp_desc_u32.view(np.uint32)
        frame = Frame(
            frame_id=handle["frame_id"], timestamp=handle["timestamp"],
            xy=res.kp_xy, xy_undist=res.kp_und, bearing=res.kp_bearing,
            level=res.kp_level, angle=res.kp_angle, response=res.kp_response,
            desc_u32=desc_u32, desc_i8=unpack_bits_host(desc_u32, res.kp_valid),
            valid=res.kp_valid, x_right=res.kp_x_right.astype(np.float32),
            depth=res.kp_depth.astype(np.float32),
            lm_idx=np.full(K, -1, np.int32), outlier=np.zeros(K, bool))
        n2 = int(res.num_inliers)
        if handle["blind"] or int(res.n_stage1) < 10 or n2 < self._lost_threshold():
            # rare path: replay the classic ladder on the extracted frame
            pose = self._track_frame(frame)
            self.last_frame = frame
            return pose, frame

        # landmark bookkeeping (host, vectorized): slots -> landmark ids
        src = res.kp_src.astype(np.int64)
        comb = np.full(P + L, -1, np.int64)
        comb[:n] = lm_ids
        comb[P:P + n_loc] = cand[:n_loc]
        lm_of_kpt = np.where(src >= 0, comb[np.clip(src, 0, P + L - 1)], -1)
        # landmarks fused away since the dispatch are forwarded to their
        # replacement, unless this frame already observes it
        stale = (lm_of_kpt >= 0) & ~db.lm_valid[np.clip(lm_of_kpt, 0, None)]
        for j in np.where(stale)[0]:
            r = db.resolve_replaced(int(lm_of_kpt[j]))
            lm_of_kpt[j] = -1 if r >= 0 and (lm_of_kpt == r).any() else r
        lm_of_kpt = np.where((lm_of_kpt >= 0) & db.lm_valid[np.clip(lm_of_kpt, 0, None)],
                             lm_of_kpt, -1)
        frame.lm_idx = lm_of_kpt.astype(np.int32)
        frame.outlier = (frame.lm_idx >= 0) & ~res.kp_inlier
        vis_ids = cand[:n_loc][res.loc_visible[:n_loc]]
        vis_ids = vis_ids[db.lm_valid[vis_ids]]      # culled since the dispatch
        db.lm_n_visible[vis_ids] += 1
        db.lm_n_found[frame.lm_idx[(frame.lm_idx >= 0) & ~frame.outlier]] += 1

        frame.pose_cw = res.T_cw.astype(np.float32)
        self._accept(frame, n2)
        self.last_frame = frame
        return frame.pose_cw, frame

    # ------------------------------------------------------------------
    # keyframe insertion (ref module/keyframe_inserter)
    # ------------------------------------------------------------------
    def _new_keyframe_needed(self, frame: Frame) -> bool:
        if self.mapper is None:
            return False            # localization mode: the map is frozen
        db = self.map_db
        if self.ref_kf < 0 or self.ref_kf >= len(db.kf_valid) or not db.kf_valid[self.ref_kf]:
            # no live reference keyframe (it was culled): insert one as soon
            # as tracking is reliable
            return self.num_tracked > 15
        # reliable landmarks in reference KF (>=3 observers after 2+ KFs)
        min_obs = 3 if db.n_kfs > 2 else 2
        ref_arr = db.kf_lm_idx[self.ref_kf]
        ref_lms = ref_arr[ref_arr >= 0]
        n_reliable = int((db.lm_num_obs[ref_lms] >= min_obs).sum()) if len(ref_lms) else 0
        frames_since = frame.frame_id - self.last_kf_frame_id
        cond_a = frames_since >= int(self.cam.fps)
        cond_c = self.num_tracked < n_reliable * 0.9
        # decay rule (beyond the reference): insert when the tracked count
        # halves from its post-KF peak so triangulation refills the leading
        # edge early under sustained panning
        cond_d = frames_since >= 1 and self.num_tracked < self.KF_PEAK_DECAY * self._peak_tracked
        enough = self.num_tracked > 15
        # ref keyframe_inserter: the mapping queue gates insertion.  With
        # async mapping saturated (>= 2 queued keyframes) new keyframes wait
        # unless the tracked count decays toward the lost threshold
        if self.mapper.backlog >= 2:
            return enough and self.num_tracked < 60
        return enough and (cond_a or cond_c or cond_d)

    def _insert_keyframe(self, frame: Frame):
        kf = self.mapper.insert_keyframe(frame)
        _log.debug("keyframe %d inserted at frame %d (%d tracked)",
                   kf, frame.frame_id, self.num_tracked)
        self.ref_kf = kf
        self.last_kf_frame_id = frame.frame_id
        self._peak_tracked = 0

    # ------------------------------------------------------------------
    # relocalization (ref module/relocalizer) with a post-loss grace window
    # ------------------------------------------------------------------
    GRACE_FRAMES = 90        # post-loss window with the relaxed gate
    GRACE_GATE = 25          # inlier gate inside the window (normal: 40)

    def _relocalize(self, frame: Frame):
        """For GRACE_FRAMES after a loss the camera is still near the map it
        just built, so the relaxed gate applies, but only to a pose within
        the distance the camera can have travelled since the loss (in map
        units, from the last speed); otherwise the normal gate holds."""
        if self.relocalizer is None:
            return None
        d_lost = frame.frame_id - self._lost_at if self._lost_at is not None else None
        grace = (d_lost is not None and d_lost <= self.GRACE_FRAMES
                 and self._lost_center is not None)
        T = self.relocalizer.relocalize(frame, min_inliers=self.GRACE_GATE if grace else None)
        if T is None:
            return None
        gate = 40
        if grace:
            c = -T[:3, :3].T.astype(np.float64) @ T[:3, 3]
            bound = max(3.0 * self._lost_speed, 1.5 * self._lost_speed * (d_lost + 10))
            if float(np.linalg.norm(c - self._lost_center)) <= bound:
                gate = self.GRACE_GATE
        frame.pose_cw = T.astype(np.float32)
        T_cur, num_inl = self._track_local_map(frame, frame.pose_cw)
        if num_inl < gate:
            # the reference accepts a relocalization only at ~50 inliers:
            # under perceptual aliasing a ~30-inlier success is often false
            frame.pose_cw = None
            return None
        frame.pose_cw = T_cur.astype(np.float32)
        self.state = TrackerState.TRACKING
        _log.info("relocalized at frame %d (%d local-map inliers%s)", frame.frame_id, num_inl,
                  ", grace" if gate == self.GRACE_GATE else "")
        self.velocity = np.eye(4, dtype=np.float32)
        self._pose_hist.clear()
        self._record_pose(frame)
        # re-anchor on the keyframe the relocalizer matched
        if self.relocalizer.last_reloc_kf >= 0:
            self.ref_kf = self.relocalizer.last_reloc_kf
            self.last_kf_frame_id = frame.frame_id
        self.num_tracked = num_inl
        # a spatially verified grace relocalization skips the 30-frame
        # distrust window (the proximity bound is the evidence it gathers)
        self.frames_since_reloc = 31 if gate == self.GRACE_GATE else 0
        self._lost_at = None
        self._lost_center = None
        return frame.pose_cw
