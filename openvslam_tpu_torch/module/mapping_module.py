"""Mapping module (counterpart of
``openvslam_tpu/module/mapping_module.py``; ref ``mapping_module.*``):
keyframe insertion pipeline — store KF (stereo/RGB-D: seed landmarks from
measured depth), cull fresh landmarks, triangulate new landmarks with
covisible keyframes, fuse duplicates, local BA (stereo edges for a stereo
or RGB-D camera), cull redundant keyframes, hand-off to the global
optimization module (BoW registration and loop detection).

Host orchestration over the numpy map database; the numeric work runs on
the module's device: epipolar-gated matching, checked triangulation,
projection fusion and the dense-Schur local BA.  The immutable keypoint
columns of each keyframe are uploaded once and kept on the device.

Synchronous by default (``insert_keyframe`` stores and processes).  In
async mode the System's mapping worker calls ``process_keyframe`` with the
shared ``map_lock`` set: each stage snapshots the map under the lock, runs
its device work without it, and applies the result under the lock only if
no whole-map geometry rewrite (loop correction, pose graph, global BA)
moved ``db.geom_version`` meanwhile; otherwise the result is discarded and
counted in ``stale_discards``.

Not ported here: the multi-camera BA window (merged sessions).
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import List, Tuple

import numpy as np
import torch

from ..camera.base import SetupType
from ..device import resolve_device
from ..models import tracking_ops as TO
from ..optimize.ba import BAProblem, make_local_ba
from ..utils.log import get_logger

_log = get_logger("mapping")


class MappingModule:
    # solver iteration schedule (ref local_bundle_adjuster: LM 5 iters,
    # outlier removal, 10 more)
    BA_FIRST_ITERS, BA_SECOND_ITERS = 5, 10
    # local BA buckets: cameras (local + fixed), landmarks, observations
    C, L, O = 24, 4096, 16384

    def __init__(self, cfg, cam, map_db, global_optimizer=None, device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.cam = cam
        self.db = map_db
        self.global_optimizer = global_optimizer
        nl = cfg.feature.num_levels
        sf = cfg.feature.scale_factor
        self.scale_factors = np.array([sf**l for l in range(nl)], np.float32)
        self.sigma2 = self.scale_factors**2
        self.num_levels = nl
        self.stereo = cam.setup != SetupType.MONOCULAR
        self.local_ba = make_local_ba(cam, self.BA_FIRST_ITERS, self.BA_SECOND_ITERS,
                                      stereo=self.stereo)
        self.recent_lms: List[Tuple[int, int]] = []   # (lm, born_kf)
        self.num_covis_for_triangulation = 10
        # capacity-overflow accounting: every silent truncation is counted
        # and WARN-logged on first occurrence
        self.overflow: dict = {}
        self.ba_runs = 0
        self.ba_skipped = 0             # skipped on a backlog (async mode)
        self.ba_iters_total = 0
        self.ba_wall_s = 0.0
        self.lms_culled = 0
        self.kfs_culled = 0
        self.lms_created = 0
        self.lms_created_seed = 0       # of which seeded from depth
        self.seeds_skipped = 0          # depth seeds refused by the cell budget
        self.culled_ratio = 0           # found/visible ratio cull
        self.culled_obs = 0             # num_obs <= 2 at age 2 cull
        # unlocked device results discarded because a whole-map geometry
        # rewrite landed while they were computed (async mode)
        self.stale_discards = 0
        # per-phase wall-clock accumulators for the KF-insertion pipeline
        self.phase_s: dict = {}
        # kf -> device-resident keypoint columns; the tracking thread fills
        # it (store_keyframe) while the mapping worker reads and prunes it
        self._dev_kf: dict = {}
        self._dev_kf_lock = threading.Lock()
        self._scale_factors_dev = torch.from_numpy(self.scale_factors).to(self.device)
        # the map lock of the async pipeline (System sets it): held around
        # map reads and write-backs, released during the device work
        self.map_lock = None

    # synchronous mapping never queues: the tracker's backlog gate reads 0
    # (the System's async proxy reports its queue instead)
    backlog = 0

    def reset(self, map_db):
        """Start over on ``map_db``: no recent landmarks, no cached keyframe
        columns."""
        self.db = map_db
        self.recent_lms = []
        with self._dev_kf_lock:
            self._dev_kf.clear()

    def _lock(self):
        return self.map_lock if self.map_lock is not None else contextlib.nullcontext()

    def _phase(self, name: str, t0: float) -> float:
        now = time.perf_counter()
        self.phase_s[name] = self.phase_s.get(name, 0.0) + (now - t0)
        return now

    def _count_overflow(self, what: str, n: int):
        if what not in self.overflow:
            _log.warning("capacity overflow: %s dropped %d entries (first hit; "
                         "counted in System.stats()['overflow'])", what, n)
        self.overflow[what] = self.overflow.get(what, 0) + int(n)

    # ------------------------------------------------------------------
    # device-resident per-keyframe operands: keypoint columns are immutable
    # once a keyframe is stored, so they are uploaded once; poses stay on
    # the host (BA moves them).  On the card an entry carries the stream it
    # was uploaded on and an event after the upload: a reader on another
    # stream waits for the event and marks the tensors as used by its
    # stream, so a later prune cannot hand their memory to new work before
    # the reader's kernels are done.
    # ------------------------------------------------------------------
    def _kf_dev(self, kf: int) -> dict:
        with self._dev_kf_lock:
            e = self._dev_kf.get(kf)
            if e is None:
                e = self._upload_kf(kf)
                self._dev_kf[kf] = e
        cols, stream, ready = e
        if ready is not None:
            cur = torch.cuda.current_stream(self.device)
            if cur != stream:
                cur.wait_event(ready)
                for x in cols.values():
                    x.record_stream(cur)
        return cols

    def _upload_kf(self, kf: int):
        db, dev = self.db, self.device
        t = lambda a: torch.as_tensor(np.asarray(a), device=dev)  # noqa: E731
        level = np.asarray(db.kf_level[kf]).astype(np.int64)
        cols = {
            "desc_i8": t(db.kf_desc_i8[kf]),
            "bearing": t(db.kf_bearing[kf]),
            "angle": t(db.kf_angle[kf]),
            "und": t(db.kf_xy_undist[kf]),
            "valid": t(db.kf_kpt_valid[kf]),
            "level": t(level),
            "sigma2": t(self.sigma2[np.clip(level, 0, self.num_levels - 1)]),
        }
        if dev.type != "cuda":
            return cols, None, None
        ready = torch.cuda.Event()
        ready.record()
        return cols, torch.cuda.current_stream(dev), ready

    def _prune_dev_cache(self):
        with self._dev_kf_lock:
            if len(self._dev_kf) <= len(self.db.valid_kf_ids()) + 64:
                return
            for k in [k for k in self._dev_kf if not self.db.kf_valid[k]]:
                del self._dev_kf[k]

    def _stack(self, kfs, key):
        return torch.stack([self._kf_dev(k)[key] for k in kfs])

    # ------------------------------------------------------------------
    def after_initialization(self, kf1: int, kf2: int):
        """Local BA on the 2-KF initial map (ref: global BA after init)."""
        self._run_local_ba(kf2)
        for lm in self.db.valid_lm_ids():
            self.recent_lms.append((int(lm), kf2))
        if self.global_optimizer is not None:
            self.global_optimizer.queue_keyframe(kf1)
            self.global_optimizer.queue_keyframe(kf2)

    def after_stereo_initialization(self, kf: int):
        if self.global_optimizer is not None:
            self.global_optimizer.queue_keyframe(kf)

    def insert_keyframe(self, frame) -> int:
        """Synchronous insertion: store + full mapping pipeline."""
        t0 = time.perf_counter()
        kf = self.store_keyframe(frame)
        self._phase("store", t0)
        self.process_keyframe(kf, run_ba=True)
        return kf

    def store_keyframe(self, frame) -> int:
        """Create the KF record and associate its tracked landmarks (the
        fast part: it runs on the tracking thread, under the map lock in
        async mode, like the reference's queue_keyframe)."""
        db = self.db
        kf = db.add_keyframe(frame)
        touched = []
        for i in np.where((frame.lm_idx >= 0) & frame.valid & ~frame.outlier)[0]:
            lm = int(frame.lm_idx[i])
            if not db.lm_valid[lm]:
                continue
            if kf not in db.lm_obs[lm]:
                db.add_observation(lm, kf, int(i))
                db.update_landmark_descriptor(lm)
                touched.append(lm)
        db.update_landmark_geometry_batch(touched, self.cfg.feature.scale_factor, self.num_levels)
        if self.stereo:
            self._seed_landmarks_from_depth(frame, kf)
        db.update_connections(kf)
        self._kf_dev(kf)
        self._prune_dev_cache()
        return kf

    def process_keyframe(self, kf: int, run_ba: bool = True):
        """The reference's mapping-thread body: cull, create, fuse, local BA,
        cull keyframes, forward to global optimization.  ``run_ba`` False is
        the abort-on-backlog policy (ref: local BA aborted when new
        keyframes are waiting).  Each stage takes the map lock (when one is
        set) only around its map reads and write-backs."""
        lock = self._lock()
        with lock:
            n_lm0 = len(self.db.valid_lm_ids())
            t = time.perf_counter()
            self.remove_redundant_landmarks(kf)
            self._phase("cull_lms", t)
        t = time.perf_counter()
        self.create_new_landmarks(kf)
        t = self._phase("triangulate", t)
        self.fuse_duplicated_landmarks(kf)
        t = self._phase("fuse", t)
        if run_ba:
            self._run_local_ba(kf)
            t = self._phase("local_ba", t)
        else:
            self.ba_skipped += 1
        # keyframe redundancy: snapshot under the lock, histogram pass
        # without it, erase under it
        with lock:
            snap = self.snapshot_redundant_kfs(kf)
        if snap is not None:
            victims = self.compute_redundant_kfs(snap)
            with lock:
                self.apply_redundant_kfs(snap, victims)
        t = self._phase("cull_kfs", t)
        with lock:
            _log.debug("keyframe %d processed: landmarks %d -> %d, local BA %s", kf, n_lm0,
                       len(self.db.valid_lm_ids()), "ran" if run_ba else "skipped (backlog)")
            if self.global_optimizer is not None:
                self.global_optimizer.queue_keyframe(kf)
                self._phase("bow_loop", t)

    def _seed_landmarks_from_depth(self, frame, kf: int):
        """Stereo/RGB-D keyframes seed landmarks from measured depth for
        their unmatched keypoints closer than the camera's depth threshold
        (ref keyframe_inserter depth seeding).  With
        ``Mapping.seed_cell_budget`` > 0 each cell of ``seed_grid`` takes
        seeds, closest first, only up to that many landmarks in all (tracked
        ones count), unless the keyframe tracks fewer than
        ``seed_close_floor`` close landmarks; the default budget 0 seeds
        every candidate."""
        db = self.db
        thr = self.cam.depth_threshold
        has = frame.valid & (frame.depth > 0) & (frame.depth < thr) & (db.kf_lm_idx[kf] < 0)
        cand = np.where(has & (frame.bearing[:, 2] > 1e-6))[0]
        budget = self.cfg.mapping.seed_cell_budget
        tracked = np.where(db.kf_lm_idx[kf] >= 0)[0]
        if budget > 0 and len(cand):
            close = int(((frame.depth[tracked] > 0) & (frame.depth[tracked] < thr)).sum())
            if close < self.cfg.mapping.seed_close_floor:
                budget = 0
        if budget > 0 and len(cand):
            gr, gc = self.cfg.mapping.seed_grid
            ch, cw = self.cam.rows / gr, self.cam.cols / gc

            def cell_of(xy):
                r = np.minimum((xy[:, 1] // ch).astype(int), gr - 1)
                c = np.minimum((xy[:, 0] // cw).astype(int), gc - 1)
                return r * gc + c

            cover = np.zeros(gr * gc, np.int32)
            if len(tracked):
                np.add.at(cover, cell_of(frame.xy[tracked]), 1)
            order = cand[np.argsort(frame.depth[cand])]      # closest first
            keep = []
            for i, c in zip(order, cell_of(frame.xy[order])):
                if cover[c] < budget:
                    cover[c] += 1
                    keep.append(i)
            self.seeds_skipped += len(cand) - len(keep)
            cand = np.asarray(keep, dtype=np.int64)
        T = db.kf_pose_cw[kf]
        bz = frame.bearing[:, 2]
        born = []
        for i in cand:
            Xc = frame.bearing[i] * (frame.depth[i] / bz[i])
            Xw = T[:3, :3].T @ (Xc - T[:3, 3])
            lm = db.add_landmark(Xw.astype(np.float32), frame.desc_u32[i], frame.desc_i8[i], kf)
            db.add_observation(lm, kf, int(i))
            born.append(lm)
            self.recent_lms.append((lm, kf))
        self.lms_created += len(born)
        self.lms_created_seed += len(born)
        db.update_landmark_geometry_batch(born, self.cfg.feature.scale_factor, self.num_levels)

    # ------------------------------------------------------------------
    # landmark culling (ref module/local_map_cleaner)
    # ------------------------------------------------------------------
    def remove_redundant_landmarks(self, cur_kf: int):
        db = self.db
        keep = []
        for lm, born in self.recent_lms:
            if not db.lm_valid[lm]:
                continue
            ratio = db.lm_n_found[lm] / max(db.lm_n_visible[lm], 1)
            age = cur_kf - born
            if ratio < 0.25 and age >= 2:
                db.erase_landmark(lm)
                self.lms_culled += 1
                self.culled_ratio += 1
            elif age >= 2 and db.lm_num_obs[lm] <= 2:
                db.erase_landmark(lm)
                self.lms_culled += 1
                self.culled_obs += 1
            elif age < 3:
                keep.append((lm, born))      # at age >= 3 it has graduated
        self.recent_lms = keep

    # ------------------------------------------------------------------
    # triangulation with covisible keyframes (ref create_new_landmarks)
    # ------------------------------------------------------------------
    def create_new_landmarks(self, kf: int):
        """Snapshot under the map lock, match and triangulate on the device
        without it, apply under it: discarded if the map geometry moved,
        and each association re-checked against the live keyframe columns
        (first wins)."""
        db = self.db
        with self._lock():
            if not db.kf_valid[kf]:
                return
            neighbors = db.get_top_covisible(kf, self.num_covis_for_triangulation)
            if not neighbors:
                neighbors = [k for k in db.valid_kf_ids() if k != kf][-2:]
            T1 = db.kf_pose_cw[kf].copy()
            c1 = -T1[:3, :3].T @ T1[:3, 3]
            unmatched1 = (db.kf_lm_idx[kf] < 0) & db.kf_kpt_valid[kf]
            median_depth = self._median_scene_depth(kf)
            # baseline-gate the neighbour set on the host (stereo/RGB-D: the
            # rig's own baseline), then match, check orientation and
            # triangulate against all survivors in one batch
            min_baseline = (self.cam.focal_x_baseline / max(self.cam.fx, 1e-9) if self.stereo
                            else self.cfg.mapping.baseline_dist_thr_ratio * median_depth)
            usable = []
            for nb in neighbors:
                T2 = db.kf_pose_cw[nb]
                if np.linalg.norm(-T2[:3, :3].T @ T2[:3, 3] - c1) >= min_baseline:
                    usable.append(nb)
            if not usable:
                db.update_connections(kf)
                return
            un2 = np.stack([(db.kf_lm_idx[nb] < 0) & db.kf_kpt_valid[nb] for nb in usable])
            poses_nb = np.stack([db.kf_pose_cw[nb] for nb in usable]).astype(np.float32)
            geom_v = db.geom_version
        dev = self.device
        d1 = self._kf_dev(kf)
        idx_all, X_all, ok_all = TO.triangulation_candidates_multi(
            self.cam, torch.from_numpy(T1.astype(np.float32)).to(dev),
            d1["desc_i8"], torch.from_numpy(unmatched1).to(dev), d1["bearing"], d1["angle"],
            d1["und"], d1["sigma2"], torch.from_numpy(poses_nb).to(dev),
            self._stack(usable, "desc_i8"), torch.from_numpy(un2).to(dev),
            self._stack(usable, "bearing"), self._stack(usable, "angle"),
            self._stack(usable, "und"), self._stack(usable, "sigma2"), 1e-2)
        idx_all = idx_all.cpu().numpy()
        X_all = X_all.cpu().numpy()
        ok_all = ok_all.cpu().numpy()
        with self._lock():
            if not db.kf_valid[kf]:
                return
            if db.geom_version != geom_v:
                # the triangulated points belong to the geometry before a
                # loop correction / global BA: discard them wholesale
                self.stale_discards += 1
                _log.debug("triangulation for KF %d discarded (map geometry moved)", kf)
                return
            born = []
            # second-view confirmation: only keypoints triangulated against
            # >= 2 live neighbours become landmarks (born with >= 3
            # observations); with a single usable neighbour the floor is 1
            need = min(2, len(usable))
            live = np.array([bool(db.kf_valid[nb]) for nb in usable])
            hit = ok_all & (idx_all >= 0) & live[:, None]
            for j in np.where(hit.sum(0) >= need)[0]:
                i1 = int(j)
                if db.kf_lm_idx[kf][i1] >= 0:
                    continue      # associated while the device work ran
                views = []
                for b in np.where(hit[:, j])[0]:
                    nb, i2 = usable[b], int(idx_all[b][j])
                    if db.kf_lm_idx[nb][i2] < 0:
                        views.append((b, nb, i2))
                if len(views) < need:
                    continue
                lm = db.add_landmark(X_all[views[0][0]][j].astype(np.float32),
                                     db.kf_desc_u32[kf][i1], db.kf_desc_i8[kf][i1], kf)
                db.add_observation(lm, kf, i1)
                for _, nb, i2 in views:
                    db.add_observation(lm, nb, i2)
                db.update_landmark_descriptor(lm)
                born.append(lm)
                self.recent_lms.append((lm, kf))
            self.lms_created += len(born)
            db.update_landmark_geometry_batch(born, self.cfg.feature.scale_factor,
                                              self.num_levels)
            db.update_connections(kf)

    def _median_scene_depth(self, kf: int) -> float:
        db = self.db
        lms = db.kf_lm_idx[kf]
        lms = lms[lms >= 0]
        if len(lms) == 0:
            return 1.0
        T = db.kf_pose_cw[kf]
        z = ((T[:3, :3] @ db.lm_pos[lms].T).T + T[:3, 3])[:, 2]
        z = z[z > 0]
        return float(np.median(z)) if len(z) else 1.0

    # ------------------------------------------------------------------
    # duplicate fusion (ref update_new_keyframe / match::fuse)
    # ------------------------------------------------------------------
    def fuse_duplicated_landmarks(self, kf: int):
        """Same snapshot / unlocked device call / locked apply structure as
        create_new_landmarks."""
        db = self.db
        with self._lock():
            if not db.kf_valid[kf]:
                return
            targets = db.get_top_covisible(kf,
                                           self.cfg.mapping.num_covisibilities_for_landmark_fusion)
            own = db.kf_lm_idx[kf]
            own_lms = own[own >= 0]
            if len(own_lms) == 0 or not targets:
                return
            lm_ids = own_lms[:4096].copy()
            pos, desc = db.lm_pos[lm_ids], db.lm_desc_i8[lm_ids]
            poses = np.stack([db.kf_pose_cw[nb] for nb in targets]).astype(np.float32)
            geom_v = db.geom_version
        dev = self.device
        n = len(lm_ids)
        idx_all, _ = TO.fuse_candidates_multi(
            self.cam, torch.from_numpy(poses).to(dev), torch.from_numpy(pos).to(dev),
            torch.from_numpy(desc).to(dev), torch.ones(n, dtype=torch.bool, device=dev),
            self._stack(targets, "desc_i8"), self._stack(targets, "und"),
            self._stack(targets, "valid"), self._stack(targets, "level"),
            3.0, self._scale_factors_dev, torch.full((n,), -1, dtype=torch.int64, device=dev))
        idx_all = idx_all.cpu().numpy()
        touched = set()
        with self._lock():
            if not db.kf_valid[kf]:
                return
            if db.geom_version != geom_v:
                # matched against the poses before a geometry rewrite
                self.stale_discards += 1
                _log.debug("fusion for KF %d discarded (map geometry moved)", kf)
                return
            for b, nb in enumerate(targets):
                if not db.kf_valid[nb]:
                    continue
                for j in np.where(idx_all[b] >= 0)[0]:
                    lm = int(lm_ids[j])
                    if not db.lm_valid[lm]:
                        continue
                    kpt = int(idx_all[b][j])
                    other = int(db.kf_lm_idx[nb][kpt])
                    if other >= 0 and db.lm_valid[other]:
                        if other != lm:
                            # merge the one with fewer observations in
                            if db.lm_num_obs[lm] >= db.lm_num_obs[other]:
                                db.replace_landmark(other, lm)
                            else:
                                db.replace_landmark(lm, other)
                    else:
                        db.add_observation(lm, nb, kpt)
                        touched.add(lm)
            for lm in touched:
                if db.lm_valid[lm]:
                    db.update_landmark_descriptor(lm)
            db.update_connections(kf)

    # ------------------------------------------------------------------
    # local BA (ref optimize/local_bundle_adjuster)
    # ------------------------------------------------------------------
    def _run_local_ba(self, kf: int):
        """Build the window under the map lock, solve without it, write back
        under it unless the map geometry moved meanwhile."""
        with self._lock():
            built = self._build_ba_problem(kf)
            geom_v = self.db.geom_version
        if built is None:
            return
        prob, cam_index, lm_index, cam_opt, obs_refs, n_obs, lm_ids = built
        t0 = time.perf_counter()
        res = self.local_ba(prob)
        T_new = res.T_cw.cpu().numpy()
        X_new = res.X.cpu().numpy()
        inl = res.obs_inlier.cpu().numpy()
        self.ba_runs += 1
        self.ba_iters_total += self.BA_FIRST_ITERS + self.BA_SECOND_ITERS
        self.ba_wall_s += time.perf_counter() - t0
        with self._lock():
            if self.db.geom_version != geom_v:
                # solved against the geometry before a loop correction or
                # global BA: discard rather than overwrite it
                self.stale_discards += 1
                _log.debug("local BA for KF %d discarded (map geometry moved)", kf)
                return
            self._apply_ba_result(T_new, X_new, inl, cam_index, lm_index, cam_opt, obs_refs,
                                  n_obs, lm_ids)
            self.db.version += 1

    def _build_ba_problem(self, kf: int):
        db = self.db
        local = [kf] + db.get_top_covisible(kf, self.C - 1)
        local = [k for k in local if db.kf_valid[k]]
        if not local:
            return None
        local_set = set(local)
        # landmarks of local KFs: one vectorized pass over their lm columns
        cat = np.concatenate([db.kf_lm_idx[k] for k in local])
        lm_all = np.unique(cat[cat >= 0])
        lm_all = lm_all[db.lm_valid[lm_all]]
        if len(lm_all) > self.L:
            self._count_overflow("ba_lms", len(lm_all) - self.L)
        lm_ids = [int(l) for l in lm_all[: self.L]]
        # fixed KFs: other observers of those landmarks, via the flat table
        lm_lookup = np.full(db.n_lms, -1, np.int32)
        lm_lookup[lm_ids] = np.arange(len(lm_ids), dtype=np.int32)
        t_lm, t_kf, _, t_u, t_v, t_xr, t_lvl = db.observation_rows()
        ol_all = lm_lookup[np.clip(t_lm, 0, db.n_lms - 1)]
        sel = (t_lm >= 0) & (ol_all >= 0)
        fixed = [int(k) for k in np.unique(t_kf[sel]) if k not in local_set and db.kf_valid[k]]
        # cap total cameras at C: all local first, then fixed by recency
        fixed = sorted(fixed, reverse=True)[: self.C - len(local)]
        cams = local + fixed
        cam_index = {k: i for i, k in enumerate(cams)}
        lm_index = {lm: i for i, lm in enumerate(lm_ids)}

        C, L, O = self.C, self.L, self.O
        T = np.tile(np.eye(4, dtype=np.float32), (C, 1, 1))
        cam_opt = np.zeros(C, bool)
        cam_valid = np.zeros(C, bool)
        for k, i in cam_index.items():
            T[i] = db.kf_pose_cw[k]
            cam_valid[i] = True
            cam_opt[i] = (k in local_set) and (k != db.origin_kf)
        if cam_opt.all():          # keep a gauge: fix the oldest
            cam_opt[cam_index[min(cams)]] = False
        X = np.zeros((L, 3), np.float32)
        lm_valid = np.zeros(L, bool)
        X[: len(lm_ids)] = db.lm_pos[lm_ids]
        lm_valid[: len(lm_ids)] = True
        # observation packing: rows of the flat table whose landmark AND
        # keyframe are both in the window
        cam_lookup = np.full(db.n_kfs, -1, np.int32)
        cam_lookup[cams] = np.arange(len(cams), dtype=np.int32)
        oc_all = cam_lookup[np.clip(t_kf, 0, db.n_kfs - 1)]
        rows = np.where(sel & (oc_all >= 0))[0]
        if len(rows) > O:
            self._count_overflow("ba_obs", len(rows) - O)
            rows = rows[:O]
        n_obs = len(rows)
        if n_obs < 10:
            return None
        oc = np.zeros(O, np.int64)
        ol = np.zeros(O, np.int64)
        ouv = np.zeros((O, 3 if self.stereo else 2), np.float32)
        osg = np.ones(O, np.float32)
        om = np.zeros(O, bool)
        oc[:n_obs] = oc_all[rows]
        ol[:n_obs] = ol_all[rows]
        ouv[:n_obs, 0] = t_u[rows]
        ouv[:n_obs, 1] = t_v[rows]
        if self.stereo:
            ouv[:n_obs, 2] = t_xr[rows]
        osg[:n_obs] = self.sigma2[np.clip(t_lvl[rows], 0, self.num_levels - 1)]
        om[:n_obs] = True
        obs_refs = (t_lm[rows].copy(), t_kf[rows].copy())
        prob = BAProblem(*(torch.from_numpy(a) for a in (
            T, cam_opt, cam_valid, X, lm_valid, oc, ol, ouv, osg, om))).to(self.device)
        return prob, cam_index, lm_index, cam_opt, obs_refs, n_obs, lm_ids

    def _apply_ba_result(self, T_new, X_new, inl, cam_index, lm_index, cam_opt, obs_refs,
                         n_obs, lm_ids):
        db = self.db
        for k, i in cam_index.items():
            if cam_opt[i]:
                db.kf_pose_cw[k] = T_new[i]
        for lm, i in lm_index.items():
            if db.lm_valid[lm]:
                db.lm_pos[lm] = X_new[i]
        # remove outlier observations (obs_refs: parallel (lm, kf) arrays)
        ref_lm, ref_kf = obs_refs
        for j in np.where(~inl[:n_obs])[0]:
            db.erase_observation(int(ref_lm[j]), int(ref_kf[j]))
        db.update_landmark_geometry_batch(lm_ids, self.cfg.feature.scale_factor, self.num_levels)

    # ------------------------------------------------------------------
    # keyframe culling (ref remove_redundant_keyframes: 90% rule): a
    # keyframe is redundant when > 90% of its landmarks are seen by >= 3
    # other keyframes at the same or finer scale.  Snapshot under the map
    # lock, histogram pass without it, erase under it; at most one keyframe
    # is erased per call.
    # ------------------------------------------------------------------
    def snapshot_redundant_kfs(self, cur_kf: int):
        """Copy what the redundancy pass reads (caller holds the lock)."""
        db = self.db
        cands = [k for k in db.get_top_covisible(cur_kf, 30)
                 if k != db.origin_kf and k != cur_kf and db.kf_valid[k]]
        if not cands:
            return None
        return {"geom_version": db.geom_version, "cands": cands,
                "obs_lm": db.obs_lm[: db.n_obs_rows].copy(),
                "obs_level": db.obs_level[: db.n_obs_rows].copy(),
                "n_lms": db.n_lms, "lm_valid": db.lm_valid.copy(),
                "kf_lm_idx": {k: db.kf_lm_idx[k].copy() for k in cands},
                "kf_level": {k: db.kf_level[k].copy() for k in cands}}

    def compute_redundant_kfs(self, snap) -> list:
        """Host work on the snapshot alone (no lock, no map access): one
        pass over the observation rows builds a per-landmark cumulative
        histogram of observation levels, and each candidate's counts are
        lookups into it.  Returns at most one victim."""
        NLV = max(self.num_levels + 2, 2)
        t_lm = snap["obs_lm"]
        t_lvl = np.clip(snap["obs_level"], 0, NLV - 1)
        live = t_lm >= 0
        flat = np.bincount(t_lm[live].astype(np.int64) * NLV + t_lvl[live],
                           minlength=snap["n_lms"] * NLV)
        hist = np.cumsum(flat.reshape(snap["n_lms"], NLV), axis=1)
        for k in snap["cands"]:
            arr = snap["kf_lm_idx"][k]
            kpts = np.where(arr >= 0)[0]
            if len(kpts) < 10:
                continue
            lms = arr[kpts]
            my_level = np.clip(snap["kf_level"][k][kpts].astype(np.int64) + 1, 0, NLV - 1)
            # observations at level <= my_level+1 excluding this KF's own
            n_better = hist[lms, my_level] - 1
            n_redundant = int(((n_better >= 3) & snap["lm_valid"][lms]).sum())
            if n_redundant > self.cfg.mapping.redundant_obs_ratio_thr * len(kpts):
                return [k]
        return []

    def apply_redundant_kfs(self, snap, victims: list):
        """Erase the victims (caller holds the lock), unless the map
        geometry moved since the snapshot."""
        db = self.db
        if db.geom_version != snap["geom_version"]:
            self.stale_discards += 1
            return
        for k in victims:
            if db.kf_valid[k]:
                db.erase_keyframe(k)
                self.kfs_culled += 1
