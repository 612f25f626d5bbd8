"""Global optimization module (counterpart of
``openvslam_tpu/module/global_optimization_module.py``; ref
``global_optimization_module.*``): BoW registration of every keyframe, loop
detection -> Sim3 validation -> loop correction (pose and landmark
propagation, duplicate merge) -> Sim3 pose graph -> global BA.  A stereo or
RGB-D map is metric: ``fix_scale`` locks the Sim3 scale in the validation
and in every pose-graph vertex, and the global BA takes stereo edges; a
map whose keyframes come from more than one camera (a merged map) takes
the multi-camera edge.

Synchronous by default: the loop pipeline runs inline in
``queue_keyframe``, called by the mapping module after each keyframe.  In
async mode (``start_loop_worker``; the System starts it) a dedicated worker
thread on its own CUDA stream consumes the keyframe queue: it registers the
whole backlog's BoW vectors in one batch, then checks each keyframe.
Detection and the candidates' snapshots run under the map lock, the Sim3
validation without it; a correction pauses the mapping worker, re-takes the
lock and is discarded (``loop_stale_discards``) if a geometry rewrite
landed during the validation.  With ``async_global_ba`` the global BA after
a correction solves on a thread of its own and splices its result onto the
map as it is then (keyframes and landmarks born meanwhile move with their
snapshotted ancestors).  A newer correction supersedes a global BA still
running: its result is discarded (``gba_superseded``; ref: a new loop
aborts the running loop BA).  The reference joins the running one there,
under the map lock that the running one needs to apply its result.

The reference's two backlog behaviours are carried as they are: the worker
registers its whole backlog before it checks the oldest keyframe (so newer
keyframes of the same place take part in that check's candidate gate), and
culled keyframes leave the BoW database only at the next registration.

Not ported: the compile-bucket prewarming (the port compiles nothing per
shape).
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, Optional, Set

import numpy as np
import torch

from ..camera.base import SetupType
from ..data.bow import BowDatabase, default_vocabulary, load_vocabulary
from ..device import resolve_device
from ..optimize import residuals as R
from ..optimize.ba import BAProblem, make_global_ba
from ..optimize.pose_graph import PoseGraphProblem, make_pose_graph_optimizer
from ..utils.log import get_logger
from ..utils.threads import WorkerFaults, on_stream, sync_current_stream, worker_stream
from .loop_detector import LoopDetector
from .mapping_module import kf_camv
from .relocalizer import Relocalizer

_log = get_logger("global_opt")

COVIS_GRAPH_EDGE_WEIGHT = 100   # reference: covisibility edges with weight >= 100
GLOBAL_BA_ITERS = 60            # after a loop correction (see correct_loop)
GLOBAL_BA_CG_ITERS = 30


class GlobalOptimizationModule:
    def __init__(self, cfg, cam, map_db, vocab_path: Optional[str] = None,
                 fix_scale: bool = False, device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.cam = cam
        self.db = map_db
        if vocab_path is None or vocab_path == "default":
            vocab = default_vocabulary(pattern=cfg.feature.descriptor_pattern)
        else:
            vocab = load_vocabulary(vocab_path)
        self.bow_db = BowDatabase(vocab, map_db, device=self.device)
        # the vocabulary's device tensors exist before any worker starts
        # (a worker's stream waits for the uploads queued so far)
        vocab.idf_on(self.device)
        self.loop_detector = LoopDetector(cfg, cam, map_db, self.bow_db, fix_scale,
                                          device=self.device)
        self.relocalizer = Relocalizer(cfg, cam, map_db, self.bow_db, device=self.device)
        # metric maps lock every vertex's Sim3 scale in the pose graph, as
        # the reference's graph_optimizer does via fix_scale
        self.pose_graph_opt = make_pose_graph_optimizer(iters=20, cg_iters=60,
                                                        fix_scale=fix_scale)
        # stereo/RGB-D maps carry x_right in the global BA's third column
        # (stereo edges; u_right < 0 marks a mono observation)
        self.stereo = cam.setup != SetupType.MONOCULAR
        self.global_ba = make_global_ba(cam, iters=GLOBAL_BA_ITERS, cg_iters=GLOBAL_BA_CG_ITERS,
                                        stereo=self.stereo)
        self.num_loops_closed = 0
        self.abort_global_ba = False
        self.last_loop_kf = -1
        # loop-detection event log: ("cand"|"valid", kf, cand) per stage
        self.loop_events: list = []
        self.loop_enabled = cfg.loop.enabled
        self.loop_checks_run = 0
        self.loop_cands_seen = 0
        self.loop_validations = 0
        self.loop_stale_discards = 0
        # async mode: the map lock and the mapping proxy (set by the System),
        # the loop worker and its queue, the background global BA, and the
        # exceptions the threads raised
        self.map_lock = None
        self.mapper_proxy = None
        self.async_global_ba = False
        self.faults = WorkerFaults()
        self._gba_threads: list = []      # background global BAs, the latest last
        self._gba_gen = 0                 # generation of the latest global BA
        self.gba_superseded = 0
        self._loop_thread: Optional[threading.Thread] = None
        self._loop_queue: list = []
        self._loop_busy = 0            # keyframes taken off the queue, not yet checked
        self._loop_qlock = threading.Lock()
        self._loop_wake = threading.Event()
        self._loop_stop = False
        nl = cfg.feature.num_levels
        sf = cfg.feature.scale_factor
        self.sigma2 = np.array([sf ** (2 * l) for l in range(nl)], np.float32)
        # host seconds per stage: "check" (detect + prefilter + validations
        # of one keyframe), "validate", "pose_graph", "global_ba", each a list
        self.timings: Dict[str, list] = {"check": [], "validate": [], "pose_graph": [],
                                         "global_ba": []}

    def reset(self, map_db):
        """Start over on ``map_db``: an empty BoW database and no loop state."""
        with self._loop_qlock:
            self._loop_queue.clear()
        self.db = map_db
        self.bow_db.map_db = map_db
        self.bow_db.clear()
        self.loop_detector.db = map_db
        self.loop_detector.cont_groups = []
        self.relocalizer.db = map_db
        self.relocalizer.last_reloc_kf = -1
        self.last_loop_kf = -1

    def _lock(self):
        return self.map_lock if self.map_lock is not None else contextlib.nullcontext()

    # ------------------------------------------------------------------
    def queue_keyframe(self, kf: int):
        """Called by the mapping module for every new keyframe (under the
        map lock in async mode).  Synchronous: register its BoW vector, then
        run the loop pipeline inline.  With the loop worker running: hand
        the keyframe to it; the worker registers it in processing order (ref:
        the loop detector adds keyframes to the BoW database on its own
        thread)."""
        if self._loop_thread is not None:
            with self._loop_qlock:
                self._loop_queue.append(kf)
            self._loop_wake.set()
            return
        self._register_bow(kf)
        if self.loop_enabled:
            self._loop_check(kf)

    def _register_bow(self, kf: int):
        """Register kf in the BoW database and drop the entries of keyframes
        culled since the last call."""
        db = self.db
        for k in [k for k in self.bow_db.kf_words if not db.kf_valid[k]]:
            self.bow_db.remove_keyframe(k)
        if kf in self.bow_db.kf_words:
            return   # already registered (snapshot() registers on demand)
        self.bow_db.add_keyframe(kf, self.bow_db.compute_words(db.kf_desc_i8[kf],
                                                               db.kf_kpt_valid[kf]))

    def _kf_ok(self, kf: int) -> bool:
        db = self.db
        return 0 <= kf < db.n_kfs and bool(db.kf_valid[kf])

    # ------------------------------------------------------------------
    # the loop worker (async mode)
    # ------------------------------------------------------------------
    def start_loop_worker(self):
        if self._loop_thread is not None:
            return
        self._loop_stop = False
        self._loop_thread = threading.Thread(target=self._loop_worker, daemon=True,
                                             name="global-opt")
        self._loop_thread.start()

    def stop_loop_worker(self, timeout: float = 120.0):
        """Check the keyframes still queued, then stop (System.shutdown).
        Raises TimeoutError if the worker is still running after
        ``timeout`` seconds."""
        t = self._loop_thread
        if t is None:
            return
        self._loop_stop = True
        self._loop_wake.set()
        t.join(timeout)
        if t.is_alive():
            raise TimeoutError(f"loop worker still running after {timeout} s")
        self._loop_thread = None

    @property
    def loop_backlog(self) -> int:
        """Keyframes queued for the loop worker."""
        with self._loop_qlock:
            return len(self._loop_queue)

    @property
    def loop_idle(self) -> bool:
        """Nothing queued for the loop worker and nothing being checked."""
        with self._loop_qlock:
            return not self._loop_queue and not self._loop_busy

    def _loop_worker(self):
        stream = worker_stream(self.device)
        with on_stream(stream):
            while True:
                self._loop_wake.wait(timeout=0.2)
                with self._loop_qlock:
                    if not self._loop_queue:
                        self._loop_wake.clear()
                        if self._loop_stop:
                            return
                        continue
                    # the whole backlog: one batched BoW registration
                    pending = self._loop_queue[:]
                    self._loop_queue.clear()
                    self._loop_busy = len(pending)
                try:
                    self._register_pending(pending)
                except Exception:
                    self.faults.record("loop worker: batch BoW registration")
                for kf in pending:
                    try:
                        self._loop_check(kf)
                    except Exception:
                        self.faults.record(f"loop worker: check of keyframe {kf}")
                    with self._loop_qlock:
                        self._loop_busy -= 1

    def _register_pending(self, pending: list):
        """Register the pending keyframes in the BoW database in processing
        order: descriptors copied under the map lock, one batched word
        assignment and tf-idf pass without it, dictionary inserts under it."""
        db = self.db
        with self._lock():
            todo = [k for k in pending if self._kf_ok(k) and not self._registered(k)]
            if todo:
                desc_b = np.stack([db.kf_desc_i8[k] for k in todo])
                valid_b = np.stack([db.kf_kpt_valid[k] for k in todo])
        if not todo:
            return
        words_b = self.bow_db.compute_words_batch(desc_b, valid_b)
        vecs_b = self.bow_db.bow_vecs_batch(words_b)
        with self._lock():
            for k in [k for k in self.bow_db.kf_words if not db.kf_valid[k]]:
                self.bow_db.remove_keyframe(k)
            sel = [i for i, k in enumerate(todo) if self._kf_ok(k) and not self._registered(k)]
            self.bow_db.add_keyframes_batch([todo[i] for i in sel], words_b[sel], vecs_b[sel])

    def _registered(self, kf: int) -> bool:
        return kf in self.bow_db.kf_words

    # ------------------------------------------------------------------
    def _loop_check(self, kf: int):
        """Loop pipeline for one keyframe: detect -> Sim3 validate -> correct."""
        on_worker = self._loop_thread is not None
        if on_worker and (not self._registered(kf) or not self.loop_enabled):
            return
        if kf - self.last_loop_kf < 10:   # cooldown (ref: 10 keyframes)
            return
        t0 = time.perf_counter()
        try:
            self._check(kf)
        finally:
            self.timings["check"].append(time.perf_counter() - t0)

    def _check(self, kf: int):
        """Detection and the candidates' snapshots under the map lock, the
        Sim3 validations without it; a validated loop is corrected with the
        mapper paused (ref: loop correction pauses mapping, not tracking)
        and under the lock, or discarded if the map geometry moved since
        the snapshot."""
        lock = self._lock()
        with lock:
            if not self._kf_ok(kf):
                return
            candidates = self.loop_detector.detect(kf)
        self.loop_checks_run += 1
        if not candidates:
            return
        self.loop_cands_seen += len(candidates)
        _log.info("loop candidates for keyframe %d: %s", kf, candidates)
        with lock:
            pairs = [(c, self.loop_detector.snapshot(kf, c)) for c in candidates
                     if self._kf_ok(kf) and self._kf_ok(c)]
        if not pairs:
            return
        counts = self.loop_detector.prefilter_counts([s for _, s in pairs])
        for (cand, snap), n_first in zip(pairs, counts):
            self.loop_events.append(("cand", kf, cand))
            if n_first < self.cfg.loop.min_num_bow_matches:
                continue
            t0 = time.perf_counter()
            out = self.loop_detector.validate_snapshot(
                snap, min_inliers=self.cfg.loop.min_num_valid_obs)
            self.timings["validate"].append(time.perf_counter() - t0)
            if out is None:
                continue
            self.loop_events.append(("valid", kf, cand))
            self.loop_validations += 1
            R, t, s, _, _, lms_k, lms_c = out
            _log.info("loop detected: keyframe %d <-> %d (scale %.3f); correcting",
                      kf, cand, float(s))
            # pause the mapper without the lock held (its keyframe in
            # flight needs the lock to finish), then correct under the lock
            proxy = self.mapper_proxy
            if proxy is not None:
                proxy.pause(wait=True)
            try:
                with lock:
                    if self.db.geom_version != snap["geom_version"]:
                        self.loop_stale_discards += 1
                        _log.info("loop Sim3 %d <-> %d discarded (map geometry moved during "
                                  "the validation)", kf, cand)
                        continue
                    if not (self._kf_ok(kf) and self._kf_ok(cand)):
                        continue
                    self.correct_loop(kf, cand, (R, t, s), lms_k, lms_c)
                    self.last_loop_kf = kf
                    self.num_loops_closed += 1
            finally:
                if proxy is not None:
                    proxy.resume()
            _log.info("loop %d closed (pose graph + global BA)", self.num_loops_closed)
            return

    # ------------------------------------------------------------------
    def correct_loop(self, kf: int, cand: int, g_cur_from_cand, lms_k, lms_c, group=None):
        """Propagate the validated Sim3 through kf's covisibility group
        (``group`` overrides it), merge the matched duplicate landmarks, add
        the loop edge, then optimize the pose graph and run the global BA.
        The propagation is host numpy: a 3x3 compose per group keyframe."""
        db = self.db
        R, t, s = g_cur_from_cand
        R = np.asarray(R, np.float64)
        t = np.asarray(t, np.float64)
        s = float(s)

        def _comp(a, b):
            (Ra, ta, sa), (Rb, tb, sb) = a, b
            return Ra @ Rb, sa * (Ra @ tb) + ta, sa * sb

        def _inv(g):
            Rg, tg, sg = g
            si = 1.0 / sg
            return Rg.T, -si * (Rg.T @ tg), si

        # corrected Sim3 pose of the current KF: S_cw = S(cur <- cand) T_cand_w
        T_cand = np.asarray(db.kf_pose_cw[cand], np.float64)
        g_corr_cur = _comp((R, t, s), (T_cand[:3, :3], T_cand[:3, 3], 1.0))
        if group is None:
            group = [kf] + db.get_top_covisible(kf, 30)
        T_cur_old_inv = np.linalg.inv(np.asarray(db.kf_pose_cw[kf], np.float64))
        corrected: Dict[int, tuple] = {}
        for k2 in group:
            rel = np.asarray(db.kf_pose_cw[k2], np.float64) @ T_cur_old_inv   # SE3 k <- cur
            corrected[k2] = _comp((rel[:3, :3], rel[:3, 3], 1.0), g_corr_cur)

        # correct the group's landmarks (through their observing KF) and poses
        moved: Set[int] = set()
        for k2 in group:
            T_old = np.asarray(db.kf_pose_cw[k2], np.float64)
            g_new = corrected[k2]
            Ri, ti, si = _inv(g_new)
            arr = db.kf_lm_idx[k2]
            lms = [l for l in arr[arr >= 0] if db.lm_valid[l] and l not in moved]
            if lms:
                X = db.lm_pos[np.array(lms)].astype(np.float64)
                Xc = (T_old[:3, :3] @ X.T).T + T_old[:3, 3]
                db.lm_pos[np.array(lms)] = (si * (Xc @ Ri.T) + ti).astype(np.float32)
                moved.update(int(l) for l in lms)
            Rn, tn, sn = g_new
            Tn = np.eye(4)
            Tn[:3, :3] = Rn
            Tn[:3, 3] = tn / sn     # ref Sim3 -> SE3 rescale
            db.kf_pose_cw[k2] = Tn.astype(np.float32)
        db.geom_version += 1

        # merge the directly matched duplicate landmark pairs (keep the older,
        # loop-side landmark)
        for lk, lc in zip(lms_k, lms_c):
            lk, lc = int(lk), int(lc)
            if lk != lc and db.lm_valid[lk] and db.lm_valid[lc]:
                db.replace_landmark(lk, lc)
        for k2 in group:
            db.update_connections(k2, set_parent=False)

        db.add_loop_edge(kf, cand)
        t0 = time.perf_counter()
        self._optimize_pose_graph(fixed_kf=cand)
        sync_current_stream(self.device)
        self.timings["pose_graph"].append(time.perf_counter() - t0)
        # 60 LM steps, not the reference's 10: each takes an inexact
        # (PCG-truncated) Schur step where g2o's takes an exact one
        self.run_global_ba(iters=GLOBAL_BA_ITERS)
        db.version += 1

    # ------------------------------------------------------------------
    def build_pose_graph(self, fixed_kf: int):
        """The pose-graph problem over every valid keyframe (None below 3):
        spanning-tree, loop and strong covisibility edges, each measured from
        the current poses.  Returns (problem as numpy arrays, index, T_old)."""
        db = self.db
        ids = db.valid_kf_ids()
        n = len(ids)
        if n < 3:
            return None
        index = {int(k): i for i, k in enumerate(ids)}
        N = max(8, 1 << int(np.ceil(np.log2(n))))
        Rn = np.tile(np.eye(3, dtype=np.float32), (N, 1, 1))
        tn = np.zeros((N, 3), np.float32)
        sn = np.ones(N, np.float32)
        node_valid = np.zeros(N, bool)
        node_fixed = np.zeros(N, bool)
        T_old = {}
        for k, i in index.items():
            T = db.kf_pose_cw[k]
            T_old[k] = T.copy()
            Rn[i] = T[:3, :3]
            tn[i] = T[:3, 3]
            node_valid[i] = True
        node_fixed[index[int(fixed_kf)]] = True

        edges = set()
        for k in ids:
            k = int(k)
            p = int(db.parent[k])
            if p >= 0 and p in index:
                edges.add((min(k, p), max(k, p)))
            for le in db.loop_edges[k]:
                if le in index:
                    edges.add((min(k, le), max(k, le)))
            for nb, w in db.covis[k].items():
                if w >= COVIS_GRAPH_EDGE_WEIGHT and nb in index:
                    edges.add((min(k, nb), max(k, nb)))
        edges = sorted(edges)
        E = max(4 * N, 1 << int(np.ceil(np.log2(max(len(edges), 2)))))
        e_i = np.zeros(E, np.int32)
        e_j = np.zeros(E, np.int32)
        e_R = np.tile(np.eye(3, dtype=np.float32), (E, 1, 1))
        e_t = np.zeros((E, 3), np.float32)
        e_s = np.ones(E, np.float32)
        e_mask = np.zeros(E, bool)
        if edges:
            ne = len(edges)
            ka = np.array([a for a, _ in edges])
            kb = np.array([b for _, b in edges])
            Ti, Tj = db.kf_pose_cw[ka], db.kf_pose_cw[kb]
            Ri, ti = Ti[:, :3, :3], Ti[:, :3, 3]
            Rj, tj = Tj[:, :3, :3], Tj[:, :3, 3]
            Rrel = np.einsum("nij,nkj->nik", Rj, Ri)      # Rj Ri^T
            e_i[:ne] = [index[int(a)] for a in ka]
            e_j[:ne] = [index[int(b)] for b in kb]
            e_R[:ne] = Rrel
            e_t[:ne] = tj - np.einsum("nij,nj->ni", Rrel, ti)
            e_mask[:ne] = True
        prob = (Rn, tn, sn, node_valid, node_fixed, e_i, e_j, e_R, e_t, e_s, e_mask)
        return prob, index, T_old

    def _optimize_pose_graph(self, fixed_kf: int):
        built = self.build_pose_graph(fixed_kf)
        if built is None:
            return
        prob_np, index, T_old = built
        db = self.db
        prob = PoseGraphProblem(*(torch.as_tensor(a, device=self.device) for a in prob_np))
        R_o, t_o, s_o, _ = (x.cpu().numpy() for x in self.pose_graph_opt(prob))
        N = len(prob_np[0])
        # write back the poses (Sim3 -> SE3 rescale) and move every landmark
        # through its reference keyframe's correction (one batched pass):
        #   Xc = R_old X + t_old;  Xw' = (1/s) R_new^T (Xc - t_new)
        node_of = np.full(db.n_kfs, -1, np.int32)
        R_old_n = np.zeros((N, 3, 3), np.float32)
        t_old_n = np.zeros((N, 3), np.float32)
        for k, i in index.items():
            node_of[k] = i
            R_old_n[i] = T_old[k][:3, :3]
            t_old_n[i] = T_old[k][:3, 3]
        lms = db.valid_lm_ids()
        refs = db.lm_ref_kf[lms]
        ri = np.where(refs >= 0, node_of[np.clip(refs, 0, db.n_kfs - 1)], -1)
        keep = ri >= 0
        lms, ri = lms[keep], ri[keep]
        if len(lms):
            Xc = np.einsum("nij,nj->ni", R_old_n[ri], db.lm_pos[lms]) + t_old_n[ri]
            Xw = np.einsum("nji,nj->ni", R_o[ri], Xc - t_o[ri]) \
                / np.maximum(s_o[ri], 1e-9)[:, None]
            db.lm_pos[lms] = Xw.astype(np.float32)
        for k, i in index.items():
            T = np.eye(4, dtype=np.float32)
            T[:3, :3] = R_o[i]
            T[:3, 3] = t_o[i] / max(s_o[i], 1e-9)
            db.kf_pose_cw[k] = T
        db.geom_version += 1

    # ------------------------------------------------------------------
    def loop_BA_is_running(self) -> bool:
        return any(t.is_alive() for t in self._gba_threads)

    def join_global_ba(self, timeout: float = 120.0):
        """Wait for the background global BAs (a superseded one may still
        be solving); raises TimeoutError if one is still running after
        ``timeout`` seconds.  Call it without the map lock held: a global
        BA applies its result under the lock."""
        deadline = time.monotonic() + timeout
        for t in list(self._gba_threads):
            t.join(max(deadline - time.monotonic(), 0.0))
            if t.is_alive():
                raise TimeoutError(f"global BA still running after {timeout} s")
        self._gba_threads = []

    def run_global_ba(self, iters: int = GLOBAL_BA_ITERS):
        """Full-map BA after a loop correction (ref loop_bundle_adjuster).
        Synchronous by default; with ``async_global_ba`` the solve runs on a
        thread of its own, on the problem built now, and its result is
        applied under the map lock unless ``abort_global_ba`` was set
        meanwhile (ref global_optimization_module::run_loop_BA)."""
        if self.abort_global_ba:
            self.abort_global_ba = False
            return
        built = self._build_global_ba()
        if built is None:
            return
        _log.info("global BA: %d keyframes, %d landmarks, %d iters (%s)",
                  len(built["cam_index"]), len(built["lm_index"]), iters,
                  "async" if self.async_global_ba else "sync")
        multicam = built["multicam"]
        ba = (self.global_ba if iters == GLOBAL_BA_ITERS and not multicam else make_global_ba(
            self.cam, iters=iters, cg_iters=GLOBAL_BA_CG_ITERS, stereo=self.stereo,
            multicam=multicam))
        if not self.async_global_ba:
            t0 = time.perf_counter()
            self._apply_global_ba(self._solve_global_ba(ba, built), built)
            self.timings["global_ba"].append(time.perf_counter() - t0)
            return
        self._gba_gen += 1
        gen = self._gba_gen

        def _worker():
            try:
                with on_stream(worker_stream(self.device)):
                    t0 = time.perf_counter()
                    out = self._solve_global_ba(ba, built)       # no lock held
                    with self._lock():
                        if gen != self._gba_gen:
                            self.gba_superseded += 1
                            _log.info("global BA superseded by a newer correction; result "
                                      "discarded")
                            return
                        if self.abort_global_ba:
                            self.abort_global_ba = False
                            _log.info("global BA aborted; result discarded")
                            return
                        self._apply_global_ba(out, built)
                        self.db.version += 1
                    self.timings["global_ba"].append(time.perf_counter() - t0)
            except Exception:
                self.faults.record("background global BA")

        t = threading.Thread(target=_worker, daemon=True, name="global-ba")
        self._gba_threads = [x for x in self._gba_threads if x.is_alive()] + [t]
        t.start()

    def _solve_global_ba(self, ba, built):
        """(T_cw, X) of the global BA on ``built``'s problem, on the host."""
        res = ba(BAProblem(*(torch.as_tensor(a, device=self.device) for a in built["prob"])))
        return res.T_cw.cpu().numpy(), res.X.cpu().numpy()

    def _apply_global_ba(self, out, built):
        apply_ba_writeback(self.db, built["cam_index"], built["lm_index"], built["cam_opt"],
                           *out)

    def _build_global_ba(self):
        """The global BA problem over every valid keyframe and landmark as
        numpy arrays, padded to power-of-two buckets (None when the map is
        too small)."""
        db = self.db
        kf_ids = db.valid_kf_ids()
        lm_ids = db.valid_lm_ids()
        n_c, n_l = len(kf_ids), len(lm_ids)
        if n_c < 3 or n_l < 30:
            return None
        C = max(8, 1 << int(np.ceil(np.log2(n_c))))
        L = max(64, 1 << int(np.ceil(np.log2(n_l))))
        cam_index = {int(k): i for i, k in enumerate(kf_ids)}
        lm_index = {int(l): i for i, l in enumerate(lm_ids)}
        n_obs_total = int(db.lm_num_obs[lm_ids].sum())
        O = max(256, 1 << int(np.ceil(np.log2(max(n_obs_total, 2)))))

        T = np.tile(np.eye(4, dtype=np.float32), (C, 1, 1))
        cam_opt = np.zeros(C, bool)
        cam_valid = np.zeros(C, bool)
        for k, i in cam_index.items():
            T[i] = db.kf_pose_cw[k]
            cam_valid[i] = True
            cam_opt[i] = k != db.origin_kf
        X = np.zeros((L, 3), np.float32)
        lm_valid = np.zeros(L, bool)
        X[:n_l] = db.lm_pos[lm_ids]
        lm_valid[:n_l] = True
        # a map over several cameras (merged sessions) takes the
        # multi-camera edge, with each keyframe's camera vector (the
        # session camera for a keyframe without one) in the observation
        # columns 2..; a single-camera stereo/RGB-D map carries x_right in
        # column 2
        multicam = len({db.kf_camera[int(k)] for k in kf_ids} - {None}) > 1
        stereo = self.stereo and not multicam
        oc = np.zeros(O, np.int32)
        ol = np.zeros(O, np.int32)
        ouv = np.zeros((O, 2 + R.CAMV_DIM if multicam else 3 if stereo else 2), np.float32)
        osg = np.ones(O, np.float32)
        om = np.zeros(O, bool)
        lm_lookup = np.full(db.n_lms, -1, np.int32)
        lm_lookup[lm_ids] = np.arange(n_l, dtype=np.int32)
        cam_lookup = np.full(db.n_kfs, -1, np.int32)
        cam_lookup[kf_ids] = np.arange(n_c, dtype=np.int32)
        t_lm, t_kf, _, t_u, t_v, t_xr, t_lvl = db.observation_rows()
        ol_all = lm_lookup[np.clip(t_lm, 0, db.n_lms - 1)]
        oc_all = cam_lookup[np.clip(t_kf, 0, db.n_kfs - 1)]
        rows = np.where((t_lm >= 0) & (ol_all >= 0) & (oc_all >= 0))[0][:O]
        n_obs = len(rows)
        oc[:n_obs] = oc_all[rows]
        ol[:n_obs] = ol_all[rows]
        ouv[:n_obs, 0] = t_u[rows]
        ouv[:n_obs, 1] = t_v[rows]
        if multicam:
            ouv[:n_obs, 2:] = kf_camv(db, kf_ids, self.cam)[oc[:n_obs]]
        elif stereo:
            ouv[:n_obs, 2] = t_xr[rows]
        osg[:n_obs] = self.sigma2[np.clip(t_lvl[rows], 0, len(self.sigma2) - 1)]
        om[:n_obs] = True
        prob = (T, cam_opt, cam_valid, X, lm_valid, oc, ol, ouv, osg, om)
        return {"prob": prob, "cam_index": cam_index, "lm_index": lm_index, "cam_opt": cam_opt,
                "multicam": multicam}


def apply_ba_writeback(db, cam_index, lm_index, cam_opt, T_new, X_new):
    """Write full-map BA results back onto the map.  Keyframes and landmarks
    created after the snapshot move with their nearest snapshotted
    spanning-tree ancestor / reference keyframe (ref
    global_optimization_module::run_loop_BA's born-during pass)."""
    T_pre = {int(k): db.kf_pose_cw[int(k)].copy() for k in db.valid_kf_ids()}
    new_pose = {}
    for k, i in cam_index.items():
        if db.kf_valid[k]:
            new_pose[k] = T_new[i] if cam_opt[i] else db.kf_pose_cw[k]
    for k in db.valid_kf_ids():
        k = int(k)
        if k in cam_index:
            continue
        anc = k
        hops = 0
        while anc not in cam_index and anc >= 0 and hops < 256:
            anc = int(db.parent[anc])
            hops += 1
        if anc not in cam_index:
            continue
        rel = T_pre[k] @ np.linalg.inv(T_pre[anc])
        new_pose[k] = (rel @ new_pose.get(anc, T_pre[anc])).astype(np.float32)
    for lm in db.valid_lm_ids():
        lm = int(lm)
        if lm in lm_index:
            db.lm_pos[lm] = X_new[lm_index[lm]]
            continue
        ref = int(db.lm_ref_kf[lm])
        if ref not in new_pose or ref not in T_pre:
            continue
        To, Tn = T_pre[ref], new_pose[ref]
        Xc = To[:3, :3] @ db.lm_pos[lm] + To[:3, 3]
        db.lm_pos[lm] = (Tn[:3, :3].T @ (Xc - Tn[:3, 3])).astype(np.float32)
    for k, Tk in new_pose.items():
        db.kf_pose_cw[k] = Tk.astype(np.float32)
    db.geom_version += 1
