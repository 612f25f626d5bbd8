"""Concurrent multi-session SLAM with a pooled, landmark-sharded BA
(counterpart of ``openvslam_tpu/parallel/multi_session.py``).

BASELINE.json config #5 ("KITTI 00+02+05 concurrent sessions, sharded map,
distributed BA on N>=2 hosts"):

* K SLAM sessions run concurrently, their frames interleaved round-robin
  (each session's mapping may also run on its own thread with
  ``async_mapping``);
* their maps pool into ONE bundle-adjustment problem: cameras concatenated
  with per-session offsets (each session's origin keyframe fixed for
  gauge), landmarks concatenated, then block-sharded
  (``distributed_ba.partition_problem``);
* ``distributed_ba`` solves it: per-shard Schur elimination, the reduced
  camera system summed over the shards;
* the results are written back into every session's live map with the
  born-during-BA propagation of the in-session global BA
  (``apply_ba_writeback``).

The pooled problem is taken under each session's ``map_lock``; the solve
runs outside the locks and the write-back takes each lock again.  With
``async_mapping`` a session's mapper holds that same lock; every wait for
it is bounded (``session_lock``) and raises TimeoutError when it expires.
Sessions with different cameras pool with the multi-camera edge (each
observation carries its camera's intrinsics).
"""
from __future__ import annotations

import contextlib
import logging
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..camera.base import SetupType, camera_to_config
from ..module.global_optimization_module import apply_ba_writeback
from ..optimize import residuals as R
from ..optimize.ba import BAProblem
from .distributed_ba import make_distributed_ba, partition_problem
from .mesh import make_mesh

log = logging.getLogger(__name__)

LOCK_TIMEOUT_S = 120.0


@contextlib.contextmanager
def session_lock(system):
    """Hold ``system.map_lock``, waiting at most LOCK_TIMEOUT_S seconds for it."""
    if not system.map_lock.acquire(timeout=LOCK_TIMEOUT_S):
        raise TimeoutError(f"a session's map lock was not free within {LOCK_TIMEOUT_S} s")
    try:
        yield
    finally:
        system.map_lock.release()


class MultiSessionRunner:
    """Drives K ``System`` sessions concurrently and bundle-adjusts their
    pooled map with the landmark-sharded solver.

    systems:   constructed (not yet started) or running System instances.
    mesh:      device list of the pooled BA, one shard per entry (default:
               ``n_shards`` entries, 1 if not given, of the sessions'
               device).
    n_shards:  landmark shards when no mesh is given.
    """

    def __init__(self, systems: Sequence, mesh=None, n_shards: Optional[int] = None):
        self.systems = list(systems)
        if mesh is None:
            mesh = make_mesh(n_shards or 1, self.systems[0].device)
        self.mesh = list(mesh)
        self.n_shards = len(self.mesh)
        self._ba_cache: Dict[tuple, object] = {}
        self.joint_ba_runs = 0
        self.failed: List[int] = []    # sessions dropped by run() on error

    # ------------------------------------------------------------------
    def startup(self):
        for s in self.systems:
            if not getattr(s, "_running", False):
                s.startup()

    def shutdown(self):
        for s in self.systems:
            s.shutdown()

    def run(self, frame_iters: Sequence, joint_ba_every: int = 0,
            joint_ba_iters: int = 8, pipeline: bool = False,
            pipeline_depth: int = 1) -> List[List[bool]]:
        """Round-robin the sessions' frame streams until all are exhausted.

        frame_iters[i] yields the argument tuples of session i's feed
        (``System.feed_frame``: by its camera setup, ``feed_monocular_frame``,
        ``feed_stereo_frame`` or ``feed_RGBD_frame``).

        joint_ba_every: if > 0, run the pooled BA every that many frames fed
        in all (and once at the end).  Returns each session's list of
        per-frame tracked flags.

        pipeline: drive each session through ``System.feed_sequence(depth=
        pipeline_depth)`` and interleave the generators, so that session
        i's device step overlaps the other sessions' host bookkeeping.

        A session whose feed raises is dropped (its index goes to
        ``failed``, its map stays in the pool as it is) and the others go
        on."""
        self.startup()
        tracked: List[List[bool]] = [[] for _ in self.systems]
        total = 0
        if pipeline:
            streams = [s.feed_sequence(iter(f), kind=s.feed_kind(), depth=pipeline_depth)
                       for s, f in zip(self.systems, frame_iters)]
        else:
            feeds = [s.feed_frame for s in self.systems]
            iters = [iter(f) for f in frame_iters]
        live = [True] * len(self.systems)
        self.failed = []
        while any(live):
            for i in range(len(self.systems)):
                if not live[i]:
                    continue
                try:
                    if pipeline:
                        _ts, pose = next(streams[i])
                    else:
                        pose = feeds[i](*next(iters[i]))
                except StopIteration:
                    live[i] = False
                    continue
                except Exception:
                    # a failing session must not take the others down
                    log.exception("session %d failed; continuing with the surviving sessions", i)
                    live[i] = False
                    self.failed.append(i)
                    continue
                tracked[i].append(pose is not None)
                total += 1
                if joint_ba_every and total % joint_ba_every == 0:
                    self.joint_bundle_adjust(iters=joint_ba_iters)
        if joint_ba_every:
            self.joint_bundle_adjust(iters=joint_ba_iters)
        return tracked

    # ------------------------------------------------------------------
    def snapshot_problem(self) -> Optional[dict]:
        return pool_sessions(self.systems)

    def joint_bundle_adjust(self, iters: int = 10) -> Optional[float]:
        """Snapshot -> sharded solve over the mesh -> write back.

        Returns the final pooled robust cost, or None if skipped (the pooled
        map is too small).  The solve runs outside the map locks; the
        write-back takes each session's lock again and moves the keyframes
        and landmarks born during the solve with their anchors."""
        built = self.snapshot_problem()
        if built is None:
            return None
        sp = partition_problem(built["prob"], self.n_shards)
        key = (built["multicam"], built["stereo"], iters)
        if key not in self._ba_cache:
            self._ba_cache[key] = make_distributed_ba(
                self.systems[0].cam, self.mesh, stereo=built["stereo"], iters=iters,
                multicam=built["multicam"])
        T_out, X_out, cost = self._ba_cache[key](sp)
        T_out = T_out.cpu().numpy()
        X_out = X_out.cpu().numpy()
        for ps in built["per_session"]:
            s = ps["sys"]
            with session_lock(s):
                apply_ba_writeback(s.map_db, ps["cam_index"], ps["lm_index"],
                                   built["cam_opt"], T_out, X_out)
                s.map_db.version += 1
        self.joint_ba_runs += 1
        return float(cost)


def pool_sessions(systems: Sequence) -> Optional[dict]:
    """Pool every session's map into one padded ``BAProblem`` (CPU tensors).

    Camera slots are concatenated session by session (each origin keyframe
    fixed for gauge), landmark slots likewise; observations carry
    per-observation intrinsics when the sessions' cameras differ, and
    (u, v, u_right) when every session is stereo or RGB-D with one camera.
    Each session is read under its map lock.  Returns None when the pooled
    map is too small.  The layout (capacities the powers of two above
    the counts, at least 8 cameras, 64 landmarks and 256 observations) is
    the JAX package's ``pool_sessions``, array for array."""
    snaps = []
    cam_specs = set()
    all_stereo = all(s.cam.setup != SetupType.MONOCULAR for s in systems)
    for s in systems:
        with session_lock(s):
            db = s.map_db
            kf_ids = [int(k) for k in db.valid_kf_ids()]
            lm_ids = [int(l) for l in db.valid_lm_ids()]
            sigma2 = s.global_optimizer.sigma2
            t_lm, t_kf, _t_kpt, t_u, t_v, t_xr, t_lvl = db.observation_rows()
            rows = np.where((t_lm >= 0) & db.kf_valid[np.clip(t_kf, 0, None)])[0]
            snaps.append({
                "sys": s, "kf_ids": kf_ids, "lm_ids": lm_ids,
                "kf_pose": {k: db.kf_pose_cw[k].copy() for k in kf_ids},
                "lm_pos": {l: db.lm_pos[l].copy() for l in lm_ids},
                "origin": db.origin_kf, "n_kfs": db.n_kfs, "n_lms": db.n_lms,
                "obs": {
                    "kf": t_kf[rows].copy(), "lm": t_lm[rows].copy(),
                    "u": t_u[rows].copy(), "v": t_v[rows].copy(),
                    "sg": sigma2[np.clip(t_lvl[rows], 0, len(sigma2) - 1)].astype(np.float32),
                    "xr": (t_xr[rows].copy() if all_stereo
                           else np.full(len(rows), -1.0, np.float32)),
                },
            })
        spec = camera_to_config(s.cam)
        cam_specs.add(tuple(sorted((k, v) for k, v in spec.items()
                                   if not isinstance(v, (list, dict)))))

    n_c = sum(len(sn["kf_ids"]) for sn in snaps)
    n_l = sum(len(sn["lm_ids"]) for sn in snaps)
    n_o = sum(len(sn["obs"]["kf"]) for sn in snaps)
    if n_c < 3 or n_l < 30 or n_o < 60:
        return None
    multicam = len(cam_specs) > 1
    # stereo edges (u, v, u_right) only when every session is stereo/RGB-D
    # and they share one camera (the multi-camera edge is monocular)
    stereo = all_stereo and not multicam

    C = max(8, 1 << int(np.ceil(np.log2(n_c))))
    L = max(64, 1 << int(np.ceil(np.log2(n_l))))
    O = max(256, 1 << int(np.ceil(np.log2(n_o))))
    D = 2 + R.CAMV_DIM if multicam else (3 if stereo else 2)

    T = np.tile(np.eye(4, dtype=np.float32), (C, 1, 1))
    cam_opt = np.zeros(C, bool)
    cam_valid = np.zeros(C, bool)
    X = np.zeros((L, 3), np.float32)
    lm_valid = np.zeros(L, bool)
    oc = np.zeros(O, np.int32)
    ol = np.zeros(O, np.int32)
    ouv = np.zeros((O, D), np.float32)
    osg = np.ones(O, np.float32)
    om = np.zeros(O, bool)

    cam_off = lm_off = n_obs = 0
    per_session = []
    for sn in snaps:
        cam_index = {k: cam_off + i for i, k in enumerate(sn["kf_ids"])}
        lm_index = {l: lm_off + i for i, l in enumerate(sn["lm_ids"])}
        for k, i in cam_index.items():
            T[i] = sn["kf_pose"][k]
            cam_valid[i] = True
            cam_opt[i] = k != sn["origin"]
        for l, i in lm_index.items():
            X[i] = sn["lm_pos"][l]
            lm_valid[i] = True
        ob = sn["obs"]
        cam_lookup = np.full(sn["n_kfs"], -1, np.int32)
        cam_lookup[list(cam_index)] = list(cam_index.values())
        lm_lookup = np.full(sn["n_lms"], -1, np.int32)
        lm_lookup[list(lm_index)] = list(lm_index.values())
        oc_s = cam_lookup[np.clip(ob["kf"], 0, sn["n_kfs"] - 1)]
        ol_s = lm_lookup[np.clip(ob["lm"], 0, sn["n_lms"] - 1)]
        sel = np.where((oc_s >= 0) & (ol_s >= 0))[0][: O - n_obs]
        sl = slice(n_obs, n_obs + len(sel))
        oc[sl] = oc_s[sel]
        ol[sl] = ol_s[sel]
        ouv[sl, 0] = ob["u"][sel]
        ouv[sl, 1] = ob["v"][sel]
        if multicam:
            ouv[sl, 2:] = R.make_camv(camera_to_config(sn["sys"].cam))
        elif stereo:
            ouv[sl, 2] = ob["xr"][sel]
        osg[sl] = ob["sg"][sel]
        om[sl] = True
        n_obs += len(sel)
        per_session.append({"sys": sn["sys"], "cam_index": cam_index, "lm_index": lm_index})
        cam_off += len(sn["kf_ids"])
        lm_off += len(sn["lm_ids"])

    t = torch.from_numpy
    prob = BAProblem(t(T), t(cam_opt), t(cam_valid), t(X), t(lm_valid), t(oc), t(ol), t(ouv),
                     t(osg), t(om))
    return {"prob": prob, "per_session": per_session, "multicam": multicam,
            "stereo": stereo, "cam_opt": cam_opt, "shapes": (C, L, O, D)}
