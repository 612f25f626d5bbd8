"""Multi-process multi-session SLAM: each process its own sessions, one
pooled BA across the processes (counterpart of
``openvslam_tpu/parallel/multi_session_multihost.py``).

Each process (one per GPU, or on the CPU) runs its own ``System`` sessions
and feeds their frames itself; now and then every process joins ONE pooled
bundle adjustment over the ``torch.distributed`` group:

1. every process pools its own sessions (``multi_session.pool_sessions``);
2. the control plane (``multihost.process_allgather``) exchanges the
   processes' unpadded camera, landmark and observation blocks, with
   camera and landmark offsets from the cumulative counts;
3. every process assembles the identical global problem and runs the
   landmark-sharded solve (``multihost.make_multihost_ba``): each places
   only its own shards on its device, and the reduced camera system is
   summed with ``all_reduce``;
4. every process writes back ONLY its own sessions, with the born-during
   propagation of the in-session global BA.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..camera.base import SetupType, camera_to_config
from ..module.global_optimization_module import apply_ba_writeback
from ..optimize import residuals as R
from ..optimize.ba import BAProblem
from ..utils.log import get_logger
from . import multihost
from .multi_session import pool_sessions, session_lock

_log = get_logger("multihost_pool")


class MultihostSessionPool:
    """This process's sessions + the pooled BA across the group.

    Construct after ``multihost.initialize``.  Every process must call
    ``joint_bundle_adjust`` together (it holds collectives); feeding frames
    is local.  This process's shard of the pooled BA lives on its
    sessions' device, and the collectives run over the default group."""

    def __init__(self, local_systems: Sequence):
        self.systems = list(local_systems)
        self.device = self.systems[0].device
        self._solver = None
        self._solver_key = None
        self.joint_ba_runs = 0
        self.last_cost: Optional[float] = None

    # ------------------------------------------------------------------
    def run_local(self, frame_iters: Sequence, joint_ba_every: int = 0,
                  joint_ba_iters: int = 8) -> List[List[bool]]:
        """Round-robin this process's sessions.  ``joint_ba_every`` counts
        frames fed by this process and must agree across processes when
        used (the pooled BA is a collective)."""
        for s in self.systems:
            if not getattr(s, "_running", False):
                s.startup()
        tracked: List[List[bool]] = [[] for _ in self.systems]
        iters = [iter(f) for f in frame_iters]
        live = [True] * len(self.systems)
        total = 0
        while any(live):
            for i, s in enumerate(self.systems):
                if not live[i]:
                    continue
                try:
                    pose = s.feed_frame(*next(iters[i]))
                except StopIteration:
                    live[i] = False
                    continue
                tracked[i].append(pose is not None)
                total += 1
                if joint_ba_every and total % joint_ba_every == 0:
                    self.joint_bundle_adjust(iters=joint_ba_iters)
        return tracked

    # ------------------------------------------------------------------
    def global_problem(self) -> Optional[dict]:
        """The pooled problem of every process's sessions, identical on every
        rank (collective): {"prob", "stereo", "multicam", "cam_off",
        "lm_off", "local"}, or None when the whole pool is too small."""
        built = pool_sessions(self.systems)
        camv_local = np.zeros(R.CAMV_DIM, np.float32)
        if built is None:
            n_c = n_l = n_o = 0
            stereo = all(s.cam.setup != SetupType.MONOCULAR for s in self.systems)
            mc_local = False
        else:
            prob = built["prob"]
            n_c = int(prob.cam_valid.sum())
            n_l = int(prob.lm_valid.sum())
            n_o = int(prob.obs_mask.sum())
            stereo = built["stereo"]
            mc_local = built["multicam"]
        if not mc_local and self.systems:
            camv_local = R.make_camv(camera_to_config(self.systems[0].cam)).astype(np.float32)

        # ---- control plane: counts, camera agreement, offsets ----------
        counts = multihost.process_allgather(np.asarray(
            [n_c, n_l, n_o, int(stereo), int(mc_local)], np.int64)).reshape(-1, 5)
        camvs = multihost.process_allgather(camv_local).reshape(len(counts), -1)
        if int(counts[:, 0].sum()) < 3 or int(counts[:, 1].sum()) < 30:
            return None
        data = np.where(counts[:, 0] > 0)[0]
        # the edge, decided alike on every rank: mixed cameras if any
        # contributing rank mixes them or their cameras differ; else stereo
        # only if every contributing rank is stereo
        multicam = bool(counts[data, 4].any()) or not all(
            np.array_equal(camvs[h], camvs[data[0]]) for h in data)
        stereo = bool(counts[data, 3].all()) and not multicam
        D = 2 + R.CAMV_DIM if multicam else (3 if stereo else 2)

        # ---- local blocks at the agreed observation width --------------
        if built is None:
            T_loc = np.zeros((0, 4, 4), np.float32)
            opt_loc = np.zeros(0, bool)
            X_loc = np.zeros((0, 3), np.float32)
            obs_loc = (np.zeros(0, np.int32), np.zeros(0, np.int32),
                       np.zeros((0, D), np.float32), np.zeros(0, np.float32))
        else:
            T_loc = prob.T_cw.numpy()[:n_c]
            opt_loc = prob.cam_opt.numpy()[:n_c]
            X_loc = prob.X.numpy()[:n_l]
            ouv = prob.obs_uv.numpy()[:n_o]
            if multicam and not mc_local:
                # a one-camera rank in a mixed pool: (u, v) and its camera
                ouv = np.concatenate([ouv[:, :2], np.tile(camv_local, (n_o, 1))], axis=1)
            elif not multicam and ouv.shape[1] != D:
                if ouv.shape[1] > D:        # stereo rank, mono pool
                    ouv = ouv[:, :D]
                else:                       # mono rank, stereo pool
                    ouv = np.concatenate([ouv, np.full((n_o, D - ouv.shape[1]), -1.0,
                                                       np.float32)], axis=1)
            obs_loc = (prob.obs_cam.numpy()[:n_o], prob.obs_lm.numpy()[:n_o],
                       ouv.astype(np.float32), prob.obs_sigma2.numpy()[:n_o])

        cam_off = np.zeros(len(counts) + 1, np.int64)
        cam_off[1:] = np.cumsum(counts[:, 0])
        lm_off = np.zeros(len(counts) + 1, np.int64)
        lm_off[1:] = np.cumsum(counts[:, 1])

        # ---- exchange the raw blocks (padded to the largest rank's) ----
        def xg(a, cap, fill=0.0):
            pad = np.full((cap - a.shape[0],) + a.shape[1:], fill, a.dtype)
            return multihost.process_allgather(np.concatenate([a, pad], axis=0))

        Cm, Lm, Om = (int(counts[:, i].max()) for i in range(3))
        T_all, opt_all = xg(T_loc, Cm), xg(opt_loc, Cm, False)
        X_all = xg(X_loc, Lm)
        oc_all, ol_all = xg(obs_loc[0], Om), xg(obs_loc[1], Om)
        ouv_all, osg_all = xg(obs_loc[2], Om), xg(obs_loc[3], Om, 1.0)

        # ---- the same global assembly on every rank --------------------
        n_cg, n_lg = int(cam_off[-1]), int(lm_off[-1])
        n_og = int(counts[:, 2].sum())
        C = max(8, 1 << int(np.ceil(np.log2(n_cg))))
        L = max(64, 1 << int(np.ceil(np.log2(n_lg))))
        O = max(256, 1 << int(np.ceil(np.log2(max(n_og, 2)))))
        T = np.tile(np.eye(4, dtype=np.float32), (C, 1, 1))
        cam_opt = np.zeros(C, bool)
        cam_valid = np.zeros(C, bool)
        X = np.zeros((L, 3), np.float32)
        lm_valid = np.zeros(L, bool)
        oc = np.zeros(O, np.int32)
        ol = np.zeros(O, np.int32)
        ouv = np.zeros((O, D), np.float32)
        osg = np.ones(O, np.float32)
        omk = np.zeros(O, bool)
        o_at = 0
        for h in range(len(counts)):
            ch, lh, oh = (int(counts[h, i]) for i in range(3))
            T[cam_off[h]:cam_off[h] + ch] = T_all[h, :ch]
            cam_opt[cam_off[h]:cam_off[h] + ch] = opt_all[h, :ch]
            cam_valid[cam_off[h]:cam_off[h] + ch] = True
            X[lm_off[h]:lm_off[h] + lh] = X_all[h, :lh]
            lm_valid[lm_off[h]:lm_off[h] + lh] = True
            sl = slice(o_at, o_at + oh)
            oc[sl] = oc_all[h, :oh] + cam_off[h]
            ol[sl] = ol_all[h, :oh] + lm_off[h]
            ouv[sl] = ouv_all[h, :oh]
            osg[sl] = osg_all[h, :oh]
            omk[sl] = True
            o_at += oh
        t = torch.from_numpy
        gprob = BAProblem(t(T), t(cam_opt), t(cam_valid), t(X), t(lm_valid), t(oc), t(ol),
                          t(ouv), t(osg), t(omk))
        return {"prob": gprob, "stereo": stereo, "multicam": multicam, "cam_off": cam_off,
                "lm_off": lm_off, "local": built, "counts": counts}

    def joint_bundle_adjust(self, iters: int = 10) -> Optional[float]:
        """The pooled BA across the group (collective: every rank calls it).
        Returns the pooled robust cost, or None when the whole pool is too
        small (decided alike on every rank from the gathered counts)."""
        gp = self.global_problem()
        if gp is None:
            return None
        key = (gp["stereo"], gp["multicam"], iters)
        if self._solver is None or self._solver_key != key:
            _, self._solver = multihost.make_multihost_ba(
                self.systems[0].cam, self.device, stereo=gp["stereo"], iters=iters,
                multicam=gp["multicam"])
            self._solver_key = key
        T_out, X_out, cost = self._solver(gp["prob"])

        # ---- write back this rank's sessions only ----------------------
        rank = dist.get_rank()
        cam_opt = gp["prob"].cam_opt.numpy()
        if gp["local"] is not None:
            for ps in gp["local"]["per_session"]:
                s = ps["sys"]
                ci = {k: int(i + gp["cam_off"][rank]) for k, i in ps["cam_index"].items()}
                li = {l: int(i + gp["lm_off"][rank]) for l, i in ps["lm_index"].items()}
                with session_lock(s):
                    apply_ba_writeback(s.map_db, ci, li, cam_opt, T_out, X_out)
                    s.map_db.version += 1
        self.joint_ba_runs += 1
        self.last_cost = cost
        counts = gp["counts"]
        _log.info("cross-process pooled BA #%d: %d cams / %d lms / %d obs over %d ranks, "
                  "cost %.4f", self.joint_ba_runs, int(counts[:, 0].sum()),
                  int(counts[:, 1].sum()), int(counts[:, 2].sum()), len(counts), cost)
        return cost
