"""Loop detector (counterpart of ``openvslam_tpu/module/loop_detector.py``;
ref ``module/loop_detector``): BoW candidates gated by the covisibility
minimum score, a continuity check over consecutive keyframes, then Sim3
validation: word-gated match -> Horn RANSAC -> projection widening with the
RANSAC Sim3 in both directions (kernel K2) -> transform optimizer ->
inlier gate.

The matching, RANSAC and optimizer run on the module's device as plain
PyTorch; the widening's guided search is ``ops.match.projection_scale_match``
(K2 on the card).
"""
from __future__ import annotations

from typing import List, Set, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..ops import bow as bow_ops
from ..ops import match as M
from ..ops import ransac, solvers
from ..optimize.sim3_transform import make_sim3_transform_optimizer

N_HYP = 128


class LoopDetector:
    SEED = 23

    def __init__(self, cfg, cam, map_db, bow_db, fix_scale: bool = False, device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.cam = cam
        self.db = map_db
        self.bow_db = bow_db
        self.fix_scale = fix_scale
        self.cont_groups: List[Tuple[Set[int], int]] = []   # (group KFs, chain length)
        self.sim3_opt = make_sim3_transform_optimizer(cam, fix_scale=fix_scale)
        self.gen = torch.Generator(device=self.device).manual_seed(self.SEED)
        self.min_continuity = cfg.loop.min_continuity

    def _t(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), device=self.device)

    # ------------------------------------------------------------------
    def detect(self, kf: int) -> List[int]:
        """Continuity-validated loop candidates of keyframe kf."""
        db = self.db
        covis = db.get_top_covisible(kf, 30)
        if not covis:
            self.cont_groups = []
            return []
        scores = [self.bow_db.score(kf, c) for c in covis if c in self.bow_db.kf_bow]
        if not scores:
            self.cont_groups = []
            return []
        connected = set(covis) | {kf}
        cands = self.bow_db.acquire_loop_candidates(kf, min(scores), connected)
        if not cands:
            self.cont_groups = []
            return []
        # continuity: a candidate's group must intersect a previous group
        validated = []
        new_groups: List[Tuple[Set[int], int]] = []
        for cand in cands:
            group = set([cand] + db.get_top_covisible(cand, 10))
            chain = 0
            for prev_group, prev_chain in self.cont_groups:
                if group & prev_group:
                    chain = max(chain, prev_chain + 1)
            new_groups.append((group, chain))
            if chain >= self.min_continuity - 1:
                validated.append(cand)
        self.cont_groups = new_groups
        return validated

    # ------------------------------------------------------------------
    def snapshot(self, kf: int, cand: int) -> dict:
        """Copy everything Sim3 validation reads from the map for the pair
        (kf, cand): keypoint columns, per-slot landmark positions and
        validity, poses, BoW gate words."""
        db = self.db
        snap = {"kf": kf, "cand": cand, "geom_version": db.geom_version}
        for tag, k in (("k", kf), ("c", cand)):
            if k not in self.bow_db.kf_words:   # registered on demand (bootstrap KFs)
                self.bow_db.add_keyframe(k, self.bow_db.compute_words(db.kf_desc_i8[k],
                                                                      db.kf_kpt_valid[k]))
            lm_idx = db.kf_lm_idx[k].copy()
            lmc = np.clip(lm_idx, 0, db.n_lms - 1)
            snap[tag] = {
                "desc": db.kf_desc_i8[k],
                "desc_u32": np.ascontiguousarray(db.kf_desc_u32[k]).view(np.int32),
                "und": db.kf_xy_undist[k],
                "level": db.kf_level[k].astype(np.int32),
                "kpt_valid": db.kf_kpt_valid[k],
                "lm_idx": lm_idx,
                "lmok": (lm_idx >= 0) & db.lm_valid[lmc],
                "X": db.lm_pos[lmc].copy(),
                "pose": db.kf_pose_cw[k].copy(),
                "words": self.bow_db.gate_words(self.bow_db.kf_words[k]),
            }
        return snap

    def prefilter_counts(self, snaps: List[dict]) -> np.ndarray:
        """First-stage match counts of a batch of snapshots of the same kf in
        one batched match: the count validate_snapshot gates on
        min_num_bow_matches.  Candidate axis padded to a power of two."""
        if not snaps:
            return np.zeros(0, np.int32)
        sk = snaps[0]["k"]
        C = len(snaps)
        cap = 1 << int(np.ceil(np.log2(max(C, 1))))
        shp = snaps[0]["c"]["desc"].shape
        bits_cs = np.zeros((cap,) + shp, np.int8)
        has_cs = np.zeros((cap, shp[0]), bool)
        words_cs = np.full((cap, len(sk["words"])), -1, np.int64)
        for i, s in enumerate(snaps):
            sc = s["c"]
            bits_cs[i] = sc["desc"]
            has_cs[i] = sc["lmok"] & sc["kpt_valid"]
            words_cs[i] = sc["words"]
        words_k = self._t(np.asarray(sk["words"], np.int64))
        gate = bow_ops.word_gate(words_k.expand(cap, -1), self._t(words_cs))
        idx, _ = M.match_descriptors(
            self._t(sk["desc"]).expand(cap, -1, -1), self._t(bits_cs),
            self._t(sk["lmok"] & sk["kpt_valid"]).expand(cap, -1), self._t(has_cs), gate=gate,
            max_dist=M.HAMMING_DIST_THR_LOW, ratio=0.9, cross_check=True)
        return (idx >= 0).sum(-1).cpu().numpy()[:C]

    @staticmethod
    def _pair_points(snap, mk, mc):
        sk, sc = snap["k"], snap["c"]
        T_k, T_c = sk["pose"], sc["pose"]
        pk = (T_k[:3, :3] @ sk["X"][mk].T).T + T_k[:3, 3]   # in the current camera
        pc = (T_c[:3, :3] @ sc["X"][mc].T).T + T_c[:3, 3]   # in the candidate camera
        return pk, pc

    @staticmethod
    def _padded(pk, pc):
        n = len(pk)
        cap = max(64, 1 << int(np.ceil(np.log2(max(n, 2)))))
        p1 = np.zeros((cap, 3), np.float32)
        p2 = np.zeros((cap, 3), np.float32)
        pmask = np.zeros(cap, bool)
        p1[:n] = pc          # candidate-frame coordinates (source)
        p2[:n] = pk          # current-frame coordinates (target)
        pmask[:n] = True
        return p1, p2, pmask

    def bow_matches(self, snap):
        """The word-gated cross-checked first stage: (mk, mc) keypoint slots
        of kf and cand whose both sides carry a live landmark, or None when
        fewer than min_num_bow_matches."""
        sk, sc = snap["k"], snap["c"]
        has_lm_k = sk["lmok"] & sk["kpt_valid"]
        has_lm_c = sc["lmok"] & sc["kpt_valid"]
        gate = bow_ops.word_gate(self._t(np.asarray(sk["words"], np.int64)),
                                 self._t(np.asarray(sc["words"], np.int64)))
        idx, _ = M.match_descriptors(self._t(sk["desc"]), self._t(sc["desc"]),
                                     self._t(has_lm_k), self._t(has_lm_c), gate=gate,
                                     max_dist=M.HAMMING_DIST_THR_LOW, ratio=0.9,
                                     cross_check=True)
        idx = idx.cpu().numpy()
        mk = np.where(idx >= 0)[0]
        if len(mk) < self.cfg.loop.min_num_bow_matches:
            return None
        mc = idx[mk]
        ok = has_lm_k[mk] & has_lm_c[mc]
        mk, mc = mk[ok], mc[ok]
        if len(mk) < self.cfg.loop.min_num_bow_matches:
            return None
        return mk, mc

    def validate_snapshot(self, snap: dict, min_inliers: int = 20, samples=None):
        """Returns (R, t, s) of S(cur <- cand) (candidate camera coordinates
        -> current camera coordinates), the matched keypoint slots and their
        landmark pairs, or None.  ``samples`` (N_HYP, 3) replaces the RANSAC
        draw from the module's generator (the parity tests feed the JAX
        package's)."""
        sk, sc = snap["k"], snap["c"]
        m = self.bow_matches(snap)
        if m is None:
            return None
        mk, mc = m
        pk, pc = self._pair_points(snap, mk, mc)
        p1, p2, pmask = self._padded(pk, pc)
        p1j, p2j, mj = self._t(p1), self._t(p2), self._t(pmask)
        if samples is None:
            samples = ransac.sample_minimal_sets(self.gen, mj, N_HYP, 3)
        samples = torch.as_tensor(samples, device=self.device).to(torch.int64)
        # RANSAC over Horn 3-point fits; threshold scaled by the scene depth
        thr = (0.05 * float(np.median(pk[:, 2]))) ** 2
        g, _, inl = ransac.ransac_from_samples(
            samples, lambda s: solvers.fit_sim3_horn(p1j[s], p2j[s], fix_scale=self.fix_scale),
            lambda g: solvers.score_sim3(g, p1j, p2j, mj, thr))
        n_ransac = int(inl.sum())
        if n_ransac < 10:
            return None
        # Sim3-warped projection widening in both directions (ref
        # validate_candidates: match::projection with the RANSAC Sim3 before
        # the transform optimization)
        g_np = (g[0].cpu().numpy(), g[1].cpu().numpy(), float(g[2]))
        add_k, add_c = self._widen_matches(snap, g_np, set(int(i) for i in mk),
                                           set(int(i) for i in mc))
        if len(add_k):
            mk = np.concatenate([mk, add_k])
            mc = np.concatenate([mc, add_c])
            pk, pc = self._pair_points(snap, mk, mc)
            p1, p2, pmask = self._padded(pk, pc)
            p1j, p2j, mj = self._t(p1), self._t(p2), self._t(pmask)
        n, cap = len(mk), len(p1)
        # refine with mutual reprojection (keypoint observations)
        uv1 = np.zeros((cap, 2), np.float32)
        uv2 = np.zeros((cap, 2), np.float32)
        s2_1 = np.ones(cap, np.float32)
        s2_2 = np.ones(cap, np.float32)
        uv1[:n] = sk["und"][mk]
        uv2[:n] = sc["und"][mc]
        sf = self.cfg.feature.scale_factor
        s2_1[:n] = (sf ** sk["level"][mk]) ** 2
        s2_2[:n] = (sf ** sc["level"][mc]) ** 2
        res = self.sim3_opt(g[0], g[1], g[2], p2j, p1j, self._t(uv1), self._t(uv2),
                            self._t(s2_1), self._t(s2_2), mj)
        if int(res.num_inliers) < min_inliers:
            return None
        return (res.R.cpu().numpy(), res.t.cpu().numpy(), float(res.s), mk, mc,
                sk["lm_idx"][mk], sc["lm_idx"][mc])

    # ------------------------------------------------------------------
    def _widen_matches(self, snap, g, taken_k, taken_c, radius_base: float = 8.0):
        """Sim3-guided projection search in both directions (ref
        match::projection in validate_candidates): project cand's landmarks
        into kf via g = S(cur <- cand) and kf's into cand via g^-1, match
        within a scale-dependent radius (kernel K2, the HIGH threshold, no
        ratio test, cross-checked), and keep the mutually consistent new
        pairs whose both sides carry a landmark.  Returns (new_k, new_c)."""
        R, t, s = g
        sf = self.cfg.feature.scale_factor

        def project_dir(src, dst, Rg, tg, sg, taken_src):
            a_valid = src["lmok"] & src["kpt_valid"]
            if len(taken_src):
                a_valid = a_valid.copy()
                a_valid[list(taken_src)] = False
            T_src = src["pose"]
            p_src = (T_src[:3, :3] @ src["X"].T).T + T_src[:3, 3]
            p_dst = (sg * (Rg @ p_src.T).T + tg).astype(np.float32)
            uv, z, _ = self.cam.project(self._t(p_dst))
            vis = self._t(a_valid) & (z > 1e-6)
            level = src["level"]
            radius = (radius_base * (sf ** level.astype(np.float32))).astype(np.float32)
            idx, _ = M.projection_scale_match(
                self._t(src["desc_u32"]), self._t(dst["desc_u32"]), uv, vis, self._t(radius),
                self._t(level.astype(np.int64)), self._t(dst["und"]),
                self._t(dst["level"].astype(np.int64)), self._t(dst["lmok"] & dst["kpt_valid"]),
                max_dist=M.HAMMING_DIST_THR_HIGH, ratio=None, cross_check=True,
                image_size=(self.cam.cols, self.cam.rows))
            return idx.cpu().numpy()

        # direction 1: cand landmarks -> kf image (m1[jc] = ik)
        m1 = project_dir(snap["c"], snap["k"], R, t, s, taken_c)
        # direction 2: kf landmarks -> cand image (m2[ik] = jc)
        Ri = R.T
        si = 1.0 / max(s, 1e-12)
        m2 = project_dir(snap["k"], snap["c"], Ri, -si * (Ri @ t), si, taken_k)
        new_k, new_c = [], []
        for jc in np.where(m1 >= 0)[0]:
            ik = int(m1[jc])
            if ik in taken_k or int(jc) in taken_c:
                continue
            if int(m2[ik]) == int(jc):      # mutual agreement
                new_k.append(ik)
                new_c.append(int(jc))
                taken_k.add(ik)
                taken_c.add(int(jc))
        return np.asarray(new_k, np.int64), np.asarray(new_c, np.int64)
