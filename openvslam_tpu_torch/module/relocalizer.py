"""Relocalizer (counterpart of ``openvslam_tpu/module/relocalizer.py``; ref
``module/relocalizer``): recover the pose when tracking is lost.

BoW candidates -> stage 1 for all candidates at once (word-gated
cross-checked descriptor match, EPnP RANSAC on bearings; plain PyTorch,
candidates padded to ``RELOC_CAND_CAP``) -> stage 2 for the first surviving
candidate in BoW order (pose LM through kernel K3, widened match by
projection over the candidate's local map through kernel K2, final K3) ->
accept above the inlier gate.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from ..models import tracking_ops as TO
from ..ops import bow as bow_ops
from ..ops import match as M
from ..ops import ransac, solvers
from ..ops.orb import unpack_bits_i8
from ..optimize.pose_optimizer import make_pose_optimizer

RELOC_CAND_CAP = 16   # fixed stage-1 candidate padding (>= the BoW cap of 10)
N_HYP = 128


def stage1_match(d_f, v_f, words_f, kf_desc_u32, kf_words, kf_ok, kf_pts):
    """Word-gated cross-checked match of the frame's keypoints against every
    candidate keyframe's landmark keypoints.  d_f (K,256) bits, v_f (K,),
    words_f (K,) gate ids; kf_desc_u32 (C,Kf,8) packed, kf_words (C,Kf),
    kf_ok (C,Kf) keypoints with a live landmark, kf_pts (C,Kf,3) their
    positions.  Returns (idx (C,K) frame keypoint -> keyframe keypoint,
    pair_ok (C,K), P (C,K,3) matched world points, n_match (C,))."""
    C, Kf = kf_desc_u32.shape[:2]
    desc = unpack_bits_i8(kf_desc_u32.reshape(C * Kf, 8)).reshape(C, Kf, 256)
    desc = torch.where(kf_ok[..., None], desc, 0)
    gate = bow_ops.word_gate(words_f.expand(C, -1), kf_words)
    idx, _ = M.match_descriptors(d_f.expand(C, -1, -1), desc, v_f.expand(C, -1), kf_ok,
                                 gate=gate, max_dist=M.HAMMING_DIST_THR_LOW, ratio=0.9,
                                 cross_check=True)
    pair_ok = idx >= 0
    P = torch.gather(kf_pts, 1, torch.clamp(idx, min=0).to(torch.int64)[..., None].expand(-1, -1, 3))
    return idx, pair_ok, P, pair_ok.to(torch.int32).sum(-1)


def stage1_ransac(samples, brg_f, P, pair_ok):
    """EPnP RANSAC per candidate on the given draws (C, n_hyp, 4).
    Returns (T_est (C,4,4), n_inl (C,))."""
    C = P.shape[0]
    rows = torch.arange(C, device=P.device)[:, None, None]
    b = brg_f[samples]
    T_est, _, inl = ransac.ransac_from_samples(
        samples, lambda s: solvers.fit_pnp_epnp(b, P[rows, s]),
        lambda T: solvers.score_pnp(T, brg_f[None, None], P[:, None], pair_ok[:, None],
                                    thr_cos=0.9998))
    return T_est, (inl & pair_ok).to(torch.int32).sum(-1)


def reloc_stage1(gen, d_f, v_f, brg_f, words_f, kf_desc_u32, kf_words, kf_ok, kf_pts,
                 samples=None):
    """Stage 1 of relocalization for all candidates in one batched pass.
    ``samples`` (C, N_HYP, 4) replaces the draw from ``gen`` (the parity
    tests feed the JAX package's).  Returns (idx (C,K), n_match (C,),
    T_est (C,4,4), n_inl (C,))."""
    idx, pair_ok, P, n_match = stage1_match(d_f, v_f, words_f, kf_desc_u32, kf_words, kf_ok,
                                            kf_pts)
    if samples is None:
        samples = ransac.sample_minimal_sets(gen, pair_ok, N_HYP, 4)
    T_est, n_inl = stage1_ransac(samples, brg_f, P, pair_ok)
    return idx, n_match, T_est, n_inl


class Relocalizer:
    SEED = 17

    def __init__(self, cfg, cam, map_db, bow_db, min_inliers: int = 40, device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.cam = cam
        self.db = map_db
        self.bow_db = bow_db
        self.min_inliers = min_inliers
        self.pose_opt = make_pose_optimizer(cam)
        nl = cfg.feature.num_levels
        sf = cfg.feature.scale_factor
        self.scale_factors = np.array([sf**l for l in range(nl)], np.float32)
        self.sigma2 = self.scale_factors**2
        self.num_levels = nl
        self.gen = torch.Generator(device=self.device).manual_seed(self.SEED)
        self.last_reloc_kf = -1
        self.attempts = 0

    def _t(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), device=self.device)

    def stage1_operands(self, frame, words, cands):
        """Host packing of stage 1's operands, candidates padded with the
        first to RELOC_CAND_CAP (a power of two above it)."""
        db = self.db
        C = len(cands)
        Cp = RELOC_CAND_CAP if C <= RELOC_CAND_CAP else 1 << int(np.ceil(np.log2(C)))
        padded = list(cands) + [cands[0]] * (Cp - C)
        Kf = db.kf_desc_u32[int(cands[0])].shape[0]
        kf_desc = np.zeros((Cp, Kf, 8), np.uint32)
        kf_words = np.zeros((Cp, Kf), np.int32)
        kf_ok = np.zeros((Cp, Kf), bool)
        kf_pts = np.zeros((Cp, Kf, 3), np.float32)
        for ci, kf in enumerate(padded):
            kf = int(kf)
            arr = db.kf_lm_idx[kf]
            ok = (arr >= 0) & db.kf_kpt_valid[kf] & db.lm_valid[np.clip(arr, 0, None)]
            kf_desc[ci] = db.kf_desc_u32[kf]
            kf_words[ci] = self.bow_db.gate_words(self.bow_db.kf_words[kf])
            kf_ok[ci] = ok
            kf_pts[ci][ok] = db.lm_pos[arr[ok]]
        return {"d_f": frame.desc_i8, "v_f": frame.valid, "brg_f": frame.bearing,
                "words_f": self.bow_db.gate_words(words).astype(np.int32),
                "kf_desc_u32": kf_desc.view(np.int32), "kf_words": kf_words,
                "kf_ok": kf_ok, "kf_pts": kf_pts}

    def relocalize(self, frame, min_inliers: Optional[int] = None) -> Optional[np.ndarray]:
        """``min_inliers`` overrides the acceptance gate for this call (the
        tracker's post-loss grace window lowers it)."""
        gate = self.min_inliers if min_inliers is None else int(min_inliers)
        self.attempts += 1
        words = self.bow_db.compute_words(frame.desc_i8, frame.valid)
        cands = self.bow_db.acquire_relocalization_candidates(words)
        if not cands:
            return None
        ops = self.stage1_operands(frame, words, cands)
        idx_all, n_match, T_all, n_inl = (x.cpu().numpy() for x in reloc_stage1(
            self.gen, **{k: self._t(v) for k, v in ops.items()}))
        # candidates in BoW-rank order; the first to pass every gate wins
        for ci, kf in enumerate(cands):
            if int(n_match[ci]) < 15 or int(n_inl[ci]) < 10:
                continue
            T = self._refine_candidate(frame, int(kf), idx_all[ci], ops["kf_ok"][ci],
                                       T_all[ci].astype(np.float32), gate)
            if T is not None:
                self.last_reloc_kf = int(kf)
                return T
        return None

    def _refine_candidate(self, frame, kf: int, idx, kf_ok, T_est, gate: int):
        """Stage 2 for one surviving candidate: pose LM on the matches, match
        by projection over the candidate's local map, final LM."""
        db = self.db
        m_f = np.where((idx >= 0) & kf_ok[np.clip(idx, 0, None)])[0]
        frame.lm_idx[:] = -1
        frame.lm_idx[m_f] = db.kf_lm_idx[kf][idx[m_f]]
        T_opt, num_inl = self._pose_optimize(frame, T_est)
        if num_inl < 10:
            frame.lm_idx[:] = -1
            return None
        lm_set = set()
        for k2 in [kf] + db.get_top_covisible(kf, 10):
            arr = db.kf_lm_idx[k2]
            lm_set.update(int(lm) for lm in arr[arr >= 0] if db.lm_valid[lm])
        cand_lms = np.array(sorted(lm_set), np.int64)
        Lcap = 4096
        n2 = min(len(cand_lms), Lcap)
        pos = np.zeros((Lcap, 3), np.float32)
        desc = np.zeros((Lcap, 8), np.uint32)
        valid = np.zeros(Lcap, bool)
        pos[:n2] = db.lm_pos[cand_lms[:n2]]
        desc[:n2] = db.lm_desc_u32[cand_lms[:n2]]
        valid[:n2] = True
        idx2, _, _ = TO.match_landmarks_by_projection(
            self.cam, self._t(np.asarray(T_opt, np.float32)), self._t(pos),
            self._t(desc.view(np.int32)), self._t(valid),
            self._t(np.ascontiguousarray(frame.desc_u32).view(np.int32)),
            self._t(frame.xy_undist), self._t(frame.valid),
            self._t(frame.level.astype(np.int64)), 10.0,
            self._t(self.scale_factors), self._t(np.full(Lcap, -1, np.int64)))
        idx2 = idx2.cpu().numpy()
        for j in np.where(idx2[:n2] >= 0)[0]:
            kpt = int(idx2[j])
            if frame.lm_idx[kpt] < 0:
                frame.lm_idx[kpt] = cand_lms[j]
        T_fin, num_inl = self._pose_optimize(frame, T_opt)
        if num_inl < gate:
            frame.lm_idx[:] = -1
            return None
        frame.lm_idx[frame.outlier] = -1
        frame.outlier[:] = False
        return T_fin

    def _pose_optimize(self, frame, T_init):
        obs_mask = (frame.lm_idx >= 0) & frame.valid
        X = self.db.lm_pos[np.clip(frame.lm_idx, 0, None)]
        sigma2 = self.sigma2[np.clip(frame.level, 0, self.num_levels - 1)]
        res = self.pose_opt(self._t(np.asarray(T_init, np.float32)), self._t(X),
                            self._t(frame.xy_undist), self._t(sigma2), self._t(obs_mask))
        frame.outlier = obs_mask & ~res.inliers.cpu().numpy()
        return res.T_cw.cpu().numpy(), int(res.num_inliers)
