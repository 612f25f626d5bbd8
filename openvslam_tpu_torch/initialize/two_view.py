"""Two-view monocular bootstrap (counterpart of ``openvslam_tpu/initialize/two_view.py``;
ref ``initialize/{base,perspective,bearing_vector}``).

One attempt:
  1. area-gated descriptor match between the init frame and current frame,
     orientation check, stable compaction of the matched pairs;
  2. perspective camera: H-RANSAC and F-RANSAC on the same pairs (batched
     hypotheses), model selection by score ratio R_H = S_H/(S_H+S_F) > 0.45
     -> H else F; fisheye and equirectangular cameras (``K`` None): one
     8-point E-RANSAC on the bearing vectors;
  3. decompose (8 Faugeras hypotheses for H / 4 for E), triangulate each,
     pick the hypothesis with the most cheirality+parallax support;
  4. relative pose + triangulated points + inlier mask.

Steps 1-3 run on the operands' device without reading anything back; the
acceptance thresholds are host logic (``initialize_two_view``).  The draw
of the RANSAC samples is separate (``draw_samples``): ``init_attempt``
draws with a ``torch.Generator``, ``init_attempt_with_samples`` takes the
samples, so an attempt can be replayed on another device or fed the JAX
package's draws.  The JAX package also keeps an unfused multi-call
version of the attempt as a test oracle; the port has only the fused one.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops import match as M
from ..ops import ransac, solvers, triangulate

N_HYP = 256


class InitResult(NamedTuple):
    success: bool
    T_21: np.ndarray          # (4,4) pose of frame2 wrt frame1 (t normalized)
    points: np.ndarray        # (N,3) triangulated points in frame1 coords
    is_inlier: np.ndarray     # (N,) over the matched pairs
    idx1: np.ndarray          # (N,) keypoint indices in frame 1
    idx2: np.ndarray          # (N,) keypoint indices in frame 2
    used_homography: bool
    # descriptor matches between the views (the tracker keeps its reference
    # frame while overlap remains, ref mono initializer)
    num_matches: int = 0


class InitPairs(NamedTuple):
    """Matched pairs compacted to the front, ascending frame-1 index."""
    num_matches: torch.Tensor   # ()
    m1: torch.Tensor            # (K,) frame-1 keypoint of each row
    m2: torch.Tensor            # (K,) frame-2 keypoint (0 past num_matches)
    pmask: torch.Tensor         # (K,) row holds a match
    p1: torch.Tensor            # (K,2) undistorted pixels, 0 past num_matches
    p2: torch.Tensor
    b1: torch.Tensor            # (K,3) bearings, +z past num_matches
    b2: torch.Tensor


class InitAttempt(NamedTuple):
    num_matches: torch.Tensor
    use_h: torch.Tensor         # () bool
    counts: torch.Tensor        # (8,) support per hypothesis, -1 unused
    T21: torch.Tensor           # (4,4) best hypothesis
    X: torch.Tensor             # (K,3) its points
    good: torch.Tensor          # (K,) its support mask
    m1: torch.Tensor
    m2: torch.Tensor
    pmask: torch.Tensor
    n_inl: torch.Tensor         # () pairs the RANSAC model kept


def init_pairs(d1, v1, xy1, ang1, und1, brg1, d2, v2, xy2, ang2, und2, brg2) -> InitPairs:
    """Match (window 100 px, Hamming <= 30, ratio 0.9, cross-check), filter
    by orientation and compact.  d* are (K,256) descriptor bits."""
    gate = M.window_gate(xy1, xy2, 100.0)
    idx, _ = M.match_descriptors(d1, d2, v1, v2, gate=gate,
                                 max_dist=M.HAMMING_DIST_THR_LOW, ratio=0.9, cross_check=True)
    idx = M.angle_consistency_filter(ang1, ang2, idx)
    matched = idx >= 0
    order = torch.sort((~matched).to(torch.int32), stable=True).indices
    pmask = matched[order]
    m2 = torch.where(pmask, idx[order].to(torch.int64), 0)
    unit_z = torch.tensor([0.0, 0.0, 1.0], dtype=brg1.dtype, device=brg1.device)
    pm = pmask[:, None]
    return InitPairs(matched.sum(), order, m2, pmask,
                     torch.where(pm, und1[order], 0.0), torch.where(pm, und2[m2], 0.0),
                     torch.where(pm, brg1[order], unit_z), torch.where(pm, brg2[m2], unit_z))


def draw_samples(gen: torch.Generator, pmask: torch.Tensor, n_hyp: int = N_HYP,
                 perspective: bool = True):
    """(samples_h, samples_f): the homography's 4-point and the fundamental's
    8-point sample sets; for the bearing path (``perspective`` False) no
    homography set and the essential matrix's 8-point set."""
    if not perspective:
        return None, ransac.sample_minimal_sets(gen, pmask, n_hyp, 8)
    return (ransac.sample_minimal_sets(gen, pmask, n_hyp, 4),
            ransac.sample_minimal_sets(gen, pmask, n_hyp, 8))


def evaluate_motion_hypotheses(Rs, ts, b1, b2, mask, min_parallax_cos=0.99995):
    """For each candidate (R,t): triangulate all pairs, count support.
    Rs (Q,3,3), ts (Q,3); returns (counts (Q,), points (Q,N,3), good (Q,N)).
    Support = positive depth in both views + parallax above threshold."""
    Q, N = Rs.shape[0], b1.shape[0]
    T1 = torch.eye(4, dtype=b1.dtype, device=b1.device).expand(Q, 4, 4)
    T2 = T1.clone()
    T2[:, :3, :3] = Rs
    T2[:, :3, 3] = ts
    b1q, b2q = b1.expand(Q, N, 3), b2.expand(Q, N, 3)
    X, ok = triangulate.triangulate_two_view(b1q, b2q, T1, T2)
    z1, z2, cospar = triangulate.depths_and_parallax(X, b1q, b2q, T1, T2)
    good = (ok & mask & (z1 > 0) & (z2 > 0) & (cospar < min_parallax_cos) & (cospar > -1.0)
            & (z1 < 1e5) & (z2 < 1e5))
    return good.sum(-1, dtype=torch.int32), X, good


def _pad_essential(Rs_e, ts_e):
    """The 4 essential hypotheses padded to 8 with (I, 0)."""
    eye = torch.eye(3, dtype=Rs_e.dtype, device=Rs_e.device).expand(4, 3, 3)
    return torch.cat([Rs_e, eye]), torch.cat([ts_e, torch.zeros_like(ts_e)])


def solve_pairs(pairs: InitPairs, samples_h, samples_f, K) -> InitAttempt:
    """Steps 2-3 of an attempt on compacted pairs with given samples.  With
    ``K`` None (a fisheye or equirectangular camera) ``samples_f`` are the
    essential matrix's 8-point sets on the bearings and ``samples_h`` is
    not used."""
    p1, p2, b1, b2, pmask = pairs.p1, pairs.p2, pairs.b1, pairs.b2, pairs.pmask
    dev = b1.device
    if K is None:
        E, _, inl_e = ransac.ransac_from_samples(
            samples_f, lambda i: solvers.fit_essential(b1[i], b2[i]),
            lambda Ee: solvers.score_essential(Ee, b1, b2, pmask))
        Rs, ts = _pad_essential(*solvers.decompose_essential(E))
        return _best_motion(pairs, torch.zeros((), dtype=torch.bool, device=dev), Rs, ts,
                            torch.arange(8, device=dev) < 4, pmask & inl_e)
    H, s_h, inl_h = ransac.ransac_from_samples(
        samples_h, lambda i: solvers.fit_homography(p1[i], p2[i]),
        lambda Hh: solvers.score_homography(Hh, p1, p2, pmask, sigma=1.0))
    F, s_f, inl_f = ransac.ransac_from_samples(
        samples_f, lambda i: solvers.fit_fundamental(p1[i], p2[i]),
        lambda Ff: solvers.score_fundamental(Ff, p1, p2, pmask, sigma=1.0))
    use_h = s_h / torch.clamp(s_h + s_f, min=1e-9) > 0.45
    Rs_h, ts_h, _ = solvers.decompose_homography(H, K)
    Rs_e, ts_e = _pad_essential(*solvers.decompose_essential(solvers.essential_from_F(F, K, K)))
    return _best_motion(pairs, use_h, torch.where(use_h, Rs_h, Rs_e),
                        torch.where(use_h, ts_h, ts_e), use_h | (torch.arange(8, device=dev) < 4),
                        pmask & torch.where(use_h, inl_h, inl_f))


def _best_motion(pairs: InitPairs, use_h, Rs, ts, hyp_ok, eval_mask) -> InitAttempt:
    """Step 3: triangulate the 8 hypotheses (those not ``hyp_ok`` count -1)
    and keep the best supported."""
    counts, Xs, goods = evaluate_motion_hypotheses(Rs, ts, pairs.b1, pairs.b2, eval_mask)
    counts = torch.where(hyp_ok, counts, -1)
    best = torch.argmax(counts)
    T21 = torch.eye(4, dtype=Rs.dtype, device=Rs.device)
    T21[:3, :3] = Rs[best]
    T21[:3, 3] = ts[best]
    return InitAttempt(pairs.num_matches, use_h, counts, T21, Xs[best], goods[best],
                       pairs.m1, pairs.m2, pairs.pmask, eval_mask.sum())


def init_attempt(gen: torch.Generator, d1, v1, xy1, ang1, und1, brg1,
                 d2, v2, xy2, ang2, und2, brg2, K, n_hyp: int = N_HYP) -> InitAttempt:
    """One whole bootstrap attempt on the operands' device, drawing its
    RANSAC samples from ``gen`` (a generator on that device); ``K`` None
    takes the bearing path."""
    pairs = init_pairs(d1, v1, xy1, ang1, und1, brg1, d2, v2, xy2, ang2, und2, brg2)
    samples_h, samples_f = draw_samples(gen, pairs.pmask, n_hyp, perspective=K is not None)
    return solve_pairs(pairs, samples_h, samples_f, K)


def init_attempt_with_samples(samples_h, samples_f, d1, v1, xy1, ang1, und1, brg1,
                              d2, v2, xy2, ang2, und2, brg2, K) -> InitAttempt:
    """``init_attempt`` with the (n_hyp,4) and (n_hyp,8) sample sets given
    (``K`` None: ``samples_h`` None and the essential matrix's sets)."""
    pairs = init_pairs(d1, v1, xy1, ang1, und1, brg1, d2, v2, xy2, ang2, und2, brg2)
    return solve_pairs(pairs, samples_h, samples_f, K)


def frame_operands(frame, device):
    """The six per-frame operands of an attempt, as tensors on ``device``."""
    t = lambda a: torch.as_tensor(np.asarray(a), device=device)  # noqa: E731
    return (t(frame.desc_i8), t(frame.valid), t(frame.xy), t(frame.angle),
            t(frame.xy_undist), t(frame.bearing))


def intrinsics(cam, device) -> torch.Tensor:
    """K of a perspective camera."""
    return torch.tensor([[cam.fx, 0.0, cam.cx], [0.0, cam.fy, cam.cy], [0.0, 0.0, 1.0]],
                        dtype=torch.float32, device=device)


def initialize_two_view(gen: torch.Generator, frame1, frame2, cam, min_matches=50,
                        min_triangulated=40) -> InitResult:
    """One attempt on the generator's device, then the acceptance thresholds
    on the host.  frame*: data.Frame.  A fisheye or equirectangular camera
    takes the bearing path."""
    dev = gen.device
    K = intrinsics(cam, dev) if cam.model_name == "perspective" else None
    out = init_attempt(gen, *frame_operands(frame1, dev), *frame_operands(frame2, dev), K)
    (num_matches, use_h, counts, T21, X, good, m1, m2, _, n_inl) = (
        t.cpu().numpy() for t in out)
    n = int(num_matches)
    use_h = bool(use_h)
    fail = InitResult(False, np.eye(4), np.zeros((0, 3)), np.zeros(0, bool),
                      np.zeros(0, np.int64), np.zeros(0, np.int64), use_h, n)
    if n < min_matches:
        return fail
    order = np.argsort(counts)[::-1]
    n_best = int(counts[order[0]])
    n_second = int(counts[order[1]])
    if n_best < min_triangulated or n_best < 0.5 * int(n_inl) or n_second > 0.93 * n_best:
        return fail
    return InitResult(True, T21.astype(np.float32), X[:n], good[:n],
                      m1[:n].astype(np.int64), m2[:n].astype(np.int64), use_h, n)
