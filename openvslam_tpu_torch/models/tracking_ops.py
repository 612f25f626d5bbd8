"""Device helpers of the tracking and mapping modules (counterpart of
``openvslam_tpu/models/tracking_ops.py``): projection matching for
tracking, triangulation and fusion candidates for mapping."""
from __future__ import annotations

import torch

from ..ops import match as M
from ..ops import se3, triangulate


def project_landmarks(cam, T_cw, lm_pos, lm_valid):
    """Project landmark positions into a camera: (uv (L,2), depth, visible)."""
    uv, depth, valid = cam.project(se3.transform(T_cw, lm_pos))
    return uv, depth, valid & lm_valid


def match_landmarks_by_projection(cam, T_cw, lm_pos, lm_desc_u32, lm_valid,
                                  kpt_desc_u32, kpt_xy_undist, kpt_valid, kpt_level,
                                  radius_scale, scale_factors, lm_pred_level,
                                  max_dist=M.HAMMING_DIST_THR_HIGH, ratio=None):
    """Guided 3D->2D search: project landmarks, gate keypoints by radius
    (scaled by the predicted octave) and octave consistency, match.
    Returns (kpt_idx (L,) [-1 unmatched], dist (L,), visible (L,))."""
    uv, _, vis = project_landmarks(cam, T_cw, lm_pos, lm_valid)
    lvl = torch.clamp(lm_pred_level, 0, scale_factors.shape[0] - 1)
    radius = radius_scale * scale_factors[lvl]
    idx, dist = M.projection_scale_match(
        lm_desc_u32, kpt_desc_u32, uv, vis, radius, lm_pred_level,
        kpt_xy_undist, kpt_level, kpt_valid,
        max_dist=max_dist, ratio=ratio, cross_check=True, image_size=(cam.cols, cam.rows))
    return idx, dist, vis


def predict_scale_levels(lm_pos, T_cw, lm_max_dist, num_levels: int, log_scale: float):
    """Predicted pyramid level from distance (ref landmark::predict_scale_level)."""
    cam_center = -(T_cw[:3, :3].T @ T_cw[:3, 3])
    dist = torch.linalg.norm(lm_pos - cam_center, dim=-1)
    ratio = torch.clamp(lm_max_dist, min=1e-9) / torch.clamp(dist, min=1e-9)
    lvl = torch.ceil(torch.log(torch.clamp(ratio, min=1e-9)) / log_scale)
    return torch.clamp(lvl, 0, num_levels - 1).to(torch.int64)


# ---------------------------------------------------------------------------
# mapping helpers: triangulation and fusion candidates against B neighbour
# keyframes at once (the JAX package's vmap over neighbours becomes one
# batched computation with a leading (B,) axis)
# ---------------------------------------------------------------------------

def essential_from_poses(T1_cw, T2_cw):
    """E_12 with b1^T E b2 = 0 for bearings of cameras 1,2 (rel pose 1<-2);
    T2_cw may carry a leading batch axis."""
    T12 = T1_cw @ se3.inverse(T2_cw)
    return se3.hat(T12[..., :3, 3]) @ T12[..., :3, :3]


def match_unmatched_robust(descA, validA, bearA, descB, validB, bearB, E_ab, epi_thr,
                           max_dist=M.HAMMING_DIST_THR_LOW, ratio=0.9):
    """Epipolar-gated brute-force match between unmatched keypoints of two
    keyframes (ref match::robust for triangulation pairs); descriptors are
    (...,K,256) bits."""
    gate = M.epipolar_gate(bearA, bearB, E_ab, thr=epi_thr)
    return M.match_descriptors(descA, descB, validA, validB, gate=gate,
                               max_dist=max_dist, ratio=ratio, cross_check=True)


def triangulate_pair_checked(cam, T1_cw, T2_cw, b1, b2, uv1, uv2, sigma2_1, sigma2_2, mask,
                             min_parallax_cos=0.99998, chi2=5.991):
    """Two-view triangulation with the reference's acceptance gates (ref
    module/two_view_triangulator): parallax, reprojection chi2 in both
    views, positive depth.  Returns (X_w (...,N,3), ok (...,N))."""
    X, ok0 = triangulate.triangulate_two_view(b1, b2, T1_cw, T2_cw)
    z1, z2, cospar = triangulate.depths_and_parallax(X, b1, b2, T1_cw, T2_cw)
    uv1p, _, _ = cam.project(se3.transform(T1_cw, X))
    uv2p, _, _ = cam.project(se3.transform(T2_cw, X))
    e1 = torch.sum((uv1 - uv1p) ** 2, -1) / torch.clamp(sigma2_1, min=1e-12)
    e2 = torch.sum((uv2 - uv2p) ** 2, -1) / torch.clamp(sigma2_2, min=1e-12)
    ok = (ok0 & mask & (z1 > 1e-6) & (z2 > 1e-6) & (cospar < min_parallax_cos)
          & (cospar > 0.0) & (e1 < chi2) & (e2 < chi2))
    return X, ok


def triangulation_candidates_multi(cam, T1, desc1, un1, brg1, ang1, und1, sig1,
                                   T2s, desc2s, un2s, brg2s, ang2s, und2s, sig2s, epi_thr):
    """Robust match + orientation check + checked triangulation of one
    keyframe's unmatched keypoints against B neighbour keyframes.

    Query operands are (K,...); neighbour operands carry a leading (B,...)
    axis.  Returns (idx (B,K) matched neighbour keypoint per query keypoint,
    X (B,K,3) triangulated world points, ok (B,K) acceptance)."""
    B = T2s.shape[0]
    E12 = essential_from_poses(T1, T2s)
    idx, _ = match_unmatched_robust(desc1, un1, brg1, desc2s, un2s, brg2s, E12, epi_thr)
    idx = M.angle_consistency_filter(ang1, ang2s, idx)
    kpt = torch.clamp(idx, min=0).to(torch.int64)
    rows = torch.arange(B, device=kpt.device)[:, None]
    X, ok = triangulate_pair_checked(
        cam, T1, T2s, brg1.expand(B, *brg1.shape), brg2s[rows, kpt], und1, und2s[rows, kpt],
        sig1, sig2s[rows, kpt], idx >= 0)
    return idx, X, ok


def fuse_candidates_multi(cam, T_cw_nb, lm_pos, lm_desc_i8, lm_valid,
                          kpt_desc_i8, kpt_xy_undist, kpt_valid, kpt_level,
                          radius_scale, scale_factors, lm_pred_level,
                          max_dist=M.HAMMING_DIST_THR_LOW):
    """Project one landmark table into B neighbour keyframes and find merge
    targets (ref match::fuse): the projection + octave gate without the
    ratio test or cross-check.  T_cw_nb (B,4,4); kpt_* carry a leading (B,)
    axis.  Returns (idx (B,L), dist (B,L)).

    This is the plain composition, as in the JAX package (which does not
    route fusion through its Pallas matcher)."""
    pc = lm_pos @ T_cw_nb[:, :3, :3].transpose(-1, -2) + T_cw_nb[:, None, :3, 3]
    uv, _, vis = cam.project(pc)
    vis = vis & lm_valid
    lvl = torch.clamp(lm_pred_level, 0, scale_factors.shape[0] - 1)
    radius = radius_scale * scale_factors[lvl]
    gate = M.projection_gate(uv, vis, kpt_xy_undist, radius)
    sgate = torch.abs(kpt_level[..., None, :] - lm_pred_level[:, None]) <= 1
    gate = gate & (sgate | (lm_pred_level < 0)[:, None])
    return M.match_descriptors(lm_desc_i8, kpt_desc_i8, vis, kpt_valid, gate=gate,
                               max_dist=max_dist, ratio=None, cross_check=False)
