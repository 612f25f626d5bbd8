"""Device helpers of the tracking step (counterpart of the projection part of
``openvslam_tpu/models/tracking_ops.py``)."""
from __future__ import annotations

import torch

from ..ops import match as M
from ..ops import se3


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
