"""The fused per-frame step: image + local map in, tracked pose out
(counterpart of ``openvslam_tpu/models/frame_step.py``).

extract (pyramid, FAST kernel K1, selection, blur, IC angle, rBRIEF)
-> projection-gated matching against the local map (kernel K2)
-> the 4 x 10 pose-only LM (kernel K3).

Every array keeps its fixed capacity with a validity mask and nothing on
the step reads a value back to the host.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..device import resolve_device
from ..ops import match as M
from ..ops import se3
from ..optimize.pose_optimizer import make_pose_optimizer
from .frontend import OrbFrontend


def match_and_optimize(cam, num_levels, scale_factors, sigma2, pose_core,
                       kp_xy, kp_desc_u32, kp_level, kp_valid,
                       T_pred, lm_pos, lm_desc_u32, lm_valid, lm_pred_level):
    """Projection-gated matching of the local map + the pose-only LM.
    Returns (T_cw, num_inliers, lm_kpt_idx)."""
    und = cam.undistort_keypoints(kp_xy)
    uv, _, vis = cam.project(se3.transform(T_pred, lm_pos))
    vis = vis & lm_valid
    lvl = torch.clamp(lm_pred_level, 0, num_levels - 1)
    radius = 7.0 * scale_factors[lvl]
    idx, _ = M.projection_scale_match(
        lm_desc_u32, kp_desc_u32, uv, vis, radius, lm_pred_level,
        und, kp_level, kp_valid,
        max_dist=M.HAMMING_DIST_THR_HIGH, ratio=0.9, cross_check=True,
        image_size=(cam.cols, cam.rows))
    kpt = torch.clamp(idx, min=0).to(torch.int64)
    obs_sig = sigma2[torch.clamp(kp_level[kpt], 0, num_levels - 1)]
    res = pose_core(T_pred, lm_pos, und[kpt], obs_sig, idx >= 0)
    return res.T_cw, res.num_inliers, idx


class FrameStepResult(NamedTuple):
    T_cw: torch.Tensor         # (4,4) optimized pose
    num_inliers: torch.Tensor  # ()
    kp_xy: torch.Tensor        # (K,2)
    kp_valid: torch.Tensor     # (K,)
    lm_kpt_idx: torch.Tensor   # (L,) matched keypoint per landmark (-1 none)
    kp_desc_u32: torch.Tensor  # (K,8)


class FrameStep:
    """Fused extract + match + optimize step for a fixed camera geometry."""

    def __init__(self, cam, max_keypts=2048, num_levels=8, scale_factor=1.2,
                 ini_fast_thr=20.0, min_fast_thr=7.0, lm_capacity=4096,
                 opt_rounds=4, iters_per_round=10, device="cuda"):
        self.device = resolve_device(device)
        self.cam = cam
        self.frontend = OrbFrontend(
            rows=cam.rows, cols=cam.cols, max_keypts=max_keypts,
            num_levels=num_levels, scale_factor=scale_factor,
            ini_fast_thr=ini_fast_thr, min_fast_thr=min_fast_thr, device=self.device)
        self.lm_capacity = lm_capacity
        self.num_levels = num_levels
        self.scale_factors = torch.tensor([scale_factor**l for l in range(num_levels)],
                                          dtype=torch.float32, device=self.device)
        self.sigma2 = self.scale_factors**2
        self._pose_core = make_pose_optimizer(cam, stereo=False, num_rounds=opt_rounds,
                                              iters_per_round=iters_per_round)

    def step(self, image_u8, T_pred, lm_pos, lm_desc_u32, lm_valid, lm_pred_level
             ) -> FrameStepResult:
        """image (H,W) u8; T_pred (4,4); local map of lm_capacity rows:
        lm_pos (L,3), lm_desc_u32 (L,8) packed, lm_valid (L,), lm_pred_level
        (L,) (< 0 = no octave gate)."""
        d = self.device
        kp = self.frontend.extract(image_u8)
        T, inl, idx = match_and_optimize(
            self.cam, self.num_levels, self.scale_factors, self.sigma2, self._pose_core,
            kp.xy, kp.desc_u32, kp.level, kp.valid,
            torch.as_tensor(T_pred, dtype=torch.float32, device=d),
            torch.as_tensor(lm_pos, dtype=torch.float32, device=d),
            torch.as_tensor(lm_desc_u32, device=d),
            torch.as_tensor(lm_valid, device=d),
            torch.as_tensor(lm_pred_level, device=d).to(torch.int64))
        return FrameStepResult(T, inl, kp.xy, kp.valid, idx, kp.desc_u32)
