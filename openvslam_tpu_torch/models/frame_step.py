"""The fused per-frame step: image + local map in, tracked pose out
(counterpart of ``openvslam_tpu/models/frame_step.py``).

extract (pyramid, FAST kernel K1, selection, blur, IC angle, rBRIEF)
-> projection-gated matching against the local map (kernel K2)
-> the 4 x 10 pose-only LM (kernel K3).

Every array keeps its fixed capacity with a validity mask and nothing on
the step reads a value back to the host.

``match_and_optimize``, the post-extraction half, takes B streams of one
camera (``models/batch_step.py``; FrameStep is B = 1): one K2 launch and
one K3 launch for all B problems, each stream's result bit for bit its
own call's.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..device import canonical_device, resolve_device
from ..ops import match as M
from ..ops import se3
from ..optimize.pose_optimizer import make_pose_optimizer
from .frontend import OrbFrontend


def match_and_optimize(cam, num_levels, scale_factors, sigma2, pose_core,
                       kp_xy, kp_desc_u32, kp_level, kp_valid,
                       T_pred, lm_pos, lm_desc_u32, lm_valid, lm_pred_level):
    """Projection-gated matching of the local map + the pose-only LM over B
    streams (every operand with a leading B; FrameStep passes B = 1): one
    K2 launch and one K3 launch for all B problems.  The landmarks are
    moved into each stream's camera frame one stream at a time, so a
    stream's operands, and with them its results, do not depend on B;
    every other step is elementwise or a gather.  Returns (T_cw (B,4,4),
    num_inliers (B,), lm_kpt_idx (B,L))."""
    und = cam.undistort_keypoints(kp_xy)
    pc = torch.stack([se3.transform(T_pred[b], lm_pos[b]) for b in range(lm_pos.shape[0])])
    uv, _, vis = cam.project(pc)
    vis = vis & lm_valid
    lvl = torch.clamp(lm_pred_level, 0, num_levels - 1)
    radius = 7.0 * scale_factors[lvl]
    idx, _ = M.projection_scale_match(
        lm_desc_u32, kp_desc_u32, uv, vis, radius, lm_pred_level,
        und, kp_level, kp_valid,
        max_dist=M.HAMMING_DIST_THR_HIGH, ratio=0.9, cross_check=True,
        image_size=(cam.cols, cam.rows))
    kpt = torch.clamp(idx, min=0).to(torch.int64)
    obs_uv = torch.gather(und, 1, kpt[..., None].expand(-1, -1, 2))
    obs_sig = sigma2[torch.clamp(torch.gather(kp_level, 1, kpt), 0, num_levels - 1)]
    res = pose_core(T_pred.contiguous(), lm_pos.contiguous(), obs_uv, obs_sig, idx >= 0)
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
        self.options = dict(max_keypts=max_keypts, num_levels=num_levels,
                            scale_factor=scale_factor, ini_fast_thr=ini_fast_thr,
                            min_fast_thr=min_fast_thr, lm_capacity=lm_capacity,
                            opt_rounds=opt_rounds, iters_per_round=iters_per_round)
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

    def on_device(self, device) -> "FrameStep":
        """This step (itself when ``device`` is its own), built on ``device``."""
        device = resolve_device(device)
        if canonical_device(device) == canonical_device(self.device):
            return self
        return type(self)(self.cam, device=device, **self.options)

    def _track(self, kp, T_pred, lm_pos, lm_desc_u32, lm_valid, lm_pred_level):
        """``match_and_optimize`` on keypoints and local maps of B streams,
        every operand with a leading B.  Returns (T_cw, num_inliers,
        lm_kpt_idx)."""
        d = self.device
        return match_and_optimize(
            self.cam, self.num_levels, self.scale_factors, self.sigma2, self._pose_core,
            kp.xy, kp.desc_u32, kp.level, kp.valid,
            torch.as_tensor(T_pred, dtype=torch.float32, device=d),
            torch.as_tensor(lm_pos, dtype=torch.float32, device=d),
            torch.as_tensor(lm_desc_u32, device=d),
            torch.as_tensor(lm_valid, device=d),
            torch.as_tensor(lm_pred_level, device=d).to(torch.int64))

    def step(self, image_u8, T_pred, lm_pos, lm_desc_u32, lm_valid, lm_pred_level
             ) -> FrameStepResult:
        """image (H,W) u8; T_pred (4,4); local map of lm_capacity rows:
        lm_pos (L,3), lm_desc_u32 (L,8) packed, lm_valid (L,), lm_pred_level
        (L,) (< 0 = no octave gate)."""
        kp = self.frontend.extract(image_u8)
        T, inl, idx = self._track(
            type(kp)(*(a[None] for a in kp)),
            *(torch.as_tensor(a)[None] for a in (T_pred, lm_pos, lm_desc_u32, lm_valid,
                                                 lm_pred_level)))
        return FrameStepResult(T[0], inl[0], kp.xy, kp.valid, idx[0], kp.desc_u32)
