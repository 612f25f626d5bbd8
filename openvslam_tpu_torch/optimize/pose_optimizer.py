"""Pose-only Levenberg-Marquardt for perspective cameras (counterpart of
``openvslam_tpu/optimize/pose_optimizer.py``): g2o's schedule of 4 rounds
x 10 iterations, Huber at chi2 5.991 (mono) / 7.815 (stereo), inlier
reclassification between rounds.  The whole schedule is one call of
``ops.pose_lm.pose_lm`` (kernel K3 on the GPU)."""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.pose_lm import pose_lm
from . import residuals as R


class PoseOptResult(NamedTuple):
    T_cw: torch.Tensor        # (4,4) optimized pose
    inliers: torch.Tensor     # (N,) bool final inlier classification
    num_inliers: torch.Tensor # () int32
    chi2: torch.Tensor        # (N,) final per-obs chi2


def make_pose_optimizer(cam, stereo: bool = False, num_rounds: int = 4,
                        iters_per_round: int = 10):
    """fn(T_init (4,4), X_w (N,3), obs (N,2|3), sigma2 (N,), mask (N,)) ->
    PoseOptResult.  ``obs`` is uv for mono, (u, v, u_right) for stereo
    (u_right < 0 marks a mono observation inside a stereo frame)."""
    if cam.model_name != "perspective":
        raise NotImplementedError("only the perspective pose LM is ported")
    kw = dict(fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy,
              fxb=cam.focal_x_baseline if stereo else 0.0,
              chi2_thr=R.CHI2_3D if stereo else R.CHI2_2D,
              num_rounds=num_rounds, iters_per_round=iters_per_round)

    def optimize(T_init: torch.Tensor, X_w, obs, sigma2, mask) -> PoseOptResult:
        return PoseOptResult(*pose_lm(T_init, X_w, obs, sigma2, mask, **kw))

    return optimize
