"""Fused per-frame tracking step of the live pipeline (counterpart of
``openvslam_tpu/models/track_step.py``):

  extract (pyramid + FAST kernel K1 + rBRIEF)
  -> stereo: per-keypoint right u and depth by the dense SAD match against
     the right image; rgbd: depth sampled from the metric depth map at each
     keypoint and a virtual right u (mono: -1)
  -> motion-model projection match against the last frame's landmarks
     (radius 7, widened to 14 when fewer than 20 match; kernel K2 twice)
  -> pose-only LM (kernel K3; (u, v, u_right) observations in the stereo
     and rgbd modes, u_right < 0 marking a keypoint without depth)
  -> local-map projection match around that pose (scale-predicted radius,
     stage-1 keypoints masked; kernel K2)
  -> pose-only LM over the combined associations (kernel K3)
  -> per-keypoint source slot + inlier mask

The local-map and last-frame tables may hold the same physical landmark;
``prev_slot`` maps local slots to last-frame slots so that stage 2 skips
landmarks already matched in stage 1.  JAX's ``.at[].set(mode="drop")``
scatters become scatters into one extra dump slot that is sliced off (the
cross-check makes the kept indices unique).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device
from ..optimize.pose_optimizer import make_pose_optimizer
from . import tracking_ops as TO
from ..ops.stereo import depth_at_keypoints, stereo_match_dense
from .frontend import OrbFrontend


def unpack_bits_host(desc_u32: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """(K,8) packed words -> (K,256) int8 on the host, invalid rows zeroed."""
    words = np.asarray(desc_u32).view(np.uint32)
    bits = (words[:, :, None] >> np.arange(32, dtype=np.uint32)) & 1
    out = bits.reshape(words.shape[0], -1).astype(np.int8)
    out[~np.asarray(valid)] = 0
    return out


class LastFrame(NamedTuple):
    """Last frame's landmark table, one row per keypoint slot (P rows)."""
    pos: torch.Tensor        # (P,3) f32
    desc_u32: torch.Tensor   # (P,8) packed int32
    valid: torch.Tensor      # (P,) bool
    level: torch.Tensor      # (P,) int, octave of the observation (< 0 = no gate)


class LocalMap(NamedTuple):
    """Local-map landmark table (L rows)."""
    pos: torch.Tensor        # (L,3) f32
    desc_u32: torch.Tensor   # (L,8) packed int32
    valid: torch.Tensor      # (L,) bool
    max_dist: torch.Tensor   # (L,) f32, scale-invariance distance
    prev_slot: torch.Tensor  # (L,) int, alias slot in LastFrame (-1 none)


class TrackStepResult(NamedTuple):
    kp_xy: torch.Tensor         # (K,2)
    kp_und: torch.Tensor        # (K,2)
    kp_bearing: torch.Tensor    # (K,3)
    kp_level: torch.Tensor      # (K,)
    kp_angle: torch.Tensor      # (K,)
    kp_response: torch.Tensor   # (K,)
    kp_desc_u32: torch.Tensor   # (K,8)
    kp_valid: torch.Tensor      # (K,)
    kp_x_right: torch.Tensor    # (K,) -1 where no depth (always in mono)
    kp_depth: torch.Tensor      # (K,) -1 where no depth (always in mono)
    kp_src: torch.Tensor        # (K,) -1 none, [0,P) last-frame slot, [P,P+L) local slot
    kp_inlier: torch.Tensor     # (K,) bool final LM inliers
    n_stage1: torch.Tensor      # () inliers after the motion-match LM
    T_cw: torch.Tensor          # (4,4) final pose
    num_inliers: torch.Tensor   # ()
    loc_visible: torch.Tensor   # (L,) local landmarks projected in frame


def _scatter_slots(idx: torch.Tensor, K: int, base: int) -> torch.Tensor:
    """Per-keypoint slot from a per-landmark keypoint index: out[idx[i]] =
    base + i where idx[i] >= 0, -1 elsewhere."""
    tgt = torch.where(idx >= 0, idx.to(torch.int64), K)
    out = torch.full((K + 1,), -1, dtype=torch.int64, device=idx.device)
    out.scatter_(0, tgt, torch.arange(idx.shape[0], device=idx.device) + base)
    return out[:K]


class TrackStep:
    """Tracking step for one camera, front end and local-map capacity.
    ``mode`` "mono", "stereo" (``step``'s ``aux`` operand: the rectified
    right image, u8) or "rgbd" (``aux``: the metric depth map, f32)."""

    def __init__(self, cam, frontend: OrbFrontend, lm_capacity: int = 4096,
                 mode: str = "mono", device="cuda"):
        if mode not in ("mono", "stereo", "rgbd"):
            raise ValueError(f"unknown TrackStep mode: {mode!r}")
        self.mode = mode
        self.device = resolve_device(device)
        if frontend.device != self.device:
            raise ValueError(f"frontend lives on {frontend.device}, step on {self.device}")
        self.cam = cam
        self.frontend = frontend
        self.lm_capacity = lm_capacity
        self.prev_capacity = frontend.capacity
        self.num_levels = frontend.num_levels
        sf = frontend.scale_factor
        self.scale_factors = torch.tensor([sf**l for l in range(self.num_levels)],
                                          dtype=torch.float32, device=self.device)
        self.sigma2 = self.scale_factors**2
        self.log_scale = float(np.log(sf))
        self._pose_core = make_pose_optimizer(cam, stereo=mode != "mono")

    def step(self, image_u8, mask, T_pred, last: LastFrame, local: LocalMap, aux=None
             ) -> TrackStepResult:
        cam = self.cam
        dev = self.device
        P = self.prev_capacity
        T_pred = torch.as_tensor(T_pred, dtype=torch.float32, device=dev)
        image_u8 = torch.as_tensor(image_u8, device=dev)
        if self.mode != "mono":
            aux = torch.as_tensor(aux, device=dev)
        prev_desc = torch.where(last.valid[:, None], last.desc_u32, 0)
        kp = self.frontend.extract(image_u8, mask)
        und = cam.undistort_keypoints(kp.xy)
        brg = cam.keypoints_to_bearings(kp.xy)
        K = kp.capacity
        sig2 = self.sigma2[torch.clamp(kp.level, 0, self.num_levels - 1)]
        if self.mode == "stereo":
            x_right, depth = stereo_match_dense(image_u8, aux, kp.xy, kp.valid,
                                                cam.focal_x_baseline)
        elif self.mode == "rgbd":
            x_right, depth = depth_at_keypoints(aux, kp.xy, und, kp.valid, cam.focal_x_baseline)
        else:
            x_right = torch.full((K,), -1.0, dtype=torch.float32, device=dev)
            depth = torch.full((K,), -1.0, dtype=torch.float32, device=dev)
        # stereo modes: (u, v, u_right) observations (u_right < 0: mono)
        obs = und if self.mode == "mono" else torch.cat([und, x_right[:, None]], 1)

        # ---- stage 1: motion-model match (radius 7 -> widen to 14) -------
        def motion_match(radius):
            idx, _, _ = TO.match_landmarks_by_projection(
                cam, T_pred, last.pos, prev_desc, last.valid,
                kp.desc_u32, und, kp.valid, kp.level,
                radius, self.scale_factors, last.level)
            return idx

        idx_a = motion_match(7.0)
        n_a = (idx_a >= 0).sum()
        idx_b = motion_match(14.0)
        idx1 = torch.where(n_a >= 20, idx_a, idx_b)
        kp_lm1 = _scatter_slots(idx1, K, 0)

        has1 = kp_lm1 >= 0
        res1 = self._pose_core(T_pred, last.pos[torch.clamp(kp_lm1, min=0)], obs, sig2, has1)
        # drop outlier associations before the local-map search
        kp_lm1 = torch.where(res1.inliers, kp_lm1, -1)
        prev_matched = torch.zeros(P + 1, dtype=torch.bool, device=dev)
        prev_matched[torch.where(kp_lm1 >= 0, kp_lm1, P)] = True
        prev_matched = prev_matched[:P]

        # ---- stage 2: local-map match around the stage-1 pose ------------
        pred_lvl = TO.predict_scale_levels(local.pos, res1.T_cw, local.max_dist,
                                           self.num_levels, self.log_scale)
        alias_hit = (local.prev_slot >= 0) & prev_matched[torch.clamp(local.prev_slot, min=0)]
        loc_ok = local.valid & ~alias_hit
        kpt_free = kp.valid & (kp_lm1 < 0)
        n_seeds = (kp_lm1 >= 0).sum()
        radius = torch.where(n_seeds >= 50, 4.0, 9.0).to(torch.float32)
        idx2, _, vis2 = TO.match_landmarks_by_projection(
            cam, res1.T_cw, local.pos, local.desc_u32, loc_ok,
            kp.desc_u32, und, kpt_free, kp.level,
            radius, self.scale_factors, pred_lvl)
        L = local.pos.shape[0]
        kp_lm2 = _scatter_slots(idx2, K, P)
        # stage-1 association wins where both exist
        kp_src = torch.where(kp_lm1 >= 0, kp_lm1, kp_lm2)

        # ---- final pose LM over the combined association set -------------
        is_prev = (kp_src >= 0) & (kp_src < P)
        Xc = torch.where(is_prev[:, None], last.pos[torch.clamp(kp_src, 0, P - 1)],
                         local.pos[torch.clamp(kp_src - P, 0, L - 1)])
        res2 = self._pose_core(res1.T_cw, Xc, obs, sig2, kp_src >= 0)

        return TrackStepResult(
            kp_xy=kp.xy, kp_und=und, kp_bearing=brg, kp_level=kp.level,
            kp_angle=kp.angle, kp_response=kp.response,
            kp_desc_u32=kp.desc_u32, kp_valid=kp.valid,
            kp_x_right=x_right, kp_depth=depth,
            kp_src=kp_src, kp_inlier=res2.inliers,
            n_stage1=res1.num_inliers,
            T_cw=res2.T_cw, num_inliers=res2.num_inliers,
            loc_visible=vis2)
