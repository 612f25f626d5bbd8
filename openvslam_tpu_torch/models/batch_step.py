"""Batched multi-stream tracking step (counterpart of
``openvslam_tpu/models/batch_step.py``): B frames, one per stream, of one
camera through extraction, guided matching and the pose-only LM.

On the card every kernel runs once for the whole batch: K1 over all
levels of all B frames (``OrbFrontend.extract_batch``), K2 and K3 with a
grid over the B problems (``frame_step.match_and_optimize``).  The
per-problem code of each kernel is the single launch's, so each stream's
result equals ``FrameStep.step`` on that stream bit for bit.  The JAX
package batches only FAST this way and falls back to its XLA matcher and
pose LM (their Pallas kernels carry scalar-prefetch operands that vmap
cannot batch); no such limit stands here.  On the CPU the kernels' plain
versions run each problem in turn.  A batched launch that fails raises:
nothing falls back to the plain versions on the card.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .frame_step import FrameStep


class BatchStepResult(NamedTuple):
    T_cw: torch.Tensor         # (B,4,4)
    num_inliers: torch.Tensor  # (B,)
    kp_xy: torch.Tensor        # (B,K,2)
    kp_valid: torch.Tensor     # (B,K)
    lm_kpt_idx: torch.Tensor   # (B,L)
    kp_desc_u32: torch.Tensor  # (B,K,8)


class BatchFrameStep(FrameStep):
    """Fused extract + match + optimize for a batch of same-camera streams
    (FrameStep's options and constructor)."""

    def step(self, images_u8, T_pred, lm_pos, lm_desc_u32, lm_valid, lm_pred_level
             ) -> BatchStepResult:
        """images (B,H,W) u8; T_pred (B,4,4); per stream a local map of
        lm_capacity rows: lm_pos (B,L,3), lm_desc_u32 (B,L,8) packed,
        lm_valid (B,L), lm_pred_level (B,L) (< 0 = no octave gate)."""
        kp = self.frontend.extract_batch(images_u8)
        T, inl, idx = self._track(kp, T_pred, lm_pos, lm_desc_u32, lm_valid, lm_pred_level)
        return BatchStepResult(T, inl, kp.xy, kp.valid, idx, kp.desc_u32)
