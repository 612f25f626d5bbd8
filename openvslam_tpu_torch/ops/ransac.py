"""Batched RANSAC (counterpart of ``openvslam_tpu/ops/ransac.py``; ref the
sequential ``find_via_ransac()`` loops of ``solve/*``).

A fixed number of minimal samples is drawn, every hypothesis is fitted and
scored in one batched call, and the best-scoring model wins.  The draw and
the evaluation are separate so that a caller can evaluate given draws (the
parity tests feed the JAX package's samples): the draw takes an explicit
``torch.Generator`` on the mask's device.
"""
from __future__ import annotations

from typing import Callable

import torch


def sample_minimal_sets(gen: torch.Generator, mask: torch.Tensor, n_hyp: int,
                        k: int) -> torch.Tensor:
    """Draw (..., n_hyp, k) index sets from the valid entries of ``mask``
    (..., N), one batch of hypotheses per leading index.

    Gumbel top-k: per hypothesis, perturb the log-mask with Gumbel noise and
    take the k largest, a without-replacement sample restricted to valid
    entries."""
    u = torch.rand(mask.shape[:-1] + (n_hyp, mask.shape[-1]), generator=gen,
                   device=mask.device)
    g = -torch.log(-torch.log(torch.clamp(u, min=torch.finfo(u.dtype).tiny)))
    logits = torch.where(mask, 0.0, float("-inf"))
    return torch.topk(logits[..., None, :] + g, k, dim=-1).indices


def _take(models, best):
    """Select hypothesis ``best`` (...,) from models with a (..., n_hyp)
    leading shape; models may be a tensor or a tuple of tensors."""
    if isinstance(models, tuple):
        return tuple(_take(m, best) for m in models)
    idx = best.reshape(best.shape + (1,) * (models.dim() - best.dim()))
    idx = idx.expand(best.shape + (1,) + models.shape[best.dim() + 1:])
    return torch.gather(models, best.dim(), idx).squeeze(best.dim())


def ransac_from_samples(samples: torch.Tensor, fit_fn: Callable, score_fn: Callable):
    """Fit every hypothesis of ``samples`` (..., n_hyp, k) and keep the best.

    fit_fn(samples) -> models with leading (..., n_hyp) axes (a tensor or a
    tuple of tensors); score_fn(models) -> (scores (..., n_hyp), inliers
    (..., n_hyp, N)).  Returns (best_model, best_score, best_inliers); ties
    go to the first."""
    models = fit_fn(samples)
    scores, inliers = score_fn(models)
    best = torch.argmax(scores, dim=-1)
    return (_take(models, best), _take(scores, best), _take(inliers, best))
