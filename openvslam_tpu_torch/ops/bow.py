"""Bag-of-words operations (counterpart of ``openvslam_tpu/ops/bow.py``; ref
the DBoW2-fork vocabulary of ``data/bow_vocabulary``).

The default vocabulary is FLAT: W binary word centres, and word assignment
is one Hamming matrix and an argmin (exact nearest-word quantization); ties
go to the lowest word index, as in the JAX package.  The tree vocabulary
descends greedily, one gather and one argmin per level.  The reference's
"direct index at tree level l" used by ``match::bow_tree`` becomes a
word-equality gate on the Hamming matrix (``word_gate``).

Every function takes tensors on any device and runs plain PyTorch.
"""
from __future__ import annotations

import numpy as np
import torch

from .match import hamming_matrix

_INVALID_CHILD_PENALTY = 1 << 20


def assign_words(desc_i8: torch.Tensor, centers_i8: torch.Tensor,
                 valid: torch.Tensor) -> torch.Tensor:
    """(...,K,256) descriptors x (W,256) centres -> (...,K) int32 word ids
    (-1 where invalid)."""
    d = hamming_matrix(desc_i8, centers_i8)
    w = torch.argmin(d, dim=-1).to(torch.int32)
    return torch.where(valid, w, -1)


def assign_words_batch(desc_b, centers_i8, valid_b):
    """(B,K,256) descriptors -> (B,K) word ids in one call."""
    return assign_words(desc_b, centers_i8, valid_b)


def bow_vector(word_ids: torch.Tensor, idf: torch.Tensor, num_words: int) -> torch.Tensor:
    """tf-idf BoW vector (W,) of (K,) word ids, L1-normalized (DBoW2's
    scoring convention)."""
    return bow_vector_batch(word_ids[None], idf, num_words)[0]


def bow_vector_batch(word_ids_b: torch.Tensor, idf: torch.Tensor, num_words: int) -> torch.Tensor:
    """(B,K) word ids -> (B,W) tf-idf vectors in one call."""
    B = word_ids_b.shape[0]
    ok = (word_ids_b >= 0).to(torch.float32)
    hist = torch.zeros((B, num_words), dtype=torch.float32, device=word_ids_b.device)
    hist.scatter_add_(1, torch.clamp(word_ids_b, min=0).to(torch.int64), ok)
    v = hist * idf
    return v / torch.clamp(torch.abs(v).sum(-1, keepdim=True), min=1e-12)


def l1_score(v1: torch.Tensor, v2: torch.Tensor) -> torch.Tensor:
    """DBoW2 L1 similarity of L1-normalized vectors: 1 - 0.5*|v1 - v2|_1."""
    return 1.0 - 0.5 * torch.abs(v1 - v2).sum(-1)


def l1_scores_batch(v: torch.Tensor, db: torch.Tensor) -> torch.Tensor:
    """(W,) query against (N,W) database vectors -> (N,) scores."""
    return l1_score(v[None, :], db)


def word_gate(words_a: torch.Tensor, words_b: torch.Tensor) -> torch.Tensor:
    """(...,N),(...,M) -> (...,N,M) bool: the same valid word (ref
    ``match::bow_tree``)."""
    return (words_a[..., :, None] == words_b[..., None, :]) & (words_a >= 0)[..., :, None]


def tree_assign_words(desc_i8: torch.Tensor, valid: torch.Tensor, level_centers,
                      level_valid, k: int) -> torch.Tensor:
    """Greedy tree descent: (...,K,256) descriptors -> (...,K) int32 leaf ids.

    ``level_centers[l]`` is (k**(l+1), 256) {0,1} indexed by the base-k path
    prefix; ``level_valid[l]`` masks the children that exist.  -1 for
    invalid descriptors."""
    d32 = desc_i8.to(torch.float32)
    na = d32.sum(-1)
    node = torch.zeros(desc_i8.shape[:-1], dtype=torch.int64, device=desc_i8.device)
    ar = torch.arange(k, device=desc_i8.device)
    for C, V in zip(level_centers, level_valid):
        child = node[..., None] * k + ar                       # (...,K,k)
        cc = C[child].to(torch.float32)                        # (...,K,k,256)
        dots = (cc @ d32[..., :, None])[..., 0]
        dist = (na[..., None] + cc.sum(-1) - 2 * dots).to(torch.int32)
        dist = torch.where(V[child], dist, _INVALID_CHILD_PENALTY)
        node = node * k + torch.argmin(dist, dim=-1)
    return torch.where(valid, node.to(torch.int32), -1)


def tree_assign_words_batch(desc_b, valid_b, level_centers, level_valid, k: int):
    """(B,K,256) descriptors -> (B,K) leaf ids in one call."""
    return tree_assign_words(desc_b, valid_b, level_centers, level_valid, k)


def node_at_level(words, k: int, levels: int, level: int):
    """Ancestor node id of each leaf word at tree ``level`` (1..levels): leaf
    ids are base-k path encodings, so the ancestor is word // k**(levels -
    level).  Invalid words (-1) stay -1.  Takes numpy arrays or tensors."""
    q = k ** (levels - level)
    if isinstance(words, torch.Tensor):
        return torch.where(words >= 0, torch.div(words, q, rounding_mode="floor"), -1)
    words = np.asarray(words)
    return np.where(words >= 0, words // q, -1).astype(words.dtype)
