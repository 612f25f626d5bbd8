"""Vocabularies and the BoW database (counterpart of
``openvslam_tpu/data/bow.py``; ref ``data/bow_vocabulary`` and
``data/bow_database``).

- ``Vocabulary`` (the default): W flat binary word centres; assignment is
  exact nearest-word quantization (``ops/bow.assign_words``).
- ``TreeVocabulary``: a k-branch / L-level DBoW2-style tree, descended
  greedily, with the direct-index-at-level gate.

Both load from the JAX package's npz format.  The default vocabularies are
the package's own copies in ``assets/`` (one per descriptor pattern); a
missing asset raises.  Word assignment runs on the device the caller names
(the vocabulary keeps one copy of its centres per device); the database is
host numpy.

Not ported: vocabulary training and the ORB-SLAM text / DBoW2 binary
readers and writers.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Set

import numpy as np
import torch

from ..ops import bow as bow_ops
from ..utils import native

_ASSET_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets")
VOCAB_ASSETS = {
    "learned": os.path.join(_ASSET_DIR, "default_vocab.npz"),
    "cv": os.path.join(_ASSET_DIR, "default_vocab_cv.npz"),
}


def _dev(device) -> torch.device:
    return torch.device(device)


class Vocabulary:
    def __init__(self, centers_i8: np.ndarray, idf: Optional[np.ndarray] = None):
        self.centers_i8 = np.asarray(centers_i8).astype(np.int8)     # (W,256) {0,1}
        self.num_words = self.centers_i8.shape[0]
        self.idf = (np.asarray(idf, np.float32) if idf is not None
                    else np.ones(self.num_words, np.float32))
        self._on: Dict[torch.device, tuple] = {}

    def _tensors(self, device):
        dev = _dev(device)
        if dev not in self._on:
            self._on[dev] = (torch.from_numpy(self.centers_i8).to(dev),
                             torch.from_numpy(self.idf).to(dev))
        return self._on[dev]

    def idf_on(self, device) -> torch.Tensor:
        return self._tensors(device)[1]

    def assign(self, desc_i8, valid, device="cpu") -> np.ndarray:
        """(...,K,256) descriptors -> (...,K) int32 word ids (-1 invalid)."""
        centers, _ = self._tensors(device)
        dev = centers.device
        return bow_ops.assign_words(torch.as_tensor(np.asarray(desc_i8), device=dev), centers,
                                    torch.as_tensor(np.asarray(valid), device=dev)).cpu().numpy()

    def assign_batch(self, desc_b, valid_b, device="cpu") -> np.ndarray:
        return self.assign(desc_b, valid_b, device)

    def gate_ids(self, words: np.ndarray) -> np.ndarray:
        """Ids used for match gating: a flat vocabulary's words themselves."""
        return words

    def save(self, path: str):
        np.savez_compressed(path, centers=self.centers_i8, idf=self.idf)

    @classmethod
    def load(cls, path: str):
        with np.load(path) as z:
            if "tree_k" in z:
                return TreeVocabulary._from_npz(z)
            return cls(z["centers"], z["idf"])


class TreeVocabulary:
    """Hierarchical k-branch / L-level binary vocabulary (DBoW2-style),
    stored level-major so descent is L gathers and argmins."""

    def __init__(self, level_centers, level_valid, k: int, idf: Optional[np.ndarray] = None):
        self.level_centers = [np.asarray(c).astype(np.int8) for c in level_centers]
        self.level_valid = [np.asarray(v).astype(bool) for v in level_valid]
        self.k = int(k)
        self.levels = len(self.level_centers)
        self.num_words = self.k ** self.levels
        self.idf = (np.asarray(idf, np.float32) if idf is not None
                    else np.ones(self.num_words, np.float32))
        self.centers_i8 = self.level_centers[-1]
        self._on: Dict[torch.device, tuple] = {}

    def _tensors(self, device):
        dev = _dev(device)
        if dev not in self._on:
            self._on[dev] = ([torch.from_numpy(c).to(dev) for c in self.level_centers],
                             [torch.from_numpy(v).to(dev) for v in self.level_valid],
                             torch.from_numpy(self.idf).to(dev))
        return self._on[dev]

    def idf_on(self, device) -> torch.Tensor:
        return self._tensors(device)[2]

    def assign(self, desc_i8, valid, device="cpu") -> np.ndarray:
        centers, vmask, _ = self._tensors(device)
        dev = vmask[0].device
        return bow_ops.tree_assign_words(
            torch.as_tensor(np.asarray(desc_i8), device=dev),
            torch.as_tensor(np.asarray(valid), device=dev), centers, vmask, self.k).cpu().numpy()

    def assign_batch(self, desc_b, valid_b, device="cpu") -> np.ndarray:
        return self.assign(desc_b, valid_b, device)

    def node_at_level(self, words: np.ndarray, level: int) -> np.ndarray:
        """Direct index: the level-``level`` ancestor of each leaf word id."""
        return bow_ops.node_at_level(words, self.k, self.levels, level)

    def gate_ids(self, words: np.ndarray) -> np.ndarray:
        """Match-gating ids: the direct-index ancestor two levels above the
        leaves (DBoW2's default di_levels placement)."""
        return np.asarray(self.node_at_level(words, max(1, self.levels - 2)))

    def save(self, path: str):
        """Centres bit-packed on disk (32 bytes per node)."""
        payload = {"tree_k": np.int64(self.k), "idf": self.idf, "packed": np.int64(1)}
        for i, (c, v) in enumerate(zip(self.level_centers, self.level_valid)):
            payload[f"centers_{i}"] = np.packbits(c.astype(np.uint8), axis=-1, bitorder="little")
            payload[f"valid_{i}"] = v
        np.savez_compressed(path, **payload)

    @classmethod
    def _from_npz(cls, z) -> "TreeVocabulary":
        k = int(z["tree_k"])
        packed = "packed" in z and int(z["packed"])
        centers, valid = [], []
        i = 0
        while f"centers_{i}" in z:
            c = z[f"centers_{i}"]
            if packed:
                c = np.unpackbits(c, axis=-1, bitorder="little")[..., :256]
            centers.append(c.astype(np.int8))
            valid.append(z[f"valid_{i}"])
            i += 1
        return cls(centers, valid, k, z["idf"])

    @classmethod
    def load(cls, path: str) -> "TreeVocabulary":
        v = Vocabulary.load(path)
        if not isinstance(v, cls):
            raise ValueError(f"{path} holds a flat vocabulary")
        return v


def load_vocabulary(path: str):
    """Load a flat or tree vocabulary from the JAX package's npz format."""
    if not path.endswith(".npz"):
        raise NotImplementedError(
            f"{path}: only npz vocabularies are ported (not the ORB-SLAM text or "
            "DBoW2 binary formats)")
    return Vocabulary.load(path)


def default_vocabulary(num_words: int = 1024, pattern: str = "learned") -> Vocabulary:
    """The package's built-in vocabulary for a descriptor pattern (words
    learned on one pattern's descriptors quantize another's poorly).  Raises
    if the asset is missing or holds another word count; nothing is trained
    here."""
    if pattern not in VOCAB_ASSETS:
        raise ValueError(f"no default vocabulary for pattern {pattern!r}; "
                         f"valid: {sorted(VOCAB_ASSETS)}")
    path = VOCAB_ASSETS[pattern]
    if not os.path.exists(path):
        raise FileNotFoundError(f"default vocabulary asset missing: {path}")
    v = Vocabulary.load(path)
    if v.num_words != num_words:
        raise ValueError(f"{path} holds {v.num_words} words, not {num_words}")
    return v


class _InvertedIndex:
    """Append-only word -> keyframe postings with a lazily rebuilt CSR view
    (removal is a mask; the CSR is rebuilt by one argsort when dirty)."""

    def __init__(self, num_words: int, cap: int = 1 << 14):
        self.num_words = num_words
        self._w = np.zeros(cap, np.int64)
        self._kf = np.zeros(cap, np.int64)
        self._alive = np.zeros(cap, bool)
        self._n = 0
        self._kf_rows: Dict[int, tuple] = {}
        self._csr = None

    def add(self, kf: int, words: np.ndarray):
        m = len(words)
        while self._n + m > len(self._w):
            grow = len(self._w)
            self._w = np.concatenate([self._w, np.zeros(grow, np.int64)])
            self._kf = np.concatenate([self._kf, np.zeros(grow, np.int64)])
            self._alive = np.concatenate([self._alive, np.zeros(grow, bool)])
        sl = slice(self._n, self._n + m)
        self._w[sl] = words
        self._kf[sl] = kf
        self._alive[sl] = True
        self._kf_rows[kf] = (self._n, self._n + m)
        self._n += m
        self._csr = None

    def remove(self, kf: int):
        rows = self._kf_rows.pop(kf, None)
        if rows is not None:
            self._alive[rows[0]:rows[1]] = False
            self._csr = None

    def clear(self):
        self._alive[: self._n] = False
        self._n = 0
        self._kf_rows.clear()
        self._csr = None

    def csr(self):
        """-> (offsets (W+1,) int64, kfs (P,) int64) sorted by word."""
        if self._csr is None:
            rows = np.where(self._alive[: self._n])[0]
            w = self._w[rows]
            order = np.argsort(w, kind="stable")
            counts = np.bincount(w, minlength=self.num_words)
            offsets = np.zeros(self.num_words + 1, np.int64)
            np.cumsum(counts, out=offsets[1:])
            self._csr = (offsets, self._kf[rows][order])
        return self._csr


class BowDatabase:
    """Inverted index word -> keyframes and per-keyframe BoW vectors (host),
    with the reference's two queries: relocalization candidates (shared-word
    gate and score) and loop candidates (shared-word gate, minimum score and
    covisibility-group accumulation).  Word assignment and tf-idf vectors
    run on ``device``."""

    def __init__(self, vocab, map_db=None, device="cpu"):
        self.vocab = vocab
        self.map_db = map_db
        self.device = _dev(device)
        self.inverted = _InvertedIndex(vocab.num_words)
        self.kf_words: Dict[int, np.ndarray] = {}     # kf -> (K,) word ids
        self.kf_bow: Dict[int, np.ndarray] = {}       # kf -> (W,) tf-idf vector

    # ------------------------------------------------------------------
    def compute_words(self, desc_i8: np.ndarray, valid: np.ndarray) -> np.ndarray:
        return self.vocab.assign(desc_i8, valid, self.device)

    def compute_words_batch(self, desc_b: np.ndarray, valid_b: np.ndarray) -> np.ndarray:
        """Word ids of B keyframes in one call."""
        return self.vocab.assign_batch(desc_b, valid_b, self.device)

    def bow_vecs_batch(self, words_b: np.ndarray) -> np.ndarray:
        """tf-idf vectors of B keyframes in one call."""
        if len(words_b) == 0:
            return np.zeros((0, self.vocab.num_words), np.float32)
        w = torch.as_tensor(np.asarray(words_b), device=self.device)
        return bow_ops.bow_vector_batch(w, self.vocab.idf_on(self.device),
                                        self.vocab.num_words).cpu().numpy()

    def add_keyframes_batch(self, kfs: list, words_b: np.ndarray, vecs_b: np.ndarray):
        for kf, w, v in zip(kfs, words_b, vecs_b):
            self.kf_words[kf] = w
            self.kf_bow[kf] = v
            self.inverted.add(kf, np.unique(w[w >= 0]))

    def gate_words(self, words: np.ndarray) -> np.ndarray:
        """Ids for ``word_gate``: leaf words (flat vocabulary) or coarser
        direct-index nodes (tree vocabulary)."""
        return self.vocab.gate_ids(words)

    def bow_vec(self, words: np.ndarray) -> np.ndarray:
        return self.bow_vecs_batch(np.asarray(words)[None])[0]

    def add_keyframe(self, kf: int, words: np.ndarray):
        self.kf_words[kf] = words
        self.kf_bow[kf] = self.bow_vec(words)
        self.inverted.add(kf, np.unique(words[words >= 0]))

    def remove_keyframe(self, kf: int):
        words = self.kf_words.pop(kf, None)
        self.kf_bow.pop(kf, None)
        if words is not None:
            self.inverted.remove(kf)

    def clear(self):
        self.inverted.clear()
        self.kf_words.clear()
        self.kf_bow.clear()

    def score(self, a: int, b: int) -> float:
        return float(1.0 - 0.5 * np.abs(self.kf_bow[a] - self.kf_bow[b]).sum())

    def score_vec(self, v: np.ndarray, kf: int) -> float:
        return float(1.0 - 0.5 * np.abs(v - self.kf_bow[kf]).sum())

    # ------------------------------------------------------------------
    def _shared_word_counts(self, words: np.ndarray, exclude: Set[int]):
        offsets, inv = self.inverted.csr()
        ks, vs = native.bow_shared_words(words, offsets, inv)
        return {int(k): int(v) for k, v in zip(ks, vs) if int(k) not in exclude}

    def acquire_relocalization_candidates(self, words: np.ndarray,
                                          max_candidates: int = 10) -> List[int]:
        counts = self._shared_word_counts(words, exclude=set())
        if not counts:
            return []
        thr = 0.8 * max(counts.values())
        v = self.bow_vec(words)
        scored = [(self.score_vec(v, kf), kf) for kf, c in counts.items() if c >= thr]
        scored.sort(reverse=True)
        return [kf for _, kf in scored[:max_candidates]]

    def acquire_loop_candidates(self, kf: int, min_score: float, connected: Set[int],
                                max_candidates: int = 10) -> List[int]:
        """Shared-word gate, minimum score, then each candidate's score
        accumulated over its covisibility group (the reference's scheme)."""
        words = self.kf_words.get(kf)
        if words is None:
            return []
        counts = self._shared_word_counts(words, exclude=connected | {kf})
        if not counts:
            return []
        thr = 0.8 * max(counts.values())
        first = [(self.score(kf, cand), cand) for cand, c in counts.items() if c >= thr]
        first = [(s, c) for s, c in first if s >= min_score]
        if not first:
            return []
        best_of_group = {}
        for s, cand in first:
            group = [cand]
            if self.map_db is not None:
                group += self.map_db.get_top_covisible(cand, 10)
            acc = 0.0
            best_kf, best_s = cand, s
            for g in group:
                if g in self.kf_bow and g in counts:
                    gs = self.score(kf, g)
                    acc += gs
                    if gs > best_s:
                        best_kf, best_s = g, gs
            best_of_group[best_kf] = max(best_of_group.get(best_kf, 0.0), acc)
        if not best_of_group:
            return []
        best_acc = max(best_of_group.values())
        out = [c for c, acc in best_of_group.items() if acc >= 0.75 * best_acc]
        out.sort(key=lambda c: -best_of_group[c])
        return out[:max_candidates]
