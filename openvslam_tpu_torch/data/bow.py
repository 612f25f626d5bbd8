"""Vocabularies and the BoW database (counterpart of
``openvslam_tpu/data/bow.py``; ref ``data/bow_vocabulary`` and
``data/bow_database``).

- ``Vocabulary`` (the default): W flat binary word centres; assignment is
  exact nearest-word quantization (``ops/bow.assign_words``).
- ``TreeVocabulary``: a k-branch / L-level DBoW2-style tree, descended
  greedily, with the direct-index-at-level gate.

Both train from descriptors (k-medians with a seeded numpy generator, the
JAX package's schedule, so the same seed gives the same vocabulary) and
load from the JAX package's npz format; a tree vocabulary also reads and
writes the ORB-SLAM text format (``ORBvoc.txt``) and the DBoW2 binary format
(``orb_vocab.dbow2``).  The default vocabularies are the package's own
copies in ``assets/`` (one per descriptor pattern); a missing asset raises
and nothing is trained on the way.  Word assignment runs on the device the
caller names (the vocabulary keeps one copy of its centres per device); the
database is host numpy.
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

    @classmethod
    def train(cls, descs_i8: np.ndarray, num_words: int = 1024, iters: int = 8,
              seed: int = 0) -> "Vocabulary":
        """k-medians on binary descriptors: assignment by Hamming distance,
        centres updated by per-bit majority vote; idf from the training
        distribution."""
        rng = np.random.default_rng(seed)
        n = descs_i8.shape[0]
        if n < num_words:
            raise ValueError("need more training descriptors than words")
        centers = descs_i8[rng.choice(n, num_words, replace=False)].astype(np.int8)
        d = descs_i8.astype(np.int32)
        for _ in range(iters):
            # Hamming via dot: d and centers in {0,1}
            dots = d @ centers.astype(np.int32).T
            na = d.sum(-1, keepdims=True)
            nb = centers.astype(np.int32).sum(-1)[None, :]
            assign = (na + nb - 2 * dots).argmin(-1)
            for w in range(num_words):
                members = d[assign == w]
                if len(members) == 0:
                    centers[w] = d[rng.integers(0, n)]
                else:
                    centers[w] = (members.mean(0) > 0.5).astype(np.int8)
        dots = d @ centers.astype(np.int32).T
        na = d.sum(-1, keepdims=True)
        nb = centers.astype(np.int32).sum(-1)[None, :]
        assign = (na + nb - 2 * dots).argmin(-1)
        counts = np.bincount(assign, minlength=num_words).astype(np.float64)
        idf = np.log(n / np.maximum(counts, 1.0)).astype(np.float32)
        return cls(centers, idf)


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

    @classmethod
    def train(cls, descs_i8: np.ndarray, k: int = 8, levels: int = 3, iters: int = 8,
              seed: int = 0) -> "TreeVocabulary":
        """Recursive k-medians: cluster into k groups, recurse per branch
        (DBoW2's training scheme on binary descriptors); idf from the
        training descriptors' leaf words."""
        rng = np.random.default_rng(seed)
        d = descs_i8.astype(np.int32)
        level_centers = [np.zeros((k ** (l + 1), 256), np.int8) for l in range(levels)]
        level_valid = [np.zeros(k ** (l + 1), bool) for l in range(levels)]

        def kmedians(sub: np.ndarray):
            """(n,256) -> (centres (<=k,256) int8, assignment (n,))"""
            n = sub.shape[0]
            kk = min(k, n)
            centers = sub[rng.choice(n, kk, replace=False)]
            for _ in range(iters):
                dist = sub.sum(-1, keepdims=True) + centers.sum(-1)[None] - 2 * (sub @ centers.T)
                assign = dist.argmin(-1)
                for w in range(kk):
                    members = sub[assign == w]
                    if len(members):
                        centers[w] = (members.mean(0) > 0.5).astype(np.int32)
                    else:
                        centers[w] = sub[rng.integers(0, n)]
            dist = sub.sum(-1, keepdims=True) + centers.sum(-1)[None] - 2 * (sub @ centers.T)
            return centers.astype(np.int8), dist.argmin(-1)

        def build(node: int, sub: np.ndarray, level: int):
            if level == levels or sub.shape[0] == 0:
                return
            centers, assign = kmedians(sub)
            for j in range(centers.shape[0]):
                level_centers[level][node * k + j] = centers[j]
                level_valid[level][node * k + j] = True
                build(node * k + j, sub[assign == j], level + 1)

        build(0, d, 0)
        # a valid interior node needs a valid child down to the leaves, else
        # greedy descent dead-ends: chain its own centre down
        for l in range(levels - 1):
            for node in np.nonzero(level_valid[l])[0]:
                lo = node * k
                if not level_valid[l + 1][lo:lo + k].any():
                    level_centers[l + 1][lo] = level_centers[l][node]
                    level_valid[l + 1][lo] = True
        vocab = cls(level_centers, level_valid, k)
        words = vocab.assign(descs_i8.astype(np.int8), np.ones(len(descs_i8), bool))
        counts = np.bincount(words, minlength=vocab.num_words).astype(np.float64)
        vocab.idf = np.log(len(descs_i8) / np.maximum(counts, 1.0)).astype(np.float32)
        return vocab


def load_vocabulary(path: str):
    """A vocabulary from ``.npz`` (flat or tree, the JAX package's format),
    an ORB-SLAM text file (``.txt``; ``load_orbslam_text``) or a DBoW2
    binary file (``.dbow2`` / ``.bin``; ``load_dbow2_binary``)."""
    if path.endswith(".txt"):
        return load_orbslam_text(path)
    if path.endswith((".dbow2", ".bin")):
        return load_dbow2_binary(path)
    return Vocabulary.load(path)


# ---------------------------------------------------------------------------
# ORB-SLAM / DBoW2 text vocabulary format (ORB-SLAM2's ``ORBvoc.txt``),
# DBoW2's TemplatedVocabulary::loadFromTextFile / saveToTextFile:
#
#   line 1:  k L scoring_type weighting_type
#   then one line per non-root node, parents before children:
#            <parent_node_id> <is_leaf 0|1> <32 descriptor bytes> <weight>
#
# Node ids are implicit (root 0, then one per line).  A leaf above the
# deepest level is chained straight down (the trainer's convention) so
# greedy descent ends at a bottom-level word.  Word ids are level-major slot
# ids, not DBoW2's: quantization does not depend on the labels.
# ---------------------------------------------------------------------------
def _desc_bytes_to_bits(vals) -> np.ndarray:
    return np.unpackbits(np.asarray(vals, np.uint8), bitorder="little").astype(np.int8)


def _bits_to_desc_bytes(bits: np.ndarray) -> np.ndarray:
    return np.packbits(bits.astype(np.uint8), bitorder="little")


class _TreeBuilder:
    """Places nodes given parents-first (parent id, bits, is_leaf, weight)
    into the level-major arrays, then chains early leaves to the bottom."""

    def __init__(self, k: int, levels: int):
        self.k, self.levels = k, levels
        self.centers = [np.zeros((k ** (l + 1), 256), np.int8) for l in range(levels)]
        self.valid = [np.zeros(k ** (l + 1), bool) for l in range(levels)]
        self.level = {0: -1}
        self.slot = {0: 0}
        self.n_children = {0: 0}
        self.leaves = []
        self.next_id = 1

    def add(self, pid: int, bits: np.ndarray, is_leaf: bool, weight: float):
        lvl = self.level[pid] + 1
        rank = self.n_children[pid]
        if rank >= self.k:
            raise ValueError(f"node {pid} has more than k={self.k} children")
        if lvl >= self.levels:
            raise ValueError(f"node {self.next_id} lies below the vocabulary's "
                             f"{self.levels} levels")
        slot = self.slot[pid] * self.k + rank
        self.n_children[pid] = rank + 1
        self.centers[lvl][slot] = bits
        self.valid[lvl][slot] = True
        self.level[self.next_id] = lvl
        self.slot[self.next_id] = slot
        self.n_children[self.next_id] = 0
        if is_leaf:
            self.leaves.append((lvl, slot, weight))
        self.next_id += 1

    def vocabulary(self) -> "TreeVocabulary":
        idf = np.ones(self.k ** self.levels, np.float32)
        for lvl, slot, weight in self.leaves:
            s_ = slot
            for l in range(lvl + 1, self.levels):
                child = s_ * self.k
                self.centers[l][child] = self.centers[l - 1][s_]
                self.valid[l][child] = True
                s_ = child
            idf[s_] = weight
        return TreeVocabulary(self.centers, self.valid, self.k, idf)


def _tree_nodes(vocab: "TreeVocabulary"):
    """(parent id, level, slot, is_leaf, weight) of every non-root node of a
    tree vocabulary, breadth first, with ids assigned in that order."""
    k, levels = vocab.k, vocab.levels
    ids = {(-1, 0): 0}
    for lvl in range(levels):
        for slot in np.nonzero(vocab.level_valid[lvl])[0]:
            slot = int(slot)
            parent = (lvl - 1, slot // k) if lvl else (-1, 0)
            is_leaf = (lvl == levels - 1
                       or not vocab.level_valid[lvl + 1][slot * k:slot * k + k].any())
            weight = float(vocab.idf[slot]) if lvl == levels - 1 else 0.0
            yield ids[parent], lvl, slot, is_leaf, weight
            ids[(lvl, slot)] = len(ids)


def load_orbslam_text(path: str) -> "TreeVocabulary":
    with open(path) as f:
        header = f.readline().split()
        tb = _TreeBuilder(int(header[0]), int(header[1]))
        for line in f:
            parts = line.split()
            if parts:
                tb.add(int(parts[0]), _desc_bytes_to_bits([int(v) for v in parts[2:34]]),
                       bool(int(parts[1])), float(parts[34]))
    return tb.vocabulary()


def save_orbslam_text(vocab: "TreeVocabulary", path: str, scoring: int = 0,
                      weighting: int = 0):
    """Write a tree vocabulary in the text format above."""
    with open(path, "w") as f:
        f.write(f"{vocab.k} {vocab.levels} {scoring} {weighting}\n")
        for pid, lvl, slot, is_leaf, w in _tree_nodes(vocab):
            byts = _bits_to_desc_bytes(vocab.level_centers[lvl][slot])
            f.write(f"{pid} {int(is_leaf)} " + " ".join(str(int(v)) for v in byts) + f" {w}\n")


# ---------------------------------------------------------------------------
# DBoW2 binary vocabulary format (the reference ships ``orb_vocab.dbow2``):
# the ORB-SLAM2 saveToBinaryFile / loadFromBinaryFile layout, little-endian:
#
#   uint32 nb_nodes (including the root), uint32 size_node (41 for ORB)
#   int32 k, int32 L, int32 scoring_type, int32 weighting_type
#   one record per non-root node, parents before children:
#     int32 parent id, 32 x uint8 descriptor bytes, float32 weight,
#     uint8 is_leaf
# ---------------------------------------------------------------------------
_DBOW2_NODE = np.dtype([("parent", "<i4"), ("desc", "u1", 32), ("weight", "<f4"),
                        ("is_leaf", "u1")])


def load_dbow2_binary(path: str) -> "TreeVocabulary":
    with open(path, "rb") as f:
        nb_nodes, size_node = np.frombuffer(f.read(8), "<u4")
        k, levels = (int(v) for v in np.frombuffer(f.read(16), "<i4")[:2])
        if size_node != _DBOW2_NODE.itemsize:
            raise ValueError(f"{path}: size_node={size_node} != {_DBOW2_NODE.itemsize} — "
                             "not a 256-bit ORB DBoW2 binary vocabulary")
        payload = f.read()
    expect = (int(nb_nodes) - 1) * int(size_node)
    if len(payload) != expect:
        raise ValueError(f"{path}: payload is {len(payload)} bytes, expected {expect} "
                         "((nb_nodes-1) * size_node)")
    tb = _TreeBuilder(k, levels)
    for nd in np.frombuffer(payload, _DBOW2_NODE):
        tb.add(int(nd["parent"]), _desc_bytes_to_bits(nd["desc"]), bool(nd["is_leaf"]),
               float(nd["weight"]))
    return tb.vocabulary()


def save_dbow2_binary(vocab: "TreeVocabulary", path: str, scoring: int = 0,
                      weighting: int = 0):
    records = []
    for pid, lvl, slot, is_leaf, w in _tree_nodes(vocab):
        rec = np.zeros((), _DBOW2_NODE)
        rec["parent"] = pid
        rec["is_leaf"] = int(is_leaf)
        rec["desc"] = _bits_to_desc_bytes(vocab.level_centers[lvl][slot])
        rec["weight"] = w
        records.append(rec)
    with open(path, "wb") as f:
        f.write(np.asarray([len(records) + 1, _DBOW2_NODE.itemsize], "<u4").tobytes())
        f.write(np.asarray([vocab.k, vocab.levels, scoring, weighting], "<i4").tobytes())
        f.write(np.stack(records).tobytes())


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
