"""The port's vocabulary surface (``openvslam_tpu_torch/data/bow.py``):
training, the ORB-SLAM text and DBoW2 binary formats and the
``load_vocabulary`` dispatch, as tests/test_orbslam_vocab.py,
tests/test_tree_vocab.py (its IO, training and dispatch cases) and
tests/test_vocab_generalization.py (its two binary-format cases) hold the
JAX package's.  Training is numpy with a seeded generator in both
packages, so the port's vocabularies are bit-exact against JAX's on one
seed, and both packages write the same text and binary files."""
import os

import numpy as np
import pytest
import torch

from openvslam_tpu.data import bow as jbow
from openvslam_tpu_torch.data import bow

ASSET = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets",
                     "vocab_tree_k8L5.npz")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand_descs(n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.random((n, 256)) < 0.5).astype(np.int8)


@pytest.fixture(scope="module")
def tree_vocab():
    rng = np.random.default_rng(0)
    descs = rng.integers(0, 2, (2000, 256)).astype(np.int8)
    return bow.TreeVocabulary.train(descs, k=3, levels=3, iters=4), descs


def _greedy_descent_np(desc, vocab):
    node = 0
    d = desc.astype(np.int64)
    for C, V in zip(vocab.level_centers, vocab.level_valid):
        lo = node * vocab.k
        best_j, best_dist = 0, 1 << 40
        for j in range(vocab.k):
            if V[lo + j]:
                dist = int(np.sum(d != C[lo + j].astype(np.int64)))
                if dist < best_dist:
                    best_j, best_dist = j, dist
        node = node * vocab.k + best_j
    return node


# --- training, bit-exact against JAX ------------------------------------
def test_flat_training_is_bit_exact_against_jax():
    descs = _rand_descs(600, seed=11)
    p = bow.Vocabulary.train(descs, num_words=32, iters=3, seed=5)
    j = jbow.Vocabulary.train(descs, num_words=32, iters=3, seed=5)
    assert np.array_equal(p.centers_i8, j.centers_i8) and p.centers_i8.dtype == np.int8
    assert np.array_equal(p.idf, j.idf) and p.idf.dtype == j.idf.dtype


def test_tree_training_is_bit_exact_against_jax():
    descs = _rand_descs(700, seed=12)
    p = bow.TreeVocabulary.train(descs, k=4, levels=3, iters=3, seed=2)
    j = jbow.TreeVocabulary.train(descs, k=4, levels=3, iters=3, seed=2)
    for a, b in zip(p.level_centers, j.level_centers):
        assert np.array_equal(a, b)
    for a, b in zip(p.level_valid, j.level_valid):
        assert np.array_equal(a, b)
    assert np.array_equal(p.idf, j.idf)


def test_train_and_assign_matches_numpy_descent():
    descs = _rand_descs(600, seed=1)
    vocab = bow.TreeVocabulary.train(descs, k=4, levels=3, iters=4, seed=0)
    assert vocab.num_words == 64
    words = vocab.assign(descs[:50], np.ones(50, bool))
    expected = np.array([_greedy_descent_np(descs[i], vocab) for i in range(50)])
    np.testing.assert_array_equal(words, expected)
    valid = np.ones(50, bool)
    valid[::7] = False
    words2 = vocab.assign(descs[:50], valid)
    assert (words2[~valid] == -1).all()
    np.testing.assert_array_equal(words2[valid], expected[valid])


def test_training_descriptors_land_in_nonempty_leaves():
    descs = _rand_descs(400, seed=2)
    vocab = bow.TreeVocabulary.train(descs, k=3, levels=3, iters=4, seed=1)
    words = vocab.assign(descs, np.ones(len(descs), bool))
    assert (words >= 0).all() and (words < vocab.num_words).all()
    assert np.isfinite(vocab.idf).all()
    seen = np.bincount(words, minlength=vocab.num_words) > 0
    assert (vocab.idf[seen] <= np.log(len(descs)) + 1e-6).all()


def test_small_training_sets_stay_consistent():
    descs = _rand_descs(10, seed=7)
    vocab = bow.TreeVocabulary.train(descs, k=4, levels=3, iters=2, seed=0)
    words = vocab.assign(descs, np.ones(len(descs), bool))
    assert (words >= 0).all() and (words < vocab.num_words).all()
    assert vocab.level_valid[-1][np.unique(words)].all()


def test_flat_training_needs_more_descriptors_than_words():
    with pytest.raises(ValueError):
        bow.Vocabulary.train(_rand_descs(8), num_words=16)


# --- npz IO and the dispatch ---------------------------------------------
def test_io_roundtrip_and_dispatch(tmp_path):
    descs = _rand_descs(300, seed=4)
    vocab = bow.TreeVocabulary.train(descs, k=4, levels=2, iters=3, seed=0)
    p = str(tmp_path / "tree_vocab.npz")
    vocab.save(p)
    v2 = bow.load_vocabulary(p)
    assert isinstance(v2, bow.TreeVocabulary) and (v2.k, v2.levels) == (vocab.k, vocab.levels)
    np.testing.assert_array_equal(vocab.assign(descs[:20], np.ones(20, bool)),
                                  v2.assign(descs[:20], np.ones(20, bool)))
    np.testing.assert_allclose(v2.idf, vocab.idf)
    flat = bow.Vocabulary.train(descs, num_words=16, iters=2)
    pf = str(tmp_path / "flat.npz")
    flat.save(pf)
    assert isinstance(bow.load_vocabulary(pf), bow.Vocabulary)
    # the dispatch by suffix
    pt, pb = str(tmp_path / "v.txt"), str(tmp_path / "v.dbow2")
    bow.save_orbslam_text(vocab, pt)
    bow.save_dbow2_binary(vocab, pb)
    assert isinstance(bow.load_vocabulary(pt), bow.TreeVocabulary)
    assert isinstance(bow.load_vocabulary(pb), bow.TreeVocabulary)


# --- the ORB-SLAM text format (tests/test_orbslam_vocab.py) --------------
def test_text_roundtrip_assignments(tree_vocab, tmp_path):
    tv, _ = tree_vocab
    path = str(tmp_path / "voc.txt")
    bow.save_orbslam_text(tv, path)
    tv2 = bow.load_orbslam_text(path)
    assert (tv2.k, tv2.levels) == (tv.k, tv.levels)
    q = np.random.default_rng(1).integers(0, 2, (500, 256)).astype(np.int8)
    v = np.ones(500, bool)
    np.testing.assert_array_equal(tv.assign(q, v), tv2.assign(q, v))
    w = tv.assign(q, v)
    np.testing.assert_allclose(tv.idf[w], tv2.idf[w], rtol=1e-6)


def test_text_format_shape(tree_vocab, tmp_path):
    tv, _ = tree_vocab
    path = str(tmp_path / "voc2.txt")
    bow.save_orbslam_text(tv, path)
    with open(path) as f:
        k, L, _, _ = f.readline().split()
        assert (int(k), int(L)) == (tv.k, tv.levels)
        line = f.readline().split()
        assert len(line) == 35 and line[0] == "0"
        assert all(0 <= int(v) <= 255 for v in line[2:34])


def test_imbalanced_leaf_propagation(tmp_path):
    """A leaf above the bottom level still quantizes by greedy descent."""
    path = str(tmp_path / "imb.txt")
    rng = np.random.default_rng(3)
    d0, d1 = rng.integers(0, 2, 256), rng.integers(0, 2, 256)
    by0, by1 = (" ".join(str(int(v)) for v in np.packbits(d.astype(np.uint8), bitorder="little"))
                for d in (d0, d1))
    with open(path, "w") as f:
        f.write("2 2 0 0\n")
        f.write(f"0 1 {by0} 1.5\n")        # node 1: a leaf at level 0
        f.write(f"0 0 {by1} 0.0\n")        # node 2: interior at level 0
        f.write(f"2 1 {by1} 2.0\n")        # node 3: a leaf at level 1
    tv = bow.load_orbslam_text(path)
    w = tv.assign(np.stack([d0, d1]).astype(np.int8), np.ones(2, bool))
    assert w[0] != w[1]
    assert tv.idf[w[0]] == pytest.approx(1.5) and tv.idf[w[1]] == pytest.approx(2.0)


def test_system_loads_text_vocab(tmp_path, tree_vocab):
    from openvslam_tpu_torch.config import Config
    from openvslam_tpu_torch.system import System

    path = str(tmp_path / "voc3.txt")
    bow.save_orbslam_text(tree_vocab[0], path)
    cfg = Config.from_dict({
        "Camera": {"name": "synthetic", "setup": "monocular", "model": "perspective",
                   "fx": 350.0, "fy": 350.0, "cx": 208.0, "cy": 160.0, "cols": 416,
                   "rows": 320, "fps": 20},
        "Feature": {"max_num_keypts": 600, "num_levels": 4, "scale_factor": 1.2},
        "LoopDetector": {"enabled": False}})
    for p in (path, str(tmp_path / "voc3.dbow2")):
        if p.endswith(".dbow2"):
            bow.save_dbow2_binary(tree_vocab[0], p)
        s = System(cfg, vocab_path=p, device="cpu")
        assert isinstance(s.global_optimizer.bow_db.vocab, bow.TreeVocabulary)


# --- the DBoW2 binary format (tests/test_vocab_generalization.py) --------
@pytest.mark.skipif(not os.path.exists(ASSET), reason="large tree vocabulary not trained")
def test_dbow2_binary_roundtrip(tmp_path):
    vocab = bow.load_vocabulary(ASSET)
    p = str(tmp_path / "v.dbow2")
    bow.save_dbow2_binary(vocab, p)
    v2 = bow.load_dbow2_binary(p)
    assert (v2.k, v2.levels) == (vocab.k, vocab.levels)
    for a, b in zip(vocab.level_centers, v2.level_centers):
        assert np.array_equal(a, b)
    for a, b in zip(vocab.level_valid, v2.level_valid):
        assert np.array_equal(a, b)
    leaf_ok = vocab.level_valid[-1]
    assert np.allclose(vocab.idf[leaf_ok], v2.idf[leaf_ok], atol=1e-6)


def test_dbow2_binary_matches_text(tmp_path):
    rng = np.random.default_rng(5)
    descs = rng.integers(0, 2, (4000, 256)).astype(np.int8)
    v = bow.TreeVocabulary.train(descs, k=4, levels=3, iters=4)
    pb, pt = str(tmp_path / "v.dbow2"), str(tmp_path / "v.txt")
    bow.save_dbow2_binary(v, pb)
    bow.save_orbslam_text(v, pt)
    vb, vt = bow.load_dbow2_binary(pb), bow.load_orbslam_text(pt)
    q = rng.integers(0, 2, (512, 256)).astype(np.int8)
    val = np.ones(512, bool)
    wb = vb.assign(q, val)
    assert np.array_equal(wb, vt.assign(q, val))
    assert np.array_equal(v.assign(q, val), wb)


def test_dbow2_binary_rejects_other_node_sizes(tmp_path):
    p = str(tmp_path / "bad.dbow2")
    with open(p, "wb") as f:
        f.write(np.asarray([2, 40], "<u4").tobytes() + np.asarray([2, 1, 0, 0], "<i4").tobytes())
    with pytest.raises(ValueError):
        bow.load_dbow2_binary(p)


# --- the two packages' files ----------------------------------------------
def test_both_packages_write_the_same_vocabulary_files(tree_vocab, tmp_path):
    """One tree, written by each package in both formats: byte-identical
    files, and each package reads the other's to the same tree."""
    tv, _ = tree_vocab
    jv = jbow.TreeVocabulary(tv.level_centers, tv.level_valid, tv.k, tv.idf)
    for save_p, save_j, load_p, load_j, name in (
            (bow.save_orbslam_text, jbow.save_orbslam_text, bow.load_orbslam_text,
             jbow.load_orbslam_text, "v.txt"),
            (bow.save_dbow2_binary, jbow.save_dbow2_binary, bow.load_dbow2_binary,
             jbow.load_dbow2_binary, "v.dbow2")):
        pp, pj = str(tmp_path / f"port_{name}"), str(tmp_path / f"jax_{name}")
        save_p(tv, pp)
        save_j(jv, pj)
        assert open(pp, "rb").read() == open(pj, "rb").read(), name
        a, b = load_p(pj), load_j(pp)
        for x, y in zip(a.level_centers + a.level_valid, b.level_centers + b.level_valid):
            assert np.array_equal(x, y)
        assert np.array_equal(a.idf, b.idf)
