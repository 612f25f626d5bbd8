"""Bag-of-words parity: the port's vocabularies, word assignment, tf-idf
vectors, scores, BoW database queries and native shared-word counter
against the JAX package on the CPU, on the same numpy inputs.

Tolerances:
* flat and tree word ids: identical (ties go to the lowest index in both);
* tf-idf vectors and L1 scores: within 1e-6;
* the databases' relocalization and loop candidate lists: identical, and
  so are those of the batch registration paths against one-by-one;
* the native shared-word counter: the same (keyframe, count) pairs as its
  numpy twin, and the same order as the JAX package's native build of the
  same code (the order breaks ties in the candidate queries);
* the vocabulary assets: the repository's files byte for byte.
"""
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from openvslam_tpu.data import bow as jbow
from openvslam_tpu.ops import bow as jbow_ops
from openvslam_tpu.utils import native as jnative
from openvslam_tpu_torch import convert
from openvslam_tpu_torch.camera import Perspective
from openvslam_tpu_torch.data import bow
from openvslam_tpu_torch.models.frontend import OrbFrontend
from openvslam_tpu_torch.models.track_step import unpack_bits_host
from openvslam_tpu_torch.ops import bow as bow_ops
from openvslam_tpu_torch.utils import native, synthetic

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS, COLS = 320, 416


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def frames():
    """Descriptors (bits) and validity of 6 rendered frames of the e2e orbit,
    extracted by the port's front end on the CPU."""
    cam = Perspective(fx=350.0, fy=350.0, cx=COLS / 2, cy=ROWS / 2, cols=COLS, rows=ROWS)
    scene = synthetic.PatchSceneRenderer(np.random.default_rng(11), n_points=700,
                                         center=(0, 0, 6), extent=(6, 4.5, 2.5),
                                         rows=ROWS, cols=COLS)
    gt = synthetic.orbit_trajectory(40, radius=2.5, target=(0, 0, 6), arc=np.pi / 4)
    fe = OrbFrontend(ROWS, COLS, max_keypts=600, num_levels=4, device="cpu")
    out = []
    for i in (0, 3, 6, 20, 30, 39):
        kp = fe.extract(torch.from_numpy(scene.render(cam, gt[i])))
        valid = kp.valid.numpy()
        desc = kp.desc_u32.numpy().view(np.uint32)
        out.append((unpack_bits_host(desc, valid), valid))
    return out


def test_flat_assign_words_matches_jax(frames):
    vocab = bow.default_vocabulary()
    for desc, valid in frames:
        ours = vocab.assign(desc, valid)
        ref = np.asarray(jbow_ops.assign_words(jnp.asarray(desc), jnp.asarray(vocab.centers_i8),
                                               jnp.asarray(valid)))
        np.testing.assert_array_equal(ours, ref)
        assert (ours[valid] >= 0).all() and (ours[~valid] == -1).all()
    desc_b = np.stack([d for d, _ in frames[:4]])
    valid_b = np.stack([v for _, v in frames[:4]])
    np.testing.assert_array_equal(vocab.assign_batch(desc_b, valid_b),
                                  np.stack([vocab.assign(d, v) for d, v in frames[:4]]))


def test_tree_assign_words_matches_jax(frames):
    path = os.path.join(ROOT, "assets", "vocab_tree_k8L5.npz")
    ours = bow.TreeVocabulary.load(path)
    ref = jbow.TreeVocabulary.load(path)
    assert (ours.k, ours.levels, ours.num_words) == (ref.k, ref.levels, ref.num_words)
    for desc, valid in frames[:3]:
        w = ours.assign(desc, valid)
        np.testing.assert_array_equal(w, ref.assign(desc, valid))
        np.testing.assert_array_equal(ours.gate_ids(w), ref.gate_ids(w))
        for level in (1, 3, 5):
            np.testing.assert_array_equal(ours.node_at_level(w, level),
                                          ref.node_at_level(w, level))
            np.testing.assert_array_equal(
                bow_ops.node_at_level(torch.from_numpy(w), ours.k, ours.levels, level).numpy(),
                np.asarray(jbow_ops.node_at_level(jnp.asarray(w), ref.k, ref.levels, level)))


def test_bow_vectors_and_scores_match_jax(frames):
    vocab = bow.default_vocabulary()
    db = bow.BowDatabase(vocab)
    words = np.stack([vocab.assign(d, v) for d, v in frames])
    ours = db.bow_vecs_batch(words)
    ref = np.stack([np.asarray(jbow_ops.bow_vector(jnp.asarray(w), jnp.asarray(vocab.idf),
                                                   vocab.num_words)) for w in words])
    np.testing.assert_allclose(ours, ref, atol=1e-6)
    np.testing.assert_allclose(db.bow_vec(words[0]), ref[0], atol=1e-6)
    sc = bow_ops.l1_scores_batch(torch.from_numpy(ours[0]), torch.from_numpy(ours)).numpy()
    sc_ref = np.asarray(jbow_ops.l1_scores_batch(jnp.asarray(ref[0]), jnp.asarray(ref)))
    np.testing.assert_allclose(sc, sc_ref, atol=1e-6)
    assert abs(float(bow_ops.l1_score(torch.from_numpy(ours[1]), torch.from_numpy(ours[2])))
               - float(jbow_ops.l1_score(jnp.asarray(ref[1]), jnp.asarray(ref[2])))) < 1e-6
    assert sc[0] == pytest.approx(1.0, abs=1e-6) and (sc[1:] < 1.0).all()


def test_databases_return_the_same_candidates(frames):
    """The same keyframes registered in both databases (no map: each loop
    candidate's group is itself) give identical candidate lists, and the
    JAX database carried across by ``convert`` answers as the port's own."""
    vocab = bow.default_vocabulary()
    jvocab = jbow.Vocabulary.load(os.path.join(ROOT, "assets", "default_vocab.npz"))
    ours, ref = bow.BowDatabase(vocab), jbow.BowDatabase(jvocab)
    rng = np.random.default_rng(4)
    for kf, (desc, valid) in enumerate(frames * 2):
        keep = valid & (rng.random(len(valid)) < 0.8)      # each copy a different subset
        w = vocab.assign(desc, keep)
        ours.add_keyframe(kf, w)
        ref.add_keyframe(kf, w)
    ours.remove_keyframe(3)
    ref.remove_keyframe(3)
    carried = convert.bow_database_from_state(convert.bow_state(ref), vocab, None)
    for desc, valid in frames:
        w = vocab.assign(desc, valid)
        expect = ref.acquire_relocalization_candidates(w)
        assert expect
        assert ours.acquire_relocalization_candidates(w) == expect
        assert carried.acquire_relocalization_candidates(w) == expect
    for kf in (0, 1, 5, 8):
        for min_score in (0.0, 0.05):
            expect = ref.acquire_loop_candidates(kf, min_score, {kf + 1})
            assert ours.acquire_loop_candidates(kf, min_score, {kf + 1}) == expect
            assert carried.acquire_loop_candidates(kf, min_score, {kf + 1}) == expect
    np.testing.assert_allclose(ours.score(0, 6), ref.score(0, 6), atol=1e-6)


def test_batch_registration_equals_one_by_one(frames):
    """The batch paths (words, tf-idf vectors and registration of several
    keyframes in one call; flat and tree vocabularies) give the databases
    that one-by-one registration gives."""
    desc_b = np.stack([d for d, _ in frames])
    valid_b = np.stack([v for _, v in frames])
    tree = bow.TreeVocabulary.load(os.path.join(ROOT, "assets", "vocab_tree_k8L5.npz"))
    for vocab in (bow.default_vocabulary(), tree):
        one, batch = bow.BowDatabase(vocab), bow.BowDatabase(vocab)
        for kf, (desc, valid) in enumerate(frames):
            one.add_keyframe(kf, one.compute_words(desc, valid))
        words_b = batch.compute_words_batch(desc_b, valid_b)
        batch.add_keyframes_batch(list(range(len(frames))), words_b, batch.bow_vecs_batch(words_b))
        for kf in range(len(frames)):
            np.testing.assert_array_equal(batch.kf_words[kf], one.kf_words[kf])
            np.testing.assert_allclose(batch.kf_bow[kf], one.kf_bow[kf], atol=1e-7)
            assert (batch.acquire_loop_candidates(kf, 0.0, {kf})
                    == one.acquire_loop_candidates(kf, 0.0, {kf}))
        assert (batch.acquire_relocalization_candidates(words_b[0])
                == one.acquire_relocalization_candidates(words_b[0]))


def test_native_bow_shared_words_equals_plain_and_jax(rng):
    n_words, n_kf = 64, 40
    posting_w = rng.integers(0, n_words, 600)
    posting_kf = rng.integers(0, n_kf, 600)
    order = np.argsort(posting_w, kind="stable")
    offsets = np.zeros(n_words + 1, np.int64)
    np.cumsum(np.bincount(posting_w, minlength=n_words), out=offsets[1:])
    inv = posting_kf[order].astype(np.int64)
    for q in (rng.integers(-1, n_words, 50), np.array([-1, -1]), np.arange(n_words)):
        ks, vs = native.bow_shared_words(q, offsets, inv)
        pk, pv = native.bow_shared_words_plain(q, offsets, inv)
        assert dict(zip(ks.tolist(), vs.tolist())) == dict(zip(pk.tolist(), pv.tolist()))
        jk, jv = jnative.bow_shared_words(q, offsets, inv)
        np.testing.assert_array_equal(ks, jk)
        np.testing.assert_array_equal(vs, jv)


def test_vocabulary_assets_are_the_repositorys():
    for pattern, path in bow.VOCAB_ASSETS.items():
        name = os.path.basename(path)
        with open(path, "rb") as a, open(os.path.join(ROOT, "assets", name), "rb") as b:
            assert a.read() == b.read(), pattern
    for pattern in ("learned", "cv"):
        v = bow.default_vocabulary(pattern=pattern)
        assert v.centers_i8.shape == (1024, 256) and v.idf.shape == (1024,)
