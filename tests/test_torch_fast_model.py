"""K1's algorithm on the CPU: a numpy model of what each block of
``csrc/fast.cu`` computes, held bit-exact against the plain composition
``fast_cell_pools_plain``.  The kernel itself runs only on a card
(tests/test_torch_kernels.py); this model checks the choices that make it
exact without a sort or score maps: the pass-mask shortcut at the lower
threshold, the sliding 9-arc sums, and the per-cell top-k by packed
32-bit keys ``(v + 1) << 10 | (1023 - p)`` with retired keys set to 0.
"""
import numpy as np
import pytest
import torch

from openvslam_tpu_torch.ops import fast


def _starts(m):
    """bit s set iff ring bits s..s+8 (circularly) are all set (fast.cu arc_starts)."""
    a = m | (m << 16)
    r = a & (a >> 1)
    r &= r >> 2
    r &= r >> 4
    return r & (a >> 8) & 0xFFFF


def _mask(d, sign, thr):
    return sum(((sign * d[..., k] - thr) > 0).astype(np.int64) << k for k in range(16))


def _score(d, w, thr):
    best = np.zeros(d.shape[:-1], np.float32)
    for sign in (1.0, -1.0):
        starts = _starts(_mask(d, sign, thr))
        for s in range(16):
            arc = sign * w[..., s] - 9 * np.float32(thr)
            best = np.where((starts >> s) & 1 == 1, np.maximum(best, arc), best)
    return best


def _k1_model(img, thr_hi, thr_lo, budget, mask=None, cell=32):
    """One level through fast.cu's steps; returns (vals, idxs) of its pool."""
    h, w = img.shape
    c = img[3:h - 3, 3:w - 3]
    d = np.stack([img[3 + dy:h - 3 + dy, 3 + dx:w - 3 + dx] - c for dy, dx in fast._CIRCLE], -1)
    t_min = min(thr_hi, thr_lo)
    has_arc = (_starts(_mask(d, 1.0, t_min)) | _starts(_mask(d, -1.0, t_min))) != 0
    acc = d[..., :9].sum(-1)
    sums = [acc]
    for s in range(1, 16):                          # sliding: one add, one subtract
        acc = acc + (d[..., (s + 8) & 15] - d[..., s - 1])
        sums.append(acc)
    sums = np.stack(sums, -1)
    s_hi, s_lo = _score(d, sums, thr_hi), _score(d, sums, thr_lo)
    pref = np.zeros((h, w), np.float32)
    pref[3:h - 3, 3:w - 3] = np.where(has_arc, np.where(s_hi > 0, s_hi + 1e4, s_lo), 0)
    ring = np.full((h + 2, w + 2), -np.inf, np.float32)    # -inf outside the level
    ring[1:-1, 1:-1] = pref
    mx = np.max([ring[dy:dy + h, dx:dx + w] for dy in range(3) for dx in range(3)], 0)
    v = np.where(pref >= mx, pref, 0)
    if mask is not None:
        v = np.where(mask > 0, v, 0)
    gh, gw = -(-h // cell), -(-w // cell)
    padded = np.zeros((gh * cell, gw * cell))
    padded[:h, :w] = v
    cells = padded.reshape(gh, cell, gw, cell).transpose(0, 2, 1, 3).reshape(gh * gw, cell * cell)
    keys = ((cells.astype(np.int64) + 1) << 10) | (cell * cell - 1 - np.arange(cell * cell))
    rows = np.arange(gh * gw)
    vals, idxs = [], []
    for _ in range(fast.pool_geometry(((h, w),), (budget,), cell).k_cell[0]):
        best = keys.max(1)
        p = cell * cell - 1 - (best & 1023)
        keys[rows, p] = 0                           # the owner retires the winner
        vals.append((best >> 10) - 1)
        idxs.append(rows * cell * cell + p)
    return (np.stack(vals, 1).reshape(-1).astype(np.float32),
            np.stack(idxs, 1).reshape(-1))


@pytest.mark.parametrize("case", ["noise", "mask", "thr_hi_below_lo", "blank_and_small"])
def test_k1_model_equals_plain(rng, case):
    shapes, budgets = [(96, 160), (67, 111), (20, 24)], [64, 32, 16]
    levels = [rng.integers(0, 256, s).astype(np.float32) for s in shapes]
    masks, thr = None, (20.0, 7.0)
    if case == "mask":
        masks = [(rng.random(s) > 0.3).astype(np.float32) for s in shapes]
    elif case == "thr_hi_below_lo":
        thr = (7.0, 20.0)
    elif case == "blank_and_small":
        levels[0][:] = 0
    vals, idxs = fast.fast_cell_pools_plain(
        [torch.from_numpy(x) for x in levels], *thr, budgets,
        masks=None if masks is None else [torch.from_numpy(m) for m in masks])
    for l, (x, b) in enumerate(zip(levels, budgets)):
        mv, mi = _k1_model(x, *thr, b, None if masks is None else masks[l])
        np.testing.assert_array_equal(vals[l, :mv.shape[0]].numpy(), mv)
        np.testing.assert_array_equal(idxs[l, :mi.shape[0]].numpy(), mi)
        assert bool(torch.isneginf(vals[l, mv.shape[0]:]).all())
    assert (vals[1] > 1e4).any()
    if case == "blank_and_small":
        assert not bool((vals[0] > 0).any())
