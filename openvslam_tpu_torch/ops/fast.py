"""FAST-9/16 corner detection + NMS + grid top-k selection (counterpart of
``openvslam_tpu/ops/fast.py``).

The score maps come from kernel K1 (``csrc/fast.cu``) on the GPU, one
launch over all pyramid levels, and from ``fast_score_maps`` (the plain
PyTorch version) for CPU tensors.  Selection keeps JAX's tie order: every
top-k is a max/argmax loop (first occurrence) or a stable descending sort,
so equal candidates come out lowest index first, as ``lax.top_k`` gives.
"""
from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F

from .. import kernels

# FAST circle of radius 3: 16 (dy, dx) offsets in circular order
_CIRCLE = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)
_ARC = 9  # FAST-9/16
_BORDER = 3
_BONUS = 1e4  # additive preference for hi-threshold corners


def _shifted(img: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """out[y,x] = img[(y+dy) % H, (x+dx) % W]: a wrapping shift, as the JAX
    version's ``jnp.roll``.  Only the zeroed 3-px frame ever reads a
    wrapped pixel."""
    return torch.roll(img, (-dy, -dx), dims=(0, 1))


def _arc_score(diff: torch.Tensor, t: float) -> torch.Tensor:
    """Best contiguous 9-arc of max(+-diff - t, 0) over the ring (H,W,16),
    through circular prefix sums (all sums are of small integers: exact)."""

    def arc(mag):
        m = torch.cat([mag, mag[..., : _ARC - 1]], -1)
        zero = torch.zeros_like(m[..., :1])
        cf = torch.cat([zero, torch.cumsum((m > 0.0).to(torch.float32), -1)], -1)
        cm = torch.cat([zero, torch.cumsum(m, -1)], -1)
        wf = cf[..., _ARC:] - cf[..., :-_ARC]
        wm = cm[..., _ARC:] - cm[..., :-_ARC]
        return torch.where(wf >= _ARC, wm, torch.zeros_like(wm)).amax(-1)

    bright = arc(torch.clamp(diff - t, min=0.0))
    dark = arc(torch.clamp(-diff - t, min=0.0))
    return torch.maximum(bright, dark)


def fast_score_maps(img: torch.Tensor, thresholds) -> List[torch.Tensor]:
    """Plain version of K1: (H,W) f32 -> per-threshold (H,W) score maps with
    a zeroed 3-px frame."""
    ring = torch.stack([_shifted(img, dy, dx) for dy, dx in _CIRCLE], -1)
    diff = ring - img[..., None]
    h, w = img.shape
    yy = torch.arange(h, device=img.device)[:, None]
    xx = torch.arange(w, device=img.device)[None, :]
    inside = (yy >= _BORDER) & (yy < h - _BORDER) & (xx >= _BORDER) & (xx < w - _BORDER)
    return [torch.where(inside, _arc_score(diff, float(t)), torch.zeros_like(img))
            for t in thresholds]


FAST_TILE_X, FAST_TILE_Y = 32, 8   # must match csrc/fast.cu


def kernel_args(level_imgs, thr_hi: float, thr_lo: float):
    """Lay out the operands of one K1 launch over all levels and allocate
    its outputs.  Returns (ctypes arguments of ``fast_score_maps_levels`` in
    csrc/fast.cu, [(hi, lo) per level], tensors to keep alive); the
    arguments hold pointers that must outlive the launch."""
    dev = level_imgs[0].device
    n = len(level_imgs)
    if n > kernels.MAX_LEVELS:
        raise ValueError(f"at most {kernels.MAX_LEVELS} levels, got {n}")
    table = kernels.LevelTable()
    table.num_levels = n
    off = tiles = 0
    for l, im in enumerate(level_imgs):
        if im.dtype != torch.float32 or im.ndim != 2 or im.device != dev:
            raise ValueError("levels must be 2-D float32 tensors on one device")
        h, w = im.shape
        tx = -(-w // FAST_TILE_X)
        table.offset[l], table.height[l], table.width[l] = off, h, w
        table.tiles_x[l], table.tile_start[l] = tx, tiles
        off += h * w
        tiles += tx * -(-h // FAST_TILE_Y)
    table.tile_start[n] = tiles
    flat = torch.cat([im.reshape(-1) for im in level_imgs])
    hi = torch.empty_like(flat)
    lo = torch.empty_like(flat)
    args = (flat.data_ptr(), hi.data_ptr(), lo.data_ptr(), table, float(thr_hi), float(thr_lo),
            kernels.stream_ptr(dev))
    out = []
    for l, im in enumerate(level_imgs):
        o, sz = table.offset[l], im.numel()
        out.append((hi[o:o + sz].view(im.shape), lo[o:o + sz].view(im.shape)))
    return args, out, [flat, hi, lo]


def fast_score_maps_levels(level_imgs, thr_hi: float, thr_lo: float):
    """Both score maps of every pyramid level: [(hi, lo), ...].

    CPU tensors take the plain version level by level; CUDA tensors take
    kernel K1, one launch over all levels (each level's 3-px frame zeroed
    in the kernel).  Any other device raises."""
    dev = level_imgs[0].device
    if dev.type == "cpu":
        return [tuple(fast_score_maps(im, [thr_hi, thr_lo])) for im in level_imgs]
    if dev.type != "cuda":
        raise RuntimeError(f"fast_score_maps_levels: unsupported device {dev}")
    args, out, _keep = kernel_args(level_imgs, thr_hi, thr_lo)
    kernels.check(kernels.library("fast")(*args), "fast_score_maps_levels")
    kernels.LAUNCHES["fast_score_maps"] += 1
    return out


def topk_small(x: torch.Tensor, k: int):
    """Per-row top-k as k rounds of (max, argmax, mask-out): values
    descending, ties keep the lowest index (argmax takes the first)."""
    cols = torch.arange(x.shape[-1], device=x.device)
    vals, idxs = [], []
    for _ in range(k):
        i = torch.argmax(x, -1)
        vals.append(torch.gather(x, -1, i[..., None])[..., 0])
        idxs.append(i)
        x = x.masked_fill(cols == i[..., None], float("-inf"))
    return torch.stack(vals, -1), torch.stack(idxs, -1)


def nms3x3(score: torch.Tensor) -> torch.Tensor:
    """Keep local maxima of a 3x3 neighbourhood (window padded with -inf)."""
    mx = F.max_pool2d(score[None, None], 3, stride=1, padding=1)[0, 0]
    return torch.where(score >= mx, score, torch.zeros_like(score))


def _cell_candidates(s_hi, s_lo, max_pts: int, cell: int, mask):
    """Two-threshold preference + NMS + per-cell top-k cap.  Returns
    (vals (V,), idxs (V,) into the padded (gh,gw,cell,cell) layout, gw)."""
    score = torch.where(s_hi > 0, s_hi + _BONUS, s_lo)
    score = nms3x3(score)
    if mask is not None:
        score = torch.where(mask > 0, score, torch.zeros_like(score))
    h, w = score.shape
    gh, gw = -(-h // cell), -(-w // cell)
    sp = F.pad(score, (0, gw * cell - w, 0, gh * cell - h))
    cells = sp.reshape(gh, cell, gw, cell).permute(0, 2, 1, 3).reshape(gh * gw, cell * cell)
    k_cell = max(1, min(cell * cell, (max_pts * 4) // (gh * gw) + 1))
    cv, ci = topk_small(cells, k_cell)
    cell_ids = torch.arange(gh * gw, device=score.device)[:, None]
    flat_idx = cell_ids * (cell * cell) + ci
    return cv.reshape(-1), flat_idx.reshape(-1), gw


def _finalize_selection(topv, sel, gw: int, cell: int):
    """Decode top-k winners back to (xy, resp, valid)."""
    cell_id = sel // (cell * cell)
    in_cell = sel % (cell * cell)
    y = (cell_id // gw) * cell + in_cell // cell
    x = (cell_id % gw) * cell + in_cell % cell
    valid = topv > 0
    resp = torch.where(topv > _BONUS * 0.5, topv - _BONUS, topv)
    return torch.stack([x, y], -1).to(torch.float32), resp, valid


def select_from_scores_multi(score_pairs, budgets, cell: int = 32, masks=None):
    """Per-level candidate pools, then one stable descending sort over all
    levels; each level keeps its first ``budget`` winners."""
    if masks is None:
        masks = [None] * len(score_pairs)
    pools = [_cell_candidates(s_hi, s_lo, b, cell, m)
             for (s_hi, s_lo), b, m in zip(score_pairs, budgets, masks)]
    vmax = max(p[0].shape[0] for p in pools)
    kmax = max(budgets)
    vals = torch.stack([F.pad(v, (0, vmax - v.shape[0]), value=float("-inf"))
                        for v, _, _ in pools])
    idxs = torch.stack([F.pad(i, (0, vmax - i.shape[0])) for _, i, _ in pools])
    topv, topi = torch.sort(vals, dim=1, descending=True, stable=True)
    topv, topi = topv[:, :kmax], topi[:, :kmax]
    sel = torch.gather(idxs, 1, topi)
    return [_finalize_selection(topv[l, :b], sel[l, :b], pools[l][2], cell)
            for l, b in enumerate(budgets)]


def detect_levels(level_imgs, ini_threshold: float, min_threshold: float,
                  budgets, cell: int = 32, masks=None) -> List[Tuple]:
    """All-pyramid detection: score maps of every level (K1 on the GPU),
    then one cross-level selection.  Returns [(xy, resp, valid), ...]."""
    score_pairs = fast_score_maps_levels(level_imgs, ini_threshold, min_threshold)
    return select_from_scores_multi(score_pairs, budgets, cell=cell, masks=masks)
