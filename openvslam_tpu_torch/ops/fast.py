"""FAST-9/16 corner detection + NMS + grid top-k selection (counterpart of
``openvslam_tpu/ops/fast.py``).

Kernel K1 (``csrc/fast.cu``) runs the whole detection stage of every
pyramid level in one launch on the GPU: both score maps, the
two-threshold preference, the 3x3 NMS, the masks and the per-cell top-k,
writing only the per-cell candidate pools (``fast_cell_pools``).  CPU
tensors take the plain composition ``fast_cell_pools_plain``
(``fast_score_maps``, then ``_cell_candidates`` per level).  One stable
descending sort over all levels' pools then picks each level's keypoints
(``select_from_pools``).  Tie order is JAX's throughout: every top-k is a
max/argmax loop (first occurrence), a block maximum over keys that rank
the lower index higher, or a stable descending sort, so equal candidates
come out lowest index first, as ``lax.top_k`` gives.
"""
from __future__ import annotations

import functools
from typing import List, NamedTuple, Tuple

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
    """The score maps that open K1's plain version: (H,W) f32 ->
    per-threshold (H,W) score maps with a zeroed 3-px frame."""
    ring = torch.stack([_shifted(img, dy, dx) for dy, dx in _CIRCLE], -1)
    diff = ring - img[..., None]
    h, w = img.shape
    yy = torch.arange(h, device=img.device)[:, None]
    xx = torch.arange(w, device=img.device)[None, :]
    inside = (yy >= _BORDER) & (yy < h - _BORDER) & (xx >= _BORDER) & (xx < w - _BORDER)
    return [torch.where(inside, _arc_score(diff, float(t)), torch.zeros_like(img))
            for t in thresholds]


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


class PoolGeometry(NamedTuple):
    """Shape-only layout of the candidate pools of a set of levels."""
    cells_x: Tuple[int, ...]     # gw: cells per row of each level
    cells: Tuple[int, ...]       # gh * gw
    k_cell: Tuple[int, ...]      # candidates kept per cell
    vmax: int                    # pool row length: max of cells * k_cell


@functools.lru_cache(maxsize=None)
def pool_geometry(shapes: Tuple[Tuple[int, int], ...], budgets: Tuple[int, ...],
                  cell: int) -> PoolGeometry:
    """Cells and per-cell caps of levels of the given (h, w) shapes and
    keypoint budgets (the k_cell rule of ``_cell_candidates``)."""
    gws, cells, ks = [], [], []
    for (h, w), budget in zip(shapes, budgets):
        gh, gw = -(-h // cell), -(-w // cell)
        gws.append(gw)
        cells.append(gh * gw)
        ks.append(max(1, min(cell * cell, (budget * 4) // (gh * gw) + 1)))
    return PoolGeometry(tuple(gws), tuple(cells), tuple(ks),
                        max(c * k for c, k in zip(cells, ks)))


def _cell_candidates(s_hi, s_lo, max_pts: int, cell: int, mask):
    """Two-threshold preference + NMS + per-cell top-k cap of one level.
    Returns (vals (V,), idxs (V,) into the padded (gh,gw,cell,cell) layout)."""
    score = torch.where(s_hi > 0, s_hi + _BONUS, s_lo)
    score = nms3x3(score)
    if mask is not None:
        score = torch.where(mask > 0, score, torch.zeros_like(score))
    h, w = score.shape
    gh, gw = -(-h // cell), -(-w // cell)
    sp = F.pad(score, (0, gw * cell - w, 0, gh * cell - h))
    cells = sp.reshape(gh, cell, gw, cell).permute(0, 2, 1, 3).reshape(gh * gw, cell * cell)
    cv, ci = topk_small(cells, pool_geometry(((h, w),), (max_pts,), cell).k_cell[0])
    cell_ids = torch.arange(gh * gw, device=score.device)[:, None]
    flat_idx = cell_ids * (cell * cell) + ci
    return cv.reshape(-1), flat_idx.reshape(-1)


def fast_cell_pools_plain(level_imgs, thr_hi: float, thr_lo: float, budgets,
                          cell: int = 32, masks=None):
    """Plain version of K1: per level the score maps of ``fast_score_maps``,
    then ``_cell_candidates``; the pools padded to one length with -inf
    (index 0) and stacked.  Returns (vals (L, Vmax) f32, idxs (L, Vmax) i64).
    Any float thresholds."""
    if masks is None:
        masks = [None] * len(level_imgs)
    pools = [_cell_candidates(*fast_score_maps(im, [thr_hi, thr_lo]), b, cell, m)
             for im, b, m in zip(level_imgs, budgets, masks)]
    vmax = max(v.shape[0] for v, _ in pools)
    vals = torch.stack([F.pad(v, (0, vmax - v.shape[0]), value=float("-inf")) for v, _ in pools])
    idxs = torch.stack([F.pad(i, (0, vmax - i.shape[0])) for _, i in pools])
    return vals, idxs


KERNEL_CELL = 32     # the cell side K1 is compiled for (csrc/fast.cu CELL)


@functools.lru_cache(maxsize=None)
def _level_table(shapes, budgets) -> kernels.LevelTable:
    """K1's table with the geometry filled in and no pointers."""
    n = len(shapes)
    if n > kernels.MAX_LEVELS:
        raise ValueError(f"at most {kernels.MAX_LEVELS} levels, got {n}")
    geo = pool_geometry(shapes, budgets, KERNEL_CELL)
    table = kernels.LevelTable()
    table.num_levels, table.vmax = n, geo.vmax
    start = 0
    for l, (h, w) in enumerate(shapes):
        table.height[l], table.width[l] = h, w
        table.cells_x[l], table.k_cell[l] = geo.cells_x[l], geo.k_cell[l]
        table.cell_start[l] = start
        start += geo.cells[l]
    table.cell_start[n] = start
    return table


def kernel_args(level_imgs, thr_hi: float, thr_lo: float, budgets, cell: int = KERNEL_CELL,
                masks=None):
    """Check the operands of one K1 launch and allocate its outputs.
    Returns (ctypes arguments of ``fast_cell_pools`` in csrc/fast.cu,
    (vals, idxs), tensors to keep alive); the arguments hold pointers that
    must outlive the launch."""
    dev = level_imgs[0].device
    if cell != KERNEL_CELL:
        raise ValueError(f"K1 is built for {KERNEL_CELL}-px cells, got {cell}")
    thr = (float(thr_hi), float(thr_lo))
    if not all(t.is_integer() and 0 <= t <= 255 for t in thr):
        raise ValueError(f"K1 takes integer thresholds in [0, 255], got {thr}")
    if len(budgets) != len(level_imgs) or (masks is not None and len(masks) != len(level_imgs)):
        raise ValueError("one budget (and mask) per level")
    shapes = tuple(tuple(im.shape) for im in level_imgs)
    table = kernels.LevelTable.from_buffer_copy(_level_table(shapes, tuple(budgets)))
    keep = list(level_imgs)
    for l, im in enumerate(level_imgs):
        if im.dtype != torch.float32 or im.ndim != 2 or im.device != dev or not im.is_contiguous():
            raise ValueError("levels must be contiguous 2-D float32 tensors on one device")
        table.img[l] = im.data_ptr()
        m = None if masks is None else masks[l]
        if m is not None:
            if tuple(m.shape) != shapes[l] or m.device != dev:
                raise ValueError("a level's mask must have its shape and device")
            m = (m > 0).contiguous()
            keep.append(m)
            table.mask[l] = m.data_ptr()
    vals = torch.empty((len(shapes), table.vmax), dtype=torch.float32, device=dev)
    idxs = torch.empty((len(shapes), table.vmax), dtype=torch.int64, device=dev)
    args = (table, *thr, vals.data_ptr(), idxs.data_ptr(), kernels.stream_ptr(dev))
    return args, (vals, idxs), keep + [vals, idxs]


def fast_cell_pools(level_imgs, thr_hi: float, thr_lo: float, budgets, cell: int = 32,
                    masks=None):
    """The candidate pools of every pyramid level: FAST at both thresholds,
    the preference for high-threshold corners, 3x3 NMS, the optional masks
    (> 0 = usable) and the per-cell top-k.  Returns (vals (L, Vmax) f32,
    padded with -inf; idxs (L, Vmax) i64 into each level's padded
    (gh, gw, cell, cell) layout, padded with 0).

    CPU tensors take the plain version (any float thresholds).  CUDA
    tensors launch kernel K1 once for all levels; it takes levels of
    integers in [0, 255] (the pyramid's) and integer thresholds in
    [0, 255], which keep every score an integer its top-k keys can hold,
    and raises on other thresholds or a cell other than 32.  Any other
    device raises."""
    dev = level_imgs[0].device
    if dev.type == "cpu":
        return fast_cell_pools_plain(level_imgs, thr_hi, thr_lo, budgets, cell, masks)
    if dev.type != "cuda":
        raise RuntimeError(f"fast_cell_pools: unsupported device {dev}")
    args, out, _keep = kernel_args(level_imgs, thr_hi, thr_lo, budgets, cell, masks)
    kernels.check(kernels.library("fast")(*args), "fast_cell_pools")
    kernels.count_launch("fast_score_maps")
    return out


@functools.lru_cache(maxsize=None)
def _cells_x_column(cells_x, device) -> torch.Tensor:
    return torch.tensor(cells_x, dtype=torch.int64, device=device)[:, None]


def _finalize_selection(topv, sel, gw, cell: int):
    """Decode top-k winners back to (xy, resp, valid); ``gw``, the cells
    per row, is an int or an (L, 1) column with one entry per level."""
    cell_id = sel // (cell * cell)
    in_cell = sel % (cell * cell)
    y = (cell_id // gw) * cell + in_cell // cell
    x = (cell_id % gw) * cell + in_cell % cell
    valid = topv > 0
    resp = torch.where(topv > _BONUS * 0.5, topv - _BONUS, topv)
    return torch.stack([x, y], -1).to(torch.float32), resp, valid


def select_from_pools(vals, idxs, shapes, budgets, cell: int = 32):
    """One stable descending sort over the pools of all levels (JAX's
    batched ``lax.top_k``); each level keeps its first ``budget`` winners,
    decoded once for all levels.  Returns [(xy, resp, valid), ...]."""
    geo = pool_geometry(tuple(tuple(s) for s in shapes), tuple(budgets), cell)
    kmax = max(budgets)
    topv, topi = torch.sort(vals, dim=1, descending=True, stable=True)
    topv, topi = topv[:, :kmax], topi[:, :kmax]
    sel = torch.gather(idxs, 1, topi)
    xy, resp, valid = _finalize_selection(topv, sel, _cells_x_column(geo.cells_x, vals.device),
                                          cell)
    return [(xy[l, :b], resp[l, :b], valid[l, :b]) for l, b in enumerate(budgets)]


def detect_levels(level_imgs, ini_threshold: float, min_threshold: float,
                  budgets, cell: int = 32, masks=None) -> List[Tuple]:
    """All-pyramid detection: the candidate pools of every level (K1 on the
    GPU), then one cross-level selection.  Returns [(xy, resp, valid), ...]."""
    vals, idxs = fast_cell_pools(level_imgs, ini_threshold, min_threshold, budgets, cell, masks)
    return select_from_pools(vals, idxs, [im.shape for im in level_imgs], budgets, cell)
