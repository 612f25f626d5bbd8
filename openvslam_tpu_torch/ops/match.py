"""Projection-gated Hamming matching (counterpart of ``openvslam_tpu/ops/match.py``).

``projection_scale_match`` is the guided-search matcher of the tracking
step.  CUDA tensors go to kernel K2 (``csrc/match.cu``), which bins the
keypoints on a grid of square cells and searches, for each visible
landmark, only the cells around its projection; CPU tensors go to the
plain version, the gate + ``match_descriptors`` composition, which
computes the full (L,K) Hamming matrix.  Both give the same ``idx`` and
``dist``, ties included: row minima take the lowest keypoint index, the
cross-check's column minima the lowest landmark row.

The grid's geometry is plain Python here (``bin_grid``), and
``keypoint_cells`` / ``row_boxes`` repeat the kernel's float32 arithmetic
for its cell of a keypoint and its box of cells around a row, so the CPU
tests can check that the box holds every keypoint the exact gate passes.

Descriptors are packed (N,8) int32 words (see ``ops/orb.py``).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .. import kernels
from .orb import unpack_bits_i8

LARGE = 1 << 20

HAMMING_DIST_THR_LOW = 30
HAMMING_DIST_THR_HIGH = 50


def hamming_matrix(bits_a: torch.Tensor, bits_b: torch.Tensor) -> torch.Tensor:
    """(...,N,256)/(...,M,256) {0,1} -> (...,N,M) int32 Hamming distances, as
    popcnt(a) + popcnt(b) - 2 a.b (an f32 product: exact, TF32 is off)."""
    a = bits_a.to(torch.float32)
    b = bits_b.to(torch.float32)
    dots = (a @ b.transpose(-1, -2)).to(torch.int32)
    na = a.sum(-1).to(torch.int32)
    nb = b.sum(-1).to(torch.int32)
    return na[..., :, None] + nb[..., None, :] - 2 * dots


def top2(dist: torch.Tensor):
    """Per-row best & second-best over the last axis: (best_idx, best_d,
    second_d); the best index is the lowest among ties (argmin takes the
    first occurrence)."""
    best_idx = torch.argmin(dist, dim=-1)
    best_d = torch.gather(dist, -1, best_idx[..., None])[..., 0]
    cols = torch.arange(dist.shape[-1], device=dist.device)
    rest = torch.where(cols == best_idx[..., None], torch.iinfo(torch.int32).max, dist)
    return best_idx, best_d, rest.amin(dim=-1)


def match_descriptors(bits_a, bits_b, valid_a, valid_b, gate=None,
                      max_dist: int = HAMMING_DIST_THR_LOW, ratio=0.9,
                      cross_check: bool = True):
    """Generic gated matcher of rows a against columns b; every operand may
    carry the same leading batch axes.  Returns (idx_b (...,N) int32 [-1
    unmatched], dist (...,N) int32 [LARGE unmatched])."""
    d = hamming_matrix(bits_a, bits_b)
    allowed = valid_a[..., :, None] & valid_b[..., None, :]
    if gate is not None:
        allowed = allowed & gate
    d = torch.where(allowed, d, LARGE)
    best_idx, best_d, second_d = top2(d)
    ok = best_d <= max_dist
    if ratio is not None:
        ok = ok & (best_d.to(torch.float32) <= ratio * second_d.to(torch.float32))
    if cross_check:
        col_best = torch.argmin(d, dim=-2)
        rows = torch.arange(d.shape[-2], device=d.device)
        ok = ok & (torch.gather(col_best, -1, best_idx) == rows)
    return (torch.where(ok, best_idx.to(torch.int32), -1),
            torch.where(ok, best_d, LARGE))


def window_gate(xy_a: torch.Tensor, xy_b: torch.Tensor, radius: float) -> torch.Tensor:
    """(N,2),(M,2) -> (N,M) bool: b within a square window around a (ref match::area)."""
    dx = torch.abs(xy_a[:, None, 0] - xy_b[None, :, 0])
    dy = torch.abs(xy_a[:, None, 1] - xy_b[None, :, 1])
    return (dx < radius) & (dy < radius)


def scale_gate(level_a: torch.Tensor, level_b: torch.Tensor, tol: int = 1) -> torch.Tensor:
    """Octave-consistency gate: |level difference| <= tol."""
    return torch.abs(level_a[:, None] - level_b[None, :]) <= tol


def epipolar_gate(bearings_a, bearings_b, E_ab, thr: float = 2e-3) -> torch.Tensor:
    """Essential-matrix consistency |b_a^T E b_b| below threshold on the unit
    sphere (ref match::robust's epipolar check for triangulation pairs).
    (...,N,3), (...,M,3), (...,3,3) -> (...,N,M) bool."""
    Eb = bearings_b @ E_ab.transpose(-1, -2)
    n = Eb / torch.clamp(torch.linalg.norm(Eb, dim=-1, keepdim=True), min=1e-9)
    return torch.abs(bearings_a @ n.transpose(-1, -2)) < thr


def angle_consistency_filter(angles_a, angles_b, idx_b, num_bins: int = 30,
                             keep_top: int = 3):
    """Orientation-histogram check (ref ``match/angle_checker.h``): keep only
    matches whose angle difference falls in the ``keep_top`` fullest of
    ``num_bins`` bins (ties between bins go to the lower bin, as
    ``lax.top_k`` breaks them).  angles_a (...,N), angles_b (...,M), idx_b
    (...,N) -> idx_b with inconsistent matches set to -1."""
    matched = idx_b >= 0
    da = angles_a - torch.gather(angles_b, -1, torch.clamp(idx_b, min=0).to(torch.int64))
    two_pi = 2 * math.pi
    # floored modulo as XLA computes it: the exact fmod, shifted by 2 pi
    # where its sign differs from the divisor's
    da = torch.fmod(da, two_pi)
    da = torch.where((da != 0) & (da < 0), da + two_pi, da)
    bin_idx = torch.clamp((da / two_pi * num_bins).to(torch.int32), 0, num_bins - 1).to(torch.int64)
    hist = torch.zeros(idx_b.shape[:-1] + (num_bins,), dtype=torch.int32, device=idx_b.device)
    hist.scatter_add_(-1, bin_idx, matched.to(torch.int32))
    top_bins = torch.sort(hist, dim=-1, descending=True, stable=True).indices[..., :keep_top]
    in_top = (bin_idx[..., :, None] == top_bins[..., None, :]).any(-1)
    return torch.where(matched & in_top, idx_b, -1)


def projection_gate(proj_uv, proj_valid, xy_b, radius):
    """Keypoint b must lie strictly within ``radius`` (per row) of the
    projected position of landmark a.  (...,L,2), (...,L), (...,K,2), (L,)
    -> (...,L,K) bool."""
    dx = proj_uv[..., :, None, 0] - xy_b[..., None, :, 0]
    dy = proj_uv[..., :, None, 1] - xy_b[..., None, :, 1]
    d2 = dx * dx + dy * dy
    return proj_valid[..., :, None] & (d2 < (radius * radius)[:, None])


def projection_scale_match_plain(a_desc_u32, b_desc_u32, uv, vis, radius, pred_level,
                                 b_xy, b_level, b_valid,
                                 max_dist: int = HAMMING_DIST_THR_HIGH,
                                 ratio=None, cross_check: bool = True):
    """Plain version of K2: projection + octave gate, then match_descriptors."""
    gate = projection_gate(uv, vis, b_xy, radius)
    sgate = torch.abs(b_level[None, :] - pred_level[:, None]) <= 1
    gate = gate & (sgate | (pred_level < 0)[:, None])
    return match_descriptors(unpack_bits_i8(a_desc_u32), unpack_bits_i8(b_desc_u32),
                             vis, b_valid, gate=gate, max_dist=max_dist,
                             ratio=ratio, cross_check=cross_check)


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


MATCH_CELL = 16          # starting side of a grid cell in pixels (a power of two)
IMAGE_SIZE = (640, 480)  # grid extent (cols, rows) when the caller gives none
MAX_CELLS = 8192         # must match csrc/match.cu
_SLACK = 2.0 ** -20      # relative widening of a row's box, for rounding


class BinGrid(NamedTuple):
    cell: int   # side of a square cell in pixels, a power of two
    gw: int     # cells across
    gh: int     # cells down


def bin_grid(cols, rows, cell: int = MATCH_CELL) -> BinGrid:
    """Grid of square cells over [0, cols) x [0, rows); the side doubles
    until there are at most MAX_CELLS cells.  Coordinates outside the grid
    fall into its border cells, so any grid gives exact results; the image
    size only decides how few keypoints a row visits."""
    cols, rows = max(float(cols), 1.0), max(float(rows), 1.0)
    while math.ceil(cols / cell) * math.ceil(rows / cell) > MAX_CELLS:
        cell *= 2
    return BinGrid(cell, math.ceil(cols / cell), math.ceil(rows / cell))


def _grid_coord(x: torch.Tensor, cell: int, n: int) -> torch.Tensor:
    """floor(x / cell) clamped to [0, n) in float32, NaN to 0: the kernel's
    grid_coord (1 / cell is exact for a power of two)."""
    f = torch.floor(x.to(torch.float32) * (1.0 / cell))
    f = torch.nan_to_num(f, nan=0.0, posinf=float(n - 1), neginf=0.0)
    return torch.clamp(f, 0.0, float(n - 1)).to(torch.int64)


def keypoint_cells(xy: torch.Tensor, grid: BinGrid):
    """(cx, cy) of each keypoint's cell, as the bin kernel computes them."""
    return _grid_coord(xy[:, 0], grid.cell, grid.gw), _grid_coord(xy[:, 1], grid.cell, grid.gh)


def row_boxes(uv: torch.Tensor, radius: torch.Tensor, grid: BinGrid):
    """(x0, x1, y0, y1), inclusive cell ranges that the row kernel walks for
    each landmark: the disc's bounding box widened by one cell and 2^-20 of
    |uv| + |r| (more than the float32 rounding of the gate), clamped."""
    f32 = torch.float32
    ar = torch.abs(radius.to(f32))
    cell = torch.tensor(float(grid.cell), dtype=f32)
    out = []
    for c, n in ((uv[:, 0].to(f32), grid.gw), (uv[:, 1].to(f32), grid.gh)):
        pad = ar + (cell + (torch.abs(c) + ar) * _SLACK)
        out += [_grid_coord(c - pad, grid.cell, n), _grid_coord(c + pad, grid.cell, n)]
    return out[0], out[1], out[2], out[3]


def scratch_size(L: int, K: int, grid: BinGrid, B: int = 1) -> int:
    """int32 words of K2's scratch for B problems: per problem its cell
    starts, binned keypoints, row best and second, column minima."""
    return B * (grid.gw * grid.gh + 1 + 2 * K + 2 * L)


def kernel_args(a_desc_u32, b_desc_u32, uv, vis, radius, pred_level, b_xy, b_level, b_valid,
                max_dist: int = HAMMING_DIST_THR_HIGH, ratio=None, cross_check: bool = True,
                image_size=IMAGE_SIZE):
    """Check the operands of one K2 launch, one problem (a_desc (L,8), ...)
    or a batch of B of one shape (a_desc (B,L,8), ...), and allocate its
    outputs and scratch.  Returns (ctypes arguments of ``projection_match``
    in csrc/match.cu, (idx, dist) shaped as the operands, tensors to keep
    alive); the arguments hold pointers into the operands, the scratch and
    the outputs, which must outlive the launch."""
    dev = a_desc_u32.device
    single = a_desc_u32.ndim == 2
    ops = (a_desc_u32, b_desc_u32, uv, vis, radius, pred_level, b_xy, b_level, b_valid)
    if single:
        ops = tuple(t[None] for t in ops)
    B, L, K = ops[0].shape[0], ops[0].shape[1], ops[1].shape[1]
    if K < 2:
        raise ValueError("projection_scale_match needs at least two keypoints")
    if not (0 <= max_dist < 1023):
        raise ValueError("max_dist must lie in [0, 1023)")
    col_mul, row_mul = _next_pow2(max(K, 2)), _next_pow2(max(L, 2))
    if col_mul * 1024 >= 2**31 or row_mul * 1024 >= 2**31:
        raise ValueError(f"too many landmarks/keypoints for packed minima: L={L}, K={K}")
    i32, f32 = torch.int32, torch.float32

    def arg(t, dtypes, shape):
        # copies only what the kernel cannot read as it is
        if t.dtype not in dtypes or t.device != dev or not t.is_contiguous():
            t = t.to(device=dev, dtype=t.dtype if t.dtype in dtypes else dtypes[0]).contiguous()
        if t.shape != shape:
            raise ValueError(f"expected shape {shape}, got {tuple(t.shape)}")
        return t

    levels = (torch.int64, i32)
    keep = [arg(t, dts, (B,) + shape) for t, dts, shape in zip(
        ops, ((i32,), (i32,), (f32,), (torch.bool,), (f32,), levels, (f32,), levels,
              (torch.bool,)),
        ((L, 8), (K, 8), (L, 2), (L,), (L,), (L,), (K, 2), (K,), (K,)))]
    a_desc, b_desc, a_uv, a_vis, a_r, a_pred, bxy, blvl, bval = keep
    if b_desc.data_ptr() % 16:
        raise ValueError("projection_scale_match: b_desc must be 16-byte aligned")
    grid = bin_grid(*image_size)
    # one allocation: the scratch, then idx and dist
    n_scratch = scratch_size(L, K, grid, B)
    buf = torch.empty(n_scratch + 2 * B * L, dtype=i32, device=dev)
    base = buf.data_ptr()
    args = (B, a_desc.data_ptr(), b_desc.data_ptr(), a_uv.data_ptr(), a_vis.data_ptr(),
            a_r.data_ptr(), a_pred.data_ptr(), int(a_pred.dtype == torch.int64),
            bxy.data_ptr(), blvl.data_ptr(), int(blvl.dtype == torch.int64), bval.data_ptr(),
            L, K, float(grid.cell), grid.gw, grid.gh, col_mul, row_mul, int(max_dist),
            -1.0 if ratio is None else float(ratio), int(bool(cross_check)),
            base, base + 4 * n_scratch, base + 4 * (n_scratch + B * L), kernels.stream_ptr(dev))
    out = buf[n_scratch:].view(2, B, L)
    idx, dist = (out[0][0], out[1][0]) if single else (out[0], out[1])
    return args, (idx, dist), keep + [buf]


def projection_scale_match_plain_batch(*ops, **kw):
    """Plain version of a batched K2 launch: ``projection_scale_match_plain``
    on each of the B problems, results stacked."""
    outs = [projection_scale_match_plain(*(t[b] for t in ops), **kw)
            for b in range(ops[0].shape[0])]
    return tuple(torch.stack(o) for o in zip(*outs))


def projection_scale_match(a_desc_u32, b_desc_u32, uv, vis, radius, pred_level,
                           b_xy, b_level, b_valid,
                           max_dist: int = HAMMING_DIST_THR_HIGH,
                           ratio=None, cross_check: bool = True, image_size=IMAGE_SIZE):
    """Projection-radius + octave gated matcher: landmarks a (L rows) against
    keypoints b (K columns).

    a_desc_u32 (L,8) / b_desc_u32 (K,8) packed int32; uv (L,2) projected
    landmarks, vis (L,) bool (already ANDed with landmark validity), radius
    (L,) f32, pred_level (L,) int (< 0 disables the octave gate for the row);
    b_xy (K,2), b_level (K,), b_valid (K,) bool.  ``image_size`` (cols,
    rows) sets the extent of the kernel's keypoint grid: any extent gives
    the same result, the camera's keeps each row's search short.
    Returns (idx_b (L,) int32 [-1 unmatched], dist (L,) int32 [LARGE]).
    A batch of B problems of one shape (same L, K and image) carries a
    leading B on every operand and on both results.

    CPU tensors take the plain version (each problem in turn); CUDA tensors
    launch kernel K2 once for the whole batch."""
    dev = a_desc_u32.device
    ops = (a_desc_u32, b_desc_u32, uv, vis, radius, pred_level, b_xy, b_level, b_valid)
    kw = dict(max_dist=max_dist, ratio=ratio, cross_check=cross_check)
    if dev.type == "cpu":
        if a_desc_u32.ndim == 3:
            return projection_scale_match_plain_batch(*ops, **kw)
        return projection_scale_match_plain(*ops, **kw)
    if dev.type != "cuda":
        raise RuntimeError(f"projection_scale_match: unsupported device {dev}")
    args, out, _keep = kernel_args(*ops, **kw, image_size=image_size)
    kernels.check(kernels.library("match")(*args), "projection_scale_match")
    kernels.count_launch("projection_match", args[0])
    return out
