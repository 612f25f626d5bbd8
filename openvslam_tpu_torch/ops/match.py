"""Projection-gated Hamming matching (counterpart of ``openvslam_tpu/ops/match.py``).

``projection_scale_match`` is the guided-search matcher of the tracking
step.  CUDA tensors go to kernel K2 (``csrc/match.cu``); CPU tensors go to
the plain version, the gate + ``match_descriptors`` composition, which
computes the full (L,K) Hamming matrix.  Both give the same ``idx`` and
``dist``, ties included: row minima take the lowest keypoint index, the
cross-check's column minima the lowest landmark row.

Descriptors are packed (N,8) int32 words (see ``ops/orb.py``).
"""
from __future__ import annotations

import torch

from .. import kernels
from .orb import unpack_bits_i8

LARGE = 1 << 20

HAMMING_DIST_THR_LOW = 30
HAMMING_DIST_THR_HIGH = 50


def hamming_matrix(bits_a: torch.Tensor, bits_b: torch.Tensor) -> torch.Tensor:
    """(N,256)/(M,256) {0,1} -> (N,M) int32 Hamming distances, as
    popcnt(a) + popcnt(b) - 2 a.b (an f32 product: exact, TF32 is off)."""
    a = bits_a.to(torch.float32)
    b = bits_b.to(torch.float32)
    dots = (a @ b.T).to(torch.int32)
    return a.sum(-1).to(torch.int32)[:, None] + b.sum(-1).to(torch.int32)[None, :] - 2 * dots


def top2(dist: torch.Tensor):
    """Per-row best & second-best: (best_idx, best_d, second_d); the best
    index is the lowest among ties (argmin takes the first occurrence)."""
    best_idx = torch.argmin(dist, dim=1)
    best_d = torch.gather(dist, 1, best_idx[:, None])[:, 0]
    cols = torch.arange(dist.shape[1], device=dist.device)
    rest = torch.where(cols[None, :] == best_idx[:, None], torch.iinfo(torch.int32).max, dist)
    return best_idx, best_d, rest.amin(dim=1)


def match_descriptors(bits_a, bits_b, valid_a, valid_b, gate=None,
                      max_dist: int = HAMMING_DIST_THR_LOW, ratio=0.9,
                      cross_check: bool = True):
    """Generic gated matcher.  Returns (idx_b (N,) int32 [-1 unmatched],
    dist (N,) int32 [LARGE unmatched])."""
    d = hamming_matrix(bits_a, bits_b)
    allowed = valid_a[:, None] & valid_b[None, :]
    if gate is not None:
        allowed = allowed & gate
    d = torch.where(allowed, d, LARGE)
    best_idx, best_d, second_d = top2(d)
    ok = best_d <= max_dist
    if ratio is not None:
        ok = ok & (best_d.to(torch.float32) <= ratio * second_d.to(torch.float32))
    if cross_check:
        col_best = torch.argmin(d, dim=0)
        ok = ok & (col_best[best_idx] == torch.arange(d.shape[0], device=d.device))
    return (torch.where(ok, best_idx.to(torch.int32), -1),
            torch.where(ok, best_d, LARGE))


def projection_gate(proj_uv, proj_valid, xy_b, radius):
    """Keypoint b must lie strictly within ``radius`` (per row) of the
    projected position of landmark a."""
    dx = proj_uv[:, None, 0] - xy_b[None, :, 0]
    dy = proj_uv[:, None, 1] - xy_b[None, :, 1]
    d2 = dx * dx + dy * dy
    return proj_valid[:, None] & (d2 < (radius * radius)[:, None])


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


def projection_scale_match(a_desc_u32, b_desc_u32, uv, vis, radius, pred_level,
                           b_xy, b_level, b_valid,
                           max_dist: int = HAMMING_DIST_THR_HIGH,
                           ratio=None, cross_check: bool = True):
    """Projection-radius + octave gated matcher: landmarks a (L rows) against
    keypoints b (K columns).

    a_desc_u32 (L,8) / b_desc_u32 (K,8) packed int32; uv (L,2) projected
    landmarks, vis (L,) bool (already ANDed with landmark validity), radius
    (L,) f32, pred_level (L,) int (< 0 disables the octave gate for the row);
    b_xy (K,2), b_level (K,), b_valid (K,) bool.
    Returns (idx_b (L,) int32 [-1 unmatched], dist (L,) int32 [LARGE]).

    CPU tensors take the plain version; CUDA tensors launch kernel K2."""
    dev = a_desc_u32.device
    if dev.type == "cpu":
        return projection_scale_match_plain(
            a_desc_u32, b_desc_u32, uv, vis, radius, pred_level, b_xy, b_level, b_valid,
            max_dist=max_dist, ratio=ratio, cross_check=cross_check)
    if dev.type != "cuda":
        raise RuntimeError(f"projection_scale_match: unsupported device {dev}")
    L, K = a_desc_u32.shape[0], b_desc_u32.shape[0]
    if K < 2:
        raise ValueError("projection_scale_match needs at least two keypoints")
    if not (0 <= max_dist < 1023):
        raise ValueError("max_dist must lie in [0, 1023)")
    col_mul, row_mul = _next_pow2(max(K, 2)), _next_pow2(max(L, 2))
    if col_mul * 1024 >= 2**31 or row_mul * 1024 >= 2**31:
        raise ValueError(f"too many landmarks/keypoints for packed minima: L={L}, K={K}")
    i32, f32 = torch.int32, torch.float32

    def arg(t, dtype, shape):
        t = t.to(device=dev, dtype=dtype).contiguous()
        if tuple(t.shape) != shape:
            raise ValueError(f"expected shape {shape}, got {tuple(t.shape)}")
        return t

    a_desc = arg(a_desc_u32, i32, (L, 8))
    b_desc = arg(b_desc_u32, i32, (K, 8))
    a_uv = arg(uv, f32, (L, 2))
    a_vis = arg(vis, torch.bool, (L,))
    r = arg(radius, f32, (L,))
    a_r2 = r * r
    a_pred = arg(pred_level, i32, (L,))
    bxy = arg(b_xy, f32, (K, 2))
    blvl = arg(b_level, i32, (K,))
    bval = arg(b_valid, torch.bool, (K,))
    row_best = torch.empty(L, dtype=i32, device=dev)
    row_second = torch.empty(L, dtype=i32, device=dev)
    col_min = torch.full((K,), torch.iinfo(i32).max, dtype=i32, device=dev)
    idx = torch.empty(L, dtype=i32, device=dev)
    dist = torch.empty(L, dtype=i32, device=dev)
    fn = kernels.library("match")
    kernels.check(fn(a_desc.data_ptr(), b_desc.data_ptr(), a_uv.data_ptr(), a_vis.data_ptr(),
                     a_r2.data_ptr(), a_pred.data_ptr(), bxy.data_ptr(), blvl.data_ptr(),
                     bval.data_ptr(), L, K, col_mul, row_mul, int(max_dist),
                     -1.0 if ratio is None else float(ratio), int(bool(cross_check)),
                     row_best.data_ptr(), row_second.data_ptr(), col_min.data_ptr(),
                     idx.data_ptr(), dist.data_ptr(), kernels.stream_ptr(dev)),
                  "projection_scale_match")
    kernels.LAUNCHES["projection_match"] += 1
    return idx, dist
