"""Oriented rBRIEF description, gather path (counterpart of the gather path
of ``openvslam_tpu/ops/orb.py``, which is what the JAX package itself runs
off the TPU).

Descriptors are packed as (N,8) int32 words holding the uint32 bit pattern
(PyTorch's uint32 supports few operations): bit j of word i is test
``32*i + j``, the JAX package's order.
"""
from __future__ import annotations

import functools
import os

import numpy as np
import torch
import torch.nn.functional as F

PATCH_RADIUS = 15          # IC-angle patch (31x31)

_ASSET_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets")
_PATTERN_ASSETS = {
    "learned": os.path.join(_ASSET_DIR, "brief_pattern.npy"),
    "cv": os.path.join(_ASSET_DIR, "orb_pattern_cv.npy"),
}


@functools.lru_cache(maxsize=None)
def get_pattern_np(name: str = "learned") -> np.ndarray:
    """(256, 2 points, xy) f32 test pattern by name ("learned" | "cv").
    A missing asset raises."""
    if name not in _PATTERN_ASSETS:
        raise ValueError(f"unknown descriptor pattern {name!r}; valid: {sorted(_PATTERN_ASSETS)}")
    path = _PATTERN_ASSETS[name]
    if not os.path.exists(path):
        raise FileNotFoundError(f"descriptor pattern asset missing: {path}")
    return np.load(path).astype(np.float32)


@functools.lru_cache(maxsize=None)
def get_pattern(name: str, device: torch.device) -> torch.Tensor:
    """The pattern as a tensor on ``device``, uploaded once."""
    return torch.from_numpy(get_pattern_np(name)).to(device)


def _gather_nearest(img: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour sample (round half to even, clamp to the image)."""
    h, w = img.shape
    x = torch.clamp(torch.round(xy[..., 0]).to(torch.int64), 0, w - 1)
    y = torch.clamp(torch.round(xy[..., 1]).to(torch.int64), 0, h - 1)
    return img.reshape(-1)[y * w + x]


def ic_moment_maps(img: torch.Tensor):
    """(H,W) -> (m10, m01) maps over the square 31x31 patch (separable 1-D
    cross-correlations with zero SAME padding).  With TF32 off these integer
    sums are exact on the CPU; the main path uses ``ic_moments_at``."""
    r = PATCH_RADIUS
    ones = torch.ones(2 * r + 1, dtype=img.dtype, device=img.device)
    ramp = torch.arange(-r, r + 1, dtype=img.dtype, device=img.device)
    x = img[None, None]
    col_sum = F.conv2d(x, ones.view(1, 1, -1, 1), padding=(r, 0))
    m10 = F.conv2d(col_sum, ramp.view(1, 1, 1, -1), padding=(0, r))
    row_sum = F.conv2d(x, ones.view(1, 1, 1, -1), padding=(0, r))
    m01 = F.conv2d(row_sum, ramp.view(1, 1, -1, 1), padding=(r, 0))
    return m10[0, 0], m01[0, 0]


def ic_moments_at(img: torch.Tensor, xy: torch.Tensor):
    """The values of ``ic_moment_maps`` at the nearest pixels of xy (N,2),
    from one (N,31,31) patch gather instead of four full-image convolutions.
    Every term is an integer and every sum stays below 2**24, so the result
    equals the maps' values bit for bit in any summation order."""
    h, w = img.shape
    r = PATCH_RADIUS
    x0 = torch.clamp(torch.round(xy[:, 0]).to(torch.int64), 0, w - 1)
    y0 = torch.clamp(torch.round(xy[:, 1]).to(torch.int64), 0, h - 1)
    offs = torch.arange(-r, r + 1, device=img.device)
    ys = y0[:, None, None] + offs[None, :, None]
    xs = x0[:, None, None] + offs[None, None, :]
    inside = (ys >= 0) & (ys < h) & (xs >= 0) & (xs < w)
    patch = torch.where(
        inside, img.reshape(-1)[(ys.clamp(0, h - 1) * w + xs.clamp(0, w - 1))],
        torch.zeros((), dtype=img.dtype, device=img.device))
    ramp = offs.to(img.dtype)
    m10 = (patch.sum(1) * ramp[None, :]).sum(1)
    m01 = (patch.sum(2) * ramp[None, :]).sum(1)
    return m10, m01


def ic_angles(img: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Intensity-centroid orientation at keypoints xy (N,2) -> angles (N,) rad."""
    m10, m01 = ic_moments_at(img, xy)
    return torch.atan2(m01, m10)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(N,256) {0,1} -> (N,8) int32 words holding the packed uint32 patterns
    (the JAX package's ``_pack_bits``; int64 arithmetic, then the bit
    pattern stored as int32)."""
    n = bits.shape[0]
    words = bits.to(torch.int64).reshape(n, 8, 32)
    shifts = torch.arange(32, device=bits.device)
    v = torch.sum(words << shifts, dim=-1)
    return torch.where(v >= 2**31, v - 2**32, v).to(torch.int32)


def unpack_bits_i8(packed: torch.Tensor) -> torch.Tensor:
    """(N,8) packed words (int32 or uint32 pattern) -> (N,256) int8 in {0,1}."""
    shifts = torch.arange(32, device=packed.device)
    bits = ((packed.to(torch.int64) & 0xFFFFFFFF)[..., None] >> shifts) & 1
    return bits.reshape(packed.shape[0], -1).to(torch.int8)


def brief_descriptors_gather(img_blurred: torch.Tensor, xy: torch.Tensor,
                             angles: torch.Tensor, pattern_name: str = "learned") -> torch.Tensor:
    """Steered BRIEF via direct image gathers (512 point loads / keypoint)."""
    pat = get_pattern(pattern_name, img_blurred.device)
    c = torch.cos(angles)[:, None, None]
    s = torch.sin(angles)[:, None, None]
    px = pat[None, :, :, 0]
    py = pat[None, :, :, 1]
    pts = torch.stack([c * px - s * py, s * px + c * py], -1) + xy[:, None, None, :]
    vals = _gather_nearest(img_blurred, pts)                   # (N,256,2)
    return pack_bits(vals[..., 0] < vals[..., 1])
