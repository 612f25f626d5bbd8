"""Image pyramid + Gaussian blur (counterpart of ``openvslam_tpu/ops/pyramid.py``).

Levels are integer-valued float32 (rounded to the 0..255 grid), each
resized from the previous one with the antialiased linear
scale-and-translate of ``jax.image.resize``.

``torch.nn.functional.interpolate(..., antialias=True)`` is a different
filter and lands on other integers, so the resize is rebuilt from the JAX
definition: the same triangle kernel widened by the inverse scale, the same
per-column weight normalisation, rows contracted before columns.  The
sample position ``(i + 0.5) * inv_scale - 0.5`` is one fused multiply-add
and the division by the kernel scale a reciprocal multiply (weights, in
numpy at construction time), as XLA:CPU compiles them.  Each output is a
chain of fused multiply-adds over its taps in ascending input order; a
fused multiply-add of float32 operands is emulated exactly in float64 (the
product is exact there) and rounded once, so the CPU and the GPU give the
same bits.

That order is one choice, not XLA's: the reference's own floats depend on
how XLA:CPU lays out its dot (resizing the transposed image and
transposing back changes about a quarter of the pre-round values, see
tests/test_torch_frontend.py test_reference_resize_depends_on_layout), so
no fixed order reproduces them.  The levels match JAX's except at a few
near-half values (a few pixels of 950k at 640x480), stated by the tests.
"""
from __future__ import annotations

import functools
from typing import List, Tuple

import numpy as np
import torch

_F32 = np.float32


def level_shapes(h: int, w: int, num_levels: int, scale: float) -> List[Tuple[int, int]]:
    return [
        (max(8, int(round(h / scale**l))), max(8, int(round(w / scale**l))))
        for l in range(num_levels)
    ]


def scale_factors(num_levels: int, scale: float):
    return [scale**l for l in range(num_levels)]


def _fma32(a, b, c):
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(_F32)


@functools.lru_cache(maxsize=None)
def _resize_taps(m: int, n: int):
    """Nonzero weights of the (m -> n) antialiased triangle resize, as
    (idx (n,T) int64, w (n,T) float32) in ascending input order (pads carry
    weight 0 at index 0)."""
    inv = _F32(1.0 / (n / m))
    kscale = max(inv, _F32(1.0))
    sample = _fma32(np.arange(n, dtype=_F32) + _F32(0.5), inv, _F32(-0.5))
    dist = np.abs(sample[None, :] - np.arange(m, dtype=_F32)[:, None])
    w = np.maximum(_F32(0.0), _F32(1.0) - dist * (_F32(1.0) / kscale))
    tot = w.sum(0, keepdims=True, dtype=_F32)
    den = np.where(tot != 0, tot, _F32(1.0))
    w = np.where(np.abs(tot) > _F32(1000.0 * np.finfo(np.float32).eps), w / den, _F32(0.0))
    inside = (sample >= -0.5) & (sample <= m - 0.5)
    w = np.where(inside[None, :], w, _F32(0.0)).astype(_F32)      # (m, n)
    taps = max(1, int((w != 0).sum(0).max()))
    idx = np.zeros((n, taps), np.int64)
    wt = np.zeros((n, taps), _F32)
    for o in range(n):
        nz = np.nonzero(w[:, o])[0]
        idx[o, :len(nz)] = nz
        wt[o, :len(nz)] = w[nz, o]
    return idx, wt


@functools.lru_cache(maxsize=None)
def _device_taps(m: int, n: int, device: torch.device):
    """``_resize_taps`` on ``device``, uploaded once (no copy per frame)."""
    idx, w = _resize_taps(m, n)
    return (torch.from_numpy(idx).to(device),
            torch.from_numpy(w).to(device=device, dtype=torch.float64))


def _contract(x: torch.Tensor, m: int, n: int, dim: int) -> torch.Tensor:
    """Resize axis ``dim`` of x from m to n samples: an f32 fused-multiply-add
    chain over the taps, emulated exactly in float64."""
    idx, w = _device_taps(m, n, x.device)
    shape = [1] * x.ndim
    shape[dim] = n
    acc = torch.zeros(x.shape[:dim] + (n,) + x.shape[dim + 1:],
                      dtype=torch.float32, device=x.device)
    for t in range(idx.shape[1]):
        g = x.index_select(dim, idx[:, t]).to(torch.float64)
        acc = (w[:, t].reshape(shape) * g + acc.to(torch.float64)).to(torch.float32)
    return acc


def resize_linear_antialias(img: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """(..., H, W) f32 -> (..., h, w): ``jax.image.resize(method="linear",
    antialias=True, precision=HIGHEST)``, rows first."""
    h0, w0 = img.shape[-2:]
    h1, w1 = out_hw
    x = _contract(img, h0, h1, img.ndim - 2) if h1 != h0 else img
    return _contract(x, w0, w1, img.ndim - 1) if w1 != w0 else x


def quantize_u8_grid(img: torch.Tensor) -> torch.Tensor:
    """Round to the integer 0..255 grid, staying f32 (cv2 u8 semantics)."""
    return torch.clamp(torch.round(img), 0.0, 255.0)


def build_pyramid(img: torch.Tensor, num_levels: int, scale: float):
    """(H,W) f32 -> list of (Hl,Wl) integer-valued f32 levels, each resized
    from the previous one."""
    h, w = img.shape
    shapes = level_shapes(h, w, num_levels, scale)
    levels = [img]
    for l in range(1, num_levels):
        levels.append(quantize_u8_grid(resize_linear_antialias(levels[-1], shapes[l])))
    return levels


def resize_nearest(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """``jax.image.resize(method="nearest")`` for a 2-D map: source index
    floor((i + 0.5) * m / n), where XLA folds ``* m / n`` into one f32
    constant m * (1/n) (each step rounded to f32)."""
    for d, n in zip((0, 1), out_hw):
        m = x.shape[d]
        if m == n:
            continue
        ratio = float(_F32(m) * (_F32(1.0) / _F32(n)))       # exact in f32
        pos = (torch.arange(n, dtype=torch.float32, device=x.device) + 0.5) * ratio
        x = x.index_select(d, torch.floor(pos).to(torch.int64))
    return x


@functools.lru_cache(maxsize=None)
def _gaussian_taps(ksize: int, sigma: float) -> Tuple[float, ...]:
    kk = np.exp(-0.5 * ((np.arange(ksize) - ksize // 2) / sigma) ** 2)
    return tuple(float(v) for v in (kk / kk.sum()).astype(np.float32))


def _blur_axis(x: torch.Tensor, taps, dim: int) -> torch.Tensor:
    r = len(taps) // 2
    n = x.shape[dim]
    first = x.narrow(dim, 0, 1).expand(*[r if d == dim else -1 for d in range(x.ndim)])
    last = x.narrow(dim, n - 1, 1).expand(*[r if d == dim else -1 for d in range(x.ndim)])
    xp = torch.cat([first, x, last], dim)
    # XLA:CPU fuses the shift-and-add into a multiply-add chain; emulate it
    # exactly in float64 (see the module docstring)
    acc = taps[0] * xp.narrow(dim, 0, n)
    for i in range(1, len(taps)):
        acc = (taps[i] * xp.narrow(dim, i, n).to(torch.float64)
               + acc.to(torch.float64)).to(torch.float32)
    return acc


def gaussian_blur(img: torch.Tensor, ksize: int = 7, sigma: float = 2.0) -> torch.Tensor:
    """Separable Gaussian blur with replicate padding (cv::GaussianBlur(7,7,2)),
    rounded back to the integer grid like cv::GaussianBlur on u8."""
    taps = _gaussian_taps(ksize, sigma)
    return quantize_u8_grid(_blur_axis(_blur_axis(img, taps, 0), taps, 1))
