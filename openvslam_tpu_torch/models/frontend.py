"""ORB front end (counterpart of ``openvslam_tpu/models/frontend.py``).

One ``extract`` call takes an (H,W) u8 image and returns a fixed-capacity
keypoint structure of arrays:

    xy        (K,2) f32   keypoint position at level-0 scale
    response  (K,)  f32
    level     (K,)  i64
    angle     (K,)  f32
    desc_u32  (K,8) i32   packed rBRIEF (uint32 bit patterns)
    valid     (K,)  bool

``extract_batch`` takes B frames (B,H,W) of one geometry and returns the
same fields with a leading B, each frame's bit for bit ``extract``'s: the
pyramid, blur, IC angles and rBRIEF run over the batch in elementwise
steps and gathers, and kernel K1 runs once for all levels of all frames.

Invalid slots keep their (meaningless) positions, as in the JAX package;
their descriptors are zeroed.  The unpacked int8 bits are not produced:
the matcher (kernel K2) reads the packed words.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ..device import resolve_device
from ..ops import fast, orb, pyramid


class Keypoints(NamedTuple):
    xy: torch.Tensor
    response: torch.Tensor
    level: torch.Tensor
    angle: torch.Tensor
    desc_u32: torch.Tensor
    valid: torch.Tensor

    @property
    def capacity(self):
        return self.xy.shape[-2]


def level_budgets(max_keypts: int, num_levels: int, scale: float):
    f = 1.0 / scale
    raw = [max_keypts * (1 - f) / (1 - f**num_levels) * f**l for l in range(num_levels)]
    budget = [max(16, int(round(v))) for v in raw]
    return [((b + 7) // 8) * 8 for b in budget]


class OrbFrontend:
    """Configured extractor for one image geometry on one device."""

    def __init__(self, rows: int, cols: int, max_keypts: int = 2048,
                 num_levels: int = 8, scale_factor: float = 1.2,
                 ini_fast_thr: float = 20.0, min_fast_thr: float = 7.0,
                 cell: int = 32, pattern: str = "learned", device="cuda"):
        self.device = resolve_device(device)
        self.rows, self.cols = rows, cols
        self.pattern = pattern
        orb.get_pattern_np(pattern)          # a missing asset raises here
        self.num_levels = num_levels
        self.scale_factor = scale_factor
        self.ini_fast_thr = ini_fast_thr
        self.min_fast_thr = min_fast_thr
        self.cell = cell
        self.budgets = level_budgets(max_keypts, num_levels, scale_factor)
        self.capacity = sum(self.budgets)
        self.scales = pyramid.scale_factors(num_levels, scale_factor)
        self._level = torch.cat([torch.full((b,), l, dtype=torch.int64)
                                 for l, b in enumerate(self.budgets)]).to(self.device)

    def extract(self, image_u8: torch.Tensor, mask: torch.Tensor | None = None) -> Keypoints:
        """(H,W) u8 (and an optional (H,W) mask, > 0 = usable) -> Keypoints."""
        return self._extract(image_u8, mask)

    def extract_batch(self, images_u8: torch.Tensor,
                      masks: torch.Tensor | None = None) -> Keypoints:
        """(B,H,W) u8 (and optional (B,H,W) masks) -> Keypoints with a
        leading batch axis, equal per frame to ``extract``."""
        if torch.as_tensor(images_u8).ndim != 3:
            raise ValueError("extract_batch takes (B,H,W) images")
        return self._extract(images_u8, masks)

    def _extract(self, image_u8, mask) -> Keypoints:
        """One frame (H,W) or a batch (B,H,W): the same steps over the
        trailing two axes."""
        img = torch.as_tensor(image_u8, device=self.device).to(torch.float32)
        levels = pyramid.build_pyramid(img, self.num_levels, self.scale_factor)
        lvl_masks = None
        if mask is not None:
            m = torch.as_tensor(mask, device=self.device)
            lvl_masks = [pyramid.resize_nearest(m, tuple(lv.shape[-2:])) for lv in levels]
        dets = fast.detect_levels(levels, self.ini_fast_thr, self.min_fast_thr,
                                  self.budgets, cell=self.cell, masks=lvl_masks)
        xs, rs, ans, descs, vs = [], [], [], [], []
        for l, lvl_img in enumerate(levels):
            xy, resp, valid = dets[l]
            blurred = pyramid.gaussian_blur(lvl_img)
            ang = orb.ic_angles(lvl_img, xy)
            descs.append(orb.brief_descriptors_gather(blurred, xy, ang, self.pattern))
            ans.append(ang)
            xs.append(xy * self.scales[l])
            rs.append(resp)
            vs.append(valid)
        cat = functools.partial(torch.cat, dim=img.ndim - 2)     # the keypoint axis
        valid = cat(vs)
        d32 = torch.where(valid[..., None], cat(descs), torch.zeros((), dtype=torch.int32,
                                                                     device=self.device))
        level = self._level.expand(*img.shape[:-2], -1)
        return Keypoints(cat(xs), cat(rs), level, cat(ans), d32, valid)
