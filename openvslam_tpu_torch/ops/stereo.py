"""Per-keypoint right u and depth of stereo and RGB-D frames: matching on
rectified pairs (counterpart of ``openvslam_tpu/ops/stereo.py``; ref
``match/stereo``) and sampling a registered depth map.

``stereo_match_dense`` is the one the System runs: each left keypoint
against the right image by zero-mean SAD over a patch at every integer
disparity, a uniqueness ratio and parabolic subpixel refinement, batched
as one (K, D, h, w) gather on the device.  ``stereo_match`` matches left
keypoints against right-image keypoints by descriptor inside the epipolar
band.  Both are plain PyTorch, as they are plain JAX in the reference.
"""
from __future__ import annotations

import torch

from . import match as M


def stereo_match(desc_l, xy_l, valid_l, level_l, desc_r, xy_r, valid_r, level_r,
                 focal_x_baseline: float, min_disparity: float = 0.5,
                 max_disparity: float = 1e4, row_tol: float = 2.0,
                 max_dist: int = M.HAMMING_DIST_THR_LOW):
    """Descriptor (unpacked bits) match inside the epipolar band.  Returns
    (x_right (K,), depth (K,)) per left keypoint; -1 where unmatched."""
    row_gate = torch.abs(xy_l[:, None, 1] - xy_r[None, :, 1]) <= row_tol
    disp = xy_l[:, None, 0] - xy_r[None, :, 0]
    gate = (row_gate & (disp >= min_disparity) & (disp <= max_disparity)
            & (torch.abs(level_l[:, None] - level_r[None, :]) <= 1))
    idx, _ = M.match_descriptors(desc_l, desc_r, valid_l, valid_r, gate=gate,
                                 max_dist=max_dist, ratio=0.95, cross_check=True)
    matched = idx >= 0
    xr = torch.where(matched, xy_r[torch.clamp(idx, min=0).to(torch.int64), 0], -1.0)
    d = torch.where(matched, xy_l[:, 0] - xr, -1.0)
    depth = torch.where(matched & (d > 1e-6), focal_x_baseline / torch.clamp(d, min=1e-6), -1.0)
    ok = matched & (depth > 0)
    return torch.where(ok, xr, -1.0), torch.where(ok, depth, -1.0)


def stereo_match_dense(img_l, img_r, xy, valid, focal_x_baseline: float,
                       max_disp: int = 96, half_w: int = 5, half_h: int = 2,
                       max_cost: float = 18.0, uniq_ratio: float = 0.88):
    """Match each left keypoint ``xy`` (K,2) against the right image by
    zero-mean SAD over a (2 half_h + 1) x (2 half_w + 1) patch at every
    integer disparity in [1, max_disp], with parabolic subpixel refinement
    (the reference's ``match::stereo`` SAD scheme).  A match must cost at
    most ``max_cost`` and at most ``uniq_ratio`` times the best disparity
    more than 1 px away.  Returns (x_right (K,), depth (K,)); -1 where
    unmatched."""
    H, W = img_l.shape
    dev = xy.device
    il = img_l.to(torch.float32)
    ir = img_r.to(torch.float32)
    u = torch.clamp(torch.round(xy[:, 0]).to(torch.int64), 0, W - 1)
    v = torch.clamp(torch.round(xy[:, 1]).to(torch.int64), 0, H - 1)
    dy = torch.arange(-half_h, half_h + 1, device=dev)
    dx = torch.arange(-half_w, half_w + 1, device=dev)
    rows = torch.clamp(v[:, None] + dy[None, :], 0, H - 1)                   # (K,h)
    cols_l = torch.clamp(u[:, None] + dx[None, :], 0, W - 1)                 # (K,w)
    patch_l = il[rows[:, :, None], cols_l[:, None, :]]                       # (K,h,w)
    zl = patch_l - patch_l.mean(dim=(1, 2), keepdim=True)
    dvals = torch.arange(1, max_disp + 1, device=dev)                        # (D,)
    cols_r = u[:, None, None] - dvals[None, :, None] + dx[None, None, :]     # (K,D,w)
    in_img = cols_r[:, :, 0] >= 0                                            # (K,D)
    patch_r = ir[rows[:, None, :, None], torch.clamp(cols_r, 0, W - 1)[:, :, None, :]]
    zr = patch_r - patch_r.mean(dim=(2, 3), keepdim=True)                    # (K,D,h,w)
    cost = torch.abs(zl[:, None] - zr).mean(dim=(2, 3))                      # (K,D)
    cost = torch.where(in_img, cost, torch.inf)
    best = torch.argmin(cost, dim=1)                                         # (K,)
    c0 = cost.gather(1, best[:, None])[:, 0]
    # uniqueness: the best must beat every disparity more than 1 px away
    far = torch.abs(dvals[None, :] - dvals[best][:, None]) > 1
    c2nd = torch.where(far, cost, torch.inf).amin(dim=1)
    # parabola through the best integer disparity and its neighbours
    cl = cost.gather(1, torch.clamp(best - 1, 0, max_disp - 1)[:, None])[:, 0]
    cr = cost.gather(1, torch.clamp(best + 1, 0, max_disp - 1)[:, None])[:, 0]
    denom = cl + cr - 2 * c0
    offs = torch.where((denom > 1e-6) & torch.isfinite(cl) & torch.isfinite(cr),
                       torch.clamp(0.5 * (cl - cr) / torch.clamp(denom, min=1e-6), -0.5, 0.5),
                       0.0)
    disp = dvals[best].to(torch.float32) + offs
    ok = (valid & torch.isfinite(c0) & (c0 <= max_cost) & (c0 <= uniq_ratio * c2nd)
          & (disp >= 1.0))
    xr = torch.where(ok, xy[:, 0] - disp, -1.0)
    depth = torch.where(ok, focal_x_baseline / torch.clamp(disp, min=1e-6), -1.0)
    return xr, depth


def depth_at_keypoints(z_map, xy, und, valid, focal_x_baseline: float):
    """RGB-D: the metric depth map ``z_map`` (H,W) at each keypoint's
    nearest pixel, and a virtual right u = undistorted u - focal_x_baseline
    / depth, which is what the stereo residual predicts (the JAX package
    subtracts from the raw u).  Returns (x_right (K,), depth (K,)); -1 where
    the keypoint is invalid or the depth is missing (<= 1 mm) or not finite."""
    H, W = z_map.shape
    u = torch.clamp(torch.round(xy[:, 0]).to(torch.int64), 0, W - 1)
    v = torch.clamp(torch.round(xy[:, 1]).to(torch.int64), 0, H - 1)
    z = z_map[v, u]
    ok = (z > 1e-3) & torch.isfinite(z) & valid
    return (torch.where(ok, und[:, 0] - focal_x_baseline / torch.clamp(z, min=1e-6), -1.0),
            torch.where(ok, z, -1.0))
