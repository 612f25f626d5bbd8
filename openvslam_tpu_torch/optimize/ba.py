"""Bundle adjustment (counterpart of ``openvslam_tpu/optimize/ba.py``): the
local BA with a dense Schur complement (ref g2o's
``optimize/local_bundle_adjuster``: local KFs + landmarks + fixed observer
KFs, LM 5 iterations, outlier removal, 10 more) and the matrix-free global
BA (``make_global_ba``, PCG over the reduced camera system).

* The problem is a fixed-capacity SoA (cams C, landmarks L, observations O)
  with validity masks.
* Jacobians are the analytic Dx6 (left increment [omega, upsilon]) and Dx3
  blocks of the edge: the pinhole edge of perspective and fisheye cameras,
  mono (D = 2, (u, v) observations) or stereo (D = 3, (u, v, u_right),
  u_right < 0 marking a mono observation whose third row is masked); the
  equirectangular edge (D = 2, lon/lat pixels, the u residual wrapped
  across the seam); with ``multicam`` the multi-camera edge, whose
  intrinsics ride in each observation ((O, 2 + CAMV_DIM) observations).
  ``tests/test_torch_mapping.py``, ``tests/test_torch_stereo.py`` and
  ``tests/test_torch_fisheye_equirect.py`` hold them against
  ``torch.func.jacfwd`` of the residual.
* Per-observation blocks are summed per camera and per landmark in one
  fixed order on every device (``segment_sum``): a run on the card
  repeats, and card and CPU agree to rounding.
* Landmark blocks are 3x3, eliminated in parallel (batched inverse); the
  reduced camera system S (6C x 6C) is ONE matmul, S = blkdiag(Hcc) - Y W^T
  over the dense (L,C,6,3) cross-block tensor.
* The 5 + 10 iterations are a Python loop whose accept decision and damping
  stay 0-d tensors (``torch.where``), and the solves are the ``_ex`` forms:
  past the sums' grid widths, read once before the iterations, nothing
  reads a value back to the host until the caller does.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import residuals as R
from .segment_sum import segment_sums

_EPS = 1e-9


class BAProblem(NamedTuple):
    """Fixed-capacity bundle adjustment problem (padded; see masks)."""
    T_cw: torch.Tensor       # (C,4,4) camera poses (world->cam)
    cam_opt: torch.Tensor    # (C,) bool: optimize this camera (False = fixed/pad)
    cam_valid: torch.Tensor  # (C,) bool: camera slot is real
    X: torch.Tensor          # (L,3) landmark positions
    lm_valid: torch.Tensor   # (L,) bool
    obs_cam: torch.Tensor    # (O,) int camera index
    obs_lm: torch.Tensor     # (O,) int landmark index
    obs_uv: torch.Tensor     # (O,2) mono or (O,3) stereo observations (undistorted pixels)
    obs_sigma2: torch.Tensor # (O,) variance (scale^2 of the octave)
    obs_mask: torch.Tensor   # (O,) bool

    def to(self, device) -> "BAProblem":
        return BAProblem(*(t.to(device) for t in self))


class BAResult(NamedTuple):
    T_cw: torch.Tensor
    X: torch.Tensor
    obs_inlier: torch.Tensor
    cost: torch.Tensor


def _rho(c2, thr):
    """Huber robust cost."""
    return torch.where(c2 <= thr, c2, 2.0 * torch.sqrt(thr * torch.clamp(c2, min=0.0)) - thr)


def reprojection_residuals(cam, T_cw, X, obs_cam, obs_lm, obs_uv, multicam: bool = False):
    """Residuals obs - proj(T X) of every observation: (r (O,D), ok (O,),
    camera-frame points (O,3)).  With D = 3 the third component is the
    right-image u, zero where the observation's u_right < 0; with
    ``multicam`` each observation carries its camera (``cam`` unused)."""
    Tc = T_cw[obs_cam]
    xc = torch.einsum("oij,oj->oi", Tc[:, :3, :3], X[obs_lm]) + Tc[:, :3, 3]
    if multicam:
        r, ok = R.multicam_edge(xc, obs_uv)
    elif obs_uv.shape[-1] == 3:
        r, ok = R.stereo_edge(cam, xc, obs_uv)
    else:
        r, ok = R.mono_edge(cam, xc, obs_uv)
    return r, ok, xc


def _pinhole_rows(fx, fy, x, y, z):
    """d(u, v)/d(xc) of the pinhole projection, (O,2,3)."""
    zero = torch.zeros_like(z)
    return torch.stack([torch.stack([fx / z, zero, -fx * x / (z * z)], -1),
                        torch.stack([zero, fy / z, -fy * y / (z * z)], -1)], -2)


def reprojection_residuals_and_jacobians(cam, T_cw, X, obs_cam, obs_lm, obs_uv,
                                         multicam: bool = False):
    """Residuals (O,D), ok (O,), and their Jacobians with respect to the
    left increment exp(xi) T of the observing camera (O,D,6) and to the
    landmark position (O,D,3); zero where the observation is not ok (and,
    for D = 3, in the masked third row)."""
    r, ok, xc = reprojection_residuals(cam, T_cw, X, obs_cam, obs_lm, obs_uv, multicam)
    x, y = xc[:, 0], xc[:, 1]
    z = torch.where(xc[:, 2] > _EPS, xc[:, 2], torch.ones_like(xc[:, 2]))
    # d(prediction)/d(xc); the residual's Jacobian is its negative
    if multicam:
        fx, fy, _, _, cols, rows, is_eq = obs_uv[:, 2:9].unbind(-1)
        P = torch.where((is_eq > 0.5)[:, None, None], R.equirect_uv_jacobian(xc, cols, rows),
                        _pinhole_rows(fx, fy, x, y, z))
    elif cam.model_name == "equirectangular":
        P = R.equirect_uv_jacobian(xc, cam.cols, cam.rows)
    else:
        P = _pinhole_rows(cam.fx, cam.fy, x, y, z)
        if obs_uv.shape[-1] == 3:
            # u_right = u - fxb / z
            zero = torch.zeros_like(z)
            ur = torch.stack([cam.fx / z, zero, (cam.focal_x_baseline - cam.fx * x) / (z * z)], -1)
            P = torch.cat([P, (ur * (obs_uv[:, 2] >= 0)[:, None])[:, None]], -2)
    P = P * ok[:, None, None]
    # d(exp(xi) xc)/d(xi) at 0 = [-hat(xc) | I]
    Jc = torch.cat([P @ _hat(xc), -P], -1)
    Jl = -P @ T_cw[obs_cam][:, :3, :3]
    return r, ok, Jc, Jl


def _hat(w):
    x, y, z = w[..., 0], w[..., 1], w[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack([torch.stack([zero, -z, y], -1), torch.stack([z, zero, -x], -1),
                        torch.stack([-y, x, zero], -1)], -2)


def make_local_ba(cam, first_iters: int = 5, second_iters: int = 10, stereo: bool = False,
                  multicam: bool = False):
    """Dense-Schur local BA: mono edges of ``cam``, (with ``stereo``) stereo
    edges over (O,3) observations, or (with ``multicam``; ``cam`` may be
    None) the multi-camera edge over (O, 2 + CAMV_DIM) observations.
    Returns fn(problem: BAProblem) -> BAResult on the problem's device, with
    the reference's two-phase schedule: ``first_iters`` LM iterations,
    outlier rejection (observations beyond the chi2 gate are dropped),
    ``second_iters`` more."""
    chi2_thr = R.CHI2_3D if stereo and not multicam else R.CHI2_2D

    def lm_phase(p: BAProblem, active: torch.Tensor, iters: int, sums):
        dev, dt = p.T_cw.device, p.T_cw.dtype
        C, L = p.T_cw.shape[0], p.X.shape[0]
        oc, ol = p.obs_cam.to(torch.int64), p.obs_lm.to(torch.int64)
        sum_c, sum_l, sum_cl = sums
        inv_s2 = 1.0 / torch.clamp(p.obs_sigma2, min=1e-12)
        obs_ok_static = active & p.obs_mask & p.cam_valid[oc] & p.lm_valid[ol]
        cam_free = p.cam_opt & p.cam_valid
        m6 = cam_free.repeat_interleave(6).to(dt)
        eyec = torch.eye(6, dtype=dt, device=dev)
        eyel = torch.eye(3, dtype=dt, device=dev)
        diag = torch.arange(C, device=dev)

        def cost_of(T, X):
            r, ok, _ = reprojection_residuals(cam, T, X, oc, ol, p.obs_uv, multicam)
            c2 = (r * r).sum(-1) * inv_s2
            w = (obs_ok_static & ok).to(dt)
            return (_rho(c2, chi2_thr) * w).sum(), c2, ok

        T, X = p.T_cw, p.X
        lam = torch.tensor(1e-4, dtype=dt, device=dev)
        cost = torch.zeros((), dtype=dt, device=dev)
        for _ in range(iters):
            r, ok, Jc, Jl = reprojection_residuals_and_jacobians(cam, T, X, oc, ol, p.obs_uv,
                                                                   multicam)
            c2 = (r * r).sum(-1) * inv_s2
            w = R.huber_weight(c2, chi2_thr) * inv_s2 * (obs_ok_static & ok).to(dt)
            # fixed cameras keep their Jacobians out of the system (they
            # still constrain the landmarks)
            Jc = Jc * cam_free[oc][:, None, None]
            Hcc = sum_c(torch.einsum("odi,odj,o->oij", Jc, Jc, w))
            Hll = sum_l(torch.einsum("odi,odj,o->oij", Jl, Jl, w))
            gc = sum_c(torch.einsum("odi,od,o->oi", Jc, r, w))
            gl = sum_l(torch.einsum("odi,od,o->oi", Jl, r, w))
            Wt = sum_cl(torch.einsum("odi,odj,o->oij", Jc, Jl, w)).view(L, C, 6, 3)
            # damping (LM, multiplicative on block diagonals)
            Hcc_d = Hcc + lam * Hcc * eyec + 1e-8 * eyec
            Hll_d = Hll + lam * Hll * eyel + 1e-8 * eyel
            Hll_d = torch.where(p.lm_valid[:, None, None], Hll_d, eyel)
            Hll_inv = torch.linalg.inv_ex(Hll_d).inverse

            Y = torch.einsum("lcik,lkm->lcim", Wt, Hll_inv)
            Yr = Y.permute(1, 2, 0, 3).reshape(C * 6, L * 3)
            Wr = Wt.permute(1, 2, 0, 3).reshape(C * 6, L * 3)
            S = -(Yr @ Wr.T)
            S4 = S.view(C, 6, C, 6)
            S4[diag, :, diag, :] += Hcc_d
            v = (-gc + torch.einsum("lcim,lm->ci", Y, gl)).reshape(C * 6)
            # mask fixed/invalid cameras out of the system
            S = S * m6[:, None] * m6[None, :] + torch.diag(1.0 - m6)
            dxc = torch.linalg.solve_ex(S, v * m6).result.reshape(C, 6)
            dxl = -torch.einsum("lkm,lm->lk", Hll_inv,
                                gl + torch.einsum("lcik,ci->lk", Wt, dxc))
            dxl = dxl * p.lm_valid[:, None]

            T_new = R.perturb_pose(dxc * cam_free[:, None], T)
            X_new = X + dxl
            cost_new, _, _ = cost_of(T_new, X_new)
            cost_old, _, _ = cost_of(T, X)
            # a diverged step can produce non-finite poses/points whose
            # residuals are all masked (cost 0): never accept one
            finite = torch.isfinite(dxc).all() & torch.isfinite(dxl).all()
            accept = (cost_new < cost_old) & finite
            T = torch.where(accept, T_new, T)
            X = torch.where(accept, X_new, X)
            lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0), 1e-9, 1e6)
            cost = torch.minimum(cost_new, cost_old)
        _, c2, ok = cost_of(T, X)
        return T, X, c2, ok, cost

    def optimize(p: BAProblem) -> BAResult:
        C, L = p.T_cw.shape[0], p.X.shape[0]
        oc, ol = p.obs_cam.to(torch.int64), p.obs_lm.to(torch.int64)
        keep = p.obs_mask & p.cam_valid[oc] & p.lm_valid[ol]
        sums = segment_sums([(oc, C, keep), (ol, L, keep), (ol * C + oc, L * C, keep)])
        active = p.obs_mask
        T, X, c2, ok, _ = lm_phase(p, active, first_iters, sums)
        active = active & ok & (c2 < chi2_thr)
        T, X, c2, ok, cost = lm_phase(p._replace(T_cw=T, X=X), active, second_iters, sums)
        return BAResult(T, X, active & ok & (c2 < chi2_thr), cost)

    return optimize


# ---------------------------------------------------------------------------
# Global BA: matrix-free Schur complement + PCG
# ---------------------------------------------------------------------------

def make_global_ba(cam, iters: int = 10, cg_iters: int = 40, stereo: bool = False,
                   multicam: bool = False):
    """Matrix-free LM for full-map BA over an unbounded camera count
    (counterpart of ``make_global_ba``; ref ``optimize/global_bundle_adjuster``),
    with the edges of ``make_local_ba``.

    Same problem struct as local BA; the reduced camera system is never
    formed: each PCG step applies S x = Hcc x - W (Hll^-1 (W^T x)) with
    fixed-order sums over the observations, preconditioned by the
    inverse camera blocks.  Gauge: cam_opt False for the origin keyframe.
    Like local BA, the iterations are Python loops over 0-d tensors and
    nothing is read back to the host inside the solve."""
    chi2_thr = R.CHI2_3D if stereo and not multicam else R.CHI2_2D

    def optimize(p: BAProblem) -> BAResult:
        dev, dt = p.T_cw.device, p.T_cw.dtype
        C, L = p.T_cw.shape[0], p.X.shape[0]
        oc, ol = p.obs_cam.to(torch.int64), p.obs_lm.to(torch.int64)
        inv_s2 = 1.0 / torch.clamp(p.obs_sigma2, min=1e-12)
        cam_free = p.cam_opt & p.cam_valid
        free6 = cam_free[:, None].to(dt)
        obs_ok_static = p.obs_mask & p.cam_valid[oc] & p.lm_valid[ol]
        eyec = torch.eye(6, dtype=dt, device=dev)
        eyel = torch.eye(3, dtype=dt, device=dev)
        sum_c, sum_l = segment_sums([(oc, C, obs_ok_static), (ol, L, obs_ok_static)])

        def cost_of(T, X):
            r, ok, _ = reprojection_residuals(cam, T, X, oc, ol, p.obs_uv, multicam)
            c2 = (r * r).sum(-1) * inv_s2
            w = (obs_ok_static & ok).to(dt)
            return (_rho(c2, chi2_thr) * w).sum(), c2, ok

        T, X = p.T_cw, p.X
        lam = torch.tensor(1e-4, dtype=dt, device=dev)
        cost = torch.zeros((), dtype=dt, device=dev)
        for _ in range(iters):
            r, ok, Jc, Jl = reprojection_residuals_and_jacobians(cam, T, X, oc, ol, p.obs_uv,
                                                                   multicam)
            c2 = (r * r).sum(-1) * inv_s2
            w = R.huber_weight(c2, chi2_thr) * inv_s2 * (obs_ok_static & ok).to(dt)
            Jc = Jc * cam_free[oc][:, None, None]
            Hcc = sum_c(torch.einsum("odi,odj,o->oij", Jc, Jc, w))
            Hll = sum_l(torch.einsum("odi,odj,o->oij", Jl, Jl, w))
            gc = sum_c(torch.einsum("odi,od,o->oi", Jc, r, w))
            gl = sum_l(torch.einsum("odi,od,o->oi", Jl, r, w))
            Hcc_d = Hcc + lam * Hcc * eyec + 1e-8 * eyec
            Hll_d = Hll + lam * Hll * eyel + 1e-8 * eyel
            Hll_d = torch.where(p.lm_valid[:, None, None], Hll_d, eyel)
            Hll_inv = torch.linalg.inv_ex(Hll_d).inverse
            # per-observation W_o = w Jc^T Jl (6,3) applies Hcl and Hlc
            Wo = torch.einsum("odi,odj,o->oij", Jc, Jl, w)

            def S_apply(x):
                u = sum_l(torch.einsum("oij,oi->oj", Wo, x[oc]))
                y = torch.einsum("lkm,lm->lk", Hll_inv, u)
                z = sum_c(torch.einsum("oij,oj->oi", Wo, y[ol]))
                return torch.einsum("cij,cj->ci", Hcc_d, x) - z

            rhs = (-gc + sum_c(torch.einsum(
                "oij,oj->oi", Wo, torch.einsum("lkm,lm->lk", Hll_inv, gl)[ol]))) * free6
            Minv = torch.linalg.inv_ex(torch.where(cam_free[:, None, None], Hcc_d, eyec)).inverse
            x = torch.zeros((C, 6), dtype=dt, device=dev)
            rv = rhs
            pv = torch.einsum("cij,cj->ci", Minv, rhs) * free6
            rz = (rhs * pv).sum()
            for _ in range(cg_iters):
                Ap = S_apply(pv) * free6
                alpha = rz / torch.clamp((pv * Ap).sum(), min=1e-12)
                x = x + alpha * pv
                rv = rv - alpha * Ap
                z = torch.einsum("cij,cj->ci", Minv, rv) * free6
                rz_new = (rv * z).sum()
                pv = z + rz_new / torch.clamp(rz, min=1e-12) * pv
                rz = rz_new
            dxc = x * free6
            u = sum_l(torch.einsum("oij,oi->oj", Wo, dxc[oc]))
            dxl = -torch.einsum("lkm,lm->lk", Hll_inv, gl + u) * p.lm_valid[:, None]

            T_new = R.perturb_pose(dxc, T)
            X_new = X + dxl
            cost_new, _, _ = cost_of(T_new, X_new)
            cost_old, _, _ = cost_of(T, X)
            # a diverged step masks all its residuals (cost 0): never accept one
            finite = torch.isfinite(dxc).all() & torch.isfinite(dxl).all()
            accept = (cost_new < cost_old) & finite
            T = torch.where(accept, T_new, T)
            X = torch.where(accept, X_new, X)
            lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0), 1e-9, 1e6)
            cost = torch.minimum(cost_new, cost_old)
        _, c2, ok = cost_of(T, X)
        return BAResult(T, X, obs_ok_static & ok & (c2 < chi2_thr), cost)

    return optimize
