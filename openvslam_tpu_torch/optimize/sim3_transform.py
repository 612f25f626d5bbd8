"""Sim3 pair refinement with mutual reprojection (counterpart of
``openvslam_tpu/optimize/sim3_transform.py``; ref
``optimize/transform_optimizer``).

Given matched landmark pairs of two keyframes, lm1 (keyframe 1 camera
coordinates) and lm2 (keyframe 2), with their pixel observations, refine
the Sim3 S_12 (keyframe-2 coordinates -> keyframe 1) by minimizing

    r1 = uv1 - project(S_12 . lm2)        (observed in image 1)
    r2 = uv2 - project(S_12^-1 . lm1)     (observed in image 2)

with Huber at chi2 10 (the reference's threshold): a first phase, outlier
removal, a second phase.  The Jacobians are forward-mode
(``torch.func.jacfwd``) of the residuals at the identity increment, as the
JAX package takes them, in float64 (forward-mode tangents of 0-d float32
operands mixed with Python scalars come out float64 in PyTorch); each
iteration's accept decision and damping stay
0-d tensors, so the solve reads nothing back to the host.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jacfwd

from ..ops import sim3
from . import residuals as R

CHI2_SIM3 = 10.0


class Sim3OptResult(NamedTuple):
    R: torch.Tensor
    t: torch.Tensor
    s: torch.Tensor
    inliers: torch.Tensor
    num_inliers: torch.Tensor


def _rho(c):
    return torch.where(c <= CHI2_SIM3, c,
                       2.0 * torch.sqrt(CHI2_SIM3 * torch.clamp(c, min=0.0)) - CHI2_SIM3)


def make_sim3_transform_optimizer(cam, fix_scale: bool = False, first_iters: int = 10,
                                  second_iters: int = 10):
    """fn(R0, t0, s0, lm1 (N,3), lm2 (N,3), uv1 (N,2), uv2 (N,2), sigma2_1
    (N,), sigma2_2 (N,), mask (N,)) -> Sim3OptResult."""

    def optimize(R0, t0, s0, lm1, lm2, uv1, uv2, sigma2_1, sigma2_2, mask):
        dt, dev = lm1.dtype, lm1.device
        inv1 = 1.0 / torch.clamp(sigma2_1, min=1e-12)
        inv2 = 1.0 / torch.clamp(sigma2_2, min=1e-12)
        z7 = torch.zeros(7, dtype=dt, device=dev)
        eye7 = torch.eye(7, dtype=dt, device=dev)
        free = torch.ones(7, dtype=dt, device=dev)
        if fix_scale:
            free[6] = 0.0

        def residuals(xi, g, lm1=lm1, lm2=lm2, uv1=uv1, uv2=uv2):
            g12 = sim3.compose(sim3.exp(xi), g)
            g21 = sim3.inverse(g12)
            uvp1, z1, _ = cam.project(sim3.transform(g12, lm2))
            uvp2, z2, _ = cam.project(sim3.transform(g21, lm1))
            ok1, ok2 = z1 > 1e-6, z2 > 1e-6
            r1 = torch.where(ok1[:, None], uv1 - uvp1, torch.zeros_like(uvp1))
            r2 = torch.where(ok2[:, None], uv2 - uvp2, torch.zeros_like(uvp2))
            return r1, r2, ok1 & ok2

        ops64 = tuple(x.double() for x in (lm1, lm2, uv1, uv2))

        def costs(xi, g):
            r1, r2, ok = residuals(xi, g)
            return r1, r2, (r1 * r1).sum(-1) * inv1, (r2 * r2).sum(-1) * inv2, ok

        def phase(g, active, iters):
            lam = torch.tensor(1e-4, dtype=dt, device=dev)
            for _ in range(iters):
                r1, r2, c1, c2, ok = costs(z7, g)
                w1 = R.huber_weight(c1, CHI2_SIM3) * inv1 * (active & ok)
                w2 = R.huber_weight(c2, CHI2_SIM3) * inv2 * (active & ok)
                g64 = tuple(x.double() for x in g)
                J1, J2 = jacfwd(lambda xi: residuals(xi, g64, *ops64)[:2])(z7.double())
                J1, J2 = J1.to(dt) * free, J2.to(dt) * free                   # (N,2,7)
                H = (torch.einsum("ndi,ndj,n->ij", J1, J1, w1)
                     + torch.einsum("ndi,ndj,n->ij", J2, J2, w2))
                grad = (torch.einsum("ndi,nd,n->i", J1, r1, w1)
                        + torch.einsum("ndi,nd,n->i", J2, r2, w2))
                if fix_scale:
                    H = H + torch.diag(1.0 - free)
                Hd = H + lam * torch.diag(torch.diagonal(H)) + 1e-8 * eye7
                dx = -torch.linalg.solve_ex(Hd, grad[:, None]).result[:, 0] * free
                g_new = sim3.compose(sim3.exp(dx), g)
                _, _, c1n, c2n, okn = costs(dx, g)
                m = (active & ok).to(dt)
                mn = (active & okn).to(dt)
                cost_old = ((_rho(c1) + _rho(c2)) * m).sum()
                cost_new = ((_rho(c1n) + _rho(c2n)) * mn).sum()
                finite = torch.stack([torch.isfinite(x).all() for x in g_new]).all()
                accept = (cost_new < cost_old) & finite
                g = tuple(torch.where(accept, a, b) for a, b in zip(g_new, g))
                lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0), 1e-9, 1e6)
            _, _, c1, c2, ok = costs(z7, g)
            return g, ok & (c1 < CHI2_SIM3) & (c2 < CHI2_SIM3)

        g1, good = phase((R0, t0, s0), mask, first_iters)
        active = mask & good
        g2, good2 = phase(g1, active, second_iters)
        inl = active & good2
        return Sim3OptResult(g2[0], g2[1], g2[2], inl, inl.to(torch.int32).sum())

    return optimize
