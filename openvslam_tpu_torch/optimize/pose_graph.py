"""Sim(3) pose-graph optimization for loop closure (counterpart of
``openvslam_tpu/optimize/pose_graph.py``; ref ``optimize/graph_optimizer``).

* vertices: Sim3 world->camera poses as SoA (R (N,3,3), t (N,3), s (N,))
* edges: fixed-capacity arrays (e_i, e_j, measurement S_ji = S_j S_i^-1 at
  graph-build time, mask)
* residual per edge: r = log(S_ji_meas S_i S_j^-1)  (7,)
* LM whose step solves the 7N system matrix-free by preconditioned CG
  (block-Jacobi); the per-edge 7x14 Jacobians are forward-mode
  (``torch.func``) over the edge axis.
* the solve runs in float64 and returns the input's dtype: its 60 CG
  iterations stop far short of convergence on a loop of tens of
  keyframes, and such a truncated CG amplifies rounding, so in float32 the
  card's and the CPU's solves of one 69-node loop ended 7e-5 apart in pose
  and 0.5 % apart in cost.
* the per-edge blocks are summed per vertex in one fixed order on every
  device (``segment_sum``), so a run on the card repeats.

Each iteration's accept decision and damping stay 0-d tensors: nothing is
read back to the host inside the solve.  The caller moves landmarks
through their reference keyframes afterwards.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jacfwd, vmap

from ..ops import sim3
from .segment_sum import segment_sums


class PoseGraphProblem(NamedTuple):
    R: torch.Tensor           # (N,3,3)
    t: torch.Tensor           # (N,3)
    s: torch.Tensor           # (N,)
    node_valid: torch.Tensor  # (N,) bool
    node_fixed: torch.Tensor  # (N,) bool (the gauge, e.g. the loop keyframe)
    e_i: torch.Tensor         # (E,) int
    e_j: torch.Tensor         # (E,) int
    e_R: torch.Tensor         # (E,3,3) measurement S_ji = S_j S_i^-1
    e_t: torch.Tensor         # (E,3)
    e_s: torch.Tensor         # (E,)
    e_mask: torch.Tensor      # (E,) bool

    def to(self, device) -> "PoseGraphProblem":
        return PoseGraphProblem(*(t.to(device) for t in self))


def _edge_residual(xi_i, xi_j, Ri, ti, si, Rj, tj, sj, Rm, tm, sm):
    Si2 = sim3.compose(sim3.exp(xi_i), (Ri, ti, si))
    Sj2 = sim3.compose(sim3.exp(xi_j), (Rj, tj, sj))
    return sim3.log(sim3.compose((Rm, tm, sm), sim3.compose(Si2, sim3.inverse(Sj2))))


_edge_jacobians = vmap(jacfwd(_edge_residual, argnums=(0, 1)),
                       in_dims=(None, None, 0, 0, 0, 0, 0, 0, 0, 0, 0))


def make_pose_graph_optimizer(iters: int = 20, cg_iters: int = 50, fix_scale: bool = False):
    """fn(PoseGraphProblem) -> (R, t, s, cost).  ``fix_scale`` locks every
    vertex's Sim3 scale (the reference's fix_scale for metric maps)."""

    def optimize(p: PoseGraphProblem):
        dt, dev = torch.float64, p.R.device
        N = p.R.shape[0]
        ei, ej = p.e_i.to(torch.int64), p.e_j.to(torch.int64)
        free = p.node_valid & ~p.node_fixed
        coord = torch.ones(7, dtype=dt, device=dev)
        if fix_scale:
            coord[6] = 0.0
        eye7 = torch.eye(7, dtype=dt, device=dev)
        z7 = torch.zeros(7, dtype=dt, device=dev)
        w = p.e_mask.to(dt)
        proj = free[:, None].to(dt) * coord[None, :]
        Sm = (p.e_R.to(dt), p.e_t.to(dt), p.e_s.to(dt))

        def residual(R, t, s):
            return _edge_residual(z7, z7, R[ei], t[ei], s[ei], R[ej], t[ej], s[ej], *Sm)

        def cost_of(R, t, s):
            r = residual(R, t, s)
            return ((r * r).sum(-1) * w).sum()

        sum_i, sum_j = segment_sums([(ei, N, p.e_mask != 0), (ej, N, p.e_mask != 0)])

        R, t, s = p.R.to(dt), p.t.to(dt), p.s.to(dt)
        lam = torch.tensor(1e-4, dtype=dt, device=dev)
        cost = torch.zeros((), dtype=dt, device=dev)
        for _ in range(iters):
            r = residual(R, t, s)
            Ji, Jj = _edge_jacobians(z7, z7, R[ei], t[ei], s[ei], R[ej], t[ej], s[ej], *Sm)
            g = (sum_i(torch.einsum("edk,ed,e->ek", Ji, r, w))
                 + sum_j(torch.einsum("edk,ed,e->ek", Jj, r, w)))
            Hii = (sum_i(torch.einsum("edk,edl,e->ekl", Ji, Ji, w))
                   + sum_j(torch.einsum("edk,edl,e->ekl", Jj, Jj, w)))
            damp = lam * Hii * eye7 + 1e-8 * eye7
            Hii_d = Hii + damp
            if fix_scale:
                # freeze the sigma row and column of the preconditioner block
                Hii_d = Hii_d * (coord[:, None] * coord[None, :]) + torch.diag(1.0 - coord)
            Minv = torch.linalg.inv_ex(torch.where(free[:, None, None], Hii_d, eye7)).inverse

            def H_apply(x):
                y = (torch.einsum("edk,ek->ed", Ji, x[ei])
                     + torch.einsum("edk,ek->ed", Jj, x[ej])) * w[:, None]
                out = (sum_i(torch.einsum("edk,ed->ek", Ji, y))
                       + sum_j(torch.einsum("edk,ed->ek", Jj, y)))
                return (out + torch.einsum("nkl,nl->nk", damp, x)) * proj

            rhs = -g * proj
            x = torch.zeros((N, 7), dtype=dt, device=dev)
            rv = rhs
            pv = torch.einsum("nkl,nl->nk", Minv, rhs) * proj
            rz = (rhs * pv).sum()
            for _ in range(cg_iters):
                Ap = H_apply(pv)
                alpha = rz / torch.clamp((pv * Ap).sum(), min=1e-12)
                x = x + alpha * pv
                rv = rv - alpha * Ap
                z = torch.einsum("nkl,nl->nk", Minv, rv) * proj
                rz_new = (rv * z).sum()
                pv = z + rz_new / torch.clamp(rz, min=1e-12) * pv
                rz = rz_new
            dx = x * proj
            Rn, tn, sn = sim3.compose(sim3.exp(dx), (R, t, s))
            c_new = cost_of(Rn, tn, sn)
            c_old = cost_of(R, t, s)
            accept = (c_new < c_old) & torch.isfinite(dx).all()
            R = torch.where(accept, Rn, R)
            t = torch.where(accept, tn, t)
            s = torch.where(accept, sn, s)
            lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0), 1e-9, 1e6)
            cost = torch.minimum(c_new, c_old)
        return tuple(x.to(p.R.dtype) for x in (R, t, s, cost))

    return optimize
