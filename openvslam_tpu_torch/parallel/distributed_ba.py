"""Distributed bundle adjustment (counterpart of
``openvslam_tpu/parallel/distributed_ba.py``): landmarks sharded, the
reduced camera system summed over the shards.

The landmark block of the BA Hessian is block-diagonal (3x3 per
landmark), so Schur elimination splits over landmarks.  Landmarks and
their observations are sharded (``partition_problem``); each shard

  1. computes the residuals and analytic Jacobians of ITS observations;
  2. eliminates ITS landmark blocks;
  3. forms its part of the reduced camera system S (6C x 6C), of v, of
     the camera blocks Hcc and of the robust cost, with fixed-order
     segment sums (``optimize/segment_sum.py``);
  4. the parts are summed: in one process shard after shard, across
     processes with ``all_reduce(SUM)`` over a ``torch.distributed``
     group (NCCL on the card, gloo on the CPU);
  5. every process solves the same (6C x 6C) system in float32 and
     back-substitutes ITS landmarks.

The LM schedule is the JAX package's: lambda 1e-4, halved on an accepted
step and quadrupled on a rejected one, clipped to [1e-9, 1e6], a step
accepted when the pooled robust cost falls (and the step is finite).

The JAX package builds a dense (L, C, 6, 3) cross-block tensor per shard
and takes its Jacobians from ``jax.jacfwd``.  Here the cross blocks are
summed per (landmark, camera) pair that occurs (a segment sum over the
observations), and S's product Y W^T runs over chunks of landmarks, each
a dense (6C x 3Lc) product with ``torch.matmul`` whose chunks are filled
from those pairs.  The peak memory is bounded by ``_CHUNK_ELEMS``; the
work is not: every iteration still zero-fills chunks that together cover
all L x C (landmark, camera) slots and multiplies them, O(L C) writes and
O(L C^2) multiply-adds, as JAX's dense tensor does.  The Jacobians are
the port's analytic ones (``optimize/ba.py
reprojection_residuals_and_jacobians``); a residual given as
``res_fn_override`` takes autodiff Jacobians instead, as JAX does (``torch.func.jacrev`` at the first-order increment I + hat(xi),
whose derivative at 0 is the SE(3) exp's).

Determinism: each shard's part depends only on its own rows, summed in a
fixed order on every device, so a shard gives the same bits wherever it
runs; two parts summed in one process equal their ``all_reduce`` over two
ranks bit for bit (a + b either way).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..ops import se3
from ..optimize import residuals as R
from ..optimize.ba import reprojection_residuals, reprojection_residuals_and_jacobians
from ..optimize.segment_sum import segment_sums
from ..device import canonical_device
from .mesh import make_mesh

# elements of one dense chunk of S's product (6C x 3Lc floats)
_CHUNK_ELEMS = 1 << 24


class ShardedBAProblem(NamedTuple):
    """Leading axis of X/lm/obs arrays is the GLOBAL (sharded) axis:
    X (L_total,3) with L_total = n_shards * L_shard, etc.  Cameras replicated."""
    T_cw: torch.Tensor        # (C,4,4)
    cam_opt: torch.Tensor     # (C,)
    cam_valid: torch.Tensor   # (C,)
    X: torch.Tensor           # (L_total,3)
    lm_valid: torch.Tensor    # (L_total,)
    obs_cam: torch.Tensor     # (O_total,) global camera index
    obs_lm: torch.Tensor      # (O_total,) LOCAL landmark index within the shard
    obs_uv: torch.Tensor      # (O_total,2|3|2+CAMV_DIM)
    obs_sigma2: torch.Tensor  # (O_total,)
    obs_mask: torch.Tensor    # (O_total,)


def partition_problem(prob, n_shards: int) -> ShardedBAProblem:
    """Host helper: repartition a flat ``optimize.ba.BAProblem`` (tensors or
    numpy arrays) into the sharded layout: landmarks in contiguous blocks
    (landmark l on shard l // L_shard at local index l % L_shard), masked
    observations moved to their landmark's shard in their order, each
    shard's observations padded to a multiple of 8.  The JAX package's
    ``partition_problem``, array for array; returns CPU tensors."""
    X = np.asarray(prob.X)
    L = X.shape[0]
    obs_lm = np.asarray(prob.obs_lm)
    L_shard = -(-L // n_shards)
    obs_shard = obs_lm // L_shard
    obs_local = obs_lm % L_shard
    obs_mask = np.asarray(prob.obs_mask)
    counts = np.bincount(obs_shard[obs_mask], minlength=n_shards)
    O_shard = max(1, int(-(-counts.max() // 8) * 8)) if counts.size else 1

    X_pad = np.zeros((n_shards * L_shard, 3), np.float32)
    X_pad[:L] = X
    lmv_pad = np.zeros(n_shards * L_shard, bool)
    lmv_pad[:L] = np.asarray(prob.lm_valid)

    obs_uv = np.asarray(prob.obs_uv)
    oc = np.zeros((n_shards, O_shard), np.int32)
    ol = np.zeros((n_shards, O_shard), np.int32)
    ouv = np.zeros((n_shards, O_shard) + obs_uv.shape[1:], np.float32)
    osg = np.ones((n_shards, O_shard), np.float32)
    om = np.zeros((n_shards, O_shard), bool)
    # masked observations in their order, shard by shard (a stable sort)
    rows = np.nonzero(obs_mask)[0]
    rows = rows[np.argsort(obs_shard[rows], kind="stable")]
    shard = obs_shard[rows]
    slot = np.arange(len(rows)) - np.searchsorted(shard, shard, side="left")
    oc[shard, slot] = np.asarray(prob.obs_cam)[rows]
    ol[shard, slot] = obs_local[rows]
    ouv[shard, slot] = obs_uv[rows]
    osg[shard, slot] = np.asarray(prob.obs_sigma2)[rows]
    om[shard, slot] = True

    t = torch.from_numpy
    return ShardedBAProblem(
        t(np.array(prob.T_cw, np.float32)), t(np.array(prob.cam_opt, bool)),
        t(np.array(prob.cam_valid, bool)), t(X_pad), t(lmv_pad),
        t(oc.reshape(-1)), t(ol.reshape(-1)), t(ouv.reshape((-1,) + ouv.shape[2:])),
        t(osg.reshape(-1)), t(om.reshape(-1)))


def rank_rows(sp: ShardedBAProblem, n_shards: int, world: int, rank: int) -> ShardedBAProblem:
    """The rows of ``rank``'s shards (a contiguous block of ``n_shards //
    world``) of a problem of ``n_shards`` shards, cameras whole."""
    if n_shards % world:
        raise ValueError(f"{n_shards} shards do not divide over {world} ranks")
    if sp.X.shape[0] % n_shards or sp.obs_cam.shape[0] % n_shards:
        raise ValueError(f"landmark and observation rows must divide by {n_shards} shards")
    per = n_shards // world
    L_s, O_s = sp.X.shape[0] // n_shards, sp.obs_cam.shape[0] // n_shards
    lr = slice(rank * per * L_s, (rank + 1) * per * L_s)
    orows = slice(rank * per * O_s, (rank + 1) * per * O_s)
    return ShardedBAProblem(sp.T_cw, sp.cam_opt, sp.cam_valid, sp.X[lr], sp.lm_valid[lr],
                            sp.obs_cam[orows], sp.obs_lm[orows], sp.obs_uv[orows],
                            sp.obs_sigma2[orows], sp.obs_mask[orows])


def _rho(c2, thr):
    return torch.where(c2 <= thr, c2, 2.0 * torch.sqrt(thr * torch.clamp(c2, min=0.0)) - thr)


def _override_residuals(res_fn):
    """(residuals, residuals and jacobians) of a residual
    res_fn(T (4,4), X (N,3), obs (N,D)) -> (r (N,D'), ok (N,)), evaluated one
    observation at a time under ``torch.func.vmap``, the Jacobians by
    ``torch.func.jacrev`` of the left increment and of the point."""
    from torch.func import jacrev, vmap

    def one(Tc, Xl, o):
        r, ok = res_fn(Tc, Xl[None], o[None])
        return r[0], ok[0]

    def residuals(T, X, oc, ol, ouv):
        return vmap(one)(T[oc], X[ol], ouv)

    def residuals_and_jacobians(T, X, oc, ol, ouv):
        dt = T.dtype

        def per_obs(Tc, Xl, o):
            z6 = torch.zeros(6, dtype=dt, device=Tc.device)
            z3 = torch.zeros(3, dtype=dt, device=Tc.device)

            def r_of(xi, dX):
                return one(se3.se3_exp(xi) @ Tc, Xl + dX, o)[0]

            r, ok = one(Tc, Xl, o)
            return r, ok, jacrev(lambda xi: r_of(xi, z3))(z6), jacrev(lambda dX: r_of(z6, dX))(z3)

        return vmap(per_obs)(T[oc], X[ol], ouv)

    return residuals, residuals_and_jacobians


class _Shard:
    """One shard's rows on its device and the fixed index structures of a
    solve: the static observation mask, the (landmark, camera) pairs that
    occur and the segment sums over observations and pairs."""

    def __init__(self, sp: ShardedBAProblem, s: int, n_shards: int, device, D: int):
        L_s = sp.X.shape[0] // n_shards
        O_s = sp.obs_cam.shape[0] // n_shards
        lr, orows = slice(s * L_s, (s + 1) * L_s), slice(s * O_s, (s + 1) * O_s)
        C = sp.T_cw.shape[0]
        self.device = device
        self.X = sp.X[lr].to(device)
        self.lm_valid = sp.lm_valid[lr].to(device)
        oc = sp.obs_cam[orows].to(torch.int64)
        ol = sp.obs_lm[orows].to(torch.int64)
        keep = sp.obs_mask[orows] & sp.cam_valid[oc] & sp.lm_valid[lr][ol]
        # the (landmark, camera) pairs of the kept observations, by landmark
        key = ol * C + oc
        pairs, pair_of = torch.unique(torch.where(keep, key, L_s * C), return_inverse=True)
        n_pairs = int((pairs < L_s * C).sum())
        pairs = pairs[:n_pairs]
        self.oc, self.ol = oc.to(device), ol.to(device)
        self.obs_uv = sp.obs_uv[orows][:, :D].to(device)
        self.inv_s2 = (1.0 / torch.clamp(sp.obs_sigma2[orows], min=1e-12)).to(device)
        self.keep = keep.to(device)
        self.pl, self.pc = (pairs // C).to(device), (pairs % C).to(device)
        pair_of = torch.clamp(pair_of, max=max(n_pairs - 1, 0)).to(device)
        self.n_pairs, self.C = n_pairs, C
        # S's product runs over chunks of lc landmarks, each chunk with its
        # range [a, b) of the pairs (sorted by landmark)
        lc = max(1, min(L_s, _CHUNK_ELEMS // (18 * C)))
        bounds = torch.searchsorted(pairs // C, torch.arange(0, L_s + lc, lc))
        self.chunks = [(l0, min(l0 + lc, L_s), int(a), int(b))
                       for l0, a, b in zip(range(0, L_s, lc), bounds[:-1], bounds[1:]) if b > a]
        (self.sum_c, self.sum_l, self.sum_pair, self.sum_pc, self.sum_pl) = segment_sums([
            (self.oc, C, self.keep), (self.ol, L_s, self.keep),
            (pair_of, max(n_pairs, 1), self.keep), (self.pc, C, None), (self.pl, L_s, None)])


def make_distributed_ba(cam, mesh: Optional[Sequence] = None, group=None, stereo: bool = False,
                        iters: int = 10, res_fn_override=None, multicam: bool = False):
    """Build the sharded BA.  Returns optimize(sp: ShardedBAProblem) ->
    (T_cw (C,4,4), X (L_total,3), cost 0-d), on the first device of
    ``mesh``.

    ``mesh`` (a device list, ``parallel.mesh.make_mesh``; default every
    CUDA device) holds one shard per entry.  Without ``group`` the shard
    count is len(mesh) and the process holds them all; with a
    ``torch.distributed`` group of W ranks it is W x len(mesh), rank r
    holds shards [r len(mesh), (r + 1) len(mesh)) of the problem (which
    every rank passes whole), and the results come back on every rank.
    L_total and O_total must divide by the shard count (``partition_problem``
    pads them so).

    Edges: the mono edge of ``cam``, the stereo edge with ``stereo`` ((u,
    v, u_right) observations), the multi-camera edge with ``multicam``
    (per-observation intrinsics in observation columns 2..), or a residual
    ``res_fn_override(T, X, obs) -> (r, ok)`` with autodiff Jacobians (the
    JAX package's argument; chi2 gate 5.991)."""
    import torch.distributed as dist

    mesh = [canonical_device(d) for d in (make_mesh() if mesh is None else mesh)]
    world, rank = (1, 0) if group is None else (dist.get_world_size(group),
                                                 dist.get_rank(group))
    n_local = len(mesh)
    n_shards = world * n_local
    if res_fn_override is not None:
        res_only, res_jac = _override_residuals(res_fn_override)
        chi2_thr = R.CHI2_2D
    else:
        def res_only(T, X, oc, ol, ouv):
            return reprojection_residuals(cam, T, X, oc, ol, ouv, multicam)[:2]

        def res_jac(T, X, oc, ol, ouv):
            return reprojection_residuals_and_jacobians(cam, T, X, oc, ol, ouv, multicam)

        chi2_thr = R.CHI2_3D if stereo and not multicam else R.CHI2_2D
    D = None if res_fn_override is not None or multicam else (3 if stereo else 2)

    def reduce(parts):
        """Sum this process's parts in shard order on the first device, then
        over the group."""
        d0 = mesh[0]
        acc = parts[0].to(d0)
        for p in parts[1:]:
            acc = acc + p.to(d0)
        if group is not None:
            dist.all_reduce(acc, op=dist.ReduceOp.SUM, group=group)
        return acc

    def cost_part(sh, T, X):
        r, ok = res_only(T, X, sh.oc, sh.ol, sh.obs_uv)
        c2 = (r * r).sum(-1) * sh.inv_s2
        return (_rho(c2, chi2_thr) * (sh.keep & ok).to(T.dtype)).sum()

    def schur_part(sh, T, X, lam, free):
        """This shard's [S (36 C^2), v (6C), Hcc (36C)] (``free``: the
        cameras to optimize, 0/1) and what the back substitution needs."""
        C, dt = sh.C, T.dtype
        r, ok, Jc, Jl = res_jac(T, X, sh.oc, sh.ol, sh.obs_uv)
        c2 = (r * r).sum(-1) * sh.inv_s2
        w = R.huber_weight(c2, chi2_thr) * sh.inv_s2 * (sh.keep & ok).to(dt)
        Jc = Jc * free[sh.oc][:, None, None]
        Hcc = sh.sum_c(torch.einsum("odi,odj,o->oij", Jc, Jc, w))
        Hll = sh.sum_l(torch.einsum("odi,odj,o->oij", Jl, Jl, w))
        gc = sh.sum_c(torch.einsum("odi,od,o->oi", Jc, r, w))
        gl = sh.sum_l(torch.einsum("odi,od,o->oi", Jl, r, w))
        W = sh.sum_pair(torch.einsum("odi,odj,o->oij", Jc, Jl, w))[:sh.n_pairs]   # (P,6,3)
        eyel = torch.eye(3, dtype=dt, device=T.device)
        Hll_d = Hll + lam * Hll * eyel + 1e-8 * eyel
        Hll_d = torch.where(sh.lm_valid[:, None, None], Hll_d, eyel)
        Hll_inv = torch.linalg.inv_ex(Hll_d).inverse
        Y = torch.einsum("pik,pkm->pim", W, Hll_inv[sh.pl])                       # (P,6,3)
        S = torch.zeros((C * 6, C * 6), dtype=dt, device=T.device)
        for l0, l1, a, b in sh.chunks:
            lc = l1 - l0
            Yr = torch.zeros((C, 6, lc, 3), dtype=dt, device=T.device)
            Wr = torch.zeros((C, 6, lc, 3), dtype=dt, device=T.device)
            Yr[sh.pc[a:b], :, sh.pl[a:b] - l0, :] = Y[a:b]
            Wr[sh.pc[a:b], :, sh.pl[a:b] - l0, :] = W[a:b]
            S = S + Yr.reshape(C * 6, lc * 3) @ Wr.reshape(C * 6, lc * 3).T
        v = -gc + sh.sum_pc(torch.einsum("pim,pm->pi", Y, gl[sh.pl]))
        part = torch.cat([(-S).reshape(-1), v.reshape(-1), Hcc.reshape(-1)])
        return part, (Hll_inv, gl, W)

    def optimize(sp: ShardedBAProblem):
        d0 = mesh[0]
        C = sp.T_cw.shape[0]
        width = sp.obs_uv.shape[1] if D is None else D
        mine = rank_rows(sp, n_shards, world, rank)
        shards = [_Shard(mine, j, n_local, d, width) for j, d in enumerate(mesh)]
        devices = list(dict.fromkeys([d0] + [sh.device for sh in shards]))
        frees = {d: (sp.cam_opt & sp.cam_valid).to(torch.float32).to(d) for d in devices}
        free = frees[d0]
        m6 = free.repeat_interleave(6)
        eyec = torch.eye(6, dtype=torch.float32, device=d0)
        diag = torch.arange(C, device=d0)
        T = sp.T_cw.to(d0, torch.float32)
        Xs = [sh.X for sh in shards]
        lam = torch.tensor(1e-4, dtype=torch.float32, device=d0)
        cost = torch.zeros((), dtype=torch.float32, device=d0)
        n_S, n_v = 36 * C * C, 6 * C
        for _ in range(iters):
            Td = {d: T.to(d) for d in devices}
            parts, backsub = [], []
            for sh, X in zip(shards, Xs):
                p, k = schur_part(sh, Td[sh.device], X, lam.to(sh.device), frees[sh.device])
                parts.append(p)
                backsub.append(k)
            tot = reduce(parts)
            S = tot[:n_S].reshape(C * 6, C * 6)
            v = tot[n_S:n_S + n_v]
            Hcc = tot[n_S + n_v:].reshape(C, 6, 6)
            Hcc_d = Hcc + lam * Hcc * eyec + 1e-8 * eyec
            S4 = S.reshape(C, 6, C, 6).clone()
            S4[diag, :, diag, :] += Hcc_d
            S = S4.reshape(C * 6, C * 6) * m6[:, None] * m6[None, :] + torch.diag(1.0 - m6)
            dxc = torch.linalg.solve_ex(S, v * m6).result.reshape(C, 6)     # replicated solve
            T_new = R.perturb_pose(dxc * free[:, None], T)
            X_new = []
            finite = torch.isfinite(dxc).all()
            for sh, X, (Hll_inv, gl, W) in zip(shards, Xs, backsub):
                dxc_s = dxc.to(sh.device)
                u = sh.sum_pl(torch.einsum("pik,pi->pk", W, dxc_s[sh.pc]))
                dxl = -torch.einsum("lkm,lm->lk", Hll_inv, gl + u) * sh.lm_valid[:, None]
                finite = finite & torch.isfinite(dxl).all().to(d0)
                X_new.append(X + dxl)
            Tn = {d: T_new.to(d) for d in devices}
            costs = reduce([torch.stack([cost_part(sh, Tn[sh.device], Xn),
                                         cost_part(sh, Td[sh.device], X)])
                            for sh, X, Xn in zip(shards, Xs, X_new)])
            c_new, c_old = costs[0], costs[1]
            if group is not None:
                # every rank takes the same decision from the reduced costs;
                # the finiteness of each rank's landmark steps is pooled too
                flag = finite.to(torch.float32).reshape(1)
                dist.all_reduce(flag, op=dist.ReduceOp.MIN, group=group)
                finite = flag[0] > 0
            accept = (c_new < c_old) & finite
            T = torch.where(accept, T_new, T)
            Xs = [torch.where(accept.to(X.device), Xn, X) for X, Xn in zip(Xs, X_new)]
            lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0), 1e-9, 1e6)
            cost = torch.minimum(c_new, c_old)
        X_out = torch.cat([X.to(d0) for X in Xs])
        if group is not None:
            blocks = [torch.empty_like(X_out) for _ in range(world)]
            dist.all_gather(blocks, X_out.contiguous(), group=group)
            X_out = torch.cat(blocks)
        return T, X_out, cost

    return optimize
