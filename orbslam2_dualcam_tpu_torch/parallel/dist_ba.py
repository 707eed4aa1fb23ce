"""Distributed global bundle adjustment over a mesh of shards.

Port of orbslam2_dualcam_tpu/parallel/dist_ba.py: global BA whose
observation set is sharded across the shards of a `runtime.Mesh`, with the
landmark and reduced camera systems assembled by sums over the mesh.

* The mesh shards the EDGE table, the only O(n)-growing axis: shard g takes
  the contiguous rows [g E/size, (g+1) E/size).  Poses [K, 6] are
  replicated on every shard (every pose couples to every shard's edges
  through the Schur system).
* Two point layouts:
  - replicated (default, `shard_points=False`): points [M, 3] on every
    shard; the landmark sums (g_l, H_ll and the W^T v products inside the
    Schur CG matvec) are reduced over the mesh.
  - point-sharded (`shard_points=True`): edges are partitioned by their
    point's owner on the host (round-robin by point id,
    `partition_by_point`), so each shard holds only its M/size landmark
    block (positions, H_ll, H_ll^-1) and every landmark-sized sum stays
    local.  Only the pose-sized (K x 6) sums are reduced in each CG
    iteration.
* Each shard computes its rows' residuals and Jacobians
  (optim/ba._build_system) and partial `index_add_` sums; `Mesh.all_reduce`
  completes them, after which every shard runs the identical replicated
  update.  Nothing is read back inside the LM loop.

The reference's `shard_map` body is one generator per shard here
(`_shard_body`): it yields each partial that the reference `psum`s and is
sent the mesh's sum back; `_run` steps the shards in lockstep.  The shards
of one process run one after another, so a virtual mesh of n shards on one
card launches n times the edge-side work of `ba.solve_ba`.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import numpy as np
import torch

from orbslam2_dualcam_tpu_torch.ops import lie
from orbslam2_dualcam_tpu_torch.optim import ba
from orbslam2_dualcam_tpu_torch.optim.ba import BAProblem, BAResult
from orbslam2_dualcam_tpu_torch.optim.factors import Edges
from orbslam2_dualcam_tpu_torch.utils.config import BAConfig

if TYPE_CHECKING:
    from orbslam2_dualcam_tpu_torch.parallel.runtime import Mesh


def partition_by_point(prob: BAProblem, n_dev: int):
    """Host-side repartition for the point-sharded layout: edges grouped by
    their point's owner shard (round-robin by point id), each group padded
    to a multiple of 8 rows with invalid edges, point ids localized, points
    restacked [n_dev * M_loc].

    Returns (prob_partitioned, point_map [M] global -> stacked index,
    rows [n_dev * E_pad] original edge row or -1 for padding)."""
    e = prob.edges
    dev = e.mp.device
    M = int(prob.points.shape[0])
    M_loc = -(-M // n_dev)
    owner = e.mp.cpu().numpy() % n_dev
    per_dev = [np.nonzero(owner == d)[0] for d in range(n_dev)]
    E_pad = max(8, max(len(ix) for ix in per_dev))
    E_pad = -(-E_pad // 8) * 8
    rows = np.full((n_dev, E_pad), -1, np.int64)
    for d, ix in enumerate(per_dev):
        rows[d, :len(ix)] = ix
    rows = rows.reshape(-1)
    sel = torch.as_tensor(np.maximum(rows, 0), device=dev)
    real = torch.as_tensor(rows >= 0, device=dev)
    edges = Edges(kf=e.kf[sel], mp=(e.mp // n_dev)[sel], cam=e.cam[sel],
                  uv=e.uv[sel], inv_sigma2=e.inv_sigma2[sel],
                  valid=e.valid[sel] & real)
    # stacked points: shard d's block holds globals {m : m % n_dev == d}
    point_map = (np.arange(M) % n_dev) * M_loc + np.arange(M) // n_dev
    at = torch.as_tensor(point_map, device=dev)
    points = prob.points.new_zeros((n_dev * M_loc, 3))
    points[at] = prob.points
    point_valid = torch.zeros(n_dev * M_loc, dtype=torch.bool, device=dev)
    point_valid[at] = prob.point_valid
    prob_p = prob._replace(points=points, edges=edges,
                           point_valid=point_valid)
    return prob_p, point_map, rows


def solve_ba_distributed(prob: BAProblem, T_sc, adj_sc, Ks, mesh: Mesh,
                         iters: int = 10, cg_iters: int = 24,
                         cfg: BAConfig = BAConfig(),
                         robust: bool = True,
                         shard_points: bool = False) -> BAResult:
    """Distributed LM/Schur/PCG global BA; the result lies on the device of
    `prob`, in the caller's edge and point order.

    shard_points=False: the edge count must be divisible by `mesh.size`;
    points replicated.
    shard_points=True: edges and points are repartitioned by point owner
    (partition_by_point) and the landmark system stays local to each
    shard."""
    if shard_points:
        return _solve_sharded_points(prob, T_sc, adj_sc, Ks, mesh, iters,
                                     cg_iters, cfg, robust)
    return _solve(prob, T_sc, adj_sc, Ks, mesh, iters, cg_iters, cfg,
                  robust, point_sharded=False)


def _solve_sharded_points(prob, T_sc, adj_sc, Ks, mesh, iters, cg_iters,
                          cfg, robust) -> BAResult:
    prob_p, point_map, rows = partition_by_point(prob, mesh.size)
    res = _solve(prob_p, T_sc, adj_sc, Ks, mesh, iters, cg_iters, cfg,
                 robust, point_sharded=True)
    dev = res.points.device
    real = np.nonzero(rows >= 0)[0]
    chi2 = res.edge_chi2.new_zeros(prob.edges.kf.shape[0])
    chi2[torch.as_tensor(rows[real], device=dev)] = \
        res.edge_chi2[torch.as_tensor(real, device=dev)]
    points = res.points[torch.as_tensor(point_map, device=dev)]
    return BAResult(poses=res.poses, points=points, edge_chi2=chi2,
                    cost=res.cost)


def _shard(prob: BAProblem, g: int, E_loc: int, M_loc, device) -> BAProblem:
    """Shard g's problem on `device`: its block of edge rows, the poses,
    and its block of M_loc points (point-sharded) or all of them (None)."""
    rows = slice(g * E_loc, (g + 1) * E_loc)
    pts = slice(None) if M_loc is None else slice(g * M_loc, (g + 1) * M_loc)
    return BAProblem(
        poses=prob.poses.to(device), points=prob.points[pts].to(device),
        edges=Edges(*(f[rows].to(device) for f in prob.edges)),
        pose_valid=prob.pose_valid.to(device),
        pose_fixed=prob.pose_fixed.to(device),
        point_valid=prob.point_valid[pts].to(device))


def _solve(prob: BAProblem, T_sc, adj_sc, Ks, mesh: Mesh, iters: int,
           cg_iters: int, cfg: BAConfig, robust: bool,
           point_sharded: bool) -> BAResult:
    K = prob.poses.shape[0]
    M = prob.points.shape[0]
    E = prob.edges.kf.shape[0]
    n = mesh.size
    if E % n:
        raise ValueError(f"edge count {E} not divisible by mesh size {n}")
    if point_sharded and M % n:
        raise ValueError(f"point count {M} not divisible by mesh size {n}")
    mesh.check_same_problem(K, M, E)
    M_loc = M // n if point_sharded else None
    bodies = [
        _shard_body(_shard(prob, g, E // n, M_loc, d), T_sc.to(d),
                    adj_sc.to(d), Ks.to(d), iters, cg_iters, cfg, robust,
                    point_sharded)
        for g, d in enumerate(mesh.devices, start=mesh.first_shard)]
    outs = _run(mesh, bodies)
    poses, points, _, cost = outs[0]
    if point_sharded:
        points = mesh.concat([o[1] for o in outs])
    chi2 = mesh.concat([o[2] for o in outs])
    dev = prob.poses.device
    return BAResult(poses=poses.to(dev), points=points.to(dev),
                    edge_chi2=chi2.to(dev), cost=cost.to(dev))


def _run(mesh: Mesh, bodies: list) -> list:
    """Step the shard bodies in lockstep: each yields its partial sum, the
    mesh sums one partial per shard, and each body is sent its copy of the
    sum.  Every body runs the same sequence of sums, so all of them finish
    on the same step; returns their return values in shard order."""
    partials = [next(b) for b in bodies]
    while True:
        sums = mesh.all_reduce(partials)
        partials, results = [], []
        for b, s in zip(bodies, sums):
            try:
                partials.append(b.send(s))
            except StopIteration as stop:
                results.append(stop.value)
        if results:
            if partials:
                raise RuntimeError("distributed BA: the shards ran different "
                                   "sequences of sums")
            return results


def _shard_body(prob: BAProblem, T_sc, adj_sc, Ks, iters: int,
                cg_iters: int, cfg: BAConfig, robust: bool,
                point_sharded: bool):
    """One shard's LM loop (the reference's `shard_body` and `step_fn`):
    a generator that yields every partial sum the reference `psum`s and
    is sent back the sum over the mesh.  Returns (poses, points on this
    shard, this shard's per-edge chi2, cost)."""
    K = prob.poses.shape[0]
    M_loc = prob.points.shape[0]
    dev, dtype = prob.poses.device, prob.poses.dtype
    delta2 = cfg.huber_delta ** 2
    ekf, emp = prob.edges.kf, prob.edges.mp
    fixed = prob.pose_fixed[:, None]
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    eye6 = torch.eye(6, dtype=dtype, device=dev)

    def masked(v):
        return torch.where(fixed, torch.zeros_like(v), v)

    def pose_sum(data):
        return (yield ba._segment_sum(data, ekf, K))

    def point_sum(data):
        """Landmark-sized sum: local when points are sharded (each edge
        lives with its point's owner), over the mesh when replicated."""
        s = ba._segment_sum(data, emp, M_loc)
        if point_sharded:
            return s
        return (yield s)

    def cost_of(poses, points):
        return (yield ba._cost(prob._replace(poses=poses, points=points),
                               T_sc, adj_sc, Ks, robust, delta2))

    def lm_step(poses, points, lam, cost):
        r, Jp, Jx, w, _ = ba._build_system(
            prob._replace(poses=poses, points=points), T_sc, adj_sc, Ks,
            robust, delta2)
        g_p = ba._segment_sum(torch.einsum('eri,e,er->ei', Jp, w, r), ekf, K)
        g_l = ba._segment_sum(torch.einsum('eri,e,er->ei', Jx, w, r), emp,
                              M_loc)
        Hpp = ba._segment_sum(torch.einsum('eri,e,erj->eij', Jp, w, Jp),
                              ekf, K)
        Hll = ba._segment_sum(torch.einsum('eri,e,erj->eij', Jx, w, Jx),
                              emp, M_loc)
        # the four gradient and Hessian sums in one reduction (the landmark
        # two only when points are replicated)
        sums = [g_p, Hpp] if point_sharded else [g_p, Hpp, g_l, Hll]
        flat = yield torch.cat([s.reshape(-1) for s in sums])
        sums = [p.view(s.shape) for p, s in
                zip(torch.split(flat, [s.numel() for s in sums]), sums)]
        if point_sharded:
            g_p, Hpp = sums
        else:
            g_p, Hpp, g_l, Hll = sums

        Hpp_d = ba._damp(Hpp, lam)
        Hll_inv = ba._inv(ba._damp(Hll, lam) + 1e-9 * eye3)
        W_e = torch.einsum('eri,e,erj->eij', Jp, w, Jx)           # this shard

        def S_matvec(v):
            u = yield from point_sum(torch.einsum('eij,ei->ej', W_e, v[ekf]))
            y = torch.einsum('mij,mj->mi', Hll_inv, u)
            z = yield from pose_sum(torch.einsum('eij,ej->ei', W_e, y[emp]))
            return masked(torch.einsum('kij,kj->ki', Hpp_d, v) - z)

        y0 = torch.einsum('mij,mj->mi', Hll_inv, g_l)
        rhs = masked(-g_p + (yield from pose_sum(
            torch.einsum('eij,ej->ei', W_e, y0[emp]))))
        P_inv = ba._inv(Hpp_d + 1e-6 * eye6)

        def precond(v):
            return masked(torch.einsum('kij,kj->ki', P_inv, v))

        x = torch.zeros_like(rhs)
        rr = rhs
        p = precond(rhs)
        rz = (rhs * p).sum()
        for _ in range(cg_iters):
            Ap = yield from S_matvec(p)
            alpha = rz / torch.clamp((p * Ap).sum(), min=1e-20)
            x = x + alpha * p
            rr = rr - alpha * Ap
            z = precond(rr)
            rz_new = (rr * z).sum()
            p = z + (rz_new / torch.clamp(rz, min=1e-20)) * p
            rz = rz_new
        dx_p = x

        u = yield from point_sum(torch.einsum('eij,ei->ej', W_e, dx_p[ekf]))
        dx_l = -torch.einsum('mij,mj->mi', Hll_inv, g_l + u)
        dx_l = torch.where(prob.point_valid[:, None], dx_l,
                           torch.zeros_like(dx_l))
        new_poses = lie.se3_exp(dx_p) @ poses
        new_poses = torch.where(fixed[:, :, None], poses, new_poses)
        new_points = points + dx_l

        new_cost = yield from cost_of(new_poses, new_points)
        accept = new_cost < cost
        poses = torch.where(accept, new_poses, poses)
        points = torch.where(accept, new_points, points)
        lam = torch.clamp(torch.where(accept, lam / cfg.lm_lambda_factor,
                                      lam * cfg.lm_lambda_factor), 1e-8, 1e8)
        cost = torch.where(accept, new_cost, cost)
        return poses, points, lam, cost

    poses, points = prob.poses, prob.points
    cost = yield from cost_of(poses, points)
    lam = torch.full((), cfg.lm_lambda_init, dtype=dtype, device=dev)
    for _ in range(iters):
        poses, points, lam, cost = yield from lm_step(poses, points, lam, cost)
    # final chi2 of this shard's rows
    _, _, _, _, chi2 = ba._build_system(
        prob._replace(poses=poses, points=points), T_sc, adj_sc, Ks, False,
        delta2)
    return poses, points, chi2, cost
