"""Bundle adjustment: Levenberg-Marquardt with landmark Schur elimination
and a matrix-free PCG solve of the reduced camera system.

Port of orbslam2_dualcam_tpu/optim/ba.py, the reference's
Optimizer::BundleAdjustment / LocalBundleAdjustment
(src/Optimizer.cc:62-248, 407-696) without a sparse solver: the normal
equations are never materialized as sparse matrices.

* Landmark blocks H_ll are 3x3, inverted as one batch [M,3,3].
* The reduced camera system S = H_pp - W H_ll^-1 W^T is applied
  matrix-free: S v costs two edge gathers and two `index_add_` sums, so a
  PCG iteration is gather / scatter / einsum with no data-dependent
  sparsity.
* Block-Jacobi preconditioner from the 6x6 pose diagonal.
* Gauge/scale fixing: a boolean `fixed` mask per pose zeroes its updates.

The reference's `lax.scan` over LM steps and `fori_loop` over PCG steps are
Python loops here; acceptance and damping stay tensor selects, so one
`solve_ba` call never reads a value back to the host (small inverses go
through `torch.linalg.inv_ex`, which skips the host-side singularity check
of `torch.linalg.inv`).  On the card the per-pose and per-point sums are
float atomics, so two runs need not agree to the last bit.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from orbslam2_dualcam_tpu_torch.ops import lie
from orbslam2_dualcam_tpu_torch.optim import factors
from orbslam2_dualcam_tpu_torch.optim.factors import Edges
from orbslam2_dualcam_tpu_torch.utils.config import BAConfig
from orbslam2_dualcam_tpu_torch.utils.profiling import span


class BAProblem(NamedTuple):
    poses: torch.Tensor        # [K, 4, 4] T_cw rig poses
    points: torch.Tensor       # [M, 3] world points
    edges: Edges               # padded observation table
    pose_valid: torch.Tensor   # [K] bool: slot holds a real KF
    pose_fixed: torch.Tensor   # [K] bool: held constant (gauge/scale anchors)
    point_valid: torch.Tensor  # [M] bool


class BAResult(NamedTuple):
    poses: torch.Tensor
    points: torch.Tensor
    edge_chi2: torch.Tensor    # [E] final per-edge chi2 (for outlier culling)
    cost: torch.Tensor


def _edge_mask(prob: BAProblem) -> torch.Tensor:
    return (prob.edges.valid & prob.pose_valid[prob.edges.kf] &
            prob.point_valid[prob.edges.mp])


def _build_system(prob: BAProblem, T_sc, adj_sc, Ks, robust: bool,
                  delta2: float):
    """Residuals, Jacobians, weights, and per-edge chi2."""
    r, Jp, Jx = factors.edge_residuals_jacobians(
        prob.poses, prob.points, prob.edges, T_sc, adj_sc, Ks)
    chi2 = (r * r).sum(-1) * prob.edges.inv_sigma2
    w = prob.edges.inv_sigma2
    if robust:
        w = w * factors.huber_weight(chi2, delta2)
    # a masked edge must add exactly zero to every sum
    w = torch.where(_edge_mask(prob), w, torch.zeros_like(w))
    # fixed poses contribute residuals but no pose-block derivatives
    Jp = torch.where(prob.pose_fixed[prob.edges.kf, None, None],
                     torch.zeros_like(Jp), Jp)
    return r, Jp, Jx, w, chi2


def _segment_sum(data: torch.Tensor, ids: torch.Tensor, num: int) -> torch.Tensor:
    out = torch.zeros((num, *data.shape[1:]), dtype=data.dtype,
                      device=data.device)
    return out.index_add_(0, ids, data)


def _inv(A: torch.Tensor) -> torch.Tensor:
    return torch.linalg.inv_ex(A).inverse


def _damp(H: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """Marquardt damping: scale the diagonals of the blocks H [..., n, n]."""
    d = torch.diagonal(H, dim1=-2, dim2=-1)
    return H + torch.diag_embed(lam * d + 1e-8)


def _cost(prob: BAProblem, T_sc, adj_sc, Ks, robust: bool,
          delta2: float) -> torch.Tensor:
    """The summed (Huber-robust when `robust`) cost over the unmasked edges,
    matching what LM minimizes."""
    _, _, _, _, chi2 = _build_system(prob, T_sc, adj_sc, Ks, False, delta2)
    if robust:
        rho = torch.where(
            chi2 > delta2,
            2.0 * torch.sqrt(delta2 * torch.clamp(chi2, min=0.0)) - delta2,
            chi2)
    else:
        rho = chi2
    return torch.where(_edge_mask(prob), rho, torch.zeros_like(rho)).sum()


def solve_ba(prob: BAProblem, T_sc: torch.Tensor, adj_sc: torch.Tensor,
             Ks: torch.Tensor, iters: int, cfg: BAConfig = BAConfig(),
             cg_iters: int = 24, robust: bool = True) -> BAResult:
    """LM loop of `iters` steps, each with `cg_iters` PCG iterations;
    per-iteration accept/reject keeps the best state (no data-dependent
    control flow, nothing read back)."""
    K = prob.poses.shape[0]
    M = prob.points.shape[0]
    dev = prob.poses.device
    dtype = prob.poses.dtype
    delta2 = cfg.huber_delta ** 2
    ekf = prob.edges.kf
    emp = prob.edges.mp
    fixed = prob.pose_fixed[:, None]
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    eye6 = torch.eye(6, dtype=dtype, device=dev)

    def cost_of(poses, points):
        return _cost(prob._replace(poses=poses, points=points), T_sc, adj_sc,
                     Ks, robust, delta2)

    def lm_step(poses, points, lam, cost):
        p2 = prob._replace(poses=poses, points=points)
        r, Jp, Jx, w, _ = _build_system(p2, T_sc, adj_sc, Ks, robust, delta2)

        # gradient blocks
        g_p = _segment_sum(torch.einsum('eri,e,er->ei', Jp, w, r), ekf, K)  # [K,6]
        g_l = _segment_sum(torch.einsum('eri,e,er->ei', Jx, w, r), emp, M)  # [M,3]
        # Hessian blocks
        Hpp = _segment_sum(torch.einsum('eri,e,erj->eij', Jp, w, Jp), ekf, K)
        Hll = _segment_sum(torch.einsum('eri,e,erj->eij', Jx, w, Jx), emp, M)
        Hpp_d = _damp(Hpp, lam)
        Hll_inv = _inv(_damp(Hll, lam) + 1e-9 * eye3)  # masked pts ~ eps I

        # per-edge coupling W_e = Jp^T w Jx  (6x3); S v uses it matrix-free
        W_e = torch.einsum('eri,e,erj->eij', Jp, w, Jx)              # [E,6,3]

        def S_matvec(v):                                             # [K,6]
            u = torch.einsum('eij,ei->ej', W_e, v[ekf])              # [E,3]
            u = _segment_sum(u, emp, M)                              # W^T v
            y = torch.einsum('mij,mj->mi', Hll_inv, u)               # H_ll^-1 W^T v
            z = torch.einsum('eij,ej->ei', W_e, y[emp])              # [E,6]
            z = _segment_sum(z, ekf, K)                              # W H^-1 W^T v
            out = torch.einsum('kij,kj->ki', Hpp_d, v) - z
            return torch.where(fixed, torch.zeros_like(out), out)

        # rhs: -g_p + W Hll^-1 g_l
        y0 = torch.einsum('mij,mj->mi', Hll_inv, g_l)
        rhs = -g_p + _segment_sum(
            torch.einsum('eij,ej->ei', W_e, y0[emp]), ekf, K)
        rhs = torch.where(fixed, torch.zeros_like(rhs), rhs)

        # block-Jacobi preconditioner
        P_inv = _inv(Hpp_d + 1e-6 * eye6)

        def precond(v):
            out = torch.einsum('kij,kj->ki', P_inv, v)
            return torch.where(fixed, torch.zeros_like(out), out)

        x = torch.zeros_like(rhs)
        rr = rhs
        p = precond(rhs)
        rz = (rhs * p).sum()
        for _ in range(cg_iters):
            Ap = S_matvec(p)
            alpha = rz / torch.clamp((p * Ap).sum(), min=1e-20)
            x = x + alpha * p
            rr = rr - alpha * Ap
            z = precond(rr)
            rz_new = (rr * z).sum()
            beta = rz_new / torch.clamp(rz, min=1e-20)
            p = z + beta * p
            rz = rz_new
        dx_p = x

        # back-substitute landmarks: dx_l = -Hll^-1 (g_l + W^T dx_p)
        u = _segment_sum(torch.einsum('eij,ei->ej', W_e, dx_p[ekf]), emp, M)
        dx_l = -torch.einsum('mij,mj->mi', Hll_inv, g_l + u)
        dx_l = torch.where(prob.point_valid[:, None], dx_l,
                           torch.zeros_like(dx_l))

        new_poses = lie.se3_exp(dx_p) @ poses
        new_poses = torch.where(fixed[:, :, None], poses, new_poses)
        new_points = points + dx_l

        new_cost = cost_of(new_poses, new_points)
        accept = new_cost < cost
        poses = torch.where(accept, new_poses, poses)
        points = torch.where(accept, new_points, points)
        lam = torch.clamp(torch.where(accept, lam / cfg.lm_lambda_factor,
                                      lam * cfg.lm_lambda_factor), 1e-8, 1e8)
        cost = torch.where(accept, new_cost, cost)
        return poses, points, lam, cost

    poses, points = prob.poses, prob.points
    cost = cost_of(poses, points)
    # filled on the device: a tensor built from a host value would
    # synchronize the host with the card
    lam = torch.full((), cfg.lm_lambda_init, dtype=dtype, device=dev)
    for _ in range(iters):
        poses, points, lam, cost = lm_step(poses, points, lam, cost)

    # final per-edge chi2 for outlier erasure by the caller
    p2 = prob._replace(poses=poses, points=points)
    _, _, _, _, chi2 = _build_system(p2, T_sc, adj_sc, Ks, False, delta2)
    return BAResult(poses=poses, points=points, edge_chi2=chi2, cost=cost)


def solve_ba_chunked(prob: BAProblem, T_sc, adj_sc, Ks, iters: int,
                     chunk: int = 4, should_abort=None,
                     unlock=None, relock=None,
                     cfg: BAConfig = BAConfig(),
                     cg_iters: int = 24, robust: bool = True) -> BAResult:
    """Abortable LM: run `iters` in chunks of `chunk`, checking
    `should_abort()` between chunks (the reference's mbAbortBA flag that
    LocalMapping::InterruptBA raises when a new keyframe arrives,
    LocalMapping.cc:97-108, Optimizer.cc:483).  `unlock`/`relock` bracket
    each chunk so a concurrently tracking thread can use the map while the
    chunk runs (pipeline/system.py passes the map lock).  The host waits
    for the card once per chunk, inside the unlocked section, and nowhere
    else.

    The LM damping restarts per chunk (accept/reject inside solve_ba keeps
    each chunk monotone, so a restart only costs a few inner iterations).
    The call is a span `ba.solve` with the padded (K, M, E) as `shape`;
    each chunk's wait a span `device.wait` of kind `ba_chunk`."""
    with span("ba.solve", shape=padded_shape(prob)):
        done = 0
        res = None
        cur = prob
        while done < iters:
            n = min(chunk, iters - done)
            if unlock is not None:
                unlock()
            try:
                step = solve_ba(cur, T_sc, adj_sc, Ks, iters=n, cfg=cfg,
                                cg_iters=cg_iters, robust=robust)
                with span("device.wait", kind="ba_chunk"):
                    if step.poses.device.type == "cuda":
                        torch.cuda.current_stream(
                            step.poses.device).synchronize()
            finally:
                if relock is not None:
                    relock()
            res = step
            cur = cur._replace(poses=step.poses, points=step.points)
            done += n
            if should_abort is not None and done < iters and should_abort():
                break
        return res


def padded_shape(prob: BAProblem) -> tuple:
    """(K, M, E): the problem's padded pose, point and edge counts."""
    return (int(prob.poses.shape[0]), int(prob.points.shape[0]),
            int(prob.edges.kf.shape[0]))
