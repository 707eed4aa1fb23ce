"""Sim3 pose-graph (essential graph) optimization.

Port of orbslam2_dualcam_tpu/optim/pose_graph.py
(Optimizer::OptimizeEssentialGraph, src/Optimizer.cc:699-974, in the
original): 7-DoF similarity poses per keyframe, constrained by
spanning-tree edges, strong covisibility edges (weight >= 100), and loop
edges; solved by Levenberg-Marquardt with per-edge 7x7 Jacobians obtained
by forward-mode autodiff (the residual is exact, no hand-derived Jacobian
to go stale) and a block-Jacobi PCG on the normal equations, the same
matrix-free pattern as optim/ba.py.

The reference takes the Jacobians with vmap(jacfwd) of a per-edge residual.
Here the residual is written over the edge axis (the Sim3 functions of
ops/lie.py take leading axes) and
`torch.func.jacfwd` differentiates it with respect to one 14-vector added
to every edge's pair of tangents: edge e's residual depends on edge e's
tangents only, so that Jacobian [E, 7, 14] holds exactly the per-edge
blocks.  The LM and PCG loops are Python loops whose accept/reject is a
device-side select: nothing is read back.  On the card the per-node sums
are float atomics, so two runs need not agree to the last bit.

After optimization each keyframe pose becomes [R, t/s] (Optimizer.cc:
962-967) and map points are remapped through their reference keyframe's
old->new similarity (done by the host wrapper)."""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from orbslam2_dualcam_tpu_torch.models.map import Map
from orbslam2_dualcam_tpu_torch.ops import lie
from orbslam2_dualcam_tpu_torch.utils.device import to_host, upload


def _edge_residual(xi_i, xi_j, S_i0, S_j0, S_meas_inv, fix_scale: bool):
    """r = log_sim3( S_meas^-1 * (exp(xi_i) S_i0) * (exp(xi_j) S_j0)^-1 ),
    over the leading edge axis."""
    if fix_scale:
        xi_i = torch.cat([xi_i[..., :6], torch.zeros_like(xi_i[..., 6:])], -1)
        xi_j = torch.cat([xi_j[..., :6], torch.zeros_like(xi_j[..., 6:])], -1)
    S_i = lie.sim3_exp(xi_i) @ S_i0
    S_j = lie.sim3_exp(xi_j) @ S_j0
    return lie.sim3_log(S_meas_inv @ S_i @ lie.sim3_inv(S_j))


def edge_residuals_and_jacobians(S_i0, S_j0, S_meas_inv,
                                 fix_scale: bool = False):
    """Residuals [E, 7] at zero tangents and their Jacobians (Ji, Jj), each
    [E, 7, 7], with respect to the left tangents of the two nodes."""
    E = S_i0.shape[0]

    def f(d):
        r = _edge_residual(d[:7].expand(E, 7), d[7:].expand(E, 7),
                           S_i0, S_j0, S_meas_inv, fix_scale)
        return r, r

    J, r = torch.func.jacfwd(f, has_aux=True)(
        torch.zeros(14, dtype=S_i0.dtype, device=S_i0.device))
    return r, J[..., :7], J[..., 7:]


def optimize_pose_graph(S0: torch.Tensor, e_i: torch.Tensor,
                        e_j: torch.Tensor, S_meas: torch.Tensor,
                        e_valid: torch.Tensor, fixed: torch.Tensor,
                        iters: int = 40, cg_iters: int = 32,
                        fix_scale: bool = False):
    """Solve the Sim3 pose graph on the device of S0.

    S0 [K,4,4] initial sim3 node poses (world->kf), e_i/e_j [E] int64 node
    ids, S_meas [E,4,4] measured S_i * S_j^-1, fixed [K] bool.
    Returns (optimized [K,4,4], cost 0-d tensor)."""
    K = S0.shape[0]
    dtype, dev = S0.dtype, S0.device
    S_meas_inv = lie.sim3_inv(S_meas)
    w = e_valid.to(dtype)
    free = (~fixed)[:, None]
    eye7 = torch.eye(7, dtype=dtype, device=dev)
    zK = torch.zeros((K, 7), dtype=dtype, device=dev)

    def total_cost(S):
        z = torch.zeros((e_i.shape[0], 7), dtype=dtype, device=dev)
        r = _edge_residual(z, z, S[e_i], S[e_j], S_meas_inv, fix_scale)
        return (r * r * w[:, None]).sum()

    def masked(v):
        return torch.where(free, v, torch.zeros_like(v))

    S = S0
    lam = torch.full((), 1e-6, dtype=dtype, device=dev)
    cost = total_cost(S0)
    for _ in range(iters):
        r, Ji, Jj = edge_residuals_and_jacobians(S[e_i], S[e_j], S_meas_inv,
                                                 fix_scale)
        Jiw = Ji * w[:, None, None]
        Jjw = Jj * w[:, None, None]
        # gradient
        g = zK.index_add(0, e_i, torch.einsum('eri,er->ei', Jiw, r))
        g = g.index_add(0, e_j, torch.einsum('eri,er->ei', Jjw, r))
        # block-diagonal
        H = torch.zeros((K, 7, 7), dtype=dtype, device=dev)
        H = H.index_add(0, e_i, torch.einsum('eri,erj->eij', Jiw, Ji))
        H = H.index_add(0, e_j, torch.einsum('eri,erj->eij', Jjw, Jj))
        H_d = H + lam * torch.diag_embed(
            torch.diagonal(H, dim1=-2, dim2=-1)) + 1e-6 * eye7
        # off-diagonal edge blocks W_e = Ji^T Jj
        W_e = torch.einsum('eri,erj->eij', Jiw, Jj)

        def matvec(v):
            out = torch.einsum('kij,kj->ki', H_d, v)
            out = out.index_add(0, e_i,
                                torch.einsum('eij,ej->ei', W_e, v[e_j]))
            out = out.index_add(0, e_j,
                                torch.einsum('eij,ei->ej', W_e, v[e_i]))
            return masked(out)

        P_inv = torch.linalg.inv_ex(H_d).inverse

        def precond(v):
            return masked(torch.einsum('kij,kj->ki', P_inv, v))

        rhs = masked(-g)
        x = torch.zeros_like(rhs)
        rr = rhs
        p = precond(rhs)
        rz = (rhs * p).sum()
        for _ in range(cg_iters):
            Ap = matvec(p)
            alpha = rz / torch.clamp((p * Ap).sum(), min=1e-20)
            x = x + alpha * p
            rr = rr - alpha * Ap
            zz = precond(rr)
            rz2 = (rr * zz).sum()
            p = zz + (rz2 / torch.clamp(rz, min=1e-20)) * p
            rz = rz2
        dx = x
        if fix_scale:
            dx = torch.cat([dx[:, :6], torch.zeros_like(dx[:, 6:])], -1)
        S_new = lie.sim3_exp(dx) @ S
        S_new = torch.where(fixed[:, None, None], S, S_new)
        new_cost = total_cost(S_new)
        accept = new_cost < cost
        S = torch.where(accept, S_new, S)
        lam = torch.clamp(torch.where(accept, lam * 0.3, lam * 5.0),
                          1e-8, 1e6)
        cost = torch.where(accept, new_cost, cost)
    return S, cost


# ---------------------------------------------------------------------------
# host wrapper over the map
# ---------------------------------------------------------------------------

def optimize_essential_graph(m: Map, rig, loop_kid: int, cur_kid: int,
                             old_poses: Dict[int, np.ndarray] | None = None,
                             loop_connections: Dict[int, set] | None = None,
                             fix_scale: bool = False,
                             iters: int = 40,
                             corrected_sim: Dict[int, np.ndarray] | None = None,
                             corrected_mids: Dict[int, int] | None = None) -> None:
    """Build the essential graph from the map and solve it on the device
    the rig's tensors lie on.

    Edge set (Optimizer.cc:757-860): spanning-tree edges, loop edges,
    covisibility edges with weight >= 100; measurements from `old_poses`
    (pre-correction) when provided, so the already-corrected window pulls
    the rest of the trajectory around the loop.

    `corrected_sim` maps window keyframes to their FULL corrected Sim3
    (scale included) — the reference's vScw/CorrectedSim3
    (Optimizer.cc:739-755): those nodes start at the corrected similarity
    (not the scale-stripped SE3 written into the map) and loop-edge
    measurements are taken from it, so the 7-DoF graph can redistribute
    monocular scale drift.  `corrected_mids` maps already-corrected map
    points to the window keyframe that corrected them — the reference's
    mnCorrectedByKF/mnCorrectedReference (Optimizer.cc:905-935) — so the
    remap below transforms each point exactly once."""
    kids = sorted(m.keyframes.keys())
    if len(kids) < 3:
        return
    slot = {kid: i for i, kid in enumerate(kids)}
    K = len(kids)
    corrected_sim = corrected_sim or {}
    corrected_mids = corrected_mids or {}

    def pose_of(kid) -> np.ndarray:
        if old_poses is not None and kid in old_poses:
            return old_poses[kid]
        return m.keyframes[kid].T_cw

    def current_sim(kid) -> np.ndarray:
        return corrected_sim.get(kid, m.keyframes[kid].T_cw)

    S0 = np.stack([current_sim(kid) for kid in kids]).astype(np.float32)

    edges: List[Tuple[int, int, np.ndarray]] = []
    seen = set()

    def add_edge(a: int, b: int, use_current: bool = False):
        if a not in slot or b not in slot or a == b:
            return
        kkey = (min(a, b), max(a, b))
        if kkey in seen:
            return
        seen.add(kkey)
        Sa = current_sim(a) if use_current else pose_of(a)
        Sb = current_sim(b) if use_current else pose_of(b)
        S_ab = Sa @ np.linalg.inv(Sb)
        edges.append((slot[a], slot[b], S_ab.astype(np.float32)))

    for kid in kids:
        kf = m.keyframes[kid]
        if kf.parent >= 0:
            add_edge(kid, kf.parent)
        for lk in kf.loop_edges:
            add_edge(kid, lk, use_current=True)
        for nkid, w in kf.covis.items():
            if w >= 100:
                add_edge(kid, nkid)
    if loop_connections:
        for a, bs in loop_connections.items():
            for b in bs:
                add_edge(a, b, use_current=True)

    E = len(edges)
    if E < 2:
        return
    e_i = np.asarray([e[0] for e in edges], np.int64)
    e_j = np.asarray([e[1] for e in edges], np.int64)
    S_meas = np.stack([e[2] for e in edges])
    fixed = np.zeros(K, bool)
    fixed[slot[loop_kid]] = True

    dev = rig.K.device
    S_opt, cost = optimize_pose_graph(
        upload(S0, dev), upload(e_i, dev), upload(e_j, dev),
        upload(S_meas, dev), torch.ones(E, dtype=torch.bool, device=dev),
        upload(fixed, dev), iters=iters, fix_scale=fix_scale)
    S_opt = to_host((S_opt,))[0].astype(np.float64)

    # write back SE3 poses [R, t/s] and remap points via reference KF.
    # For a point already moved by the Sim3 window correction, "old" is the
    # corrected Sim3 of the keyframe that moved it (Optimizer.cc:905-920);
    # using the pre-correction pose there would transform it twice.
    old_sim: Dict[int, np.ndarray] = {kid: pose_of(kid).copy()
                                      for kid in kids}
    new_sim: Dict[int, np.ndarray] = {}
    for kid in kids:
        S = S_opt[slot[kid]]
        sR = S[:3, :3]
        s = float(np.cbrt(np.linalg.det(sR)))
        T = np.eye(4)
        T[:3, :3] = sR / s
        T[:3, 3] = S[:3, 3] / s
        new_sim[kid] = S
        m.keyframes[kid].T_cw = T
    for mp in m.points.values():
        corr_ref = corrected_mids.get(mp.mid, -1)
        if corr_ref >= 0 and corr_ref in slot:
            ref = corr_ref
            S_old = corrected_sim[ref]
        else:
            ref = mp.ref_kid if mp.ref_kid in slot else (
                next(iter(mp.obs)) if mp.obs else -1)
            if ref < 0 or ref not in slot:
                continue
            S_old = old_sim[ref]
        S_new = new_sim[ref]
        x = S_old[:3, :3] @ mp.pos + S_old[:3, 3]         # into old kf frame
        Sni = np.linalg.inv(S_new)
        mp.pos = Sni[:3, :3] @ x + Sni[:3, 3]
