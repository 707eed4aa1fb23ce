"""Plain least squares over reprojection errors: the benchmark's reference
for the poses the tracker publishes and for the maps local BA leaves.

The program's answers are judged by the cost they leave: the reference
works out the same cost over the same observations by Levenberg-Marquardt
with landmark Schur elimination and a dense solve of the reduced camera
system.

- A tracked frame: the rig pose T_cw against its matched map points (held
  fixed), the plain squared cost sum_e inv_sigma2_e |r_e|^2 over the
  frame's final matches, as the last round of the program's pose
  optimizer minimizes it, iterated to convergence from the published pose.
- A local BA: keyframe poses and points of the window (fixed poses held),
  the Huber cost rho(chi2) (chi2 inside delta^2 = 5.991, else
  2 sqrt(delta^2 chi2) - delta^2) over every observation of the problem,
  from the problem's starting state, with the program's schedule (15 LM
  iterations in chunks of 5, the damping restarting at 1e-4 in each, x10
  on a rejected step, /10 on an accepted one) and an exact solve of each
  step's reduced system; judged by the share of that solve's reduction
  that the program's result leaves undone.

Projection: x_c = T_cw X, x_s = T_sc[cam] x_c, pixel = K[cam] (x_s / z).
Poses are updated on the left, T <- exp(xi) T, xi = (rho, phi).

`dtype` is the arithmetic of the solve: float64 is the reference;
bfloat16 is the control, the reference one step below the program's
float32 (its reduced systems are solved in float32, which torch.linalg
needs).  A solve accepts its steps by the cost in its own arithmetic; the
judged costs are evaluated in float64.  Nothing here imports the program.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

HUBER_DELTA2 = 5.991


class Rig(NamedTuple):
    K: torch.Tensor       # [ncam, 3, 3]
    T_sc: torch.Tensor    # [ncam, 4, 4] capture frame -> camera


class Problem(NamedTuple):
    """Observations e of points mp[e] from poses kf[e] through camera
    cam[e], with pixel uv[e] and weight inv_sigma2[e]."""

    poses: torch.Tensor       # [K, 4, 4]
    points: torch.Tensor      # [M, 3]
    kf: torch.Tensor          # [E] int64
    mp: torch.Tensor          # [E] int64
    cam: torch.Tensor         # [E] int64
    uv: torch.Tensor          # [E, 2]
    inv_sigma2: torch.Tensor  # [E]
    pose_fixed: torch.Tensor  # [K] bool
    point_fixed: torch.Tensor  # [M] bool


def rig_from(K: np.ndarray, T_sc: np.ndarray, device) -> Rig:
    return Rig(torch.as_tensor(K, dtype=torch.float64, device=device),
               torch.as_tensor(T_sc, dtype=torch.float64, device=device))


def _hat(v):
    z = torch.zeros_like(v[..., 0])
    return torch.stack([torch.stack([z, -v[..., 2], v[..., 1]], -1),
                        torch.stack([v[..., 2], z, -v[..., 0]], -1),
                        torch.stack([-v[..., 1], v[..., 0], z], -1)], -2)


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """[..., 6] (rho, phi) -> [..., 4, 4]."""
    rho, phi = xi[..., :3], xi[..., 3:]
    th2 = (phi * phi).sum(-1)[..., None, None]
    th = torch.sqrt(th2 + 1e-30)
    small = th2 < 1e-10
    a = torch.where(small, 1 - th2 / 6, torch.sin(th) / th)
    b = torch.where(small, 0.5 - th2 / 24, (1 - torch.cos(th)) / th2.clamp(min=1e-30))
    c = torch.where(small, 1 / 6 - th2 / 120,
                    (th - torch.sin(th)) / (th2 * th).clamp(min=1e-30))
    Kx = _hat(phi)
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device).expand(Kx.shape)
    R = eye + a * Kx + b * (Kx @ Kx)
    V = eye + b * Kx + c * (Kx @ Kx)
    t = (V @ rho[..., None])[..., 0]
    top = torch.cat([R, t[..., None]], -1)
    bottom = torch.zeros_like(top[..., :1, :])
    bottom[..., 0, 3] = 1
    return torch.cat([top, bottom], -2)


def _residuals(p: Problem, rig: Rig, jac: bool):
    T = p.poses[p.kf]                                    # [E, 4, 4]
    X = p.points[p.mp]                                   # [E, 3]
    x_c = (T[:, :3, :3] @ X[..., None])[..., 0] + T[:, :3, 3]
    Tsc = rig.T_sc[p.cam]
    R_sc = Tsc[:, :3, :3]
    x_s = (R_sc @ x_c[..., None])[..., 0] + Tsc[:, :3, 3]
    Kc = rig.K[p.cam]
    fx, fy, cx, cy = Kc[:, 0, 0], Kc[:, 1, 1], Kc[:, 0, 2], Kc[:, 1, 2]
    z = x_s[:, 2]
    z = torch.where(z.abs() > 1e-9, z, torch.full_like(z, 1e-9))
    r = p.uv - torch.stack([fx * x_s[:, 0] / z + cx, fy * x_s[:, 1] / z + cy], -1)
    if not jac:
        return r, None, None
    iz = 1.0 / z
    zero = torch.zeros_like(iz)
    Jpi = torch.stack([torch.stack([fx * iz, zero, -fx * x_s[:, 0] * iz * iz], -1),
                       torch.stack([zero, fy * iz, -fy * x_s[:, 1] * iz * iz], -1)],
                      1)                                 # [E, 2, 3]
    A = Jpi @ R_sc                                       # d pixel / d x_c
    eye = torch.eye(3, dtype=r.dtype, device=r.device).expand(len(r), 3, 3)
    Jp = -(A @ torch.cat([eye, -_hat(x_c)], -1))         # d r / d xi
    Jx = -(A @ T[:, :3, :3])                             # d r / d X
    return r, Jp, Jx


def cost(p: Problem, rig: Rig, robust: bool, dtype=torch.float64) -> float:
    """The cost of the problem's state, evaluated in `dtype`."""
    q = Problem(*(x.to(dtype) if x.is_floating_point() else x for x in p))
    rig = Rig(*(x.to(dtype) for x in rig))
    r, _, _ = _residuals(q, rig, False)
    chi2 = (r * r).sum(-1) * q.inv_sigma2
    if robust:
        chi2 = torch.where(chi2 > HUBER_DELTA2,
                           2 * torch.sqrt(HUBER_DELTA2 * chi2) - HUBER_DELTA2, chi2)
    return float(chi2.sum())


def solve(p: Problem, rig: Rig, robust: bool, dtype=torch.float64,
          iters: int = 60) -> Problem:
    """Levenberg-Marquardt from p's state to convergence, arithmetic in
    `dtype`; returns the problem at the optimum found."""
    p = Problem(*(x.to(dtype) if x.is_floating_point() else x for x in p))
    rig = Rig(*(x.to(dtype) for x in rig))
    K, M = p.poses.shape[0], p.points.shape[0]
    dev = p.poses.device
    lam = 1e-4
    best = cost(p, rig, robust, dtype)
    free_p = ~p.pose_fixed
    free_l = ~p.point_fixed
    for _ in range(iters):
        r, Jp, Jx = _residuals(p, rig, True)
        chi2 = (r * r).sum(-1) * p.inv_sigma2
        w = p.inv_sigma2
        if robust:
            w = w * torch.where(chi2 <= HUBER_DELTA2, torch.ones_like(chi2),
                                torch.sqrt(HUBER_DELTA2 / chi2.clamp(min=1e-12)))
        Jp = Jp * free_p[p.kf, None, None]
        Jx = Jx * free_l[p.mp, None, None]
        wJp = Jp * w[:, None, None]
        wJx = Jx * w[:, None, None]
        g_p = torch.zeros(K, 6, dtype=dtype, device=dev).index_add_(
            0, p.kf, (wJp.transpose(1, 2) @ r[..., None])[..., 0])
        g_l = torch.zeros(M, 3, dtype=dtype, device=dev).index_add_(
            0, p.mp, (wJx.transpose(1, 2) @ r[..., None])[..., 0])
        Hpp = torch.zeros(K, 6, 6, dtype=dtype, device=dev).index_add_(
            0, p.kf, wJp.transpose(1, 2) @ Jp)
        Hll = torch.zeros(M, 3, 3, dtype=dtype, device=dev).index_add_(
            0, p.mp, wJx.transpose(1, 2) @ Jx)
        W_e = wJp.transpose(1, 2) @ Jx                    # [E, 6, 3]
        # dense coupling W [6K, 3M] and the reduced camera system, f32+
        f = torch.float32 if dtype == torch.bfloat16 else dtype
        Hll_d = Hll + torch.diag_embed(lam * torch.diagonal(Hll, dim1=-2, dim2=-1))
        Hll_d = Hll_d + torch.diag_embed((~free_l)[:, None].to(dtype).expand(M, 3))
        Hll_inv = torch.linalg.inv(Hll_d.to(f) + 1e-12 * torch.eye(3, device=dev, dtype=f))
        Wd = torch.zeros(K, M, 6, 3, dtype=f, device=dev)
        Wd.index_put_((p.kf, p.mp), W_e.to(f), accumulate=True)
        Y = torch.einsum('kmij,mjl->kmil', Wd, Hll_inv)   # W Hll^-1
        S = (torch.block_diag(*(Hpp + torch.diag_embed(
            lam * torch.diagonal(Hpp, dim1=-2, dim2=-1))).to(f))
             - torch.einsum('kmil,nmjl->kinj', Y, Wd).reshape(6 * K, 6 * K))
        rhs = (-g_p.to(f) + torch.einsum('kmil,ml->ki', Y, g_l.to(f))).reshape(-1)
        fixed6 = p.pose_fixed.repeat_interleave(6)
        S = torch.where(fixed6[:, None] | fixed6[None, :],
                        torch.eye(6 * K, dtype=f, device=dev), S)
        rhs = torch.where(fixed6, torch.zeros_like(rhs), rhs)
        dx_p = torch.linalg.solve(S, rhs).reshape(K, 6)
        u = torch.einsum('kmij,ki->mj', Wd, dx_p)
        dx_l = -torch.einsum('mij,mj->mi', Hll_inv, g_l.to(f) + u)
        dx_l = dx_l * free_l[:, None]
        trial = p._replace(
            poses=torch.where(p.pose_fixed[:, None, None], p.poses,
                              se3_exp(dx_p.to(dtype)) @ p.poses),
            points=p.points + dx_l.to(dtype))
        c = cost(trial, rig, robust, dtype)
        if c < best:
            rel = (best - c) / max(best, 1e-300)
            p, best, lam = trial, c, max(lam / 10, 1e-12)
            if rel < 1e-13:
                break
        else:
            lam *= 10
            if lam > 1e8:
                break
    return p


def judge_pose(prog: Problem, rig: Rig, control: bool = False) -> float:
    """The share by which the published pose's cost exceeds the optimum the
    reference reaches from it over the same matches (points held).  With
    `control`, the reference's own bfloat16 solve from the same pose stands
    in for the published one."""
    ref = solve(prog, rig, robust=False)
    c_ref = cost(ref, rig, False)
    if control:
        prog = solve(prog, rig, robust=False, dtype=torch.bfloat16)
    return (cost(prog, rig, False) - c_ref) / c_ref


# the local BA's schedule as the port states it (BAConfig): 5 + 10 LM
# iterations, run as chunks of 5 that each restart the damping at 1e-4
BA_ITERS, BA_CHUNK = 15, 5


def solve_schedule(start: Problem, rig: Rig, dtype=torch.float64) -> Problem:
    """The robust local-BA solve with the program's iteration schedule."""
    p = start
    for _ in range(BA_ITERS // BA_CHUNK):
        p = solve(p, rig, robust=True, dtype=dtype, iters=BA_CHUNK)
    return p


def judge_ba(start: Problem, prog: Problem, rig: Rig,
             control: bool = False) -> tuple[float, tuple]:
    """(shortfall, (start cost, answer's cost, reference's cost)): the share
    of the cost reduction that the reference's solve with the same schedule
    reaches from the problem's start which the program's result leaves
    undone: about 0 for the same answer, 1 for a state left as it started.
    With `control`, the reference's own bfloat16 solve stands in for the
    program's result."""
    ref = solve_schedule(start, rig)
    c0, c_ref = cost(start, rig, True), cost(ref, rig, True)
    if control:
        prog = solve_schedule(start, rig, dtype=torch.bfloat16)
    c = cost(prog, rig, True)
    return (c - c_ref) / max(c0 - c_ref, 1e-12 * c0), (c0, c, c_ref)
