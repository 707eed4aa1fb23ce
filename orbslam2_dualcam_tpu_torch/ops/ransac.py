"""Batched RANSAC solvers: two-view initialization (homography /
fundamental), PnP and Horn similarity (Sim3) alignment.

Port of orbslam2_dualcam_tpu/ops/ransac.py: the original's
Initializer.cc (H and F estimated side by side, model chosen by the score
ratio RH > 0.40, then ReconstructH / ReconstructF with cheirality tests),
PnPsolver.cc (here 6-point DLT and plane-homography hypotheses, then
Gauss-Newton on the consensus set) and Sim3Solver.cc (3-point Horn), each
with a fixed budget of hypotheses solved and scored as one batch.

Every hypothesis is a row of a leading batch axis (the reference's vmap):
the minimal-set solvers take ``[..., k, 2]`` samples.  Sampling is split
from solving: `two_view_samples` draws the minimal sets with a
`torch.Generator` on the CPU (so a run on the card and a run on the CPU draw
the same sets) and `two_view_solve` is a pure function of the sets, so a
test can feed it sets drawn elsewhere; `pnp_samples` / `pnp_solve` and
`sim3_samples` / `sim3_solve` split the same way.

Small inverses are closed forms: `torch.linalg.inv` raises on a singular
matrix, and degenerate samples make singular ones; the closed forms give
inf/nan there, which every later comparison reads as "not an inlier".
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from orbslam2_dualcam_tpu_torch.ops import epipolar as epi
from orbslam2_dualcam_tpu_torch.ops import lie


def _sample_indices(gen: torch.Generator, n_hyp: int, k: int, n: int,
                    weights: torch.Tensor | None = None) -> torch.Tensor:
    """[n_hyp, k] random indices in [0, n), on the CPU.  Sampling with
    replacement within a hypothesis is tolerated (degenerate samples score
    0 inliers); `weights` biases sampling to valid rows."""
    if weights is None:
        return torch.randint(0, n, (n_hyp, k), generator=gen)
    w = torch.clamp(weights.detach().to("cpu", torch.float32), min=1e-9)
    return torch.multinomial(w.expand(n_hyp, n), k, replacement=True,
                             generator=gen)


_inv3 = lie.inv3
_det3 = lie.det3


def _normalize_2d(uv: torch.Tensor, valid: torch.Tensor):
    """Hartley normalization (Initializer::Normalize, Initializer.cc:767+)."""
    w = valid.to(torch.float32)
    n = torch.clamp(w.sum(), min=1.0)
    mean = (uv * w[:, None]).sum(0) / n
    d = (uv - mean).abs() * w[:, None]
    md = torch.clamp(d.sum(0) / n, min=1e-6)
    s = 1.0 / md
    z = torch.zeros_like(s[0])
    o = torch.ones_like(s[0])
    T = torch.stack([torch.stack([s[0], z, -mean[0] * s[0]]),
                     torch.stack([z, s[1], -mean[1] * s[1]]),
                     torch.stack([z, z, o])]).to(uv.dtype)
    uvn = (uv - mean) * s
    return uvn, T


# ---------------------------------------------------------------------------
# homography
# ---------------------------------------------------------------------------

def _h_rows(uv1: torch.Tensor, uv2: torch.Tensor):
    x, y = uv1[..., 0], uv1[..., 1]
    u, v = uv2[..., 0], uv2[..., 1]
    z = torch.zeros_like(x)
    o = torch.ones_like(x)
    r1 = torch.stack([x, y, o, z, z, z, -u * x, -u * y, -u], -1)
    r2 = torch.stack([z, z, z, x, y, o, -v * x, -v * y, -v], -1)
    return r1, r2


def _null_vector(AtA: torch.Tensor) -> torch.Tensor:
    """Eigenvector of the smallest eigenvalue of a symmetric [..., 9, 9]
    matrix as [..., 3, 3] (defined up to sign)."""
    _, v = torch.linalg.eigh(AtA)
    return v[..., :, 0].reshape(*AtA.shape[:-2], 3, 3)


def _h_from_4pts(uv1: torch.Tensor, uv2: torch.Tensor) -> torch.Tensor:
    """DLT homography from 4 correspondences (uv1 -> uv2), each [..., 4, 2]."""
    r1, r2 = _h_rows(uv1, uv2)
    A = torch.cat([r1, r2], dim=-2)                       # [..., 8, 9]
    return _null_vector(A.transpose(-1, -2) @ A)


def _h_transfer_err2(H: torch.Tensor, uv1: torch.Tensor, uv2: torch.Tensor):
    """Symmetric transfer errors (CheckHomography, Initializer.cc:142-238).
    H [..., 3, 3]; uv1, uv2 [N, 2] -> two [..., N]."""
    def xfer(H, a, b):
        x = torch.cat([a, torch.ones_like(a[..., :1])], -1) @ H.transpose(-1, -2)
        zc = x[..., 2:]
        zc = torch.where(zc.abs() > 1e-9, zc, torch.full_like(zc, 1e-9))
        return ((x[..., :2] / zc - b) ** 2).sum(-1)

    eye = torch.eye(3, dtype=H.dtype, device=H.device)
    Hinv = _inv3(H + 1e-12 * eye)
    return xfer(H, uv1, uv2), xfer(Hinv, uv2, uv1)


# ---------------------------------------------------------------------------
# fundamental
# ---------------------------------------------------------------------------

def _rank2(F: torch.Tensor) -> torch.Tensor:
    U, S, Vt = torch.linalg.svd(F)
    S = torch.cat([S[..., :2], torch.zeros_like(S[..., 2:])], -1)
    return (U * S[..., None, :]) @ Vt


def _f_from_8pts(uv1: torch.Tensor, uv2: torch.Tensor) -> torch.Tensor:
    """8-point algorithm with rank-2 projection, inputs [..., 8, 2] each."""
    x1 = torch.cat([uv1, torch.ones_like(uv1[..., :1])], -1)
    x2 = torch.cat([uv2, torch.ones_like(uv2[..., :1])], -1)
    A = (x2[..., :, None] * x1[..., None, :]).reshape(*uv1.shape[:-1], 9)
    return _rank2(_null_vector(A.transpose(-1, -2) @ A))


def _h_refit(uv1n: torch.Tensor, uv2n: torch.Tensor,
             w: torch.Tensor) -> torch.Tensor:
    """Least-squares homography over all inliers (weighted 9x9 eigh).
    Normalized coords keep the normal equations well-conditioned."""
    r1, r2 = _h_rows(uv1n, uv2n)
    A = torch.cat([r1 * w[:, None], r2 * w[:, None]])
    return _null_vector(A.T @ A)


def _f_refit(uv1n: torch.Tensor, uv2n: torch.Tensor,
             w: torch.Tensor) -> torch.Tensor:
    """Least-squares fundamental over all inliers + rank-2 projection (the
    8-point minimal fit is too noisy in float32 to decompose into (R, t))."""
    x1 = torch.cat([uv1n, torch.ones_like(uv1n[:, :1])], -1)
    x2 = torch.cat([uv2n, torch.ones_like(uv2n[:, :1])], -1)
    A = (x2[:, :, None] * x1[:, None, :]).reshape(-1, 9) * w[:, None]
    return _rank2(_null_vector(A.T @ A))


def _f_epipolar_err2(F: torch.Tensor, uv1: torch.Tensor, uv2: torch.Tensor):
    """Squared point-line distances both directions (CheckFundamental,
    Initializer.cc:240-330).  F [..., 3, 3]; uv1, uv2 [N, 2]."""
    x1 = torch.cat([uv1, torch.ones_like(uv1[..., :1])], -1)
    x2 = torch.cat([uv2, torch.ones_like(uv2[..., :1])], -1)
    l2 = x1 @ F.transpose(-1, -2)        # line in image 2
    l1 = x2 @ F
    d2 = ((l2 * x2).sum(-1) ** 2) / torch.clamp(
        l2[..., 0] ** 2 + l2[..., 1] ** 2, min=1e-12)
    d1 = ((l1 * x1).sum(-1) ** 2) / torch.clamp(
        l1[..., 0] ** 2 + l1[..., 1] ** 2, min=1e-12)
    return d1, d2


class TwoViewResult(NamedTuple):
    success: torch.Tensor    # bool
    is_h: torch.Tensor       # bool: model chosen
    T_21: torch.Tensor       # (4,4) pose of view2 w.r.t. view1 (unit-norm t)
    points: torch.Tensor     # (N,3) triangulated in view-1 frame
    inliers: torch.Tensor    # (N,) bool: triangulated good points
    score_h: torch.Tensor
    score_f: torch.Tensor


def _score(err2_a, err2_b, valid, sigma2, th, th_score):
    """Initializer scoring: sum over inliers of (thScore - err2/sigma2),
    counting both directions (Initializer.cc:142-330).  Sums run over the
    last axis."""
    ca = err2_a / sigma2
    cb = err2_b / sigma2
    good = (ca < th) & (cb < th) & valid
    zero = torch.zeros_like(ca)
    sa = torch.where(valid & (ca < th_score), th_score - ca, zero)
    sb = torch.where(valid & (cb < th_score), th_score - cb, zero)
    return sa.sum(-1) + sb.sum(-1), good


def two_view_samples(gen: torch.Generator, n_hyp: int,
                     valid: torch.Tensor):
    """Draw the minimal sets of `two_view_solve`: (idx_h [n_hyp, 4],
    idx_f [n_hyp, 8]) on valid's device, sampled among the valid rows."""
    w = valid.to(torch.float32)
    N = valid.shape[0]
    idx_h = _sample_indices(gen, n_hyp, 4, N, w)
    idx_f = _sample_indices(gen, n_hyp, 8, N, w)
    return idx_h.to(valid.device), idx_f.to(valid.device)


def two_view_solve(idx_h: torch.Tensor, idx_f: torch.Tensor,
                   uv1: torch.Tensor, uv2: torch.Tensor, valid: torch.Tensor,
                   K: torch.Tensor, sigma: float = 1.0,
                   min_parallax_deg: float = 1.0,
                   min_triangulated: int = 50) -> TwoViewResult:
    """Two-view initialization from given minimal sets: idx_h [n_hyp, 4]
    homography samples and idx_f [n_hyp, 8] fundamental samples, rows of
    uv1/uv2 [N, 2] (matched undistorted pixels; valid [N])."""
    sigma2 = sigma * sigma
    uv1n, T1 = _normalize_2d(uv1, valid)
    uv2n, T2 = _normalize_2d(uv2, valid)
    T2inv = _inv3(T2)

    # ---- homography hypotheses (normalized coords) ----
    Hs = T2inv @ _h_from_4pts(uv1n[idx_h], uv2n[idx_h]) @ T1
    e1, e2 = _h_transfer_err2(Hs, uv1, uv2)
    h_scores, h_good = _score(e1, e2, valid, sigma2, 5.991, 5.991)
    bh = torch.argmax(h_scores)
    h_inl = h_good.index_select(0, bh[None])[0]
    # refit on all inliers, re-derive the inlier set once
    H_best = T2inv @ _h_refit(uv1n, uv2n, h_inl.to(uv1.dtype)) @ T1
    e1h, e2h = _h_transfer_err2(H_best, uv1, uv2)
    score_h, h_inl = _score(e1h, e2h, valid, sigma2, 5.991, 5.991)

    # ---- fundamental hypotheses ----
    Fs = T2.T @ _f_from_8pts(uv1n[idx_f], uv2n[idx_f]) @ T1
    e1, e2 = _f_epipolar_err2(Fs, uv1, uv2)
    f_scores, f_good = _score(e1, e2, valid, sigma2, 3.841, 5.991)
    bf = torch.argmax(f_scores)
    f_inl = f_good.index_select(0, bf[None])[0]
    F_best = T2.T @ _f_refit(uv1n, uv2n, f_inl.to(uv1.dtype)) @ T1
    e1f, e2f = _f_epipolar_err2(F_best, uv1, uv2)
    score_f, f_inl = _score(e1f, e2f, valid, sigma2, 3.841, 5.991)

    # ---- model selection: RH = SH/(SH+SF) > 0.40 -> H (Initializer.cc:135)
    rh = score_h / torch.clamp(score_h + score_f, min=1e-9)
    use_h = rh > 0.40

    # ---- reconstruct both, select on device ----
    ok_h, T_h, P_h, inl3d_h = _reconstruct_h(H_best, K, uv1, uv2, h_inl,
                                             sigma2, min_parallax_deg,
                                             min_triangulated)
    ok_f, T_f, P_f, inl3d_f = _reconstruct_f(F_best, K, uv1, uv2, f_inl,
                                             sigma2, min_parallax_deg,
                                             min_triangulated)
    return TwoViewResult(success=torch.where(use_h, ok_h, ok_f), is_h=use_h,
                         T_21=torch.where(use_h, T_h, T_f),
                         points=torch.where(use_h, P_h, P_f),
                         inliers=torch.where(use_h, inl3d_h, inl3d_f),
                         score_h=score_h, score_f=score_f)


def two_view_init(gen: torch.Generator, uv1: torch.Tensor, uv2: torch.Tensor,
                  valid: torch.Tensor, K: torch.Tensor, n_hyp: int = 256,
                  sigma: float = 1.0, min_parallax_deg: float = 1.0,
                  min_triangulated: int = 50) -> TwoViewResult:
    """Full monocular two-view initialization (Initializer::Initialize).

    uv1/uv2 [N,2] matched undistorted pixels; valid [N].  Returns
    TwoViewResult with T_21 scaled to unit translation (the caller
    normalizes by median depth, as Tracking.cc:2063-2087 does)."""
    idx_h, idx_f = two_view_samples(gen, n_hyp, valid)
    return two_view_solve(idx_h, idx_f, uv1, uv2, valid, K, sigma,
                          min_parallax_deg, min_triangulated)


def _triangulate_and_check(R, t, K, uv1, uv2, match_inl, sigma2,
                           min_parallax_deg):
    """CheckRT (Initializer.cc:752-910): triangulate with candidate motion,
    count points passing cheirality/parallax/reprojection both views."""
    T1 = torch.eye(4, dtype=R.dtype, device=R.device)
    T2 = lie.se3(R, t)
    P1 = K @ T1[:3, :4]
    P2 = K @ T2[:3, :4]
    X = epi.triangulate_dlt(P1, P2, uv1, uv2)
    finite = torch.isfinite(X).all(-1)
    X = torch.where(finite[:, None], X, torch.zeros_like(X))
    c2 = -R.T @ t
    ray1 = X
    ray2 = X - c2
    cosp = (ray1 * ray2).sum(-1) / torch.clamp(
        torch.linalg.vector_norm(ray1, dim=-1) *
        torch.linalg.vector_norm(ray2, dim=-1), min=1e-12)
    x2 = lie.se3_apply(T2, X)
    z1 = X[:, 2]
    z2 = x2[:, 2]

    def reproj2(P, X, uv):
        Xh = torch.cat([X, torch.ones_like(X[:, :1])], -1)
        p = Xh @ P.T
        zc = p[:, 2:]
        zc = torch.where(zc.abs() > 1e-9, zc, torch.full_like(zc, 1e-9))
        return ((p[:, :2] / zc - uv) ** 2).sum(-1)

    good_parallax = cosp < math.cos(math.radians(min_parallax_deg))
    ok = match_inl & finite & (z1 > 0) & (z2 > 0)
    ok = ok & (reproj2(P1, X, uv1) < 4.0 * sigma2)
    ok = ok & (reproj2(P2, X, uv2) < 4.0 * sigma2)
    n_good = (ok & good_parallax).sum()
    # parallax statistic: the 50th-smallest cos among the good points
    cos_sorted = torch.sort(torch.where(ok, cosp, torch.ones_like(cosp))).values
    idx50 = torch.clamp(torch.clamp(ok.sum() - 1, min=0), max=50)
    parallax_cos = cos_sorted.index_select(0, idx50[None])[0]
    return n_good, parallax_cos, X, ok & good_parallax


def _pick_motion(cands, stats, inl, min_parallax_deg, min_tri):
    """Choose the motion hypothesis with dominant cheirality and apply the
    acceptance gates (Initializer.cc:540-575)."""
    n_goods = torch.stack([s[0] for s in stats])
    best = torch.argmax(n_goods)[None]
    n_best = n_goods.index_select(0, best)[0]
    n_total = inl.sum()
    # accept: clear winner (runner-up < 0.75*best), enough points, enough
    # parallax
    n_second = torch.sort(n_goods).values[-2]
    cosp = torch.stack([s[1] for s in stats]).index_select(0, best)[0]
    ok = ((n_best > torch.clamp(0.9 * n_total, min=min_tri)) &
          (n_second < 0.75 * n_best) &
          (cosp < math.cos(math.radians(min_parallax_deg))))
    Rb = torch.stack([c[0] for c in cands]).index_select(0, best)[0]
    tb = torch.stack([c[1] for c in cands]).index_select(0, best)[0]
    X = torch.stack([s[2] for s in stats]).index_select(0, best)[0]
    good = torch.stack([s[3] for s in stats]).index_select(0, best)[0]
    return ok, lie.se3(Rb, tb), X, good


def _reconstruct_f(F, K, uv1, uv2, inl, sigma2, min_parallax_deg, min_tri):
    """ReconstructF (Initializer.cc:488-582): E = K'FK, 4 motions, pick the
    one with dominant cheirality."""
    E = K.T @ F @ K
    U, _, Vt = torch.linalg.svd(E)
    W = torch.tensor([[0., -1, 0], [1, 0, 0], [0, 0, 1]], dtype=E.dtype,
                     device=E.device)

    def fixdet(R):
        return R * torch.sign(_det3(R))

    R1 = fixdet(U @ W @ Vt)
    R2 = fixdet(U @ W.T @ Vt)
    t = U[:, 2]
    t = t / torch.clamp(torch.linalg.vector_norm(t), min=1e-12)
    cands = [(R1, t), (R1, -t), (R2, t), (R2, -t)]
    stats = [_triangulate_and_check(R, tt, K, uv1, uv2, inl, sigma2,
                                    min_parallax_deg) for R, tt in cands]
    return _pick_motion(cands, stats, inl, min_parallax_deg, min_tri)


def _reconstruct_h(H, K, uv1, uv2, inl, sigma2, min_parallax_deg, min_tri):
    """ReconstructH (Initializer.cc:584-750, Faugeras SVD decomposition,
    8 motion candidates).  The factor det(U) det(V) absorbs the signs the
    SVD is free to choose."""
    A = epi._inv_K(K) @ H @ K
    U, S, Vt = torch.linalg.svd(A)
    s = _det3(U) * _det3(Vt)
    d1, d2, d3 = S[0], S[1], S[2]
    zero = torch.zeros_like(d1)
    one = torch.ones_like(d1)
    den13 = torch.clamp(d1 * d1 - d3 * d3, min=1e-12)
    x1 = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) / den13, min=0.0))
    x3 = torch.sqrt(torch.clamp((d2 * d2 - d3 * d3) / den13, min=0.0))
    prod = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3),
                                  min=0.0))
    st_pos = prod / torch.clamp((d1 + d3) * d2, min=1e-12)
    ct = torch.sqrt(torch.clamp((d2 * d2 + d1 * d3) ** 2, min=0.0)) / \
        torch.clamp((d1 + d3) * d2, min=1e-12)
    sp = prod / torch.clamp((d1 - d3) * d2, min=1e-12)
    cp = (d1 * d3 - d2 * d2) / torch.clamp((d1 - d3) * d2, min=1e-12)
    # 8 candidates: eps1, eps3 in {+,-}, d' = +-d2
    cands = []
    for e1 in (1.0, -1.0):
        for e3 in (1.0, -1.0):
            # d' = +d2 case
            Rp = torch.stack([torch.stack([ct, zero, -e1 * e3 * st_pos]),
                              torch.stack([zero, one, zero]),
                              torch.stack([e1 * e3 * st_pos, zero, ct])])
            tp = (d1 - d3) * torch.stack([e1 * x1, zero, -e3 * x3])
            cands.append((Rp, tp))
            # d' = -d2 case
            Rn = torch.stack([torch.stack([cp, zero, e1 * e3 * sp]),
                              torch.stack([zero, -one, zero]),
                              torch.stack([e1 * e3 * sp, zero, -cp])])
            tn = (d1 + d3) * torch.stack([e1 * x1, zero, e3 * x3])
            cands.append((Rn, tn))

    stats = []
    mats = []
    for R_, t_ in cands:
        R = s * (U @ R_ @ Vt)
        t = U @ t_
        t = t / torch.clamp(torch.linalg.vector_norm(t), min=1e-12)
        mats.append((R, t))
        stats.append(_triangulate_and_check(R, t, K, uv1, uv2, inl, sigma2,
                                            min_parallax_deg))
    return _pick_motion(mats, stats, inl, min_parallax_deg, min_tri)


# ---------------------------------------------------------------------------
# PnP
# ---------------------------------------------------------------------------

def _se3_batch(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3], [..., 3] -> [..., 4, 4]."""
    top = torch.cat([R, t[..., :, None]], -1)
    bot = torch.zeros_like(top[..., :1, :])
    bot[..., 0, 3] = 1.0
    return torch.cat([top, bot], -2)


def _pnp_dlt(X: torch.Tensor, uv_n: torch.Tensor,
             w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """DLT absolute pose from world points X [..., n, 3] and normalized
    image coords uv_n [..., n, 2]: the minimal 6-point solve, or with
    weights w [..., n] the overdetermined refit over all rows (the
    reference's _pnp_dlt and _pnp_dlt_weighted).  3D points
    are Hartley-normalized before the solve: without it the f32 12-dim
    null-space extraction is too ill-conditioned to beat even a loose
    inlier gate.  The null vector's free sign is fixed by det(R) > 0."""
    if w is None:
        w = torch.ones_like(X[..., 0])
    wsum = torch.clamp(w.sum(-1), min=1e-9)[..., None]
    c3 = (X * w[..., None]).sum(-2) / wsum                         # [..., 3]
    Xc = X - c3[..., None, :]
    s3 = torch.clamp((torch.linalg.vector_norm(Xc, dim=-1) * w).sum(-1)
                     / wsum[..., 0], min=1e-6)[..., None, None]
    Xn = Xc / s3

    x, y, z3 = Xn[..., 0], Xn[..., 1], Xn[..., 2]
    u, v = uv_n[..., 0], uv_n[..., 1]
    zr = torch.zeros_like(x)
    o = torch.ones_like(x)
    r1 = torch.stack([x, y, z3, o, zr, zr, zr, zr,
                      -u * x, -u * y, -u * z3, -u], -1)
    r2 = torch.stack([zr, zr, zr, zr, x, y, z3, o,
                      -v * x, -v * y, -v * z3, -v], -1)
    A = torch.cat([r1 * w[..., None], r2 * w[..., None]], -2)
    _, _, Vt = torch.linalg.svd(A, full_matrices=False)
    P = Vt[..., -1, :].reshape(*A.shape[:-2], 3, 4)
    # denormalize 3D: X -> (X - c3)/s3
    P3 = P[..., :, :3] / s3
    p4 = P[..., :, 3] - (P3 @ c3[..., :, None])[..., 0]
    # P = lambda [R|t]; force lambda > 0 (det(R_raw) = lambda^3)
    sg = torch.sign(_det3(P3))
    R_raw = P3 * sg[..., None, None]
    p4 = p4 * sg[..., None]
    U, S, Vt2 = torch.linalg.svd(R_raw)
    d = torch.sign(_det3(U @ Vt2))
    diag = torch.stack([torch.ones_like(d), torch.ones_like(d), d], -1)
    R = (U * diag[..., None, :]) @ Vt2
    scale = (2.0 + d) / torch.clamp(S[..., 0] + S[..., 1] + d * S[..., 2],
                                    min=1e-12)
    return _se3_batch(R, p4 * scale[..., None])


def _pnp_planar_hypotheses(idx: torch.Tensor, X: torch.Tensor,
                           uv_n: torch.Tensor,
                           valid: torch.Tensor) -> torch.Tensor:
    """Pose hypotheses for (near-)planar point sets via plane-homography
    decomposition, one per row of idx [n_hyp, 4].

    The 6-point DLT is rank-degenerate when the sampled world points are
    coplanar, the common case for wall-viewing relocalization.  Here: fit
    the dominant plane (weighted PCA), express points in plane coordinates
    (u, v), estimate the 2D->2D homography from the 4-point samples, and
    decompose H = [R e1, R e2, R P0 + t] into a pose.  Returns
    [n_hyp, 4, 4]."""
    w = valid.to(X.dtype)
    wsum = torch.clamp(w.sum(), min=1e-9)
    c = (X * w[:, None]).sum(0) / wsum
    Xc = (X - c) * w[:, None]
    C = Xc.T @ Xc / wsum
    _, evecs = torch.linalg.eigh(C)
    e1 = evecs[:, 2]
    e2 = evecs[:, 1]
    pu = (X - c) @ e1
    pv = (X - c) @ e2

    plane_pts = torch.stack([pu[idx], pv[idx]], -1)        # [H, 4, 2]
    Hn = _h_from_4pts(plane_pts, uv_n[idx])                # plane -> normalized
    lam = 0.5 * (torch.linalg.vector_norm(Hn[..., :, 0], dim=-1) +
                 torch.linalg.vector_norm(Hn[..., :, 1], dim=-1))
    Hs = Hn / torch.where(lam > 1e-12, lam,
                          torch.full_like(lam, 1e-12))[:, None, None]
    # orthonormalize r1, r2 symmetrically
    U, _, Vt = torch.linalg.svd(Hs[..., :, :2])            # [H,3,3], [H,2,2]
    R12 = U[..., :, :2] @ Vt
    r1o = R12[..., :, 0]
    r2o = R12[..., :, 1]
    B = torch.stack([e1, e2, torch.linalg.cross(e1, e2)], 1)   # world<-plane

    def pose(r1o, r2o, h3):
        R_pc = torch.stack([r1o, r2o, torch.linalg.cross(r1o, r2o)], -1)
        R = R_pc @ B.T
        return R, h3 - R @ c

    R, t = pose(r1o, r2o, Hs[..., :, 2])
    # flip if cheirality majority fails (homography sign ambiguity)
    z = (torch.einsum('hij,nj->hni', R, X) + t[:, None, :])[..., 2]
    n_front = torch.where(w > 0, (z > 0).to(X.dtype),
                          torch.zeros_like(z)).sum(-1)
    flip = n_front < 0.5 * wsum
    Rf, tf = pose(-r1o, -r2o, -Hs[..., :, 2])
    return torch.where(flip[:, None, None], _se3_batch(Rf, tf),
                       _se3_batch(R, t))


def pnp_samples(gen: torch.Generator, n_hyp: int, valid: torch.Tensor):
    """Draw the minimal sets of `pnp_solve`: (idx6 [n_hyp, 6] DLT samples,
    idx4 [n_hyp, 4] plane-homography samples) on valid's device, sampled
    among the valid rows."""
    w = valid.to(torch.float32)
    N = valid.shape[0]
    idx6 = _sample_indices(gen, n_hyp, 6, N, w)
    idx4 = _sample_indices(gen, n_hyp, 4, N, w)
    return idx6.to(valid.device), idx4.to(valid.device)


def pnp_solve(idx6: torch.Tensor, idx4: torch.Tensor, X: torch.Tensor,
              uv: torch.Tensor, valid: torch.Tensor, K: torch.Tensor,
              th_px: float = 5.991 ** 0.5, refine_rounds: int = 2,
              min_inliers: int = 12):
    """Batched DLT-PnP RANSAC from given minimal sets (replaces
    PnPsolver::iterate, PnPsolver.cc:201-294).  X [N,3] world, uv [N,2]
    pixels (single camera).  The 6-point hypotheses of idx6 and the planar
    ones of idx4 compete for the consensus set; the winner is then refined
    on its inliers (`refine_rounds`x), replacing PnPsolver::Refine.
    Returns (T_cw, inliers, n_inliers, success: n_inliers >= min_inliers);
    nothing is read back."""
    Kinv = epi._inv_K(K)
    uv_n = (torch.cat([uv, torch.ones_like(uv[:, :1])], -1) @ Kinv.T)[:, :2]

    def classify(T, th):
        """T [..., 4, 4] -> inliers [..., N], count [...]."""
        xc = X @ T[..., :3, :3].transpose(-1, -2) + T[..., None, :3, 3]
        zc = xc[..., 2]
        z = torch.where(zc.abs() > 1e-9, zc, torch.full_like(zc, 1e-9))
        u = K[0, 0] * xc[..., 0] / z + K[0, 2]
        v = K[1, 1] * xc[..., 1] / z + K[1, 2]
        err2 = (u - uv[:, 0]) ** 2 + (v - uv[:, 1]) ** 2
        inl = valid & (zc > 0) & (err2 < th * th)
        return inl, inl.sum(-1)

    # LO-RANSAC schedule: minimal hypotheses are noise-amplified, so the
    # consensus search runs at a loose 4x gate; the winner is then refined
    # on its loose inliers and the gate annealed down to th_px.
    th_search = 4.0 * th_px
    Ts = torch.cat([_pnp_dlt(X[idx6], uv_n[idx6]),
                    _pnp_planar_hypotheses(idx4, X, uv_n, valid)])
    # a degenerate sample may give a non-finite pose: it scores 0 inliers
    Ts = torch.where(torch.isfinite(Ts).all(-1).all(-1)[:, None, None], Ts,
                     torch.eye(4, dtype=Ts.dtype, device=Ts.device))
    inls, counts = classify(Ts, th_search)
    best = torch.argmax(counts)[None]
    T = Ts.index_select(0, best)[0]
    inl = inls.index_select(0, best)[0]
    # nonlinear refinement on the inlier set: Gauss-Newton, not a DLT
    # refit, which is rank-degenerate on planar point sets
    ths = [2.0 * th_px] + [th_px] * max(refine_rounds - 1, 1)
    for th in ths:
        T = _pnp_gn_refine(T, X, uv_n, inl.to(X.dtype))
        inl, _ = classify(T, th)
    n = inl.sum()
    return T, inl, n, n >= min_inliers


def pnp_ransac(gen: torch.Generator, X: torch.Tensor, uv: torch.Tensor,
               valid: torch.Tensor, K: torch.Tensor, n_hyp: int = 256,
               th_px: float = 5.991 ** 0.5, refine_rounds: int = 2,
               min_inliers: int = 12):
    """`pnp_samples` on `gen` (a CPU generator), then `pnp_solve`."""
    idx6, idx4 = pnp_samples(gen, n_hyp, valid)
    return pnp_solve(idx6, idx4, X, uv, valid, K, th_px, refine_rounds,
                     min_inliers)


def _pnp_gn_refine(T: torch.Tensor, X: torch.Tensor, uv_n: torch.Tensor,
                   w: torch.Tensor, iters: int = 8) -> torch.Tensor:
    """Weighted Gauss-Newton pose refinement in normalized image coords.
    The 6x6 system is solved by LU without the host-side singularity
    check."""
    eye3 = torch.eye(3, dtype=X.dtype, device=X.device).expand(
        X.shape[0], 3, 3)
    eye6 = torch.eye(6, dtype=X.dtype, device=X.device)
    for _ in range(iters):
        xc = lie.se3_apply(T, X)
        zc = xc[:, 2]
        z = torch.where(zc.abs() > 1e-9, zc, torch.full_like(zc, 1e-9))
        r = torch.stack([xc[:, 0] / z, xc[:, 1] / z], -1) - uv_n   # [N,2]
        iz = 1.0 / z
        zeros = torch.zeros_like(iz)
        Jpi = torch.stack([
            torch.stack([iz, zeros, -xc[:, 0] * iz * iz], -1),
            torch.stack([zeros, iz, -xc[:, 1] * iz * iz], -1)], 1)  # [N,2,3]
        Jx = torch.cat([eye3, -lie.hat(xc)], -1)              # [N,3,6]
        J = Jpi @ Jx                                                # [N,2,6]
        Jw = J * w[:, None, None]
        H = torch.einsum('nri,nrj->ij', Jw, J) + 1e-8 * eye6
        b = torch.einsum('nri,nr->i', Jw, r)
        dx = -torch.linalg.solve_ex(H, b).result
        T = lie.se3_exp(dx) @ T
    return T


# ---------------------------------------------------------------------------
# Horn Sim3
# ---------------------------------------------------------------------------

def horn_sim3(P1: torch.Tensor, P2: torch.Tensor, fix_scale: bool = False):
    """Closed-form similarity aligning point sets: (R, t, s) minimizing
    ||P1 - (s R P2 + t)||, Horn's quaternion method as in
    Sim3Solver::ComputeSim3 (Sim3Solver.cc:251-363).  P1, P2 [..., n, 3]
    (n >= 3); returns R [..., 3, 3], t [..., 3], s [...].  The quaternion is
    the eigenvector of the largest eigenvalue, whose sign is free: compare
    rotations, not quaternions."""
    # centroids summed in float64: for a repeated point the mean is then the
    # point itself, so a degenerate triple's scale is exactly 0 and it
    # scores no inlier (in float32, the reference's sum * (1/3) can miss the
    # point by an ulp, and the triple's garbage model then scores its own
    # point)
    c1 = P1.to(torch.float64).mean(-2).to(P1.dtype)
    c2 = P2.to(torch.float64).mean(-2).to(P2.dtype)
    Q1 = P1 - c1[..., None, :]
    Q2 = P2 - c2[..., None, :]
    M = Q2.transpose(-1, -2) @ Q1     # correlation (rotating P2 into P1)
    Sxx, Sxy, Sxz = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    Syx, Syy, Syz = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    Szx, Szy, Szz = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    Nm = torch.stack([
        torch.stack([Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx], -1),
        torch.stack([Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz], -1),
        torch.stack([Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy], -1),
        torch.stack([Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz], -1)],
        -2)
    _, v = torch.linalg.eigh(Nm)
    R = lie.quat_to_rot(v[..., :, -1])
    if fix_scale:
        s = torch.ones_like(c1[..., 0])
    else:
        s = (Q1 * (Q2 @ R.transpose(-1, -2))).sum((-2, -1)) / torch.clamp(
            (Q2 * Q2).sum((-2, -1)), min=1e-12)
    t = c1 - s[..., None] * (R @ c2[..., :, None])[..., 0]
    return R, t, s


def sim3_samples(gen: torch.Generator, n_hyp: int, valid: torch.Tensor):
    """Draw the minimal sets of `sim3_solve`: [n_hyp, 3] on valid's device,
    sampled among the valid rows."""
    idx = _sample_indices(gen, n_hyp, 3, valid.shape[0], valid.to(torch.float32))
    return idx.to(valid.device)


def sim3_solve(idx: torch.Tensor, P1: torch.Tensor, P2: torch.Tensor,
               valid: torch.Tensor, uv1: torch.Tensor, uv2: torch.Tensor,
               K1: torch.Tensor, K2: torch.Tensor, sigma2_1: torch.Tensor,
               sigma2_2: torch.Tensor, fix_scale: bool = False,
               chi2: float = 9.210):
    """Batched 3-point Sim3 RANSAC from given minimal sets idx [n_hyp, 3]
    (Sim3Solver::iterate, Sim3Solver.cc:158-232): a Horn (R, t, s) per
    camera-frame point triple, inliers by mutual reprojection chi2 (9.210
    sigma^2, Sim3Solver.cc:105-106).

    P1/P2 [N, 3] matched points in the two *camera* frames, uv1/uv2 their
    pixel observations.  Returns (R, t, s mapping 2 -> 1, inliers, count,
    ok = count >= 6); the best hypothesis is the first of the largest count.
    A degenerate triple (repeated or collinear points) gives inf/nan from
    the adjugate inverse, which compares as no inlier; nothing is read
    back."""
    R, t, s = horn_sim3(P1[idx], P2[idx], fix_scale)          # [H,3,3] ...

    def project(K, X):
        z = torch.where(X[..., 2].abs() > 1e-9, X[..., 2],
                        torch.full_like(X[..., 2], 1e-9))
        return torch.stack([K[0, 0] * X[..., 0] / z + K[0, 2],
                            K[1, 1] * X[..., 1] / z + K[1, 2]], -1)

    p2in1 = s[:, None, None] * (P2 @ R.transpose(-1, -2)) + t[:, None, :]
    e1 = ((project(K1, p2in1) - uv1) ** 2).sum(-1)
    sR_inv = lie.inv3(s[:, None, None] * R)
    p1in2 = (P1 - t[:, None, :]) @ sR_inv.transpose(-1, -2)
    e2 = ((project(K2, p1in2) - uv2) ** 2).sum(-1)
    inls = valid & (e1 < chi2 * sigma2_1) & (e2 < chi2 * sigma2_2)
    counts = inls.sum(-1)
    best = torch.argmax(counts)[None]
    cnt = counts.index_select(0, best)[0]
    return (R.index_select(0, best)[0], t.index_select(0, best)[0],
            s.index_select(0, best)[0], inls.index_select(0, best)[0], cnt,
            cnt >= 6)


def sim3_ransac(gen: torch.Generator, P1: torch.Tensor, P2: torch.Tensor,
                valid: torch.Tensor, uv1: torch.Tensor, uv2: torch.Tensor,
                K1: torch.Tensor, K2: torch.Tensor, sigma2_1: torch.Tensor,
                sigma2_2: torch.Tensor, n_hyp: int = 128,
                fix_scale: bool = False, chi2: float = 9.210):
    """`sim3_samples` on `gen` (a CPU generator), then `sim3_solve`."""
    idx = sim3_samples(gen, n_hyp, valid)
    return sim3_solve(idx, P1, P2, valid, uv1, uv2, K1, K2, sigma2_1,
                      sigma2_2, fix_scale, chi2)
