"""optim/factors.py and optim/ba.py of the port against the JAX reference
on one seeded synthetic window (CPU, float32).  Tolerances per assert."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam2_dualcam_tpu.ops import camera as ref_camera
from orbslam2_dualcam_tpu.optim import ba as ref_ba
from orbslam2_dualcam_tpu.optim import factors as ref_factors
from orbslam2_dualcam_tpu.utils import config as ref_config
from orbslam2_dualcam_tpu_torch.optim import ba, factors
from orbslam2_dualcam_tpu_torch.utils import synthetic
from orbslam2_dualcam_tpu_torch.utils.convert import (ba_problem_from_numpy,
                                                      config_from_reference,
                                                      rig_from_numpy)

from torch_parity import t

torch.set_num_threads(1)

K_PAD, M_PAD, E_PAD = 8, 256, 1024


@pytest.fixture(scope="module")
def rigs():
    ref_rig = ref_camera.make_rig(ref_config.dual_default())
    as_np = type(ref_rig)(*(np.asarray(x) for x in ref_rig))
    return ref_rig, rig_from_numpy(as_np, device="cpu")


def _window(seed, rig_np, n_kf=8, n_pt=110, outliers=0.05, pose_noise=0.01,
            point_noise=0.05, n_fixed=2):
    """A padded BA window as a reference BAProblem with numpy leaves: n_kf
    poses on an arc, n_pt points seen by either camera of the rig where
    they project into its image, pixel noise 0.5, and a fraction of edges
    displaced by tens of pixels.

    The first n_fixed poses are held.  Two fix the scale as well as the
    frame: with one, the cost is flat along the scale of the window and two
    correct solvers wander apart along it at equal cost.  The free poses
    have more unknowns (36) than one LM step has PCG iterations (24): once
    PCG has converged to rounding, its later iterations amplify rounding
    noise, which no two implementations share."""
    rng = np.random.default_rng(seed)
    T_sc, Ks = np.asarray(rig_np.T_sc), np.asarray(rig_np.K)
    poses = np.tile(np.eye(4, dtype=np.float32), (K_PAD, 1, 1))
    true_poses = []
    for k in range(n_kf):
        T = np.eye(4)
        T[:3, :3] = synthetic.so3_exp(np.array([0.0, 0.04 * k, 0.0]))
        T[:3, 3] = [-0.25 * k, 0.0, 0.02 * k]
        true_poses.append(T)
    X = np.stack([rng.uniform(-3, 3, n_pt), rng.uniform(-2, 2, n_pt),
                  rng.uniform(4, 9, n_pt) * rng.choice([-1, 1], n_pt)], 1)
    ekf, emp, ecam, euv, esig = [], [], [], [], []
    for k, T in enumerate(true_poses):
        for c in range(T_sc.shape[0]):
            Tc = T_sc[c] @ T
            x = X @ Tc[:3, :3].T + Tc[:3, 3]
            u = Ks[c][0, 0] * x[:, 0] / x[:, 2] + Ks[c][0, 2]
            v = Ks[c][1, 1] * x[:, 1] / x[:, 2] + Ks[c][1, 2]
            vis = (x[:, 2] > 0.5) & (u > 0) & (u < 640) & (v > 0) & (v < 480)
            for i in np.nonzero(vis)[0]:
                ekf.append(k)
                emp.append(i)
                ecam.append(c)
                euv.append([u[i], v[i]])
                esig.append(1.0 / rng.choice([1.0, 1.44, 2.0736]))
    E = len(ekf)
    assert 300 < E <= E_PAD, E
    euv = np.asarray(euv) + rng.normal(0, 0.5, (E, 2))
    bad = rng.random(E) < outliers
    euv[bad] += rng.choice([-1, 1], (int(bad.sum()), 2)) * rng.uniform(
        15, 40, (int(bad.sum()), 2))
    for k, T in enumerate(true_poses):
        Tn = T.copy()
        if k >= n_fixed:
            Tn[:3, :3] = synthetic.so3_exp(rng.normal(0, pose_noise, 3)) @ Tn[:3, :3]
            Tn[:3, 3] += rng.normal(0, pose_noise, 3)
        poses[k] = Tn
    points = np.zeros((M_PAD, 3), np.float32)
    points[:n_pt] = X + rng.normal(0, point_noise, X.shape)
    pad = E_PAD - E
    edges = ref_factors.Edges(
        kf=np.asarray(ekf + [0] * pad, np.int32),
        mp=np.asarray(emp + [0] * pad, np.int32),
        cam=np.asarray(ecam + [0] * pad, np.int32),
        uv=np.concatenate([euv, np.zeros((pad, 2))]).astype(np.float32),
        inv_sigma2=np.asarray(esig + [0.0] * pad, np.float32),
        valid=np.asarray([True] * E + [False] * pad))
    pose_valid = np.arange(K_PAD) < n_kf
    pose_fixed = np.arange(K_PAD) < n_fixed
    point_valid = np.arange(M_PAD) < n_pt
    prob = ref_ba.BAProblem(poses=poses, points=points, edges=edges,
                            pose_valid=pose_valid, pose_fixed=pose_fixed,
                            point_valid=point_valid)
    return prob, bad, E


def _to_jax(prob):
    return jax.tree.map(jnp.asarray, prob)


@pytest.mark.parametrize("seed", [0, 1])
def test_edge_residuals_jacobians(rigs, seed):
    """Residuals and both Jacobians, edge by edge: 1e-5 relative to the
    largest entry of each."""
    ref_rig, rig = rigs
    prob, _, E = _window(seed, ref_rig)
    want = ref_factors.edge_residuals_jacobians(
        jnp.asarray(prob.poses), jnp.asarray(prob.points), _to_jax(prob.edges),
        ref_rig.T_sc, ref_rig.adj_sc, ref_rig.K)
    p = ba_problem_from_numpy(prob, device="cpu")
    got = factors.edge_residuals_jacobians(p.poses, p.points, p.edges,
                                           rig.T_sc, rig.adj_sc, rig.K)
    for g, w in zip(got, want):
        w = np.asarray(w)[:E]
        assert np.abs(g.numpy()[:E] - w).max() <= 1e-5 * np.abs(w).max()


def test_single_edge_functions(rigs):
    """reproject_error / reproject_jacobians on one edge (no leading axis)
    equal the reference's per-edge functions: 1e-5 relative."""
    ref_rig, rig = rigs
    prob, _, _ = _window(2, ref_rig)
    e = 17
    k, i, c = int(prob.edges.kf[e]), int(prob.edges.mp[e]), int(prob.edges.cam[e])
    want_r = ref_factors.reproject_error(
        jnp.asarray(prob.poses[k]), jnp.asarray(prob.points[i]),
        jnp.asarray(prob.edges.uv[e]), ref_rig.T_sc[c], ref_rig.K[c])
    got_r = factors.reproject_error(t(prob.poses[k]), t(prob.points[i]),
                                    t(prob.edges.uv[e]), rig.T_sc[c], rig.K[c])
    np.testing.assert_allclose(got_r.numpy(), np.asarray(want_r), rtol=1e-5,
                               atol=1e-4)
    want_J = ref_factors.reproject_jacobians(
        jnp.asarray(prob.poses[k]), jnp.asarray(prob.points[i]),
        ref_rig.T_sc[c], ref_rig.adj_sc[c], ref_rig.K[c])
    got_J = factors.reproject_jacobians(t(prob.poses[k]), t(prob.points[i]),
                                        rig.T_sc[c], rig.adj_sc[c], rig.K[c])
    for g, w in zip(got_J, want_J):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= 1e-5 * np.abs(w).max()


@pytest.mark.parametrize("iters", [5, 15])
def test_solve_ba_matches_reference(rigs, iters):
    """LM with Schur + PCG on one window: cost within 1e-3 relative, poses
    and points within 1e-4 (absolute, metres and unit rotations), and the
    same outlier set at chi2_mono.  (Window 1: in window 0 one point seen
    at low parallax differs by 1e-3 along its ray after 5 steps, at equal
    cost, and by 2e-5 after 15.)"""
    ref_rig, rig = rigs
    prob, bad, E = _window(1, ref_rig)
    want = ref_ba.solve_ba(_to_jax(prob), ref_rig.T_sc, ref_rig.adj_sc,
                           ref_rig.K, iters=iters)
    p = ba_problem_from_numpy(prob, device="cpu")
    got = ba.solve_ba(p, rig.T_sc, rig.adj_sc, rig.K, iters=iters)
    cfg = config_from_reference(ref_config.BAConfig())
    np.testing.assert_allclose(float(got.cost), float(want.cost), rtol=1e-3)
    n_kf, n_pt = int(prob.pose_valid.sum()), int(prob.point_valid.sum())
    assert np.abs(got.poses.numpy() - np.asarray(want.poses))[:n_kf].max() < 1e-4
    assert np.abs(got.points.numpy() - np.asarray(want.points))[:n_pt].max() < 1e-4
    g_out = got.edge_chi2.numpy()[:E] > cfg.chi2_mono
    w_out = np.asarray(want.edge_chi2)[:E] > cfg.chi2_mono
    np.testing.assert_array_equal(g_out, w_out)
    # the solve did its job: the planted outliers are the flagged edges
    assert (g_out & bad).sum() >= 0.9 * bad.sum()
    # fixed and padded slots are untouched
    np.testing.assert_array_equal(got.poses.numpy()[0], prob.poses[0])
    np.testing.assert_array_equal(got.poses.numpy()[n_kf:], prob.poses[n_kf:])
    np.testing.assert_array_equal(got.points.numpy()[n_pt:], prob.points[n_pt:])


def test_solve_ba_lowers_cost_and_recovers_scene(rigs):
    ref_rig, rig = rigs
    prob, _, _ = _window(3, ref_rig, outliers=0.0)
    p = ba_problem_from_numpy(prob, device="cpu")
    r0 = ba.solve_ba(p, rig.T_sc, rig.adj_sc, rig.K, iters=0)
    r = ba.solve_ba(p, rig.T_sc, rig.adj_sc, rig.K, iters=10)
    assert float(r.cost) < 0.2 * float(r0.cost)
    assert torch.equal(r0.poses, p.poses) and torch.equal(r0.points, p.points)


def test_masked_edges_add_exactly_zero(rigs):
    """Garbage in padded edge rows (in-range indices, wild pixels) and in
    invalid point slots changes nothing, to the bit."""
    ref_rig, rig = rigs
    prob, _, E = _window(4, ref_rig)
    p = ba_problem_from_numpy(prob, device="cpu")
    a = ba.solve_ba(p, rig.T_sc, rig.adj_sc, rig.K, iters=3)
    rng = np.random.default_rng(0)
    e = p.edges
    uv = e.uv.clone()
    uv[E:] = t(rng.uniform(-1e4, 1e4, (E_PAD - E, 2)).astype(np.float32))
    kf = e.kf.clone()
    kf[E:] = t(rng.integers(0, K_PAD, E_PAD - E))
    mp = e.mp.clone()
    mp[E:] = t(rng.integers(0, M_PAD, E_PAD - E))
    sig = e.inv_sigma2.clone()
    sig[E:] = 3.0
    p2 = p._replace(edges=e._replace(uv=uv, kf=kf, mp=mp, inv_sigma2=sig))
    b = ba.solve_ba(p2, rig.T_sc, rig.adj_sc, rig.K, iters=3)
    assert torch.equal(a.poses, b.poses) and torch.equal(a.points, b.points)
    assert torch.equal(a.cost, b.cost)


def test_solve_ba_chunked_equals_its_chunks_and_aborts(rigs):
    ref_rig, rig = rigs
    prob, _, _ = _window(5, ref_rig)
    p = ba_problem_from_numpy(prob, device="cpu")
    args = (rig.T_sc, rig.adj_sc, rig.K)
    calls = []
    res = ba.solve_ba_chunked(p, *args, iters=7, chunk=3,
                              unlock=lambda: calls.append("u"),
                              relock=lambda: calls.append("r"))
    assert calls == ["u", "r"] * 3                 # chunks of 3, 3, 1
    cur = p
    for n in (3, 3, 1):
        step = ba.solve_ba(cur, *args, iters=n)
        cur = cur._replace(poses=step.poses, points=step.points)
    assert torch.equal(res.poses, step.poses)
    assert torch.equal(res.points, step.points)
    assert torch.equal(res.edge_chi2, step.edge_chi2)
    # abort after the first chunk: the result is that chunk's
    polls = []
    res1 = ba.solve_ba_chunked(p, *args, iters=7, chunk=3,
                               should_abort=lambda: polls.append(1) or True)
    first = ba.solve_ba(p, *args, iters=3)
    assert len(polls) == 1
    assert torch.equal(res1.poses, first.poses)
    # a failing chunk still takes the lock back
    calls.clear()
    broken = p._replace(points=p.points[:, :2])
    with pytest.raises(Exception):
        ba.solve_ba_chunked(broken, *args, iters=2, chunk=2,
                            unlock=lambda: calls.append("u"),
                            relock=lambda: calls.append("r"))
    assert calls == ["u", "r"]
