"""parallel/dist_ba.py and parallel/runtime.py of the port against the JAX
reference on the CPU: the same seeded problem (tests/test_optim.py's
synthetic dual-camera window, 6 keyframes, 120 points) solved by the
reference's `solve_ba_distributed` on its 8 virtual devices, by the port's
on an 8-shard CPU mesh and by the port's single-device `ba.solve_ba`.
Bands of tests/test_dist_ba.py: cost rtol 1e-3, poses atol 5e-4, points
atol 5e-3."""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as RefMesh

from orbslam2_dualcam_tpu.ops import lie as ref_lie
from orbslam2_dualcam_tpu.optim import ba as ref_ba
from orbslam2_dualcam_tpu.parallel import dist_ba as ref_dist_ba
from orbslam2_dualcam_tpu_torch.optim import ba
from orbslam2_dualcam_tpu_torch.parallel import dist_ba, runtime
from orbslam2_dualcam_tpu_torch.parallel.runtime import Mesh
from orbslam2_dualcam_tpu_torch.utils.convert import (ba_problem_from_numpy,
                                                      rig_from_numpy)
from tests.test_optim import _synthetic_ba_problem, rig2

torch.set_num_threads(1)

ITERS = 8


@pytest.fixture(scope="module")
def problem():
    """tests/test_dist_ba.py's fixture: the reference's problem and rig,
    and the port's of the same numbers."""
    rng = np.random.default_rng(1)
    rig = rig2()
    poses_t, points_t, edges = _synthetic_ba_problem(rng, rig, n_kf=6,
                                                     n_mp=120)
    n_kf, n_mp = poses_t.shape[0], points_t.shape[0]
    dp = rng.normal(0, 0.02, size=(n_kf, 6)).astype(np.float32)
    dp[:2] = 0
    poses0 = jax.vmap(lambda d, T: ref_lie.se3_exp(d) @ T)(jnp.asarray(dp),
                                                           poses_t)
    points0 = points_t + jnp.asarray(
        rng.normal(0, 0.05, size=(n_mp, 3)).astype(np.float32))
    prob = ref_ba.BAProblem(
        poses=poses0, points=points0, edges=edges,
        pose_valid=jnp.ones(n_kf, bool),
        pose_fixed=jnp.zeros(n_kf, bool).at[0].set(True).at[1].set(True),
        point_valid=jnp.ones(n_mp, bool))
    assert prob.edges.kf.shape[0] % 8 == 0
    port_rig = rig_from_numpy(type(rig)(*(np.asarray(x) for x in rig)),
                              device="cpu")
    port_prob = ba_problem_from_numpy(jax.tree.map(np.asarray, prob),
                                      device="cpu")
    return rig, prob, port_rig, port_prob


def _close(got, want, points: bool):
    np.testing.assert_allclose(float(got.cost), float(want.cost), rtol=1e-3)
    np.testing.assert_allclose(np.asarray(got.poses), np.asarray(want.poses),
                               atol=5e-4)
    if points:
        np.testing.assert_allclose(np.asarray(got.points),
                                   np.asarray(want.points), atol=5e-3)


@pytest.mark.parametrize("layout", ["replicated", "point-sharded"])
def test_distributed_matches_reference_and_single_device(problem, layout):
    """The port's 8-shard solve against the reference's 8-device solve in
    the same layout and against the port's single-device solve; its
    per-edge chi2 comes back in the caller's edge order."""
    rig, prob, port_rig, port_prob = problem
    devs = jax.devices()
    assert len(devs) == 8, "conftest must provide 8 virtual devices"
    sharded = layout == "point-sharded"
    ref = ref_dist_ba.solve_ba_distributed(
        prob, rig.T_sc, rig.adj_sc, rig.K, RefMesh(np.asarray(devs), ("data",)),
        iters=ITERS, shard_points=sharded)
    mesh = Mesh(("cpu",) * 8)
    got = dist_ba.solve_ba_distributed(
        port_prob, port_rig.T_sc, port_rig.adj_sc, port_rig.K, mesh,
        iters=ITERS, shard_points=sharded)
    single = ba.solve_ba(port_prob, port_rig.T_sc, port_rig.adj_sc,
                         port_rig.K, iters=ITERS)
    E = port_prob.edges.kf.shape[0]
    assert got.edge_chi2.shape == (E,) and got.points.shape == (120, 3)
    _close(got, ref, points=True)
    _close(got, single, points=sharded)
    # per-edge chi2 in the caller's order, row by row: the reference's and
    # the single-device solve's, at the reference's band (atol 1e-2); the
    # padding rows (uv 0, chi2 ~3e5) agree to float32's precision (rtol)
    for want in (np.asarray(ref.edge_chi2), single.edge_chi2.numpy()):
        np.testing.assert_allclose(got.edge_chi2.numpy(), want, rtol=1e-5,
                                   atol=1e-2)
    assert torch.isfinite(got.edge_chi2).all()


def test_solve_ba_auto_routes_by_size_and_warns(problem, monkeypatch, caplog):
    """Below the threshold, without a mesh, and on a mesh whose size does not
    divide the edge count (3 shards, with the reference's logged warning)
    solve_ba_auto is exactly ba.solve_ba; at the threshold on an 8-shard
    mesh it is the distributed solve.  The mesh's sum is the same tensor on
    every shard of one device, summed in shard order."""
    _, _, rig, prob = problem
    E = prob.edges.kf.shape[0]
    args = (prob, rig.T_sc, rig.adj_sc, rig.K)
    single = ba.solve_ba(*args, iters=2, cg_iters=6)
    calls = []
    real = dist_ba.solve_ba_distributed
    monkeypatch.setattr(dist_ba, "solve_ba_distributed",
                        lambda *a, **k: calls.append(a[4]) or real(*a, **k))
    mesh8, mesh3 = Mesh(("cpu",) * 8), Mesh(("cpu",) * 3)
    assert E % 3 != 0
    for mesh, threshold in ((None, 1), (mesh8, E + 1), (mesh3, 1)):
        caplog.clear()
        with caplog.at_level(logging.WARNING, logger=runtime.__name__):
            res = runtime.solve_ba_auto(*args, iters=2, cg_iters=6, mesh=mesh,
                                        dist_edge_threshold=threshold)
        for a, b in zip(res, single):
            assert torch.equal(a, b)
        warned = [r.getMessage() for r in caplog.records]
        if mesh is mesh3:
            assert len(warned) == 1 and f"E={E}" in warned[0] and \
                "mesh size 3" in warned[0], warned
        else:
            assert not warned, warned
    assert not calls
    res = runtime.solve_ba_auto(*args, iters=2, cg_iters=6, mesh=mesh8,
                                dist_edge_threshold=E)
    assert calls == [mesh8]
    _close(res, single, points=False)
    assert runtime.DIST_EDGE_THRESHOLD == 16384
    parts = [torch.full((2,), float(i)) for i in range(8)]
    sums = mesh8.all_reduce(parts)
    assert all(s is sums[0] for s in sums)
    assert sums[0].tolist() == [28.0, 28.0]
