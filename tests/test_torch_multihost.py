"""The port's distributed BA across two processes (torch.distributed over
gloo, 4 CPU shards each), as tests/test_multihost.py runs the reference
under multi-controller JAX: both processes solve the identical problem (the
reference test's, built here and handed to them as a file), must return
the same replicated result, and must match the reference's solve on its 8
virtual devices within 2e-3.  Each process also shows that a rank handed
another problem shape raises instead of hanging, and that System refuses a
mesh over the two-rank group."""

import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax.sharding import Mesh as RefMesh

from orbslam2_dualcam_tpu.ops import camera as ref_camera
from orbslam2_dualcam_tpu.ops import lie as ref_lie
from orbslam2_dualcam_tpu.optim import ba as ref_ba
from orbslam2_dualcam_tpu.optim.factors import Edges as RefEdges
from orbslam2_dualcam_tpu.parallel import dist_ba as ref_dist_ba
from orbslam2_dualcam_tpu.utils.config import dual_default as ref_dual_default
from orbslam2_dualcam_tpu_torch.parallel import dist_ba
from orbslam2_dualcam_tpu_torch.parallel.runtime import Mesh
from orbslam2_dualcam_tpu_torch.utils.convert import (ba_problem_from_numpy,
                                                      rig_from_numpy)

torch.set_num_threads(1)

_WORKER = r"""
import datetime, sys
rank, port, path, out = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
sys.path.insert(0, %(repo)r)
import numpy as np, torch
torch.set_num_threads(1)
import torch.distributed as dist
from orbslam2_dualcam_tpu_torch import dual_default
from orbslam2_dualcam_tpu_torch.optim.ba import BAProblem
from orbslam2_dualcam_tpu_torch.optim.factors import Edges
from orbslam2_dualcam_tpu_torch.parallel import dist_ba
from orbslam2_dualcam_tpu_torch.parallel.runtime import Mesh
from orbslam2_dualcam_tpu_torch.pipeline.system import System

dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        world_size=2, rank=rank,
                        timeout=datetime.timedelta(seconds=60))
d = {k: torch.as_tensor(v) for k, v in np.load(path).items()}
prob = BAProblem(poses=d["poses"], points=d["points"],
                 edges=Edges(d["kf"], d["mp"], d["cam"], d["uv"],
                             d["inv_sigma2"], d["valid"]),
                 pose_valid=d["pose_valid"], pose_fixed=d["pose_fixed"],
                 point_valid=d["point_valid"])
mesh = Mesh(("cpu",) * 4, group=dist.group.WORLD)
assert mesh.size == 8 and mesh.first_shard == 4 * rank
res = {}
for layout in ("replicated", "sharded"):
    r = dist_ba.solve_ba_distributed(prob, d["T_sc"], d["adj_sc"], d["K"], mesh,
                                     iters=3, cg_iters=8,
                                     shard_points=layout == "sharded")
    res.update({f"{layout}_{k}": getattr(r, k).numpy() for k in r._fields})
try:
    System(dual_default(), voc=None, mesh=mesh, device="cpu")
except NotImplementedError as e:
    res["refused"] = np.array(str(e))
# rank 1 is handed half the edges: both ranks must raise, not hang
half = prob._replace(edges=type(prob.edges)(*(f[:64] for f in prob.edges)))
try:
    dist_ba.solve_ba_distributed(half if rank else prob, d["T_sc"], d["adj_sc"],
                                 d["K"], mesh, iters=1, cg_iters=2)
except ValueError as e:
    res["mismatch"] = np.array(str(e))
np.savez(out, **res)
dist.destroy_process_group()
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    p = s.getsockname()[1]
    s.close()
    return p


def _reference_problem():
    """tests/test_multihost.py's problem, built as that test builds it."""
    rig = ref_camera.make_rig(ref_dual_default())
    rng = np.random.default_rng(0)
    n_kf, n_mp, E = 4, 32, 128
    poses = jnp.stack([jnp.asarray(np.asarray(
        ref_lie.se3_exp(jnp.asarray(
            rng.normal(size=6).astype(np.float32) * 0.05))))
        for _ in range(n_kf)])
    points = jnp.asarray(rng.uniform([-2, -2, 4], [2, 2, 8],
                                     (n_mp, 3)).astype(np.float32))
    edges = RefEdges(
        kf=jnp.asarray(rng.integers(0, n_kf, E, dtype=np.int32)),
        mp=jnp.asarray(rng.integers(0, n_mp, E, dtype=np.int32)),
        cam=jnp.asarray(rng.integers(0, 2, E, dtype=np.int32)),
        uv=jnp.asarray(rng.uniform(0, 480, (E, 2)).astype(np.float32)),
        inv_sigma2=jnp.ones(E, jnp.float32),
        valid=jnp.ones(E, bool))
    prob = ref_ba.BAProblem(
        poses=poses, points=points, edges=edges,
        pose_valid=jnp.ones(n_kf, bool),
        pose_fixed=jnp.zeros(n_kf, bool).at[0].set(True),
        point_valid=jnp.ones(n_mp, bool))
    return rig, prob


def test_two_process_distributed_ba(tmp_path):
    rig, prob = _reference_problem()
    np_prob = jax.tree.map(np.asarray, prob)
    e = np_prob.edges
    path = tmp_path / "problem.npz"
    np.savez(path, poses=np_prob.poses, points=np_prob.points,
             kf=e.kf.astype(np.int64), mp=e.mp.astype(np.int64),
             cam=e.cam.astype(np.int64), uv=e.uv, inv_sigma2=e.inv_sigma2,
             valid=e.valid, pose_valid=np_prob.pose_valid,
             pose_fixed=np_prob.pose_fixed, point_valid=np_prob.point_valid,
             T_sc=np.asarray(rig.T_sc), adj_sc=np.asarray(rig.adj_sc),
             K=np.asarray(rig.K))
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER % {"repo": repo})
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(worker), str(i), str(port), str(path),
         str(tmp_path / f"rank{i}.npz")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for i in range(2)]
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, (out[-2000:], err[-2000:])
    finally:
        for p in procs:
            p.kill()
            p.wait()
    got = [dict(np.load(tmp_path / f"rank{i}.npz")) for i in range(2)]

    # both ranks hold the identical replicated result, bit for bit, and the
    # same assembled points and per-edge chi2
    assert got[0].keys() == got[1].keys()
    for k in got[0]:
        if k not in ("refused", "mismatch"):
            assert np.array_equal(got[0][k], got[1][k]), k
    for g in got:
        assert "drift apart" in str(g["refused"])
        assert "different problems" in str(g["mismatch"])

    # ... and it matches the reference's single-process 8-device solve
    ref = ref_dist_ba.solve_ba_distributed(
        prob, rig.T_sc, rig.adj_sc, rig.K,
        RefMesh(np.asarray(jax.devices()[:8]), ("data",)), iters=3,
        cg_iters=8)
    cost = float(got[0]["replicated_cost"])
    assert abs(cost - float(ref.cost)) < 2e-3 * max(1.0, abs(cost)), \
        (cost, float(ref.cost))
    # the point-sharded layout across the two processes against the port's
    # own 8-shard solve in one process (the sums run in another order)
    port_rig = rig_from_numpy(type(rig)(*(np.asarray(x) for x in rig)),
                              device="cpu")
    one = dist_ba.solve_ba_distributed(
        ba_problem_from_numpy(np_prob, device="cpu"), port_rig.T_sc,
        port_rig.adj_sc, port_rig.K, Mesh(("cpu",) * 8), iters=3, cg_iters=8,
        shard_points=True)
    np.testing.assert_allclose(got[0]["sharded_cost"], one.cost.numpy(),
                               rtol=2e-3)
    np.testing.assert_allclose(got[0]["sharded_poses"], one.poses.numpy(),
                               atol=5e-4)
    np.testing.assert_allclose(got[0]["sharded_edge_chi2"],
                               one.edge_chi2.numpy(), rtol=1e-3, atol=1e-2)
