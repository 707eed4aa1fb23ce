"""Distributed BA through the port's pipeline (parallel/runtime.solve_ba_auto)
against the JAX reference on the CPU, as tests/test_dist_pipeline.py holds
the reference: a real map built by the port's public tracking pipeline, its
global-BA problem packed as the pipeline's GBA call sites pack it, solved
on an 8-shard mesh, by the port's single-device solver and by the
reference's `runtime.solve_ba_auto` on its 8 virtual devices; a System with
a mesh attached tracks, and its global-BA call sites hand the mesh on.
Bands of tests/test_dist_pipeline.py: cost rtol 2e-3, poses rtol 1e-2 atol
2e-3."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh as RefMesh

from orbslam2_dualcam_tpu.optim import ba as ref_ba
from orbslam2_dualcam_tpu.optim import factors as ref_factors
from orbslam2_dualcam_tpu.parallel import runtime as ref_runtime
from orbslam2_dualcam_tpu_torch import (CameraConfig, CapacityConfig,
                                        MappingConfig, OrbConfig, SystemConfig)
from orbslam2_dualcam_tpu_torch.optim import ba
from orbslam2_dualcam_tpu_torch.parallel import dist_ba, runtime
from orbslam2_dualcam_tpu_torch.parallel.runtime import Mesh
from orbslam2_dualcam_tpu_torch.pipeline import ba_pack
from orbslam2_dualcam_tpu_torch.pipeline.loop_closing import LoopCloser
from orbslam2_dualcam_tpu_torch.pipeline.system import System
from orbslam2_dualcam_tpu_torch.utils import synthetic

torch.set_num_threads(1)


def _cfg():
    return SystemConfig(
        cameras=(CameraConfig(width=320, height=240, fx=260, fy=260,
                              cx=160, cy=120),),
        orb=OrbConfig(n_features=400, n_levels=4),
        mapping=MappingConfig(cull_found_ratio=0.1),
        capacity=CapacityConfig(max_local_mp=2048))


def _track(sys_, n_out: int):
    world = synthetic.make_box_world(np.random.default_rng(11), half=6.0)
    poses = synthetic.out_and_back_trajectory(n_out=n_out, n_turn=0, n_back=0)
    K, T_sc = sys_.rig.K.numpy(), sys_.rig.T_sc.numpy()
    return [sys_.track(synthetic.render_rig(world, K, T_sc, T, H=240, W=320),
                       k / 30.0) for k, T in enumerate(poses)]


@pytest.fixture(scope="module")
def tracked_map():
    """A real map from the port's tracking pipeline (the reference test's
    short mono run: 14 frames at 320x240, 4 levels, 400 features)."""
    sys_ = System(_cfg(), voc=None, enable_loop_closing=False, device="cpu")
    _track(sys_, 14)
    assert sys_.map.n_keyframes >= 3
    return sys_


def _pack_gba(sys_):
    m = sys_.map
    return ba_pack.pack_problem(
        m, sorted(m.keyframes), fixed_kids={m.origin_kid},
        level_sigma2=np.asarray(sys_.cfg.orb.level_sigma2, np.float32),
        ncam=sys_.cfg.n_cameras, device="cpu")


def _reference_problem(prob):
    """The port's packed problem as the reference's BAProblem."""
    e = prob.edges
    i32 = lambda x: jnp.asarray(x.numpy().astype(np.int32))  # noqa: E731
    edges = ref_factors.Edges(kf=i32(e.kf), mp=i32(e.mp), cam=i32(e.cam),
                              uv=jnp.asarray(e.uv.numpy()),
                              inv_sigma2=jnp.asarray(e.inv_sigma2.numpy()),
                              valid=jnp.asarray(e.valid.numpy()))
    return ref_ba.BAProblem(
        poses=jnp.asarray(prob.poses.numpy()),
        points=jnp.asarray(prob.points.numpy()), edges=edges,
        pose_valid=jnp.asarray(prob.pose_valid.numpy()),
        pose_fixed=jnp.asarray(prob.pose_fixed.numpy()),
        point_valid=jnp.asarray(prob.point_valid.numpy()))


def _close(got, want):
    np.testing.assert_allclose(float(got.cost), float(want.cost), rtol=2e-3)
    np.testing.assert_allclose(np.asarray(got.poses), np.asarray(want.poses),
                               rtol=1e-2, atol=2e-3)


def test_pipeline_gba_single_vs_mesh(tracked_map):
    """solve_ba_auto on the pipeline's own GBA problem, forced onto an
    8-shard mesh: equal to the port's single-device solve and to the
    reference's solve_ba_auto on its 8-device mesh."""
    sys_ = tracked_map
    prob, _, _, _ = _pack_gba(sys_)
    E = prob.edges.kf.shape[0]
    assert E % 8 == 0, E      # ba_pack buckets edges to powers of two
    rig = sys_.rig
    r1 = ba.solve_ba(prob, rig.T_sc, rig.adj_sc, rig.K, iters=5)
    r8 = runtime.solve_ba_auto(prob, rig.T_sc, rig.adj_sc, rig.K, iters=5,
                               mesh=Mesh(("cpu",) * 8),
                               dist_edge_threshold=1)   # force dist path
    devs = jax.devices()
    assert len(devs) >= 8, "conftest must force an 8-device CPU mesh"
    ref = ref_runtime.solve_ba_auto(
        _reference_problem(prob), jnp.asarray(rig.T_sc.numpy()),
        jnp.asarray(rig.adj_sc.numpy()), jnp.asarray(rig.K.numpy()), iters=5,
        mesh=RefMesh(np.asarray(devs[:8]), ("data",)), dist_edge_threshold=1)
    _close(r8, r1)
    _close(r8, ref)
    assert r8.edge_chi2.shape == (E,) and torch.isfinite(r8.poses).all()


def test_mesh_attached_system_tracks(tracked_map, monkeypatch):
    """A System built with an 8-shard mesh tracks (below the edge threshold
    its global BAs stay single-device), and both global-BA call sites, the
    tracker's metric GBA and the loop closer's, hand their mesh to
    solve_ba_auto, which shards the map's problem when forced to."""
    mesh = Mesh(("cpu",) * 8)
    sys_ = System(tracked_map.cfg, voc=None, enable_loop_closing=False,
                  mesh=mesh, device="cpu")
    assert sys_.tracker.mesh is mesh
    states = _track(sys_, 8)
    assert states[-1] in ("OK", "FULL"), states

    seen = []
    real = runtime.solve_ba_auto
    sharded = []
    real_dist = dist_ba.solve_ba_distributed

    def forced(*args, **kwargs):
        seen.append(kwargs["mesh"])
        return real(*args, **dict(kwargs, dist_edge_threshold=1))

    monkeypatch.setattr(runtime, "solve_ba_auto", forced)
    monkeypatch.setattr(dist_ba, "solve_ba_distributed",
                        lambda *a, **k: sharded.append(a[4]) or
                        real_dist(*a, **k))
    m = sys_.map
    epoch = m.geometry_epoch
    sys_.tracker._metric_gba(iters=2, cg_iters=6)
    LoopCloser(sys_.cfg, sys_.rig, m, None, None, mesh=mesh)._global_ba()
    assert seen == [mesh, mesh] and sharded == [mesh, mesh]
    assert m.geometry_epoch == epoch + 2
    assert all(np.isfinite(p.pos).all() for p in m.points.values())


def test_system_refuses_a_multi_rank_group(monkeypatch):
    """A mesh whose process group spans more than one rank is refused by
    System, naming why (tests/test_torch_multihost.py refuses a real
    two-process group the same way)."""
    group = object()
    monkeypatch.setattr(dist, "get_world_size",
                        lambda g=None: 2 if g is group else 1)
    mesh = Mesh(("cpu",) * 4, group=group)
    assert mesh.size == 8
    with pytest.raises(NotImplementedError, match="drift apart"):
        System(_cfg(), voc=None, enable_loop_closing=False, mesh=mesh,
               device="cpu")
