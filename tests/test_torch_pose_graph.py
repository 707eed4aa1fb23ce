"""The Sim3 pose graph of the port against the reference: a 12-node ring
with one loop edge (per-edge residuals and Jacobians within 1e-4, final cost
within 1%, node poses within 1e-3), the essential graph over a scripted
map, and `apply_sim3_correction` (numpy host code: equal to 1e-6 with the
graph's iterations at 0, within 1e-3 with them on)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam2_dualcam_tpu.models import map as ref_map
from orbslam2_dualcam_tpu.ops import camera as ref_camera
from orbslam2_dualcam_tpu.ops import lie as ref_lie
from orbslam2_dualcam_tpu.optim import pose_graph as ref_pg
from orbslam2_dualcam_tpu.pipeline import loop_closing as ref_lc
from orbslam2_dualcam_tpu.utils import config as ref_config
from orbslam2_dualcam_tpu_torch.models import map as port_map
from orbslam2_dualcam_tpu_torch.ops import camera
from orbslam2_dualcam_tpu_torch.optim import pose_graph
from orbslam2_dualcam_tpu_torch.pipeline import loop_closing
from orbslam2_dualcam_tpu_torch.utils.convert import config_from_reference

from torch_parity import map_snapshot, scripted_cfg, scripted_map, t

torch.set_num_threads(1)


def ring(K: int = 12, drift: float = 0.02, seed: int = 0):
    """K similarity poses on a circle; the initial guess chains odometry
    edges with `drift` of tangent noise each, and one loop edge K-1 -> 0
    measures the truth."""
    rng = np.random.default_rng(seed)
    exp = lambda xi: np.asarray(ref_lie.sim3_exp(jnp.asarray(xi, jnp.float32)),
                                np.float64)
    S_true = []
    for k in range(K):
        a = 2 * np.pi * k / K
        S_true.append(exp([2 * np.cos(a), 0.1 * k, 2 * np.sin(a), 0, a, 0,
                           0.02 * k]))
    S0 = [S_true[0]]
    for k in range(1, K):
        rel = S_true[k] @ np.linalg.inv(S_true[k - 1])
        S0.append(exp(rng.normal(0, drift, 7)) @ rel @ S0[-1])
    e_i = list(range(1, K)) + [K - 1]
    e_j = list(range(0, K - 1)) + [0]
    S_meas = [S0[i] @ np.linalg.inv(S0[j]) for i, j in zip(e_i[:-1], e_j[:-1])]
    S_meas.append(S_true[K - 1] @ np.linalg.inv(S_true[0]))
    fixed = np.zeros(K, bool)
    fixed[0] = True
    return (np.stack(S0).astype(np.float32), np.asarray(e_i), np.asarray(e_j),
            np.stack(S_meas).astype(np.float32), fixed)


@pytest.mark.parametrize("fix_scale", [False, True])
def test_edge_residuals_and_jacobians_equal_reference(fix_scale):
    """Within 1e-4, against the reference's vmap(jacfwd) of its per-edge
    residual."""
    S0, e_i, e_j, S_meas, _ = ring()
    fs = jnp.bool_(fix_scale)
    Smi = jax.vmap(ref_lie.sim3_inv)(jnp.asarray(S_meas))
    z = jnp.zeros((len(e_i), 7))
    f = lambda a, b, Si, Sj, Sm: ref_pg._edge_residual(a, b, Si, Sj, Sm, fs)
    want_r = jax.vmap(f)(z, z, jnp.asarray(S0)[e_i], jnp.asarray(S0)[e_j], Smi)
    want_Ji, want_Jj = jax.vmap(jax.jacfwd(f, argnums=(0, 1)))(
        z, z, jnp.asarray(S0)[e_i], jnp.asarray(S0)[e_j], Smi)
    from orbslam2_dualcam_tpu_torch.ops import lie
    r, Ji, Jj = pose_graph.edge_residuals_and_jacobians(
        t(S0)[t(e_i)], t(S0)[t(e_j)], lie.sim3_inv(t(S_meas)), fix_scale)
    np.testing.assert_allclose(r.numpy(), np.asarray(want_r), atol=1e-4)
    np.testing.assert_allclose(Ji.numpy(), np.asarray(want_Ji), atol=1e-4)
    np.testing.assert_allclose(Jj.numpy(), np.asarray(want_Jj), atol=1e-4)
    assert np.abs(np.asarray(want_r)[-1]).max() > 0.01      # the loop is open
    if fix_scale:
        assert (Ji[:, :, 6] == 0).all() and (Jj[:, :, 6] == 0).all()


@pytest.mark.parametrize("fix_scale", [False, True])
def test_ring_with_a_loop_edge_equals_reference(fix_scale):
    """Final cost within 1% (and at least 10x under the initial), node
    poses within 1e-3, the fixed node untouched."""
    S0, e_i, e_j, S_meas, fixed = ring()
    E = len(e_i)
    want_S, want_c = ref_pg.optimize_pose_graph(
        jnp.asarray(S0), jnp.asarray(e_i), jnp.asarray(e_j),
        jnp.asarray(S_meas), jnp.ones(E, bool), jnp.asarray(fixed), iters=20,
        fix_scale=fix_scale)
    S, c = pose_graph.optimize_pose_graph(
        t(S0), t(e_i), t(e_j), t(S_meas), torch.ones(E, dtype=torch.bool),
        t(fixed), iters=20, fix_scale=fix_scale)
    assert float(c) == pytest.approx(float(want_c), rel=0.01)
    np.testing.assert_allclose(S.numpy(), np.asarray(want_S), atol=1e-3)
    assert torch.equal(S[0], t(S0)[0])
    from orbslam2_dualcam_tpu_torch.ops import lie
    r0, _, _ = pose_graph.edge_residuals_and_jacobians(
        t(S0)[t(e_i)], t(S0)[t(e_j)], lie.sim3_inv(t(S_meas)), fix_scale)
    assert float(c) < 0.1 * float((r0 * r0).sum())


def test_invalid_edges_carry_no_weight():
    S0, e_i, e_j, S_meas, fixed = ring()
    E = len(e_i)
    valid = np.ones(E, bool)
    valid[-1] = False                    # without the loop edge: nothing to do
    S, c = pose_graph.optimize_pose_graph(
        t(S0), t(e_i), t(e_j), t(S_meas), t(valid), t(fixed), iters=3)
    assert float(c) < 1e-8
    np.testing.assert_allclose(S.numpy(), S0, atol=1e-4)


@pytest.fixture(scope="module")
def rigs():
    rcfg = scripted_cfg(ref_config)
    return (ref_camera.make_rig(rcfg),
            camera.make_rig(config_from_reference(rcfg), device="cpu"))


def _correction(m):
    """A corrected Sim3 for the newest keyframe: 3% larger, a little turned
    and shifted; the loop keyframe is the oldest."""
    kf = m.keyframes[max(m.keyframes)]
    loop_kf = m.keyframes[min(m.keyframes)]
    d = np.asarray(ref_lie.sim3_exp(jnp.asarray(
        [0.05, -0.02, 0.03, 0.0, 0.02, 0.0, 0.03], jnp.float32)), np.float64)
    return kf, loop_kf, d @ kf.T_cw


def _assert_maps_close(a, b, atol):
    a, b = map_snapshot(a), map_snapshot(b)
    assert a["keyframes"].keys() == b["keyframes"].keys()
    assert a["points"].keys() == b["points"].keys()
    for kid in a["keyframes"]:
        np.testing.assert_allclose(a["keyframes"][kid]["T_cw"],
                                   b["keyframes"][kid]["T_cw"], atol=atol)
    for mid in a["points"]:
        for k in ("pos", "normal"):
            np.testing.assert_allclose(a["points"][mid][k], b["points"][mid][k],
                                       atol=atol)
        for k in ("min_dist", "max_dist"):
            assert a["points"][mid][k] == pytest.approx(b["points"][mid][k],
                                                        abs=10 * atol)
    assert a["geometry_epoch"] == b["geometry_epoch"]


@pytest.mark.parametrize("iters,atol", [(0, 1e-6), (20, 1e-3)])
def test_apply_sim3_correction_equals_reference(rigs, iters, atol):
    rrig, rig = rigs
    rm, _, sf = scripted_map(ref_map)
    pm, _, _ = scripted_map(port_map)
    before = map_snapshot(pm)
    kf, loop_kf, Scw = _correction(rm)
    ref_lc.apply_sim3_correction(rm, rrig, kf, loop_kf, Scw, [],
                                 fix_scale=False, pose_graph_iters=iters,
                                 scale_factors=sf)
    kf, loop_kf, Scw = _correction(pm)
    loop_closing.apply_sim3_correction(pm, rig, kf, loop_kf, Scw, [],
                                       fix_scale=False, pose_graph_iters=iters,
                                       scale_factors=sf)
    _assert_maps_close(pm, rm, atol)
    assert loop_kf.kid in kf.loop_edges and kf.kid in loop_kf.loop_edges
    assert pm.geometry_epoch == before["geometry_epoch"] + 1
    moved = max(np.abs(pm.points[mid].pos - before["points"][mid]["pos"]).max()
                for mid in pm.points)
    assert moved > 0.01


def test_sim3_parts_and_se3_of_sim3_equal_reference():
    S = np.asarray(ref_lie.sim3_exp(jnp.asarray(
        [0.3, -0.2, 0.5, 0.1, 0.4, -0.2, 0.3], jnp.float32)), np.float64)
    for g, w in zip(loop_closing._sim3_parts(S), ref_lc._sim3_parts(S)):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(loop_closing._se3_of_sim3(S),
                                  ref_lc._se3_of_sim3(S))


def test_essential_graph_equals_reference(rigs):
    """The host wrapper on a scripted map whose newest keyframe has been
    pushed away: same edges, poses and points within 1e-3."""
    rrig, rig = rigs
    maps = []
    for mod, pg, r in ((ref_map, ref_pg, rrig), (port_map, pose_graph, rig)):
        m, kf_new, _ = scripted_map(mod)
        old = {kid: kf.T_cw.copy() for kid, kf in m.keyframes.items()}
        kf_new.T_cw = kf_new.T_cw.copy()
        kf_new.T_cw[:3, 3] += [0.05, 0.0, -0.04]
        kf_new.loop_edges.add(0)
        m.keyframes[0].loop_edges.add(kf_new.kid)
        pg.optimize_essential_graph(m, r, loop_kid=0, cur_kid=kf_new.kid,
                                    old_poses=old, iters=20)
        maps.append(m)
    _assert_maps_close(maps[1], maps[0], 1e-3)
