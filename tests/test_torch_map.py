"""models/map.py, utils/metrics.py, utils/profiling.py and the trajectory
generators of the port are own copies of numpy-only reference modules:
driven through one scripted sequence of operations, both give the same
state, exactly."""

import numpy as np
import pytest
import torch

from orbslam2_dualcam_tpu.models import map as ref_map
from orbslam2_dualcam_tpu.utils import metrics as ref_metrics
from orbslam2_dualcam_tpu.utils import profiling as ref_profiling
from orbslam2_dualcam_tpu.utils import synthetic as ref_synthetic
from orbslam2_dualcam_tpu_torch.models import map as port_map
from orbslam2_dualcam_tpu_torch.utils import metrics, profiling, synthetic
from orbslam2_dualcam_tpu_torch.utils.convert import map_from_reference

from torch_parity import assert_snapshots_equal, map_snapshot, scripted_map

torch.set_num_threads(1)


def _script(mod, seed):
    """Build the scripted map, then run every mutating operation of Map on
    it, with a snapshot after each step."""
    m, newest, sf = scripted_map(mod, seed)
    T_sc = np.eye(4)[None]
    snaps = [map_snapshot(m)]
    rng = np.random.default_rng(seed + 100)
    mids = sorted(m.points)
    # erase observations (some drop their point under 3 observations)
    for mid in mids[::9]:
        mp = m.points.get(mid)
        if mp is not None and mp.obs:
            m.erase_observation(mp, next(iter(mp.obs)))
    snaps.append(map_snapshot(m))
    # merge points pairwise
    live = sorted(m.points)
    for a, b in zip(live[5::40], live[6::40]):
        if a in m.points and b in m.points:
            m.replace_point(m.points[a], m.points[b])
    snaps.append(map_snapshot(m))
    # erase points, refresh stats and the graph
    for mid in sorted(m.points)[3::50]:
        m.erase_point(m.points[mid])
    for mp in list(m.points.values()):
        mod.update_point_stats(mp, m, T_sc, sf)
    for kf in list(m.keyframes.values()):
        m.update_connections(kf)
    snaps.append(map_snapshot(m))
    covis = {kid: (m.covisible_kfs(kf), m.covisible_kfs(kf, 2))
             for kid, kf in m.keyframes.items()}
    # erase a middle keyframe (re-parents its children), try the origin and
    # a protected one
    erased = []
    m.on_erase_keyframe.append(erased.append)
    m.keyframes[3].not_erase = True
    m.erase_keyframe(m.keyframes[3])
    m.erase_keyframe(m.keyframes[2])
    m.erase_keyframe(m.keyframes[m.origin_kid])
    snaps.append(map_snapshot(m))
    # rescale, add a keyframe's worth of new points, clear
    m.set_scale(2.5)
    for _ in range(5):
        mp = m.new_point(rng.normal(0, 1, 3), newest.kid, 0)
        m.add_observation(mp, newest, int(np.nonzero(newest.mp_idx < 0)[0][0]), 0)
    snaps.append(map_snapshot(m))
    stats = (m.n_keyframes, m.n_points, newest.center().copy(),
             newest.cam_center(0, T_sc[0]).copy(), newest.n_kp)
    m.clear()
    snaps.append(map_snapshot(m))
    return snaps, covis, erased, stats


@pytest.mark.parametrize("seed", [0, 1])
def test_map_operations_equal_reference(seed):
    want, want_covis, want_erased, want_stats = _script(ref_map, seed)
    got, got_covis, got_erased, got_stats = _script(port_map, seed)
    assert len(got) == len(want) == 7
    for i, (g, w) in enumerate(zip(got, want)):
        assert_snapshots_equal(g, w, f"step{i}")
    assert got_covis == want_covis and got_erased == want_erased
    assert_snapshots_equal(list(got_stats), list(want_stats))
    # the script did something at every step
    assert len(want[0]["points"]) > 250
    assert len(want[1]["points"]) < len(want[0]["points"])
    assert 2 not in want[4]["keyframes"] and 3 in want[4]["keyframes"]
    assert want[5]["map_scaled"] and not want[6]["keyframes"]


def test_map_from_reference_is_an_equal_independent_copy():
    rm, newest, _ = scripted_map(ref_map, 2)
    pm = map_from_reference(rm)
    assert isinstance(pm, port_map.Map)
    assert isinstance(pm.keyframes[0], port_map.KeyFrame)
    assert isinstance(next(iter(pm.points.values())), port_map.MapPoint)
    assert_snapshots_equal(map_snapshot(pm), map_snapshot(rm))
    kf = pm.keyframes[newest.kid]
    for name in ("uv", "level", "angle", "desc", "kp_valid", "kp_cam"):
        np.testing.assert_array_equal(getattr(kf, name), getattr(newest, name))
    # independent: mutating the copy leaves the original alone
    before = map_snapshot(rm)
    pm.erase_keyframe(pm.keyframes[2])
    pm.set_scale(3.0)
    assert_snapshots_equal(map_snapshot(rm), before)


def test_metrics_equal_reference():
    rng = np.random.default_rng(0)
    gt = rng.normal(0, 2, (40, 3))
    R = synthetic.so3_exp(np.array([0.3, -0.2, 0.5]))
    est = 0.4 * (gt @ R.T) + [1.0, 2.0, -3.0] + rng.normal(0, 0.01, gt.shape)
    for with_scale in (True, False):
        for g, w in zip(metrics.align_umeyama(est, gt, with_scale),
                        ref_metrics.align_umeyama(est, gt, with_scale)):
            np.testing.assert_array_equal(g, w)
        assert metrics.ate_rmse(est, gt, with_scale) == \
            ref_metrics.ate_rmse(est, gt, with_scale)
    assert metrics.ate_rmse(est, gt) < 0.06      # noise 0.01 / scale 0.4 per axis
    traj = [(i, 0.1 * i, np.eye(4)) for i in range(3)]
    np.testing.assert_array_equal(metrics.trajectory_positions(traj),
                                  ref_metrics.trajectory_positions(traj))


def test_trajectories_equal_reference():
    """The reference builds its rotations with its float32 so3_exp, the
    port with a float64 Rodrigues: poses agree to 1e-5."""
    a = synthetic.out_and_back_trajectory(n_out=6, n_turn=8, n_back=5,
                                          turn_radius=1.0, n_turn2=4, n_out2=3)
    b = ref_synthetic.out_and_back_trajectory(n_out=6, n_turn=8, n_back=5,
                                              turn_radius=1.0, n_turn2=4,
                                              n_out2=3)
    assert len(a) == len(b) == 26
    np.testing.assert_allclose(np.stack(a), np.stack(b), atol=1e-5)
    a = synthetic.orbit_trajectory(10, radius=1.5, total_angle=0.8 * np.pi)
    b = ref_synthetic.orbit_trajectory(10, radius=1.5, total_angle=0.8 * np.pi)
    np.testing.assert_allclose(np.stack(a), np.stack(b), atol=1e-5)


def test_stage_timer_equal_reference():
    a, b = profiling.StageTimer(), ref_profiling.StageTimer()
    for timer in (a, b):
        for x in (0.004, 0.001, 0.003):
            timer.samples["extract"].append(x)
        timer.samples["track"].append(0.02)
    assert a.stats("extract") == b.stats("extract")
    assert a.stats("missing") is None
    assert a.report() == b.report()
    with a("fused"):
        pass
    assert a.stats("fused")["n"] == 1
    a.reset()
    assert not a.samples
    assert not hasattr(profiling, "device_trace")
