"""The port's monocular SLAM system on the CPU, alone, on the 45-frame
orbit of tests/test_mono_slam.py and held to that file's gates:
initialization, tracking, keyframes, local mapping, local BA, the savers,
and `async_mapping=True`.  The configuration, the frame loop and the choice of
RANSAC seed are tests/test_torch_system.py's; this file holds the two
orbit runs apart from that file's quick checks, so that the test
scheduler can run them beside the rest."""

import threading

import numpy as np
import pytest
import torch

from orbslam2_dualcam_tpu_torch.utils import metrics

from test_torch_system import _orbit

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def mono_run():
    return _orbit()


def _check_map_gates(sys_, poses, states):
    """The gates of tests/test_mono_slam.py."""
    ev = sys_.tracker.events
    assert states[-1] == "OK", (states, ev)
    assert "OK" in states[:12], ev
    assert sum(1 for s in states if s == "LOST") <= 3, (states, ev)
    assert sys_.map.n_keyframes >= 4, ev
    assert sys_.map.n_points > 150
    assert sys_.mapper.n_triangulated > 50
    traj = sys_.tracker.composed_trajectory()
    assert len(traj) > 30
    est = metrics.trajectory_positions(traj)
    gt = np.asarray([-poses[f][:3, :3].T @ poses[f][:3, 3]
                     for f in [t[0] for t in traj]])
    ate = metrics.ate_rmse(est, gt, with_scale=True)
    assert ate < 0.30, f"ATE {ate:.4f} m; events={ev}"


def test_orbit_meets_the_mono_slam_gates(mono_run):
    sys_, poses, states = mono_run
    _check_map_gates(sys_, poses, states)
    tr = sys_.tracker
    assert tr.n_fused_frames >= 1
    assert tr.n_fused_frames + tr.n_stepped_frames == \
        sum(1 for s in states[states.index("OK") + 1:] if s == "OK")
    # at least one local BA ran, on a window of several keyframes
    assert sys_.mapper.ba_log and max(b[1] for b in sys_.mapper.ba_log) >= 4
    assert all(np.isfinite(b[4]) for b in sys_.mapper.ba_log)
    assert any(s.name == "tracker.two_view" for s in sys_.tracer.spans())
    assert {"fused", "extract", "initialize", "track", "store_refresh"} <= \
        set(tr.timer.samples)
    assert {"triangulate", "fuse", "local_ba"} <= set(sys_.mapper.timer.samples)


def test_savers(mono_run, tmp_path):
    sys_, _, _ = mono_run
    fp, kp, mp = (tmp_path / n for n in ("frames.txt", "kfs.txt", "map.txt"))
    sys_.save_frame_trajectory(str(fp))
    sys_.save_keyframe_trajectory(str(kp))
    sys_.save_map_points(str(mp))
    lines = fp.read_text().strip().splitlines()
    assert len(lines) == len(sys_.tracker.trajectory)
    assert len(lines[0].split()) == 8      # x y z qx qy qz qw id
    q = np.asarray(lines[5].split()[3:7], float)
    assert abs(np.linalg.norm(q) - 1.0) < 1e-4
    klines = kp.read_text().strip().splitlines()
    assert len(klines) == sys_.map.n_keyframes
    assert len(klines[0].split()) == 8
    mlines = mp.read_text().strip().splitlines()
    assert len(mlines) == sys_.map.n_points and len(mlines[0].split()) == 4


def test_async_mapping_meets_the_map_gates():
    before = threading.active_count()
    sys_, poses, states = _orbit(async_mapping=True)
    assert not sys_._mapper_thread.is_alive()
    assert threading.active_count() == before
    assert sys_._kf_queue.empty()
    _check_map_gates(sys_, poses, states)
    assert sys_.mapper.ba_log
