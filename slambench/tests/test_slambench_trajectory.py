"""The trajectory's reference numbers: a published trajectory that is the
true one in another frame and scale reads 0; noise reads in proportion."""

import numpy as np

from slambench import generator
from slambench.reference import trajectory


def _similar(T_cw, R, t, s):
    """The same camera in a map whose frame is turned by R, moved by t and
    scaled by s (X_map = s R X_world + t)."""
    out = np.eye(4)
    out[:3, :3] = T_cw[:3, :3] @ R.T
    out[:3, 3] = s * T_cw[:3, 3] - out[:3, :3] @ t
    return out


def test_a_similar_trajectory_reads_zero():
    gt = generator.orbit_path(1.5, 0.3, np.radians(2.4), 40)
    R = generator.so3_exp_y(0.7) @ np.array([[1, 0, 0], [0, 0, -1], [0, 1, 0.0]])
    est = [_similar(T, R, np.array([0.2, -1.0, 3.0]), 0.37) for T in gt]
    r = trajectory.judge_map(est, gt)
    assert r["traj_err"] < 1e-9 and r["traj_rot_deg"] < 1e-5


def test_noise_reads_in_proportion():
    rng = np.random.default_rng(0)
    gt = generator.orbit_path(1.5, 0.3, np.radians(2.4), 40)
    reads = []
    for sigma in (0.01, 0.04):
        est = []
        for T in gt:
            E = T.copy()
            E[:3, 3] += rng.normal(0, sigma, 3)
            est.append(E)
        reads.append(trajectory.judge_map(est, gt)["traj_err"])
    assert 0 < reads[0] < reads[1] < 1


def test_short_maps_are_not_judged():
    gt = generator.orbit_path(1.5, 0.0, 0.04, trajectory.MIN_FRAMES - 1)
    assert trajectory.judge([[(T, T) for T in gt]]) == {}
