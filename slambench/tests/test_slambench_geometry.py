"""The reference's least squares finds the optimum of a problem built
around known poses and points, and the judges read 0 at the optimum, 1 for
a state left as it started, and far off for the bfloat16 control."""

import numpy as np
import torch

from slambench import generator
from slambench.reference import geometry


def _problem(rng, n_kf=5, n_pt=300, noise=0.5):
    K = np.array([[[400.0, 0, 320], [0, 400.0, 240], [0, 0, 1]]])
    poses = np.stack([generator.orbit_pose(1.5, 0.05 * k) for k in range(n_kf)])
    X = rng.uniform([-2, -1, 3], [2, 1, 5], (n_pt, 3))
    kf, mp, uv = [], [], []
    for k in range(n_kf):
        xc = X @ poses[k][:3, :3].T + poses[k][:3, 3]
        ok = xc[:, 2] > 0.5
        pix = xc[:, :2] / xc[:, 2:] * 400.0 + [320, 240]
        for m in np.nonzero(ok)[0]:
            kf.append(k), mp.append(m), uv.append(pix[m] + rng.normal(0, noise, 2))
    T = lambda a, d=torch.float64: torch.as_tensor(np.asarray(a)).to(d)  # noqa: E731
    p = geometry.Problem(poses=T(poses), points=T(X), kf=T(kf, torch.long),
                         mp=T(mp, torch.long), cam=T(np.zeros(len(kf)), torch.long),
                         uv=T(uv), inv_sigma2=T(np.ones(len(kf))),
                         pose_fixed=T(np.arange(n_kf) < 2, torch.bool),
                         point_fixed=T(np.zeros(n_pt, bool), torch.bool))
    rig = geometry.Rig(T(K), T(np.eye(4)[None]))
    return p, rig


def test_ba_judge_reads_zero_at_optimum_and_one_unmoved():
    rng = np.random.default_rng(0)
    p, rig = _problem(rng)
    start = p._replace(points=p.points + torch.as_tensor(rng.normal(0, 0.02, p.points.shape)))
    opt = geometry.solve(start, rig, robust=True)
    x, (c0, c, c_ref) = geometry.judge_ba(start, opt, rig)
    assert abs(x) < 1e-6 and c_ref < c0
    x, _ = geometry.judge_ba(start, start, rig)
    assert abs(x - 1.0) < 1e-12
    x, _ = geometry.judge_ba(start, opt, rig, control=True)
    assert x > 0.05


def test_pose_judge():
    rng = np.random.default_rng(1)
    p, rig = _problem(rng, n_kf=1, noise=1.0)
    p = p._replace(pose_fixed=torch.zeros(1, dtype=torch.bool),
                   point_fixed=torch.ones(p.points.shape[0], dtype=torch.bool))
    opt = geometry.solve(p, rig, robust=False)
    assert abs(geometry.judge_pose(opt, rig)) < 1e-9
    moved = opt._replace(poses=geometry.se3_exp(torch.tensor([[0.002, 0, 0, 0, 0.001, 0.0]],
                                                             dtype=torch.float64)) @ opt.poses)
    assert geometry.judge_pose(moved, rig) > 1e-2
    assert geometry.judge_pose(opt, rig, control=True) > 1e-3
