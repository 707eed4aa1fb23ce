"""Distributed global BA: milliseconds per LM iteration by shard count and
point layout.

Port of examples/bench_dist_ba.py.  A synthetic ring-of-keyframes problem
(defaults: 256 keyframes, 32768 points, 8 observations per point) is solved
by `optim.ba.solve_ba` and by `parallel.dist_ba.solve_ba_distributed` on
meshes of 1, 2 and 4 shards, replicated and point-sharded.  All the shards
of a mesh here lie on ONE device (a virtual mesh, like the reference's
`--xla_force_host_platform_device_count` CPU mesh): the numbers measure
the cost of the sharded schedule on that device (n times the edge-side
launches, the reductions), not a speed-up across devices.

The problem is solved with the rig whose camera took its observations
(`problem_rig`: 260 px focal length, principal point (160, 120)).  The
reference solves it with dual_default()'s rig (500 px, (320, 240)), with
which the observations are inconsistent.

    python -m orbslam2_dualcam_tpu_torch.examples.bench_dist_ba [--cpu]
        [--kf 256] [--mp 32768] [--obs 8] [--iters 10] [--shards 1,2,4]

It runs on the current CUDA device unless --cpu is given; without a card
and without --cpu it exits with an error.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time

import numpy as np
import torch

from orbslam2_dualcam_tpu_torch.ops import camera, lie
from orbslam2_dualcam_tpu_torch.optim import ba
from orbslam2_dualcam_tpu_torch.optim.ba import BAProblem
from orbslam2_dualcam_tpu_torch.optim.factors import Edges
from orbslam2_dualcam_tpu_torch.parallel import dist_ba
from orbslam2_dualcam_tpu_torch.parallel.runtime import Mesh
from orbslam2_dualcam_tpu_torch.utils.config import CameraConfig, SystemConfig
from orbslam2_dualcam_tpu_torch.utils.device import resolve_device

LAYOUTS = ("replicated", "sharded")
# the pinhole through which make_problem observes its points
FOCAL, CENTRE = 260.0, (160.0, 120.0)


def make_problem(rng: np.random.Generator, n_kf: int, n_mp: int,
                 obs_per_mp: int = 6, device=None) -> BAProblem:
    """Synthetic ring-of-keyframes BA problem at a controllable scale (the
    reference's, draw for draw): keyframes on a circle of radius 3 looking
    inwards, points uniform in [-4, 4]^3, each seen by `obs_per_mp` random
    keyframes through a 260 px pinhole with 0.5 px noise, edges padded to a
    multiple of 8, poses 2.. and points perturbed."""
    device = resolve_device(device)
    ang = np.linspace(0, 2 * np.pi, n_kf, endpoint=False)
    centers = np.stack([3 * np.cos(ang), np.zeros(n_kf), 3 * np.sin(ang)], 1)
    poses = []
    for c, a in zip(centers, ang):
        R = np.array([[np.cos(a), 0, -np.sin(a)], [0, 1, 0],
                      [np.sin(a), 0, np.cos(a)]])
        T = np.eye(4)
        T[:3, :3] = R
        T[:3, 3] = -R @ c
        poses.append(T)
    poses = np.asarray(poses, np.float32)
    points = rng.uniform(-4, 4, (n_mp, 3)).astype(np.float32)

    kf_of = rng.integers(0, n_kf, (n_mp, obs_per_mp)).astype(np.int64)
    mp_of = np.repeat(np.arange(n_mp, dtype=np.int64), obs_per_mp)
    kf_of = kf_of.reshape(-1)
    # project to generate consistent observations
    X = points[mp_of]
    T = poses[kf_of]
    xc = np.einsum('eij,ej->ei', T[:, :3, :3], X) + T[:, :3, 3]
    z = np.maximum(xc[:, 2], 0.5)
    uv = xc[:, :2] / z[:, None] * np.array([FOCAL, FOCAL]) + np.array(CENTRE)
    uv += rng.normal(0, 0.5, uv.shape)
    valid = xc[:, 2] > 0.3
    pad = (-len(mp_of)) % 8
    if pad:
        mp_of = np.concatenate([mp_of, np.zeros(pad, np.int64)])
        kf_of = np.concatenate([kf_of, np.zeros(pad, np.int64)])
        uv = np.concatenate([uv, np.zeros((pad, 2))])
        valid = np.concatenate([valid, np.zeros(pad, bool)])
    E = len(mp_of)

    def dev(a):
        return torch.as_tensor(a, device=device)

    edges = Edges(kf=dev(kf_of), mp=dev(mp_of),
                  cam=torch.zeros(E, dtype=torch.int64, device=device),
                  uv=dev(uv.astype(np.float32)),
                  inv_sigma2=torch.ones(E, device=device), valid=dev(valid))
    # perturb
    dp = rng.normal(0, 0.01, (n_kf, 6)).astype(np.float32)
    dp[:2] = 0
    poses0 = lie.se3_exp(dev(dp)) @ dev(poses)
    points0 = dev(points + rng.normal(0, 0.03, points.shape).astype(np.float32))
    fixed = torch.zeros(n_kf, dtype=torch.bool, device=device)
    fixed[:2] = True
    return BAProblem(poses=poses0, points=points0, edges=edges,
                     pose_valid=torch.ones(n_kf, dtype=torch.bool, device=device),
                     pose_fixed=fixed,
                     point_valid=torch.ones(n_mp, dtype=torch.bool, device=device))


def problem_rig(device=None) -> camera.CameraRig:
    """The one-camera rig of make_problem's observations."""
    cam = CameraConfig(fx=FOCAL, fy=FOCAL, cx=CENTRE[0], cy=CENTRE[1],
                       width=320, height=240)
    return camera.make_rig(SystemConfig(cameras=(cam,)), device=device)


def solver(prob: BAProblem, rig, device, n_shards: int, layout: str):
    """iters -> BAResult: ba.solve_ba for 0 shards, else the distributed
    solve on a virtual mesh of `n_shards` shards of `device`."""
    if n_shards == 0:
        return lambda iters: ba.solve_ba(prob, rig.T_sc, rig.adj_sc, rig.K,
                                         iters=iters)
    mesh = Mesh((device,) * n_shards)
    return lambda iters: dist_ba.solve_ba_distributed(
        prob, rig.T_sc, rig.adj_sc, rig.K, mesh, iters=iters,
        shard_points=layout == "sharded")


def ms_per_iter(solve, iters: int, device) -> float:
    """Host-clock ms per LM iteration: (t(1 + iters) - t(1)) / iters after
    one warm-up solve, each solve ending in a synchronization of the
    device."""
    def run(n):
        t0 = time.perf_counter()
        res = solve(n)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        float(res.cost)
        return time.perf_counter() - t0

    run(1)
    t1 = run(1)
    t2 = run(1 + iters)
    return (t2 - t1) / iters * 1e3


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--kf", type=int, default=256)
    ap.add_argument("--mp", type=int, default=32768)
    ap.add_argument("--obs", type=int, default=8)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--shards", default="1,2,4")
    args = ap.parse_args()
    try:
        device = resolve_device("cpu" if args.cpu else None)
    except RuntimeError as e:
        print(f"bench_dist_ba: {e}", file=sys.stderr)
        return 1
    rig = problem_rig(device)
    prob = make_problem(np.random.default_rng(0), args.kf, args.mp, args.obs,
                        device=device)
    E = int(prob.edges.kf.shape[0])
    if device.type == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
        where = f"{card}; every shard of a mesh on {device} (a virtual mesh)"
    else:
        where = "the host CPU; every shard of a mesh on it (a virtual mesh)"
    print(f"problem: K={args.kf} M={args.mp} E={E}; {where}")
    print(f"{'shards':>6} {'layout':>10} {'ms/LM-iter':>11} {'vs solve_ba':>11}")
    base = ms_per_iter(solver(prob, rig, device, 0, ""), args.iters, device)
    print(f"{'-':>6} {'solve_ba':>10} {base:>11.2f} {1.0:>10.2f}x")
    for n in (int(s) for s in args.shards.split(",")):
        for layout in LAYOUTS:
            if layout == "replicated" and E % n:
                continue
            per = ms_per_iter(solver(prob, rig, device, n, layout),
                              args.iters, device)
            print(f"{n:>6} {layout:>10} {per:>11.2f} {per / base:>10.2f}x")
    return 0


if __name__ == "__main__":
    sys.exit(main())
