"""Offline map-cloud tools: the original's `tools/` equivalents.

Port of orbslam2_dualcam_tpu/tools.py.  The original ships PCL-based
binaries (tools/convert_points.cpp, tools/fit_hall.cpp,
tools/visual_pcd.cpp): convert saved map points to point-cloud files,
denoise/voxel-filter them, and RANSAC-fit the dominant planes of a hall.
The cloud filters and the PLY writer are host numpy; the plane RANSAC
scores all hypotheses of a round as batched tensor ops on the card
(`device=None`, as every entry point of the port; `fit-planes --cpu` runs
it on the CPU).  Everything is reachable as
`python -m orbslam2_dualcam_tpu_torch.tools <cmd>`.

Usage:
  python -m orbslam2_dualcam_tpu_torch.tools convert map_points.txt out.ply
  python -m orbslam2_dualcam_tpu_torch.tools fit-planes map_points.txt --n 4
"""

from __future__ import annotations

import argparse
from typing import List, Tuple

import numpy as np
import torch

from orbslam2_dualcam_tpu_torch.utils.device import resolve_device, to_host


# ---------------------------------------------------------------------------
# I/O (convert_points.cpp equivalent)
# ---------------------------------------------------------------------------

def load_points_txt(path: str) -> np.ndarray:
    """Read the System.save_map_points format: `x y z mid` per line."""
    pts = []
    with open(path) as f:
        for line in f:
            v = line.split()
            if len(v) >= 3:
                pts.append([float(v[0]), float(v[1]), float(v[2])])
    return np.asarray(pts, np.float64).reshape(-1, 3)


def save_ply(points: np.ndarray, path: str,
             colors: np.ndarray | None = None) -> None:
    """ASCII PLY writer (replaces pcl::io::savePLYFile)."""
    n = len(points)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {n}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if colors is not None:
            f.write("property uchar red\nproperty uchar green\n"
                    "property uchar blue\n")
        f.write("end_header\n")
        for i in range(n):
            row = f"{points[i, 0]:.6f} {points[i, 1]:.6f} {points[i, 2]:.6f}"
            if colors is not None:
                c = colors[i]
                row += f" {int(c[0])} {int(c[1])} {int(c[2])}"
            f.write(row + "\n")


# ---------------------------------------------------------------------------
# cloud filters (fit_hall.cpp preprocessing equivalents)
# ---------------------------------------------------------------------------

def voxel_downsample(points: np.ndarray, voxel: float) -> np.ndarray:
    """One point per occupied voxel (centroid) — pcl::VoxelGrid."""
    if len(points) == 0:
        return points
    keys = np.floor(points / voxel).astype(np.int64)
    _, idx, inv = np.unique(keys, axis=0, return_index=True,
                            return_inverse=True)
    out = np.zeros((len(idx), 3))
    cnt = np.zeros(len(idx))
    np.add.at(out, inv, points)
    np.add.at(cnt, inv, 1.0)
    return out / cnt[:, None]


def remove_outliers(points: np.ndarray, k: int = 8,
                    std_ratio: float = 2.0) -> np.ndarray:
    """Statistical outlier removal (pcl::StatisticalOutlierRemoval):
    drop points whose mean k-NN distance exceeds mean + std_ratio*std."""
    n = len(points)
    if n <= k + 1:
        return points
    d2 = np.sum((points[:, None, :] - points[None, :, :]) ** 2, -1)
    np.fill_diagonal(d2, np.inf)
    knn = np.sqrt(np.sort(d2, axis=1)[:, :k]).mean(1)
    th = knn.mean() + std_ratio * knn.std()
    return points[knn <= th]


# ---------------------------------------------------------------------------
# plane fitting (fit_hall.cpp RANSAC equivalent) — batched on device
# ---------------------------------------------------------------------------

def fit_planes(points: np.ndarray, n_planes: int = 4,
               dist_th: float = 0.05, n_hyp: int = 512,
               min_inliers: int = 30, seed: int = 0,
               device=None) -> List[Tuple[np.ndarray, float, np.ndarray]]:
    """Sequential RANSAC plane extraction.

    Each round scores `n_hyp` 3-point plane hypotheses as one batched
    program on `device` (None: the current CUDA device): [H, 3, 3] triples,
    their cross products, the [N, H] point-plane distances and an inlier
    count per hypothesis, then the first best (torch.argmax, as jnp.argmax).
    The triples are drawn on the host with the reference's numpy calls, so
    both packages score the same ones.  The winner is refit on its inliers
    in float64 numpy, removed, and the next round runs.  Returns
    [(normal, d, inlier_points)] with n·x + d = 0."""
    device = resolve_device(device)
    out = []
    pts = np.asarray(points, np.float64)
    rng = np.random.default_rng(seed)
    for _ in range(n_planes):
        n = len(pts)
        if n < max(min_inliers, 3):
            break
        # offset trick keeps the three indices distinct without a host
        # rejection loop (a repeated index gives a zero cross product,
        # and the degenerate zero-normal "plane" would score dist=0 for
        # every point and win the argmax)
        base = rng.integers(0, n, (n_hyp, 3))
        tri = (base + np.array([0, 1, 2]) *
               rng.integers(1, n, (n_hyp, 1))) % n
        P = torch.as_tensor(pts[tri], dtype=torch.float32,
                            device=device)                    # [H, 3, 3]
        X = torch.as_tensor(pts, dtype=torch.float32, device=device)  # [N, 3]
        cross = torch.linalg.cross(P[:, 1] - P[:, 0], P[:, 2] - P[:, 0])
        norm = torch.linalg.vector_norm(cross, dim=-1)        # [H]
        nrms = cross / torch.clamp(norm, min=1e-12)[:, None]
        ds = -(nrms * P[:, 0]).sum(-1)
        dist = torch.abs(X @ nrms.T + ds)                     # [N, H]
        counts = torch.where(norm > 1e-9, (dist < dist_th).sum(0),
                             torch.zeros_like(norm, dtype=torch.int64))
        b = torch.argmax(counts)
        # one readback per round: the count, normal and offset of the best
        best, = to_host([torch.cat([counts[b].to(torch.float32)[None],
                                    nrms[b], ds[b][None]])])
        if int(best[0]) < min_inliers:
            break
        nrm = np.asarray(best[1:4], np.float64)
        d = float(best[4])
        # iterated least-squares refit (SVD plane): a winning hypothesis
        # that cut a diagonal strip across several structures converges
        # onto the dominant true plane as the inlier set re-forms
        for _ in range(5):
            inl = np.abs(pts @ nrm + d) < dist_th
            Q = pts[inl]
            if len(Q) < 3:
                break
            c = Q.mean(0)
            _, _, Vt = np.linalg.svd(Q - c)
            nrm = Vt[-1]
            d = -float(nrm @ c)
        inl = np.abs(pts @ nrm + d) < dist_th
        out.append((nrm, d, pts[inl]))
        pts = pts[~inl]
    return out


# ---------------------------------------------------------------------------
# offline viewer (tools/visualize.cpp + visual_pcd.cpp equivalent)
# ---------------------------------------------------------------------------

def load_trajectory_txt(path: str) -> np.ndarray:
    """Read the saver format `x y z qx qy qz qw [id]`: returns [N,3]
    camera centers (System.cc:335-410 text artifacts)."""
    out = []
    with open(path) as f:
        for line in f:
            v = line.split()
            if len(v) >= 7:
                out.append([float(v[0]), float(v[1]), float(v[2])])
    return np.asarray(out, np.float64).reshape(-1, 3)


def render_view(points: np.ndarray, out_path: str,
                traj: np.ndarray | None = None,
                kf_traj: np.ndarray | None = None) -> None:
    """Render saved map artifacts to a PNG: top-down (x,z) + side (x,y)
    panels — the headless stand-in for the reference's PCL/Pangolin
    offline viewers (tools/visualize.cpp, tools/visual_pcd.cpp)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 2, figsize=(12, 6))
    for ax, (i, j), name in zip(axes, ((0, 2), (0, 1)),
                                ("top-down (x,z)", "side (x,y)")):
        ax.scatter(points[:, i], points[:, j], s=1, c="0.55", label="points")
        if traj is not None and len(traj):
            ax.plot(traj[:, i], traj[:, j], "-", c="tab:blue", lw=1.0,
                    label="frames")
        if kf_traj is not None and len(kf_traj):
            ax.plot(kf_traj[:, i], kf_traj[:, j], "o-", c="tab:red", ms=2.5,
                    lw=0.8, label="keyframes")
        ax.set_title(name)
        ax.set_aspect("equal")
        ax.legend(loc="upper right", fontsize=8)
    fig.tight_layout()
    fig.savefig(out_path, dpi=110)
    plt.close(fig)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="orbslam2_dualcam_tpu_torch.tools")
    sub = ap.add_subparsers(dest="cmd", required=True)
    c = sub.add_parser("convert", help="map_points.txt -> .ply")
    c.add_argument("inp")
    c.add_argument("out")
    c.add_argument("--voxel", type=float, default=0.0)
    c.add_argument("--denoise", action="store_true")
    p = sub.add_parser("fit-planes", help="RANSAC dominant planes")
    p.add_argument("inp")
    p.add_argument("--n", type=int, default=4)
    p.add_argument("--dist", type=float, default=0.05)
    p.add_argument("--cpu", action="store_true",
                   help="score the hypotheses on the CPU, not the card")
    v = sub.add_parser("view", help="render saved map/trajectories to PNG")
    v.add_argument("inp", help="map_points.txt")
    v.add_argument("out", help="output .png")
    v.add_argument("--frames", default=None, help="frames.txt trajectory")
    v.add_argument("--keyframes", default=None, help="keyframes.txt")
    args = ap.parse_args(argv)

    pts = load_points_txt(args.inp)
    if args.cmd == "convert":
        if args.voxel > 0:
            pts = voxel_downsample(pts, args.voxel)
        if args.denoise:
            pts = remove_outliers(pts)
        save_ply(pts, args.out)
        print(f"wrote {len(pts)} points -> {args.out}")
    elif args.cmd == "view":
        traj = load_trajectory_txt(args.frames) if args.frames else None
        kfs = load_trajectory_txt(args.keyframes) if args.keyframes else None
        render_view(pts, args.out, traj=traj, kf_traj=kfs)
        print(f"rendered {len(pts)} points -> {args.out}")
    else:
        for i, (nrm, d, inl) in enumerate(
                fit_planes(pts, n_planes=args.n, dist_th=args.dist,
                           device="cpu" if args.cpu else None)):
            print(f"plane {i}: n=({nrm[0]:+.3f}, {nrm[1]:+.3f}, "
                  f"{nrm[2]:+.3f}) d={d:+.3f} inliers={len(inl)}")


if __name__ == "__main__":
    main()
