"""Offline visualization: frame overlays and 3D map plots.

The port's own copy of orbslam2_dualcam_tpu/viz/viewer.py (numpy, with
matplotlib imported inside each function; no torch, no jax): it draws
host arrays and the host map, so nothing of it runs on the card.

Replaces the original's live Pangolin/OpenCV viewer stack
(src/{Viewer,FrameDrawer,MapDrawer}.cc) with headless matplotlib rendering
(the card's hosts have no display).  Feature parity:

* draw_frame — side-by-side dual image with tracked keypoints overlaid and
  a state HUD (FrameDrawer::DrawFrame, FrameDrawer.cc:64-161).
* plot_map — 3D map points colored by camera observability (black =
  single-camera, green = cross-camera-observed, MapDrawer.cc:97-120),
  keyframe frusta, covisibility graph, current + reloc camera
  (MapDrawer::Draw*, MapDrawer.cc:78-136).
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def draw_frame(images: np.ndarray, uv: np.ndarray, valid: np.ndarray,
               tracked: np.ndarray, state: str, path: str) -> None:
    """Save a side-by-side annotated dual frame (jointImage + overlays).

    images [ncam,H,W]; uv [ncam,N,2]; valid/tracked [ncam,N] bools."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    ncam, H, W = images.shape
    joint = np.concatenate(list(images), axis=1)
    fig, ax = plt.subplots(figsize=(4 * ncam, 3.2), dpi=110)
    ax.imshow(joint, cmap="gray", vmin=0, vmax=255)
    for c in range(ncam):
        off = c * W
        sel = valid[c] & ~tracked[c]
        ax.plot(uv[c][sel, 0] + off, uv[c][sel, 1], '.', ms=2,
                color="#4477aa", alpha=0.5)
        sel = valid[c] & tracked[c]
        ax.plot(uv[c][sel, 0] + off, uv[c][sel, 1], 'o', ms=3,
                mfc="none", color="#22aa55")
    n_tracked = int(tracked.sum())
    ax.set_title(f"{state} | tracked {n_tracked}", fontsize=9)
    ax.axis("off")
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)


def plot_map(m, rig_T_sc: np.ndarray, path: str,
             current_T_cw: Optional[np.ndarray] = None,
             reloc_T_cw: Optional[np.ndarray] = None,
             draw_covis: bool = True) -> None:
    """Save a 3D map snapshot."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(7, 6), dpi=110)
    ax = fig.add_subplot(111, projection="3d")
    mono, cross = [], []
    for mp in m.points.values():
        (cross if mp.seen_by_multiple_cams else mono).append(mp.pos)
    if mono:
        P = np.asarray(mono)
        ax.scatter(P[:, 0], P[:, 2], -P[:, 1], s=1, c="k", alpha=0.4,
                   label=f"points ({len(mono)})")
    if cross:
        P = np.asarray(cross)
        ax.scatter(P[:, 0], P[:, 2], -P[:, 1], s=3, c="g",
                   label=f"cross-cam ({len(cross)})")
    centers = {}
    for kid, kf in m.keyframes.items():
        centers[kid] = kf.center()
    if centers:
        C = np.asarray(list(centers.values()))
        ax.plot(C[:, 0], C[:, 2], -C[:, 1], 'b^', ms=3, label="keyframes")
    if draw_covis:
        for kid, kf in m.keyframes.items():
            for nkid in kf.covis:
                if nkid > kid and nkid in centers:
                    a, b = centers[kid], centers[nkid]
                    ax.plot([a[0], b[0]], [a[2], b[2]], [-a[1], -b[1]],
                            '-', color="#8899bb", lw=0.3, alpha=0.5)

    def frustum(T_cw, color):
        c = -T_cw[:3, :3].T @ T_cw[:3, 3]
        z = T_cw[:3, :3].T @ np.array([0, 0, 0.5])
        ax.plot([c[0], c[0] + z[0]], [c[2], c[2] + z[2]],
                [-c[1], -c[1] - z[1]], '-', color=color, lw=2)
        ax.plot([c[0]], [c[2]], [-c[1]], 's', color=color, ms=6)

    if current_T_cw is not None:
        frustum(current_T_cw, "red")
    if reloc_T_cw is not None:
        frustum(reloc_T_cw, "orange")
    ax.set_xlabel("x")
    ax.set_ylabel("z")
    ax.set_zlabel("-y")
    ax.legend(loc="upper right", fontsize=7)
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)
