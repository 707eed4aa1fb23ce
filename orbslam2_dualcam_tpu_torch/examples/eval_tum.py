"""Evaluate monocular tracking on a recorded TUM RGB-D sequence.

Port of examples/eval_tum.py's `evaluate`: given an extracted TUM sequence
(rgb.txt, the rgb/ images and groundtruth.txt), it trains a vocabulary on
a subsample of the sequence's own descriptors, runs the mono SLAM system
with loop closing over the frames, and reports the Sim3-aligned ATE RMSE of
the tracked camera centres against the ground truth at matched timestamps.

The reference's `--try-download` and its URLs are left out: the port adds
no downloader, and the sequence must already be on disk.

    python -m orbslam2_dualcam_tpu_torch.examples.eval_tum --data DIR
        [--max-frames N] [--cpu]

It runs on the current CUDA device unless --cpu is given; without a card
and without --cpu it exits with an error.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from orbslam2_dualcam_tpu_torch.ops import orb
from orbslam2_dualcam_tpu_torch.pipeline.system import System
from orbslam2_dualcam_tpu_torch.utils import datasets, metrics
from orbslam2_dualcam_tpu_torch.utils.config import (CameraConfig, OrbConfig,
                                                     SystemConfig, VocabConfig)
from orbslam2_dualcam_tpu_torch.utils.convert import desc_to_numpy
from orbslam2_dualcam_tpu_torch.utils.device import resolve_device
from orbslam2_dualcam_tpu_torch.vocab import bow

# TUM Freiburg1 intrinsics (vision.in.tum.de/data/datasets/rgbd-dataset)
FR1 = dict(fx=517.3, fy=516.5, cx=318.6, cy=255.3,
           dist=(0.2624, -0.9531, -0.0054, 0.0026, 1.1633))


def evaluate(root: str, max_frames: int = 0, stride: int = 1,
             intr: dict = None, device=None) -> dict:
    """Track the sequence at `root` (every `stride`-th of its first
    `max_frames` frames, all for 0) on `device` (None: the current CUDA
    device) and return the frame, keyframe and loop counts and, with more
    than 10 frames matched to the ground truth, `ate_sim3_m`."""
    device = resolve_device(device)
    intr = FR1 if intr is None else intr
    ds = datasets.TumRgbDataset.load(root)
    img0 = ds.read(0)
    H, W = img0.shape
    cam = CameraConfig(width=W, height=H, fx=intr["fx"], fy=intr["fy"],
                       cx=intr["cx"], cy=intr["cy"],
                       dist=intr.get("dist", (0.0,) * 5))
    cfg = SystemConfig(cameras=(cam,),
                       orb=OrbConfig(n_features=1000, n_levels=8),
                       vocab=VocabConfig(branching=10, depth=3))
    # vocabulary from a sequence subsample (self-trained; an ORBvoc file
    # can be loaded through vocab/orbvoc.py instead)
    idx = list(range(0, len(ds.frames),
                     max(1, len(ds.frames) // 25)))[:25]
    descs = []
    for i in idx:
        f = orb.extract_orb(torch.as_tensor(ds.read(i), device=device),
                            cfg.orb, 1000)
        descs.append(desc_to_numpy(f.desc)[f.valid.cpu().numpy()])
    voc = bow.train_vocabulary(np.concatenate(descs)[:40000], branching=10,
                               depth=3, seed=1, weight_docs=descs,
                               device=device)

    sys_ = System(cfg, voc=voc, enable_loop_closing=True, device=device)
    n = len(ds.frames) if max_frames == 0 else min(max_frames,
                                                   len(ds.frames))
    for i in range(0, n, stride):
        ts, _ = ds.frames[i]
        sys_.track(ds.read(i)[None], ts)
    sys_.shutdown()

    # ATE against the ground truth at matched timestamps
    est_c, gt_c = [], []
    for fid, ts, rk, Trel, T in sys_.tracker.trajectory:
        g = ds.gt_center_at(ts)
        if g is None:
            continue
        est_c.append(np.linalg.inv(T)[:3, 3])
        gt_c.append(g)
    est_c, gt_c = np.asarray(est_c), np.asarray(gt_c)
    out = dict(n_frames=n, n_tracked=len(est_c),
               n_kf=sys_.map.n_keyframes,
               n_loops=(sys_.loop_closer.n_loops_closed
                        if sys_.loop_closer else 0))
    if len(est_c) > 10:
        out["ate_sim3_m"] = metrics.ate_rmse(est_c, gt_c, with_scale=True)
    print(out)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--data", required=True,
                    help="extracted TUM sequence directory")
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    try:
        device = resolve_device("cpu" if args.cpu else None)
    except RuntimeError as e:
        print(f"eval_tum: {e}", file=sys.stderr)
        return 1
    evaluate(args.data, args.max_frames, device=device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
