"""Video-driven SLAM CLI, the original's example binary as a module.

Port of orbslam2_dualcam_tpu/run.py, the equivalent of
Examples/Dual/dual_slam_video.cpp: reads a joint side-by-side video,
splits each frame into the per-camera slices, feeds the system, and writes
trajectories/map artifacts (FramePoseTcw.txt, KeyFramePoseTcw.txt,
MapPoint.txt and map.npz, the archive of utils/checkpoint.py, which either
package loads).

Usage:
  python -m orbslam2_dualcam_tpu_torch.run --settings Dual-LenaCV.yaml \\
      --video indoor_lab_loop.avi [--vocab ORBvoc.bin|.txt|.npz] \\
      [--out out_dir] [--max-frames N] [--mono] [--no-loop] [--cpu] \\
      [--viewer] [--viewer-port P]

One deliberate difference from the JAX package's CLI: that one runs on the
CPU unless SLAM_TPU=1 is set; this one runs on the current CUDA device
unless --cpu is given, and has no environment switch.  Without a CUDA
device and without --cpu it exits non-zero before reading anything; it
never carries on on the CPU.

The original's positional CLI was `dual_slam_video voc.bin settings.yaml
video.avi` (dual_slam_video.cpp:45-52); --vocab accepts the original's
DBoW2 ORBvoc artifact directly (binary or text, vocab/orbvoc.py) as well
as the .npz format (train one with vocab.bow.train_vocabulary)."""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Iterable

import numpy as np


def track_stream(sys_, frames: Iterable[np.ndarray], n_cameras: int,
                 fps: float, max_frames: int = 0) -> int:
    """Feed joint grayscale frames [H, n_cameras * w] to `sys_.track`, each
    split into equal horizontal slices (dual_slam_video.cpp:76-86 splits
    left/right halves), at timestamps n / fps.  Stops after `max_frames`
    frames (0: all) and returns the number tracked; prints a progress line
    every 30 frames."""
    n = 0
    t0 = time.time()
    for gray in frames:
        if max_frames and n >= max_frames:
            break
        H, W = gray.shape
        if n_cameras > 1:
            w = W // n_cameras
            imgs = np.stack([gray[:, c * w:(c + 1) * w]
                             for c in range(n_cameras)])
        else:
            imgs = gray[None]
        st = sys_.track(imgs, n / fps)
        if n % 30 == 0:
            rate = (n + 1) / max(time.time() - t0, 1e-9)
            print(f"frame {n:5d} state={st:15s} kf={sys_.map.n_keyframes:4d} "
                  f"mp={sys_.map.n_points:6d} ({rate:.1f} fps)")
        n += 1
    return n


def write_artifacts(sys_, out: str) -> None:
    """The four artifacts of a run, into directory `out`."""
    from orbslam2_dualcam_tpu_torch.utils import checkpoint

    os.makedirs(out, exist_ok=True)
    sys_.save_frame_trajectory(os.path.join(out, "FramePoseTcw.txt"))
    sys_.save_keyframe_trajectory(os.path.join(out, "KeyFramePoseTcw.txt"))
    sys_.save_map_points(os.path.join(out, "MapPoint.txt"))
    checkpoint.save_map(sys_.map, os.path.join(out, "map.npz"))


def video_frames(cap):
    """Grayscale float32 frames of an open cv2.VideoCapture."""
    import cv2

    while True:
        ok, frame = cap.read()
        if not ok:
            return
        yield cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY).astype(np.float32)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--settings", required=True, help="rig YAML (original format)")
    ap.add_argument("--video", required=True, help="joint side-by-side video")
    ap.add_argument("--vocab", default=None,
                    help="vocabulary: .npz or the original's DBoW2 "
                         "ORBvoc .bin/.txt (System.cc:88-102 loads both)")
    ap.add_argument("--out", default="slam_out", help="output directory")
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--mono", action="store_true",
                    help="use only camera 0 (no splitting)")
    ap.add_argument("--no-loop", action="store_true")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the current CUDA device)")
    ap.add_argument("--viewer", action="store_true",
                    help="serve the live viewer (viz/live.py) over HTTP")
    ap.add_argument("--viewer-port", type=int, default=0,
                    help="live viewer port (0 = pick a free one)")
    args = ap.parse_args(argv)

    from orbslam2_dualcam_tpu_torch.utils.device import resolve_device

    try:
        device = resolve_device("cpu" if args.cpu else None)
    except RuntimeError as e:
        print(e, file=sys.stderr)
        return 1

    import cv2

    from orbslam2_dualcam_tpu_torch.pipeline.system import System
    from orbslam2_dualcam_tpu_torch.utils.yaml_config import load_rig_yaml
    from orbslam2_dualcam_tpu_torch.vocab import bow

    cfg = load_rig_yaml(args.settings)
    voc = None
    if args.vocab:
        if args.vocab.endswith(".npz"):
            voc = bow.load_vocabulary(args.vocab, device=device)
        else:  # the original's DBoW2 artifact (.bin/.txt)
            from orbslam2_dualcam_tpu_torch.vocab.orbvoc import load_orbvoc
            voc = load_orbvoc(args.vocab, device=device)
    sys_ = System(cfg, voc=voc, enable_loop_closing=not args.no_loop,
                  viewer=args.viewer, viewer_port=args.viewer_port,
                  device=device)

    cap = cv2.VideoCapture(args.video)
    if not cap.isOpened():
        print(f"cannot open video: {args.video}", file=sys.stderr)
        sys_.shutdown()
        return 1
    ncam = cfg.n_cameras if not args.mono else 1
    n = track_stream(sys_, video_frames(cap), ncam, cfg.fps, args.max_frames)
    cap.release()
    sys_.shutdown()

    write_artifacts(sys_, args.out)
    print(f"{n} frames; artifacts in {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
