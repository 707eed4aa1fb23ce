"""Controls planted in the program, for the numbers that judge what no
plain reference can recompute step by step: the trajectory that the whole
system publishes (reference/trajectory.py).  Each breaks one thing that a
later change might be tempted to break, where it is produced:

- "no_undistort": the program is told that the lens has no distortion
  (the configuration states TUM1's radial-tangential model), so it skips
  undistorting its keypoints, as a change that dropped that step would;
- "tri_bf16": the points that local mapping triangulates are rounded to
  bfloat16 where they are produced, the step below the float32 that the
  program computes them in;
- "tri_far": a fault, not a control: each point that local mapping
  triangulates is put 10% farther from the keyframe that made it.

Used by slambench/calibrate.py (on the card) and the benchmark's tests;
the benchmark's own runs plant nothing.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

PLANTS = ("no_undistort", "tri_bf16", "tri_far")


@contextlib.contextmanager
def planted(name: str):
    from orbslam2_dualcam_tpu_torch.pipeline import frontend
    from orbslam2_dualcam_tpu_torch.utils import yaml_config

    if name == "no_undistort":
        mod, attr = yaml_config, "load_rig_yaml"
        real = mod.load_rig_yaml

        def patched(*a, **k):
            cfg = real(*a, **k)
            cams = tuple(dataclasses.replace(c, dist=(0.0,) * 5) for c in cfg.cameras)
            return dataclasses.replace(cfg, cameras=cams)
    elif name == "tri_bf16":
        mod, attr = frontend, "triangulate_pairs_batch"
        real = mod.triangulate_pairs_batch

        def patched(*a, **k):
            idx, X, good = real(*a, **k)
            return idx, X.to(torch.bfloat16).to(X.dtype), good
    elif name == "tri_far":
        mod, attr = frontend, "triangulate_pairs_batch"
        real = mod.triangulate_pairs_batch

        def patched(T1, *a, **k):
            idx, X, good = real(T1, *a, **k)
            R, t = T1[:, :3, :3].to(X.dtype), T1[:, :3, 3].to(X.dtype)
            c = -(R.transpose(1, 2) @ t[..., None])[..., 0]
            return idx, c[:, None] + 1.1 * (X - c[:, None]), good
    else:
        raise ValueError(f"no control {name!r} (have {PLANTS})")
    setattr(mod, attr, patched)
    try:
        yield
    finally:
        setattr(mod, attr, real)
