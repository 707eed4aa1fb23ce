"""Load the reference's YAML rig configuration format.

The port's own copy of orbslam2_dualcam_tpu/utils/yaml_config.py (no
torch, no jax); it builds the port's `SystemConfig`, and a test pins it
equal to the JAX package's parser on the same file.

Parses the cv::FileStorage-style YAML the original ships
(Dual-LenaCV.yaml, consumed at Tracking.cc:86-217): ``nCameras``,
per-camera ``CameraN.{fx,fy,cx,cy,k1,k2,p1,p2[,k3]}``, quaternion+
translation extrinsics ``CameraN.{qw,qx,qy,qz,tx,ty,tz}``, global
``Camera.{width,height,fps,RGB}`` and ``ORBextractor.*`` parameters, so a
user of the original can point this engine at their existing calibration
file unchanged."""

from __future__ import annotations

import re
from typing import Dict

from orbslam2_dualcam_tpu_torch.utils.config import (CameraConfig, OrbConfig,
                                                     SystemConfig)


def _parse_scalars(text: str) -> Dict[str, float]:
    """cv::FileStorage YAML is 'key: value' lines (with %YAML directive and
    occasional comments); parse the flat scalar map."""
    out: Dict[str, float] = {}
    for line in text.splitlines():
        line = line.split("#", 1)[0].strip()
        m = re.match(r"^([A-Za-z0-9_.]+)\s*:\s*(-?[0-9.eE+]+)\s*$", line)
        if m:
            out[m.group(1)] = float(m.group(2))
    return out


def load_rig_yaml(path: str) -> SystemConfig:
    with open(path) as f:
        vals = _parse_scalars(f.read())

    n_cams = int(vals.get("nCameras", 1))
    width = int(vals.get("Camera.width", 640))
    height = int(vals.get("Camera.height", 480))
    cams = []
    for c in range(n_cams):
        p = f"Camera{c}."
        cams.append(CameraConfig(
            fx=vals[p + "fx"], fy=vals[p + "fy"],
            cx=vals[p + "cx"], cy=vals[p + "cy"],
            dist=(vals.get(p + "k1", 0.0), vals.get(p + "k2", 0.0),
                  vals.get(p + "p1", 0.0), vals.get(p + "p2", 0.0),
                  vals.get(p + "k3", 0.0)),
            q_sc=(vals.get(p + "qw", 1.0), vals.get(p + "qx", 0.0),
                  vals.get(p + "qy", 0.0), vals.get(p + "qz", 0.0)),
            t_sc=(vals.get(p + "tx", 0.0), vals.get(p + "ty", 0.0),
                  vals.get(p + "tz", 0.0)),
            width=width, height=height))

    orb = OrbConfig(
        n_features=int(vals.get("ORBextractor.nFeatures", 1000)),
        scale_factor=float(vals.get("ORBextractor.scaleFactor", 1.2)),
        n_levels=int(vals.get("ORBextractor.nLevels", 8)),
        ini_th_fast=int(vals.get("ORBextractor.iniThFAST", 20)),
        min_th_fast=int(vals.get("ORBextractor.minThFAST", 7)))

    return SystemConfig(cameras=tuple(cams),
                        fps=float(vals.get("Camera.fps", 30.0)),
                        rgb=bool(int(vals.get("Camera.RGB", 1))), orb=orb)
