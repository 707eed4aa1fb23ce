"""The one generator of the benchmark's traffic: a traffic file of
parameters (slambench/traffic/<name>.json) and the seed in, the rig's
poses and the steps that feed them to the system out.

A traffic file holds:

- "system": how the system is driven ("deferred_tracking",
  "pipeline_depth");
- "paths": named paths of rig poses, in order; each names its "kind", a
  file slambench/paths/<kind>.py whose `make(params, rng, paths)` returns
  a `Path` (it may read the paths made before it, and draws what it draws
  from `rng`, the seed's);
- "setup" and "window": lists of steps; each names its "step", a file
  slambench/steps/<step>.py whose `run(ctx, step)` drives the system and
  yields after each timed call.  Set-up runs its steps once; the window
  cycles through its steps until the window closes.

A path keeps a cursor: a "track" step feeds a path's frames from where the
last step on that path stopped.  When the window's cycle starts over, every
cursor goes back to the path's first frame.  A later traffic that uses the
kinds here is a data file alone; a new kind of path or step is a file of its
own beside these.
"""

from __future__ import annotations

import importlib.util
from dataclasses import dataclass, field
from pathlib import Path as FsPath
from typing import Dict, List

import numpy as np

HERE = FsPath(__file__).resolve().parent


@dataclass
class Path:
    poses: List[np.ndarray]                       # T_cw of the rig, in order
    meta: Dict[str, float] = field(default_factory=dict)


@dataclass
class Plan:
    poses: List[np.ndarray]                       # every pose to render
    offset: Dict[str, int]                        # a path's first index in `poses`
    length: Dict[str, int]                        # a path's number of frames
    setup: List[dict]
    window: List[dict]
    deferred: bool = False
    pipeline_depth: int = 3


def load_kind(folder: str, kind: str):
    """The module slambench/<folder>/<kind>.py, found by name."""
    path = HERE / folder / f"{kind}.py"
    if not path.is_file():
        raise ValueError(f"no {folder[:-1]} kind {kind!r} (no {path})")
    spec = importlib.util.spec_from_file_location(f"slambench_{folder}_{kind}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def make_plan(traffic: dict, seed: int) -> Plan:
    rng = np.random.default_rng(seed)
    paths: Dict[str, Path] = {}
    for name, params in traffic["paths"].items():
        paths[name] = load_kind("paths", params["kind"]).make(params, rng, paths)
    poses: List[np.ndarray] = []
    offset, length = {}, {}
    for name, p in paths.items():
        offset[name], length[name] = len(poses), len(p.poses)
        poses += p.poses
    system = traffic.get("system", {})
    return Plan(poses=poses, offset=offset, length=length,
                setup=list(traffic.get("setup", [])), window=list(traffic["window"]),
                deferred=bool(system.get("deferred_tracking", False)),
                pipeline_depth=int(system.get("pipeline_depth", 3)))
