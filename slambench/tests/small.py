"""A cell of the benchmark cut to a size that a CPU test run can hold:
320x240 frames, 400 features, 24-frame arcs."""

from __future__ import annotations

import json
import time
from pathlib import Path

from slambench import harness

ROOT = Path(__file__).resolve().parents[2]


def bench() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def small_cell(workload: str):
    b = bench()
    w = next(x for x in b["workloads"] if x["name"] == workload)
    cfg = harness.load_json(ROOT / "slambench" / "configs" / f"{w['config']}.json")
    s = cfg["settings"]
    for k in list(s):
        if k.endswith((".fx", ".fy", ".cx", ".cy")):
            s[k] = s[k] / 2
    s["Camera.width"], s["Camera.height"] = 320, 240
    s["ORBextractor.nFeatures"] = 400
    cfg["room"]["tex_size"] = 256
    cfg["vocabulary"]["frames"] = 3
    traffic = harness.load_json(ROOT / "slambench" / "traffic" / f"{w['traffic']}.json")
    for p in traffic["paths"].values():
        if p["kind"] == "orbit":
            p["frames"] = min(p["frames"], 24)
    limits = harness.load_json(ROOT / "slambench" / "limits" / f"{workload}.json")
    return b, w, cfg, traffic, limits


def run_small(workload: str, seed: int, seconds: float, control: bool = False) -> dict:
    b, w, cfg, traffic, limits = small_cell(workload)
    return harness.run_cell(w, cfg, traffic, limits, seed, seconds, False, "cpu",
                            time.perf_counter(), b["end_to_end"], b["per_layer"],
                            control=control)
