"""The readings that the limits of `correct` are set from: one process runs
a cell on many seeds, and prints for each seed the numbers compared for the
program and for the control (the reference in bfloat16 put in the
program's place), one JSON line per seed; with --plants, also one line per
seed and control planted in the program (slambench/controls.py), whose
trajectory numbers are that control's readings.

    python3 -m slambench.calibrate --workload <cell> --seconds 51 --seeds 1 2 3 ... \
        [--plants no_undistort tri_bf16]

On the card only, from the root of a checkout; the benchmark's own runs
do not run it.
"""

from __future__ import annotations

import time

T_PROCESS0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--plants", nargs="*", default=[])
    args = ap.parse_args(argv)

    from slambench import run as bench_run
    root = Path.cwd()
    bench_run.cache_dirs(root)
    from slambench import controls, harness
    import torch
    if not torch.cuda.is_available():
        print("slambench.calibrate: no CUDA device", file=sys.stderr)
        return 3
    bench = harness.load_json(root / "BENCHMARK.json")
    w, entry = bench_run.find(bench, args.workload)
    here = Path(harness.__file__).resolve().parent
    config = harness.load_json(root / entry["file"])
    traffic = harness.load_json(here / "traffic" / f"{w['traffic']}.json")
    limits = harness.load_json(here / "limits" / f"{w['name']}.json")
    t0 = T_PROCESS0
    for seed in args.seeds:
        for plant in [None] + list(args.plants):
            with (controls.planted(plant) if plant else contextlib.nullcontext()):
                out = harness.run_cell(w, config, traffic, limits, seed, args.seconds,
                                       False, torch.device("cuda", 0), t0,
                                       bench["end_to_end"], bench["per_layer"],
                                       control=plant is None)
            line = {"seed": seed, "plant": plant, "program": out["readings"]["program"],
                    "attempted": len(out["run"].submitted),
                    "published": len(out["run"].published), "failed": out["run"].failed,
                    "metrics": {k: v["value"] for k, v in out["metrics"].items()}}
            if plant is None:
                line["control"] = out["readings"]["control"]
            print(json.dumps(line), flush=True)
            t0 = time.perf_counter()
            del out
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
