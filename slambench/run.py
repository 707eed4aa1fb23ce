"""The benchmark of orbslam2_dualcam_tpu_torch: one run of one cell.

    python3 -m slambench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with the card(s) the cell asks
for.  The cells, metrics and bounds are in BENCHMARK.json at the root.

Prints, as the last line of standard output, one JSON object with
`correct`, `attempted`, `failed`, `metrics`, `device` (and `breakdown`
with --trace 1), and as the last lines of standard error each number that
decides `correct` beside its limit.  With --trace 0 the metrics are the
cell's end-to-end metrics, with --trace 1 its per-layer metrics (the
profiler over the window).  Exits non-zero, with no result line, without
the card(s), when the program cannot be imported, or when JAX or the JAX
package got loaded.
"""

from __future__ import annotations

import time

T_PROCESS0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402


def cache_dirs(root: Path) -> None:
    """Every build and kernel cache at a fixed path inside the checkout:
    only a cell's first run there builds.  (The program's own CUDA library
    and postings index build into orbslam2_dualcam_tpu_torch/_build/,
    which also lies inside the checkout.)"""
    base = root / ".slambench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(base / sub)


def find(bench: dict, workload: str):
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"slambench: no workload {workload!r} in BENCHMARK.json "
                         f"(have {sorted(cells)})")
    w = cells[workload]
    config = next(c for c in bench["configs"] if c["name"] == w["config"])
    return w, config


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    root = Path.cwd()
    cache_dirs(root)
    from slambench import harness

    bench = harness.load_json(root / "BENCHMARK.json")
    w, config_entry = find(bench, args.workload)

    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(w["chips"]):
        print(f"slambench: {args.workload} needs {w['chips']} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count() {torch.cuda.device_count()}", file=sys.stderr)
        return 3

    here = Path(harness.__file__).resolve().parent
    config = harness.load_json(root / config_entry["file"])
    traffic = harness.load_json(here / "traffic" / f"{w['traffic']}.json")
    limits = harness.load_json(here / "limits" / f"{w['name']}.json")
    out = harness.run_cell(w, config, traffic, limits, args.seed, args.seconds,
                           bool(args.trace), torch.device("cuda", 0), T_PROCESS0,
                           bench["end_to_end"], bench["per_layer"])
    return report(out, args, torch)


def report(out: dict, args, torch) -> int:
    from slambench.harness import forbidden_modules
    forbidden = sorted(set(out["forbidden"]) | set(forbidden_modules()))
    if forbidden:
        print(f"slambench: modules of {forbidden} were loaded; the benchmark "
              f"runs the port alone", file=sys.stderr)
        return 4
    run = out["run"]
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": 1, "memory_peak_bytes": int(out["peak"])}
    result = {"correct": bool(out["correct"]), "attempted": len(run.submitted),
              "failed": int(run.failed), "metrics": out["metrics"], "device": device}
    if args.trace:
        t = out["trace"]
        device["busy_s"] = t["busy_s"]
        device["window_s"] = t["window_s"]
        result["breakdown"] = {"device_ops": t["device_ops"],
                               "idle_gaps": t["idle_gaps"]}
    result["checks"] = out["checks"]
    for name, c in out["checks"].items():
        ok = c["value"] is not None and c["value"] <= c["limit"]
        print(f"check {name} {c['value']} limit {c['limit']} "
              f"{'ok' if ok else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
