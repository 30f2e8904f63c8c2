#!/usr/bin/env python3
"""Run one cell of BENCHMARK.json once, on the card, and print one line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell's configuration, traffic mix, limits and per-layer readers are
found by name (harness/manifest.py). The traffic's driver loads, warms
up, measures for `--seconds` and checks what the window produced
against the plain reference; this script turns its outcome into the
result: the last line of standard output, one JSON object (`correct`,
`attempted`, `failed`, `metrics`, `device`, with `--trace 1` also
`breakdown`, and last `checks`, each compared number beside its
limit). The same numbers close standard error.

With `--trace 0` the metrics are the cell's end-to-end ones, timed on
the host's clock; with `--trace 1` its per-layer ones, read from a
device trace of a steady slice of the window and from the program's
spans and counters.

Without a card, or with fewer cards than the cell asks for, it exits 2
and prints no result; it never falls back to the CPU. It also exits 3
with no result when, once the window has closed, this process or any
rank process of the cell holds jax, jaxlib, flax, optax or the JAX
package.
"""

from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from benchmark.harness import env  # noqa: E402

env.prepare()

from benchmark.harness import compare, manifest  # noqa: E402

NO_DEVICE, FORBIDDEN_LOADED = 2, 3
HUGE = sys.float_info.max      # a tail with more than 5% misses


def _metric(value: float, unit: str) -> dict:
    return {"value": value if value == value and value != float("inf")
            else HUGE, "unit": unit}


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: float = T_START,
             overrides: dict = None) -> dict:
    """Run cell `name` once and return its result line as a dict.
    `device` "cpu" and `overrides` (entries of the driver's context;
    "traffic" updates the mix's parameters) are for tests on the CPU."""
    import torch

    overrides = dict(overrides or {})
    m = manifest.load()
    cell = manifest.cell(m, name)
    traffic = manifest.traffic(cell["traffic"])
    ctx = {"cell": cell, "chips": cell["chips"],
           "config": manifest.config(m, cell["config"]),
           "traffic": {**traffic, **overrides.pop("traffic", {})},
           "seed": seed, "seconds": seconds, "trace": bool(trace),
           "device": device, "t_start": t_start, **overrides}
    run_dir = tempfile.mkdtemp(prefix="bm-run-")
    try:
        ctx["run_dir"] = run_dir
        out = manifest.driver(traffic["driver"]).run(ctx)
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)
    limits = manifest.limits(name)["limits"]
    correct, checks = compare.judge(out["readings"], limits)

    metrics = {}
    if trace:
        obs = out["obs"]
        for spec in manifest.per_layer(m, name):
            value = manifest.reader(spec["name"])(obs)
            if value is not None:
                metrics[spec["name"]] = _metric(value, spec["unit"])
    else:
        for spec in manifest.end_to_end(m, name):
            metrics[spec["name"]] = _metric(
                out["end_to_end"][spec["name"]], spec["unit"])
    cuda = device == "cuda"
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell["chips"],
           "memory_peak_bytes": out["memory_peak_bytes"]}
    result = {"correct": correct, "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics, "device": dev}
    traces = out["traces"]
    if trace and traces:
        dev["busy_s"] = sum(t["busy_s"] for t in traces) / len(traces)
        dev["window_s"] = sum(t["window_s"] for t in traces) / len(traces)
        result["breakdown"] = {"device_ops": traces[0]["device_ops"],
                               "idle_gaps": traces[0]["idle_gaps"]}
    result["checks"] = checks
    result["_loaded"] = out["loaded"]
    result["_notes"] = {**out.get("notes", {}), "readings": {
        k: v for k, v in out["readings"].items() if not k.startswith("_")},
        "end_to_end": out["end_to_end"]}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    chips = manifest.cell(manifest.load(), args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"run: {args.workload} needs {chips} CUDA card(s); this "
              f"machine has {torch.cuda.device_count()}", file=sys.stderr)
        return NO_DEVICE
    return finish(run_cell(args.workload, args.seed, args.seconds,
                           bool(args.trace)))


def finish(result: dict) -> int:
    """Print `result` (run_cell's) and return 0; or, where this process
    or a rank held a forbidden module once the window closed, name it on
    standard error, print no result and return 3."""
    found = sorted(set(env.forbidden_loaded()) | set(result.pop("_loaded")))
    if found:
        print(f"run: the run loaded {', '.join(found)}; no result",
              file=sys.stderr)
        return FORBIDDEN_LOADED
    notes = result.pop("_notes")
    print("run: " + json.dumps(notes, default=str), file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
