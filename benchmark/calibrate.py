#!/usr/bin/env python3
"""The readings a training cell's limits are set from, over many seeds.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 \\
        [--fault half_batch:4,5,6 ...] [--control] [--witness]

For each seed it drives the cell's checked steps (traffic/train_fit.py:
trainer.fit's first step, then its blocks, at the cell's size and on
its ranks, as a run's set-up drives them); a seed given under --fault
runs with that fault (tests/faults.py) planted for its steps alone. It
prints one JSON line a seed: the numbers compare.py computes against
the plain reference (`program`) and whether the cell's own limits
(workloads/<cell>.json) judge them correct; with --control, the same of
the reference computed in TF32 put in the program's place (`control`);
with --witness, the program's and the float32 reference's readings
against the reference in float64, how far rounding alone moves each
number. The last line gives, for each number, the largest sound reading,
the smallest reading of each fault and of the control, and how many
seeds of each side the limits judged correct. The benchmark's own runs
never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from benchmark.harness import env  # noqa: E402

env.prepare()


def _seeds(text: str) -> list[int]:
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--fault", action="append", default=[],
                    help="<fault>:<seed>,<seed>,...")
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--witness", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from benchmark.harness import compare, manifest
    from benchmark.traffic import train_fit

    plan = [[s, None] for s in _seeds(args.seeds)]
    for f in args.fault:
        name, seeds = f.split(":", 1)
        plan += [[s, name] for s in _seeds(seeds)]
    m = manifest.load()
    cell = manifest.cell(m, args.workload)
    limits = manifest.limits(args.workload)["limits"]
    run_dir = tempfile.mkdtemp(prefix="bm-cal-")
    spec = {"config": manifest.config(m, cell["config"]),
            "traffic": manifest.traffic(cell["traffic"]),
            "seed": plan[0][0], "seconds": 0, "trace": False,
            "device": args.device, "run_dir": run_dir, "seeds": plan}
    extremes: dict = {}
    judged: dict = {}
    try:
        if cell["chips"] == 1:
            train_fit.rank_main(spec)
        else:
            train_fit.run_ranks(spec, cell["chips"])
        device = torch.device("cuda", 0) if args.device == "cuda" else \
            torch.device("cpu")
        for s, fault in plan:
            one = {**spec, "seed": s, "check": f"check-{s}.pt"}
            t0 = time.monotonic()
            prog, ref, init, ctrl, exact = train_fit.reference(
                one, device, args.control and fault is None,
                witness=args.witness)
            side = fault or "program"
            line = {"seed": s, "fault": fault,
                    "reference_s": time.monotonic() - t0,
                    side: compare.train_readings(prog, ref, init)}
            if ctrl is not None:
                line["control"] = compare.train_readings(ctrl, ref, init)
            if exact is not None:
                line["program_vs_f64"] = compare.train_readings(
                    prog, exact, init)
                line["reference_vs_f64"] = compare.train_readings(
                    ref, exact, init)
            for name in (side, "control"):
                if name not in line:
                    continue
                ok = compare.judge(line[name], limits)[0]
                line[f"{name}_correct"] = ok
                counts = judged.setdefault(name, [0, 0])
                counts[0] += ok
                counts[1] += 1
                fold = max if name == "program" else min
                for k, v in line[name].items():
                    if not k.startswith("_"):
                        key = f"{name}.{k}"
                        extremes[key] = fold(extremes.get(key, v), v)
            print(json.dumps(line), flush=True)
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)
    print(json.dumps({"workload": args.workload, "limits": limits,
                      "extremes": extremes,
                      "correct_of_seeds": judged}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
