"""BENCHMARK.json and the files it names, found by name.

- configs/<config>.json: a configuration (the `file` of its entry);
- traffic/<traffic>.json: a traffic mix, a data file that names its
  driver, traffic/<driver>.py, and holds the driver's parameters;
- workloads/<cell>.json: a cell's correctness limits and sample sizes;
- metrics/<metric>.py: one per-layer metric's reader, `read(obs)`.

A later cell, mix or metric is added as new files and new entries; no
file here needs an edit for it.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
from typing import Callable, Optional

from benchmark.harness.env import ROOT

BENCH = os.path.join(ROOT, "benchmark")


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load(root: str = ROOT) -> dict:
    return _json(os.path.join(root, "BENCHMARK.json"))


def cell(manifest: dict, name: str) -> dict:
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(manifest: dict, name: str) -> dict:
    for c in manifest["configs"]:
        if c["name"] == name:
            return _json(os.path.join(ROOT, c["file"]))
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    return _json(os.path.join(BENCH, "traffic", f"{name}.json"))


def limits(cell_name: str) -> dict:
    return _json(os.path.join(BENCH, "workloads", f"{cell_name}.json"))


def driver(name: str):
    """The traffic driver module traffic/<name>.py."""
    return importlib.import_module(f"benchmark.traffic.{name}")


def reader(metric: str) -> Callable[[dict], Optional[float]]:
    """metrics/<metric>.py's read(obs). A metric's name may hold dots, so
    the file is loaded by path, not imported as a package member."""
    path = os.path.join(BENCH, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(
        "bm_metric_" + metric.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def end_to_end(manifest: dict, cell_name: str) -> list[dict]:
    """The end-to-end metrics this cell reports: those that list it, and
    those without a `workloads` key."""
    return [m for m in manifest["end_to_end"]
            if cell_name in m.get("workloads", [cell_name])]


def per_layer(manifest: dict, cell_name: str) -> list[dict]:
    """The per-layer metrics read in this cell's traced run: those that
    list it, and those without a `workloads` key whose end-to-end metric
    the cell reports."""
    reported = {m["name"] for m in end_to_end(manifest, cell_name)}
    return [m for m in manifest["per_layer"]
            if cell_name in m.get("workloads", [])
            or ("workloads" not in m and m["moves"] in reported)]
