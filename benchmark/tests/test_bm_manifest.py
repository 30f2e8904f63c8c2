"""BENCHMARK.json against the format it must keep, and every name in it
found by the harness."""

import json
import os
import re

import pytest

from benchmark.harness import manifest
from benchmark.harness.env import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def m():
    return manifest.load()


def _line(s):
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level(m):
    assert set(m) == TOP_KEYS
    assert m["command"] == ["python3", "benchmark/run.py"]
    assert m["paths"] == ["benchmark"]
    assert 1 <= m["run_seconds"] <= 51
    size = os.path.getsize(os.path.join(ROOT, "BENCHMARK.json"))
    assert size <= 64 * 1024


def test_budget_holds_24_cells(m):
    cells = 24
    runs = 2 + 14 * cells
    total = runs * (m["run_seconds"] + 60) + cells * 2 * 90 + 1200
    assert total <= 43200


def test_names_and_units(m):
    names = [c["name"] for c in m["configs"]]
    names += [w["name"] for w in m["workloads"]]
    metrics = m["end_to_end"] + m["per_layer"]
    for x in names + [w["traffic"] for w in m["workloads"]] + [
            w["config"] for w in m["workloads"]] + [
            k for c in m["configs"] for k in c["reduced"]]:
        assert NAME.match(x), x
    for x in metrics:
        assert NAME.match(x["name"]), x["name"]
        assert UNIT.match(x["unit"]), x["unit"]
        assert x["better"] in ("lower", "higher")
    assert len({c["name"] for c in m["configs"]}) == len(m["configs"])
    assert len({w["name"] for w in m["workloads"]}) == len(m["workloads"])
    assert len({x["name"] for x in metrics}) == len(metrics)


def test_entry_keys_and_lines(m):
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["why"]) and _line(c["source"])
        assert len(c["reduced"]) <= 16
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _line(w["why"])
    for x in m["end_to_end"]:
        assert set(x) - {"workloads"} == {"name", "unit", "better",
                                           "bound", "source"}
        assert x["source"] in ("host_clock", "device_trace")
        assert 0.01 <= x["bound"] <= 0.25
    for x in m["per_layer"]:
        assert set(x) - {"workloads"} == {"name", "unit", "better",
                                           "source", "layer", "moves"}
        assert x["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(x["layer"])


def test_four_chip_share(m):
    four = sum(w["chips"] == 4 for w in m["workloads"])
    assert four <= max(1, len(m["workloads"]) // 4)


def test_every_cell_reports_enough(m):
    e2e = {x["name"] for x in m["end_to_end"]}
    assert "setup_s" in e2e
    for w in m["workloads"]:
        mine = {x["name"] for x in manifest.end_to_end(m, w["name"])}
        assert "setup_s" in mine and len(mine) >= 2
        assert manifest.per_layer(m, w["name"])
    cells = {w["name"] for w in m["workloads"]}
    for x in m["per_layer"]:
        assert x["moves"] in e2e
        for c in x.get("workloads", []):
            assert c in cells
            assert x["moves"] in {y["name"] for y in
                                  manifest.end_to_end(m, c)}


def test_layers_named_alike(m):
    # metrics of one layer give the same `layer`: each module named once
    by_name = {}
    for x in m["per_layer"]:
        key = x["layer"].split(" (")[0]
        by_name.setdefault(key, set()).add(x["layer"])
    assert all(len(v) == 1 for v in by_name.values()), by_name


def test_discovery_by_name(m):
    used = {w["config"] for w in m["workloads"]}
    assert used == {c["name"] for c in m["configs"]}
    files = set()
    for c in m["configs"]:
        assert c["file"].startswith("benchmark/")
        files.add(c["file"])
        cfg = manifest.config(m, c["name"])
        assert cfg["name"] == c["name"]
        assert sorted(cfg["reduced"]) == sorted(c["reduced"])
    assert len(files) == len(m["configs"])
    for w in m["workloads"]:
        assert manifest.cell(m, w["name"]) is w
        tr = manifest.traffic(w["traffic"])
        assert hasattr(manifest.driver(tr["driver"]), "run")
        assert manifest.limits(w["name"])["limits"]
    for x in m["per_layer"]:
        assert callable(manifest.reader(x["name"]))
    with pytest.raises(KeyError):
        manifest.cell(m, "no-such-cell")


def test_pairs_unique(m):
    pairs = [(w["config"], w["traffic"]) for w in m["workloads"]]
    assert len(set(pairs)) == len(pairs)


def test_per_layer_selection():
    m = {"end_to_end": [{"name": "a", "workloads": ["c1"]},
                        {"name": "b", "workloads": ["c2"]},
                        {"name": "setup_s"}],
         "per_layer": [{"name": "x", "moves": "a", "workloads": ["c1"]},
                       {"name": "y", "moves": "b"},
                       {"name": "z", "moves": "setup_s"}]}
    assert [x["name"] for x in manifest.end_to_end(m, "c1")] == [
        "a", "setup_s"]
    assert [x["name"] for x in manifest.per_layer(m, "c1")] == ["x", "z"]
    assert [x["name"] for x in manifest.per_layer(m, "c2")] == ["y", "z"]


def test_traffic_files_are_data():
    d = os.path.join(ROOT, "benchmark", "traffic")
    for f in os.listdir(d):
        if f.endswith(".json"):
            with open(os.path.join(d, f)) as fh:
                tr = json.load(fh)
            assert os.path.exists(os.path.join(d, tr["driver"] + ".py"))
