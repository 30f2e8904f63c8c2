"""The program's own spans in a training window: trainer.fit's phases
and blocks, recorded by the port's Tracer (serve/trace.py; the span
names are trainer.py's), reduced per rank and read over the ranks.

A rank's summary, `summarize(tracer.run_spans())`: the spans of its last
`fit` (the root, and every span of its thread inside it), each
{name, t0, dur, id, parent, tags} in seconds of time.monotonic(); per
name the spans' count and seconds; and the steps the blocks launched
(their `k` tags). The readers take the ranks' summaries:

- fit_outside_loop_s: the `fit` span less its `train.steady` span, the
  slowest rank's: set-up, the first block, the close;
- train_host_launch_ms: `train.block.launch` over the steady blocks
  (those begun inside `train.steady`: all but the first), over their
  steps, in ms; the mean of the ranks;
- gaps_by_span: a device slice's idle gaps, each named by the innermost
  span open on the training thread when it ended (devtrace's `label`),
  or NO_SPAN.

Nothing of the benchmark's run calls these yet: the training traffic
(traffic/train_fit.py) installs no Tracer, and run.py prints no
`idle_gaps_by_span`; wiring them in is an edit of those files.
"""

from __future__ import annotations

import bisect
from typing import Callable, Optional

from benchmark.harness import devtrace

NO_SPAN = "no span"


def summarize(spans: list) -> Optional[dict]:
    """One rank's summary of a Tracer's run spans; None without a `fit`."""
    roots = [s for s in spans if s["name"] == "fit" and s["parent"] is None]
    if not roots:
        return None
    root = max(roots, key=lambda s: s["t0"])
    end = root["t0"] + root["dur"]
    kept = [{k: s[k] for k in ("name", "t0", "dur", "id", "parent", "tags")}
            for s in spans if s["tid"] == root["tid"]
            and root["t0"] <= s["t0"] and s["t0"] + s["dur"] <= end]
    counts: dict = {}
    for s in kept:
        c = counts.setdefault(s["name"], [0, 0.0])
        c[0] += 1
        c[1] += s["dur"]
    return {"spans": kept, "counts": counts,
            "steps_launched": sum(s["tags"].get("k", 0) for s in kept
                                  if s["name"] == "train.block")}


def _one(summary: dict, name: str) -> Optional[dict]:
    found = [s for s in summary["spans"] if s["name"] == name]
    return found[-1] if found else None


def fit_outside_loop_s(ranks: list) -> Optional[float]:
    """The slowest rank's `fit` less its `train.steady`, in seconds."""
    out = []
    for r in filter(None, ranks):
        fit, steady = _one(r, "fit"), _one(r, "train.steady")
        if fit is not None and steady is not None:
            out.append(fit["dur"] - steady["dur"])
    return max(out) if out else None


def train_host_launch_ms(ranks: list) -> Optional[float]:
    """The ranks' mean of the host's launch time a steady step, in ms."""
    out = []
    for r in filter(None, ranks):
        steady = _one(r, "train.steady")
        if steady is None:
            continue
        lo, hi = steady["t0"], steady["t0"] + steady["dur"]
        blocks = {s["id"]: s["tags"].get("k", 0) for s in r["spans"]
                  if s["name"] == "train.block" and lo <= s["t0"] <= hi}
        steps = sum(blocks.values())
        if steps:
            launch = sum(s["dur"] for s in r["spans"]
                         if s["name"] == "train.block.launch"
                         and s["parent"] in blocks)
            out.append(launch / steps * 1e3)
    return sum(out) / len(out) if out else None


def label(summary: dict) -> Callable[[float], str]:
    """label(t): the innermost of the summary's spans open at monotonic
    t (the latest begun of those that cover it, the shortest of those
    begun together), or NO_SPAN. `train.steady`, a window over the
    blocks and not a phase, names nothing."""
    spans = sorted((s for s in summary["spans"]
                    if s["name"] != "train.steady"),
                   key=lambda s: (s["t0"], -s["dur"]))
    starts = [s["t0"] for s in spans]

    def at(t: float) -> str:
        for s in reversed(spans[:bisect.bisect_right(starts, t)]):
            if t <= s["t0"] + s["dur"]:
                return s["name"]
        return NO_SPAN
    return at


def tie(events: list, marks: list) -> float:
    """The time.monotonic() of the slice's first instant, where
    devtrace.summarize starts it. A trace holding the slice's marks
    starts at its first, which the first of `marks` (devtrace.Slice's)
    stamped. A trace of the device alone holds none: it ends with the
    synchronize that ends the slice, just before its last mark, and
    starts its window's length earlier."""
    x = [e for e in events if e.get("ph") == "X" and "ts" in e]
    if sum(e.get("name") == devtrace.MARK for e in x) >= 2:
        return marks[0]
    w0 = min(e["ts"] for e in x)
    w1 = max(e["ts"] + e.get("dur", 0) for e in x)
    return marks[-1] - (w1 - w0) / 1e6


def gaps_by_span(events: list, marks: list, summary: dict) -> list:
    """A slice's idle gaps ([name, seconds], largest first), each named
    by the span open on the training thread when the gap ended."""
    return devtrace.summarize(events, tie(events, marks),
                              label(summary))["idle_gaps"]
