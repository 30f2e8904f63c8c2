"""The readers of the program's spans (harness/spans.py) on planted
spans (seconds of time.monotonic()), and a synthetic device slice's idle
gaps named by them."""

import pytest

from benchmark.harness import devtrace, spans
from benchmark.tests.test_bm_devtrace import trace


def sp(sid, parent, name, t0, dur, tid="MainThread", **tags):
    return {"id": sid, "parent": parent, "name": name, "t0": t0, "dur": dur,
            "tid": tid, "rids": [], "status": "ok", "tags": tags}


def rank(t=100.0, launch=0.002, fit_extra=0.0):
    """One rank's run spans: a warm-up fit (dropped), then the window's
    fit: set-up, three blocks of 4 steps (the first outside the steady
    window), the close."""
    out = [sp(1, None, "fit", t - 50, 10.0),
           sp(2, 1, "train.block", t - 49, 1.0, step=0, k=4)]
    out += [sp(10, None, "fit", t, 2.0 + fit_extra),
            sp(11, 10, "fit.setup.model", t + 0.01, 0.1),
            sp(12, 10, "train.loop", t + 0.2, 1.5)]
    for i in range(3):
        b = 20 + 3 * i
        t0 = t + 0.2 + 0.5 * i
        out += [sp(b + 1, b, "train.block.wait", t0, 0.1),
                sp(b + 2, b, "train.block.launch", t0 + 0.1, launch),
                sp(b, 12, "train.block", t0, 0.4, step=4 * i, k=4)]
    out += [sp(40, 12, "train.steady", t + 0.65, 1.0),
            sp(41, 10, "fit.close.commit", t + 1.8, 0.1),
            sp(42, None, "serve", t + 0.3, 0.1, tid="other")]
    return sorted(out, key=lambda s: s["t0"] + s["dur"])


def test_summary_keeps_the_last_fit_on_its_thread():
    s = spans.summarize(rank())
    assert min(x["t0"] for x in s["spans"]) == 100.0
    assert "serve" not in s["counts"]
    assert s["counts"]["train.block"] == [3, pytest.approx(1.2)]
    assert s["steps_launched"] == 12
    assert spans.summarize([sp(1, None, "train.loop", 0.0, 1.0)]) is None


def test_readers_of_one_rank():
    s = spans.summarize(rank())
    assert spans.fit_outside_loop_s([s]) == pytest.approx(1.0)
    # two steady blocks of 4 steps, 2 ms of launch each
    assert spans.train_host_launch_ms([s]) == pytest.approx(0.5)


def test_readers_of_four_ranks():
    ranks = [spans.summarize(rank(t=100.0 + r, launch=0.002 * (r + 1),
                                  fit_extra=0.1 * r)) for r in range(4)]
    # the slowest rank's outside time; the ranks' mean launch a step
    assert spans.fit_outside_loop_s(ranks) == pytest.approx(1.3)
    assert spans.train_host_launch_ms(ranks) == pytest.approx(1.25)
    assert spans.fit_outside_loop_s([None, ranks[0]]) == pytest.approx(1.0)
    assert spans.fit_outside_loop_s([None]) is None
    assert spans.train_host_launch_ms([]) is None


def test_label_names_the_innermost_open_span():
    at = spans.label(spans.summarize(rank()))
    assert at(100.05) == "fit.setup.model"
    assert at(100.25) == "train.block.wait"
    assert at(100.301) == "train.block.launch"
    assert at(100.85) == "train.block"
    # between blocks, inside train.steady, which names nothing
    assert at(100.65) == at(101.65) == "train.loop"
    assert at(100.19) == "fit"
    assert at(99.0) == spans.NO_SPAN


def test_gaps_named_by_span_sum_to_the_slice_idle_time():
    # the slice's first mark at monotonic 100.0; the trace's us 0-120
    summary = {"spans": [sp(1, None, "fit", 99.0, 1.0),
                         sp(2, 1, "train.block.launch", 100.0, 20e-6),
                         sp(3, 1, "train.block.wait", 100.00005, 15e-6)]}
    named = dict(spans.gaps_by_span(trace(), [100.0, 100.00012], summary))
    s = devtrace.summarize(trace())
    assert sum(named.values()) == pytest.approx(s["window_s"] - s["busy_s"])
    # gaps end at 12 us (in the launch), 62 us (the wait), 120 us (end)
    assert named == {"train.block.launch": pytest.approx(12e-6),
                     "train.block.wait": pytest.approx(20e-6),
                     "slice end": pytest.approx(10e-6)}


def test_a_device_only_slice_is_tied_at_its_end():
    """With no mark in the trace, the slice ends at its last event,
    stamped just before the last mark."""
    events = [e for e in trace() if e["name"] != devtrace.MARK]
    # events span 5-116 us; the last mark at monotonic 200.0
    assert spans.tie(events, [199.0, 200.0]) == pytest.approx(200.0 - 111e-6)
    assert spans.tie(trace(), [199.0, 200.0]) == 199.0
    summary = {"spans": [sp(1, None, "fit", 150.0, 100.0)]}
    named = dict(spans.gaps_by_span(events, [199.0, 200.0], summary))
    s = devtrace.summarize(events)
    assert sum(named.values()) == pytest.approx(s["window_s"] - s["busy_s"])
    assert set(named) == {"fit", "slice end"}
