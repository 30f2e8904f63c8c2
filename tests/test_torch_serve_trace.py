"""The port's request tracing and its metrics surface (the snapshot's
blocks, the Prometheus exposition) against the JAX package's, on the CPU.

Held exactly against JAX on the same inputs: attribute_stages over
seeded span dicts, the head-sampling verdicts per (seed, rid), and a
whole tracer fed the same requests and spans on the same clock stamps
(its retained traces, Chrome export, Server-Timing values and snapshot);
the ServeMetrics snapshot's key sets (the deferred layers' keys aside)
and the Prometheus exposition's `# HELP`/`# TYPE` pairs and sample names
on the same recorded history. Then the tracer's own contracts through
the port's batcher: inertness, bounded rings, exemplars surviving zero
sampling, sheds and bisection as structured spans, and a fast-lane
request attributed to >= 0.95 of its wall clock.
"""

import re
import threading
import time

import numpy as np
import pytest

from distributedmnist_tpu.serve import metrics as jmetrics
from distributedmnist_tpu.serve import trace as jtrace
from distributedmnist_tpu_torch.serve import faults as tfaults
from distributedmnist_tpu_torch.serve import metrics as tmetrics
from distributedmnist_tpu_torch.serve import trace as ttrace
from distributedmnist_tpu_torch.serve import (DeadlineExceeded,
                                              DynamicBatcher, Rejected,
                                              ResiliencePolicy)
from tests.test_serve_batcher import StubEngine
from torch_sanitize_util import torch_serve_sanitizer  # noqa: F401

# the JAX snapshot's blocks of layers the port has not got yet: none
# (the autoscaler's block and families landed with the autoscaler)
DEFERRED_KEYS = set()
# their Prometheus families (prefixes)
DEFERRED_FAMILIES = ()


@pytest.fixture(autouse=True)
def _clean():
    for mod in (ttrace, jtrace, tfaults):
        mod.uninstall()
    yield
    for mod in (ttrace, jtrace, tfaults):
        mod.uninstall()


def _rows(rng, n):
    return rng.integers(0, 256, (n, 28, 28, 1)).astype(np.uint8)


# -- equality with the JAX tracer -------------------------------------------


def _random_trace(r) -> dict:
    names = sorted(jtrace.STAGE_OF) + ["batch.coalesce", "batch.plan"]
    t0 = float(r.random())
    dur = 1e-3 + float(r.random()) * 5e-3
    spans = [{"name": "request", "t0": t0, "dur": dur}]
    for _ in range(int(r.integers(0, 12))):
        a = t0 + float(r.uniform(-1e-3, dur))
        spans.append({"name": names[int(r.integers(0, len(names)))],
                      "t0": a, "dur": float(r.uniform(0, dur))})
    return {"spans": spans}


def test_stage_table_equals_jax():
    assert ttrace.STAGE_OF == jtrace.STAGE_OF
    assert ttrace.STAGE_BUCKETS_MS == jtrace.STAGE_BUCKETS_MS


def test_attribute_stages_equals_jax():
    r = np.random.default_rng(0)
    for _ in range(300):
        t = _random_trace(r)
        assert ttrace.attribute_stages(t) == jtrace.attribute_stages(t)


@pytest.mark.parametrize("sample,seed", [(0.3, 0), (0.5, 17), (0.01, 23),
                                         (0.0, 1), (1.0, 2)])
def test_sampling_verdicts_equal_jax(sample, seed):
    ours = ttrace.Tracer(sample=sample, seed=seed)
    ref = jtrace.Tracer(sample=sample, seed=seed)
    verdicts = [ours._sampled(rid) for rid in range(2000)]
    assert verdicts == [ref._sampled(rid) for rid in range(2000)]


def _drive(mod, slo_ms=2.0, sample=0.5, run_spans=False):
    """The same requests and spans, on fixed clock stamps, through one
    package's tracer: OK, errored and over-SLO requests, a shared batch
    span, a shed, and with `run_spans` a span with no request id before
    each request; returns everything the tracer exports."""
    tr = mod.Tracer(capacity=8, sample=sample, slo_ms=slo_ms, seed=5)
    for rid in range(1, 13):
        t0 = 10.0 + rid
        if run_spans:
            tr.add_span("train.block", t0 - 0.5, t0 - 0.1, k=rid)
        tr.start_request(rid, rows=rid % 3 + 1, t0=t0)
        tr.add_span("queue.wait", t0, t0 + 2e-4, rids=(rid,))
        tr.add_span("engine.staging", t0 + 2e-4, t0 + 4e-4, rids=(rid,),
                    tid="serve-dispatch", bucket=4)
        tr.add_span("engine.fetch", t0 + 4e-4, t0 + 1e-3 * (rid % 4 + 1),
                    rids=(rid, rid + 100), tid="serve-complete")
        err = RuntimeError("boom") if rid % 5 == 0 else None
        tr.finish_request(rid, error=err, t_end=t0 + 1e-3 * (rid % 4 + 1))
    tr.start_request(99, t0=50.0)
    tr.abort_request(99)
    traces = tr.traces()
    ids = [t["trace_id"] for t in traces]
    return (traces, tr.export_chrome(pid=3),
            [tr.server_timing(i) for i in ids], [tr.breakdown(i) for i in ids],
            tr.snapshot(), tr.stage_p99_ms("engine.fetch"))


def test_tracer_exports_equal_jax_on_one_clock():
    ours = _drive(ttrace)
    assert ours == _drive(jtrace)
    traces, chrome, timings, _, snap, _ = ours
    assert snap["kept_exemplars"] >= 2 and snap["aborted"] == 1
    assert chrome["displayTimeUnit"] == "ms"
    assert {e["ph"] for e in chrome["traceEvents"]} == {"M", "X"}
    assert all(re.fullmatch(r"([a-z.]+;dur=\d+\.\d{3})(, [a-z.]+;dur="
                            r"\d+\.\d{3})*", t) for t in timings)


def test_run_spans_leave_the_request_exports_as_jax_reads_them():
    """Spans with no request id between the requests change nothing the
    request path exports: the same as JAX's tracer fed the same."""
    ours = _drive(ttrace, run_spans=True)
    assert ours == _drive(jtrace, run_spans=True)
    assert ours[4]["stages"]["train.block"]["count"] == 12


def test_run_spans_are_kept_in_their_own_ring(monkeypatch):
    monkeypatch.setattr(ttrace, "RUN_CAPACITY", 3)
    tr = ttrace.Tracer()
    for i in range(5):
        tr.add_span("train.block", float(i), i + 0.5, k=i)
    tr.add_span("engine.fetch", 9.0, 9.5, rids=(1,))
    sp = tr.begin_span("fit", rank=0)
    tr.end_span(sp, steps=4)
    run = tr.run_spans()
    assert [s["name"] for s in run] == ["train.block"] * 2 + ["fit"]
    assert [s["tags"] for s in run] == [{"k": 3}, {"k": 4},
                                        {"rank": 0, "steps": 4}]
    assert all(s["rids"] == [] and s["parent"] is None for s in run)
    snap = tr.snapshot()
    assert snap["stages"]["train.block"]["count"] == 5
    assert set(snap) == set(jtrace.Tracer().snapshot())
    assert tr.traces() == [] and snap["open_spans"] == 0


def test_run_spans_export_onto_another_clock():
    tr = ttrace.Tracer()
    tr.add_span("fit", 1.0, 3.0)
    root = tr.run_spans()[0]
    tr.add_span("train.loop", 1.5, 2.5, tid="trainer", step=0)
    tr.add_span("engine.fetch", 1.6, 1.7, rids=(3,))
    out = tr.export_run_chrome(pid=2, process_name="train",
                               since=root["id"] + 1, shift_us=-1e6)
    x = [e for e in out["traceEvents"] if e["ph"] == "X"]
    assert [(e["name"], e["ts"], e["dur"], e["pid"], e["cat"]) for e in x] == [
        ("train.loop", 5e5, 1e6, 2, "train")]
    assert x[0]["args"] == {"id": root["id"] + 1, "status": "ok",
                            "parent": None, "step": 0}
    names = {e["args"]["name"] for e in out["traceEvents"] if e["ph"] == "M"}
    assert names == {"train", "trainer"}


def test_tracer_rejects_degenerate_configs_like_jax():
    for kw in ({"capacity": 0}, {"sample": 1.5}, {"sample": -0.1},
               {"slo_ms": 0}):
        with pytest.raises(ValueError) as ref:
            jtrace.Tracer(**kw)
        with pytest.raises(ValueError) as ours:
            ttrace.Tracer(**kw)
        assert str(ours.value) == str(ref.value)


# -- the metrics surface against JAX ------------------------------------------


def _record_history(m):
    m.record_latency(0.002, rows=2, version="v1")
    m.record_latency(0.004, rows=1, version="v2")
    m.record_dispatch(0.0005, inflight=2)
    m.record_fetch(0.001)
    m.record_batch(rows=3, bucket=4, queue_depth=1, version="v1",
                   infer_dtype="float32")
    m.record_wait(0.001)
    m.record_reject(2)
    m.record_shadow("v1", "v2", rows=3, agree_rows=3, max_abs_diff=0.01)
    m.record_shadow_error()
    m.record_deadline_shed(1)
    m.record_bisect_split()
    m.record_poison_isolated(2)
    m.record_bisect_rescued(3, 5)
    m.record_dispatch_error(1)
    m.record_fetch_error(2)
    m.record_breaker_trip("v1")
    m.record_rollback("v1", "v2")
    m.record_cache_hit(0.0001, rows=2, version="v2", infer_dtype="float32")
    m.record_cache_hit(0.0002, rows=1, version="v2", infer_dtype="int8",
                       collapsed=True)
    m.record_dedup(2, 3)
    m.record_fastpath(1)
    # the tenancy layer's hooks
    m.record_tenant_request("gold", "mlp", 2)
    m.record_tenant_request("free", "lenet", 1)
    m.record_tenant_shed("free", "quota", 1)
    m.record_tenant_shed("gold", "deadline", 3)
    m.record_tenant_dispatch("gold", "mlp", 2)
    m.record_tenant_dispatch("free", "lenet", 1)
    m.record_tenant_cache_hit("free", 1)
    m.record_tenant_done("gold", 0.003, True)
    m.record_tenant_done("gold", 0.009, False)
    m.record_tenant_done("free", 0.001, None)


def test_snapshot_keys_equal_jax_but_the_deferred_layers():
    ours, ref = tmetrics.ServeMetrics(), jmetrics.ServeMetrics()
    for m in (ours, ref):
        _record_history(m)
    so, sr = ours.snapshot(), ref.snapshot()
    assert set(so) == set(sr) - DEFERRED_KEYS
    for block in ("resilience", "cache_served", "dedup", "fastpath"):
        assert so[block].keys() == sr[block].keys(), block
        for k, v in so[block].items():
            if k != "last_rollback":
                assert v == sr[block][k], (block, k)
    assert so["by_dtype"] == sr["by_dtype"]
    assert so["by_version"] == sr["by_version"]
    assert so["by_tenant"] == sr["by_tenant"]
    assert so["by_model"] == sr["by_model"]
    assert so["by_tenant"]["gold"]["slo_attainment"] == 0.5
    assert so["requests"] == sr["requests"] == 4
    assert so["fastpath"]["lane_fraction"] == 0.25


def _families(text: str) -> tuple:
    helps = dict(re.findall(r"^# HELP (\S+) (.*)$", text, re.M))
    types = dict(re.findall(r"^# TYPE (\S+) (\S+)$", text, re.M))
    samples = {re.match(r"[^{ ]+", ln).group(0)
               for ln in text.splitlines() if ln and ln[0] != "#"}
    return helps, types, samples


def test_prometheus_exposition_equals_jax_for_shared_families():
    ours, ref = tmetrics.ServeMetrics(), jmetrics.ServeMetrics()
    for m in (ours, ref):
        _record_history(m)
    tr = jtrace.Tracer()
    tr.start_request(1, t0=1.0)
    tr.add_span("engine.fetch", 1.0, 1.002, rids=(1,))
    tr.finish_request(1, t_end=1.003)
    stages = tr.snapshot()["stages"]
    cache = {"hits": 3, "hit_rows": 4, "misses": 2, "collapsed": 1,
             "inserts": 2, "evictions": 0, "invalidations": 1,
             "stale_drops": 0, "expired": 1, "entries": 2,
             "inflight_keys": 0, "hit_ratio": 0.6}
    gauges = {"pending_rows": 3, "inflight_batches": 1}
    t_text = tmetrics.prometheus_exposition(
        ours.snapshot(), trace_stages=stages, gauges=gauges, cache=cache)
    j_text = jmetrics.prometheus_exposition(
        ref.snapshot(), trace_stages=stages, gauges=gauges, cache=cache)
    th, tt, ts = _families(t_text)
    jh, jt, js = _families(j_text)
    shared = {f for f in jh if not f.startswith(DEFERRED_FAMILIES)}
    assert set(th) == shared and th == {f: jh[f] for f in shared}
    assert tt == {f: jt[f] for f in shared}
    assert ts == {s for s in js if not s.startswith(DEFERRED_FAMILIES)}
    # every family carries HELP and TYPE, empty windows emit nothing
    assert set(th) == set(tt)
    empty = tmetrics.prometheus_exposition(tmetrics.ServeMetrics().snapshot())
    assert "dmnist_serve_latency_ms" not in empty
    assert 'quantile="0.99"' in t_text and 'le="+Inf"' in t_text


def test_prometheus_label_escaping_equals_jax():
    for mod in (tmetrics, jmetrics):
        assert mod._prom_line("x", {"v": 'a"b\\c\nd'}, 1) == \
            'x{v="a\\"b\\\\c\\nd"} 1'


# -- the tracer through the port's batcher ----------------------------------


def test_uninstalled_hooks_are_inert(rng):
    assert ttrace.begin_span("x") is None
    ttrace.end_span(None)
    ttrace.add_span("x", 0.0, 1.0)
    assert ttrace.current() is None
    b = DynamicBatcher(StubEngine(max_batch=8)).start()
    try:
        f = b.submit(_rows(rng, 2))
        assert f.result(timeout=10).shape == (2, 10)
        assert getattr(f, "trace_id", None) is None
    finally:
        b.stop()


def test_install_refuses_stacking_and_end_survives_uninstall():
    tr = ttrace.install(ttrace.Tracer())
    with pytest.raises(RuntimeError, match="already installed"):
        ttrace.install(ttrace.Tracer())
    sp = ttrace.begin_span("engine.staging")
    ttrace.uninstall()
    ttrace.end_span(sp)                 # the span remembers its tracer
    assert tr.snapshot()["open_spans"] == 0
    assert tr.snapshot()["stages"]["engine.staging"]["count"] == 1


def test_span_tree_is_well_formed_and_finished_before_results(rng):
    tr = ttrace.install(ttrace.Tracer(capacity=64))
    b = DynamicBatcher(StubEngine(max_batch=16), max_wait_us=2000).start()
    try:
        futs = [b.submit(_rows(rng, 1 + i % 3)) for i in range(6)]
        for f in futs:
            f.result(timeout=10)
            # finished before the future resolved: the breakdown is there
            assert tr.breakdown(f.trace_id) is not None
            assert tr.server_timing(f.trace_id)
    finally:
        b.stop()
    traces = tr.traces()
    assert len(traces) == 6
    for t in traces:
        names = {s["name"] for s in t["spans"]}
        assert {"request", "queue.wait", "batch.dispatch", "engine.fetch",
                "batch.fanout"} <= names
        root = t["spans"][0]
        assert root["name"] == "request" and root["parent"] is None
        for s in t["spans"][1:]:
            assert s["t0"] >= root["t0"] - 1e-9
    assert tr.snapshot()["open_spans"] == 0


def test_ring_bounded_and_exemplars_survive_zero_sampling(rng):
    """sample=0 keeps nothing sampled, yet errored requests stay; the
    rings are bounded."""
    tr = ttrace.install(ttrace.Tracer(capacity=4, sample=0.0,
                                      exemplar_capacity=3))

    class Flaky(StubEngine):
        def fetch(self, handle):
            if handle.x.flat[0] == 7:
                raise RuntimeError("flaky fetch")
            return super().fetch(handle)

    b = DynamicBatcher(Flaky(max_batch=8), max_wait_us=0).start()
    try:
        for i in range(10):
            x = _rows(rng, 1)
            x.flat[0] = 7 if i % 2 else 8
            f = b.submit(x)
            try:
                f.result(timeout=10)
            except RuntimeError:
                pass
    finally:
        b.stop()
    snap = tr.snapshot()
    assert snap["kept_sampled"] == 0 and snap["sampled_out"] == 5
    assert snap["kept_exemplars"] == 5
    assert snap["exemplar_traces"] == 3          # bounded
    assert all(t["status"] == "error" for t in tr.traces())


def test_rejected_submit_and_shed_traces(rng):
    tr = ttrace.install(ttrace.Tracer())
    b = DynamicBatcher(StubEngine(max_batch=8), queue_depth=1,
                       max_wait_us=50_000).start()
    gate = threading.Event()
    b.engine.gate = gate
    try:
        first = b.submit(_rows(rng, 1))
        assert b.engine.in_call.wait(10)
        queued = b.submit(_rows(rng, 1), deadline_s=time.monotonic() + 0.01)
        with pytest.raises(Rejected):
            b.submit(_rows(rng, 1))
        time.sleep(0.05)                 # the queued deadline passes
        gate.set()
        first.result(timeout=10)
        with pytest.raises(DeadlineExceeded):
            queued.result(timeout=10)
    finally:
        b.stop()
    snap = tr.snapshot()
    assert snap["aborted"] == 1 and snap["live"] == 0
    shed = [t for t in tr.traces() if t["status"] == "error"]
    assert len(shed) == 1
    names = [s["name"] for s in shed[0]["spans"]]
    assert "deadline.shed" in names
    assert any(s.get("tags", {}).get("shed") for s in shed[0]["spans"])


def test_bisection_splits_are_structured_spans(rng):
    tr = ttrace.install(ttrace.Tracer(capacity=256))
    gate = threading.Event()
    eng = StubEngine(max_batch=16, gate=gate)
    b = DynamicBatcher(eng, max_wait_us=50_000, max_inflight=4,
                       resilience=ResiliencePolicy(bisect=True)).start()
    try:
        first = b.submit(_rows(rng, 1))
        assert eng.in_call.wait(10)
        tfaults.install(tfaults.FaultInjector.from_spec(
            "batch.dispatch:mode=request,p=0.3", seed=4))
        futs = [b.submit(_rows(rng, 1)) for _ in range(8)]
        gate.set()
        first.result(timeout=10)
        for f in futs:
            try:
                f.result(timeout=10)
            except tfaults.InjectedFault:
                pass
    finally:
        b.stop()
    census = {}
    for t in tr.traces():
        for s in t["spans"]:
            census[s["name"]] = census.get(s["name"], 0) + 1
    assert census.get("bisect.split", 0) >= 1
    assert census.get("bisect.dispatch", 0) >= 2
    failed = [t for t in tr.traces() if t["status"] == "error"]
    assert len(failed) == len(tfaults.active().poisoned()) > 0


def test_fastlane_request_is_attributed_to_its_stages(rng):
    """The lane's spans (fastpath.admit, fastpath, staging, fetch) cover
    a lane request's wall clock: >= 0.95 attributed, as the root bench's
    lowlat bar asks; on the CPU here, with the port's real engine."""
    from distributedmnist_tpu_torch.serve import EngineFactory, ModelRegistry

    tf = EngineFactory("mlp", device="cpu", max_batch=8)
    router = tf.make_router()
    reg = ModelRegistry(tf, router)
    reg.add(tf.init_params(0), version="v1")
    reg.promote("v1")
    tr = ttrace.install(ttrace.Tracer(capacity=64, slo_ms=1e-3))
    b = DynamicBatcher(router, fastlane=True, max_inflight=1).start()
    try:
        for _ in range(16):
            b.submit(_rows(rng, 1)).result(timeout=10)
    finally:
        b.stop()
    fracs = [ttrace.attribute_stages(t)["attributed_frac"]
             for t in tr.traces()]
    assert len(fracs) == 16 and min(fracs) >= 0.95
    names = {s["name"] for t in tr.traces() for s in t["spans"]}
    assert {"fastpath", "fastpath.admit", "engine.staging",
            "engine.fetch"} <= names
