"""Request tracing (the port of the JAX package's serve/trace.py, same
names, span names and retention rules): request-scoped span trees, stage
attribution, and the per-stage duration histograms behind /metrics.

- A **trace** is one request's span tree: a root `request` span plus
  every pipeline stage the request crossed. Batch-level spans carry the
  request ids of every cohort member and appear in each member's tree.
- **Spans** are recorded by hooks woven through the batcher, engine,
  router, cache and resilience paths. With no tracer installed each hook
  is one module-global None check.
- **Retention** is deterministic head sampling (sha256 of
  f"{seed}:trace:{rid}", the JAX package's draw) plus an exemplar ring
  that always keeps errored and over-SLO requests. Both rings are
  bounded deques.
- Every completed span feeds a **per-stage duration histogram** (fixed
  log-spaced ms buckets), flattened into the Prometheus exposition.

A span recorded with no request id (a training run's: trainer.fit's
phases and blocks) belongs to no trace; it is kept in a bounded run ring
of its own, read by `run_spans()` and `export_run_chrome()`, beside the
per-stage histogram every span feeds.

Span discipline: every `begin_span` is closed by `end_span` in a
`finally`. Spans whose ends live on different threads (queue wait, the
dispatched-but-unfetched window) are recorded as closed intervals with
`add_span` from monotonic stamps both sides already hold.

Span name table (stage -> what it times):

    request                 submit to future resolution (the root)
    queue.wait              submit to pop (`shed=True` when the deadline
                            expired queued)
    batch.coalesce          one drain's coalesce window
    batch.plan              the cost-model batch former
    batch.pending           pop to this segment's dispatch begin
    batch.dispatch          the batcher's dispatch site incl. the
                            failpoint
    engine.staging          pad + host->device copy + launch
    engine.enqueued         the dispatched-but-unfetched window
    engine.fetch            the blocking wait for the logits
    batch.fanout            fetch-done to this request's resolution
    router.shadow           the shadow duplicate dispatch
    bisect.split            a failed cohort split in two
    bisect.dispatch         one bisection sub-dispatch
    deadline.shed           shed-before-dispatch marker
    cache.lookup            the prediction cache's content-hash lookup
                            (collapsed=True when the miss joined an
                            in-flight leader)
    cache.hit               served from the cache: no pipeline work
    cache.collapse          a single-flight follower's wait on its
                            leader
    batch.dedup             intra-batch dedup riders (zero-width marker)
    fastpath                the fast lane's inline dispatch+fetch on the
                            caller's thread (staging/fetch nest inside)
    fastpath.admit          submit to lane dispatch begin

STAGE_OF also names the stages of layers the port has not got yet (the
fleet's rescues and hedges, the cascade, the gateway), so traces
attribute the same way in both packages once those land.
"""

from __future__ import annotations

import hashlib
import itertools
import sys
import threading
import time
from collections import OrderedDict, deque
from typing import Optional

from distributedmnist_tpu_torch.analysis.locks import make_lock

# Per-stage histogram bucket upper bounds, milliseconds (log-spaced;
# the final implicit bucket is +Inf). Shared with the Prometheus
# exposition, which emits them cumulatively per the histogram contract.
STAGE_BUCKETS_MS = (0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0,
                    100.0, 250.0, 1000.0)

# The run ring's bound: trainer.fit records three spans a block and
# about fifteen more, so a run of up to 1,360 blocks keeps all of its
# spans; a longer one keeps its last blocks and its close, root last.
RUN_CAPACITY = 4096

# Span name -> (attribution stage, claim priority). Higher priority
# claims wall-clock first, so a rescue nested inside an engine.fetch
# span is blamed on the rescue, not double-counted as fetch. Names
# absent here (the request root, batch.coalesce/batch.plan — pure
# context, they overlap queue.wait) never claim time.
STAGE_OF = {
    "queue.wait": ("queue", 20),
    "batch.pending": ("pending", 12),
    "engine.staging": ("staging", 40),
    "batch.dispatch": ("staging", 10),
    "engine.enqueued": ("device", 40),
    "engine.fetch": ("fetch", 30),
    "batch.fanout": ("fanout", 15),
    "router.shadow": ("shadow", 50),
    "bisect.dispatch": ("bisect", 60),
    "deadline.shed": ("shed", 60),
    "fleet.failover.dispatch": ("rescue", 80),
    "fleet.failover.fetch": ("rescue", 80),
    "fleet.hedge": ("hedge", 70),
    "fleet.hedge.primary": ("hedge", 75),
    "fleet.hedge.duplicate": ("hedge", 75),
    # prediction-cache front layer: a hit's whole budget is
    # the lookup; a collapsed follower's is the wait on its leader
    "cache.lookup": ("cache", 90),
    "cache.hit": ("cache", 90),
    "cache.collapse": ("cache", 85),
    # single-request bypass lane: `fastpath` wraps the whole
    # inline dispatch+fetch at LOW priority so the nested staging/fetch
    # stages claim their own microseconds and the lane keeps only the
    # bookkeeping remainder; `fastpath.admit` closes the submit-to-
    # dispatch gap so attribution of a lane request has no residue
    "fastpath": ("fastpath", 8),
    "fastpath.admit": ("fastpath", 18),
    # confidence-gated cascade: stage spans wrap the inner
    # pipeline's spans at LOW priority (the nested queue/staging/fetch
    # stages claim their own time; the cascade keeps the margin math +
    # callback bookkeeping remainder); the escalate marker is
    # zero-width, priority only for deterministic attribution order
    "cascade.stage": ("cascade", 5),
    "cascade.escalate": ("cascade", 6),
    # gateway process: route = ring/least-loaded pick +
    # admission (backpressure/pause waits land here); dispatch = the
    # worker round trip, tagged with the worker's own X-Trace-Id so
    # the two processes' traces name each other; failover = the one
    # rescue redispatch after a mid-request worker death, high
    # priority like the fleet's rescues
    "gateway.route": ("route", 30),
    "gateway.dispatch": ("upstream", 20),
    "gateway.failover": ("rescue", 80),
}


class Span:
    """One open span: identity, interval start, parent link, tags.
    Recorded into the tracer (and its stage histogram) only at end —
    an abandoned Span object is garbage-collected, never exported, and
    counted by the open-span gauge until ended."""

    __slots__ = ("tracer", "id", "parent", "name", "t0", "tid",
                 "tags", "rids", "ended", "exc0")

    def __init__(self, tracer, sid, parent, name, t0, tid, tags, rids,
                 exc0=None):
        self.tracer = tracer
        self.id = sid
        self.parent = parent
        self.name = name
        self.t0 = t0
        self.tid = tid
        self.tags = tags
        self.rids = rids
        self.ended = False
        # The AMBIENT exception at begin time: failure-handling code
        # (bisection, failover rescues) begins spans INSIDE an except
        # handler, where sys.exc_info() reports the exception being
        # handled — only a NEW exception at end time marks this span
        # errored, not the enclosing failure it exists to repair.
        self.exc0 = exc0


def _interval_merge(iv):
    """Sorted, merged [lo, hi) interval list."""
    out = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def _interval_subtract(iv, taken):
    """`iv` minus `taken` (both merged-sorted)."""
    out = []
    for a, b in iv:
        cur = a
        for ta, tb in taken:
            if tb <= cur:
                continue
            if ta >= b:
                break
            if ta > cur:
                out.append((cur, min(ta, b)))
            cur = max(cur, tb)
            if cur >= b:
                break
        if cur < b:
            out.append((cur, b))
    return out


def _interval_total(iv):
    return sum(b - a for a, b in iv)


def attribute_stages(trace: dict) -> dict:
    """Blame a finished trace's wall clock on named stages.

    Each moment of the request's [start, end) interval is assigned to
    the highest-priority stage whose span covers it (STAGE_OF), so
    nested spans (a rescue inside a fetch, staging inside a dispatch)
    never double-count. What no stage claims is the RESIDUE — reported,
    never hidden: the bench's trace leg holds the residue of every
    over-SLO request under 5% (the acceptance bar), and a growing
    residue means a new pipeline stage is missing its span."""
    root = next(s for s in trace["spans"] if s["name"] == "request")
    t_lo = root["t0"]
    t_hi = root["t0"] + root["dur"]
    total = max(t_hi - t_lo, 1e-12)
    by_stage: dict[str, list] = {}
    prio: dict[str, int] = {}
    for s in trace["spans"]:
        entry = STAGE_OF.get(s["name"])
        if entry is None:
            continue
        stage, p = entry
        a = max(s["t0"], t_lo)
        b = min(s["t0"] + s["dur"], t_hi)
        if b > a:
            by_stage.setdefault(stage, []).append((a, b))
        prio[stage] = max(prio.get(stage, 0), p)
    assigned: list = []
    stages_ms = {}
    for stage in sorted(by_stage, key=lambda st: -prio[st]):
        free = _interval_subtract(_interval_merge(by_stage[stage]),
                                  assigned)
        stages_ms[stage] = _interval_total(free) * 1e3
        assigned = _interval_merge(assigned + free)
    covered = _interval_total(assigned)
    return {
        "total_ms": total * 1e3,
        "stages_ms": stages_ms,
        "residue_ms": max(total - covered, 0.0) * 1e3,
        "attributed_frac": min(covered / total, 1.0),
    }


def _chrome(spans, pid: int, process_name: str, cat: str, ids,
            shift_us: float = 0.0) -> dict:
    """Chrome trace-event JSON of span dicts: one 'X' event a span at
    monotonic microseconds + `shift_us`, its args `ids(span)`, status,
    parent and tags; thread-name metadata a thread, numbered in
    first-encounter order."""
    events = [{"ph": "M", "pid": pid, "tid": 0, "name": "process_name",
               "args": {"name": process_name}}]
    tids: dict[str, int] = {}

    def tid_of(label: str) -> int:
        t = tids.get(label)
        if t is None:
            t = tids[label] = len(tids) + 1
            events.append({"ph": "M", "pid": pid, "tid": t,
                           "name": "thread_name", "args": {"name": label}})
        return t

    for s in spans:
        events.append({
            "name": s["name"],
            "cat": cat,
            "ph": "X",
            "ts": round(s["t0"] * 1e6 + shift_us, 1),
            "dur": round(s["dur"] * 1e6, 1),
            "pid": pid,
            "tid": tid_of(s["tid"]),
            "args": {**ids(s), "status": s["status"],
                     "parent": s["parent"], **s["tags"]},
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


class Tracer:
    """Request-scoped span collection with bounded retention.

    start_request/finish_request bracket each admitted request; spans
    are recorded via begin_span/end_span (same-thread stages) or
    add_span (already-measured intervals). Retention: errored and
    over-SLO traces always land in the exemplar ring; the rest pass a
    deterministic head-sampling draw into the main ring. Both rings are
    bounded deques. Thread-safe; the single internal lock is never held
    while calling out."""

    def __init__(self, capacity: int = 256, sample: float = 1.0,
                 slo_ms: Optional[float] = None, seed: int = 0,
                 exemplar_capacity: Optional[int] = None,
                 live_cap: int = 8192):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        if not 0.0 <= sample <= 1.0:
            raise ValueError(f"sample must be in [0, 1], got {sample}")
        if slo_ms is not None and slo_ms <= 0:
            raise ValueError(f"slo_ms must be > 0, got {slo_ms}")
        self.capacity = capacity
        self.sample = sample
        self.slo_ms = slo_ms
        self.seed = seed
        self._lock = make_lock("trace.tracer")
        self._tls = threading.local()
        self._ids = itertools.count(1)
        self._ring: deque = deque(maxlen=capacity)
        self._exemplars: deque = deque(
            maxlen=exemplar_capacity if exemplar_capacity is not None
            else max(capacity // 2, 16))
        self._live: "OrderedDict[int, dict]" = OrderedDict()
        self._live_cap = live_cap
        # spans with no request id, oldest first (a training run's)
        self._run: deque = deque(maxlen=RUN_CAPACITY)
        self._recent: "OrderedDict[str, dict]" = OrderedDict()
        self._recent_cap = 512
        self._stages: dict[str, list] = {}   # name -> [count, sum_ms,
        #                                      per-bucket counts + inf]
        self._open = 0
        self._started = 0
        self._finished = 0
        self._kept_sampled = 0
        self._kept_exemplar = 0
        self._sampled_out = 0
        self._aborted = 0
        self._dropped_live = 0

    # -- per-thread span stack (parent inference) -------------------------

    def _stack(self) -> list:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def current(self) -> Optional[tuple]:
        """(span_id, rids) of the innermost open span on THIS thread —
        the explicit parent ref for spans begun on a spawned thread
        (the fleet's hedge arms)."""
        st = self._stack()
        if not st:
            return None
        top = st[-1]
        return (top.id, top.rids)

    # -- request lifecycle -------------------------------------------------

    def start_request(self, rid: int, rows: int = 1,
                      deadline_s: Optional[float] = None,
                      t0: Optional[float] = None) -> str:
        """Open a trace for an ADMITTED request; returns its trace id
        (the X-Trace-Id header value). Called by the batcher BEFORE the
        queue insert, so pop-side spans always find the live trace.
        `t0` is the request's enqueue stamp — the root span starts
        exactly where the queue.wait child does, so no child can ever
        precede its root."""
        trace_id = f"{rid:08x}"
        with self._lock:
            self._started += 1
            if len(self._live) >= self._live_cap:
                # A request whose future never resolves must not grow
                # the live table without bound: drop the oldest open
                # trace (counted — silence would read as coverage).
                self._live.popitem(last=False)
                self._dropped_live += 1
            self._live[rid] = {
                "trace_id": trace_id,
                "rid": rid,
                "t0": t0 if t0 is not None else time.monotonic(),
                "rows": rows,
                "deadline": deadline_s,
                "spans": [],
            }
        return trace_id

    def abort_request(self, rid: int) -> None:
        """The submit was refused AFTER start_request (queue watermark,
        stopped batcher): the request never entered the pipeline, so it
        has no trace to keep."""
        with self._lock:
            if self._live.pop(rid, None) is not None:
                self._aborted += 1

    def finish_request(self, rid: int, error=None,
                       t_end: Optional[float] = None) -> None:
        """Close the trace: synthesize the root `request` span, decide
        retention (exemplar for errored/over-SLO, else the sampling
        draw), and make the stage breakdown available for Server-Timing
        lookups. Callers finish BEFORE resolving the request's future,
        so a client that has seen its result can immediately read the
        finished trace. `t_end` pins the root's end to a stamp the
        caller already holds (the fast lane's completion point —
        the fast lane): a root that ends a descheduling-blip later than its
        last child would charge pure bookkeeping to the residue, and
        the lane's attribution bar is exactly about leaving none."""
        now = t_end if t_end is not None else time.monotonic()
        with self._lock:
            acc = self._live.pop(rid, None)
            if acc is None:
                return
            dur = max(now - acc["t0"], 0.0)
            root = {
                "id": next(self._ids),
                "parent": None,
                "name": "request",
                "t0": acc["t0"],
                "dur": dur,
                "tid": "request",
                "rids": [rid],
                "status": "error" if error is not None else "ok",
                "tags": ({"rows": acc["rows"]} if error is None else
                         {"rows": acc["rows"],
                          "error": type(error).__name__}),
            }
            self._stage_record_locked("request", dur * 1e3)
            dur_ms = dur * 1e3
            over_slo = self.slo_ms is not None and dur_ms > self.slo_ms
            trace = {
                "trace_id": acc["trace_id"],
                "rid": rid,
                "t0": acc["t0"],
                "duration_ms": dur_ms,
                "status": root["status"],
                "over_slo": over_slo,
                "spans": [root] + acc["spans"],
            }
            self._finished += 1
            if root["status"] == "error" or over_slo:
                self._exemplars.append(trace)
                self._kept_exemplar += 1
            elif self._sampled(rid):
                self._ring.append(trace)
                self._kept_sampled += 1
            else:
                self._sampled_out += 1
        # Breakdown computed OUTSIDE the lock (interval math over a
        # handful of spans — cheap, but the lock is hot-path-adjacent).
        att = attribute_stages(trace)
        with self._lock:
            self._recent[acc["trace_id"]] = {
                "total_ms": att["total_ms"],
                "stages_ms": att["stages_ms"],
                "residue_ms": att["residue_ms"],
                "over_slo": over_slo,
                "status": root["status"],
            }
            while len(self._recent) > self._recent_cap:
                self._recent.popitem(last=False)

    def _sampled(self, rid: int) -> bool:
        # Deterministic per-request draw (the faults.py content-hash
        # idiom): the same request keeps the same verdict across runs,
        # so sampled bench replays are reproducible.
        if self.sample >= 1.0:
            return True
        if self.sample <= 0.0:
            return False
        h = hashlib.sha256(f"{self.seed}:trace:{rid}".encode()).digest()
        return int.from_bytes(h[:8], "big") / 2.0 ** 64 < self.sample

    # -- span recording ----------------------------------------------------

    def begin_span(self, name: str, rids=None, ctx=None, **tags) -> Span:
        """Open a span on this thread. Parent and request ids inherit
        from the innermost open span unless `rids` (explicit request
        set) or `ctx` (a current() ref from the spawning thread) is
        given. MUST be closed via end_span in a try/finally."""
        st = self._stack()
        if ctx is not None:
            parent, inherited = ctx
        elif st:
            parent, inherited = st[-1].id, st[-1].rids
        else:
            parent, inherited = None, ()
        sp = Span(self, next(self._ids), parent, name, time.monotonic(),
                  threading.current_thread().name,
                  {k: v for k, v in tags.items() if v is not None},
                  tuple(rids) if rids is not None else tuple(inherited),
                  exc0=sys.exc_info()[1])
        st.append(sp)
        with self._lock:
            self._open += 1
        return sp

    def end_span(self, sp: Span, **tags) -> None:
        """Close `sp` and record it. Status becomes "error" when an
        exception is propagating through the enclosing finally, or when
        an explicit `error=...` tag is passed (for callers that caught
        the failure themselves). Idempotent."""
        if sp.ended:
            return
        sp.ended = True
        dur = max(time.monotonic() - sp.t0, 0.0)
        for k, v in tags.items():
            if v is not None:
                sp.tags[k] = v
        status = "ok"
        if sp.tags.get("error") is not None:
            status = "error"
        else:
            exc = sys.exc_info()[1]
            if exc is not None and exc is not sp.exc0:
                status = "error"
                sp.tags["error"] = type(exc).__name__
        st = self._stack()
        if st and st[-1] is sp:
            st.pop()
        else:                      # defensive: out-of-order end
            for i in range(len(st) - 1, -1, -1):
                if st[i] is sp:
                    del st[i]
                    break
        self._record({
            "id": sp.id, "parent": sp.parent, "name": sp.name,
            "t0": sp.t0, "dur": dur, "tid": sp.tid,
            "rids": list(sp.rids), "status": status, "tags": sp.tags,
        }, opened=True)

    def add_span(self, name: str, t0: float, t1: float, rids=(),
                 tid: Optional[str] = None, **tags) -> None:
        """Record an already-measured interval as a closed span — the
        cross-thread stages (queue wait, the in-flight window) whose
        endpoints are monotonic stamps both sides already hold, so no
        span object ever crosses a thread hop open."""
        st = self._stack()
        parent = st[-1].id if st else None
        self._record({
            "id": next(self._ids), "parent": parent, "name": name,
            "t0": t0, "dur": max(t1 - t0, 0.0),
            "tid": tid or threading.current_thread().name,
            "rids": list(rids), "status": "ok",
            "tags": {k: v for k, v in tags.items() if v is not None},
        }, opened=False)

    def _record(self, d: dict, opened: bool) -> None:
        with self._lock:
            if opened:
                self._open -= 1
            self._stage_record_locked(d["name"], d["dur"] * 1e3)
            if not d["rids"]:
                self._run.append(d)
            for rid in d["rids"]:
                acc = self._live.get(rid)
                if acc is not None:
                    acc["spans"].append(d)

    def _stage_record_locked(self, name: str, ms: float) -> None:
        h = self._stages.get(name)
        if h is None:
            h = self._stages[name] = [0, 0.0,
                                      [0] * (len(STAGE_BUCKETS_MS) + 1)]
        h[0] += 1
        h[1] += ms
        for i, ub in enumerate(STAGE_BUCKETS_MS):
            if ms <= ub:
                h[2][i] += 1
                break
        else:
            h[2][-1] += 1

    def stage_p99_ms(self, name: str) -> Optional[float]:
        """Histogram-estimated p99 of one stage's recorded durations:
        the upper bound of the bucket containing the 99th-percentile
        sample (None until the stage has samples; the overflow bucket
        reports twice the top bound — an honest 'at least'). The
        autoscaler's per-stage saturation signal: a
        queue.wait p99 climbing toward the SLO is the leading edge of
        overload, visible before sheds start."""
        with self._lock:
            h = self._stages.get(name)
            if h is None or not h[0]:
                return None
            target = 0.99 * h[0]
            acc = 0
            for i, n in enumerate(h[2]):
                acc += n
                if acc >= target:
                    return (float(STAGE_BUCKETS_MS[i])
                            if i < len(STAGE_BUCKETS_MS)
                            else STAGE_BUCKETS_MS[-1] * 2.0)
            return STAGE_BUCKETS_MS[-1] * 2.0

    # -- export ------------------------------------------------------------

    def traces(self) -> list:
        """Every retained trace (sampled ring + exemplars), oldest
        first within each class."""
        with self._lock:
            return list(self._ring) + list(self._exemplars)

    def breakdown(self, trace_id: str) -> Optional[dict]:
        """The finished stage breakdown for one trace id (bounded
        recent-window lookup — the Server-Timing source)."""
        with self._lock:
            d = self._recent.get(trace_id)
            return dict(d) if d is not None else None

    def server_timing(self, trace_id: str) -> Optional[str]:
        """RFC-compliant Server-Timing header value for a finished
        request: one `stage;dur=ms` entry per attributed stage plus the
        unattributed residue."""
        d = self.breakdown(trace_id)
        if d is None:
            return None
        parts = [f"{stage};dur={ms:.3f}"
                 for stage, ms in sorted(d["stages_ms"].items())]
        parts.append(f"residue;dur={d['residue_ms']:.3f}")
        return ", ".join(parts)

    def export_chrome(self, pid: int = 1,
                      process_name: str = "distributedmnist-serve"
                      ) -> dict:
        """Chrome trace-event JSON (loads directly in chrome://tracing
        and Perfetto): complete 'X' events on monotonic-microsecond
        timestamps, thread-name metadata per pipeline thread, one event
        per distinct span (batch spans shared across cohort traces are
        deduped by id). tid numbers are assigned per-export in
        first-encounter order, so a caller MERGING several tracers'
        exports into one file must give each a distinct `pid` —
        otherwise the second export's thread_name metadata relabels
        the first's tracks (the bench's --trace --chaos merge passes
        pid per leg)."""
        spans, seen = [], set()
        for tr in self.traces():
            for s in tr["spans"]:
                if s["id"] not in seen:
                    seen.add(s["id"])
                    spans.append(s)
        return _chrome(spans, pid, process_name, "serve", lambda s: {
            "trace_ids": [f"{r:08x}" for r in s["rids"]]})

    def run_spans(self) -> list:
        """The spans recorded with no request id (a training run's
        phases and blocks), oldest first: the last RUN_CAPACITY."""
        with self._lock:
            return list(self._run)

    def export_run_chrome(self, pid: int = 1,
                          process_name: str = "distributedmnist-train",
                          since: int = 0, shift_us: float = 0.0) -> dict:
        """The run spans whose id is at least `since` as export_chrome's
        JSON, each event's args holding its own span id beside its
        parent's. `shift_us` moves them from the monotonic clock onto
        another trace's (a torch.profiler trace's), so that both load
        into one view."""
        spans = [s for s in self.run_spans() if s["id"] >= since]
        return _chrome(spans, pid, process_name, "train",
                       lambda s: {"id": s["id"]}, shift_us)

    def snapshot(self) -> dict:
        """Counters + the per-stage duration histograms (the /metrics
        `trace` block; the Prometheus exposition flattens `stages`)."""
        with self._lock:
            stages = {
                name: {
                    "count": h[0],
                    "sum_ms": round(h[1], 3),
                    "buckets": {**{f"{ub:g}": h[2][i]
                                   for i, ub in
                                   enumerate(STAGE_BUCKETS_MS)},
                                "+Inf": h[2][-1]},
                }
                for name, h in sorted(self._stages.items())}
            return {
                "slo_ms": self.slo_ms,
                "sample": self.sample,
                "capacity": self.capacity,
                "requests_started": self._started,
                "requests_finished": self._finished,
                "kept_sampled": self._kept_sampled,
                "kept_exemplars": self._kept_exemplar,
                "sampled_out": self._sampled_out,
                "aborted": self._aborted,
                "dropped_live": self._dropped_live,
                "live": len(self._live),
                "open_spans": self._open,
                "ring_traces": len(self._ring),
                "exemplar_traces": len(self._exemplars),
                "stages": stages,
            }


# The module-global active tracer. None (the default, every production
# process) keeps all woven hooks to one attribute read + None test —
# the serve/faults.py inertness idiom.
_active: Optional[Tracer] = None


def install(tracer: Tracer) -> Tracer:
    """Activate `tracer` process-wide. Refuses to stack: two tracers
    silently interleaved would make neither's retention trustworthy."""
    global _active
    if _active is not None:
        raise RuntimeError(
            "a Tracer is already installed; uninstall() it first")
    _active = tracer
    return tracer


def uninstall() -> None:
    global _active
    _active = None


def active() -> Optional[Tracer]:
    return _active


def begin_span(name: str, rids=None, ctx=None, **tags) -> Optional[Span]:
    """The woven begin hook: None (and free) when no tracer is
    installed. Close with end_span in a try/finally."""
    tr = _active
    if tr is None:
        return None
    return tr.begin_span(name, rids=rids, ctx=ctx, **tags)


def end_span(sp: Optional[Span], **tags) -> None:
    """Close a begin_span result; safe on None (tracer was off) and
    after uninstall (the span remembers its tracer)."""
    if sp is not None:
        sp.tracer.end_span(sp, **tags)


def add_span(name: str, t0: float, t1: float, rids=(),
             tid: Optional[str] = None, **tags) -> None:
    tr = _active
    if tr is not None:
        tr.add_span(name, t0, t1, rids=rids, tid=tid, **tags)


def current() -> Optional[tuple]:
    tr = _active
    if tr is None:
        return None
    return tr.current()
