"""Dynamic micro-batcher: coalesce concurrent requests into engine-sized
batches, pipelined through a bounded in-flight window, with bounded-queue
backpressure (the port of the JAX package's serve/batcher.py).

A **dispatch thread** coalesces whatever is queued — up to `max_batch`
rows, or until the effective wait has passed since the oldest request
arrived — runs the drain through the cost-model batch former
(scheduler.plan_segments), and hands each segment to engine.dispatch(),
which returns without waiting for the device. A **completion thread**
fetches results in dispatch order and fans the rows out to per-request
futures. `max_inflight` bounds dispatched-but-unfetched batches, so batch
k computes on the card while batch k+1 stages on the host.

Backpressure: beyond `queue_depth` pending rows submit() raises Rejected
(503 semantics) instead of letting the queue grow without bound.

Deadlines: submit(x, deadline_s) takes a time.monotonic() deadline. One
already past raises DeadlineExceeded at submit; a live one rides the
request, and the dispatch thread sheds it as it pops the request if it
has passed by then (504, zero device work).

Resilience (serve/resilience.py): a failed multi-request dispatch is
**bisected** — retried as recursively split sub-segments along request
boundaries, whose covering buckets are rungs already on the ladder — so
a poison request is isolated and its cohort-mates succeed. A 503-shaped
failure (NoLiveModel) is systemic: the drain fails once, never bisected.
Every outcome feeds ResiliencePolicy.record_outcome, the per-version
circuit breaker. The dispatch site is the failpoint `batch.dispatch`
(ctx: the request ids), so serve/faults.py can poison requests on demand.

Dedup (`dedup=True`): identical rows inside one drain (same sha256 of the
input bytes) dispatch once; riders fan out from their representative's
slice. The cross-drain sibling, the prediction cache, is serve/cache.py's
CacheFront in front of this batcher.

Routes: submit(x, route=dtype) pins the dispatch to one precision of the
live version (the cascade's stage requests). A drain is route-uniform: a
queue head pinned to another route than the drain's first request waits
for the next cycle, so one batch runs one engine. Routed requests never
take the fast lane.

With a replica fleet as the engine (serve/fleet.py) the window left on
auto opens to the fleet's aggregate, `max_inflight_total`, and every
batch's metrics name the replica that computed it.

The fast lane (`fastlane=True`): a submit that finds the queue empty and
a free in-flight slot — one atomic choice under the queue lock
(scheduler.fastlane_eligible plus a non-blocking slot acquire; the
claimed slot is the request's in-flight slot) — dispatches on the
caller's thread (the engine's resident route when one fits), blocks on
its own fetch and returns a resolved future. Any contention sends the
submit down the coalescing path.

Tracing (serve/trace.py): with a tracer installed each request's path is
a span tree (queue wait, coalesce, plan, dispatch, the in-flight window,
fetch, fan-out, sheds and bisection splits), finished BEFORE its future
resolves, so a response-side lookup reads a complete tree. With none
installed every hook is one None check.
"""

from __future__ import annotations

import hashlib
import itertools
import threading
import time
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Optional

from distributedmnist_tpu_torch.analysis.locks import (make_condition,
                                                       make_fifo, make_lock,
                                                       make_semaphore,
                                                       make_thread)
from distributedmnist_tpu_torch.serve import trace
from distributedmnist_tpu_torch.serve.faults import failpoint
from distributedmnist_tpu_torch.serve.resilience import DeadlineExceeded
from distributedmnist_tpu_torch.serve.scheduler import (AdaptiveController,
                                                        fastlane_eligible,
                                                        plan_segments)


class Rejected(RuntimeError):
    """Queue past its watermark: shed this request (503 semantics)."""

    status = 503


def resolve_max_inflight(value: Optional[int], platform: str) -> int:
    """An explicit value wins; None means 1 on the cpu (staging and
    compute share the same cores, so depth only adds latency) and 4 on
    the card."""
    if value is not None:
        if value < 1:
            raise ValueError(f"max_inflight must be >= 1, got {value}")
        return value
    return 1 if platform == "cpu" else 4


@dataclass
class _Request:
    x: "object"                   # (n, 28, 28, 1) uint8 ndarray
    n: int
    t_enqueue: float              # time.monotonic()
    rid: int = 0                  # unique per submit: the identity the
    #   fault injector's request-sticky draws and bisection key on
    deadline: Optional[float] = None   # time.monotonic(); None = none
    future: Future = field(default_factory=Future)
    # sha256 of the input bytes when dedup is on (None = not deduped),
    # and the identical requests of the same drain riding this one
    key: Optional[bytes] = None
    dups: list = field(default_factory=list)
    # the infer_dtype the dispatch is pinned to (None = the live route)
    route: Optional[str] = None
    # the tenancy layer's {"tenant", "model"} attribution, carried onto
    # this request's queue.wait span and its dispatch's span (None keeps
    # the untagged span shape)
    tags: Optional[dict] = None


class DynamicBatcher:
    """Dispatch + completion threads over a bounded request queue.

    start()/stop() manage the threads; submit(x) -> Future resolving to
    the request's (n, 10) logits. Coalesced dispatches run on the one
    dispatch thread and their fetches on the one completion thread, in
    dispatch order, so results never reorder across batches. A fast-lane
    submit dispatches and fetches its own one-request batch on the
    caller's thread; the engine's dispatch/fetch are thread-safe for it
    (a locked staging pool, per-call fast-lane buffers, a single-flight
    row buffer)."""

    def __init__(self, engine, max_batch: Optional[int] = None,
                 max_wait_us: int = 1000, queue_depth: int = 4096,
                 metrics=None, max_inflight: Optional[int] = None,
                 slo_ms: Optional[float] = None, adaptive: bool = True,
                 split: bool = True, resilience=None,
                 dedup: bool = False, fastlane: bool = False):
        self.engine = engine
        self.fastlane = fastlane
        self.dedup = dedup
        # the policy bundle: `bisect` gates bisection, record_outcome
        # feeds the breaker; None fails a whole segment on a dispatch
        # error, with no breaker
        self.resilience = resilience
        self._rid = itertools.count(1)
        self.max_batch = min(max_batch or engine.max_batch,
                             engine.buckets[-1])
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if slo_ms is not None and slo_ms <= 0:
            raise ValueError(f"slo_ms must be > 0, got {slo_ms}")
        self.max_wait_s = max_wait_us / 1e6
        self.queue_depth = queue_depth
        self.metrics = metrics
        # the batch former; split=False sends every drain as one segment
        # in its covering bucket
        self.split = split
        self.controller = (AdaptiveController(
            self.max_wait_s,
            slo_s=slo_ms / 1e3 if slo_ms is not None else None,
            max_batch=self.max_batch) if adaptive else None)
        # a fleet keeps its own per-replica windows and advertises their
        # sum; on auto the batcher's window opens to it, so the queue
        # keeps every replica fed. An explicit value still wins.
        fleet_total = getattr(engine, "max_inflight_total", None)
        if max_inflight is None and fleet_total is not None:
            self.max_inflight = fleet_total
        else:
            self.max_inflight = resolve_max_inflight(
                max_inflight, getattr(engine, "platform", "cpu"))
        self._q: deque[_Request] = deque()
        self._rows = 0                   # pending rows, watermark basis
        self._cond = make_condition("batcher.queue")
        self._stop = False
        # The in-flight window: a slot is held from the moment a batch is
        # popped (or a fast-lane submit claims it) until its results have
        # fanned out.
        self._slots = make_semaphore("batcher.inflight_slots",
                                     self.max_inflight)
        # permits the autoscaler holds to narrow the live window: the
        # semaphore stays fixed at max_inflight (the hard ceiling)
        self._window_parked = 0          # guarded by self._cond
        # Popped segments whose futures have not all resolved (the drain
        # predicate), and the dispatched-but-unresolved ones among them
        # (the depth gauge metrics export).
        self._inflight = 0
        self._dispatched = 0
        self._inflight_lock = make_lock("batcher.inflight_gauge")
        # dispatch -> completion, FIFO; None is the shutdown sentinel
        self._handles = make_fifo("batcher.handles")
        self._dispatcher: Optional[threading.Thread] = None
        self._completer: Optional[threading.Thread] = None

    # -- client side -------------------------------------------------------

    def next_rid(self) -> int:
        """A fresh request id from the batcher's sequence: the cache front
        stamps hit and collapsed requests from the same id space."""
        return next(self._rid)

    def submit(self, x, deadline_s: Optional[float] = None,
               key: Optional[bytes] = None,
               route: Optional[str] = None,
               tags: Optional[dict] = None) -> Future:
        """Enqueue up to max_batch rows; the Future resolves to their
        logits. Raises Rejected past the queue watermark, ValueError for
        a request no single dispatch could carry, and DeadlineExceeded
        when `deadline_s` (a time.monotonic() deadline) has passed
        already: an expired request costs no queue or device work. A
        live deadline rides the request; _take_batch sheds it if it
        expires while queued. `key` is the input's sha256 when the
        caller has it (the cache front), so the bytes hash once. `route`
        pins the dispatch to that infer_dtype (coalescing path only).
        `tags` (the tenancy layer's {"tenant", "model"}) ride onto this
        request's queue.wait span and its dispatch's span."""
        x = self.engine._as_images(x)
        n = x.shape[0]
        if n > self.max_batch:
            raise ValueError(
                f"request of {n} rows exceeds max_batch={self.max_batch};"
                " split it client-side")
        now = time.monotonic()
        if deadline_s is not None and now >= deadline_s:
            if self.metrics is not None:
                self.metrics.record_deadline_shed(n)
            raise DeadlineExceeded(
                "deadline already expired at submit "
                f"({(now - deadline_s) * 1e3:.1f} ms ago)")
        if self.dedup and key is None:
            key = hashlib.sha256(x.tobytes()).digest()
        req = _Request(x=x, n=n, t_enqueue=now, rid=next(self._rid),
                       deadline=deadline_s,
                       key=key if self.dedup else None, route=route,
                       tags=tags)
        tr = trace.active()
        if tr is not None:
            # opened BEFORE the queue insert, so the dispatch thread's
            # spans always find it; the id rides the future (X-Trace-Id)
            req.future.trace_id = tr.start_request(
                req.rid, rows=n, deadline_s=deadline_s, t0=req.t_enqueue)
        fast = False
        try:
            with self._cond:
                if self._stop:
                    raise RuntimeError("batcher is stopped")
                if self._rows + n > self.queue_depth:
                    if self.metrics is not None:
                        self.metrics.record_reject(n)
                    raise Rejected(
                        f"queue at {self._rows} pending rows; watermark "
                        f"{self.queue_depth} would be exceeded by {n} "
                        "more")
                # the lane decision, atomic with admission: an empty
                # queue AND a free window slot, which becomes this
                # request's in-flight slot
                if (route is None
                        and fastlane_eligible(self.fastlane, self._rows)
                        and self._slots.acquire(blocking=False)):
                    fast = True
                    with self._inflight_lock:
                        self._inflight += 1
                else:
                    self._q.append(req)
                    self._rows += n
                    self._cond.notify_all()
        except Exception:
            # never admitted: nothing will ever finish this trace
            if tr is not None:
                tr.abort_request(req.rid)
            raise
        if self.controller is not None:
            self.controller.on_arrival(n, now=req.t_enqueue,
                                       coalesced=not fast)
        if fast:
            # every path through _fast_dispatch releases the slot and
            # the in-flight count; the future comes back resolved
            self._fast_dispatch(req)
        return req.future

    def pending_rows(self) -> int:
        with self._cond:
            return self._rows

    def inflight_batches(self) -> int:
        """Segments popped off the queue (or fast-lane requests) whose
        futures have not all resolved: pending_rows()==0 and
        inflight_batches()==0 together mean fully drained."""
        with self._inflight_lock:
            return self._inflight

    # -- autoscale actuation -----------------------------------------------

    def window(self) -> int:
        """The live in-flight window: max_inflight less the permits
        apply_scale has parked."""
        with self._cond:
            return self.max_inflight - self._window_parked

    def apply_scale(self, window: Optional[int] = None,
                    max_batch: Optional[int] = None,
                    timeout_s: float = 1.0) -> dict:
        """The single-host actuation surface: widen or narrow the
        in-flight window and/or the coalescing bucket ceiling at run
        time. Only the autoscaler's actuator may call it (lint DML019).

        The window moves by parking permits on the fixed slot semaphore:
        narrowing acquires and holds permits, one at a time and outside
        the queue lock, waiting up to `timeout_s` per permit for batches
        in flight to finish; a timeout returns the partial window (the
        next tick retries). Widening releases held permits, never past
        max_inflight. max_batch is clamped to the engine's warmed ladder
        (buckets[-1]), so a scale never builds anything.

        Returns {"window": achieved, "max_batch": achieved}."""
        if window is not None:
            if window < 1:
                raise ValueError(f"window must be >= 1, got {window}")
            target = min(window, self.max_inflight)
            while True:
                with self._cond:
                    cur = self.max_inflight - self._window_parked
                    if cur < target:          # widen: unpark
                        n = target - cur
                        self._window_parked -= n
                        self._slots.release(n)
                        break
                    if cur == target:
                        break
                # narrow: a full pipeline makes the acquire wait, and
                # holding the queue lock across it would stall submits
                if not self._slots.acquire(timeout=timeout_s):
                    break                     # partial
                with self._cond:
                    self._window_parked += 1
        if max_batch is not None:
            if max_batch < 1:
                raise ValueError(
                    f"max_batch must be >= 1, got {max_batch}")
            with self._cond:
                self.max_batch = min(max_batch, self.engine.buckets[-1])
                if self.controller is not None:
                    self.controller.max_batch = self.max_batch
        return {"window": self.window(), "max_batch": self.max_batch}

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "DynamicBatcher":
        if self._dispatcher is not None:
            raise RuntimeError("batcher already started")
        if self._stop:
            raise RuntimeError(
                "batcher is stopped; construct a new one instead of "
                "restarting")
        self._dispatcher = make_thread(
            target=self._dispatch_loop, name="serve-dispatch", daemon=True)
        self._completer = make_thread(
            target=self._completion_loop, name="serve-complete",
            daemon=True)
        self._dispatcher.start()
        self._completer.start()
        return self

    def stop(self, drain: bool = True) -> None:
        """Stop the pipeline. drain=True serves what is queued and fetches
        every in-flight batch before returning (every accepted future
        resolves); drain=False fails still-queued futures at once, while
        in-flight batches still resolve when their fetch lands."""
        dropped: list[_Request] = []
        with self._cond:
            self._stop = True
            # permits the autoscaler parked go back: a narrowed window
            # must not throttle the final drain (the autoscaler stops
            # first, so nothing parks them again)
            if self._window_parked:
                self._slots.release(self._window_parked)
                self._window_parked = 0
            if not drain:
                while self._q:
                    req = self._q.popleft()
                    self._rows -= req.n
                    dropped.append(req)
            self._cond.notify_all()
        # futures resolve outside the queue lock: their callbacks (the
        # cache front's fan-out) run inline and must never run under it
        for req in dropped:
            err = RuntimeError("batcher stopped")
            self._finish_trace(req, error=err)
            req.future.set_exception(err)
        timeout = 30 if drain else 1
        for t in (self._dispatcher, self._completer):
            if t is not None:
                t.join(timeout=timeout)
        self._dispatcher = self._completer = None

    # -- dispatch side -----------------------------------------------------

    def _take_batch(self) -> list[list[_Request]]:
        """Block until there is work, coalesce until max_batch rows are
        pending or the effective wait has passed since the oldest
        request, pop a prefix that fits max_batch and plan it into
        segments. [] only when stopping with an empty queue. Popped
        segments are counted in-flight before the queue lock drops, so
        an observer never sees a popped drain in neither count.

        Requests whose deadline has passed are shed as they are popped:
        their futures fail with DeadlineExceeded, off the queue lock, and
        they never reach a dispatch. A pop that sheds its whole drain
        coalesces again instead of returning [] (the shutdown signal)."""
        while True:
            with self._cond:
                segments, shed = self._take_batch_locked()
            self._shed_expired(shed)
            if segments is not None:
                return segments

    def _shed_expired(self, shed: list) -> None:
        """Fail the deadline-expired requests one drain popped (504),
        outside the queue lock; spans and the trace land first."""
        for req, t_shed in shed:
            if self.metrics is not None:
                self.metrics.record_deadline_shed(req.n)
            err = DeadlineExceeded(
                "deadline expired while queued "
                f"({(t_shed - req.deadline) * 1e3:.1f} ms past); "
                "shed before dispatch")
            trace.add_span("queue.wait", req.t_enqueue, t_shed,
                           rids=(req.rid,), shed=True,
                           **(req.tags or {}))
            trace.add_span("deadline.shed", t_shed, t_shed,
                           rids=(req.rid,))
            self._finish_trace(req, error=err)
            req.future.set_exception(err)

    def _take_batch_locked(self) -> tuple:
        """One coalesce-pop-plan cycle under self._cond: (segments, shed),
        segments None when everything popped was shed, shed the
        (request, pop time) pairs the caller fails once the lock drops."""
        shed: list = []
        while not self._q and not self._stop:
            self._cond.wait(0.1)
        if not self._q:
            return [], shed
        t_coalesce = time.monotonic()
        wait_s = (self.controller.effective_wait_s()
                  if self.controller is not None else self.max_wait_s)
        if self.metrics is not None:
            self.metrics.record_wait(wait_s)
        deadline = self._q[0].t_enqueue + wait_s
        while self._rows < self.max_batch and not self._stop:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            self._cond.wait(remaining)
        batch = []
        taken = 0
        now = time.monotonic()
        # route-uniform: a head pinned elsewhere waits for the next drain
        route = self._q[0].route
        while (self._q and taken + self._q[0].n <= self.max_batch
               and self._q[0].route == route):
            req = self._q.popleft()
            self._rows -= req.n
            if req.deadline is not None and now >= req.deadline:
                shed.append((req, now))
                continue
            trace.add_span("queue.wait", req.t_enqueue, now,
                           rids=(req.rid,), **(req.tags or {}))
            taken += req.n
            batch.append(req)
        if not batch:
            return None, shed
        t_plan = time.monotonic()
        popped = batch
        all_rids = [r.rid for r in batch]
        if self.dedup:
            batch = self._dedup_batch(batch, t_plan)
        segments = self._plan(batch)
        tr = trace.active()
        if tr is not None:
            # the drain's one coalesce span starts no earlier than its
            # latest request: one that arrived while the drain coalesced
            # must not hold a span older than itself (its queue.wait
            # covers its own wait)
            t_join = max([t_coalesce] + [r.t_enqueue for r in popped])
            tr.add_span("batch.coalesce", t_join, now, rids=all_rids,
                        rows=taken)
            tr.add_span("batch.plan", t_plan, time.monotonic(),
                        rids=all_rids, segments=len(segments))
        with self._inflight_lock:
            self._inflight += len(segments)
        return segments, shed

    def _plan(self, batch: list[_Request]) -> list[list[_Request]]:
        """The batch former: cut one drain into bucket-shaped segments by
        the engine's measured cost table; one segment without a table or
        with split=False."""
        counts = [len(batch)]
        if self.split and len(batch) > 1:
            costs_fn = getattr(self.engine, "bucket_costs", None)
            costs = costs_fn() if callable(costs_fn) else None
            if costs:
                counts = plan_segments([r.n for r in batch],
                                       self.engine.buckets, costs)
        segments = []
        off = 0
        for c in counts:
            segments.append(batch[off:off + c])
            off += c
        return segments

    def _dedup_batch(self, batch: list[_Request],
                     now: float) -> list[_Request]:
        """Collapse requests with the same content hash and row count
        into one representative per drain; riders ride its `dups` and
        resolve from its slice. Riders never reach the dispatch
        failpoint, so request-sticky draws and bisection see unique rows
        only."""
        uniques: dict = {}
        out: list[_Request] = []
        dup_rids: list[int] = []
        dup_rows = 0
        for r in batch:
            rep = (uniques.get((r.key, r.n))
                   if r.key is not None else None)
            if rep is not None:
                rep.dups.append(r)
                dup_rids.append(r.rid)
                dup_rows += r.n
                continue
            if r.key is not None:
                uniques[(r.key, r.n)] = r
            out.append(r)
        if dup_rids:
            if self.metrics is not None:
                self.metrics.record_dedup(len(dup_rids), dup_rows)
            trace.add_span("batch.dedup", now, now, rids=dup_rids,
                           collapsed=len(dup_rids))
        return out

    @staticmethod
    def _span_rids(seg: list[_Request]) -> list[int]:
        """The request ids a batch-level span covers: the dispatched
        requests and their dedup riders."""
        rids: list[int] = []
        for r in seg:
            rids.append(r.rid)
            rids.extend(d.rid for d in r.dups)
        return rids

    @staticmethod
    def _span_tags(seg: list[_Request]) -> dict:
        """The batch.dispatch span's attribution: the model tag is
        drain-uniform (one batch runs one engine), so the first tagged
        request speaks for all; tenants can coalesce, so the span carries
        the sorted distinct set. Untagged segments add nothing."""
        tags: dict = {}
        tenants = sorted({r.tags["tenant"] for r in seg
                          if r.tags and "tenant" in r.tags})
        if tenants:
            tags["tenants"] = ",".join(tenants)
        for r in seg:
            if r.tags and "model" in r.tags:
                tags["model"] = r.tags["model"]
                break
        return tags

    def _live_version(self) -> Optional[str]:
        """The version a dispatch failure is blamed on: the router's live
        version, or a bare engine's own label; None (never counted by the
        breaker) when neither exists."""
        live_fn = getattr(self.engine, "live_version", None)
        if callable(live_fn):
            return live_fn()
        return getattr(self.engine, "version", None)

    def _finish_trace(self, req: _Request, error=None,
                      t_end: Optional[float] = None) -> None:
        """Close the request's trace (a no-op with no tracer), always
        before its future resolves."""
        tr = trace.active()
        if tr is not None:
            tr.finish_request(req.rid, error=error, t_end=t_end)

    def _fail_fanout(self, req: _Request, e: Exception) -> None:
        """Fail one request and its dedup riders with the same error."""
        self._finish_trace(req, error=e)
        req.future.set_exception(e)
        for d in req.dups:
            self._finish_trace(d, error=e)
            d.future.set_exception(e)

    def _engine_dispatch(self, seg: list[_Request]):
        """The one engine.dispatch call site of the coalescing path,
        crossed by every first dispatch and every bisection retry: the
        `batch.dispatch` failpoint fires with the dispatched request ids
        (riders are not dispatched)."""
        sp = trace.begin_span("batch.dispatch", rids=self._span_rids(seg),
                              rows=sum(r.n for r in seg),
                              **self._span_tags(seg))
        try:
            failpoint("batch.dispatch", rids=[r.rid for r in seg])
            xs = [r.x for r in seg]
            # segments are route-uniform, and bisection's retries come
            # back through here with the same pin
            route = seg[0].route
            if route is None:
                return self.engine.dispatch(xs)
            return self.engine.dispatch(xs, infer_dtype=route)
        finally:
            trace.end_span(sp)

    def _fast_dispatch(self, req: _Request) -> None:
        """The fast lane's whole pipeline on the submitting thread: the
        dispatch (the engine's resident route, else its ordinary
        dispatch), the blocking fetch and the fan-out. The caller holds
        one window slot and one in-flight count; every path out releases
        both. Traces finish before the future resolves, metrics record
        the populations a coalesced request records, and outcomes feed
        the breaker."""
        t0 = time.monotonic()
        sp = trace.begin_span("fastpath", rids=(req.rid,), rows=req.n)
        try:
            if sp is not None:
                # admit ends exactly where the lane span begins, so the
                # submit-to-dispatch interval is covered without a gap
                trace.add_span("fastpath.admit", req.t_enqueue, sp.t0,
                               rids=(req.rid,))
            if req.deadline is not None and t0 >= req.deadline:
                if self.metrics is not None:
                    self.metrics.record_deadline_shed(req.n)
                err = DeadlineExceeded(
                    "deadline expired at fast-lane dispatch "
                    f"({(t0 - req.deadline) * 1e3:.1f} ms past); "
                    "shed before dispatch")
                trace.add_span("deadline.shed", t0, t0, rids=(req.rid,))
                trace.end_span(sp)
                self._finish_trace(req, error=err)
                req.future.set_exception(err)
                with self._inflight_lock:
                    self._inflight -= 1
                self._slots.release()
                return
            try:
                failpoint("batch.dispatch", rids=[req.rid])
                fast = getattr(self.engine, "dispatch_fast", None)
                handle = fast(req.x) if callable(fast) else None
                if handle is None:
                    # no resident route, or a busy row buffer: still on
                    # this thread, still queue-free
                    handle = self.engine.dispatch([req.x])
            except Exception as e:   # a singleton cohort: no bisection
                trace.end_span(sp, error=type(e).__name__)
                self._dispatch_failed([req], e)
                return
            with self._inflight_lock:
                self._dispatched += 1
                depth = self._dispatched
            if self.metrics is not None:
                self.metrics.record_dispatch(time.monotonic() - t0,
                                             inflight=depth)
            t_fetch = time.monotonic()
            fsp = trace.begin_span("engine.fetch", rids=(req.rid,),
                                   bucket=handle.bucket)
            try:
                logits = self.engine.fetch(handle)
            except Exception as e:
                trace.end_span(fsp, error=type(e).__name__)
                trace.end_span(sp)
                self._fail_fanout(req, e)
                if self.metrics is not None:
                    self.metrics.record_fetch_error(1)
                if self.resilience is not None:
                    self.resilience.record_outcome(
                        getattr(handle, "version", None), ok=False)
                with self._inflight_lock:
                    self._inflight -= 1
                    self._dispatched -= 1
                self._slots.release()
                return
            finally:
                trace.end_span(fsp)
            t_done = time.monotonic()
            version = getattr(handle, "version", None)
            if self.resilience is not None:
                self.resilience.record_outcome(version, ok=True)
            if self.controller is not None:
                self.controller.on_latency(t_done - req.t_enqueue)
            req.future.version = version
            # the lane span closes before the trace finishes, and the
            # root's end is pinned to this stamp: no bookkeeping residue
            t_end = time.monotonic()
            trace.end_span(sp)
            self._finish_trace(req, t_end=t_end)
            req.future.set_result(logits[:req.n])
            if self.metrics is not None:
                # one record: a reset() between the lane split and the
                # request would skew the lane fraction
                self.metrics.record_served(
                    t_done - t_fetch, rows=req.n, bucket=handle.bucket,
                    queue_depth=self.pending_rows(),
                    latencies=((t_done - req.t_enqueue, req.n),),
                    version=version,
                    replica=getattr(handle, "replica", None),
                    infer_dtype=getattr(handle, "infer_dtype", None),
                    fastpath=True)
            with self._inflight_lock:
                self._inflight -= 1
                self._dispatched -= 1
            self._slots.release()
        finally:
            trace.end_span(sp)

    def _wait_for_work(self) -> bool:
        """Park until the queue is non-empty (True) or the batcher is
        stopping with nothing queued (False), holding no window slot, so
        an idle pipeline leaves its slots to the fast lane."""
        with self._cond:
            while not self._q and not self._stop:
                self._cond.wait(0.1)
            return bool(self._q)

    def _dispatch_loop(self) -> None:
        while True:
            if not self._wait_for_work():
                self._handles.put(None)      # completion shutdown
                return
            # The window slot is taken BEFORE coalescing: while the window
            # is full, arrivals keep accumulating toward a fuller batch.
            self._slots.acquire()
            segments = self._take_batch()
            if not segments:
                self._slots.release()
                self._handles.put(None)
                return
            t_pop = time.monotonic()
            for i, seg in enumerate(segments):
                if i:
                    # later segments of a split drain hold their own slot
                    # (the completion thread frees slots as it drains, so
                    # this cannot deadlock even at max_inflight=1)
                    self._slots.acquire()
                t0 = time.monotonic()
                if trace.active() is not None:
                    trace.add_span("batch.pending", t_pop, t0,
                                   rids=[r.rid for r in seg])
                try:
                    handle = self._engine_dispatch(seg)
                except Exception as e:   # fail or bisect, keep serving
                    self._dispatch_failed(seg, e)
                    continue
                t_disp = time.monotonic()
                with self._inflight_lock:
                    self._dispatched += 1
                    depth = self._dispatched
                if self.metrics is not None:
                    self.metrics.record_dispatch(t_disp - t0,
                                                 inflight=depth)
                self._handles.put((seg, handle, t_disp))

    def _dispatch_failed(self, seg: list[_Request], e: Exception) -> None:
        """A segment raised at dispatch. Without bisection (no policy,
        bisect off, a single-request segment, or a systemic 503 such as
        NoLiveModel) the whole segment fails. With it the segment is
        retried as recursively split halves: a poison request re-fails
        every sub-dispatch that holds it, so the recursion fails only the
        culprit's singleton while every cohort-mate's sub-segment
        dispatches clean, in a bucket already on the ladder.

        Accounting: the segment holds one in-flight count and one window
        slot. The first sub-segment that dispatches inherits them, each
        further one acquires its own; if none dispatches, they are
        released here. Failures are blamed on the live version for the
        breaker (no handle exists to name the one that failed)."""
        res = self.resilience
        systemic = getattr(e, "status", None) == 503
        bisect = (res is not None and res.bisect and len(seg) > 1
                  and not systemic)
        ndups = sum(len(r.dups) for r in seg)
        if not bisect:
            if self.metrics is not None:
                if (not systemic and res is not None and res.bisect
                        and len(seg) == 1):
                    # a singleton failing at dispatch IS an isolated
                    # culprit; its riders fail as plain dispatch errors
                    self.metrics.record_isolated_culprit(seg[0].n, ndups)
                else:
                    self.metrics.record_dispatch_error(len(seg) + ndups)
            for r in seg:
                self._fail_fanout(r, e)
            if res is not None and not systemic:
                res.record_outcome(self._live_version(), ok=False,
                                   n=len(seg))
            with self._inflight_lock:
                self._inflight -= 1
            self._slots.release()
            return
        if self.metrics is not None:
            self.metrics.record_bisect_split()
        mid = len(seg) // 2
        t_split = time.monotonic()
        trace.add_span("bisect.split", t_split, t_split,
                       rids=[r.rid for r in seg],
                       into=[mid, len(seg) - mid])
        pending: deque = deque([seg[:mid], seg[mid:]])
        enqueued = 0
        while pending:
            sub = pending.popleft()
            sub_err = None
            sp = trace.begin_span("bisect.dispatch",
                                  rids=self._span_rids(sub),
                                  rows=sum(r.n for r in sub))
            try:
                handle = self._engine_dispatch(sub)
            except Exception as se:
                sub_err = se
                handle = None
            finally:
                trace.end_span(sp, error=(type(sub_err).__name__
                                          if sub_err is not None
                                          else None))
            if sub_err is not None:
                if len(sub) == 1:
                    if self.metrics is not None:
                        self.metrics.record_isolated_culprit(
                            sub[0].n, len(sub[0].dups))
                    self._fail_fanout(sub[0], sub_err)
                    if res is not None:
                        res.record_outcome(self._live_version(), ok=False)
                else:
                    if self.metrics is not None:
                        self.metrics.record_bisect_split()
                    m = len(sub) // 2
                    t_split = time.monotonic()
                    trace.add_span("bisect.split", t_split, t_split,
                                   rids=[r.rid for r in sub],
                                   into=[m, len(sub) - m])
                    # left half first: FIFO order holds across the
                    # completion thread's in-order fetches
                    pending.appendleft(sub[m:])
                    pending.appendleft(sub[:m])
                continue
            if enqueued:
                self._slots.acquire()
                with self._inflight_lock:
                    self._inflight += 1
            with self._inflight_lock:
                self._dispatched += 1
            if self.metrics is not None:
                self.metrics.record_bisect_rescued(
                    len(sub), sum(r.n for r in sub))
            self._handles.put((sub, handle, time.monotonic()))
            enqueued += 1
        if not enqueued:
            with self._inflight_lock:
                self._inflight -= 1
            self._slots.release()

    def _completion_loop(self) -> None:
        while True:
            item = self._handles.get()
            if item is None:
                return
            batch, handle, t_disp = item
            t0 = time.monotonic()
            rids = self._span_rids(batch)
            # the dispatched-but-unfetched window, from stamps both
            # threads hold, so no span crosses the thread hop open
            trace.add_span("engine.enqueued", t_disp, t0, rids=rids,
                           tid="inflight-window", bucket=handle.bucket)
            sp = trace.begin_span("engine.fetch", rids=rids,
                                  bucket=handle.bucket)
            try:
                logits = self.engine.fetch(handle)
            except Exception as e:   # fan the failure out, keep serving
                trace.end_span(sp, error=type(e).__name__)
                for r in batch:
                    self._fail_fanout(r, e)
                if self.metrics is not None:
                    self.metrics.record_fetch_error(
                        sum(1 + len(r.dups) for r in batch))
                if self.resilience is not None:
                    # the handle names the version that failed
                    self.resilience.record_outcome(
                        getattr(handle, "version", None), ok=False,
                        n=len(batch))
                with self._inflight_lock:
                    self._inflight -= 1
                    self._dispatched -= 1
                self._slots.release()
                continue
            finally:
                trace.end_span(sp)
            t_done = time.monotonic()
            version = getattr(handle, "version", None)
            if self.resilience is not None:
                self.resilience.record_outcome(version, ok=True,
                                               n=len(batch))
            if self.controller is not None:
                for r in batch:
                    self.controller.on_latency(t_done - r.t_enqueue)
                    for d in r.dups:
                        self.controller.on_latency(t_done - d.t_enqueue)
            off = 0
            for r in batch:
                # which version computed this request rides the future,
                # set (and the trace finished) before the result, so a
                # waiter sees all three
                r.future.version = version
                trace.add_span("batch.fanout", t_done, time.monotonic(),
                               rids=(r.rid,))
                self._finish_trace(r)
                r.future.set_result(logits[off:off + r.n])
                # riders get their OWN copy: they alias the same rows
                for d in r.dups:
                    d.future.version = version
                    trace.add_span("batch.fanout", t_done,
                                   time.monotonic(), rids=(d.rid,))
                    self._finish_trace(d)
                    d.future.set_result(logits[off:off + r.n].copy())
                off += r.n
            if self.metrics is not None:
                # one record for the batch and all its requests, riders
                # included: a reset() window never splits them. The
                # replica tag names the replica that COMPUTED the batch:
                # after a failover, the sibling
                self.metrics.record_served(
                    t_done - t0, rows=sum(r.n for r in batch),
                    bucket=handle.bucket, queue_depth=self.pending_rows(),
                    latencies=[(t_done - q.t_enqueue, q.n)
                               for r in batch for q in (r, *r.dups)],
                    version=version,
                    replica=getattr(handle, "replica", None),
                    infer_dtype=getattr(handle, "infer_dtype", None))
            # a batch leaves the in-flight count only after its futures
            # resolved and its metrics landed (the drain invariant)
            with self._inflight_lock:
                self._inflight -= 1
                self._dispatched -= 1
            self._slots.release()
