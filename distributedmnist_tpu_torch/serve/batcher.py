"""Dynamic micro-batcher: coalesce concurrent requests into engine-sized
batches, pipelined through a bounded in-flight window, with bounded-queue
backpressure (the core of the JAX package's serve/batcher.py).

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

Not ported yet: intra-batch dedup, the single-request fast lane,
bisection of a failed dispatch, fault injection and tracing. A failed
dispatch or fetch fails its whole segment and serving goes on.
"""

from __future__ import annotations

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
from distributedmnist_tpu_torch.serve.resilience import DeadlineExceeded
from distributedmnist_tpu_torch.serve.scheduler import (AdaptiveController,
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
    deadline: Optional[float] = None   # time.monotonic(); None = none
    future: Future = field(default_factory=Future)


class DynamicBatcher:
    """Dispatch + completion threads over a bounded request queue.

    start()/stop() manage the threads; submit(x) -> Future resolving to
    the request's (n, 10) logits. Dispatches run on the one dispatch
    thread and fetches on the one completion thread, in dispatch order,
    so results never reorder across batches."""

    def __init__(self, engine, max_batch: Optional[int] = None,
                 max_wait_us: int = 1000, queue_depth: int = 4096,
                 metrics=None, max_inflight: Optional[int] = None,
                 slo_ms: Optional[float] = None, adaptive: bool = True,
                 split: bool = True):
        self.engine = engine
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
        self.max_inflight = resolve_max_inflight(
            max_inflight, getattr(engine, "platform", "cpu"))
        self._q: deque[_Request] = deque()
        self._rows = 0                   # pending rows, watermark basis
        self._cond = make_condition("batcher.queue")
        self._stop = False
        # The in-flight window: a slot is held from the moment a batch is
        # popped until its results have fanned out.
        self._slots = make_semaphore("batcher.inflight_slots",
                                     self.max_inflight)
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

    def submit(self, x, deadline_s: Optional[float] = None) -> Future:
        """Enqueue up to max_batch rows; the Future resolves to their
        logits. Raises Rejected past the queue watermark, ValueError for
        a request no single dispatch could carry, and DeadlineExceeded
        when `deadline_s` (a time.monotonic() deadline) has passed
        already: an expired request costs no queue or device work. A
        live deadline rides the request; _take_batch sheds it if it
        expires while queued."""
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
        req = _Request(x=x, n=n, t_enqueue=now, deadline=deadline_s)
        with self._cond:
            if self._stop:
                raise RuntimeError("batcher is stopped")
            if self._rows + n > self.queue_depth:
                if self.metrics is not None:
                    self.metrics.record_reject(n)
                raise Rejected(
                    f"queue at {self._rows} pending rows; watermark "
                    f"{self.queue_depth} would be exceeded by {n} more")
            self._q.append(req)
            self._rows += n
            self._cond.notify_all()
        if self.controller is not None:
            self.controller.on_arrival(n, now=req.t_enqueue)
        return req.future

    def pending_rows(self) -> int:
        with self._cond:
            return self._rows

    def inflight_batches(self) -> int:
        """Segments popped off the queue whose futures have not all
        resolved: pending_rows()==0 and inflight_batches()==0 together
        mean fully drained."""
        with self._inflight_lock:
            return self._inflight

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
            if not drain:
                while self._q:
                    req = self._q.popleft()
                    self._rows -= req.n
                    dropped.append(req)
            self._cond.notify_all()
        # futures resolve outside the queue lock: their callbacks run
        # inline and must never run under it
        for req in dropped:
            req.future.set_exception(RuntimeError("batcher stopped"))
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
        outside the queue lock: a future's callbacks run inline."""
        for req, t_shed in shed:
            if self.metrics is not None:
                self.metrics.record_deadline_shed(req.n)
            req.future.set_exception(DeadlineExceeded(
                "deadline expired while queued "
                f"({(t_shed - req.deadline) * 1e3:.1f} ms past); "
                "shed before dispatch"))

    def _take_batch_locked(self) -> tuple:
        """One coalesce-pop-plan cycle under self._cond: (segments, shed),
        segments None when everything popped was shed, shed the
        (request, pop time) pairs the caller fails once the lock drops."""
        shed: list = []
        while not self._q and not self._stop:
            self._cond.wait(0.1)
        if not self._q:
            return [], shed
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
        while self._q and taken + self._q[0].n <= self.max_batch:
            req = self._q.popleft()
            self._rows -= req.n
            if req.deadline is not None and now >= req.deadline:
                shed.append((req, now))
                continue
            taken += req.n
            batch.append(req)
        if not batch:
            return None, shed
        segments = self._plan(batch)
        with self._inflight_lock:
            self._inflight += len(segments)
        return segments, shed

    def _plan(self, batch: list[_Request]) -> list[list[_Request]]:
        """The batch former: cut one drain into bucket-shaped segments by
        the engine's measured cost table; one segment without a table or
        with split=False."""
        counts = [len(batch)]
        if self.split and len(batch) > 1:
            costs = self.engine.bucket_costs()
            if costs:
                counts = plan_segments([r.n for r in batch],
                                       self.engine.buckets, costs)
        segments = []
        off = 0
        for c in counts:
            segments.append(batch[off:off + c])
            off += c
        return segments

    def _dispatch_loop(self) -> None:
        while True:
            with self._cond:
                while not self._q and not self._stop:
                    self._cond.wait(0.1)
                if not self._q:
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
            for i, seg in enumerate(segments):
                if i:
                    # later segments of a split drain hold their own slot
                    # (the completion thread frees slots as it drains, so
                    # this cannot deadlock even at max_inflight=1)
                    self._slots.acquire()
                t0 = time.monotonic()
                try:
                    handle = self.engine.dispatch([r.x for r in seg])
                except Exception as e:   # fail the segment, keep serving
                    self._dispatch_failed(seg, e)
                    continue
                t_disp = time.monotonic()
                with self._inflight_lock:
                    self._dispatched += 1
                    depth = self._dispatched
                if self.metrics is not None:
                    self.metrics.record_dispatch(t_disp - t0,
                                                 inflight=depth)
                self._handles.put((seg, handle))

    def _dispatch_failed(self, seg: list[_Request], e: Exception) -> None:
        """A segment raised at dispatch: fail every request of it, then
        release its in-flight count and window slot."""
        if self.metrics is not None:
            self.metrics.record_dispatch_error(len(seg))
        for r in seg:
            r.future.set_exception(e)
        with self._inflight_lock:
            self._inflight -= 1
        self._slots.release()

    def _completion_loop(self) -> None:
        while True:
            item = self._handles.get()
            if item is None:
                return
            batch, handle = item
            t0 = time.monotonic()
            try:
                logits = self.engine.fetch(handle)
            except Exception as e:   # fan the failure out, keep serving
                for r in batch:
                    r.future.set_exception(e)
                if self.metrics is not None:
                    self.metrics.record_fetch_error(len(batch))
                with self._inflight_lock:
                    self._inflight -= 1
                    self._dispatched -= 1
                self._slots.release()
                continue
            t_done = time.monotonic()
            version = getattr(handle, "version", None)
            if self.controller is not None:
                for r in batch:
                    self.controller.on_latency(t_done - r.t_enqueue)
            off = 0
            for r in batch:
                # which version computed this request rides the future,
                # set before the result so a waiter sees both
                r.future.version = version
                r.future.set_result(logits[off:off + r.n])
                off += r.n
            if self.metrics is not None:
                self.metrics.record_fetch(t_done - t0)
                self.metrics.record_batch(
                    rows=sum(r.n for r in batch), bucket=handle.bucket,
                    queue_depth=self.pending_rows(), version=version,
                    infer_dtype=getattr(handle, "infer_dtype", None))
                for r in batch:
                    self.metrics.record_latency(t_done - r.t_enqueue,
                                                rows=r.n, version=version)
            # a batch leaves the in-flight count only after its futures
            # resolved and its metrics landed (the drain invariant)
            with self._inflight_lock:
                self._inflight -= 1
                self._dispatched -= 1
            self._slots.release()
