"""The prediction cache and single-flight collapse: the content-hash
front layer of the serving stack (the port of the JAX package's
serve/cache.py, same names, keys and counters).

1. **PredictionCache**: a bounded LRU keyed by `(live version,
   infer_dtype, rows, sha256(input bytes))` — the bytes of the uint8
   image in C order, shape (n, 28, 28, 1), as the JAX package hashes
   them. A hit costs one hash and one dict lookup: no queue, no staging,
   no dispatch. Entries record the version that computed them and are
   re-checked at read; the registry invalidates the whole cache on every
   live-route change (promote, rollback, dtype activation, demotion),
   and an epoch stamp drops any in-flight insert that raced it. Entries
   expire by monotonic age past `ttl_s`.
2. **CacheFront**: concurrent identical misses share ONE computation.
   The first (the leader) dispatches through the batcher; followers park
   on its flight and resolve from its bytes. A leader failure fails
   every follower with the leader's error; errors are never cached.
3. **Intra-batch dedup** (`DynamicBatcher(dedup=True)`): identical rows
   inside one drain dispatch once and fan out.

A hit still records the metrics populations and a trace (`cache.lookup`
/ `cache.hit` spans); hit/miss/collapse/evict counters and the hit ratio
surface in /metrics, JSON and Prometheus. All cache state mutates under
one lock, never held across a submit, an engine call or a future's
resolution.
"""

from __future__ import annotations

import hashlib
import logging
import time
from collections import OrderedDict
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from distributedmnist_tpu_torch.analysis.locks import make_lock
from distributedmnist_tpu_torch.serve import trace
from distributedmnist_tpu_torch.serve.resilience import DeadlineExceeded

log = logging.getLogger("distributedmnist_tpu_torch")


def _pinned(route: Optional[str], tags: Optional[dict] = None) -> dict:
    """The batcher submit's route and tags arguments, only when a route
    is pinned or the tags carry attribution: a plain submit keeps the
    batcher's (x, deadline_s, key) shape."""
    extra = {"route": route} if route is not None else {}
    if tags:
        extra["tags"] = tags
    return extra


def content_key(version: Optional[str], infer_dtype: Optional[str],
                x: np.ndarray) -> tuple:
    """The cache key: (live version, serving precision, row count,
    sha256 of the canonical input bytes) — the faults.py content-hash
    idiom applied to request bytes. Version and dtype come from the
    CURRENT live route, so entries written under a demoted route are
    unreachable the instant a promote lands."""
    return (version, infer_dtype, int(x.shape[0]),
            hashlib.sha256(x.tobytes()).digest())


@dataclass
class _Entry:
    """One cached response: the logits bytes plus the identity of the
    engine set that computed them (checked again at read) and the
    monotonic insert stamp the TTL ages against."""

    logits: np.ndarray
    version: Optional[str]
    infer_dtype: Optional[str]
    t_insert: float = 0.0


@dataclass
class _Follower:
    """One collapsed request parked on a flight: resolved from the
    leader's bytes (or failed with the leader's error) by the leader's
    done-callback."""

    rid: int
    trace_id: Optional[str]
    future: Future
    t0: float
    rows: int


@dataclass
class _Flight:
    """One in-flight computation shared by all concurrent identical
    misses. The leader's batcher future drives it; followers accumulate
    under the cache lock and are fanned out when the leader resolves."""

    key: tuple
    version: Optional[str]
    infer_dtype: Optional[str]
    epoch: int
    followers: list = field(default_factory=list)


class PredictionCache:
    """Bounded LRU response cache with invalidation epochs.

    Thread-safe; every mutation of `_entries`/`_flights` happens under
    the named `cache.state` lock. `invalidate()` is the registry hook: promote,
    rollback and dtype activation call it atomically with the routing
    swap, clearing every entry and bumping the epoch so in-flight
    single-flight inserts that raced the swap are dropped, not cached.
    """

    def __init__(self, capacity: int = 4096,
                 ttl_s: Optional[float] = None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        if ttl_s is not None and ttl_s <= 0:
            raise ValueError(f"ttl_s must be > 0, got {ttl_s}")
        self.capacity = capacity
        # Bounded staleness: entries expire by MONOTONIC age — a
        # wall-clock step must never mass-expire (or immortalize) the
        # cache. An expired entry is dropped at lookup time and the
        # lookup counts as a miss; None = no TTL.
        self.ttl_s = ttl_s
        self._lock = make_lock("cache.state")
        self._entries: "OrderedDict[tuple, _Entry]" = OrderedDict()
        self._flights: dict[tuple, _Flight] = {}
        self._epoch = 0
        self._hits = 0
        self._hit_rows = 0
        self._misses = 0
        self._collapsed = 0
        self._inserts = 0
        self._evictions = 0
        self._invalidations = 0
        self._stale_drops = 0
        self._expired = 0

    def _expired_locked(self, entry: _Entry, now: float) -> bool:
        """Caller holds the lock: True (and counted) when the entry
        has aged past the TTL."""
        if self.ttl_s is None or now - entry.t_insert <= self.ttl_s:
            return False
        self._expired += 1
        return True

    # -- direct surface (unit tests, simple callers) -----------------------

    def lookup(self, key: tuple) -> Optional[np.ndarray]:
        """LRU lookup; returns a copy of the cached logits or None.
        The entry's recorded computing version is re-checked against
        the key's version (captured at insert, checked at read): a
        mismatched entry is dropped and counted, never served."""
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                self._misses += 1
                return None
            if self._expired_locked(entry, time.monotonic()):
                # aged past the TTL: dropped, counted, recomputed —
                # an expired hit IS a miss
                del self._entries[key]
                self._misses += 1
                return None
            if entry.version != key[0] or entry.infer_dtype != key[1]:
                # defense in depth: the key embeds (version, dtype), so
                # this can only fire on a corrupted insert — but a
                # stale byte served once is worse than a dropped entry
                del self._entries[key]
                self._stale_drops += 1
                self._misses += 1
                return None
            self._entries.move_to_end(key)
            self._hits += 1
            self._hit_rows += entry.logits.shape[0]
            return np.array(entry.logits)

    def probe(self, key: tuple) -> Optional[np.ndarray]:
        """Shed-path lookup: the tenancy layer consults the cache before
        a quota or watermark shed, since a hit costs no device work. A
        hit counts (and refreshes LRU recency) exactly like lookup's; a
        miss counts nothing, so it does not dilute the hit ratio."""
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                return None
            if self._expired_locked(entry, time.monotonic()):
                del self._entries[key]
                return None
            if entry.version != key[0] or entry.infer_dtype != key[1]:
                del self._entries[key]
                self._stale_drops += 1
                return None
            self._entries.move_to_end(key)
            self._hits += 1
            self._hit_rows += entry.logits.shape[0]
            return np.array(entry.logits)

    def insert(self, key: tuple, logits: np.ndarray,
               computed_version: Optional[str],
               computed_dtype: Optional[str],
               epoch: Optional[int] = None) -> bool:
        """Insert a computed response. Refused (False, counted) when
        the COMPUTING version/dtype differ from the key's — a canary
        result or a mid-promote race must never be served as the live
        answer — or when `epoch` predates an invalidation."""
        with self._lock:
            if epoch is not None and epoch != self._epoch:
                self._stale_drops += 1
                return False
            if computed_version != key[0] or computed_dtype != key[1]:
                self._stale_drops += 1
                return False
            self._entries[key] = _Entry(
                np.array(logits, copy=True), computed_version,
                computed_dtype, t_insert=time.monotonic())
            self._entries.move_to_end(key)
            self._inserts += 1
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)
                self._evictions += 1
            return True

    def invalidate(self, reason: Optional[str] = None) -> None:
        """Drop every entry and bump the epoch (the registry's
        live-route-change hook). In-flight single-flight leaders keep
        computing — their followers still resolve — but their inserts
        are refused by the epoch check."""
        with self._lock:
            dropped = len(self._entries)
            self._entries.clear()
            self._epoch += 1
            self._invalidations += 1
        if dropped or reason:
            log.info("prediction cache invalidated (%s): %d entries "
                     "dropped", reason or "unspecified", dropped)

    def epoch(self) -> int:
        with self._lock:
            return self._epoch

    def flights(self) -> int:
        """In-flight single-flight computations (leader dispatched,
        not yet resolved)."""
        with self._lock:
            return len(self._flights)

    def stats(self) -> dict:
        """The counters `/metrics` exposes (JSON `cache` block; the
        Prometheus exposition flattens the same dict)."""
        with self._lock:
            lookups = self._hits + self._misses
            return {
                "capacity": self.capacity,
                "ttl_s": self.ttl_s,
                "expired": self._expired,
                "entries": len(self._entries),
                "inflight_keys": len(self._flights),
                "hits": self._hits,
                "hit_rows": self._hit_rows,
                "misses": self._misses,
                "collapsed": self._collapsed,
                "inserts": self._inserts,
                "evictions": self._evictions,
                "invalidations": self._invalidations,
                "stale_drops": self._stale_drops,
                "epoch": self._epoch,
                "hit_ratio": (round(self._hits / lookups, 4)
                              if lookups else None),
            }


class CacheFront:
    """The submit()-shaped front layer: cache lookup + single-flight
    collapse in front of a DynamicBatcher.

    Duck-types the batcher's client surface (`submit` returning a
    Future with `.version`/`.trace_id` attributes, `pending_rows`,
    `inflight_batches`, `stop`), so the HTTP handler and the
    bench drive it unchanged. With no live version (server warming) it
    passes straight through — the batcher's NoLiveModel 503 semantics
    are preserved, nothing is keyed on a route that does not exist.
    """

    def __init__(self, batcher, router, cache: PredictionCache,
                 metrics=None):
        self.batcher = batcher
        self.router = router
        self.cache = cache
        self.metrics = metrics

    # -- batcher-surface proxies (bench drain predicate, stop) -------------

    def pending_rows(self) -> int:
        return self.batcher.pending_rows()

    def inflight_batches(self) -> int:
        return self.batcher.inflight_batches()

    def stop(self, drain: bool = True) -> None:
        self.batcher.stop(drain=drain)

    # -- the front door ----------------------------------------------------

    def _live_route(self) -> tuple:
        """(live version, live infer_dtype) read atomically where the
        router supports it (one lock crossing — two separate reads
        could interleave with a promote and key a mixed route)."""
        fn = getattr(self.router, "live_route", None)
        if callable(fn):
            return fn()
        return (self.router.live_version(),
                getattr(self.router, "live_infer_dtype",
                        lambda: None)())

    def submit(self, x, deadline_s: Optional[float] = None,
               route: Optional[str] = None,
               route_label: Optional[str] = None,
               tags: Optional[dict] = None) -> Future:
        """Cache-or-collapse-or-dispatch. Returns a Future resolving to
        the request's (n, 10) logits:

        - **hit**: already resolved, version-tagged, trace finished
          (cache.lookup + cache.hit spans; X-Trace-Id rides the future
          exactly like a computed response) — sub-millisecond, zero
          device work;
        - **collapsed miss**: parked on the identical in-flight
          leader's flight, resolved (or failed) with the leader;
        - **leading miss**: dispatched through the batcher as usual
          (the batcher owns its trace), with the result cached on
          completion unless the computing version no longer matches.

        `route` pins the dispatch to a named infer_dtype (the cascade's
        stage requests); `route_label` (the route by default) replaces
        the live dtype in the key, so a pinned stage's bytes are keyed,
        and only ever served, under the precision that computed them.
        `tags` (the tenancy layer's attribution) pass through to the
        batcher for a leading miss; hits and collapsed followers never
        reach a queue, so they carry none.
        """
        x = self.router._as_images(x)
        n = x.shape[0]
        t0 = time.monotonic()
        if deadline_s is not None and t0 >= deadline_s:
            # mirror the batcher's shed-at-submit contract: an expired
            # request costs nothing, not even a hash
            if self.metrics is not None:
                self.metrics.record_deadline_shed(n)
            raise DeadlineExceeded(
                "deadline already expired at submit "
                f"({(t0 - deadline_s) * 1e3:.1f} ms ago)")
        version, infer_dtype = self._live_route()
        if version is None:
            # warming / drained of versions: nothing to key on; the
            # pipeline's NoLiveModel 503 path is authoritative
            return self.batcher.submit(x, deadline_s=deadline_s,
                                       **_pinned(route, tags))
        if route_label is None:
            route_label = route
        if route_label is not None:
            infer_dtype = route_label
        key = content_key(version, infer_dtype, x)
        cache = self.cache
        tr = trace.active()
        hit: Optional[_Entry] = None
        flight: Optional[_Flight] = None
        follower: Optional[_Follower] = None
        leading = False
        with cache._lock:
            entry = cache._entries.get(key)
            if (entry is not None
                    and cache._expired_locked(entry, time.monotonic())):
                # aged past the TTL: drop and
                # fall through to the miss path — the next identical
                # request recomputes under single-flight as usual
                del cache._entries[key]
                entry = None
            if entry is not None and entry.version == version \
                    and entry.infer_dtype == infer_dtype:
                cache._entries.move_to_end(key)
                cache._hits += 1
                cache._hit_rows += n
                hit = entry
            else:
                if entry is not None:
                    # version/dtype mismatch inside a matching key:
                    # corrupted insert — drop, never serve (checked at
                    # read, the invalidation-race backstop)
                    del cache._entries[key]
                    cache._stale_drops += 1
                cache._misses += 1
                flight = cache._flights.get(key)
                if flight is not None:
                    # Follower registration happens UNDER the cache
                    # lock, and the leader's done-callback pops the
                    # flight under the same lock — a registered
                    # follower can therefore never be skipped, and its
                    # trace is open before the leader could finish it.
                    cache._collapsed += 1
                    rid = self.batcher.next_rid()
                    fut: Future = Future()
                    tid = (tr.start_request(rid, rows=n,
                                            deadline_s=deadline_s,
                                            t0=t0)
                           if tr is not None else None)
                    fut.trace_id = tid
                    # Collapsed-follower marker: harnesses that audit
                    # per-request outcomes (the chaos leg's poison-
                    # isolation ledger) must be able to tell
                    # a leader's failure from its followers' echoes of
                    # the same error — one injected fault, one rid,
                    # N futures.
                    fut.collapsed = True
                    follower = _Follower(rid, tid, fut, t0, n)
                    flight.followers.append(follower)
                    # span recorded UNDER the lock, like the trace
                    # start above: once the lock drops the leader's
                    # done-callback may finish this trace, and a span
                    # added after the finish would be silently dropped
                    trace.add_span("cache.lookup", t0,
                                   time.monotonic(), rids=(rid,),
                                   collapsed=True)
                else:
                    flight = _Flight(key, version, infer_dtype,
                                     cache._epoch)
                    cache._flights[key] = flight
                    leading = True
        if hit is not None:
            return self._resolve_hit(hit, n, t0, deadline_s)
        if not leading:
            return follower.future
        return self._lead(flight, x, deadline_s, route, tags)

    def _resolve_hit(self, entry: _Entry, n: int, t0: float,
                     deadline_s: Optional[float]) -> Future:
        """Build the already-resolved Future for a cache hit, with the
        full observability a computed response gets: metrics
        populations (per-version AND per-dtype — a hit must never
        silently skip accounting), a finished trace whose id rides the
        future (X-Trace-Id), and an over-SLO hit landing in the
        tracer's exemplar ring like any other slow request."""
        tr = trace.active()
        tid = None
        if tr is not None:
            rid = self.batcher.next_rid()
            tid = tr.start_request(rid, rows=n, deadline_s=deadline_s,
                                   t0=t0)
            now = time.monotonic()
            tr.add_span("cache.lookup", t0, now, rids=(rid,))
            tr.add_span("cache.hit", now, now, rids=(rid,),
                        version=entry.version,
                        infer_dtype=entry.infer_dtype)
            tr.finish_request(rid)
        if self.metrics is not None:
            self.metrics.record_cache_hit(
                time.monotonic() - t0, rows=n, version=entry.version,
                infer_dtype=entry.infer_dtype)
        fut: Future = Future()
        fut.trace_id = tid
        fut.version = entry.version
        fut.cache_hit = True        # outcome-audit marker (chaos leg)
        fut.set_result(np.array(entry.logits))
        return fut

    def _lead(self, flight: _Flight, x, deadline_s,
              route: Optional[str] = None,
              tags: Optional[dict] = None) -> Future:
        """Dispatch the leader through the batcher. The leader's OWN
        future is the batcher's (its trace, version tag and error
        semantics are untouched); the flight resolves from it."""
        try:
            bf = self.batcher.submit(x, deadline_s=deadline_s,
                                     key=flight.key[3],
                                     **_pinned(route, tags))
        except BaseException as e:
            # Rejected / DeadlineExceeded / stopped batcher: the flight
            # never got a computation — followers that slipped in
            # between registration and here fail with the same error.
            self._fail_flight(flight, e)
            raise
        bf.add_done_callback(
            lambda done, fl=flight: self._flight_done(fl, done))
        return bf

    def _fail_flight(self, flight: _Flight, err: BaseException) -> None:
        cache = self.cache
        with cache._lock:
            cache._flights.pop(flight.key, None)
            followers = list(flight.followers)
            flight.followers.clear()
        self._fan_out(flight, followers, None, None, err)

    def _flight_done(self, flight: _Flight, bf: Future) -> None:
        """The leader resolved (completion thread, or inline for an
        already-done future): cache the bytes if they are still the
        live route's answer, then fan the flight's followers out —
        futures resolve OUTSIDE the cache lock."""
        err: Optional[BaseException] = None
        logits = None
        try:
            logits = bf.result()
        except BaseException as e:   # leader error: followers share it,
            err = e                  # nothing is ever cached
        computed_version = getattr(bf, "version", None)
        cache = self.cache
        with cache._lock:
            fl = cache._flights.pop(flight.key, None)
            followers = list(fl.followers) if fl is not None else []
            if fl is not None:
                fl.followers.clear()
        if err is None:
            # insert() re-checks the computing version against the
            # key's and the flight's epoch against the current one: a
            # promote/rollback/dtype-activation that raced this flight
            # (or a canary/mid-swap computation) is refused and counted
            # — the bytes still answer THESE requests, which were
            # admitted under the old route exactly like any in-flight
            # batch across a promote, but are never served to future
            # lookups.
            cache.insert(flight.key, logits, computed_version,
                         flight.key[1], epoch=flight.epoch)
        self._fan_out(flight, followers, logits, computed_version, err)

    def _fan_out(self, flight: _Flight, followers: list, logits,
                 computed_version,
                 err: Optional[BaseException]) -> None:
        """Resolve (or fail) every follower, finishing each trace
        BEFORE its future resolves — the Server-Timing contract the
        batcher keeps, kept here too. Each follower gets its OWN copy
        of the bytes (the cache's copy-on-hit discipline): one
        caller's in-place edit of its result must never corrupt a
        concurrent identical request's."""
        tr = trace.active()
        now = time.monotonic()
        for f in followers:
            try:
                if tr is not None and f.trace_id is not None:
                    tr.add_span("cache.collapse", f.t0, now,
                                rids=(f.rid,),
                                version=computed_version,
                                error=(type(err).__name__
                                       if err is not None else None))
                    tr.finish_request(f.rid, error=err)
                if err is not None:
                    f.future.set_exception(err)
                    continue
                if self.metrics is not None:
                    self.metrics.record_cache_hit(
                        now - f.t0, rows=f.rows,
                        version=computed_version,
                        infer_dtype=flight.key[1], collapsed=True)
                f.future.version = computed_version
                f.future.set_result(np.array(logits))
            except Exception:        # one bad follower must not strand
                log.exception("cache follower fan-out failed")


def build_cache_front(cfg, batcher, router, registry, metrics=None):
    """(front, cache) per Config: the CacheFront wired in front of the
    batcher with the registry's invalidation hook installed, or
    (batcher, None) when cfg.serve_cache is off — callers submit to
    whatever comes back."""
    if not cfg.serve_cache:
        return batcher, None
    cache = PredictionCache(cfg.serve_cache_capacity,
                            ttl_s=cfg.serve_cache_ttl_s)
    if hasattr(registry, "set_cache"):
        registry.set_cache(cache)
    return CacheFront(batcher, router, cache, metrics=metrics), cache
