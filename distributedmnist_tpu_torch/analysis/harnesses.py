"""Model-checking harnesses for the port's serve state machines, driven
by `analysis/explore.py`.

Each machine is a small closed world: the REAL serve component under
test (PredictionCache + CacheFront, ModelRegistry + Router,
DynamicBatcher, ReplicaSet, GlobalScheduler, Autoscaler) over pure
Python and numpy fakes for everything below it (no torch, no device
work — schedules must be cheap and deterministic), plus client/admin threads that drive the racy
operations and invariants checked at every quiescent step and at
drain. Every primitive the real components build goes through the
`analysis/locks.py` factories, so under an installed Controller the
whole machine is explorable with zero changes to the code under test.

The invariants are the machines' documented contracts:

- **cache**: no stale bytes surface (every cache entry's payload was
  computed in the route era that is still current for its version — an
  insert that crossed an invalidation must have been refused), no
  future left unresolved, the single-flight table empty at drain, and
  every resolved result's payload matches its future's version tag.
- **registry**: at quiescence exactly one version is 'live' and it is
  the router's live target; no routed version is ever evicted.
- **batcher**: every accepted future resolves, pending rows and the
  in-flight gauge return to zero, and the window semaphore's net
  acquire-release balance is zero at drain.
- **fleet**: no mixed-version pick window (all replicas agree on the
  live version whenever the pick lock is free), per-replica windows
  and outstanding cost return to zero, and replica faults are absorbed
  by failover (clients see results, not errors).

Planted mutations (the explorer's self-test — an explorer that cannot
find planted bugs is theater):

- ``mutation="skip-follower"`` drops the first single-flight follower
  registration (the "can a follower be skipped?" race, made
  real): the skipped follower's future never resolves, which the
  explorer reports as a deadlock/unresolved-future finding.
- ``mutation="drop-epoch-bump"`` makes invalidation clear entries
  without bumping the epoch: a leader that raced a promote/rollback
  pair lands stale bytes in the cache, violating the era invariant.
"""

from __future__ import annotations

import itertools
import types
from concurrent.futures import Future

import numpy as np

from distributedmnist_tpu_torch.analysis.locks import make_fifo, make_lock

# The smoke budget (the tests and chip_smoke.py run the CLI with --smoke):
# fixed seeds, this many schedules per machine — small enough to stay
# well under 30 s total, large enough to cross every interesting
# interleaving class at least once per run.
SMOKE_SCHEDULES = 25


def await_future(ctl, fut: Future, what: str = "future") -> None:
    """Cooperative future wait: a controller yield point parked on
    fut.done() — never fut.result() on an unresolved future, which
    would block the real thread outside the controller's model."""
    ctl.yield_point("future.wait", what, ready=fut.done)


def encode(version: str, era: int, rows: int) -> np.ndarray:
    """Version+era-stamped payload: logits whose every element encodes
    (version, route era) so stale bytes are OBSERVABLE, not just
    theorized — the harness twin of the bench's version-encoded-logits
    trick."""
    code = float(int(version.lstrip("v")) * 1000 + era)
    return np.full((rows, 10), code, dtype=np.float32)


def decode(arr: np.ndarray) -> tuple:
    code = int(arr.flat[0])
    return (f"v{code // 1000}", code % 1000)


# -- machine 1: cache single-flight vs promote/invalidation epoch ----------


class _Route:
    """Fake live route + promote: the (version, era) pair the cache
    keys on, mutated atomically with the cache invalidation under one
    state lock — the registry's `_route_set("live", ...)` shape. `era`
    increments on every promote (including re-promotes of an old
    version), so payload bytes can prove WHICH reign computed them."""

    def __init__(self):
        self._state_lock = make_lock("harness.route.state")
        self.version = "v1"
        self.era = 1
        self.era_of = {"v1": 1}

    @staticmethod
    def _as_images(x) -> np.ndarray:
        return np.asarray(x, dtype=np.uint8)

    def live_route(self) -> tuple:
        with self._state_lock:
            return (self.version, None)

    def live_version(self):
        with self._state_lock:
            return self.version

    def promote(self, version: str, cache) -> None:
        with self._state_lock:
            self.era += 1
            self.version = version
            self.era_of[version] = self.era
            cache.invalidate(reason=f"live -> {version}")


class _RouteBatcher:
    """Fake batcher under the CacheFront: submit() enqueues, a worker
    thread captures the live route (the engine-capture-at-dispatch
    model) and resolves the future — whose done-callback then runs the
    REAL single-flight completion inline, exactly like the production
    completion thread."""

    def __init__(self, route: _Route):
        self.route = route
        self._rid = itertools.count(1)
        self._q = make_fifo("harness.batcher.q")

    def next_rid(self) -> int:
        return next(self._rid)

    def submit(self, x, deadline_s=None, key=None, route=None,
               tags=None) -> Future:
        fut: Future = Future()
        fut.trace_id = None
        self._q.put((fut, int(x.shape[0])))
        return fut

    def worker(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            fut, rows = item
            with self.route._state_lock:
                v, era = self.route.version, self.route.era
            fut.version = v
            fut.set_result(encode(v, era, rows))


class _DropFirstAppend(list):
    """The skip-follower mutation's followers list: silently drops the
    first registration."""

    def __init__(self):
        super().__init__()
        self._dropped = False

    def append(self, item) -> None:
        if not self._dropped:
            self._dropped = True
            return
        super().append(item)


def _broken_invalidate(self, reason=None) -> None:
    """The drop-epoch-bump mutation: entries cleared, epoch NOT bumped
    — an in-flight single-flight insert that raced the invalidation now
    lands instead of being refused."""
    with self._lock:
        self._entries.clear()
        self._invalidations += 1


class CacheMachine:
    """Single-flight collapse vs promote/rollback invalidation epoch:
    3 clients hammer two key classes while a promoter rolls
    v1 -> v2 -> v1 (each roll invalidating atomically with the route
    swap) and a worker thread resolves leaders."""

    name = "cache"

    def __init__(self, mutation: str = None):
        self.mutation = mutation
        self.futs: list = []
        self.route = None
        self.cache = None

    def run(self, ctl) -> None:
        from distributedmnist_tpu_torch.serve import cache as cache_mod

        restore = None
        if self.mutation == "skip-follower":
            real = cache_mod._Flight

            def broken_flight(key, version, infer_dtype, epoch):
                fl = real(key, version, infer_dtype, epoch)
                fl.followers = _DropFirstAppend()
                return fl

            cache_mod._Flight = broken_flight
            restore = real
        try:
            self._run(ctl, cache_mod)
        finally:
            if restore is not None:
                cache_mod._Flight = restore

    def _run(self, ctl, cache_mod) -> None:
        self.route = route = _Route()
        self.cache = cache = cache_mod.PredictionCache(capacity=8)
        if self.mutation == "drop-epoch-bump":
            cache.invalidate = types.MethodType(_broken_invalidate,
                                                cache)
        batcher = _RouteBatcher(route)
        front = cache_mod.CacheFront(batcher, route, cache)
        hot = np.zeros((2, 4), np.uint8)      # shared hot key
        cold = np.ones((2, 4), np.uint8)

        def client(payload, k):
            def body():
                for _ in range(k):
                    self.futs.append(front.submit(payload))
            return body

        def promoter():
            route.promote("v2", cache)
            route.promote("v1", cache)

        threads = [
            ctl.spawn(client(hot, 2), "client-a"),
            ctl.spawn(client(hot, 2), "client-b"),
            ctl.spawn(client(cold, 1), "client-c"),
            ctl.spawn(promoter, "promoter"),
        ]
        worker = ctl.spawn(batcher.worker, "worker")
        for t in threads:
            t.join()
        for fut in list(self.futs):
            await_future(ctl, fut, "client-result")
        batcher._q.put(None)
        worker.join()

    def invariant(self, ctl) -> None:
        cache, route = self.cache, self.route
        if cache is None or route is None:
            return
        if not (ctl.lock_free("cache.state")
                and ctl.lock_free("harness.route.state")):
            return
        for key, entry in list(cache._entries.items()):
            assert (entry.version == key[0]
                    and entry.infer_dtype == key[1]), (
                f"cache entry/key identity mismatch: entry "
                f"({entry.version}, {entry.infer_dtype}) under key "
                f"({key[0]}, {key[1]})")
            v, era = decode(entry.logits)
            assert v == entry.version, (
                f"cache entry for {entry.version} holds bytes computed "
                f"by {v} — mixed-version bytes surfaced")
            current = route.era_of.get(v)
            assert era == current, (
                f"stale bytes cached: entry for {v} carries era {era} "
                f"but the route's current era for {v} is {current} — "
                "an insert crossed an invalidation (epoch bump "
                "dropped?)")

    def final(self, ctl) -> None:
        unresolved = [f for f in self.futs if not f.done()]
        assert not unresolved, (
            f"{len(unresolved)} submitted future(s) never resolved "
            "(skipped single-flight follower?)")
        assert not self.cache._flights, (
            "single-flight table not empty at drain: "
            f"{list(self.cache._flights)}")
        for fut in self.futs:
            v, era = decode(fut.result())
            assert v == fut.version, (
                f"result bytes from {v} tagged version {fut.version} — "
                "mixed-version response")
        self.invariant(ctl)


# -- machine 2: registry promote/rollback vs concurrent admin + eviction ---


class _RegEngine:
    """A warmed engine by fiat: compiles nothing, prices nothing —
    the registry's state machine is the subject, not the device."""

    def __init__(self, version: str, infer_dtype: str = "float32"):
        self.version = version
        self.infer_dtype = infer_dtype
        self.max_batch = 8
        self.buckets = (8,)
        self.params = None

    def warmup(self, cost_samples: int = 5) -> int:
        return 0

    def bucket_costs(self) -> dict:
        return {}

    def bucket_costs_p95(self) -> dict:
        return {}

    def infer(self, x) -> np.ndarray:
        return np.zeros((np.asarray(x).shape[0], 10), np.float32)


class _RegFactory:
    max_batch = 8
    buckets = (8,)
    model = "mlp"
    device = "cpu"          # describe() names it and its group
    devices = ("cpu",)

    def make_engine(self, params, version, replica: int = 0,
                    infer_dtype: str = "float32") -> _RegEngine:
        return _RegEngine(version, infer_dtype)


class RegistryMachine:
    """Real ModelRegistry + real Router over fiat-warmed engines:
    concurrent add/promote/canary/rollback/describe with eviction
    pressure (max_versions=3). The contract: one live version, the
    router always points at a resident one, routed versions are never
    evicted."""

    name = "registry"

    def __init__(self):
        self.reg = None
        self.router = None

    def run(self, ctl) -> None:
        from distributedmnist_tpu_torch.serve.registry import ModelRegistry
        from distributedmnist_tpu_torch.serve.router import Router

        self.router = router = Router(max_batch=8, buckets=(8,),
                                      platform="cpu")
        self.reg = reg = ModelRegistry(_RegFactory(), router,
                                       max_versions=3)
        reg.add(None, version="v1")
        reg.promote("v1")
        expected = (KeyError, RuntimeError, ValueError)

        def admin_a():
            try:
                reg.add(None, version="v2")
                reg.promote("v2")
            except expected:
                pass

        def admin_b():
            try:
                reg.add(None, version="v3")
                reg.set_canary("v3", fraction=0.2)
            except expected:
                pass
            reg.clear_candidates()

        def evictor():
            try:
                reg.add(None, version="v4")
            except expected:
                pass

        def roller():
            reg.rollback("v2", reason="model-checker drill")

        def reader():
            for _ in range(3):
                reg.describe()
                reg.live_version()

        threads = [ctl.spawn(admin_a, "admin-a"),
                   ctl.spawn(admin_b, "admin-b"),
                   ctl.spawn(evictor, "evictor"),
                   ctl.spawn(roller, "roller"),
                   ctl.spawn(reader, "reader")]
        for t in threads:
            t.join()

    def invariant(self, ctl) -> None:
        reg, router = self.reg, self.router
        if reg is None or router is None:
            return
        if not (ctl.lock_free("registry.admin")
                and ctl.lock_free("registry.state")
                and ctl.lock_free("router.routes")):
            return
        # Quiescent reads go straight at the state (the controller
        # thread is not a controlled task; taking the shadow locks from
        # here would corrupt their ownership model).
        versions = dict(reg._versions)
        live = [name for name, mv in versions.items()
                if mv.state == "live"]
        assert len(live) <= 1, f"multiple live versions: {live}"
        live_t = router._live
        if live_t is not None:
            mv = versions.get(live_t.version)
            assert mv is not None, (
                f"router live target {live_t.version!r} was evicted "
                "from the registry")
            assert mv.state == "live", (
                f"router serves {live_t.version!r} but registry marks "
                f"it {mv.state!r}")
        in_route = {t.version for t in (router._live, router._canary,
                                        router._shadow)
                    if t is not None}
        missing = in_route - set(versions)
        assert not missing, (
            f"routed version(s) {sorted(missing)} evicted while still "
            "in the routing table")

    def final(self, ctl) -> None:
        assert self.router._live is not None, "no live version at drain"
        self.invariant(ctl)


# -- machine 3: batcher submit/shed/drain vs stop --------------------------


class _BatEngine:
    """Engine-shaped fake under the real DynamicBatcher: instant
    dispatch/fetch, no cost table (single-segment plans)."""

    max_batch = 8
    buckets = (4, 8)
    platform = "cpu"
    version = "v1"

    @staticmethod
    def _as_images(x) -> np.ndarray:
        return np.asarray(x, dtype=np.uint8)

    def bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if b >= n:
                return b
        raise ValueError(f"batch of {n} exceeds {self.buckets[-1]}")

    def bucket_costs(self) -> dict:
        return {}

    def dispatch(self, parts):
        rows = sum(np.asarray(p).shape[0] for p in parts)
        return types.SimpleNamespace(
            n=rows, bucket=self.bucket_for(rows), version=self.version,
            logits=np.full((rows, 10), 7.0, np.float32))

    def fetch(self, handle) -> np.ndarray:
        return handle.logits


class BatcherMachine:
    """Real DynamicBatcher (dispatch + completion threads under the
    controller) vs concurrent submits, deadline sheds, queue-watermark
    rejects and a racing stop(). The contract: every accepted future
    resolves, nothing is stranded by stop, and the in-flight window
    semaphore nets zero."""

    name = "batcher"

    def __init__(self, drain: bool = True):
        self.drain = drain
        self.batcher = None
        self.futs: list = []
        self.refused: list = []

    def run(self, ctl) -> None:
        import time

        from distributedmnist_tpu_torch.serve.batcher import DynamicBatcher

        self.batcher = batcher = DynamicBatcher(
            _BatEngine(), max_batch=8, max_wait_us=1000, queue_depth=8,
            max_inflight=2, adaptive=False)
        batcher.start()

        def client(rows, use_deadline):
            def body():
                for _ in range(2):
                    try:
                        dl = (time.monotonic() + 0.002
                              if use_deadline else None)
                        self.futs.append(batcher.submit(
                            np.zeros((rows, 4), np.uint8),
                            deadline_s=dl))
                    except Exception as e:
                        # Rejected (watermark), DeadlineExceeded
                        # (expired at submit), RuntimeError (stopped)
                        self.refused.append(type(e).__name__)
            return body

        threads = [ctl.spawn(client(3, False), "client-a"),
                   ctl.spawn(client(2, True), "client-b"),
                   ctl.spawn(client(3, False), "client-c"),
                   ctl.spawn(lambda: batcher.stop(drain=self.drain),
                             "stopper")]
        for t in threads:
            t.join()
        batcher.stop(drain=True)       # idempotent second stop
        for fut in list(self.futs):
            await_future(ctl, fut, "client-result")

    def invariant(self, ctl) -> None:
        b = self.batcher
        if b is None:
            return
        if ctl.lock_free("batcher.inflight_gauge"):
            assert b._inflight >= 0, "in-flight count went negative"
            assert 0 <= b._dispatched <= b.max_inflight, (
                f"dispatched-but-unresolved {b._dispatched} outside "
                f"[0, {b.max_inflight}] — the window invariant")
        if ctl.lock_free("batcher.queue"):
            assert b._rows >= 0, "pending-row gauge went negative"

    def final(self, ctl) -> None:
        b = self.batcher
        unresolved = [f for f in self.futs if not f.done()]
        assert not unresolved, (
            f"{len(unresolved)} accepted future(s) never resolved "
            "across stop()")
        assert len(self.futs) + len(self.refused) == 6, (
            "client ops lost: "
            f"{len(self.futs)} futures + {len(self.refused)} refusals")
        assert b._rows == 0, f"pending rows {b._rows} at drain"
        assert b._inflight == 0 and b._dispatched == 0, (
            f"in-flight gauges nonzero at drain: {b._inflight}/"
            f"{b._dispatched}")
        balance = ctl.sem_balance.get("batcher.inflight_slots", 0)
        assert balance == 0, (
            f"window semaphore nets {balance:+d} at drain — a held "
            "slot no error path released")
        assert b._handles.empty(), "handle queue not drained"
        self.invariant(ctl)


# -- machine 4: fleet pick/failover/drain-rejoin ---------------------------


class _FleetRouter:
    """Per-replica router fake under the real ReplicaSet: version
    pointer under its own named lock, schedulable fetch faults, and a
    never-fetched-shaped handle so the abandoned-handle drain path
    (the fleet's staging-leak fix) is explored too."""

    def __init__(self, rid: str):
        self.replica = rid
        self.max_batch = 8
        self.buckets = (8,)
        self.platform = "cpu"
        self.n_chips = 1
        self._lock = make_lock(f"harness.fleet.{rid}")
        self._live = "v1"
        self.fail_fetches = 0
        self.dispatched = 0

    def set_live(self, engine, version: str) -> None:
        with self._lock:
            self._live = version

    def set_shadow(self, engine, version, fraction) -> None:
        pass

    def set_canary(self, engine, version, fraction) -> None:
        pass

    def clear_candidates(self) -> None:
        pass

    def live_version(self):
        with self._lock:
            return self._live

    def live_infer_dtype(self):
        return None

    def live_route(self) -> tuple:
        with self._lock:
            return (self._live, None)

    def routes(self) -> dict:
        with self._lock:
            return {"live": self._live, "canary": None, "shadow": None}

    def versions_in_route(self) -> set:
        with self._lock:
            return {self._live}

    def bucket_costs(self) -> dict:
        return {8: 0.001}

    def bucket_costs_p95(self) -> dict:
        return {}

    def dispatch(self, parts):
        rows = sum(np.asarray(p).shape[0] for p in parts)
        with self._lock:
            self.dispatched += 1
            v = self._live
        return types.SimpleNamespace(
            version=v, n=rows, bucket=8, infer_dtype=None,
            handle=types.SimpleNamespace(staging="pinned"))

    def fetch(self, rh) -> np.ndarray:
        fail = False
        with self._lock:
            if self.fail_fetches > 0:
                self.fail_fetches -= 1
                fail = True
        if fail:
            raise RuntimeError(
                f"injected fetch fault on {self.replica}")
        return np.zeros((rh.n, 10), np.float32)


class FleetMachine:
    """Real ReplicaSet over 2 fake replica routers: 3 dispatch/fetch
    workers vs injected replica-fetch faults (failover), an admin
    drain/rejoin cycle, and a fleet-wide version roll. The contract:
    no mixed-version pick window, windows/outstanding cost net zero,
    and replica faults cost latency, never client errors."""

    name = "fleet"

    def __init__(self):
        self.fleet = None
        self.routers = None
        self.errors: list = []
        self.results: list = []

    def run(self, ctl) -> None:
        from distributedmnist_tpu_torch.serve.fleet import ReplicaSet

        self.routers = [_FleetRouter("r0"), _FleetRouter("r1")]
        self.fleet = fleet = ReplicaSet(self.routers,
                                        per_replica_inflight=1)
        x = np.zeros((4, 28, 28, 1), np.uint8)

        def worker():
            for _ in range(2):
                try:
                    out = fleet.fetch(fleet.dispatch(x))
                    self.results.append(out.shape)
                except Exception as e:
                    self.errors.append(f"{type(e).__name__}: {e}")

        def failer():
            with self.routers[0]._lock:
                self.routers[0].fail_fetches = 2

        def admin():
            fleet.drain("r0")
            fleet.rejoin("r0")

        def roller():
            fleet.set_live([object(), object()], "v2")

        threads = [ctl.spawn(worker, "worker-a"),
                   ctl.spawn(worker, "worker-b"),
                   ctl.spawn(worker, "worker-c"),
                   ctl.spawn(failer, "failer"),
                   ctl.spawn(admin, "admin"),
                   ctl.spawn(roller, "roller")]
        for t in threads:
            t.join()

    def invariant(self, ctl) -> None:
        fleet = self.fleet
        if fleet is None:
            return
        if not ctl.lock_free("fleet.pick"):
            return
        live = {r._live for r in self.routers}
        assert len(live) == 1, (
            f"mixed-version pick window: replicas serve {sorted(live)}")
        for rep in fleet.replicas:
            assert rep.inflight >= 0, (
                f"replica {rep.rid} in-flight window went negative")
            assert rep.outstanding_s >= -1e-9, (
                f"replica {rep.rid} outstanding cost went negative")

    def final(self, ctl) -> None:
        assert not self.errors, (
            "replica faults leaked to clients instead of failing over: "
            f"{self.errors}")
        assert len(self.results) == 6, (
            f"lost client ops: {len(self.results)}/6 results")
        for rep in self.fleet.replicas:
            assert rep.inflight == 0, (
                f"replica {rep.rid} holds {rep.inflight} window "
                "slot(s) at drain")
            assert abs(rep.outstanding_s) < 1e-9, (
                f"replica {rep.rid} outstanding cost "
                f"{rep.outstanding_s} at drain")
        self.invariant(ctl)


class _FastEngine(_BatEngine):
    """_BatEngine plus a fast-lane route and double-dispatch
    accounting: every dispatched row is counted exactly once (fast or
    coalesced), so the machine can prove no request's rows ever
    dispatch twice across the two lanes."""

    def __init__(self):
        self._lock = make_lock("harness.fastengine")
        self.rows_dispatched = 0
        self.fast_dispatches = 0

    def dispatch(self, parts):
        h = super().dispatch(parts)
        with self._lock:
            self.rows_dispatched += h.n
        return h

    def dispatch_fast(self, x):
        x = np.asarray(x)
        with self._lock:
            self.rows_dispatched += x.shape[0]
            self.fast_dispatches += 1
        return types.SimpleNamespace(
            n=x.shape[0], bucket=self.bucket_for(x.shape[0]),
            version=self.version,
            logits=np.full((x.shape[0], 10), 7.0, np.float32))


class FastlaneBatcherMachine(BatcherMachine):
    """The bypass lane's concurrency contract: the real
    DynamicBatcher with fastlane=True at max_inflight=1 — the
    tightest window, where the lane and the dispatch thread compete
    for ONE slot — under racing submits and a racing stop(). Proven
    on every explored schedule: no deadlock (the explorer's own
    detector), every accepted future resolves exactly once, no
    request's rows dispatch twice across the two lanes, and the
    window semaphore nets zero (a lane that leaked its try-acquired
    slot would strand the dispatch thread forever)."""

    name = "batcher-fastlane"

    def run(self, ctl) -> None:
        import time

        from distributedmnist_tpu_torch.serve.batcher import DynamicBatcher

        self.engine = _FastEngine()
        self.batcher = batcher = DynamicBatcher(
            self.engine, max_batch=8, max_wait_us=1000, queue_depth=8,
            max_inflight=1, adaptive=False, fastlane=True)
        batcher.start()

        def client(rows, use_deadline):
            def body():
                for _ in range(2):
                    try:
                        dl = (time.monotonic() + 0.002
                              if use_deadline else None)
                        self.futs.append(batcher.submit(
                            np.zeros((rows, 4), np.uint8),
                            deadline_s=dl))
                    except Exception as e:
                        self.refused.append(type(e).__name__)
            return body

        threads = [ctl.spawn(client(3, False), "client-a"),
                   ctl.spawn(client(1, False), "client-b"),
                   ctl.spawn(client(2, True), "client-c"),
                   ctl.spawn(lambda: batcher.stop(drain=self.drain),
                             "stopper")]
        for t in threads:
            t.join()
        batcher.stop(drain=True)
        for fut in list(self.futs):
            await_future(ctl, fut, "client-result")

    def final(self, ctl) -> None:
        super().final(ctl)
        # No double dispatch: rows the engine saw == rows of futures
        # that resolved successfully (refusals and sheds never reach
        # the engine; a row dispatched by BOTH lanes would overshoot).
        served = sum(f.result().shape[0] for f in self.futs
                     if f.exception() is None)
        assert self.engine.rows_dispatched == served, (
            f"engine dispatched {self.engine.rows_dispatched} rows but "
            f"{served} rows resolved — a request dispatched twice "
            "(or was lost) across the lanes")


# -- machine 6: global scheduler WFQ/EDF fairness --------------------------


class _TenRouter:
    """Router-shaped fake under the real GlobalScheduler: always
    resident, empty cost table (dispatch pricing falls back to the
    default per-row estimate — deterministic, schedule-independent)."""

    @staticmethod
    def live_version():
        return "v1"

    @staticmethod
    def live_infer_dtype():
        return "float32"

    @staticmethod
    def bucket_costs():
        return {}

    @staticmethod
    def _as_images(x) -> np.ndarray:
        return np.asarray(x, dtype=np.uint8)


class _TenBatcher:
    """Inline-resolving per-model queue fake: submit() returns an
    already-resolved future (zero service time). The machine explores
    the SCHEDULER's interleavings — admission vs grant loop vs admin
    vs stop; the batcher's own races are BatcherMachine's job."""

    def __init__(self, name: str):
        self.name = name
        self.rows_forwarded = 0

    def submit(self, x, deadline_s=None, route=None, tags=None):
        arr = np.asarray(x)
        self.rows_forwarded += arr.shape[0]     # forward thread only
        fut: Future = Future()
        fut.set_result(np.zeros((arr.shape[0], 10), np.float32))
        return fut

    @staticmethod
    def pending_rows() -> int:
        return 0

    def stop(self, drain: bool = True) -> None:
        pass


class SchedulerWFQMachine:
    """Real GlobalScheduler (grant loop under the controller) over a
    two-model fake catalog: a light weight-2 tenant and a heavy
    bursty tenant racing concurrent submits, a live set_quota admin
    call, and a draining stop(). The contract: every accepted future
    resolves across stop, no client op is lost, per-tenant pending-row
    accounting always matches the queues' actual contents, and the
    DRR consecutive-skip starvation bound holds (bounded head-of-line
    blocking — also asserted inside every grant)."""

    name = "scheduler-wfq"
    OPS = 7          # 2 light + 3 heavy + 2 deadlined light

    def __init__(self):
        self.sched = None
        self.futs: list = []
        self.refused: list = []

    def run(self, ctl) -> None:
        import time

        from distributedmnist_tpu_torch.serve.tenancy import (CatalogEntry,
                                                        GlobalScheduler,
                                                        ModelCatalog,
                                                        SLOClass)

        catalog = ModelCatalog()
        for m in ("mlp", "lenet"):
            catalog.add(CatalogEntry(
                name=m, registry=None, router=_TenRouter(),
                factory=types.SimpleNamespace(max_batch=8,
                                              buckets=(4, 8),
                                              platform="cpu"),
                batcher=_TenBatcher(m)))
        tenants = {
            "light": SLOClass(name="light", weight=2.0),
            "heavy": SLOClass(name="heavy", weight=1.0,
                              model="lenet"),
        }
        # The clock is passed explicitly: GlobalScheduler's default
        # argument binds the real time.monotonic at import, which the
        # Controller's patched logical clock would never reach.
        self.sched = sched = GlobalScheduler(
            catalog, tenants, quantum_s=0.001, tenant_queue_rows=64,
            clock=ctl.now)
        sched.start()

        def client(tenant, rows, n_ops, use_deadline=False):
            def body():
                for _ in range(n_ops):
                    try:
                        dl = (time.monotonic() + 0.002
                              if use_deadline else None)
                        self.futs.append(sched.submit(
                            np.zeros((rows, 4), np.uint8),
                            tenant=tenant, deadline_s=dl))
                    except Exception as e:
                        # QuotaExceeded / Rejected (watermark) /
                        # DeadlineExceeded (expired at the door) /
                        # RuntimeError (stopped)
                        self.refused.append(type(e).__name__)
            return body

        threads = [
            ctl.spawn(client("light", 2, 2), "light"),
            ctl.spawn(client("heavy", 6, 3), "heavy-burst"),
            ctl.spawn(client("light", 1, 2, use_deadline=True),
                      "light-deadlined"),
            ctl.spawn(lambda: sched.set_quota("light", qps=1000.0,
                                              burst=64.0), "admin"),
        ]
        for t in threads:
            t.join()
        sched.stop(drain=True)
        for fut in list(self.futs):
            await_future(ctl, fut, "tenant-result")

    def invariant(self, ctl) -> None:
        s = self.sched
        if s is None:
            return
        if ctl.lock_free("tenancy.sched"):
            qrows: dict = {}
            for (t, _m), q in s._queues.items():
                qrows[t] = qrows.get(t, 0) + sum(r.n for r in q)
            for t, rows in s._pending_rows.items():
                assert rows >= 0, (
                    f"tenant {t} pending rows went negative: {rows}")
                assert qrows.get(t, 0) == rows, (
                    f"tenant {t} pending-row gauge {rows} disagrees "
                    f"with queue contents {qrows.get(t, 0)} — torn "
                    "admission/grant accounting")
            self._check_skip_bound(s)

    @staticmethod
    def _check_skip_bound(s) -> None:
        from distributedmnist_tpu_torch.serve import scheduler as policy

        if s._max_head_cost_s <= 0:
            return
        weights = [c.weight for c in s._classes.values()]
        bound = policy.drr_skip_bound(len(s._ring),
                                      s._max_head_cost_s,
                                      s.quantum_s, min(weights))
        assert s.max_skip_observed <= bound, (
            f"WFQ starvation: a tenant was passed over "
            f"{s.max_skip_observed} consecutive grants "
            f"(bound {bound})")

    def final(self, ctl) -> None:
        s = self.sched
        unresolved = [f for f in self.futs if not f.done()]
        assert not unresolved, (
            f"{len(unresolved)} admitted future(s) never resolved "
            "across stop(drain=True)")
        assert len(self.futs) + len(self.refused) == self.OPS, (
            "client ops lost: "
            f"{len(self.futs)} futures + {len(self.refused)} refusals "
            f"!= {self.OPS}")
        assert all(rows == 0 for rows in s._pending_rows.values()), (
            f"pending rows at drain: {s._pending_rows}")
        assert all(not q for q in s._queues.values()), (
            "non-empty tenant queue at drain")
        self._check_skip_bound(s)
        self.invariant(ctl)


# -- machine 7: autoscaler control loop ------------------------------------


class _ScaleRecorder:
    """Actuator-shaped fake under the real Autoscaler: records every
    scale_to target, applies the clamp a real actuator would, and can
    die exactly once mid-decision (`die_on_call` = index of the call
    that raises BEFORE applying — the worker-died-while-draining case).
    The entry/exit counters straddle the instrumented state lock, so if
    two actuations ever overlap there is a schedule where both callers
    sit inside scale_to at once and `overlaps` catches it."""

    kind = "fake"
    cost_basis = "fake-units"

    def __init__(self, floor: int, ceiling: int,
                 die_on_call: int = None):
        self.floor = floor
        self.ceiling = ceiling
        self._lock = make_lock("harness.asc.units")
        self._units = floor
        self.calls: list = []
        self.deaths = 0
        self._die_on_call = die_on_call
        self._in_flight = 0          # mutated only between yield points
        self.overlaps = 0

    def current(self) -> int:
        with self._lock:
            return self._units

    def scale_to(self, units: int) -> int:
        self._in_flight += 1
        if self._in_flight > 1:
            self.overlaps += 1
        try:
            with self._lock:
                n = len(self.calls)
                self.calls.append(units)
                if self._die_on_call is not None and n == self._die_on_call:
                    self.deaths += 1
                    raise RuntimeError(
                        "worker died mid-drain (injected)")
                self._units = min(max(units, self.floor), self.ceiling)
                return self._units
        finally:
            self._in_flight -= 1

    def capacity_rows_per_s(self, units: int):
        return 100.0 * min(max(units, 1), self.ceiling)

    def chip_fraction(self, units: int) -> float:
        return float(min(max(units, 1), self.ceiling))

    def close(self) -> None:
        pass


class _SignalBox:
    """Mutable saturation surface: the load-spike thread writes a
    pressure level, the control loop reads it through the same
    instrumented lock — every read is a yield point, so decisions can
    land on either side of a spike edge."""

    def __init__(self):
        self._lock = make_lock("harness.asc.signals")
        self._queue_frac = 0.0

    def set(self, frac: float) -> None:
        with self._lock:
            self._queue_frac = frac

    def read(self):
        from distributedmnist_tpu_torch.serve.autoscale import Signals

        with self._lock:
            return Signals(queue_frac=self._queue_frac,
                           inflight_frac=0.0, shed_delta=0)


class AutoscalerLoopMachine:
    """The REAL Autoscaler control loop over a recording
    fake actuator and a mutable signal box: the started loop thread
    races a load-spike thread (manual tick()s at pressure 1.0, then a
    drop to trough), a second trough thread, one injected mid-decision
    actuator death, and a racing stop(). The contract: no deadlock
    (the explorer's own detector), actuations NEVER overlap (the admin
    lock serializes manual ticks against the loop), every target the
    loop hands the actuator and every achieved scale stays inside
    [floor, ceiling], the injected death is absorbed as a counted
    error with the loop still alive to act again, and stop() joins the
    loop thread even when it lands mid-decision."""

    name = "autoscaler-loop"

    def __init__(self):
        self.act = None
        self.asc = None

    def run(self, ctl) -> None:
        from distributedmnist_tpu_torch.serve.autoscale import Autoscaler

        # (the injected death's warning goes to the serve logger, which
        # the Controller silences for the run)
        self.act = _ScaleRecorder(floor=1, ceiling=3, die_on_call=1)
        self.sigs = _SignalBox()
        # cooldown 0: every decision may act, so the overlap/bounds
        # invariants face the max actuation rate (flap counting is the
        # bench's job; this machine stresses the serialization)
        # the logical clock, explicitly (see SchedulerWFQMachine.run)
        self.asc = asc = Autoscaler(
            self.act, self.sigs.read, high=0.7, low=0.2,
            cooldown_s=0.0, interval_s=0.001, clock=ctl.now)
        asc.start()

        def spike():
            # pin pressure above the high band, force decisions racing
            # the loop thread's own ticks, then drop off the cliff
            self.sigs.set(1.0)
            for _ in range(3):
                asc.tick()
            self.sigs.set(0.0)
            asc.tick()

        def trough():
            self.sigs.set(0.05)
            asc.tick()

        threads = [ctl.spawn(spike, "load-spike"),
                   ctl.spawn(trough, "trough"),
                   ctl.spawn(asc.stop, "stopper")]
        for t in threads:
            t.join()
        asc.stop()              # idempotent: second stop is a no-op

    def invariant(self, ctl) -> None:
        a = self.act
        if a is None:
            return
        assert a.overlaps == 0, (
            f"{a.overlaps} overlapping actuation(s) — the admin lock "
            "failed to serialize a manual tick against the loop")
        if ctl.lock_free("harness.asc.units"):
            assert a.floor <= a._units <= a.ceiling, (
                f"scale {a._units} escaped [{a.floor}, {a.ceiling}]")

    def final(self, ctl) -> None:
        a, asc = self.act, self.asc
        assert asc._thread is None, "loop thread not joined by stop()"
        assert a.overlaps == 0, (
            f"{a.overlaps} overlapping actuation(s) at drain")
        assert all(a.floor <= u <= a.ceiling for u in a.calls), (
            f"loop handed the actuator an out-of-bounds target: "
            f"{a.calls} outside [{a.floor}, {a.ceiling}]")
        assert a.floor <= a.current() <= a.ceiling, (
            f"final scale {a.current()} outside "
            f"[{a.floor}, {a.ceiling}]")
        for rec in asc.actions:
            assert a.floor <= rec["achieved_units"] <= a.ceiling, (
                f"action log records out-of-bounds scale: {rec}")
        assert asc.errors == a.deaths, (
            f"{a.deaths} injected death(s) but {asc.errors} counted "
            "error(s) — a failure was double-counted or swallowed")
        assert asc.flaps() == 0
        self.invariant(ctl)


def _batcher_nodrain() -> BatcherMachine:
    return BatcherMachine(drain=False)


MACHINES = {
    "cache": CacheMachine,
    "registry": RegistryMachine,
    "batcher": BatcherMachine,
    # stop(drain=False) is the path with a resolve-under-lock hazard
    # (lint DML009): it gets its own explored machine so the fix is
    # pinned dynamically too, not just statically.
    "batcher-nodrain": _batcher_nodrain,
    # bypass-vs-coalesce racing submits at max_inflight=1:
    # never deadlock, never double-dispatch, never strand the window
    # semaphore.
    "batcher-fastlane": FastlaneBatcherMachine,
    "fleet": FleetMachine,
    # the global scheduler's WFQ/EDF fairness vs racing admission,
    # quota admin and stop: accepted futures all resolve,
    # queue accounting never tears, head-of-line blocking stays under
    # the asserted DRR skip bound.
    "scheduler-wfq": SchedulerWFQMachine,
    # the autoscaler's closed loop vs load spikes, a mid-decision
    # actuator death and racing stop(): actuations never
    # overlap, scale never escapes [floor, ceiling], the death is a
    # counted error and the loop joins cleanly.
    "autoscaler-loop": AutoscalerLoopMachine,
}
