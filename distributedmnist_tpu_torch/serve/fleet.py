"""The replica fleet: health-tracked dispatch, failover redispatch and
hedged tails over N engine replicas (the port of the JAX package's
serve/fleet.py, same names, decisions and counters).

A **ReplicaSet** is engine-shaped (dispatch()/fetch(), max_batch,
buckets, platform, _as_images, bucket_costs), so it sits where the single
Router sits and the batcher cannot tell the difference. Each replica owns
a Router over its own InferenceEngines; the registry fans every version's
warm and promote out to all of them, so a roll never leaves the fleet
serving mixed versions. Where a replica runs is the factory's choice
(serve/registry.py): on its own card when at least N cards are visible,
else N replicas share one card, each engine launching on a CUDA stream of
its replica's own, so a hedge never queues behind the slow batch it
races. Per dispatch:

- **cost-aware least-loaded pick** (`select_member`, a pure function):
  each replica holds a bounded in-flight window (`per_replica_inflight`
  batches) and an outstanding cost priced by the engines' warmup-measured
  bucket cost tables; the healthy replica with the cheapest backlog wins,
  least recently picked breaking ties (round-robin when no table exists).
- **health-tracked exclusion**: every batch outcome feeds a per-replica
  HealthTracker and CircuitBreaker (serve/resilience.py). A tripped
  replica is left out of picks until its cooldown lapses; with every
  replica tripped the pick falls back to least-loaded (limp mode).
- **failover redispatch**: a batch whose replica dies at dispatch or fetch
  is retried once on a healthy sibling before the failure reaches the
  batcher. The handle keeps the host payload until fan-out for exactly
  this, and failover re-tags (version, replica) to the replica that
  computed the result. 503-shaped errors (NoLiveModel) are systemic and
  propagate without failover or blame.
- **hedged dispatch** (`hedge`): a batch that reaches its fetch already
  slower than `hedge_factor` x the live p95 cost of its bucket races a
  duplicate on a free healthy sibling; the first result wins, the loser
  drains on its own thread.
- **drain / rejoin**: drain(rid) takes a replica out of the pick set while
  its batches finish; rejoin(rid) restores it with a fresh health slate.
  Draining the last active replica is refused.

The failpoints `replica.dispatch` and `replica.fetch` (serve/faults.py)
wrap the per-replica hops with ctx {replica, ...}, so a chaos schedule can
kill exactly one replica, and the rescue spans `fleet.failover.dispatch`,
`fleet.failover.fetch` and `fleet.hedge` (serve/trace.py) name both
replicas. Rescue and hedge dispatches use only buckets warmup already ran.
There is no dispatch_fast: with a fleet the batcher's fast lane takes the
fleet's ordinary dispatch, as the JAX batcher does.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Optional, Sequence

import numpy as np

from distributedmnist_tpu_torch.analysis.locks import (make_condition,
                                                       make_thread)
from distributedmnist_tpu_torch.serve import trace
from distributedmnist_tpu_torch.serve.batcher import resolve_max_inflight
from distributedmnist_tpu_torch.serve.engine import InferenceEngine
from distributedmnist_tpu_torch.serve.faults import failpoint
from distributedmnist_tpu_torch.serve.resilience import (CircuitBreaker,
                                                         HealthTracker)

log = logging.getLogger("distributedmnist_tpu_torch")


class NoReplicaAvailable(RuntimeError):
    """Every replica is draining: new work is shed with 503 semantics,
    systemic like NoLiveModel (never bisected, never blamed)."""

    status = 503


@dataclasses.dataclass
class _Replica:
    """One member of the fleet: its Router and the accounting the pick
    runs on, every mutable field guarded by the fleet's condition."""

    rid: str
    router: Any
    state: str = "active"            # "active" | "draining"
    inflight: int = 0                # reserved dispatch slots
    outstanding_s: float = 0.0       # estimated cost of reserved work
    last_pick: int = 0               # fleet pick sequence (LRU tiebreak)
    dispatched_batches: int = 0
    dispatched_rows: int = 0
    failures: int = 0


def select_member(active: Sequence[Any], cooled, window: int,
                  overflow: bool = False,
                  healthy_only: bool = False) -> Optional[Any]:
    """The cost-aware least-loaded pick as a pure function (the gateway's
    balanced dispatch takes the same policy). Members carry `rid`,
    `inflight`, `outstanding_s` and `last_pick`; `cooled(rid)` is the
    breaker's cooldown predicate.

    Healthy members with free window credit win by least outstanding
    work, then least in flight, then least recently picked; with every
    member cooled the pool is every active member (limp mode) unless
    `healthy_only` (a hedge on a sick member is wasted work). `overflow`
    lets the pick exceed the window (a rescue). None when no candidate
    qualifies; the caller reserves the slot under its own lock."""
    if not active:
        return None
    healthy = [m for m in active if not cooled(m.rid)]
    if healthy_only and not healthy:
        return None
    pool = healthy or active        # limp mode
    free = [m for m in pool if m.inflight < window]
    cands = free or (pool if overflow else [])
    if not cands:
        return None
    # least recently picked, not least picked overall: a rejoined member
    # must not be flooded until its lifetime count catches up
    return min(cands, key=lambda m: (m.outstanding_s, m.inflight,
                                     m.last_pick))


@dataclasses.dataclass
class FleetHandle:
    """A dispatched batch plus what failover needs: the replica holding
    it, the reserved cost released at completion, and the host payload
    (a fetch-side death is redispatched from it). (version, replica,
    infer_dtype) are re-stamped when failover or a winning hedge moves
    the computation, so attribution names the replica that computed the
    result."""

    inner: Any                      # the replica Router's RoutedHandle
    replica: str
    version: Optional[str]
    n: int
    bucket: int
    x: Any                          # host payload, for redispatch
    cost_s: float                   # reserved estimate, released as is
    t_dispatch: float
    infer_dtype: Optional[str] = None


class ReplicaSet:
    """Engine-shaped load-balancing dispatcher over N >= 2 replica
    Routers. The registry drives the version surface (set_live,
    set_shadow and set_canary fan out under the fleet lock, so no batch
    is picked mid-roll); the batcher drives dispatch()/fetch()."""

    HEDGE_FACTOR = 3.0

    def __init__(self, routers: Sequence, metrics=None,
                 per_replica_inflight: Optional[int] = None,
                 breaker: Optional[CircuitBreaker] = None,
                 health: Optional[HealthTracker] = None,
                 hedge: bool = False,
                 hedge_factor: Optional[float] = None):
        if len(routers) < 2:
            raise ValueError(
                f"a fleet needs >= 2 replicas, got {len(routers)} "
                "(single-replica serving uses a bare Router)")
        first = routers[0]
        for r in routers[1:]:
            if (tuple(r.buckets) != tuple(first.buckets)
                    or r.max_batch != first.max_batch):
                raise ValueError(
                    "replica geometry mismatch: all replicas must share "
                    "one bucket ladder / max_batch")
        self.replicas = [_Replica(rid=r.replica or f"r{i}", router=r)
                         for i, r in enumerate(routers)]
        self._by_id = {r.rid: r for r in self.replicas}
        if len(self._by_id) != len(self.replicas):
            raise ValueError("duplicate replica ids")
        self.max_batch = first.max_batch
        self.buckets = tuple(first.buckets)
        self.platform = first.platform
        self.n_chips = first.n_chips           # per replica
        self.metrics = metrics
        self.per_replica_inflight = resolve_max_inflight(
            per_replica_inflight, self.platform)
        # tighter than the version breaker: a replica is cheap to exclude
        # (siblings absorb its share) and cheap to re-admit
        self.breaker = breaker if breaker is not None else CircuitBreaker(
            window_s=5.0, min_requests=8, failure_ratio=0.5,
            cooldown_s=10.0)
        self.health = health if health is not None else HealthTracker()
        self.hedge = hedge
        self.hedge_factor = (self.HEDGE_FACTOR if hedge_factor is None
                             else hedge_factor)
        self._cond = make_condition("fleet.pick")
        self._pick_seq = 0
        self._failovers_dispatch = 0
        self._failovers_fetch = 0
        self._hedges = 0
        self._hedge_wins = 0
        # replica failures a hedge race absorbed (the arm failed, its
        # twin answered): neither a failover nor a client's error
        self._hedge_absorbed: dict = {}
        self._replica_trips = 0

    # engine-shape parity (the Router borrows the same two)
    _as_images = staticmethod(InferenceEngine._as_images)
    bucket_for = InferenceEngine.bucket_for

    @property
    def n_replicas(self) -> int:
        return len(self.replicas)

    @property
    def max_inflight_total(self) -> int:
        """The fleet's aggregate window: the batcher opens its own to
        this when its max_inflight is left on auto."""
        return self.per_replica_inflight * len(self.replicas)

    def replica_ids(self) -> list[str]:
        return [r.rid for r in self.replicas]

    # -- version wiring: the registry's fan-out surface -------------------

    def set_live(self, engines: Sequence, version: str) -> None:
        """Fleet-wide swap under the pick lock: no batch dispatches
        between replica k and k+1 taking the new version."""
        self._check_fanout(engines)
        with self._cond:
            for rep, eng in zip(self.replicas, engines):
                rep.router.set_live(eng, version)

    def set_shadow(self, engines: Sequence, version: str,
                   fraction: float) -> None:
        self._check_fanout(engines)
        with self._cond:
            for rep, eng in zip(self.replicas, engines):
                rep.router.set_shadow(eng, version, fraction)

    def set_canary(self, engines: Sequence, version: str,
                   fraction: float) -> None:
        self._check_fanout(engines)
        with self._cond:
            for rep, eng in zip(self.replicas, engines):
                rep.router.set_canary(eng, version, fraction)

    def clear_candidates(self) -> None:
        with self._cond:
            for rep in self.replicas:
                rep.router.clear_candidates()

    def _check_fanout(self, engines: Sequence) -> None:
        if len(engines) != len(self.replicas):
            raise ValueError(
                f"fan-out needs one engine per replica: got "
                f"{len(engines)} for {len(self.replicas)} replicas")

    # replica 0 speaks for all: every route mutation fans out under the
    # fleet lock, so the replicas' tables are identical
    def live_version(self) -> Optional[str]:
        return self.replicas[0].router.live_version()

    def live_infer_dtype(self) -> Optional[str]:
        return self.replicas[0].router.live_infer_dtype()

    def live_route(self) -> tuple:
        return self.replicas[0].router.live_route()

    def routes(self) -> dict:
        return self.replicas[0].router.routes()

    def versions_in_route(self) -> set:
        out: set = set()
        for rep in self.replicas:
            out |= rep.router.versions_in_route()
        return out

    def bucket_costs(self) -> dict:
        return self.replicas[0].router.bucket_costs()

    def bucket_costs_p95(self) -> dict:
        return self.replicas[0].router.bucket_costs_p95()

    # -- the pick ----------------------------------------------------------

    def _cost(self, bucket: int) -> float:
        costs = self.bucket_costs()
        return costs.get(bucket, 0.0) if costs else 0.0

    def _pick(self, cost_s: float, exclude: frozenset = frozenset(),
              block: bool = True, overflow: bool = False,
              healthy_only: bool = False) -> Optional[_Replica]:
        """Reserve a dispatch slot on the best replica (select_member's
        choice), under the lock, so concurrent pickers never oversubscribe
        a window. block=True (the primary dispatch) waits for credit;
        block=False (failover and hedge, on the completion thread that
        frees credit, where waiting would deadlock) returns None, or
        over-commits with `overflow` (a rescue may, a hedge may not)."""
        with self._cond:
            while True:
                active = [r for r in self.replicas
                          if r.state == "active" and r.rid not in exclude]
                if not active:
                    if exclude:
                        return None       # no sibling to rescue/hedge on
                    raise NoReplicaAvailable(
                        "every replica is draining — fleet takes no new "
                        "work")
                rep = select_member(active, self.breaker.in_cooldown,
                                    self.per_replica_inflight,
                                    overflow=(not block and overflow),
                                    healthy_only=healthy_only)
                if rep is not None:
                    self._pick_seq += 1
                    rep.last_pick = self._pick_seq
                    rep.inflight += 1
                    rep.outstanding_s += cost_s
                    return rep
                if healthy_only and all(self.breaker.in_cooldown(r.rid)
                                        for r in active):
                    # no hedge onto a tripped sibling; rescues and the
                    # primary dispatch still limp inside the policy
                    return None
                if not block:
                    return None
                self._cond.wait(0.05)

    def _release(self, rep: _Replica, cost_s: float) -> None:
        with self._cond:
            rep.inflight -= 1
            rep.outstanding_s = max(rep.outstanding_s - cost_s, 0.0)
            self._cond.notify_all()

    def _mark_dispatched(self, rep: _Replica, rows: int) -> None:
        with self._cond:
            rep.dispatched_batches += 1
            rep.dispatched_rows += rows

    def _record(self, rep: _Replica, ok: bool, n: int = 1,
                latency_s: Optional[float] = None) -> None:
        """One replica-attributed outcome into the health window and the
        replica's breaker. A trip is logged and counted, and the pick
        leaves the replica out for the cooldown: a sick replica is routed
        around, never rolled back (that is the version breaker's job)."""
        self.health.record(rep.rid, ok, n=n, latency_s=latency_s)
        if not ok:
            with self._cond:
                rep.failures += 1
        if self.breaker.record(rep.rid, ok, n=n):
            with self._cond:
                self._replica_trips += 1
            log.warning(
                "fleet: replica %s TRIPPED its breaker — excluded from "
                "dispatch for %.1fs (siblings absorb its share)",
                rep.rid, self.breaker.cooldown_s)
            if self.metrics is not None:
                self.metrics.record_replica_trip(rep.rid)

    # -- the engine surface the batcher drives -----------------------------

    def dispatch(self, x) -> FleetHandle:
        parts = ([self._as_images(p) for p in x]
                 if isinstance(x, (list, tuple))
                 else [self._as_images(x)])
        n = sum(p.shape[0] for p in parts)
        bucket = self.bucket_for(n)
        cost_s = self._cost(bucket)
        rep = self._pick(cost_s)
        try:
            return self._dispatch_on(rep, parts, n, bucket, cost_s)
        except Exception as e:
            self._release(rep, cost_s)
            if getattr(e, "status", None) == 503:
                raise             # systemic: every sibling would refuse
            self._record(rep, ok=False)
            sib = self._pick(cost_s, exclude=frozenset((rep.rid,)),
                             block=False, overflow=True)
            if sib is None:
                raise
            sp = trace.begin_span("fleet.failover.dispatch",
                                  from_replica=rep.rid,
                                  to_replica=sib.rid)
            try:
                fh = self._dispatch_on(sib, parts, n, bucket, cost_s)
            except Exception as e2:
                self._release(sib, cost_s)
                self._record(sib, ok=False)
                # the batch is attributed to its primary failure; the
                # span errors explicitly, since what propagates is the
                # original cause
                trace.end_span(sp, error=type(e2).__name__)
                log.warning("fleet: rescue dispatch on %s failed too "
                            "(%s)", sib.rid, e2)
                raise e
            finally:
                trace.end_span(sp)
            with self._cond:
                self._failovers_dispatch += 1
            if self.metrics is not None:
                self.metrics.record_failover("dispatch", rep.rid, sib.rid)
            log.warning("fleet: dispatch failover %s -> %s (%s)",
                        rep.rid, sib.rid, e)
            return fh

    def _dispatch_on(self, rep: _Replica, parts: list, n: int,
                     bucket: int, cost_s: float) -> FleetHandle:
        """One replica-targeted dispatch (the caller reserved the slot
        and releases it on failure)."""
        failpoint("replica.dispatch", replica=rep.rid, rows=n,
                  bucket=bucket)
        rh = rep.router.dispatch(parts)
        self._mark_dispatched(rep, n)
        return FleetHandle(inner=rh, replica=rep.rid, version=rh.version,
                           n=rh.n, bucket=rh.bucket, x=parts,
                           cost_s=cost_s, t_dispatch=time.monotonic(),
                           infer_dtype=getattr(rh, "infer_dtype", None))

    def _fetch_on(self, rep: _Replica, fh_or_rh, version, n: int
                  ) -> np.ndarray:
        failpoint("replica.fetch", replica=rep.rid, version=version,
                  rows=n)
        return rep.router.fetch(fh_or_rh)

    def _drain_abandoned(self, rep: _Replica, inner) -> None:
        """A replica-targeted fetch died and the pipeline will never fetch
        its handle again. If the death came before the engine's own fetch
        ran (the replica.fetch failpoint, the chaos kill), the handle
        still holds a checked-out staging pair, and on the card its copy
        may still be running into that pair's output buffer: fetch and
        discard it on a daemon thread, which waits on the handle's own
        event before the engine recycles the pair. A handle whose engine
        fetch already ran (staging None, the one-shot marker) is skipped:
        a second Router.fetch would enqueue its shadow comparison
        twice."""
        h = getattr(inner, "handle", inner)
        if getattr(h, "staging", "never-fetched") is None:
            return

        def drain():
            try:
                rep.router.fetch(inner)
            except Exception:
                pass

        make_thread(target=drain, name="serve-drain-abandoned",
                    daemon=True).start()

    def fetch(self, fh: FleetHandle) -> np.ndarray:
        rep = self._by_id[fh.replica]
        if self.hedge:
            threshold = self._hedge_threshold(fh.bucket)
            if (threshold is not None
                    and time.monotonic() - fh.t_dispatch > threshold):
                sib = self._pick(fh.cost_s,
                                 exclude=frozenset((rep.rid,)),
                                 block=False, overflow=False,
                                 healthy_only=True)
                if sib is not None:
                    return self._fetch_hedged(fh, rep, sib)
        try:
            out = self._fetch_on(rep, fh.inner, fh.version, fh.n)
        except Exception as e:
            self._release(rep, fh.cost_s)
            if getattr(e, "status", None) == 503:
                raise             # systemic: not this replica's fault
            self._record(rep, ok=False)
            return self._failover_fetch(fh, rep, e)
        self._release(rep, fh.cost_s)
        self._record(rep, ok=True,
                     latency_s=time.monotonic() - fh.t_dispatch)
        return out

    def _failover_fetch(self, fh: FleetHandle, failed: _Replica,
                        cause: Exception) -> np.ndarray:
        """The batch's replica died at fetch: redispatch the kept payload
        once on a healthy sibling, inline on the completion thread (FIFO
        order holds; the rescue lengthens this batch's service time). The
        sibling may over-commit its window. A failed rescue propagates the
        ORIGINAL cause, and a failover counts only once the rescue landed
        (dispatch and fetch)."""
        self._drain_abandoned(failed, fh.inner)
        sib = self._pick(fh.cost_s, exclude=frozenset((failed.rid,)),
                         block=False, overflow=True)
        if sib is None:
            raise cause
        sp = trace.begin_span("fleet.failover.fetch",
                              from_replica=failed.rid,
                              to_replica=sib.rid)
        try:
            try:
                rescued = self._dispatch_on(sib, fh.x, fh.n, fh.bucket,
                                            fh.cost_s)
            except Exception as e2:
                self._release(sib, fh.cost_s)
                self._record(sib, ok=False)
                trace.end_span(sp, error=type(e2).__name__)
                log.warning("fleet: rescue dispatch on %s failed too "
                            "(%s)", sib.rid, e2)
                raise cause
            log.warning("fleet: fetch failover %s -> %s (%s)",
                        failed.rid, sib.rid, cause)
            try:
                out = self._fetch_on(sib, rescued.inner, rescued.version,
                                     fh.n)
            except Exception as e2:
                self._release(sib, fh.cost_s)
                self._record(sib, ok=False)
                self._drain_abandoned(sib, rescued.inner)
                trace.end_span(sp, error=type(e2).__name__)
                log.warning("fleet: rescue fetch on %s failed too (%s)",
                            sib.rid, e2)
                raise cause
        finally:
            trace.end_span(sp)
        self._release(sib, fh.cost_s)
        # scored on its own service time, from the rescue dispatch on
        self._record(sib, ok=True,
                     latency_s=time.monotonic() - rescued.t_dispatch)
        with self._cond:
            self._failovers_fetch += 1
        if self.metrics is not None:
            self.metrics.record_failover("fetch", failed.rid, sib.rid)
        # attribution follows the computation (a roll may have landed
        # in between)
        fh.replica, fh.version = sib.rid, rescued.version
        fh.infer_dtype = rescued.infer_dtype
        return out

    def _hedge_threshold(self, bucket: int) -> Optional[float]:
        p95 = self.bucket_costs_p95()
        if not p95 or bucket not in p95:
            return None           # no tail estimate yet: never hedge
        return self.hedge_factor * p95[bucket]

    def _fetch_hedged(self, fh: FleetHandle, rep: _Replica,
                      sib: _Replica) -> np.ndarray:
        """Race the overdue primary fetch against a duplicate on `sib`
        (slot reserved by the caller's pick): the first success wins, the
        loser finishes on its own daemon thread, where its engine fetch
        waits on its own event and recycles its own staging pair (the
        duplicate was staged into a pair of the sibling's engine, never
        the primary's)."""
        cv = make_condition("fleet.hedge")
        results: dict = {}            # tag -> (ok, value), arrival order
        winner: dict = {}             # the hedge span's winner tag
        arm_rid = {"primary": rep.rid, "hedge": sib.rid}

        def absorbed(tag):
            # caller holds cv: a failed arm of a race that answered
            with self._cond:
                rid = arm_rid[tag]
                self._hedge_absorbed[rid] = (
                    self._hedge_absorbed.get(rid, 0) + 1)

        def finish(tag, ok, value):
            with cv:
                results[tag] = (ok, value)
                if not ok and "who" in winner:
                    absorbed(tag)     # the loser failed after the answer
                cv.notify_all()

        # the arms run on threads of their own, so they take an explicit
        # parent ref instead of a thread-local stack
        hsp = trace.begin_span("fleet.hedge", primary=rep.rid,
                               duplicate=sib.rid, bucket=fh.bucket)
        try:
            ctx = trace.current()

            def run_primary():
                psp = trace.begin_span("fleet.hedge.primary", ctx=ctx,
                                       replica=rep.rid)
                try:
                    try:
                        out = self._fetch_on(rep, fh.inner, fh.version,
                                             fh.n)
                    except Exception as e:
                        self._release(rep, fh.cost_s)
                        self._record(rep, ok=False)
                        self._drain_abandoned(rep, fh.inner)
                        finish("primary", False, e)
                        return
                    self._release(rep, fh.cost_s)
                    self._record(rep, ok=True,
                                 latency_s=(time.monotonic()
                                            - fh.t_dispatch))
                    finish("primary", True, out)
                finally:
                    trace.end_span(psp)

            def run_hedge():
                dsp = trace.begin_span("fleet.hedge.duplicate", ctx=ctx,
                                       replica=sib.rid)
                try:
                    try:
                        dup = self._dispatch_on(sib, fh.x, fh.n,
                                                fh.bucket, fh.cost_s)
                    except Exception as e:
                        self._release(sib, fh.cost_s)
                        self._record(sib, ok=False)
                        finish("hedge", False, e)
                        return
                    try:
                        out = self._fetch_on(sib, dup.inner, dup.version,
                                             fh.n)
                    except Exception as e:
                        self._release(sib, fh.cost_s)
                        self._record(sib, ok=False)
                        self._drain_abandoned(sib, dup.inner)
                        finish("hedge", False, e)
                        return
                    self._release(sib, fh.cost_s)
                    # scored on the duplicate's own time
                    self._record(sib, ok=True,
                                 latency_s=(time.monotonic()
                                            - dup.t_dispatch))
                    finish("hedge", True, (out, dup.version, sib.rid,
                                           dup.infer_dtype))
                finally:
                    trace.end_span(dsp)

            with self._cond:
                self._hedges += 1
            for target in (run_primary, run_hedge):
                make_thread(target=target, name="serve-hedge",
                            daemon=True).start()
            with cv:
                while True:
                    for tag, (ok, value) in results.items():
                        if ok:
                            hedge_won = tag == "hedge"
                            winner["who"] = tag
                            for lost, (lost_ok, _) in results.items():
                                if not lost_ok:
                                    absorbed(lost)
                            if hedge_won:
                                with self._cond:
                                    self._hedge_wins += 1
                                out, version, rid, dtype = value
                                fh.replica, fh.version = rid, version
                                fh.infer_dtype = dtype
                            else:
                                out = value
                            if self.metrics is not None:
                                self.metrics.record_hedge(win=hedge_won)
                            return out
                    if len(results) == 2:   # both failed
                        if self.metrics is not None:
                            self.metrics.record_hedge(win=False)
                        raise results["primary"][1]
                    cv.wait()
        finally:
            trace.end_span(hsp, winner=winner.get("who"))

    def infer(self, x) -> np.ndarray:
        return self.fetch(self.dispatch(x))

    # -- admin: drain / rejoin --------------------------------------------

    def drain(self, rid: str) -> dict:
        """Stop picking `rid` (rescues and hedges pick too, so none lands
        there); its batches in flight finish, since fetch does not pick.
        Draining the last active replica is refused."""
        with self._cond:
            rep = self._get(rid)
            if rep.state != "draining":
                others = [r for r in self.replicas
                          if r.state == "active" and r.rid != rid]
                if not others:
                    raise RuntimeError(
                        f"refusing to drain {rid}: it is the last active "
                        "replica (SIGTERM the server to stop serving)")
                rep.state = "draining"
                self._cond.notify_all()
            snap = self._replica_snapshot(rep)
        log.info("fleet: replica %s draining (%d in flight)", rid,
                 snap["inflight"])
        return snap

    def rejoin(self, rid: str) -> dict:
        """Return a drained replica to the pick set with a fresh health
        slate: failures recorded before the repair must not veto it."""
        with self._cond:
            rep = self._get(rid)
            rep.state = "active"
            self._cond.notify_all()
        self.breaker.reset(rid)
        self.health.reset(rid)
        log.info("fleet: replica %s rejoined", rid)
        with self._cond:
            return self._replica_snapshot(rep)

    def _get(self, rid: str) -> _Replica:
        rep = self._by_id.get(rid)
        if rep is None:
            raise KeyError(f"unknown replica {rid!r}; fleet has "
                           f"{self.replica_ids()}")
        return rep

    # -- introspection -----------------------------------------------------

    def _replica_snapshot(self, rep: _Replica) -> dict:
        # caller holds self._cond
        return {
            "id": rep.rid,
            "state": rep.state,
            "healthy": not self.breaker.in_cooldown(rep.rid),
            "health_score": round(self.health.score(rep.rid), 4),
            "inflight": rep.inflight,
            "outstanding_cost_ms": round(rep.outstanding_s * 1e3, 3),
            "dispatched_batches": rep.dispatched_batches,
            "dispatched_rows": rep.dispatched_rows,
            "failures": rep.failures,
        }

    def hedge_absorbed(self) -> dict:
        """{replica id: failures a hedge race absorbed}: a replica's
        dispatch or fetch that failed inside a hedge race whose other arm
        answered. Such a failure is rescued, but counts as neither a
        failover nor a client's error, so a chaos run's replica kill can
        leave no failover behind. Kept out of snapshot(), whose keys are
        the JAX fleet's."""
        with self._cond:
            return dict(self._hedge_absorbed)

    def snapshot(self) -> dict:
        """The /healthz and /metrics fleet block: per-replica state and
        the failover, hedge and trip counters."""
        with self._cond:
            replicas = [self._replica_snapshot(r) for r in self.replicas]
            out = {
                "n_replicas": len(self.replicas),
                "per_replica_inflight": self.per_replica_inflight,
                "hedge": self.hedge,
                "replicas": replicas,
                "failovers": {"dispatch": self._failovers_dispatch,
                              "fetch": self._failovers_fetch},
                "hedges": {"fired": self._hedges,
                           "wins": self._hedge_wins},
                "replica_trips": self._replica_trips,
            }
        out["breaker"] = self.breaker.snapshot()
        out["health"] = self.health.snapshot()
        return out
