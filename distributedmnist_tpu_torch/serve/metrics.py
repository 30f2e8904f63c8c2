"""Serving observability: per-request latency percentiles, batch
occupancy per bucket, queue depth, the staging/fetch pipeline split,
requests/sec, the per-version, per-replica and per-dtype populations,
the shadow comparisons, the resilience counters (deadline sheds,
bisection, breaker trips and rollbacks), the fleet's failovers, hedges
and replica trips, the prediction cache's served populations, dedup, the
fast lane's split, the cascade's classes, stages and escalations and the
tenancy layer's per-tenant and per-model populations and the
autoscaler's operating point — the ServeMetrics snapshot the selftest
summary, the HTTP server's /metrics and its heartbeat lines carry (the
port of the JAX package's serve/metrics.py, with its key names) —
prometheus_exposition, the same snapshot as Prometheus text, and
gateway_prometheus_exposition, the gateway's snapshot as the
`dmnist_gateway_*` families.

Occupancy is rows served per bucket slot executed: low occupancy says
the coalescing wait is too short or the traffic too bursty for the
ladder; the latency percentiles say what coalescing costs each request.
"""

from __future__ import annotations

import time
from collections import deque

from distributedmnist_tpu_torch.analysis.locks import make_lock
from distributedmnist_tpu_torch.utils import MetricsLogger, percentiles


def _ms(pct: dict) -> dict:
    return {k: (round(v * 1e3, 3) if v is not None else None)
            for k, v in pct.items()}


class ServeMetrics:
    """Thread-safe accumulator; snapshot() is a plain dict, reset()
    reopens the measurement window."""

    def __init__(self, max_latency_samples: int = 100_000):
        self._lock = make_lock("serve.metrics")
        self._max_samples = max_latency_samples
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self._t0 = time.monotonic()
            self._lat_s: deque = deque(maxlen=self._max_samples)
            self._requests = 0
            self._rows = 0
            self._batches = 0
            self._rejected_requests = 0
            self._rejected_rows = 0
            self._occupancy: dict[int, list] = {}  # bucket -> [batches, rows]
            self._depth_sum = 0
            self._depth_max = 0
            # pipeline split: host staging (pad + copy + launch) vs the
            # blocking fetch, and the in-flight depth after each dispatch
            self._staging_s: deque = deque(maxlen=self._max_samples)
            self._fetch_s: deque = deque(maxlen=self._max_samples)
            self._dispatches = 0
            self._inflight_sum = 0
            self._inflight_max = 0
            # executed bucket slots vs requested rows (padding waste) and
            # the adaptive controller's effective wait
            self._dispatched_rows = 0
            self._padded_rows = 0
            self._wait_last_s = None
            self._wait_sum_s = 0.0
            self._wait_n = 0
            self._by_version: dict[str, dict] = {}
            # per-replica batch populations (the handle's replica tag),
            # and the fleet's rescue counters
            self._by_replica: dict[str, dict] = {}
            self._by_dtype: dict[str, dict] = {}
            self._failovers: dict[str, int] = {}   # kind -> count
            self._last_failover = None     # {"kind", "from", "to", "at"}
            self._hedges = 0
            self._hedge_wins = 0
            self._replica_trips: dict[str, int] = {}   # rid -> trips
            self._dispatch_error_requests = 0
            self._fetch_error_requests = 0
            # "live->shadow" pair -> comparison totals; failed and
            # cap-dropped duplicates
            self._shadow: dict[str, dict] = {}
            self._shadow_errors = 0
            self._shadow_dropped = 0
            self._deadline_shed_requests = 0
            self._deadline_shed_rows = 0
            # bisection: splits, isolated culprits, rescued cohort-mates;
            # the breaker's trips and the rollbacks they caused
            self._bisect_splits = 0
            self._poison_isolated_requests = 0
            self._poison_isolated_rows = 0
            self._bisect_rescued_requests = 0
            self._bisect_rescued_rows = 0
            self._breaker_trips = 0
            self._breaker_trips_by_version: dict[str, int] = {}
            self._rollbacks = 0
            self._last_rollback = None       # {"from", "to", "at"}
            # requests the cache front served without the pipeline
            # (hits and collapsed followers), dedup riders, and the fast
            # lane's split; each also feeds the global populations
            self._cache_hit_requests = 0
            self._cache_hit_rows = 0
            self._cache_collapsed_requests = 0
            self._dedup_requests = 0
            self._dedup_rows = 0
            self._fastpath_dispatches = 0
            self._fastpath_rows = 0
            # the cascade: requests per accuracy class, rows per stage,
            # escalations, and requests that degraded to the live route
            self._cascade_class: dict[str, int] = {}
            self._cascade_stage_rows: dict[str, dict] = {}
            self._cascade_escalated_requests = 0
            self._cascade_escalated_rows = 0
            self._cascade_degraded = 0
            # the tenancy layer's populations, keyed by the RESOLVED SLO
            # class (an unknown X-Tenant collapses into "default"), so
            # the label set is bounded by configuration
            self._by_tenant: dict[str, dict] = {}
            self._by_model: dict[str, dict] = {}
            # the autoscaler's control loop: its scale, applied
            # decisions by direction, cooldown-suppressed and
            # ceiling-hit ticks, and the last action's price
            self._autoscale_scale: int = 0
            self._autoscale_decisions: dict[str, int] = {}
            self._autoscale_suppressed = 0
            self._autoscale_saturated = 0
            self._autoscale_last_cost: float = 0.0

    # -- recording hooks (called by the batcher) ---------------------------

    def _version_stats(self, version: str) -> dict:
        # caller holds the lock
        return self._by_version.setdefault(version, {
            "requests": 0, "rows": 0, "batches": 0,
            "lat": deque(maxlen=min(self._max_samples, 10_000))})

    # The bodies of the hooks one event may combine, each run with the
    # lock held (it is not reentrant): the public hooks take the lock
    # around one, the combined hooks around several, so a reset() window
    # holds all of one event's records or none of them.

    def _add_latency(self, seconds: float, rows: int, version: str) -> None:
        self._lat_s.append(seconds)
        self._requests += 1
        self._rows += rows
        if version is not None:
            v = self._version_stats(version)
            v["requests"] += 1
            v["rows"] += rows
            v["lat"].append(seconds)

    def _add_batch(self, rows: int, bucket: int, queue_depth: int,
                   version: str, replica: str, infer_dtype: str) -> None:
        self._batches += 1
        occ = self._occupancy.setdefault(bucket, [0, 0])
        occ[0] += 1
        occ[1] += rows
        self._dispatched_rows += bucket
        self._padded_rows += max(bucket - rows, 0)
        self._depth_sum += queue_depth
        self._depth_max = max(self._depth_max, queue_depth)
        if version is not None:
            self._version_stats(version)["batches"] += 1
        if replica is not None:
            s = self._by_replica.setdefault(replica,
                                            {"batches": 0, "rows": 0})
            s["batches"] += 1
            s["rows"] += rows
        if infer_dtype is not None:
            s = self._by_dtype.setdefault(infer_dtype,
                                          {"batches": 0, "rows": 0})
            s["batches"] += 1
            s["rows"] += rows

    def _add_fastpath(self, rows: int) -> None:
        self._fastpath_dispatches += 1
        self._fastpath_rows += rows

    def _add_deadline_shed(self, rows: int) -> None:
        self._deadline_shed_requests += 1
        self._deadline_shed_rows += rows

    def _add_reject(self, rows: int) -> None:
        self._rejected_requests += 1
        self._rejected_rows += rows

    def _add_poison_isolated(self, rows: int) -> None:
        self._poison_isolated_requests += 1
        self._poison_isolated_rows += rows

    def _add_tenant_request(self, tenant: str, model: str,
                            rows: int) -> None:
        t = self._tenant_stats(tenant)
        t["requests"] += 1
        t["rows"] += rows
        m = self._model_stats(model)
        m["requests"] += 1
        m["rows"] += rows

    def _add_tenant_shed(self, tenant: str, kind: str, rows: int) -> None:
        t = self._tenant_stats(tenant)
        t[f"{kind}_sheds"] += 1
        t["shed_rows"] += rows

    def _add_cascade_stage(self, stage: str, rows: int) -> None:
        s = self._cascade_stage_rows.setdefault(
            stage, {"rows": 0, "dispatches": 0})
        s["rows"] += rows
        s["dispatches"] += 1

    def record_served(self, fetch_seconds: float, rows: int, bucket: int,
                      queue_depth: int, latencies, version: str = None,
                      replica: str = None, infer_dtype: str = None,
                      fastpath: bool = False) -> None:
        """One served dispatch's completion records under one
        acquisition: its fetch, its batch (`rows` real rows in `bucket`
        slots), each request's (seconds, rows) in `latencies` (riders
        included) and, for the fast lane, its lane split. The same
        records record_fetch, record_batch, record_latency and
        record_fastpath make one by one, but a reset() window now holds
        all of them or none."""
        with self._lock:
            if fastpath:
                self._add_fastpath(rows)
            self._fetch_s.append(fetch_seconds)
            self._add_batch(rows, bucket, queue_depth, version, replica,
                            infer_dtype)
            for seconds, n in latencies:
                self._add_latency(seconds, n, version)

    def record_latency(self, seconds: float, rows: int = 1,
                       version: str = None) -> None:
        with self._lock:
            self._add_latency(seconds, rows, version)

    def record_cache_hit(self, seconds: float, rows: int = 1,
                         version: str = None, infer_dtype: str = None,
                         collapsed: bool = False) -> None:
        """One request served by the cache front: a hit, or a
        single-flight follower resolved from its leader's bytes
        (collapsed=True). It records the populations a computed response
        records (global, per-version, per-dtype rows)."""
        with self._lock:
            self._lat_s.append(seconds)
            self._requests += 1
            self._rows += rows
            if collapsed:
                self._cache_collapsed_requests += 1
            else:
                self._cache_hit_requests += 1
            self._cache_hit_rows += rows
            if version is not None:
                v = self._version_stats(version)
                v["requests"] += 1
                v["rows"] += rows
                v["lat"].append(seconds)
            if infer_dtype is not None:
                s = self._by_dtype.setdefault(infer_dtype,
                                              {"batches": 0, "rows": 0})
                s["rows"] += rows

    def record_fastpath(self, rows: int = 1) -> None:
        """One request served through the fast lane (its latency, batch
        and version land through the usual hooks; this is the lane
        split)."""
        with self._lock:
            self._add_fastpath(rows)

    def record_cascade_class(self, accuracy_class: str) -> None:
        """One request entered the cascade front under this class,
        counted at submit, before any degrade or shed."""
        with self._lock:
            self._cascade_class[accuracy_class] = \
                self._cascade_class.get(accuracy_class, 0) + 1

    def record_cascade_submit(self, accuracy_class: str,
                              degraded: bool) -> None:
        """One cascade-front request's submit under one acquisition: its
        class and, when no calibrated cascade serves it, its degrade."""
        with self._lock:
            self._cascade_class[accuracy_class] = \
                self._cascade_class.get(accuracy_class, 0) + 1
            if degraded:
                self._cascade_degraded += 1

    def record_cascade_stage(self, stage: str, rows: int) -> None:
        """Rows a cascade stage answered: the cheap dtype counts every
        stage-1 row, 'float32' only the escalated ones."""
        with self._lock:
            self._add_cascade_stage(stage, rows)

    def record_cascade_escalation(self, rows: int) -> None:
        """A balanced request sent `rows` rows under the threshold on to
        float32."""
        with self._lock:
            self._cascade_escalated_requests += 1
            self._cascade_escalated_rows += rows

    def record_cascade_first_stage(self, stage: str, rows: int,
                                   escalated_rows: int) -> None:
        """A balanced request's cheap stage under one acquisition: its
        `rows` on `stage` and, when any fell under the threshold, the
        escalation of `escalated_rows` of them, so the escalation
        fraction's two terms share every window."""
        with self._lock:
            self._add_cascade_stage(stage, rows)
            if escalated_rows:
                self._cascade_escalated_requests += 1
                self._cascade_escalated_rows += escalated_rows

    def record_cascade_degraded(self) -> None:
        """A cascade-front request served by the plain live route (no
        calibrated cascade on the live version): loud, never an
        error."""
        with self._lock:
            self._cascade_degraded += 1

    def record_dedup(self, requests: int, rows: int) -> None:
        """Intra-batch dedup riders: `rows` the device did not run."""
        with self._lock:
            self._dedup_requests += requests
            self._dedup_rows += rows

    def record_dispatch(self, staging_seconds: float,
                        inflight: int = 1) -> None:
        """One batch dispatched: host staging time and the pipeline depth
        right after the dispatch."""
        with self._lock:
            self._staging_s.append(staging_seconds)
            self._dispatches += 1
            self._inflight_sum += inflight
            self._inflight_max = max(self._inflight_max, inflight)

    def record_fetch(self, seconds: float) -> None:
        """One batch's blocking fetch completed."""
        with self._lock:
            self._fetch_s.append(seconds)

    def record_batch(self, rows: int, bucket: int, queue_depth: int,
                     version: str = None, replica: str = None,
                     infer_dtype: str = None) -> None:
        with self._lock:
            self._add_batch(rows, bucket, queue_depth, version, replica,
                            infer_dtype)

    def record_wait(self, seconds: float) -> None:
        """The effective coalescing wait one drain used."""
        with self._lock:
            self._wait_last_s = seconds
            self._wait_sum_s += seconds
            self._wait_n += 1

    def record_reject(self, rows: int = 1) -> None:
        with self._lock:
            self._add_reject(rows)

    def rejected_total(self) -> int:
        """The rejection count alone, for the autoscaler's shed signal:
        snapshot() does percentile math, too heavy for a control tick."""
        with self._lock:
            return self._rejected_requests

    def record_shadow(self, live_version: str, shadow_version: str,
                      rows: int, agree_rows: int,
                      max_abs_diff: float) -> None:
        """One shadowed batch compared: the rows whose argmax agreed
        between live and candidate, and the largest logit gap."""
        with self._lock:
            s = self._shadow.setdefault(
                f"{live_version}->{shadow_version}",
                {"batches": 0, "rows": 0, "agree_rows": 0,
                 "max_abs_diff": 0.0})
            s["batches"] += 1
            s["rows"] += rows
            s["agree_rows"] += agree_rows
            s["max_abs_diff"] = max(s["max_abs_diff"], max_abs_diff)

    def record_shadow_error(self) -> None:
        """A shadow dispatch or fetch failed (swallowed: live traffic is
        untouched, but a broken candidate must show)."""
        with self._lock:
            self._shadow_errors += 1

    def record_shadow_drop(self) -> None:
        """A sampled batch skipped its duplicate at the outstanding-shadow
        cap (a slow candidate)."""
        with self._lock:
            self._shadow_dropped += 1

    def record_deadline_shed(self, rows: int = 1) -> None:
        """One request shed on an expired client deadline before dispatch
        (504, zero device work)."""
        with self._lock:
            self._add_deadline_shed(rows)

    def record_bisect_split(self) -> None:
        """One failed segment split in two for retry."""
        with self._lock:
            self._bisect_splits += 1

    def record_poison_isolated(self, rows: int = 1) -> None:
        """One culprit isolated to its singleton dispatch, failed alone."""
        with self._lock:
            self._add_poison_isolated(rows)

    def record_isolated_culprit(self, rows: int, riders: int) -> None:
        """One isolated culprit and its `riders` (failed as plain
        dispatch errors) under one acquisition."""
        with self._lock:
            self._add_poison_isolated(rows)
            self._dispatch_error_requests += riders

    def record_bisect_rescued(self, requests: int, rows: int) -> None:
        """One sub-segment of a bisected batch dispatched clean."""
        with self._lock:
            self._bisect_rescued_requests += requests
            self._bisect_rescued_rows += rows

    def record_dispatch_error(self, requests: int) -> None:
        """A whole segment failed at dispatch without isolation."""
        with self._lock:
            self._dispatch_error_requests += requests

    def record_fetch_error(self, requests: int) -> None:
        with self._lock:
            self._fetch_error_requests += requests

    def record_breaker_trip(self, version: str) -> None:
        """One circuit-breaker trip, attributed to its version."""
        with self._lock:
            self._breaker_trips += 1
            if version is not None:
                self._breaker_trips_by_version[version] = (
                    self._breaker_trips_by_version.get(version, 0) + 1)

    def record_rollback(self, from_version: str, to_version: str) -> None:
        """The breaker's trip demoted `from_version` and promoted
        `to_version`. "at" is wall clock, for display only."""
        with self._lock:
            self._rollbacks += 1
            self._last_rollback = {"from": from_version, "to": to_version,
                                   # lint: allow[DML004] wall-clock event stamp for operators
                                   "at": round(time.time(), 3)}

    # -- fleet hooks (called by serve/fleet.py) ----------------------------

    def record_failover(self, kind: str, from_replica: str,
                        to_replica: str) -> None:
        """One batch rescued on a sibling after its replica died at
        `kind` ('dispatch' or 'fetch'). "at" is wall clock, for display
        only."""
        with self._lock:
            self._failovers[kind] = self._failovers.get(kind, 0) + 1
            self._last_failover = {"kind": kind, "from": from_replica,
                                   "to": to_replica,
                                   # lint: allow[DML004] wall-clock event stamp for operators
                                   "at": round(time.time(), 3)}

    def record_hedge(self, win: bool) -> None:
        """One hedged fetch resolved; win: the duplicate beat the overdue
        primary."""
        with self._lock:
            self._hedges += 1
            if win:
                self._hedge_wins += 1

    def record_replica_trip(self, replica: str) -> None:
        """A replica's breaker tripped (excluded for its cooldown)."""
        with self._lock:
            self._replica_trips[replica] = (
                self._replica_trips.get(replica, 0) + 1)

    # -- reporting ---------------------------------------------------------

    # -- tenancy hooks (called by the GlobalScheduler) ---------------------


    def record_autoscale_scale(self, units: int) -> None:
        """The autoscaler's starting scale, in actuator units (window
        slots or workers)."""
        with self._lock:
            self._autoscale_scale = units

    def record_autoscale_action(self, direction: str, units: int,
                                price_chip_s: float) -> None:
        """One applied scale action: its direction (grow|shrink), the
        achieved scale and its price in chip-seconds per second."""
        with self._lock:
            self._autoscale_scale = units
            self._autoscale_decisions[direction] = (
                self._autoscale_decisions.get(direction, 0) + 1)
            self._autoscale_last_cost = price_chip_s

    def record_autoscale_suppressed(self) -> None:
        """A decision the cooldown window suppressed."""
        with self._lock:
            self._autoscale_suppressed += 1

    def record_autoscale_saturated(self) -> None:
        """A tick that wanted to grow past the hard ceiling."""
        with self._lock:
            self._autoscale_saturated += 1
    def _tenant_stats(self, tenant: str) -> dict:
        # caller holds the lock
        return self._by_tenant.setdefault(tenant, {
            "requests": 0, "rows": 0, "dispatched_rows": 0,
            "quota_sheds": 0, "watermark_sheds": 0, "deadline_sheds": 0,
            "shed_rows": 0, "cache_hits": 0, "slo_hits": 0,
            "slo_total": 0,
            "lat": deque(maxlen=min(self._max_samples, 10_000))})

    def _model_stats(self, model: str) -> dict:
        # caller holds the lock
        return self._by_model.setdefault(
            model, {"requests": 0, "rows": 0, "dispatched_rows": 0})

    def record_tenant_request(self, tenant: str, model: str,
                              rows: int = 1) -> None:
        """One request admitted (or cache-served) for a tenant, routed
        to a model: the demand side of by_tenant/by_model."""
        with self._lock:
            self._add_tenant_request(tenant, model, rows)

    def record_tenant_shed(self, tenant: str, kind: str,
                           rows: int = 1) -> None:
        """One tenant request shed, kind in {"quota" (429), "watermark"
        (503), "deadline" (504)}: the per-tenant attribution beside the
        global counters the scheduler records separately."""
        with self._lock:
            self._add_tenant_shed(tenant, kind, rows)

    def record_tenant_refusal(self, tenant: str, kind: str,
                              rows: int = 1) -> None:
        """One tenant request shed, under one acquisition with the
        global counter of its kind: "deadline" the deadline sheds,
        "watermark" the rejections, "quota" none."""
        with self._lock:
            self._add_tenant_shed(tenant, kind, rows)
            if kind == "deadline":
                self._add_deadline_shed(rows)
            elif kind == "watermark":
                self._add_reject(rows)

    def record_tenant_cache_served(self, tenant: str, model: str,
                                   rows: int = 1) -> None:
        """A would-be quota/watermark shed served from the cache: its
        cache hit and its request under one acquisition."""
        with self._lock:
            self._tenant_stats(tenant)["cache_hits"] += 1
            self._add_tenant_request(tenant, model, rows)

    def record_tenant_dispatch(self, tenant: str, model: str,
                               rows: int) -> None:
        """Rows granted to a tenant by one scheduler decision: the
        service side, the fairness ratio's numerator."""
        with self._lock:
            self._tenant_stats(tenant)["dispatched_rows"] += rows
            self._model_stats(model)["dispatched_rows"] += rows

    def record_tenant_cache_hit(self, tenant: str,
                                rows: int = 1) -> None:
        """A would-be quota/watermark shed served from the cache."""
        with self._lock:
            self._tenant_stats(tenant)["cache_hits"] += 1

    def record_tenant_done(self, tenant: str, seconds: float,
                           slo_ok=None) -> None:
        """One tenant request resolved, admission to resolution;
        `slo_ok` None (a best-effort class) stays out of attainment."""
        with self._lock:
            t = self._tenant_stats(tenant)
            t["lat"].append(seconds)
            if slo_ok is not None:
                t["slo_total"] += 1
                if slo_ok:
                    t["slo_hits"] += 1

    def snapshot(self) -> dict:
        # Copy under the lock; percentile math after releasing it, so a
        # snapshot never stalls the recording hooks on the hot path.
        with self._lock:
            elapsed = max(time.monotonic() - self._t0, 1e-9)
            lat = list(self._lat_s)
            staging = list(self._staging_s)
            fetch = list(self._fetch_s)
            occupancy_raw = {b: tuple(v)
                             for b, v in self._occupancy.items()}
            by_version_raw = {
                v: {"requests": s["requests"], "rows": s["rows"],
                    "batches": s["batches"], "lat": list(s["lat"])}
                for v, s in self._by_version.items()}
            by_dtype = {d: dict(s) for d, s in self._by_dtype.items()}
            by_replica = {r: dict(s) for r, s in self._by_replica.items()}
            stage_rows = {st: dict(s)
                          for st, s in self._cascade_stage_rows.items()}
            shadow_raw = {pair: dict(s) for pair, s in self._shadow.items()}
            by_tenant_raw = {
                t: {**{k: v for k, v in s.items() if k != "lat"},
                    "lat": list(s["lat"])}
                for t, s in self._by_tenant.items()}
            by_model = {m: dict(s) for m, s in self._by_model.items()}
            c = {
                "requests": self._requests, "rows": self._rows,
                "batches": self._batches,
                "dispatched_rows": self._dispatched_rows,
                "padded_rows": self._padded_rows,
                "wait_last_s": self._wait_last_s,
                "wait_sum_s": self._wait_sum_s, "wait_n": self._wait_n,
                "depth_sum": self._depth_sum, "depth_max": self._depth_max,
                "rejected_requests": self._rejected_requests,
                "rejected_rows": self._rejected_rows,
                "inflight_sum": self._inflight_sum,
                "inflight_max": self._inflight_max,
                "dispatches": self._dispatches,
                "dispatch_error_requests": self._dispatch_error_requests,
                "fetch_error_requests": self._fetch_error_requests,
                "shadow_errors": self._shadow_errors,
                "shadow_dropped": self._shadow_dropped,
                "deadline_shed_requests": self._deadline_shed_requests,
                "deadline_shed_rows": self._deadline_shed_rows,
                "bisect_splits": self._bisect_splits,
                "poison_isolated_requests":
                    self._poison_isolated_requests,
                "poison_isolated_rows": self._poison_isolated_rows,
                "bisect_rescued_requests": self._bisect_rescued_requests,
                "bisect_rescued_rows": self._bisect_rescued_rows,
                "breaker_trips": self._breaker_trips,
                "breaker_trips_by_version":
                    dict(self._breaker_trips_by_version),
                "rollbacks": self._rollbacks,
                "last_rollback": self._last_rollback,
                "cache_hit_requests": self._cache_hit_requests,
                "cache_hit_rows": self._cache_hit_rows,
                "cache_collapsed_requests":
                    self._cache_collapsed_requests,
                "dedup_requests": self._dedup_requests,
                "dedup_rows": self._dedup_rows,
                "fastpath_dispatches": self._fastpath_dispatches,
                "fastpath_rows": self._fastpath_rows,
                "failovers": dict(self._failovers),
                "last_failover": self._last_failover,
                "hedges": self._hedges,
                "hedge_wins": self._hedge_wins,
                "autoscale_scale": self._autoscale_scale,
                "autoscale_decisions": dict(self._autoscale_decisions),
                "autoscale_suppressed": self._autoscale_suppressed,
                "autoscale_saturated": self._autoscale_saturated,
                "autoscale_last_cost": self._autoscale_last_cost,
                "replica_trips": dict(self._replica_trips),
                "cascade_class": dict(self._cascade_class),
                "cascade_escalated_requests":
                    self._cascade_escalated_requests,
                "cascade_escalated_rows": self._cascade_escalated_rows,
                "cascade_degraded": self._cascade_degraded,
            }
        # escalated rows over cheap-stage rows (None before any cascade
        # traffic)
        cheap_stage_rows = sum(s["rows"] for st, s in stage_rows.items()
                               if st != "float32")
        total_tenant_dispatched = sum(
            s["dispatched_rows"] for s in by_tenant_raw.values())
        return {
            "window_s": round(elapsed, 3),
            "requests": c["requests"],
            "rows": c["rows"],
            "batches": c["batches"],
            "requests_per_sec": round(c["requests"] / elapsed, 2),
            "rows_per_sec": round(c["rows"] / elapsed, 2),
            "latency_ms": _ms(percentiles(lat)),
            "batch_occupancy": {
                str(b): {"batches": n, "rows": rows,
                         "occupancy": round(rows / (n * b), 4)}
                for b, (n, rows) in sorted(occupancy_raw.items())},
            "dispatched_rows": c["dispatched_rows"],
            "padded_rows": c["padded_rows"],
            "padding_waste_ratio": (
                round(c["padded_rows"] / c["dispatched_rows"], 4)
                if c["dispatched_rows"] else None),
            "bucket_dispatches": {
                str(b): n for b, (n, _) in sorted(occupancy_raw.items())},
            "effective_wait_us": {
                "last": (round(c["wait_last_s"] * 1e6, 1)
                         if c["wait_n"] else None),
                "mean": (round(c["wait_sum_s"] / c["wait_n"] * 1e6, 1)
                         if c["wait_n"] else None),
            },
            "mean_rows_per_batch": (round(c["rows"] / c["batches"], 2)
                                    if c["batches"] else None),
            "queue_depth_mean": (round(c["depth_sum"] / c["batches"], 2)
                                 if c["batches"] else None),
            "queue_depth_max": c["depth_max"],
            "rejected_requests": c["rejected_requests"],
            "rejected_rows": c["rejected_rows"],
            "staging_ms": _ms(percentiles(staging)),
            "fetch_ms": _ms(percentiles(fetch)),
            "inflight_mean": (round(c["inflight_sum"] / c["dispatches"], 2)
                              if c["dispatches"] else None),
            "inflight_max": c["inflight_max"],
            "by_version": {
                v: {"requests": s["requests"], "rows": s["rows"],
                    "batches": s["batches"],
                    "latency_ms": _ms(percentiles(s["lat"]))}
                for v, s in sorted(by_version_raw.items())},
            "shadow": {
                pair: {**s,
                       "agreement": (round(s["agree_rows"] / s["rows"], 4)
                                     if s["rows"] else None),
                       "max_abs_diff": round(s["max_abs_diff"], 6)}
                for pair, s in sorted(shadow_raw.items())},
            "shadow_errors": c["shadow_errors"],
            "shadow_dropped": c["shadow_dropped"],
            "by_replica": {r: s for r, s in sorted(by_replica.items())},
            "by_dtype": {d: s for d, s in sorted(by_dtype.items())},
            # per-tenant demand, sheds by kind, granted service (its
            # share is the fairness ratio's numerator) and SLO
            # attainment; per-model demand across the catalog
            "by_tenant": {
                t: {**{k: v for k, v in s.items() if k != "lat"},
                    "dispatch_share": (
                        round(s["dispatched_rows"]
                              / total_tenant_dispatched, 4)
                        if total_tenant_dispatched else None),
                    "slo_attainment": (
                        round(s["slo_hits"] / s["slo_total"], 4)
                        if s["slo_total"] else None),
                    "latency_ms": _ms(percentiles(s["lat"]))}
                for t, s in sorted(by_tenant_raw.items())},
            "by_model": {m: s for m, s in sorted(by_model.items())},
            "cache_served": {
                "hit_requests": c["cache_hit_requests"],
                "hit_rows": c["cache_hit_rows"],
                "collapsed_requests": c["cache_collapsed_requests"],
            },
            "dedup": {"requests": c["dedup_requests"],
                      "rows": c["dedup_rows"]},
            # lane_fraction near 1 at low load and near 0 under sustained
            # traffic is the designed shape
            "fastpath": {
                "dispatches": c["fastpath_dispatches"],
                "rows": c["fastpath_rows"],
                "lane_fraction": (
                    round(c["fastpath_dispatches"] / c["requests"], 4)
                    if c["requests"] else None),
            },
            "cascade": {
                "by_class": {k: v for k, v in
                             sorted(c["cascade_class"].items())},
                "stage_rows": {st: s for st, s in
                               sorted(stage_rows.items())},
                "escalated_requests": c["cascade_escalated_requests"],
                "escalated_rows": c["cascade_escalated_rows"],
                "degraded_requests": c["cascade_degraded"],
                "escalation_fraction": (
                    round(c["cascade_escalated_rows"] / cheap_stage_rows,
                          4) if cheap_stage_rows else None),
            },
            "fleet": {
                "failovers": c["failovers"],
                "failovers_total": sum(c["failovers"].values()),
                "last_failover": c["last_failover"],
                "hedges": c["hedges"],
                "hedge_wins": c["hedge_wins"],
                "replica_trips": sum(c["replica_trips"].values()),
                "replica_trips_by_replica": c["replica_trips"],
            },
            # the control loop's operating point: scale in actuator
            # units, applied decisions by direction, cooldown-suppressed
            # decisions, ceiling-hit ticks and the last action's price
            "autoscale": {
                "scale": c["autoscale_scale"],
                "decisions": {k: v for k, v in
                              sorted(c["autoscale_decisions"].items())},
                "suppressed": c["autoscale_suppressed"],
                "saturated_ticks": c["autoscale_saturated"],
                "last_cost_chip_s": c["autoscale_last_cost"],
            },
            "resilience": {
                "deadline_shed_requests": c["deadline_shed_requests"],
                "deadline_shed_rows": c["deadline_shed_rows"],
                "bisect_splits": c["bisect_splits"],
                "poison_isolated_requests":
                    c["poison_isolated_requests"],
                "poison_isolated_rows": c["poison_isolated_rows"],
                "bisect_rescued_requests": c["bisect_rescued_requests"],
                "bisect_rescued_rows": c["bisect_rescued_rows"],
                "dispatch_error_requests": c["dispatch_error_requests"],
                "fetch_error_requests": c["fetch_error_requests"],
                "breaker_trips": c["breaker_trips"],
                "breaker_trips_by_version":
                    c["breaker_trips_by_version"],
                "rollbacks": c["rollbacks"],
                "last_rollback": c["last_rollback"],
            },
        }

    def record(self) -> dict:
        """The heartbeat record: the snapshot under the conventional
        'metric' key."""
        return {"metric": "serve_stats", **self.snapshot()}

    def heartbeat_line(self) -> str:
        return MetricsLogger.summary_line(self.record())


# -- Prometheus text exposition ---------------------------------------------

# The p-keys utils.percentiles emits, as Prometheus quantile labels.
_PROM_QUANTILES = {"p50": "0.5", "p95": "0.95", "p99": "0.99"}

# One-line # HELP text per family, the JAX package's; a name absent here
# falls back to a generated line, so no family ships without HELP.
_PROM_HELP = {
    "dmnist_serve_requests_total":
        "Requests served (computed fan-outs plus cache hits).",
    "dmnist_serve_rows_total": "Image rows served.",
    "dmnist_serve_batches_total": "Engine batches fetched.",
    "dmnist_serve_rejected_requests_total":
        "Requests shed at the queue watermark (503).",
    "dmnist_serve_rejected_rows_total":
        "Rows shed at the queue watermark.",
    "dmnist_serve_dispatched_rows_total":
        "Bucket slots executed on the device (incl. padding).",
    "dmnist_serve_padded_rows_total":
        "Executed bucket slots that were padding, not real rows.",
    "dmnist_serve_requests_per_second":
        "Request rate over the current metrics window.",
    "dmnist_serve_rows_per_second":
        "Row rate over the current metrics window.",
    "dmnist_serve_padding_waste_ratio":
        "Fraction of executed slots burned on padding.",
    "dmnist_serve_inflight_max":
        "Max dispatched-but-unfetched pipeline depth observed.",
    "dmnist_serve_queue_depth_max":
        "Max pending-row queue depth observed at batch record time.",
    "dmnist_serve_latency_ms":
        "End-to-end request latency quantiles, milliseconds.",
    "dmnist_serve_staging_ms":
        "Host staging (pad + device_put + enqueue) quantiles, ms.",
    "dmnist_serve_fetch_ms":
        "Blocking device-to-host fetch quantiles, milliseconds.",
    "dmnist_serve_bucket_dispatches_total":
        "Batches dispatched per compile bucket.",
    "dmnist_serve_version_requests_total":
        "Requests served per model version (canary separability).",
    "dmnist_serve_replica_batches_total":
        "Batches computed per fleet replica.",
    "dmnist_serve_dtype_batches_total":
        "Batches computed per serving precision.",
    "dmnist_serve_shadow_errors_total":
        "Shadow-candidate dispatch/fetch failures (swallowed).",
    "dmnist_serve_deadline_shed_requests_total":
        "Requests shed before dispatch on an expired deadline (504).",
    "dmnist_serve_bisect_splits_total":
        "Failed segments split in half for poison isolation.",
    "dmnist_serve_poison_isolated_requests_total":
        "Culprit requests isolated to a singleton dispatch.",
    "dmnist_serve_bisect_rescued_requests_total":
        "Cohort-mates that re-dispatched clean after a split.",
    "dmnist_serve_dispatch_error_requests_total":
        "Requests failed at dispatch without isolation.",
    "dmnist_serve_fetch_error_requests_total":
        "Requests failed by a batch fetch error.",
    "dmnist_serve_breaker_trips_total": "Circuit-breaker trips.",
    "dmnist_serve_breaker_version_trips_total":
        "Circuit-breaker trips attributed per model version.",
    "dmnist_serve_rollbacks_total":
        "Completed automatic rollbacks to a healthy resident.",
    "dmnist_serve_failovers_total":
        "Batches rescued on a sibling replica, by failure kind.",
    "dmnist_serve_hedges_total": "Hedged duplicate dispatches raced.",
    "dmnist_serve_hedge_wins_total":
        "Hedge races the duplicate won (tail bought back).",
    "dmnist_serve_replica_trips_total":
        "Per-replica circuit-breaker trips.",
    "dmnist_serve_stage_duration_ms":
        "Per-stage request durations derived from trace spans, ms.",
    "dmnist_serve_pending_rows": "Rows pending in the batcher queue.",
    "dmnist_serve_inflight_batches":
        "Dispatch segments popped but not yet fully resolved.",
    "dmnist_serve_cache_hits_total":
        "Prediction-cache lookups served from a cached response.",
    "dmnist_serve_cache_hit_rows_total":
        "Rows served straight from the prediction cache.",
    "dmnist_serve_cache_misses_total":
        "Prediction-cache lookups that missed.",
    "dmnist_serve_cache_collapsed_total":
        "Identical concurrent misses collapsed onto one in-flight "
        "computation (single-flight followers).",
    "dmnist_serve_cache_inserts_total":
        "Computed responses inserted into the prediction cache.",
    "dmnist_serve_cache_evictions_total":
        "LRU evictions past the prediction-cache capacity.",
    "dmnist_serve_cache_invalidations_total":
        "Whole-cache invalidations (promote/rollback/dtype swap).",
    "dmnist_serve_cache_stale_drops_total":
        "Inserts or reads refused because the computing version no "
        "longer matched the live route.",
    "dmnist_serve_cache_hit_ratio":
        "Hits over lookups since process start (None until traffic).",
    "dmnist_serve_cache_entries": "Live prediction-cache entries.",
    "dmnist_serve_cache_inflight_keys":
        "Single-flight computations currently in flight.",
    "dmnist_serve_dedup_requests_total":
        "Intra-batch dedup riders resolved from a representative's "
        "dispatch.",
    "dmnist_serve_dedup_rows_total":
        "Device rows the intra-batch dedup did not dispatch.",
    "dmnist_serve_fastpath_dispatches_total":
        "Requests served through the single-request bypass lane "
        "(dispatched on the caller's thread, no coalesce wait).",
    "dmnist_serve_fastpath_rows_total":
        "Rows served through the bypass lane.",
    "dmnist_serve_fastpath_lane_fraction":
        "Fraction of served requests that took the bypass lane.",
    "dmnist_serve_cache_expired_total":
        "Cache entries that aged past the TTL (expired hits count "
        "as misses).",
    "dmnist_serve_cascade_requests_total":
        "Requests entering the cascade front, by accuracy class "
        "(X-Accuracy-Class: fast / balanced / exact).",
    "dmnist_serve_cascade_stage_rows_total":
        "Rows answered per cascade stage (the cheap dtype counts every "
        "stage-1 row, float32 only the escalated slice).",
    "dmnist_serve_cascade_escalated_requests_total":
        "Balanced requests with at least one row under the calibrated "
        "margin threshold (re-submitted to f32).",
    "dmnist_serve_cascade_escalated_rows_total":
        "Rows escalated to the f32 stage.",
    "dmnist_serve_cascade_escalation_fraction":
        "Escalated rows over cheap-stage rows: the fraction of "
        "stage-1 work the calibrated threshold sent on to f32.",
    "dmnist_serve_cascade_degraded_total":
        "Cascade-front requests served by the plain live route "
        "(no calibrated cascade on the live version).",
    "dmnist_serve_tenant_requests_total":
        "Requests admitted per tenant SLO class.",
    "dmnist_serve_tenant_rows_total":
        "Rows admitted per tenant SLO class.",
    "dmnist_serve_tenant_dispatched_rows_total":
        "Rows the global scheduler granted per tenant (the WFQ "
        "service share's numerator).",
    "dmnist_serve_tenant_sheds_total":
        "Requests shed per tenant by kind: quota (429), watermark "
        "(503), deadline (504 / infeasible-by-cost-model).",
    "dmnist_serve_tenant_cache_hits_total":
        "Would-be sheds rescued by a prediction-cache probe (the "
        "cache-aware shed path; never quota-charged).",
    "dmnist_serve_tenant_dispatch_share":
        "Tenant's fraction of all scheduler-granted rows; divide by "
        "the weight share for the WFQ fairness ratio.",
    "dmnist_serve_tenant_slo_attainment":
        "Fraction of a tenant's completed requests that finished "
        "inside their SLO-class deadline.",
    "dmnist_serve_tenant_latency_ms":
        "Per-tenant end-to-end latency quantiles (enqueue at the "
        "global scheduler to future resolution), milliseconds.",
    "dmnist_serve_model_requests_total":
        "Requests routed per catalog model.",
    "dmnist_serve_model_dispatched_rows_total":
        "Rows the scheduler granted per catalog model.",
    "dmnist_serve_autoscale_scale":
        "Current scale in actuator units (in-flight window slots on a "
        "single host, active workers behind the gateway).",
    "dmnist_serve_autoscale_decisions_total":
        "Actuated scale decisions by direction (grow / shrink).",
    "dmnist_serve_autoscale_suppressed_total":
        "Scale decisions suppressed by the cooldown window (the "
        "anti-flap counter; nonzero under square-wave load is the "
        "hysteresis doing its job).",
    "dmnist_serve_autoscale_saturated_total":
        "Control ticks that wanted to grow past the configured "
        "ceiling — disclosed saturation, not silent queueing.",
    "dmnist_serve_autoscale_last_cost_chip_seconds":
        "Priced cost of the most recent decision: chip-seconds per "
        "second bought (positive) or released (negative), in the "
        "actuator's disclosed cost basis.",
}


def _prom_help(name: str) -> str:
    return _PROM_HELP.get(
        name, name.removeprefix("dmnist_serve_").replace("_", " ") + ".")


def _prom_escape(value: str) -> str:
    return (str(value).replace("\\", r"\\").replace('"', r'\"')
            .replace("\n", r"\n"))


def _prom_line(name: str, labels: dict, value) -> str:
    if labels:
        body = ",".join(f'{k}="{_prom_escape(v)}"'
                        for k, v in sorted(labels.items()))
        return f"{name}{{{body}}} {value}"
    return f"{name} {value}"


def prometheus_exposition(snapshot: dict, trace_stages: dict = None,
                          gauges: dict = None, cache: dict = None) -> str:
    """A ServeMetrics snapshot() as Prometheus text (`GET
    /metrics?format=prometheus`, or a text/plain Accept): counters,
    gauges and summaries with `# HELP` and `# TYPE` lines, the JAX
    package's family names. `trace_stages` (Tracer.snapshot()["stages"])
    adds the per-stage duration histograms, `gauges` point-in-time
    pipeline gauges, `cache` (PredictionCache.stats()) the cache's
    counters. None-valued samples are skipped, never emitted as 0."""
    out: list[str] = []

    def emit(name: str, mtype: str, samples) -> None:
        rows = [(labels, v) for labels, v in samples if v is not None]
        if not rows:
            return
        out.append(f"# HELP {name} {_prom_help(name)}")
        out.append(f"# TYPE {name} {mtype}")
        for labels, v in rows:
            out.append(_prom_line(name, labels, v))

    def summary(name: str, pct: dict, count=None) -> None:
        rows = [({"quantile": q}, pct.get(p))
                for p, q in _PROM_QUANTILES.items()]
        if all(v is None for _, v in rows):
            return
        emit(name, "summary", rows)
        if count is not None:
            out.append(_prom_line(name + "_count", {}, count))

    s = snapshot
    res = s.get("resilience", {})
    for name, mtype, key in (
            ("dmnist_serve_requests_total", "counter", "requests"),
            ("dmnist_serve_rows_total", "counter", "rows"),
            ("dmnist_serve_batches_total", "counter", "batches"),
            ("dmnist_serve_rejected_requests_total", "counter",
             "rejected_requests"),
            ("dmnist_serve_rejected_rows_total", "counter",
             "rejected_rows"),
            ("dmnist_serve_dispatched_rows_total", "counter",
             "dispatched_rows"),
            ("dmnist_serve_padded_rows_total", "counter", "padded_rows"),
            ("dmnist_serve_requests_per_second", "gauge",
             "requests_per_sec"),
            ("dmnist_serve_rows_per_second", "gauge", "rows_per_sec"),
            ("dmnist_serve_padding_waste_ratio", "gauge",
             "padding_waste_ratio"),
            ("dmnist_serve_inflight_max", "gauge", "inflight_max"),
            ("dmnist_serve_queue_depth_max", "gauge", "queue_depth_max")):
        emit(name, mtype, [({}, s.get(key))])
    summary("dmnist_serve_latency_ms", s.get("latency_ms", {}),
            count=s.get("requests"))
    summary("dmnist_serve_staging_ms", s.get("staging_ms", {}))
    summary("dmnist_serve_fetch_ms", s.get("fetch_ms", {}))
    emit("dmnist_serve_bucket_dispatches_total", "counter",
         [({"bucket": b}, n)
          for b, n in s.get("bucket_dispatches", {}).items()])
    emit("dmnist_serve_version_requests_total", "counter",
         [({"version": v}, vs.get("requests"))
          for v, vs in s.get("by_version", {}).items()])
    emit("dmnist_serve_replica_batches_total", "counter",
         [({"replica": r}, rs.get("batches"))
          for r, rs in s.get("by_replica", {}).items()])
    emit("dmnist_serve_dtype_batches_total", "counter",
         [({"dtype": d}, ds.get("batches"))
          for d, ds in s.get("by_dtype", {}).items()])
    emit("dmnist_serve_shadow_errors_total", "counter",
         [({}, s.get("shadow_errors"))])
    for name, key in (
            ("dmnist_serve_deadline_shed_requests_total",
             "deadline_shed_requests"),
            ("dmnist_serve_bisect_splits_total", "bisect_splits"),
            ("dmnist_serve_poison_isolated_requests_total",
             "poison_isolated_requests"),
            ("dmnist_serve_bisect_rescued_requests_total",
             "bisect_rescued_requests"),
            ("dmnist_serve_dispatch_error_requests_total",
             "dispatch_error_requests"),
            ("dmnist_serve_fetch_error_requests_total",
             "fetch_error_requests"),
            ("dmnist_serve_breaker_trips_total", "breaker_trips")):
        emit(name, "counter", [({}, res.get(key))])
    emit("dmnist_serve_breaker_version_trips_total", "counter",
         [({"version": v}, n) for v, n in
          res.get("breaker_trips_by_version", {}).items()])
    emit("dmnist_serve_rollbacks_total", "counter",
         [({}, res.get("rollbacks"))])
    fleet = s.get("fleet", {})
    emit("dmnist_serve_failovers_total", "counter",
         [({"kind": k}, n) for k, n in fleet.get("failovers", {}).items()])
    emit("dmnist_serve_hedges_total", "counter",
         [({}, fleet.get("hedges"))])
    emit("dmnist_serve_hedge_wins_total", "counter",
         [({}, fleet.get("hedge_wins"))])
    emit("dmnist_serve_replica_trips_total", "counter",
         [({"replica": r}, n) for r, n in
          fleet.get("replica_trips_by_replica", {}).items()])
    dd = s.get("dedup", {})
    emit("dmnist_serve_dedup_requests_total", "counter",
         [({}, dd.get("requests"))])
    emit("dmnist_serve_dedup_rows_total", "counter", [({}, dd.get("rows"))])
    fp = s.get("fastpath", {})
    emit("dmnist_serve_fastpath_dispatches_total", "counter",
         [({}, fp.get("dispatches"))])
    emit("dmnist_serve_fastpath_rows_total", "counter",
         [({}, fp.get("rows"))])
    emit("dmnist_serve_fastpath_lane_fraction", "gauge",
         [({}, fp.get("lane_fraction"))])
    ca = s.get("cascade", {})
    emit("dmnist_serve_cascade_requests_total", "counter",
         [({"accuracy_class": cls}, n)
          for cls, n in sorted(ca.get("by_class", {}).items())])
    emit("dmnist_serve_cascade_stage_rows_total", "counter",
         [({"stage": st}, v.get("rows"))
          for st, v in sorted(ca.get("stage_rows", {}).items())])
    emit("dmnist_serve_cascade_escalated_requests_total", "counter",
         [({}, ca.get("escalated_requests"))])
    emit("dmnist_serve_cascade_escalated_rows_total", "counter",
         [({}, ca.get("escalated_rows"))])
    emit("dmnist_serve_cascade_escalation_fraction", "gauge",
         [({}, ca.get("escalation_fraction"))])
    emit("dmnist_serve_cascade_degraded_total", "counter",
         [({}, ca.get("degraded_requests"))])
    bt = s.get("by_tenant", {})
    for name, key in (
            ("dmnist_serve_tenant_requests_total", "requests"),
            ("dmnist_serve_tenant_rows_total", "rows"),
            ("dmnist_serve_tenant_dispatched_rows_total",
             "dispatched_rows")):
        emit(name, "counter",
             [({"tenant": t}, ts.get(key)) for t, ts in bt.items()])
    emit("dmnist_serve_tenant_sheds_total", "counter",
         [({"tenant": t, "kind": kind}, ts.get(f"{kind}_sheds"))
          for t, ts in bt.items()
          for kind in ("quota", "watermark", "deadline")])
    emit("dmnist_serve_tenant_cache_hits_total", "counter",
         [({"tenant": t}, ts.get("cache_hits")) for t, ts in bt.items()])
    emit("dmnist_serve_tenant_dispatch_share", "gauge",
         [({"tenant": t}, ts.get("dispatch_share"))
          for t, ts in bt.items()])
    emit("dmnist_serve_tenant_slo_attainment", "gauge",
         [({"tenant": t}, ts.get("slo_attainment"))
          for t, ts in bt.items()])
    emit("dmnist_serve_tenant_latency_ms", "summary",
         [({"tenant": t, "quantile": q}, ts.get("latency_ms", {}).get(p))
          for t, ts in bt.items()
          for p, q in _PROM_QUANTILES.items()])
    bm = s.get("by_model", {})
    emit("dmnist_serve_model_requests_total", "counter",
         [({"model": m}, ms.get("requests")) for m, ms in bm.items()])
    emit("dmnist_serve_model_dispatched_rows_total", "counter",
         [({"model": m}, ms.get("dispatched_rows"))
          for m, ms in bm.items()])
    # the autoscaler: current scale (absent when none runs), decisions by
    # direction, the cooldown and ceiling counts, the last action's price
    asc = s.get("autoscale", {})
    emit("dmnist_serve_autoscale_scale", "gauge",
         [({}, asc.get("scale") or None)])
    emit("dmnist_serve_autoscale_decisions_total", "counter",
         [({"direction": d}, n)
          for d, n in asc.get("decisions", {}).items()])
    emit("dmnist_serve_autoscale_suppressed_total", "counter",
         [({}, asc.get("suppressed"))])
    emit("dmnist_serve_autoscale_saturated_total", "counter",
         [({}, asc.get("saturated_ticks"))])
    emit("dmnist_serve_autoscale_last_cost_chip_seconds", "gauge",
         [({}, asc.get("last_cost_chip_s") or None)])
    if cache:
        for name, mtype, key in (
                ("dmnist_serve_cache_hits_total", "counter", "hits"),
                ("dmnist_serve_cache_hit_rows_total", "counter",
                 "hit_rows"),
                ("dmnist_serve_cache_misses_total", "counter", "misses"),
                ("dmnist_serve_cache_collapsed_total", "counter",
                 "collapsed"),
                ("dmnist_serve_cache_inserts_total", "counter",
                 "inserts"),
                ("dmnist_serve_cache_evictions_total", "counter",
                 "evictions"),
                ("dmnist_serve_cache_invalidations_total", "counter",
                 "invalidations"),
                ("dmnist_serve_cache_stale_drops_total", "counter",
                 "stale_drops"),
                ("dmnist_serve_cache_expired_total", "counter",
                 "expired"),
                ("dmnist_serve_cache_entries", "gauge", "entries"),
                ("dmnist_serve_cache_inflight_keys", "gauge",
                 "inflight_keys"),
                ("dmnist_serve_cache_hit_ratio", "gauge", "hit_ratio")):
            emit(name, mtype, [({}, cache.get(key))])
    for name, value in (gauges or {}).items():
        emit(f"dmnist_serve_{name}", "gauge", [({}, value)])
    # per-stage histograms from the trace spans, cumulative buckets per
    # the Prometheus histogram contract
    if trace_stages:
        name = "dmnist_serve_stage_duration_ms"
        out.append(f"# HELP {name} {_prom_help(name)}")
        out.append(f"# TYPE {name} histogram")
        for stage, h in sorted(trace_stages.items()):
            cum = 0
            for le, count in h["buckets"].items():
                cum += count
                out.append(_prom_line(name + "_bucket",
                                      {"stage": stage, "le": le}, cum))
            out.append(_prom_line(name + "_sum", {"stage": stage},
                                  h["sum_ms"]))
            out.append(_prom_line(name + "_count", {"stage": stage},
                                  h["count"]))
    return "\n".join(out) + "\n"


_GATEWAY_PROM_HELP = {
    "dmnist_gateway_requests_total":
        "Requests admitted by the gateway's routing layer.",
    "dmnist_gateway_routed_affinity_total":
        "Requests routed to their consistent-hash ring owner (the "
        "sharded-cache path).",
    "dmnist_gateway_routed_balanced_total":
        "Requests routed by the cost-aware least-loaded fallback "
        "(no computable ring key, or owners dead/cooled).",
    "dmnist_gateway_failovers_total":
        "Mid-request worker failures that entered the one-redispatch "
        "failover path.",
    "dmnist_gateway_failover_rescued_total":
        "Failovers whose redispatch to the next ring owner answered.",
    "dmnist_gateway_backpressure_503_total":
        "Requests shed because the target worker's in-flight window "
        "was full (spilling an affinity key would duplicate its "
        "cache entry).",
    "dmnist_gateway_paused_503_total":
        "Requests shed waiting out a fleet-promote admission pause.",
    "dmnist_gateway_mixed_epoch_rejected_total":
        "Worker replies rejected because their X-Cluster-Epoch did "
        "not match the epoch the request was admitted under (must "
        "stay zero; the two-phase promote barrier makes the path "
        "unreachable).",
    "dmnist_gateway_worker_deaths_total":
        "Workers removed from the ring after dying (process exit or "
        "connection refused).",
    "dmnist_gateway_promotes_total":
        "Completed fleet-wide two-phase promotes.",
    "dmnist_gateway_cluster_epoch":
        "The gateway's current cluster epoch (bumped once per "
        "fleet-wide promote flip).",
    "dmnist_gateway_workers": "Workers spawned (alive or dead).",
    "dmnist_gateway_workers_active": "Workers in the dispatch set.",
    "dmnist_gateway_worker_inflight":
        "Requests currently dispatched to each worker.",
    "dmnist_gateway_worker_dispatched_total":
        "Requests each worker answered (including rescues).",
    "dmnist_gateway_worker_rescued_total":
        "Failover rescues each worker absorbed.",
    "dmnist_gateway_worker_failures_total":
        "Failed round trips attributed to each worker.",
}


def gateway_prometheus_exposition(snapshot: dict) -> str:
    """Gateway.snapshot() as Prometheus text, the `dmnist_gateway_*`
    families (the JAX package's names): # HELP/# TYPE pairs,
    None-valued samples skipped, per-worker series labelled
    worker=<rid>."""
    out: list[str] = []

    def emit(name: str, mtype: str, samples) -> None:
        rows = [(labels, v) for labels, v in samples if v is not None]
        if not rows:
            return
        help_text = _GATEWAY_PROM_HELP.get(
            name,
            name.removeprefix("dmnist_gateway_").replace("_", " ") + ".")
        out.append(f"# HELP {name} {help_text}")
        out.append(f"# TYPE {name} {mtype}")
        for labels, v in rows:
            out.append(_prom_line(name, labels, v))

    s = snapshot
    for key in ("requests", "routed_affinity", "routed_balanced",
                "failovers", "failover_rescued", "backpressure_503",
                "paused_503", "mixed_epoch_rejected", "worker_deaths",
                "promotes"):
        emit(f"dmnist_gateway_{key}_total", "counter", [({}, s.get(key))])
    emit("dmnist_gateway_cluster_epoch", "gauge",
         [({}, s.get("cluster_epoch"))])
    emit("dmnist_gateway_workers", "gauge", [({}, s.get("workers"))])
    emit("dmnist_gateway_workers_active", "gauge",
         [({}, s.get("workers_active"))])
    per = s.get("per_worker") or []
    emit("dmnist_gateway_worker_inflight", "gauge",
         [({"worker": w["worker"]}, w.get("inflight")) for w in per])
    emit("dmnist_gateway_worker_dispatched_total", "counter",
         [({"worker": w["worker"]}, w.get("dispatched")) for w in per])
    emit("dmnist_gateway_worker_rescued_total", "counter",
         [({"worker": w["worker"]}, w.get("rescued")) for w in per])
    emit("dmnist_gateway_worker_failures_total", "counter",
         [({"worker": w["worker"]}, w.get("failures")) for w in per])
    return "\n".join(out) + "\n"
