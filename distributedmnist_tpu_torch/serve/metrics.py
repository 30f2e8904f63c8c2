"""Serving observability core: per-request latency percentiles, batch
occupancy per bucket, queue depth, the staging/fetch pipeline split,
requests/sec, the per-version populations (live and canary apart), the
shadow comparisons and the deadline sheds — the ServeMetrics snapshot
the selftest summary, the HTTP server's /metrics and its heartbeat lines
carry (the core of the JAX package's serve/metrics.py, with its key
names; its Prometheus exposition is not ported yet, ROADMAP §1 item 6).

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
            self._by_dtype: dict[str, dict] = {}
            self._dispatch_error_requests = 0
            self._fetch_error_requests = 0
            # "live->shadow" pair -> comparison totals; failed and
            # cap-dropped duplicates
            self._shadow: dict[str, dict] = {}
            self._shadow_errors = 0
            self._shadow_dropped = 0
            self._deadline_shed_requests = 0
            self._deadline_shed_rows = 0

    # -- recording hooks (called by the batcher) ---------------------------

    def _version_stats(self, version: str) -> dict:
        # caller holds the lock
        return self._by_version.setdefault(version, {
            "requests": 0, "rows": 0, "batches": 0,
            "lat": deque(maxlen=min(self._max_samples, 10_000))})

    def record_latency(self, seconds: float, rows: int = 1,
                       version: str = None) -> None:
        with self._lock:
            self._lat_s.append(seconds)
            self._requests += 1
            self._rows += rows
            if version is not None:
                v = self._version_stats(version)
                v["requests"] += 1
                v["rows"] += rows
                v["lat"].append(seconds)

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
                     version: str = None, infer_dtype: str = None) -> None:
        with self._lock:
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
            if infer_dtype is not None:
                s = self._by_dtype.setdefault(infer_dtype,
                                              {"batches": 0, "rows": 0})
                s["batches"] += 1
                s["rows"] += rows

    def record_wait(self, seconds: float) -> None:
        """The effective coalescing wait one drain used."""
        with self._lock:
            self._wait_last_s = seconds
            self._wait_sum_s += seconds
            self._wait_n += 1

    def record_reject(self, rows: int = 1) -> None:
        with self._lock:
            self._rejected_requests += 1
            self._rejected_rows += rows

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
            self._deadline_shed_requests += 1
            self._deadline_shed_rows += rows

    def record_dispatch_error(self, requests: int) -> None:
        with self._lock:
            self._dispatch_error_requests += requests

    def record_fetch_error(self, requests: int) -> None:
        with self._lock:
            self._fetch_error_requests += requests

    # -- reporting ---------------------------------------------------------

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
            shadow_raw = {pair: dict(s) for pair, s in self._shadow.items()}
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
            }
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
            "by_dtype": {d: s for d, s in sorted(by_dtype.items())},
            # the JAX snapshot's block, with the counters the port has
            # (bisection and the breaker are ROADMAP §1 item 6)
            "resilience": {
                "deadline_shed_requests": c["deadline_shed_requests"],
                "deadline_shed_rows": c["deadline_shed_rows"],
                "dispatch_error_requests": c["dispatch_error_requests"],
                "fetch_error_requests": c["fetch_error_requests"],
            },
        }

    def record(self) -> dict:
        """The heartbeat record: the snapshot under the conventional
        'metric' key."""
        return {"metric": "serve_stats", **self.snapshot()}

    def heartbeat_line(self) -> str:
        return MetricsLogger.summary_line(self.record())
