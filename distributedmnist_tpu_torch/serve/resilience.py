"""Serving resilience (the port of the JAX package's serve/resilience.py,
same names and behaviour): the deadline shed, bisection's switch, the
per-version circuit breaker with auto-rollback, and the health tracker.

- **DeadlineExceeded**: a request may carry a client deadline (the HTTP
  server's X-Deadline-Ms). One that has passed at submit, or passes while
  it waits in the queue, is shed before dispatch: 504, zero device work.
- **Bisection** (the mechanics live in the batcher, switched by
  ResiliencePolicy.bisect): a failed multi-request dispatch is retried as
  recursively split halves along request boundaries, onto rungs already
  on the ladder, so only the culprit request fails.
- **CircuitBreaker**: a sliding-window failure ratio per version. A trip
  on the live version calls the registry's rollback(from_version,
  reason) on a thread of its own, which promotes the newest healthy
  resident; the trip and the rollback are recorded in metrics.
- **HealthTracker**: an n-weighted success ratio and a latency EWMA per
  key, for the replica fleet's pick (serve/fleet.py).

Every time-dependent call takes `now` (time.monotonic() by default), so
tests drive windows and cooldowns with an injected clock.
"""

from __future__ import annotations

import logging
import time
from collections import deque
from typing import Optional

from distributedmnist_tpu_torch.analysis.locks import make_lock, make_thread

log = logging.getLogger("distributedmnist_tpu_torch")


class DeadlineExceeded(RuntimeError):
    """The request's client deadline passed before its batch dispatched:
    shed with 504 semantics (the HTTP server adds a Retry-After derived
    from the pipeline's state)."""

    status = 504


class CircuitBreaker:
    """Sliding-window failure-ratio breaker, one window per version.

    record(version, ok) feeds every request outcome; it returns True
    exactly when THIS record tripped the breaker for that version —
    failures/window >= failure_ratio with at least min_requests of
    volume inside window_s. A tripped version enters a cooldown during
    which it cannot re-trip (the rollback it triggered needs time to
    take effect; re-tripping on the tail of in-flight failures would
    flap). Thread-safe: outcomes arrive from the completion thread,
    snapshots from HTTP threads.
    """

    def __init__(self, window_s: float = 5.0, min_requests: int = 20,
                 failure_ratio: float = 0.5, cooldown_s: float = 30.0):
        if window_s <= 0:
            raise ValueError(f"window_s must be > 0, got {window_s}")
        if min_requests < 1:
            raise ValueError(
                f"min_requests must be >= 1, got {min_requests}")
        if not 0.0 < failure_ratio <= 1.0:
            raise ValueError(
                f"failure_ratio must be in (0, 1], got {failure_ratio}")
        if cooldown_s < 0:
            raise ValueError(f"cooldown_s must be >= 0, got {cooldown_s}")
        self.window_s = window_s
        self.min_requests = min_requests
        self.failure_ratio = failure_ratio
        self.cooldown_s = cooldown_s
        self._lock = make_lock("resilience.breaker")
        # version -> deque[(t, ok, n)] — n-weighted so one failed batch
        # of k requests carries its real volume
        self._windows: dict[str, deque] = {}
        self._cooldown_until: dict[str, float] = {}
        self._trips = 0

    def record(self, version: str, ok: bool, n: int = 1,
               now: Optional[float] = None) -> bool:
        if now is None:
            now = time.monotonic()
        with self._lock:
            win = self._windows.setdefault(version, deque())
            win.append((now, ok, n))
            cutoff = now - self.window_s
            while win and win[0][0] < cutoff:
                win.popleft()
            if now < self._cooldown_until.get(version, 0.0):
                return False
            total = sum(w[2] for w in win)
            if total < self.min_requests:
                return False
            failures = sum(w[2] for w in win if not w[1])
            if failures / total < self.failure_ratio:
                return False
            # Trip: start the cooldown and clear the window so the
            # in-flight failure tail doesn't immediately re-accumulate.
            self._trips += 1
            self._cooldown_until[version] = now + self.cooldown_s
            win.clear()
            return True

    def trips(self) -> int:
        with self._lock:
            return self._trips

    def in_cooldown(self, key: str, now: Optional[float] = None) -> bool:
        """True while `key` (a version, or a replica id in the fleet's
        per-replica breaker) is inside a trip's cooldown — the fleet's
        dispatch pick excludes such replicas instead of waiting for
        their failures to resolve futures."""
        if now is None:
            now = time.monotonic()
        with self._lock:
            return now < self._cooldown_until.get(key, 0.0)

    def reset(self, key: str) -> None:
        """Forget `key`'s window AND cooldown: an operator rejoining a
        drained/repaired replica gets a fresh health slate — old
        failures from before the repair must not re-trip it on its
        first post-rejoin batch."""
        with self._lock:
            self._windows.pop(key, None)
            self._cooldown_until.pop(key, None)

    def snapshot(self) -> dict:
        with self._lock:
            now = time.monotonic()
            return {
                "window_s": self.window_s,
                "min_requests": self.min_requests,
                "failure_ratio": self.failure_ratio,
                "trips": self._trips,
                "by_version": {
                    v: {"volume": sum(w[2] for w in win),
                        "failures": sum(w[2] for w in win if not w[1]),
                        "cooldown_remaining_s": round(max(
                            self._cooldown_until.get(v, 0.0) - now,
                            0.0), 3)}
                    for v, win in self._windows.items()},
            }


class HealthTracker:
    """Per-key sliding-window health score: n-weighted
    success ratio over the last `window_s` seconds plus a latency EWMA.

    The replica fleet (serve/fleet.py) records every batch outcome here,
    keyed by replica id, beside a per-replica CircuitBreaker: the breaker
    decides EXCLUSION (binary, with cooldown hysteresis), the tracker
    keeps the continuous score an operator reads off /healthz to see a
    replica degrading BEFORE it trips. score() is 1.0 with no data —
    an idle replica is presumed healthy, not suspect. Thread-safe.
    """

    def __init__(self, window_s: float = 30.0, ewma_alpha: float = 0.2):
        if window_s <= 0:
            raise ValueError(f"window_s must be > 0, got {window_s}")
        if not 0.0 < ewma_alpha <= 1.0:
            raise ValueError(
                f"ewma_alpha must be in (0, 1], got {ewma_alpha}")
        self.window_s = window_s
        self.ewma_alpha = ewma_alpha
        self._lock = make_lock("resilience.health")
        self._windows: dict[str, deque] = {}   # key -> (t, ok, n)
        self._ewma_s: dict[str, float] = {}

    def record(self, key: str, ok: bool, n: int = 1,
               latency_s: Optional[float] = None,
               now: Optional[float] = None) -> None:
        if now is None:
            now = time.monotonic()
        with self._lock:
            win = self._windows.setdefault(key, deque())
            win.append((now, ok, n))
            cutoff = now - self.window_s
            while win and win[0][0] < cutoff:
                win.popleft()
            if latency_s is not None:
                prev = self._ewma_s.get(key)
                self._ewma_s[key] = (
                    latency_s if prev is None
                    else prev + self.ewma_alpha * (latency_s - prev))

    def score(self, key: str, now: Optional[float] = None) -> float:
        """Success ratio over the live window; 1.0 with no samples."""
        if now is None:
            now = time.monotonic()
        with self._lock:
            win = self._windows.get(key)
            if not win:
                return 1.0
            cutoff = now - self.window_s
            total = ok = 0
            for t, o, n in win:
                if t < cutoff:
                    continue
                total += n
                if o:
                    ok += n
            return ok / total if total else 1.0

    def reset(self, key: str) -> None:
        with self._lock:
            self._windows.pop(key, None)
            self._ewma_s.pop(key, None)

    def snapshot(self) -> dict:
        with self._lock:
            now = time.monotonic()
            out = {}
            for key, win in self._windows.items():
                cutoff = now - self.window_s
                live = [(t, o, n) for t, o, n in win if t >= cutoff]
                total = sum(n for _, _, n in live)
                fails = sum(n for _, o, n in live if not o)
                ewma = self._ewma_s.get(key)
                out[key] = {
                    "volume": total,
                    "failures": fails,
                    "success_ratio": (round((total - fails) / total, 4)
                                      if total else None),
                    "latency_ewma_ms": (round(ewma * 1e3, 3)
                                        if ewma is not None else None),
                }
            return out


class ResiliencePolicy:
    """The batcher/server-facing bundle of the three policies.

    The batcher calls exactly two things: `bisect` (a bool gating the
    dispatch-failure bisection path) and `record_outcome(version, ok,
    n)` at every batch fan-out. A breaker trip on the LIVE version
    demotes it and promotes the newest healthy registry resident on a
    dedicated daemon thread — never the completion thread, which must
    keep fanning out results while the roll happens (the registry's
    admin lock may be held by a slow warmup, and rollback must not
    stall live fan-out behind it).
    """

    def __init__(self, bisect: bool = True,
                 breaker: Optional[CircuitBreaker] = None,
                 registry=None, metrics=None):
        self.bisect = bisect
        self.breaker = breaker
        self.registry = registry
        self.metrics = metrics

    def record_outcome(self, version: Optional[str], ok: bool,
                       n: int = 1) -> None:
        """One batch's fan-out result (version-tagged). Feeds the
        breaker; a trip triggers the async rollback."""
        if self.breaker is None or version is None:
            return
        if self.breaker.record(version, ok, n=n):
            self._tripped(version)

    def _tripped(self, version: str) -> None:
        log.warning("circuit breaker TRIPPED for version %s", version)
        if self.metrics is not None:
            self.metrics.record_breaker_trip(version)
        if self.registry is None:
            return
        make_thread(target=self._rollback, args=(version,),
                    name="serve-rollback", daemon=True).start()

    def _rollback(self, version: str) -> None:
        try:
            target = self.registry.rollback(
                version, reason=f"circuit breaker tripped on {version}")
        except Exception:
            log.exception("auto-rollback from %s failed", version)
            return
        if target is not None:
            if self.metrics is not None:
                self.metrics.record_rollback(version, target.version)
            log.warning("auto-rollback: %s -> %s", version,
                        target.version)

    def snapshot(self) -> dict:
        return {
            "bisect": self.bisect,
            "breaker": (self.breaker.snapshot()
                        if self.breaker is not None else None),
        }


def build_resilience(cfg, registry=None, metrics=None) -> ResiliencePolicy:
    """ResiliencePolicy from Config knobs — the wiring the server and the
    bench share (one construction, no drift in defaults)."""
    breaker = CircuitBreaker(
        window_s=cfg.serve_breaker_window_s,
        min_requests=cfg.serve_breaker_min_requests,
        failure_ratio=cfg.serve_breaker_ratio)
    return ResiliencePolicy(bisect=cfg.serve_bisect, breaker=breaker,
                            registry=registry, metrics=metrics)
