"""Version-aware router: the engine-shaped layer between the dynamic
batcher and the per-version InferenceEngines (the port of the JAX
package's serve/router.py).

The batcher talks to one engine-shaped object; the Router keeps that
surface (dispatch()/fetch(), max_batch/buckets/platform, _as_images) but
resolves which engine serves each batch at dispatch time:

- **live**: the default target. set_live() swaps it atomically under a
  lock the dispatch thread crosses once per batch, and a handle captures
  its engine at dispatch, so a batch dispatched before a swap fetches
  from the engine that computed it. Routing is per batch: no request
  ever mixes versions.
- **canary**: a fraction of batches goes to a candidate for real
  (clients get its results); the handle's version tags the batch, so
  ServeMetrics.by_version keeps the two populations apart.
- **shadow**: a fraction of live-routed batches is duplicated to a
  candidate. The client gets the live result; the duplicate is fetched
  and compared on a drain thread of its own (never the completion
  thread, whose FIFO fan-out a slow candidate would hold up), recorded
  in metrics and dropped. A shadow failure is counted and swallowed. At
  most SHADOW_CAP duplicates are outstanding; past it a sampled batch
  skips its duplicate, counted as dropped.

The two draws of each dispatch (route, then shadow) come from a seeded
random.Random under the routes lock, in the JAX router's order, so
sampling is reproducible. Every engine the router takes shares its
bucket ladder and max_batch.

dispatch(x, infer_dtype=...) is the **pinned route** (the cascade's
stage requests): the live version's warmed engine of that precision,
from the alternates table set_live swaps in atomically with the live
target. It skips canary and shadow and draws nothing from the seeded
sequence; a precision with no live route raises NoLiveModel.

dispatch_fast() is the fast lane's routed dispatch: the live engine's
resident route, or None when canary/shadow roles are set (those
populations are defined over coalesced dispatches) or the engine declines.
The shadow duplicate crosses the `router.shadow` failpoint and span.
Handles carry the version (the breaker and metrics read it), the
precision and the fleet replica the router serves (None standalone).
"""

from __future__ import annotations

import dataclasses
import logging
import random
import threading
import time
from typing import Any, Optional, Sequence

import numpy as np

from distributedmnist_tpu_torch.analysis.locks import (make_fifo, make_lock,
                                                       make_thread)
from distributedmnist_tpu_torch.serve import trace
from distributedmnist_tpu_torch.serve.engine import InferenceEngine
from distributedmnist_tpu_torch.serve.faults import failpoint

log = logging.getLogger("distributedmnist_tpu_torch")


class NoLiveModel(RuntimeError):
    """dispatch() with no live version (the server is warming): 503."""

    status = 503


@dataclasses.dataclass
class _Target:
    engine: Any
    version: str
    fraction: float = 1.0


@dataclasses.dataclass
class RoutedHandle:
    """A dispatched batch plus the engine that computed it and, when
    shadowed, the duplicate in flight on the candidate."""

    handle: Any
    engine: Any
    version: str
    n: int
    bucket: int
    canary: bool = False
    shadow_handle: Any = None
    shadow_engine: Any = None
    shadow_version: Optional[str] = None
    infer_dtype: Optional[str] = None
    # the fleet replica that computed the batch (None standalone)
    replica: Optional[str] = None


class Router:
    """Engine-shaped dispatch()/fetch() over a swappable set of versioned
    engines. Built from the shared engine geometry, so the batcher can
    start and accept requests before any version is live — early submits
    fail their futures with NoLiveModel."""

    # outstanding shadow duplicates (dispatched or queued for comparison)
    SHADOW_CAP = 64

    # The registry wires a cascade only onto a router that resolves a
    # pinned precision; the fleet front and engine doubles lack it.
    supports_alternates = True

    def __init__(self, max_batch: int, buckets: Sequence[int],
                 platform: str, n_chips: int = 1, metrics=None,
                 seed: int = 0, shadow_cap: Optional[int] = None,
                 replica: Optional[str] = None):
        self.max_batch = max_batch
        self.buckets = tuple(buckets)
        self.platform = platform
        self.n_chips = n_chips
        self.metrics = metrics
        # the fleet replica this router serves, stamped on every handle
        self.replica = replica
        # `is None`: an explicit 0 (drop every sampled duplicate) holds
        self.shadow_cap = (self.SHADOW_CAP if shadow_cap is None
                           else shadow_cap)
        self._lock = make_lock("router.routes")
        self._live: Optional[_Target] = None
        self._canary: Optional[_Target] = None
        self._shadow: Optional[_Target] = None
        # infer_dtype -> warmed engine of the LIVE version, swapped with
        # the live target so a pinned dispatch never pairs two versions
        self._alternates: dict = {}
        self._rng = random.Random(seed)
        self._shadow_q = make_fifo("router.shadow_q")
        self._shadow_pending = 0
        self._shadow_pending_lock = make_lock("router.shadow_pending")
        self._shadow_thread: Optional[threading.Thread] = None

    # engine-shape parity: one implementation, shared
    _as_images = staticmethod(InferenceEngine._as_images)
    bucket_for = InferenceEngine.bucket_for

    # -- version wiring (called by the registry) ---------------------------

    def _check_compatible(self, engine) -> None:
        if (tuple(engine.buckets) != self.buckets
                or engine.max_batch != self.max_batch):
            raise ValueError(
                "engine geometry mismatch: router serves buckets "
                f"{self.buckets} (max_batch {self.max_batch}), engine has "
                f"{tuple(engine.buckets)} (max_batch {engine.max_batch})")

    def set_live(self, engine, version: str,
                 alternates: Optional[dict] = None) -> None:
        """Atomic hot-swap: the next dispatched batch runs `version`.
        Clears a candidate role the promoted version held. `alternates`
        maps infer_dtype -> warmed engine of this version for pinned
        dispatches; omitted, it holds the live engine under its own
        dtype alone."""
        self._check_compatible(engine)
        if alternates is not None:
            for alt in alternates.values():
                self._check_compatible(alt)
            alternates = dict(alternates)
        else:
            alternates = {
                (getattr(engine, "infer_dtype", None) or "float32"):
                    engine}
        with self._lock:
            prev = self._live.version if self._live else None
            self._live = _Target(engine, version)
            self._alternates = alternates
            if self._canary and self._canary.version == version:
                self._canary = None
            if self._shadow and self._shadow.version == version:
                self._shadow = None
        log.info("router: live version %s -> %s [%s] (alternates: %s)",
                 prev, version, getattr(engine, "infer_dtype", None),
                 sorted(alternates))

    def set_shadow(self, engine, version: str, fraction: float) -> None:
        self._check_compatible(engine)
        if not 0.0 < fraction <= 1.0:
            raise ValueError(f"shadow fraction must be in (0, 1], "
                             f"got {fraction}")
        with self._lock:
            self._shadow = _Target(engine, version, fraction)
        log.info("router: shadowing %.0f%% of live traffic to %s",
                 100 * fraction, version)

    def set_canary(self, engine, version: str, fraction: float) -> None:
        self._check_compatible(engine)
        if not 0.0 < fraction < 1.0:
            raise ValueError(f"canary fraction must be in (0, 1), "
                             f"got {fraction}")
        with self._lock:
            self._canary = _Target(engine, version, fraction)
        log.info("router: canarying %.0f%% of traffic to %s",
                 100 * fraction, version)

    def clear_candidates(self) -> None:
        with self._lock:
            self._canary = self._shadow = None

    def live_version(self) -> Optional[str]:
        with self._lock:
            return self._live.version if self._live else None

    def live_infer_dtype(self) -> Optional[str]:
        with self._lock:
            live = self._live
        return getattr(live.engine, "infer_dtype", None) if live else None

    def live_route(self) -> tuple:
        """(live version, live infer_dtype) under ONE lock crossing: the
        prediction cache's key basis (two separate reads could straddle
        a promote and key a pair that was never live together)."""
        with self._lock:
            live = self._live
        if live is None:
            return (None, None)
        return (live.version, getattr(live.engine, "infer_dtype", None))

    def routes(self) -> dict:
        """The routing table (GET /models, promote's answer)."""
        with self._lock:
            return {
                "live": self._live.version if self._live else None,
                "canary": ({"version": self._canary.version,
                            "fraction": self._canary.fraction}
                           if self._canary else None),
                "shadow": ({"version": self._shadow.version,
                            "fraction": self._shadow.fraction}
                           if self._shadow else None),
                "alternates": sorted(self._alternates),
            }

    def versions_in_route(self) -> set:
        """Versions holding a routing role, which the registry must not
        evict."""
        with self._lock:
            return {t.version for t in (self._live, self._canary,
                                        self._shadow) if t is not None}

    def bucket_costs(self) -> dict:
        """The live engine's measured per-bucket cost table (empty while
        nothing is live); every engine shares the ladder, so it plans
        canary dispatches too."""
        with self._lock:
            live = self._live
        if live is None:
            return {}
        costs = getattr(live.engine, "bucket_costs", None)
        return costs() if callable(costs) else {}

    def bucket_costs_p95(self) -> dict:
        """The live engine's p95 cost table, the fleet's hedge trigger;
        empty while nothing is live or for an engine without one (which
        turns hedging off, not serving)."""
        with self._lock:
            live = self._live
        if live is None:
            return {}
        costs = getattr(live.engine, "bucket_costs_p95", None)
        return costs() if callable(costs) else {}

    # -- the engine surface the batcher drives -----------------------------

    def dispatch(self, x, infer_dtype: Optional[str] = None
                 ) -> RoutedHandle:
        if infer_dtype is not None:
            # before the seeded draws: a pinned stage dispatch must not
            # move the canary/shadow sampling of interleaved live traffic
            return self._dispatch_pinned(x, infer_dtype)
        with self._lock:
            live, canary, shadow = self._live, self._canary, self._shadow
            route_draw = self._rng.random()
            shadow_draw = self._rng.random()
        if live is None:
            raise NoLiveModel(
                "no warmed model version is live (server warming?)")
        target, is_canary = live, False
        if canary is not None and route_draw < canary.fraction:
            target, is_canary = canary, True
        h = target.engine.dispatch(x)
        rh = RoutedHandle(handle=h, engine=target.engine,
                          version=target.version, n=h.n, bucket=h.bucket,
                          canary=is_canary, replica=self.replica,
                          infer_dtype=getattr(target.engine, "infer_dtype",
                                              None))
        # only live-routed batches are shadowed: the canary and shadow
        # populations stay apart
        if (shadow is not None and not is_canary
                and shadow_draw < shadow.fraction):
            with self._shadow_pending_lock:
                claim = self._shadow_pending < self.shadow_cap
                if claim:
                    self._shadow_pending += 1
            if not claim:
                if self.metrics is not None:
                    self.metrics.record_shadow_drop()
                return rh
            sp = trace.begin_span("router.shadow", version=shadow.version)
            try:
                # an injected shadow fault is swallowed and counted like
                # a real broken candidate
                failpoint("router.shadow", version=shadow.version)
                rh.shadow_handle = shadow.engine.dispatch(x)
                rh.shadow_engine = shadow.engine
                rh.shadow_version = shadow.version
            except Exception as se:
                # a broken candidate never takes live traffic down
                log.exception("shadow dispatch to %s failed",
                              shadow.version)
                trace.end_span(sp, error=type(se).__name__)
                with self._shadow_pending_lock:
                    self._shadow_pending -= 1
                if self.metrics is not None:
                    self.metrics.record_shadow_error()
            finally:
                trace.end_span(sp)
        return rh

    def _dispatch_pinned(self, x, infer_dtype: str) -> RoutedHandle:
        """Dispatch on the live version's engine of `infer_dtype` (the
        cascade's `fast` and stage-1 requests pin the cheap dtype,
        escalations and `exact` pin float32), with no canary or shadow:
        a stage's rows are merged with its sibling stage's, so they must
        come from the live version. A missing alternate is NoLiveModel,
        systemic (503), so the batcher fails the batch without
        bisecting it."""
        with self._lock:
            live = self._live
            engine = self._alternates.get(infer_dtype)
        if live is None:
            raise NoLiveModel(
                "no warmed model version is live (server warming?)")
        if engine is None:
            raise NoLiveModel(
                f"no live {infer_dtype!r} route for version "
                f"{live.version} (variant not promoted with the "
                "cascade, or demoted by a re-gate)")
        h = engine.dispatch(x)
        return RoutedHandle(handle=h, engine=engine,
                            version=live.version, n=h.n, bucket=h.bucket,
                            canary=False, replica=self.replica,
                            infer_dtype=getattr(engine, "infer_dtype",
                                                None))

    def dispatch_fast(self, x) -> Optional[RoutedHandle]:
        """The fast lane's routed dispatch: the live engine's resident
        route, or None when the full dispatch() semantics are needed (a
        canary or shadow role is set, or the engine declines). NoLiveModel
        still raises: warming is a 503, not a fallback."""
        with self._lock:
            live, canary, shadow = self._live, self._canary, self._shadow
        if live is None:
            raise NoLiveModel(
                "no warmed model version is live (server warming?)")
        if canary is not None or shadow is not None:
            return None
        fast = getattr(live.engine, "dispatch_fast", None)
        if not callable(fast):
            return None
        h = fast(x)
        if h is None:
            return None
        return RoutedHandle(handle=h, engine=live.engine,
                            version=live.version, n=h.n, bucket=h.bucket,
                            replica=self.replica,
                            infer_dtype=getattr(live.engine, "infer_dtype",
                                                None))

    def fetch(self, rh: RoutedHandle) -> np.ndarray:
        try:
            out = rh.engine.fetch(rh.handle)
        except Exception:
            # the duplicate still drains (its staging pair and pending
            # slot would leak otherwise); None skips the comparison
            if rh.shadow_handle is not None:
                self._enqueue_shadow(rh, None)
            raise
        if rh.shadow_handle is not None:
            self._enqueue_shadow(rh, out)
        return out

    def _enqueue_shadow(self, rh: RoutedHandle, out) -> None:
        with self._shadow_pending_lock:
            if self._shadow_thread is None:
                self._shadow_thread = make_thread(
                    target=self._shadow_loop, name="serve-shadow",
                    daemon=True)
                self._shadow_thread.start()
        self._shadow_q.put((rh, out))

    def _shadow_loop(self) -> None:
        while True:
            rh, out = self._shadow_q.get()
            try:
                shadow_out = rh.shadow_engine.fetch(rh.shadow_handle)
                if self.metrics is not None and out is not None:
                    agree = int(np.sum(out.argmax(-1)
                                       == shadow_out.argmax(-1)))
                    diff = float(np.max(np.abs(
                        out.astype(np.float32)
                        - shadow_out.astype(np.float32))))
                    self.metrics.record_shadow(
                        rh.version, rh.shadow_version, rows=rh.n,
                        agree_rows=agree, max_abs_diff=diff)
            except Exception:
                log.exception("shadow fetch from %s failed",
                              rh.shadow_version)
                if self.metrics is not None:
                    self.metrics.record_shadow_error()
            finally:
                with self._shadow_pending_lock:
                    self._shadow_pending -= 1

    def shadow_pending(self) -> int:
        """Shadow duplicates dispatched or queued, not yet recorded."""
        with self._shadow_pending_lock:
            return self._shadow_pending

    def drain_shadow(self, timeout: float = 30.0) -> None:
        """Wait, at most `timeout` seconds, for every outstanding shadow
        comparison to land in metrics (tests and orderly shutdowns)."""
        deadline = time.monotonic() + timeout
        while self.shadow_pending():
            if time.monotonic() > deadline:
                raise RuntimeError(
                    f"{self.shadow_pending()} shadow comparison(s) "
                    f"still pending after {timeout:g}s")
            time.sleep(0.005)

    def infer(self, x) -> np.ndarray:
        return self.fetch(self.dispatch(x))
