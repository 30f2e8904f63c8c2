"""Version-aware router: the engine-shaped layer between the dynamic
batcher and the per-version InferenceEngines.

The batcher talks to one engine-shaped object; the Router keeps that
surface (dispatch()/fetch(), max_batch/buckets/platform, _as_images) but
resolves which engine serves each batch at dispatch time. This slice
ports the live route: set_live() swaps the target atomically under a lock
the dispatch thread crosses once per batch, and a handle captures its
engine at dispatch, so a batch dispatched before a swap fetches from the
engine that computed it. Routing is per batch: no request ever mixes
versions. (The JAX package's canary and shadow routes are not ported
yet.)
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Optional, Sequence

import numpy as np

from distributedmnist_tpu_torch.analysis.locks import make_lock
from distributedmnist_tpu_torch.serve.engine import InferenceEngine

log = logging.getLogger("distributedmnist_tpu_torch")


class NoLiveModel(RuntimeError):
    """dispatch() with no live version (the server is warming): 503."""

    status = 503


@dataclasses.dataclass
class RoutedHandle:
    """A dispatched batch plus the engine that computed it."""

    handle: Any
    engine: Any
    version: str
    n: int
    bucket: int
    infer_dtype: Optional[str] = None


class Router:
    """Engine-shaped dispatch()/fetch() over a swappable live engine.
    Built from the shared engine geometry, so the batcher can start and
    accept requests before any version is live — early submits fail their
    futures with NoLiveModel."""

    def __init__(self, max_batch: int, buckets: Sequence[int],
                 platform: str):
        self.max_batch = max_batch
        self.buckets = tuple(buckets)
        self.platform = platform
        self._lock = make_lock("router.routes")
        self._live_engine = None
        self._live_version: Optional[str] = None

    # engine-shape parity: one implementation, shared
    _as_images = staticmethod(InferenceEngine._as_images)
    bucket_for = InferenceEngine.bucket_for

    def set_live(self, engine, version: str) -> None:
        """Atomic hot-swap: the next dispatched batch runs `version`."""
        if (tuple(engine.buckets) != self.buckets
                or engine.max_batch != self.max_batch):
            raise ValueError(
                "engine geometry mismatch: router serves buckets "
                f"{self.buckets} (max_batch {self.max_batch}), engine has "
                f"{tuple(engine.buckets)} (max_batch {engine.max_batch})")
        with self._lock:
            prev = self._live_version
            self._live_engine = engine
            self._live_version = version
        log.info("router: live version %s -> %s [%s]", prev, version,
                 getattr(engine, "infer_dtype", None))

    def live_version(self) -> Optional[str]:
        with self._lock:
            return self._live_version

    def live_infer_dtype(self) -> Optional[str]:
        with self._lock:
            engine = self._live_engine
        return getattr(engine, "infer_dtype", None) if engine else None

    def routes(self) -> dict:
        with self._lock:
            return {"live": self._live_version}

    def versions_in_route(self) -> set:
        """Versions holding a routing role, which the registry must not
        evict: the live one (the only route ported)."""
        with self._lock:
            return ({self._live_version} if self._live_version is not None
                    else set())

    def bucket_costs(self) -> dict:
        """The live engine's measured per-bucket cost table (empty while
        nothing is live)."""
        with self._lock:
            engine = self._live_engine
        return engine.bucket_costs() if engine is not None else {}

    def dispatch(self, x) -> RoutedHandle:
        with self._lock:
            engine, version = self._live_engine, self._live_version
        if engine is None:
            raise NoLiveModel(
                "no warmed model version is live (server warming?)")
        h = engine.dispatch(x)
        return RoutedHandle(handle=h, engine=engine, version=version,
                            n=h.n, bucket=h.bucket,
                            infer_dtype=engine.infer_dtype)

    def fetch(self, rh: RoutedHandle) -> np.ndarray:
        return rh.engine.fetch(rh.handle)

    def infer(self, x) -> np.ndarray:
        return self.fetch(self.dispatch(x))
