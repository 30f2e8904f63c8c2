"""Model lifecycle: versioned parameter sets loaded from the trainer's
checkpoints, pre-warmed engines, atomic promotion, rollback, bounded
residency, and the parity-gated inference variants (the port of the JAX
package's serve/registry.py).

A **ModelRegistry** registers a parameter set as a version — read from
the latest committed checkpoint by the params-only restore, or fresh-init
— builds and warms its engine off the hot path, proves it warm with a
second warmup that must trigger no kernel-library build, and only then
lets promote() re-point the Router's live target. rollback() demotes a
live version and promotes the newest healthy resident; past
`max_versions` the oldest routeless version is evicted. A version's
**variants** (bfloat16, int8, megakernel) are built from its float32
parameters and must also pass the accuracy-parity gate against the
float32 engine on a held-out batch before they may take traffic.

Beside the live route, a warmed non-live version may take a canary
fraction of traffic for real, or shadow a fraction of live traffic
(compared and dropped); versions holding any route are never evicted,
and add() refuses a newcomer up front when every resident version holds
one. All versions share one EngineFactory — model, device, bucket
ladder — so a swap never changes the shapes the kernels run at.

**Replicas**: with a ReplicaSet in the router's slot (serve/fleet.py,
`build_serving` with serve_replicas > 1) every version and variant warms
one engine per replica, each proved warm on its own, and every route
change fans the whole list out, so a roll moves the entire fleet. The
factory serves over the process's cards (cfg.num_devices, default every
visible card; one device on the CPU) and cuts them among the replicas
by the JAX registry's rule (parallel/mesh.py place_replicas): equal
slices when the replicas divide the cards, else every replica over all
of them, each engine data-parallel over its replica's cards, and on
each card on a CUDA stream of the replica's own.

**The cascade** (serve/cascade.py): enable_cascade() builds the cheap
variant, calibrates the confidence threshold on the held-out batch and
runs the composed-accuracy gate; set_cascade_threshold() and promote's
`cascade_threshold` judge an operator's override by the same gate;
cascade_plan() is the CascadeFront's per-request read. The live route
carries an alternates table (the float32 base and every ready variant of
the live version) for the cascade's pinned dispatches. A fleet front has
no alternates, so a cascade on it is refused, as the JAX registry
refuses it.

set_cache() installs the prediction cache (serve/cache.py), which every
live-route change invalidates under the state lock, atomically with the
swap: promote, rollback, dtype activation, a re-gate's demotion and a
cascade change. The failpoints `registry.restore`, `registry.warmup` and
`registry.variant` (serve/faults.py) drive the failed-version
bookkeeping on demand.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from collections import deque
from typing import Any, Optional

import numpy as np

from distributedmnist_tpu_torch import checkpoint
from distributedmnist_tpu_torch.analysis.locks import make_lock, make_rlock
from distributedmnist_tpu_torch.serve import cascade as cascade_mod
from distributedmnist_tpu_torch.serve.engine import (InferenceEngine,
                                                     make_buckets)
from distributedmnist_tpu_torch.serve.faults import failpoint
from distributedmnist_tpu_torch.serve.fleet import ReplicaSet
from distributedmnist_tpu_torch.serve.quantize import (  # noqa: F401
    PARITY_ROWS, PARITY_SEED, variant_supported)
from distributedmnist_tpu_torch.serve.router import Router
from distributedmnist_tpu_torch.utils import parity_check
from distributedmnist_tpu_torch.utils.device import resolve_device

log = logging.getLogger("distributedmnist_tpu_torch")

# Per-variant parity thresholds against the float32 reference on the
# held-out batch: (min argmax agreement, max relative logit diff) — the
# JAX package's PARITY_GATES (PARITY.md "Serving parity gate").
PARITY_GATES = {"bfloat16": (0.995, 0.05), "int8": (0.995, 0.15),
                "megakernel": (0.995, 0.01)}


class ParityRefused(RuntimeError):
    """The parity gate refused a variant: it ran, but its logits stray
    too far from the float32 engine's. Any other failure (a kernel that
    does not build or launch) is not a refusal and propagates as is."""


@dataclasses.dataclass
class VariantInfo:
    """One inference variant of a version: warming -> ready, or failed
    (build error, or refused by the parity gate; last_error says why)."""

    infer_dtype: str
    state: str = "warming"
    engine: Any = None             # replica 0's engine
    # one warmed engine per fleet replica ([engine] on one replica)
    engines: list = dataclasses.field(default_factory=list)
    warmup_builds: int = 0
    warmup_s: float = 0.0
    parity: Optional[dict] = None
    last_error: Optional[str] = None

    def describe(self) -> dict:
        return {"infer_dtype": self.infer_dtype, "state": self.state,
                "warmup_builds": self.warmup_builds,
                "warmup_s": round(self.warmup_s, 3), "parity": self.parity,
                "last_error": self.last_error,
                "replica_engines": len(self.engines)}


@dataclasses.dataclass
class ModelVersion:
    version: str
    engine: Any                    # replica 0's engine, None until warm
    state: str                     # warming | ready | live | failed
    source: str                    # "checkpoint <dir>" | "fresh-init" | ...
    step: Optional[int] = None     # checkpoint step, when from disk
    # monotonic load stamp: rollback picks the newest healthy resident by
    # it, whatever the wall clock does
    loaded_mono: float = 0.0
    warmup_builds: int = 0
    warmup_s: float = 0.0
    last_error: Optional[str] = None
    variants: dict = dataclasses.field(default_factory=dict)
    # one warmed engine per fleet replica ([engine] on one replica):
    # routes fan the whole list out
    engines: list = dataclasses.field(default_factory=list)
    # the calibrated cascade (serve/cascade.CascadeState) once
    # enable_cascade's gate passed; None otherwise
    cascade: Any = None

    def describe(self) -> dict:
        return {
            "version": self.version, "state": self.state,
            "source": self.source, "step": self.step,
            "warmup_builds": self.warmup_builds,
            "warmup_s": round(self.warmup_s, 3),
            "last_error": self.last_error,
            "bucket_cost_ms": ({
                str(b): round(c * 1e3, 3)
                for b, c in sorted(self.engine.bucket_costs().items())}
                if self.engine is not None else None),
            "replica_engines": len(self.engines),
            "variants": {dt: v.describe()
                         for dt, v in sorted(self.variants.items())},
            "cascade": (self.cascade.describe()
                        if self.cascade is not None else None),
        }


class EngineFactory:
    """Builds shape-identical InferenceEngines, one per (version, fleet
    replica): one model, one bucket ladder for every version.

    The factory serves over a group of devices, `devices` (build_serving
    passes `get_devices(cfg.device, cfg.num_devices)`; a device may
    repeat: two shards on one card, or logical shards on the CPU), by
    default `get_devices(device)`: every visible card, the one CPU
    device on the cpu. As the JAX registry does, it cuts them among
    `replicas` (place_replicas): equal slices when the replicas divide
    the devices, else every replica a logical replica over all of them.
    Each engine is data-parallel over its replica's devices. `n_chips`
    and `buckets` are per replica (the ladder's rungs are multiples of
    n_chips); `total_chips` is the union of the replicas' devices.

    With `replicas` > 1 or `own_stream` on the card, each replica's
    engines launch on CUDA streams of the replica's own, one a card (a
    catalog model beside others on one card then never queues behind
    another model's dispatches). On the CPU the replicas are logical:
    separate engines and staging pools on one device.

    `replica_devices[i]` is replica i's devices and `replica_streams[i]`
    their streams (None: the card's current stream)."""

    def __init__(self, model: str, device="cuda", max_batch: int = 512,
                 replicas: int = 1, own_stream: bool = False,
                 devices: Optional[list] = None):
        from distributedmnist_tpu_torch.parallel.mesh import (get_devices,
                                                              place_replicas)

        if replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {replicas}")
        self.model = model
        self.device = resolve_device(device)
        self.platform = self.device.type
        self.max_batch = max_batch
        self.replicas = replicas
        self.devices = list(devices) if devices else get_devices(device)
        self.replica_devices = place_replicas(self.devices, replicas)
        self.n_chips = len(self.replica_devices[0])      # per replica
        self.buckets = make_buckets(max_batch, self.n_chips)
        self.replica_streams = [[None] * len(g)
                                for g in self.replica_devices]
        if self.device.type == "cuda" and (replicas > 1 or own_stream):
            import torch

            self.replica_streams = [[torch.cuda.Stream(device=d) for d in g]
                                    for g in self.replica_devices]
        self.total_chips = len({(d.type, d.index)
                                for g in self.replica_devices for d in g})
        # engines built so far: with the kernel-library loads, the
        # process's build count (the HTTP server's compiles_total)
        self.engine_builds = 0

    @property
    def device_kind(self) -> str:
        """The first card's name, or "cpu"."""
        if self.device.type == "cuda":
            import torch

            return torch.cuda.get_device_name(self.device)
        return "cpu"

    def make_router(self, metrics=None, seed: int = 0,
                    replica: Optional[str] = None) -> Router:
        return Router(self.max_batch, self.buckets, self.platform,
                      n_chips=self.n_chips, metrics=metrics, seed=seed,
                      replica=replica)

    def make_fleet(self, metrics=None, seed: int = 0,
                   per_replica_inflight: Optional[int] = None,
                   hedge: bool = False):
        """The N-replica dispatcher (serve/fleet.py): one Router per
        replica, labelled rN and seeded apart so canary and shadow draws
        never lockstep across replicas."""
        routers = [self.make_router(metrics=metrics, seed=seed + i,
                                    replica=f"r{i}")
                   for i in range(self.replicas)]
        return ReplicaSet(routers, metrics=metrics,
                          per_replica_inflight=per_replica_inflight,
                          hedge=hedge)

    def make_engine(self, params, version: str,
                    infer_dtype: str = "float32",
                    replica: int = 0) -> InferenceEngine:
        self.engine_builds += 1
        return InferenceEngine(self.model, params,
                               devices=self.replica_devices[replica],
                               max_batch=self.max_batch, version=version,
                               infer_dtype=infer_dtype, buckets=self.buckets,
                               streams=self.replica_streams[replica])

    def init_params(self, seed: int = 0) -> dict:
        """Fresh-init parameters (a seeded CPU generator, so the values do
        not depend on the device)."""
        from distributedmnist_tpu_torch import models

        return models.init_params(self.model, seed)

    def abstract_params(self) -> dict:
        """The restore template for checkpoint.restore_latest_params: the
        model's state_dict on the meta device (names, shapes and dtypes,
        no storage)."""
        from distributedmnist_tpu_torch import models

        return models.build(self.model, device="meta").state_dict()


class ModelRegistry:
    """Versioned, pre-warmed model store feeding one Router.

    `_admin` (re-entrant) serializes the slow operations (load, add,
    promote, add_variant), which run on admin threads, never the dispatch
    thread; `_state` guards only the version table and is never held
    across a restore or a warmup, so describe() answers while a version
    warms."""

    def __init__(self, factory: EngineFactory, router: Router,
                 checkpoint_dir: Optional[str] = None,
                 max_versions: int = 4):
        if max_versions < 2:
            raise ValueError(
                f"max_versions must be >= 2 (live + one candidate), "
                f"got {max_versions}")
        self.factory = factory
        self.router = router
        self.checkpoint_dir = checkpoint_dir
        self.max_versions = max_versions
        # a ReplicaSet router: every version warms one engine a replica
        # and every route change fans the list out
        self.n_replicas = getattr(router, "n_replicas", 1)
        self._versions: dict[str, ModelVersion] = {}   # insertion-ordered
        # blocking_ok: the admin lock serializes multi-second restores
        # and warmups BY DESIGN (they run on admin/SIGHUP threads, never
        # the dispatch path) — the sanitizer's blocking-under-lock check
        # must not flag what the two-lock split exists to permit. _state
        # stays hot-path strict: holding it across anything slow starves
        # /healthz, which is what the split prevents.
        self._admin = make_rlock("registry.admin", blocking_ok=True)
        self._state = make_lock("registry.state")
        self._auto_id = 0
        # rollbacks, failed rollbacks and variant demotions, oldest first
        # (bounded)
        self._events: deque = deque(maxlen=64)
        # the prediction cache every live-route change invalidates
        self._cache = None

    def set_cache(self, cache) -> None:
        """Install the prediction cache to invalidate on every live-route
        change (any object with `invalidate(reason=)`; None removes
        it)."""
        self._cache = cache

    def _route_set(self, kind: str, mv: ModelVersion,
                   fraction: Optional[float] = None,
                   engines: Optional[list] = None) -> None:
        """One route change, fanned out: a ReplicaSet takes the whole
        per-replica engine list under its pick lock, a Router the single
        engine. `engines` overrides the version's base list (a variant
        serving under the version's name). A live change on a Router
        carries the alternates table (the float32 base and every ready
        variant of this version, for pinned dispatches) and invalidates
        the cache: cached bytes are keyed by the live route, so the flush
        reclaims entries the new route can no longer reach and bumps the
        epoch that drops in-flight inserts which raced the swap."""
        engines = mv.engines if engines is None else engines
        target = list(engines) if self.n_replicas > 1 else engines[0]
        if kind == "live":
            if (self.n_replicas == 1
                    and getattr(self.router, "supports_alternates",
                                False)):
                alternates = {"float32": mv.engines[0]}
                for dt, vi in mv.variants.items():
                    if vi.state == "ready" and vi.engines:
                        alternates[dt] = vi.engines[0]
                self.router.set_live(target, mv.version,
                                     alternates=alternates)
            else:
                self.router.set_live(target, mv.version)
            if self._cache is not None:
                self._cache.invalidate(reason=f"live -> {mv.version}")
        elif kind == "shadow":
            self.router.set_shadow(target, mv.version, fraction)
        else:
            self.router.set_canary(target, mv.version, fraction)

    def _warm(self, engine: InferenceEngine, what: str) -> int:
        """Warm `engine`, then prove it warm: a second warmup must
        trigger no kernel-library build, or it must not take traffic."""
        builds = engine.warmup()
        residual = engine.warmup()
        if residual:
            raise RuntimeError(
                f"{what} still triggered {residual} kernel-library "
                "build(s) on the verification warmup pass — refusing to "
                "mark it promotable")
        return builds

    def _build_warm(self, params, version: str, infer_dtype: str,
                    what: str) -> tuple[list, int]:
        """One engine a replica, each proved warm on its own (promote fans
        out, so one cold replica would poison the fleet): (engines, kernel
        library builds)."""
        engines, builds = [], 0
        for i in range(self.n_replicas):
            engine = self.factory.make_engine(params, version,
                                              infer_dtype=infer_dtype,
                                              replica=i)
            where = f" (replica {i})" if self.n_replicas > 1 else ""
            builds += self._warm(engine, what + where)
            engines.append(engine)
        return engines, builds

    # -- loading -----------------------------------------------------------

    def add(self, params, version: Optional[str] = None,
            source: str = "direct", step: Optional[int] = None
            ) -> ModelVersion:
        """Register + pre-warm a float32 parameter set. Returns the
        version in state 'ready'; raises if the name is taken, if every
        resident version holds a route (before any warmup work), or if
        warmup fails (the version is then recorded as 'failed')."""
        with self._admin:
            with self._state:
                if version is None:
                    self._auto_id += 1
                    version = f"v{self._auto_id}"
                if version in self._versions:
                    raise ValueError(f"version {version!r} already loaded")
                # with every resident version holding a route, eviction
                # could free nothing but the newcomer: refuse now, not
                # after warming an engine only to drop it
                in_route = self.router.versions_in_route()
                evictable = [n for n, v in self._versions.items()
                             if v.state == "failed"
                             or (v.state == "ready" and n not in in_route)]
                if len(self._versions) >= self.max_versions \
                        and not evictable:
                    raise RuntimeError(
                        f"registry full: {len(self._versions)} resident "
                        "versions all hold routing roles (live/shadow/"
                        "canary); clear a candidate or raise "
                        "serve_max_versions")
                mv = ModelVersion(version=version, engine=None,
                                  state="warming", source=source, step=step,
                                  loaded_mono=time.monotonic())
                self._versions[version] = mv
            try:
                t0 = time.perf_counter()
                failpoint("registry.warmup", version=version)
                engines, mv.warmup_builds = self._build_warm(
                    params, version, "float32", f"version {version!r}")
                mv.engines = engines
                mv.engine = engines[0]
                mv.warmup_s = time.perf_counter() - t0
                mv.state = "ready"
            except Exception as e:
                mv.state = "failed"
                mv.engine = None
                mv.engines = []
                mv.last_error = f"warmup: {type(e).__name__}: {e}"
                raise
            with self._state:
                self._evict_locked(protect={version})
            log.info("registry: %s ready (%s, %d kernel library loads, "
                     "%.2fs warm)", version, source, mv.warmup_builds,
                     mv.warmup_s)
            return mv

    def add_fresh(self, version: Optional[str] = None,
                  seed: int = 0) -> ModelVersion:
        """Register + pre-warm a seeded fresh-init parameter set."""
        return self.add(self.factory.init_params(seed), version=version,
                        source="fresh-init")

    def load_latest(self, directory: Optional[str] = None,
                    version: Optional[str] = None) -> ModelVersion:
        """Load + pre-warm the latest committed checkpoint of `directory`
        (default: the registry's checkpoint_dir) by the params-only
        restore. Idempotent per checkpoint step: re-loading a resident
        step returns that version, after one directory listing and no
        read of the checkpoint. An explicit `version` name that holds an
        older step is refused. A restore that raises leaves a 'failed'
        version with the error (a later retry of the name may load)."""
        directory = directory or self.checkpoint_dir
        if not directory:
            raise ValueError(
                "no checkpoint directory: pass one or construct the "
                "registry with checkpoint_dir")
        with self._admin:
            steps = checkpoint.committed_steps(directory)
            if not steps:
                raise FileNotFoundError(
                    f"no committed checkpoint in {directory!r}")
            step = steps[-1]
            if version is None:
                version = f"step-{step}"
            with self._state:
                existing = self._versions.get(version)
                if existing is not None and existing.state != "failed":
                    if existing.step == step:
                        log.info("registry: %s already resident (state "
                                 "%s)", version, existing.state)
                        return existing
                    raise ValueError(
                        f"version {version!r} already holds step "
                        f"{existing.step}; latest committed step is "
                        f"{step} — pick a new version name (or omit it "
                        "for step-derived names)")
                if existing is not None:      # failed: allow a retry
                    del self._versions[version]
            # Pin the step listed above: a checkpoint committed between
            # the listing and the restore must not come in under this
            # step's version name.
            try:
                failpoint("registry.restore", directory=directory,
                          step=step)
                params, step = checkpoint.restore_latest_params(
                    directory, self.factory.abstract_params(), step=step)
            except Exception as e:
                mv = ModelVersion(version=version, engine=None,
                                  state="failed",
                                  source=f"checkpoint {directory}",
                                  step=step, loaded_mono=time.monotonic(),
                                  last_error=f"restore: "
                                             f"{type(e).__name__}: {e}")
                with self._state:
                    self._versions.setdefault(version, mv)
                raise
            return self.add(params, version=version,
                            source=f"checkpoint {directory}", step=step)

    def bootstrap(self, seed: int = 0, promote: bool = True
                  ) -> ModelVersion:
        """Process start: the latest checkpoint when checkpoint_dir holds
        one, fresh-init parameters otherwise, warmed, then promoted —
        unless another version went live while this one warmed (the
        operator's newer choice wins), or `promote` is False (the caller
        puts it live, e.g. by go_live)."""
        if self.checkpoint_dir and checkpoint.committed_steps(
                self.checkpoint_dir):
            mv = self.load_latest()
        else:
            mv = self.add_fresh(seed=seed)
        if not promote:
            return mv
        with self._admin:
            live = self.router.live_version()
            if live is None or live == mv.version:
                self.promote(mv.version)
            else:
                log.info("bootstrap: %s went live during warmup; leaving "
                         "it (%s stays ready)", live, mv.version)
        return mv

    # -- inference variants ------------------------------------------------

    def _parity_batch(self) -> np.ndarray:
        """The held-out gate batch: seeded synthetic test images, capped
        at max_batch so one infer() covers it."""
        from distributedmnist_tpu_torch.data import synthetic_mnist

        rows = min(PARITY_ROWS, self.factory.max_batch)
        data = synthetic_mnist(seed=PARITY_SEED, train_n=16, test_n=rows)
        return np.asarray(data["test_x"][:rows])

    def add_variant(self, version: str, infer_dtype: str,
                    min_agreement: Optional[float] = None,
                    max_rel_diff: Optional[float] = None) -> VariantInfo:
        """Build, warm and gate the `infer_dtype` variant of `version`.

        Same warm bar as a version, plus the parity gate: the held-out
        batch runs through the float32 engine and the candidate, and the
        variant is refused (state 'failed', last_error naming the failing
        threshold, never promotable) unless argmax agreement and the
        relative logit diff clear PARITY_GATES (or the thresholds given
        here). An already-ready variant is returned as is at the default
        bar; given thresholds, its existing engine is re-gated at them,
        never rebuilt, and a refusal there fails it and, if it is the
        live route, demotes traffic to the version's float32 engine (a
        'variant_demoted' event). A missing or failed variant is built."""
        if infer_dtype not in PARITY_GATES:
            raise ValueError(
                f"unknown variant dtype {infer_dtype!r} (expected one of "
                f"{sorted(PARITY_GATES)}; float32 is the base)")
        gate_agree, gate_rel = PARITY_GATES[infer_dtype]
        custom = min_agreement is not None or max_rel_diff is not None
        if min_agreement is not None:
            gate_agree = min_agreement
        if max_rel_diff is not None:
            gate_rel = max_rel_diff
        with self._admin:
            with self._state:
                mv = self._get(version)
                if mv.state not in ("ready", "live"):
                    raise RuntimeError(
                        f"version {version!r} is {mv.state!r}; variants "
                        "hang off a warmed version")
                existing = mv.variants.get(infer_dtype)
                ready = existing is not None and existing.state == "ready"
                if ready and not custom:
                    return existing
                if not ready:
                    vi = VariantInfo(infer_dtype=infer_dtype)
                    mv.variants[infer_dtype] = vi
            if ready:
                return self._regate(mv, existing, gate_agree, gate_rel)
            try:
                t0 = time.perf_counter()
                failpoint("registry.variant", version=version,
                          dtype=infer_dtype)
                engines, vi.warmup_builds = self._build_warm(
                    mv.engine.params, version, infer_dtype,
                    f"variant {infer_dtype!r} of {version!r}")
                engine = engines[0]
                x = self._parity_batch()
                # lint: allow[DML015] admin-path parity-gate measurement, never the request path
                ref = mv.engine.infer(x)
                # lint: allow[DML015] admin-path parity-gate measurement, never the request path
                cand = engine.infer(x)
                vi.parity = parity_check(ref, cand,
                                         min_agreement=gate_agree,
                                         max_rel_diff=gate_rel)
                if not vi.parity["passed"]:
                    raise ParityRefused(
                        f"parity gate REFUSED {infer_dtype!r} variant of "
                        f"{version!r}: {vi.parity['why']}")
                vi.engines = engines
                vi.engine = engine
                vi.warmup_s = time.perf_counter() - t0
                vi.state = "ready"
            except Exception as e:
                vi.state = "failed"
                vi.engine = None
                vi.engines = []
                vi.last_error = f"{type(e).__name__}: {e}"
                raise
            log.info("registry: %s variant %s ready (%.2fs; parity agree=%s "
                     "rel_diff=%s)", version, infer_dtype, vi.warmup_s,
                     vi.parity["argmax_agreement"],
                     vi.parity["max_rel_logit_diff"])
            return vi

    def _regate(self, mv: ModelVersion, vi: VariantInfo,
                min_agreement: float, max_rel_diff: float) -> VariantInfo:
        """Judge a ready variant's existing engine again at the given bar
        (the caller holds _admin). A refused variant must stop serving at
        once, not at the next promote: if it is the live route, the
        version's float32 engine goes live and the demotion is recorded
        as an event, like a rollback."""
        x = self._parity_batch()
        # lint: allow[DML015] admin-path parity-gate measurement, never the request path
        vi.parity = parity_check(mv.engine.infer(x), vi.engine.infer(x),
                                 min_agreement=min_agreement,
                                 max_rel_diff=max_rel_diff)
        if vi.parity["passed"]:
            return vi
        dt = vi.infer_dtype
        vi.state = "failed"
        vi.last_error = (f"re-gate REFUSED {dt!r} variant of "
                         f"{mv.version!r}: {vi.parity['why']}")
        if (self.router.live_version() == mv.version
                and self.router.live_infer_dtype() == dt):
            with self._state:
                self._route_set("live", mv)
                # "at" is wall clock, for display only
                self._events.append({
                    "event": "variant_demoted", "version": mv.version,
                    "infer_dtype": dt, "to": "float32",
                    # lint: allow[DML004] wall-clock event stamp for operators
                    "reason": vi.last_error, "at": round(time.time(), 3)})
            log.warning("registry: live variant %s of %s demoted to "
                        "float32 (%s)", dt, mv.version, vi.parity["why"])
        # batches in flight keep the engines alive through their handles
        vi.engine = None
        vi.engines = []
        raise ParityRefused(vi.last_error)

    def cheapest_variant(self, version: str) -> str:
        """Among the float32 base and the version's parity-passing ready
        variants, the dtype whose warmup cost table prices the bucket
        ladder cheapest (all engines share the ladder)."""
        with self._state:
            mv = self._get(version)
            candidates = {"float32": mv.engine}
            for dt, vi in mv.variants.items():
                if vi.state == "ready" and vi.engine is not None:
                    candidates[dt] = vi.engine

        def price(engine) -> float:
            costs = engine.bucket_costs()
            return sum(costs.values()) if costs else float("inf")

        return min(candidates, key=lambda dt: price(candidates[dt]))

    def activate_infer_dtype(self, version: str, choice: str) -> str:
        """Warm + gate the requested variant(s) of `version` and promote
        the pick. 'auto' tries every variant the model supports and
        promotes the cheapest that passes (float32 included); an explicit
        dtype raises if its variant is refused. Returns the dtype now
        live."""
        if choice == "auto":
            targets = [dt for dt in PARITY_GATES
                       if variant_supported(self.factory.model, dt)]
        else:
            targets = [choice]
        errors = {}
        for dt in targets:
            try:
                self.add_variant(version, dt)
            except ParityRefused as e:
                errors[dt] = e
                log.warning("variant %s of %s refused: %s", dt, version, e)
        if choice == "auto":
            pick = self.cheapest_variant(version)
        else:
            if choice in errors:
                raise errors[choice]
            pick = choice
        self.promote(version, infer_dtype=pick)
        return pick

    def go_live(self, version: str, choice: str) -> str:
        """Put `version` live at the configured precision `choice`: the
        one path of process start and of SIGHUP. float32 is promoted at
        once; a variant only once it is warmed and gated. A gate refusal
        is forgiven: the version goes live at float32, loudly. Any other
        failure (a variant kernel that does not build or launch) raises
        with nothing promoted, so whatever was live stays live. Returns
        the dtype now live."""
        if choice != "float32":
            try:
                return self.activate_infer_dtype(version, choice)
            except ParityRefused:
                log.exception("registry: %s refused on %s; it goes live "
                              "at float32", choice, version)
        self.promote(version)
        return "float32"

    # -- the confidence cascade ---------------------------------------------

    def _cascade_gate(self, mv: ModelVersion, vi: VariantInfo,
                      threshold: Optional[float] = None,
                      max_escalation: float = 0.5) -> dict:
        """The cascade's gate: the held-out batch through the float32
        engine and the cheap variant, then calibrate (or, given
        `threshold`, judge) the threshold so that the COMPOSED answer
        agrees with float32 within the variant's own agreement bar."""
        x = self._parity_batch()
        # lint: allow[DML015] admin-path cascade parity-gate calibration, never the request path
        ref = mv.engines[0].infer(x)
        # lint: allow[DML015] admin-path cascade parity-gate calibration, never the request path
        cheap = vi.engines[0].infer(x)
        return cascade_mod.calibrate(
            np.asarray(ref), np.asarray(cheap),
            min_agreement=PARITY_GATES[vi.infer_dtype][0],
            threshold=threshold, max_escalation=max_escalation)

    def _refresh_live_routes(self, mv: ModelVersion) -> None:
        """Re-set the live route on `mv` (same engines, current
        alternates) and flush the cache, after a cascade change, so
        pinned routes and composed entries never serve a stale
        calibration."""
        live_dt = self.router.live_infer_dtype()
        engines = None
        if live_dt not in (None, "float32"):
            lvi = mv.variants.get(live_dt)
            if lvi is not None and lvi.engines:
                engines = lvi.engines
        self._route_set("live", mv, engines=engines)

    def enable_cascade(self, version: Optional[str] = None,
                       cheap_dtype: str = "auto",
                       threshold: Optional[float] = None,
                       max_escalation: float = 0.5):
        """Calibrate and gate a confidence cascade on `version` (default:
        the live one). `cheap_dtype` 'auto' takes the cheapest ready
        non-float32 variant by warmup-measured bucket cost (int8 when
        none is ready yet); an explicit dtype is warmed and gated by
        add_variant first. `threshold` overrides the calibration search
        and faces the same gate. Returns the CascadeState now active;
        raises RuntimeError when the gate refuses (the version's cascade
        cleared, the refusal recorded as an event) or the router cannot
        resolve pinned routes (a fleet front)."""
        with self._admin:
            if not getattr(self.router, "supports_alternates", False):
                raise RuntimeError(
                    "router does not support pinned-route alternates "
                    "(fleet front / engine double); a cascade needs "
                    "per-dtype dispatch on one routing table")
            if version is None:
                version = self.router.live_version()
                if version is None:
                    raise RuntimeError(
                        "no live version to enable a cascade on")
            with self._state:
                mv = self._get(version)
                if mv.state not in ("ready", "live"):
                    raise RuntimeError(
                        f"version {version!r} is {mv.state!r}; a cascade "
                        "hangs off a warmed version")
                ready = {dt: vi for dt, vi in mv.variants.items()
                         if vi.state == "ready" and vi.engines}
            if cheap_dtype == "auto":
                if ready:
                    def price(vi) -> float:
                        costs = vi.engine.bucket_costs()
                        return (sum(costs.values()) if costs
                                else float("inf"))
                    cheap_dtype = min(ready,
                                      key=lambda dt: price(ready[dt]))
                else:
                    cheap_dtype = "int8"
            if cheap_dtype in (None, "float32"):
                raise ValueError(
                    "the cascade's cheap stage must be a low-precision "
                    f"variant, not {cheap_dtype!r}")
            # checks the dtype, warms and gates once; a refusal raises
            vi = self.add_variant(version, cheap_dtype)
            rec = self._cascade_gate(mv, vi, threshold=threshold,
                                     max_escalation=max_escalation)
            if not rec["passed"]:
                with self._state:
                    mv.cascade = None
                    self._events.append({
                        "event": "cascade_refused", "version": version,
                        "cheap_dtype": cheap_dtype, "reason": rec["why"],
                        # lint: allow[DML004] wall-clock event stamp for operators
                        "at": round(time.time(), 3)})
                raise RuntimeError(
                    f"cascade-accuracy gate REFUSED {cheap_dtype!r} "
                    f"cascade of {version!r}: {rec['why']}")
            state = cascade_mod.CascadeState(
                cheap_dtype=cheap_dtype, threshold=rec["threshold"],
                calibration=rec)
            with self._state:
                mv.cascade = state
                self._events.append({
                    "event": "cascade_enabled", "version": version,
                    "cheap_dtype": cheap_dtype,
                    "threshold": round(rec["threshold"], 6),
                    "escalation_fraction": rec["escalation_fraction"],
                    # lint: allow[DML004] wall-clock event stamp for operators
                    "at": round(time.time(), 3)})
            if self.router.live_version() == version:
                self._refresh_live_routes(mv)
            log.info("registry: cascade enabled on %s (%s, threshold %.4f, "
                     "composed agreement %s, escalating %.1f%% of the "
                     "calibration batch)", version, cheap_dtype,
                     rec["threshold"], rec["composed_agreement"],
                     100 * rec["escalation_fraction"])
            return state

    def set_cascade_threshold(self, version: str, threshold: float):
        """Judge `version`'s cascade again at an operator's threshold
        (promote's `cascade_threshold`), by the same composed gate; a
        refusal raises RuntimeError (409) and keeps the previous
        state."""
        with self._admin:
            with self._state:
                mv = self._get(version)
                state = mv.cascade
            if state is None:
                raise RuntimeError(
                    f"version {version!r} has no cascade to "
                    "re-threshold; enable one first")
            vi = mv.variants.get(state.cheap_dtype)
            if vi is None or vi.state != "ready" or not vi.engines:
                raise RuntimeError(
                    f"cascade variant {state.cheap_dtype!r} of "
                    f"{version!r} is no longer ready; re-enable the "
                    "cascade")
            rec = self._cascade_gate(
                mv, vi, threshold=threshold,
                max_escalation=state.calibration.get("max_escalation",
                                                     0.5))
            if not rec["passed"]:
                raise RuntimeError(
                    f"cascade threshold override {threshold!r} REFUSED "
                    f"for {version!r}: {rec['why']}")
            new = cascade_mod.CascadeState(
                cheap_dtype=state.cheap_dtype,
                threshold=rec["threshold"], calibration=rec)
            with self._state:
                mv.cascade = new
                self._events.append({
                    "event": "cascade_threshold_set", "version": version,
                    "threshold": round(rec["threshold"], 6),
                    # lint: allow[DML004] wall-clock event stamp for operators
                    "at": round(time.time(), 3)})
            if self.router.live_version() == version:
                self._refresh_live_routes(mv)
            return new

    def cascade_plan(self) -> Optional[tuple]:
        """(live version, CascadeState) when the live version has a
        calibrated cascade (the CascadeFront's read on every request),
        else None: every class then degrades to the live route."""
        live = self.router.live_version()
        if live is None:
            return None
        with self._state:
            mv = self._versions.get(live)
            if mv is None or mv.cascade is None:
                return None
            return (live, mv.cascade)

    # -- routing -----------------------------------------------------------

    def promote(self, version: str,
                infer_dtype: Optional[str] = None,
                cascade_threshold: Optional[float] = None
                ) -> ModelVersion:
        """Atomic hot-swap: `version` (warmed: 'ready' or already 'live')
        becomes the live target, through its float32 engines or, with
        `infer_dtype`, one of its parity-passing ready variants. The
        demoted version stays resident in state 'ready'.
        `cascade_threshold` first judges the version's cascade at that
        threshold; a refusal aborts the promote (the old live stays)."""
        with self._admin:
            if cascade_threshold is not None:
                self.set_cascade_threshold(version, cascade_threshold)
            return self._promote_locked(version, infer_dtype)

    def _promote_locked(self, version: str,
                        infer_dtype: Optional[str]) -> ModelVersion:
        with self._state:
            mv = self._get(version)
            if mv.state not in ("ready", "live"):
                raise RuntimeError(
                    f"version {version!r} is {mv.state!r}; only a warmed "
                    "('ready') version may take live traffic")
            engines = None
            if infer_dtype not in (None, "float32"):
                vi = mv.variants.get(infer_dtype)
                if vi is None or vi.state != "ready" or not vi.engines:
                    why = vi.last_error if vi is not None else "never warmed"
                    raise RuntimeError(
                        f"variant {infer_dtype!r} of {version!r} is not "
                        f"promotable ({why}); only a parity-passing ready "
                        "variant may take traffic")
                engines = vi.engines
            prev = self.router.live_version()
            self._route_set("live", mv, engines=engines)
            mv.state = "live"
            if prev is not None and prev != version:
                old = self._versions.get(prev)
                if old is not None:
                    old.state = "ready"
            self._evict_locked(protect={version})
            return mv

    def rollback(self, from_version: str,
                 reason: str) -> Optional[ModelVersion]:
        """Demote `from_version` (if still live) and promote, through its
        float32 engine, the newest healthy resident: 'ready', engine
        resident, no recorded error. The demoted version stays resident
        with `reason` as its last_error, which keeps it from being rolled
        back to. Records a 'rollback' event, or 'rollback_failed' when no
        healthy fallback exists (the tripped version then stays live).
        Returns the newly live version, or None."""
        with self._admin, self._state:
            live = self.router.live_version()
            if live != from_version:
                log.info("rollback from %s skipped: live is already %s",
                         from_version, live)
                return None
            candidates = [
                mv for name, mv in self._versions.items()
                if name != from_version and mv.state == "ready"
                and mv.engines and mv.last_error is None]
            # "at" is wall clock, for display only
            event = {"from": from_version, "reason": reason,
                     # lint: allow[DML004] wall-clock event stamp for operators
                     "at": round(time.time(), 3)}
            if not candidates:
                self._events.append({"event": "rollback_failed",
                                     "to": None, **event})
                log.error("rollback from %s FAILED: no healthy resident "
                          "fallback (%s); keeping it live", from_version,
                          reason)
                return None
            target = max(candidates, key=lambda mv: mv.loaded_mono)
            self._route_set("live", target)
            target.state = "live"
            old = self._versions.get(from_version)
            if old is not None:
                old.state = "ready"
                old.last_error = reason
            self._events.append({"event": "rollback",
                                 "to": target.version, **event})
            log.warning("rollback: %s -> %s (%s)", from_version,
                        target.version, reason)
            return target

    def events(self) -> list:
        """Lifecycle events, oldest first: rollbacks, failed rollbacks and
        variant demotions."""
        with self._state:
            return list(self._events)

    def set_shadow(self, version: str, fraction: float = 0.1
                   ) -> ModelVersion:
        """Duplicate `fraction` of live traffic to `version` (warmed, not
        live); its results are compared and dropped, never returned."""
        with self._admin, self._state:
            mv = self._get(version)
            if mv.state != "ready":
                raise RuntimeError(
                    f"version {version!r} is {mv.state!r}; only a warmed "
                    "non-live version can shadow")
            self._route_set("shadow", mv, fraction)
            return mv

    def set_canary(self, version: str, fraction: float = 0.1
                   ) -> ModelVersion:
        """Route `fraction` of traffic to `version` (warmed, not live) for
        real; version-tagged metrics keep the two populations apart."""
        with self._admin, self._state:
            mv = self._get(version)
            if mv.state != "ready":
                raise RuntimeError(
                    f"version {version!r} is {mv.state!r}; only a warmed "
                    "non-live version can take canary traffic")
            self._route_set("canary", mv, fraction)
            return mv

    def clear_candidates(self) -> None:
        self.router.clear_candidates()

    # -- introspection -----------------------------------------------------

    def _get(self, version: str) -> ModelVersion:
        mv = self._versions.get(version)
        if mv is None:
            raise KeyError(f"unknown version {version!r}; loaded: "
                           f"{sorted(self._versions)}")
        return mv

    def get(self, version: str) -> ModelVersion:
        with self._state:
            return self._get(version)

    def live_version(self) -> Optional[str]:
        return self.router.live_version()

    def describe(self) -> dict:
        with self._state:
            return {
                "versions": [mv.describe()
                             for mv in self._versions.values()],
                "routes": self.router.routes(),
                "live_infer_dtype": self.router.live_infer_dtype(),
                "events": list(self._events),
                "max_versions": self.max_versions,
                "checkpoint_dir": self.checkpoint_dir,
                "buckets": list(self.factory.buckets),
                "max_batch": self.factory.max_batch,
                "device": str(self.factory.device),
                "devices": [str(d) for d in self.factory.devices],
                "replicas": self.n_replicas,
            }

    # -- eviction ----------------------------------------------------------

    def _evict_locked(self, protect: set = frozenset()) -> None:
        """Drop the oldest routeless versions past max_versions (the
        caller holds _state): 'failed', or 'ready' and holding no route
        (live, canary or shadow).
        Versions in `protect` (the one just added or promoted) are never
        dropped. A batch in flight keeps its engine alive through its
        handle, so eviction never frees an engine under a dispatch."""
        in_route = self.router.versions_in_route()
        while len(self._versions) > self.max_versions:
            for name, mv in list(self._versions.items()):
                if name in protect:
                    continue
                if mv.state == "failed" or (
                        mv.state == "ready" and name not in in_route):
                    del self._versions[name]
                    log.info("registry: evicted %s (%s)", name, mv.state)
                    break
            else:
                return            # everything left is routed or warming


def build_serving(cfg, metrics=None, own_stream: bool = False):
    """(registry, router, factory) from a Config: `cfg.model` (mlp or
    lenet), its device, bucket ladder, checkpoint_dir and
    serve_max_versions; the router records shadow comparisons into
    `metrics` and draws its routes from cfg.seed. With serve_replicas > 1
    the router's slot holds a ReplicaSet (serve/fleet.py) of that many
    replicas, with serve_replica_inflight and serve_hedge; 1 keeps the
    bare Router. The engines serve over cfg.num_devices cards (None:
    every visible card; EngineFactory cuts them among the replicas).
    `own_stream` launches every engine on CUDA streams of the factory's
    own. No version is loaded yet: the caller bootstraps. Raises without
    a card unless cfg.device is 'cpu', and when cfg.num_devices asks for
    more devices than are visible."""
    from distributedmnist_tpu_torch import models
    from distributedmnist_tpu_torch.parallel.mesh import get_devices

    models.build(cfg.model, device="meta")    # refuses unknown names
    factory = EngineFactory(cfg.model, device=cfg.device,
                            max_batch=cfg.serve_max_batch,
                            replicas=cfg.serve_replicas,
                            own_stream=own_stream,
                            devices=get_devices(cfg.device, cfg.num_devices))
    if cfg.serve_replicas > 1:
        router = factory.make_fleet(
            metrics=metrics, seed=cfg.seed,
            per_replica_inflight=cfg.serve_replica_inflight,
            hedge=cfg.serve_hedge)
    else:
        router = factory.make_router(metrics=metrics, seed=cfg.seed)
    registry = ModelRegistry(factory, router,
                             checkpoint_dir=cfg.checkpoint_dir,
                             max_versions=cfg.serve_max_versions)
    return registry, router, factory
