"""Multi-tenant, multi-model serving: per-model queues under one global
scheduler (the port of the JAX package's serve/tenancy.py, with its
names, keys, error texts and status codes).

- **ModelCatalog** — several models (MLP and LeNet-5) in one process,
  each with its OWN registry, router, EngineFactory and batcher, built by
  the same `registry.build_serving(cfg)` that boots a single-model
  server: each keeps its bucket ladder, measured cost table, dtype
  variants and promote/rollback state. The per-model batchers are the
  per-model queues. On the card each model's engines launch on a CUDA
  stream of their own, so one model's dispatch never queues behind the
  other's on the default stream.

- **GlobalScheduler** — one scheduler owns every dispatch decision
  across tenants and models (Clockwork's premise: centralize the
  decisions, price them with a measured cost model). Admission maps the
  `X-Tenant` header to a configured SLO class (quota, deadline, weight);
  a token bucket enforces the quota with 429 and Retry-After (Clipper:
  shed at the door per class). The order across the per-tenant queues
  is weighted deficit round robin (scheduler.drr_grant), with the
  consecutive-skip bound ASSERTED on every grant; which model a tenant
  drains next is earliest-feasible-deadline (scheduler.edf_pick) priced
  by the live router's per-bucket cost table, and a head that cannot
  make its deadline even if dispatched now is shed with 504. A cold
  model's warmup is a priced, scheduled event on a warm thread of the
  scheduler's own, never a surprise on the dispatch path.

Before a quota or watermark shed the scheduler probes the prediction
cache (cache.probe): a cached answer costs no device work, so it is
served even over quota.

All tenancy accounting (`_tokens`, `_deficits`, `_skips`, `_granted`,
`_pending_rows`, `_queues`, `_cursor`, `_warming`) is mutated only under
the scheduler's condition `tenancy.sched`. The scheduler reads time from
an injectable `clock` (time.monotonic by default; a test's clock keeps
its epoch, since the deadlines taken on it ride into the batchers, which
read time.monotonic). If the grant thread
dies (a broken skip bound raises AssertionError there), every queued
request fails with its error, later submits are refused, and stop()
raises it.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from collections import deque
from concurrent.futures import Future
from typing import Callable, Optional

import numpy as np

from distributedmnist_tpu_torch.analysis.locks import (make_condition,
                                                       make_thread)
from distributedmnist_tpu_torch.serve import scheduler as policy
from distributedmnist_tpu_torch.serve.batcher import DynamicBatcher, Rejected
from distributedmnist_tpu_torch.serve.resilience import DeadlineExceeded

log = logging.getLogger("distributedmnist_tpu_torch")


class QuotaExceeded(RuntimeError):
    """Tenant over its token-bucket quota: 429. Carries the bucket's
    refill time so the server can stamp Retry-After."""

    status = 429

    def __init__(self, msg: str, retry_after_s: float = 1.0):
        super().__init__(msg)
        self.retry_after_s = max(retry_after_s, 0.0)


@dataclasses.dataclass(frozen=True)
class SLOClass:
    """One tenant admission class. `qps=None` means unlimited (no token
    bucket), `deadline_ms=None` best-effort (EDF ranks it after every
    deadlined head), `model=None` the catalog's default model."""

    name: str
    qps: Optional[float] = None
    burst: float = 1.0
    deadline_ms: Optional[float] = None
    weight: float = 1.0
    model: Optional[str] = None

    def __post_init__(self):
        if self.qps is not None and self.qps <= 0:
            raise ValueError(f"tenant {self.name}: qps must be > 0")
        if self.burst < 1.0:
            raise ValueError(f"tenant {self.name}: burst must be >= 1")
        if self.deadline_ms is not None and self.deadline_ms <= 0:
            raise ValueError(
                f"tenant {self.name}: deadline_ms must be > 0")
        if self.weight <= 0:
            raise ValueError(f"tenant {self.name}: weight must be > 0")


def parse_tenants(spec: str) -> dict:
    """Parse --serve-tenants, `name:k=v,k=v;name2:...` with keys qps,
    burst, deadline_ms, weight and model, into {name: SLOClass}. The
    result always holds a "default" class (unlimited, weight 1), which an
    absent or unknown X-Tenant resolves to; an entry named `default`
    overrides it. Raises ValueError on anything malformed."""
    classes = {}
    for part in (spec or "").split(";"):
        part = part.strip()
        if not part:
            continue
        name, sep, body = part.partition(":")
        name = name.strip()
        if not name:
            raise ValueError(f"tenant spec {part!r}: empty name")
        kwargs: dict = {}
        if sep:
            for kv in body.split(","):
                kv = kv.strip()
                if not kv:
                    continue
                k, eq, v = kv.partition("=")
                if not eq:
                    raise ValueError(
                        f"tenant {name}: expected k=v, got {kv!r}")
                k = k.strip()
                v = v.strip()
                if k in ("qps", "burst", "deadline_ms", "weight"):
                    kwargs[k] = float(v)
                elif k == "model":
                    kwargs[k] = v
                else:
                    raise ValueError(f"tenant {name}: unknown key {k!r}")
        if name in classes:
            raise ValueError(f"tenant {name} specified twice")
        classes[name] = SLOClass(name=name, **kwargs)
    classes.setdefault("default", SLOClass(name="default"))
    return classes


def token_admit(tokens: float, t_last: float, now: float,
                qps: Optional[float], burst: float) -> tuple:
    """One token-bucket admission step: (ok, tokens_after,
    retry_after_s). Refill at `qps` tokens/s since `t_last`, capped at
    `burst`; admission costs one token. With no rate the bucket is inert.
    `retry_after_s` is the time until one token exists."""
    if qps is None or qps <= 0:
        return True, tokens, 0.0
    tokens = min(burst, tokens + max(now - t_last, 0.0) * qps)
    if tokens >= 1.0:
        return True, tokens - 1.0, 0.0
    return False, tokens, (1.0 - tokens) / qps


@dataclasses.dataclass
class CatalogEntry:
    """One model's serving stack in the catalog: the registry, router
    and factory `build_serving` boots, the model's own DynamicBatcher
    and, under --serve-cache, its cache front."""

    name: str
    registry: "object"
    router: "object"
    factory: "object"
    batcher: DynamicBatcher
    front: "object" = None          # CacheFront when caching is on
    cache: "object" = None          # PredictionCache or None
    warmup_s: Optional[float] = None
    warmup_compile_events: Optional[int] = None

    def resident(self) -> bool:
        """Live and dispatchable now (only the scheduler's warm
        decisions and eager boots change it)."""
        return self.router.live_version() is not None

    def submit_target(self):
        return self.front if self.front is not None else self.batcher


class ModelCatalog:
    """An ordered set of CatalogEntry, one a model name, built once at
    boot and read-only afterwards; each entry's lifecycle happens inside
    its own registry."""

    def __init__(self):
        self._models: dict = {}

    def add(self, entry: CatalogEntry) -> None:
        if entry.name in self._models:
            raise ValueError(f"model {entry.name!r} already in catalog")
        self._models[entry.name] = entry

    def get(self, name: str) -> CatalogEntry:
        try:
            return self._models[name]
        except KeyError:
            raise KeyError(
                f"unknown model {name!r}; catalog has {self.names()}")

    def names(self) -> list:
        return list(self._models)

    def default(self) -> str:
        return next(iter(self._models))

    def entries(self) -> list:
        return list(self._models.values())

    def ensure_live(self, name: str, seed: int = 0,
                    infer_dtype: str = "float32") -> CatalogEntry:
        """Boot one model to live: bootstrap (load or fresh-init, warm,
        promote; the registry's admin lock serializes concurrent
        callers), then best-effort activation of `infer_dtype` (a refusal
        is logged and float32 stays live). Idempotent. The one residency
        transition: the scheduler's warm thread and eager boots call
        it."""
        entry = self.get(name)
        if entry.resident():
            return entry
        t0 = time.monotonic()
        mv = entry.registry.bootstrap(seed=seed)
        entry.warmup_s = time.monotonic() - t0
        entry.warmup_compile_events = mv.warmup_builds
        log.info("catalog: %s live as %s (%s) in %.2fs — %d kernel "
                 "library loads", name, mv.version, mv.source,
                 entry.warmup_s, mv.warmup_builds)
        if infer_dtype != "float32":
            try:
                entry.registry.activate_infer_dtype(mv.version,
                                                    infer_dtype)
            except Exception:
                log.exception("catalog: %s infer dtype %s refused; "
                              "float32 stays live", name, infer_dtype)
        return entry

    def stop(self, drain: bool = True) -> None:
        for entry in self._models.values():
            entry.batcher.stop(drain=drain)

    def describe(self) -> dict:
        out = {}
        for name, e in self._models.items():
            out[name] = {
                "resident": e.resident(),
                "live_version": e.router.live_version(),
                "live_infer_dtype": e.router.live_infer_dtype(),
                "buckets": list(e.factory.buckets),
                "max_batch": e.factory.max_batch,
                "warmup_s": (round(e.warmup_s, 3)
                             if e.warmup_s is not None else None),
                "warmup_compile_events": e.warmup_compile_events,
                "pending_rows": e.batcher.pending_rows(),
            }
        return out


def _model_ckpt_dir(base: Optional[str], name: str) -> Optional[str]:
    """Each model loads from its own checkpoint subtree
    (`<base>/<model>`): one tree for two models would restore one
    model's parameters into the other's forward."""
    return os.path.join(base, name) if base else None


def build_catalog(cfg, metrics=None, own_streams: bool = True
                  ) -> ModelCatalog:
    """One `build_serving` a name in cfg.serve_models (or cfg.model
    alone), each on its own checkpoint subtree, with its own started
    DynamicBatcher (fast lane off: a lane submit would dispatch before
    the scheduler's grant) and, under --serve-cache, its own cache
    front. Every model's factory serves over the same cards
    (cfg.num_devices, default every visible card). `own_streams` puts
    each model's engines on CUDA streams of their own on the card.
    Nothing is warmed here."""
    from distributedmnist_tpu_torch.serve.cache import build_cache_front
    from distributedmnist_tpu_torch.serve.registry import build_serving

    names = [s.strip() for s in (cfg.serve_models or "").split(",")
             if s.strip()]
    if not names:
        names = [cfg.model]
    catalog = ModelCatalog()
    for name in dict.fromkeys(names):
        mcfg = dataclasses.replace(
            cfg, model=name,
            checkpoint_dir=_model_ckpt_dir(cfg.checkpoint_dir, name))
        registry, router, factory = build_serving(
            mcfg, metrics=metrics, own_stream=own_streams)
        batcher = DynamicBatcher(
            router, max_batch=mcfg.serve_max_batch,
            max_wait_us=mcfg.serve_max_wait_us,
            queue_depth=mcfg.serve_queue_depth,
            max_inflight=mcfg.serve_max_inflight,
            slo_ms=mcfg.serve_slo_ms, adaptive=mcfg.serve_adaptive,
            dedup=mcfg.serve_dedup, metrics=metrics).start()
        front = cache = None
        if cfg.serve_cache:
            front, cache = build_cache_front(mcfg, batcher, router,
                                             registry, metrics=metrics)
        catalog.add(CatalogEntry(name=name, registry=registry,
                                 router=router, factory=factory,
                                 batcher=batcher, front=front,
                                 cache=cache))
    return catalog


@dataclasses.dataclass
class _Pending:
    """One admitted request in a per-(tenant, model) queue, waiting for
    the scheduler's grant."""

    x: "object"
    n: int
    tenant: str
    model: str
    t_enqueue: float
    deadline: Optional[float]          # absolute, on the clock, or None
    route: Optional[str]
    future: Future = dataclasses.field(default_factory=Future)


class GlobalScheduler:
    """The one dispatch authority over a ModelCatalog (see the module
    docstring). submit() admits (quota, then watermark, probing the
    cache before either sheds) into per-(tenant, model) queues; the
    grant thread picks the tenant by weighted DRR and its model by EDF
    priced off the live cost tables, sheds infeasible heads with 504,
    schedules cold models' warmups, and forwards granted runs into the
    model's own batcher with {tenant, model} span tags."""

    def __init__(self, catalog: ModelCatalog, tenants: dict,
                 metrics=None, quantum_s: float = 0.005,
                 tenant_queue_rows: int = 4096, seed: int = 0,
                 infer_dtype: str = "float32",
                 warmup_est_s: float = 5.0,
                 clock: Callable[[], float] = time.monotonic):
        if quantum_s <= 0:
            raise ValueError(f"quantum_s must be > 0, got {quantum_s}")
        self.catalog = catalog
        self.metrics = metrics
        self.quantum_s = quantum_s
        self.tenant_queue_rows = tenant_queue_rows
        self.seed = seed
        self.infer_dtype = infer_dtype
        self.warmup_est_s = warmup_est_s
        self.clock = clock
        # Dispatch pacing (Clockwork): a model is grantable only while
        # its batcher stages fewer than this many max_batch multiples;
        # past that its backlog waits in the per-tenant queues, where
        # DRR/EDF still own the order.
        self.staging_rows_factor = 2
        self._classes = dict(tenants)
        self._classes.setdefault("default", SLOClass(name="default"))
        for cls in self._classes.values():
            if cls.model is not None:
                catalog.get(cls.model)   # fail the boot on a bad route
        self._cond = make_condition("tenancy.sched")
        self._ring = sorted(self._classes)     # fixed DRR visit order
        self._cursor = 0
        self._queues: dict = {}        # (tenant, model) -> deque
        self._tokens: dict = {}        # tenant -> [tokens, t_last]
        self._deficits: dict = {}      # tenant -> DRR credit (seconds)
        self._skips: dict = {}         # tenant -> consecutive passes
        self._granted: dict = {}       # tenant -> rows ever granted
        self._pending_rows: dict = {}  # tenant -> rows queued now
        self._warming: set = set()     # models with a warm in flight
        self._max_head_cost_s = 0.0    # running max, the bound's basis
        self.max_skip_observed = 0
        self._stop = False
        self._drain = True
        self._thread = None
        # the grant thread's exception, if it died
        self.failure: Optional[BaseException] = None
        now = clock()
        for name, cls in self._classes.items():
            self._tokens[name] = [cls.burst, now]
            self._deficits[name] = 0.0
            self._skips[name] = 0
            self._granted[name] = 0
            self._pending_rows[name] = 0

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "GlobalScheduler":
        if self._thread is not None:
            raise RuntimeError("scheduler already started")
        self._thread = make_thread(target=self._run,
                                   name="serve-tenancy-sched",
                                   daemon=True)
        self._thread.start()
        return self

    def stop(self, drain: bool = True) -> None:
        """Close admission; with drain=True the grant loop dispatches
        until every queue is empty, then the catalog's batchers drain and
        stop. Raises RuntimeError if the grant thread had died."""
        with self._cond:
            self._stop = True
            self._drain = drain
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=30.0)
        self.catalog.stop(drain=drain)
        if self.failure is not None:
            raise RuntimeError(
                "the tenancy scheduler's grant thread died: "
                f"{type(self.failure).__name__}: {self.failure}") \
                from self.failure

    # -- admission (the front door) ----------------------------------------

    def submit(self, x, tenant: Optional[str] = None,
               deadline_s: Optional[float] = None,
               route: Optional[str] = None,
               model: Optional[str] = None) -> Future:
        """Admit one request. Tenant -> SLO class (an absent or unknown
        tenant collapses into "default"); model -> the argument, else the
        class's route, else the catalog default. A quota breach raises
        QuotaExceeded (429, retry_after_s) and a full tenant queue
        Rejected (503), but either shed first probes the cache, and a
        hit is served instead. An absent deadline (on the scheduler's
        clock) takes the class default; an expired one is shed with 504
        at the door."""
        cls = self._classes.get(tenant if tenant is not None
                                else "default")
        if cls is None:
            cls = self._classes["default"]
        name = cls.name
        model = model or cls.model or self.catalog.default()
        entry = self.catalog.get(model)
        x = np.asarray(x)
        n = int(x.shape[0]) if x.ndim >= 2 else 1
        now = self.clock()
        if deadline_s is None and cls.deadline_ms is not None:
            deadline_s = now + cls.deadline_ms / 1e3
        if deadline_s is not None and now >= deadline_s:
            if self.metrics is not None:
                self.metrics.record_tenant_refusal(name, "deadline", n)
            raise DeadlineExceeded(
                "deadline already expired at admission "
                f"({(now - deadline_s) * 1e3:.1f} ms ago)")
        req = _Pending(x=x, n=n, tenant=name, model=model,
                       t_enqueue=now, deadline=deadline_s, route=route)
        shed_exc = None
        with self._cond:
            if self._stop:
                raise RuntimeError("tenancy scheduler is stopped")
            if self.failure is not None:
                raise RuntimeError(
                    "tenancy scheduler is stopped: its grant thread "
                    f"died ({type(self.failure).__name__})")
            tokens, t_last = self._tokens[name]
            ok, tokens, retry_after = token_admit(
                tokens, t_last, now, cls.qps, cls.burst)
            self._tokens[name] = [tokens, now]
            if not ok:
                shed_exc = QuotaExceeded(
                    f"tenant {name!r} over quota ({cls.qps:g} qps, "
                    f"burst {cls.burst:g}); retry in {retry_after:.3f}s",
                    retry_after_s=retry_after)
            elif self._pending_rows[name] + n > self.tenant_queue_rows:
                shed_exc = Rejected(
                    f"tenant {name!r} queue at "
                    f"{self._pending_rows[name]} pending rows; "
                    f"watermark {self.tenant_queue_rows} would be "
                    f"exceeded by {n} more")
            else:
                self._queues.setdefault((name, model),
                                        deque()).append(req)
                self._pending_rows[name] += n
                self._cond.notify_all()
        if shed_exc is None:
            if self.metrics is not None:
                self.metrics.record_tenant_request(name, model, n)
            return req.future
        # the cache-aware shed, probed outside the condition; a probe
        # miss counts nothing in the cache
        hit = self._cache_probe(entry, x)
        if hit is not None:
            if self.metrics is not None:
                self.metrics.record_tenant_cache_served(name, model, n)
            req.future.set_result(hit)
            return req.future
        if self.metrics is not None:
            kind = ("quota" if isinstance(shed_exc, QuotaExceeded)
                    else "watermark")
            self.metrics.record_tenant_refusal(name, kind, n)
        raise shed_exc

    def _cache_probe(self, entry: CatalogEntry, x) -> Optional[np.ndarray]:
        if entry.cache is None:
            return None
        from distributedmnist_tpu_torch.serve.cache import content_key

        version = entry.router.live_version()
        if version is None:
            return None
        dtype = entry.router.live_infer_dtype()
        try:
            imgs = entry.router._as_images(x)
            return entry.cache.probe(content_key(version, dtype, imgs))
        except Exception:
            return None      # a probe must never turn a shed into a 500

    # -- the grant loop ----------------------------------------------------

    def _run(self) -> None:
        """The grant thread: the loop, and on its death the failure
        recorded and every queued request failed with it (a waiter must
        not hang on a scheduler that is gone)."""
        try:
            self._loop()
        except BaseException as e:
            log.exception("tenancy scheduler's grant thread died")
            with self._cond:
                self.failure = e
                orphans = [r for q in self._queues.values() for r in q]
                for q in self._queues.values():
                    q.clear()
                for t in self._pending_rows:
                    self._pending_rows[t] = 0
            for r in orphans:
                r.future.set_exception(e)

    def _loop(self) -> None:
        while True:
            sheds: list = []
            grant = None
            warm = None
            with self._cond:
                while (not self._stop
                       and not any(self._queues.values())):
                    self._cond.wait(0.1)
                if self._stop and (not self._drain
                                   or not any(self._queues.values())):
                    break
                grant, sheds, warm = self._grant_locked(self.clock())
                if grant is None and not sheds and warm is None:
                    # backlog, but nothing dispatchable yet (a warming
                    # model, a full staging): park until a warm
                    # completes or capacity frees
                    self._cond.wait(0.01)
            for req, why in sheds:
                self._shed(req, why)
            if warm is not None:
                self._spawn_warm(warm)
            if grant is not None:
                self._forward(*grant)

    def _grant_locked(self, now: float):
        """One scheduling decision under self._cond: (grant, sheds,
        warm). `grant` is (tenant, model, [requests]) to forward outside
        the lock, `sheds` the infeasible requests to fail with 504
        outside it, `warm` a cold model that needs a scheduled warmup."""
        sheds: list = []
        warm = None
        # Per tenant, EDF across that tenant's model queues, heads priced
        # off each model's cost table. Cold models don't compete: their
        # backlog schedules a warmup, and their heads are checked
        # against the priced warmup so doomed waits shed now.
        head_costs: dict = {}
        picks: dict = {}
        for (tenant, model), q in self._queues.items():
            if not q:
                continue
            entry = self.catalog.get(model)
            if not entry.resident():
                if model not in self._warming:
                    self._warming.add(model)
                    warm = model
                wait_s = (entry.warmup_s if entry.warmup_s is not None
                          else self.warmup_est_s)
                while q:
                    head = q[0]
                    cost = wait_s + self._price(entry, head.n)
                    if (head.deadline is not None
                            and now + cost > head.deadline):
                        q.popleft()
                        self._pending_rows[tenant] -= head.n
                        sheds.append((head, cost))
                    else:
                        break
                continue
            if (entry.batcher.pending_rows()
                    >= self.staging_rows_factor * entry.factory.max_batch):
                # the model's staging already holds enough rows to keep
                # its device busy: the backlog stays here, where DRR/EDF
                # decide its order; _complete() wakes the loop
                continue
            head = q[0]
            cost = self._price(entry, head.n)
            prev = picks.get(tenant)
            pick, infeasible = policy.edf_pick(
                ([prev] if prev else []) + [(model, head.deadline,
                                             cost)], now)
            for bad_model in infeasible:
                bq = self._queues[(tenant, bad_model)]
                bad = bq.popleft()
                self._pending_rows[tenant] -= bad.n
                sheds.append((bad, self._price(
                    self.catalog.get(bad_model), bad.n)))
            if pick is not None:
                if prev is None or pick != prev[0]:
                    bq = self._queues[(tenant, pick)]
                    h = bq[0]
                    picks[tenant] = (pick, h.deadline,
                                     self._price(self.catalog.get(pick),
                                                 h.n))
                head_costs[tenant] = picks[tenant][2]
        if not head_costs:
            return None, sheds, warm
        weights = {t: c.weight for t, c in self._classes.items()}
        tenant, self._cursor, _ = policy.drr_grant(
            self._ring, self._cursor, self._deficits, weights,
            self.quantum_s, head_costs)
        # Starvation-freedom, asserted: every other tenant whose head was
        # feasible this round is passed over once, and none may be passed
        # over more than the closed-form DRR bound, priced at the running
        # max head cost (skips accrued under an expensive head must not
        # trip a bound shrunk by a later cheap one). Checked before the
        # run leaves its queue, so a failed check strands no request.
        self._max_head_cost_s = max(self._max_head_cost_s,
                                    max(head_costs.values()))
        bound = policy.drr_skip_bound(
            len(self._ring), self._max_head_cost_s, self.quantum_s,
            min(w for w in weights.values()))
        self._skips[tenant] = 0
        for other in head_costs:
            if other == tenant:
                continue
            self._skips[other] += 1
            self.max_skip_observed = max(self.max_skip_observed,
                                         self._skips[other])
            assert self._skips[other] <= bound, (
                f"WFQ starvation: tenant {other!r} passed over "
                f"{self._skips[other]} consecutive grants "
                f"(bound {bound}) — deficit accounting is broken")
        model = picks[tenant][0]
        entry = self.catalog.get(model)
        q = self._queues[(tenant, model)]
        run: list = []
        rows = 0
        while q:
            head = q[0]
            if rows + head.n > entry.factory.max_batch:
                break
            cost = self._price(entry, head.n)
            if run and self._deficits[tenant] < cost:
                break
            q.popleft()
            policy.drr_charge(self._deficits, tenant, cost)
            self._pending_rows[tenant] -= head.n
            rows += head.n
            run.append(head)
        self._granted[tenant] += rows
        return (tenant, model, run), sheds, warm

    def _price(self, entry: CatalogEntry, rows: int) -> float:
        return policy.estimate_dispatch_s(rows, list(entry.factory.buckets),
                                          entry.router.bucket_costs())

    def _shed(self, req: _Pending, cost_s: float) -> None:
        """Fail one infeasible request now (504), off the lock."""
        if self.metrics is not None:
            self.metrics.record_tenant_refusal(req.tenant, "deadline",
                                               req.n)
        req.future.set_exception(DeadlineExceeded(
            f"infeasible: modeled {req.model} dispatch of {req.n} rows "
            f"needs {cost_s * 1e3:.1f} ms but the deadline is "
            f"{(req.deadline - req.t_enqueue) * 1e3:.1f} ms out; shed "
            "before it could poison a batch"))

    def _spawn_warm(self, model: str) -> None:
        """A cold model's backlog schedules its warmup here, on a thread
        of its own: the grant loop goes on dispatching resident models,
        and the cold queue is priced with the warmup until it ends."""
        def _warm():
            try:
                self.catalog.ensure_live(model, seed=self.seed,
                                         infer_dtype=self.infer_dtype)
            except Exception:
                log.exception("scheduled warmup of %s failed", model)
            finally:
                with self._cond:
                    self._warming.discard(model)
                    self._cond.notify_all()
        make_thread(target=_warm, name=f"serve-tenancy-warm-{model}",
                    daemon=True).start()

    def _forward(self, tenant: str, model: str, run: list) -> None:
        """Hand one granted run to the model's batcher (or cache front),
        off the lock, chaining each inner future to the caller's."""
        entry = self.catalog.get(model)
        target = entry.submit_target()
        if self.metrics is not None:
            self.metrics.record_tenant_dispatch(
                tenant, model, sum(r.n for r in run))
        for req in run:
            try:
                inner = target.submit(
                    req.x, deadline_s=req.deadline, route=req.route,
                    tags={"tenant": tenant, "model": model})
            except BaseException as e:
                req.future.set_exception(e)
                continue
            inner.add_done_callback(
                lambda f, r=req: self._complete(r, f))

    def _complete(self, req: _Pending, inner: Future) -> None:
        # capacity freed downstream: wake a grant loop parked at a
        # model's staging cap
        with self._cond:
            self._cond.notify_all()
        done = self.clock()
        cls = self._classes.get(req.tenant)
        slo_ok = None
        if req.deadline is not None:
            slo_ok = done <= req.deadline
        elif cls is not None and cls.deadline_ms is not None:
            slo_ok = (done - req.t_enqueue) <= cls.deadline_ms / 1e3
        if self.metrics is not None:
            self.metrics.record_tenant_done(
                req.tenant, done - req.t_enqueue, slo_ok)
        err = inner.exception()
        if err is not None:
            req.future.set_exception(err)
        else:
            req.future.set_result(inner.result())

    # -- admin surface -----------------------------------------------------

    def classes(self) -> dict:
        """The live SLO-class table (name -> SLOClass), copied."""
        with self._cond:
            return dict(self._classes)

    def set_quota(self, tenant: str, qps: Optional[float] = None,
                  burst: Optional[float] = None) -> SLOClass:
        """Update one tenant's quota live (POST /tenants/{id}/quota); the
        bucket refills to the new burst so a loosened quota takes effect
        now. KeyError for an unknown tenant (404)."""
        with self._cond:
            cls = self._classes.get(tenant)
            if cls is None:
                raise KeyError(f"unknown tenant {tenant!r}")
            cls = dataclasses.replace(
                cls, qps=qps if qps is not None else cls.qps,
                burst=burst if burst is not None else cls.burst)
            self._classes[tenant] = cls
            self._tokens[tenant] = [cls.burst, self.clock()]
            return cls

    def queued_rows(self) -> int:
        with self._cond:
            return sum(self._pending_rows.values())

    def snapshot(self) -> dict:
        """GET /tenants: each tenant's admission config and live
        accounting, and the catalog's residency."""
        with self._cond:
            tenants = {}
            total_granted = sum(self._granted.values()) or 1
            for name in self._ring:
                cls = self._classes[name]
                tenants[name] = {
                    "qps": cls.qps,
                    "burst": cls.burst,
                    "deadline_ms": cls.deadline_ms,
                    "weight": cls.weight,
                    "model": cls.model,
                    "tokens": round(self._tokens[name][0], 3),
                    "deficit_s": round(self._deficits[name], 6),
                    "queued_rows": self._pending_rows[name],
                    "granted_rows": self._granted[name],
                    "granted_share": round(
                        self._granted[name] / total_granted, 4),
                    "consecutive_skips": self._skips[name],
                }
            return {
                "quantum_s": self.quantum_s,
                "tenant_queue_rows": self.tenant_queue_rows,
                "max_skip_observed": self.max_skip_observed,
                "warming": sorted(self._warming),
                "tenants": tenants,
                "models": self.catalog.describe(),
            }


def build_tenancy(cfg, metrics=None) -> tuple:
    """The serve CLI's one-call boot: parse the class table, build the
    catalog, start the scheduler; (catalog, scheduler). Residency is the
    caller's (ensure_live a model) or the scheduler's warm path."""
    classes = parse_tenants(cfg.serve_tenants)
    catalog = build_catalog(cfg, metrics=metrics)
    sched = GlobalScheduler(
        catalog, classes, metrics=metrics,
        quantum_s=cfg.serve_tenant_quantum_us / 1e6,
        tenant_queue_rows=cfg.serve_queue_depth, seed=cfg.seed,
        infer_dtype=cfg.serve_infer_dtype).start()
    return catalog, sched
