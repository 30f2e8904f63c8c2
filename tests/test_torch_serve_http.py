"""The port's HTTP server (distributedmnist_tpu_torch/serve/server.py)
and the serving pieces it needs, against the JAX package, on the CPU.

- ServerState and shed_retry_after_s against the root serve.py's, loaded
  from the file as the JAX tests load it, on the same stub inputs.
- The router's canary and shadow routes against the JAX router on the
  same seed (the draw sequence, shadow only on live batches, the cap,
  swallowed shadow errors), and the registry's "registry full" refusal
  and eviction against the JAX registry.
- The batcher's deadline shed, and the metrics' shadow and deadline
  blocks against the JAX ServeMetrics.
- The server in-process (routes, codes, warming, a failed warm, the
  SIGHUP reload) and as `python -m distributedmnist_tpu_torch.serve
  --port 0` subprocesses: the JAX end-to-end and admin lifecycle tests'
  steps over port checkpoints, and one conformance test that boots the
  root serve.py and the port's server on the same step-N MLP weights and
  sends both the same request script (equal codes, classes and version;
  /healthz and /metrics key sets equal apart from the listed keys of
  unported layers), and again with the request path's layers on in both
  (--serve-cache --serve-dedup --serve-fastlane --serve-trace and a
  fault spec): then /trace and the Prometheus route answer 200 in both,
  and only the fleet's (one replica) and tenancy's /metrics blocks stay
  None.
- The in-process server with those layers on: the Prometheus exposition
  by query and by Accept header, /trace, X-Trace-Id and Server-Timing,
  cache hits version-tagged and metered.
- The fleet and the cascade over HTTP: root serve.py and the port's
  server on the same fitted MLP, with --serve-replicas 2 --serve-hedge
  (drain and rejoin, the last-active 409, /healthz's replicas, /metrics'
  fleet block) and with --serve-cascade (X-Accuracy-Class fast, balanced
  and exact, an unknown class, promote's cascade_threshold 400s and 409):
  the same codes and bodies' keys; ServerState on a fleet against the
  JAX one.
- Tenancy over HTTP: root serve.py and the port's server with
  `--serve-models mlp,lenet --serve-tenants ...` on the same script
  (X-Tenant to a class, an unknown tenant, a free tenant's burst into
  429 with Retry-After, a passed deadline 504, GET /tenants, the quota
  route's 200/400/404, X-Accuracy-Class refused): equal codes and
  bodies' keys, /metrics' tenancy, by_tenant and by_model blocks of
  JAX's keys, the tenant and model families, and the summary's tenancy
  block; the serve CLI's tenancy refusals with the root serve.py's text.
"""

import importlib.util
import json
import math
import os
import re
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from distributedmnist_tpu import models as jmodels
from distributedmnist_tpu.parallel import make_mesh
from distributedmnist_tpu.serve import DynamicBatcher as JDynamicBatcher
from distributedmnist_tpu.serve import metrics as jmetrics_mod
from distributedmnist_tpu.serve import registry as jregistry
from distributedmnist_tpu.serve import router as jrouter
from distributedmnist_tpu_torch import config as tconfig
from distributedmnist_tpu_torch import interop, models
from distributedmnist_tpu_torch.checkpoint import Checkpointer
from distributedmnist_tpu_torch.data import synthetic_mnist
from distributedmnist_tpu_torch.ops import fused as tfused
from distributedmnist_tpu_torch.ops import kernel_lib
from distributedmnist_tpu_torch.serve import (DeadlineExceeded,
                                              DynamicBatcher, ServeMetrics,
                                              build_cache_front,
                                              build_resilience,
                                              build_serving)
from distributedmnist_tpu_torch.serve import trace as ttrace
from distributedmnist_tpu_torch.serve import __main__ as serve_cli
from distributedmnist_tpu_torch.serve import registry as tregistry
from distributedmnist_tpu_torch.serve import router as trouter
from distributedmnist_tpu_torch.serve import server as tserver
from distributedmnist_tpu_torch.serve.process import ServerProcess

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAX_BATCH = 16
# /metrics keys of the JAX server that belong to layers the port has not
# got yet, each with its ROADMAP.md §1 item
UNPORTED_METRICS_KEYS = {
    "autoscale": "item 3: autoscaling",
}


def _load_jax_serve():
    """The root serve.py as a module, as the JAX tests load it."""
    spec = importlib.util.spec_from_file_location(
        "serve_mod_torch_http", os.path.join(REPO, "serve.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _images(n, seed=0):
    return synthetic_mnist(seed=seed, train_n=16, test_n=n)["test_x"][:n]


# -- (a) ServerState and shed_retry_after_s against serve.py ---------------


class _StubRegistry:
    live = None

    def live_version(self):
        return self.live

    def describe(self):
        return {"versions": [1] if self.live else []}


class _StubBatcher:
    def pending_rows(self):
        return 0

    def inflight_batches(self):
        return 0


def test_healthz_state_machine_recovers_from_failed_boot():
    """503 while warming, 200 once any path puts a live version up (also
    after a failed boot), draining terminal: step for step with the JAX
    ServerState on the same stubs, the same codes, states and keys."""
    jserve = _load_jax_serve()
    runs = []
    for state_cls in (jserve.ServerState, tserver.ServerState):
        state = state_cls()
        reg, b = _StubRegistry(), _StubBatcher()
        seen = [state.healthz(reg, b)]
        state.phase = "failed"                  # boot load died
        seen.append(state.healthz(reg, b))
        reg.live = "step-5"                     # admin repaired it
        seen.append(state.healthz(reg, b))
        state.begin_drain()                     # SIGTERM: terminal
        seen.append(state.healthz(reg, b))
        state.mark_running()                    # never resurrected
        seen.append(state.healthz(reg, b))
        runs.append(seen)
    for (jcode, jp), (tcode, tp) in zip(*runs):
        assert tcode == jcode
        assert set(tp) == set(jp)
        for k in ("ok", "state", "live_version", "versions", "rollbacks",
                  "last_rollback", "pending_rows", "inflight_batches"):
            assert tp[k] == jp[k], k
    codes = [(c, p["state"]) for c, p in runs[1]]
    assert codes == [(503, "warming"), (503, "failed"), (200, "running"),
                     (503, "draining"), (503, "draining")]
    assert runs[1][2][1]["live_version"] == "step-5"


def test_shed_retry_after_is_capped_integer_seconds():
    """Integer seconds rounded up, floored at 1, capped: equal to the JAX
    shed_retry_after_s on the JAX test's stub inputs."""
    jserve = _load_jax_serve()

    class StubBatcher:
        controller = None
        max_wait_s = 0.4

        def __init__(self, inflight, costs):
            self._inflight = inflight
            self.engine = SimpleNamespace(bucket_costs=lambda: costs)

        def inflight_batches(self):
            return self._inflight

    cases = [((2, {16: 1.2}), 30, 4), ((1, {16: 1.0}), 30, 3),
             ((32, {16: 60.0}), 30, 30), ((32, {16: 60.0}), 7.9, 7),
             ((0, {}), 30, 1)]
    for args, cap, want in cases:
        got = tserver.shed_retry_after_s(StubBatcher(*args), cap_s=cap)
        assert got == jserve.shed_retry_after_s(StubBatcher(*args),
                                                cap_s=cap) == want
        assert isinstance(got, int)


def test_healthz_reports_started_at_and_uptime():
    """The process start (ISO 8601 UTC) and a growing uptime, with the
    JAX ServerState's keys."""
    import datetime

    jserve = _load_jax_serve()
    reg = _StubRegistry()
    reg.live = "v1"
    state = tserver.ServerState()
    code, payload = state.healthz(reg, _StubBatcher())
    assert code == 200
    _, jpayload = jserve.ServerState().healthz(reg, _StubBatcher())
    assert set(payload) == set(jpayload)
    started = datetime.datetime.fromisoformat(payload["started_at"])
    assert started.tzinfo is not None
    assert abs(started.timestamp() - time.time()) < 5
    assert payload["uptime_s"] >= 0
    time.sleep(0.05)
    _, later = state.healthz(reg, _StubBatcher())
    assert later["started_at"] == payload["started_at"]
    assert later["uptime_s"] > payload["uptime_s"]
    assert "replicas" not in payload


def test_healthz_on_a_fleet_matches_jax():
    """On a fleet registry /healthz carries each replica's state and the
    failover counters, with the JAX ServerState's keys and values; the
    live version's cascade block rides along (None without one)."""
    from distributedmnist_tpu.serve import fleet as jfleet
    from distributedmnist_tpu_torch.serve import fleet as tfleet
    from tests.test_serve_fleet import StubRouter

    jserve = _load_jax_serve()
    seen = []
    for state_cls, fleet_mod in ((jserve.ServerState, jfleet),
                                 (tserver.ServerState, tfleet)):
        reg = _StubRegistry()
        reg.live = "v1"
        reg.router = fleet_mod.ReplicaSet([StubRouter("r0"),
                                           StubRouter("r1")])
        reg.router.drain("r1")
        code, payload = state_cls().healthz(reg, _StubBatcher())
        seen.append((code, set(payload), payload["replicas"],
                     payload["failovers"], payload["cascade"]))
    assert seen[0] == seen[1]
    assert seen[1][2][1]["state"] == "draining"


# -- (b) router and registry against the JAX package -----------------------


class _StubEngine:
    """Engine-shaped double: constant logits per engine (so a shadow
    comparison has a known answer), optional failures and a gate."""

    buckets = (1, 2, 4, 8)
    max_batch = 8

    def __init__(self, cls, infer_dtype="float32", fail_dispatch=False,
                 fail_fetch=False, gate=None):
        self.cls = cls
        self.infer_dtype = infer_dtype
        self.fail_dispatch = fail_dispatch
        self.fail_fetch = fail_fetch
        self.gate = gate
        self.dispatches = 0

    def dispatch(self, x):
        if self.fail_dispatch:
            raise RuntimeError("injected dispatch failure")
        self.dispatches += 1
        n = len(x)
        return SimpleNamespace(n=n, bucket=8)

    def fetch(self, h):
        if self.gate is not None:
            assert self.gate.wait(30)
        if self.fail_fetch:
            raise RuntimeError("injected fetch failure")
        out = np.zeros((h.n, 10), np.float32)
        out[:, self.cls] = 1.0 + self.cls
        return out

    def bucket_costs(self):
        return {}


def _routers(seed, **kw):
    jm, tm = jmetrics_mod.ServeMetrics(), ServeMetrics()
    jr = jrouter.Router(8, (1, 2, 4, 8), "cpu", metrics=jm, seed=seed, **kw)
    tr = trouter.Router(8, (1, 2, 4, 8), "cpu", metrics=tm, seed=seed, **kw)
    return (jr, jm), (tr, tm)


def test_router_canary_shadow_draws_match_jax_on_the_same_seed():
    """Two seeded draws per dispatch (route, then shadow), in the JAX
    router's order: the same batches go canary and the same live ones are
    shadowed, never a canary one; the comparisons land alike."""
    x = np.zeros((3, 28, 28, 1), np.uint8)
    seqs, shadows = [], []
    for router, metrics in _routers(seed=11):
        router.set_live(_StubEngine(1), "live")
        router.set_canary(_StubEngine(2), "cand", 0.3)
        router.set_shadow(_StubEngine(1), "shadow", 0.5)
        seq = []
        for _ in range(200):
            rh = router.dispatch(x)
            seq.append((rh.version, rh.canary, rh.shadow_version))
            router.fetch(rh)
        router.drain_shadow()
        seqs.append(seq)
        shadows.append(metrics.snapshot()["shadow"])
        assert router.versions_in_route() == {"live", "cand", "shadow"}
    assert seqs[0] == seqs[1]
    assert shadows[0] == shadows[1]
    seq = seqs[1]
    canary = [s for s in seq if s[1]]
    shadowed = [s for s in seq if s[2] is not None]
    assert 30 < len(canary) < 90 and 50 < len(shadowed) < 150
    assert all(v == "cand" and sh is None for v, _, sh in canary)
    assert all(v == "live" for v, _, _ in shadowed)
    pair = shadows[1]["live->shadow"]
    assert pair["batches"] == len(shadowed) and pair["agreement"] == 1.0


def test_router_routes_table_and_live_promote_clears_candidate_roles():
    for router, _ in _routers(seed=0):
        router.set_live(_StubEngine(1), "a")
        router.set_canary(_StubEngine(2), "b", 0.25)
        router.set_shadow(_StubEngine(3), "c", 1.0)
        routes = router.routes()
        assert routes["canary"] == {"version": "b", "fraction": 0.25}
        assert routes["shadow"] == {"version": "c", "fraction": 1.0}
        for bad in (0.0, 1.0, 1.5):
            with pytest.raises(ValueError, match="canary fraction"):
                router.set_canary(_StubEngine(2), "b", bad)
        with pytest.raises(ValueError, match="shadow fraction"):
            router.set_shadow(_StubEngine(3), "c", 0.0)
        router.set_live(_StubEngine(2), "b")    # the canary goes live
        assert router.routes()["canary"] is None
        assert router.versions_in_route() == {"b", "c"}
        router.clear_candidates()
        assert router.versions_in_route() == {"b"}


def test_router_shadow_cap_drops_and_counts_like_jax():
    """Past the outstanding-duplicate cap a sampled batch skips its
    duplicate, counted as dropped; live results never wait on it."""
    x = np.zeros((2, 28, 28, 1), np.uint8)
    got = []
    for router, metrics in _routers(seed=3, shadow_cap=2):
        gate = threading.Event()
        router.set_live(_StubEngine(4), "live")
        router.set_shadow(_StubEngine(4, gate=gate), "slow", 1.0)
        handles = [router.dispatch(x) for _ in range(5)]
        outs = [router.fetch(rh) for rh in handles]   # not held up
        assert all(o[0, 4] == 5.0 for o in outs)
        pending = router.shadow_pending()
        snap = metrics.snapshot()
        gate.set()
        router.drain_shadow()
        after = metrics.snapshot()
        got.append((pending, snap["shadow_dropped"],
                    [rh.shadow_version for rh in handles],
                    after["shadow"], after["shadow_dropped"]))
    assert got[0] == got[1]
    pending, dropped, tags, _, _ = got[1]
    assert pending == 2 and dropped == 3
    assert tags == ["slow", "slow", None, None, None]


def test_router_shadow_accounting_under_concurrent_dispatch():
    """8 threads dispatch and fetch at once, with a short switch interval,
    through a shadow route at fraction 1.0 and a cap of 4: every duplicate
    is either compared or counted as dropped, and none stays pending."""
    x = np.zeros((1, 28, 28, 1), np.uint8)
    metrics = ServeMetrics()
    router = trouter.Router(8, (1, 2, 4, 8), "cpu", metrics=metrics,
                            seed=1, shadow_cap=4)
    router.set_live(_StubEngine(2), "live")
    router.set_shadow(_StubEngine(2), "shadow", 1.0)

    def work():
        for _ in range(100):
            router.fetch(router.dispatch(x))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    router.drain_shadow()
    snap = metrics.snapshot()
    compared = snap["shadow"].get("live->shadow", {}).get("batches", 0)
    assert compared + snap["shadow_dropped"] == 800
    assert snap["shadow_errors"] == 0 and router.shadow_pending() == 0


@pytest.mark.parametrize("failure", ["dispatch", "fetch", "live_fetch"])
def test_router_shadow_errors_are_swallowed_and_counted(failure):
    """A broken candidate never breaks live traffic: its failures count as
    shadow errors, like the JAX router's; a live fetch error still drains
    the duplicate."""
    x = np.zeros((1, 28, 28, 1), np.uint8)
    got = []
    for router, metrics in _routers(seed=5):
        router.set_live(_StubEngine(6, fail_fetch=failure == "live_fetch"),
                        "live")
        router.set_shadow(_StubEngine(
            6, fail_dispatch=failure == "dispatch",
            fail_fetch=failure == "fetch"), "bad", 1.0)
        rh = router.dispatch(x)
        if failure == "live_fetch":
            with pytest.raises(RuntimeError, match="injected"):
                router.fetch(rh)
        else:
            assert router.fetch(rh)[0, 6] == 7.0
        router.drain_shadow()
        snap = metrics.snapshot()
        got.append((snap["shadow_errors"], snap["shadow"],
                    router.shadow_pending()))
    assert got[0] == got[1]
    assert got[1][0] == (0 if failure == "live_fetch" else 1)
    assert got[1][1] == {} and got[1][2] == 0


@pytest.fixture(scope="module")
def jax_factory():
    mesh = make_mesh(jax.devices()[:1])
    return jregistry.EngineFactory(jmodels.build("mlp", platform="cpu"),
                                   mesh, max_batch=4)


def _count_builds(monkeypatch, factory):
    calls = [0]
    make = factory.make_engine

    def counted(*a, **kw):
        calls[0] += 1
        return make(*a, **kw)

    monkeypatch.setattr(factory, "make_engine", counted)
    return calls


def _registries(jax_factory, max_versions):
    jr = jregistry.ModelRegistry(jax_factory, jax_factory.make_router(),
                                 max_versions=max_versions)
    tfactory = tregistry.EngineFactory("mlp", device="cpu", max_batch=4)
    tr = tregistry.ModelRegistry(tfactory, tfactory.make_router(),
                                 max_versions=max_versions)
    return (jr, jax_factory), (tr, tfactory)


def test_registry_full_refused_before_any_warmup_like_jax(jax_factory,
                                                          monkeypatch):
    """With every resident version holding a route, add() refuses before
    building an engine, with the JAX registry's message, and nothing
    resident vanishes."""
    outcomes = []
    for registry, factory in _registries(jax_factory, max_versions=2):
        registry.promote(registry.add(factory.init_params(0),
                                      version="v1").version)
        registry.add(factory.init_params(1), version="v2")
        registry.set_shadow("v2", fraction=0.5)
        builds = _count_builds(monkeypatch, factory)
        with pytest.raises(RuntimeError, match="registry full") as ei:
            registry.add(factory.init_params(2), version="v3")
        names = sorted(v["version"] for v in
                       registry.describe()["versions"])
        outcomes.append((str(ei.value), builds[0], names,
                         registry.describe()["routes"]["shadow"]))
        # a cleared candidate frees its slot: the next add evicts it
        registry.clear_candidates()
        registry.add(factory.init_params(2), version="v3")
        outcomes.append(sorted(v["version"] for v in
                               registry.describe()["versions"]))
    assert outcomes[:2] == outcomes[2:]
    assert outcomes[2][1] == 0 and outcomes[2][2] == ["v1", "v2"]
    assert outcomes[3] == ["v1", "v3"]


def test_registry_eviction_protects_routed_versions_like_jax(jax_factory):
    """Past max_versions the oldest routeless version goes; live, canary
    and shadow versions stay, as in the JAX registry. Only a ready,
    non-live version may take a candidate route."""
    seen = []
    for registry, factory in _registries(jax_factory, max_versions=3):
        registry.promote(registry.add(factory.init_params(0),
                                      version="v1").version)
        registry.add(factory.init_params(1), version="v2")
        registry.add(factory.init_params(2), version="v3")
        registry.set_canary("v3", fraction=0.5)
        registry.add(factory.init_params(3), version="v4")  # evicts v2
        registry.set_shadow("v4", fraction=0.5)
        with pytest.raises(RuntimeError, match="non-live"):
            registry.set_canary("v1", fraction=0.5)
        with pytest.raises(KeyError):
            registry.set_shadow("v2", fraction=0.5)
        with pytest.raises(RuntimeError, match="registry full"):
            registry.add(factory.init_params(4), version="v5")
        desc = registry.describe()
        seen.append(([v["version"] for v in desc["versions"]],
                     {k: desc["routes"][k]
                      for k in ("live", "canary", "shadow")}))
    assert seen[0] == seen[1]
    assert seen[1][0] == ["v1", "v3", "v4"]


# -- (c) the batcher's deadline shed and the metrics' blocks ----------------


class _GatedEngine(_StubEngine):
    """A stub whose first fetch waits on a gate, holding the in-flight
    window of 1."""

    def __init__(self, gate):
        super().__init__(0)
        self._gate = gate

    def fetch(self, h):
        if self.dispatches == 1:
            assert self._gate.wait(30)
        return super().fetch(h)

    _as_images = staticmethod(trouter.Router._as_images)


def test_batcher_refuses_an_expired_deadline_at_submit():
    metrics = ServeMetrics()
    engine = _GatedEngine(threading.Event())
    b = DynamicBatcher(engine, max_wait_us=0, max_inflight=1,
                       metrics=metrics).start()
    try:
        with pytest.raises(DeadlineExceeded, match="at submit"):
            b.submit(np.zeros((2, 784), np.uint8),
                     deadline_s=time.monotonic() - 0.01)
        assert b.pending_rows() == 0
    finally:
        b.stop()
    assert engine.dispatches == 0
    assert DeadlineExceeded.status == 504
    res = metrics.snapshot()["resilience"]
    assert (res["deadline_shed_requests"], res["deadline_shed_rows"]) \
        == (1, 2)


def test_batcher_sheds_a_request_that_expires_while_queued():
    """The window is held by a first batch; a second request's deadline
    passes in the queue: it is shed at pop with zero dispatches, and a
    third request with no deadline is served."""
    metrics = ServeMetrics()
    gate = threading.Event()
    engine = _GatedEngine(gate)
    b = DynamicBatcher(engine, max_wait_us=0, max_inflight=1,
                       adaptive=False, metrics=metrics).start()
    try:
        first = b.submit(np.zeros((1, 784), np.uint8))
        while engine.dispatches == 0:
            time.sleep(0.001)
        doomed = b.submit(np.zeros((3, 784), np.uint8),
                          deadline_s=time.monotonic() + 0.05)
        time.sleep(0.1)                  # past the deadline, still queued
        gate.set()
        assert first.result(10).shape == (1, 10)
        with pytest.raises(DeadlineExceeded, match="while queued"):
            doomed.result(10)
        assert b.submit(np.zeros((1, 784), np.uint8)).result(10).shape \
            == (1, 10)
    finally:
        b.stop()
    assert engine.dispatches == 2        # the first and the third
    res = metrics.snapshot()["resilience"]
    assert (res["deadline_shed_requests"], res["deadline_shed_rows"]) \
        == (1, 3)


def test_batcher_submit_deadline_matches_jax_batcher():
    """The JAX batcher on the same expired request: the same exception
    type name and the same counter keys and values."""
    from distributedmnist_tpu.serve.resilience import \
        DeadlineExceeded as JDeadline

    got = []
    for batcher_cls, metrics, exc in (
            (JDynamicBatcher, jmetrics_mod.ServeMetrics(), JDeadline),
            (DynamicBatcher, ServeMetrics(), DeadlineExceeded)):
        b = batcher_cls(_GatedEngine(threading.Event()), max_wait_us=0,
                        max_inflight=1, metrics=metrics).start()
        try:
            with pytest.raises(exc, match="already expired at submit"):
                b.submit(np.zeros((1, 784), np.uint8),
                         deadline_s=time.monotonic() - 1)
        finally:
            b.stop()
        res = metrics.snapshot()["resilience"]
        got.append({k: res[k] for k in ("deadline_shed_requests",
                                        "deadline_shed_rows")})
    assert got[0] == got[1] == {"deadline_shed_requests": 1,
                                "deadline_shed_rows": 1}
    assert exc.status == JDeadline.status


def test_metrics_blocks_and_heartbeat_match_jax():
    """The same recording calls give the same shadow block, per-version
    populations (canary apart from live), resilience counters (those the
    port has) and heartbeat record shape."""
    snaps = []
    for m in (jmetrics_mod.ServeMetrics(), ServeMetrics()):
        m.record_shadow("v1", "v2", rows=4, agree_rows=3,
                        max_abs_diff=0.1234567)
        m.record_shadow("v1", "v2", rows=2, agree_rows=2, max_abs_diff=0.05)
        m.record_shadow_error()
        m.record_shadow_drop()
        m.record_shadow_drop()
        m.record_deadline_shed(5)
        m.record_latency(0.002, rows=2, version="v1")
        m.record_latency(0.004, rows=1, version="v2")
        m.record_batch(rows=2, bucket=2, queue_depth=0, version="v1")
        m.record_batch(rows=1, bucket=1, queue_depth=0, version="v2")
        rec = m.record()
        assert rec["metric"] == "serve_stats"
        assert json.loads(m.heartbeat_line())["metric"] == "serve_stats"
        snaps.append(rec)
    j, t = snaps
    for k in ("shadow", "shadow_errors", "shadow_dropped", "by_version"):
        assert t[k] == j[k], k
    assert set(t["resilience"]) <= set(j["resilience"])
    for k, v in t["resilience"].items():
        assert v == j["resilience"][k], k
    assert set(j) - set(t) == set(UNPORTED_METRICS_KEYS)
    assert set(t) - set(j) == set()


# -- the server in-process ---------------------------------------------------


def _request(url, data=None, headers=None, method=None, timeout=30):
    """(status, json body, headers) of one request, errors included."""
    req = urllib.request.Request(url, data=data, headers=headers or {},
                                 method=method)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


def _post(url, payload, timeout=120):
    return _request(url, data=json.dumps(payload).encode(),
                    headers={"Content-Type": "application/json"},
                    method="POST", timeout=timeout)


class _InProcess:
    """The port's HTTPServer on the CPU in this process, its serve() on a
    thread; it warms as the serve CLI does unless the caller passes a
    warm."""

    def __init__(self, warm=None, **cfg):
        self.cfg = tconfig.Config(model="mlp", device="cpu",
                                  serve_max_batch=8, **cfg)
        self.metrics = ServeMetrics()
        self.registry, self.router, self.factory = build_serving(
            self.cfg, metrics=self.metrics)
        # wired as the serve CLI wires it
        if self.cfg.serve_trace:
            ttrace.install(ttrace.Tracer(
                capacity=self.cfg.serve_trace_capacity,
                sample=self.cfg.serve_trace_sample, seed=self.cfg.seed))
        self.batcher = DynamicBatcher(
            self.router, max_batch=8, metrics=self.metrics,
            resilience=build_resilience(self.cfg, registry=self.registry,
                                        metrics=self.metrics),
            dedup=self.cfg.serve_dedup,
            fastlane=self.cfg.serve_fastlane).start()
        self.front, self.cache = build_cache_front(
            self.cfg, self.batcher, self.router, self.registry,
            metrics=self.metrics)
        self.state = tserver.ServerState()
        self.server = tserver.HTTPServer(
            self.batcher, self.metrics, self.registry, self.state,
            request_timeout=30,
            infer_dtype_choice=self.cfg.serve_infer_dtype,
            front=self.front, cache=self.cache)
        self.base = f"http://127.0.0.1:{self.server.port}"
        warm = warm or (lambda: serve_cli.warm(self.registry, self.cfg))
        self.summary = None
        self.thread = threading.Thread(
            target=self._run, args=(warm,), daemon=True)
        self.thread.start()

    def _run(self, warm):
        self.summary = self.server.serve(warm, metrics_every=60)

    def wait_healthy(self, timeout=60):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            code, body, _ = _request(f"{self.base}/healthz")
            if code == 200:
                return body
            time.sleep(0.02)
        pytest.fail(f"never healthy: {body}")

    def predict(self, x, headers=None):
        return _request(f"{self.base}/predict",
                        data=np.ascontiguousarray(x, np.uint8).tobytes(),
                        headers=headers, method="POST")

    def close(self):
        self.server.shutdown()
        self.thread.join(30)
        self.batcher.stop()
        if self.cfg.serve_trace:
            ttrace.uninstall()
        assert not self.thread.is_alive()


@pytest.fixture(scope="module")
def inproc():
    srv = _InProcess()
    srv.wait_healthy()
    yield srv
    srv.close()


@pytest.mark.parametrize("method,path,code", [
    ("GET", "/trace", 409), ("GET", "/tenants", 409),
    ("POST", "/tenants/gold/quota", 409), ("POST", "/tenants/gold", 404),
    ("POST", "/replicas/r0/drain", 409), ("POST", "/replicas/r0", 404),
    ("POST", "/cluster/epoch", 501), ("GET", "/nope", 404),
    ("POST", "/nope", 404)])
def test_server_routes_of_unported_layers(inproc, method, path, code):
    """Refused layers answer as the JAX server does on this
    configuration; the unported ones 501, naming the ROADMAP item."""
    got, body, _ = _request(f"{inproc.base}{path}", method=method,
                            data=b"{}" if method == "POST" else None)
    assert got == code, body
    if code == 501:
        assert "ROADMAP" in body["error"]


@pytest.mark.parametrize("path", ["/predict", "/models/load"])
@pytest.mark.parametrize("length", ["-784", "lots"])
def test_server_bad_content_length_is_400(inproc, path, length):
    """A Content-Length that is not a non-negative integer is a 400 at
    once: a negative one must not read until the client hangs up, nor a
    non-number leave the client without an answer."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", inproc.server.port,
                                      timeout=30)
    try:
        conn.putrequest("POST", path)
        conn.putheader("Content-Length", length)
        conn.endheaders()
        r = conn.getresponse()
        body = json.loads(r.read())
    finally:
        conn.close()
    assert r.status == 400, body
    assert "Content-Length" in body["error"]


def _text(url, headers=None):
    req = urllib.request.Request(url, headers=headers or {})
    with urllib.request.urlopen(req, timeout=30) as r:
        return r.status, r.read().decode(), dict(r.headers)


@pytest.mark.parametrize("how", ["query", "accept"])
def test_server_prometheus_exposition(inproc, how):
    """?format=prometheus, or a text/plain Accept without JSON: 200 with
    the exposition, every family with # HELP and # TYPE; a JSON Accept
    keeps the JSON."""
    inproc.predict(_images(2))
    url, hdrs = ((f"{inproc.base}/metrics?format=prometheus", None)
                 if how == "query" else
                 (f"{inproc.base}/metrics", {"Accept": "text/plain"}))
    code, text, h = _text(url, hdrs)
    assert code == 200 and h["Content-Type"].startswith("text/plain")
    helps = set(re.findall(r"^# HELP (\S+) ", text, re.M))
    types = set(re.findall(r"^# TYPE (\S+) ", text, re.M))
    assert helps == types and "dmnist_serve_requests_total" in helps
    assert "dmnist_serve_pending_rows" in helps
    code, body, _ = _request(f"{inproc.base}/metrics", headers={
        "Accept": "text/plain, application/json"})
    assert code == 200 and body["metric"] == "serve_stats"


@pytest.fixture
def inproc_layers():
    """The in-process server with the request path's layers on: the
    cache, dedup, the fast lane and the tracer."""
    srv = _InProcess(serve_cache=True, serve_dedup=True,
                     serve_fastlane=True, serve_trace=True)
    srv.wait_healthy()
    yield srv
    srv.close()


def test_server_request_path_layers(inproc_layers):
    """X-Trace-Id on every /predict, Server-Timing when asked, GET /trace
    as Chrome trace events, a repeat served from the cache (version-
    tagged, metered), and the exposition's cache, fast-lane and stage
    families."""
    srv = inproc_layers
    x = _images(1, seed=11)
    code, body, hdrs = srv.predict(x)
    assert code == 200 and "X-Trace-Id" in hdrs
    assert "Server-Timing" not in hdrs
    code, again, hdrs = srv.predict(x, headers={"X-Server-Timing": "1"})
    assert code == 200 and again == body
    assert re.fullmatch(r"(\w+(\.\w+)?;dur=\d+\.\d{3}, )*"
                        r"residue;dur=\d+\.\d{3}", hdrs["Server-Timing"])
    code, trace, _ = _request(f"{srv.base}/trace")
    assert code == 200 and trace["displayTimeUnit"] == "ms"
    assert {e["name"] for e in trace["traceEvents"]} >= {"cache.hit",
                                                         "fastpath"}
    _, m, _ = _request(f"{srv.base}/metrics")
    assert m["cache"]["hits"] == 1 and m["cache_served"]["hit_requests"] == 1
    assert m["fastpath"]["dispatches"] == 1
    assert m["by_version"][body["version"]]["requests"] == 2
    _, text, _ = _text(f"{srv.base}/metrics?format=prometheus")
    for fam in ("dmnist_serve_cache_hits_total",
                "dmnist_serve_fastpath_dispatches_total",
                "dmnist_serve_stage_duration_ms"):
        assert f"# HELP {fam} " in text and f"# TYPE {fam} " in text


def test_server_deadline_shed_is_504_with_retry_after(inproc):
    """A budget that has passed at submit sheds with 504, an integer
    Retry-After and zero device work, counted in /metrics."""
    before = inproc.metrics.snapshot()["batches"]
    code, body, hdrs = inproc.predict(_images(2),
                                      headers={"X-Deadline-Ms": "0.0001"})
    assert code == 504 and "deadline" in body["error"]
    assert int(hdrs["Retry-After"]) >= 1
    _, m, _ = _request(f"{inproc.base}/metrics")
    assert m["resilience"]["deadline_shed_requests"] >= 1
    assert m["batches"] == before
    code, body, _ = inproc.predict(_images(2),
                                   headers={"X-Deadline-Ms": "5000"})
    assert code == 200 and body["n"] == 2


def test_server_metrics_payload_shape(inproc_layers):
    inproc = inproc_layers
    code, body, _ = inproc.predict(_images(3))
    assert code == 200
    _, m, _ = _request(f"{inproc.base}/metrics")
    assert m["metric"] == "serve_stats" and m["requests"] >= 1
    assert m["queue"]["max_inflight"] == inproc.batcher.max_inflight
    assert m["adaptive"]["aimd_wait_us"] > 0
    # the blocks of layers off on this server (one replica, one model)
    for k in ("fleet", "tenancy"):
        assert m[k] is None, k
    assert m["cache"]["misses"] >= 1 and m["cache"]["capacity"] == 4096
    assert m["resilience_policy"]["bisect"] is True
    assert m["resilience_policy"]["breaker"]["min_requests"] == 20
    assert m["trace"]["requests_finished"] >= 1
    assert m["compiles_total"] == (kernel_lib.load_events()
                                   + inproc.factory.engine_builds) >= 1


def test_server_keepalive_requests_are_not_held_by_nagle(inproc):
    """Requests on one keep-alive connection: with Nagle on, each response's
    body waits for the client's delayed ACK of its headers (about 40 ms a
    request, measured on the CPU); the server sets TCP_NODELAY."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", inproc.server.port,
                                      timeout=30)
    lat = []
    try:
        for i in range(21):
            t0 = time.perf_counter()
            if i % 2:
                conn.request("GET", "/healthz")
            else:
                conn.request("POST", "/predict",
                             body=_images(1).tobytes())
            r = conn.getresponse()
            r.read()
            assert r.status == 200
            lat.append(time.perf_counter() - t0)
    finally:
        conn.close()
    assert float(np.median(lat)) < 0.02, lat


def test_server_warming_then_failed_warm_then_admin_recovery():
    """503 + Retry-After while warming; a warm that raises leaves the
    server up at 503 "failed"; an admin load and promote recovers it."""
    release = threading.Event()

    def warm():
        assert release.wait(30)
        raise RuntimeError("injected boot failure")

    srv = _InProcess(warm=warm)
    try:
        code, body, _ = _request(f"{srv.base}/healthz")
        assert code == 503 and body["state"] == "warming"
        code, body, hdrs = srv.predict(_images(1))
        assert code == 503 and int(hdrs["Retry-After"]) >= 1
        release.set()
        deadline = time.monotonic() + 30
        while _request(f"{srv.base}/healthz")[1]["state"] != "failed":
            assert time.monotonic() < deadline
            time.sleep(0.02)
        code, body, _ = _post(f"{srv.base}/models/load",
                              {"fresh": {"seed": 3, "version": "fix"}})
        assert code == 200 and body["state"] == "ready"
        assert _post(f"{srv.base}/models/promote",
                     {"version": "fix"})[0] == 200
        health = srv.wait_healthy()
        assert health["live_version"] == "fix"
        code, body, _ = srv.predict(_images(2))
        assert code == 200 and body["version"] == "fix"
    finally:
        srv.close()
    assert srv.summary["metric"] == "serve_summary"
    assert srv.summary["live_version"] == "fix"


@pytest.mark.parametrize("gate", ["passes", "refuses"])
def test_server_reload_promotes_latest_and_reactivates_variant(
        tmp_path, monkeypatch, gate):
    """SIGHUP's reload: load the latest checkpoint, promote it, then
    re-activate the configured precision; a gate refusal leaves the new
    version's float32 engine live."""
    monkeypatch.setitem(tregistry.PARITY_GATES, "megakernel",
                        (0.0, math.inf) if gate == "passes"
                        else (1.01, 0.0))
    ck = tmp_path / "ck"
    _save_port_checkpoint(ck, 5, seed=1)
    srv = _InProcess(serve_infer_dtype="megakernel",
                     checkpoint_dir=str(ck))
    try:
        srv.wait_healthy()
        _save_port_checkpoint(ck, 9, seed=2)
        srv.server.reload().join(60)
        desc = srv.registry.describe()
        assert desc["routes"]["live"] == "step-9"
        want = "megakernel" if gate == "passes" else "float32"
        assert desc["live_infer_dtype"] == want
        variant = srv.registry.get("step-9").variants["megakernel"]
        assert variant.state == ("ready" if gate == "passes" else "failed")
        code, body, _ = srv.predict(_images(4))
        assert code == 200 and body["version"] == "step-9"
    finally:
        srv.close()


def _break_variant_kernel(m, srv, failure):
    """Make every megakernel variant fail from now on: its engine does not
    build ("build"), or its kernel raises at launch ("launch")."""
    if failure == "build":
        make = srv.factory.make_engine

        def broken_build(params, version, infer_dtype="float32",
                         replica=0):
            if infer_dtype != "float32":
                raise RuntimeError("injected: the kernel did not build")
            return make(params, version, infer_dtype=infer_dtype,
                        replica=replica)

        m.setattr(srv.factory, "make_engine", broken_build)
    else:
        def broken_launch(*args, **kwargs):
            raise RuntimeError("injected: the kernel did not launch")

        m.setattr(tfused, "mlp_megakernel", broken_launch)


@pytest.mark.parametrize("failure", ["build", "launch"])
def test_server_reload_keeps_the_live_version_when_a_variant_kernel_fails(
        tmp_path, monkeypatch, failure):
    """A variant kernel that fails on SIGHUP's new version is an error,
    not a gate refusal: nothing is promoted, and the version that was live
    stays live at its precision (never the new one at float32)."""
    monkeypatch.setitem(tregistry.PARITY_GATES, "megakernel",
                        (0.0, math.inf))
    ck = tmp_path / "ck"
    _save_port_checkpoint(ck, 5, seed=1)
    srv = _InProcess(serve_infer_dtype="megakernel", checkpoint_dir=str(ck))
    try:
        health = srv.wait_healthy()
        assert (health["live_version"], health["live_infer_dtype"]) \
            == ("step-5", "megakernel")
        _save_port_checkpoint(ck, 9, seed=2)
        with monkeypatch.context() as m:
            _break_variant_kernel(m, srv, failure)
            srv.server.reload().join(60)
        desc = srv.registry.describe()
        assert desc["routes"]["live"] == "step-5"
        assert desc["live_infer_dtype"] == "megakernel"
        new = srv.registry.get("step-9")
        assert new.state == "ready"
        assert new.variants["megakernel"].state == "failed"
        assert "injected" in new.variants["megakernel"].last_error
        code, body, _ = srv.predict(_images(4))
        assert code == 200 and body["version"] == "step-5"
    finally:
        srv.close()


@pytest.mark.parametrize("failure", ["build", "launch"])
def test_server_boot_with_a_failing_variant_kernel_is_failed(monkeypatch,
                                                             failure):
    """At boot the same failure leaves nothing live: /healthz 503
    "failed", never float32 served in the variant's place."""
    monkeypatch.setitem(tregistry.PARITY_GATES, "megakernel",
                        (0.0, math.inf))
    gate = threading.Event()
    srv = _InProcess(serve_infer_dtype="megakernel",
                     warm=lambda: (gate.wait(30),
                                   serve_cli.warm(srv.registry, srv.cfg)))
    try:
        _break_variant_kernel(monkeypatch, srv, failure)
        gate.set()
        deadline = time.monotonic() + 60
        while True:
            code, body, _ = _request(f"{srv.base}/healthz")
            if body["state"] != "warming":
                break
            assert time.monotonic() < deadline
            time.sleep(0.02)
        assert code == 503 and body["state"] == "failed"
        assert body["live_version"] is None
        assert srv.predict(_images(1))[0] == 503
    finally:
        srv.close()


@pytest.mark.parametrize("argv,msg", [
    (["--port", "0", "--selftest", "4"], "mutually exclusive"),
    (["--port", "0", "--request-timeout", "0"], "request-timeout"),
    (["--port", "0", "--serve-retry-after-cap-s", "0.5"],
     "retry-after-cap"),
    (["--serve-faults", "engine.fetch:p=2"], "--serve-faults"),
    (["--serve-cache-capacity", "0"], "serve-cache-capacity"),
    (["--serve-cache-ttl-s", "0"], "serve-cache-ttl-s"),
    (["--serve-trace-sample", "1.5"], "serve-trace-sample"),
    (["--serve-trace-capacity", "0"], "serve-trace-capacity"),
    (["--serve-breaker-ratio", "0"], "serve-breaker-ratio"),
    (["--serve-breaker-window-s", "0"], "serve-breaker-window-s"),
    (["--serve-breaker-min-requests", "0"], "serve-breaker-min-requests"),
    (["--serve-replicas", "0"], "--serve-replicas must be >= 1"),
    (["--serve-replica-inflight", "0"],
     "--serve-replica-inflight must be >= 1"),
    (["--serve-cascade-threshold", "0.5"],
     "--serve-cascade-threshold requires --serve-cascade"),
    (["--serve-cascade", "--serve-cascade-threshold", "nan"],
     "--serve-cascade-threshold must be in [0, 1]"),
])
def test_server_cli_usage_errors(capsys, argv, msg):
    with pytest.raises(SystemExit) as ei:
        serve_cli.main(["--device", "cpu", "--model", "mlp"] + argv)
    assert ei.value.code == 2
    assert msg in capsys.readouterr().err


def test_server_cli_defaults_match_jax_serve():
    """--metrics-every and --request-timeout take the root serve.py's
    defaults (serve.py:1182-1184), the Retry-After cap the JAX config's."""
    from distributedmnist_tpu import config as jconfig

    args = serve_cli.parser().parse_args(["--port", "0"])
    assert (args.port, args.metrics_every, args.request_timeout) \
        == (0, 10.0, 60.0)
    assert tconfig.Config().serve_retry_after_cap_s \
        == jconfig.Config().serve_retry_after_cap_s == 30.0


# -- (d, e) subprocess servers -----------------------------------------------


def _port_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    return env


def _start_port_server(extra=()):
    return ServerProcess([sys.executable, "-m",
                          "distributedmnist_tpu_torch.serve", "--model",
                          "mlp", "--device", "cpu", "--serve-max-batch",
                          str(MAX_BATCH), "--port", "0", "--metrics-every",
                          "0.5", *extra], env=_port_env(), cwd=REPO)


def _wait_healthy(base, timeout=120):
    deadline = time.monotonic() + timeout
    last = None
    while time.monotonic() < deadline:
        code, last, _ = _request(f"{base}/healthz")
        if code == 200:
            return last
        assert code == 503 and last["ok"] is False
        time.sleep(0.1)
    pytest.fail(f"/healthz never became healthy: {last}")


def _save_port_checkpoint(directory, step, seed):
    ck = Checkpointer(str(directory))
    ck.save(step, {"params": models.init_params("mlp", seed),
                   "optimizer": {}, "scheduler": {}})
    ck.close()


def test_serve_http_end_to_end():
    """The JAX test_serve_http_end_to_end's steps on the port's server:
    ready line, /healthz 503 while warming then a real payload, a
    version-tagged /predict, the /metrics shape, 400 on a malformed
    body, SIGTERM -> rc 0, a serve_summary and the launch counts."""
    srv = _start_port_server()
    try:
        base = srv.base
        ok = _wait_healthy(base)
        assert ok["ok"] is True and ok["state"] == "running"
        assert ok["live_version"] and ok["versions"] >= 1
        assert isinstance(ok["pending_rows"], int)
        assert isinstance(ok["inflight_batches"], int)
        assert ok["backend"] == "cpu" and ok["device_kind"] == "cpu"

        code, r, _ = _request(f"{base}/predict", method="POST",
                              data=np.full((3, 784), 128,
                                           np.uint8).tobytes())
        assert code == 200 and r["n"] == 3 and len(r["classes"]) == 3
        assert all(0 <= c <= 9 for c in r["classes"])
        assert r["version"] == ok["live_version"]

        _, m, _ = _request(f"{base}/metrics")
        assert m["metric"] == "serve_stats" and m["requests"] >= 1
        assert r["version"] in m["by_version"]
        q = m["queue"]
        assert q["pending_rows"] >= 0 and q["inflight_batches"] >= 0
        assert q["max_inflight"] >= 1 and q["queue_depth_watermark"] >= 1
        assert m["adaptive"]["aimd_wait_us"] > 0
        assert m["padding_waste_ratio"] is not None
        assert m["bucket_dispatches"]
        assert m["effective_wait_us"]["last"] is not None

        code, _, _ = _request(f"{base}/predict", data=b"not-784",
                              method="POST")
        assert code == 400
        # a serve_stats heartbeat line every --metrics-every (0.5 s)
        deadline = time.monotonic() + 10
        while not any('"serve_stats"' in ln for ln in srv.lines):
            assert time.monotonic() < deadline, "no heartbeat line"
            time.sleep(0.05)
    finally:
        done = srv.stop()
    assert done.rc == 0, done.stderr
    assert any(r.get("metric") == "serve_stats" for r in done.records)
    summary = [r for r in done.records
               if r.get("metric") == "serve_summary"]
    assert summary and summary[-1]["requests"] >= 1
    assert done.launches == [{"dense_relu": 0, "quant_dense": 0,
                              "mlp_megakernel": 0}]   # plain versions here


def test_serve_admin_model_lifecycle(tmp_path):
    """The JAX test_serve_admin_model_lifecycle's steps on port
    checkpoints: boot fresh-init, load and promote a committed step,
    404/400 on bad promotes, SIGHUP to a later step, the demoted step as
    a 0.25 canary (both populations in /metrics by_version), then a fresh
    version as a shadow (its comparison block in /metrics)."""
    ck = tmp_path / "ck"
    srv = _start_port_server(["--checkpoint-dir", str(ck)])
    try:
        base = srv.base
        boot = _wait_healthy(base)["live_version"]
        _, view, _ = _request(f"{base}/models")
        assert view["routes"]["live"] == boot
        assert [v["version"] for v in view["versions"]] == [boot]
        assert view["versions"][0]["source"] == "fresh-init"
        assert view["versions"][0]["bucket_cost_ms"]

        _save_port_checkpoint(ck, 5, seed=3)
        code, loaded, _ = _post(f"{base}/models/load", {})
        assert code == 200 and loaded["version"] == "step-5"
        assert loaded["state"] == "ready"
        assert _request(f"{base}/models")[1]["routes"]["live"] == boot
        code, promoted, _ = _post(f"{base}/models/promote",
                                  {"version": "step-5"})
        assert code == 200 and promoted["live"] == "step-5"
        body = np.full((2, 784), 7, np.uint8).tobytes()
        code, r, _ = _request(f"{base}/predict", data=body, method="POST")
        assert r["version"] == "step-5"

        assert _post(f"{base}/models/promote",
                     {"version": "nope"})[0] == 404
        for bad in ("lots", None):
            code, _, _ = _post(f"{base}/models/promote",
                               {"version": boot, "mode": "canary",
                                "fraction": bad})
            assert code == 400, bad

        _save_port_checkpoint(ck, 9, seed=4)
        srv.proc.send_signal(signal.SIGHUP)
        deadline = time.monotonic() + 120
        while _request(f"{base}/models")[1]["routes"]["live"] != "step-9":
            assert time.monotonic() < deadline, "SIGHUP never promoted"
            time.sleep(0.2)

        code, canary, _ = _post(f"{base}/models/promote",
                                {"version": "step-5", "mode": "canary",
                                 "fraction": 0.25})
        assert code == 200
        assert canary["canary"] == {"version": "step-5", "fraction": 0.25}
        assert _request(f"{base}/healthz")[1]["live_version"] == "step-9"
        versions = set()
        for _ in range(40):
            code, r, _ = _request(f"{base}/predict", data=body,
                                  method="POST")
            assert code == 200
            versions.add(r["version"])
        assert versions == {"step-9", "step-5"}
        _, m, _ = _request(f"{base}/metrics")
        by_v = m["by_version"]
        assert by_v["step-5"]["requests"] + by_v["step-9"]["requests"] >= 40

        code, fresh, _ = _post(f"{base}/models/load", {"fresh": {"seed": 1}})
        assert code == 200 and fresh["source"] == "fresh-init"
        code, sh, _ = _post(f"{base}/models/promote",
                            {"version": fresh["version"], "mode": "shadow",
                             "fraction": 1.0})
        assert code == 200 and sh["shadow"]["version"] == fresh["version"]
        for _ in range(20):
            _request(f"{base}/predict", data=body, method="POST")
        deadline = time.monotonic() + 30
        pair = f"step-9->{fresh['version']}"
        while pair not in _request(f"{base}/metrics")[1]["shadow"]:
            assert time.monotonic() < deadline, "no shadow comparisons"
            time.sleep(0.1)
        assert _request(f"{base}/metrics")[1]["shadow"][pair]["rows"] >= 2
    finally:
        done = srv.stop()
    assert done.rc == 0, done.stderr
    assert [r for r in done.records if r.get("metric") == "serve_summary"]


def _save_jax_mlp_checkpoint(ckpt_dir, step, seed):
    """A JAX full-train-state checkpoint (the JAX admin test's helper);
    returns its params as numpy."""
    from distributedmnist_tpu import optim
    from distributedmnist_tpu.checkpoint import Checkpointer as JCkpt
    from distributedmnist_tpu.parallel import replicated
    from distributedmnist_tpu.trainer import init_state

    mesh = make_mesh(jax.devices()[:8])
    model = jmodels.build("mlp", fused="xla")
    state = init_state(jax.random.PRNGKey(seed), model,
                       optim.build("adam", 1e-3),
                       jnp.zeros((1, 28, 28, 1)))
    state = state.replace(step=jnp.asarray(step, jnp.int32))
    state = jax.device_put(state, replicated(mesh))
    ck = JCkpt(str(ckpt_dir), async_save=False)
    ck.save(step, state)
    ck.wait()
    ck.close()
    return jax.tree.map(np.asarray, state.params)


# The request script both servers answer: (name, method, path, body,
# headers); the body of a predict is raw pixels.
def _script(max_batch):
    x3 = _images(3, seed=709).reshape(3, 784)
    big = np.zeros((max_batch + 1, 784), np.uint8)
    json_post = {"Content-Type": "application/json"}

    def promote(body):
        return ("POST", "/models/promote", json.dumps(body).encode(),
                json_post)

    return [
        ("predict 3 rows", "POST", "/predict", x3.tobytes(), {}),
        ("malformed body", "POST", "/predict", b"not-784", {}),
        ("oversize body", "POST", "/predict", big.tobytes(), {}),
        ("deadline not a number", "POST", "/predict", x3.tobytes(),
         {"X-Deadline-Ms": "soon"}),
        ("deadline nan", "POST", "/predict", x3.tobytes(),
         {"X-Deadline-Ms": "nan"}),
        ("deadline zero", "POST", "/predict", x3.tobytes(),
         {"X-Deadline-Ms": "0"}),
        ("deadline negative", "POST", "/predict", x3.tobytes(),
         {"X-Deadline-Ms": "-5"}),
        ("deadline passed", "POST", "/predict", x3.tobytes(),
         {"X-Deadline-Ms": "0.0001"}),
        ("deadline generous", "POST", "/predict", x3.tobytes(),
         {"X-Deadline-Ms": "30000"}),
        ("accuracy class known", "POST", "/predict", x3.tobytes(),
         {"X-Accuracy-Class": "exact"}),
        ("accuracy class unknown", "POST", "/predict", x3.tobytes(),
         {"X-Accuracy-Class": "bogus"}),
        ("tenant", "POST", "/predict", x3.tobytes(), {"X-Tenant": "gold"}),
        ("promote unknown version", *promote({"version": "nope"})),
        ("promote fraction not a number",
         *promote({"version": "step-5", "mode": "canary",
                   "fraction": "lots"})),
        ("promote fraction null",
         *promote({"version": "step-5", "mode": "canary",
                   "fraction": None})),
        ("promote unknown mode",
         *promote({"version": "step-5", "mode": "sideways"})),
        ("promote missing version", *promote({"mode": "live"})),
        ("promote live canary fraction 1.5",
         *promote({"version": "step-5", "mode": "canary",
                   "fraction": 1.5})),
        ("promote infer_dtype on a canary",
         *promote({"version": "step-5", "mode": "canary",
                   "infer_dtype": "int8"})),
        ("promote unknown infer_dtype",
         *promote({"version": "step-5", "infer_dtype": "fp4"})),
        ("promote unwarmed variant",
         *promote({"version": "step-5", "infer_dtype": "int8"})),
        ("promote cascade threshold", *promote({"version": "step-5",
                                                "cascade_threshold": 0.5})),
        ("promote cascade threshold bad",
         *promote({"version": "step-5", "cascade_threshold": "x"})),
        ("promote cascade unknown version",
         *promote({"version": "nope", "cascade_threshold": 0.5})),
        ("promote live", *promote({"version": "step-5"})),
        ("load from a missing dir", "POST", "/models/load",
         json.dumps({"dir": "/nonexistent/ck"}).encode(), json_post),
        ("load fresh bad seed", "POST", "/models/load",
         json.dumps({"fresh": {"seed": "x"}}).encode(), json_post),
        ("load not an object", "POST", "/models/load", b"[1, 2]",
         json_post),
        ("trace", "GET", "/trace", None, {}),
        ("tenants", "GET", "/tenants", None, {}),
        ("tenant quota", "POST", "/tenants/gold/quota", b"{}", json_post),
        ("replica drain", "POST", "/replicas/r0/drain", b"{}", json_post),
        ("unknown path", "GET", "/nope", None, {}),
        ("predict after", "POST", "/predict", x3.tobytes(), {}),
    ]


def _run_script(base, script):
    out = {}
    for name, method, path, body, headers in script:
        out[name] = _request(f"{base}{path}", data=body, headers=headers,
                             method=method)
    return out


def _conformance(tmp_path, layers=()):
    """Boot root serve.py and the port's server on the same MLP step-5
    weights (a JAX checkpoint, and the same params through interop in a
    port checkpoint), with the same extra flags, and send both the same
    request script: (answers, healthz, metrics, GET /trace, a Prometheus
    scrape) per server."""
    from conftest import worker_env

    jck, tck = tmp_path / "jck", tmp_path / "tck"
    jparams = _save_jax_mlp_checkpoint(jck, step=5, seed=3)
    ck = Checkpointer(str(tck))
    ck.save(5, {"params": interop.mlp_params_from_flax(jparams),
                "optimizer": {}, "scheduler": {}})
    ck.close()

    jenv, _ = worker_env()
    common = ["--model", "mlp", "--device", "cpu", "--serve-max-batch",
              str(MAX_BATCH), "--port", "0", "--metrics-every", "60",
              *layers]
    servers = {
        "jax": ServerProcess([sys.executable,
                              os.path.join(REPO, "serve.py"), *common,
                              "--checkpoint-dir", str(jck)], env=jenv,
                             cwd=REPO),
        "port": ServerProcess([sys.executable, "-m",
                               "distributedmnist_tpu_torch.serve", *common,
                               "--checkpoint-dir", str(tck)],
                              env=_port_env(), cwd=REPO),
    }
    answers, health, metrics, traces, prom = {}, {}, {}, {}, {}
    try:
        for name, srv in servers.items():
            health[name] = _wait_healthy(srv.base, timeout=180)
            answers[name] = _run_script(srv.base, _script(MAX_BATCH))
            metrics[name] = _request(f"{srv.base}/metrics")[1]
            traces[name] = _request(f"{srv.base}/trace")[:2]
            try:
                prom[name] = _text(
                    f"{srv.base}/metrics?format=prometheus")[:2]
            except urllib.error.HTTPError as e:
                prom[name] = (e.code, None)
    finally:
        rcs = {name: srv.stop().rc for name, srv in servers.items()}
    assert rcs == {"jax": 0, "port": 0}
    j, t = answers["jax"], answers["port"]
    codes = {name: (j[name][0], t[name][0]) for name in j}
    assert all(a == b for a, b in codes.values()), codes
    for name in ("predict 3 rows", "deadline generous", "predict after"):
        assert j[name][0] == 200
        for k in ("classes", "n", "version"):
            assert t[name][1][k] == j[name][1][k], (name, k)
        assert t[name][1]["version"] == "step-5"
    for name, (code, _, hdrs) in t.items():
        if code in (503, 504):
            assert int(hdrs["Retry-After"]) >= 1, name
    assert codes["deadline passed"] == (504, 504)
    assert codes["promote cascade threshold"] == (409, 409)
    assert codes["oversize body"] == (413, 413)

    assert set(health["port"]) == set(health["jax"])
    for k in ("ok", "state", "live_version", "live_infer_dtype",
              "backend", "device_kind", "versions"):
        assert health["port"][k] == health["jax"][k], k
    jkeys, tkeys = set(metrics["jax"]), set(metrics["port"])
    assert jkeys - tkeys == set(UNPORTED_METRICS_KEYS)
    assert tkeys - jkeys == set()
    assert set(metrics["port"]["queue"]) == set(metrics["jax"]["queue"])
    assert set(metrics["port"]["resilience"]) \
        == set(metrics["jax"]["resilience"])
    # the breaker is on by default in both servers
    assert metrics["port"]["resilience_policy"].keys() \
        == metrics["jax"]["resilience_policy"].keys()
    assert metrics["port"]["resilience_policy"]["breaker"].keys() \
        == metrics["jax"]["resilience_policy"]["breaker"].keys()
    for k in ("fleet", "tenancy"):
        assert metrics["port"][k] is metrics["jax"][k] is None, k
    return answers, metrics, traces, prom


def test_conformance_with_jax_serve_on_the_same_weights(tmp_path):
    """Root serve.py and the port's server boot the same MLP step-5
    weights and answer the same request script: equal status codes,
    classes and version; /healthz and /metrics key sets equal but for
    the keys of layers the port has not got. With the request path's
    layers off, both answer /trace 409 and their cache and trace blocks
    are None."""
    _, metrics, traces, prom = _conformance(tmp_path)
    for k in ("cache", "trace"):
        assert metrics["port"][k] is metrics["jax"][k] is None, k
    assert traces["port"][0] == traces["jax"][0] == 409
    assert prom["port"][0] == prom["jax"][0] == 200


def test_conformance_with_jax_serve_request_path_layers(tmp_path):
    """The same script with --serve-cache --serve-dedup --serve-fastlane
    --serve-trace and a fault schedule on both servers (a latency-only
    rule on the engine's fetch, so the answers stay comparable): equal
    codes, classes and versions; /trace and the Prometheus route 200 in
    both; only the fleet's and tenancy's blocks None; the cache and
    trace blocks and the exposition's families alike."""
    spec = "engine.fetch:latency_ms=1"
    answers, metrics, traces, prom = _conformance(
        tmp_path, ["--serve-cache", "--serve-dedup", "--serve-fastlane",
                   "--serve-trace", "--serve-faults", spec])
    mp, mj = metrics["port"], metrics["jax"]
    assert mp["cache"].keys() == mj["cache"].keys()
    for k in ("hits", "misses", "inserts", "invalidations"):
        assert mp["cache"][k] == mj["cache"][k], k
    assert mp["trace"].keys() == mj["trace"].keys()
    assert mp["fastpath"]["dispatches"] == mj["fastpath"]["dispatches"] > 0
    assert traces["port"][0] == traces["jax"][0] == 200
    assert {e["name"] for e in traces["port"][1]["traceEvents"]} \
        <= {e["name"] for e in traces["jax"][1]["traceEvents"]} | {
            "process_name", "thread_name"}
    assert prom["port"][0] == prom["jax"][0] == 200
    fams = [set(re.findall(r"^# TYPE (\S+) ", p[1], re.M))
            for p in (prom["port"], prom["jax"])]
    assert fams[0] <= fams[1] and "dmnist_serve_cache_hits_total" \
        in fams[0]
    for name in ("predict 3 rows", "predict after"):
        assert "X-Trace-Id" in answers["port"][name][2]
        assert "X-Trace-Id" in answers["jax"][name][2]


# -- (f) the fleet and the cascade over HTTP, against root serve.py ----------


def _save_fitted_checkpoints(jck, tck, step=5):
    """The fitted MLP of tests/test_torch_serve.py (real margins: both
    packages' int8 variants clear their gates on it) as a JAX train-state
    checkpoint and a port checkpoint of the same step."""
    from distributedmnist_tpu import optim
    from distributedmnist_tpu.checkpoint import Checkpointer as JCkpt
    from distributedmnist_tpu.parallel import replicated
    from distributedmnist_tpu.trainer import init_state
    from torch_fit_util import fit_params, mlp_flax

    params = fit_params()
    flax = mlp_flax(params)
    mesh = make_mesh(jax.devices()[:8])
    model = jmodels.build("mlp", fused="xla")
    state = init_state(jax.random.PRNGKey(0), model,
                       optim.build("adam", 1e-3),
                       jnp.zeros((1, 28, 28, 1)))
    state = state.replace(step=jnp.asarray(step, jnp.int32),
                          params=jax.tree.map(jnp.asarray, flax))
    state = jax.device_put(state, replicated(mesh))
    ck = JCkpt(str(jck), async_save=False)
    ck.save(step, state)
    ck.wait()
    ck.close()
    tk = Checkpointer(str(tck))
    tk.save(step, {"params": params, "optimizer": {}, "scheduler": {}})
    tk.close()


def _pair(tmp_path, layers, script, ready=None):
    """Root serve.py and the port's server on the fitted step-5 MLP with
    the same extra flags; once both are healthy (and `ready(healthz)`
    holds), the same script: {server: (answers, healthz, metrics,
    Prometheus text)}."""
    from conftest import worker_env

    jck, tck = tmp_path / "jck", tmp_path / "tck"
    _save_fitted_checkpoints(jck, tck)
    jenv, _ = worker_env()
    common = ["--model", "mlp", "--device", "cpu", "--serve-max-batch",
              str(MAX_BATCH), "--port", "0", "--metrics-every", "60",
              *layers]
    servers = {
        "jax": ServerProcess([sys.executable,
                              os.path.join(REPO, "serve.py"), *common,
                              "--checkpoint-dir", str(jck)], env=jenv,
                             cwd=REPO),
        "port": ServerProcess([sys.executable, "-m",
                               "distributedmnist_tpu_torch.serve", *common,
                               "--checkpoint-dir", str(tck)],
                              env=_port_env(), cwd=REPO),
    }
    out = {}
    try:
        for name, srv in servers.items():
            health = _wait_healthy(srv.base, timeout=180)
            deadline = time.monotonic() + 120
            while ready is not None and not ready(health):
                assert time.monotonic() < deadline, health
                time.sleep(0.1)
                health = _request(f"{srv.base}/healthz")[1]
            answers = _run_script(srv.base, script)
            out[name] = (answers, _request(f"{srv.base}/healthz")[1],
                         _request(f"{srv.base}/metrics")[1],
                         _text(f"{srv.base}/metrics?format=prometheus")[1])
    finally:
        rcs = {name: srv.stop().rc for name, srv in servers.items()}
    assert rcs == {"jax": 0, "port": 0}
    return out


def _post_json(path, body):
    return ("POST", path, json.dumps(body).encode(),
            {"Content-Type": "application/json"})


def _families_of(text):
    return set(re.findall(r"^# TYPE (\S+) ", text, re.M))


def test_conformance_fleet_admin_with_jax_serve(tmp_path):
    """`--serve-replicas 2 --serve-hedge` on both servers: drain r1 (200,
    twice), the last-active drain of r0 (409), an unknown replica and a
    bad action (404), predictions while drained, rejoin (200), and a
    cascade header on a server without the cascade (400): equal codes
    and bodies' keys; /healthz carries `replicas` and `failovers`,
    /metrics a `fleet` block of JAX's keys and the replica families."""
    x2 = _images(2, seed=709).reshape(2, 784).tobytes()
    script = [
        ("predict", "POST", "/predict", x2, {}),
        ("drain r1", *_post_json("/replicas/r1/drain", {})),
        ("drain r1 again", *_post_json("/replicas/r1/drain", {})),
        ("drain r0 last active", *_post_json("/replicas/r0/drain", {})),
        ("drain unknown", *_post_json("/replicas/r9/drain", {})),
        ("bad action", *_post_json("/replicas/r1/restart", {})),
        ("predict drained", "POST", "/predict", x2, {}),
        ("rejoin r1", *_post_json("/replicas/r1/rejoin", {})),
        ("rejoin unknown", *_post_json("/replicas/r9/rejoin", {})),
        ("accuracy class without cascade", "POST", "/predict", x2,
         {"X-Accuracy-Class": "fast"}),
        ("predict after", "POST", "/predict", x2, {}),
    ]
    runs = _pair(tmp_path, ["--serve-replicas", "2", "--serve-hedge"],
                 script)
    (ja, jh, jm, jp), (ta, th, tm, tp) = runs["jax"], runs["port"]
    codes = {name: (ja[name][0], ta[name][0]) for name in ja}
    assert all(a == b for a, b in codes.values()), codes
    assert codes["drain r1"] == codes["rejoin r1"] == (200, 200)
    assert codes["drain r0 last active"] == (409, 409)
    assert codes["drain unknown"] == codes["bad action"] == (404, 404)
    assert codes["accuracy class without cascade"] == (400, 400)
    for name in ja:
        assert set(ta[name][1]) == set(ja[name][1]), name
    for name in ("drain r1", "rejoin r1"):
        assert set(ta[name][1]["replica"]) == set(ja[name][1]["replica"])
        assert ta[name][1]["replica"]["id"] == "r1"
    assert ta["drain r1"][1]["replica"]["state"] == "draining"
    assert ta["rejoin r1"][1]["replica"]["state"] == "active"
    for name in ("predict", "predict drained", "predict after"):
        assert ta[name][1]["classes"] == ja[name][1]["classes"], name
    assert set(th) == set(jh) and {"replicas", "failovers"} <= set(th)
    assert [r["id"] for r in th["replicas"]] == ["r0", "r1"]
    assert set(th["replicas"][0]) == set(jh["replicas"][0])
    assert set(tm) == set(jm) - set(UNPORTED_METRICS_KEYS)
    assert set(tm["fleet"]) == set(jm["fleet"])
    assert tm["fleet"]["n_replicas"] == 2 and tm["fleet"]["hedge"] is True
    assert set(tm["by_replica"]) <= {"r0", "r1"} and tm["by_replica"]
    fams = _families_of(tp)
    assert {"dmnist_serve_replica_batches_total", "dmnist_serve_hedges_total",
            "dmnist_serve_failovers_total"} & _families_of(jp) <= fams
    assert "dmnist_serve_replica_batches_total" in fams


def test_conformance_cascade_with_jax_serve(tmp_path):
    """`--serve-cascade` on both servers (a calibrated int8 cascade in
    each): X-Accuracy-Class fast, balanced and exact (200; exact's classes
    JAX's), an unknown class (400), promote's cascade_threshold malformed
    or out of range (400), judged and kept (200), and on a version with
    no cascade (409, the old version stays live): equal codes and bodies'
    keys; /healthz's `cascade` block and /metrics' `cascade` block of
    JAX's keys."""
    x3 = _images(3, seed=709).reshape(3, 784).tobytes()

    def promote(body):
        return _post_json("/models/promote", body)

    script = [
        ("exact", "POST", "/predict", x3, {"X-Accuracy-Class": "exact"}),
        ("fast", "POST", "/predict", x3, {"X-Accuracy-Class": "fast"}),
        ("balanced", "POST", "/predict", x3,
         {"X-Accuracy-Class": "balanced"}),
        ("class in capitals", "POST", "/predict", x3,
         {"X-Accuracy-Class": "EXACT"}),
        ("unknown class", "POST", "/predict", x3,
         {"X-Accuracy-Class": "bogus"}),
        ("no class", "POST", "/predict", x3, {}),
        ("threshold not a number",
         *promote({"version": "step-5", "cascade_threshold": "x"})),
        ("threshold out of range",
         *promote({"version": "step-5", "cascade_threshold": 1.5})),
        ("threshold on a canary",
         *promote({"version": "step-5", "mode": "canary",
                   "cascade_threshold": 0.5})),
        ("threshold kept",
         *promote({"version": "step-5", "cascade_threshold": 1.0})),
        ("load fresh", *_post_json("/models/load",
                                   {"fresh": {"seed": 4,
                                              "version": "fresh"}})),
        ("threshold without cascade",
         *promote({"version": "fresh", "cascade_threshold": 0.5})),
        ("balanced after", "POST", "/predict", x3,
         {"X-Accuracy-Class": "balanced"}),
    ]
    runs = _pair(tmp_path, ["--serve-cascade"], script,
                 ready=lambda h: h.get("cascade") is not None)
    (ja, jh, jm, jp), (ta, th, tm, tp) = runs["jax"], runs["port"]
    codes = {name: (ja[name][0], ta[name][0]) for name in ja}
    assert all(a == b for a, b in codes.values()), codes
    for name in ("exact", "fast", "balanced", "class in capitals",
                 "threshold kept", "balanced after"):
        assert codes[name] == (200, 200), name
    for name in ("unknown class", "threshold not a number",
                 "threshold out of range", "threshold on a canary"):
        assert codes[name] == (400, 400), name
    assert codes["threshold without cascade"] == (409, 409)
    for name in ja:
        if name != "load fresh":   # a version's describe(): its own keys
            assert set(ta[name][1]) == set(ja[name][1]), name
    assert ta["exact"][1]["classes"] == ja["exact"][1]["classes"]
    assert ta["exact"][1]["classes"] == ta["class in capitals"][1]["classes"]
    assert ta["balanced after"][1]["version"] == "step-5"
    assert set(th["cascade"]) == set(jh["cascade"])
    assert th["cascade"]["cheap_dtype"] == jh["cascade"]["cheap_dtype"]
    assert th["cascade"]["threshold"] == 1.0 == jh["cascade"]["threshold"]
    assert set(tm["cascade"]) == set(jm["cascade"])
    assert tm["cascade"]["by_class"] == jm["cascade"]["by_class"] == {
        "balanced": 3, "exact": 2, "fast": 1}
    cascade_fams = {f for f in _families_of(jp)
                    if f.startswith("dmnist_serve_cascade_")}
    assert cascade_fams and cascade_fams <= _families_of(tp)


# -- (g) tenancy over HTTP, against root serve.py -----------------------------

TENANTS = ("gold:qps=1000,burst=64,deadline_ms=30000,weight=2,model=mlp;"
           "free:qps=0.05,burst=2,model=lenet")


def _tenancy_script():
    x2 = _images(2, seed=709).reshape(2, 784).tobytes()

    def quota(tenant, body):
        return _post_json(f"/tenants/{tenant}/quota", body)

    return [
        ("gold", "POST", "/predict", x2, {"X-Tenant": "gold"}),
        ("unknown tenant", "POST", "/predict", x2, {"X-Tenant": "nobody"}),
        ("no tenant", "POST", "/predict", x2, {}),
        ("free 1", "POST", "/predict", x2, {"X-Tenant": "free"}),
        ("free 2", "POST", "/predict", x2, {"X-Tenant": "free"}),
        ("free over quota", "POST", "/predict", x2, {"X-Tenant": "free"}),
        ("deadline passed", "POST", "/predict", x2,
         {"X-Tenant": "gold", "X-Deadline-Ms": "0.001"}),
        ("accuracy class", "POST", "/predict", x2,
         {"X-Accuracy-Class": "fast"}),
        ("tenants", "GET", "/tenants", None, {}),
        ("quota not a number", *quota("free", {"qps": "x"})),
        ("quota a bool", *quota("free", {"burst": True})),
        ("quota refused", *quota("free", {"qps": -1})),
        ("quota bad json", "POST", "/tenants/free/quota", b"{",
         {"Content-Type": "application/json"}),
        ("quota unknown tenant", *quota("nobody", {"qps": 5})),
        ("quota bad shape", *_post_json("/tenants/free", {})),
        ("quota loosened", *quota("free", {"qps": 100, "burst": 10})),
        ("free after", "POST", "/predict", x2, {"X-Tenant": "free"}),
        ("replica drain", *_post_json("/replicas/r0/drain", {})),
    ]


def test_conformance_tenancy_with_jax_serve():
    """`--serve-models mlp,lenet --serve-tenants ...` on both servers
    (fresh-init weights, so the classes are not compared): equal codes
    and bodies' keys for the whole script, the 429 with a Retry-After of
    the same value, /metrics' tenancy, by_tenant and by_model blocks, the
    tenant and model Prometheus families, and a SIGTERM summary with the
    tenancy block in each."""
    from conftest import worker_env

    jenv, _ = worker_env()
    common = ["--model", "mlp", "--device", "cpu", "--serve-max-batch",
              str(MAX_BATCH), "--port", "0", "--metrics-every", "60",
              "--serve-models", "mlp,lenet", "--serve-tenants", TENANTS]
    servers = {
        "jax": ServerProcess([sys.executable,
                              os.path.join(REPO, "serve.py"), *common],
                             env=jenv, cwd=REPO),
        "port": ServerProcess([sys.executable, "-m",
                               "distributedmnist_tpu_torch.serve", *common],
                              env=_port_env(), cwd=REPO),
    }
    out, done = {}, {}
    try:
        for name, srv in servers.items():
            _wait_healthy(srv.base, timeout=240)
            answers = _run_script(srv.base, _tenancy_script())
            out[name] = (answers, _request(f"{srv.base}/metrics")[1],
                         _text(f"{srv.base}/metrics?format=prometheus")[1])
    finally:
        for name, srv in servers.items():
            done[name] = srv.stop()
    # the port exits 0. Root serve.py answers /healthz 200 once its
    # default model is live, while its boot thread still warms LeNet, and
    # a SIGTERM then can abort it at exit, after its summary, with that
    # thread inside XLA (SIGABRT): the reference's; its summary is still
    # checked below
    assert done["port"].rc == 0, done["port"].stderr[-3000:]
    (ja, jm, jp), (ta, tm, tp) = out["jax"], out["port"]
    codes = {name: (ja[name][0], ta[name][0]) for name in ja}
    assert all(a == b for a, b in codes.values()), codes
    for name in ("gold", "unknown tenant", "no tenant", "free 1", "free 2",
                 "tenants", "quota loosened", "free after"):
        assert codes[name] == (200, 200), name
    assert codes["free over quota"] == (429, 429)
    assert codes["deadline passed"] == (504, 504)
    for name in ("accuracy class", "quota not a number", "quota a bool",
                 "quota refused", "quota bad json"):
        assert codes[name] == (400, 400), name
    assert codes["quota unknown tenant"] == (404, 404)
    assert codes["quota bad shape"] == (404, 404)
    assert codes["replica drain"] == (409, 409)
    for name in ja:
        assert set(ta[name][1]) == set(ja[name][1]), name
    # the bucket's refill time at 0.05 qps, whole seconds: its value
    # depends on how long each server took since the last token
    for answers in (ta, ja):
        assert 1 <= int(answers["free over quota"][2]["Retry-After"]) <= 20
    assert ta["quota loosened"][1] == ja["quota loosened"][1]
    for name in ("gold", "unknown tenant", "free after"):
        # the scheduler's future carries no version tag, in both
        assert ta[name][1]["n"] == 2
        assert ta[name][1]["version"] == ja[name][1]["version"]
    tt, jt = ta["tenants"][1], ja["tenants"][1]
    assert set(tt["tenants"]) == set(jt["tenants"]) == {"gold", "free",
                                                        "default"}
    for t in tt["tenants"]:
        assert set(tt["tenants"][t]) == set(jt["tenants"][t]), t
    assert set(tt["models"]) == set(jt["models"]) == {"mlp", "lenet"}
    assert set(tt["models"]["lenet"]) == set(jt["models"]["lenet"])
    assert set(tm) == set(jm) - set(UNPORTED_METRICS_KEYS)
    assert set(tm["tenancy"]) == set(jm["tenancy"])
    assert set(tm["by_tenant"]) == set(jm["by_tenant"]) == {
        "gold", "free", "default"}
    for t in tm["by_tenant"]:
        assert set(tm["by_tenant"][t]) == set(jm["by_tenant"][t]), t
        for k in ("requests", "rows", "quota_sheds", "deadline_sheds"):
            assert tm["by_tenant"][t][k] == jm["by_tenant"][t][k], (t, k)
    assert tm["by_model"] == jm["by_model"]
    assert tm["by_tenant"]["free"]["quota_sheds"] == 1
    fams = {f for f in _families_of(jp)
            if f.startswith(("dmnist_serve_tenant_",
                             "dmnist_serve_model_"))}
    assert fams and fams == {f for f in _families_of(tp)
                             if f.startswith(("dmnist_serve_tenant_",
                                              "dmnist_serve_model_"))}
    for name, d in done.items():
        summary = [r for r in d.records
                   if r.get("metric") == "serve_summary"]
        assert summary and set(summary[-1]["tenancy"]) == set(
            jm["tenancy"]), name


@pytest.mark.parametrize("argv", [
    ["--serve-tenants", "a:nope=1"],
    ["--serve-tenants", "gold:qps=1", "--serve-tenant-quantum-us", "0"],
    ["--serve-models", "mlp,resnet"],
    ["--serve-models", "mlp,lenet", "--serve-cascade"],
    ["--serve-tenants", "gold:qps=1", "--serve-replicas", "2"],
    ["--serve-models", "mlp", "--serve-fastlane"]])
def test_server_cli_tenancy_refusals_match_jax_serve(capsys, argv):
    """The serve CLI refuses a malformed tenant spec, a quantum of 0, an
    unknown model, and tenancy with the cascade, a fleet or the fast
    lane: exit 2 with the root serve.py's message, word for word."""
    errors = []
    for main in (_load_jax_serve().main, serve_cli.main):
        with pytest.raises(SystemExit) as ei:
            main(["--device", "cpu", "--model", "mlp"] + argv)
        assert ei.value.code == 2
        errors.append(capsys.readouterr().err.strip().splitlines()[-1]
                      .split("error: ", 1)[1])
    assert errors[0] == errors[1]


def test_tenancy_server_in_process_routes_and_summary():
    """The HTTPServer in-process over a two-model catalog: X-Tenant routes
    to each model's batcher, /metrics counts every catalog factory's
    builds in compiles_total and carries the scheduler's snapshot, and
    the summary its tenancy block."""
    from distributedmnist_tpu_torch.serve import build_tenancy

    cfg = tconfig.Config(model="mlp", device="cpu", serve_max_batch=8,
                         serve_models="mlp,lenet",
                         serve_tenants="a:model=mlp;b:model=lenet")
    metrics = ServeMetrics()
    catalog, sched = build_tenancy(cfg, metrics=metrics)
    entry = catalog.get(catalog.default())
    server = tserver.HTTPServer(entry.batcher, metrics, entry.registry,
                                tserver.ServerState(), request_timeout=30,
                                front=sched, scheduler=sched)
    base = f"http://127.0.0.1:{server.port}"
    result = {}
    t = threading.Thread(target=lambda: result.update(server.serve(
        lambda: serve_cli.warm_catalog(catalog, cfg), metrics_every=60)),
        daemon=True)
    t.start()
    try:
        _wait_healthy(base, timeout=60)
        for tenant in ("a", "b", "b"):
            code, body, _ = _request(f"{base}/predict",
                                     data=_images(3).tobytes(),
                                     headers={"X-Tenant": tenant},
                                     method="POST")
            assert code == 200 and body["n"] == 3
        _, m, _ = _request(f"{base}/metrics")
        assert m["by_model"]["mlp"]["requests"] == 1
        assert m["by_model"]["lenet"]["requests"] == 2
        assert m["tenancy"]["tenants"]["b"]["granted_rows"] == 6
        assert m["compiles_total"] == kernel_lib.load_events() + sum(
            e.factory.engine_builds for e in catalog.entries())
        assert all(e.factory.engine_builds >= 1
                   for e in catalog.entries())
    finally:
        server.shutdown()
        t.join(30)
        sched.stop()
    assert result["tenancy"]["models"]["lenet"]["resident"] is True
    assert set(result["by_tenant"]) == {"a", "b"}
