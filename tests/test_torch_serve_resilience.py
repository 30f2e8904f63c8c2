"""The port's fault injection, circuit breaker, health tracker, resilience
policy, bisection and deadline shed against the JAX package's, on the CPU.

Every comparison feeds both packages the same inputs: the same spec
strings (equal `describe()` dicts, the same refusals), the same
(seed, point, rid) grid for the request-sticky draw, the same call
sequence through a FaultInjector, the same outcome sequence under the
same injected clock through the breaker and the tracker, the same
registry trip (its `events()` sequence), and the same drains through
both batchers: one stub engine class (the JAX suite's, duck-typed) held
at its fetch gate while a cohort forms, with request-sticky poison from
one spec and seed. Tolerance: exact everywhere (these are decisions and
counts, not floats).
"""

import threading
from types import SimpleNamespace

import numpy as np
import pytest

from distributedmnist_tpu.serve import batcher as jbatcher
from distributedmnist_tpu.serve import faults as jfaults
from distributedmnist_tpu.serve import metrics as jmetrics
from distributedmnist_tpu.serve import resilience as jresilience
from distributedmnist_tpu_torch.serve import batcher as tbatcher
from distributedmnist_tpu_torch.serve import faults as tfaults
from distributedmnist_tpu_torch.serve import metrics as tmetrics
from distributedmnist_tpu_torch.serve import resilience as tresilience
from distributedmnist_tpu_torch.serve import (EngineFactory, ModelRegistry,
                                              NoLiveModel)
from tests.test_serve_batcher import StubEngine

PKGS = {
    "jax": SimpleNamespace(faults=jfaults, res=jresilience, b=jbatcher,
                           m=jmetrics),
    "torch": SimpleNamespace(faults=tfaults, res=tresilience, b=tbatcher,
                             m=tmetrics),
}
GOOD_SPECS = [
    "batch.dispatch:mode=request,p=0.02",
    "engine.fetch:p=1,count=3,after=5,latency_ms=2,version=v1",
    "engine.dispatch:p=0.5;router.shadow:error=boom",
    "registry.warmup:p=1;registry.restore:p=1,step=7",
    "registry.variant:dtype=int8;replica.fetch:p=0.25,replica=r1",
    "engine.fetch:latency_ms=5",
]
BAD_SPECS = ["", "engine.fetch:p=2", "engine.fetch:p=",
             "engine.fetch:mode=weird", "engine.fetch:count=0",
             "engine.fetch:latency_ms=-1", "engine.fetch:p",
             # lint: allow[DML003] deliberately-bad spec: this test asserts parse_spec rejects it
             "engine.fetsh:p=1", "nope:p=1", "engine.fetch:after=-1",
             "batch.dispatch:p=0"]


@pytest.fixture(autouse=True)
def _no_leaked_injector():
    for p in PKGS.values():
        p.faults.uninstall()
    yield
    for p in PKGS.values():
        p.faults.uninstall()


def _rows(rng, n):
    return rng.integers(0, 256, (n, 28, 28, 1)).astype(np.uint8)


# -- faults -----------------------------------------------------------------


def test_known_failpoints_equal_jax():
    assert tfaults.KNOWN_FAILPOINTS == jfaults.KNOWN_FAILPOINTS


@pytest.mark.parametrize("spec", GOOD_SPECS)
def test_fault_spec_parses_like_jax(spec):
    ours = [r.describe() for r in tfaults.parse_spec(spec)]
    ref = [r.describe() for r in jfaults.parse_spec(spec)]
    assert ours == ref


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_fault_spec_refused_like_jax(spec):
    with pytest.raises(ValueError) as ref:
        jfaults.parse_spec(spec)
    with pytest.raises(ValueError) as ours:
        tfaults.parse_spec(spec)
    assert str(ours.value) == str(ref.value)


def test_hash_draw_equals_jax_on_a_grid():
    for seed in (0, 3, 23, 709):
        for point in sorted(jfaults.KNOWN_FAILPOINTS):
            for rid in list(range(40)) + [10**6, 2**40]:
                assert (tfaults._hash_draw(seed, point, rid)
                        == jfaults._hash_draw(seed, point, rid))


def _fire_sequence(pkg, spec: str, seed: int, calls) -> tuple:
    """Fire `calls` (point, ctx) through an injector; the verdict of each
    crossing (None or the fault's message), then the snapshot and the
    poisoned set."""
    inj = pkg.faults.FaultInjector.from_spec(spec, seed=seed)
    verdicts = []
    for point, ctx in calls:
        try:
            inj.fire(point, **ctx)
            verdicts.append(None)
        except pkg.faults.InjectedFault as e:
            assert e.point == point and e.status == 500
            verdicts.append(str(e))
    return verdicts, inj.snapshot(), inj.poisoned()


@pytest.mark.parametrize("spec,seed", [
    ("engine.fetch:p=1,count=2,after=1,version=v1", 0),
    ("engine.dispatch:p=0.3;engine.fetch:p=0.6,version=v2", 5),
    ("batch.dispatch:mode=request,p=0.2", 7),
    ("batch.dispatch:mode=request,p=0.015;"
     "engine.fetch:p=1,count=200,after=40,version=v1", 23)])
def test_injector_fires_on_the_same_calls_as_jax(spec, seed):
    r = np.random.default_rng(seed)
    calls = []
    for i in range(300):
        k = int(r.integers(0, 3))
        if k == 0:
            calls.append(("engine.fetch",
                          {"version": f"v{int(r.integers(1, 3))}"}))
        elif k == 1:
            calls.append(("engine.dispatch", {"version": "v1", "rows": 3}))
        else:
            calls.append(("batch.dispatch",
                          {"rids": [int(x) for x in
                                    r.integers(0, 500, int(r.integers(1, 6)))]}))
    assert (_fire_sequence(PKGS["torch"], spec, seed, calls)
            == _fire_sequence(PKGS["jax"], spec, seed, calls))


def test_failpoint_inert_and_install_refuses_stacking():
    tfaults.failpoint("engine.dispatch", version="v1", rids=[1, 2])
    inj = tfaults.install(tfaults.FaultInjector.from_spec(
        "engine.dispatch:p=1"))
    assert tfaults.active() is inj
    with pytest.raises(RuntimeError, match="already installed"):
        tfaults.install(tfaults.FaultInjector.from_spec("engine.fetch:p=1"))
    with pytest.raises(tfaults.InjectedFault):
        tfaults.failpoint("engine.dispatch")
    tfaults.uninstall()
    tfaults.failpoint("engine.dispatch")


# -- breaker, health tracker, policy ---------------------------------------


def _breaker_trace(pkg, outcomes) -> tuple:
    br = pkg.res.CircuitBreaker(window_s=2.0, min_requests=6,
                                failure_ratio=0.5, cooldown_s=3.0)
    trips = [br.record(v, ok, n=n, now=t) for t, v, ok, n in outcomes]
    cool = [br.in_cooldown(v, now=t) for t, v, _, _ in outcomes]
    snap = br.snapshot()
    for v in snap["by_version"].values():
        v.pop("cooldown_remaining_s")      # read off the real clock
    return trips, cool, br.trips(), snap


def test_breaker_states_equal_jax_under_one_clock():
    r = np.random.default_rng(1)
    outcomes, t = [], 100.0
    for i in range(400):
        t += float(r.exponential(0.05))
        v = "v1" if i % 3 else "v2"
        bad = 0.7 if 120 <= i < 200 else 0.1
        outcomes.append((t, v, bool(r.random() > bad),
                         int(r.integers(1, 4))))
    ours = _breaker_trace(PKGS["torch"], outcomes)
    assert ours == _breaker_trace(PKGS["jax"], outcomes)
    assert ours[2] >= 1 and any(ours[0])       # the storm trips it


def test_breaker_rejects_bad_params_like_jax():
    for kw in ({"window_s": 0}, {"min_requests": 0},
               {"failure_ratio": 0.0}, {"failure_ratio": 1.5},
               {"cooldown_s": -1}):
        with pytest.raises(ValueError) as ref:
            jresilience.CircuitBreaker(**kw)
        with pytest.raises(ValueError) as ours:
            tresilience.CircuitBreaker(**kw)
        assert str(ours.value) == str(ref.value)


def test_health_tracker_equals_jax_under_one_clock():
    r = np.random.default_rng(2)
    hs = [p.res.HealthTracker(window_s=1.0, ewma_alpha=0.3)
          for p in (PKGS["torch"], PKGS["jax"])]
    t = 0.0
    for i in range(200):
        t += float(r.exponential(0.03))
        key, ok = f"r{i % 2}", bool(r.random() > 0.2)
        lat = float(r.random()) * 1e-3 if i % 5 else None
        for h in hs:
            h.record(key, ok, n=2, latency_s=lat, now=t)
        assert hs[0].score("r0", now=t) == hs[1].score("r0", now=t)
        assert hs[0].score("r1", now=t) == hs[1].score("r1", now=t)
    assert hs[0].snapshot().keys() == hs[1].snapshot().keys()
    hs[0].reset("r0")
    assert hs[0].score("r0") == 1.0


class _RecordingRegistry:
    def __init__(self):
        self.calls = []
        self.done = threading.Event()

    def rollback(self, version, reason):
        self.calls.append((version, reason))
        self.done.set()
        return SimpleNamespace(version="v0")


@pytest.mark.parametrize("name", ["torch", "jax"])
def test_policy_trip_rolls_back_async_and_records(name):
    pkg = PKGS[name]
    reg = _RecordingRegistry()
    m = pkg.m.ServeMetrics()
    pol = pkg.res.ResiliencePolicy(
        bisect=True, breaker=pkg.res.CircuitBreaker(
            window_s=60, min_requests=4, failure_ratio=0.5),
        registry=reg, metrics=m)
    for _ in range(4):
        pol.record_outcome("v1", ok=False)
    assert reg.done.wait(10)
    assert reg.calls == [("v1", "circuit breaker tripped on v1")]
    for _ in range(200):                      # the metrics land after
        if m.snapshot()["resilience"]["rollbacks"]:
            break
        threading.Event().wait(0.01)
    res = m.snapshot()["resilience"]
    assert res["breaker_trips"] == 1
    assert res["breaker_trips_by_version"] == {"v1": 1}
    assert res["rollbacks"] == 1
    assert res["last_rollback"]["from"] == "v1"
    assert res["last_rollback"]["to"] == "v0"
    assert pol.snapshot()["bisect"] is True


def test_build_resilience_reads_the_config_like_jax():
    from distributedmnist_tpu import config as jconfig
    from distributedmnist_tpu_torch import config as tconfig

    kw = dict(serve_bisect=False, serve_breaker_window_s=7.0,
              serve_breaker_min_requests=9, serve_breaker_ratio=0.25)
    ours = tresilience.build_resilience(tconfig.Config(**kw)).snapshot()
    ref = jresilience.build_resilience(jconfig.Config(**kw)).snapshot()
    assert ours == ref


def test_policy_trip_through_registries_gives_jax_events(eight_devices):
    """A breaker trip on the live version against a real registry in
    each package, on the same weights: the same events() sequence
    (rollback from the tripped version to the newest healthy resident),
    and the demoted version keeps the reason as its last error."""
    from distributedmnist_tpu import models as jmodels
    from distributedmnist_tpu.parallel import make_mesh
    from distributedmnist_tpu.serve import registry as jregistry

    jf = jregistry.EngineFactory(jmodels.build("mlp", platform="cpu"),
                                 make_mesh(eight_devices[:1]), max_batch=4)
    jreg = jregistry.ModelRegistry(jf, jf.make_router())
    tf = EngineFactory("mlp", device="cpu", max_batch=4)
    treg = ModelRegistry(tf, tf.make_router())
    seqs = []
    for reg, pkg, factory in ((treg, PKGS["torch"], tf),
                              (jreg, PKGS["jax"], jf)):
        reg.add(factory.init_params(0), version="v1")
        reg.add(factory.init_params(1), version="v2")
        reg.promote("v2")
        pol = pkg.res.ResiliencePolicy(breaker=pkg.res.CircuitBreaker(
            window_s=60, min_requests=3, failure_ratio=0.5), registry=reg)
        for _ in range(3):
            pol.record_outcome("v2", ok=False)
        for _ in range(500):
            if reg.live_version() == "v1":
                break
            threading.Event().wait(0.01)
        ev = [{k: e[k] for k in ("event", "from", "to", "reason")}
              for e in reg.events()]
        seqs.append((ev, reg.live_version(), reg.get("v2").last_error,
                     reg.rollback("v1", "no fallback left")))
    assert seqs[0][:3] == seqs[1][:3]
    assert seqs[0][0] == [{"event": "rollback", "from": "v2", "to": "v1",
                           "reason": "circuit breaker tripped on v2"}]
    # v2 carries its error, so it is no fallback: both refuse alike
    assert seqs[0][3] is None and seqs[1][3] is None


# -- deadlines ----------------------------------------------------------------


@pytest.mark.parametrize("name", ["torch", "jax"])
def test_expired_deadline_sheds_at_submit(name, rng):
    import time

    pkg = PKGS[name]
    m = pkg.m.ServeMetrics()
    b = pkg.b.DynamicBatcher(StubEngine(max_batch=16), metrics=m).start()
    try:
        with pytest.raises(pkg.res.DeadlineExceeded):
            b.submit(_rows(rng, 2), deadline_s=time.monotonic() - 1e-3)
        assert m.snapshot()["resilience"]["deadline_shed_requests"] == 1
        assert b.submit(_rows(rng, 1)).result(timeout=10).shape == (1, 10)
    finally:
        b.stop()


# -- bisection, held against the JAX batcher -----------------------------


class _PoisonStub(StubEngine):
    """StubEngine failing any cohort that holds a marked request (first
    pixel 211), independent of the injector; `calls` logs rows, negative
    for a failed attempt."""

    def dispatch(self, x):
        parts = x if isinstance(x, (list, tuple)) else [x]
        if any(np.asarray(p).flat[0] == 211 for p in parts):
            self.calls.append(-sum(np.asarray(p).reshape(-1, 784).shape[0]
                                   for p in parts))
            raise RuntimeError("poison request in cohort")
        return super().dispatch(x)


def _drain(pkg, sizes, spec=None, seed=0, bisect=True, marked=(),
           engine_cls=StubEngine, max_inflight=4):
    """One gated drain through `pkg`'s batcher: a first request holds
    the pipeline at the stub's fetch gate while requests of `sizes` queue
    into one cohort; then the gate opens. Returns the failed request
    indices, the resilience counters, the stub's dispatch log and the
    injector's poisoned rids."""
    rng = np.random.default_rng(42)
    gate = threading.Event()
    eng = engine_cls(max_batch=64, gate=gate)
    m = pkg.m.ServeMetrics()
    b = pkg.b.DynamicBatcher(
        eng, max_wait_us=100_000, max_inflight=max_inflight,
        resilience=pkg.res.ResiliencePolicy(bisect=bisect), metrics=m,
        split=False).start()
    try:
        first = b.submit(_rows(rng, 1))
        assert eng.in_call.wait(timeout=10)
        if spec is not None:       # after the gate-holder's dispatch
            pkg.faults.install(pkg.faults.FaultInjector.from_spec(
                spec, seed=seed))
        futs = []
        for i, n in enumerate(sizes):
            x = _rows(rng, n)
            if i in marked:
                x[0, 0, 0, 0] = 211
            futs.append(b.submit(x))
        gate.set()
        first.result(timeout=30)
        failed = []
        for i, f in enumerate(futs):
            try:
                assert f.result(timeout=30).shape == (sizes[i], 10)
            except Exception as e:
                failed.append((i, type(e).__name__))
        poisoned = (pkg.faults.active().poisoned()
                    if spec is not None else set())
        assert b.pending_rows() == 0
        for _ in range(500):
            if b.inflight_batches() == 0:
                break
            threading.Event().wait(0.01)
        assert b.inflight_batches() == 0
    finally:
        b.stop()
        pkg.faults.uninstall()
    return failed, m.snapshot()["resilience"], eng.calls, poisoned


@pytest.mark.parametrize("sizes,spec,seed", [
    ([1] * 24, "batch.dispatch:mode=request,p=0.1", 3),
    ([2, 1, 3, 1, 4, 2, 1, 1, 2, 3, 1, 2], "batch.dispatch:mode=request,"
                                           "p=0.2", 11),
    ([1, 1, 1, 1, 1, 1, 1, 1], "batch.dispatch:mode=request,p=0.5", 5)])
def test_bisection_equals_jax_on_request_sticky_poison(sizes, spec, seed):
    ours = _drain(PKGS["torch"], sizes, spec, seed)
    ref = _drain(PKGS["jax"], sizes, spec, seed)
    assert ours == ref
    failed, res, calls, poisoned = ours
    # exact isolation: the failures are the poisoned rids (rid 1 is the
    # gate-holder, so request i is rid i + 2)
    assert {i + 2 for i, _ in failed} == poisoned
    assert all(kind == "InjectedFault" for _, kind in failed)
    assert res["poison_isolated_requests"] == len(poisoned)
    assert res["bisect_splits"] >= 1 and res["bisect_rescued_requests"] > 0
    assert res["dispatch_error_requests"] == 0


def test_bisection_with_a_marked_culprit_equals_jax():
    sizes = [2, 2, 2, 3]
    ours = _drain(PKGS["torch"], sizes, marked={2},
                  engine_cls=_PoisonStub)
    assert ours == _drain(PKGS["jax"], sizes, marked={2},
                          engine_cls=_PoisonStub)
    failed, res, calls, _ = ours
    assert failed == [(2, "RuntimeError")]
    assert res["poison_isolated_requests"] == 1
    assert res["bisect_rescued_requests"] == 3
    assert res["bisect_rescued_rows"] == 7
    assert [c for c in calls if c < 0]


@pytest.mark.parametrize("bisect", [False, True])
def test_no_bisect_and_all_poison_equal_jax(bisect):
    sizes = [1, 2, 1]
    kw = dict(marked={0, 1, 2}, engine_cls=_PoisonStub, bisect=bisect,
              max_inflight=1)
    ours = _drain(PKGS["torch"], sizes, **kw)
    assert ours == _drain(PKGS["jax"], sizes, **kw)
    failed, res, _, _ = ours
    assert [i for i, _ in failed] == [0, 1, 2]
    if bisect:
        assert res["poison_isolated_requests"] == 3
    else:
        assert res["dispatch_error_requests"] == 3
        assert res["bisect_splits"] == 0


class _DeadEngine(StubEngine):
    """Every dispatch fails: with NoLiveModel (a systemic 503), or with a
    plain error."""

    systemic = True

    def dispatch(self, x):
        self.calls.append(-1)
        if self.systemic:
            raise NoLiveModel("no live model")
        raise RuntimeError("engine died")

    def live_version(self):
        return None if self.systemic else "v1"


@pytest.mark.parametrize("name", ["torch", "jax"])
def test_systemic_failure_never_bisects(name):
    """NoLiveModel fails the whole drain once: one dispatch attempt, no
    split, no breaker volume, every future the 503."""
    pkg = PKGS[name]
    eng = _DeadEngine(max_batch=16)
    m = pkg.m.ServeMetrics()
    br = pkg.res.CircuitBreaker(window_s=60, min_requests=1)
    b = pkg.b.DynamicBatcher(
        eng, max_wait_us=50_000, max_inflight=1,
        resilience=pkg.res.ResiliencePolicy(bisect=True, breaker=br),
        metrics=m).start()
    rng = np.random.default_rng(0)
    try:
        futs = [b.submit(_rows(rng, 1)) for _ in range(6)]
        for f in futs:
            with pytest.raises(RuntimeError) as e:
                f.result(timeout=10)
            assert getattr(e.value, "status", None) == 503
        res = m.snapshot()["resilience"]
        assert res["bisect_splits"] == 0
        assert res["poison_isolated_requests"] == 0
        assert eng.calls.count(-1) <= 6 and len(eng.calls) < 12
        assert br.snapshot()["by_version"] == {}
    finally:
        b.stop()


def test_dispatch_failures_feed_the_breaker_like_jax():
    """An engine that fails every dispatch with a plain error: bisection
    runs, every singleton fails, and the breaker counts the failures
    against the live version — the same trips and windows in both."""
    out = []
    for pkg in (PKGS["torch"], PKGS["jax"]):
        eng = _DeadEngine(max_batch=16)
        eng.systemic = False
        gate = threading.Event()
        eng.gate = gate
        br = pkg.res.CircuitBreaker(window_s=600, min_requests=4,
                                    failure_ratio=0.5, cooldown_s=600)
        b = pkg.b.DynamicBatcher(
            eng, max_wait_us=50_000, max_inflight=1,
            resilience=pkg.res.ResiliencePolicy(bisect=True, breaker=br),
            split=False).start()
        rng = np.random.default_rng(0)
        try:
            futs = [b.submit(_rows(rng, 1)) for _ in range(4)]
            for f in futs:
                with pytest.raises(RuntimeError, match="engine died"):
                    f.result(timeout=10)
        finally:
            b.stop()
        snap = br.snapshot()
        out.append((br.trips(), {v: {k: s[k] for k in ("volume",
                                                       "failures")}
                                 for v, s in snap["by_version"].items()}))
    assert out[0] == out[1]
    assert out[0][0] == 1


# -- the registry's failpoints ------------------------------------------------


def test_registry_warmup_failure_surfaces_last_error():
    tf = EngineFactory("mlp", device="cpu", max_batch=4)
    reg = ModelRegistry(tf, tf.make_router())
    tfaults.install(tfaults.FaultInjector.from_spec(
        "registry.warmup:p=1,version=bad"))
    with pytest.raises(tfaults.InjectedFault):
        reg.add(tf.init_params(0), version="bad")
    mv = reg.get("bad")
    assert mv.state == "failed"
    assert "injected fault at registry.warmup" in mv.last_error
    reg.add(tf.init_params(0), version="good")     # the filter held
    assert reg.get("good").state == "ready"


def test_registry_restore_and_variant_failpoints(tmp_path):
    from distributedmnist_tpu_torch.checkpoint import Checkpointer

    tf = EngineFactory("mlp", device="cpu", max_batch=4)
    reg = ModelRegistry(tf, tf.make_router(), checkpoint_dir=str(tmp_path))
    ck = Checkpointer(str(tmp_path))
    ck.save(3, {"params": tf.init_params(0), "optimizer": {},
                "scheduler": {}})
    ck.close()
    tfaults.install(tfaults.FaultInjector.from_spec(
        "registry.restore:p=1,step=3;registry.variant:p=1,dtype=int8"))
    with pytest.raises(tfaults.InjectedFault):
        reg.load_latest()
    assert reg.get("step-3").state == "failed"
    assert "registry.restore" in reg.get("step-3").last_error
    tfaults.uninstall()
    mv = reg.load_latest()                      # a retry loads
    assert mv.state == "ready"
    tfaults.install(tfaults.FaultInjector.from_spec(
        "registry.variant:p=1,dtype=int8"))
    with pytest.raises(tfaults.InjectedFault):
        reg.add_variant(mv.version, "int8")
    assert reg.get(mv.version).variants["int8"].state == "failed"


# -- the config's request-path fields ---------------------------------------

REQUEST_PATH_FIELDS = (
    "serve_bisect", "serve_breaker_window_s", "serve_breaker_min_requests",
    "serve_breaker_ratio", "serve_faults", "serve_trace",
    "serve_trace_sample", "serve_trace_capacity", "serve_cache",
    "serve_cache_capacity", "serve_cache_ttl_s", "serve_dedup",
    "serve_fastlane")


def test_request_path_config_and_flags_match_jax():
    """The fields' names and defaults are the JAX Config's, and the same
    flags set the same values in both parsers."""
    import argparse

    from distributedmnist_tpu import config as jconfig
    from distributedmnist_tpu_torch import config as tconfig

    for f in REQUEST_PATH_FIELDS:
        assert getattr(tconfig.Config(), f) == getattr(jconfig.Config(), f)
    argv = ["--no-bisect", "--serve-breaker-window-s", "2.5",
            "--serve-breaker-min-requests", "7", "--serve-breaker-ratio",
            "0.4", "--serve-faults", "engine.fetch:p=0.5", "--serve-trace",
            "--serve-trace-sample", "0.25", "--serve-trace-capacity", "9",
            "--serve-cache", "--serve-cache-capacity", "11",
            "--serve-cache-ttl-s", "3", "--serve-dedup", "--serve-fastlane"]
    got = []
    for mod in (tconfig, jconfig):
        p = argparse.ArgumentParser()
        mod.add_args(p)
        cfg = mod.from_args(p.parse_args(argv))
        got.append({f: getattr(cfg, f) for f in REQUEST_PATH_FIELDS})
    assert got[0] == got[1]
    assert got[0]["serve_bisect"] is False and got[0]["serve_fastlane"]
