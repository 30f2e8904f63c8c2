"""Multi-tenant, multi-model serving in the port (serve/tenancy.py and the
scheduler's DRR/EDF policy) against the JAX package, on the CPU.

- The pure pieces, exactly, on the same inputs: parse_tenants (and its
  rejections' texts), token_admit, estimate_dispatch_s, edf_pick, the
  grant and deficit sequences of drr_grant/drr_charge over seeded random
  rings, and drr_skip_bound.
- The GlobalScheduler over the JAX suite's stub engine, case for case
  with tests/test_serve_tenancy.py, each scenario run through both
  packages' schedulers and batchers: the quota 429 with Retry-After, the
  unknown tenant collapsing into "default", the watermark 503, the door
  deadline 504 and the infeasible head shed at grant, the cache-aware
  shed, set_quota and the snapshot's shape, WFQ shares tracking the
  weights, the tenant tags on queue.wait and batch.dispatch (and an
  untagged request's spans as before), the Prometheus families, the boot
  refusals and a submit after stop. The port's scheduler runs on an
  injected clock, frozen, so no assertion depends on how long a step
  took; the JAX one on its own clock, held to its own test's bounds.
- A grant thread that dies (a broken skip bound) fails its waiters and
  stop() raises it.
- Real MLP and LeNet-5 catalog entries: two models from their own
  checkpoint subtrees answering through the scheduler with no build
  after warmup, the same accounting as the JAX catalog's on the same
  script, each answer its own router's dispatch (int8 bit for bit,
  float32 at 1e-5), the MLP's int8 bit for bit the JAX package's plain
  int8 reference and LeNet's float32 within 1e-5 of JAX's engine; the
  scheduled warm path of a cold model.

Tolerances: the policy functions exact (the same float operations in the
same order); float32 logits rtol=atol=1e-5 (scaled by the logits' size
for LeNet, as tests/test_torch_serve_lenet.py holds it); int8 exact.
"""

import dataclasses
import time
import types

import numpy as np
import pytest

from distributedmnist_tpu.serve import DynamicBatcher as JDynamicBatcher
from distributedmnist_tpu.serve import ServeMetrics as JServeMetrics
from distributedmnist_tpu.serve import cache as jcache
from distributedmnist_tpu.serve import prometheus_exposition as jprom
from distributedmnist_tpu.serve import scheduler as jpolicy
from distributedmnist_tpu.serve import tenancy as jtenancy
from distributedmnist_tpu.serve import trace as jtrace
from distributedmnist_tpu.serve.batcher import Rejected as JRejected
from distributedmnist_tpu.serve.resilience import \
    DeadlineExceeded as JDeadline
from distributedmnist_tpu_torch import config as tconfig
from distributedmnist_tpu_torch import models
from distributedmnist_tpu_torch.checkpoint import Checkpointer
from distributedmnist_tpu_torch.ops import kernel_lib
from distributedmnist_tpu_torch.serve import DynamicBatcher as TDynamicBatcher
from distributedmnist_tpu_torch.serve import ServeMetrics as TServeMetrics
from distributedmnist_tpu_torch.serve import cache as tcache
from distributedmnist_tpu_torch.serve import prometheus_exposition as tprom
from distributedmnist_tpu_torch.serve import scheduler as tpolicy
from distributedmnist_tpu_torch.serve import tenancy as ttenancy
from distributedmnist_tpu_torch.serve import trace as ttrace
from distributedmnist_tpu_torch.serve.batcher import Rejected as TRejected
from distributedmnist_tpu_torch.serve.resilience import \
    DeadlineExceeded as TDeadline
from tests.test_serve_batcher import StubEngine
from torch_sanitize_util import torch_serve_sanitizer  # noqa: F401

PKGS = {
    "jax": types.SimpleNamespace(
        tenancy=jtenancy, policy=jpolicy, Batcher=JDynamicBatcher,
        Metrics=JServeMetrics, cache=jcache, trace=jtrace, prom=jprom,
        Rejected=JRejected, Deadline=JDeadline),
    "port": types.SimpleNamespace(
        tenancy=ttenancy, policy=tpolicy, Batcher=TDynamicBatcher,
        Metrics=TServeMetrics, cache=tcache, trace=ttrace, prom=tprom,
        Rejected=TRejected, Deadline=TDeadline),
}


class FrozenClock:
    """The port scheduler's clock in these tests: time.monotonic's epoch
    (deadlines taken on it go on into the batcher), still until moved."""

    def __init__(self):
        self.t = time.monotonic()

    def __call__(self) -> float:
        return self.t


@pytest.fixture(autouse=True)
def _no_tracer():
    for mod in (ttrace, jtrace):
        mod.uninstall()
    yield
    for mod in (ttrace, jtrace):
        mod.uninstall()


def _rows(rng, n):
    return rng.integers(0, 256, (n, 28, 28, 1)).astype(np.uint8)


def _classes(classes: dict) -> dict:
    return {name: dataclasses.astuple(c) for name, c in classes.items()}


# -- the spec parser and the pure policy -------------------------------------


@pytest.mark.parametrize("spec", [
    "gold:qps=100,burst=8,deadline_ms=50,weight=4,model=lenet;"
    "free:weight=1",
    "default:qps=5,weight=2", "", "  ;  ", "a", "a:", "b:qps=1 , burst=3 ;",
    "light:weight=2,deadline_ms=5000,model=mlp;heavy:weight=1,model=lenet"])
def test_parse_tenants_equals_jax(spec):
    ours = ttenancy.parse_tenants(spec)
    assert _classes(ours) == _classes(jtenancy.parse_tenants(spec))
    assert list(ours) == list(jtenancy.parse_tenants(spec))
    assert "default" in ours


@pytest.mark.parametrize("spec", [
    ":qps=1", "a:nope=1", "a:qps", "a:qps=1;a:qps=2", "a:qps=0",
    "a:burst=0.5", "a:deadline_ms=0", "a:weight=0", "a:qps=x"])
def test_parse_tenants_rejects_with_jax_text(spec):
    with pytest.raises(ValueError) as ref:
        jtenancy.parse_tenants(spec)
    with pytest.raises(ValueError) as ours:
        ttenancy.parse_tenants(spec)
    assert str(ours.value) == str(ref.value)


def test_token_admit_equals_jax():
    r = np.random.default_rng(3)
    for _ in range(500):
        tokens, t_last = float(r.random() * 4), float(r.random() * 10)
        now = t_last + float(r.random() * 2) - 0.2
        qps = None if r.random() < 0.2 else float(r.random() * 20 + 0.01)
        burst = float(1 + r.random() * 8)
        assert ttenancy.token_admit(tokens, t_last, now, qps, burst) == \
            jtenancy.token_admit(tokens, t_last, now, qps, burst)


def test_estimate_dispatch_s_equals_jax():
    r = np.random.default_rng(5)
    for _ in range(300):
        buckets = sorted({int(b) for b in 2 ** r.integers(0, 10, 5)})
        costs = {b: float(r.random() * 1e-3 + 1e-5) for b in buckets}
        if r.random() < 0.2:
            costs.pop(buckets[0])       # an incomplete table
        if r.random() < 0.1:
            costs = {}
        rows = int(r.integers(0, 2 * buckets[-1]))
        ours = tpolicy.estimate_dispatch_s(rows, buckets, costs)
        assert ours == jpolicy.estimate_dispatch_s(rows, buckets, costs)


def test_edf_pick_equals_jax():
    r = np.random.default_rng(7)
    for _ in range(500):
        now = float(r.random() * 10)
        heads = [(f"m{i}",
                  None if r.random() < 0.25
                  else now + float(r.random() * 0.02 - 0.005),
                  float(r.random() * 0.01))
                 for i in range(int(r.integers(1, 5)))]
        assert tpolicy.edf_pick(heads, now) == jpolicy.edf_pick(heads, now)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_drr_grant_and_charge_sequences_equal_jax(seed):
    """A random ring of 2-6 flows, random weights and quantum, a random
    backlogged subset each step: the same grants, cursors, scan counts
    and deficits after every charge, and no flow passed over more than
    drr_skip_bound consecutive grants."""
    r = np.random.default_rng(seed)
    ring = [f"t{i}" for i in range(int(r.integers(2, 7)))]
    weights = {f: float(r.choice([0.5, 1.0, 2.0, 3.0])) for f in ring}
    quantum = float(r.choice([1e-4, 5e-4, 2e-3]))
    costs = {f: float(r.random() * 4e-3 + 1e-4) for f in ring}
    bound = tpolicy.drr_skip_bound(len(ring), max(costs.values()), quantum,
                                   min(weights.values()))
    assert bound == jpolicy.drr_skip_bound(len(ring), max(costs.values()),
                                           quantum, min(weights.values()))
    dt, dj = {f: 0.0 for f in ring}, {f: 0.0 for f in ring}
    ct = cj = 0
    skips = {f: 0 for f in ring}
    for _ in range(300):
        heads = {f: costs[f] for f in ring if r.random() < 0.7}
        gt = tpolicy.drr_grant(ring, ct, dt, weights, quantum, heads)
        gj = jpolicy.drr_grant(ring, cj, dj, weights, quantum, heads)
        assert gt == gj and dt == dj
        flow, ct, _ = gt
        cj = gj[1]
        if flow is None:
            assert not heads
            continue
        tpolicy.drr_charge(dt, flow, heads[flow])
        jpolicy.drr_charge(dj, flow, heads[flow])
        assert dt == dj
        skips[flow] = 0
        for other in heads:
            if other != flow:
                skips[other] += 1
                assert skips[other] <= bound
        for f in ring:
            if f not in heads:
                skips[f] = 0


def test_drr_deterministic_deficit_accounting():
    """The JAX suite's walk (weights 2:1, quantum 1 s, heads 3 s) in both
    packages: the same grants, scans and balances at every step."""
    for pol in (tpolicy, jpolicy):
        ring, weights = ["a", "b"], {"a": 2.0, "b": 1.0}
        deficits = {"a": 0.0, "b": 0.0}
        heads = {"a": 3.0, "b": 3.0}
        assert pol.drr_grant(ring, 0, deficits, weights, 1.0, heads) == \
            ("a", 0, 1)
        assert deficits == {"a": 4.0, "b": 2.0}
        pol.drr_charge(deficits, "a", 3.0)
        assert pol.drr_grant(ring, 0, deficits, weights, 1.0, heads) == \
            ("b", 1, 0)
        pol.drr_charge(deficits, "b", 3.0)
        assert deficits == {"a": 1.0, "b": 0.0}
        assert pol.drr_grant(ring, 1, deficits, weights, 1.0, heads) == \
            ("a", 0, 0)
        deficits["b"] = 7.5
        pol.drr_grant(ring, 0, deficits, weights, 1.0, {"a": 1.0})
        assert deficits["b"] == 0.0
        pol.drr_charge(deficits, "a", 1e9)
        assert deficits["a"] == 0.0
        assert pol.drr_grant(ring, 0, deficits, weights, 1.0, {}) == \
            (None, 0, 0)


def test_drr_unaffordable_raises_with_jax_text():
    errs = []
    for pol in (tpolicy, jpolicy):
        with pytest.raises(RuntimeError) as e:
            pol.drr_grant(["a"], 0, {"a": 0.0}, {"a": 1.0}, 1e-9,
                          {"a": 1.0}, max_rounds=3)
        errs.append(str(e.value))
    assert errs[0] == errs[1]


@pytest.mark.parametrize("args", [(2, 3.0, 1.0, 1.0), (3, 0.016, 0.005, 1.0),
                                  (1, 0.0, 0.001, 2.0), (0, 1e-3, 1e-4, 0.5),
                                  (4, 0.1, 0.0, 1.0)])
def test_drr_skip_bound_equals_jax(args):
    assert tpolicy.drr_skip_bound(*args) == jpolicy.drr_skip_bound(*args)


# -- the GlobalScheduler over the stub engine, both packages ------------------


class _FakeRouter:
    """Router-shaped double: statically live, no cost table (the scheduler
    prices by the 1 ms/row default)."""

    _as_images = staticmethod(StubEngine._as_images)

    def live_version(self):
        return "v1"

    def live_infer_dtype(self):
        return "float32"

    def bucket_costs(self):
        return {}


def _stub_entry(pkg, name, cache=None, metrics=None):
    eng = StubEngine(max_batch=16)
    batcher = pkg.Batcher(eng, max_wait_us=200, queue_depth=4096,
                          metrics=metrics).start()
    return pkg.tenancy.CatalogEntry(
        name=name, registry=None, router=_FakeRouter(),
        factory=types.SimpleNamespace(buckets=eng.buckets,
                                      max_batch=eng.max_batch),
        batcher=batcher, cache=cache)


def _stub_sched(which, spec, entries=("mlp",), caches=None, start=True,
                metrics=None, clock=None, **kw):
    pkg = PKGS[which]
    catalog = pkg.tenancy.ModelCatalog()
    for name in entries:
        catalog.add(_stub_entry(pkg, name,
                                cache=(caches or {}).get(name)))
    if which == "port":
        kw["clock"] = clock or FrozenClock()
    sched = pkg.tenancy.GlobalScheduler(
        catalog, pkg.tenancy.parse_tenants(spec), metrics=metrics,
        quantum_s=0.005, **kw)
    return sched.start() if start else sched


def _by_tenant_counts(snap: dict) -> dict:
    keys = ("requests", "rows", "dispatched_rows", "quota_sheds",
            "watermark_sheds", "deadline_sheds", "shed_rows", "cache_hits",
            "slo_total")
    return {t: {k: s[k] for k in keys}
            for t, s in snap["by_tenant"].items()}


def test_quota_shed_raises_429_with_retry_after():
    """One token then a 429 in each package: the port's Retry-After is the
    bucket's exact refill time on its frozen clock (1/qps), JAX's at most
    that on its own; the same per-tenant counts. The quota refills in
    100 s, longer than the test, so JAX's wall clock cannot refill the
    token before the second request however loaded the host is."""
    out = {}
    for which, pkg in PKGS.items():
        rng = np.random.default_rng(0)
        metrics = pkg.Metrics()
        sched = _stub_sched(which, "gold:qps=0.01,burst=1", metrics=metrics)
        try:
            fut = sched.submit(_rows(rng, 2), tenant="gold")
            assert fut.result(timeout=30).shape == (2, 10)
            with pytest.raises(pkg.tenancy.QuotaExceeded) as ei:
                sched.submit(_rows(rng, 2), tenant="gold")
        finally:
            sched.stop()
        assert ei.value.status == 429
        out[which] = (ei.value.retry_after_s,
                      _by_tenant_counts(metrics.snapshot()))
    assert out["port"][0] == pytest.approx(100.0, abs=1e-12)
    assert 0.0 < out["jax"][0] <= 100.0
    assert out["port"][1] == out["jax"][1]
    assert out["port"][1]["gold"]["quota_sheds"] == 1


def test_unknown_tenant_collapses_into_default():
    snaps = {}
    for which in PKGS:
        rng = np.random.default_rng(0)
        sched = _stub_sched(which, "gold:qps=100")
        try:
            fut = sched.submit(_rows(rng, 1), tenant="nobody-configured")
            assert fut.result(timeout=30).shape == (1, 10)
        finally:
            sched.stop()
        snaps[which] = sched.snapshot()
    for snap in snaps.values():
        assert snap["tenants"]["default"]["granted_rows"] == 1
        assert "nobody-configured" not in snap["tenants"]
    assert snaps["port"]["tenants"] == snaps["jax"]["tenants"]


def test_watermark_shed_raises_503():
    """Not started: submits park in the tenant queue, so the watermark is
    hit without racing the grant loop; the same text and counts."""
    out = {}
    for which, pkg in PKGS.items():
        rng = np.random.default_rng(0)
        metrics = pkg.Metrics()
        sched = _stub_sched(which, "default:qps=1000,burst=64",
                            start=False, metrics=metrics,
                            tenant_queue_rows=4)
        try:
            sched.submit(_rows(rng, 3))
            with pytest.raises(pkg.Rejected, match="watermark") as ei:
                sched.submit(_rows(rng, 3))
            assert sched.queued_rows() == 3
        finally:
            sched.stop(drain=False)
        snap = metrics.snapshot()
        out[which] = (str(ei.value), _by_tenant_counts(snap),
                      snap["rejected_requests"])
    assert out["port"] == out["jax"]
    assert out["port"][1]["default"]["watermark_sheds"] == 1


def test_expired_deadline_shed_504_at_the_door():
    out = {}
    clock = FrozenClock()
    for which, pkg in PKGS.items():
        rng = np.random.default_rng(0)
        metrics = pkg.Metrics()
        sched = _stub_sched(which, "default:", start=False,
                            metrics=metrics, clock=clock)
        try:
            with pytest.raises(pkg.Deadline, match="expired") as ei:
                sched.submit(_rows(rng, 2), deadline_s=clock() - 0.01)
        finally:
            sched.stop(drain=False)
        snap = metrics.snapshot()
        out[which] = (_by_tenant_counts(snap), snap["batches"],
                      snap["resilience"]["deadline_shed_rows"])
    assert out["port"] == out["jax"]
    assert out["port"][0]["default"]["deadline_sheds"] == 1
    assert out["port"][1] == 0
    assert str(ei.value) == ("deadline already expired at admission "
                             "(10.0 ms ago)")


class _FrozenMonotonic:
    """The JAX scheduler module's `time` in a test: monotonic() still at
    `t`, every other attribute the real module's (the grant thread's
    waits are the condition variable's own, on the real clock)."""

    def __init__(self, t: float):
        self.t = t

    def monotonic(self) -> float:
        return self.t

    def __getattr__(self, name):
        return getattr(time, name)


def test_infeasible_head_shed_at_grant_is_504(monkeypatch):
    """A head whose modeled dispatch (2 rows at the 1 ms/row default)
    cannot make a 0.5 ms deadline is shed by EDF at grant, before any
    batch: 504 with the same text in both. Both schedulers read a frozen
    clock (the JAX one through its module's `time`), so a stall between
    taking t0 and the admission's own read cannot expire the deadline at
    the door."""
    out = {}
    for which, pkg in PKGS.items():
        rng = np.random.default_rng(0)
        metrics = pkg.Metrics()
        clock = FrozenClock()
        with monkeypatch.context() as mp:
            if which == "jax":
                mp.setattr(jtenancy, "time", _FrozenMonotonic(clock()))
            sched = _stub_sched(which, "default:", start=False,
                                metrics=metrics, clock=clock)
            fut = sched.submit(_rows(rng, 2), deadline_s=clock() + 5e-4)
            sched.start()
            try:
                with pytest.raises(pkg.Deadline) as ei:
                    fut.result(timeout=30)
            finally:
                sched.stop()
        snap = metrics.snapshot()
        out[which] = (str(ei.value).split(" ms but")[0],
                      _by_tenant_counts(snap), snap["batches"])
    assert out["port"] == out["jax"]
    assert out["port"][0] == ("infeasible: modeled mlp dispatch of 2 rows "
                              "needs 2.0")
    assert out["port"][2] == 0


def test_cache_aware_shed_serves_hit_instead_of_429():
    """An over-quota request whose answer is cached is served, never
    429'd; an over-quota miss is still a 429 and its probe counts no
    miss: the same in both packages."""
    out = {}
    for which, pkg in PKGS.items():
        rng = np.random.default_rng(0)
        cache = pkg.cache.PredictionCache(capacity=16)
        metrics = pkg.Metrics()
        sched = _stub_sched(which, "gold:qps=0.01,burst=1",
                            caches={"mlp": cache}, metrics=metrics)
        x = _rows(rng, 2)
        logits = np.arange(20.0).reshape(2, 10)
        cache.insert(pkg.cache.content_key("v1", "float32",
                                           StubEngine._as_images(x)),
                     logits, "v1", "float32")
        try:
            sched.submit(_rows(rng, 1), tenant="gold").result(timeout=30)
            misses_before = cache.stats()["misses"]
            fut = sched.submit(x, tenant="gold")
            np.testing.assert_array_equal(fut.result(timeout=1), logits)
            with pytest.raises(pkg.tenancy.QuotaExceeded):
                sched.submit(_rows(rng, 2), tenant="gold")
            assert cache.stats()["misses"] == misses_before
        finally:
            sched.stop()
        out[which] = (_by_tenant_counts(metrics.snapshot()),
                      cache.stats())
    assert out["port"] == out["jax"]
    assert out["port"][0]["gold"]["cache_hits"] == 1
    assert out["port"][0]["gold"]["quota_sheds"] == 1


def test_cache_probe_counts_a_hit_like_lookup_and_a_miss_not_at_all():
    for pkg in PKGS.values():
        c = pkg.cache.PredictionCache(capacity=4)
        key = ("v1", "float32", 1, b"k")
        assert c.probe(key) is None
        c.insert(key, np.ones((1, 10)), "v1", "float32")
        assert c.probe(key).shape == (1, 10)
        s = c.stats()
        assert (s["hits"], s["hit_rows"], s["misses"]) == (1, 1, 0)


def _shape(obj):
    """A nested dict's key structure (leaves' types dropped)."""
    if isinstance(obj, dict):
        return {k: _shape(v) for k, v in obj.items()}
    return None


def test_admin_set_quota_live_and_snapshot_shape():
    out = {}
    for which, pkg in PKGS.items():
        rng = np.random.default_rng(0)
        sched = _stub_sched(which, "gold:qps=0.01,burst=1;free:weight=2")
        try:
            sched.submit(_rows(rng, 1), tenant="gold").result(timeout=30)
            with pytest.raises(pkg.tenancy.QuotaExceeded):
                sched.submit(_rows(rng, 1), tenant="gold")
            cls = sched.set_quota("gold", qps=1000.0, burst=8.0)
            futs = [sched.submit(_rows(rng, 1), tenant="gold")
                    for _ in range(4)]
            for f in futs:
                f.result(timeout=30)
            with pytest.raises(KeyError) as ei:
                sched.set_quota("nobody", qps=1.0)
            with pytest.raises(ValueError):
                sched.set_quota("gold", qps=-1.0)
        finally:
            sched.stop()
        snap = sched.snapshot()
        out[which] = (dataclasses.astuple(cls), str(ei.value),
                      _shape(snap), snap["tenants"]["gold"]["granted_rows"],
                      _classes(sched.classes()))
    assert out["port"] == out["jax"]
    assert out["port"][0][1:3] == (1000.0, 8.0)
    assert set(out["port"][2]["tenants"]) == {"gold", "free", "default"}


def test_wfq_grant_shares_track_weights():
    """Two tenants at weights 2:1 on two stub models, 30 requests each:
    every row granted, the same grant and dispatch accounting in both,
    and the observed consecutive-skip maximum within the bound."""
    out = {}
    for which, pkg in PKGS.items():
        rng = np.random.default_rng(0)
        metrics = pkg.Metrics()
        sched = _stub_sched(
            which, "light:qps=10000,burst=256,weight=2,model=mlp;"
            "heavy:qps=10000,burst=256,weight=1,model=lenet",
            entries=("mlp", "lenet"), metrics=metrics)
        try:
            futs = []
            for _ in range(30):
                futs.append(sched.submit(_rows(rng, 2), tenant="light"))
                futs.append(sched.submit(_rows(rng, 2), tenant="heavy"))
            for f in futs:
                assert f.result(timeout=60).shape == (2, 10)
        finally:
            sched.stop()
        snap = sched.snapshot()
        bound = pkg.policy.drr_skip_bound(
            3, 0.016, sched.quantum_s,
            min(c.weight for c in sched.classes().values()))
        assert snap["max_skip_observed"] <= bound
        bt = metrics.snapshot()["by_tenant"]
        out[which] = ({t: s["granted_rows"]
                       for t, s in snap["tenants"].items()},
                      {t: (s["dispatched_rows"], s["dispatch_share"])
                       for t, s in bt.items()},
                      metrics.snapshot()["by_model"])
    assert out["port"] == out["jax"]
    assert out["port"][0] == {"light": 60, "heavy": 60, "default": 0}
    assert out["port"][1]["light"] == (60, 0.5)


def _spans(tracer) -> list:
    return [s for t in tracer.traces() for s in t["spans"]]


def test_queue_wait_span_carries_tenant_tag():
    """The scheduler stamps {tenant, model} on every forwarded request: the
    batcher's queue.wait span carries both and its batch.dispatch span
    the tenants and model; a request submitted to the batcher directly
    keeps the untagged spans. The same tags in both packages."""
    out = {}
    for which, pkg in PKGS.items():
        rng = np.random.default_rng(0)
        tracer = pkg.trace.install(pkg.trace.Tracer(capacity=16,
                                                    sample=1.0))
        sched = _stub_sched(which, "gold:qps=100,burst=8")
        try:
            sched.submit(_rows(rng, 2), tenant="gold").result(timeout=30)
            tagged = _spans(tracer)
            pkg.trace.uninstall()
            tracer_plain = pkg.trace.install(pkg.trace.Tracer(capacity=16,
                                                              sample=1.0))
            entry = sched.catalog.get("mlp")
            entry.batcher.submit(_rows(rng, 2)).result(timeout=30)
            plain = _spans(tracer_plain)
        finally:
            sched.stop()
            pkg.trace.uninstall()
        out[which] = (
            [s["tags"] for s in tagged if s["name"] == "queue.wait"],
            [{k: s["tags"].get(k) for k in ("tenants", "model")}
             for s in tagged if s["name"] == "batch.dispatch"],
            [sorted(s["tags"]) for s in plain
             if s["name"] in ("queue.wait", "batch.dispatch")])
    assert out["port"] == out["jax"]
    assert out["port"][0] == [{"tenant": "gold", "model": "mlp"}]
    assert out["port"][1] == [{"tenants": "gold", "model": "mlp"}]
    assert all("tenant" not in t and "model" not in t
               for t in out["port"][2])


def test_prometheus_tenant_and_model_series():
    """The same recorded tenancy history exposes the same tenant and
    model samples (counters exact; the latency summary's labels)."""
    lines = {}
    for which, pkg in PKGS.items():
        rng = np.random.default_rng(0)
        metrics = pkg.Metrics()
        sched = _stub_sched(which, "gold:qps=0.01,burst=1,deadline_ms=5000",
                            metrics=metrics)
        try:
            sched.submit(_rows(rng, 2), tenant="gold").result(timeout=30)
            with pytest.raises(pkg.tenancy.QuotaExceeded):
                sched.submit(_rows(rng, 1), tenant="gold")
        finally:
            sched.stop()
        text = pkg.prom(metrics.snapshot())
        lines[which] = sorted(
            ln if "latency_ms" not in ln else ln.rsplit(" ", 1)[0]
            for ln in text.splitlines()
            if ln.startswith(("dmnist_serve_tenant_", "dmnist_serve_model_",
                              "# HELP dmnist_serve_tenant_",
                              "# TYPE dmnist_serve_tenant_",
                              "# HELP dmnist_serve_model_",
                              "# TYPE dmnist_serve_model_")))
    assert lines["port"] == lines["jax"]
    text = "\n".join(lines["port"])
    assert 'dmnist_serve_tenant_requests_total{tenant="gold"} 1' in text
    assert ('dmnist_serve_tenant_sheds_total{kind="quota",'
            'tenant="gold"} 1') in text
    assert 'dmnist_serve_model_requests_total{model="mlp"} 1' in text
    assert ('dmnist_serve_tenant_latency_ms{quantile="0.99",'
            'tenant="gold"}') in text


def test_scheduler_refuses_bad_boot():
    errs = {}
    for which, pkg in PKGS.items():
        catalog = pkg.tenancy.ModelCatalog()
        catalog.add(_stub_entry(pkg, "mlp"))
        try:
            with pytest.raises(KeyError) as bad_model:
                pkg.tenancy.GlobalScheduler(
                    catalog, pkg.tenancy.parse_tenants("a:model=nope"))
            with pytest.raises(ValueError, match="quantum") as bad_q:
                pkg.tenancy.GlobalScheduler(
                    catalog, pkg.tenancy.parse_tenants(""), quantum_s=0.0)
            with pytest.raises(ValueError) as twice:
                catalog.add(_stub_entry(pkg, "mlp"))
        finally:
            catalog.stop(drain=False)
        errs[which] = (str(bad_model.value), str(bad_q.value),
                       str(twice.value))
    assert errs["port"] == errs["jax"]


def test_submit_after_stop_refused():
    for which in PKGS:
        sched = _stub_sched(which, "default:")
        sched.stop()
        with pytest.raises(RuntimeError, match="stopped"):
            sched.submit(_rows(np.random.default_rng(0), 1))


def test_dead_grant_thread_fails_waiters_and_stop(monkeypatch):
    """A skip bound the grants break (0, so the first grant with two
    backlogged tenants asserts) kills the grant thread: its queued
    requests fail with the AssertionError, a later submit is refused,
    and stop() raises, so no test or chip phase can miss it."""
    monkeypatch.setattr(tpolicy, "drr_skip_bound", lambda *a: 0)
    rng = np.random.default_rng(0)
    sched = _stub_sched("port", "a:weight=1;b:weight=1", start=False)
    futs = [sched.submit(_rows(rng, 2), tenant=t) for t in ("a", "b")]
    sched.start()
    errors = []
    for f in futs:
        errors.append(f.exception(timeout=30))
    assert any(isinstance(e, AssertionError) and "WFQ starvation" in str(e)
               for e in errors)
    assert isinstance(sched.failure, AssertionError)
    with pytest.raises(RuntimeError, match="grant thread died"):
        sched.submit(_rows(rng, 1), tenant="a")
    with pytest.raises(RuntimeError, match="grant thread died"):
        sched.stop()


def test_model_ckpt_dir_and_catalog_errors_equal_jax():
    assert ttenancy._model_ckpt_dir("/ck", "lenet") == \
        jtenancy._model_ckpt_dir("/ck", "lenet")
    assert ttenancy._model_ckpt_dir(None, "mlp") is None
    errs = []
    for pkg in PKGS.values():
        with pytest.raises(KeyError) as e:
            pkg.tenancy.ModelCatalog().get("mlp")
        errs.append(str(e.value))
    assert errs[0] == errs[1]


# -- real MLP and LeNet-5 catalog entries -----------------------------------


TENANTS = ("light:qps=10000,burst=256,weight=2,model=mlp;"
           "heavy:qps=10000,burst=256,weight=1,model=lenet")
SIZES = (1, 3, 7, 8, 12, 16, 5, 2)


def _port_builds(catalog) -> int:
    return kernel_lib.load_events() + sum(e.factory.engine_builds
                                          for e in catalog.entries())


def test_two_model_catalog_zero_steady_state_builds():
    """MLP and LeNet-5 resident in one process, tenant traffic interleaved
    through the scheduler: no engine or kernel-library build after each
    model's warmup in the port (no compile event in JAX's, on the same
    script), and the same grant, per-model and per-tenant accounting."""
    from distributedmnist_tpu.config import Config as JConfig
    from distributedmnist_tpu.utils import CompileCounter

    out = {}
    for which, pkg in PKGS.items():
        rng = np.random.default_rng(0)
        if which == "jax":
            cfg = JConfig(device="cpu", num_devices=1, synthetic=True,
                          model="mlp", serve_models="mlp,lenet",
                          serve_tenants=TENANTS, serve_max_batch=16,
                          serve_max_wait_us=500, log_every=0)
            builds = CompileCounter.instance().snapshot
        else:
            cfg = tconfig.Config(device="cpu", model="mlp",
                                 serve_models="mlp,lenet",
                                 serve_tenants=TENANTS, serve_max_batch=16,
                                 serve_max_wait_us=500)
        metrics = pkg.Metrics()
        catalog, sched = pkg.tenancy.build_tenancy(cfg, metrics=metrics)
        if which == "port":
            def builds(catalog=catalog):
                return _port_builds(catalog)
        try:
            for name in catalog.names():
                catalog.ensure_live(name, seed=cfg.seed)
            assert catalog.names() == ["mlp", "lenet"]
            assert all(e.resident() for e in catalog.entries())
            before = builds()
            futs = []
            for n in SIZES * 2:
                futs.append((n, sched.submit(_rows(rng, n),
                                             tenant="light")))
                futs.append((n, sched.submit(_rows(rng, n),
                                             tenant="heavy")))
            for n, f in futs:
                assert f.result(timeout=120).shape == (n, 10)
        finally:
            sched.stop()
        assert builds() - before == 0, which
        snap, s = sched.snapshot(), metrics.snapshot()
        out[which] = (
            {t: v["granted_rows"] for t, v in snap["tenants"].items()},
            {m: (v["live_version"], v["resident"], v["buckets"])
             for m, v in snap["models"].items()},
            s["by_model"], _by_tenant_counts(s), _shape(snap))
    assert out["port"] == out["jax"]
    rows = sum(SIZES) * 2
    assert out["port"][0] == {"light": rows, "heavy": rows, "default": 0}
    assert out["port"][2]["lenet"]["dispatched_rows"] == rows


def _save(directory, params, step):
    ck = Checkpointer(str(directory))
    ck.save(step, {"params": params, "optimizer": {}, "scheduler": {}})
    ck.close()


@pytest.fixture(scope="module")
def catalog_models(tmp_path_factory):
    """A checkpoint base with the fitted MLP under mlp/ (its int8 variant
    clears the gate) and a seeded LeNet-5 under lenet/, one subtree a
    model."""
    from torch_fit_util import fit_params

    base = tmp_path_factory.mktemp("catalog")
    mlp, lenet = fit_params(), models.init_params("lenet", 3)
    _save(base / "mlp", mlp, 11)
    _save(base / "lenet", lenet, 22)
    return {"base": str(base), "mlp": mlp, "lenet": lenet}


def test_catalog_models_answer_as_their_routers_and_jax(catalog_models):
    """`--serve-infer-dtype int8` over the two subtrees: the MLP goes live
    at int8, and LeNet, put back at float32 through its own registry,
    serves float32. Every answer of
    a mixed stream through the scheduler is its model's own router's
    dispatch of the same rows (int8 bit for bit, float32 at 1e-5), the
    MLP's bit for bit JAX's plain int8 reference on its own prepared
    weights, LeNet's within 1e-5 of JAX's float32 engine."""
    import jax
    import jax.numpy as jnp

    from distributedmnist_tpu import models as jmodels
    from distributedmnist_tpu.ops import fused as jfused
    from distributedmnist_tpu.parallel import make_mesh
    from distributedmnist_tpu.serve import quantize as jquantize
    from distributedmnist_tpu.serve.engine import \
        InferenceEngine as JInferenceEngine
    from distributedmnist_tpu_torch.models.lenet import LAYERS
    from torch_fit_util import mlp_flax

    cfg = tconfig.Config(device="cpu", model="mlp",
                         serve_models="mlp,lenet", serve_tenants=TENANTS,
                         serve_max_batch=16, serve_max_wait_us=500,
                         serve_infer_dtype="int8",
                         checkpoint_dir=catalog_models["base"])
    catalog, sched = ttenancy.build_tenancy(cfg)
    rng = np.random.default_rng(9)
    reqs = [(t, _rows(rng, int(n))) for n in rng.integers(1, 17, 24)
            for t in ("light", "heavy")]
    try:
        for name in catalog.names():
            catalog.ensure_live(name, seed=cfg.seed,
                                infer_dtype=cfg.serve_infer_dtype)
        assert catalog.describe()["mlp"]["live_infer_dtype"] == "int8"
        # LeNet back at float32 through its own registry: the catalog's
        # models keep their own lifecycles
        catalog.get("lenet").registry.promote("step-22",
                                              infer_dtype="float32")
        assert catalog.describe()["lenet"]["live_infer_dtype"] == "float32"
        for name, step in (("mlp", 11), ("lenet", 22)):
            mv = catalog.get(name).registry.get(f"step-{step}")
            assert mv.source == "checkpoint " + catalog_models["base"] \
                + f"/{name}"
        futs = [(t, x, sched.submit(x, tenant=t)) for t, x in reqs]
        got = [(t, x, f.result(timeout=120)) for t, x, f in futs]
        own = {"light": catalog.get("mlp").router,
               "heavy": catalog.get("lenet").router}
        for t, x, out in got:
            want = own[t].infer(x)
            if t == "light":
                assert out.tobytes() == want.tobytes()
            else:
                np.testing.assert_allclose(out, want, rtol=1e-5, atol=1e-5)
    finally:
        sched.stop()
    # the MLP's int8 against JAX's plain reference on its own preparation
    x = np.concatenate([x for t, x, _ in got if t == "light"])
    mlp_out = np.concatenate([o for t, _, o in got if t == "light"])
    jm = jmodels.build("mlp", fused="xla", platform="cpu")
    p, _ = jquantize.prepare_inference(
        jm, mlp_flax(catalog_models["mlp"], fused=True), "int8",
        jfused.PALLAS_INTERPRET)
    xc = jquantize._center_pixels(jnp.asarray(x.reshape(len(x), -1)))
    h = jfused.quant_dense_reference(xc, p["w1q"], p["s1"], p["b1"],
                                     relu=True)
    hq = jquantize.quantize_act_static(h, p["act_scale"])
    want = np.asarray(jfused.quant_dense_reference(
        hq, p["w2q"], p["s2"] * p["act_scale"], p["b2"], relu=False))
    assert mlp_out.tobytes() == want.tobytes()
    # LeNet's float32 against JAX's engine on the same weights
    flax = {name: {leaf: catalog_models["lenet"][f"{name}.{leaf}"].numpy()
                   for leaf in ("kernel", "bias")}
            for name, _, _ in LAYERS}
    jengine = JInferenceEngine(jmodels.build("lenet", platform="cpu"), flax,
                               make_mesh(jax.devices()[:1]), max_batch=16)
    for t, x, out in got:
        if t == "heavy":
            ref = np.asarray(jengine.infer(x))
            scale = max(1.0, float(np.abs(ref).max()))
            np.testing.assert_allclose(out, ref, rtol=1e-5,
                                       atol=1e-5 * scale)


def test_lenet_megakernel_refused_and_float32_kept_like_jax():
    """ensure_live at megakernel: the MLP goes live on it, LeNet has none,
    so its activation is refused, logged, and float32 stays live, as the
    JAX catalog's ensure_live keeps it."""
    cfg = tconfig.Config(device="cpu", model="mlp",
                         serve_models="lenet,mlp", serve_max_batch=8)
    catalog = ttenancy.build_catalog(cfg)
    try:
        assert catalog.default() == "lenet"
        for name in catalog.names():
            entry = catalog.ensure_live(name, infer_dtype="megakernel")
            assert entry.resident()
            again = catalog.ensure_live(name, infer_dtype="megakernel")
            assert again is entry             # idempotent
        assert catalog.describe()["lenet"]["live_infer_dtype"] == "float32"
        assert catalog.describe()["mlp"]["live_infer_dtype"] in (
            "megakernel", "float32")
        assert set(catalog.describe()["mlp"]) == {
            "resident", "live_version", "live_infer_dtype", "buckets",
            "max_batch", "warmup_s", "warmup_compile_events",
            "pending_rows"}
    finally:
        catalog.stop()


def test_scheduled_warm_path_boots_cold_model():
    """A submit routed at a cold model does not fail: the scheduler prices
    the warmup, schedules it on its warm thread, and dispatches once the
    model is live."""
    cfg = tconfig.Config(device="cpu", model="mlp", serve_models="mlp",
                         serve_tenants="", serve_max_batch=16,
                         serve_max_wait_us=500)
    catalog, sched = ttenancy.build_tenancy(cfg)
    try:
        assert not catalog.get("mlp").resident()
        assert sched.snapshot()["warming"] == []
        fut = sched.submit(_rows(np.random.default_rng(0), 4))
        assert fut.result(timeout=120).shape == (4, 10)
        assert catalog.get("mlp").resident()
        assert sched.snapshot()["warming"] == []
        assert catalog.describe()["mlp"]["warmup_s"] is not None
    finally:
        sched.stop()


def test_catalog_factories_own_a_stream_only_on_the_card():
    """build_catalog asks each model's factory for a stream of its own;
    on the CPU there is none, and the single-model path asks for none."""
    cfg = tconfig.Config(device="cpu", serve_models="mlp,lenet",
                         serve_max_batch=8)
    catalog = ttenancy.build_catalog(cfg)
    try:
        assert [e.factory.replica_streams for e in catalog.entries()] == \
            [[[None]], [[None]]]
    finally:
        catalog.stop()
