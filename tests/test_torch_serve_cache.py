"""The port's prediction cache, single-flight front and intra-batch dedup
against the JAX package's, on the CPU.

The same request script runs through both packages' CacheFront +
DynamicBatcher(dedup=True) over one stub router class (the JAX suite's:
its logits are the rows' own pixels, offset per version, so a stale byte
is visible by value) and one injected clock for the TTL: equal hit,
miss, collapse, insert, evict, expire and invalidation counters, equal
engine dispatch logs, and identical bytes — exact, since the stub's
logits are computed the same way in both. The script covers promote,
rollback and TTL expiry. Then both packages' real registries and engines
on the same weights: every live-route change invalidates alike, the
counters agree exactly, hits are byte-identical to the computed response
within each package, and the two packages' logits agree at float32
tolerance (rtol=1e-5, atol=1e-5, the serving slice's).
"""

import threading
from concurrent.futures import Future
from types import SimpleNamespace

import jax
import numpy as np
import pytest

from distributedmnist_tpu.serve import batcher as jbatcher
from distributedmnist_tpu.serve import cache as jcache
from distributedmnist_tpu.serve import metrics as jmetrics
from distributedmnist_tpu_torch import interop
from distributedmnist_tpu_torch.serve import batcher as tbatcher
from distributedmnist_tpu_torch.serve import cache as tcache
from distributedmnist_tpu_torch.serve import metrics as tmetrics
from distributedmnist_tpu_torch.serve import (DeadlineExceeded,
                                              EngineFactory, ModelRegistry,
                                              content_key)
from tests.test_serve_cache import StubRouter

PKGS = {"jax": SimpleNamespace(b=jbatcher, c=jcache, m=jmetrics),
        "torch": SimpleNamespace(b=tbatcher, c=tcache, m=tmetrics)}


class _Clock:
    """An injected monotonic clock for the cache's TTL."""

    def __init__(self, t: float = 1000.0):
        self.t = t

    def monotonic(self) -> float:
        return self.t


def _rows(rng, n):
    return rng.integers(0, 256, (n, 28, 28, 1)).astype(np.uint8)


# -- PredictionCache ----------------------------------------------------------


def test_content_key_equals_jax():
    r = np.random.default_rng(0)
    for n in (1, 2, 7):
        x = _rows(r, n)
        assert content_key("v1", "int8", x) == jcache.content_key("v1",
                                                                   "int8", x)
        assert content_key("v1", "int8", x) != content_key("v2", "int8", x)
        # C-order bytes of the (n, 28, 28, 1) image: the same key for the
        # (n, 784) view
        assert content_key(None, None, x) == content_key(
            None, None, x.reshape(n, 784))


@pytest.mark.parametrize("name", ["torch", "jax"])
def test_lru_insert_checks_and_validation(name):
    c = PKGS[name].c.PredictionCache(capacity=2)
    keys = [content_key("v1", "float32", np.full((1, 784), i, np.uint8))
            for i in range(3)]
    for k in keys[:2]:
        assert c.insert(k, np.ones((1, 10)), "v1", "float32")
    assert c.lookup(keys[0]) is not None       # refresh 0
    assert c.insert(keys[2], np.ones((1, 10)), "v1", "float32")
    assert c.lookup(keys[1]) is None           # 1 was LRU: evicted
    assert not c.insert(keys[0], np.ones((1, 10)), "v2", "float32")
    assert not c.insert(keys[0], np.ones((1, 10)), "v1", "float32",
                        epoch=c.epoch() + 1)
    c.invalidate("test")
    assert c.stats()["entries"] == 0 and c.epoch() == 1
    s = c.stats()
    assert (s["evictions"], s["stale_drops"], s["invalidations"]) == (1, 2, 1)
    for kw in ({"capacity": 0}, {"capacity": 4, "ttl_s": 0.0}):
        with pytest.raises(ValueError):
            PKGS[name].c.PredictionCache(**kw)


# -- the same script through both fronts ---------------------------------------


def _script(pkg, monkeypatch) -> dict:
    """Sequential requests (each waited on) through CacheFront +
    DynamicBatcher(dedup=True) over the stub router: repeats (hits), a
    capacity of 4 (evictions), a TTL of 10 s on the injected clock
    (expiry), a promote to v2 and a rollback to v1 (invalidations)."""
    clock = _Clock()
    monkeypatch.setattr(pkg.c, "time", clock)
    router = StubRouter(max_batch=16)
    m = pkg.m.ServeMetrics()
    b = pkg.b.DynamicBatcher(router, max_wait_us=0, queue_depth=256,
                             metrics=m, dedup=True).start()
    cache = pkg.c.PredictionCache(capacity=4, ttl_s=10.0)
    front = pkg.c.CacheFront(b, router, cache, metrics=m)
    r = np.random.default_rng(7)
    keys = [_rows(r, int(n)) for n in r.integers(1, 4, 6)]
    out = []

    def ask(i):
        f = front.submit(keys[i])
        out.append((i, f.result(timeout=10).tobytes(), f.version,
                    bool(getattr(f, "cache_hit", False))))

    try:
        for i in (0, 1, 0, 2, 3, 1, 4, 0, 5, 5, 2):
            ask(i)
        clock.t += 11.0                       # every entry ages out
        for i in (5, 5, 4):
            ask(i)
        router.set_live_route("v2")           # a promote
        cache.invalidate("live -> v2")
        for i in (5, 5, 0):
            ask(i)
        router.set_live_route("v1")           # a rollback
        cache.invalidate("live -> v1")
        for i in (0, 1, 1):
            ask(i)
        stats = cache.stats()
    finally:
        b.stop()
    snap = m.snapshot()
    return {"stats": stats, "calls": list(router.calls), "out": out,
            "cache_served": snap["cache_served"], "dedup": snap["dedup"],
            "requests": snap["requests"]}


def test_cache_script_equals_jax(monkeypatch):
    ours = _script(PKGS["torch"], monkeypatch)
    assert ours == _script(PKGS["jax"], monkeypatch)
    s = ours["stats"]
    assert s["hits"] == 6 and s["expired"] == 2 and s["evictions"] >= 1
    assert s["invalidations"] == 2
    # a hit's bytes are the computed response's, under the same version
    first = {}
    for i, raw, version, hit in ours["out"]:
        if hit:
            assert first[(i, version)] == raw
        first.setdefault((i, version), raw)
    # v2's bytes differ by the stub's per-version offset: never stale
    v1 = [raw for i, raw, v, _ in ours["out"] if i == 0 and v == "v1"]
    v2 = [raw for i, raw, v, _ in ours["out"] if i == 0 and v == "v2"]
    assert v1 and v2 and v1[0] != v2[0]


@pytest.mark.parametrize("name", ["torch", "jax"])
def test_front_sheds_expired_and_passes_through_without_live(name, rng):
    import time

    pkg = PKGS[name]
    router = StubRouter(max_batch=16)
    b = pkg.b.DynamicBatcher(router, max_wait_us=0).start()
    front = pkg.c.CacheFront(b, router, pkg.c.PredictionCache(4))
    try:
        with pytest.raises(Exception) as e:
            front.submit(_rows(rng, 1), deadline_s=time.monotonic() - 1)
        assert type(e.value).__name__ == "DeadlineExceeded"
        router.set_live_route(None)
        f = front.submit(_rows(rng, 2))
        assert f.result(timeout=10).shape == (2, 10)
        assert front.cache.stats()["misses"] == 0    # nothing keyed
    finally:
        b.stop()


def _single_flight(pkg, fail: bool):
    """N concurrent identical misses behind a held leader: one dispatch;
    on a leader failure every follower fails with its error, and nothing
    is cached (the next identical request elects a new leader)."""

    class Failing(StubRouter):
        def dispatch(self, x):
            h = super().dispatch(x)
            if fail and len(self.calls) == 1:
                raise RuntimeError("leader died")
            return h

    gate = threading.Event()
    router = Failing(max_batch=16, gate=gate)
    m = pkg.m.ServeMetrics()
    b = pkg.b.DynamicBatcher(router, max_wait_us=0, metrics=m).start()
    front = pkg.c.CacheFront(b, router, pkg.c.PredictionCache(8), metrics=m)
    x = np.full((2, 28, 28, 1), 9, np.uint8)
    outcomes = []
    try:
        futs = [front.submit(x) for _ in range(5)]
        gate.set()
        for f in futs:
            try:
                outcomes.append(f.result(timeout=10).tobytes())
            except RuntimeError as e:
                outcomes.append(str(e))
        again = front.submit(x).result(timeout=10).tobytes()
    finally:
        b.stop()
    s = front.cache.stats()
    return (outcomes, again, list(router.calls),
            {k: s[k] for k in ("hits", "misses", "collapsed", "inserts",
                               "inflight_keys")},
            [bool(getattr(f, "collapsed", False)) for f in futs])


@pytest.mark.parametrize("fail", [False, True])
def test_single_flight_equals_jax(fail):
    ours = _single_flight(PKGS["torch"], fail)
    assert ours == _single_flight(PKGS["jax"], fail)
    outcomes, again, calls, stats, collapsed = ours
    assert collapsed == [False, True, True, True, True]
    assert stats["collapsed"] == 4 and stats["inflight_keys"] == 0
    if fail:
        assert outcomes == ["leader died"] * 5
        assert calls == [2, 2] and stats["inserts"] == 1  # re-elected
    else:
        assert len(set(outcomes)) == 1 and again == outcomes[0]
        assert calls == [2] and stats["hits"] == 1


def _dedup_drain(pkg, dedup: bool, fail: bool = False):
    class Stub(StubRouter):
        def dispatch(self, x):
            if fail and self.calls:
                self.calls.append(-1)
                raise RuntimeError("poisoned drain")
            return super().dispatch(x)

    gate = threading.Event()
    eng = Stub(max_batch=16, gate=gate)
    m = pkg.m.ServeMetrics()
    b = pkg.b.DynamicBatcher(eng, max_wait_us=50_000, queue_depth=256,
                             metrics=m, dedup=dedup).start()
    r = np.random.default_rng(3)
    out = []
    try:
        first = b.submit(_rows(r, 1))
        assert eng.in_call.wait(timeout=10)
        a, bb = _rows(r, 3), _rows(r, 2)
        futs = [b.submit(a), b.submit(a.copy()), b.submit(bb)]
        gate.set()
        first.result(timeout=10)
        for f in futs:
            try:
                out.append(f.result(timeout=10).tobytes())
            except RuntimeError as e:
                out.append(str(e))
    finally:
        b.stop()
    snap = m.snapshot()
    return out, list(eng.calls), snap["dedup"], snap["requests"]


@pytest.mark.parametrize("dedup,fail", [(True, False), (False, False),
                                        (True, True)])
def test_intra_batch_dedup_equals_jax(dedup, fail):
    ours = _dedup_drain(PKGS["torch"], dedup, fail)
    assert ours == _dedup_drain(PKGS["jax"], dedup, fail)
    out, calls, dd, _ = ours
    if fail:
        assert out == ["poisoned drain"] * 3       # riders share it
    elif dedup:
        assert calls == [1, 5] and dd == {"requests": 1, "rows": 3}
        assert out[0] == out[1]
    else:
        assert calls == [1, 8] and dd == {"requests": 0, "rows": 0}


# -- real registries and engines, both packages ----------------------------


def _real_script(reg, router, batcher_mod, cache_mod, metrics_mod, x):
    cache = cache_mod.PredictionCache(capacity=8)
    reg.set_cache(cache)
    m = metrics_mod.ServeMetrics()
    b = batcher_mod.DynamicBatcher(router, max_wait_us=0, metrics=m,
                                   dedup=True).start()
    front = cache_mod.CacheFront(b, router, cache, metrics=m)
    out = []
    try:
        reg.promote("v1")
        for i in (0, 1, 0, 0, 2):
            out.append(("v1", front.submit(x[i]).result(timeout=30)))
        reg.promote("v2")
        for i in (0, 0):
            out.append(("v2", front.submit(x[i]).result(timeout=30)))
        assert reg.rollback("v2", "test rollback").version == "v1"
        for i in (1, 1):
            out.append(("v1", front.submit(x[i]).result(timeout=30)))
        reg.set_shadow("v2", 0.5)             # no live change: no flush
    finally:
        b.stop()
        reg.set_cache(None)
    return out, cache.stats()


def test_real_registries_invalidate_and_count_like_jax(eight_devices):
    from distributedmnist_tpu import models as jmodels
    from distributedmnist_tpu.parallel import make_mesh
    from distributedmnist_tpu.serve import registry as jregistry

    jf = jregistry.EngineFactory(jmodels.build("mlp", platform="cpu"),
                                 make_mesh(eight_devices[:1]), max_batch=4)
    jreg = jregistry.ModelRegistry(jf, jf.make_router())
    tf = EngineFactory("mlp", device="cpu", max_batch=4)
    treg = ModelRegistry(tf, tf.make_router())
    for seed, v in ((0, "v1"), (1, "v2")):
        p = jf.init_params(seed)
        jreg.add(p, version=v)
        treg.add(interop.mlp_params_from_flax(
            jax.tree.map(np.asarray, p)), version=v)
    r = np.random.default_rng(5)
    x = [_rows(r, n) for n in (1, 2, 3)]
    ours, ts = _real_script(treg, treg.router, tbatcher, tcache, tmetrics, x)
    ref, js = _real_script(jreg, jreg.router, jbatcher, jcache, jmetrics, x)
    drop = {"ttl_s", "expired", "capacity"}
    assert {k: v for k, v in ts.items() if k not in drop} == \
        {k: v for k, v in js.items() if k not in drop}
    assert ts["invalidations"] == 3 and ts["hits"] == 4
    for (va, a), (vb, b) in zip(ours, ref):
        assert va == vb
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    # a hit is the computed response's bytes, exactly
    assert ours[2][1].tobytes() == ours[0][1].tobytes()
    assert ours[6][1].tobytes() == ours[5][1].tobytes()


def test_front_ttl_hit_recomputes_with_a_fake_batcher(monkeypatch):
    clock = _Clock()
    monkeypatch.setattr(tcache, "time", clock)

    class _Route:
        _as_images = staticmethod(lambda x: np.asarray(x, np.uint8))

        def live_route(self):
            return ("v1", "float32")

    class _Batcher:
        submits = 0

        def next_rid(self):
            return 1

        def submit(self, x, deadline_s=None, key=None):
            _Batcher.submits += 1
            f = Future()
            f.trace_id, f.version = None, "v1"
            f.set_result(np.full((x.shape[0], 10), 2.0, np.float32))
            return f

    cache = tcache.PredictionCache(8, ttl_s=0.05)
    front = tcache.CacheFront(_Batcher(), _Route(), cache)
    x = np.zeros((1, 784), np.uint8)
    front.submit(x).result(timeout=5)
    front.submit(x).result(timeout=5)
    assert _Batcher.submits == 1
    clock.t += 0.06
    front.submit(x).result(timeout=5)
    assert _Batcher.submits == 2 and cache.stats()["expired"] == 1


def test_build_cache_front_wires_the_registry():
    from distributedmnist_tpu_torch.config import Config

    tf = EngineFactory("mlp", device="cpu", max_batch=4)
    router = tf.make_router()
    reg = ModelRegistry(tf, router)
    b = tbatcher.DynamicBatcher(router)
    assert tcache.build_cache_front(Config(), b, router, reg) == (b, None)
    front, cache = tcache.build_cache_front(
        Config(serve_cache=True, serve_cache_capacity=3,
               serve_cache_ttl_s=2.0), b, router, reg)
    assert isinstance(front, tcache.CacheFront)
    assert cache.capacity == 3 and cache.ttl_s == 2.0
    assert reg._cache is cache
    with pytest.raises(DeadlineExceeded):
        front.submit(np.zeros((1, 784), np.uint8), deadline_s=0.0)
