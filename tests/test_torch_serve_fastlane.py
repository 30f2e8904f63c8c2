"""The port's fast lane — the engine's resident routes (dispatch_fast:
exact fit and row-staged), the router's dispatch_fast and the batcher's
lane — against the JAX package's rules and its own coalesced path, on
the CPU.

Held against JAX exactly: the row-route rung (fast_row_bucket over a
grid of ladders), the admission rule (fastlane_eligible), and the lane
decision of every request of one scripted arrival pattern through both
batchers (one stub engine class, gated), with the lane fraction the
metrics report. Held against the port's own coalesced path bit for bit
(the same forward at bucket 1, so equality is exact): the fast lane's
logits on the MLP at float32, bfloat16, int8 and megakernel and LeNet-5
at float32, bfloat16 and int8 (their plain versions on the CPU), and
the row-staged route on a dirty resident buffer against the pooled
dispatch. Explored with the port's schedule explorer: a metrics.reset()
racing the lane or the coalesced path never opens a window that holds
part of one dispatch's records, and the explorer finds that split when
the records are made one at a time, as the JAX package makes them.
"""

import threading
import time

import numpy as np
import pytest

from distributedmnist_tpu.serve import batcher as jbatcher
from distributedmnist_tpu.serve import engine as jengine
from distributedmnist_tpu.serve import metrics as jmetrics
from distributedmnist_tpu.serve import scheduler as jscheduler
from distributedmnist_tpu_torch import models
from distributedmnist_tpu_torch.analysis import explore as texplore
from distributedmnist_tpu_torch.analysis import harnesses as tharnesses
from distributedmnist_tpu_torch.serve import batcher as tbatcher
from distributedmnist_tpu_torch.serve import engine as tengine
from distributedmnist_tpu_torch.serve import metrics as tmetrics
from distributedmnist_tpu_torch.serve import scheduler as tscheduler
from distributedmnist_tpu_torch.serve import trace as ttrace
from distributedmnist_tpu_torch.serve import (DeadlineExceeded,
                                              DynamicBatcher, EngineFactory,
                                              InferenceEngine, ModelRegistry,
                                              NoLiveModel, Router,
                                              ServeMetrics)
from tests.test_serve_batcher import StubEngine
from torch_sanitize_util import torch_serve_sanitizer  # noqa: F401


def _rows(rng, n):
    return rng.integers(0, 256, (n, 28, 28, 1)).astype(np.uint8)


@pytest.fixture(scope="module")
def mlp_params():
    return models.init_params("mlp", 3)


@pytest.fixture(scope="module")
def lenet_params():
    return models.init_params("lenet", 3)


# -- the rules, against JAX ---------------------------------------------------


def test_fast_row_bucket_equals_jax():
    assert tengine.FASTLANE_MAX_BUCKET == jengine.FASTLANE_MAX_BUCKET
    for lo in (1, 2, 3, 4, 8, 16, 32, 33, 64):
        for n in (1, 2, 4):
            ladder = [lo * 2 ** i for i in range(n)]
            assert (tengine.fast_row_bucket(ladder)
                    == jengine.fast_row_bucket(ladder))
    assert tengine.fast_row_bucket((1, 2, 4)) is None
    assert tengine.fast_row_bucket((8, 16)) == 8


def test_fastlane_eligible_equals_jax():
    for enabled in (False, True):
        for rows in (0, 1, 7):
            assert (tscheduler.fastlane_eligible(enabled, rows)
                    == jscheduler.fastlane_eligible(enabled, rows))
    assert tscheduler.fastlane_eligible(True, 0)


def _lane_script(bmod, mmod):
    """The lane decision (future already resolved when submit returns)
    of each request of one arrival pattern: three lone requests; one
    lone request held in its fetch on another thread while two more
    arrive (no free slot: they coalesce); two lone requests after."""
    gate = threading.Event()
    gate.set()
    eng = StubEngine(max_batch=16, gate=gate)
    m = mmod.ServeMetrics()
    b = bmod.DynamicBatcher(eng, fastlane=True, max_inflight=1,
                            max_wait_us=0, metrics=m).start()
    r = np.random.default_rng(1)
    lane = []
    try:
        for _ in range(3):
            f = b.submit(_rows(r, 1))
            lane.append(f.done())
        gate.clear()
        held = {}
        t = threading.Thread(target=lambda: held.setdefault(
            "f", b.submit(_rows(r, 1))))
        t.start()
        for _ in range(200):                  # the holder is in fetch
            if len(eng.calls) == 4:
                break
            time.sleep(0.005)
        queued = [b.submit(_rows(r, 2)) for _ in range(2)]
        lane += [f.done() for f in queued]
        gate.set()
        t.join(10)
        lane.insert(3, held["f"].done())
        for f in queued:
            f.result(timeout=10)
        for _ in range(2):
            f = b.submit(_rows(r, 1))
            lane.append(f.done())
        for _ in range(200):
            if b.inflight_batches() == 0:
                break
            time.sleep(0.005)
    finally:
        b.stop()
    snap = m.snapshot()
    return lane, list(eng.calls), snap["fastpath"]


def test_lane_decisions_equal_jax():
    ours = _lane_script(tbatcher, tmetrics)
    assert ours == _lane_script(jbatcher, jmetrics)
    lane, calls, fp = ours
    assert lane == [True] * 4 + [False, False] + [True, True]
    assert calls == [1, 1, 1, 1, 4, 1, 1]     # the pair coalesced
    assert fp == {"dispatches": 6, "rows": 6, "lane_fraction": 0.75}


def test_controller_keeps_fastpath_out_of_the_rate_like_jax():
    ours = tscheduler.AdaptiveController(1e-3, max_batch=8)
    ref = jscheduler.AdaptiveController(1e-3, max_batch=8)
    for ctl in (ours, ref):
        for i in range(20):
            ctl.on_arrival(1, now=i * 1e-3, coalesced=bool(i % 2))
    assert ours.snapshot() == ref.snapshot()
    assert ours.snapshot()["fastpath_dispatches"] == 10


# -- the engine's resident routes ---------------------------------------------


@pytest.mark.parametrize("model,dtype", [
    ("mlp", "float32"), ("mlp", "bfloat16"), ("mlp", "int8"),
    ("mlp", "megakernel"), ("lenet", "float32"), ("lenet", "bfloat16"),
    ("lenet", "int8")])
def test_fast_lane_logits_equal_the_coalesced_path(model, dtype, mlp_params,
                                                   lenet_params, rng):
    params = mlp_params if model == "mlp" else lenet_params
    eng = InferenceEngine(model, params, device="cpu", max_batch=8,
                          version="v1", infer_dtype=dtype)
    eng.warmup(cost_samples=1)
    x = _rows(rng, 6)
    lane = DynamicBatcher(eng, fastlane=True).start()
    coal = DynamicBatcher(eng, max_wait_us=0).start()
    try:
        for i in range(6):
            h = eng.dispatch_fast(x[i:i + 1])
            assert h.resident and h.bucket == 1 and h.staging is None
            direct = eng.fetch(h)
            f_lane = lane.submit(x[i:i + 1])
            assert f_lane.done()                       # took the lane
            want = coal.submit(x[i:i + 1]).result(timeout=30)
            assert direct.tobytes() == want.tobytes()
            assert f_lane.result().tobytes() == want.tobytes()
    finally:
        lane.stop()
        coal.stop()


def test_exact_fit_multi_row_and_declines(mlp_params, rng):
    eng = InferenceEngine("mlp", mlp_params, device="cpu", max_batch=8)
    eng.warmup(cost_samples=1)
    x = _rows(rng, 4)                  # n == its bucket: exact fit
    h = eng.dispatch_fast(x)
    assert h.resident and h.bucket == 4
    assert eng.fetch(h).tobytes() == eng.infer(x).tobytes()
    with pytest.raises(RuntimeError, match="already fetched"):
        eng.fetch(h)
    assert eng.dispatch_fast(_rows(rng, 3)) is None   # 3 pads into 4


@pytest.fixture
def row_engine(mlp_params):
    """A ladder whose smallest rung is 8: the row-staged route."""
    eng = InferenceEngine("mlp", mlp_params, device="cpu", max_batch=32,
                          buckets=(8, 16, 32), version="v1")
    eng.warmup(cost_samples=3)
    eng._fast_row_ok = True        # the CPU's price is noise: pin it on
    return eng


def test_row_staged_route_on_a_dirty_buffer(row_engine, rng):
    eng = row_engine
    assert eng._fast_row_b == 8 and eng.fast_row_cost() is not None
    for i in range(5):
        # rows 1..7 hold whatever earlier requests (or this test) left
        eng._fast_row_buf[1:] = torch_randint(rng, eng)
        x = _rows(rng, 1)
        h = eng.dispatch_fast(x)
        assert h.resident and h.bucket == 8
        assert eng.fetch(h).tobytes() == eng.infer(x).tobytes()


def torch_randint(rng, eng):
    import torch

    return torch.from_numpy(rng.integers(
        0, 256, tuple(eng._fast_row_buf[1:].shape)).astype(np.uint8))


def test_busy_row_buffer_returns_none(row_engine, rng):
    eng = row_engine
    assert eng._fast_row_lock.acquire(blocking=False)
    try:
        assert eng.dispatch_fast(_rows(rng, 1)) is None
    finally:
        eng._fast_row_lock.release()
    assert eng.dispatch_fast(_rows(rng, 1)) is not None


def test_cost_gate_turns_the_row_route_off(row_engine, rng):
    eng = row_engine
    eng._warm_fastlane({8: 0.0})       # the pooled dispatch costs nothing
    assert eng._fast_row_ok is False
    assert eng.dispatch_fast(_rows(rng, 1)) is None
    eng._warm_fastlane({8: float("inf")})
    assert eng._fast_row_ok is True


def test_no_row_route_on_a_ladder_from_one(mlp_params):
    eng = InferenceEngine("mlp", mlp_params, device="cpu", max_batch=8)
    eng.warmup(cost_samples=1)
    assert eng._fast_row_b is None and eng._fast_row_buf is None
    assert eng.fast_row_cost() is None


# -- the router -------------------------------------------------------------


def _registry(max_batch=8):
    tf = EngineFactory("mlp", device="cpu", max_batch=max_batch)
    router = tf.make_router()
    reg = ModelRegistry(tf, router)
    for seed, v in ((0, "v1"), (1, "v2")):
        reg.add(tf.init_params(seed), version=v)
    return reg, router


def test_router_dispatch_fast_routes_live_and_declines_candidates(rng):
    reg, router = _registry()
    empty = Router(8, router.buckets, "cpu")
    with pytest.raises(NoLiveModel):
        empty.dispatch_fast(_rows(rng, 1))
    reg.promote("v1")
    rh = router.dispatch_fast(_rows(rng, 1))
    assert rh.version == "v1" and rh.handle.resident
    assert rh.replica is None and rh.infer_dtype == "float32"
    assert router.fetch(rh).shape == (1, 10)
    reg.set_canary("v2", 0.5)
    assert router.dispatch_fast(_rows(rng, 1)) is None
    router.clear_candidates()
    reg.set_shadow("v2", 0.5)
    assert router.dispatch_fast(_rows(rng, 1)) is None
    assert router.live_route() == ("v1", "float32")


# -- the batcher's lane ----------------------------------------------------


def test_lane_off_by_default_and_closed_under_contention(rng):
    b = DynamicBatcher(StubEngine(max_batch=8), max_wait_us=50_000).start()
    try:
        f = b.submit(_rows(rng, 1))
        assert not f.done()             # coalescing: waits its window
        f.result(timeout=10)
    finally:
        b.stop()


class _Fails(StubEngine):
    def __init__(self, where, **kw):
        super().__init__(**kw)
        self.where = where
        self.n = 0

    def dispatch(self, x):
        self.n += 1
        if self.where == "dispatch" and self.n == 1:
            raise RuntimeError("dispatch died")
        return super().dispatch(x)

    def fetch(self, h):
        if self.where == "fetch" and self.n == 1:
            raise RuntimeError("fetch died")
        return super().fetch(h)


@pytest.mark.parametrize("where", ["dispatch", "fetch"])
def test_lane_failure_fails_the_future_and_keeps_serving(where, rng):
    m = ServeMetrics()
    b = DynamicBatcher(_Fails(where, max_batch=8), fastlane=True,
                       metrics=m).start()
    try:
        f = b.submit(_rows(rng, 1))
        with pytest.raises(RuntimeError, match=f"{where} died"):
            f.result(timeout=1)
        assert b.submit(_rows(rng, 2)).result(timeout=1).shape == (2, 10)
        assert b.inflight_batches() == 0
        res = m.snapshot()["resilience"]
        assert res[f"{where}_error_requests"] == 1
    finally:
        b.stop()


def test_lane_sheds_deadlines(rng, monkeypatch):
    b = DynamicBatcher(StubEngine(max_batch=8), fastlane=True).start()
    try:
        with pytest.raises(DeadlineExceeded):
            b.submit(_rows(rng, 1), deadline_s=time.monotonic() - 1)
        # a deadline that passes between admission and the lane's
        # dispatch: the clock jumps inside submit
        real = time.monotonic
        calls = {"n": 0}

        def jumpy():
            calls["n"] += 1
            return real() + (10.0 if calls["n"] > 1 else 0.0)

        monkeypatch.setattr(tbatcher.time, "monotonic", jumpy)
        f = b.submit(_rows(rng, 1), deadline_s=real() + 1.0)
        monkeypatch.setattr(tbatcher.time, "monotonic", real)
        with pytest.raises(DeadlineExceeded, match="fast-lane"):
            f.result(timeout=1)
        assert b.inflight_batches() == 0
        assert b.submit(_rows(rng, 1)).result(timeout=1).shape == (1, 10)
    finally:
        b.stop()


def test_lane_traces_and_stop_resolve_everything(rng):
    tr = ttrace.install(ttrace.Tracer())
    try:
        b = DynamicBatcher(StubEngine(max_batch=8), fastlane=True).start()
        futs = [b.submit(_rows(rng, 1)) for _ in range(5)]
        b.stop()
        assert all(f.done() for f in futs)
        assert len(tr.traces()) == 5
        for t in tr.traces():
            assert {"fastpath", "fastpath.admit", "engine.fetch"} <= {
                s["name"] for s in t["spans"]}
    finally:
        ttrace.uninstall()


def test_lane_through_the_registry_serves_the_live_version(rng):
    reg, router = _registry()
    reg.promote("v2")
    m = ServeMetrics()
    b = DynamicBatcher(router, fastlane=True, metrics=m).start()
    try:
        x = _rows(rng, 1)
        f = b.submit(x)
        assert f.done() and f.version == "v2"
        assert f.result().tobytes() == reg.get("v2").engine.infer(
            x).tobytes()
        snap = m.snapshot()
        assert snap["fastpath"]["dispatches"] == 1
        assert snap["by_dtype"] == {"float32": {"batches": 1, "rows": 1}}
    finally:
        b.stop()


# -- a reset() window never splits one dispatch's records (explored) ---------

# Schedules per machine, and the metrics.reset() calls the resetter makes,
# spread across the client's requests by its sleeps (each a schedule step).
RESET_SCHEDULES = 50
RESETS = 16


class _SplitRecords(ServeMetrics):
    """A served dispatch's records one acquisition at a time, in the
    order the JAX package makes them: the split the machines must find
    when it is planted."""

    def record_served(self, fetch_seconds, rows, bucket, queue_depth,
                      latencies, version=None, replica=None,
                      infer_dtype=None, fastpath=False):
        if fastpath:
            self.record_fastpath(rows)
        self.record_fetch(fetch_seconds)
        self.record_batch(rows, bucket, queue_depth, version, replica,
                          infer_dtype)
        for seconds, n in latencies:
            self.record_latency(seconds, n, version)


class _ResetWindowMachine(tharnesses.FastlaneBatcherMachine):
    """The real DynamicBatcher over the harness engine, with a real
    ServeMetrics: one client submits six 1-row requests (through the
    fast lane when `fastlane`, each a lone request; else without
    waiting, so they coalesce) while a second thread reopens the
    metrics window. At drain the window holds whole dispatches only:
    the lane split counts every request in it, and the occupancy rows
    sum to its rows."""

    name = "metrics-reset"

    def __init__(self, fastlane: bool, metrics_cls=ServeMetrics):
        super().__init__()
        self.fastlane = fastlane
        self.metrics_cls = metrics_cls

    def run(self, ctl) -> None:
        self.engine = tharnesses._FastEngine()
        self.metrics = self.metrics_cls()
        self.batcher = b = DynamicBatcher(
            self.engine, max_batch=8, max_wait_us=1000, queue_depth=8,
            max_inflight=1, adaptive=False, fastlane=self.fastlane,
            metrics=self.metrics)
        b.start()

        def client():
            for _ in range(6):
                self.futs.append(b.submit(np.zeros((1, 4), np.uint8)))

        def resetter():
            for _ in range(RESETS):
                time.sleep(0.001)
                self.metrics.reset()

        for t in (ctl.spawn(client, "client"),
                  ctl.spawn(resetter, "resetter")):
            t.join()
        b.stop(drain=True)
        for fut in list(self.futs):
            tharnesses.await_future(ctl, fut, "client-result")

    def final(self, ctl) -> None:
        super().final(ctl)
        snap = self.metrics.snapshot()
        if self.fastlane:
            fp = snap["fastpath"]
            assert (fp["dispatches"], fp["rows"]) == (
                snap["requests"], snap["rows"]), (
                f"lane split {fp} against {snap['requests']} requests, "
                f"{snap['rows']} rows in one window")
        else:
            occ = sum(o["rows"] for o in snap["batch_occupancy"].values())
            assert occ == snap["rows"], (
                f"occupancy rows {occ} against {snap['rows']} rows in "
                "one window")


@pytest.mark.parametrize("fastlane", [True, False],
                         ids=["fastlane", "coalesced"])
def test_reset_window_never_splits_a_dispatch(fastlane):
    rep = texplore.Explorer().run(
        lambda: _ResetWindowMachine(fastlane), "metrics-reset",
        RESET_SCHEDULES)
    assert rep.findings == [], rep.findings[0]["detail"]
    assert rep.completed == RESET_SCHEDULES


@pytest.mark.parametrize("fastlane", [True, False],
                         ids=["fastlane", "coalesced"])
def test_reset_window_split_is_found_when_planted(fastlane):
    rep = texplore.Explorer(stop_on_finding=True).run(
        lambda: _ResetWindowMachine(fastlane, _SplitRecords),
        "metrics-reset-split", RESET_SCHEDULES)
    assert rep.findings, "the explorer missed the planted split"
    assert rep.findings[0]["kind"] == "invariant"
    assert "one window" in rep.findings[0]["detail"]
