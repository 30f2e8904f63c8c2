"""The port's confidence cascade (serve/cascade.py, the router's pinned
routes, the batcher's route-uniform drains, the cache's route labels and
the registry's cascade gate) against the JAX package's, on the CPU.

- softmax_margin within 1e-7 of JAX's; calibrate equal to JAX's (the
  threshold, the escalation set, the verdict and the whole record) on
  the JAX suite's constructed logits and on random ones, refusals and
  overrides included.
- The JAX suite's CascadeFront scenarios through both packages on its
  route-pinnable stub engine: class routing (fast pins the cheap dtype,
  exact float32, balanced partitions by margin and reassembles row by
  row), the degraded path with no calibrated cascade, an unknown class,
  the deadline inherited by the escalation, the cache (composed answers
  under `cascade:<dtype>`, a cheap-only answer never served to an
  `exact` request, the epoch dropping stale composed entries), poison
  bisection under the cascade, and drains that never mix routes: equal
  answers, route logs and metrics blocks.
- Real engines: the registry's cascade on a fitted MLP (the gate's
  record, the events, the alternates, set_cascade_threshold and
  promote's override, their refusals, and the refusal on a fleet front
  with JAX's text), and composed answers on MLP and LeNet engines:
  classes equal to JAX's, float32 rows within 1e-5 of JAX's, every row
  byte for byte the port's own single-route answer.

Tolerances: decisions, counts and records exact; margins 1e-7; float32
logits rtol 1e-5, atol 1e-5 times the logits' scale; MLP int8 rows 1e-5
(one ulp apart at most, ROADMAP §3 item 3); LeNet int8 rows atol 5e-3
times the scale (the two frameworks' f32 conv trunks sum in other orders,
tests/test_torch_serve_lenet.py).
"""

import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

from distributedmnist_tpu import models as jmodels
from distributedmnist_tpu.ops import fused as jfused
from distributedmnist_tpu.parallel import make_mesh
from distributedmnist_tpu.serve import cache as jcache
from distributedmnist_tpu.serve import cascade as jcascade
from distributedmnist_tpu.serve import fleet as jfleet
from distributedmnist_tpu.serve import metrics as jmetrics
from distributedmnist_tpu.serve import registry as jregistry
from distributedmnist_tpu.serve import router as jrouter
from distributedmnist_tpu.serve.batcher import DynamicBatcher as JBatcher
from distributedmnist_tpu.serve.engine import \
    InferenceEngine as JInferenceEngine
from distributedmnist_tpu.serve.resilience import \
    DeadlineExceeded as JDeadline
from distributedmnist_tpu.serve.resilience import \
    ResiliencePolicy as JPolicy
from distributedmnist_tpu_torch import config as tconfig
from distributedmnist_tpu_torch.data import synthetic_mnist
from distributedmnist_tpu_torch.models.lenet import LAYERS
from distributedmnist_tpu_torch.serve import cache as tcache
from distributedmnist_tpu_torch.serve import cascade as tcascade
from distributedmnist_tpu_torch.serve import fleet as tfleet
from distributedmnist_tpu_torch.serve import metrics as tmetrics
from distributedmnist_tpu_torch.serve import registry as tregistry
from distributedmnist_tpu_torch.serve import router as trouter
from distributedmnist_tpu_torch.serve.batcher import DynamicBatcher
from distributedmnist_tpu_torch.serve.engine import InferenceEngine
from distributedmnist_tpu_torch.serve.registry import PARITY_SEED
from distributedmnist_tpu_torch.serve.resilience import (DeadlineExceeded,
                                                         ResiliencePolicy)
from tests.test_serve_cascade import (CascadeStubEngine, PlanStub,
                                      PoisonCascadeStub, _cheap_with,
                                      _poison_rows, _ref_logits)
from tests.test_serve_fleet import StubRouter
from torch_fit_util import fit_params, mlp_flax

PKGS = {
    "jax": SimpleNamespace(cascade=jcascade, cache=jcache,
                           metrics=jmetrics, batcher=JBatcher,
                           deadline=JDeadline, policy=JPolicy,
                           registry=jregistry, fleet=jfleet,
                           router=jrouter),
    "torch": SimpleNamespace(cascade=tcascade, cache=tcache,
                             metrics=tmetrics, batcher=DynamicBatcher,
                             deadline=DeadlineExceeded,
                             policy=ResiliencePolicy, registry=tregistry,
                             fleet=tfleet, router=trouter),
}


def _rows(seed, n):
    return np.random.default_rng(seed).integers(
        0, 256, (n, 28, 28, 1)).astype(np.uint8)


# -- the margin and the calibration ------------------------------------------


def test_softmax_margin_equals_jax():
    rng = np.random.default_rng(0)
    for scale in (0.1, 3.0, 40.0):
        z = rng.normal(size=(64, 10)) * scale
        np.testing.assert_allclose(tcascade.softmax_margin(z),
                                   jcascade.softmax_margin(z), atol=1e-7,
                                   rtol=0)
    z = (rng.normal(size=(32, 10)) * 5).astype(np.float32)   # engines'
    np.testing.assert_allclose(tcascade.softmax_margin(z),
                               jcascade.softmax_margin(z), atol=1e-7,
                               rtol=0)
    assert tcascade.ACCURACY_CLASSES == jcascade.ACCURACY_CLASSES
    assert tcascade.cascade_label("int8") == jcascade.cascade_label("int8")
    st = tcascade.CascadeState("int8", 0.25, {"passed": True})
    assert st.describe() == jcascade.CascadeState(
        "int8", 0.25, {"passed": True}).describe()
    assert tcascade.threshold_of(st) == 0.25


_CALIBRATIONS = [
    ("perfect", lambda: (_ref_logits(16), _cheap_with(16)), {}),
    ("uncertain wrong rows",
     lambda: (_ref_logits(16), _cheap_with(16, wrong_low_margin=(2, 9))),
     {}),
    ("confident wrong row capped",
     lambda: (_ref_logits(16), _cheap_with(16, wrong_high_margin=(5,))),
     {"max_escalation": 0.5}),
    ("bar out of reach", lambda: (_ref_logits(16), _cheap_with(16)),
     {"min_agreement": 1.01}),
    ("override nothing",
     lambda: (_ref_logits(16), _cheap_with(16, wrong_low_margin=(2, 9))),
     {"threshold": 0.0}),
    ("override everything",
     lambda: (_ref_logits(16), _cheap_with(16, wrong_low_margin=(2, 9))),
     {"threshold": 1.0}),
    ("tie across the cut",
     lambda: (_ref_logits(8), np.tile(_cheap_with(1), (8, 1))),
     {"min_agreement": 0.995}),
]


@pytest.mark.parametrize("name,make,kw", _CALIBRATIONS,
                         ids=[c[0] for c in _CALIBRATIONS])
def test_calibrate_equals_jax(name, make, kw):
    ref, cheap = make()
    kw = dict(kw)
    bar = kw.pop("min_agreement", 0.995)
    ours = tcascade.calibrate(ref, cheap, bar, **kw)
    want = jcascade.calibrate(ref, cheap, bar, **kw)
    assert ours == want
    esc = tcascade.softmax_margin(cheap) < ours["threshold"]
    assert (esc == (jcascade.softmax_margin(cheap) < want["threshold"])).all()


def test_calibrate_equals_jax_on_random_logits():
    rng = np.random.default_rng(3)
    for trial in range(60):
        n = int(rng.integers(4, 200))
        ref = rng.normal(size=(n, 10)) * 4
        cheap = ref + rng.normal(size=(n, 10)) * rng.choice([0.05, 0.5, 2])
        bar = float(rng.choice([0.9, 0.99, 0.995, 1.0]))
        cap = float(rng.choice([0.1, 0.5, 1.0]))
        ours = tcascade.calibrate(ref, cheap, bar, max_escalation=cap)
        assert ours == jcascade.calibrate(ref, cheap, bar,
                                          max_escalation=cap), trial
    with pytest.raises(ValueError) as ei:
        tcascade.calibrate(np.zeros((2, 10)), np.zeros((3, 10)), 0.9)
    with pytest.raises(ValueError) as ej:
        jcascade.calibrate(np.zeros((2, 10)), np.zeros((3, 10)), 0.9)
    assert str(ei.value) == str(ej.value)


# -- CascadeFront scenarios through both packages ----------------------------


def _state(pkg, threshold, cheap_dtype="int8"):
    return pkg.cascade.CascadeState(cheap_dtype, threshold,
                                    {"passed": True, "source": "test"})


def _front(pkg, engine, state, cache=None, **batcher_kw):
    metrics = pkg.metrics.ServeMetrics()
    b = pkg.batcher(engine, max_wait_us=1000, queue_depth=1024,
                    metrics=metrics, **batcher_kw).start()
    reg = PlanStub(state)
    inner = (pkg.cache.CacheFront(b, engine, cache, metrics=metrics)
             if cache is not None else b)
    front = pkg.cascade.CascadeFront(inner, b, engine, reg,
                                     metrics=metrics, cache=cache)
    return front, b, reg, metrics


def _cascade_block(metrics):
    return metrics.snapshot()["cascade"]


def _classes(pkg):
    eng = CascadeStubEngine()
    x = _rows(1, 8)
    base = x.reshape(8, -1)[:, :10].astype(np.float32) / 100.0
    thr = float(np.sort(pkg.cascade.softmax_margin(base + 500.0))[4])
    front, b, _, m = _front(pkg, eng, _state(pkg, thr))
    try:
        outs = [front.submit(x, accuracy_class=c).result(timeout=10)
                for c in ("exact", "fast", "balanced")]
        with pytest.raises(ValueError) as ei:
            front.submit(x, accuracy_class="cheapest")
    finally:
        b.stop()
    return ([o.tobytes() for o in outs], eng.route_log, eng.calls,
            str(ei.value), _cascade_block(m))


def _degraded(pkg):
    eng = CascadeStubEngine()
    front, b, _, m = _front(pkg, eng, None)
    try:
        out = front.submit(_rows(2, 3),
                           accuracy_class="balanced").result(timeout=10)
        exact = front.submit(_rows(2, 3),
                             accuracy_class="exact").result(timeout=10)
    finally:
        b.stop()
    return out.tobytes(), exact.tobytes(), eng.route_log, _cascade_block(m)


def _full_escalation(pkg):
    eng = CascadeStubEngine()
    front, b, _, m = _front(pkg, eng, _state(pkg, 1.0))
    try:
        x = _rows(3, 5)
        bal = front.submit(x, accuracy_class="balanced").result(timeout=10)
        ex = front.submit(x, accuracy_class="exact").result(timeout=10)
    finally:
        b.stop()
    return bal.tobytes() == ex.tobytes(), eng.route_log, _cascade_block(m)


def _deadlines(pkg):
    gate = threading.Event()
    eng = CascadeStubEngine(gate=gate)
    front, b, _, m = _front(pkg, eng, _state(pkg, 1.0))
    seen = []
    try:
        with pytest.raises(pkg.deadline):
            front.submit(_rows(4, 2), accuracy_class="balanced",
                         deadline_s=time.monotonic() - 0.01)
        seen.append(list(eng.calls))
        fut = front.submit(_rows(4, 2), accuracy_class="balanced",
                           deadline_s=time.monotonic() + 0.2)
        assert eng.in_call.wait(timeout=10)
        time.sleep(0.35)
        gate.set()
        with pytest.raises(pkg.deadline):
            fut.result(timeout=10)
        seen.append(eng.route_log)
        b.stop()
        with pytest.raises(RuntimeError) as ei:
            front.submit(_rows(5, 2),
                         accuracy_class="balanced").result(timeout=10)
        seen.append(str(ei.value))
    finally:
        gate.set()
        b.stop()
    return seen


def _cache_labels(pkg):
    """Composed answers cached under the cascade label and hit again; a
    cheap-only answer never served to `exact`; a threshold change with
    the epoch bump drops the stale composed entry."""
    seen = []
    eng = CascadeStubEngine()
    cache = pkg.cache.PredictionCache(64)
    front, b, reg, m = _front(pkg, eng, _state(pkg, 0.0), cache=cache)
    try:
        x = _rows(6, 3)
        first = front.submit(x, accuracy_class="balanced").result(timeout=10)
        seen.append(cache.stats()["entries"])
        seen.append(cache.lookup(pkg.cache.content_key(
            "v1", pkg.cascade.cascade_label("int8"), x)) is not None)
        again = front.submit(x, accuracy_class="balanced").result(timeout=10)
        seen.append((first.tobytes() == again.tobytes(), list(eng.calls)))
        exact = front.submit(x, accuracy_class="exact").result(timeout=10)
        fast = front.submit(x, accuracy_class="fast").result(timeout=10)
        seen.append((exact.tobytes(), fast.tobytes() == first.tobytes(),
                     cache.stats()["entries"], list(eng.route_log)))
        reg.state = _state(pkg, 1.0)
        cache.invalidate()
        out = front.submit(x, accuracy_class="balanced").result(timeout=10)
        seen.append((out.tobytes() == exact.tobytes(), eng.route_log))
        seen.append({k: v for k, v in cache.stats().items()
                     if k not in ("ttl_s", "expired", "capacity")})
        seen.append(_cascade_block(m))
    finally:
        b.stop()
    return seen


def _poison(pkg):
    gate = threading.Event()
    eng = PoisonCascadeStub(max_batch=16, gate=gate)
    metrics = pkg.metrics.ServeMetrics()
    b = pkg.batcher(eng, max_wait_us=50_000, max_inflight=4,
                    resilience=pkg.policy(bisect=True),
                    metrics=metrics).start()
    front = pkg.cascade.CascadeFront(b, b, eng, PlanStub(_state(pkg, 0.0)),
                                     metrics=metrics)
    try:
        first = front.submit(_rows(7, 1), accuracy_class="balanced")
        assert eng.in_call.wait(timeout=10)
        clean = [front.submit(_rows(8 + i, 2), accuracy_class="balanced")
                 for i in range(2)]
        bad = front.submit(_poison_rows(2), accuracy_class="balanced")
        clean.append(front.submit(_rows(11, 3), accuracy_class="balanced"))
        gate.set()
        first.result(timeout=10)
        with pytest.raises(RuntimeError) as ei:
            bad.result(timeout=10)
        shapes = [f.result(timeout=10).shape for f in clean]
    finally:
        b.stop()
    res = metrics.snapshot()["resilience"]
    return (str(ei.value), shapes, set(eng.route_log),
            {k: res[k] for k in ("poison_isolated_requests",
                                 "poison_isolated_rows",
                                 "bisect_rescued_requests",
                                 "bisect_rescued_rows",
                                 "dispatch_error_requests")})


def _route_uniform(pkg):
    gate = threading.Event()
    eng = CascadeStubEngine(max_batch=64, gate=gate)
    b = pkg.batcher(eng, max_wait_us=50_000, max_inflight=2).start()
    try:
        first = b.submit(_rows(12, 1))
        assert eng.in_call.wait(timeout=10)
        futs = [b.submit(_rows(13, 2), route="int8"),
                b.submit(_rows(14, 2), route="float32"),
                b.submit(_rows(15, 2), route="int8"),
                b.submit(_rows(16, 1), route="int8")]
        gate.set()
        outs = [f.result(timeout=10).tobytes() for f in [first] + futs]
    finally:
        b.stop()
    return outs, eng.route_log, eng.calls


@pytest.mark.parametrize("scenario", [
    _classes, _degraded, _full_escalation, _deadlines, _cache_labels,
    _poison, _route_uniform], ids=lambda f: f.__name__.strip("_"))
def test_cascade_front_equals_jax_on_the_stub_engine(scenario):
    ref = scenario(PKGS["jax"])
    ours = scenario(PKGS["torch"])
    assert ours == ref


def test_routed_requests_never_take_the_fast_lane():
    eng = CascadeStubEngine()
    b = DynamicBatcher(eng, max_wait_us=0, fastlane=True,
                       metrics=tmetrics.ServeMetrics()).start()
    try:
        b.submit(_rows(1, 1)).result(timeout=10)
        b.submit(_rows(2, 1), route="int8").result(timeout=10)
        snap = b.metrics.snapshot()
    finally:
        b.stop()
    assert snap["fastpath"]["dispatches"] == 1
    assert eng.route_log == ["float32", "int8"]


# -- the registry's cascade over real engines --------------------------------


def _scale(logits) -> float:
    return max(1.0, float(np.abs(logits).max()))


@pytest.fixture(scope="module")
def mlp_registries(eight_devices):
    """The same fitted MLP live as v1 in a JAX registry (its Pallas
    kernels in interpret mode) and a port registry, each with a
    calibrated int8 cascade."""
    params = fit_params()
    jf = jregistry.EngineFactory(
        jmodels.build("mlp", fused="pallas", platform="cpu"),
        make_mesh(eight_devices[:1]), max_batch=16, fused="pallas")
    jreg = jregistry.ModelRegistry(jf, jf.make_router())
    jreg.add(mlp_flax(params, fused=True), version="v1")
    tf = tregistry.EngineFactory("mlp", device="cpu", max_batch=16)
    treg = tregistry.ModelRegistry(tf, tf.make_router())
    treg.add(params, version="v1")
    states = []
    for reg in (jreg, treg):
        reg.promote("v1")
        states.append(reg.enable_cascade("v1"))
    return (jreg, states[0]), (treg, states[1])


def test_registry_cascade_gate_matches_jax(mlp_registries):
    (jreg, jst), (treg, tst) = mlp_registries
    assert tst.cheap_dtype == jst.cheap_dtype == "int8"
    ours, ref = tst.calibration, jst.calibration
    assert ours["passed"] is ref["passed"] is True
    for k in ("rows", "base_agreement", "composed_agreement",
              "escalation_fraction", "min_agreement", "max_escalation",
              "source"):
        assert ours[k] == ref[k], k
    # the threshold sits between two margins of logits 1e-5 apart
    assert abs(tst.threshold - jst.threshold) <= 1e-5
    plan = treg.cascade_plan()
    assert plan[0] == "v1" and plan[1] is tst
    desc = treg.describe()
    mv = next(v for v in desc["versions"] if v["version"] == "v1")
    jmv = next(v for v in jreg.describe()["versions"]
               if v["version"] == "v1")
    assert mv["cascade"].keys() == jmv["cascade"].keys()
    assert desc["routes"]["alternates"] == \
        jreg.describe()["routes"]["alternates"] == ["float32", "int8"]
    assert [e["event"] for e in treg.events()] == \
        [e["event"] for e in jreg.events()] == ["cascade_enabled"]


def test_registry_cascade_threshold_and_refusals_match_jax(mlp_registries):
    (jreg, _), (treg, _) = mlp_registries
    seen = []
    for reg in (jreg, treg):
        row = []
        old = reg.cascade_plan()[1].threshold
        row.append(reg.set_cascade_threshold("v1", 1.0).calibration)
        mv = reg.promote("v1", cascade_threshold=0.5)
        row.append((mv.state, reg.cascade_plan()[1].threshold,
                    reg.cascade_plan()[1].calibration["source"]))
        reg.set_cascade_threshold("v1", old)
        for call in (lambda: reg.set_cascade_threshold("nope", 0.5),
                     lambda: reg.promote("nope", cascade_threshold=0.5)):
            with pytest.raises(KeyError) as ei:
                call()
            row.append(str(ei.value))
        with pytest.raises(ValueError) as ei:
            reg.enable_cascade("v1", cheap_dtype="float32")
        row.append(str(ei.value))
        with pytest.raises(ValueError) as ei:
            reg.enable_cascade("v1", cheap_dtype="float16")
        row.append(str(ei.value))
        reg.add(reg.factory.init_params(5), version="v2")
        with pytest.raises(RuntimeError) as ei:
            reg.set_cascade_threshold("v2", 0.5)
        row.append(str(ei.value))
        with pytest.raises(RuntimeError) as ei:
            reg.promote("v2", cascade_threshold=0.5)
        row.append((str(ei.value), reg.live_version()))
        reg.promote("v2")             # no cascade there: plan is None
        row.append(reg.cascade_plan())
        reg.promote("v1")
        row.append(reg.cascade_plan()[0])
        row.append([e["event"] for e in reg.events()])
        seen.append(row)
    assert seen[1] == seen[0]


def test_cascade_on_a_fleet_front_is_refused_with_jax_text():
    msgs = []
    for pkg in PKGS.values():
        fleet = pkg.fleet.ReplicaSet([StubRouter("r0"), StubRouter("r1")])
        reg = pkg.registry.ModelRegistry(SimpleNamespace(), fleet)
        with pytest.raises(RuntimeError) as ei:
            reg.enable_cascade("v1")
        msgs.append(str(ei.value))
        assert reg.n_replicas == 2
    assert msgs[0] == msgs[1]
    assert "fleet front" in msgs[1]
    # and through build_serving's real fleet
    treg, tfl, _ = tregistry.build_serving(tconfig.Config(
        model="mlp", device="cpu", serve_max_batch=4, serve_replicas=2))
    with pytest.raises(RuntimeError, match="fleet front") as ei:
        treg.enable_cascade("v1")
    assert str(ei.value) == msgs[0]


def _composed_through(pkg, router, registry, x, classes):
    metrics = pkg.metrics.ServeMetrics()
    b = pkg.batcher(router, max_wait_us=500, queue_depth=256,
                    metrics=metrics).start()
    front = pkg.cascade.CascadeFront(b, b, router, registry,
                                     metrics=metrics)
    try:
        outs = {c: np.asarray(front.submit(x, accuracy_class=c)
                              .result(timeout=120)) for c in classes}
    finally:
        b.stop()
    return outs, metrics.snapshot()["cascade"]


def test_composed_mlp_answers_match_jax(mlp_registries):
    (jreg, _), (treg, tst) = mlp_registries
    x = synthetic_mnist(seed=PARITY_SEED, train_n=16,
                        test_n=16)["test_x"][:16]
    margins = tcascade.softmax_margin(
        treg.get("v1").variants["int8"].engine.infer(x))
    cut = np.sort(margins)
    gaps = np.diff(cut)[4:12]
    k = 4 + int(np.argmax(gaps))
    thr = float((cut[k] + cut[k + 1]) / 2)
    for reg in (jreg, treg):
        reg.set_cascade_threshold("v1", thr)
    try:
        ref, jblock = _composed_through(PKGS["jax"], jreg.router, jreg, x,
                                        ("exact", "fast", "balanced"))
        ours, tblock = _composed_through(PKGS["torch"], treg.router, treg,
                                         x, ("exact", "fast", "balanced"))
    finally:
        for reg in (jreg, treg):
            reg.enable_cascade("v1")
    assert tblock == jblock
    assert 0 < tblock["escalated_rows"] < 16
    esc = margins < thr
    for c in ("exact", "fast", "balanced"):
        assert (ours[c].argmax(-1) == ref[c].argmax(-1)).all(), c
        np.testing.assert_allclose(ours[c], ref[c], rtol=1e-5,
                                   atol=1e-5 * _scale(ref[c]))
    assert ours["balanced"][esc].tobytes() == ours["exact"][esc].tobytes()
    assert ours["balanced"][~esc].tobytes() == ours["fast"][~esc].tobytes()


@pytest.fixture(scope="module")
def lenet_params():
    """LeNet-5 fit for 200 Adam steps on the parity batch's synthetic
    distribution: real margins, so no class sits on a near-tie that the
    two frameworks' conv trunks round apart."""
    return fit_params("lenet", seed=0, steps=200)


def test_composed_lenet_answers_match_jax(lenet_params, eight_devices):
    """LeNet's float32 and int8 engines behind each package's router with
    the pinned alternates, one CascadeState (a threshold between two
    well-separated margins): classes equal JAX's, float32 rows within
    1e-5, int8 rows within the LeNet int8 tolerance, and every composed
    row the port's own single-route bytes."""
    flax = {name: {leaf: lenet_params[f"{name}.{leaf}"].numpy()
                   for leaf in ("kernel", "bias")}
            for name, _, _ in LAYERS}
    jm = jmodels.build("lenet", fused="pallas", platform="cpu")
    mesh = make_mesh(eight_devices[:1])
    jeng = {dt: JInferenceEngine(jm, flax, mesh, max_batch=16,
                                 version="v1", infer_dtype=dt,
                                 fused_mode=jfused.PALLAS_INTERPRET)
            for dt in ("float32", "int8")}
    teng = {dt: InferenceEngine("lenet", lenet_params, device="cpu",
                                max_batch=16, version="v1", infer_dtype=dt)
            for dt in ("float32", "int8")}
    x = synthetic_mnist(seed=PARITY_SEED, train_n=16,
                        test_n=16)["test_x"][:16]
    margins = tcascade.softmax_margin(teng["int8"].infer(x))
    jmargins = jcascade.softmax_margin(np.asarray(jeng["int8"].infer(x)))
    cut = np.sort(margins)
    gaps = np.diff(cut)[4:12]
    k = 4 + int(np.argmax(gaps))
    thr = float((cut[k] + cut[k + 1]) / 2)
    esc = margins < thr
    assert (esc == (jmargins < thr)).all() and 0 < esc.sum() < 16
    results = {}
    for name, pkg, engines in (("jax", PKGS["jax"], jeng),
                               ("torch", PKGS["torch"], teng)):
        router = pkg.router.Router(16, engines["float32"].buckets, "cpu")
        router.set_live(engines["float32"], "v1", alternates=engines)
        reg = PlanStub(_state(pkg, thr))
        results[name] = _composed_through(pkg, router, reg, x,
                                          ("exact", "fast", "balanced"))
    (ref, jblock), (ours, tblock) = results["jax"], results["torch"]
    assert tblock == jblock
    scale = _scale(ref["exact"])
    for c in ("exact", "fast", "balanced"):
        assert (ours[c].argmax(-1) == ref[c].argmax(-1)).all(), c
    np.testing.assert_allclose(ours["exact"], ref["exact"], rtol=1e-5,
                               atol=1e-5 * scale)
    np.testing.assert_allclose(ours["balanced"][esc], ref["balanced"][esc],
                               rtol=1e-5, atol=1e-5 * scale)
    np.testing.assert_allclose(ours["fast"], ref["fast"], atol=5e-3 * scale)
    assert ours["balanced"][esc].tobytes() == ours["exact"][esc].tobytes()
    assert ours["balanced"][~esc].tobytes() == ours["fast"][~esc].tobytes()
