"""The port's replica fleet (serve/fleet.py) against the JAX package's, on
the CPU.

- On one injected clock (the fleet's and the resilience module's `time`
  patched in both packages) and the JAX suite's duck-typed StubRouter,
  the same script through both ReplicaSets gives the same decisions and
  counts: pick sequences (the cost-aware choice, the least recently
  picked tiebreak, limp mode), per-replica window blocking, failover at
  dispatch and at fetch, the give-up without a sibling and the systemic
  503, _drain_abandoned's skip rule, breaker exclusion, drain and rejoin
  with the last-active refusal, the hedge (fired and won, not fired, never
  onto a tripped sibling) and the snapshot() dicts. `select_member` equals
  JAX's over random member triples (hypothesis).
- Real MLP engines on the CPU, two replicas from build_serving in each
  package on the same weights: warm and promote fan out to both; each
  replica's float32 logits equal JAX's within 1e-5 and its int8 logits
  bit for bit; the batcher attributes batches per replica; a replica
  killed at fetch stays invisible to clients, with the same chaos ledger
  as JAX's (failovers, the injector's evaluations and fires, the
  replicas' failures).

Tolerance: exact for decisions, counts and snapshots; float32 logits
rtol=atol=1e-5; int8 logits exact.
"""

import threading
import time
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from distributedmnist_tpu import models as jmodels
from distributedmnist_tpu.parallel import make_mesh
from distributedmnist_tpu.serve import DynamicBatcher as JDynamicBatcher
from distributedmnist_tpu.serve import ServeMetrics as JServeMetrics
from distributedmnist_tpu.serve import faults as jfaults
from distributedmnist_tpu.serve import fleet as jfleet
from distributedmnist_tpu.serve import registry as jregistry
from distributedmnist_tpu.serve import resilience as jresilience
from distributedmnist_tpu.serve.router import NoLiveModel as JNoLiveModel
from distributedmnist_tpu_torch import config as tconfig
from distributedmnist_tpu_torch.serve import (DynamicBatcher, ServeMetrics,
                                              build_serving)
from distributedmnist_tpu_torch.serve import faults as tfaults
from distributedmnist_tpu_torch.serve import fleet as tfleet
from distributedmnist_tpu_torch.serve import resilience as tresilience
from distributedmnist_tpu_torch.serve.router import NoLiveModel
from tests.test_serve_fleet import StubRouter
from torch_fit_util import fit_params, mlp_flax
from torch_sanitize_util import torch_serve_sanitizer  # noqa: F401

PKGS = {
    "jax": SimpleNamespace(fleet=jfleet, res=jresilience, faults=jfaults,
                           nolive=JNoLiveModel),
    "torch": SimpleNamespace(fleet=tfleet, res=tresilience, faults=tfaults,
                             nolive=NoLiveModel),
}


class _Clock:
    """One injected monotonic clock for both packages' fleets, breakers
    and health trackers."""

    def __init__(self, t: float = 1000.0):
        self.t = t

    def monotonic(self) -> float:
        return self.t


@pytest.fixture()
def clock(monkeypatch):
    c = _Clock()
    for pkg in PKGS.values():
        monkeypatch.setattr(pkg.fleet, "time", c)
        monkeypatch.setattr(pkg.res, "time", c)
    return c


@pytest.fixture(autouse=True)
def _no_leaked_injector():
    for pkg in PKGS.values():
        pkg.faults.uninstall()
    yield
    for pkg in PKGS.values():
        pkg.faults.uninstall()


def _req(seed, n=4):
    return np.random.default_rng(seed).integers(
        0, 256, (n, 28, 28, 1)).astype(np.uint8)


def _fleet(pkg, n=2, costs=True, **kw):
    routers = [StubRouter(f"r{i}", costs=costs) for i in range(n)]
    kw.setdefault("per_replica_inflight", 2)
    return pkg.fleet.ReplicaSet(routers, **kw), routers


def _both(scenario, clock):
    """Run `scenario(pkg, clock)` for each package from the same clock
    reading; returns (jax's observations, the port's)."""
    out = []
    for pkg in PKGS.values():
        clock.t = 1000.0
        out.append(scenario(pkg, clock))
    return out


def _wait_idle(fleet, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if all(r["inflight"] == 0 for r in fleet.snapshot()["replicas"]):
            return
        time.sleep(0.005)
    raise AssertionError(f"fleet never idle: {fleet.snapshot()}")


# -- scenarios, each run through both packages -----------------------------


def _picks_cost_aware_and_limp(pkg, clock):
    """Held handles price a replica's backlog (a bucket-16 batch outweighs
    two bucket-4 ones); idle replicas alternate by least recent pick; a
    tripped replica is skipped; every replica tripped limps on."""
    fleet, routers = _fleet(pkg, n=3, per_replica_inflight=4)
    seen = []
    big = fleet.dispatch(_req(0, 16))                   # 4 ms on one
    small = [fleet.dispatch(_req(i, 3)) for i in range(1, 5)]
    seen.append([big.replica] + [h.replica for h in small])
    for h in [big] + small:
        seen.append(fleet.fetch(h).shape)
    idle = []
    for i in range(5):
        h = fleet.dispatch(_req(10 + i))
        idle.append(h.replica)
        fleet.fetch(h)
    seen.append(idle)
    for _ in range(10):
        fleet._record(fleet.replicas[1], ok=False)
    picks = []
    for i in range(4):
        h = fleet.dispatch(_req(20 + i))
        picks.append(h.replica)
        fleet.fetch(h)
    seen.append(picks)
    for rep in fleet.replicas:
        for _ in range(10):
            fleet._record(rep, ok=False)
    clock.t += 1.0
    limp = []
    for i in range(3):
        h = fleet.dispatch(_req(30 + i))
        limp.append(h.replica)
        fleet.fetch(h)
    seen.append(limp)
    seen.append(fleet.snapshot())
    return seen


def _window_blocks(pkg, clock):
    """per_replica_inflight=1 x 2: the third dispatch waits for a slot
    and lands on the replica whose batch was fetched."""
    fleet, routers = _fleet(pkg, n=2, per_replica_inflight=1)
    h1 = fleet.dispatch(_req(1))
    h2 = fleet.dispatch(_req(2))
    got = []
    t = threading.Thread(target=lambda: got.append(fleet.dispatch(_req(3))),
                         daemon=True)
    t.start()
    time.sleep(0.15)
    blocked = t.is_alive() and not got
    fleet.fetch(h2)
    t.join(10)
    third = got[0].replica
    fleet.fetch(h1)
    fleet.fetch(got[0])
    return [blocked, h1.replica, h2.replica, third, fleet.snapshot()]


def _failovers(pkg, clock):
    """Dispatch death rescued on the sibling, fetch death redispatched
    from the kept payload (re-tagged), a rescue that fails the same way
    counted as nothing, both dead propagating, and the systemic 503
    neither failing over nor blamed."""
    fleet, routers = _fleet(pkg, n=2)
    seen = []
    hb = fleet.dispatch(_req(1))
    victim = next(r for r in routers if r.replica != hb.replica)
    victim.fail_dispatch = True
    x = _req(2)
    h = fleet.dispatch(x)
    seen.append((h.replica, fleet.fetch(h).tobytes() ==
                 x.reshape(4, -1)[:, :10].astype(np.float32).tobytes()))
    fleet.fetch(hb)
    victim.fail_dispatch = False
    x = _req(3, 6)
    h = fleet.dispatch(x)
    dead = next(r for r in routers if r.replica == h.replica)
    dead.fail_fetch = True
    out = fleet.fetch(h)
    dead.fail_fetch = False
    seen.append((h.replica, out.tobytes() ==
                 x.reshape(6, -1)[:, :10].astype(np.float32).tobytes()))
    h = fleet.dispatch(_req(4))
    routers[0].fail_fetch = routers[1].fail_fetch = True
    with pytest.raises(RuntimeError) as ei:
        fleet.fetch(h)
    seen.append(str(ei.value))
    routers[0].fail_fetch = routers[1].fail_fetch = False
    routers[0].fail_dispatch = routers[1].fail_dispatch = True
    with pytest.raises(RuntimeError) as ei:
        fleet.dispatch(_req(5))
    seen.append(str(ei.value))
    routers[0].fail_dispatch = routers[1].fail_dispatch = False

    def no_live(x):
        raise pkg.nolive("warming")

    before = fleet.snapshot()
    routers[0].dispatch = routers[1].dispatch = no_live
    with pytest.raises(pkg.nolive):
        fleet.dispatch(_req(6))
    after = fleet.snapshot()
    seen.append(after["failovers"] == before["failovers"])
    seen.append(after)
    return seen


def _drain_abandoned(pkg, clock):
    fleet, routers = _fleet(pkg, n=2)
    drained = []
    routers[0].fetch = drained.append
    fetched = SimpleNamespace(handle=SimpleNamespace(staging=None))
    unfetched = SimpleNamespace(handle=SimpleNamespace(staging=1))
    bare = SimpleNamespace(x=1)                  # no staging attribute
    for h in (fetched, unfetched, bare):
        fleet._drain_abandoned(fleet.replicas[0], h)
    deadline = time.monotonic() + 5
    while len(drained) < 2 and time.monotonic() < deadline:
        time.sleep(0.01)
    time.sleep(0.05)
    return sorted(id(h) for h in drained) == sorted(
        [id(unfetched), id(bare)]), len(drained)


def _breaker_exclusion(pkg, clock):
    fleet, routers = _fleet(pkg, n=2)
    seen = []
    for _ in range(7):
        fleet._record(fleet.replicas[1], ok=False)
    seen.append(fleet.breaker.in_cooldown("r1"))      # below min volume
    fleet._record(fleet.replicas[1], ok=False)
    seen.append(fleet.breaker.in_cooldown("r1"))
    for _ in range(4):
        fleet.infer(_req(1))
    seen.append([r.dispatches for r in routers])
    clock.t += 10.5                                   # cooldown lapses
    seen.append(fleet.breaker.in_cooldown("r1"))
    for _ in range(4):
        fleet.infer(_req(2))
    seen.append([r.dispatches for r in routers])
    seen.append(fleet.snapshot())
    return seen


def _drain_rejoin(pkg, clock):
    fleet, routers = _fleet(pkg, n=3)
    seen = [fleet.drain("r1"), fleet.drain("r1"), fleet.drain("r2")]
    with pytest.raises(RuntimeError) as ei:
        fleet.drain("r0")
    seen.append(str(ei.value))
    with pytest.raises(KeyError) as ei:
        fleet.rejoin("r9")
    seen.append(str(ei.value))
    h = fleet.dispatch(_req(1))
    seen.append(h.replica)
    for _ in range(10):
        fleet._record(fleet.replicas[1], ok=False)
    seen.append(fleet.rejoin("r1"))
    picks = []
    for i in range(3):
        hh = fleet.dispatch(_req(2 + i))
        picks.append(hh.replica)
    seen.append(picks)
    seen.append(fleet.snapshot())
    # everything draining (the admin refuses it; a white-box check)
    for rep in fleet.replicas:
        rep.state = "draining"
    with pytest.raises(pkg.fleet.NoReplicaAvailable) as ei:
        fleet.dispatch(_req(9))
    seen.append((ei.value.status, str(ei.value)))
    return seen


def _hedges(pkg, clock):
    """Past hedge_factor x p95(bucket) on the injected clock a gated
    primary races a duplicate, which wins and re-tags the handle; within
    the threshold nothing fires; a tripped sibling takes no hedge."""
    seen = []
    fleet, routers = _fleet(pkg, n=2, hedge=True, hedge_factor=1.0)
    gate = threading.Event()
    x = _req(1, 5)
    h = fleet.dispatch(x)
    primary = next(r for r in routers if r.replica == h.replica)
    primary.gate = gate
    clock.t += 0.0029                # bucket 8's p95 is 3 ms: not yet
    seen.append(fleet._hedge_threshold(h.bucket))
    clock.t += 0.01
    out = fleet.fetch(h)
    seen.append((h.replica != primary.replica,
                 out.tobytes() == x.reshape(5, -1)[:, :10].astype(
                     np.float32).tobytes()))
    gate.set()
    _wait_idle(fleet)
    primary.gate = None
    seen.append(fleet.snapshot())
    fleet, routers = _fleet(pkg, n=2, hedge=True, hedge_factor=1.0)
    h = fleet.dispatch(_req(2))
    clock.t += 0.0014                # bucket 4's p95 is 1.5 ms
    fleet.fetch(h)
    seen.append(fleet.snapshot()["hedges"])
    h = fleet.dispatch(_req(3))
    sib = next(rep for rep in fleet.replicas if rep.rid != h.replica)
    for _ in range(10):
        fleet._record(sib, ok=False)
    clock.t += 1.0
    fleet.fetch(h)
    seen.append(fleet.snapshot())
    fleet, routers = _fleet(pkg, n=2, costs=False, hedge=True,
                            hedge_factor=1.0)
    h = fleet.dispatch(_req(4))
    clock.t += 5.0                   # no cost table: never hedge
    fleet.fetch(h)
    seen.append(fleet.snapshot()["hedges"])
    return seen


@pytest.mark.parametrize("scenario", [
    _picks_cost_aware_and_limp, _window_blocks, _failovers,
    _drain_abandoned, _breaker_exclusion, _drain_rejoin, _hedges],
    ids=lambda f: f.__name__.strip("_"))
def test_fleet_decisions_equal_jax_on_one_clock(scenario, clock):
    ref, ours = _both(scenario, clock)
    assert ours == ref


def _until(fn, timeout=10.0):
    """Poll fn() until it returns a truthy value; that value."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        got = fn()
        if got:
            return got
        time.sleep(0.005)
    raise AssertionError(f"condition never held: {fn}")


def _hedge_with_a_dead_arm(pkg, clock, dead_arm):
    """An overdue fetch hedged onto the twin, one arm dying (the primary
    at fetch, or the duplicate at dispatch) and the other answering:
    (the fleet, the dead replica's id, [the answer right, failovers,
    the snapshot once the dead arm's failure is recorded])."""
    fleet, routers = _fleet(pkg, n=2, hedge=True, hedge_factor=1.0)
    x = _req(1, 5)
    h = fleet.dispatch(x)
    primary = next(r for r in routers if r.replica == h.replica)
    twin = next(r for r in routers if r is not primary)
    if dead_arm == "primary":
        dead, primary.fail_fetch = primary, True
    else:
        dead, twin.fail_dispatch = twin, True
    clock.t += 0.01                  # past bucket 8's 3 ms p95
    out = fleet.fetch(h)
    snap = _until(lambda: next(
        (s for s in [fleet.snapshot()]
         if all(r["inflight"] == 0 for r in s["replicas"])
         and sum(r["failures"] for r in s["replicas"]) == 1), None))
    return fleet, dead.replica, [
        out.tobytes() == x.reshape(5, -1)[:, :10].astype(
            np.float32).tobytes(),
        snap["failovers"], snap]


@pytest.mark.parametrize("dead_arm", ("primary", "duplicate"))
def test_hedge_absorbed_counts_the_dead_arm_of_an_answered_race(
        clock, dead_arm):
    """A replica failure inside a hedge race whose other arm answered is
    neither a failover nor a client's error: the port counts it by
    replica in hedge_absorbed() (what the bench's replica kill reports),
    and its snapshot stays JAX's."""
    (_, _, ref), (fleet, dead, ours) = [
        _hedge_with_a_dead_arm(pkg, clock, dead_arm)
        for pkg in PKGS.values()]
    assert ours == ref
    assert ours[0] is True and ours[1] == {"dispatch": 0, "fetch": 0}
    assert ours[2]["hedges"]["fired"] == 1
    assert _until(fleet.hedge_absorbed) == {dead: 1}
    assert "hedge_absorbed" not in ours[2]


def test_hedge_absorbed_is_empty_without_a_failed_arm(clock):
    """A hedge whose arms both answer absorbs nothing; a fleet without
    hedging reports an empty count."""
    fleet, routers = _fleet(PKGS["torch"], n=2, hedge=True,
                            hedge_factor=1.0)
    h = fleet.dispatch(_req(2, 5))
    clock.t += 0.01
    fleet.fetch(h)
    _wait_idle(fleet)
    assert fleet.snapshot()["hedges"]["fired"] == 1
    assert fleet.hedge_absorbed() == {}
    plain, _ = _fleet(PKGS["torch"], n=2)
    plain.fetch(plain.dispatch(_req(3)))
    assert plain.hedge_absorbed() == {}


def test_fleet_refusals_and_engine_shape_equal_jax():
    seen = []
    for pkg in PKGS.values():
        row = []
        for routers in ([StubRouter("r0")],
                        [StubRouter("r0"), StubRouter("r0")]):
            with pytest.raises(ValueError) as ei:
                pkg.fleet.ReplicaSet(routers)
            row.append(str(ei.value))
        bad = StubRouter("r1")
        bad.buckets = (2, 4)
        with pytest.raises(ValueError) as ei:
            pkg.fleet.ReplicaSet([StubRouter("r0"), bad])
        row.append(str(ei.value))
        fleet, _ = _fleet(pkg, n=3, per_replica_inflight=2)
        with pytest.raises(ValueError) as ei:
            fleet.set_live([object()], "v2")
        row.append(str(ei.value))
        row.append((fleet.max_batch, fleet.buckets, fleet.platform,
                    fleet.n_replicas, fleet.max_inflight_total,
                    fleet.bucket_for(5), fleet.bucket_costs(),
                    fleet.bucket_costs_p95(), fleet.replica_ids(),
                    fleet.HEDGE_FACTOR, fleet.hedge_factor,
                    fleet.per_replica_inflight))
        cpu_auto, _ = _fleet(pkg, n=2, per_replica_inflight=None)
        row.append(cpu_auto.per_replica_inflight)
        seen.append(row)
    assert seen[0] == seen[1]


def test_fast_lane_on_a_fleet_takes_the_fleets_dispatch_like_jax():
    """A fleet has no dispatch_fast: a lane submit claims its slot and
    dispatches through the fleet's pick on the caller's thread, as the
    JAX batcher does; both packages count the same lane dispatches and
    per-replica batches."""
    from distributedmnist_tpu.serve.batcher import \
        DynamicBatcher as JBatcher
    from distributedmnist_tpu.serve.metrics import ServeMetrics as JMetrics

    seen = []
    for pkg, batcher_cls, metrics_cls in (
            (PKGS["jax"], JBatcher, JMetrics),
            (PKGS["torch"], DynamicBatcher, ServeMetrics)):
        fleet, routers = _fleet(pkg, n=2)
        assert not hasattr(fleet, "dispatch_fast")
        metrics = metrics_cls()
        b = batcher_cls(fleet, max_wait_us=0, fastlane=True,
                        metrics=metrics).start()
        try:
            outs = [b.submit(_req(i)).result(timeout=10).tobytes()
                    for i in range(6)]
        finally:
            b.stop()
        snap = metrics.snapshot()
        seen.append((outs, snap["fastpath"], snap["by_replica"],
                     [r.dispatches for r in routers]))
    assert seen[0] == seen[1]
    assert seen[1][1]["dispatches"] == 6


def test_fleet_and_cascade_metrics_equal_jax():
    """The same fleet and cascade recordings give the same `by_replica`,
    `fleet` and `cascade` blocks (the failover's wall-clock stamp aside)
    and the same Prometheus lines of those families."""
    import re

    from distributedmnist_tpu.serve import metrics as jmetrics
    from distributedmnist_tpu_torch.serve import metrics as tmetrics

    snaps, texts = [], []
    for mod in (jmetrics, tmetrics):
        m = mod.ServeMetrics()
        m.record_batch(rows=3, bucket=4, queue_depth=0, version="v1",
                       replica="r0", infer_dtype="int8")
        m.record_batch(rows=5, bucket=8, queue_depth=1, version="v1",
                       replica="r1", infer_dtype="float32")
        m.record_failover("fetch", "r1", "r0")
        m.record_failover("dispatch", "r1", "r0")
        m.record_failover("fetch", "r0", "r1")
        m.record_hedge(win=True)
        m.record_hedge(win=False)
        m.record_replica_trip("r1")
        for cls in ("fast", "balanced", "balanced", "exact"):
            m.record_cascade_class(cls)
        m.record_cascade_stage("int8", 8)
        m.record_cascade_stage("float32", 2)
        m.record_cascade_escalation(2)
        m.record_cascade_degraded()
        snap = m.snapshot()
        snap["fleet"]["last_failover"].pop("at")
        snaps.append({k: snap[k] for k in ("by_replica", "fleet",
                                           "cascade")})
        text = mod.prometheus_exposition(snap)
        texts.append(sorted(
            ln for ln in text.splitlines()
            if re.search(r"dmnist_serve_(replica|failovers|hedge|cascade)",
                         ln)))
    assert snaps[1] == snaps[0]
    assert texts[1] == texts[0] and texts[1]


class _Member:
    def __init__(self, rid, inflight, outstanding_s, last_pick):
        self.rid, self.inflight = rid, inflight
        self.outstanding_s, self.last_pick = outstanding_s, last_pick


_members = st.lists(
    st.tuples(st.integers(0, 4), st.sampled_from([0.0, 1e-3, 2e-3, 4e-3]),
              st.integers(0, 6), st.booleans()),
    min_size=0, max_size=5)


@settings(max_examples=300, deadline=None, database=None)
@given(members=_members, window=st.integers(1, 4),
       overflow=st.booleans(), healthy_only=st.booleans())
def test_select_member_equals_jax(members, window, overflow, healthy_only):
    active = [_Member(f"r{i}", inf, out, lp)
              for i, (inf, out, lp, _) in enumerate(members)]
    cooled_set = {f"r{i}" for i, m in enumerate(members) if m[3]}
    picks = [pkg.fleet.select_member(active, cooled_set.__contains__,
                                     window, overflow=overflow,
                                     healthy_only=healthy_only)
             for pkg in PKGS.values()]
    assert (None if picks[0] is None else picks[0].rid) == \
        (None if picks[1] is None else picks[1].rid)


# -- real engines: two replicas from build_serving in each package ---------


@pytest.fixture(scope="module")
def fleets(eight_devices):
    """(jax (registry, fleet), port (registry, fleet)), each a two-replica
    fleet serving the same fitted MLP as v1 with its int8 variant warm."""
    params = fit_params()
    # the JAX engines run its Pallas kernels as its own tests do on the
    # CPU, in interpret mode
    jf = jregistry.EngineFactory(
        jmodels.build("mlp", fused="pallas", platform="cpu"),
        make_mesh(eight_devices[:2]), max_batch=16, replicas=2,
        fused="pallas")
    jfl = jf.make_fleet(metrics=None)
    jreg = jregistry.ModelRegistry(jf, jfl)
    jreg.add(mlp_flax(params, fused=True), version="v1")
    treg, tfl, tfac = build_serving(tconfig.Config(
        model="mlp", device="cpu", serve_max_batch=16, serve_replicas=2))
    treg.add(params, version="v1")
    for reg in (jreg, treg):
        reg.promote("v1")
        reg.add_variant("v1", "int8")
    return (jreg, jfl), (treg, tfl)


def test_warm_and_promote_fan_out_to_both_replicas(fleets):
    (jreg, jfl), (treg, tfl) = fleets
    assert isinstance(tfl, tfleet.ReplicaSet) and tfl.replica_ids() == [
        "r0", "r1"]
    tmv, jmv = treg.get("v1"), jreg.get("v1")
    assert len(tmv.engines) == len(jmv.engines) == 2
    assert tmv.engines[0] is not tmv.engines[1]
    assert tmv.describe()["replica_engines"] == 2
    assert tmv.variants["int8"].describe()["replica_engines"] == 2
    assert treg.describe()["replicas"] == jreg.describe()["replicas"] == 2
    for fl in (jfl, tfl):
        assert [rep.router.live_version() for rep in fl.replicas] == [
            "v1", "v1"]
    # a partial engine list never reaches the replicas
    for fl in (jfl, tfl):
        with pytest.raises(ValueError, match="one engine per replica"):
            fl.set_live(tmv.engines[:1], "v1")


def test_each_replica_equals_jax_f32_and_int8(fleets):
    """Every replica's logits against JAX's fleet replica (1e-5), and the
    int8 ones bit for bit against the JAX package's int8 forward on its
    own prepared weights with its plain quant_dense_reference (the Pallas
    kernel in interpret mode fuses its epilogue into an FMA, an ulp off
    that reference: ROADMAP §3 item 3)."""
    from distributedmnist_tpu.ops import fused as jfused
    from distributedmnist_tpu.serve import quantize as jquantize

    (jreg, jfl), (treg, tfl) = fleets
    x = np.random.default_rng(7).integers(0, 256, (13, 28, 28, 1),
                                          dtype=np.uint8)
    jmv = jreg.get("v1")
    p, _ = jquantize.prepare_inference(
        jreg.factory.model, jmv.engines[0].params, "int8",
        jfused.PALLAS_INTERPRET)
    xc = jquantize._center_pixels(jnp.asarray(x.reshape(13, -1)))
    h = jfused.quant_dense_reference(xc, p["w1q"], p["s1"], p["b1"],
                                     relu=True)
    hq = jquantize.quantize_act_static(h, p["act_scale"])
    want_int8 = np.asarray(jfused.quant_dense_reference(
        hq, p["w2q"], p["s2"] * p["act_scale"], p["b2"], relu=False))
    for dt in ("float32", "int8"):
        for reg in (jreg, treg):
            reg.promote("v1", infer_dtype=dt)
        assert tfl.live_infer_dtype() == jfl.live_infer_dtype() == dt
        for jrep, trep in zip(jfl.replicas, tfl.replicas):
            ours = trep.router.infer(x)
            np.testing.assert_allclose(ours, np.asarray(
                jrep.router.infer(x)), rtol=1e-5, atol=1e-5)
            if dt == "int8":
                assert ours.tobytes() == want_int8.tobytes(), trep.rid
        # both replicas hold one set of weights: the same bytes
        a, b = (rep.router.infer(x) for rep in tfl.replicas)
        assert a.tobytes() == b.tobytes()
    for reg in (jreg, treg):
        reg.promote("v1")


def test_batcher_opens_to_the_fleet_window_and_attributes_replicas(fleets):
    _, (treg, tfl) = fleets
    metrics = ServeMetrics()
    tfl.metrics = metrics
    b = DynamicBatcher(tfl, max_wait_us=100, metrics=metrics).start()
    try:
        assert b.max_inflight == tfl.max_inflight_total == 2
        rng = np.random.default_rng(3)
        futs = [b.submit(rng.integers(0, 256, (2, 784), dtype=np.uint8))
                for _ in range(12)]
        for f in futs:
            assert f.result(timeout=60).shape == (2, 10)
    finally:
        b.stop()
        tfl.metrics = None
    by_replica = metrics.snapshot()["by_replica"]
    assert set(by_replica) == {"r0", "r1"}
    assert sum(s["rows"] for s in by_replica.values()) == 24
    assert DynamicBatcher(tfl, max_inflight=1).max_inflight == 1


def _killed_replica_ledger(pkg, fl, batcher_cls, metrics_cls):
    """Requests one at a time through a batcher while r1 dies at fetch
    three times: every answer arrives; the ledger."""
    metrics = metrics_cls()
    fl.metrics = metrics
    # the same starting point in both fleets (earlier tests of this
    # module drive one package's fleet alone): a fresh pick order
    fl._pick_seq = 0
    for rep in fl.replicas:
        rep.last_pick = 0
    inj = pkg.faults.install(pkg.faults.FaultInjector.from_spec(
        "replica.fetch:p=1,replica=r1,count=3", seed=5))
    b = batcher_cls(fl, max_batch=4, max_wait_us=0,
                    metrics=metrics).start()
    before = {r["id"]: (r["dispatched_batches"], r["failures"])
              for r in fl.snapshot()["replicas"]}
    rng = np.random.default_rng(11)
    try:
        outs = [b.submit(rng.integers(0, 256, (2, 784), dtype=np.uint8))
                .result(timeout=60) for _ in range(10)]
    finally:
        b.stop()
        pkg.faults.uninstall()
        fl.metrics = None
    snap = fl.snapshot()
    return {
        "answers": [o.shape for o in outs],
        "rules": [{k: r[k] for k in ("point", "evaluations", "fires")}
                  for r in inj.snapshot()["rules"]],
        "failovers": snap["failovers"],
        "metrics_fleet": {k: v for k, v in metrics.snapshot()["fleet"]
                          .items() if k != "last_failover"},
        "by_replica": metrics.snapshot()["by_replica"],
        "replicas": {r["id"]: (r["dispatched_batches"]
                               - before[r["id"]][0],
                               r["failures"] - before[r["id"]][1])
                     for r in snap["replicas"]},
    }, outs


def test_killed_replica_is_invisible_with_jax_chaos_ledger(fleets):
    (jreg, jfl), (treg, tfl) = fleets
    ref, jouts = _killed_replica_ledger(PKGS["jax"], jfl, JDynamicBatcher,
                                        JServeMetrics)
    ours, touts = _killed_replica_ledger(PKGS["torch"], tfl,
                                         DynamicBatcher, ServeMetrics)
    assert ours == ref
    assert ours["failovers"]["fetch"] >= 3
    assert ours["rules"][0]["fires"] == 3
    for a, b in zip(touts, jouts):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-5)


def _dispatch_storm(pkg, batcher_cls, metrics_cls):
    """Through the full batcher: a replica-pinned storm of dispatch and
    fetch deaths on r0 costs clients nothing; the fleet ledger."""
    metrics = metrics_cls()
    fleet, routers = _fleet(pkg, n=2, metrics=metrics)
    pkg.faults.install(pkg.faults.FaultInjector.from_spec(
        "replica.dispatch:p=1,replica=r0,count=2;"
        "replica.fetch:p=1,replica=r0,after=2,count=2", seed=11))
    # max_batch=2: one request per dispatch, so the storm's after/count
    # windows land on a predictable per-replica batch sequence
    b = batcher_cls(fleet, max_batch=2, max_wait_us=100,
                    metrics=metrics).start()
    try:
        outs = [b.submit(_req(i, 2)).result(timeout=30)
                for i in range(16)]
    finally:
        b.stop()
        pkg.faults.uninstall()
    snap = metrics.snapshot()["fleet"]
    return ([o.shape for o in outs], snap["failovers_total"],
            snap["failovers"], snap["last_failover"]["to"])


def test_replica_dispatch_storm_is_invisible_like_jax():
    ref = _dispatch_storm(PKGS["jax"], JDynamicBatcher, JServeMetrics)
    ours = _dispatch_storm(PKGS["torch"], DynamicBatcher, ServeMetrics)
    assert ours == ref
    assert ours[1:] == (4, {"dispatch": 2, "fetch": 2}, "r1")
