"""The PyTorch port's MLP serving slice against the JAX package, on the
CPU: weights carried by interop from both flax MLP layouts, the engine's
float32 logits, the bfloat16/int8/megakernel variants, the registry's
parity gate, the batcher, the scheduler and the selftest CLI — plus the
guards (the port imports no jax; its entry points default to cuda and
raise without a card).

Tolerances: float32 rtol=1e-5, atol=1e-5; the megakernel likewise; int8
exact (its int32 products are, and the f32 epilogues round the same way
in both packages); bfloat16 at bf16 resolution, atol=2e-2 times the logit
scale (one bf16 rounding is 2**-8 relative, and the two frameworks round
the logits matmul's bf16 result at different points).
"""

import json
import os
import subprocess
import sys
import threading
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from distributedmnist_tpu import config as jconfig
from distributedmnist_tpu import models as jmodels
from distributedmnist_tpu.ops import fused as jfused
from distributedmnist_tpu.serve import quantize as jquantize
from distributedmnist_tpu.serve import registry as jregistry
from distributedmnist_tpu.serve import scheduler as jscheduler
from distributedmnist_tpu.utils import metrics as jmetrics
from distributedmnist_tpu.utils import numerics as jnumerics
from distributedmnist_tpu_torch import config as tconfig
from distributedmnist_tpu_torch import interop, models
from distributedmnist_tpu_torch.data import synthetic_mnist
from distributedmnist_tpu_torch.serve import (PARITY_GATES, DynamicBatcher,
                                              EngineFactory, InferenceEngine,
                                              ModelRegistry, ParityRefused,
                                              Rejected, ServeMetrics,
                                              build_serving, make_buckets)
from distributedmnist_tpu_torch.serve import quantize as tquantize
from distributedmnist_tpu_torch.ops import fused as tfused
from distributedmnist_tpu_torch.serve import registry as tregistry
from distributedmnist_tpu_torch.serve import scheduler as tscheduler
from distributedmnist_tpu_torch.serve.__main__ import main as serve_main
from distributedmnist_tpu_torch.serve.registry import PARITY_SEED
from distributedmnist_tpu_torch.utils import numerics as tnumerics
from distributedmnist_tpu_torch.utils import percentiles

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAX_BATCH = 8
# the fitted weights' init seed: this recipe leaves every row of the
# held-out parity batch a top-2 logit margin of >= 4% of the logit scale
FIT_SEED = 1


def _flax_mlp(layout: str, seed: int = 0):
    """(model, params) of the JAX MLP: 'pallas' is the fused-kernel
    layout (hidden_kernel/hidden_bias, interpret mode here), 'xla' the
    nn.Dense tree (hidden/{kernel,bias})."""
    model = jmodels.build("mlp", fused=layout, platform="cpu")
    params = model.init(jax.random.PRNGKey(seed),
                        jnp.zeros((1, 28, 28, 1)))["params"]
    return model, params


def _jax_logits(model, params, x):
    return np.asarray(model.apply({"params": params},
                                  jnp.asarray(x, jnp.float32) / 255.0))


def _images(n, seed=0):
    return np.random.default_rng(seed).integers(
        0, 256, (n, 28, 28, 1), dtype=np.uint8)


def _fit_params(seed: int = FIT_SEED, steps: int = 1000) -> dict:
    """MLP weights with real margins: seeded fresh init, then a short SGD
    fit on the train split of the parity batch's distribution (synthetic
    templates differ per seed, so a model fit on other templates has
    near-tie logits on the held-out batch). Fresh-init weights flip
    argmaxes under int8/bf16 rounding and are rightly refused."""
    data = synthetic_mnist(seed=PARITY_SEED, train_n=8192, test_n=16)
    net = models.build("mlp", device="cpu")
    net.load_state_dict(models.init_params("mlp", seed))
    opt = torch.optim.SGD(net.parameters(), lr=0.05, momentum=0.9)
    x = torch.from_numpy(data["train_x"])
    y = torch.from_numpy(data["train_y"]).long()
    g = torch.Generator().manual_seed(seed)
    for _ in range(steps):
        idx = torch.randint(0, x.shape[0], (128,), generator=g)
        loss = F.cross_entropy(net(x[idx].float() / 255.0), y[idx])
        opt.zero_grad()
        loss.backward()
        opt.step()
    return {k: v.detach().clone() for k, v in net.state_dict().items()}


# -- weights across ---------------------------------------------------------


def test_interop_reads_both_layouts_without_transpose():
    _, fused_params = _flax_mlp("pallas")
    _, dense_params = _flax_mlp("xla")
    a = interop.mlp_params_from_flax(jax.tree.map(np.asarray, fused_params))
    b = interop.mlp_params_from_flax(jax.tree.map(np.asarray, dense_params))
    for p in (a, b):
        assert tuple(p["hidden_kernel"].shape) == (784, 128)
        assert tuple(p["logits_kernel"].shape) == (128, 10)
        assert all(v.dtype == torch.float32 for v in p.values())
    np.testing.assert_array_equal(a["hidden_kernel"].numpy(),
                                  np.asarray(fused_params["hidden_kernel"]))
    np.testing.assert_array_equal(b["hidden_kernel"].numpy(),
                                  np.asarray(dense_params["hidden"]["kernel"]))


def test_fresh_init_matches_flax_lecun_normal():
    p = models.init_params("mlp", seed=3)
    assert sum(v.numel() for v in p.values()) == 101_770
    for name, fan_in in (("hidden_kernel", 784), ("logits_kernel", 128)):
        w = p[name].numpy()
        std = np.sqrt(1.0 / fan_in)
        assert abs(w.std() - std) < 0.1 * std, name
        assert np.abs(w).max() <= 2 * std / 0.87962566103423978 + 1e-6
    assert not p["hidden_bias"].any() and not p["logits_bias"].any()
    np.testing.assert_array_equal(
        p["hidden_kernel"].numpy(),
        models.init_params("mlp", seed=3)["hidden_kernel"].numpy())


# -- the engine -------------------------------------------------------------


@pytest.mark.parametrize("layout", ["pallas", "xla"])
def test_engine_f32_matches_jax_every_bucket(layout):
    model, params = _flax_mlp(layout, seed=1)
    x = _images(MAX_BATCH, seed=2)
    want = _jax_logits(model, params, x)
    engine = InferenceEngine(
        "mlp", interop.mlp_params_from_flax(jax.tree.map(np.asarray, params)),
        device="cpu", max_batch=MAX_BATCH)
    assert engine.buckets == (1, 2, 4, 8)
    assert engine.warmup(cost_samples=1) == 0
    for n in (1, 2, 3, 4, 5, 8):        # exact fits and padded buckets
        got = engine.infer(x[:n])
        assert got.shape == (n, 10) and got.dtype == np.float32
        np.testing.assert_allclose(got, want[:n], rtol=1e-5, atol=1e-5)
    # coalesced parts stage into one bucket
    got = engine.infer([x[:3], x[3:5].reshape(2, 784)])
    np.testing.assert_allclose(got, want[:5], rtol=1e-5, atol=1e-5)
    assert sum(engine.staging_buffers().values()) >= 1


def test_engine_fetch_is_one_shot_and_validates_input():
    engine = InferenceEngine("mlp", models.init_params("mlp"),
                             device="cpu", max_batch=4)
    h = engine.dispatch(_images(3))
    engine.fetch(h)
    with pytest.raises(RuntimeError, match="already fetched"):
        engine.fetch(h)
    with pytest.raises(TypeError, match="uint8"):
        engine.infer(np.zeros((1, 784), np.float32))
    with pytest.raises(ValueError, match="exceeds the top bucket"):
        engine.infer(_images(5))


@pytest.mark.parametrize("infer_dtype", ["bfloat16", "int8", "megakernel"])
@pytest.mark.parametrize("layout", ["pallas", "xla"])
def test_variant_matches_jax_prepare_inference(infer_dtype, layout):
    model, params = _flax_mlp(layout, seed=4)
    x = _images(MAX_BATCH, seed=5)
    jprep, jfwd = jquantize.prepare_inference(model, params, infer_dtype,
                                              jfused.PALLAS_INTERPRET)
    want = np.asarray(jax.jit(jfwd)(jprep, x))
    tparams = interop.mlp_params_from_flax(jax.tree.map(np.asarray, params))
    engine = InferenceEngine("mlp", tparams, device="cpu",
                             max_batch=MAX_BATCH, infer_dtype=infer_dtype)
    got = engine.infer(x)
    assert got.dtype == np.float32
    if infer_dtype == "int8":
        tprep, _ = tquantize.prepare_inference("mlp", tparams, "int8")
        assert float(tprep["act_scale"]) == float(jprep["act_scale"])
        # exact products and identically rounded epilogues: the whole
        # int8 forward agrees to the bit, well inside the parity gate
        np.testing.assert_array_equal(got, want)
        rep = tnumerics.parity_check(_jax_logits(model, params, x), got,
                                     *PARITY_GATES["int8"])
        assert rep["max_rel_logit_diff"] <= PARITY_GATES["int8"][1]
    elif infer_dtype == "bfloat16":
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2 * scale)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_quantization_helpers_match_jax():
    w = np.random.default_rng(0).normal(size=(40, 12)).astype(np.float32)
    w[:, 3] = 0.0
    q, s = tquantize.quantize_channelwise(w)
    jq, js = jquantize.quantize_channelwise(w)
    np.testing.assert_array_equal(q, jq)
    np.testing.assert_array_equal(s, js)
    np.testing.assert_array_equal(tquantize.dequantize(q, s),
                                  jquantize.dequantize(jq, js))
    np.testing.assert_array_equal(tquantize.calibration_batch(),
                                  jquantize.calibration_batch())
    h = np.random.default_rng(1).normal(size=(6, 9)).astype(np.float32) * 3
    h[0, :3] = [0.5, 1.5, -2.5]          # round-half-to-even cases
    scale = np.asarray(1.0, np.float32)
    np.testing.assert_array_equal(
        tquantize.quantize_act_static(torch.from_numpy(h),
                                      torch.from_numpy(scale)).numpy(),
        np.asarray(jquantize.quantize_act_static(jnp.asarray(h), scale)))
    for dt in ("bfloat16", "int8", "megakernel"):
        assert tquantize.variant_supported("mlp", dt) \
            == jquantize.variant_supported("mlp", dt)
    assert not tquantize.variant_supported("lenet", "megakernel")


# -- registry, parity gate, batcher ---------------------------------------------


def _registry(max_batch=128):
    factory = EngineFactory("mlp", device="cpu", max_batch=max_batch)
    router = factory.make_router()
    return ModelRegistry(factory, router), router, factory


def test_parity_constants_match_jax():
    assert PARITY_GATES == jregistry.PARITY_GATES
    assert PARITY_SEED == jregistry.PARITY_SEED
    assert tquantize.PARITY_ROWS == jregistry.PARITY_ROWS


def test_registry_gates_all_three_variants_and_serves_them():
    registry, router, _ = _registry()
    boot = registry.bootstrap(seed=0)
    assert boot.state == "live" and router.live_version() == boot.version
    assert boot.warmup_builds == 0        # plain versions build nothing
    mv = registry.add(_fit_params(), version="fitted")
    registry.promote("fitted")
    assert registry.get(boot.version).state == "ready"
    x = _images(64, seed=9)
    metrics = ServeMetrics()
    for dt in ("bfloat16", "int8", "megakernel"):
        vi = registry.add_variant("fitted", dt)
        assert vi.state == "ready", vi.last_error
        assert vi.parity["passed"] and vi.parity["rows"] == 128, vi.parity
        registry.promote("fitted", infer_dtype=dt)
        assert router.live_infer_dtype() == dt
        b = DynamicBatcher(router, max_batch=32, metrics=metrics).start()
        try:
            futs = [(i, b.submit(x[i:i + 4])) for i in range(0, 64, 4)]
            out = np.concatenate([f.result(timeout=60) for _, f in futs])
        finally:
            b.stop()
        np.testing.assert_array_equal(out, vi.engine.infer(x))
        assert registry.add_variant("fitted", dt) is vi   # idempotent
    snap = metrics.snapshot()
    assert snap["requests"] == 48 and snap["rejected_requests"] == 0
    assert set(snap["by_dtype"]) == {"bfloat16", "int8", "megakernel"}
    assert registry.cheapest_variant("fitted") in (
        "float32", "bfloat16", "int8", "megakernel")
    assert mv.describe()["variants"]["int8"]["state"] == "ready"


def test_registry_refuses_a_variant_that_fails_the_gate():
    registry, router, _ = _registry()
    mv = registry.bootstrap()
    with pytest.raises(ParityRefused, match="parity gate REFUSED"):
        registry.add_variant(mv.version, "megakernel", min_agreement=1.01)
    vi = registry.get(mv.version).variants["megakernel"]
    assert vi.state == "failed" and "argmax agreement" in vi.last_error
    with pytest.raises(RuntimeError, match="not promotable"):
        registry.promote(mv.version, infer_dtype="megakernel")
    assert router.live_infer_dtype() == "float32"
    with pytest.raises(ValueError, match="unknown variant dtype"):
        registry.add_variant(mv.version, "float16")
    # activate_infer_dtype retries at the default bar and promotes
    assert registry.activate_infer_dtype(mv.version,
                                         "megakernel") == "megakernel"
    assert router.live_infer_dtype() == "megakernel"


def test_registry_regates_a_ready_variant_and_demotes_a_live_one():
    """The JAX package's re-gate and demotion steps
    (tests/test_serve_quantize.py::test_variant_gate_refuses_and_records),
    assertion for assertion: custom thresholds against a ready variant
    re-gate its existing engine instead of rebuilding it, a refusal fails
    it, and a live variant refused at re-gate is demoted to the float32
    engine at once, with one event."""
    registry, router, _ = _registry()
    registry.bootstrap()
    mv = registry.add(_fit_params(), version="fitted")
    registry.promote("fitted")
    vi = registry.add_variant("fitted", "bfloat16")
    assert vi.state == "ready"
    # a passing re-gate keeps the variant and its engine: nothing rebuilt
    engine = vi.engine
    again = registry.add_variant("fitted", "bfloat16", max_rel_diff=0.5)
    assert again is vi and again.engine is engine and vi.state == "ready"
    # custom thresholds against an ALREADY-ready variant re-gate its
    # existing engine instead of returning the default-bar verdict
    with pytest.raises(RuntimeError, match="re-gate REFUSED"):
        registry.add_variant("fitted", "bfloat16", min_agreement=1.01)
    assert registry.get("fitted").variants["bfloat16"].state == "failed"
    assert "argmax agreement" in vi.last_error
    assert router.live_infer_dtype() == "float32"    # it was never live
    vi = registry.add_variant("fitted", "bfloat16")  # default bar again
    assert vi.state == "ready" and vi.engine is not engine
    # a LIVE variant failing a re-gate is demoted to the float32 base at
    # once, event-logged
    registry.promote("fitted", infer_dtype="bfloat16")
    assert router.live_infer_dtype() == "bfloat16"
    with pytest.raises(RuntimeError, match="re-gate REFUSED"):
        registry.add_variant("fitted", "bfloat16", min_agreement=1.01)
    assert router.live_infer_dtype() == "float32"
    assert router.live_version() == "fitted"
    demotions = [e for e in registry.events()
                 if e["event"] == "variant_demoted"]
    assert len(demotions) == 1
    assert demotions[0]["version"] == "fitted"
    assert demotions[0]["infer_dtype"] == "bfloat16"
    assert demotions[0]["to"] == "float32"
    assert demotions[0]["reason"] == vi.last_error
    described = registry.describe()
    assert described["live_infer_dtype"] == "float32"
    assert mv.describe()["variants"]["bfloat16"]["state"] == "failed"
    with pytest.raises(RuntimeError, match="not promotable"):
        registry.promote("fitted", infer_dtype="bfloat16")
    # what is served afterwards is the float32 engine's answer
    x = _images(24, seed=12)
    b = DynamicBatcher(router, max_batch=32).start()
    try:
        futs = [b.submit(x[i:i + 3]) for i in range(0, 24, 3)]
        out = np.concatenate([f.result(timeout=60) for f in futs])
    finally:
        b.stop()
    np.testing.assert_array_equal(out, mv.engine.infer(x))
    vi = registry.add_variant("fitted", "bfloat16")  # clean slate again
    assert vi.state == "ready"


_SELFTEST_ARGS = ["--device", "cpu", "--model", "mlp", "--selftest", "8",
                  "--serve-max-batch", "8", "--serve-infer-dtype",
                  "megakernel"]


def test_selftest_keeps_float32_live_when_the_gate_refuses(monkeypatch,
                                                          capsys):
    """A parity refusal is forgiven: float32 stays live and the selftest
    answers every request."""
    monkeypatch.setitem(tregistry.PARITY_GATES, "megakernel", (1.01, 0.0))
    assert serve_main(_SELFTEST_ARGS) == 0
    s = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert s["metric"] == "serve_selftest"
    assert s["live_infer_dtype"] == "float32"
    assert s["requests"] == 8 and s["rejected_requests"] == 0
    variant = s["versions"][0]["variants"]["megakernel"]
    assert variant["state"] == "failed"
    assert "parity gate REFUSED" in variant["last_error"]


def test_selftest_fails_when_a_variant_kernel_fails(monkeypatch, capsys):
    """A kernel that fails to launch is not a gate refusal: the selftest
    raises (a nonzero exit) and prints no summary."""
    def failed_launch(*args, **kwargs):
        raise RuntimeError("mlp_megakernel_f32 launch failed: CUDA error "
                           "700 (an illegal memory access was encountered)")

    monkeypatch.setattr(tfused, "mlp_megakernel_reference", failed_launch)
    with pytest.raises(RuntimeError, match="launch failed"):
        serve_main(_SELFTEST_ARGS)
    assert "serve_selftest" not in capsys.readouterr().out


def test_batcher_backpressure_and_drain():
    registry, router, _ = _registry(max_batch=8)
    b = DynamicBatcher(router, max_batch=8, queue_depth=6)
    # nothing is live yet: the first batch fails with NoLiveModel (503)
    b.start()
    try:
        with pytest.raises(RuntimeError, match="no warmed model"):
            b.submit(_images(2)).result(timeout=30)
    finally:
        b.stop()
    registry.bootstrap()
    b = DynamicBatcher(router, max_batch=8, queue_depth=6,
                       max_wait_us=50_000)
    f1 = b.submit(_images(4))              # not started: stays queued
    with pytest.raises(Rejected):
        b.submit(_images(4))
    assert b.pending_rows() == 4
    b.start()
    try:
        assert f1.result(timeout=30).shape == (4, 10)
        with pytest.raises(ValueError, match="exceeds max_batch"):
            b.submit(_images(9))
    finally:
        b.stop()
    assert b.pending_rows() == 0 and b.inflight_batches() == 0


def test_batcher_concurrent_submitters_each_get_their_rows():
    """16 submitter threads against one batcher with a window of 2 and a
    shortened switch interval: every request resolves with exactly its
    own rows' logits (a torn fan-out or a lost queue update would hand a
    request someone else's rows or strand it), and the pipeline drains
    to zero."""
    import threading

    registry, router, _ = _registry(max_batch=16)
    mv = registry.bootstrap()
    x = _images(16 * 12, seed=11)
    want = np.concatenate([mv.engine.infer(x[i:i + 16])
                           for i in range(0, len(x), 16)])
    b = DynamicBatcher(router, max_batch=16, max_inflight=2,
                       max_wait_us=200).start()
    results, errors = {}, []

    def client(t):
        try:
            for j in range(4):
                lo = (t * 4 + j) * 3
                results[lo] = b.submit(x[lo:lo + 3]).result(timeout=60)
        except Exception as e:          # surfaced by the assert below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=client, args=(t,))
                   for t in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
        b.stop()
    assert not errors, errors
    assert len(results) == 64
    for lo, got in results.items():
        np.testing.assert_allclose(got, want[lo:lo + 3], rtol=1e-5,
                                   atol=1e-5)
    assert b.pending_rows() == 0 and b.inflight_batches() == 0


def test_batcher_stop_without_drain_fails_queued():
    registry, router, _ = _registry(max_batch=8)
    registry.bootstrap()
    b = DynamicBatcher(router, max_batch=8)
    f = b.submit(_images(1))
    b.stop(drain=False)
    with pytest.raises(RuntimeError, match="batcher stopped"):
        f.result(timeout=5)
    with pytest.raises(RuntimeError, match="stopped"):
        b.submit(_images(1))


class _GatedEngine:
    """Engine-shaped double for the batch former: dispatch() logs its row
    count, fetch() waits on a gate (the card still computing) and returns
    each row's first 10 pixels, so a result names the rows it came from.
    Its cost table is linear in the bucket, where splitting a drain
    always beats padding it."""

    platform = "cpu"
    _as_images = staticmethod(InferenceEngine._as_images)
    bucket_for = InferenceEngine.bucket_for

    def __init__(self, max_batch: int):
        self.max_batch = max_batch
        self.buckets = make_buckets(max_batch)
        self.calls = []
        self.in_call = threading.Event()
        self.gate = threading.Event()

    def bucket_costs(self):
        return {b: b * 1e-3 for b in self.buckets}

    def dispatch(self, parts):
        x = np.concatenate([self._as_images(p) for p in parts])
        self.calls.append(x.shape[0])
        self.in_call.set()
        return SimpleNamespace(x=x, n=x.shape[0],
                               bucket=self.bucket_for(x.shape[0]))

    def fetch(self, handle):
        assert self.gate.wait(timeout=30)
        return handle.x.reshape(handle.n, -1)[:, :10].astype(np.float32)


@pytest.mark.parametrize("split", [True, False])
def test_batcher_split_false_sends_one_covering_segment(split):
    """The JAX package's split=False escape hatch
    (tests/test_serve_batcher.py::
    test_split_disabled_restores_single_covering_dispatch): a 20-row
    drain that the cost table splits (16 + 4) goes out as one padded
    segment when split=False, and every request gets its own rows."""
    eng = _GatedEngine(max_batch=32)
    b = DynamicBatcher(eng, max_wait_us=50_000, queue_depth=256,
                       max_inflight=1, split=split).start()
    try:
        first = b.submit(_images(1))         # wedged at the fetch gate
        assert eng.in_call.wait(timeout=10)
        xs = [_images(4, seed=i) for i in range(5)]
        futs = [b.submit(x) for x in xs]     # queue behind it: one drain
        eng.gate.set()
        first.result(timeout=10)
        for x, f in zip(xs, futs):
            np.testing.assert_array_equal(
                f.result(timeout=10),
                x.reshape(4, -1)[:, :10].astype(np.float32))
    finally:
        b.stop()
    assert eng.calls[0] == 1 and sum(eng.calls[1:]) == 20
    if split:
        assert len(eng.calls) > 2, eng.calls
    else:
        assert eng.calls == [1, 20], eng.calls


# -- scheduler, metrics, numerics, config -------------------------------------


def test_scheduler_matches_jax():
    r = np.random.default_rng(0)
    buckets = make_buckets(64)
    assert buckets == (1, 2, 4, 8, 16, 32, 64)
    for _ in range(50):
        costs = {b: 1e-4 + float(r.random()) * 1e-5 * b for b in buckets}
        sizes = [int(s) for s in r.integers(1, 20, int(r.integers(1, 9)))]
        sizes = [s for s in sizes if s <= 64] or [1]
        assert tscheduler.plan_segments(sizes, buckets, costs) \
            == jscheduler.plan_segments(sizes, buckets, costs)
        assert tscheduler.fit_dispatch_cost(costs) \
            == jscheduler.fit_dispatch_cost(costs)


def test_adaptive_controller_matches_jax():
    ours = tscheduler.AdaptiveController(1e-3, slo_s=5e-3, max_batch=64)
    ref = jscheduler.AdaptiveController(1e-3, slo_s=5e-3, max_batch=64)
    for i in range(100):
        for ctl in (ours, ref):
            ctl.on_arrival(1 + i % 7, now=i * 2e-3)
            ctl.on_latency(1e-2 if i % 9 == 0 else 1e-3)
        assert ours.effective_wait_s() == ref.effective_wait_s()
    for ctl in (ours, ref):         # a fast-lane arrival: counted, not
        ctl.on_arrival(3, now=0.5, coalesced=False)   # in the EWMA
    assert ours.effective_wait_s() == ref.effective_wait_s()
    assert ours.snapshot() == ref.snapshot()


def test_numerics_and_percentiles_match_jax():
    r = np.random.default_rng(0)
    ref = r.normal(size=(32, 10)).astype(np.float32)
    cand = ref + r.normal(size=ref.shape).astype(np.float32) * 0.05
    assert tnumerics.parity_check(ref, cand, 0.9, 0.1) \
        == jnumerics.parity_check(ref, cand, 0.9, 0.1)
    assert tnumerics.round_up(13, 8) == jnumerics.round_up(13, 8) == 16
    vals = list(r.random(101))
    assert percentiles(vals) == jmetrics.percentiles(vals)
    assert percentiles([]) == jmetrics.percentiles([])


def test_serving_config_defaults_match_jax():
    ours, ref = tconfig.Config(), jconfig.Config()
    for f in ("model", "seed", "serve_max_batch", "serve_max_wait_us",
              "serve_queue_depth", "serve_max_inflight", "serve_slo_ms",
              "serve_adaptive", "serve_infer_dtype"):
        assert getattr(ours, f) == getattr(ref, f), f
    assert ours.device == "cuda"


# -- guards -------------------------------------------------------------------


def test_entry_points_default_to_cuda_and_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        build_serving(tconfig.Config(model="mlp"))
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        build_serving(tconfig.Config(model="mlp", serve_replicas=2,
                                     serve_cascade=True))
    from distributedmnist_tpu_torch.serve import build_tenancy

    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        build_tenancy(tconfig.Config(serve_models="mlp,lenet",
                                     serve_tenants="a:model=lenet"))
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        InferenceEngine("mlp", models.init_params("mlp"))
    registry, _, factory = build_serving(
        tconfig.Config(model="mlp", device="cpu", serve_max_batch=4))
    assert factory.device == torch.device("cpu")


def test_lenet_builds_but_is_not_served_yet():
    """LeNet-5 builds and, since its serving slice landed, serves: the
    name is kept from when build_serving refused it."""
    net = models.build("lenet", device="cpu")
    assert sum(p.numel() for p in net.parameters()) == 61_706
    registry, router, factory = build_serving(
        tconfig.Config(model="lenet", device="cpu", serve_max_batch=4))
    assert factory.model == "lenet" and factory.buckets == (1, 2, 4)
    mv = registry.bootstrap(seed=0)
    assert mv.state == "live" and mv.source == "fresh-init"
    out = router.infer(_images(3))
    assert out.shape == (3, 10) and np.all(np.isfinite(out))
    with pytest.raises(ValueError, match="unknown model"):
        build_serving(tconfig.Config(model="resnet", device="cpu"))


def test_selftest_cli_imports_no_jax():
    """The selftest, end to end in a fresh interpreter, with the bench
    module, the HTTP server's modules, the fleet, the cascade and tenancy
    imported too: one serve_selftest line with nothing rejected, and neither jax
    nor the JAX package in sys.modules afterwards."""
    code = (
        "import json, sys\n"
        "import distributedmnist_tpu_torch.bench\n"
        "import distributedmnist_tpu_torch.serve.process\n"
        "import distributedmnist_tpu_torch.serve.resilience\n"
        "import distributedmnist_tpu_torch.serve.server\n"
        "import distributedmnist_tpu_torch.serve.fleet\n"
        "import distributedmnist_tpu_torch.serve.cascade\n"
        "import distributedmnist_tpu_torch.serve.tenancy\n"
        "from distributedmnist_tpu_torch.serve.__main__ import main\n"
        "rc = main(['--device', 'cpu', '--model', 'mlp', '--selftest', "
        "'48', '--serve-max-batch', '16', '--serve-infer-dtype', "
        "'megakernel'])\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' "
        "or m.startswith('jax.') or m == 'distributedmnist_tpu' "
        "or m.startswith('distributedmnist_tpu.'))\n"
        "print('MODULES ' + json.dumps(bad))\n"
        "sys.exit(rc)\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    assert json.loads(lines[-1].split(" ", 1)[1]) == []
    summaries = [json.loads(ln) for ln in lines
                 if ln.startswith("{") and "serve_selftest" in ln]
    assert len(summaries) == 1
    s = summaries[0]
    assert s["requests"] == 48 and s["rejected_at_submit"] == 0
    assert s["rejected_requests"] == 0 and s["device"] == "cpu"
    assert s["live_infer_dtype"] == "megakernel"
