"""Serving over a group of devices in the port against the JAX package,
on the CPU: the JAX engine shards each batch over its whole 'data' mesh,
and the port's engine splits it over a list of devices.

- The placement: parallel/mesh.py's get_devices and place_replicas, and
  EngineFactory over N devices and R replicas, against the JAX
  package's EngineFactory over make_mesh(eight_devices[:N]) for N in
  1..8 and R in 1..4: each replica's device indices, n_chips,
  total_chips and the bucket ladder.
- The engine over k = 2, 4 and 8 logical CPU shards (`devices=[cpu] *
  k`: the split, the gather and the ladder the cards run) against the
  JAX engine over k CPU devices, on the same numpy inputs and weights,
  at every row count from 1 to max_batch, for the MLP and LeNet-5. The
  JAX engines run their Pallas kernels in interpret mode, as its own
  tests do on the CPU.
- The group engine's own contract: the ladder's multiples, its fast
  lane (exact fit split over the shards, the row route priced at
  warmup), a shard that fails failing the dispatch with its staging
  recycled; a fleet of group replicas served through the batcher;
  torchcheck over a group target; the dry run's serve group.
- The guards: build_serving, the serve CLI and the bench refuse more
  devices than are visible, in the JAX package's words, and accept
  --num-devices 1 on the CPU.

Tolerances, as the existing serve tests state them: float32 and the
megakernel rtol 1e-5 and atol 1e-5 times the logits' scale (at least
1); bfloat16 rtol 2e-2 and atol 2e-2 times the scale for the MLP
(tests/test_torch_serve.py), atol 3e-2 times the scale for LeNet-5
(tests/test_torch_serve_lenet.py); int8 bit for bit.
"""

import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedmnist_tpu import models as jmodels
from distributedmnist_tpu.analysis import jaxcheck as jc
from distributedmnist_tpu.parallel import get_devices as jget_devices
from distributedmnist_tpu.parallel import make_mesh
from distributedmnist_tpu.serve import registry as jregistry
from distributedmnist_tpu.serve.engine import InferenceEngine as JEngine
from distributedmnist_tpu.serve.engine import make_buckets as jmake_buckets
from distributedmnist_tpu_torch import bench as tbench
from distributedmnist_tpu_torch import config as tconfig
from distributedmnist_tpu_torch import dryrun, interop, models
from distributedmnist_tpu_torch.analysis import torchcheck as tc
from distributedmnist_tpu_torch.parallel import mesh as tmesh
from distributedmnist_tpu_torch.serve import (DynamicBatcher, EngineFactory,
                                              InferenceEngine, ModelRegistry,
                                              ServeMetrics, build_serving,
                                              make_buckets)
from distributedmnist_tpu_torch.serve.__main__ import main as serve_main
from torch_sanitize_util import torch_serve_sanitizer  # noqa: F401

MAX_BATCH = 16
CPU = torch.device("cpu")
TOL = {"mlp": {"float32": 1e-5, "megakernel": 1e-5, "bfloat16": 2e-2},
       "lenet": {"float32": 1e-5, "bfloat16": 3e-2}}


def _scale(logits) -> float:
    return max(1.0, float(np.abs(logits).max()))


def _images(n, seed=0):
    return np.random.default_rng(seed).integers(
        0, 256, (n, 28, 28, 1), dtype=np.uint8)


# -- placement ------------------------------------------------------------------


@pytest.mark.parametrize("replicas", [1, 2, 3, 4])
@pytest.mark.parametrize("n", range(1, 9))
def test_placement_equals_jax_engine_factory(eight_devices, n, replicas):
    """Per-replica device indices, n_chips, total_chips and buckets of
    the port's factory over n distinct devices (cpu:0..cpu:n-1 stand for
    cards: no engine is built) against the JAX factory over an n-device
    mesh."""
    jf = jregistry.EngineFactory(jmodels.build("mlp", platform="cpu"),
                                 make_mesh(eight_devices[:n]),
                                 max_batch=64, replicas=replicas)
    want = [[d.id for d in m.devices.flat] for m in jf.meshes]
    assert tmesh.place_replicas(list(range(n)), replicas) == want
    tf = EngineFactory("mlp", device="cpu", max_batch=64, replicas=replicas,
                       devices=[torch.device("cpu", i) for i in range(n)])
    assert [[d.index for d in g] for g in tf.replica_devices] == want
    assert (tf.n_chips, tf.total_chips) == (jf.n_chips, jf.total_chips)
    assert tuple(tf.buckets) == tuple(jf.buckets)
    assert tf.make_router().n_chips == jf.make_router().n_chips


def test_get_devices_takes_the_first_n_and_refuses_more_than_visible():
    assert tmesh.get_devices("cpu") == [CPU]
    assert tmesh.get_devices("cpu", 1) == [CPU]
    with pytest.raises(ValueError, match="num_devices must be >= 1"):
        tmesh.get_devices("cpu", 0)
    with pytest.raises(RuntimeError) as ours:
        tmesh.get_devices("cpu", 3)
    with pytest.raises(RuntimeError) as theirs:
        jget_devices("cpu", 9)
    pattern = r"^requested (\d+) devices, only (\d+) visible"
    assert re.match(pattern, str(ours.value)).groups() == ("3", "1")
    assert re.match(pattern, str(theirs.value)).groups() == ("9", "8")


def test_build_serving_refuses_more_devices_than_visible():
    with pytest.raises(RuntimeError,
                       match="^requested 2 devices, only 1 visible"):
        build_serving(tconfig.Config(model="mlp", device="cpu",
                                     num_devices=2, serve_max_batch=8))
    _, router, factory = build_serving(tconfig.Config(
        model="mlp", device="cpu", num_devices=1, serve_max_batch=8))
    assert factory.devices == [CPU] and factory.n_chips == 1
    assert router.buckets == (1, 2, 4, 8)


# -- the group engine against JAX's engine over k devices ----------------------


def _jax_and_port(model: str, seed: int):
    if model == "mlp":
        jm = jmodels.build("mlp", fused="pallas", platform="cpu")
    else:
        jm = jmodels.build("lenet", platform="cpu")
    flax = jm.init(jax.random.PRNGKey(seed),
                   jnp.zeros((1, 28, 28, 1)))["params"]
    to_port = (interop.mlp_params_from_flax if model == "mlp"
               else interop.lenet_params_from_flax)
    return jm, flax, to_port(jax.tree.map(np.asarray, flax))


CASES = [(m, dt, k) for m, dts in (("mlp", ("float32", "bfloat16", "int8",
                                            "megakernel")),
                                   ("lenet", ("float32", "bfloat16", "int8")))
         for dt in dts for k in (2, 4, 8)]


@pytest.mark.parametrize("model,infer_dtype,k", CASES,
                         ids=[f"{m}-{dt}-k{k}" for m, dt, k in CASES])
def test_group_engine_equals_jax_k_device_engine(eight_devices, model,
                                                 infer_dtype, k):
    jm, flax, params = _jax_and_port(model, seed=k)
    jeng = JEngine(jm, flax, make_mesh(eight_devices[:k]),
                   max_batch=MAX_BATCH, infer_dtype=infer_dtype,
                   fused_mode="pallas")
    eng = InferenceEngine(model, params, devices=[CPU] * k,
                          max_batch=MAX_BATCH, infer_dtype=infer_dtype)
    assert eng.n_chips == jeng.n_chips == k
    assert eng.buckets == tuple(jeng.buckets) == make_buckets(MAX_BATCH, k)
    x = _images(MAX_BATCH, seed=10 + k)
    for n in range(1, MAX_BATCH + 1):
        want = np.asarray(jeng.infer(x[:n]))
        got = eng.infer(x[:n])
        assert got.shape == (n, 10) and got.dtype == np.float32
        if infer_dtype == "int8":
            assert got.tobytes() == want.tobytes(), n
            continue
        tol = TOL[model][infer_dtype]
        rtol = 0 if model == "lenet" and infer_dtype == "bfloat16" else tol
        np.testing.assert_allclose(got, want, rtol=rtol,
                                   atol=tol * _scale(want), err_msg=str(n))


@pytest.mark.parametrize("infer_dtype", ["float32", "bfloat16", "int8",
                                         "megakernel"])
def test_group_engine_gives_the_one_device_engines_answers(infer_dtype):
    """Every row's logits are a function of that row alone: the k-shard
    engine's answer is the one-device engine's, int8 bit for bit (exact
    products), the float forwards at the tolerances above (a matmul's
    blocking, and so its rounding, may change with its row count)."""
    params = models.init_params("mlp", 3)
    one = InferenceEngine("mlp", params, device="cpu", max_batch=MAX_BATCH,
                          infer_dtype=infer_dtype)
    x = _images(MAX_BATCH, seed=4)
    for k in (2, 4):
        eng = InferenceEngine("mlp", params, devices=["cpu"] * k,
                              max_batch=MAX_BATCH, infer_dtype=infer_dtype)
        for n in (1, k - 1, k, k + 1, MAX_BATCH):
            got, want = eng.infer(x[:n]), one.infer(x[:n])
            if infer_dtype == "int8":
                assert got.tobytes() == want.tobytes(), (k, n)
            else:
                tol = TOL["mlp"][infer_dtype]
                np.testing.assert_allclose(got, want, rtol=tol,
                                           atol=tol * _scale(want))


# -- the group engine's own contract ----------------------------------------------


def test_group_engine_refuses_a_ladder_off_its_width_and_mixed_streams():
    params = models.init_params("mlp", 0)
    with pytest.raises(ValueError, match="must be multiples of the "
                                         "data-parallel width 2"):
        InferenceEngine("mlp", params, devices=["cpu"] * 2, buckets=(2, 3))
    with pytest.raises(ValueError, match="must be multiples of the "
                                         "data-parallel width 4"):
        JEngine(jmodels.build("mlp", platform="cpu"),
                jmodels.build("mlp", platform="cpu").init(
                    jax.random.PRNGKey(0), jnp.zeros((1, 28, 28, 1)))[
                    "params"], make_mesh(jax.devices()[:4]), buckets=(4, 6))
    with pytest.raises(ValueError, match="one stream a device"):
        InferenceEngine("mlp", params, devices=["cpu"] * 2,
                        streams=[None])


def test_group_fast_lane_splits_exact_fits_and_prices_the_row_route():
    params = models.init_params("mlp", 1)
    # int8: exact products, so a row's answer is bit for bit the same in
    # any row count
    one = InferenceEngine("mlp", params, device="cpu", max_batch=16,
                          infer_dtype="int8")
    eng = InferenceEngine("mlp", params, devices=["cpu"] * 4, max_batch=16,
                          infer_dtype="int8")
    assert eng.buckets == (4, 8, 16)
    eng.warmup(cost_samples=1)
    # the smallest rung is 4: a lone row can take only the row route,
    # priced at warmup against the 4-row pooled dispatch
    assert eng.fast_row_cost() is not None
    assert eng._fast_row_ok == (eng.fast_row_cost()
                                <= eng.bucket_costs()[4])
    assert tuple(eng._fast_row_buf.shape) == (1, 28, 28, 1)   # shard 0's
    x = _images(8, seed=6)
    eng._fast_row_ok = True
    h = eng.dispatch_fast(x[:1])
    assert h is not None and h.resident
    assert eng.fetch(h).tobytes() == one.infer(x[:1]).tobytes()
    eng._fast_row_ok = False
    assert eng.dispatch_fast(x[:1]) is None     # no route fits: pooled
    h = eng.dispatch_fast(x[:8])                # exact fit, split 4 ways
    assert h is not None and h.bucket == 8
    assert eng.fetch(h).tobytes() == one.infer(x[:8]).tobytes()
    assert eng.dispatch_fast(x[:5]) is None


def test_a_shard_that_fails_fails_the_dispatch_and_recycles_staging():
    eng = InferenceEngine("mlp", models.init_params("mlp", 0),
                          devices=["cpu"] * 2, max_batch=8)
    real = eng._device_forwards[CPU]
    calls = {"n": 0}

    def second_shard_fails(x):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("shard 1 launch failed")
        return real(x)

    eng._device_forwards[CPU] = second_shard_fails
    with pytest.raises(RuntimeError, match="shard 1 launch failed"):
        eng.dispatch(_images(5))
    assert calls["n"] == 2
    assert eng.staging_buffers()[8] == 1      # back in the pool
    eng._device_forwards[CPU] = real
    assert eng.infer(_images(5)).shape == (5, 10)


def test_fleet_of_group_replicas_serves_through_the_batcher():
    """Two replicas cut from four devices get two each (the JAX rule),
    every engine of a version is a two-shard engine on its replica's
    devices, and the batcher's int8 answers are the one-device int8
    engine's, bit for bit."""
    factory = EngineFactory("mlp", device="cpu", max_batch=16, replicas=2,
                            devices=[CPU] * 4)
    assert factory.replica_devices == [[CPU, CPU], [CPU, CPU]]
    assert factory.n_chips == 2 and factory.buckets == (2, 4, 8, 16)
    metrics = ServeMetrics()
    fleet = factory.make_fleet(metrics=metrics)
    assert fleet.n_chips == 2
    registry = ModelRegistry(factory, fleet)
    params = models.init_params("mlp", 2)
    registry.add(params, version="v1")
    registry.promote("v1")
    # fresh-init weights have near-tie logits: the gate is opened, the
    # answers are held bit for bit below
    registry.add_variant("v1", "int8", min_agreement=0.0,
                         max_rel_diff=1e9)
    registry.promote("v1", infer_dtype="int8")
    assert [e.n_chips for e in registry.get("v1").engines] == [2, 2]
    one = InferenceEngine("mlp", params, device="cpu", max_batch=16,
                          infer_dtype="int8")
    x = _images(48, seed=8)
    b = DynamicBatcher(fleet, max_wait_us=200, metrics=metrics).start()
    try:
        futs = [b.submit(x[i:i + 3]) for i in range(0, 48, 3)]
        out = np.concatenate([f.result(timeout=60) for f in futs])
    finally:
        b.stop()
    assert out.tobytes() == one.infer(x[:16]).tobytes() + one.infer(
        x[16:32]).tobytes() + one.infer(x[32:]).tobytes()


def test_torchcheck_audits_a_group_target():
    """A two-shard target: its warmed universe equals jaxcheck's for the
    n_chips=2 ladder, it audits clean, and each rung's recorded forward
    is the one-device target's at half the rows (a shard's program)."""
    ladder = make_buckets(16, 2)
    assert ladder == jmake_buckets(16, 2)
    for dt in ("float32", "bfloat16", "int8", "megakernel"):
        assert tc.warmed_buckets(ladder, dt, 2) == jc.warmed_buckets(
            ladder, dt)
    group = tc.audit_target(tc.AuditTarget(model="mlp", serve_max_batch=16,
                                           n_chips=2), "cpu")
    assert group["findings"] == [] and group["n_chips"] == 2
    assert group["buckets"] == [2, 4, 8, 16]
    assert "-c2-" in group["label"]
    one = tc.audit_target(tc.AuditTarget(model="mlp", serve_max_batch=8,
                                         buckets=(1, 2, 4, 8)), "cpu")
    for dt in ("float32", "int8", "megakernel"):
        for b in (2, 4, 8, 16):
            assert group["fingerprints"][f"mlp/{dt}/b{b}"] == \
                one["fingerprints"][f"mlp/{dt}/b{b // 2}"]
    summary = tc.compile_surface_summary("mlp", ladder, 16, "int8",
                                         n_chips=2)
    assert summary["findings"] == 0


def test_dry_run_serves_over_n_devices():
    assert dryrun.serve_group(3, "cpu") == [CPU] * 3
    launched = dryrun.serve_reload(2, "cpu")
    assert set(launched) == {"dense_relu", "quant_dense", "mlp_megakernel"}


# -- the CLIs -----------------------------------------------------------------------


def test_serve_cli_num_devices(capsys):
    assert serve_main(["--device", "cpu", "--model", "mlp", "--num-devices",
                       "1", "--selftest", "16", "--serve-max-batch",
                       "8"]) in (0, None)
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{") and "serve_selftest" in ln]
    summary = json.loads(lines[-1])
    assert summary["devices"] == ["cpu"] and summary["device"] == "cpu"
    assert summary["rejected_requests"] == 0
    with pytest.raises(RuntimeError,
                       match="requested 2 devices, only 1 visible"):
        serve_main(["--device", "cpu", "--model", "mlp", "--num-devices",
                    "2", "--selftest", "4", "--serve-max-batch", "8"])


def test_bench_serve_accepts_num_devices_1_on_the_cpu(capsys):
    rc = tbench.main(["serve", "--device", "cpu", "--model", "mlp",
                      "--num-devices", "1", "--serve-duration", "0.2",
                      "--serve-qps", "50", "--serve-clients", "2",
                      "--serve-max-batch", "8", "--no-artifact",
                      "--inline"])
    assert rc == 0
    rec = json.loads([ln for ln in capsys.readouterr().out.splitlines()
                      if ln.startswith("{")][-1])
    assert rec["metric"] == "serve_images_per_sec_per_chip"
    assert rec["detail"]["n_chips"] == 1
    assert rec["detail"]["buckets"] == [1, 2, 4, 8]
