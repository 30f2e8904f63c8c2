"""The PyTorch port's LeNet-5 serving slice against the JAX package, on
the CPU: the float32 engine, the bfloat16 and int8 variants
(prepare_inference), the registry's checkpoint lifecycle (load_latest,
bootstrap, rollback, eviction) over checkpoints the port's own trainer
and Checkpointer write, the parity gates on trained weights, and the
selftest CLI booted from a checkpoint of the train CLI.

Weights: a module fixture trains LeNet-5 for 300 Adam steps through the
port's trainer on the parity batch's synthetic distribution (synthetic
templates are drawn per seed, and a model fit on other templates has
near-tie logits on the held-out batch, which int8/bf16 rounding flips).

Tolerances:
- float32 engine: rtol 1e-5 and atol 1e-5 times the logits' scale (the
  same function, its sums of up to 400 terms in another order);
- int8: quantized weights, scales, activation scales and the dense stack
  on a shared 400-wide input bit-identical to the JAX package's
  reference; the whole forward at atol 5e-3 times the logits' scale and
  argmax agreement >= 0.995 (the two frameworks' f32 conv trunks sum in
  other orders, which can move a quantized activation across a rounding
  boundary, a step of about 1e-3 of the scale; measured 7e-8 on trained
  weights);
- bfloat16: atol 3e-2 times the logits' scale and argmax agreement >=
  0.995 (one bf16 rounding is 2**-8 relative; the two frameworks round
  the convolutions' and the logits' bf16 results at different points,
  through five layers; measured 8e-3 to 9e-3 on trained weights).
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from distributedmnist_tpu import models as jmodels
from distributedmnist_tpu.ops import fused as jfused
from distributedmnist_tpu.parallel import make_mesh
from distributedmnist_tpu.serve import quantize as jquantize
from distributedmnist_tpu.serve.engine import \
    InferenceEngine as JInferenceEngine
from distributedmnist_tpu_torch import checkpoint as tcheckpoint
from distributedmnist_tpu_torch import config as tconfig
from distributedmnist_tpu_torch import models
from distributedmnist_tpu_torch import optim as toptim
from distributedmnist_tpu_torch import trainer as ttrainer
from distributedmnist_tpu_torch.checkpoint import Checkpointer
from distributedmnist_tpu_torch.data import synthetic_mnist
from distributedmnist_tpu_torch.models.lenet import LAYERS
from distributedmnist_tpu_torch.serve import (PARITY_GATES, DynamicBatcher,
                                              EngineFactory, InferenceEngine,
                                              ModelRegistry, ServeMetrics,
                                              build_serving)
from distributedmnist_tpu_torch.serve import quantize as tquantize
from distributedmnist_tpu_torch.serve.quantize import PARITY_SEED
from distributedmnist_tpu_torch.utils import logit_parity
from idx_util import write_idx_fixtures

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN_STEPS = 300
MAX_BATCH = 8


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """{dir, params, steps}: LeNet-5 trained by the port's trainer
    (config 2's recipe, 300 steps), checkpoints committed at 150 and
    300."""
    d = str(tmp_path_factory.mktemp("lenet_ckpt"))
    data = synthetic_mnist(seed=PARITY_SEED, train_n=4096, test_n=512)
    cfg = tconfig.PRESETS["lenet-adam"].replace(
        device="cpu", synthetic=True, steps=TRAIN_STEPS, eval_every=1000,
        log_every=0, target_accuracy=None, checkpoint_dir=d,
        checkpoint_every=TRAIN_STEPS // 2, seed=PARITY_SEED)
    out = ttrainer.fit(cfg, data=data)
    assert out["steps"] == TRAIN_STEPS and out["test_accuracy"] > 0.9
    params, step = tcheckpoint.restore_latest_params(d)
    assert step == TRAIN_STEPS
    return {"dir": d, "params": params,
            "steps": tcheckpoint.committed_steps(d)}


def _flax(params) -> dict:
    """The port's LeNet state_dict as a flax param tree (numpy)."""
    return {name: {leaf: params[f"{name}.{leaf}"].numpy()
                   for leaf in ("kernel", "bias")}
            for name, _, _ in LAYERS}


def _parity_images(n=128):
    """The held-out parity batch (the registry's gate batch)."""
    return synthetic_mnist(seed=PARITY_SEED, train_n=16,
                           test_n=n)["test_x"][:n]


def _scale(logits) -> float:
    return max(1.0, float(np.abs(logits).max()))


# -- the engines --------------------------------------------------------------


def test_lenet_engine_f32_matches_jax_every_bucket(trained):
    jm = jmodels.build("lenet", platform="cpu")
    jengine = JInferenceEngine(jm, _flax(trained["params"]),
                               make_mesh(jax.devices()[:1]),
                               max_batch=MAX_BATCH)
    engine = InferenceEngine("lenet", trained["params"], device="cpu",
                             max_batch=MAX_BATCH)
    assert engine.buckets == tuple(jengine.buckets) == (1, 2, 4, 8)
    assert engine.warmup(cost_samples=1) == 0
    x = _parity_images(MAX_BATCH)
    want = np.asarray(jengine.infer(x))
    for n in (1, 2, 3, 4, 5, 8):        # exact fits and padded buckets
        got = engine.infer(x[:n])
        assert got.shape == (n, 10) and got.dtype == np.float32
        np.testing.assert_allclose(got, want[:n], rtol=1e-5,
                                   atol=1e-5 * _scale(want))
    got = engine.infer([x[:3], x[3:5].reshape(2, 784)])
    np.testing.assert_allclose(got, want[:5], rtol=1e-5,
                               atol=1e-5 * _scale(want))


def _jax_variant(params, infer_dtype):
    jm = jmodels.build("lenet", platform="cpu")
    return jquantize.prepare_inference(jm, _flax(params), infer_dtype,
                                       jfused.PALLAS_INTERPRET)


def _jax_dense_layer(jprep, n, x, mode):
    """One layer of the JAX package's int8 dense stack (its
    _prepare_lenet forward after the flatten): (int8 input, output)."""
    xq = jquantize.quantize_act_static(x, jprep[n]["act_scale"])
    return xq, jfused.quant_dense(xq, jprep[n]["q"],
                                  jprep[n]["scale"] * jprep[n]["act_scale"],
                                  jprep[n]["bias"], relu=n != "logits",
                                  mode=mode)


def test_lenet_int8_prep_and_dense_stack_bit_identical_to_jax(trained):
    params = trained["params"]
    jprep, _ = _jax_variant(params, "int8")
    tprep, _ = tquantize.prepare_inference("lenet", params, "int8")
    for n in ("conv1", "conv2"):
        np.testing.assert_array_equal(tprep[f"{n}.kernel"].numpy(),
                                      jprep[n]["kernel"])
        np.testing.assert_array_equal(tprep[f"{n}.bias"].numpy(),
                                      jprep[n]["bias"])
    for n in ("fc1", "fc2", "logits"):
        assert tprep[f"{n}.q"].dtype == torch.int8
        np.testing.assert_array_equal(tprep[f"{n}.q"].numpy(), jprep[n]["q"])
        np.testing.assert_array_equal(tprep[f"{n}.act_scale"].numpy(),
                                      jprep[n]["act_scale"])
        np.testing.assert_array_equal(
            tprep[f"{n}.scale"].numpy(),
            np.asarray(jprep[n]["scale"] * jprep[n]["act_scale"],
                       np.float32))
        np.testing.assert_array_equal(tprep[f"{n}.bias"].numpy(),
                                      jprep[n]["bias"])
    # one 400-wide input through both dense stacks: the port's trunk
    # output on the calibration batch (the parity batch and a
    # dense-random block)
    x = tquantize.lenet_trunk(
        tprep, torch.from_numpy(tquantize.calibration_batch()).float())
    assert tuple(x.shape) == (160, 400) and x.is_contiguous()
    # Layer by layer on the same input: the int8 activations are equal,
    # and the outputs equal those of the JAX package's quant_dense
    # reference (its XLA route) bit for bit. Its Pallas kernel in
    # interpret mode contracts the epilogue acc * scale + b into one
    # fused multiply-add on the CPU (one rounding, not two), so it may
    # differ from its own reference by an ulp of the product acc * scale:
    # held at rtol 1e-6 and atol 1e-6 times the output's scale (where
    # the bias cancels the product, an ulp of it is large relative to
    # the result).
    h = x.numpy()
    for n in ("fc1", "fc2", "logits"):
        tq_in = tquantize.quantize_act_static(torch.from_numpy(h),
                                              tprep[f"{n}.act_scale"])
        got = tquantize.fused.quant_dense(
            tq_in, tprep[f"{n}.q"], tprep[f"{n}.scale"],
            tprep[f"{n}.bias"], relu=n != "logits").numpy()
        jq_in, want = _jax_dense_layer(jprep, n, h, jfused.XLA)
        np.testing.assert_array_equal(tq_in.numpy(), np.asarray(jq_in))
        np.testing.assert_array_equal(got, np.asarray(want))
        _, interp = _jax_dense_layer(jprep, n, h, jfused.PALLAS_INTERPRET)
        np.testing.assert_allclose(got, np.asarray(interp), rtol=1e-6,
                                   atol=1e-6 * _scale(got))
        h = got
    # and the whole stack, as the int8 forward runs it
    np.testing.assert_array_equal(
        tquantize.lenet_int8_dense_stack(tprep, x).numpy(), h)


@pytest.mark.parametrize("infer_dtype", ["bfloat16", "int8"])
def test_lenet_variant_matches_jax_prepare_inference(trained, infer_dtype):
    params = trained["params"]
    jprep, jfwd = _jax_variant(params, infer_dtype)
    x = _parity_images()
    want = np.asarray(jax.jit(jfwd)(jprep, x))
    engine = InferenceEngine("lenet", params, device="cpu", max_batch=128,
                             infer_dtype=infer_dtype)
    got = engine.infer(x)
    assert got.shape == (128, 10) and got.dtype == np.float32
    if infer_dtype == "bfloat16":
        tprep, _ = tquantize.prepare_inference("lenet", params, "bfloat16")
        for n, _, _ in LAYERS:
            for leaf in ("kernel", "bias"):
                t = tprep[f"{n}.{leaf}"]
                assert t.dtype == torch.bfloat16
                np.testing.assert_array_equal(
                    t.float().numpy(),
                    np.asarray(jprep[n][leaf], np.float32))
    atol = (3e-2 if infer_dtype == "bfloat16" else 5e-3) * _scale(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    rep = logit_parity(want, got)
    assert rep["argmax_agreement"] >= 0.995, rep


def test_lenet_has_no_megakernel():
    assert not tquantize.variant_supported("lenet", "megakernel")
    assert tquantize.variant_supported("lenet", "int8")
    with pytest.raises(ValueError, match="MLP only"):
        tquantize.prepare_inference("lenet", models.init_params("lenet"),
                                    "megakernel")
    with pytest.raises(ValueError, match="float32 serves"):
        tquantize.prepare_inference("lenet", models.init_params("lenet"),
                                    "float32")


# -- the registry's checkpoint lifecycle ---------------------------------------


def _save(directory, step, params):
    """Commit `params` as step `step` with a full train state (Adam
    moments and schedule), as the trainer writes it."""
    net = models.build("lenet", device="cpu")
    net.load_state_dict(params)
    opt, sched = toptim.build("adam", net.parameters(),
                              toptim.make_schedule(1e-3))
    ck = Checkpointer(str(directory))
    ck.save(step, {"params": params, "optimizer": opt.state_dict(),
                   "scheduler": sched.state_dict()})
    ck.close()


def _registry(**kw):
    factory = EngineFactory("lenet", device="cpu", max_batch=MAX_BATCH)
    router = factory.make_router()
    return ModelRegistry(factory, router, **kw), router, factory


def test_load_latest_is_params_only_and_correct(tmp_path):
    params = models.init_params("lenet", seed=9)
    _save(tmp_path / "c", 7, params)
    registry, router, _ = _registry()
    mv = registry.load_latest(str(tmp_path / "c"))
    assert mv.version == "step-7" and mv.step == 7 and mv.state == "ready"
    assert mv.source == f"checkpoint {tmp_path / 'c'}"
    registry.promote(mv.version)
    x = _parity_images(5)
    net = models.build("lenet", device="cpu")
    net.load_state_dict(params)
    with torch.no_grad():
        want = net(torch.from_numpy(x).float() / 255.0).numpy()
    np.testing.assert_array_equal(router.infer(x), want)


def test_load_latest_no_checkpoint_raises(tmp_path):
    registry, _, _ = _registry()
    with pytest.raises(FileNotFoundError, match="no committed"):
        registry.load_latest(str(tmp_path / "empty"))
    with pytest.raises(ValueError, match="checkpoint directory"):
        registry.load_latest()            # no directory configured


def test_load_latest_is_idempotent_per_step(tmp_path, monkeypatch):
    """A reload with no new checkpoint returns the resident version
    without reading the checkpoint again."""
    _save(tmp_path / "c", 5, models.init_params("lenet", seed=5))
    registry, _, _ = _registry()
    calls = []
    real = tcheckpoint.restore_latest_params
    monkeypatch.setattr(tcheckpoint, "restore_latest_params",
                        lambda *a, **k: calls.append(k) or real(*a, **k))
    mv1 = registry.load_latest(str(tmp_path / "c"))
    mv2 = registry.load_latest(str(tmp_path / "c"))
    assert mv1 is mv2 and len(registry.describe()["versions"]) == 1
    assert len(calls) == 1 and calls[0]["step"] == 5   # the pinned step


def test_load_latest_explicit_name_refuses_stale_step(tmp_path):
    d = tmp_path / "c"
    _save(d, 5, models.init_params("lenet", seed=5))
    registry, _, _ = _registry()
    mv = registry.load_latest(str(d), version="candidate")
    assert mv.step == 5
    assert registry.load_latest(str(d), version="candidate") is mv
    _save(d, 9, models.init_params("lenet", seed=9))
    with pytest.raises(ValueError, match="already holds step 5"):
        registry.load_latest(str(d), version="candidate")
    assert registry.load_latest(str(d)).step == 9


def test_failed_restore_is_recorded_then_retryable(tmp_path, monkeypatch):
    d = tmp_path / "c"
    _save(d, 3, models.init_params("lenet", seed=3))
    registry, _, _ = _registry()
    real = tcheckpoint.restore_latest_params
    fail = [OSError("injected read error")]

    def flaky(*a, **k):
        if fail:
            raise fail.pop()
        return real(*a, **k)

    monkeypatch.setattr(tcheckpoint, "restore_latest_params", flaky)
    with pytest.raises(OSError, match="injected"):
        registry.load_latest(str(d))
    failed = registry.get("step-3")
    assert failed.state == "failed" and failed.step == 3
    assert failed.last_error == "restore: OSError: injected read error"
    mv = registry.load_latest(str(d))          # the retry loads
    assert mv.state == "ready" and mv.last_error is None
    # a checkpoint of another model is refused against the template
    mlp_dir = tmp_path / "mlp"
    ck = Checkpointer(str(mlp_dir))
    ck.save(4, {"params": models.init_params("mlp"), "optimizer": {},
                "scheduler": {}})
    ck.close()
    with pytest.raises(ValueError, match="does not hold params"):
        registry.load_latest(str(mlp_dir))
    assert registry.get("step-4").state == "failed"


def test_bootstrap_from_checkpoint_and_fresh_without(tmp_path):
    registry, router, _ = _registry(checkpoint_dir=str(tmp_path / "none"))
    fresh = registry.bootstrap(seed=0)
    assert fresh.source == "fresh-init" and fresh.step is None
    assert router.live_version() == fresh.version
    _save(tmp_path / "c", 11, models.init_params("lenet", seed=11))
    registry, router, _ = _registry(checkpoint_dir=str(tmp_path / "c"))
    mv = registry.bootstrap(seed=0)
    assert (mv.version, mv.step, mv.state) == ("step-11", 11, "live")
    assert router.routes()["live"] == "step-11"
    desc = registry.describe()
    assert desc["versions"][0]["step"] == 11 and desc["events"] == []
    assert desc["checkpoint_dir"] == str(tmp_path / "c")
    assert desc["max_versions"] == 4


def test_rollback_promotes_the_newest_healthy_resident(tmp_path):
    d = tmp_path / "c"
    registry, router, _ = _registry(checkpoint_dir=str(d))
    for step in (5, 7, 9):
        _save(d, step, models.init_params("lenet", seed=step))
        registry.load_latest()
    registry.promote("step-9")
    assert registry.rollback("step-7", "not live") is None   # no event
    assert registry.events() == []
    target = registry.rollback("step-9", "error rate")
    assert target.version == "step-7"             # newest healthy
    assert router.live_version() == "step-7"
    tripped = registry.get("step-9")
    assert tripped.state == "ready" and tripped.last_error == "error rate"
    ev = registry.events()[-1]
    assert (ev["event"], ev["from"], ev["to"], ev["reason"]) == (
        "rollback", "step-9", "step-7", "error rate")
    # the tripped version is never rolled back to
    assert registry.rollback("step-7", "again").version == "step-5"
    target = registry.rollback("step-5", "no fallback left")
    assert target is None and router.live_version() == "step-5"
    ev = registry.events()[-1]
    assert ev["event"] == "rollback_failed" and ev["to"] is None
    assert registry.describe()["events"] == registry.events()


def test_eviction_keeps_live_and_caps_residency():
    registry, _, factory = _registry(max_versions=2)
    registry.promote(registry.add(factory.init_params(0),
                                  version="v1").version)
    registry.add(factory.init_params(1), version="v2")
    registry.add(factory.init_params(2), version="v3")
    names = [v["version"] for v in registry.describe()["versions"]]
    assert names == ["v1", "v3"]   # live kept, just-added kept, v2 gone
    registry.promote("v3")         # v1 demoted to ready, still resident
    registry.add(factory.init_params(3), version="v4")
    names = [v["version"] for v in registry.describe()["versions"]]
    assert names == ["v3", "v4"]
    with pytest.raises(ValueError, match="max_versions"):
        ModelRegistry(factory, factory.make_router(), max_versions=1)


def test_lifecycle_config_matches_jax_and_cli_refuses_one_version(capsys):
    from distributedmnist_tpu import config as jconfig
    from distributedmnist_tpu_torch.serve.__main__ import main as serve_main

    assert tconfig.Config().serve_max_versions \
        == jconfig.Config().serve_max_versions == 4
    with pytest.raises(SystemExit) as e:
        serve_main(["--device", "cpu", "--serve-max-versions", "1"])
    assert e.value.code == 2
    assert "--serve-max-versions must be >= 2" in capsys.readouterr().err


# -- trained weights through the gates ----------------------------------------


def test_lenet_trained_checkpoint_gates_and_serves(trained):
    cfg = tconfig.Config(model="lenet", device="cpu", serve_max_batch=128,
                         checkpoint_dir=trained["dir"])
    registry, router, factory = build_serving(cfg)
    mv = registry.bootstrap()
    assert mv.version == f"step-{TRAIN_STEPS}" and mv.state == "live"
    x = _parity_images(64)
    metrics = ServeMetrics()
    for dt in ("bfloat16", "int8"):
        assert registry.activate_infer_dtype(mv.version, dt) == dt
        vi = registry.get(mv.version).variants[dt]
        gate_agree, gate_rel = PARITY_GATES[dt]
        assert vi.parity["passed"] and vi.parity["rows"] == 128
        assert vi.parity["argmax_agreement"] >= gate_agree
        assert vi.parity["max_rel_logit_diff"] <= gate_rel
        assert router.live_infer_dtype() == dt
        b = DynamicBatcher(router, max_batch=32, metrics=metrics).start()
        try:
            futs = [b.submit(x[i:i + 4]) for i in range(0, 64, 4)]
            out = np.concatenate([f.result(timeout=60) for f in futs])
        finally:
            b.stop()
        np.testing.assert_array_equal(out, vi.engine.infer(x))
    # auto tries bfloat16 and int8 and never the megakernel
    assert registry.activate_infer_dtype(mv.version, "auto") in (
        "float32", "bfloat16", "int8")
    assert set(registry.get(mv.version).variants) == {"bfloat16", "int8"}
    assert metrics.snapshot()["requests"] == 32


def test_serve_cli_boots_lenet_from_the_train_cli_checkpoint(tmp_path):
    """Train with the port's train CLI, then serve its checkpoint with the
    selftest CLI, each in a fresh interpreter: int8 goes live through the
    gate, the version carries its step, and neither process imports jax
    or the JAX package."""
    src = synthetic_mnist(seed=PARITY_SEED, train_n=4096, test_n=256)
    data_dir, ckpt = tmp_path / "data", tmp_path / "ckpt"
    data_dir.mkdir()
    write_idx_fixtures(data_dir, src)
    guard = ("bad = sorted(m for m in sys.modules if m == 'jax' "
             "or m.startswith('jax.') or m == 'distributedmnist_tpu' "
             "or m.startswith('distributedmnist_tpu.'))\n"
             "print('MODULES ' + json.dumps(bad))\n"
             "sys.exit(rc)\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    runs = (
        ("distributedmnist_tpu_torch.train",
         ["--device", "cpu", "--preset", "lenet-adam", "--data-dir",
          str(data_dir), "--steps", str(TRAIN_STEPS), "--eval-every",
          "1000", "--log-every", "0", "--seed", str(PARITY_SEED),
          "--checkpoint-dir", str(ckpt)]),
        ("distributedmnist_tpu_torch.serve.__main__",
         ["--device", "cpu", "--model", "lenet", "--checkpoint-dir",
          str(ckpt), "--selftest", "48", "--serve-max-batch", "16",
          "--serve-infer-dtype", "int8"]))
    out = []
    for module, argv in runs:
        code = (f"import json, sys\nfrom {module} import main\n"
                f"rc = main({argv!r})\n" + guard)
        proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                              env=env, capture_output=True, text=True,
                              timeout=300)
        assert proc.returncode == 0, proc.stderr[-3000:]
        lines = proc.stdout.strip().splitlines()
        assert json.loads(lines[-1].split(" ", 1)[1]) == []
        out.append(json.loads(lines[-2]))
    trained_run, s = out
    assert trained_run["steps"] == TRAIN_STEPS
    assert s["metric"] == "serve_selftest" and s["device"] == "cpu"
    assert s["requests"] == 48 and s["rejected_requests"] == 0
    assert s["live_infer_dtype"] == "int8"
    (v,) = s["versions"]
    assert v["version"] == f"step-{TRAIN_STEPS}"
    assert v["step"] == TRAIN_STEPS and v["state"] == "live"
    assert v["source"] == f"checkpoint {ckpt}"
    assert v["variants"]["int8"]["parity"]["passed"] is True
