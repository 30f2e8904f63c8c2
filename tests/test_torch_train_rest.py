"""The rest of the port's training against the JAX package, on the CPU:
the config fields and flags, bfloat16 training, the streaming pipeline
(data/host_loader.py), the native IDX reader (data/native), process
supervision (utils/supervise.py), --profile-dir, the flat optimizer
switch and the im2col convolutions; and that none of the new modules
imports jax.

Tolerances, each where it is used:
- bfloat16 forwards, logits against JAX's: atol 4e-2 times the logits'
  scale (a few bf16 roundings, 2**-8 relative each, at other points of
  the two frameworks' sums); 20 bfloat16 steps: losses rtol 2e-2 (the
  parameters themselves are rounded to bf16 after every update, in both
  packages, and the roundings land apart);
- the streaming pipeline against the device pipeline, and the tfdata
  source against numpy: the same losses, bit for bit (the same pixels
  and the same ops in the same order);
- im2col against lax: forward 1e-5, gradients rtol 1e-4 and atol 1e-5
  (JAX's tests/test_conv.py's tolerances);
- flat_optimizer on and off: bit for bit.
"""

import argparse
import gzip
import inspect
import json
import os
import struct
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedmnist_tpu import config as jconfig
from distributedmnist_tpu import models as jmodels
from distributedmnist_tpu import optim as joptim
from distributedmnist_tpu import trainer as jtrainer
from distributedmnist_tpu.data.host_loader import HostStream as JHostStream
from distributedmnist_tpu.parallel import make_mesh as jmake_mesh
from distributedmnist_tpu_torch import config as tconfig
from distributedmnist_tpu_torch import interop, models, optim, trainer
from distributedmnist_tpu_torch.config import Config
from distributedmnist_tpu_torch.data import IndexStream, native
from distributedmnist_tpu_torch.data import mnist as tmnist
from distributedmnist_tpu_torch.data import packing as tpacking
from distributedmnist_tpu_torch.data.host_loader import HostStream
from distributedmnist_tpu_torch.ops import conv as tconv
from distributedmnist_tpu_torch.utils import MetricsLogger, supervise
from torch_dp_util import REPO, launch_smoke

BASE = Config(device="cpu", synthetic=True, log_every=1,
              target_accuracy=None, model="mlp", optimizer="sgd",
              learning_rate=0.05, batch_size=64, steps=16, eval_every=16)

# the Config fields this slice ports, each with its flag's argv
FIELDS = {"model_parallel": ["--model-parallel", "2"],
          "dtype": ["--dtype", "bfloat16"],
          "data_pipeline": ["--data-pipeline", "stream"],
          "stream_source": ["--stream-source", "tfdata"],
          "profile_dir": ["--profile-dir", "prof"],
          "fused_kernels": ["--fused-kernels", "xla"],
          "conv_impl": ["--conv-impl", "im2col"],
          "flat_optimizer": ["--no-flat-optimizer"]}


@pytest.fixture(scope="module")
def small_data():
    return tmnist.synthetic_mnist(seed=1, train_n=2048, test_n=256)


def _losses(cfg, data):
    mlog = MetricsLogger()
    out = trainer.fit(cfg, data=data, log=mlog)
    return [r["loss"] for r in mlog.history if "loss" in r], out


def _choices(mod, flag):
    p = argparse.ArgumentParser()
    mod.add_args(p)
    action = next(a for a in p._actions if flag in a.option_strings)
    return action.choices


# -- config ----------------------------------------------------------------------


def test_config_fields_and_flags_match_jax():
    for f, argv in FIELDS.items():
        assert getattr(Config(), f) == getattr(jconfig.Config(), f), f
        parsed = []
        for mod in (tconfig, jconfig):
            p = argparse.ArgumentParser()
            mod.add_args(p)
            parsed.append(mod.from_args(p.parse_args(argv)))
        assert getattr(parsed[0], f) == getattr(parsed[1], f), f
        assert getattr(parsed[0], f) != getattr(Config(), f), f
        if argv[1:]:
            assert _choices(tconfig, argv[0]) == _choices(jconfig, argv[0])
    p = argparse.ArgumentParser()
    tconfig.add_args(p)
    assert tconfig.from_args(p.parse_args(
        ["--no-flat-optimizer", "--flat-optimizer"])).flat_optimizer


# -- bfloat16 --------------------------------------------------------------------


def _jax_model(name, dtype):
    fused = "pallas-interpret" if name == "mlp" else "xla"
    return jmodels.build(name, dtype=dtype, fused=fused, platform="cpu",
                         conv="lax")


def _carry(name, params):
    conv = (interop.lenet_params_from_flax if name == "lenet"
            else interop.mlp_params_from_flax)
    return conv(jax.tree.map(lambda a: np.asarray(a, np.float32), params))


def _bf16_ulp(scale):
    return 2.0 ** (np.floor(np.log2(scale)) - 7)


def _port_forward(name, params, x, dtype):
    net = models.build(name, dtype=dtype, device="cpu")
    net.load_state_dict(_carry(name, params))
    with torch.no_grad():
        return net(tpacking.normalize(torch.from_numpy(x), getattr(
            torch, dtype))).float().numpy(), net


@pytest.mark.parametrize("name", ("mlp", "lenet"))
def test_bfloat16_forward_matches_jax(name, small_data):
    """The JAX MLP on its Pallas path (interpret mode) holds its hidden
    layer in bf16, as the port's kernel path does; LeNet keeps float32
    params and computes in bf16 in both. Measured gap: the MLP bit for
    bit, LeNet 1 bf16 ulp of the logits' scale; held to 2 ulps. A float32
    forward is as close to JAX's bf16 one, so the control holds the port's
    bf16 forward away from its own float32 forward by as much as JAX's
    bf16 forward lies from JAX's float32 one."""
    jm = _jax_model(name, jnp.bfloat16)
    params = jm.init(jax.random.PRNGKey(0),
                     jnp.zeros((1, 28, 28, 1)))["params"]
    x = small_data["test_x"][:64]
    got, net = _port_forward(name, params, x, "bfloat16")
    if name == "mlp":
        assert params["hidden_kernel"].dtype == jnp.bfloat16
        assert net.hidden_kernel.dtype == torch.bfloat16
        assert net.logits_kernel.dtype == torch.float32
    want = np.asarray(jm.apply({"params": params},
                               jnp.asarray(x, jnp.bfloat16) / 255.0),
                      np.float32)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2 * _bf16_ulp(scale))
    assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.95
    # control: bf16 rounding, not a float32 forward
    got32, _ = _port_forward(name, params, x, "float32")
    want32 = np.asarray(_jax_model(name, jnp.float32).apply(
        {"params": jax.tree.map(lambda a: a.astype(jnp.float32), params)},
        jnp.asarray(x, jnp.float32) / 255.0), np.float32)
    d_port = np.abs(got - got32).mean() / scale
    d_jax = np.abs(want - want32).mean() / scale
    assert 0.5 * d_jax <= d_port <= 2 * d_jax, (d_port, d_jax)


def _bf16_losses(name, opt, lr, batch, port_dtype):
    """20 steps from the same init on the same batches: JAX's bf16 step
    (its per-leaf optimizer, whose state of a bf16 param is bf16 as the
    port's is) and the port's step at `port_dtype`."""
    data = tmnist.synthetic_mnist(seed=1, train_n=4096, test_n=16)
    jm = _jax_model(name, jnp.bfloat16)
    tx = joptim.build(opt, lr, 0.9)
    state = jtrainer.init_state(jax.random.PRNGKey(0), jm, tx,
                                jnp.zeros((1, 28, 28, 1)))
    one_step = jax.jit(jtrainer._make_one_step(
        jtrainer._forward_loss(jm, jnp.bfloat16, "packed"), tx))
    net = models.build(name, dtype=port_dtype, device="cpu")
    net.load_state_dict(_carry(name, state.params))
    optimizer, scheduler = optim.build(opt, net.parameters(),
                                       optim.make_schedule(lr), 0.9)
    step = trainer.make_train_step(net, optimizer, scheduler, "packed",
                                   dtype=getattr(torch, port_dtype))
    packed = tpacking.pack_rows(data["train_x"])
    jx, jy = jnp.asarray(packed), jnp.asarray(data["train_y"])
    tx_, ty = torch.from_numpy(packed), torch.from_numpy(
        data["train_y"]).long()
    stream = IndexStream(4096, batch, seed=0)
    jl, tl = [], []
    for _ in range(20):
        idx = stream.host_block(1)[0]
        state, loss = one_step(state, jnp.take(jx, idx, axis=0),
                               jnp.take(jy, idx, axis=0))
        jl.append(float(loss))
        tl.append(float(step(tx_, ty, torch.from_numpy(idx).long())))
    return np.array(tl), np.array(jl)


# measured 20-step gaps to JAX: MLP 1.67e-2 (torch rounds p - lr*buf
# once, optax twice), LeNet 2.6e-3
@pytest.mark.parametrize("name,opt,lr,batch,rtol",
                         (("mlp", "sgd", 0.05, 64, 2e-2),
                          ("lenet", "adam", 1e-3, 128, 5e-3)))
def test_bfloat16_steps_match_jax(name, opt, lr, batch, rtol):
    """20 steps of configs 1 and 2 in bfloat16 against JAX's. A float32
    run of the port lies as near JAX's bf16 losses, so the control holds
    the port's bf16 losses away from its own float32 losses (measured
    1.26e-2 MLP, 1.53e-3 LeNet; the float32 port and JAX's float32 part
    by 3.6e-5 over these steps)."""
    tl, jl = _bf16_losses(name, opt, lr, batch, "bfloat16")
    np.testing.assert_allclose(tl, jl, rtol=rtol)
    assert tl[-1] < tl[0]
    t32, _ = _bf16_losses(name, opt, lr, batch, "float32")
    assert np.max(np.abs(tl - t32) / np.abs(t32)) > 5e-4


def test_bfloat16_decode_is_jax_decode():
    x = tmnist.synthetic_mnist(seed=0, train_n=16, test_n=64)["test_x"]
    from distributedmnist_tpu.data import packing as jpacking
    words = tpacking.pack_rows(x)
    for got, want in (
            (trainer._decoder("u8", torch.bfloat16)(torch.from_numpy(x)),
             jnp.asarray(x).astype(jnp.bfloat16) / jnp.asarray(
                 255.0, jnp.bfloat16)),
            (trainer._decoder("packed", torch.bfloat16)(
                torch.from_numpy(words)),
             jpacking.unpack_rows(jnp.asarray(words), jnp.bfloat16))):
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want, np.float32))


# -- the streaming pipeline --------------------------------------------------------


@pytest.mark.parametrize("world", (1, 2))
def test_host_stream_order_matches_index_stream_and_jax(world, small_data):
    """Rank r's block is its columns of IndexStream's batches, and what
    JAX's HostStream places on device r of a ('data',) mesh."""
    mesh = jmake_mesh(jax.devices("cpu")[:world])
    ref = JHostStream(small_data["train_x"], small_data["train_y"], 128, 7,
                      mesh)
    ours = [HostStream(small_data["train_x"], small_data["train_y"], 128, 7,
                       "cpu", rank=r, world=world) for r in range(world)]
    idx = IndexStream(2048, 128, 7)
    for k in (3, 5, 2):        # 16 steps an epoch: crosses into epoch 1
        jx, jy = ref.next_block(k)
        want = idx.host_block(k)
        for r in range(world):
            x, y = ours[r].next_block(k)
            cols = slice(r * 128 // world, (r + 1) * 128 // world)
            assert x.dtype == torch.uint8 and y.dtype == torch.int64
            np.testing.assert_array_equal(
                x.numpy(), small_data["train_x"][want[:, cols]])
            np.testing.assert_array_equal(
                y.numpy(), small_data["train_y"][want[:, cols]])
            shard = sorted(jx.addressable_shards,
                           key=lambda s: s.device.id)[r]
            np.testing.assert_array_equal(x.numpy(), np.asarray(shard.data))
    assert all(s.step == 10 for s in ours)


def test_tfdata_source_equals_numpy(small_data):
    kw = dict(global_batch=128, seed=7, device="cpu")
    a = HostStream(small_data["train_x"], small_data["train_y"], **kw)
    b = HostStream(small_data["train_x"], small_data["train_y"],
                   source="tfdata", **kw)
    try:
        for k in (2, 2, 3):    # a block-size change mid-stream
            for ta, tb in zip(a.next_block(k), b.next_block(k)):
                assert torch.equal(ta, tb)
    finally:
        b.close()
    assert a.step == b.step == 7
    with pytest.raises(ValueError, match="host-stream source"):
        HostStream(small_data["train_x"], small_data["train_y"],
                   source="parquet", **kw)


@pytest.mark.parametrize("model", ("mlp", "lenet"))
def test_fit_stream_equals_the_device_pipeline(model, small_data):
    kw = ({} if model == "mlp" else
          dict(model="lenet", optimizer="adam", learning_rate=1e-3))
    a, _ = _losses(BASE.replace(**kw), small_data)
    b, out = _losses(BASE.replace(data_pipeline="stream", **kw), small_data)
    assert a == b and len(a) == 16
    # blocks of 5, 5, 5 and 1: the tfdata source changes its block size
    c, _ = _losses(BASE.replace(data_pipeline="stream",
                                stream_source="tfdata", steps_per_call=5,
                                **kw), small_data)
    d, _ = _losses(BASE.replace(steps_per_call=5, **kw), small_data)
    assert c == d and len(c) == 4
    assert (out["data_pipeline"], out["pixel_format"]) == ("stream", "u8")


def test_stream_rules_raise_with_jax_words(small_data):
    base = dict(device="cpu", synthetic=True, log_every=0, steps=1,
                target_accuracy=None, batch_size=128, num_devices=2,
                data_pipeline="stream")
    for kw in ({"spmd_mode": "explicit"}, {"grad_accum": 2},
               {"data_pipeline": "disk"}):
        with pytest.raises(ValueError) as want:
            jtrainer.fit(jconfig.Config(**{**base, **kw}), data=small_data)
        with pytest.raises(ValueError) as got:
            trainer.validate(Config(**{**base, **kw}), 2)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kw", ({}, {"checkpoint_every": 300},
                                {"eval_every": 1000}))
def test_streaming_steps_per_call_matches_jax(kw):
    for streaming in (False, True):
        cfg = Config(**kw)
        assert trainer._pick_steps_per_call(
            cfg, "cuda", True, streaming=streaming) == \
            jtrainer._pick_steps_per_call(jconfig.Config(**kw), "tpu", True,
                                          streaming=streaming)


def test_two_ranks_stream_equals_device_pipeline(tmp_path):
    """2 ranks over gloo, each streaming its own columns, data parallel
    and at model_parallel 2: the device pipeline's losses bit for bit."""
    runs = [{}, {"data_pipeline": "stream"},
            {"data_pipeline": "stream", "stream_source": "tfdata"},
            {"model_parallel": 2}, {"model_parallel": 2,
                                    "data_pipeline": "stream"}]
    recs, _ = launch_smoke(2, str(tmp_path), runs,
                           ("--preset", "mlp-dp2", "--steps", "8"))
    got = recs[0]
    assert got[0]["losses"] == got[1]["losses"] == got[2]["losses"]
    assert got[3]["losses"] == got[4]["losses"]
    assert [r["data_pipeline"] for r in got] == [
        "device", "stream", "stream", "device", "stream"]
    assert all(r["losses"] == g["losses"] for r, g in zip(recs[1], got))


# -- the native IDX reader (JAX's tests/test_native.py) ------------------------------


def _write_idx(path, arr):
    dims = arr.shape
    header = struct.pack(f">I{len(dims)}I", 0x0800 | len(dims), *dims)
    with open(path, "wb") as f:
        f.write(header)
        f.write(arr.astype(np.uint8).tobytes())


@pytest.fixture
def built(tmp_path, monkeypatch):
    """The reader built by g++ into a temporary directory."""
    monkeypatch.setattr(native, "_LIB", str(tmp_path / "lib" /
                                            "libidx_reader.so"))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_load_failed", False)
    if not native.ensure_built():
        pytest.skip("g++ toolchain unavailable")
    return native


def test_native_read_matches_python(built, tmp_path):
    arr = np.random.default_rng(0).integers(0, 255, (50, 28, 28)).astype(
        np.uint8)
    p = str(tmp_path / "images-idx3-ubyte")
    _write_idx(p, arr)
    before = built.READS[0]
    np.testing.assert_array_equal(built.read_idx(p), arr)
    np.testing.assert_array_equal(tmnist._read_idx(p), arr)
    assert built.READS[0] == before + 2


def test_native_read_1d(built, tmp_path):
    labels = np.arange(100, dtype=np.uint8) % 10
    p = str(tmp_path / "labels-idx1-ubyte")
    _write_idx(p, labels)
    np.testing.assert_array_equal(built.read_idx(p), labels)


def test_native_rejects_bad_magic(built, tmp_path):
    p = str(tmp_path / "bad")
    with open(p, "wb") as f:
        f.write(b"\xde\xad\xbe\xef" + b"\x00" * 16)
    with pytest.raises(ValueError, match="idx_probe"):
        built.read_idx(p)


def test_gzip_still_uses_python_path(built, tmp_path):
    arr = np.random.default_rng(1).integers(0, 255, (10, 28, 28)).astype(
        np.uint8)
    raw = str(tmp_path / "x-idx3-ubyte")
    _write_idx(raw, arr)
    with open(raw, "rb") as fin, gzip.open(raw + ".gz", "wb") as fout:
        fout.write(fin.read())
    before = built.READS[0]
    np.testing.assert_array_equal(tmnist._read_idx(raw + ".gz"), arr)
    assert built.READS[0] == before


def test_native_loads_a_data_dir_as_the_python_parser(built, tmp_path):
    from idx_util import write_idx_fixtures

    src = tmnist.synthetic_mnist(seed=2, train_n=64, test_n=32)
    write_idx_fixtures(str(tmp_path), src)
    before = built.READS[0]
    got = tmnist.load_mnist(str(tmp_path))
    assert built.READS[0] == before + 4 and got["source"] == "real"
    for k in ("train_x", "train_y", "test_x", "test_y"):
        np.testing.assert_array_equal(got[k], src[k])


def test_available_never_compiles(monkeypatch):
    calls = []
    monkeypatch.setattr(native.subprocess, "run",
                        lambda *a, **k: calls.append(a))
    native.available()
    assert calls == []


def test_python_parser_when_lib_missing(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "available", lambda: False)
    arr = np.random.default_rng(2).integers(0, 255, (5, 28, 28)).astype(
        np.uint8)
    p = str(tmp_path / "y-idx3-ubyte")
    _write_idx(p, arr)
    np.testing.assert_array_equal(tmnist._read_idx(p), arr)


# -- supervision (JAX's tests/test_supervise.py) ----------------------------------


def _script(tmp_path, body):
    script = tmp_path / "worker.py"
    script.write_text(body)
    return [str(script)]


def _accept():
    return supervise.json_record_acceptor("metric")


def test_supervise_forwards_json_result(tmp_path, capfd):
    cmd = _script(tmp_path, "import json\nprint('banner')\n"
                            "print(json.dumps({'metric': 'm', 'value': 1}))\n")
    assert supervise.run_supervised(cmd, _accept(), stall_timeout=30,
                                    attempts=1) == 0
    out = capfd.readouterr().out.strip().splitlines()
    assert json.loads(out[-1]) == {"metric": "m", "value": 1}


def test_supervise_crash_retries_then_fails(tmp_path, capfd):
    cmd = _script(tmp_path, "import sys\nprint('no json')\nsys.exit(3)\n")
    assert supervise.run_supervised(cmd, _accept(), stall_timeout=30,
                                    attempts=2) == 1
    err = capfd.readouterr().err
    assert "attempt 1/2" in err and "attempt 2/2" in err
    assert "exit code 3" in err


def test_supervise_silent_stall_is_killed(tmp_path, capfd):
    cmd = _script(tmp_path, "import time\ntime.sleep(600)\n")
    assert supervise.run_supervised(cmd, _accept(), stall_timeout=2,
                                    attempts=1) == 1
    assert "no output for 2s" in capfd.readouterr().err


def test_supervise_result_then_teardown_wedge_is_accepted(tmp_path, capfd):
    cmd = _script(tmp_path, "import json, time\n"
                            "print(json.dumps({'metric': 'm', 'value': 2}))\n"
                            "time.sleep(600)\n")
    assert supervise.run_supervised(cmd, _accept(), stall_timeout=4,
                                    attempts=1) == 0
    out = capfd.readouterr().out.strip().splitlines()
    assert json.loads(out[-1])["value"] == 2


def test_supervise_worker_env_marker(tmp_path, capfd):
    cmd = _script(tmp_path, "import json, os\n"
                            "print(json.dumps({'metric': 'env', 'w': "
                            "os.environ.get('DMNIST_SUPERVISED_WORKER')}))\n")
    assert not supervise.is_worker()
    assert supervise.run_supervised(cmd, _accept(), stall_timeout=30,
                                    attempts=1) == 0
    cap = capfd.readouterr()
    assert json.loads(cap.out.strip().splitlines()[-1])["w"] == "1"


def test_supervise_has_no_fallback_attempt(tmp_path, capfd):
    # the reference's fallback_env (an extra attempt under other env,
    # its CPU re-run) is not part of the port: N attempts, then failure
    log = tmp_path / "attempts.log"
    cmd = _script(tmp_path, "import os, sys\n"
                            f"open({str(log)!r}, 'a').write("
                            "os.environ.get('DMNIST_SUPERVISED_WORKER', '-')"
                            " + '\\n')\n"
                            "sys.exit(5)\n")
    assert "fallback_env" not in inspect.signature(
        supervise.run_supervised).parameters
    assert supervise.run_supervised(cmd, _accept(), stall_timeout=30,
                                    attempts=2) == 1
    assert log.read_text().split() == ["1", "1"]
    err = capfd.readouterr().err
    assert "all attempts failed" in err and "fallback" not in err


def test_supervise_accept_scans_each_line_once(tmp_path, capfd):
    cmd = _script(tmp_path, "import json, time\n"
                            "for i in range(40):\n"
                            "    print(f'chatter {i}', flush=True)\n"
                            "    time.sleep(0.05)\n"
                            "print(json.dumps({'metric': 'm', 'value': 3}))\n"
                            "time.sleep(3)\n")
    calls = []
    inner = _accept()

    def spy(lines):
        calls.append(len(lines))
        return inner(lines)

    assert supervise.run_supervised(cmd, spy, stall_timeout=30,
                                    attempts=1) == 0
    assert json.loads(capfd.readouterr().out.strip().splitlines()[-1])[
        "value"] == 3
    assert sum(calls) == 41 and len(calls) > 1


def test_supervise_acceptor_ignores_non_record_json():
    accept = _accept()
    assert accept(["[1, 2]\n", "42\n", '"metric"\n']) is None
    assert accept(['{"other": 1}\n']) is None
    line = '{"metric": "m"}\n'
    assert accept(["junk\n", line]) == line


def test_train_cli_supervise_forwards_the_summary(tmp_path):
    """--supervise: the worker's argv without --supervise, the summary
    line (accepted on test_accuracy) forwarded."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-m", "distributedmnist_tpu_torch.train",
         "--preset", "mlp-sgd", "--synthetic", "--device", "cpu",
         "--steps", "5", "--eval-every", "5", "--supervise",
         "--stall-timeout", "120", "--max-attempts", "1"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    assert len(lines) == 1 and json.loads(lines[0])["steps"] == 5


# -- --profile-dir, the flat optimizer, im2col ----------------------------------------


def test_profile_dir_writes_a_trace(tmp_path, small_data):
    """The profiler's trace, and beside it the rank's spans on the
    trace's clock: the loop's host operations fall inside the spans'
    `train.loop`."""
    prof = str(tmp_path / "prof")
    trainer.fit(BASE.replace(steps=4, eval_every=4, profile_dir=prof),
                data=small_data)
    found = sorted(f for f in os.listdir(prof) if f.endswith(".json"))
    assert [f.split("-")[:2] for f in found] == [["spans", "rank0"],
                                                 ["trace", "rank0"]]
    with open(os.path.join(prof, found[1])) as f:
        events = json.load(f)["traceEvents"]
    assert any(ev.get("ph") == "X" for ev in events)
    with open(os.path.join(prof, found[0])) as f:
        spans = [e for e in json.load(f)["traceEvents"] if e["ph"] == "X"]
    assert {e["pid"] for e in spans} == {0}
    assert [e["name"] for e in spans if e["args"]["parent"] is None] == [
        "fit"]
    loop = next(e for e in spans if e["name"] == "train.loop")
    ops = [e for e in events if e.get("cat") == "cpu_op"]
    assert ops
    slack = 2e3      # us: the mark's two stamps, and rounding
    assert all(loop["ts"] - slack <= e["ts"] and e["ts"] + e["dur"]
               <= loop["ts"] + loop["dur"] + slack for e in ops)


@pytest.mark.parametrize("name,opt", (("mlp", "sgd"), ("lenet", "adam")))
def test_flat_optimizer_on_and_off_give_one_trajectory(name, opt,
                                                       small_data):
    kw = dict(model=name, optimizer=opt,
              learning_rate=0.05 if opt == "sgd" else 1e-3)
    a, _ = _losses(BASE.replace(**kw), small_data)
    b, _ = _losses(BASE.replace(flat_optimizer=False, **kw), small_data)
    assert a == b


def test_im2col_equals_lax():
    """JAX's tests/test_conv.py: the convolutions at SAME and VALID, the
    pool, and LeNet's forward and gradients, im2col against lax."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(2, 14, 14, 6)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(5, 5, 6, 16)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(16,)).astype(np.float32))
    for padding in ("VALID", "SAME"):
        want = tconv.conv2d(x, w, b, padding)
        got = tconv.im2col_conv(x, w, b, padding)
        assert got.shape == want.shape
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(tconv.avg_pool2_reshape(x), tconv.avg_pool2(x))
    params = models.init_params("lenet", 0)
    xs = torch.from_numpy(rng.normal(size=(4, 28, 28, 1)).astype(np.float32))
    outs, grads = [], []
    for conv in ("lax", "im2col", "auto"):
        net = models.build("lenet", conv=conv, device="cpu")
        net.load_state_dict(params)
        y = net(xs)
        (y ** 2).mean().backward()
        outs.append(y.detach())
        grads.append(torch.cat([p.grad.reshape(-1)
                                for p in net.parameters()]))
    torch.testing.assert_close(outs[1], outs[0], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(grads[1], grads[0], rtol=1e-4, atol=1e-5)
    assert torch.equal(outs[2], outs[0])       # auto is lax
    with pytest.raises(ValueError, match="conv"):
        models.build("lenet", conv="fft", device="cpu")


def test_summary_reports_the_run(small_data):
    _, out = _losses(BASE.replace(dtype="bfloat16", fused_kernels="xla"),
                     small_data)
    assert (out["model_parallel"], out["data_pipeline"],
            out["pixel_format"]) == (1, "device", "packed")
    assert np.isfinite(out["final_loss"])


# -- no jax ------------------------------------------------------------------------


def test_new_modules_import_no_jax():
    mods = ["distributedmnist_tpu_torch.parallel.tp",
            "distributedmnist_tpu_torch.parallel.mesh",
            "distributedmnist_tpu_torch.data.host_loader",
            "distributedmnist_tpu_torch.data.native",
            "distributedmnist_tpu_torch.utils.supervise",
            "distributedmnist_tpu_torch.allreduce_bw",
            "distributedmnist_tpu_torch.trainer",
            "distributedmnist_tpu_torch.bench",
            "distributedmnist_tpu_torch.train",
            "distributedmnist_tpu_torch.dryrun",
            "distributedmnist_tpu_torch.calibrate_synthetic"]
    code = ("import importlib, json, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "print(json.dumps(sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'distributedmnist_tpu' or "
            "m.startswith('distributedmnist_tpu.'))))\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []
