"""The PyTorch port's training slice against the JAX package, on the CPU:
loss and accuracy, the schedules and optimizers, pixel packing, the index
stream, the MNIST readers, LeNet-5's convolutions and forward, a
trajectory of training steps from the same init and batches, and the
trainer end to end (accuracy, kill/resume, eval-only, SIGTERM
preemption through the CLI, the guards).

Tolerances, stated where each is used:
- loss 1e-6 (f32 log-softmax of the same logits), accuracy counts exact;
- schedules atol 1e-7 (optax computes in float32, the port in float64);
- 20 optimizer updates from the same grads: SGD rtol 1e-6, Adam rtol
  1e-5 (the same function in another rounding order);
- pixels bit-identical;
- convolutions and the LeNet forward 1e-5 (sums of up to 150 products
  in another order);
- trajectories: SGD 1e-5 on the losses and the params; Adam rtol 1e-4 on
  the losses and atol 2*lr on the params, since Adam divides each update
  by the running RMS of its gradient: a dead unit's gradient, 0 in one
  framework and a rounding residue of 1e-11 in the other, moves its
  weight by up to about lr a step in one of them.
"""

import json
import os
import signal
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributedmnist_tpu import config as jconfig
from distributedmnist_tpu import models as jmodels
from distributedmnist_tpu import optim as joptim
from distributedmnist_tpu import trainer as jtrainer
from distributedmnist_tpu.data import loader as jloader
from distributedmnist_tpu.data import mnist as jmnist
from distributedmnist_tpu.data import packing as jpacking
from distributedmnist_tpu.ops import conv as jconv
from distributedmnist_tpu.ops import loss as jloss
from distributedmnist_tpu_torch import config as tconfig
from distributedmnist_tpu_torch import interop, models
from distributedmnist_tpu_torch import optim as toptim
from distributedmnist_tpu_torch import trainer as ttrainer
from distributedmnist_tpu_torch.checkpoint import (Checkpointer,
                                                   committed_steps,
                                                   restore_latest_params)
from distributedmnist_tpu_torch.data import loader as tloader
from distributedmnist_tpu_torch.data import mnist as tmnist
from distributedmnist_tpu_torch.data import packing as tpacking
from distributedmnist_tpu_torch.ops import conv as tconv
from distributedmnist_tpu_torch.ops import loss as tloss
from idx_util import write_idx_fixtures

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = tconfig.Config(device="cpu", synthetic=True, log_every=0,
                      target_accuracy=None)


@pytest.fixture(scope="module")
def small_data():
    return tmnist.synthetic_mnist(seed=1, train_n=4096, test_n=1024)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# -- loss, schedules, optimizers ----------------------------------------------


def test_loss_and_masked_accuracy_match_jax():
    r = np.random.default_rng(0)
    logits = (r.normal(size=(97, 10)) * 3).astype(np.float32)
    labels = r.integers(0, 10, 97).astype(np.int32)
    # a third of the rows predicted right, so the counts are not trivial
    labels[::3] = logits[::3].argmax(-1)
    valid = r.random(97) < 0.7
    want = float(jloss.cross_entropy(jnp.asarray(logits),
                                     jnp.asarray(labels)))
    got = float(tloss.cross_entropy(_t(logits), _t(labels)))
    assert abs(got - want) <= 1e-6
    for mask in (None, valid):
        j = int(jloss.accuracy_count(
            jnp.asarray(logits), jnp.asarray(labels),
            None if mask is None else jnp.asarray(mask)))
        t = tloss.accuracy_count(_t(logits), _t(labels).long(),
                                 None if mask is None else _t(mask))
        assert t.dtype == torch.int32 and int(t) == j


SCHEDULES = (("constant", 0, None), ("constant", 7, None),
             ("cosine", 0, 40), ("warmup-cosine", 7, 40))


@pytest.mark.parametrize("name,warmup,total", SCHEDULES)
def test_schedules_match_optax(name, warmup, total):
    want = joptim.make_schedule(0.1, name, warmup, total)
    got = toptim.make_schedule(0.1, name, warmup, total)
    for step in range(50):
        w = float(want(step)) if callable(want) else want
        assert abs(got(step) - w) <= 1e-7, (step, got(step), w)


def test_schedule_errors_match_jax():
    for args in (("cosine", 0, None), ("warmup-cosine", 0, 40),
                 ("linear", 0, None)):
        with pytest.raises(ValueError):
            joptim.make_schedule(0.1, *args)
        with pytest.raises(ValueError):
            toptim.make_schedule(0.1, *args)


@pytest.mark.parametrize("name,lr,rtol", (("sgd", 0.1, 1e-6),
                                          ("adam", 1e-3, 1e-5)))
def test_optimizer_updates_match_optax(name, lr, rtol):
    """20 updates from the same params and grads, under a warmup-cosine
    schedule (so the lr of each update is checked too)."""
    r = np.random.default_rng(1)
    shapes = {"w": (13, 7), "b": (7,)}
    p0 = {k: r.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: r.normal(size=s).astype(np.float32)
              for k, s in shapes.items()} for _ in range(20)]
    tx = joptim.build(name, joptim.make_schedule(lr, "warmup-cosine", 5, 20))
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    st = tx.init(jp)
    tp = {k: torch.nn.Parameter(_t(v).clone()) for k, v in p0.items()}
    opt, sched = toptim.build(
        name, tp.values(), toptim.make_schedule(lr, "warmup-cosine", 5, 20))
    for g in grads:
        upd, st = tx.update({k: jnp.asarray(v) for k, v in g.items()}, st, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = _t(g[k]).clone()
        opt.step()
        sched.step()
    for k in shapes:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                   rtol=rtol, atol=rtol)


# -- data ---------------------------------------------------------------------


def test_packing_is_bit_identical_to_jax():
    r = np.random.default_rng(2)
    x = r.integers(0, 256, (33, 28, 28, 1), dtype=np.uint8)
    x[0] = 255          # words with the sign bit set
    words = tpacking.pack_rows(x)
    assert words.dtype == np.int32
    assert words.tobytes() == jpacking.pack_rows(x).tobytes()
    want = np.asarray(jpacking.unpack_rows(jnp.asarray(words)))
    got = tpacking.unpack_rows(_t(words)).numpy()
    assert got.shape == want.shape == (33, 28, 28, 1)
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    # the u8 decode is the same division
    want_u8 = np.asarray(jnp.asarray(x).astype(jnp.float32)
                         / jnp.asarray(255.0, jnp.float32))
    assert np.array_equal(tpacking.normalize(_t(x)).numpy().view(np.uint32),
                          want_u8.view(np.uint32))
    with pytest.raises(ValueError):
        tpacking.pack_rows(x.astype(np.int16))


def test_index_stream_matches_jax():
    # 1000 rows at batch 64: 15 steps an epoch, so a block of 20 crosses
    # an epoch boundary
    j = jloader.IndexStream(1000, 64, seed=5, mesh=None)
    t = tloader.IndexStream(1000, 64, seed=5)
    for k in (20, 1, 13):
        assert np.array_equal(t.host_block(k), j.host_block(k))
    jr = jloader.IndexStream(1000, 64, seed=5, mesh=None, start_step=29)
    tr = tloader.IndexStream(1000, 64, seed=5, start_step=29)
    assert np.array_equal(tr.host_block(7), jr.host_block(7))
    assert tr.next_block(2, "cpu").dtype == torch.int64
    for n, b in ((1024, 256), (1000, 256), (10_000, 2048)):
        for got, want in zip(tloader.eval_batches(n, b),
                             jloader.eval_batches(n, b)):
            assert np.array_equal(got, want)
    with pytest.raises(ValueError):
        tloader.IndexStream(10, 64, seed=0)


@pytest.mark.parametrize("fmt", ("idx", "idx.gz", "npz"))
def test_load_mnist_matches_jax(fmt, tmp_path):
    import gzip

    src = tmnist.synthetic_mnist(seed=3, train_n=64, test_n=32)
    if fmt == "npz":
        np.savez(tmp_path / "mnist.npz", x_train=src["train_x"][..., 0],
                 y_train=src["train_y"], x_test=src["test_x"][..., 0],
                 y_test=src["test_y"])
    else:
        write_idx_fixtures(tmp_path, src)
        if fmt == "idx.gz":
            for p in list(tmp_path.iterdir()):
                with open(p, "rb") as f, gzip.open(f"{p}.gz", "wb") as g:
                    g.write(f.read())
                p.unlink()
    got = tmnist.load_mnist(str(tmp_path))
    want = jmnist.load_mnist(str(tmp_path))
    assert got["source"] == want["source"] == "real"
    for k in ("train_x", "train_y", "test_x", "test_y"):
        assert got[k].dtype == want[k].dtype
        assert np.array_equal(got[k], want[k])
        assert np.array_equal(got[k], src[k])
    with pytest.raises(FileNotFoundError):
        tmnist.load_mnist(str(tmp_path / "missing"))


def test_device_dataset_layouts(small_data):
    u8 = tloader.DeviceDataset(small_data, "cpu", pixel_format="u8")
    packed = tloader.DeviceDataset(small_data, "cpu", pixel_format="packed")
    assert u8.train_x.dtype == torch.uint8 and u8.train_y.dtype == torch.int64
    assert tuple(packed.train_x.shape) == (4096, 196)
    assert torch.equal(tpacking.unpack_rows(packed.train_x[:9]),
                       tpacking.normalize(u8.train_x[:9]))
    only_test = tloader.DeviceDataset(small_data, "cpu",
                                      device_resident_train=False)
    assert only_test.train_x is None and only_test.test_n == 1024
    with pytest.raises(ValueError):
        tloader.DeviceDataset(small_data, "cpu", pixel_format="f32")


# -- LeNet-5 ------------------------------------------------------------------


@pytest.mark.parametrize("padding", ("SAME", "VALID"))
def test_conv_and_pool_match_jax(padding):
    r = np.random.default_rng(4)
    x = r.normal(size=(3, 12, 10, 6)).astype(np.float32)
    k = (r.normal(size=(5, 5, 6, 16)) * 0.1).astype(np.float32)
    b = r.normal(size=16).astype(np.float32)
    want = np.asarray(jconv.im2col_conv(jnp.asarray(x), jnp.asarray(k),
                                        jnp.asarray(b), padding))
    got = tconv.conv2d(_t(x), _t(k), _t(b), padding).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tconv.avg_pool2(_t(x)).numpy(),
                               np.asarray(jconv.avg_pool2(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError):
        tconv.conv2d(_t(x), _t(k), _t(b), "FULL")


@pytest.mark.parametrize("conv_impl", ("lax", "im2col"))
def test_lenet_forward_matches_jax(conv_impl, small_data):
    jm = jmodels.build("lenet", platform="cpu", conv=conv_impl)
    params = jm.init(jax.random.PRNGKey(3), jnp.zeros((1, 28, 28, 1)))["params"]
    x = small_data["test_x"][:32].astype(np.float32) / 255.0
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    net = models.build("lenet", device="cpu")
    net.load_state_dict(interop.lenet_params_from_flax(
        jax.tree.map(np.asarray, params)))
    with torch.no_grad():
        got = net(_t(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_lenet_parameters_and_fresh_init():
    params = models.init_params("lenet", seed=0)
    jm = jmodels.build("lenet", platform="cpu")
    jp = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 28, 28, 1)))["params"]
    want = interop.lenet_params_from_flax(jax.tree.map(np.asarray, jp))
    assert {k: tuple(v.shape) for k, v in params.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    assert sum(v.numel() for v in params.values()) == 61_706
    for name, shape, _ in models.lenet.LAYERS:
        kernel = params[f"{name}.kernel"]
        fan_in = int(np.prod(shape[:-1]))
        std = (1.0 / fan_in) ** 0.5
        # lecun_normal: truncated at 2 std of the underlying normal
        assert float(kernel.abs().max()) <= 2 * std / 0.8796 + 1e-6
        if kernel.numel() >= 2400:
            assert abs(float(kernel.std()) / std - 1) < 0.06, name
            # the same statistics as flax's draw
            assert abs(float(kernel.std())
                       / float(want[f"{name}.kernel"].std()) - 1) < 0.08
        assert not params[f"{name}.bias"].any()
    again = models.init_params("lenet", seed=0)
    other = models.init_params("lenet", seed=1)
    assert all(torch.equal(params[k], again[k]) for k in params)
    assert not torch.equal(params["fc1.kernel"], other["fc1.kernel"])


# -- the training step against the JAX package's ------------------------------


TRAJECTORIES = (("mlp", "sgd", 0.1, 64, "u8"),
                ("mlp", "sgd", 0.1, 64, "packed"),
                ("lenet", "adam", 1e-3, 128, "packed"))


@pytest.mark.parametrize("model,opt,lr,batch,fmt", TRAJECTORIES)
def test_training_trajectory_matches_jax(model, opt, lr, batch, fmt):
    """20 steps of the presets' recipes from the JAX init (trainer.py's
    init_state), through JAX's _forward_loss/_make_one_step and the
    port's step, on the same index blocks."""
    data = tmnist.synthetic_mnist(seed=1, train_n=2048, test_n=16)
    train_x = (data["train_x"] if fmt == "u8"
               else tpacking.pack_rows(data["train_x"]))
    jm = jmodels.build(model, fused="xla", platform="cpu", conv="lax")
    tx = joptim.build(opt, lr, 0.9)
    state = jtrainer.init_state(jax.random.PRNGKey(0), jm, tx,
                                jnp.zeros((1, 28, 28, 1)))
    one_step = jax.jit(jtrainer._make_one_step(
        jtrainer._forward_loss(jm, jnp.float32, fmt), tx))
    to_port = (interop.lenet_params_from_flax if model == "lenet"
               else interop.mlp_params_from_flax)
    net = models.build(model, device="cpu")
    net.load_state_dict(to_port(jax.tree.map(np.asarray, state.params)))
    optimizer, scheduler = toptim.build(opt, net.parameters(),
                                        toptim.make_schedule(lr), 0.9)
    step = ttrainer.make_train_step(net, optimizer, scheduler, fmt)
    jx, jy = jnp.asarray(train_x), jnp.asarray(data["train_y"])
    tx_, ty = _t(train_x), _t(data["train_y"]).long()
    stream = tloader.IndexStream(2048, batch, seed=0)
    jlosses, tlosses = [], []
    for _ in range(20):
        idx = stream.host_block(1)[0]
        state, loss = one_step(state, jnp.take(jx, idx, axis=0),
                               jnp.take(jy, idx, axis=0))
        jlosses.append(float(loss))
        tlosses.append(float(step(tx_, ty, _t(idx).long())))
    got = net.state_dict()
    want = to_port(jax.tree.map(np.asarray, state.params))
    if opt == "sgd":
        np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5, atol=1e-5)
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                       rtol=1e-5, atol=1e-5, err_msg=k)
    else:
        np.testing.assert_allclose(tlosses, jlosses, rtol=1e-4)
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                       rtol=0, atol=2 * lr, err_msg=k)
    assert tlosses[-1] < tlosses[0]


def test_grad_accum_is_the_full_batch_step(small_data):
    """Two microbatches of 32 give the update of one batch of 64."""
    nets = []
    for ga in (1, 2):
        net = models.build("mlp", device="cpu")
        net.load_state_dict(models.init_params("mlp", 0))
        opt, sched = toptim.build("sgd", net.parameters(),
                                  toptim.make_schedule(0.05))
        step = ttrainer.make_train_step(net, opt, sched, "u8", grad_accum=ga)
        stream = tloader.IndexStream(4096, 64, seed=0)
        x, y = _t(small_data["train_x"]), _t(small_data["train_y"]).long()
        losses = [float(step(x, y, _t(stream.host_block(1)[0]).long()))
                  for _ in range(3)]
        nets.append((losses, net.state_dict()))
    np.testing.assert_allclose(nets[1][0], nets[0][0], rtol=1e-6)
    for k, v in nets[0][1].items():
        np.testing.assert_allclose(nets[1][1][k].numpy(), v.numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


# -- the trainer ---------------------------------------------------------------


def test_fit_reaches_accuracy(small_data):
    cfg = BASE.replace(model="mlp", optimizer="sgd", learning_rate=0.02,
                       batch_size=256, steps=200, eval_every=100,
                       target_accuracy=0.9)
    out = ttrainer.fit(cfg, data=small_data)
    assert out["test_accuracy"] >= 0.9
    assert out["data"] == "synthetic" and out["n_chips"] == 1
    assert out["wall_clock_to_target_s"] is not None
    assert out["n_evals"] >= 1 and out["steps"] <= 200


def test_summary_keys_match_jax(small_data):
    j = jtrainer.fit(jconfig.Config(
        device="cpu", num_devices=1, model="mlp", optimizer="sgd",
        batch_size=256, steps=2, eval_every=2, log_every=0,
        target_accuracy=None, fused_kernels="xla"), data=small_data)
    t = ttrainer.fit(BASE.replace(model="lenet", steps=2, eval_every=2,
                                  batch_size=64, log_every=1),
                     data=small_data)
    assert set(t) == set(j)
    assert t["steps"] == 2 and np.isfinite(t["final_loss"])


def _final_params(ckpt_dir):
    params, step = restore_latest_params(ckpt_dir)
    return params, step


def test_kill_resume_ends_with_the_uninterrupted_params(small_data, tmp_path):
    """Crash at step 20 through the fault hook, restart, restore the
    checkpoint of step 20 (params, Adam moments, the schedule's count,
    the index stream's position) and finish: the same params, bit for
    bit, as a run that was never interrupted."""
    kw = dict(model="mlp", optimizer="adam", learning_rate=1e-3,
              lr_schedule="warmup-cosine", warmup_steps=5, batch_size=128,
              steps=30, eval_every=1000, checkpoint_every=10)
    killed = str(tmp_path / "killed")
    with pytest.raises(ttrainer.SimulatedFailure):
        ttrainer.fit(BASE.replace(fail_at_step=20, checkpoint_dir=killed,
                                  **kw), data=small_data)
    assert committed_steps(killed) == [10, 20]
    out = ttrainer.fit(BASE.replace(checkpoint_dir=killed, **kw),
                       data=small_data)
    assert out["restored"] is True and out["steps"] == 30
    whole = str(tmp_path / "whole")
    ttrainer.fit(BASE.replace(checkpoint_dir=whole, **kw), data=small_data)
    (got, s1), (want, s2) = _final_params(killed), _final_params(whole)
    assert s1 == s2 == 30
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_resume_disabled_and_eval_only(small_data, tmp_path):
    ckpt = str(tmp_path / "ckpt")
    kw = dict(model="mlp", optimizer="sgd", learning_rate=0.02,
              batch_size=256, steps=10, eval_every=1000,
              checkpoint_dir=ckpt, checkpoint_every=5)
    first = ttrainer.fit(BASE.replace(**kw), data=small_data)
    assert first["restored"] is False
    fresh = ttrainer.fit(BASE.replace(resume=False, **kw), data=small_data)
    assert fresh["restored"] is False and fresh["steps"] == 10
    ev = ttrainer.fit(BASE.replace(eval_only=True, **kw), data=small_data)
    assert ev["restored"] is True and ev["steps"] == 10
    assert ev["test_accuracy"] == fresh["test_accuracy"]
    assert ev["steps_timed"] == 0 and ev["final_loss"] is None
    with pytest.raises(ValueError, match="no checkpoint"):
        ttrainer.fit(BASE.replace(eval_only=True, checkpoint_dir=str(
            tmp_path / "empty")), data=small_data)
    with pytest.raises(ValueError, match="eval-only"):
        ttrainer.fit(BASE.replace(eval_only=True), data=small_data)


def test_checkpointer_commits_and_keeps_the_newest(tmp_path):
    d = str(tmp_path / "c")
    params = models.init_params("mlp", 0)
    net = models.build("mlp", device="cpu")
    opt, sched = toptim.build("adam", net.parameters(),
                              toptim.make_schedule(1e-3))
    ck = Checkpointer(d)
    os.makedirs(os.path.join(d, "7.tmp-1"))      # a save cut off halfway
    for s in (1, 2, 3, 4):
        assert ck.save(s, {"params": params, "optimizer": opt.state_dict(),
                           "scheduler": sched.state_dict()})
    assert not ck.save(4, {"params": params, "optimizer": {},
                           "scheduler": {}})
    ck.close()
    assert committed_steps(d) == [2, 3, 4]
    got, step = restore_latest_params(d, template=params)
    assert step == 4 and all(torch.equal(got[k], params[k]) for k in params)
    with pytest.raises(ValueError, match="does not hold params"):
        restore_latest_params(d, template=models.init_params("lenet", 0))
    assert restore_latest_params(str(tmp_path / "none")) == (None, None)
    assert Checkpointer(d).maybe_restore()["step"] == 4


def test_sigterm_preemption_through_the_cli(small_data, tmp_path):
    """SIGTERM a CLI training run once a checkpoint is committed: it
    force-saves at its stopping step, prints its summary with
    preempted: true, and dies by the signal; a later run restores that
    checkpoint and finishes."""
    data_dir = tmp_path / "data"
    data_dir.mkdir()
    np.savez(data_dir / "mnist.npz", x_train=small_data["train_x"][..., 0],
             y_train=small_data["train_y"], x_test=small_data["test_x"][..., 0],
             y_test=small_data["test_y"])
    ckpt = str(tmp_path / "ckpt")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    p = subprocess.Popen(
        [sys.executable, "-m", "distributedmnist_tpu_torch.train",
         "--device", "cpu", "--data-dir", str(data_dir), "--model", "mlp",
         "--optimizer", "sgd", "--learning-rate", "0.02", "--batch-size",
         "64", "--steps", "1000000", "--eval-every", "1000000",
         "--log-every", "0", "--checkpoint-dir", ckpt,
         "--checkpoint-every", "10"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=REPO)
    try:
        deadline = time.monotonic() + 120
        while not committed_steps(ckpt):
            assert p.poll() is None, p.communicate()[0][-3000:]
            assert time.monotonic() < deadline, "no checkpoint committed"
            time.sleep(0.1)
        p.send_signal(signal.SIGTERM)
        out, _ = p.communicate(timeout=120)
    finally:
        if p.poll() is None:
            p.kill()
    assert p.returncode == -signal.SIGTERM, (p.returncode, out[-3000:])
    summary = json.loads([ln for ln in out.splitlines()
                          if ln.startswith("{")][-1])
    assert summary["preempted"] is True
    assert 10 <= summary["steps"] < 1_000_000
    assert summary["steps"] in committed_steps(ckpt)
    resumed = ttrainer.fit(BASE.replace(
        model="mlp", optimizer="sgd", learning_rate=0.02, batch_size=64,
        steps=summary["steps"] + 5, eval_every=1000, checkpoint_dir=ckpt,
        checkpoint_every=10), data=small_data)
    assert resumed["restored"] is True and resumed["preempted"] is False
    assert resumed["steps"] == summary["steps"] + 5


# -- config, CLI and guards ----------------------------------------------------


TRAIN_FIELDS = ("model", "optimizer", "learning_rate", "momentum",
                "lr_schedule", "warmup_steps", "lr_decay_steps", "data_dir",
                "synthetic", "batch_size", "pixel_format", "epochs", "steps",
                "eval_every", "target_accuracy", "seed", "steps_per_call",
                "max_inflight", "grad_accum", "checkpoint_dir",
                "checkpoint_every", "resume", "eval_only",
                "graceful_preemption", "fail_at_step", "log_every",
                "num_devices", "spmd_mode", "coordinator_address",
                "num_processes", "process_id")


def test_training_config_matches_jax():
    ours, ref = tconfig.Config(), jconfig.Config()
    for f in TRAIN_FIELDS:
        assert getattr(ours, f) == getattr(ref, f), f
    assert set(tconfig.PRESETS) == set(jconfig.PRESETS) == {
        "mlp-sgd", "lenet-adam", "mlp-dp2", "lenet-dp8", "lenet-multihost"}
    for name, preset in tconfig.PRESETS.items():
        for f in TRAIN_FIELDS:
            assert getattr(preset, f) == getattr(jconfig.PRESETS[name], f), \
                (name, f)
    import argparse
    p = argparse.ArgumentParser()
    tconfig.add_args(p)
    cfg = tconfig.from_args(p.parse_args(
        ["--preset", "lenet-adam", "--device", "cpu", "--steps", "5",
         "--synthetic", "--pixel-format", "u8", "--no-resume"]))
    assert cfg.model == "lenet" and cfg.batch_size == 128
    assert cfg.device == "cpu" and cfg.steps == 5 and cfg.synthetic
    assert cfg.pixel_format == "u8" and cfg.resume is False


@pytest.mark.parametrize("kw", ({}, {"checkpoint_every": 300},
                                {"fail_at_step": 250}, {"eval_every": 2000},
                                {"steps_per_call": 7}))
def test_steps_per_call_matches_jax(kw):
    kw = {"eval_every": 500, **kw}
    cfg = BASE.replace(**kw)
    jcfg = jconfig.Config(**kw)
    for has_ckpt in (False, True):
        assert ttrainer._pick_steps_per_call(cfg, "cuda", has_ckpt) == \
            jtrainer._pick_steps_per_call(jcfg, "tpu", has_ckpt)
    assert ttrainer._pick_steps_per_call(cfg, "cpu", True) == \
        jtrainer._pick_steps_per_call(jcfg, "cpu", True)


def test_fit_validates_its_config(small_data):
    for kw, match in (({"grad_accum": 0}, "grad_accum"),
                      ({"grad_accum": 3, "batch_size": 64}, "divisible"),
                      ({"lr_decay_steps": 0}, "lr_decay_steps")):
        with pytest.raises(ValueError, match=match):
            ttrainer.fit(BASE.replace(model="mlp", steps=2, **kw),
                         data=small_data)


def test_fit_on_cuda_raises_without_a_card(small_data):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        ttrainer.fit(BASE.replace(device="cuda", model="mlp", steps=2),
                     data=small_data)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        ttrainer.fit(tconfig.PRESETS["mlp-sgd"].replace(steps=2),
                     data=small_data)


def test_train_cli_imports_no_jax(tmp_path):
    """The CLI end to end in a fresh interpreter: one JSON summary line,
    and neither jax nor the JAX package in sys.modules afterwards."""
    src = tmnist.synthetic_mnist(seed=2, train_n=512, test_n=128)
    write_idx_fixtures(tmp_path, src)
    code = (
        "import json, sys\n"
        "import distributedmnist_tpu_torch.parallel.launch\n"
        "import distributedmnist_tpu_torch.parallel.mh_smoke\n"
        "from distributedmnist_tpu_torch.train import main\n"
        f"rc = main(['--device', 'cpu', '--preset', 'lenet-adam', "
        f"'--data-dir', {str(tmp_path)!r}, '--steps', '6', "
        "'--eval-every', '3', '--log-every', '2'])\n"
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
    summaries = [json.loads(ln) for ln in lines if ln.startswith("{")]
    assert len(summaries) == 1
    s = summaries[0]
    assert s["model"] == "lenet" and s["data"] == "real"
    assert s["steps"] == 6 and s["n_evals"] == 2
    assert s["global_batch"] == 128 and s["pixel_format"] == "packed"


def test_train_profile_refuses_without_a_card(monkeypatch, capsys):
    from distributedmnist_tpu_torch import train_profile

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert train_profile.main([]) == 2
    assert "needs a CUDA card" in capsys.readouterr().err
