"""The port's data-parallel layer (distributedmnist_tpu_torch/parallel/)
against the JAX package's, on the CPU: each rank's slice of a global
batch and of the index stream against JAX's `put_global` shards on 2 and
4 of conftest's 8 virtual devices, the new config fields and presets,
the trainer's validation messages, the process group's rules (backend,
topology reuse, device count), the rank-aware checkpointer; then runs of
2 ranks over gloo on localhost: the train CLI starting its own ranks in
both SPMD modes, kill/resume (every rank restores rank 0's step and the
run ends on the uninterrupted run's params, bit for bit; the checkpoint
boots serving), SIGTERM to one rank of two (both stop at one boundary),
and the launcher ending a run whose rank fails.

Exactness: slices and index blocks bit for bit; error messages equal to
JAX's; the resumed params equal to the uninterrupted run's bit for bit
(2 ranks: gloo sums 2 values, which commute).
"""

import json
import os
import signal
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from distributedmnist_tpu import config as jconfig
from distributedmnist_tpu import trainer as jtrainer
from distributedmnist_tpu.data import IndexStream as JIndexStream
from distributedmnist_tpu.data.loader import eval_batches as jeval_batches
from distributedmnist_tpu.parallel import distributed as jdistributed
from distributedmnist_tpu.parallel import make_mesh
from distributedmnist_tpu_torch import checkpoint, models, trainer
from distributedmnist_tpu_torch.config import Config
from distributedmnist_tpu_torch.data import IndexStream, eval_batches
from distributedmnist_tpu_torch.data import synthetic_mnist
from distributedmnist_tpu_torch.parallel import (batch_shard, chip_count,
                                                 distributed, get_device,
                                                 launch)
from distributedmnist_tpu_torch.serve.registry import build_serving
from idx_util import write_idx_fixtures
from torch_dp_util import REPO, collect, kill, launch_smoke, spawn_smoke

BASE = Config(device="cpu", synthetic=True, log_every=0,
              target_accuracy=None)
CLI_TIMEOUT_S = 150


@pytest.fixture(scope="module")
def small_data():
    return synthetic_mnist(seed=1, train_n=1024, test_n=256)


def _shards(arr):
    """A JAX array's blocks in mesh order (device ids ascending)."""
    return [np.asarray(s.data) for s in
            sorted(arr.addressable_shards, key=lambda s: s.device.id)]


# -- a rank's slice of the global batch ---------------------------------------


@pytest.mark.parametrize("world", (2, 4))
def test_rank_slices_match_jax_put_global_shards(world):
    """IndexStream blocks and eval index columns: rank r's equal device
    r's shard of JAX's P(None, 'data') placement, for several blocks
    across an epoch boundary."""
    mesh = make_mesh(jax.devices("cpu")[:world])
    spec = NamedSharding(mesh, P(None, "data"))
    ref = JIndexStream(1024, 128, 7, mesh)
    ours = [IndexStream(1024, 128, 7) for _ in range(world)]
    for k in (3, 5, 1):     # 8 steps an epoch: the third block crosses it
        want = _shards(ref.next_block(k))
        for r in range(world):
            got = ours[r].next_block(k, "cpu", r, world)
            assert got.dtype == torch.int64
            np.testing.assert_array_equal(got.numpy(), want[r])
    idx, mask = eval_batches(255, 256)
    jidx, jmask = jeval_batches(255, 256)
    for ours_mat, theirs in ((idx, jidx), (mask, jmask)):
        want = _shards(jdistributed.put_global(theirs, spec))
        for r in range(world):
            np.testing.assert_array_equal(
                ours_mat[:, batch_shard(256, r, world)], want[r])
    with pytest.raises(ValueError, match="not divisible"):
        batch_shard(100, 0, 8)


# -- config and validation ----------------------------------------------------


DP_FIELDS = ("num_devices", "spmd_mode", "coordinator_address",
             "num_processes", "process_id")


def test_dp_fields_and_flags_match_jax():
    import argparse

    from distributedmnist_tpu_torch import config as tconfig

    for f in DP_FIELDS:
        assert getattr(Config(), f) == getattr(jconfig.Config(), f), f
    argv = ["--num-devices", "2", "--spmd-mode", "explicit",
            "--coordinator-address", "localhost:1234", "--num-processes",
            "2", "--process-id", "1"]
    parsed = []
    for mod in (tconfig, jconfig):
        p = argparse.ArgumentParser()
        mod.add_args(p)
        parsed.append(mod.from_args(p.parse_args(argv)))
    for f in DP_FIELDS:
        assert getattr(parsed[0], f) == getattr(parsed[1], f), f
    assert parsed[0].num_devices == 2 and parsed[0].process_id == 1


VALIDATION_CASES = (
    ({"batch_size": 100, "num_devices": 8}, 8),
    ({"batch_size": 128, "num_devices": 2, "grad_accum": 3}, 2),
    ({"batch_size": 128, "num_devices": 2, "grad_accum": 0}, 2),
    ({"batch_size": 128, "num_devices": 2, "spmd_mode": "bogus"}, 2),
)


@pytest.mark.parametrize("kw,world", VALIDATION_CASES)
def test_validation_errors_match_jax(kw, world, small_data):
    """The JAX trainer's checks (trainer.py:324-350 and the unknown-mode
    refusal), raised by the port's `validate` for the same world with
    the same message."""
    with pytest.raises(ValueError) as theirs:
        jtrainer.fit(jconfig.Config(device="cpu", steps=1, log_every=0,
                                    fused_kernels="xla", **kw),
                     data=small_data)
    ours_kw = {k: v for k, v in kw.items() if k != "num_devices"}
    with pytest.raises(ValueError) as ours:
        trainer.validate(BASE.replace(**ours_kw), world)
    assert str(ours.value) == str(theirs.value)


def test_fit_with_num_devices_and_no_process_group_raises(small_data):
    with pytest.raises(ValueError) as e:
        trainer.fit(BASE.replace(model="mlp", steps=2, num_devices=2),
                    data=small_data)
    msg = str(e.value)
    assert "not in a process group" in msg
    assert "distributedmnist_tpu_torch.train" in msg
    assert "--coordinator-address" in msg and "--num-processes" in msg
    with pytest.raises(ValueError, match="num_devices must be >= 1"):
        get_device("cpu", 0)


# -- the process group --------------------------------------------------------


def test_backend_rule():
    """NCCL only when every host has a card per rank; gloo on the CPU and
    for ranks that share a card."""
    rule = distributed.backend_for
    assert rule("cpu", [("a", 0), ("a", 0)]) == "gloo"
    assert rule("cuda", [("a", 1)]) == "nccl"
    assert rule("cuda", [("a", 1), ("a", 1)]) == "gloo"
    assert rule("cuda", [("a", 2), ("a", 2)]) == "nccl"
    assert rule("cuda", [("a", 1), ("b", 1)]) == "nccl"
    assert rule("cuda", [("a", 4)] * 4 + [("b", 1)] * 2) == "gloo"


@pytest.mark.parametrize("hosts,cards", (
    ([("a", 0), ("a", 0)], 0),
    ([("a", 1), ("a", 1)], 1),
    ([("a", 1)] * 8, 1),
    ([("a", 2), ("a", 2)], 2),
    ([("a", 4)] * 2 + [("b", 1)] * 3, 3),
))
def test_cards_in_use_count_a_shared_card_once(hosts, cards):
    """The backend line's card count (and on the card the summary's
    n_chips): ranks beyond a host's cards share them."""
    assert distributed.cards_in_use(hosts) == cards


def test_topology_mismatch_on_reuse_raises():
    """A live group is reused only for the topology it has, as
    jax.distributed is; the device count is checked against it."""
    assert not torch.distributed.is_initialized()
    addr = f"localhost:{launch.free_port()}"
    try:
        assert distributed.maybe_initialize(addr, 1, 0, "cpu") is True
        topo = distributed.topology()
        assert (topo.rank, topo.world, topo.backend) == (0, 1, "gloo")
        assert distributed.maybe_initialize(addr, 1, 0, "cpu") is True
        assert distributed.maybe_initialize(None, None, None) is True
        for kw, name in (((1, 1), "process_id=0"),
                         ((2, 0), "num_processes=1")):
            with pytest.raises(ValueError, match=name) as e:
                distributed.maybe_initialize(addr, *kw, "cpu")
            assert "different topology" in str(e.value)
        with pytest.raises(RuntimeError,
                           match="requested 2 devices, only 1 visible"):
            get_device("cpu", 2)
        assert get_device("cpu", 1) == torch.device("cpu")
        assert distributed.agree_max(3, "cpu") == 3
        assert distributed.all_sum(3, "cpu") == 3
        assert chip_count(torch.device("cpu")) == 1
        assert distributed.broadcast_int(5, "cpu") == 5
    finally:
        distributed.shutdown()
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="--num-processes"):
        distributed.maybe_initialize(addr, None, 0, "cpu")


def test_checkpointer_writes_only_on_rank_0(tmp_path, monkeypatch):
    params = models.init_params("mlp", 0)
    state = {"params": params, "optimizer": {}, "scheduler": {}}
    d = str(tmp_path / "ck")
    monkeypatch.setattr(distributed, "process_index", lambda: 1)
    other = checkpoint.Checkpointer(d)
    assert other.save(1, state) is False
    other.close()
    assert not os.path.exists(d)
    monkeypatch.setattr(distributed, "process_index", lambda: 0)
    writer = checkpoint.Checkpointer(d)
    assert writer.save(1, state) is True
    writer.close()
    assert checkpoint.committed_steps(d) == [1]
    assert checkpoint.Checkpointer(d).maybe_restore()["step"] == 1


# -- the train CLI starting its own ranks -------------------------------------


@pytest.fixture(scope="module")
def idx_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("idx")
    write_idx_fixtures(d, synthetic_mnist(seed=2, train_n=1024, test_n=256))
    return str(d)


def _cli(args, timeout=CLI_TIMEOUT_S):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen(
        [sys.executable, "-m", "distributedmnist_tpu_torch.train", *args],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    return proc.returncode, out, err


@pytest.mark.parametrize("mode", ("auto", "explicit"))
def test_train_cli_starts_two_ranks(mode, idx_dir, small_data):
    """`train --preset mlp-dp2 --device cpu` (num_devices 2) starts two
    ranks of itself: one summary line (rank 0's) with the JAX trainer's
    keys, n_chips and n_processes 2; both ranks' launch counts and the
    backend line on stderr."""
    rc, out, err = _cli(["--preset", "mlp-dp2", "--device", "cpu",
                         "--data-dir", idx_dir, "--steps", "8",
                         "--eval-every", "4", "--spmd-mode", mode])
    assert rc == 0, err[-3000:]
    lines = [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]
    assert len(lines) == 1
    s = lines[0]
    keys = set(trainer.fit(BASE.replace(model="mlp", steps=1, eval_every=1),
                           data=small_data))
    assert set(s) == keys
    assert s["n_chips"] == s["n_processes"] == 2 and s["multihost"] is False
    assert s["spmd_mode"] == mode and s["steps"] == 8 and s["n_evals"] == 2
    assert s["global_batch"] == 128 and np.isfinite(s["final_loss"])
    assert "[rank 0] " in err and "dist: backend gloo, 2 ranks on 0 card(s)" \
        in err
    for r in (0, 1):
        assert f"[rank {r}] train: launches " in err


def test_sigterm_to_the_cli_ends_it_by_sigterm(idx_dir, tmp_path):
    """SIGTERM to the train CLI running 2 ranks: it forwards the signal,
    both ranks stop at one checkpoint boundary and rank 0 saves it, one
    summary line (rank 0's, preempted) reaches stdout, and the CLI ends
    by the SIGTERM itself, as a one-rank run does (torch.distributed.run
    prints every rank's summary and ends with exit code 1)."""
    ckpt = str(tmp_path / "ckpt")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    err_path = tmp_path / "cli.err"
    with open(err_path, "w") as err_file:
        proc = subprocess.Popen(
            [sys.executable, "-m", "distributedmnist_tpu_torch.train",
             "--preset", "mlp-dp2", "--device", "cpu", "--data-dir", idx_dir,
             "--steps", "100000", "--eval-every", "100000",
             "--checkpoint-every", "5", "--checkpoint-dir", ckpt],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=err_file,
            text=True)
    try:
        deadline = time.monotonic() + CLI_TIMEOUT_S
        while not checkpoint.committed_steps(ckpt):
            assert time.monotonic() < deadline, "no checkpoint committed"
            assert proc.poll() is None, err_path.read_text()[-3000:]
            time.sleep(0.1)
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=CLI_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    err = err_path.read_text()
    assert proc.returncode == -signal.SIGTERM, err[-3000:]
    lines = [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]
    assert len(lines) == 1 and lines[0]["preempted"] is True
    stop = lines[0]["steps"]
    assert stop % 5 == 0 and stop in checkpoint.committed_steps(ckpt)
    for r in (0, 1):
        assert f"[rank {r}] " in err and (
            f"SIGTERM: stopping at step {stop} to checkpoint" in err)
        assert f"[rank {r}] train: launches " in err
    assert "Traceback" not in err


def test_launcher_stops_every_rank_when_one_fails():
    """Rank 1 exits 3 at once; rank 0 would sleep for a minute. The
    launcher kills rank 0 and exits 1 with rank 1's last lines."""
    code = ("import os, sys, time\n"
            "if os.environ['RANK'] == '1':\n"
            "    print('rank one fails', file=sys.stderr); sys.exit(3)\n"
            "time.sleep(60)\n")
    parent = ("import sys\n"
              "from distributedmnist_tpu_torch.parallel import launch\n"
              "sys.exit(launch.launch([sys.executable, '-c', "
              f"{code!r}], 2))\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    t0 = time.monotonic()
    proc = subprocess.run([sys.executable, "-c", parent], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 1
    assert time.monotonic() - t0 < 30
    assert "rank 1 of 2 exited 3" in proc.stderr
    assert "rank one fails" in proc.stderr


# -- kill/resume and preemption under 2 ranks ---------------------------------


KILL_KW = dict(model="mlp", optimizer="adam", learning_rate=1e-3,
               lr_schedule="warmup-cosine", warmup_steps=5, batch_size=128,
               steps=30, eval_every=1000, checkpoint_every=10)


def test_two_rank_kill_resume_ends_with_the_uninterrupted_params(tmp_path):
    """Both ranks crash at step 20 (the fault hook); rank 0 committed 10
    and 20. The restart restores step 20 on both ranks and finishes; its
    params equal, bit for bit, those of a 2-rank run never interrupted.
    The data-parallel checkpoint holds the bare model's params, so
    serving boots from it."""
    killed, whole = str(tmp_path / "killed"), str(tmp_path / "whole")
    recs, _ = launch_smoke(2, str(tmp_path), [
        {**KILL_KW, "fail_at_step": 20, "checkpoint_dir": killed},
        {**KILL_KW, "checkpoint_dir": whole}])
    for rank in recs:
        assert rank[0]["failed"] == "injected failure at step 20"
        assert rank[1]["steps"] == 30
    assert checkpoint.committed_steps(killed) == [10, 20]
    recs, logs = launch_smoke(2, str(tmp_path), [
        {**KILL_KW, "checkpoint_dir": killed}])
    for rank, log in zip(recs, logs):
        assert rank[0]["restored"] is True and rank[0]["steps"] == 30
        assert "restored checkpoint at step 20" in log
    template = models.init_params("mlp", 0)
    got, s1 = checkpoint.restore_latest_params(killed, template=template)
    want, s2 = checkpoint.restore_latest_params(whole, template=template)
    assert s1 == s2 == 30
    assert all(torch.equal(got[k], want[k]) for k in want)
    registry, _, _ = build_serving(Config(model="mlp", device="cpu",
                                          checkpoint_dir=killed,
                                          serve_max_batch=16))
    mv = registry.bootstrap()
    assert mv.step == 30 and mv.source == f"checkpoint {killed}"


def test_sigterm_to_one_rank_stops_both_at_one_boundary(tmp_path):
    """SIGTERM to rank 0 only: the ranks agree at the next checkpoint
    boundary, both stop at the same step with preempted true, rank 0
    force-saves that step, and a new 2-rank run restores it and
    finishes."""
    ckpt = str(tmp_path / "pre")
    run = {"steps": 100000, "checkpoint_every": 5, "eval_every": 100000,
           "checkpoint_dir": ckpt}
    ranks = spawn_smoke(2, str(tmp_path), [run])
    try:
        deadline = time.monotonic() + 120
        while not checkpoint.committed_steps(ckpt):
            assert time.monotonic() < deadline, "no checkpoint committed"
            assert all(p.poll() is None for p, _, _ in ranks)
            time.sleep(0.1)
        ranks[0][0].send_signal(signal.SIGTERM)
    except BaseException:
        kill(ranks)
        raise
    recs, _ = collect(ranks, 1)
    stops = [r[0]["steps"] for r in recs]
    assert all(r[0]["preempted"] is True for r in recs)
    assert stops[0] == stops[1] and 0 < stops[0] < 100000
    assert stops[0] % 5 == 0 and stops[0] in checkpoint.committed_steps(ckpt)
    recs, _ = launch_smoke(2, str(tmp_path), [
        {**run, "steps": stops[0] + 6}])
    for r in recs:
        assert r[0]["restored"] is True and r[0]["preempted"] is False
        assert r[0]["steps"] == stops[0] + 6
