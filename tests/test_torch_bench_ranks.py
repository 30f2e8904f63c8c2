"""The port's bench over ranks (`python -m distributedmnist_tpu_torch.bench
--num-devices N`), on the CPU over gloo, against the root bench.py, which
runs its four training modes over every device of its mesh: the 2-rank
runner's losses against the JAX package's data-parallel step on a
2-device mesh and against the 1-rank runner; each training mode over 2
ranks, one record with the root bench's keys, its batch rounding
(round_up over the devices) and n_chips 2; the sweep measuring its
all-reduce; time-to-accuracy's steps within one eval of 1 rank's; every
rank's launch counts, and no jax in any of the bench's processes (a
sitecustomize written for the test records each one's modules at exit).
Then the guards: serve refuses more devices than are visible (and
--num-devices 0 with exit 2), and a run whose
rank fails, at its start or once the process group is up, exits
non-zero with no record, supervised or not, and never runs on one rank.

Tolerances: the 2-rank runner against the JAX package rtol 1e-4 (Adam's
update in another rounding order, as tests/test_torch_bench.py holds
the 1-rank runner); against the 1-rank runner rtol 1e-5 (the same
step, its gradient summed over two ranks' columns).
"""

import argparse
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedmnist_tpu import models as jmodels
from distributedmnist_tpu import optim as joptim
from distributedmnist_tpu import trainer as jtrainer
from distributedmnist_tpu.data import loader as jloader
from distributedmnist_tpu.parallel import make_mesh, replicated
from distributedmnist_tpu_torch import bench as tbench
from distributedmnist_tpu_torch import interop
from distributedmnist_tpu_torch.data import mnist as tmnist
from distributedmnist_tpu_torch.parallel import launch
from torch_dp_util import REPO, RANK_TIMEOUT_S, kill, run_bench

STEPS = 8
GB = 128
TRAIN_N = 2048
# the root bench's committed records of each training mode
RECORDS = {"throughput": "THROUGHPUT_r05.json",
           "time-to-accuracy": "TTA_r05.json",
           "sweep": "SWEEP_r05.json",
           "smoke": "SMOKE_r05.json"}
RECORD_KEYS = {"metric", "value", "unit", "vs_baseline", "detail"}
# each mode at a small size; --global-batch 127 over 2 ranks runs as 128
MODE_ARGS = {
    "throughput": ("--global-batch", "127", "--bench-steps", "8",
                   "--warmup-steps", "2"),
    "time-to-accuracy": ("--global-batch", "127", "--target-accuracy",
                         "0.97", "--max-epochs", "2", "--trials", "1"),
    "sweep": ("--sweep-batches", "32,64", "--bench-steps", "4",
              "--warmup-steps", "2"),
    "smoke": ("--global-batch", "127"),
}
EVAL_EVERY = 200    # tta_config's eval cadence

# Written into a directory put first on the bench's PYTHONPATH: every
# process of the run (the launcher and its ranks) records the modules of
# jax and of the JAX package it imported, and whether it imported torch,
# when it exits; with
# BENCH_RANKS_FAIL set, rank 1 exits 3 at its start ("start") or as soon
# as its process group is up ("group").
SITECUSTOMIZE = '''
import json, os, sys, threading

_dir = os.environ.get("BENCH_RANKS_PROBE")
if _dir:
    import atexit

    def _dump():
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "distributedmnist_tpu"))
        name = f"modules-{os.environ.get('RANK', 'top')}-{os.getpid()}.json"
        with open(os.path.join(_dir, name), "w") as f:
            json.dump({"jax": bad, "torch": "torch" in sys.modules}, f)
    atexit.register(_dump)

_fail = os.environ.get("BENCH_RANKS_FAIL")
if _fail and os.environ.get("RANK") == "1":
    if _fail == "start":
        sys.stderr.write("rank one fails at its start\\n")
        sys.stderr.flush()
        os._exit(3)

    def _watch():
        import time
        while True:
            d = sys.modules.get("torch.distributed")
            try:
                up = d is not None and d.is_initialized()
            except Exception:
                up = False
            if up:
                sys.stderr.write("rank one fails in the group\\n")
                sys.stderr.flush()
                os._exit(3)
            time.sleep(0.01)
    threading.Thread(target=_watch, daemon=True).start()
'''


def _probe_env(tmp, fail=None) -> tuple[dict, str]:
    """(the env that loads SITECUSTOMIZE into every process of a bench
    run, the directory its module records land in)."""
    site = os.path.join(str(tmp), "site")
    probe = os.path.join(str(tmp), "probe")
    os.makedirs(site, exist_ok=True)
    os.makedirs(probe, exist_ok=True)
    with open(os.path.join(site, "sitecustomize.py"), "w") as f:
        f.write(SITECUSTOMIZE)
    env = {"PYTHONPATH": site + os.pathsep + os.environ.get("PYTHONPATH",
                                                            ""),
           "BENCH_RANKS_PROBE": probe}
    if fail is not None:
        env["BENCH_RANKS_FAIL"] = fail
    return env, probe


def _jax_detail_keys(record: str) -> set:
    with open(os.path.join(REPO, record)) as f:
        return set(json.load(f)["detail"])


# -- the runner over 2 ranks against the JAX package ----------------------------


RANK_CODE = '''
import argparse, json, sys
import torch
import torch.distributed as dist
from distributedmnist_tpu_torch import bench
from distributedmnist_tpu_torch.data import mnist
from distributedmnist_tpu_torch.parallel import distributed

params = torch.load(sys.argv[1])
data = mnist.synthetic_mnist(seed=0, train_n=%(train_n)d, test_n=16)
args = argparse.Namespace(device="cpu", model="mlp", bench_steps=%(steps)d,
                          dtype="float32", data_dir=None, num_devices=2)
runner = bench._Runner(args, data=data)
run_block = runner.stepper(%(gb)d, params=params)
losses = []
for _ in range(%(steps)d):
    loss = run_block(1).clone()
    # the rank's loss is its columns' mean: the global mean, as the JAX
    # step reports it, is the mean over the ranks
    dist.all_reduce(loss)
    losses.append(float(loss) / dist.get_world_size())
print("LOSSES " + json.dumps({"losses": losses, "world": runner.world,
                              "n_chips": runner.n_chips}), flush=True)
distributed.shutdown()
''' % {"train_n": TRAIN_N, "steps": STEPS, "gb": GB}


def _run_two_ranks(tmp, params_path) -> list:
    """RANK_CODE as ranks 0 and 1 (the launcher's environment, output in
    files); every rank waited for with a timeout and none left running.
    Returns each rank's LOSSES record."""
    port = launch.free_port()
    ranks = []
    try:
        for r in range(2):
            env = dict(os.environ, OMP_NUM_THREADS="1",
                       MASTER_ADDR="localhost", MASTER_PORT=str(port),
                       WORLD_SIZE="2", RANK=str(r), LOCAL_RANK=str(r),
                       LOCAL_WORLD_SIZE="2")
            env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH",
                                                            "")
            out = os.path.join(tmp, f"rank{r}.out")
            err = os.path.join(tmp, f"rank{r}.err")
            with open(out, "w") as fo, open(err, "w") as fe:
                ranks.append((subprocess.Popen(
                    [sys.executable, "-c", RANK_CODE, params_path],
                    stdout=fo, stderr=fe, env=env, cwd=REPO), out, err))
        for proc, _, _ in ranks:
            proc.wait(timeout=RANK_TIMEOUT_S)
    finally:
        kill(ranks)
    recs = []
    for proc, out, err in ranks:
        with open(out) as fo, open(err) as fe:
            text, log = fo.read(), fe.read()
        assert proc.returncode == 0, log[-3000:]
        recs.append([json.loads(ln.split(" ", 1)[1])
                     for ln in text.splitlines()
                     if ln.startswith("LOSSES ")][0])
    return recs


@pytest.fixture(scope="module")
def two_rank_losses(tmp_path_factory):
    """The JAX package's initial MLP params (seed 0), the 2-rank runner's
    first STEPS global losses from them, and the data they trained on."""
    tmp = str(tmp_path_factory.mktemp("ranks"))
    data = tmnist.synthetic_mnist(seed=0, train_n=TRAIN_N, test_n=16)
    model = jmodels.build("mlp", fused="xla", platform="cpu")
    tx = joptim.build("adam", 1e-3, flat=True)
    state = jtrainer.init_state(jax.random.PRNGKey(0), model, tx,
                                jnp.zeros((1, 28, 28, 1)))
    params = interop.mlp_params_from_flax(
        jax.tree.map(np.asarray, state.params))
    path = os.path.join(tmp, "params.pt")
    torch.save(params, path)
    recs = _run_two_ranks(tmp, path)
    return {"data": data, "model": model, "tx": tx, "state": state,
            "params": params, "recs": recs}


def test_two_rank_runner_losses_match_jax_on_a_2_device_mesh(
        two_rank_losses):
    """The 2-rank runner's first 8 global losses (--model mlp, global
    batch 128, gloo on the CPU, each rank its columns) against the JAX
    package's make_train_step on a 2-device mesh (the root bench's
    runner step: 'auto' mode, Adam at 1e-3, packed pixels), fed by its
    IndexStream over the mesh, from the same initial params."""
    t = two_rank_losses
    mesh = make_mesh(jax.devices()[:2])
    ds = jloader.DeviceDataset(t["data"], mesh, pixel_format="packed")
    state = jax.device_put(t["state"], replicated(mesh))
    step_fn = jtrainer.make_train_step(t["model"], t["tx"], mesh,
                                       mode="auto", pixel_format="packed")
    stream = jloader.IndexStream(TRAIN_N, GB, seed=0, mesh=mesh)
    jlosses = []
    for _ in range(STEPS):
        state, metrics = step_fn(state, ds.train_x, ds.train_y,
                                 stream.next_block(1))
        jlosses.append(float(metrics["loss"]))
    r0, r1 = t["recs"]
    assert r0["world"] == r1["world"] == 2
    assert r0["n_chips"] == 2 and r0["losses"] == r1["losses"]
    np.testing.assert_allclose(r0["losses"], jlosses, rtol=1e-4)
    assert r0["losses"][-1] < r0["losses"][0]


def test_two_rank_runner_losses_match_one_rank(two_rank_losses):
    """The same 8 losses against the 1-rank runner at the same global
    batch, from the same params, in this process."""
    t = two_rank_losses
    args = argparse.Namespace(device="cpu", model="mlp", bench_steps=STEPS,
                              dtype="float32", data_dir=None)
    runner = tbench._Runner(args, data=t["data"])
    assert (runner.world, runner.n_chips) == (1, 1)
    run_block = runner.stepper(GB, params=t["params"])
    one = [float(run_block(1)) for _ in range(STEPS)]
    np.testing.assert_allclose(t["recs"][0]["losses"], one, rtol=1e-5)


# -- each training mode over 2 ranks ------------------------------------------------


def _two_rank_run(tmp, mode: str, *extra) -> tuple[dict, str]:
    """The mode over 2 gloo ranks on the CPU (--inline: the launcher in the
    bench's own process): (its one record, its stderr), after checking
    the run's processes imported no jax, the launcher no torch, and every
    rank reported its launches."""
    env, probe = _probe_env(tmp)
    rc, records, out, err = run_bench(
        [mode, "--device", "cpu", "--model", "mlp", "--num-devices", "2",
         *MODE_ARGS[mode], *extra, "--inline"], str(tmp), env_extra=env)
    assert rc == 0, err[-3000:]
    assert len(records) == 1, out
    for r in (0, 1):
        assert f"[rank {r}] bench: launches " in err
        assert f"[rank {r}] bench: backend up: 2x cpu on 2 chip(s) over " \
            "gloo" in err
    # the launcher prints no launch line of its own: it launched nothing
    assert "\nbench: launches" not in "\n" + err
    seen = sorted(os.listdir(probe))
    for who in ("top", "0", "1"):
        assert [n for n in seen if n.startswith(f"modules-{who}-")], seen
    for name in seen:
        with open(os.path.join(probe, name)) as f:
            got = json.load(f)
        assert got["jax"] == [], name
        # the launcher only starts ranks: it never waits to import torch
        assert got["torch"] == (not name.startswith("modules-top-")), name
    return records[0], err


@pytest.mark.parametrize("mode", sorted(RECORDS))
def test_training_mode_over_two_ranks(mode, tmp_path):
    """One JSON line with the root bench's keys, n_chips 2 (two CPU ranks
    are two devices), the root bench's batch rounding, and each mode's
    own checks: the sweep's all-reduce measured, time-to-accuracy's steps
    within one eval of 1 rank's, smoke's five legs and floor."""
    rec, err = _two_rank_run(tmp_path, mode)
    assert set(rec) == RECORD_KEYS
    d = rec["detail"]
    assert set(d) == _jax_detail_keys(RECORDS[mode])
    assert rec["vs_baseline"] is None and rec["value"] > 0
    assert d["backend"] == "cpu"
    if mode == "sweep":
        assert d["n_chips_measured"] == 2
        assert d["allreduce_modeled"] is False
        assert d["allreduce_ms_est"] > 0
        smallest = d["strong_scaling"]["per_chip_batch"]
        assert smallest == 32
        assert d["strong_scaling"]["step_ms"] == \
            d["curve_img_s_chip"]["32"]["step_ms"]
        # each point's global batch is b x 2 ranks
        for b in (32, 64):
            assert f"b={2 * b}: warmup" in err
        lo, hi = d["prediction_range"]["strong_img_s_chip"]
        assert lo <= rec["value"] <= hi
        return
    assert d["n_chips"] == 2
    if mode == "throughput":
        assert d["global_batch"] == 128 and d["bench_steps"] == 8
        assert d["step_ms"] > 0
    elif mode == "time-to-accuracy":
        assert d["global_batch"] == 128 and d["reached_target"]
        assert all(t["reached"] for t in d["trial_results"])
        one, _ = _one_rank_tta(tmp_path)
        assert one["detail"]["n_chips"] == 1
        assert one["detail"]["reached_target"]
        assert abs(d["steps_to_target"][0]
                   - one["detail"]["steps_to_target"][0]) <= EVAL_EVERY
    else:
        assert d["legs"] == ["train", "eval", "checkpoint-save",
                             "restore-resume", "accuracy-floor"]
        assert d["final_accuracy"] >= 0.85
        # both ranks restored rank 0's checkpoint and resumed, at
        # global batch 128
        assert err.count("restored checkpoint at step 64") == 2
        assert '"global_batch": 128' in err


def _one_rank_tta(tmp):
    rc, records, out, err = run_bench(
        ["time-to-accuracy", "--device", "cpu", "--model", "mlp",
         *MODE_ARGS["time-to-accuracy"], "--inline"], str(tmp))
    assert rc == 0 and len(records) == 1, err[-3000:]
    assert "[rank " not in err
    return records[0], err


# -- guards -------------------------------------------------------------------------


def test_serve_refuses_num_devices(capsys):
    """The serve mode shards over --num-devices devices, as the root
    bench's engine shards over its mesh: a count below 1 is a usage error
    (exit 2), and more devices than are visible (the cpu has one) fails
    before any load phase, in the JAX package's words."""
    with pytest.raises(SystemExit) as exc:
        tbench.main(["serve", "--num-devices", "0", "--inline"])
    assert exc.value.code == 2
    assert "--num-devices must be >= 1" in capsys.readouterr().err
    with pytest.raises(RuntimeError,
                       match="requested 2 devices, only 1 visible"):
        tbench.main(["serve", "--device", "cpu", "--num-devices", "2",
                     "--no-artifact", "--inline"])


@pytest.mark.parametrize("fail,supervised", [("start", False),
                                              ("group", False),
                                              ("group", True)])
def test_a_failing_rank_ends_the_run_with_no_record(fail, supervised,
                                                    tmp_path):
    """Rank 1 exits 3 at its start, or once the process group is up: the
    launcher stops rank 0 and the bench exits non-zero with no record on
    stdout; supervised, every attempt fails alike and nothing runs on one
    rank or again on the CPU."""
    env, _ = _probe_env(tmp_path, fail=fail)
    argv = ["throughput", "--device", "cpu", "--model", "mlp",
            "--num-devices", "2", *MODE_ARGS["throughput"]]
    argv += ["--max-attempts", "2"] if supervised else ["--inline"]
    rc, records, out, err = run_bench(argv, str(tmp_path), env_extra=env)
    assert rc != 0 and records == [], out
    assert "launch: rank " in err and " of 2 exited " in err
    assert ("rank one fails at its start" if fail == "start"
            else "rank one fails in the group") in err
    assert "bench: launches" not in err
    if supervised:
        assert "attempt 2/2" in err and "attempt 3" not in err
        assert "all attempts failed" in err and "fallback" not in err
