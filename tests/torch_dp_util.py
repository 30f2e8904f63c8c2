"""Shared test helper: start N ranks of the port's data-parallel smoke
worker (`distributedmnist_tpu_torch.parallel.mh_smoke`) on a free
localhost port and read their MHSMOKE records; and run the port's bench,
whose training modes start their own ranks, to its end. Imports no jax,
so the card's tests (run without tests/conftest.py) use it too.

Each rank writes its output to files, never to a pipe that could fill
and stall it while the test waits on another rank; every wait has a
timeout, and every rank still running when the helper returns is
killed, so no rank is left blocked in a collective."""

import json
import os
import signal
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_TIMEOUT_S = 150


def spawn_smoke(n, tmp, runs, extra=(), env_extra=None):
    """Start ranks 0..n-1 of mh_smoke with `runs` (a list of Config
    overrides) on the cpu, or on the card where `extra` says
    `--device cuda` (the later flag wins); returns [(process, stdout
    path, stderr path)]."""
    from distributedmnist_tpu_torch.parallel import launch

    port = launch.free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1", **(env_extra or {}))
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    ranks = []
    try:
        for r in range(n):
            out = os.path.join(tmp, f"rank{r}-{port}.out")
            err = os.path.join(tmp, f"rank{r}-{port}.err")
            with open(out, "w") as fo, open(err, "w") as fe:
                proc = subprocess.Popen(
                    [sys.executable, "-m",
                     "distributedmnist_tpu_torch.parallel.mh_smoke", str(r),
                     str(n), str(port), "--runs", json.dumps(runs),
                     "--device", "cpu", *extra],
                    stdout=fo, stderr=fe, env=env, cwd=REPO)
            ranks.append((proc, out, err))
    except BaseException:
        kill(ranks)
        raise
    return ranks


def kill(ranks) -> None:
    for proc, _, _ in ranks:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def collect(ranks, n_runs, timeout=RANK_TIMEOUT_S):
    """Wait for every rank (killing all of them on a timeout); assert
    each exited 0 with one record a run. Returns ([records of rank r],
    [stderr text of rank r])."""
    try:
        for proc, _, _ in ranks:
            proc.wait(timeout=timeout)
    finally:
        kill(ranks)
    recs, logs = [], []
    for proc, out, err in ranks:
        with open(out) as fo, open(err) as fe:
            text, log = fo.read(), fe.read()
        assert proc.returncode == 0, log[-3000:]
        recs.append([json.loads(ln.split(" ", 1)[1])
                     for ln in text.splitlines()
                     if ln.startswith("MHSMOKE ")])
        assert len(recs[-1]) == n_runs, text[-2000:] + log[-2000:]
        logs.append(log)
    return recs, logs


def launch_smoke(n, tmp, runs, extra=()):
    """Run ranks 0..n-1 to the end: collect(spawn_smoke(...))."""
    return collect(spawn_smoke(n, tmp, runs, extra), len(runs))


def run_bench(argv, tmp, timeout=RANK_TIMEOUT_S, env_extra=None):
    """`python -m distributedmnist_tpu_torch.bench *argv` to its end, in a
    session of its own with its output in files under `tmp`; when it
    ends, or at the timeout, the whole session (the launcher and every
    rank it started) is killed. Returns (exit code, [the JSON records on
    stdout], stdout, stderr)."""
    env = dict(os.environ, OMP_NUM_THREADS="1", **(env_extra or {}))
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    run_dir = tempfile.mkdtemp(prefix="bench-", dir=tmp)
    out = os.path.join(run_dir, "stdout")
    err = os.path.join(run_dir, "stderr")
    with open(out, "w") as fo, open(err, "w") as fe:
        proc = subprocess.Popen(
            [sys.executable, "-m", "distributedmnist_tpu_torch.bench",
             *argv], stdout=fo, stderr=fe, env=env, cwd=REPO,
            start_new_session=True)
    try:
        proc.wait(timeout=timeout)
    finally:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        proc.wait()
    with open(out) as fo, open(err) as fe:
        text, log = fo.read(), fe.read()
    records = [json.loads(ln) for ln in text.splitlines()
               if ln.startswith("{")]
    return proc.returncode, records, text, log
