"""Start N ranks of a command on this host: the port's way to do what one
JAX process does over N local chips (a JAX process drives them all; the
port runs one process a device).

Each rank gets the torchrun environment (MASTER_ADDR/MASTER_PORT of a
free local port, WORLD_SIZE, RANK, LOCAL_RANK, LOCAL_WORLD_SIZE), which
parallel/distributed.maybe_initialize reads, and, as torchrun gives it,
OMP_NUM_THREADS=1 unless the caller set it: N ranks each running a
thread a core oversubscribe the host (a 2-rank MLP step on 8 CPU cores
took 134 ms with torch's default threads, 5.9 ms with one). Rank 0's
stdout is passed through; every rank's stderr is passed through line by
line, prefixed `[rank r] `; the other ranks' stdout is kept only for a
failure report.

A SIGTERM to the launcher is forwarded to every rank (the trainer's
graceful preemption agrees on a stopping step across ranks). If a rank
exits non-zero on its own, the launcher kills the rest, so none is left
blocked in a collective, and exits non-zero with that rank's output
tail, as the JAX package's multi-process test harness does.

Why not torch.distributed.run (torchrun, which sets the same
environment): run under it (torch 2.13), the train CLI breaks two of its
contracts. Every rank's stdout reaches the console, so a 2-rank run
prints two summary lines; `--local-ranks-filter 0` keeps one, prefixed
`[default0]:`, and drops the other ranks' stderr, their launch counts
and tracebacks with it. And a SIGTERM to torchrun, after the ranks have
saved their checkpoint and printed their summary, ends it with exit code
1 and a SignalException traceback, where the single-process CLI ends by
the SIGTERM itself. tests/test_torch_parallel.py holds the launcher to
both.
"""

from __future__ import annotations

import collections
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from typing import Optional

TAIL_LINES = 40


def local_ranks(cfg) -> int:
    """Ranks a train invocation with Config `cfg` starts on this host:
    1 when it is a rank already (coordinator flags, a launcher's
    environment), else num_devices, by default one a visible card (one
    on the cpu)."""
    from distributedmnist_tpu_torch.parallel import distributed

    if cfg.coordinator_address is not None or all(
            k in os.environ for k in distributed.LAUNCH_ENV):
        return 1
    if cfg.num_devices is not None:
        return cfg.num_devices
    if cfg.device == "cuda":
        import torch
        return max(1, torch.cuda.device_count())
    return 1


def run_ranks(module: str, argv: list[str], cfg) -> Optional[int]:
    """When `cfg` asks for more than one rank on this host, run
    `python -m module argv` as each of them (launch) and return the exit
    code; None when this process is the one rank to run."""
    n = local_ranks(cfg)
    if n <= 1:
        return None
    return launch([sys.executable, "-m", module, *argv], n)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _pump(stream, out, prefix: str, tail: collections.deque,
          lock: threading.Lock) -> None:
    for line in stream:
        tail.append(line)
        if out is not None:
            with lock:
                out.write(prefix + line)
                out.flush()
    stream.close()


def launch(argv: list[str], n: int) -> int:
    """Run `argv` as ranks 0..n-1 and wait for all of them. Returns 0 when
    every rank exits 0, 1 when one fails (the rest are killed). After a
    forwarded SIGTERM that ended the ranks by that signal, re-delivers it
    to this process once their output is through."""
    port = free_port()
    lock = threading.Lock()
    procs, tails, pumps = [], [], []
    for r in range(n):
        env = dict(os.environ, MASTER_ADDR="localhost",
                   MASTER_PORT=str(port), WORLD_SIZE=str(n), RANK=str(r),
                   LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(n))
        env.setdefault("OMP_NUM_THREADS", "1")
        proc = subprocess.Popen(argv, env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        tail: collections.deque = collections.deque(maxlen=TAIL_LINES)
        for stream, out, prefix in (
                (proc.stdout, sys.stdout if r == 0 else None, ""),
                (proc.stderr, sys.stderr, f"[rank {r}] ")):
            t = threading.Thread(target=_pump,
                                 args=(stream, out, prefix, tail, lock),
                                 daemon=True)
            t.start()
            pumps.append(t)
        procs.append(proc)
        tails.append(tail)

    terminated = []

    def _forward(signum, frame):
        terminated.append(signum)
        for p in procs:
            if p.poll() is None:
                p.send_signal(signum)

    prev = signal.signal(signal.SIGTERM, _forward)
    def first_failed():
        """The first rank that exited non-zero, but by a SIGTERM this
        launcher forwarded."""
        return next((r for r, p in enumerate(procs)
                     if p.poll() not in (None, 0) and not (
                         terminated and p.returncode == -signal.SIGTERM)),
                    None)

    failed = None
    try:
        while failed is None and any(p.poll() is None for p in procs):
            failed = first_failed()
            time.sleep(0.05)
        if failed is None:
            failed = first_failed()
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
        for t in pumps:
            t.join(timeout=10)
        signal.signal(signal.SIGTERM, prev)
    if failed is not None:
        with lock:
            sys.stderr.write(
                f"launch: rank {failed} of {n} exited "
                f"{procs[failed].returncode}; the other ranks were "
                f"stopped. Its last lines:\n" + "".join(tails[failed]))
            sys.stderr.flush()
        return 1
    if terminated and any(p.returncode == -signal.SIGTERM for p in procs):
        sys.stdout.flush()
        signal.signal(signal.SIGTERM, signal.SIG_DFL)
        os.kill(os.getpid(), signal.SIGTERM)
    return 0
