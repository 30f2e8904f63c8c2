"""Stall-watchdog process supervision — the port's copy of
distributedmnist_tpu/utils/supervise.py.

The supervisor runs the real work in a worker subprocess, watches its
stdout/stderr for activity, and kills and retries a worker that goes
silent too long (a device claim or a collective that never returns) or
that exits without a result. Acceptance of a worker's output is
delegated to the caller (e.g. "a parseable JSON record with a 'metric'
key"), so a crashed worker's stray output is never forwarded as a
result.

Used by the port's bench (by default) and train CLI (--supervise). The
worker is `python -u` followed by a command line, a script or `-m
module` and its arguments. Unlike the reference, there is no
`fallback_env` attempt: a supervised run that fails on every attempt
fails, and nothing can re-run it on another device.
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import threading
import time
from typing import Callable, Optional

_WORKER_ENV = "DMNIST_SUPERVISED_WORKER"


def is_worker() -> bool:
    return os.environ.get(_WORKER_ENV) == "1"


def mark(msg: str) -> None:
    """Progress marker on stderr — the supervisor's liveness signal."""
    print(f"supervise: {msg}", file=sys.stderr, flush=True)


def run_supervised(command: list[str],
                   accept: Callable[[list[str]], Optional[str]],
                   stall_timeout: float = 300.0,
                   attempts: int = 3,
                   final_codes: tuple = ()) -> int:
    """Run `python -u *command` as a worker (marked via env); kill +
    retry if it produces no output for stall_timeout seconds. `accept`
    maps worker stdout lines to the result to forward (or None if they
    contain no valid result); while the worker runs it is called with
    successive chunks of NEWLY-arrived lines — not the whole buffer —
    and the most recent non-None result wins, so each line is scanned
    once per attempt. Acceptors must therefore be LINE-LOCAL (decide per
    line, like json_record_acceptor): a record straddling a poll
    boundary is split across chunks. As a safety net for acceptors that
    do need cross-line context, after the worker exits with no chunk
    result the whole buffer is re-scanned in ONE final accept() call.
    A worker that exits without a result on one of `final_codes` (a
    deterministic refusal) is not retried: its code is returned.
    Returns the exit code; the accepted result is written to stdout."""
    env = dict(os.environ, **{_WORKER_ENV: "1"})
    for attempt in range(1, attempts + 1):
        proc = subprocess.Popen(
            [sys.executable, "-u", *command],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, env=env, start_new_session=True)
        last = [time.monotonic()]
        out_lines: list[str] = []

        def pump(stream, sink):
            for line in stream:
                last[0] = time.monotonic()
                sink(line)

        threads = [
            threading.Thread(target=pump,
                             args=(proc.stdout, out_lines.append),
                             daemon=True),
            threading.Thread(target=pump,
                             args=(proc.stderr, sys.stderr.write),
                             daemon=True),
        ]
        for t in threads:
            t.start()

        # Incremental result scan: each one-second poll hands accept()
        # only the lines that arrived since the last poll and caches the
        # latest hit — re-scanning the whole buffer every poll is
        # O(lines^2) over a chatty multi-hour run.
        scanned = 0
        cached = None

        def current_result():
            nonlocal scanned, cached
            new = out_lines[scanned:]
            scanned += len(new)
            if new:
                r = accept(new)
                if r is not None:
                    cached = r
            return cached

        stalled = False
        teardown_grace = min(30.0, stall_timeout)
        # Hard per-attempt ceiling: a wedged worker that emits periodic
        # chatter (retry warnings, reconnect spam) never goes quiet, so
        # silence alone cannot bound the attempt. 8x the stall timeout
        # (floor 40 min) keeps a chattering-but-wedged worker from
        # burning hours before the kill while leaving room for the
        # slowest legitimate attempt.
        deadline = time.monotonic() + max(8 * stall_timeout, 2400.0)
        while proc.poll() is None:
            quiet = time.monotonic() - last[0]
            if current_result() is not None and quiet > teardown_grace:
                # Result produced; only the worker's teardown is hanging.
                break
            if quiet > stall_timeout:
                stalled = True
                stall_reason = f"no output for {stall_timeout:.0f}s"
                break
            if time.monotonic() > deadline:
                stalled = True
                stall_reason = "attempt deadline exceeded"
                break
            time.sleep(1)

        if proc.poll() is None:
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
        proc.wait()
        for t in threads:
            t.join(timeout=5)

        result = current_result()
        if result is None and out_lines:
            # Post-exit fallback: one full-buffer scan. Chunk-wise
            # scanning is line-local by contract; an acceptor needing
            # cross-line context (multi-line JSON, line pairs) would
            # miss a record split across poll boundaries — after process
            # exit the complete buffer exists, so scan it once.
            result = accept(out_lines)
        if result is not None:
            sys.stdout.write(result)
            sys.stdout.flush()
            return 0
        if not stalled and proc.returncode in final_codes:
            mark(f"worker refused (exit code {proc.returncode}); not "
                 "retried")
            return proc.returncode
        reason = stall_reason if stalled else f"exit code {proc.returncode}"
        mark(f"worker failed ({reason}), attempt {attempt}/{attempts}")
    mark("all attempts failed")
    return 1


def json_record_acceptor(required_key: str):
    """accept() factory: the last stdout line that parses as a JSON object
    containing `required_key`.

    LINE-LOCAL by design — each line is judged on its own, so the
    acceptor is correct under run_supervised's chunk-wise delivery
    (accept() sees only newly-arrived lines per poll, never the whole
    buffer until the post-exit fallback). Any future acceptor that needs
    cross-line context must rely on that post-exit full-buffer scan
    instead."""
    import json

    def accept(out_lines: list[str]) -> Optional[str]:
        # The line-local contract also means every element must BE one
        # line; a caller handing in multi-line strings would defeat the
        # chunking guarantee silently.
        assert all("\n" not in line.rstrip("\n") for line in out_lines), \
            "json_record_acceptor expects one line per list element"
        for line in reversed(out_lines):
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if isinstance(rec, dict) and required_key in rec:
                return line
        return None

    return accept
