"""A serving process as a child: any server that announces itself with a
{"metric": "serve_ready", "port": P} line (`python -m
distributedmnist_tpu_torch.serve --port 0 ...`, or the root serve.py),
started, read until that line within a deadline, talked to over HTTP and
stopped with SIGTERM. Its stdout lines are collected by a reader thread
and its stderr goes to a temporary file, so neither pipe can fill and
stall it.

    srv = ServerProcess([sys.executable, "-m",
                         "distributedmnist_tpu_torch.serve", "--port", "0"])
    srv.wait_for("/healthz 200", srv.healthy_payload)
    code, body = srv.call("/predict", data=pixels)
    done = srv.stop()       # done.rc, done.records, done.launches
"""

from __future__ import annotations

import dataclasses
import json
import signal
import subprocess
import tempfile
import threading
import time
import urllib.error
import urllib.request
from typing import Callable, Optional

from distributedmnist_tpu_torch.analysis.locks import make_thread

LAUNCHES_PREFIX = "serve: launches "


@dataclasses.dataclass
class Exited:
    """How a stopped server ended: its exit code, its stdout lines that
    parse as JSON, the tail of its stderr and the kernel launch counts of
    each `serve: launches {...}` line there."""
    rc: int
    records: list
    stderr: str
    launches: list


class ServerProcess:
    """`argv` started with stdout piped; raises RuntimeError (the child
    killed) unless a serve_ready line comes within `ready_timeout`
    seconds."""

    def __init__(self, argv, env=None, cwd=None,
                 ready_timeout: float = 120.0):
        self.err = tempfile.TemporaryFile("w+")
        self.proc = subprocess.Popen(argv, stdout=subprocess.PIPE,
                                     stderr=self.err, text=True, env=env,
                                     cwd=cwd)
        self.lines: list = []
        self.port: Optional[int] = None
        self._announced = threading.Event()
        self._reader = make_thread(target=self._read, name="server-stdout",
                                   daemon=True)
        self._reader.start()
        if not self._announced.wait(ready_timeout) or self.port is None:
            self.proc.kill()
            self.proc.wait()
            raise RuntimeError(
                f"{argv[1:]} gave no serve_ready line in {ready_timeout:g}s "
                f"(exit {self.proc.returncode}):\n{self.stderr()}")
        self.base = f"http://127.0.0.1:{self.port}"

    def _read(self):
        for line in self.proc.stdout:
            self.lines.append(line)
            if self.port is None and '"serve_ready"' in line:
                self.port = int(json.loads(line)["port"])
                self._announced.set()
        self._announced.set()           # EOF: the child has gone

    def stderr(self, tail: int = 4000) -> str:
        self.err.seek(0)
        return self.err.read()[-tail:]

    def call(self, path: str, data: Optional[bytes] = None,
             json_body=None, timeout: float = 120.0,
             headers: Optional[dict] = None) -> tuple[int, dict]:
        """(status, parsed JSON body) of one request, with `headers`;
        HTTP errors included. A body makes it a POST."""
        headers = dict(headers or {})
        if json_body is not None:
            data = json.dumps(json_body).encode()
            headers["Content-Type"] = "application/json"
        req = urllib.request.Request(self.base + path, data=data,
                                     headers=headers)
        try:
            with urllib.request.urlopen(req, timeout=timeout) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    def ok(self, path: str, **kw) -> dict:
        """The JSON body of a request that must answer 200."""
        code, body = self.call(path, **kw)
        if code != 200:
            raise RuntimeError(f"{path}: {code} {body}")
        return body

    def healthy_payload(self) -> Optional[dict]:
        """/healthz's payload when it answers 200, else None."""
        code, body = self.call("/healthz")
        return body if code == 200 else None

    def wait_for(self, what: str, predicate: Callable, timeout: float = 300.0,
                 poll_s: float = 0.2):
        """Poll `predicate` until it returns something true and return
        that; raises if the child exits or `timeout` seconds pass."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self.proc.poll() is not None:
                raise RuntimeError(f"server exited {self.proc.returncode} "
                                   f"while waiting for {what}:\n"
                                   f"{self.stderr()}")
            got = predicate()
            if got:
                return got
            time.sleep(poll_s)
        raise RuntimeError(f"timed out after {timeout:g}s waiting for "
                           f"{what}:\n{self.stderr()}")

    def stop(self, timeout: float = 120.0) -> Exited:
        """SIGTERM and wait for the exit (the child killed, and
        TimeoutExpired raised, past `timeout` seconds)."""
        self.proc.send_signal(signal.SIGTERM)
        try:
            rc = self.proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()
            raise
        self._reader.join(30)
        err = self.stderr(tail=1 << 30)
        self.err.close()
        records = []
        for line in self.lines:
            try:
                records.append(json.loads(line))
            except ValueError:
                pass
        launches = [json.loads(ln[len(LAUNCHES_PREFIX):])
                    for ln in err.splitlines()
                    if ln.startswith(LAUNCHES_PREFIX)]
        return Exited(rc=rc, records=records, stderr=err[-4000:],
                      launches=launches)
