"""The bench's closed loops time their windows once their clients run.

A host that takes longer to start the clients than the ramp plus the
window must still measure a window of the requested duration with
requests in it, not an empty one: the serve closed loop (timed from
metrics.reset()), the gateway's closed loop over HTTP (its rates over
the window its clients had) and the multimodel leg's three phases (each
phase's stop time and grant baseline taken once its pumps run).
"""

import http.server
import json
import os
import sys
import threading
import time
from concurrent.futures import Future

import pytest

from distributedmnist_tpu_torch import bench

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _Batcher:
    def __init__(self):
        self.lock = threading.Lock()
        self.answered: list = []

    def submit(self, req):
        time.sleep(0.001)
        with self.lock:                 # answered: metrics land here
            self.answered.append(time.monotonic())
        f = Future()
        f.set_result(req)
        return f

    def pending_rows(self):
        return 0

    def inflight_batches(self):
        return 0


class _Metrics:
    def __init__(self, batcher):
        self.batcher = batcher
        self.t_reset = None

    def reset(self):
        self.t_reset = time.monotonic()

    def snapshot(self):
        now = time.monotonic()
        with self.batcher.lock:
            after = [t for t in self.batcher.answered if t >= self.t_reset]
        return {"window_s": now - self.t_reset, "requests": len(after)}


@pytest.mark.parametrize("start_delay_s", [0.0, 0.05])
def test_window_is_the_duration_however_slow_the_clients_start(
        monkeypatch, start_delay_s):
    real = bench.make_thread

    def slow_thread(*args, **kwargs):
        t = real(*args, **kwargs)
        start = t.start

        def slow_start():
            time.sleep(start_delay_s)       # a busy host's thread start
            start()
        t.start = slow_start
        return t

    monkeypatch.setattr(bench, "make_thread", slow_thread)
    batcher = _Batcher()
    metrics = _Metrics(batcher)
    duration = 0.2
    # 8 clients at 0.05 s each take 0.4 s to start: past ramp + duration
    snap = bench._serve_closed_loop(batcher, metrics, [1], clients=8,
                                    duration=duration)
    assert snap["window_s"] >= duration
    assert snap["requests"] > 0


def test_min_requests_runs_on_past_the_window(monkeypatch):
    batcher = _Batcher()
    metrics = _Metrics(batcher)
    monkeypatch.setattr(bench, "CLOSED_LOOP_MAX_S", 5.0)
    snap = bench._serve_closed_loop(batcher, metrics, [1], clients=2,
                                    duration=0.05, min_requests=150)
    assert snap["requests"] >= 150


def _slow_starts(monkeypatch, delay_s: float, names=None):
    """Each thread the bench makes (those named in `names`, when given)
    sleeps `delay_s` in its start() before it starts: a busy host."""
    real = bench.make_thread

    def slow_thread(*args, **kwargs):
        t = real(*args, **kwargs)
        if names is None or t.name in names:
            start = t.start

            def slow_start():
                time.sleep(delay_s)
                start()
            t.start = slow_start
        return t

    monkeypatch.setattr(bench, "make_thread", slow_thread)


class _Predict(http.server.BaseHTTPRequestHandler):
    """POST /predict answers 200; each answer's time is recorded."""
    protocol_version = "HTTP/1.1"

    def do_POST(self):
        self.rfile.read(int(self.headers["Content-Length"]))
        body = b"{}"
        self.send_response(200 if self.path == "/predict" else 404)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)
        with self.server.lock:
            self.server.answered.append(time.perf_counter())

    def log_message(self, *args):
        pass


@pytest.fixture
def predict_server():
    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _Predict)
    srv.daemon_threads = True
    srv.lock, srv.answered = threading.Lock(), []
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        yield srv
    finally:
        srv.shutdown()
        srv.server_close()
        t.join(timeout=10)


def _root_bench():
    """The root bench.py, imported as tests/test_torch_bench.py does."""
    sys.path.insert(0, REPO)
    try:
        import bench as root
    finally:
        sys.path.remove(REPO)
    return root


def test_gateway_window_starts_once_its_clients_run(monkeypatch,
                                                    predict_server):
    duration, clients = 0.3, 2
    # each client's start outlasts the old common start line and window
    _slow_starts(monkeypatch, 0.2 + duration + 0.1)
    t0 = time.perf_counter()
    rec = bench._gw_closed_loop(predict_server.server_address[1], clients,
                                duration, rows=1, seed=0)
    took = time.perf_counter() - t0
    with predict_server.lock:
        answered = list(predict_server.answered)
    assert rec["requests_ok"] > 0
    assert rec["requests_ok"] == len(answered)
    assert (rec["transport_errors"], rec["shed_503"]) == (0, 0)
    assert rec["duration_s"] == duration and rec["clients"] == clients
    # over the window the clients had: at least the duration, from its
    # start to the last answer; within the call, after the slow starts
    had = rec["requests_ok"] / rec["requests_per_sec"]
    assert duration * 0.99 <= had <= took
    assert had >= (answered[-1] - answered[0]) * 0.99
    assert rec["rows_per_sec"] == rec["requests_per_sec"]


def test_gateway_record_keeps_the_root_bench_keys(predict_server):
    port = predict_server.server_address[1]
    ours = bench._gw_closed_loop(port, 2, 0.1, rows=1, seed=0)
    theirs = _root_bench()._gw_closed_loop(port, 2, 0.1, rows=1, seed=0)
    assert set(ours) == set(theirs)


def test_multimodel_phases_start_once_their_pumps_run(monkeypatch):
    duration = 0.3
    _slow_starts(monkeypatch, duration + 0.1,
                 names={"bench-mm-light", "bench-mm-heavy"})
    leg = bench._serve_multimodel_leg(bench._BuildCounter(), "cpu",
                                      duration, rows=1)
    for k in ("light_solo_p99_ms", "light_mixed_p99_ms",
              "light_p99_degradation_x"):
        assert isinstance(leg[k], float), (k, leg[k])
    assert set(leg["fairness"]) == {"light", "heavy"}
    assert all(f["granted_rows"] > 0 for f in leg["fairness"].values())
    json.dumps(leg)
