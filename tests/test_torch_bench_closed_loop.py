"""The bench's closed loop times its window from metrics.reset().

A host that takes longer to start the clients than the ramp plus the
window must still measure a window of the requested duration with
requests in it, not an empty one.
"""

import threading
import time
from concurrent.futures import Future

import pytest

from distributedmnist_tpu_torch import bench


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
