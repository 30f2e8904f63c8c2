"""Metrics — latency percentiles for serving, and the trainer's
throughput timer and logger (the port of
distributedmnist_tpu/utils/metrics.py).

Timing respects CUDA's asynchronous launches: StepTimer closes a window
only after the work it counts has finished on the card (a CUDA event
recorded after it, synchronized), never on a launch that returned.
"""

from __future__ import annotations

import contextlib
import json
import logging
import time
from typing import Any, Optional

import numpy as np

log = logging.getLogger("distributedmnist_tpu_torch")


def percentiles(values, qs=(50, 95, 99)) -> dict:
    """{f"p{q}": value} by linear interpolation over sorted `values`
    (numpy's default quantile method). Empty input yields None per key —
    a window with no completed requests must not fake a zero latency."""
    if len(values) == 0:
        return {f"p{int(q)}": None for q in qs}
    arr = np.asarray(values, dtype=np.float64)
    out = np.quantile(arr, [q / 100.0 for q in qs])
    return {f"p{int(q)}": float(v) for q, v in zip(qs, out)}


class StepTimer:
    """Throughput over the training loop, warm-up excluded.

    Call start() after the first block (kernel builds, cuDNN's first
    calls), lap(k) after each later block of k steps; snapshot() closes
    the window. images/sec/chip = images / elapsed / n_chips.
    """

    def __init__(self, global_batch: int, n_chips: int):
        self.global_batch = global_batch
        self.n_chips = n_chips
        self.t0: Optional[float] = None
        self.steps = 0
        self.excluded = 0.0

    @staticmethod
    def barrier(sync: Any) -> None:
        """Wait until the work behind `sync`, a torch.cuda.Event recorded
        after it, has finished. None waits for nothing (on the CPU every
        op has finished when it returns)."""
        if sync is not None:
            sync.synchronize()

    def start(self, sync: Any = None) -> None:
        self.barrier(sync)
        self.t0 = time.perf_counter()
        self.steps = 0
        self.excluded = 0.0

    def lap(self, n: int = 1) -> None:
        self.steps += n

    @contextlib.contextmanager
    def exclude(self):
        """Exclude a span that is not training (eval, checkpoint copy)
        from the throughput window."""
        t = time.perf_counter()
        try:
            yield
        finally:
            self.excluded += time.perf_counter() - t

    def snapshot(self, sync: Any = None) -> dict:
        self.barrier(sync)
        # no window was ever opened (an eval-only run): a zero window,
        # not -excluded
        if self.t0 is None:
            elapsed = 0.0
        else:
            elapsed = time.perf_counter() - self.t0 - self.excluded
        images = self.steps * self.global_batch
        ips = images / elapsed if elapsed > 0 else 0.0
        return {
            "elapsed_s": elapsed,
            "steps_timed": self.steps,
            "images_per_sec": ips,
            "images_per_sec_per_chip": ips / max(self.n_chips, 1),
            "step_ms": 1000.0 * elapsed / self.steps if self.steps else 0.0,
        }


class MetricsLogger:
    """Per-step scalar log and the final JSON line. Cadence is the
    caller's job: step() fetches its values (float()), which waits for
    the card, so the trainer calls it at log_every, never every step."""

    def __init__(self):
        self.history: list[dict] = []

    def step(self, step: int, scalars: dict) -> None:
        rec = {"step": step}
        rec.update({k: float(v) for k, v in scalars.items()})
        self.history.append(rec)
        log.info("step %6d  %s", step,
                 "  ".join(f"{k}={v:.4g}" for k, v in rec.items()
                           if k != "step"))

    def eval(self, step: int, accuracy: float) -> None:
        log.info("eval step %6d  test_accuracy=%.4f", step, accuracy)
        self.history.append({"step": step, "test_accuracy": float(accuracy)})

    @staticmethod
    def summary_line(summary: dict) -> str:
        return json.dumps(summary, sort_keys=True)
