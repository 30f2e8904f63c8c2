"""The streaming host-to-device input pipeline — the port of
distributedmnist_tpu/data/host_loader.py, for datasets too large to live
on the card.

The default pipeline (loader.DeviceDataset + IndexStream) keeps the
whole train set on the card and moves only indices. This one keeps it on
the host: each rank gathers, from the same IndexStream permutation, only
the rows of its own data share of every global batch (as the JAX
package's per-device callback gathers only its device's rows), into
pinned memory, and copies them to its device without waiting
(`non_blocking=True`, so the copy of block k+1 overlaps the steps of
block k). Batch order is the device-resident pipeline's exactly, so the
two are interchangeable mid-training and held against each other.

Two host-gather sources, with the same order and the same batches:
- "numpy": the gather runs in the training loop, at next_block.
- "tfdata": the role the JAX package gives tf.data (a per-host pipeline
  that gathers ahead, prefetch 2), in torch's idiom: a background thread
  gathers blocks from a private IndexStream clone into a queue two deep,
  and the canonical IndexStream stays the only authority on order (each
  prefetched block's indices are checked against it). There is no
  tensorflow here: this is not tf.data.
"""

from __future__ import annotations

import queue
import threading
from typing import Optional

import numpy as np
import torch

from distributedmnist_tpu_torch.analysis.locks import make_thread
from distributedmnist_tpu_torch.data.loader import IndexStream
from distributedmnist_tpu_torch.parallel.mesh import batch_shard

SOURCES = ("numpy", "tfdata")
PREFETCH = 2


class _Ahead:
    """The tfdata source's background gatherer of k-step blocks."""

    def __init__(self, stream: "HostStream", k: int):
        self.k = k
        self.queue: queue.Queue = queue.Queue(maxsize=PREFETCH)
        self.stop = threading.Event()
        lookahead = IndexStream(stream.indices.train_n,
                                stream.indices.global_batch,
                                stream.indices.seed,
                                start_step=stream.indices.step)
        self.thread = make_thread(self._run, "host-stream-prefetch",
                                  daemon=True, args=(stream, lookahead))
        self.thread.start()

    def _run(self, stream: "HostStream", lookahead: IndexStream) -> None:
        try:
            while not self.stop.is_set():
                idx = lookahead.host_block(self.k)
                item = ("block", (idx, *stream.gather(idx)))
                while not self.stop.is_set():
                    try:
                        self.queue.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
        except BaseException as e:      # handed to the consumer, re-raised
            self.queue.put(("error", e))

    def get(self):
        kind, item = self.queue.get()
        if kind == "error":
            raise item
        return item

    def close(self) -> None:
        self.stop.set()
        self.thread.join(timeout=10)


class HostStream:
    """Yields (x_block, y_block) on `device`: (k, B/world, 28, 28, 1)
    uint8 pixels and (k, B/world) int64 labels, rank `rank`'s columns of
    k global batches of `global_batch` rows."""

    def __init__(self, train_x: np.ndarray, train_y: np.ndarray,
                 global_batch: int, seed: int, device,
                 start_step: int = 0, source: str = "numpy",
                 rank: int = 0, world: int = 1):
        if source not in SOURCES:
            raise ValueError(f"unknown host-stream source {source!r} "
                             "(expected 'numpy' or 'tfdata')")
        self.train_x = train_x
        self.train_y = train_y
        self.device = torch.device(device)
        self.source = source
        self.cols = batch_shard(global_batch, rank, world)
        self.indices = IndexStream(train_x.shape[0], global_batch, seed,
                                   start_step=start_step)
        self._ahead: Optional[_Ahead] = None

    @property
    def step(self) -> int:
        return self.indices.step

    def gather(self, idx: np.ndarray) -> tuple[torch.Tensor, torch.Tensor]:
        """The rows of this rank's columns of the (k, global_batch) index
        block, gathered on the host: into pinned memory when the device
        is a card (so its copy need not wait)."""
        cols = idx[:, self.cols]
        pin = self.device.type == "cuda"
        x = torch.empty(cols.shape + self.train_x.shape[1:],
                        dtype=torch.uint8, pin_memory=pin)
        y = torch.empty(cols.shape, dtype=torch.int64, pin_memory=pin)
        np.take(self.train_x, cols, axis=0, out=x.numpy())
        y.numpy()[...] = self.train_y[cols]
        return x, y

    def _put(self, x: torch.Tensor, y: torch.Tensor):
        if self.device.type == "cpu":
            return x, y
        return (x.to(self.device, non_blocking=True),
                y.to(self.device, non_blocking=True))

    def next_block(self, k: int):
        """The next k steps' batches on the device; advances the stream."""
        if self.source == "numpy":
            return self._put(*self.gather(self.indices.host_block(k)))
        if self._ahead is None or self._ahead.k != k:
            # the block size changed (the run's last, shorter block): the
            # old gatherer stops before its replacement starts
            self.close()
            self._ahead = _Ahead(self, k)
        idx, x, y = self._ahead.get()
        want = self.indices.host_block(k)
        if not np.array_equal(idx, want):
            raise RuntimeError("the prefetched block left the canonical "
                               "batch order")
        return self._put(x, y)

    def close(self) -> None:
        """Stop the tfdata source's background thread, if any."""
        if self._ahead is not None:
            self._ahead.close()
            self._ahead = None
