"""Batched inference engine: a forward-only step over a bucket ladder,
with pooled host staging and a dispatch()/fetch() split.

Requests arrive at arbitrary sizes and are rounded up to a fixed ladder
of power-of-two **buckets**: an n-row request pads into the smallest
covering bucket, runs, and the first n rows of the result come back. On
the card every dispatch is asynchronous: dispatch() pads into a pooled
pinned host buffer, copies it to the device with non_blocking=True,
launches the forward and the device->host copy of the logits into a
pinned output buffer, records a CUDA event, and returns. fetch() waits on
that event — the one synchronizing step — and returns the rows. A
staging pair is recycled only after its fetch, so the next dispatch can
never overwrite a buffer the card is still reading or writing.

One engine serves one (model, precision): the MLP or LeNet-5, whose
input is the staged (B, 28, 28, 1) uint8 batch either way. The float32
engine runs the model's own forward on raw uint8 pixels divided by 255
inside the step; the bfloat16/int8/megakernel engines run
serve/quantize.py's variants. On the card an engine pins float32
numerics (TF32 off for matmuls and cuDNN convolutions) for the rest of
the process: the float32 engine is the reference every parity gate
measures against, and the flags are process-wide, so switching them per
dispatch would race between the dispatch thread and an admin thread
warming a variant.
"""

from __future__ import annotations

import dataclasses
import logging
import statistics
import time
from typing import Any, Optional

import numpy as np
import torch

from distributedmnist_tpu_torch.analysis.locks import make_lock
from distributedmnist_tpu_torch.ops import kernel_lib
from distributedmnist_tpu_torch.utils import round_up
from distributedmnist_tpu_torch.utils.device import (pin_float32_numerics,
                                                     resolve_device)

log = logging.getLogger("distributedmnist_tpu_torch")

IMAGE_SHAPE = (28, 28, 1)
IMAGE_SIZE = 28 * 28
NUM_CLASSES = 10


@dataclasses.dataclass
class _Staging:
    """One pooled pair: the uint8 input rows and the f32 logits rows of a
    bucket, pinned on the host when the engine runs on the card."""

    x: torch.Tensor              # (bucket, 28, 28, 1) uint8
    out: torch.Tensor            # (bucket, 10) float32
    x_np: np.ndarray             # numpy view of x, for the host-side pad


@dataclasses.dataclass
class InferenceHandle:
    """A dispatched-but-unfetched forward; consumed once by fetch()."""

    n: int                        # real rows (the rest is padding)
    bucket: int
    staging: Optional[_Staging]   # recycled on fetch; None after
    done: Any = None              # torch.cuda.Event on the card, else None
    version: Optional[str] = None
    infer_dtype: Optional[str] = None


def make_buckets(max_batch: int, n_chips: int = 1,
                 min_bucket: int = 1) -> tuple[int, ...]:
    """Powers of two scaled to multiples of n_chips, doubling from
    round_up(min_bucket, n_chips) until max_batch is covered."""
    if max_batch < 1:
        raise ValueError(f"max_batch must be >= 1, got {max_batch}")
    b = round_up(max(min_bucket, 1), n_chips)
    ladder = [b]
    while ladder[-1] < max_batch:
        ladder.append(ladder[-1] * 2)
    return tuple(ladder)


class InferenceEngine:
    """infer(x) takes uint8 images, (n, 28, 28, 1) or (n, 784), and returns
    float32 logits (n, 10). Padded rows are computed and discarded."""

    def __init__(self, model: str, params: dict, device="cuda",
                 max_batch: int = 512, version: Optional[str] = None,
                 infer_dtype: str = "float32"):
        from distributedmnist_tpu_torch import models

        self.device = resolve_device(device)
        self.platform = self.device.type
        self.version = version
        self.infer_dtype = infer_dtype
        self.max_batch = max_batch
        self.buckets = make_buckets(max_batch)
        self._pin = self.device.type == "cuda"
        if self._pin:
            pin_float32_numerics()
        # The float32 parameters on the device: the registry builds every
        # variant of a version from these.
        self.params = {k: torch.as_tensor(v).detach().to(self.device)
                       for k, v in params.items()}
        if infer_dtype == "float32":
            net = models.build(model, device=self.device)
            net.load_state_dict(self.params)
            net.eval()

            def forward(x_u8):
                # cast + /255 in-step: the host->device copy stays uint8
                return net(x_u8.to(torch.float32) / 255.0)
        else:
            from distributedmnist_tpu_torch.serve.quantize import \
                prepare_inference

            prep, fast_forward = prepare_inference(model, self.params,
                                                   infer_dtype)
            prep = {k: v.to(self.device) for k, v in prep.items()}

            def forward(x_u8):
                return fast_forward(prep, x_u8)
        self._forward = forward
        # Host staging pairs, one free-list per bucket: bounded by the
        # caller's dispatched-but-unfetched window, never by traffic.
        self._staging_pool: dict[int, list[_Staging]] = {
            b: [] for b in self.buckets}
        self._staging_lock = make_lock("engine.staging")
        # Per-bucket measured dispatch cost (median and p95 of end-to-end
        # infer seconds, timed by warmup) — the batch former's price list.
        self._bucket_cost: dict[int, float] = {}
        self._bucket_cost_p95: dict[int, float] = {}

    # -- bucketing ---------------------------------------------------------

    def bucket_for(self, n: int) -> int:
        """Smallest bucket covering n rows."""
        if n < 1:
            raise ValueError(f"need at least one row, got {n}")
        for b in self.buckets:
            if b >= n:
                return b
        raise ValueError(
            f"batch of {n} rows exceeds the top bucket "
            f"{self.buckets[-1]} (raise max_batch)")

    @staticmethod
    def _as_images(x) -> np.ndarray:
        x = np.asarray(x)
        if x.dtype != np.uint8:
            raise TypeError(f"expected uint8 pixels, got {x.dtype}")
        if x.ndim == 2 and x.shape[1] == IMAGE_SIZE:
            x = x.reshape(-1, *IMAGE_SHAPE)
        if x.ndim != 4 or x.shape[1:] != IMAGE_SHAPE:
            raise ValueError(
                f"expected (n, 28, 28, 1) or (n, 784) images, "
                f"got shape {x.shape}")
        return x

    # -- staging pool ------------------------------------------------------

    def _staging_take(self, bucket: int) -> _Staging:
        with self._staging_lock:
            pool = self._staging_pool[bucket]
            if pool:
                return pool.pop()
        x = torch.empty((bucket, *IMAGE_SHAPE), dtype=torch.uint8,
                        pin_memory=self._pin)
        out = torch.empty((bucket, NUM_CLASSES), dtype=torch.float32,
                          pin_memory=self._pin)
        return _Staging(x=x, out=out, x_np=x.numpy())

    def _staging_put(self, bucket: int, staging: _Staging) -> None:
        with self._staging_lock:
            self._staging_pool[bucket].append(staging)

    def staging_buffers(self) -> dict[int, int]:
        """Per-bucket free-list sizes."""
        with self._staging_lock:
            return {b: len(p) for b, p in self._staging_pool.items()}

    # -- inference ---------------------------------------------------------

    def dispatch(self, x) -> InferenceHandle:
        """Pad `x` — one uint8 image array or a list of them (coalesced
        requests, staged directly) — into a pooled staging buffer, copy
        it to the device, launch the forward and the copy of the logits
        back, and return without waiting."""
        parts = ([self._as_images(p) for p in x]
                 if isinstance(x, (list, tuple))
                 else [self._as_images(x)])
        n = sum(p.shape[0] for p in parts)
        b = self.bucket_for(n)
        staging = self._staging_take(b)
        dispatched = False
        try:
            off = 0
            for p in parts:
                staging.x_np[off:off + p.shape[0]] = p
                off += p.shape[0]
            if n < b:
                staging.x_np[n:] = 0
            done = None
            with torch.inference_mode():
                x_dev = staging.x.to(self.device, non_blocking=True)
                logits = self._forward(x_dev)
                staging.out.copy_(logits, non_blocking=True)
                if self._pin:
                    done = torch.cuda.Event()
                    done.record(torch.cuda.current_stream(self.device))
            dispatched = True
        finally:
            if not dispatched:
                self._staging_put(b, staging)
        return InferenceHandle(n=n, bucket=b, staging=staging, done=done,
                               version=self.version,
                               infer_dtype=self.infer_dtype)

    def fetch(self, handle: InferenceHandle) -> np.ndarray:
        """Wait for the batch (the device->host copy of its logits) and
        return its real rows. Recycles the staging pair whether the wait
        succeeds or raises; one-shot."""
        staging = handle.staging
        if staging is None:
            raise RuntimeError("handle already fetched")
        try:
            if handle.done is not None:
                handle.done.synchronize()
            return staging.out.numpy()[:handle.n].copy()
        finally:
            handle.staging = None
            self._staging_put(handle.bucket, staging)

    def infer(self, x) -> np.ndarray:
        """Logits (n, 10) for n uint8 images: dispatch() then fetch()."""
        return self.fetch(self.dispatch(x))

    def warmup(self, cost_samples: int = 5) -> int:
        """Run every bucket once (which builds or loads the kernel
        libraries on first use), then time each bucket cost_samples times
        into the median and p95 cost tables. Returns the number of kernel
        library builds or loads the warmup triggered — 0 for a warm
        engine, which the registry's verification pass requires."""
        before = kernel_lib.load_events()
        costs, costs_p95 = {}, {}
        for b in self.buckets:
            x = np.zeros((b, *IMAGE_SHAPE), np.uint8)
            self.infer(x)              # first run: never timed
            samples = []
            for _ in range(max(1, cost_samples)):
                t0 = time.perf_counter()
                self.infer(x)
                samples.append(time.perf_counter() - t0)
            costs[b] = statistics.median(samples)
            samples.sort()
            costs_p95[b] = samples[min(len(samples) - 1,
                                       int(0.95 * len(samples)))]
        # one reference swap: a concurrent reader sees a whole table
        self._bucket_cost = costs
        self._bucket_cost_p95 = costs_p95
        builds = kernel_lib.load_events() - before
        log.info("serve engine warm [%s on %s]: %d buckets %s (%d kernel "
                 "library loads); bucket cost ms %s", self.infer_dtype,
                 self.device, len(self.buckets), list(self.buckets), builds,
                 {b: round(c * 1e3, 3)
                  for b, c in sorted(self._bucket_cost.items())})
        return builds

    def bucket_costs(self) -> dict[int, float]:
        """Median seconds per dispatch of each bucket (empty before
        warmup — the batch former then does not split)."""
        return self._bucket_cost

    def bucket_costs_p95(self) -> dict[int, float]:
        return self._bucket_cost_p95
