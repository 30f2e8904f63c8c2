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

The fast lane's dispatch_fast() stages a lone request without the pooled
pad, on the submitting thread, by one of two resident routes:

- **exact fit** (n == covering bucket, a 1-row request on a ladder that
  starts at 1): the request's own rows are copied to the device from
  pageable memory, with no pool checkout and no pad;
- **row-staged** (a 1-row request into a smallest rung b > 1, up to
  FASTLANE_MAX_BUCKET): the row goes into row 0 of a warm device buffer
  of b rows, whose other rows are never read for the answer (every
  serving forward is row-independent). The buffer is single-flight: a
  non-blocking lock acquire, and None when it is busy. The row is
  written on the host into a pinned one-row buffer of the request's own
  (pooled like the output buffers, recycled at fetch), so nothing under
  that lock ever waits for the card: the copy out of the pinned row is
  ordered on the stream, and the row is rewritten only after its
  fetch.

Each fast dispatch has its own output buffer and CUDA event, so up to
max_inflight fast requests can be in flight beside the pooled pipeline.
warmup() prices the row route against the covering bucket's pooled
dispatch and turns it off where it is slower (`_warm_fastlane`).

An engine built with `streams`, one a device (each replica of a fleet
has its own), launches each shard's copies and kernels on its device's
stream and records its events there, so two replicas never queue behind
each other; a None stream is the device's current stream. Each stream
first waits for the work that built the engine's parameters on the
current stream.

**A group of devices** (`devices=[...]`, the JAX engine's 'data' mesh):
the engine is data-parallel over them. The parameters, and a variant's
prepared weights (prepared once), are copied once to each distinct
device; the ladder is `make_buckets(max_batch, n_chips)`, multiples of
n_chips = len(devices). dispatch() pads into the pooled pinned buffer
and then, for each shard i, copies its equal block of rows to device i
on that device's stream (`streams[i]`, or its current stream), launches
the forward there and copies the logits back into its block of the
pinned output, recording one event a shard; fetch() waits on them all.
The exact-fit fast route splits the same way; the row-staged one runs
shard 0 alone, whose first row is the request (its resident buffer is
one shard's rows on the first device). A shard that fails to launch
fails the dispatch. Several shards may share one device (on the CPU,
or two shards on one card), which runs the same split and gather.

Failpoints `engine.dispatch` and `engine.fetch` (serve/faults.py), the
span `engine.staging` (serve/trace.py) and the concurrency sanitizer's
hooks (analysis/sanitize.py: every pooled staging checkout is an
`engine.staging` resource until its recycle, and every host wait on the
card is declared with blocking()) are woven in; each is one None check
with no injector, tracer or sanitizer installed.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import statistics
import time
from typing import Optional, Sequence

import numpy as np
import torch

from distributedmnist_tpu_torch.analysis.locks import make_lock
from distributedmnist_tpu_torch.analysis.sanitize import (blocking,
                                                          resource_acquire,
                                                          resource_release)
from distributedmnist_tpu_torch.ops import kernel_lib
from distributedmnist_tpu_torch.serve import trace
from distributedmnist_tpu_torch.serve.faults import failpoint
from distributedmnist_tpu_torch.utils import round_up
from distributedmnist_tpu_torch.utils.device import (pin_float32_numerics,
                                                     resolve_device)

log = logging.getLogger("distributedmnist_tpu_torch")

IMAGE_SHAPE = (28, 28, 1)
IMAGE_SIZE = 28 * 28
NUM_CLASSES = 10

# The row-staged fast route serves only smallest rungs at or below this:
# past it the one-row saving is a rounding error of a large dispatch.
FASTLANE_MAX_BUCKET = 32


def fast_row_bucket(buckets) -> Optional[int]:
    """The one rung the row-staged route can serve: a 1-row request
    always covers into the SMALLEST rung, and when that rung is 1 the
    exact-fit route already skips staging, so there is no row route."""
    b = sorted(set(buckets))[0]
    return b if 1 < b <= FASTLANE_MAX_BUCKET else None


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
    done: tuple = ()              # a shard's torch.cuda.Event each (card)
    version: Optional[str] = None
    infer_dtype: Optional[str] = None
    # A fast-lane handle: no staging pair; its own output buffer `out`
    # (from the fast-lane pool, None once fetched) carries the one-shot,
    # and a row-staged one its pinned host row (recycled at fetch too)
    resident: bool = False
    out: Optional[torch.Tensor] = None
    row_host: Optional[torch.Tensor] = None


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
                 infer_dtype: str = "float32",
                 buckets: Optional[Sequence[int]] = None,
                 devices: Optional[Sequence] = None,
                 streams: Optional[Sequence] = None):
        self.devices = [resolve_device(d)
                        for d in (devices if devices else [device])]
        if len({d.type for d in self.devices}) != 1:
            raise ValueError(f"an engine's devices must be of one kind, "
                             f"got {self.devices}")
        self.device = self.devices[0]
        self.n_chips = len(self.devices)
        self.platform = self.device.type
        self.version = version
        self.infer_dtype = infer_dtype
        self.max_batch = max_batch
        self.buckets = (tuple(sorted(set(buckets))) if buckets
                        else make_buckets(max_batch, self.n_chips))
        if any(b % self.n_chips for b in self.buckets):
            raise ValueError(
                f"buckets {self.buckets} must be multiples of the "
                f"data-parallel width {self.n_chips}")
        self.streams = (list(streams) if streams is not None
                        else [None] * self.n_chips)
        if len(self.streams) != self.n_chips:
            raise ValueError(f"give one stream a device: {self.n_chips} "
                             f"devices, {len(self.streams)} streams")
        self.stream = self.streams[0]
        self._pin = self.device.type == "cuda"
        if self._pin:
            pin_float32_numerics()
        # The float32 parameters on the first device: the registry builds
        # every variant of a version from these.
        self.params = {k: torch.as_tensor(v).detach().to(self.device)
                       for k, v in params.items()}
        # One forward a distinct device, over its own copy of the same
        # bits; the first device's is also self._forward.
        prep = None
        if infer_dtype != "float32":
            from distributedmnist_tpu_torch.serve.quantize import \
                prepare_inference

            prep, fast_forward = prepare_inference(model, self.params,
                                                   infer_dtype)
        self._device_forwards = {}
        for d in dict.fromkeys(self.devices):
            if prep is None:
                on_d = (self.params if d == self.device else
                        {k: v.to(d) for k, v in self.params.items()})
                self._device_forwards[d] = self._float32_forward(model,
                                                                 on_d, d)
            else:
                self._device_forwards[d] = self._variant_forward(
                    fast_forward, {k: v.to(d) for k, v in prep.items()})
        for d, s in zip(self.devices, self.streams):
            if s is not None:
                # the parameters (and their quantized forms) were written
                # on the current stream: dispatches on this one must see
                # them
                s.wait_stream(torch.cuda.current_stream(d))
        # Host staging pairs, one free-list per bucket: bounded by the
        # caller's dispatched-but-unfetched window, never by traffic.
        self._staging_pool: dict[int, list[_Staging]] = {
            b: [] for b in self.buckets}
        self._staging_lock = make_lock("engine.staging")
        # Per-bucket measured dispatch cost (median and p95 of end-to-end
        # infer seconds, timed by warmup) — the batch former's price list.
        self._bucket_cost: dict[int, float] = {}
        self._bucket_cost_p95: dict[int, float] = {}
        # The fast lane: output buffers of its own (one per fast request
        # in flight, recycled at fetch), the row-staged route's resident
        # device buffer, and its pinned one-row host buffers (one per
        # row-staged request in flight, recycled at fetch). The route
        # serves only once warmup has priced it no slower than the
        # pooled dispatch of its rung.
        self._fast_out_pool: dict[int, list[torch.Tensor]] = {
            b: [] for b in self.buckets}
        self._fast_row_b = fast_row_bucket(self.buckets)
        self._fast_row_buf: Optional[torch.Tensor] = None
        self._fast_row_hosts: list[torch.Tensor] = []
        self._fast_row_ok = False
        self._fast_row_cost: Optional[float] = None
        self._fast_row_lock = make_lock("engine.fastlane")

    @property
    def _forward(self):
        """The first device's forward (what a one-device engine runs)."""
        return self._device_forwards[self.device]

    @_forward.setter
    def _forward(self, forward) -> None:
        self._device_forwards[self.device] = forward

    @staticmethod
    def _float32_forward(model: str, params: dict, device):
        from distributedmnist_tpu_torch import models

        net = models.build(model, device=device)
        net.load_state_dict(params)
        net.eval()

        def forward(x_u8):
            # cast + /255 in-step: the host->device copy stays uint8
            return net(x_u8.to(torch.float32) / 255.0)

        return forward

    @staticmethod
    def _variant_forward(fast_forward, prep: dict):
        def forward(x_u8):
            return fast_forward(prep, x_u8)

        return forward

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
        # Balance-checked: every checkout is matched by a recycle —
        # fetch()'s finally on the normal path, dispatch()'s own error
        # path otherwise — and the sanitizer asserts the net is zero at
        # drain.
        resource_acquire("engine.staging")
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
        """Recycle a checkout. Called only from a finally: dispatch()'s
        error path and fetch()."""
        with self._staging_lock:
            # lint: allow[DML006] the recycle helper; both callers call it from a finally
            self._staging_pool[bucket].append(staging)
        resource_release("engine.staging")

    def staging_buffers(self) -> dict[int, int]:
        """Per-bucket free-list sizes."""
        with self._staging_lock:
            return {b: len(p) for b, p in self._staging_pool.items()}

    # -- inference ---------------------------------------------------------

    def _on_stream(self, shard: int = 0):
        """The context every launch of shard `shard` runs in: its own
        stream (and card) when it has one, else nothing to enter (its
        copies and kernels then run on the current stream of the card
        their tensors are on, whichever card is current)."""
        stream = self.streams[shard]
        if stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(stream)

    def _launch(self, x_dev: torch.Tensor, out: torch.Tensor,
                shard: int = 0):
        """Launch shard `shard`'s forward on `x_dev` and the copy of its
        logits into the host buffer `out` (the caller is inside
        _on_stream(shard)); returns the event that marks the copy done
        (None on the CPU, where both ran already)."""
        dev = self.devices[shard]
        logits = self._device_forwards[dev](x_dev)
        out.copy_(logits, non_blocking=True)
        if not self._pin:
            return None
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(dev))
        return done

    def _launch_split(self, x_host: torch.Tensor, out: torch.Tensor,
                      non_blocking: bool = True) -> tuple:
        """Split the host rows `x_host` into n_chips equal blocks and, for
        each, copy it to its shard's device, launch the forward there and
        copy the logits into the same block of `out`. Returns the shards'
        events. When a shard fails, the ones already launched are waited
        for before the error goes on, so that no copy still reads or
        writes a buffer the caller then recycles."""
        rows = x_host.shape[0] // self.n_chips
        events = []
        try:
            for i, dev in enumerate(self.devices):
                blk = slice(i * rows, (i + 1) * rows)
                with self._on_stream(i):
                    x_dev = x_host[blk].to(dev, non_blocking=non_blocking)
                    done = self._launch(x_dev, out[blk], i)
                if done is not None:
                    events.append(done)
        except BaseException:
            for done in events:
                done.synchronize()
            raise
        return tuple(events)

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
        # before the staging take: an injected error strands no buffer
        failpoint("engine.dispatch", version=self.version, rows=n,
                  bucket=b)
        sp = trace.begin_span("engine.staging", rows=n, bucket=b,
                              version=self.version)
        try:
            staging = self._staging_take(b)
            dispatched = False
            try:
                off = 0
                for p in parts:
                    staging.x_np[off:off + p.shape[0]] = p
                    off += p.shape[0]
                if n < b:
                    staging.x_np[n:] = 0
                with torch.inference_mode():
                    done = self._launch_split(staging.x, staging.out)
                dispatched = True
            finally:
                if not dispatched:
                    self._staging_put(b, staging)
        finally:
            trace.end_span(sp)
        return InferenceHandle(n=n, bucket=b, staging=staging, done=done,
                               version=self.version,
                               infer_dtype=self.infer_dtype)

    def _fast_out_take(self, bucket: int) -> torch.Tensor:
        with self._staging_lock:
            pool = self._fast_out_pool[bucket]
            if pool:
                return pool.pop()
        return torch.empty((bucket, NUM_CLASSES), dtype=torch.float32,
                           pin_memory=self._pin)

    def _fast_out_put(self, bucket: int, out: torch.Tensor) -> None:
        with self._staging_lock:
            self._fast_out_pool[bucket].append(out)

    def _launch_exact(self, x: np.ndarray, out: torch.Tensor) -> tuple:
        """Exact-fit route: the request's own rows, each shard's block
        copied to its device from pageable memory. That copy returns once
        it has run, after the work queued before it on the stream; a lane
        request waits for that work at its fetch anyway. Staging through
        a pinned tensor of torch's caching host allocator, and the pooled
        dispatch, time within a few percent of this copy at b = 1 on an
        H100 (chip_smoke.py times all three), so the route takes the
        simplest one. The array is copied first: an HTTP body is a
        read-only buffer."""
        return self._launch_split(torch.from_numpy(np.array(x)), out,
                                  non_blocking=False)

    def _row_host_take(self, x: np.ndarray) -> torch.Tensor:
        """A pinned one-row host buffer holding `x`, taken outside the
        lane lock. It is the request's own until its fetch recycles it,
        so no later row can overwrite it while its copy to the card is in
        flight."""
        with self._staging_lock:
            host = (self._fast_row_hosts.pop() if self._fast_row_hosts
                    else None)
        if host is None:
            host = torch.empty((1, *IMAGE_SHAPE), dtype=torch.uint8,
                               pin_memory=self._pin)
        host.numpy()[:] = x
        return host

    def _row_host_put(self, host: torch.Tensor) -> None:
        with self._staging_lock:
            self._fast_row_hosts.append(host)

    def _stage_row(self, host: torch.Tensor) -> torch.Tensor:
        """Row-staged route (the caller holds the fast-row lock): copy
        the pinned host row into row 0 of the resident device buffer (on
        the first device: shard 0's rows) and return the buffer. Nothing
        here waits for the card."""
        self._fast_row_buf[0:1].copy_(host, non_blocking=True)
        return self._fast_row_buf

    def _launch_row(self, host: torch.Tensor, out: torch.Tensor):
        """Stage `host` by the row route and launch shard 0 on the
        resident buffer, its logits into the first rows of `out` (the
        caller holds the fast-row lock and is inside _on_stream())."""
        buf = self._stage_row(host)
        return self._launch(buf, out[:buf.shape[0]])

    def dispatch_fast(self, x) -> Optional[InferenceHandle]:
        """The fast lane's dispatch: stage `x` by a resident route and
        launch, or return None so that the caller takes the ordinary
        dispatch() — when no route fits (n below its bucket and no warm
        row route) or the row buffer is busy. A route that fits and then
        fails raises; it never falls back quietly. Thread-safe: each call
        has its own output buffer and event."""
        x = self._as_images(x)
        n = x.shape[0]
        b = self.bucket_for(n)
        row_staged = (n == 1 and b == self._fast_row_b
                      and self._fast_row_ok
                      and self._fast_row_buf is not None)
        if n != b and not row_staged:
            return None
        failpoint("engine.dispatch", version=self.version, rows=n,
                  bucket=b)
        sp = trace.begin_span("engine.staging", rows=n, bucket=b,
                              version=self.version, resident=True)
        try:
            out = self._fast_out_take(b)
            host = None if n == b else self._row_host_take(x)
            dispatched = False
            try:
                with torch.inference_mode():
                    if host is None:
                        done = self._launch_exact(x, out)
                    else:
                        if not self._fast_row_lock.acquire(blocking=False):
                            return None   # busy: the pooled path serves
                        try:
                            with self._on_stream():
                                done = self._launch_row(host, out)
                        finally:
                            self._fast_row_lock.release()
                        done = () if done is None else (done,)
                dispatched = True
            finally:
                if not dispatched:
                    self._fast_out_put(b, out)
                    if host is not None:
                        self._row_host_put(host)
        finally:
            trace.end_span(sp)
        return InferenceHandle(n=n, bucket=b, staging=None, done=done,
                               version=self.version,
                               infer_dtype=self.infer_dtype,
                               resident=True, out=out, row_host=host)

    def fetch(self, handle: InferenceHandle) -> np.ndarray:
        """Wait for the batch (the device->host copy of its logits) and
        return its real rows. Recycles the handle's buffers whether the
        wait succeeds or raises; one-shot."""
        if handle.resident:
            out = handle.out
            if out is None:
                raise RuntimeError("handle already fetched")
            try:
                failpoint("engine.fetch", version=handle.version,
                          rows=handle.n)
                blocking("engine.fetch device->host sync")
                for done in handle.done:
                    done.synchronize()
                return out.numpy()[:handle.n].copy()
            finally:
                handle.out = None
                self._fast_out_put(handle.bucket, out)
                if handle.row_host is not None:
                    self._row_host_put(handle.row_host)
                    handle.row_host = None
        staging = handle.staging
        if staging is None:
            raise RuntimeError("handle already fetched")
        # The staging pair is recycled whether the wait succeeds or
        # raises: either way this batch's copies are over.
        try:
            failpoint("engine.fetch", version=handle.version,
                      rows=handle.n)
            # the host waits here for the card (on the CPU the batch is
            # already done): flagged if a hot-path lock is held
            blocking("engine.fetch device->host sync")
            for done in handle.done:
                done.synchronize()
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
        self._warm_fastlane(costs)
        # one reference swap: a concurrent reader sees a whole table
        self._bucket_cost = costs
        self._bucket_cost_p95 = costs_p95
        builds = kernel_lib.load_events() - before
        log.info("serve engine warm [%s on %s]: %d buckets %s (%d kernel "
                 "library loads); bucket cost ms %s", self.infer_dtype,
                 ", ".join(map(str, self.devices)), len(self.buckets),
                 list(self.buckets), builds,
                 {b: round(c * 1e3, 3)
                  for b, c in sorted(self._bucket_cost.items())})
        return builds

    def _warm_fastlane(self, costs: dict) -> None:
        """Allocate the row route's resident buffers, run it, and price
        it: it serves only when its median single-row cost is no worse
        than the covering bucket's pooled dispatch over the whole group
        (`costs`, this warmup's). A no-op for ladders whose smallest rung
        is 1. In a group the buffer is shard 0's rows of the rung."""
        b = self._fast_row_b
        if b is None:
            return
        if self._fast_row_buf is None:
            with self._on_stream():       # zeroed where it is read
                buf = torch.zeros((b // self.n_chips, *IMAGE_SHAPE),
                                  dtype=torch.uint8, device=self.device)
            with self._fast_row_lock:
                self._fast_row_buf = buf
        row = np.zeros((1, *IMAGE_SHAPE), np.uint8)
        out = self._fast_out_take(b)
        host = self._row_host_take(row)
        samples = []
        try:
            for i in range(4):
                t0 = time.perf_counter()
                with self._fast_row_lock:
                    with torch.inference_mode(), self._on_stream():
                        done = self._launch_row(host, out)
                if done is not None:
                    # outside the lane lock: warmup's own wait
                    blocking("engine.warmup device->host sync")
                    done.synchronize()
                if i:                     # the first call is not timed
                    samples.append(time.perf_counter() - t0)
        finally:
            self._fast_out_put(b, out)
            self._row_host_put(host)
        self._fast_row_cost = statistics.median(samples)
        self._fast_row_ok = (self._fast_row_cost
                             <= costs.get(b, float("inf")))
        if not self._fast_row_ok:
            log.info("fast lane: row-staged b%d route off on this host "
                     "(%.3f ms against pooled %.3f ms); exact fit and the "
                     "queue bypass still serve", b,
                     self._fast_row_cost * 1e3,
                     costs.get(b, float("nan")) * 1e3)

    def fast_row_cost(self) -> Optional[float]:
        """Median seconds of the row-staged route at warmup (None when
        the ladder has no row route or before warmup)."""
        return self._fast_row_cost

    def bucket_costs(self) -> dict[int, float]:
        """Median seconds per dispatch of each bucket (empty before
        warmup — the batch former then does not split)."""
        return self._bucket_cost

    def bucket_costs_p95(self) -> dict[int, float]:
        return self._bucket_cost_p95
