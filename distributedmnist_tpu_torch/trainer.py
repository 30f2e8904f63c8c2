"""Trainer — the port of distributedmnist_tpu/trainer.py: the training
step and the host-side fit loop, on one device or data-parallel over
ranks (parallel/: one process a device, joined by torch.distributed).

The JAX package compiles a block of K steps (forward, backward, update)
into one XLA program and dispatches it once. PyTorch runs eagerly, so
here a block is K steps launched back to back from Python, with one
host-to-device copy of the block's indices and one CUDA event recorded
after it. The batch is selected on the card from the device-resident
dataset by those indices and decoded (cast, /255) inside the step; no
pixels cross from the host in the loop, and no value comes back to it
except at log_every, at an eval or when the in-flight window is full.
A per-step `.item()` would make the host wait for the card every step.

The MLP's hidden layer goes through the hand-written dense_relu kernel
on the card (ops/fused.DenseReLU: the kernel forward, a plain-matmul
backward, as the JAX package's custom VJP), in every training step and
every eval batch, on every rank.

The JAX package's two SPMD modes, held against each other:

- "auto": the model wrapped in DistributedDataParallel, which all-reduces
  the gradients in the backward pass; the microbatches of an
  accumulated step but the last run under no_sync(), so the all-reduce
  happens once per optimizer step.
- "explicit": the bare model, and after backward (and accumulation) one
  hand-written all-reduce of the flattened gradients divided by the
  world size: the port of the JAX step's `lax.pmean(grads, 'data')`.

Each rank computes the loss of its columns of the global batch; a block's
losses are all-reduced once, so `loss`/`loss_mean` are the global means
the JAX package reports. An eval counts each rank's columns of every
eval batch and all-reduces the count once.

Tensor parallelism (model_parallel > 1, parallel/tp.py) folds the ranks
into JAX's ('data', 'model') layout. The batch, the eval batches and the
index stream are split over the data index only; each rank holds its
shard of the dense layers and of their optimizer state; DDP runs over
the data group (the ranks holding the same shard), and the model's own
collectives over the model group. A checkpoint holds the full
parameters and optimizer state (rank 0 gathers them over its model
group), so it is the same file as a data-parallel one, and restores at
any model_parallel. The dense_relu kernel stays on under TP: a rank runs
it on its whole local column shard (the JAX package turns its Pallas
kernel off there because that kernel takes unsharded operands).

`dtype` bfloat16 decodes the pixels straight to bfloat16 and computes
the models in it (models/). The streaming pipeline (data_pipeline
"stream", data/host_loader.py) gathers each rank's rows on the host and
copies them to the card a block at a time, in the device pipeline's
batch order. `profile_dir` makes rank 0 trace the training loop with
torch.profiler into a Chrome trace.

Spans (serve/trace.py's hooks; with no Tracer installed each is one
None check, a few a block and none a step), all on the training thread:

    fit                     fit's entry to its return (the root; tags
                            rank, world, steps)
    fit.setup.data          the dataset's upload (DeviceDataset)
    fit.setup.model         the model's build, its weights, the optimizer
    fit.setup.restore       the resume from a checkpoint
    fit.setup.wrap          run.start: DDP's wrap and its broadcast
    fit.setup.agree         the ranks' agreement on the SIGTERM handler
    train.loop              the loop over blocks
    train.steady            StepTimer's window: from the first block's
                            end (timer.start) to the loop's exit
    train.block             one block (tags step, k: its first step and
                            its steps), with its children
    train.block.wait        waiting for the oldest in-flight block when
                            max_inflight are queued
    train.block.launch      run_block(k) and the block's event: the
                            host's enqueue of k steps, which waits for
                            the card once CUDA's launch queue is full
    train.drain             finishing the in-flight blocks
    train.eval              an eval, its drain inside
    train.checkpoint        a periodic save's copy
    train.agree             the ranks' preemption agreement
    fit.close.sync          the window's closing wait for the card
    fit.close.save          the final save
    fit.close.commit        waiting for the save, then every rank

With `profile_dir` every rank also writes its spans as a Chrome trace,
spans-rank<r>-<pid>.json, shifted onto rank 0's profiler trace by one
mark recorded on both clocks.
"""

from __future__ import annotations

import contextlib
import json
import logging
import math
import os
import signal
import threading
import time
from collections import deque
from typing import Callable, Optional

import torch
import torch.distributed as dist
from torch.nn.parallel import DistributedDataParallel

from distributedmnist_tpu_torch import models, optim
from distributedmnist_tpu_torch.checkpoint import Checkpointer
from distributedmnist_tpu_torch.config import Config
from distributedmnist_tpu_torch.data import (DeviceDataset, IndexStream,
                                             eval_batches, load_mnist)
from distributedmnist_tpu_torch.data.packing import normalize, unpack_rows
from distributedmnist_tpu_torch.ops.loss import accuracy_count, cross_entropy
from distributedmnist_tpu_torch.parallel import (batch_shard, chip_count,
                                                 distributed, get_device)
from distributedmnist_tpu_torch.parallel import tp as tp_lib
from distributedmnist_tpu_torch.parallel.mesh import (Groups, make_mesh,
                                                      process_groups)
from distributedmnist_tpu_torch.serve import trace
from distributedmnist_tpu_torch.utils import (MetricsLogger, StepTimer,
                                              round_up)
from distributedmnist_tpu_torch.utils.device import (resolve_device,
                                                     training_numerics)

SPMD_MODES = ("auto", "explicit")
DATA_PIPELINES = ("device", "stream")
CLOCK_MARK = "trainer.clock"   # the profiler trace's mark of the span clock

log = logging.getLogger("distributedmnist_tpu_torch")


class SimulatedFailure(RuntimeError):
    """Raised by the fail_at_step fault-injection hook."""


@contextlib.contextmanager
def _span(name: str, **tags):
    """A span of the installed Tracer around the block (none without
    one)."""
    sp = trace.begin_span(name, **tags)
    try:
        yield
    finally:
        trace.end_span(sp)


def _decoder(pixel_format: str, dtype=torch.float32):
    """Raw gathered rows -> (B, 28, 28, 1) images in [0, 1] in `dtype`,
    decoded straight to it (bytes -> dtype, / 255 in dtype, as the JAX
    decode does): 'u8' rows are byte images, 'packed' rows (B, 196)
    int32 words."""
    if pixel_format == "u8":
        return lambda x: normalize(x, dtype)
    if pixel_format == "packed":
        return lambda words: unpack_rows(words, dtype)
    raise ValueError(f"unknown pixel format {pixel_format!r}")


def _make_update(model, optimizer, scheduler, decode, grad_accum: int,
                 reduce_grads: Optional[Callable]):
    """update(microbatches) -> the step's loss: one optimizer update on
    the mean of the microbatches' gradients, each an (x_raw, y) pair."""
    params = list(model.parameters())
    ddp = isinstance(model, DistributedDataParallel)

    def update(micro) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        loss = None
        for i, (x_raw, y) in enumerate(micro):
            with (model.no_sync() if ddp and i < grad_accum - 1
                  else contextlib.nullcontext()):
                part = cross_entropy(model(decode(x_raw)), y)
                part.backward()
            loss = part.detach() if loss is None else loss + part.detach()
        if grad_accum > 1:
            inv = 1.0 / grad_accum
            torch._foreach_mul_([p.grad for p in params], inv)
            loss = loss * inv
        if reduce_grads is not None:
            reduce_grads(params)
        optimizer.step()
        scheduler.step()
        return loss
    return update


def make_train_step(model, optimizer, scheduler, pixel_format: str = "u8",
                    grad_accum: int = 1,
                    reduce_grads: Optional[Callable] = None,
                    dtype=torch.float32):
    """step(train_x, train_y, idx) -> the step's loss (a detached tensor
    on the card): one optimizer update on the batch train_x[idx].

    With grad_accum > 1 the batch is cut into that many equal
    microbatches; their gradients are summed and scaled by 1/grad_accum,
    the mean of microbatch means, which is the full batch's gradient.

    Under data parallelism `idx` is the rank's columns of the global
    batch. A DistributedDataParallel `model` all-reduces the gradients in
    the last microbatch's backward (the others run under no_sync());
    `reduce_grads(params)`, when given, runs once after accumulation
    (spmd_mode explicit)."""
    update = _make_update(model, optimizer, scheduler,
                          _decoder(pixel_format, dtype), grad_accum,
                          reduce_grads)

    def step(train_x, train_y, idx):
        return update([(train_x[i], train_y[i])
                       for i in idx.reshape(grad_accum, -1)])
    return step


def make_train_step_from_batches(model, optimizer, scheduler,
                                 dtype=torch.float32):
    """The streaming pipeline's step (data/host_loader.HostStream):
    step(x_u8, y) -> the step's loss, one optimizer update on a batch
    already gathered and on the device; the same update as
    make_train_step's on the same rows."""
    update = _make_update(model, optimizer, scheduler,
                          _decoder("u8", dtype), 1, None)
    return lambda x, y: update([(x, y)])


def _wrap(model, spmd_mode: str, device, groups: Groups):
    """(the model the step runs, the gradient reduction it runs after
    backward) for this process. On a rank of a process group (of any
    size: NCCL at world size 1 still runs every collective), `auto` runs
    the model under DistributedDataParallel over the data group (the
    world without tensor parallelism; with it, the ranks holding the
    same shard, and none when that group is this rank alone) and
    `explicit` reduces the gradients with pmean_grads; outside a group,
    the bare model."""
    if not dist.is_initialized():
        return model, None
    if spmd_mode == "explicit":
        return model, pmean_grads
    if groups.mesh.model_parallel > 1 and groups.mesh.dp == 1:
        return model, None
    return DistributedDataParallel(
        model, device_ids=[device] if device.type == "cuda" else None,
        process_group=groups.data), None


def data_parallel_step(model, optimizer, scheduler, pixel_format: str,
                       grad_accum: int, spmd_mode: str, device,
                       dtype=torch.float32):
    """make_train_step for this process under data parallelism, its
    model wrapped by _wrap."""
    groups = Groups(make_mesh(distributed.process_count()),
                    distributed.process_index())
    model, reduce_grads = _wrap(model, spmd_mode, device, groups)
    return make_train_step(model, optimizer, scheduler, pixel_format,
                           grad_accum, reduce_grads, dtype)


def pmean_grads(params) -> None:
    """The gradients' mean over the ranks, in place: one all_reduce(SUM)
    of all of them flattened into one buffer, divided by the world size
    (the JAX step's `lax.pmean(grads, 'data')`)."""
    grads = [p.grad for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    flat /= dist.get_world_size()
    torch._foreach_copy_(grads, [part.view_as(g) for part, g in zip(
        flat.split([g.numel() for g in grads]), grads)])


def make_eval_fn(model, dtype=torch.float32):
    """evaluate(test_x, test_y, idx_mat, mask_mat) -> the int32 count of
    correct predictions over the masked index batches, on the card.
    Under data parallelism the batches are the rank's columns, and the
    caller sums the counts over the ranks."""
    def evaluate(test_x, test_y, idx_mat, mask_mat):
        correct = torch.zeros((), dtype=torch.int32, device=test_x.device)
        with torch.no_grad():
            for idx, mask in zip(idx_mat, mask_mat):
                logits = model(normalize(test_x[idx], dtype))
                correct += accuracy_count(logits, test_y[idx], mask)
        return correct
    return evaluate


def _pick_steps_per_call(cfg: Config, device_type: str,
                         has_ckpt: bool, streaming: bool = False) -> int:
    """Steps per block. Auto: 1 on the CPU; on the card the largest
    k <= 1024 dividing the eval/checkpoint/fail-at cadence, so that block
    edges land exactly on eval, checkpoint and fail-at steps. The
    streaming pipeline keeps JAX's ceiling of 256: each of its blocks
    holds k whole batches on the card, up to max_inflight of them."""
    if cfg.steps_per_call is not None:
        return max(1, cfg.steps_per_call)
    if device_type == "cpu":
        return 1
    cadence = cfg.eval_every
    if has_ckpt:
        cadence = math.gcd(cadence, cfg.checkpoint_every)
    if cfg.fail_at_step:
        cadence = math.gcd(cadence, cfg.fail_at_step)
    for k in range(min(256 if streaming else 1024, cadence), 0, -1):
        if cadence % k == 0:
            return k
    return 1


def fit(cfg: Config, data: Optional[dict] = None, *,
        log: Optional[MetricsLogger] = None,
        init_params: Optional[dict] = None) -> dict:
    """Run one training workload end to end; returns the summary dict (the
    JAX trainer's keys), whose JSON form the CLI prints. `log` receives
    the step and eval records (a fresh MetricsLogger by default);
    `init_params` (a state_dict) replaces the seed's fresh init.

    With the coordinator flags, or in a rank started by a launcher, this
    process first joins the process group (parallel/distributed.py) and
    trains on its device as one rank. num_devices > 1 without a process
    group raises ValueError: the run never quietly trains on one rank.

    With a checkpoint_dir and graceful_preemption (the default), a
    SIGTERM during training stops the run at the next block boundary and
    force-saves a resumable checkpoint; the absorbed signal is reported
    as summary["preempted"], not re-delivered. Under data parallelism
    the ranks agree at eval and checkpoint boundaries, so all of them
    stop at the same step. Float32 runs with TF32 off, and cuDNN on its
    deterministic algorithms, so that a run at a seed repeats itself bit
    for bit on the card (utils/device.training_numerics).

    With a Tracer installed (serve/trace.py) fit records the spans the
    module's docstring lists; with `profile_dir` and none installed it
    installs one of its own for the call."""
    own = (trace.install(trace.Tracer()) if cfg.profile_dir
           and trace.active() is None else None)
    clock: dict = {}     # rank 0's profiler clock, filled by _profiler
    root = trace.begin_span("fit")
    tags: dict = {}
    try:
        device_type = resolve_device(cfg.device).type
        multihost = distributed.maybe_initialize(
            cfg.coordinator_address, cfg.num_processes, cfg.process_id,
            device_type)
        device = get_device(cfg.device, cfg.num_devices)
        tags.update(rank=distributed.process_index(),
                    world=distributed.process_count())
        with training_numerics():
            summary = _fit(cfg, data, device, multihost,
                           log if log is not None else MetricsLogger(),
                           init_params, clock)
        tags["steps"] = summary["steps"]
    finally:
        trace.end_span(root, **tags)
        if own is not None:
            trace.uninstall()
    if cfg.profile_dir:
        _write_spans(cfg.profile_dir, root, distributed.broadcast_object(
            clock.get("shift_us"), device))
    return summary


def _write_spans(profile_dir: str, root, shift_us: Optional[float]) -> None:
    """This rank's spans of one fit (`root`'s and those begun after it)
    as a Chrome trace beside the profiler's, pid the rank, shifted by
    rank 0's `shift_us` onto its profiler trace's clock. Ranks share
    that shift as they share a host's monotonic clock."""
    rank = distributed.process_index()
    path = os.path.join(profile_dir, f"spans-rank{rank}-{os.getpid()}.json")
    with open(path, "w") as f:
        json.dump(root.tracer.export_run_chrome(
            pid=rank, process_name=f"distributedmnist-train rank {rank}",
            since=root.id, shift_us=shift_us or 0.0), f)
    log.info("profile: spans written to %s", path)


def validate(cfg: Config, world: int) -> None:
    """The JAX trainer's checks of a configuration against `world` ranks,
    with its messages."""
    mp = cfg.model_parallel
    if mp < 1:
        raise ValueError(f"model_parallel must be >= 1, got {mp}")
    if mp > 1 and cfg.spmd_mode == "explicit":
        raise ValueError("model_parallel > 1 requires spmd_mode=auto "
                         "(the explicit shard_map path is DP-only)")
    if world % mp:
        raise ValueError(
            f"{world} chips not divisible by model_parallel={mp}")
    dp = world // mp
    if cfg.batch_size % dp:
        raise ValueError(
            f"global batch {cfg.batch_size} not divisible by "
            f"{dp} data-parallel chips")
    ga = cfg.grad_accum
    if ga < 1:
        raise ValueError(f"grad_accum must be >= 1, got {ga}")
    if ga > 1 and cfg.batch_size % (dp * ga):
        raise ValueError(
            f"global batch {cfg.batch_size} not divisible by "
            f"{dp} chips x {ga} grad-accum microbatches")
    if cfg.data_pipeline not in DATA_PIPELINES:
        raise ValueError(f"unknown data pipeline {cfg.data_pipeline!r}")
    streaming = cfg.data_pipeline == "stream"
    if streaming and cfg.spmd_mode == "explicit":
        raise ValueError("data_pipeline=stream requires spmd_mode=auto")
    if streaming and ga > 1:
        raise ValueError("grad_accum > 1 requires the device-resident "
                         "pipeline (microbatches re-gather from the "
                         "replicated dataset; pre-gathered streamed "
                         "batches would reshard on every split)")
    if cfg.dtype not in models.DTYPES:
        raise ValueError(f"unknown dtype {cfg.dtype!r} "
                         "(expected float32|bfloat16)")
    if cfg.lr_decay_steps is not None and cfg.lr_decay_steps < 1:
        raise ValueError(
            f"lr_decay_steps must be >= 1, got {cfg.lr_decay_steps} "
            "(omit it to decay over the run's own length)")
    if cfg.eval_only and not (cfg.checkpoint_dir and cfg.resume):
        raise ValueError(
            "--eval-only needs a restorable checkpoint "
            "(--checkpoint-dir with an existing checkpoint and "
            "resume enabled)")
    if cfg.spmd_mode not in SPMD_MODES:
        raise ValueError(f"unknown spmd mode {cfg.spmd_mode!r}")


class _Shards:
    """Moves state between the full tensors a checkpoint and an init hold
    and this rank's shards of them (every tensor itself without tensor
    parallelism)."""

    def __init__(self, model, name: str, tp: Optional[tp_lib.TPContext]):
        self.model, self.tp = model, tp
        self.names = [n for n, _ in model.named_parameters()]
        self.full = models.full_shapes(name)

    def load_params(self, full: dict) -> None:
        if self.tp is not None:
            full = {k: self.tp.shard(k, v) for k, v in full.items()}
        self.model.load_state_dict(full)

    def _optim_map(self, state: dict, fn) -> dict:
        """The optimizer state_dict with fn(name, tensor) applied to each
        per-parameter state tensor (moments, momentum buffers)."""
        out = dict(state)
        out["state"] = {i: {k: fn(self.names[i], v)
                            if isinstance(v, torch.Tensor) else v
                            for k, v in per.items()}
                        for i, per in state["state"].items()}
        return out

    def load_optimizer(self, optimizer, full: dict) -> None:
        if self.tp is not None:
            full = self._optim_map(full, self.tp.shard)
        optimizer.load_state_dict(full)

    def gathered(self, optimizer) -> tuple[dict, dict]:
        """(full params, full optimizer state) on every rank of the model
        group: a collective of the group."""
        params = self.model.state_dict()
        opt = optimizer.state_dict()
        if self.tp is None:
            return params, opt
        return ({k: self.tp.gather(k, v, self.full[k])
                 for k, v in params.items()},
                self._optim_map(opt, lambda n, v: self.tp.gather(
                    n, v, self.full[n])))


def _fit(cfg: Config, data: Optional[dict], device: torch.device,
         multihost: bool, mlog: MetricsLogger,
         init_params: Optional[dict], clock: dict) -> dict:
    world = distributed.process_count()
    validate(cfg, world)
    mesh = make_mesh(world, cfg.model_parallel)
    groups = (process_groups(mesh, distributed.process_index())
              if dist.is_initialized() else Groups(mesh, 0))
    tp = None
    if mesh.model_parallel > 1:
        tp = tp_lib.TPContext(
            groups.model, mesh.model_parallel, groups.model_index,
            tp_lib.placements(models.full_shapes(cfg.model), cfg.model,
                              mesh.model_parallel))
    streaming = cfg.data_pipeline == "stream"
    with _span("fit.setup.data"):
        data = data if data is not None else load_mnist(
            cfg.data_dir, cfg.synthetic, cfg.seed)
        # streamed batches arrive as bytes: the packed layout exists only
        # on the card
        pixel_format = "u8" if streaming else cfg.pixel_format
        ds = DeviceDataset(data, device,
                           device_resident_train=not (cfg.eval_only
                                                      or streaming),
                           pixel_format=pixel_format)
    with _span("fit.setup.model"):
        model = models.build(cfg.model, dtype=cfg.dtype,
                             fused=cfg.fused_kernels, conv=cfg.conv_impl,
                             device=device, tp=tp)
        shards = _Shards(model, cfg.model, tp)
        shards.load_params(init_params if init_params is not None
                           else models.init_params(cfg.model, cfg.seed))
        steps_per_epoch = ds.train_n // cfg.batch_size
        total_steps = cfg.steps if cfg.steps is not None \
            else cfg.epochs * steps_per_epoch
        schedule = optim.make_schedule(
            cfg.learning_rate, cfg.lr_schedule, cfg.warmup_steps,
            total_steps if cfg.lr_decay_steps is None
            else cfg.lr_decay_steps)
        optimizer, scheduler = optim.build(cfg.optimizer, model.parameters(),
                                           schedule, cfg.momentum,
                                           flat=cfg.flat_optimizer)

    ckpt = Checkpointer(cfg.checkpoint_dir) if cfg.checkpoint_dir else None
    try:
        restored = False
        start_step = 0
        if ckpt and cfg.resume:
            with _span("fit.setup.restore"):
                state = ckpt.maybe_restore(device)
                if state is not None:
                    shards.load_params(state["params"])
                    shards.load_optimizer(optimizer, state["optimizer"])
                    scheduler.load_state_dict(state["scheduler"])
                    start_step = int(state["step"])
                    restored = True
                    log.info("restored checkpoint at step %d", start_step)
        if cfg.eval_only:
            if not restored:
                raise ValueError(
                    "--eval-only: no checkpoint found to restore in "
                    f"{cfg.checkpoint_dir!r}")
            # the loop below does nothing; the closing eval gives the
            # accuracy
            total_steps = start_step
        run = _Run(cfg, data, ds, model, shards, optimizer, scheduler, ckpt,
                   device, groups, streaming)
        try:
            return _train(run, start_step, total_steps, restored, multihost,
                          mlog, clock)
        finally:
            run.close()
    finally:
        if ckpt:
            ckpt.close()


class _Run:
    """What one run's loop needs: its data feed (the device-resident
    index stream or the host stream) and its step, built for this rank."""

    def __init__(self, cfg, data, ds, model, shards, optimizer, scheduler,
                 ckpt, device, groups: Groups, streaming: bool):
        self.cfg, self.ds, self.model, self.shards = cfg, ds, model, shards
        self.optimizer, self.scheduler, self.ckpt = optimizer, scheduler, ckpt
        self.device, self.groups, self.streaming = device, groups, streaming
        self.dtype = models.DTYPES[cfg.dtype]
        self.host_stream = None
        self.data = data

    def start(self, start_step: int):
        """run_block(k) -> the block's losses (a tensor on the device),
        one per step, this rank's."""
        cfg, ds, g = self.cfg, self.ds, self.groups
        net, reduce_grads = _wrap(self.model, cfg.spmd_mode, self.device, g)
        if self.streaming:
            from distributedmnist_tpu_torch.data.host_loader import \
                HostStream
            self.host_stream = HostStream(
                self.data["train_x"], self.data["train_y"], cfg.batch_size,
                cfg.seed, self.device, start_step=start_step,
                source=cfg.stream_source, rank=g.data_index,
                world=g.mesh.dp)
            step = make_train_step_from_batches(net, self.optimizer,
                                                self.scheduler, self.dtype)

            def run_block(k: int) -> torch.Tensor:
                xs, ys = self.host_stream.next_block(k)
                return torch.stack([step(xs[i], ys[i]) for i in range(k)])
            return run_block
        stream = IndexStream(ds.train_n, cfg.batch_size, cfg.seed,
                             start_step=start_step)
        step = make_train_step(net, self.optimizer, self.scheduler,
                               ds.pixel_format, cfg.grad_accum, reduce_grads,
                               self.dtype)

        def run_block(k: int) -> torch.Tensor:
            idx_block = stream.next_block(k, self.device, g.data_index,
                                          g.mesh.dp)
            return torch.stack([step(ds.train_x, ds.train_y, idx_block[i])
                                for i in range(k)])
        return run_block

    def close(self) -> None:
        if self.host_stream is not None:
            self.host_stream.close()


def _profiler(profile_dir: Optional[str], device: torch.device,
              clock: dict):
    """Rank 0's torch.profiler over the training loop (CPU and, on the
    card, CUDA activities), exporting a Chrome trace into profile_dir at
    its exit: the port of the JAX trainer's jax.profiler.start_trace on
    process 0. A null context elsewhere. At its start it records one
    mark, CLOCK_MARK, at a time.monotonic() it keeps; read back from
    the trace, the two give clock["shift_us"], which moves a span's
    monotonic microseconds onto the trace's clock."""
    if not profile_dir or distributed.process_index() != 0:
        return contextlib.nullcontext()
    from torch.autograd.profiler import record_function
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(profile_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    path = os.path.join(profile_dir, f"trace-rank0-{os.getpid()}.json")

    @contextlib.contextmanager
    def tracing():
        with profile(activities=activities) as prof:
            t_mark = time.monotonic()
            with record_function(CLOCK_MARK):
                pass
            yield
        prof.export_chrome_trace(path)
        with open(path) as f:
            marks = [e["ts"] for e in json.load(f)["traceEvents"]
                     if e.get("name") == CLOCK_MARK and "ts" in e]
        if marks:
            clock["shift_us"] = marks[0] - t_mark * 1e6
        log.info("profile: trace written to %s", path)
    return tracing()


def _train(run: _Run, start_step, total_steps, restored, multihost,
           mlog, clock: dict) -> dict:
    cfg, ds, model, ckpt = run.cfg, run.ds, run.model, run.ckpt
    device, groups = run.device, run.groups
    grouped = dist.is_initialized()
    world = distributed.process_count()
    with _span("fit.setup.wrap"):
        step_fn = run.start(start_step)

    def run_block(k: int) -> dict:
        losses = step_fn(k)
        if grouped:
            # one collective a block: the global mean of each step's loss
            dist.all_reduce(losses)
            losses /= world
        return {"loss": losses[-1], "loss_mean": losses.mean()}

    def train_state() -> dict:
        # the bare model's full state_dict (no DDP "module." prefix, a
        # tensor-parallel model's shards gathered): a data- or
        # tensor-parallel checkpoint is one that serving boots from
        params, opt = run.shards.gathered(run.optimizer)
        return {"params": params, "optimizer": opt,
                "scheduler": run.scheduler.state_dict()}

    def commit() -> None:
        """Wait for rank 0's writes; then every rank leaves together."""
        ckpt.wait()
        distributed.agree_max(0, device)

    eval_fn = make_eval_fn(model, run.dtype)
    dp = groups.mesh.dp
    eb = round_up(min(2048, ds.test_n), dp)
    idx_mat, mask_mat = eval_batches(ds.test_n, eb)
    cols = batch_shard(eb, groups.data_index, dp)
    idx_mat = torch.from_numpy(idx_mat[:, cols]).to(device).long()
    mask_mat = torch.from_numpy(mask_mat[:, cols]).to(device)

    # Blocks launched but not known to be finished: one CUDA event each
    # (None on the CPU, where every op has finished when it returns).
    inflight: deque = deque()
    if cfg.max_inflight is not None:
        max_inflight = cfg.max_inflight
    else:
        max_inflight = 1 if device.type == "cpu" else 16

    def block_done():
        if device.type != "cuda":
            return None
        event = torch.cuda.Event()
        event.record()
        return event

    def drain_inflight() -> None:
        """Finish, on the counted clock, every launched block before an
        excluded span (eval, checkpoint copy): launches run in order, so
        the span would otherwise wait out the queued blocks and move
        their training time into `excluded`. The newest block's event
        covers all of them."""
        if inflight:
            with _span("train.drain"):
                StepTimer.barrier(inflight[-1])
                inflight.clear()

    n_evals = [0]

    def evaluate() -> float:
        with _span("train.eval"):
            drain_inflight()
            n_evals[0] += 1
            with timer.exclude():
                correct = eval_fn(ds.test_x, ds.test_y, idx_mat, mask_mat)
                if grouped:
                    # once over the data group: each model rank holds the
                    # same count of its data share
                    dist.all_reduce(correct, group=groups.data)
                return int(correct) / ds.test_n

    # ranks sharing a card count it once: per-chip rates are per card
    n_chips = chip_count(device)
    timer = StepTimer(cfg.batch_size, n_chips)
    t_start = time.perf_counter()
    accuracy = 0.0
    metrics = None
    reached_target_at: Optional[float] = None
    spc = _pick_steps_per_call(cfg, device.type, bool(ckpt),
                               streaming=run.streaming)

    def crossed(step_before: int, step_after: int, every: int) -> bool:
        return step_after // every > step_before // every

    # Graceful preemption: a SIGTERM (the warning a scheduler sends
    # before it kills a worker) stops training at the next block boundary
    # and force-saves a checkpoint at that step. Only with a checkpointer
    # to save with, on the main thread (signal.signal is main-thread
    # only), and when there is training left to stop: otherwise absorbing
    # SIGTERM would only make the process immune to it.
    #
    # With ranks, one must never stop on its own signal: the others would
    # wait for it in the next collective. The local flags are agreed
    # (agree_max) at every eval and checkpoint boundary, steps every rank
    # reaches, and all stop iff any was signalled. The agreement is a
    # collective too, so the ranks first agree, once, that every one of
    # them can install the handler; before any is installed, so a failed
    # exchange leaves no handler behind.
    preempt_signum = [None]
    preempt_agreed = [False]
    install = (ckpt is not None and cfg.graceful_preemption
               and start_step < total_steps
               and threading.current_thread() is threading.main_thread())
    if grouped:
        with _span("fit.setup.agree"):
            all_capable = distributed.agree_max(0 if install else 1,
                                                device) == 0
        if install and not all_capable:
            log.warning("graceful preemption disabled: not every rank can "
                        "install the SIGTERM handler")
        install = install and all_capable
    sigterm_installed = install
    if sigterm_installed:
        def _on_sigterm(signum, frame):
            preempt_signum[0] = signum
        prev_sigterm = signal.signal(signal.SIGTERM, _on_sigterm)

    def stop_requested() -> bool:
        if not sigterm_installed:
            return False
        if not grouped:
            return preempt_signum[0] is not None
        return preempt_agreed[0]

    step = start_step
    first_call = True
    steady_t0 = None      # monotonic end of the first block: train.steady
    profiler = _profiler(cfg.profile_dir, device, clock)
    try:
        with profiler, _span("train.loop"):
            while step < total_steps:
                if stop_requested():
                    log.info("SIGTERM: stopping at step %d to checkpoint",
                             step)
                    break
                k = min(spc, total_steps - step)
                with _span("train.block", step=step, k=k):
                    # wait BEFORE launching, so that at most max_inflight
                    # blocks are ever queued on the card
                    with _span("train.block.wait"):
                        while len(inflight) >= max_inflight:
                            StepTimer.barrier(inflight.popleft())
                    with _span("train.block.launch"):
                        metrics = run_block(k)
                        inflight.append(block_done())
                    prev, step = step, step + k
                    if first_call:
                        # the first block: warm-up
                        timer.start(sync=inflight[-1])
                        steady_t0 = time.monotonic()
                        first_call = False
                    else:
                        timer.lap(k)
                    if cfg.log_every and crossed(prev, step, cfg.log_every):
                        mlog.step(step, metrics)

                    if (sigterm_installed and grouped
                            and (crossed(prev, step, cfg.checkpoint_every)
                                 or crossed(prev, step, cfg.eval_every))):
                        drain_inflight()
                        with _span("train.agree"), timer.exclude():
                            preempt_agreed[0] = distributed.agree_max(
                                0 if preempt_signum[0] is None else 1,
                                device) == 1

                    if ckpt and crossed(prev, step, cfg.checkpoint_every):
                        # the save's copy to the host waits for the queued
                        # blocks: finish them on the counted clock, exclude
                        # only the copy (the write overlaps training)
                        drain_inflight()
                        with _span("train.checkpoint"), timer.exclude():
                            ckpt.save(step, train_state())

                    if (cfg.fail_at_step is not None
                            and step >= cfg.fail_at_step):
                        if ckpt:
                            commit()
                        raise SimulatedFailure(
                            f"injected failure at step {step}")

                    if (crossed(prev, step, cfg.eval_every)
                            or step == total_steps):
                        accuracy = evaluate()
                        mlog.eval(step, accuracy)
                        if (cfg.target_accuracy is not None
                                and accuracy >= cfg.target_accuracy):
                            reached_target_at = (time.perf_counter()
                                                 - t_start)
                            log.info("target accuracy %.3f reached at "
                                     "step %d (%.2fs)", cfg.target_accuracy,
                                     step, reached_target_at)
                            break
            if steady_t0 is not None:
                trace.add_span("train.steady", steady_t0, time.monotonic())

        # On preemption skip the closing eval (a collective: every rank
        # skips it, each term below being deterministic or agreed): the
        # grace period before SIGKILL is for the save. A run that
        # completed (or reached its target) finished its job, even if a
        # signal landed in its last block.
        preempted = (stop_requested() and step < total_steps
                     and reached_target_at is None)
        if accuracy == 0.0 and not preempted:
            accuracy = evaluate()
        with _span("fit.close.sync"):
            throughput = timer.snapshot(sync=inflight[-1] if inflight
                                        else None)
        wall = time.perf_counter() - t_start
        if ckpt:
            with _span("fit.close.save"):
                ckpt.save(step, train_state())
            with _span("fit.close.commit"):
                commit()
    finally:
        # restored only after the force-save: a second SIGTERM during the
        # save is absorbed, not a kill mid-write
        if sigterm_installed:
            signal.signal(signal.SIGTERM,
                          prev_sigterm if prev_sigterm is not None
                          else signal.SIG_DFL)

    summary = {
        "model": cfg.model,
        "optimizer": cfg.optimizer,
        "spmd_mode": cfg.spmd_mode,
        "n_chips": n_chips,
        "model_parallel": groups.mesh.model_parallel,
        "n_processes": world,
        "multihost": multihost,
        "global_batch": cfg.batch_size,
        "data": ds.source,
        "data_pipeline": cfg.data_pipeline,
        "pixel_format": ds.pixel_format,
        "steps": step,
        "n_evals": n_evals[0],
        "restored": restored,
        "preempted": preempted,
        "test_accuracy": accuracy,
        "final_loss": None if metrics is None else float(metrics["loss"]),
        "target_accuracy": cfg.target_accuracy,
        "wall_clock_s": wall,
        "wall_clock_to_target_s": reached_target_at,
        **throughput,
    }
    log.info("summary %s", MetricsLogger.summary_line(summary))
    return summary
