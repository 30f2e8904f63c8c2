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
"""

from __future__ import annotations

import contextlib
import logging
import math
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
from distributedmnist_tpu_torch.utils import (MetricsLogger, StepTimer,
                                              round_up)
from distributedmnist_tpu_torch.utils.device import (float32_numerics,
                                                     resolve_device)

SPMD_MODES = ("auto", "explicit")

log = logging.getLogger("distributedmnist_tpu_torch")


class SimulatedFailure(RuntimeError):
    """Raised by the fail_at_step fault-injection hook."""


def _decoder(pixel_format: str):
    """Raw gathered rows -> float32 (B, 28, 28, 1) images in [0, 1]: 'u8'
    rows are byte images, 'packed' rows (B, 196) int32 words."""
    if pixel_format == "u8":
        return normalize
    if pixel_format == "packed":
        return unpack_rows
    raise ValueError(f"unknown pixel format {pixel_format!r}")


def make_train_step(model, optimizer, scheduler, pixel_format: str = "u8",
                    grad_accum: int = 1,
                    reduce_grads: Optional[Callable] = None):
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
    decode = _decoder(pixel_format)
    params = list(model.parameters())
    ddp = isinstance(model, DistributedDataParallel)

    def loss_fn(x_raw, y):
        return cross_entropy(model(decode(x_raw)), y)

    def step(train_x, train_y, idx):
        optimizer.zero_grad(set_to_none=True)
        loss = None
        for i, idx_m in enumerate(idx.reshape(grad_accum, -1)):
            with (model.no_sync() if ddp and i < grad_accum - 1
                  else contextlib.nullcontext()):
                part = loss_fn(train_x[idx_m], train_y[idx_m])
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
    return step


def data_parallel_step(model, optimizer, scheduler, pixel_format: str,
                       grad_accum: int, spmd_mode: str, device):
    """make_train_step for this process. On a rank of a process group (of
    any size: NCCL at world size 1 still runs every collective), `auto`
    runs the model under DistributedDataParallel and `explicit` reduces
    the gradients with pmean_grads; outside a group, the plain step."""
    grouped = dist.is_initialized()
    if grouped and spmd_mode == "auto":
        model = DistributedDataParallel(
            model, device_ids=[device] if device.type == "cuda" else None)
    return make_train_step(
        model, optimizer, scheduler, pixel_format, grad_accum,
        pmean_grads if grouped and spmd_mode == "explicit" else None)


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


def make_eval_fn(model):
    """evaluate(test_x, test_y, idx_mat, mask_mat) -> the int32 count of
    correct predictions over the masked index batches, on the card.
    Under data parallelism the batches are the rank's columns, and the
    caller sums the counts over the ranks."""
    def evaluate(test_x, test_y, idx_mat, mask_mat):
        correct = torch.zeros((), dtype=torch.int32, device=test_x.device)
        with torch.no_grad():
            for idx, mask in zip(idx_mat, mask_mat):
                logits = model(normalize(test_x[idx]))
                correct += accuracy_count(logits, test_y[idx], mask)
        return correct
    return evaluate


def _pick_steps_per_call(cfg: Config, device_type: str,
                         has_ckpt: bool) -> int:
    """Steps per block. Auto: 1 on the CPU; on the card the largest
    k <= 1024 dividing the eval/checkpoint/fail-at cadence, so that block
    edges land exactly on eval, checkpoint and fail-at steps."""
    if cfg.steps_per_call is not None:
        return max(1, cfg.steps_per_call)
    if device_type == "cpu":
        return 1
    cadence = cfg.eval_every
    if has_ckpt:
        cadence = math.gcd(cadence, cfg.checkpoint_every)
    if cfg.fail_at_step:
        cadence = math.gcd(cadence, cfg.fail_at_step)
    for k in range(min(1024, cadence), 0, -1):
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
    stop at the same step. Float32 runs with TF32 off
    (utils/device.float32_numerics)."""
    device_type = resolve_device(cfg.device).type
    multihost = distributed.maybe_initialize(
        cfg.coordinator_address, cfg.num_processes, cfg.process_id,
        device_type)
    device = get_device(cfg.device, cfg.num_devices)
    with float32_numerics():
        return _fit(cfg, data, device, multihost,
                    log if log is not None else MetricsLogger(), init_params)


def validate(cfg: Config, world: int) -> None:
    """The JAX trainer's checks of a configuration against `world`
    data-parallel ranks, with its messages."""
    if cfg.batch_size % world:
        raise ValueError(
            f"global batch {cfg.batch_size} not divisible by "
            f"{world} data-parallel chips")
    ga = cfg.grad_accum
    if ga < 1:
        raise ValueError(f"grad_accum must be >= 1, got {ga}")
    if ga > 1 and cfg.batch_size % (world * ga):
        raise ValueError(
            f"global batch {cfg.batch_size} not divisible by "
            f"{world} chips x {ga} grad-accum microbatches")
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


def _fit(cfg: Config, data: Optional[dict], device: torch.device,
         multihost: bool, mlog: MetricsLogger,
         init_params: Optional[dict]) -> dict:
    world = distributed.process_count()
    validate(cfg, world)
    data = data if data is not None else load_mnist(
        cfg.data_dir, cfg.synthetic, cfg.seed)
    ds = DeviceDataset(data, device, device_resident_train=not cfg.eval_only,
                       pixel_format=cfg.pixel_format)
    model = models.build(cfg.model, device=device)
    model.load_state_dict(init_params if init_params is not None
                          else models.init_params(cfg.model, cfg.seed))
    steps_per_epoch = ds.train_n // cfg.batch_size
    total_steps = cfg.steps if cfg.steps is not None \
        else cfg.epochs * steps_per_epoch
    schedule = optim.make_schedule(
        cfg.learning_rate, cfg.lr_schedule, cfg.warmup_steps,
        total_steps if cfg.lr_decay_steps is None else cfg.lr_decay_steps)
    optimizer, scheduler = optim.build(cfg.optimizer, model.parameters(),
                                       schedule, cfg.momentum)

    ckpt = Checkpointer(cfg.checkpoint_dir) if cfg.checkpoint_dir else None
    try:
        restored = False
        start_step = 0
        if ckpt and cfg.resume:
            state = ckpt.maybe_restore(device)
            if state is not None:
                model.load_state_dict(state["params"])
                optimizer.load_state_dict(state["optimizer"])
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
        return _train(cfg, ds, model, optimizer, scheduler, ckpt, device,
                      start_step, total_steps, restored, multihost, mlog)
    finally:
        if ckpt:
            ckpt.close()


def _train(cfg, ds, model, optimizer, scheduler, ckpt, device, start_step,
           total_steps, restored, multihost, mlog) -> dict:
    grouped = dist.is_initialized()
    world = distributed.process_count()
    rank = distributed.process_index()
    stream = IndexStream(ds.train_n, cfg.batch_size, cfg.seed,
                         start_step=start_step)
    step_fn = data_parallel_step(model, optimizer, scheduler,
                                 ds.pixel_format, cfg.grad_accum,
                                 cfg.spmd_mode, device)

    def run_block(k: int) -> dict:
        idx_block = stream.next_block(k, device, rank, world)
        losses = torch.stack([step_fn(ds.train_x, ds.train_y, idx_block[i])
                              for i in range(k)])
        if grouped:
            # one collective a block: the global mean of each step's loss
            dist.all_reduce(losses)
            losses /= world
        return {"loss": losses[-1], "loss_mean": losses.mean()}

    def train_state() -> dict:
        # the bare model's state_dict (no DDP "module." prefix): a
        # data-parallel checkpoint is one that serving boots from
        return {"params": model.state_dict(),
                "optimizer": optimizer.state_dict(),
                "scheduler": scheduler.state_dict()}

    def commit() -> None:
        """Wait for rank 0's writes; then every rank leaves together."""
        ckpt.wait()
        distributed.agree_max(0, device)

    eval_fn = make_eval_fn(model)
    eb = round_up(min(2048, ds.test_n), world)
    idx_mat, mask_mat = eval_batches(ds.test_n, eb)
    cols = batch_shard(eb, rank, world)
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
            StepTimer.barrier(inflight[-1])
            inflight.clear()

    n_evals = [0]

    def evaluate() -> float:
        drain_inflight()
        n_evals[0] += 1
        with timer.exclude():
            correct = eval_fn(ds.test_x, ds.test_y, idx_mat, mask_mat)
            if grouped:
                dist.all_reduce(correct)
            return int(correct) / ds.test_n

    # ranks sharing a card count it once: per-chip rates are per card
    n_chips = chip_count(device)
    timer = StepTimer(cfg.batch_size, n_chips)
    t_start = time.perf_counter()
    accuracy = 0.0
    metrics = None
    reached_target_at: Optional[float] = None
    spc = _pick_steps_per_call(cfg, device.type, bool(ckpt))

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
    try:
        while step < total_steps:
            if stop_requested():
                log.info("SIGTERM: stopping at step %d to checkpoint", step)
                break
            k = min(spc, total_steps - step)
            # wait BEFORE launching, so that at most max_inflight blocks
            # are ever queued on the card
            while len(inflight) >= max_inflight:
                StepTimer.barrier(inflight.popleft())
            metrics = run_block(k)
            inflight.append(block_done())
            prev, step = step, step + k
            if first_call:
                timer.start(sync=inflight[-1])  # the first block: warm-up
                first_call = False
            else:
                timer.lap(k)
            if cfg.log_every and crossed(prev, step, cfg.log_every):
                mlog.step(step, metrics)

            if (sigterm_installed and grouped
                    and (crossed(prev, step, cfg.checkpoint_every)
                         or crossed(prev, step, cfg.eval_every))):
                drain_inflight()
                with timer.exclude():
                    preempt_agreed[0] = distributed.agree_max(
                        0 if preempt_signum[0] is None else 1, device) == 1

            if ckpt and crossed(prev, step, cfg.checkpoint_every):
                # the save's copy to the host waits for the queued
                # blocks: finish them on the counted clock, exclude only
                # the copy (the write overlaps training)
                drain_inflight()
                with timer.exclude():
                    ckpt.save(step, train_state())

            if cfg.fail_at_step is not None and step >= cfg.fail_at_step:
                if ckpt:
                    commit()
                raise SimulatedFailure(f"injected failure at step {step}")

            if crossed(prev, step, cfg.eval_every) or step == total_steps:
                accuracy = evaluate()
                mlog.eval(step, accuracy)
                if (cfg.target_accuracy is not None
                        and accuracy >= cfg.target_accuracy):
                    reached_target_at = time.perf_counter() - t_start
                    log.info("target accuracy %.3f reached at step %d "
                             "(%.2fs)", cfg.target_accuracy, step,
                             reached_target_at)
                    break

        # On preemption skip the closing eval (a collective: every rank
        # skips it, each term below being deterministic or agreed): the
        # grace period before SIGKILL is for the save. A run that
        # completed (or reached its target) finished its job, even if a
        # signal landed in its last block.
        preempted = (stop_requested() and step < total_steps
                     and reached_target_at is None)
        if accuracy == 0.0 and not preempted:
            accuracy = evaluate()
        throughput = timer.snapshot(sync=inflight[-1] if inflight else None)
        wall = time.perf_counter() - t_start
        if ckpt:
            ckpt.save(step, train_state())
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
        "model_parallel": 1,
        "n_processes": world,
        "multihost": multihost,
        "global_batch": cfg.batch_size,
        "data": ds.source,
        "data_pipeline": "device",
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
