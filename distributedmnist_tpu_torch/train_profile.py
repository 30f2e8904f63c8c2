"""Where a training step's time goes, on the card.

    python -m distributedmnist_tpu_torch.train_profile [--steps N]
        [--trace-dir DIR] [--recipe PRESET]

For each single-card recipe (config 1: the MLP with SGD at batch 64;
config 2: LeNet-5 with Adam at batch 128), or for the one preset named
by --recipe, on full-size synthetic MNIST and through the trainer's own
step (trainer.data_parallel_step), after 50 warm-up steps. A
data-parallel preset (mlp-dp2) runs as its ranks, started here as the
train CLI starts them (one a card, sharing the card where there are
fewer), each through its step under DDP, and rank 0's line is printed:

1. Host time per step: N steps launched back to back as the trainer
   launches a block, the clock stopped after a synchronize.
2. A torch.profiler trace of N more steps: the device time per step
   (kernels, copies and fills on the card), the device's busy share of
   the window (the union of those intervals over the window from the
   first launch to the last device event), kernel launches per step,
   the calls in which the host waited for the card (synchronizes and
   blocking copies), the host time inside collectives (the profiler's
   gloo:/nccl: spans) and the kernels that took the most device time.
   The chrome traces go to DIR (default: csrc/build/train_profile,
   beside the built kernels).

Prints the card's name and power limit, then one JSON line per recipe.
Without a card it exits nonzero.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

from distributedmnist_tpu_torch import models, optim, trainer
from distributedmnist_tpu_torch.config import PRESETS
from distributedmnist_tpu_torch.data import (DeviceDataset, IndexStream,
                                             synthetic_mnist)
from distributedmnist_tpu_torch.kernel_profile import card_line
from distributedmnist_tpu_torch.ops import kernel_lib
from distributedmnist_tpu_torch.parallel import (distributed, get_device,
                                                 launch)
from distributedmnist_tpu_torch.utils.device import training_numerics

WARMUP = 50
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WAITS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize", "cudaMemcpy")


def _union_us(intervals) -> float:
    busy, end = 0.0, float("-inf")
    for start, stop in sorted(intervals):
        if stop <= end:
            continue
        busy += stop - max(start, end)
        end = stop
    return busy


def _read_trace(path: Path, steps: int) -> dict:
    events = [ev for ev in json.loads(path.read_text())["traceEvents"]
              if ev.get("ph") == "X"]
    device = [ev for ev in events if ev.get("cat") in DEVICE_CATS]
    launches = [ev for ev in events if ev.get("cat") == "kernel"]
    if not device:
        return {"kernels_per_step": 0.0}
    first = min(ev["ts"] for ev in events)
    last = max(ev["ts"] + ev["dur"] for ev in device)
    busy = _union_us((ev["ts"], ev["ts"] + ev["dur"]) for ev in device)
    by_kernel: dict = {}
    for ev in launches:
        by_kernel[ev["name"]] = by_kernel.get(ev["name"], 0.0) + ev["dur"]
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    waits = {}
    for ev in events:
        if ev.get("cat") == "cuda_runtime" and ev["name"] in WAITS:
            waits[ev["name"]] = waits.get(ev["name"], 0) + 1
    collective = sum(ev["dur"] for ev in events
                     if ev["name"].startswith(("gloo:", "nccl:")))
    return {
        "window_us_per_step": (last - first) / steps,
        "device_us_per_step": sum(ev["dur"] for ev in device) / steps,
        "device_busy_share": busy / (last - first),
        "kernels_per_step": len(launches) / steps,
        "host_waits": waits,
        "collective_us_per_step": collective / steps,
        "top_kernels_us_per_step": [
            {"kernel": name[:90], "us": us / steps} for name, us in top],
    }


def profile_recipe(name: str, data: dict, steps: int,
                   trace_dir: Path) -> dict:
    from torch.profiler import ProfilerActivity, profile

    cfg = PRESETS[name]
    dev = get_device("cuda", cfg.num_devices)
    rank, world = distributed.process_index(), distributed.process_count()
    ds = DeviceDataset(data, dev, pixel_format=cfg.pixel_format)
    net = models.build(cfg.model, device=dev)
    net.load_state_dict(models.init_params(cfg.model, cfg.seed))
    opt, sched = optim.build(cfg.optimizer, net.parameters(),
                             optim.make_schedule(cfg.learning_rate),
                             cfg.momentum)
    step = trainer.data_parallel_step(net, opt, sched, cfg.pixel_format, 1,
                                      cfg.spmd_mode, dev)
    stream = IndexStream(ds.train_n, cfg.batch_size, cfg.seed)

    def run(k: int) -> None:
        idx = stream.next_block(k, dev, rank, world)
        for i in range(k):
            step(ds.train_x, ds.train_y, idx[i])

    run(WARMUP)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(steps)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / steps
    path = trace_dir / f"{name}.json"
    # the profiler now and then drops a window's device events; take the
    # first of three windows that kept at least one kernel a step
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run(steps)
            torch.cuda.synchronize()
        prof.export_chrome_trace(str(path))
        rec = _read_trace(path, steps)
        if rec["kernels_per_step"] >= 1:
            break
    return {"recipe": name, "model": cfg.model, "optimizer": cfg.optimizer,
            "batch": cfg.batch_size, "ranks": world,
            "backend": distributed.topology().backend, "steps": steps,
            "step_ms": host_ms,
            "images_per_sec": cfg.batch_size * 1e3 / host_ms, **rec}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--trace-dir", type=Path,
                    default=kernel_lib.BUILD_DIR / "train_profile")
    ap.add_argument("--recipe", choices=sorted(PRESETS), default=None,
                    help="one preset (default: mlp-sgd and lenet-adam)")
    argv = sys.argv[1:] if argv is None else list(argv)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("train_profile: needs a CUDA card", file=sys.stderr)
        return 2
    if args.recipe:
        rc = launch.run_ranks("distributedmnist_tpu_torch.train_profile",
                              argv, PRESETS[args.recipe])
        if rc is not None:
            return rc
    distributed.maybe_initialize(None, None, None, "cuda")
    try:
        if distributed.process_index() == 0:
            print(f"card: {card_line()}", flush=True)
        trace_dir = args.trace_dir / f"rank{distributed.process_index()}"
        trace_dir.mkdir(parents=True, exist_ok=True)
        data = synthetic_mnist(seed=0)
        with training_numerics():
            for name in ((args.recipe,) if args.recipe
                         else ("mlp-sgd", "lenet-adam")):
                print(json.dumps(profile_recipe(name, data, args.steps,
                                                trace_dir)), flush=True)
    finally:
        distributed.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
