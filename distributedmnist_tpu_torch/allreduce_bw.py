"""NCCL's all-reduce bus bandwidth among this host's cards, one rank a
card, at the size of each model's float32 gradients: the figure the
bench's sweep models the 8-card gradient all-reduce with
(bench.ALLREDUCE_BUS_GBPS).

    python -m distributedmnist_tpu_torch.allreduce_bw [--ranks N]

Starts N ranks (default: every visible card; parallel/launch.py), each
on its own card over NCCL. Each all-reduces a float32 buffer of each
model's gradient size, `--iters` times back to back after a warm-up,
timed by CUDA events; rank 0 prints one JSON line with the card's name
and power limit and, per model, the time per all-reduce, the algorithm
bandwidth (bytes / time) and NCCL's bus bandwidth (algorithm bandwidth
x 2(n-1)/n, the rate on each card's links that a ring all-reduce
needs), from rank 0's timing. Needs at least 2 cards.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys


def _measure(iters: int, warmup: int) -> dict:
    import torch
    import torch.distributed as dist

    from distributedmnist_tpu_torch import models
    from distributedmnist_tpu_torch.parallel import distributed, get_device

    distributed.maybe_initialize(None, None, None, "cuda")
    dev = get_device("cuda")
    world = dist.get_world_size()
    if distributed.topology().backend != "nccl":
        raise RuntimeError("needs one card a rank (NCCL)")
    out = {}
    for name in ("lenet", "mlp"):
        n = sum(math.prod(s) for s in models.full_shapes(name).values())
        buf = torch.ones(n, dtype=torch.float32, device=dev)
        for _ in range(warmup):
            dist.all_reduce(buf)
        torch.cuda.synchronize()
        dist.barrier()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            dist.all_reduce(buf)
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / iters
        nbytes = 4 * n
        alg = nbytes / (ms * 1e-3) / 1e9
        out[name] = {"grad_bytes_f32": nbytes, "ms": ms,
                     "algbw_gbps": alg,
                     "busbw_gbps": alg * 2 * (world - 1) / world}
    return {"ranks": world, "device": torch.cuda.get_device_name(dev),
            "models": out}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m distributedmnist_tpu_torch.allreduce_bw",
        description=__doc__.splitlines()[0])
    p.add_argument("--ranks", type=int, default=None)
    p.add_argument("--iters", type=int, default=500)
    p.add_argument("--warmup", type=int, default=50)
    p.add_argument("--rank-worker", action="store_true",
                   help=argparse.SUPPRESS)
    argv = sys.argv[1:] if argv is None else list(argv)
    args = p.parse_args(argv)
    if args.rank_worker:
        rec = _measure(args.iters, args.warmup)
        from distributedmnist_tpu_torch.parallel import distributed
        if distributed.process_index() == 0:
            print(json.dumps(rec), flush=True)
        distributed.shutdown()
        return 0

    import torch

    from distributedmnist_tpu_torch.parallel import launch

    n = args.ranks or torch.cuda.device_count()
    if n < 2:
        print("allreduce_bw: needs at least 2 cards", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    print(f"cards: {card}", flush=True)
    return launch.launch([sys.executable, "-m",
                          "distributedmnist_tpu_torch.allreduce_bw",
                          "--rank-worker", "--iters", str(args.iters),
                          "--warmup", str(args.warmup)], n)


if __name__ == "__main__":
    sys.exit(main())
