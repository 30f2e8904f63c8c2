"""Where the device time of the split-K kernels goes, on one CUDA card.

    python -m distributedmnist_tpu_torch.kernel_profile [--trace-dir DIR]

1. A K sweep: device time (calls captured in a CUDA graph and replayed)
   of dense_relu (f32, bf16), mlp_megakernel and quant_dense (784->128
   with relu; 128->10 where K <= 128) at b=1 and b=512, for K from 32
   (one stage: a cluster of one CTA) up to the MLP's 784. Beside
   it, the floor of any kernel in a graph: a one-element fill. The sweep
   separates what a launch, its cluster barriers and its reduction cost
   from what the cluster's size and each K stage cost.
2. A torch.profiler trace of each kernel at the serving path's buckets
   (1, 7, 128, 512), at the MLP's widths (quant_dense's second layer at
   its own K, 128) and at LeNet's dense widths (dense_relu bf16 400->120
   and 120->84, quant_dense 400->120, 120->84 and 84->10): for every
   kernel the trace
   records, its mean device time and the launch geometry the profiler
   reports (grid, block, registers per thread, shared memory, blocks and
   warps per SM, estimated achieved occupancy). The chrome traces go to
   DIR (default: csrc/build/kernel_profile, beside the built kernels).
3. Where LeNet's serving forward spends its device time: a profiler
   window of each precision's whole forward (float32, bfloat16, int8;
   uint8 pixels on the card -> logits) at buckets 1, 7, 128 and 512,
   summed per device kernel name, with the number of launches a forward.

Prints the card's name and power limit, then one JSON line per
measurement. Without a card it exits nonzero.
"""

from __future__ import annotations

import argparse
import itertools
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from distributedmnist_tpu_torch.ops import fused, kernel_lib

HIDDEN, CLASSES = 128, 10
BUCKETS = (1, 7, 128, 512)
SWEEP_K = (32, 64, 128, 256, 512, 784)


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def graph_us(fn, calls: int = 20, replays: int = 10) -> float:
    """Device microseconds per call: `calls` calls in one CUDA graph,
    replayed between CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) * 1e3 / (replays * calls)


def _inputs(m: int, k: int, seed: int) -> dict:
    r = np.random.default_rng(seed)
    dev = torch.device("cuda")

    def t(a):
        return torch.from_numpy(a.astype(np.float32)).to(dev)

    return {"x": t(r.integers(0, 256, (m, k))),
            "w1": t(r.normal(size=(k, HIDDEN)) * 0.05 / 255),
            "b1": t(r.normal(size=HIDDEN) * 0.1),
            "w2": t(r.normal(size=(HIDDEN, CLASSES)) * 0.1),
            "b2": t(r.normal(size=CLASSES))}


def _quant_inputs(m: int, k: int, n: int, seed: int) -> tuple:
    r = np.random.default_rng(seed)
    dev = torch.device("cuda")
    return (torch.from_numpy(r.integers(-128, 128, (m, k)).astype(
                np.int8)).to(dev),
            torch.from_numpy(r.integers(-127, 128, (k, n)).astype(
                np.int8)).to(dev),
            torch.from_numpy((r.random(n) * 1e-3).astype(np.float32)).to(dev),
            torch.from_numpy(r.normal(size=n).astype(np.float32)).to(dev))


def _cases(m: int, k: int, k2=None):
    """(name, fn) of each split-K kernel at (m, k) on the MLP's widths;
    quant_dense's 128->10 layer too, at K=k2, when k2 is given."""
    a = _inputs(m, k, seed=m + k)
    xs = a["x"] / 255.0
    xb, wb, bb = (t.bfloat16() for t in (xs, a["w1"] * 255, a["b1"]))
    yield "dense_relu f32", lambda: fused.dense_relu_inference(
        xs, a["w1"], a["b1"])
    yield "dense_relu bf16", lambda: fused.dense_relu_inference(xb, wb, bb)
    yield "mlp_megakernel", lambda: fused.mlp_megakernel(
        a["x"], a["w1"], a["b1"], a["w2"], a["b2"])
    q1 = _quant_inputs(m, k, HIDDEN, seed=m + k)
    yield "quant_dense layer1", lambda: fused.quant_dense(*q1)
    if k2 is not None:
        q2 = _quant_inputs(m, k2, CLASSES, seed=m + k2)
        yield "quant_dense layer2", lambda: fused.quant_dense(*q2,
                                                              relu=False)


def _lenet_cases(m: int):
    """(name, fn) of the kernels of LeNet's serving path at its dense
    widths: dense_relu bf16 at fc1 and fc2, quant_dense at fc1, fc2 and
    logits (no relu)."""
    for k, n in ((400, 120), (120, 84)):
        r = np.random.default_rng(m + k)
        x, w, b = (torch.from_numpy(a.astype(np.float32)).cuda().bfloat16()
                   for a in (r.random((m, k)), r.normal(size=(k, n)) * 0.05,
                             r.normal(size=n) * 0.1))
        yield (f"dense_relu bf16 {k}->{n}",
               lambda x=x, w=w, b=b: fused.dense_relu_inference(x, w, b))
    for k, n in ((400, 120), (120, 84), (84, 10)):
        q = _quant_inputs(m, k, n, seed=m + k)
        yield (f"quant_dense {k}->{n}",
               lambda q=q, r=n != 10: fused.quant_dense(*q, relu=r))


def sweep() -> None:
    one = torch.zeros(1, device="cuda")
    print(json.dumps({"sweep": "floor", "kernel": "fill_ one element",
                      "us": graph_us(lambda: one.fill_(1.0))}), flush=True)
    for m in (1, 512):
        for k in SWEEP_K:
            for name, fn in _cases(m, k, k if k <= HIDDEN else None):
                print(json.dumps({"sweep": "k", "kernel": name, "m": m,
                                  "k": k, "us": graph_us(fn)}), flush=True)


def trace(trace_dir: Path) -> None:
    from torch.profiler import ProfilerActivity, profile

    trace_dir.mkdir(parents=True, exist_ok=True)
    calls = 20
    for m in BUCKETS:
        for name, fn in itertools.chain(_cases(m, 784, HIDDEN),
                                        _lenet_cases(m)):
            for _ in range(5):
                fn()
            torch.cuda.synchronize()
            stem = name.replace(" ", "_").replace("->", "to")
            path = trace_dir / f"{stem}_b{m}.json"
            # the profiler now and then drops a window's device events;
            # take the first of three windows that kept most of them
            for _ in range(3):
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    for _ in range(calls):
                        fn()
                    torch.cuda.synchronize()
                prof.export_chrome_trace(str(path))
                kernels = {}
                for ev in json.loads(path.read_text())["traceEvents"]:
                    if ev.get("cat") != "kernel":
                        continue
                    rec = kernels.setdefault(
                        ev["name"], {"durs": [], "args": ev["args"]})
                    rec["durs"].append(ev["dur"])
                if any(len(r["durs"]) >= calls // 2
                       for r in kernels.values()):
                    break
            for kname, rec in kernels.items():
                args = rec["args"]
                print(json.dumps({
                    "trace": name, "m": m, "kernel": kname[:90],
                    "calls": len(rec["durs"]),
                    "mean_us": float(np.mean(rec["durs"])),
                    **{key: args.get(key) for key in (
                        "grid", "block", "registers per thread",
                        "shared memory", "blocks per SM", "warps per SM",
                        "est. achieved occupancy %")}}), flush=True)


def _device_kernels(fn, calls: int) -> dict:
    """{kernel name: [launches, total us]} of `calls` calls of fn, from a
    profiler window's device events."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            rec = out.setdefault(ev.name[:80], [0, 0.0])
            rec[0] += 1
            rec[1] += ev.time_range.elapsed_us()
    return out


def lenet_forwards() -> None:
    from distributedmnist_tpu_torch import models
    from distributedmnist_tpu_torch.serve import InferenceEngine

    params = models.init_params("lenet", 0)
    calls = 20
    for dt in ("float32", "bfloat16", "int8"):
        engine = InferenceEngine("lenet", params, device="cuda",
                                 max_batch=max(BUCKETS), infer_dtype=dt)
        for m in BUCKETS:
            x = torch.zeros((m, 28, 28, 1), dtype=torch.uint8,
                            device="cuda")
            with torch.inference_mode():
                kernels = _device_kernels(lambda: engine._forward(x), calls)
            total = sum(us for _, us in kernels.values())
            print(json.dumps({
                "forward": "lenet", "variant": dt, "m": m,
                "device_us": total / calls,
                "launches": sum(n for n, _ in kernels.values()) / calls,
                "kernels": {name: round(us / calls, 3) for name, (_, us)
                            in sorted(kernels.items(),
                                      key=lambda kv: -kv[1][1])}}),
                flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trace-dir", type=Path,
                    default=kernel_lib.BUILD_DIR / "kernel_profile")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_profile: needs a CUDA card", file=sys.stderr)
        return 2
    print(f"card: {card_line()}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    sweep()
    trace(args.trace_dir)
    lenet_forwards()
    return 0


if __name__ == "__main__":
    sys.exit(main())
