"""The device trace of a steady slice of the window: torch.profiler
(CPU and CUDA activities) started and stopped by the traffic driver at
chosen points, its Chrome trace written under the run's own temporary
directory, reduced in memory, and deleted.

The slice is bounded by two marks, `bm.clock` annotations recorded on
the profiling thread right after a device synchronize, so every
operation the slice launched has ended inside it (a trace of the device
alone, which records no annotation, is bounded by its first and last
event instead). From the trace:

- window_s: the slice, from the first mark to the last;
- busy_s: the union of every kernel, copy and memset inside it;
- kernel_s: the union of the kernels but NCCL's (the compute kernels);
- nccl_exposed_s: NCCL kernel time not covered by a compute kernel;
- launches: host calls that launch work (kernel, graph, copy, memset);
- top_ops: device time by operation name;
- gaps: idle time inside the slice, each gap named by what the host
  was doing: the innermost host operation around the launch of the
  work that ended the gap (or, given `label`, what it says of the host
  at that moment).
"""

from __future__ import annotations

import bisect
import json
import os
import time
from collections import defaultdict
from typing import Callable, Optional

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
            "cuLaunchKernelEx", "cudaLaunchCooperativeKernel",
            "cudaGraphLaunch", "cuGraphLaunch", "cudaMemcpyAsync",
            "cudaMemcpy", "cudaMemsetAsync", "cudaMemset")
MARK = "bm.clock"
TOP = 10
NAME_CHARS = 160


def _activities(device_type: str):
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if device_type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return acts


def _sync(device_type: str) -> None:
    if device_type == "cuda":
        import torch

        torch.cuda.synchronize()


def warm(device_type: str) -> None:
    """One empty profiling session, so that the tracer's own start-up
    (CUPTI's) falls in set-up and not in the slice."""
    from torch.profiler import profile

    with profile(activities=_activities(device_type)):
        pass


class Slice:
    """start() and stop() bound the slice; stop() returns its summary.

    On the card, `host_ops=False` traces the device alone (CUPTI's
    kernels, copies and runtime calls), which costs the host little, so
    the idle share is the program's own; `host_ops=True` also records
    every host operation, which names the gaps but slows the host."""

    def __init__(self, out_dir: str, device_type: str,
                 label: Optional[Callable[[float], Optional[str]]] = None,
                 host_ops: bool = True):
        self.out_dir, self.device_type, self.label = (out_dir, device_type,
                                                      label)
        self.host_ops = host_ops or device_type != "cuda"
        self.prof = None
        self.marks: list[float] = []   # time.monotonic() of each mark

    def _mark(self) -> None:
        from torch.autograd.profiler import record_function

        self.marks.append(time.monotonic())
        with record_function(MARK):
            pass

    def start(self) -> None:
        from torch.profiler import profile

        from torch.profiler import ProfilerActivity

        _sync(self.device_type)
        acts = (_activities(self.device_type) if self.host_ops
                else [ProfilerActivity.CUDA])
        self.prof = profile(activities=acts)
        self.prof.start()
        self._mark()

    def stop(self) -> dict:
        _sync(self.device_type)
        self._mark()
        self.prof.stop()
        path = os.path.join(self.out_dir, f"slice-{os.getpid()}.json")
        self.prof.export_chrome_trace(path)
        self.prof = None
        try:
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        return summarize(events, self.marks[0], self.label)


def _union(intervals) -> list[tuple[float, float]]:
    out: list = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def _length(intervals) -> float:
    return sum(b - a for a, b in intervals)


def _clip(intervals, w0: float, w1: float):
    return [(max(a, w0), min(b, w1)) for a, b in intervals
            if b > w0 and a < w1]


def _covered(a: float, b: float, union) -> float:
    """How much of [a, b] the sorted disjoint `union` covers."""
    i = max(0, bisect.bisect_right([u[0] for u in union], a) - 1)
    got = 0.0
    for u0, u1 in union[i:]:
        if u0 >= b:
            break
        got += max(0.0, min(b, u1) - max(a, u0))
    return got


def _is_nccl(name: str) -> bool:
    return "nccl" in name.lower()


class _HostIndex:
    """The innermost host operation on a thread at a moment."""

    def __init__(self, events):
        by_tid = defaultdict(list)
        for e in events:
            if e.get("cat") in HOST_CATS and e.get("name") != MARK:
                by_tid[e.get("tid")].append(
                    (e["ts"], e["ts"] + e.get("dur", 0), e["name"]))
        self.ops = {t: sorted(v) for t, v in by_tid.items()}
        self.starts = {t: [o[0] for o in v] for t, v in self.ops.items()}

    def at(self, tid, ts: float) -> Optional[str]:
        ops = self.ops.get(tid)
        if not ops:
            return None
        i = bisect.bisect_right(self.starts[tid], ts) - 1
        for j in range(i, max(-1, i - 400), -1):
            if ops[j][1] >= ts:
                return ops[j][2]
        return None


def summarize(events: list, t_mark0: Optional[float] = None,
              label: Optional[Callable[[float], Optional[str]]] = None
              ) -> dict:
    """Reduce a Chrome trace's events (microseconds) to the slice's
    summary, in seconds. `label(t)` names a gap from the host's side at
    time.monotonic() t; the first mark, at monotonic `t_mark0`, ties the
    two clocks."""
    x = [e for e in events if e.get("ph") == "X" and "ts" in e]
    marks = sorted(e["ts"] for e in x if e.get("name") == MARK)
    dev = [e for e in x if e.get("cat") in DEVICE_CATS]
    if len(marks) >= 2:
        w0, w1 = marks[0], marks[-1]
    else:
        w0 = min(e["ts"] for e in x)
        w1 = max(e["ts"] + e.get("dur", 0) for e in x)
    iv = lambda es: _clip([(e["ts"], e["ts"] + e.get("dur", 0))  # noqa: E731
                           for e in es], w0, w1)
    busy = _union(iv(dev))
    kernels = [e for e in dev if e.get("cat") == "kernel"]
    compute = _union(iv([e for e in kernels if not _is_nccl(e["name"])]))
    nccl = iv([e for e in kernels if _is_nccl(e["name"])])
    exposed = sum((b - a) - _covered(a, b, compute) for a, b in nccl)
    runtime = [e for e in x if e.get("cat") in RUNTIME_CATS]
    launches = sum(1 for e in runtime if e["name"] in LAUNCHES
                   and w0 <= e["ts"] <= w1)
    top = defaultdict(float)
    for e in dev:
        top[e["name"][:NAME_CHARS]] += e.get("dur", 0) / 1e6
    # idle gaps, each named by the host's side of the work that ended it
    by_corr = {e.get("args", {}).get("correlation"): e for e in runtime}
    starts = sorted((e["ts"], e) for e in dev)
    first_at = [s for s, _ in starts]
    host = _HostIndex(x)
    gaps = defaultdict(float)
    edge = w0
    for a, b in busy + [(w1, w1)]:
        if a > edge:
            name = "slice end" if a >= w1 else None
            if name is None:
                k = bisect.bisect_left(first_at, a)
                ender = starts[k][1] if k < len(starts) else None
                launch = by_corr.get((ender or {}).get("args", {})
                                     .get("correlation"))
                if label is not None and t_mark0 is not None:
                    name = label(t_mark0 + (a - w0) / 1e6)
                if name is None and launch is not None:
                    name = (host.at(launch.get("tid"), launch["ts"])
                            or launch["name"])
            gaps[name or "unattributed"] += (a - edge) / 1e6
        edge = max(edge, b)
    ranked = lambda d: [[k, v] for k, v in sorted(  # noqa: E731
        d.items(), key=lambda kv: -kv[1])[:TOP]]
    return {"window_s": (w1 - w0) / 1e6, "busy_s": _length(busy) / 1e6,
            "kernel_s": _length(compute) / 1e6,
            "nccl_exposed_s": exposed / 1e6, "launches": launches,
            "device_ops": ranked(top), "idle_gaps": ranked(gaps)}
