"""The device trace's reduction, on synthetic profiler events (us)."""

import pytest

from benchmark.harness import devtrace


def ev(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def trace():
    return [
        ev("user_annotation", devtrace.MARK, 0, 1),
        ev("cpu_op", "aten::conv", 5, 20),
        ev("cuda_runtime", "cudaLaunchKernel", 10, 2, corr=1),
        ev("kernel", "conv_kernel", 12, 30, tid=7, corr=1),      # 12-42
        ev("cpu_op", "aten::mm", 50, 30),
        ev("cuda_runtime", "cudaLaunchKernel", 60, 2, corr=2),
        ev("kernel", "gemm", 62, 20, tid=7, corr=2),             # 62-82
        ev("kernel", "ncclDevKernel_AllReduce", 70, 30, tid=8),  # 70-100
        ev("cuda_runtime", "cudaMemcpyAsync", 90, 2, corr=3),
        ev("gpu_memcpy", "Memcpy HtoD", 100, 10, tid=9, corr=3), # 100-110
        ev("cuda_runtime", "cudaEventSynchronize", 111, 5),
        ev("user_annotation", devtrace.MARK, 120, 1),
    ]


def test_busy_idle_and_kernels():
    s = devtrace.summarize(trace())
    assert s["window_s"] == pytest.approx(120e-6)
    # union: 12-42, 62-110
    assert s["busy_s"] == pytest.approx(78e-6)
    assert s["kernel_s"] == pytest.approx(50e-6)       # NCCL left out
    # NCCL 70-100, compute covers 70-82: 18 us exposed
    assert s["nccl_exposed_s"] == pytest.approx(18e-6)
    assert s["launches"] == 3


def test_gaps_named_by_the_host():
    s = devtrace.summarize(trace())
    gaps = dict(s["idle_gaps"])
    # 0-12 ends at conv_kernel, launched inside aten::conv; 42-62 ends
    # at gemm, launched inside aten::mm; 110-120 is the slice's end
    assert gaps["aten::conv"] == pytest.approx(12e-6)
    assert gaps["aten::mm"] == pytest.approx(20e-6)
    assert gaps["slice end"] == pytest.approx(10e-6)
    assert sum(gaps.values()) == pytest.approx(120e-6 - 78e-6)


def test_label_callback_and_top_ops():
    s = devtrace.summarize(trace(), t_mark0=100.0, label=lambda t: "host")
    assert dict(s["idle_gaps"])["host"] == pytest.approx(32e-6)
    tops = dict(s["device_ops"])
    assert tops["conv_kernel"] == pytest.approx(30e-6)
    assert list(tops)[0] == "conv_kernel"


def test_without_marks_the_trace_bounds_the_slice():
    events = [e for e in trace() if e["name"] != devtrace.MARK]
    s = devtrace.summarize(events)
    assert s["window_s"] == pytest.approx((116 - 5) * 1e-6)
