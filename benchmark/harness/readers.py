"""What the per-layer metrics of training cells read from a traced run's
observations (`obs`, the driver's): each function returns nothing where
the run traced nothing it can read. A metric's own file in metrics/
names the function it reads with; the cells of one configuration kind
can then report the same quantity under names of their own."""

from __future__ import annotations


def _traces(obs: dict) -> list:
    return obs.get("traces") or [] if obs.get("kind") == "train" else []


def idle_pct(obs: dict):
    """The share of the traced slice in which no kernel, copy or memset
    ran on the card, averaged over the ranks' cards."""
    traces = _traces(obs)
    if not traces:
        return None
    return sum(100.0 * (1.0 - t["busy_s"] / t["window_s"])
               for t in traces) / len(traces)


def launches_per_step(obs: dict):
    """Host calls that launch work on the card (kernels, graphs, copies,
    memsets) in the traced slice, per training step, averaged over the
    ranks."""
    traces = _traces(obs)
    if not traces:
        return None
    return sum(t["launches"] / t["steps"] for t in traces) / len(traces)


def mfu(obs: dict):
    """Model FLOPs a trained image (LeNet-5's shapes: forward, weight
    gradients and every input gradient but conv1's, no recompute) times
    the slice's images/s a card, over the card's float32 peak (67
    TFLOP/s, TF32 off), averaged over the ranks."""
    traces = _traces(obs)
    if not traces:
        return None
    vals = [100.0 * obs["flops_per_row"] * t["steps"] * obs["rows_per_step"]
            / t["window_s"] / obs["peak_flops"] for t in traces]
    return sum(vals) / len(vals)


def roofline_pct(obs: dict):
    """The sum of every layer operation's least time in a step (from its
    shapes: the larger of FLOPs over the f32 peak and bytes over HBM's
    bandwidth), over the step's measured compute-kernel time (the union
    of the slice's kernels but NCCL's, per step), averaged over the
    ranks."""
    traces = [t for t in _traces(obs) if t["kernel_s"] > 0]
    if not traces:
        return None
    vals = [100.0 * obs["bound_s_per_step"] * t["steps"] / t["kernel_s"]
            for t in traces]
    return sum(vals) / len(vals)


def allreduce_exposed_ms(obs: dict):
    """NCCL kernel time a step that no compute kernel on the same card
    covers, averaged over the ranks; nothing where the slice ran no NCCL
    kernel (a single rank)."""
    traces = _traces(obs)
    if not traces or obs.get("world", 1) < 2:
        return None
    return sum(1e3 * t["nccl_exposed_s"] / t["steps"]
               for t in traces) / len(traces)
