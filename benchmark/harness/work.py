"""The work of LeNet-5's layer operations, counted from their shapes,
and each operation's least time on one H100.

An operation's bound is the larger of its floating-point operations
over the float32 peak outside the tensor cores (the configuration runs
float32 with TF32 off) and its bytes over HBM's bandwidth, whatever
kernel runs it. Bytes count each input read once and each output
written once: the activations per row, the weights once per step.
Peaks are NVIDIA's data sheet for the H100 SXM (dense), as the port's
chip_smoke.py has them.
"""

from __future__ import annotations

PEAK_FLOPS_F32 = 67e12
HBM_BYTES_PER_S = 3.35e12
F32 = 4

# one row's forward: (name, input (h, w, c), kernel (kh, kw), output
# (h, w, c)) of each convolution, (name, input, output) of each pool,
# (name, inputs, outputs) of each dense layer
_CONV = (("conv1", (28, 28, 1), (5, 5), (28, 28, 6)),
         ("conv2", (14, 14, 6), (5, 5), (10, 10, 16)))
_POOL = (("pool1", (28, 28, 6), (14, 14, 6)),
         ("pool2", (10, 10, 16), (5, 5, 16)))
_DENSE = (("fc1", 400, 120), ("fc2", 120, 84), ("logits", 84, 10))
PARAMS = 61_706


def _size(shape) -> int:
    n = 1
    for d in shape:
        n *= d
    return n


def forward_macs_per_row() -> int:
    macs = 0
    for _, inp, (kh, kw), out in _CONV:
        macs += _size(out) * kh * kw * inp[2]
    return macs + sum(i * o for _, i, o in _DENSE)


def _ops(rows: int, train: bool) -> list[tuple[str, float, float]]:
    """[(operation, flops, bytes)] of one step over `rows` rows: the
    forward (and, training, the loss, the backward and Adam)."""
    ops = [("decode", 0.0, rows * 784 * (1 + F32))]
    acts = {}
    for name, inp, (kh, kw), out in _CONV:
        cin, k = inp[2], kh * kw
        w = k * cin * out[2] + out[2]
        macs = _size(out) * k * cin
        ops.append((name, 2.0 * macs * rows,
                    F32 * (rows * (_size(inp) + _size(out)) + w)))
        ops.append((name + ".relu", 0.0, 2.0 * F32 * rows * _size(out)))
        acts[name] = (inp, out, macs, w)
    for name, inp, out in _POOL:
        ops.append((name, 1.0 * rows * _size(inp),
                    F32 * rows * (_size(inp) + _size(out))))
    for name, i, o in _DENSE:
        ops.append((name, 2.0 * i * o * rows,
                    F32 * (rows * (i + o) + i * o + o)))
        if name != "logits":
            ops.append((name + ".relu", 0.0, 2.0 * F32 * rows * o))
    if not train:
        return ops
    ops.append(("loss", 3.0 * 10 * rows, F32 * rows * 10 + 8 * rows))
    ops.append(("loss.backward", 2.0 * 10 * rows, F32 * rows * 20))
    for name, i, o in reversed(_DENSE):
        # weight gradient: read input and output gradient, write dW
        ops.append((name + ".dW", 2.0 * i * o * rows,
                    F32 * (rows * (i + o) + i * o + o)))
        ops.append((name + ".dx", 2.0 * i * o * rows,
                    F32 * (rows * (i + o) + i * o)))
        if name != "fc1":           # the relu in front of this layer
            prev = {"logits": "fc2", "fc2": "fc1"}[name]
            ops.append((prev + ".relu.backward", 0.0,
                        3.0 * F32 * rows * i))
    for name, inp, out in reversed(_POOL):
        ops.append((name + ".backward", 1.0 * rows * _size(inp),
                    F32 * rows * (_size(inp) + _size(out))))
    for name in ("conv2", "conv1"):
        inp, out, macs, w = acts[name]
        ops.append((name + ".relu.backward", 0.0,
                    3.0 * F32 * rows * _size(out)))
        ops.append((name + ".dW", 2.0 * macs * rows,
                    F32 * (rows * (_size(inp) + _size(out)) + w)))
        if name == "conv2":         # the image needs no gradient
            ops.append((name + ".dx", 2.0 * macs * rows,
                        F32 * (rows * (_size(inp) + _size(out)) + w)))
    # Adam: read parameter, gradient and both moments, write three back
    ops.append(("adam", 10.0 * PARAMS, 7.0 * F32 * PARAMS))
    return ops


def bound_s(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_FLOPS_F32, nbytes / HBM_BYTES_PER_S)


def step_bound_s(rows: int, train: bool) -> float:
    """The sum of every operation's bound for one step (or one forward)
    over `rows` rows."""
    return sum(bound_s(f, b) for _, f, b in _ops(rows, train))


def flops(rows: int, train: bool) -> float:
    """Model FLOPs: 2 per multiply-add of the convolutions and dense
    layers (forward; training adds the weight gradients and every input
    gradient but conv1's), no recompute."""
    fwd = 2.0 * forward_macs_per_row() * rows
    if not train:
        return fwd
    conv1 = 2.0 * 28 * 28 * 6 * 25 * rows
    return fwd + fwd + (fwd - conv1)
