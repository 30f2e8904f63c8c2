"""The port's hand-written kernels, each beside its plain PyTorch
version: the three fused dense kernels of the MLP path and LeNet's
conv1 weight gradient.

- `dense_relu`: relu(x @ w + b), f32 or bf16, f32 accumulation; training
  goes through the `DenseReLU` autograd Function, whose backward is plain
  matmuls; serving calls `dense_relu_inference`.
- `quant_dense`: int8 x int8 -> int32, then `acc * scale + b` in f32,
  optionally relu'd.
- `mlp_megakernel`: relu(x @ w1 + b1) @ w2 + b2 in one launch.
- `conv_wgrad_1ch`: dW and db of a SAME convolution of one-channel
  images (LeNet's conv1), for the backward of ops/conv.py's
  `Conv1chWgrad`.

Dense kernels keep flax's (in, out) orientation: x is (m, k), w is (k, n).

Routing is by the tensors' device and nothing else: a CUDA tensor
launches the hand-written kernel (csrc/, built and bound by kernel_lib)
or raises — there is no fallback — and a CPU tensor runs the plain
version, which is what the CPU tests compare with the JAX package. Every
wrapper adds one to `LAUNCHES[name]` where it launches its kernel, so a
run can show that its main path went through the kernels.
"""

from __future__ import annotations

import json
import sys

import torch

from distributedmnist_tpu_torch.ops import kernel_lib

KERNEL = "kernel"      # hand-written CUDA kernel (a CUDA device)
PLAIN = "plain"        # plain PyTorch version (the CPU)

# Kernel launches since the last reset_launches(), by kernel name.
LAUNCHES = {"dense_relu": 0, "quant_dense": 0, "mlp_megakernel": 0,
            "conv_wgrad_1ch": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def print_launches(prefix: str) -> None:
    """`prefix{counts}` on stderr in one write. print() writes the text
    and its newline apart, and where stderr is unbuffered
    (PYTHONUNBUFFERED) that is two system calls: two processes sharing
    one stderr then glue their lines together."""
    sys.stderr.write(prefix + json.dumps(LAUNCHES) + "\n")
    sys.stderr.flush()


def parse_launches(text: str, prefix: str) -> list:
    """The counts of each `prefix{...}` in `text` (a child's stderr),
    each read up to its object's closing brace, so that output glued to
    it, or a second such line glued on, changes nothing. One cut short
    (its writer killed) is left out: callers check how many they got."""
    decoder = json.JSONDecoder()
    out = []
    for line in text.splitlines():
        at = line.find(prefix)
        while at >= 0:
            try:
                counts, end = decoder.raw_decode(line, at + len(prefix))
            except ValueError:
                end = at + len(prefix)
            else:
                out.append(counts)
            at = line.find(prefix, end)
    return out


def resolve(device) -> str:
    """Which implementation serves tensors on `device`: the kernel on
    cuda, the plain version on the cpu."""
    kind = torch.device(device).type
    if kind == "cuda":
        return KERNEL
    if kind == "cpu":
        return PLAIN
    raise ValueError(f"no fused-kernel route for device {kind!r}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _launch(t: torch.Tensor, source: str, fn: str, *args) -> None:
    """kernel_lib.launch with `t`'s card current: a library sets its
    kernels' attributes on the current card, and a serving fleet with a
    replica a card launches on several cards from one process."""
    if t.device.index in (None, torch.cuda.current_device()):
        kernel_lib.launch(source, fn, *args)
        return
    with torch.cuda.device(t.device):
        kernel_lib.launch(source, fn, *args)


def _check(name: str, t: torch.Tensor, dtypes, ndim: int, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {t.dtype}, expected one of "
                        f"{sorted(str(d) for d in dtypes)}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


# -- dense_relu ---------------------------------------------------------------


def dense_relu_reference(x, w, b):
    """Plain relu(x @ w + b) with the kernel's numerics: f32 accumulation,
    bias added in f32, result in x's dtype."""
    acc = x.float() @ w.float() + b.float()
    return torch.relu(acc).to(x.dtype)


def dense_relu_inference(x, w, b):
    """relu(x @ w + b), forward only: the kernel on a CUDA tensor, the
    plain version on a CPU one."""
    if resolve(x.device) == PLAIN:
        return dense_relu_reference(x, w, b)
    _check("x", x, (torch.float32, torch.bfloat16), 2, x.device)
    _check("w", w, (x.dtype,), 2, x.device)
    _check("b", b, (x.dtype,), 1, x.device)
    m, k = x.shape
    if w.shape[0] != k or b.shape[0] != w.shape[1]:
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}, b {tuple(b.shape)}")
    n = w.shape[1]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    fn = "dense_relu_f32" if x.dtype == torch.float32 else "dense_relu_bf16"
    _launch(x, "dense_relu.cu", fn, x.data_ptr(), w.data_ptr(),
            b.data_ptr(), out.data_ptr(), m, n, k, _stream(x))
    LAUNCHES["dense_relu"] += 1
    return out


class DenseReLU(torch.autograd.Function):
    """relu(x @ w + b) with the forward fused in one kernel and a plain
    matmul backward (the JAX package's custom VJP, ops/fused.py _bwd)."""

    @staticmethod
    def forward(ctx, x, w, b):
        y = dense_relu_inference(x, w, b)
        ctx.save_for_backward(x, w, y)
        return y

    @staticmethod
    def backward(ctx, g):
        x, w, y = ctx.saved_tensors
        g = torch.where(y > 0, g, torch.zeros_like(g)).float()
        # a training step's x is data, which needs no gradient
        dx = ((g @ w.float().T).to(x.dtype) if ctx.needs_input_grad[0]
              else None)
        dw = (x.float().T @ g).to(w.dtype)
        db = g.sum(dim=0).to(w.dtype)
        return dx, dw, db


def dense_relu(x, w, b):
    """relu(x @ w + b) through the fused kernel, differentiable."""
    return DenseReLU.apply(x, w, b)


# -- quant_dense --------------------------------------------------------------


def quant_dense_reference(x_q, w_q, scale, b, relu: bool = True):
    """Plain int8 dense layer. The int32 accumulator is formed in float64,
    which is exact here (|acc| <= k * 128 * 127 < 2**53 and every partial
    sum is an integer) on any device, since CUDA has no int32 matmul. The
    epilogue is a separate multiply and add, each rounded once."""
    acc = (x_q.double() @ w_q.double()).to(torch.int32)
    out = acc.float() * scale + b
    return torch.relu(out) if relu else out


def quant_dense(x_q, w_q, scale, b, relu: bool = True):
    """(x_q @ w_q) * scale + b, optionally relu'd, as float32.

    x_q (m, k) int8, w_q (k, n) int8, scale (n,) float32 — the combined
    dequant factor (weight scale x activation scale) — and b (n,)
    float32."""
    if x_q.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise TypeError(f"quant_dense wants int8 operands, got {x_q.dtype} "
                        f"@ {w_q.dtype}")
    if resolve(x_q.device) == PLAIN:
        return quant_dense_reference(x_q, w_q, scale, b, relu=relu)
    dev = x_q.device
    _check("x_q", x_q, (torch.int8,), 2, dev)
    _check("w_q", w_q, (torch.int8,), 2, dev)
    _check("scale", scale, (torch.float32,), 1, dev)
    _check("b", b, (torch.float32,), 1, dev)
    m, k = x_q.shape
    n = w_q.shape[1]
    if w_q.shape[0] != k or scale.shape[0] != n or b.shape[0] != n:
        raise ValueError(
            f"shape mismatch: x_q {tuple(x_q.shape)}, w_q "
            f"{tuple(w_q.shape)}, scale {tuple(scale.shape)}, b "
            f"{tuple(b.shape)}")
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    _launch(x_q, "quant_dense.cu", "quant_dense_s8", x_q.data_ptr(),
            w_q.data_ptr(), scale.data_ptr(), b.data_ptr(), out.data_ptr(),
            m, n, k, int(relu), _stream(x_q))
    LAUNCHES["quant_dense"] += 1
    return out


# -- mlp_megakernel -----------------------------------------------------------

def mlp_megakernel_reference(x, w1, b1, w2, b2):
    """Plain relu(x @ w1 + b1) @ w2 + b2 in float32."""
    return torch.relu(x @ w1 + b1) @ w2 + b2


def mlp_megakernel(x, w1, b1, w2, b2):
    """relu(x @ w1 + b1) @ w2 + b2 in one launch; all float32. The kernel
    itself refuses a hidden width or logit count its layout was not built
    for (csrc/mlp_megakernel.cu), and launch() raises its error."""
    if resolve(x.device) == PLAIN:
        return mlp_megakernel_reference(x, w1, b1, w2, b2)
    dev = x.device
    for name, t, nd in (("x", x, 2), ("w1", w1, 2), ("b1", b1, 1),
                        ("w2", w2, 2), ("b2", b2, 1)):
        _check(name, t, (torch.float32,), nd, dev)
    m, k = x.shape
    hidden, n2 = w2.shape
    if (tuple(w1.shape) != (k, hidden) or b1.shape[0] != hidden
            or b2.shape[0] != n2):
        raise ValueError(
            f"shape mismatch: x {tuple(x.shape)}, w1 {tuple(w1.shape)}, "
            f"b1 {tuple(b1.shape)}, w2 {tuple(w2.shape)}, b2 "
            f"{tuple(b2.shape)}")
    out = torch.empty((m, n2), dtype=torch.float32, device=dev)
    _launch(x, "mlp_megakernel.cu", "mlp_megakernel_f32", x.data_ptr(),
            w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
            out.data_ptr(), m, k, hidden, n2, _stream(x))
    LAUNCHES["mlp_megakernel"] += 1
    return out


# -- conv_wgrad_1ch -----------------------------------------------------------

# The one shape csrc/conv_wgrad_1ch.cu is compiled for: LeNet's conv1,
# images (H, W, 1), kernel (kh, kw, 1, F) HWIO; and its scratch, one row
# of partial sums (dW's and db's elements) a block of its first pass.
CONV_WGRAD_IMAGE = (28, 28, 1)
CONV_WGRAD_KERNEL = (5, 5, 1, 6)
CONV_WGRAD_MAX_BLOCKS = 512


def conv_wgrad_1ch_reference(x, g, kernel):
    """(dW, db) of a stride-1 SAME convolution, x (B, H, W, C) NHWC,
    kernel (kh, kw, C, F) HWIO, output gradient g (B, H, W, F): the one
    op autograd runs for F.conv2d's weight and bias when its input needs
    no gradient, on the NCHW views ops/conv.conv2d convolves, so the
    numbers are F.conv2d's own bit for bit. dW comes back HWIO."""
    kh, kw = kernel.shape[:2]
    _, dw, db = torch.ops.aten.convolution_backward(
        g.permute(0, 3, 1, 2), x.permute(0, 3, 1, 2),
        kernel.permute(3, 2, 0, 1), [kernel.shape[3]], [1, 1],
        [kh // 2, kw // 2], [1, 1], False, [0, 0], 1, [False, True, True])
    return dw.permute(2, 3, 1, 0), db


def conv_wgrad_1ch(x, g, kernel):
    """(dW (5, 5, 1, 6) HWIO, db (6,)) of LeNet's conv1, float32: x
    (B, 28, 28, 1) its input, g (B, 28, 28, 6) its output gradient,
    `kernel` its weights (read for their shape). The kernel on a CUDA
    tensor, which raises on any other shape or dtype, and on x or g not
    16-byte aligned (a fresh allocation is); the plain version on a CPU
    one. Two calls on the same inputs give the same bits."""
    if resolve(x.device) == PLAIN:
        return conv_wgrad_1ch_reference(x, g, kernel)
    dev = x.device
    x, g = x.contiguous(), g.contiguous()
    for name, t in (("x", x), ("g", g), ("kernel", kernel)):
        _check(name, t, (torch.float32,), 4, dev)
    rows = x.shape[0]
    filters = CONV_WGRAD_KERNEL[3]
    if (rows < 1 or tuple(x.shape[1:]) != CONV_WGRAD_IMAGE
            or tuple(kernel.shape) != CONV_WGRAD_KERNEL
            or tuple(g.shape) != (rows, *CONV_WGRAD_IMAGE[:2], filters)):
        raise ValueError(
            f"conv_wgrad_1ch takes x (B, 28, 28, 1), g (B, 28, 28, 6) and "
            f"a (5, 5, 1, 6) kernel, B >= 1: got x {tuple(x.shape)}, g "
            f"{tuple(g.shape)}, kernel {tuple(kernel.shape)}")
    dw = torch.empty(CONV_WGRAD_KERNEL, dtype=torch.float32, device=dev)
    db = torch.empty((filters,), dtype=torch.float32, device=dev)
    part = torch.empty((CONV_WGRAD_MAX_BLOCKS, dw.numel() + filters),
                       dtype=torch.float32, device=dev)
    h, w, _ = CONV_WGRAD_IMAGE
    _launch(x, "conv_wgrad_1ch.cu", "conv_wgrad_1ch_f32", x.data_ptr(),
            g.data_ptr(), part.data_ptr(), dw.data_ptr(), db.data_ptr(),
            rows, h, w, CONV_WGRAD_KERNEL[0], filters,
            CONV_WGRAD_MAX_BLOCKS, _stream(x))
    LAUNCHES["conv_wgrad_1ch"] += 1
    return dw, db
