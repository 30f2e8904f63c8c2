"""LeNet's convolution and pooling — the port of
distributedmnist_tpu/ops/conv.py.

The JAX package computes these with XLA, as lax convs or as patch
matmuls; neither is a Pallas kernel. The port has both, in plain torch:

- "lax": `F.conv2d` and `F.avg_pool2d` (`conv2d`, `avg_pool2`), which
  view the NHWC activations as NCHW, as an NHWC tensor permuted is in
  PyTorch's channels_last memory format, so the permutes cost no copy
  where cuDNN takes that format;
- "im2col": the kh*kw shifted slices stacked into one patch matmul, and
  a 2x2 pool as a reshape and a mean (`im2col_conv`, `avg_pool2_reshape`).

In training, a float32 SAME convolution of one-channel images whose
kernel needs a gradient and whose input does not (LeNet's conv1) goes
through `Conv1chWgrad`: the same forward, and a backward that computes
the weight and bias gradients by ops/fused.conv_wgrad_1ch, on the card
in one hand-written kernel in place of cuDNN's deterministic weight-
gradient engine, on the CPU in the op autograd runs for F.conv2d.

Every function keeps the JAX package's layouts at its interface:
activations NHWC, conv kernels HWIO (flax's nn.Conv tree, {kernel (kh,
kw, cin, f), bias (f,)}), so both take the same parameters. "auto" is
"lax" on the card and on the CPU: the JAX package picks im2col only for
the TPU, whose matrix unit is all it has and whose compiler hung on a
conv backward; cuDNN's convolutions have neither problem.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from distributedmnist_tpu_torch.ops import fused


def _conv(x, kernel, bias, padding: str):
    out = F.conv2d(x.permute(0, 3, 1, 2), kernel.permute(3, 2, 0, 1),
                   bias, padding="same" if padding == "SAME" else 0)
    return out.permute(0, 2, 3, 1)


class Conv1chWgrad(torch.autograd.Function):
    """conv2d(x, kernel, bias, "SAME") whose backward gives the kernel's
    and the bias's gradients from fused.conv_wgrad_1ch (dW already HWIO)
    and none for x, which must need none."""

    @staticmethod
    def forward(ctx, x, kernel, bias):
        ctx.save_for_backward(x, kernel)
        return _conv(x, kernel, bias, "SAME")

    @staticmethod
    def backward(ctx, g):
        x, kernel = ctx.saved_tensors
        dw, db = fused.conv_wgrad_1ch(x, g, kernel)
        return None, dw, db


def takes_conv1ch_wgrad(x, kernel, padding: str) -> bool:
    """Whether conv2d's backward goes through Conv1chWgrad: float32, one
    input channel, an odd square kernel, SAME, the kernel needing a
    gradient and x none (a training step's first convolution)."""
    kh, kw, cin, _ = kernel.shape
    return (padding == "SAME" and x.dtype == torch.float32
            and kernel.dtype == torch.float32 and cin == 1 and kh == kw
            and kh % 2 == 1 and torch.is_grad_enabled()
            and kernel.requires_grad and not x.requires_grad)


def conv2d(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
           padding: str = "VALID") -> torch.Tensor:
    """2-D convolution, stride 1: x (B, H, W, C), kernel (kh, kw, C, F),
    bias (F,) -> (B, H', W', F). padding in {VALID, SAME} (SAME needs odd
    kernel dims, which LeNet's 5x5 are)."""
    if padding not in ("VALID", "SAME"):
        raise ValueError(f"unsupported padding {padding!r}")
    if takes_conv1ch_wgrad(x, kernel, padding):
        return Conv1chWgrad.apply(x, kernel, bias)
    return _conv(x, kernel, bias, padding)


def avg_pool2(x: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 average pool of x (B, H, W, C), H and W even."""
    return F.avg_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)


def im2col_conv(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                padding: str = "VALID") -> torch.Tensor:
    """2-D convolution (NHWC, stride 1) as one patch matmul: x (B, H, W,
    C), kernel (kh, kw, C, F), bias (F,); padding VALID or SAME (odd
    kernel dims)."""
    kh, kw, cin, feat = kernel.shape
    if padding == "SAME":
        x = F.pad(x, (0, 0, kw // 2, kw // 2, kh // 2, kh // 2))
    elif padding != "VALID":
        raise ValueError(f"unsupported padding {padding!r}")
    b, h, w, c = x.shape
    oh, ow = h - kh + 1, w - kw + 1
    patches = torch.stack([x[:, i:i + oh, j:j + ow, :]
                           for i in range(kh) for j in range(kw)], dim=3)
    patches = patches.reshape(b, oh, ow, kh * kw * c)
    return patches @ kernel.reshape(kh * kw * cin, feat) + bias


def avg_pool2_reshape(x: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 average pool of x (B, H, W, C) as a reshape and a
    mean (H and W even)."""
    b, h, w, c = x.shape
    return x.reshape(b, h // 2, 2, w // 2, 2, c).mean(dim=(2, 4))


# conv_impl -> (conv, pool)
IMPLS = {"lax": (conv2d, avg_pool2), "im2col": (im2col_conv,
                                                avg_pool2_reshape)}


def resolve(conv_impl: str) -> str:
    """A conv_impl flag's value as the implementation that runs: auto is
    lax on every device the port runs on."""
    if conv_impl == "auto":
        return "lax"
    if conv_impl not in IMPLS:
        raise ValueError(f"unknown conv impl {conv_impl!r}")
    return conv_impl
