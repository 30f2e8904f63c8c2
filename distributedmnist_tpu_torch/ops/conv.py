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


def conv2d(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
           padding: str = "VALID") -> torch.Tensor:
    """2-D convolution, stride 1: x (B, H, W, C), kernel (kh, kw, C, F),
    bias (F,) -> (B, H', W', F). padding in {VALID, SAME} (SAME needs odd
    kernel dims, which LeNet's 5x5 are)."""
    if padding not in ("VALID", "SAME"):
        raise ValueError(f"unsupported padding {padding!r}")
    out = F.conv2d(x.permute(0, 3, 1, 2), kernel.permute(3, 2, 0, 1),
                   bias, padding="same" if padding == "SAME" else 0)
    return out.permute(0, 2, 3, 1)


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
