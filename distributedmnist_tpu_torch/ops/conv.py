"""LeNet's convolution and pooling — the port of
distributedmnist_tpu/ops/conv.py.

The JAX package computes these with XLA (lax convs, or patch matmuls on
the TPU); neither is a Pallas kernel, so the port calls `F.conv2d` and
`F.avg_pool2d`. Both functions keep the JAX package's layouts at their
interface: activations NHWC, conv kernels HWIO (flax's nn.Conv tree,
{kernel (kh, kw, cin, f), bias (f,)}). Inside they view the activations
as NCHW, which an NHWC tensor permuted is, in PyTorch's channels_last
memory format, so the permutes cost no copy where cuDNN takes that
format.
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
