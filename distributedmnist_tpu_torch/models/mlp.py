"""2-layer MLP, 784-128-10 — the port of distributedmnist_tpu/models/mlp.py.

flatten -> dense(128) -> relu -> dense(10), 101,770 parameters. The
hidden layer always goes through the fused dense+relu kernel
(ops/fused.dense_relu: the hand-written kernel on the card, its plain
version on the CPU). Parameters keep flax's layout and orientation — a
dense kernel is (in, out) — under the names of the JAX model's fused
layout (hidden_kernel/hidden_bias), so weights carry across (interop.py)
without a transpose.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from distributedmnist_tpu_torch.ops import fused

# flax's truncated_normal draws from N(0, 1) cut at ±2, whose standard
# deviation is this; variance_scaling divides it out so the kept samples
# have the requested variance.
_TRUNC_STD = 0.87962566103423978

PARAM_NAMES = ("hidden_kernel", "hidden_bias", "logits_kernel",
               "logits_bias")


def lecun_normal_(t: torch.Tensor, generator: torch.Generator) -> None:
    """flax.linen.initializers.lecun_normal for a dense (in, out) or conv
    (kh, kw, cin, out) kernel: truncated normal (±2 std) with variance
    1/fan_in, fan_in being the product of all but the last dim."""
    std = math.sqrt(1.0 / math.prod(t.shape[:-1])) / _TRUNC_STD
    nn.init.trunc_normal_(t, mean=0.0, std=std, a=-2.0 * std, b=2.0 * std,
                          generator=generator)


class MLP(nn.Module):
    def __init__(self, in_features: int = 784, hidden: int = 128,
                 num_classes: int = 10, device=None):
        super().__init__()
        kw = {"device": device, "dtype": torch.float32}
        self.hidden_kernel = nn.Parameter(
            torch.zeros(in_features, hidden, **kw))
        self.hidden_bias = nn.Parameter(torch.zeros(hidden, **kw))
        self.logits_kernel = nn.Parameter(
            torch.zeros(hidden, num_classes, **kw))
        self.logits_bias = nn.Parameter(torch.zeros(num_classes, **kw))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Fresh init as flax does it: lecun_normal kernels, zero biases.
        `generator` must live on the parameters' device."""
        lecun_normal_(self.hidden_kernel, generator)
        lecun_normal_(self.logits_kernel, generator)
        self.hidden_bias.zero_()
        self.logits_bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.reshape(x.shape[0], -1).to(torch.float32)
        h = fused.dense_relu(x, self.hidden_kernel, self.hidden_bias)
        return h @ self.logits_kernel + self.logits_bias
