"""2-layer MLP, 784-128-10 — the port of distributedmnist_tpu/models/mlp.py.

flatten -> dense(128) -> relu -> dense(10), 101,770 parameters.
Parameters keep flax's layout and orientation — a dense kernel is (in,
out) — under the names of the JAX model's fused layout
(hidden_kernel/hidden_bias), so weights carry across (interop.py)
without a transpose, whichever path computes the hidden layer:

- the kernel path (fused "auto" or "pallas", the default): the fused
  dense+relu kernel (ops/fused.dense_relu: the hand-written kernel on
  the card, its plain version on the CPU). As the JAX model's Pallas
  path creates them in its compute dtype, hidden_kernel and hidden_bias
  are held in `dtype` (bfloat16 parameters under bfloat16 training).
- fused "xla": plain relu(x @ w + b), the counterpart of the JAX model's
  nn.Dense + relu; every parameter float32, computed in `dtype`.

The logits layer is float32 parameters computed in `dtype`, as
nn.Dense(dtype=...) does. Under tensor parallelism (parallel/tp.py) the
hidden layer is column-parallel (each rank holds 128/mp columns and runs
the kernel on them: a column split with an elementwise relu needs no
collective) and the logits layer row-parallel: each rank's partial
product, summed over the model group, then the bias once.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from distributedmnist_tpu_torch.ops import fused
from distributedmnist_tpu_torch.parallel import tp as tp_lib

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


def full_shapes(in_features: int = 784, hidden: int = 128,
                num_classes: int = 10) -> dict:
    return {"hidden_kernel": (in_features, hidden), "hidden_bias": (hidden,),
            "logits_kernel": (hidden, num_classes),
            "logits_bias": (num_classes,)}


def local_shape(name: str, shape: tuple, tp) -> tuple:
    """A parameter's shape on this rank: its full shape, its sharded dim
    cut by the model group's size under tensor parallelism."""
    dim = None if tp is None else tp.placement.get(name)
    if dim is None:
        return tuple(shape)
    return tuple(n // tp.size if d == dim else n for d, n in enumerate(shape))


class MLP(nn.Module):
    def __init__(self, in_features: int = 784, hidden: int = 128,
                 num_classes: int = 10, device=None,
                 dtype: torch.dtype = torch.float32, kernel: bool = True,
                 tp=None):
        super().__init__()
        self.dtype, self.kernel, self.tp = dtype, kernel, tp
        for name, shape in full_shapes(in_features, hidden,
                                       num_classes).items():
            held = dtype if kernel and name.startswith("hidden") \
                else torch.float32
            self.register_parameter(name, nn.Parameter(torch.zeros(
                local_shape(name, shape, tp), device=device, dtype=held)))
        # the two kernels' split dims are the hidden width: both shard,
        # or both fall back
        if tp is not None and (tp.placement["logits_kernel"] is None) != (
                tp.placement["hidden_kernel"] is None):
            raise ValueError("the hidden and logits kernels must both be "
                             "split or both replicated")

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Fresh init as flax does it: lecun_normal kernels, zero biases.
        `generator` must live on the parameters' device."""
        lecun_normal_(self.hidden_kernel, generator)
        lecun_normal_(self.logits_kernel, generator)
        self.hidden_bias.zero_()
        self.logits_bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt, tp = self.dtype, self.tp
        x = x.reshape(x.shape[0], -1).to(dt)
        w, b = self.hidden_kernel.to(dt), self.hidden_bias.to(dt)
        if tp is not None and tp.placement["hidden_kernel"] is not None \
                and tp.placement["hidden_bias"] is None:
            b = tp_lib.slice_replicated(b, tp)      # the partial fallback
        if self.kernel:
            h = fused.dense_relu(x, w, b)
        else:
            h = torch.relu(x @ w + b)
        if tp is None or tp.placement["logits_kernel"] is None:
            return h @ self.logits_kernel.to(dt) + self.logits_bias.to(dt)
        y = tp_lib.reduce_from_model(h @ self.logits_kernel.to(dt), tp)
        return y + self.logits_bias.to(dt)
