"""LeNet-5 — the port of distributedmnist_tpu/models/lenet.py.

conv 5x5x6 SAME -> relu -> avgpool 2 -> conv 5x5x16 VALID -> relu ->
avgpool 2 -> flatten (400) -> dense 120 -> relu -> dense 84 -> relu ->
dense 10: 61,706 parameters. Parameters keep flax's layout and names
(conv kernels HWIO under conv1/conv2, dense kernels (in, out) under
fc1/fc2/logits), so weights carry across (interop.py) without a
transpose. The activations stay NHWC as in the JAX model, and the
flatten is of NHWC (B, 5, 5, 16), as there: flattening NCHW would feed
fc1 its rows in another order.

Float32 means float32 on the card too: cuDNN runs a float32
convolution in TF32 unless told otherwise, so the trainer runs with
TF32 off for convolutions and matmuls, and with cuDNN's deterministic
algorithms (utils/device.training_numerics).
The dense layers are plain matmuls, as in the JAX model (nn.Dense, no
Pallas kernel). Parameters are float32 whatever the compute dtype: the
convolutions and dense layers compute in `dtype`, as flax's
dtype=bfloat16 layers do. `conv_impl` picks the convolutions
(ops/conv.py): "lax" (F.conv2d) or "im2col" (patch matmuls).

Under tensor parallelism (parallel/tp.py) fc1 is column-parallel, with
Megatron's f in front of it so that the replicated convolutions' input
gradient is summed over every column shard (else the model ranks' convs
drift apart); fc2 is row-parallel (the partial products summed over the
model group, then the bias once, then relu); the logits layer is
replicated.
"""

from __future__ import annotations

import torch
from torch import nn

from distributedmnist_tpu_torch.models.mlp import lecun_normal_, local_shape
from distributedmnist_tpu_torch.ops import conv as conv_lib
from distributedmnist_tpu_torch.parallel import tp as tp_lib

# (name, kernel shape, bias width)
LAYERS = (("conv1", (5, 5, 1, 6), 6),
          ("conv2", (5, 5, 6, 16), 16),
          ("fc1", (400, 120), 120),
          ("fc2", (120, 84), 84),
          ("logits", (84, 10), 10))


def full_shapes() -> dict:
    out = {}
    for name, shape, width in LAYERS:
        out[f"{name}.kernel"], out[f"{name}.bias"] = shape, (width,)
    return out


class _Layer(nn.Module):
    """One flax layer's parameters: {kernel, bias}."""

    def __init__(self, name, kernel_shape, width, device=None, tp=None):
        super().__init__()
        kw = {"device": device, "dtype": torch.float32}
        self.kernel = nn.Parameter(torch.zeros(
            local_shape(f"{name}.kernel", kernel_shape, tp), **kw))
        self.bias = nn.Parameter(torch.zeros(
            local_shape(f"{name}.bias", (width,), tp), **kw))


class LeNet5(nn.Module):
    def __init__(self, device=None, dtype: torch.dtype = torch.float32,
                 conv_impl: str = "lax", tp=None):
        super().__init__()
        if conv_impl not in conv_lib.IMPLS:
            raise ValueError(f"unknown conv_impl {conv_impl!r} "
                             "(expected 'im2col' or 'lax')")
        self.dtype, self.tp = dtype, tp
        self.conv, self.pool = conv_lib.IMPLS[conv_impl]
        for name, shape, width in LAYERS:
            self.add_module(name, _Layer(name, shape, width, device, tp))
        # fc1's and fc2's split dims are both 120 wide: both shard, or
        # both fall back
        if tp is not None and (tp.placement["fc2.kernel"] is None) != (
                tp.placement["fc1.kernel"] is None):
            raise ValueError("the fc1 and fc2 kernels must both be split "
                             "or both replicated")

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Fresh init as flax does it: lecun_normal kernels (fan_in =
        kh*kw*cin for a conv), zero biases. `generator` must live on the
        parameters' device."""
        for name, _, _ in LAYERS:
            layer = getattr(self, name)
            lecun_normal_(layer.kernel, generator)
            layer.bias.zero_()

    def _kb(self, name: str):
        layer = getattr(self, name)
        return layer.kernel.to(self.dtype), layer.bias.to(self.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        tp = self.tp
        x = x.to(self.dtype)                                   # (B,28,28,1)
        x = self.pool(torch.relu(self.conv(x, *self._kb("conv1"), "SAME")))
        x = self.pool(torch.relu(self.conv(x, *self._kb("conv2"), "VALID")))
        x = x.reshape(x.shape[0], -1)                          # NHWC, 400
        (w1, b1), (w2, b2) = self._kb("fc1"), self._kb("fc2")
        if tp is None or tp.placement["fc2.kernel"] is None:
            x = torch.relu(x @ w1 + b1)
            x = torch.relu(x @ w2 + b2)
        else:
            x = tp_lib.copy_to_model(x, tp)
            if tp.placement["fc1.bias"] is None:
                b1 = tp_lib.slice_replicated(b1, tp)     # partial fallback
            x = torch.relu(x @ w1 + b1)             # this rank's columns
            x = torch.relu(tp_lib.reduce_from_model(x @ w2, tp) + b2)
        return x @ self.logits.kernel.to(self.dtype) \
            + self.logits.bias.to(self.dtype)
