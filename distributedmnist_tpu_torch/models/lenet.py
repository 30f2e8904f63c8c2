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
TF32 off for convolutions and matmuls (utils/device.float32_numerics).
The dense layers are plain matmuls, as in the JAX model (nn.Dense, no
Pallas kernel).
"""

from __future__ import annotations

import torch
from torch import nn

from distributedmnist_tpu_torch.models.mlp import lecun_normal_
from distributedmnist_tpu_torch.ops.conv import avg_pool2, conv2d

# (name, kernel shape, bias width)
LAYERS = (("conv1", (5, 5, 1, 6), 6),
          ("conv2", (5, 5, 6, 16), 16),
          ("fc1", (400, 120), 120),
          ("fc2", (120, 84), 84),
          ("logits", (84, 10), 10))


class _Layer(nn.Module):
    """One flax layer's parameters: {kernel, bias}."""

    def __init__(self, kernel_shape, width, device=None):
        super().__init__()
        kw = {"device": device, "dtype": torch.float32}
        self.kernel = nn.Parameter(torch.zeros(kernel_shape, **kw))
        self.bias = nn.Parameter(torch.zeros(width, **kw))


class LeNet5(nn.Module):
    def __init__(self, device=None):
        super().__init__()
        for name, shape, width in LAYERS:
            self.add_module(name, _Layer(shape, width, device=device))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Fresh init as flax does it: lecun_normal kernels (fan_in =
        kh*kw*cin for a conv), zero biases. `generator` must live on the
        parameters' device."""
        for name, _, _ in LAYERS:
            layer = getattr(self, name)
            lecun_normal_(layer.kernel, generator)
            layer.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(torch.float32)                                # (B,28,28,1)
        x = avg_pool2(torch.relu(conv2d(x, self.conv1.kernel,
                                        self.conv1.bias, "SAME")))
        x = avg_pool2(torch.relu(conv2d(x, self.conv2.kernel,
                                        self.conv2.bias, "VALID")))
        x = x.reshape(x.shape[0], -1)                          # NHWC, 400
        x = torch.relu(x @ self.fc1.kernel + self.fc1.bias)
        x = torch.relu(x @ self.fc2.kernel + self.fc2.bias)
        return x @ self.logits.kernel + self.logits.bias
