"""Inputs and weights made from `--seed`, on the device, in a few large
calls of a torch.Generator there. The same seed gives the same values
on every card of one kind, so every rank of a run, and the reference
after it, make the same ones.

The images follow the recipe of the port's synthetic MNIST
(data/mnist.synthetic_mnist): ten smooth class templates, each sample
its class's template shifted by up to +-3 px with Gaussian pixel noise
of scale 0.44, clipped and quantised to uint8. The draws are the
benchmark's own, made on the device.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.lenet5 import LAYERS

NUM_CLASSES = 10
# keeps the weights' and the images' generators apart at one seed
_WEIGHT_STREAM = 0x9E3779B97F4A7C15
_MASK64 = (1 << 64) - 1


def generator(seed: int, device, stream: int = 0) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        (int(seed) + stream) & _MASK64)


def _templates(g: torch.Generator, device) -> torch.Tensor:
    low = torch.randn(NUM_CLASSES, 7, 7, generator=g, device=device)
    t = low.repeat_interleave(4, 1).repeat_interleave(4, 2)[:, None]
    t = F.avg_pool2d(F.pad(t, (1, 1, 1, 1), mode="replicate"), 3,
                     stride=1)[:, 0]                       # 3x3 box blur
    t = t - t.amin(dim=(1, 2), keepdim=True)
    return t / (t.amax(dim=(1, 2), keepdim=True) + 1e-9)


def images(g: torch.Generator, templates: torch.Tensor, n: int,
           noise: float = 0.44, jitter: int = 3
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """(n, 28, 28, 1) uint8 images and their (n,) int64 labels."""
    device = templates.device
    y = torch.randint(0, NUM_CLASSES, (n,), generator=g, device=device)
    sx, sy = torch.randint(-jitter, jitter + 1, (2, n), generator=g,
                           device=device)
    ar = torch.arange(28, device=device)
    ii = (ar[None, :] - sx[:, None]) % 28        # np.roll along rows
    jj = (ar[None, :] - sy[:, None]) % 28        # and along columns
    x = templates[y[:, None, None], ii[:, :, None], jj[:, None, :]]
    x = x + noise * torch.randn(x.shape, generator=g, device=device)
    x = (x.clamp(0.0, 1.0) * 255).to(torch.uint8)
    return x[..., None], y


def mnist_tensors(seed: int, device, train_n: int = 60_000,
                  test_n: int = 10_000) -> dict:
    """The data set on `device`: uint8 (n, 28, 28, 1) images and int64
    labels."""
    g = generator(seed, device)
    t = _templates(g, device)
    train_x, train_y = images(g, t, train_n)
    test_x, test_y = images(g, t, test_n)
    return {"train_x": train_x, "train_y": train_y, "test_x": test_x,
            "test_y": test_y}


def mnist(seed: int, device, train_n: int = 60_000,
          test_n: int = 10_000) -> dict:
    """The data set as the trainer takes it: uint8 (n, 28, 28, 1) images
    and int32 labels, as numpy arrays on the host."""
    d = mnist_tensors(seed, device, train_n, test_n)
    out = {k: v.cpu().numpy() for k, v in d.items()}
    for k in ("train_y", "test_y"):
        out[k] = out[k].astype(np.int32)
    out["source"] = "synthetic"
    return out


def lenet_params(seed: int, device) -> dict:
    """LeNet-5's parameters under the port's names (flax's layout:
    kernels HWIO or (in, out)), float32 on `device`: one normal draw for
    all of them, kernels scaled by 1/sqrt(fan_in) (LeCun normal), biases
    by 0.01 so that they are not all zero."""
    sizes = []
    for name, shape, width in LAYERS:
        sizes += [(f"{name}.kernel", shape), (f"{name}.bias", (width,))]
    total = sum(int(np.prod(s)) for _, s in sizes)
    flat = torch.randn(total, generator=generator(seed, device,
                                                  _WEIGHT_STREAM),
                       device=device)
    out, off = {}, 0
    for key, shape in sizes:
        n = int(np.prod(shape))
        scale = (1.0 / np.sqrt(np.prod(shape[:-1]))
                 if key.endswith("kernel") else 0.01)
        out[key] = (flat[off:off + n] * scale).reshape(shape)
        off += n
    return out
