"""LeNet-5 in plain PyTorch, float32: forward, loss, backward and Adam,
the benchmark's reference for the port's models/lenet.py, trainer step
and optimizer.

The network (LeCun et al. 1998, as the port and the JAX package have
it): conv 5x5x6 SAME, relu, 2x2 average pool; conv 5x5x16 VALID, relu,
2x2 average pool; dense 400->120, relu; dense 120->84, relu; dense
84->10. Departures from the model file, each computing the same
function in another way:

- a convolution is each output pixel's patch, cut from the padded
  NHWC input by sliding windows, times the kernel, a batched matmul of
  one row a batch (the model calls F.conv2d, which cuDNN runs); the
  flatten before fc1 is of NHWC, as in the model;
- a pool is a reshape and a mean (the model calls F.avg_pool2d);
- the loss is log-sum-exp minus the label's logit, averaged, written
  out (the model calls F.cross_entropy);
- Adam is written out (torch.optim.Adam's formula: eps outside the
  square root, bias corrections at step t), with the gradient taken by
  autograd;
- a batch is computed in blocks of rows, each block's loss weighted by
  its share of the batch, so that a large batch fits; the sum is the
  batch mean.

Parameters use the port's names and layout (kernels HWIO or (in, out)).
`numerics(tf32=True)` runs the same code in TF32, the precision below
the configuration's float32 with TF32 off: the control. Given float64
parameters the same code runs in float64, a witness of how far each
float32 side lies from the exact result.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

# (name, kernel shape, bias width), in the model's parameter order
LAYERS = (("conv1", (5, 5, 1, 6), 6),
          ("conv2", (5, 5, 6, 16), 16),
          ("fc1", (400, 120), 120),
          ("fc2", (120, 84), 84),
          ("logits", (84, 10), 10))
NAMES = tuple(f"{n}.{p}" for n, _, _ in LAYERS for p in ("kernel", "bias"))
ROW_BLOCK = 16384


@contextlib.contextmanager
def numerics(tf32: bool = False):
    """float32 with TF32 off (the reference), or on (the control), for
    matmuls and cuDNN alike; restored after."""
    mods = (torch.backends.cuda.matmul, torch.backends.cudnn)
    saved = [m.allow_tf32 for m in mods]
    for m in mods:
        m.allow_tf32 = tf32
    try:
        yield
    finally:
        for m, s in zip(mods, saved):
            m.allow_tf32 = s


def conv(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
         pad: int) -> torch.Tensor:
    """x (B, H, W, C), kernel (kh, kw, C, F) -> (B, H', W', F), stride 1:
    each output pixel's patch, taken by sliding windows over the padded
    input, times the kernel, one matmul a row (so that the kernel's
    gradient sums each row's product, not one dot product over every
    pixel of the batch)."""
    b, h, w, cin = x.shape
    kh, kw, _, feat = kernel.shape
    ho, wo = h + 2 * pad - kh + 1, w + 2 * pad - kw + 1
    xp = F.pad(x, (0, 0, pad, pad, pad, pad))
    cols = xp.unfold(1, kh, 1).unfold(2, kw, 1)       # (B, H', W', C, kh, kw)
    cols = cols.reshape(b, ho * wo, cin * kh * kw)
    wmat = kernel.permute(2, 0, 1, 3).reshape(cin * kh * kw, feat)
    out = torch.bmm(cols, wmat.expand(b, -1, -1)) + bias
    return out.reshape(b, ho, wo, feat)


def pool(x: torch.Tensor) -> torch.Tensor:
    b, h, w, c = x.shape
    return x.reshape(b, h // 2, 2, w // 2, 2, c).mean(dim=(2, 4))


def forward(params: dict, x_u8: torch.Tensor) -> torch.Tensor:
    """Logits (B, 10) of uint8 images (B, 28, 28, 1), in the parameters'
    dtype."""
    dt = params["conv1.kernel"].dtype
    x = x_u8.to(dt) / torch.tensor(255.0, dtype=dt, device=x_u8.device)
    x = pool(torch.relu(conv(x, params["conv1.kernel"],
                             params["conv1.bias"], 2)))
    x = pool(torch.relu(conv(x, params["conv2.kernel"],
                             params["conv2.bias"], 0)))
    x = x.reshape(x.shape[0], -1)                     # NHWC flatten, 400
    x = torch.relu(x @ params["fc1.kernel"] + params["fc1.bias"])
    x = torch.relu(x @ params["fc2.kernel"] + params["fc2.bias"])
    return x @ params["logits.kernel"] + params["logits.bias"]


def loss_sum(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The sum over rows of the softmax cross-entropy."""
    picked = logits.gather(1, labels[:, None].long())[:, 0]
    return (torch.logsumexp(logits, dim=1) - picked).sum()


def logits(params: dict, x_u8: torch.Tensor) -> torch.Tensor:
    """Forward over any number of rows, in blocks, without gradients."""
    with torch.no_grad():
        return torch.cat([forward(params, x_u8[i:i + ROW_BLOCK])
                          for i in range(0, x_u8.shape[0], ROW_BLOCK)])


def loss_and_grads(params: dict, x_u8: torch.Tensor, labels: torch.Tensor
                   ) -> tuple[float, dict]:
    """The batch's mean loss and its gradient with respect to each
    parameter."""
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in params.items()}
    n = x_u8.shape[0]
    total = torch.zeros((), dtype=params["conv1.kernel"].dtype,
                        device=x_u8.device)
    for i in range(0, n, ROW_BLOCK):
        part = loss_sum(forward(leaves, x_u8[i:i + ROW_BLOCK]),
                        labels[i:i + ROW_BLOCK]) / n
        part.backward()
        total += part.detach()
    return float(total), {k: v.grad.detach() for k, v in leaves.items()}


def adam_run(params: dict, batches, lr: float = 1e-3,
             betas=(0.9, 0.999), eps: float = 1e-8) -> dict:
    """Adam over `batches`, a list of (uint8 images, labels): the loss of
    each step, the gradient of the first, and the parameters after the
    last."""
    b1, b2 = betas
    p = {k: v.detach().clone() for k, v in params.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    losses, first = [], None
    for t, (x, y) in enumerate(batches, start=1):
        loss, g = loss_and_grads(p, x, y)
        losses.append(loss)
        if first is None:
            first = g
        for k in p:
            m[k] = b1 * m[k] + (1 - b1) * g[k]
            v2[k] = b2 * v2[k] + (1 - b2) * g[k] * g[k]
            mhat = m[k] / (1 - b1 ** t)
            vhat = v2[k] / (1 - b2 ** t)
            p[k] = p[k] - lr * mhat / (vhat.sqrt() + eps)
    return {"losses": losses, "grads": first, "params": p}
