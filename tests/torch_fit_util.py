"""Fitted weights for the port's serving tests, made from a seed on the
CPU: a fresh-init model has near-tie logits, which int8 and bfloat16
rounding flip, so the parity gates rightly refuse its variants. Each fit
runs on one intra-op thread: under the suite's parallel workers torch's
thread-per-core default oversubscribes the cores, and the same MLP fit
took 110 s instead of 2 s."""

import contextlib

import torch
import torch.nn.functional as F

from distributedmnist_tpu_torch import models
from distributedmnist_tpu_torch.data import synthetic_mnist

# the held-out parity batch's synthetic distribution (serve/quantize.py)
PARITY_SEED = 709


@contextlib.contextmanager
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def fit_params(model: str = "mlp", seed: int = 1, steps: int = 1000,
               lr: float = 0.05) -> dict:
    """`model`'s weights after `steps` steps on the train split of the
    parity batch's distribution: SGD with momentum 0.9 for the MLP
    (tests/test_torch_serve.py's recipe), Adam at 1e-3 for LeNet-5."""
    data = synthetic_mnist(seed=PARITY_SEED, train_n=8192, test_n=16)
    with one_thread():
        net = models.build(model, device="cpu")
        net.load_state_dict(models.init_params(model, seed))
        opt = (torch.optim.SGD(net.parameters(), lr=lr, momentum=0.9)
               if model == "mlp" else
               torch.optim.Adam(net.parameters(), lr=1e-3))
        x = torch.from_numpy(data["train_x"])
        y = torch.from_numpy(data["train_y"]).long()
        g = torch.Generator().manual_seed(seed)
        for _ in range(steps):
            idx = torch.randint(0, x.shape[0], (128,), generator=g)
            loss = F.cross_entropy(net(x[idx].float() / 255.0), y[idx])
            opt.zero_grad()
            loss.backward()
            opt.step()
    return {k: v.detach().clone() for k, v in net.state_dict().items()}


def mlp_flax(params: dict, fused: bool = False) -> dict:
    """The port's MLP params as a flax MLP tree of numpy arrays: the
    nn.Dense layout {'hidden': {'kernel', 'bias'}}, or with `fused` the
    fused-kernel leaves {'hidden_kernel', 'hidden_bias'} (both keep the
    (in, out) kernel: nothing is transposed)."""
    p = {k: v.numpy() for k, v in params.items()}
    if fused:
        tree = {"hidden_kernel": p["hidden_kernel"],
                "hidden_bias": p["hidden_bias"]}
    else:
        tree = {"hidden": {"kernel": p["hidden_kernel"],
                           "bias": p["hidden_bias"]}}
    tree["logits"] = {"kernel": p["logits_kernel"],
                      "bias": p["logits_bias"]}
    return tree
