"""Carry weights from the JAX package to the port.

A flax MLP or LeNet-5 param tree, given as numpy arrays (or anything
np.asarray takes), becomes the port's parameter dict (a state_dict). Both of the JAX MLP's layouts
are accepted: the nn.Dense tree {'hidden': {'kernel', 'bias'}} and the
fused-kernel leaves {'hidden_kernel', 'hidden_bias'} (the same rule as
the JAX package's serve/quantize.py::_mlp_weights). A flax dense kernel
is (in, out), and so is the port's: nothing is transposed.
"""

from __future__ import annotations

import numpy as np
import torch

from distributedmnist_tpu_torch.models.lenet import LAYERS


def mlp_params_from_flax(params) -> dict:
    """{hidden_kernel, hidden_bias, logits_kernel, logits_bias} float32
    CPU tensors from a flax MLP param tree."""
    if "hidden" in params:
        w1, b1 = params["hidden"]["kernel"], params["hidden"]["bias"]
    else:
        w1, b1 = params["hidden_kernel"], params["hidden_bias"]
    out = {"hidden_kernel": w1, "hidden_bias": b1,
           "logits_kernel": params["logits"]["kernel"],
           "logits_bias": params["logits"]["bias"]}
    return {k: torch.from_numpy(np.array(v, dtype=np.float32))
            for k, v in out.items()}


def lenet_params_from_flax(params) -> dict:
    """{conv1.kernel, conv1.bias, ..., logits.bias} float32 CPU tensors
    from a flax LeNet5 param tree."""
    return {f"{name}.{leaf}": torch.from_numpy(
                np.array(params[name][leaf], dtype=np.float32))
            for name, _, _ in LAYERS for leaf in ("kernel", "bias")}
