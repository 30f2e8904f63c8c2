import torch

from distributedmnist_tpu_torch.models.lenet import LeNet5  # noqa: F401
from distributedmnist_tpu_torch.models.mlp import MLP  # noqa: F401


def build(name: str, device=None):
    """The port's model factory: the 784-128-10 MLP or LeNet-5."""
    if name == "mlp":
        return MLP(device=device)
    if name == "lenet":
        return LeNet5(device=device)
    raise ValueError(f"unknown model {name!r} (expected mlp|lenet)")


def init_params(name: str, seed: int = 0) -> dict:
    """Fresh-init parameters of model `name` as CPU tensors, drawn from a
    CPU torch.Generator seeded with `seed` — the same values whichever
    device they are then moved to."""
    model = build(name, device="cpu")
    model.reset_parameters(torch.Generator(device="cpu").manual_seed(seed))
    return {k: v.detach() for k, v in model.state_dict().items()}
