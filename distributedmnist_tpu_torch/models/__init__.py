import torch

from distributedmnist_tpu_torch.models.lenet import LeNet5  # noqa: F401
from distributedmnist_tpu_torch.models.mlp import MLP  # noqa: F401
from distributedmnist_tpu_torch.ops import conv as conv_lib

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
FUSED_MODES = ("auto", "pallas", "xla")


def build(name: str, dtype=torch.float32, fused: str = "auto",
          conv: str = "auto", device=None, tp=None):
    """The port's model factory, the counterpart of the JAX package's
    models.build: the 784-128-10 MLP or LeNet-5, computing in `dtype` (a
    torch dtype or its name). `fused` is the MLP's hidden layer: auto or
    pallas = the dense_relu kernel (its plain version on the cpu), xla =
    plain torch; `conv` is LeNet's convolutions (ops/conv.resolve: auto
    is lax). `tp`, a parallel.tp.TPContext, makes the model this rank's
    shard of a tensor-parallel one."""
    dtype = DTYPES.get(dtype, dtype)
    if fused not in FUSED_MODES:
        raise ValueError(f"unknown fused-kernel mode {fused!r}")
    if name == "mlp":
        return MLP(device=device, dtype=dtype, kernel=fused != "xla", tp=tp)
    if name == "lenet":
        return LeNet5(device=device, dtype=dtype,
                      conv_impl=conv_lib.resolve(conv), tp=tp)
    raise ValueError(f"unknown model {name!r} (expected mlp|lenet)")


def full_shapes(name: str) -> dict:
    """{parameter name: full shape} of model `name` (any rank's shard is
    cut from these)."""
    if name == "mlp":
        from distributedmnist_tpu_torch.models.mlp import full_shapes
        return full_shapes()
    if name == "lenet":
        from distributedmnist_tpu_torch.models.lenet import full_shapes
        return full_shapes()
    raise ValueError(f"unknown model {name!r} (expected mlp|lenet)")


def init_params(name: str, seed: int = 0) -> dict:
    """Fresh-init parameters of model `name` as float32 CPU tensors, drawn
    from a CPU torch.Generator seeded with `seed` — the same values
    whichever device, dtype or shard they are then moved to."""
    model = build(name, device="cpu")
    model.reset_parameters(torch.Generator(device="cpu").manual_seed(seed))
    return {k: v.detach() for k, v in model.state_dict().items()}
