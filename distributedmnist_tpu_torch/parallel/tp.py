"""Tensor parallelism over the ranks' ('data', 'model') layout — the port
of distributedmnist_tpu/parallel/tp.py.

The JAX package states TP as parameter placement alone: Megatron-style
specs on the dense pair, and XLA's sharding propagation inserts the
collectives. The port keeps the placement rules word for word
(`placements`, over the port's parameter names) and spells out what XLA
inserts: each rank holds only its shard of a sharded parameter (and of
its optimizer state, which mirrors it), and the two collectives of
Megatron's paired layers are explicit autograd Functions over the model
group:

  first kernel  dim 1 sharded   column-parallel: each rank computes its
  its bias      dim 0 sharded   columns; no collective forward
  second kernel dim 0 sharded   row-parallel: each rank's partial
                                product, summed over the model group

- `copy_to_model` (Megatron's f): identity forward, all-reduce of the
  gradient backward. In front of a column-parallel layer whose input
  needs a gradient (LeNet's fc1: the replicated convolutions below it
  must see the sum of every column shard's gradient).
- `reduce_from_model` (g): all-reduce forward, identity backward. After
  a row-parallel product, before its bias.
- `slice_replicated`: a rank's columns of a replicated tensor, whose
  gradient is summed over the model group (a replicated bias beside a
  sharded kernel: the partial fallback).

No DTensor and no torch.distributed.tensor.parallel: their dispatch
would not route the MLP's hidden layer through the dense_relu kernel.
Every collective here is an all_reduce, which gloo takes on CUDA tensors
(ranks sharing a card) and NCCL with a card a rank.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Optional

import torch
import torch.distributed as dist

log = logging.getLogger("distributedmnist_tpu_torch")

# A leaf's placement: the dim sharded over the model axis, or None.
Placement = Optional[int]


def _spec(names: set, ndim: int, column: tuple, row: tuple) -> Placement:
    """The JAX rules' PartitionSpec as a sharded dim: P(None, 'model') ->
    1, P('model') -> 0 for a 1-D leaf, P('model', None) -> 0, P() -> None."""
    if names & set(column):
        return 1 if ndim == 2 else 0
    if names & set(row) and ndim == 2:
        return 0
    return None


def _mlp_rule(names: set, ndim: int) -> Placement:
    # JAX: 'hidden' (its nn.Dense tree) or hidden_kernel/hidden_bias
    # (its fused-kernel leaves, the port's names) are column-parallel,
    # the logits kernel row-parallel
    return _spec(names, ndim, ("hidden", "hidden_kernel", "hidden_bias"),
                 ("logits",))


def _lenet_rule(names: set, ndim: int) -> Placement:
    return _spec(names, ndim, ("fc1",), ("fc2",))


_RULES = {"mlp": _mlp_rule, "lenet": _lenet_rule}


def _path_names(key: str) -> set:
    """The components of a parameter name, as JAX's rules see a pytree
    path: "fc1.kernel" -> {fc1, kernel}; the port's flat MLP names are
    also read as a layer and a leaf: "logits_kernel" -> {logits_kernel,
    logits, kernel}."""
    names = set()
    for part in key.split("."):
        names.add(part)
        for leaf in ("_kernel", "_bias"):
            if part.endswith(leaf):
                names.update((part[:-len(leaf)], leaf[1:]))
    return names


def placements(shapes: dict, model_name: str,
               model_parallel: int) -> dict:
    """{name: sharded dim or None} for parameters {name: shape}: the port
    of JAX's state_shardings. model_parallel 1 (a 1-D mesh): everything
    replicated. Otherwise the model's rules decide; a leaf whose sharded
    dim does not divide by model_parallel falls back to replicated with
    JAX's warning, and if every matched leaf fell back, or none matched,
    the run would silently be pure data parallelism, so that raises."""
    if model_parallel <= 1:
        return dict.fromkeys(shapes)
    rule = _RULES[model_name]
    mp = model_parallel
    matched, fell_back = [], []
    out = {}
    for key, shape in shapes.items():
        dim = rule(_path_names(key), len(shape))
        if dim is not None:
            matched.append(key)
            if shape[dim] % mp:
                fell_back.append(key)
                log.warning(
                    "TP: %s dim %d (size %d) not divisible by "
                    "model_parallel=%d; replicating this leaf",
                    key, dim, shape[dim], mp)
                dim = None
        out[key] = dim
    if not matched:
        raise ValueError(
            f"model_parallel={mp} requested but no parameter of model "
            f"{model_name!r} matched the TP placement rules — the run "
            "would silently execute as pure DP (were layers renamed?)")
    if len(fell_back) == len(matched):
        raise ValueError(
            f"model_parallel={mp} requested but every matched parameter "
            f"fell back to replicated (no sharded dim divisible by {mp}) "
            "— the run would silently execute as pure DP")
    return out


@dataclasses.dataclass(frozen=True)
class TPContext:
    """What a model needs to run its shard: the model group, its size and
    this rank's index in it, and each parameter's placement."""
    group: object
    size: int
    index: int
    placement: dict

    def local_slice(self, n: int) -> slice:
        per = n // self.size
        return slice(self.index * per, (self.index + 1) * per)

    def shard(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's shard of the full tensor `t` of parameter `name`
        (or of a state tensor of its shape): `t` itself if replicated."""
        dim = self.placement.get(name)
        if dim is None or t.dim() <= dim:
            return t
        return t.narrow(dim, self.local_slice(t.shape[dim]).start,
                        t.shape[dim] // self.size).contiguous()

    def gather(self, name: str, t: torch.Tensor, full_shape) -> torch.Tensor:
        """The full tensor of parameter `name` from this rank's shard `t`,
        on every rank of the model group (a collective of the group): each
        rank writes its shard into zeros and the group sums them, so only
        all_reduce is needed."""
        dim = self.placement.get(name)
        if dim is None or t.dim() <= dim:
            return t
        full = torch.zeros(full_shape, dtype=t.dtype, device=t.device)
        full.narrow(dim, self.local_slice(full_shape[dim]).start,
                    t.shape[dim]).copy_(t)
        _all_reduce(full, self.group)
        return full


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """In-place sum over `group`, in float32 for a bfloat16 tensor (the
    sum's own precision, and gloo's reductions are not assured for
    bfloat16)."""
    if t.dtype == torch.bfloat16:
        f = t.float()
        dist.all_reduce(f, group=group)
        t.copy_(f)
    else:
        dist.all_reduce(t, group=group)
    return t


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.clone(), ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SliceReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp, ctx.shape = tp, x.shape
        return x[..., tp.local_slice(x.shape[-1])].contiguous()

    @staticmethod
    def backward(ctx, g):
        full = g.new_zeros(ctx.shape)
        full[..., ctx.tp.local_slice(ctx.shape[-1])] = g
        return _all_reduce(full, ctx.tp.group), None


def copy_to_model(x: torch.Tensor, tp: TPContext) -> torch.Tensor:
    """Megatron's f: identity forward, gradient summed over the group."""
    return _CopyToModel.apply(x, tp.group)


def reduce_from_model(x: torch.Tensor, tp: TPContext) -> torch.Tensor:
    """Megatron's g: the sum over the group forward, identity backward."""
    return _ReduceFromModel.apply(x, tp.group)


def slice_replicated(x: torch.Tensor, tp: TPContext) -> torch.Tensor:
    """This rank's columns of a replicated tensor; its gradient is summed
    over the group."""
    return _SliceReplicated.apply(x, tp)
