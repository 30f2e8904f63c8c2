"""Loss and eval math — the port of distributedmnist_tpu/ops/loss.py.

Numerics are float32 whatever the compute dtype: logits are upcast before
the log-softmax, so the loss and the accuracy threshold are not perturbed
by low-precision reductions.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy over the batch with integer labels, in
    f32 (optax.softmax_cross_entropy_with_integer_labels(...).mean())."""
    return F.cross_entropy(logits.float(), labels.long())


def accuracy_count(logits: torch.Tensor, labels: torch.Tensor,
                   valid: torch.Tensor | None = None) -> torch.Tensor:
    """Number of correct predictions, an int32 tensor on the logits'
    device. `valid` is the optional bool mask of the padded-tail eval
    batches (data/loader.eval_batches)."""
    hit = logits.argmax(dim=-1) == labels
    if valid is not None:
        hit = hit & valid
    return hit.sum(dtype=torch.int32)
