"""Faults planted under the timed path, to show that the comparison
catches them (test_bm_faults.py on the CPU; calibrate.py's fault seeds
on the card, where a fault's reading bounds a limit from above).

- unchanged: the optimizer step returns the parameters it was given
  (its moments still move);
- half_batch: the loss is the mean over the first half of the batch;
  the rest is left out;
- no_exchange: the ranks skip DDP, so no gradient crosses between
  chips;
- stale_block: every step of a block of more than one step trains on
  the block's first batch, as a replay whose input was never refreshed
  would;
- jax_loaded: a module named jax appears in the process, as if the port
  had loaded it (the run must then print no result).
"""

from __future__ import annotations

import contextlib
import sys
import types

FAULTS = ("unchanged", "half_batch", "no_exchange", "stale_block",
          "jax_loaded")


def plant(name: str, patch=setattr) -> None:
    """Plant fault `name` in this process. `patch(obj, attr, value)` is
    setattr, or a test's monkeypatch.setattr so that it is undone."""
    import torch

    from distributedmnist_tpu_torch import trainer

    if name == "unchanged":
        step = torch.optim.Adam.step

        def unchanged(self, *a, **kw):
            params = [p for g in self.param_groups for p in g["params"]]
            before = [p.detach().clone() for p in params]
            out = step(self, *a, **kw)
            with torch.no_grad():
                for p, b in zip(params, before):
                    p.copy_(b)
            return out
        patch(torch.optim.Adam, "step", unchanged)
    elif name == "half_batch":
        ce = trainer.cross_entropy

        def half(logits, labels):
            n = logits.shape[0] // 2
            return ce(logits[:n], labels[:n])
        patch(trainer, "cross_entropy", half)
    elif name == "no_exchange":
        patch(trainer, "_wrap", lambda model, *a, **kw: (model, None))
    elif name == "stale_block":
        from distributedmnist_tpu_torch.data.loader import IndexStream

        next_block = IndexStream.next_block

        def stale(self, k, *a, **kw):
            idx = next_block(self, k, *a, **kw)
            return idx[:1].expand_as(idx).contiguous()
        patch(IndexStream, "next_block", stale)
    elif name == "jax_loaded":
        sys.modules.setdefault("jax", types.ModuleType("jax"))
    else:
        raise ValueError(f"unknown fault {name!r} (expected one of "
                         f"{FAULTS})")


@contextlib.contextmanager
def planted(name: str):
    """Fault `name` planted for the body of the `with` alone."""
    undo = []

    def patch(obj, attr, value):
        undo.append((obj, attr, getattr(obj, attr)))
        setattr(obj, attr, value)
    plant(name, patch)
    try:
        yield
    finally:
        for obj, attr, value in reversed(undo):
            setattr(obj, attr, value)
