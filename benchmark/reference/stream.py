"""The batch order of the port's training loop, worked out again: a
frozen copy of the index-stream arithmetic (the port's
data/loader.IndexStream, itself the JAX package's).

Epochs are permutations of the train set, one an epoch, drawn from
np.random.default_rng(SeedSequence([seed, epoch])) and cut into whole
global batches (a short tail is dropped). Step k of the run is batch
k mod steps_per_epoch of epoch k // steps_per_epoch.
"""

from __future__ import annotations

import functools

import numpy as np


@functools.lru_cache(maxsize=2)
def _permutation(train_n: int, seed: int, epoch: int) -> np.ndarray:
    perm = np.random.default_rng(
        np.random.SeedSequence([seed, epoch])).permutation(train_n)
    perm.flags.writeable = False
    return perm


def batch_indices(train_n: int, global_batch: int, seed: int,
                  step: int) -> np.ndarray:
    steps_per_epoch = train_n // global_batch
    epoch, k = divmod(step, steps_per_epoch)
    perm = _permutation(train_n, seed, epoch)
    return perm[k * global_batch:(k + 1) * global_batch].copy()
