"""Device-resident dataset and the seeded per-step index stream — the
port of distributedmnist_tpu/data/loader.py.

The whole train set (47 MB of uint8 pixels at MNIST's size) is copied to
the card once; each step selects its batch there by an index array, and
decodes it (cast, /255) inside the step, so no pixels cross from the
host in the training loop. Batch order is a function of (seed, epoch)
only, the same permutation the JAX package draws: that is what lets the
tests hold the port's loss trajectory against the JAX package's.

Under data parallelism every rank holds the whole dataset (replicated,
as the JAX package replicates it over the mesh: a gather of arbitrary
global indices from a row-sharded dataset would need an all-to-all) and
draws the same global permutation; each copies only its own columns of
every global batch to its device (parallel/mesh.batch_shard). So batch
order stays a function of (seed, epoch) only, and 1 rank computes what N
ranks compute together.
"""

from __future__ import annotations

import numpy as np
import torch

from distributedmnist_tpu_torch.data.packing import pack_rows
from distributedmnist_tpu_torch.parallel.mesh import batch_shard


class DeviceDataset:
    """Train and test arrays on `device`: pixels as uint8 images (or,
    with pixel_format "packed", as (N, 196) int32 words, 4 pixels a
    word), labels as int64 (what torch's cross-entropy takes)."""

    def __init__(self, data: dict, device, device_resident_train: bool = True,
                 pixel_format: str = "u8"):
        if pixel_format not in ("u8", "packed"):
            raise ValueError(f"unknown pixel format {pixel_format!r} "
                             "(expected 'u8' or 'packed')")
        self.device = torch.device(device)
        self.source = data.get("source", "unknown")
        self.pixel_format = pixel_format
        if device_resident_train:
            train_x = data["train_x"]
            if pixel_format == "packed":
                train_x = pack_rows(train_x)
            self.train_x = self._put(train_x)
            self.train_y = self._put(data["train_y"]).long()
        else:
            self.train_x = None
            self.train_y = None
        self.test_x = self._put(data["test_x"])
        self.test_y = self._put(data["test_y"]).long()
        self.train_n = int(data["train_x"].shape[0])
        self.test_n = int(data["test_x"].shape[0])

    def _put(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)


class IndexStream:
    """Seeded stream of batch index arrays.

    Epochs work like a shuffling DataLoader with drop_last=True: each
    epoch is a fresh permutation of the train set drawn from
    np.random.default_rng(SeedSequence([seed, epoch])), cut into
    batches. `start_step` resumes the stream where a checkpoint left it.
    """

    def __init__(self, train_n: int, global_batch: int, seed: int,
                 start_step: int = 0):
        if global_batch > train_n:
            raise ValueError(
                f"global batch {global_batch} > dataset {train_n}")
        self.train_n = train_n
        self.global_batch = global_batch
        self.seed = seed
        self.steps_per_epoch = train_n // global_batch
        self.step = start_step
        self._perm_cache: tuple[int, np.ndarray] | None = None

    def _epoch_perm(self, epoch: int) -> np.ndarray:
        # one permutation an epoch, not one a step
        if self._perm_cache is None or self._perm_cache[0] != epoch:
            perm = np.random.default_rng(
                np.random.SeedSequence([self.seed, epoch])
            ).permutation(self.train_n)
            self._perm_cache = (epoch, perm)
        return self._perm_cache[1]

    def indices_for_step(self, step: int) -> np.ndarray:
        epoch, k = divmod(step, self.steps_per_epoch)
        perm = self._epoch_perm(epoch)
        return perm[k * self.global_batch:(k + 1) * self.global_batch]

    def host_block(self, k: int) -> np.ndarray:
        """(k, global_batch) int32 indices for the next k steps; advances
        the stream."""
        idx = np.stack([self.indices_for_step(self.step + i)
                        for i in range(k)]).astype(np.int32)
        self.step += k
        return idx

    def next_block(self, k: int, device, rank: int = 0,
                   world: int = 1) -> torch.Tensor:
        """The next k steps' indices as one (k, global_batch / world)
        int64 tensor on `device`: rank `rank`'s columns of each global
        batch, in one host-to-device copy per block of steps. To the card
        it goes from pinned memory without waiting: a copy from pageable
        memory would wait for everything queued on the stream before
        it."""
        cols = batch_shard(self.global_batch, rank, world)
        idx = torch.from_numpy(
            self.host_block(k)[:, cols].astype(np.int64))
        if torch.device(device).type == "cuda":
            return idx.pin_memory().to(device, non_blocking=True)
        return idx


def eval_batches(test_n: int, batch: int) -> tuple[np.ndarray, np.ndarray]:
    """Index matrix (n_batches, batch) covering the test set, and a bool
    mask of the same shape; the tail's padding (index 0 repeated) is
    masked False, so it never enters the accuracy count."""
    n_batches = (test_n + batch - 1) // batch
    pos = np.arange(n_batches * batch).reshape(n_batches, batch)
    mask = pos < test_n
    idx = np.where(mask, pos, 0).astype(np.int32)
    return idx, mask
