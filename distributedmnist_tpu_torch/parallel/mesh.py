"""A rank's device and its slice of a global batch — the port of
distributedmnist_tpu/parallel/mesh.py.

The JAX package builds one ('data',) mesh over every chip a process
sees, and shards the batch axis of each global array over it. The port
runs one rank per device (parallel/distributed.py), so there is no mesh
object: a rank holds one device, and the 'data' sharding of a global
batch becomes the rank's contiguous column slice of it, the block
`[r*B/n, (r+1)*B/n)` that `P('data')` puts on device r of n.

Serving is the exception: one process serves over a group of cards, as
the JAX engine shards each batch over its whole 'data' mesh.
`get_devices` is that group (JAX's get_devices) and `place_replicas`
cuts it among a fleet's replicas by the JAX registry's rule.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from distributedmnist_tpu_torch.parallel import distributed
from distributedmnist_tpu_torch.utils.device import resolve_device

START_HINT = (
    "start one rank per device: the train CLI with --num-devices N "
    "(python -m distributedmnist_tpu_torch.train), or each rank with "
    "--coordinator-address HOST:PORT --num-processes N --process-id I")


def get_device(device: str = "cuda",
               num_devices: Optional[int] = None) -> torch.device:
    """This rank's device. On CUDA, card LOCAL_RANK modulo the cards
    visible (ranks on one host beyond its cards share them), made the
    current card. `num_devices` must be the world size when given
    (None = every rank of the group, or 1 outside a group)."""
    dev = resolve_device(device)
    world = distributed.process_count()
    if num_devices is not None:
        if num_devices < 1:
            raise ValueError(f"num_devices must be >= 1, got {num_devices}")
        if num_devices > 1 and not torch.distributed.is_initialized():
            raise ValueError(
                f"num_devices={num_devices} needs {num_devices} ranks, and "
                f"this process is not in a process group: {START_HINT}")
        if num_devices > world:
            raise RuntimeError(
                f"requested {num_devices} devices, only {world} visible "
                f"(hint: {START_HINT})")
        if num_devices < world:
            raise ValueError(
                f"requested {num_devices} devices, but the process group "
                f"has {world} ranks, one device each")
    if dev.type == "cuda":
        dev = torch.device("cuda", distributed.topology().local_rank
                           % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    return dev


def get_devices(device: str = "cuda",
                num_devices: Optional[int] = None) -> list[torch.device]:
    """The devices one serving process runs over: the first `num_devices`
    visible cards, or every one of them by default; on the cpu, the one
    CPU device. Asking for more than are visible raises, in the JAX
    package's words; nothing falls back to fewer."""
    dev = resolve_device(device)
    visible = ([torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
               if dev.type == "cuda" else [dev])
    if num_devices is None:
        return visible
    if num_devices < 1:
        raise ValueError(f"num_devices must be >= 1, got {num_devices}")
    if num_devices > len(visible):
        raise RuntimeError(
            f"requested {num_devices} devices, only {len(visible)} visible "
            f"(on the {dev.type}; CUDA_VISIBLE_DEVICES limits the cards)")
    return visible[:num_devices]


def place_replicas(devices: Sequence, replicas: int) -> list[list]:
    """Each of `replicas` fleet replicas' devices, by the JAX registry's
    rule: with N devices, N >= replicas and N % replicas == 0, replica i
    takes the equal slice `devices[i*N/R:(i+1)*N/R]`; otherwise every
    replica is a logical replica over all N."""
    if replicas < 1:
        raise ValueError(f"replicas must be >= 1, got {replicas}")
    devices = list(devices)
    n = len(devices)
    if replicas > 1 and n >= replicas and n % replicas == 0:
        k = n // replicas
        return [devices[i * k:(i + 1) * k] for i in range(replicas)]
    return [list(devices) for _ in range(replicas)]


def chip_count(dev: torch.device) -> int:
    """The distinct devices the group's ranks run on: the summary's
    n_chips, the size of the JAX package's mesh. A rank on the cpu is a
    device of its own; ranks that share a card (more ranks on a host than
    cards, over gloo) count it once, through its first rank, the one
    whose local rank is below the host's card count. 1 outside a group."""
    if not torch.distributed.is_initialized():
        return 1
    first = (dev.type != "cuda" or distributed.topology().local_rank
             < torch.cuda.device_count())
    return distributed.all_sum(int(first), dev)


def batch_shard(global_batch: int, rank: int, world: int) -> slice:
    """The columns of a global batch that rank `rank` of `world` holds:
    what `batch_sharded` gives device `rank` of a ('data',) mesh."""
    if global_batch % world:
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"{world} ranks")
    per = global_batch // world
    return slice(rank * per, (rank + 1) * per)


@dataclasses.dataclass(frozen=True)
class RankMesh:
    """The ranks of a run as JAX's mesh lays out its devices: a 1-D
    ('data',) mesh, or with model_parallel > 1 a ('data', 'model') mesh
    of shape (world // mp, mp) whose row d holds ranks d*mp .. d*mp+mp-1."""
    world: int
    model_parallel: int = 1

    @property
    def dp(self) -> int:
        return self.world // self.model_parallel

    def data_index(self, rank: int) -> int:
        return rank // self.model_parallel

    def model_index(self, rank: int) -> int:
        return rank % self.model_parallel

    def data_ranks(self, model_index: int) -> list[int]:
        """The ranks that hold the same model shard: one data group."""
        return [d * self.model_parallel + model_index
                for d in range(self.dp)]

    def model_ranks(self, data_index: int) -> list[int]:
        """The ranks that see the same rows: one model group."""
        mp = self.model_parallel
        return list(range(data_index * mp, (data_index + 1) * mp))


def make_mesh(world: int, model_parallel: int = 1) -> RankMesh:
    """The rank layout of JAX's make_mesh(devices, model_parallel), with
    its error for an indivisible size."""
    if model_parallel > 1 and world % model_parallel:
        raise ValueError(f"{world} devices not divisible by "
                         f"model_parallel={model_parallel}")
    return RankMesh(world, max(1, model_parallel))


@dataclasses.dataclass(frozen=True)
class Groups:
    """This rank's place in a RankMesh and its two process groups: the
    data group (the ranks holding its model shard; None = the whole
    world) and the model group (the ranks seeing its rows; None without
    tensor parallelism)."""
    mesh: RankMesh
    rank: int
    data: Optional[object] = None
    model: Optional[object] = None

    @property
    def data_index(self) -> int:
        return self.mesh.data_index(self.rank)

    @property
    def model_index(self) -> int:
        return self.mesh.model_index(self.rank)


def process_groups(mesh: RankMesh, rank: int) -> Groups:
    """This rank's groups of `mesh`. Every rank builds every group, in the
    same order (torch.distributed.new_group is a collective of the whole
    world): the data groups by model index, then the model groups by
    data index. Without tensor parallelism no group is built: the data
    group is the world."""
    if mesh.model_parallel <= 1:
        return Groups(mesh, rank)
    data = model = None
    for m in range(mesh.model_parallel):
        g = torch.distributed.new_group(mesh.data_ranks(m))
        if mesh.model_index(rank) == m:
            data = g
    for d in range(mesh.dp):
        g = torch.distributed.new_group(mesh.model_ranks(d))
        if mesh.data_index(rank) == d:
            model = g
    return Groups(mesh, rank, data, model)
