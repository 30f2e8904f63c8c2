"""Process groups — the port of distributedmnist_tpu/parallel/distributed.py.

A JAX process drives every local chip through one mesh, and the
processes of a multi-host run meet in `jax.distributed.initialize`. The
port runs one process (a rank) per device, joined by torch.distributed:

- Single host, N ranks (configs 3-4): the train CLI starts them itself
  (parallel/launch.py) and hands each the torchrun environment
  (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK, LOCAL_RANK,
  LOCAL_WORLD_SIZE). torchrun's own environment works the same way.
- Multi-host (config 5): every rank is started with the JAX flags
  --coordinator-address HOST:PORT --num-processes N --process-id I.

The rendezvous is a TCPStore at the coordinator (rank 0 serves it).
Through it each rank learns every rank's host and card count before the
process group exists, so the backend is fixed from the topology and
never chosen after a failure: NCCL when the device is CUDA and no host
has more ranks than cards; gloo on the CPU, and when ranks share a card
(NCCL refuses two ranks on one device; gloo's all_reduce and broadcast
take CUDA tensors through the host). The group gets a timeout, so a
missing rank fails the run instead of hanging it.

The JAX package's `put_global`/`put_replicated` have no counterpart:
each rank places its own tensors on its own device, and a global array
is only ever the same host array on every rank, sliced by rank.
"""

from __future__ import annotations

import collections
import dataclasses
import datetime
import json
import logging
import os
import socket
from typing import Optional

import torch
import torch.distributed as dist

from distributedmnist_tpu_torch.parallel.launch import LAUNCH_ENV

log = logging.getLogger("distributedmnist_tpu_torch")

# how long a rank waits for the others (rendezvous and every collective)
TIMEOUT = datetime.timedelta(seconds=120)


@dataclasses.dataclass(frozen=True)
class Topology:
    rank: int
    world: int
    local_rank: int      # index among the ranks on this host
    backend: str
    multihost: bool


# The topology of the process group this module initialized: the group
# itself is process-global state of torch.distributed, and so is this.
_live: Optional[Topology] = None


def backend_for(device_type: str, hosts: list[tuple[str, int]]) -> str:
    """The backend for ranks whose (host, cards on it) are `hosts`, one
    entry a rank: NCCL for CUDA when no host has more ranks than cards,
    else gloo."""
    if device_type != "cuda":
        return "gloo"
    ranks_on = collections.Counter(h for h, _ in hosts)
    cards_on = dict(hosts)
    if all(n <= cards_on[h] for h, n in ranks_on.items()):
        return "nccl"
    return "gloo"


def cards_in_use(hosts: list[tuple[str, int]]) -> int:
    """The cards that ranks whose (host, cards on it) are `hosts`, one
    entry a rank, run on: on each host, the fewer of its ranks and its
    cards (rank LOCAL_RANK takes card LOCAL_RANK modulo the cards)."""
    ranks_on = collections.Counter(h for h, _ in hosts)
    cards_on = dict(hosts)
    return sum(min(n, cards_on[h]) for h, n in ranks_on.items())


def _launch_env() -> Optional[tuple[str, int, int]]:
    """(coordinator address, world, rank) from a launcher's environment,
    or None outside one (or in a launch of one rank)."""
    env = os.environ
    if not all(k in env for k in LAUNCH_ENV) or int(env["WORLD_SIZE"]) < 2:
        return None
    return (f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}",
            int(env["WORLD_SIZE"]), int(env["RANK"]))


def maybe_initialize(coordinator_address: Optional[str],
                     num_processes: Optional[int],
                     process_id: Optional[int],
                     device_type: str = "cpu") -> bool:
    """Join the process group iff the coordinator flags, or a launcher's
    environment, say there is one. Returns True when running multi-host
    (coordinator flags, as in the JAX package, or a launch over more
    hosts than this one).

    A second fit() in a process whose group is live (back-to-back
    workloads in one worker) reuses that group ONLY when the requested
    topology matches it; a mismatch raises ValueError: silently reusing
    a different topology would be a bug, not a reconnect."""
    if dist.is_initialized():
        have = topology()
        for name, want, got in (("num_processes", num_processes, have.world),
                                ("process_id", process_id, have.rank)):
            if want is not None and want != got:
                raise ValueError(
                    f"torch.distributed already initialized with "
                    f"{name}={got}; this run asked for {name}={want} — "
                    "refusing to silently reuse a process group with a "
                    "different topology")
        return have.multihost
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("--coordinator-address needs --num-processes "
                             "and --process-id")
        _rendezvous(coordinator_address, num_processes, process_id,
                    device_type, multihost=True)
        return True
    launched = _launch_env()
    if launched is None:
        return False
    address, world, rank = launched
    _rendezvous(address, world, rank, device_type, multihost=None)
    return _live.multihost


def _rendezvous(address: str, world: int, rank: int, device_type: str,
                multihost: Optional[bool]) -> None:
    global _live
    if not 0 <= rank < world:
        raise ValueError(f"process_id {rank} out of range for "
                         f"num_processes={world}")
    host, port = address.rsplit(":", 1)
    store = dist.TCPStore(host, int(port), world, is_master=rank == 0,
                          timeout=TIMEOUT)
    cards = torch.cuda.device_count() if device_type == "cuda" else 0
    store.set(f"host/{rank}", json.dumps([socket.gethostname(), cards]))
    hosts = [tuple(json.loads(store.get(f"host/{r}"))) for r in range(world)]
    mine = [r for r in range(world) if hosts[r][0] == hosts[rank][0]]
    local_rank = int(os.environ.get("LOCAL_RANK", mine.index(rank)))
    backend = backend_for(device_type, hosts)
    dist.init_process_group(backend, store=store, world_size=world,
                            rank=rank, timeout=TIMEOUT)
    n_hosts = len({h for h, _ in hosts})
    _live = Topology(rank, world, local_rank, backend,
                     n_hosts > 1 if multihost is None else multihost)
    if rank == 0:
        log.info("dist: backend %s, %d ranks on %d card(s)", backend, world,
                 cards_in_use(hosts))


def topology() -> Topology:
    """This process's place in the live group (one rank of one, outside
    a group). A group initialized by the caller, not here, is read from
    the launcher's LOCAL_RANK/LOCAL_WORLD_SIZE."""
    if not dist.is_initialized():
        return Topology(0, 1, 0, "none", False)
    if _live is not None:
        return _live
    world, rank = dist.get_world_size(), dist.get_rank()
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    return Topology(rank, world, int(os.environ.get("LOCAL_RANK", rank)),
                    dist.get_backend(), local_world < world)


def shutdown() -> None:
    """Destroy the process group, if this process has one."""
    global _live
    if dist.is_initialized():
        dist.destroy_process_group()
    _live = None


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def agree_max(value: int, device) -> int:
    """Cross-rank max of a per-rank int (the trainer's preemption-flag
    agreement, and a barrier): all_reduce(MAX) of a one-element tensor
    on the rank's device. Outside a process group: the value itself."""
    return _all_reduce_int(value, device, dist.ReduceOp.MAX)


def all_sum(value: int, device) -> int:
    """Sum of a per-rank int over the ranks (the value itself outside a
    process group)."""
    return _all_reduce_int(value, device, dist.ReduceOp.SUM)


def max_float(value: float, device) -> float:
    """Max of a per-rank float over the ranks (the bench's window
    seconds: the slowest rank's), the value itself outside a process
    group."""
    if not dist.is_initialized():
        return float(value)
    t = torch.tensor([value], dtype=torch.float64, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return float(t.item())


def _all_reduce_int(value: int, device, op) -> int:
    if not dist.is_initialized():
        return int(value)
    t = torch.tensor([value], dtype=torch.int32, device=device)
    dist.all_reduce(t, op=op)
    return int(t.item())


def broadcast_object(obj, device):
    """Rank 0's `obj` (any picklable value), on every rank."""
    if not dist.is_initialized():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0, device=device)
    return box[0]


def broadcast_int(value: int, device) -> int:
    """Rank 0's `value`, on every rank."""
    if not dist.is_initialized():
        return int(value)
    t = torch.tensor([value], dtype=torch.int64, device=device)
    dist.broadcast(t, src=0)
    return int(t.item())
