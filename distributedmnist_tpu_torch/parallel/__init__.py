"""Data and tensor parallelism: one rank per device over
torch.distributed — the port of distributedmnist_tpu/parallel/. `mesh`
lays the ranks out as JAX's ('data', 'model') mesh and builds their
process groups; `tp` holds the tensor-parallel placement rules and
collectives; `launch` starts N local ranks of a command; `mh_smoke` is
one rank of a small localhost run.

`mesh`'s names below load at their first use, so a launcher (the train
CLI's or the bench's) given its rank count with --num-devices imports
no torch before it starts its ranks; without the flag, counting the
visible cards (`launch.local_ranks`) imports it."""

_MESH_NAMES = ("batch_shard", "chip_count", "get_device")


def __getattr__(name):
    if name in _MESH_NAMES:
        from distributedmnist_tpu_torch.parallel import mesh
        return getattr(mesh, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
