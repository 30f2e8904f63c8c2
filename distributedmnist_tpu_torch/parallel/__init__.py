"""Data and tensor parallelism: one rank per device over
torch.distributed — the port of distributedmnist_tpu/parallel/. `mesh`
lays the ranks out as JAX's ('data', 'model') mesh and builds their
process groups; `tp` holds the tensor-parallel placement rules and
collectives; `launch` starts N local ranks of a command; `mh_smoke` is
one rank of a small localhost run."""

from distributedmnist_tpu_torch.parallel.mesh import (  # noqa: F401
    batch_shard,
    chip_count,
    get_device,
)
from distributedmnist_tpu_torch.parallel import distributed  # noqa: F401
