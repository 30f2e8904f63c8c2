from distributedmnist_tpu_torch.data.mnist import (  # noqa: F401
    load_mnist, synthetic_mnist)
from distributedmnist_tpu_torch.data.loader import (  # noqa: F401
    DeviceDataset, IndexStream, eval_batches)
