from distributedmnist_tpu_torch.utils.metrics import (  # noqa: F401
    MetricsLogger, StepTimer, percentiles)
from distributedmnist_tpu_torch.utils.numerics import (  # noqa: F401
    logit_parity, parity_check, round_up)
