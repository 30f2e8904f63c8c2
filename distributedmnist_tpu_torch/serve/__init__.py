"""The port's serving stack: engine (bucketed, pipelined dispatch/fetch),
router (live, canary and shadow routes), registry (versions,
parity-gated variants), batcher (coalescing, backpressure, deadlines,
in-flight window), scheduler, metrics and the HTTP server
(serve/server.py)."""

from distributedmnist_tpu_torch.serve.batcher import (  # noqa: F401
    DynamicBatcher, Rejected, resolve_max_inflight)
from distributedmnist_tpu_torch.serve.engine import (  # noqa: F401
    InferenceEngine, make_buckets)
from distributedmnist_tpu_torch.serve.metrics import ServeMetrics  # noqa: F401
from distributedmnist_tpu_torch.serve.registry import (  # noqa: F401
    PARITY_GATES, EngineFactory, ModelRegistry, ParityRefused, build_serving)
from distributedmnist_tpu_torch.serve.resilience import (  # noqa: F401
    DeadlineExceeded)
from distributedmnist_tpu_torch.serve.router import (  # noqa: F401
    NoLiveModel, Router)
