"""The port's serving stack: engine (bucketed, pipelined dispatch/fetch and
the fast lane's resident routes), router (live, canary, shadow and
pinned routes), registry (versions, parity-gated variants, replica
fan-out, the cascade's gate, the cache's invalidation), batcher
(coalescing, backpressure, deadlines, in-flight window, route-uniform
drains, bisection, dedup, the fast lane), scheduler, metrics (with the
Prometheus exposition), fault injection (faults), resilience (the circuit
breaker and its rollback), tracing (trace), the prediction cache
(cache), the replica fleet (fleet), the confidence cascade (cascade),
multi-tenant, multi-model serving (tenancy: the model catalog and the
global scheduler) and the HTTP server (serve/server.py)."""

from distributedmnist_tpu_torch.serve import faults, trace  # noqa: F401
from distributedmnist_tpu_torch.serve.batcher import (  # noqa: F401
    DynamicBatcher, Rejected, resolve_max_inflight)
from distributedmnist_tpu_torch.serve.cache import (  # noqa: F401
    CacheFront, PredictionCache, build_cache_front, content_key)
from distributedmnist_tpu_torch.serve.cascade import (  # noqa: F401
    ACCURACY_CLASSES, CascadeFront, CascadeState, calibrate)
from distributedmnist_tpu_torch.serve.engine import (  # noqa: F401
    FASTLANE_MAX_BUCKET, InferenceEngine, fast_row_bucket, make_buckets)
from distributedmnist_tpu_torch.serve.faults import (  # noqa: F401
    FaultInjector, InjectedFault)
from distributedmnist_tpu_torch.serve.fleet import (  # noqa: F401
    FleetHandle, NoReplicaAvailable, ReplicaSet, select_member)
from distributedmnist_tpu_torch.serve.metrics import (  # noqa: F401
    ServeMetrics, prometheus_exposition)
from distributedmnist_tpu_torch.serve.registry import (  # noqa: F401
    PARITY_GATES, EngineFactory, ModelRegistry, ParityRefused, build_serving)
from distributedmnist_tpu_torch.serve.resilience import (  # noqa: F401
    CircuitBreaker, DeadlineExceeded, HealthTracker, ResiliencePolicy,
    build_resilience)
from distributedmnist_tpu_torch.serve.router import (  # noqa: F401
    NoLiveModel, Router)
from distributedmnist_tpu_torch.serve.trace import (  # noqa: F401
    Tracer, attribute_stages)
from distributedmnist_tpu_torch.serve.tenancy import (  # noqa: F401
    GlobalScheduler, ModelCatalog, QuotaExceeded, SLOClass, build_catalog,
    build_tenancy, parse_tenants)
