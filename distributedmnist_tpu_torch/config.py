"""Configuration of the port: the training and serving subsets of the JAX
package's Config (distributedmnist_tpu/config.py), with the same field
names, defaults and flag names, plus the device the port runs on, and
the presets of BASELINE.json's five training workloads.

`device` defaults to "cuda": an entry point runs on the card unless the
caller asks for "cpu", and with no card it raises rather than carry on
on the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Optional

INFER_DTYPE_CHOICES = ("float32", "bfloat16", "int8", "megakernel", "auto")


@dataclasses.dataclass(frozen=True)
class Config:
    # model / optimizer
    model: str = "lenet"            # {mlp, lenet}
    optimizer: str = "adam"         # {sgd, adam}
    learning_rate: float = 1e-3
    momentum: float = 0.9           # used by sgd only
    lr_schedule: str = "constant"   # {constant, cosine, warmup-cosine}
    warmup_steps: int = 0
    # cosine decay horizon in steps; None = the run's own total steps
    lr_decay_steps: Optional[int] = None
    # data
    data_dir: Optional[str] = None  # dir with IDX (*-ubyte[.gz]) or mnist.npz
    synthetic: bool = False         # force deterministic synthetic MNIST
    batch_size: int = 512
    # "device": the whole train set on the card, each batch gathered
    # there by indices; "stream": each rank gathers its rows of every
    # batch on the host and copies them to the card (data/host_loader.py).
    # The same batch order either way.
    data_pipeline: str = "device"
    # the streaming pipeline's host gather: "numpy" (in the training
    # loop) or "tfdata" (the same role in torch's idiom: a background
    # thread that gathers blocks ahead; not tf.data)
    stream_source: str = "numpy"
    # the train set on the card: "u8" bytes, or "packed" 4 pixels per
    # int32 word (data/packing.py); the same pixels either way
    pixel_format: str = "packed"
    # schedule
    epochs: int = 10
    steps: Optional[int] = None     # overrides epochs when set
    eval_every: int = 200           # steps between test-set evals
    target_accuracy: Optional[float] = 0.99  # stop early when reached
    seed: int = 0
    device: str = "cuda"            # {cuda, cpu}
    # data parallelism: one rank per device (parallel/). num_devices is
    # the world size; None = every rank of the process group (the train
    # CLI starts one a visible card, or 1 on the cpu). Serving runs in
    # one process over the first num_devices cards (None = every
    # visible card, or the one cpu device), each batch sharded over
    # them (parallel/mesh.py get_devices).
    num_devices: Optional[int] = None
    # auto: DistributedDataParallel; explicit: one hand-written
    # all-reduce of the flattened gradients per optimizer step
    spmd_mode: str = "auto"
    # tensor-parallel degree: the ranks fold into a (data, model) layout
    # and the dense layers are split Megatron-style over each model group
    # (parallel/tp.py). 1 = pure data parallelism.
    model_parallel: int = 1
    # compute dtype {float32, bfloat16}
    dtype: str = "float32"
    # steps launched back to back per block (one index copy, one event
    # each). None = auto: 1 on the cpu; on the card the largest k <= 1024
    # dividing the eval/checkpoint/fail-at cadence.
    steps_per_call: Optional[int] = None
    # blocks in flight before the host waits for the oldest. None = auto:
    # 1 on the cpu, 16 on the card.
    max_inflight: Optional[int] = None
    # microbatches per optimizer step
    grad_accum: int = 1
    # checkpointing
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 500     # steps between async saves
    resume: bool = True             # restore the latest checkpoint if present
    eval_only: bool = False         # restore + evaluate, no training
    # on SIGTERM stop at the next block boundary and force-save a
    # resumable checkpoint (only with a checkpoint_dir)
    graceful_preemption: bool = True
    # multi-host (config 5): one rank per process, started with these
    coordinator_address: Optional[str] = None
    num_processes: Optional[int] = None
    process_id: Optional[int] = None
    fail_at_step: Optional[int] = None   # fault injection (SimulatedFailure)
    log_every: int = 100
    # rank 0 writes a torch.profiler Chrome trace of the training loop
    # (CPU and CUDA activities) into this directory
    profile_dir: Optional[str] = None
    # the MLP's hidden layer: auto/pallas = the dense_relu kernel (its
    # plain version on the cpu), xla = plain relu(x @ w + b)
    fused_kernels: str = "auto"
    # LeNet's convolutions: lax = F.conv2d/F.avg_pool2d, im2col = patch
    # matmuls and reshape pooling; auto = lax
    conv_impl: str = "auto"
    # True: one multi-tensor (foreach) optimizer update across all
    # parameters, the counterpart of optax.flatten; False: per parameter
    flat_optimizer: bool = True
    # The dynamic batcher's knobs: max_batch bounds rows per dispatch
    # (and the engine's top bucket); max_wait_us bounds how long the
    # oldest queued request waits for coalescing; queue_depth is the
    # backpressure watermark in pending rows (beyond it, 503).
    serve_max_batch: int = 512
    serve_max_wait_us: int = 1000
    serve_queue_depth: int = 4096
    # Dispatched-but-unfetched batches kept in flight. None = auto:
    # 1 on the cpu, 4 on the card.
    serve_max_inflight: Optional[int] = None
    # The latency objective the adaptive coalescing wait defends; None =
    # no SLO. serve_adaptive=False pins the static wait.
    serve_slo_ms: Optional[float] = None
    serve_adaptive: bool = True
    # Serving precision: float32 serves the reference forward;
    # bfloat16/int8/megakernel take traffic only after the registry's
    # parity gate; auto serves the cheapest variant that passes it.
    serve_infer_dtype: str = "float32"
    # Resident model versions the registry keeps (live + candidates +
    # rollback targets); past it the oldest routeless version is evicted.
    serve_max_versions: int = 4
    # The ceiling on the pipeline-derived Retry-After header of every shed
    # HTTP response (integer seconds, RFC 9110): derived from the
    # in-flight depth at the measured batch cost, it is unbounded when a
    # cost spikes, and past ~30 s it just tells clients to go away.
    serve_retry_after_cap_s: float = 30.0
    # Resilience: serve_bisect isolates a poison request by splitting a
    # failed multi-request dispatch; the circuit breaker rolls a live
    # version back when its window (serve_breaker_window_s seconds, at
    # least serve_breaker_min_requests of volume) crosses
    # serve_breaker_ratio failures. serve_faults installs a fault
    # injection schedule (serve/faults.py spec string); None = inert.
    serve_bisect: bool = True
    serve_breaker_window_s: float = 5.0
    serve_breaker_min_requests: int = 20
    serve_breaker_ratio: float = 0.5
    serve_faults: Optional[str] = None
    # The replica fleet (serve/fleet.py): serve_replicas > 1 puts N
    # engine replicas (one card each when that many are visible, else N
    # replicas on one card, each on a CUDA stream of its own) behind the
    # health-tracked load-balancing dispatcher, with per-replica windows
    # of serve_replica_inflight batches (None = the serve_max_inflight
    # auto rule, per replica), failover redispatch of a batch whose
    # replica dies, and (serve_hedge) a duplicate on a free healthy
    # sibling for a batch already past the p95 cost estimate.
    serve_replicas: int = 1
    serve_replica_inflight: Optional[int] = None
    serve_hedge: bool = False
    # Request tracing: GET /trace, X-Trace-Id, Server-Timing and the
    # per-stage histograms; serve_trace_sample head-samples which OK
    # traces are kept (errored and over-SLO ones always are),
    # serve_trace_capacity bounds the ring.
    serve_trace: bool = False
    serve_trace_sample: float = 1.0
    serve_trace_capacity: int = 256
    # The prediction cache in front of the batcher (bounded LRU,
    # single-flight), its TTL by monotonic age (None = none), and
    # intra-batch dedup inside one drain.
    serve_cache: bool = False
    serve_cache_capacity: int = 4096
    serve_cache_ttl_s: Optional[float] = None
    serve_dedup: bool = False
    # The single-request fast lane: an idle pipeline dispatches a lone
    # request on the caller's thread.
    serve_fastlane: bool = False
    # The confidence-gated cascade (serve/cascade.py): the cheap
    # parity-gated variant answers rows whose softmax margin clears a
    # threshold calibrated on the held-out parity batch, the rest
    # escalate to float32 through the coalescing path; it serves only
    # after the composed-accuracy gate. serve_cascade_threshold
    # overrides the calibrated threshold (the same gate judges it).
    serve_cascade: bool = False
    serve_cascade_threshold: Optional[float] = None
    # Multi-tenant, multi-model serving (serve/tenancy.py): serve_models
    # lists the catalog ("mlp,lenet" boots both models, each with its own
    # registry/router/batcher and checkpoint subtree
    # <checkpoint_dir>/<model>; empty = just cfg.model). serve_tenants
    # configures the admission classes the X-Tenant header maps to
    # ("name:qps=50,burst=25,deadline_ms=50,weight=1,model=mlp;..."):
    # token-bucket quota (429 + Retry-After past it), a default deadline
    # (infeasible heads shed 504 by the cost model) and the weighted-fair
    # weight. Empty = tenancy off. serve_tenant_quantum_us is the
    # deficit-round-robin credit a ring visit grants per unit weight, in
    # microseconds of modeled dispatch cost.
    serve_models: str = ""
    serve_tenants: str = ""
    serve_tenant_quantum_us: float = 5000.0
    # The gateway (serve/gateway.py): gateway_workers > 0 turns `serve
    # --port P` into a front-door process that spawns that many full
    # serve processes and routes /predict across them on a
    # consistent-hash ring keyed like the prediction cache (hot keys
    # shard across workers instead of duplicating).
    # gateway_worker_inflight is the per-worker in-flight window the
    # gateway queues before shedding 503; gateway_vnodes is the ring's
    # virtual-node count per worker.
    gateway_workers: int = 0
    gateway_worker_inflight: int = 8
    gateway_vnodes: int = 64
    # Closed-loop autoscaling (serve/autoscale.py): serve_autoscale runs
    # the hysteresis controller over the live saturation surface (queue
    # watermark, in-flight depth, shed deltas, traced queue-wait p99 vs
    # serve_slo_ms) and actuates the batcher's in-flight window and
    # bucket ceiling. Floor/ceiling are hard bounds in actuator units; a
    # tick that wants past the ceiling is counted as saturation, never
    # acted on. high/low are the hysteresis bands on the normalized
    # pressure (grow at >= high, shrink at <= low); cooldown_s
    # suppresses any action inside the window after one; interval_s is
    # the control tick.
    serve_autoscale: bool = False
    serve_autoscale_floor: int = 1
    serve_autoscale_ceiling: Optional[int] = None
    serve_autoscale_interval_s: float = 0.25
    serve_autoscale_cooldown_s: float = 2.0
    serve_autoscale_high: float = 0.75
    serve_autoscale_low: float = 0.25

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


# BASELINE.json configs 1-5, with the JAX package's published values
PRESETS: dict[str, Config] = {
    # config 1: single-process 2-layer MLP (784-128-10), SGD, batch 64
    "mlp-sgd": Config(model="mlp", optimizer="sgd", learning_rate=0.1,
                      batch_size=64, num_devices=1),
    # config 2: single-process LeNet-5, Adam
    "lenet-adam": Config(model="lenet", optimizer="adam",
                         learning_rate=1e-3, num_devices=1, batch_size=128),
    # config 3: 2-worker data-parallel MLP with gradient allreduce
    "mlp-dp2": Config(model="mlp", optimizer="sgd", learning_rate=0.1,
                      batch_size=128, num_devices=2),
    # config 4: 8-chip data-parallel LeNet-5, per-rank sharding, batch 512
    "lenet-dp8": Config(model="lenet", optimizer="adam", learning_rate=1e-3,
                        batch_size=512, num_devices=8),
    # config 5: multi-host data-parallel LeNet-5 with async
    # checkpoint/restore (the coordinator flags given on the command line)
    "lenet-multihost": Config(model="lenet", optimizer="adam",
                              learning_rate=1e-3, batch_size=512,
                              checkpoint_dir="checkpoints",
                              checkpoint_every=200),
}


def add_args(p: argparse.ArgumentParser) -> argparse.ArgumentParser:
    p.add_argument("--preset", choices=sorted(PRESETS), default=None,
                   help="named workload preset (BASELINE.json configs 1-5)")
    p.add_argument("--model", choices=["mlp", "lenet"], default=None)
    p.add_argument("--optimizer", choices=["sgd", "adam"], default=None)
    p.add_argument("--learning-rate", type=float, default=None)
    p.add_argument("--momentum", type=float, default=None)
    p.add_argument("--lr-schedule",
                   choices=["constant", "cosine", "warmup-cosine"],
                   default=None)
    p.add_argument("--warmup-steps", type=int, default=None)
    p.add_argument("--lr-decay-steps", type=int, default=None,
                   help="pin the cosine decay horizon (steps); default "
                        "is the run's own total step count")
    p.add_argument("--data-dir", default=None)
    p.add_argument("--synthetic", action="store_true", default=None)
    p.add_argument("--data-pipeline", choices=["device", "stream"],
                   default=None,
                   help="device: the train set on the card, batches "
                        "gathered there; stream: each rank gathers its "
                        "rows on the host into pinned memory and copies "
                        "them over (same batch order)")
    p.add_argument("--stream-source", choices=["numpy", "tfdata"],
                   default=None,
                   help="[stream] numpy: gather in the training loop; "
                        "tfdata: a background thread gathers two blocks "
                        "ahead (torch's idiom for the role; not tf.data)")
    p.add_argument("--pixel-format", choices=["packed", "u8"],
                   default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--steps", type=int, default=None)
    p.add_argument("--eval-every", type=int, default=None)
    p.add_argument("--target-accuracy", type=float, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--device", choices=["cuda", "cpu"], default=None,
                   help="where the port runs (default cuda; cpu only "
                        "when asked)")
    p.add_argument("--num-devices", type=int, default=None,
                   help="the first N devices (default: every visible "
                        "card, or 1 on the cpu). Training: one rank a "
                        "device, N > 1 without the coordinator flags "
                        "starts N local ranks. Serving: the cards each "
                        "batch is sharded over, cut among "
                        "--serve-replicas")
    p.add_argument("--spmd-mode", choices=["auto", "explicit"], default=None)
    p.add_argument("--model-parallel", type=int, default=None,
                   help="tensor-parallel degree: ranks r with the same "
                        "r // N split the MLP's hidden layer (LeNet's "
                        "fc1/fc2) N ways, Megatron-style; the world size "
                        "must divide by N")
    p.add_argument("--dtype", choices=["float32", "bfloat16"], default=None,
                   help="compute dtype (bfloat16: the MLP's hidden layer "
                        "runs the dense_relu kernel in bf16 on bf16 "
                        "params; the rest computes in bf16 on float32 "
                        "params)")
    p.add_argument("--steps-per-call", type=int, default=None)
    p.add_argument("--max-inflight", type=int, default=None)
    p.add_argument("--grad-accum", type=int, default=None,
                   help="microbatches accumulated per optimizer step")
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--checkpoint-every", type=int, default=None)
    p.add_argument("--no-resume", dest="resume", action="store_false",
                   default=None)
    p.add_argument("--no-graceful-preemption", dest="graceful_preemption",
                   action="store_false", default=None,
                   help="don't catch SIGTERM to force-save a checkpoint "
                        "before exiting")
    p.add_argument("--eval-only", dest="eval_only", action="store_true",
                   default=None,
                   help="restore from --checkpoint-dir and evaluate; "
                        "no training steps")
    p.add_argument("--coordinator-address", default=None,
                   help="HOST:PORT of rank 0's rendezvous (multi-host: "
                        "one process a rank, with --num-processes and "
                        "--process-id)")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--fail-at-step", type=int, default=None)
    p.add_argument("--profile-dir", default=None,
                   help="rank 0 writes a torch.profiler Chrome trace of "
                        "the training loop here")
    p.add_argument("--log-every", type=int, default=None)
    p.add_argument("--fused-kernels", choices=["auto", "pallas", "xla"],
                   default=None,
                   help="the MLP's hidden layer: auto or pallas = the "
                        "hand-written dense_relu kernel (its plain version "
                        "on the cpu); xla = plain relu(x @ w + b)")
    p.add_argument("--conv-impl", choices=["auto", "im2col", "lax"],
                   default=None,
                   help="LeNet's convolutions: lax = F.conv2d and "
                        "F.avg_pool2d; im2col = patch matmuls and reshape "
                        "pooling; auto = lax")
    p.add_argument("--no-flat-optimizer", dest="flat_optimizer",
                   action="store_false", default=None,
                   help="per-parameter optimizer update instead of one "
                        "multi-tensor (foreach) update")
    p.add_argument("--flat-optimizer", dest="flat_optimizer",
                   action="store_true", default=None,
                   help="one multi-tensor (foreach) update across all "
                        "parameters (the default)")
    p.add_argument("--serve-max-batch", type=int, default=None,
                   help="max rows per inference dispatch (also the "
                        "engine's top bucket)")
    p.add_argument("--serve-max-wait-us", type=int, default=None,
                   help="max microseconds the oldest queued request "
                        "waits for batch coalescing")
    p.add_argument("--serve-queue-depth", type=int, default=None,
                   help="backpressure watermark in pending rows; beyond "
                        "it requests are rejected (503)")
    p.add_argument("--serve-max-inflight", type=int, default=None,
                   help="max dispatched-but-unfetched batches in flight "
                        "(default: 1 on cpu, 4 on cuda)")
    p.add_argument("--serve-slo-ms", type=float, default=None,
                   help="per-request latency SLO in ms for the adaptive "
                        "coalescing wait")
    p.add_argument("--no-adaptive", dest="serve_adaptive",
                   action="store_false", default=None,
                   help="pin the static coalescing wait")
    p.add_argument("--serve-infer-dtype", choices=INFER_DTYPE_CHOICES,
                   default=None,
                   help="serving precision: float32 = the reference "
                        "forward; bfloat16/int8/megakernel = variants "
                        "that serve only after the parity gate; auto = "
                        "the cheapest variant that passes it")
    p.add_argument("--serve-max-versions", type=int, default=None,
                   help="resident model versions kept (>= 2); the oldest "
                        "routeless one is evicted past it")
    p.add_argument("--serve-retry-after-cap-s", type=float, default=None,
                   help="ceiling on the pipeline-derived Retry-After "
                        "header (integer seconds per RFC 9110) on shed "
                        "responses")
    p.add_argument("--no-bisect", dest="serve_bisect",
                   action="store_false", default=None,
                   help="fail a whole batch on a dispatch error instead "
                        "of bisecting it to isolate the poison request")
    p.add_argument("--serve-breaker-window-s", type=float, default=None,
                   help="circuit-breaker sliding window in seconds over "
                        "per-version request outcomes")
    p.add_argument("--serve-breaker-min-requests", type=int, default=None,
                   help="minimum window volume before the breaker may "
                        "trip")
    p.add_argument("--serve-breaker-ratio", type=float, default=None,
                   help="failure ratio within the window that trips the "
                        "breaker and rolls the live version back "
                        "(0 < ratio <= 1)")
    p.add_argument("--serve-faults", default=None, metavar="SPEC",
                   help="install a fault-injection schedule "
                        "(serve/faults.py spec string); chaos testing "
                        "only — default: all failpoints inert")
    p.add_argument("--serve-replicas", type=int, default=None,
                   help="[serving] engine replicas behind the "
                        "load-balancing fleet dispatcher (one card each "
                        "when that many are visible, else replicas "
                        "sharing one card on streams of their own); 1 = "
                        "the single-engine path")
    p.add_argument("--serve-replica-inflight", type=int, default=None,
                   help="[serving] per-replica bounded in-flight window "
                        "in batches (default: the serve-max-inflight "
                        "auto rule, applied per replica)")
    p.add_argument("--serve-hedge", dest="serve_hedge",
                   action="store_true", default=None,
                   help="[serving] hedge batches already past the p95 "
                        "cost estimate with a duplicate dispatch on a "
                        "free healthy sibling replica (first result "
                        "wins)")
    p.add_argument("--serve-trace", dest="serve_trace",
                   action="store_true", default=None,
                   help="per-request span tracing: GET /trace exports "
                        "Chrome trace-event JSON, /predict responses "
                        "carry X-Trace-Id, /metrics gains per-stage "
                        "duration histograms")
    p.add_argument("--serve-trace-sample", type=float, default=None,
                   help="head-sampling fraction for OK traces (errored "
                        "and over-SLO traces are always kept); default 1")
    p.add_argument("--serve-trace-capacity", type=int, default=None,
                   help="bounded trace ring size (default 256)")
    p.add_argument("--serve-cache", dest="serve_cache",
                   action="store_true", default=None,
                   help="the prediction cache + single-flight front "
                        "(serve/cache.py), invalidated on every "
                        "live-route change")
    p.add_argument("--serve-cache-capacity", type=int, default=None,
                   help="prediction-cache size in entries (LRU; default "
                        "4096)")
    p.add_argument("--serve-cache-ttl-s", type=float, default=None,
                   help="cache entries older than this (monotonic age) "
                        "expire at lookup (default: no TTL)")
    p.add_argument("--serve-dedup", dest="serve_dedup",
                   action="store_true", default=None,
                   help="collapse identical rows inside one coalesced "
                        "drain into a single dispatch")
    p.add_argument("--serve-fastlane", dest="serve_fastlane",
                   action="store_true", default=None,
                   help="single-request fast lane: a submit that finds "
                        "the queue empty and a free in-flight slot "
                        "dispatches on the caller's thread")
    p.add_argument("--serve-cascade", dest="serve_cascade",
                   action="store_true", default=None,
                   help="[serving] confidence-gated model cascade "
                        "(serve/cascade.py): the cheap parity-gated "
                        "variant answers rows whose softmax margin "
                        "clears a calibrated confidence threshold; "
                        "uncertain rows escalate to the f32 reference. "
                        "Promotable only after the end-to-end composed-"
                        "accuracy gate passes (PARITY.md). Per-request "
                        "X-Accuracy-Class picks fast|balanced|exact")
    p.add_argument("--serve-cascade-threshold", type=float, default=None,
                   help="[serving] override the calibrated cascade "
                        "confidence threshold (margin in [0, 1]; rows "
                        "below it escalate). The composed-accuracy "
                        "gate still judges the override — a failing "
                        "value refuses the cascade loudly")
    p.add_argument("--serve-models", default=None,
                   help="[serving] comma-separated model catalog "
                        "(serve/tenancy.py): 'mlp,lenet' serves both "
                        "models from one process, each with its own "
                        "registry, bucket geometry, cost tables and "
                        "checkpoint subtree <checkpoint-dir>/<model>. "
                        "Empty (default) serves --model alone")
    p.add_argument("--serve-tenants", default=None,
                   help="[serving] tenant SLO classes for the X-Tenant "
                        "header, 'name:qps=50,burst=25,deadline_ms=50,"
                        "weight=1,model=mlp;name2:...': token-bucket "
                        "quota (429 + Retry-After on breach), default "
                        "deadline (infeasible requests shed 504), and "
                        "weighted-fair-queueing weight. Setting this "
                        "routes /predict through the global scheduler "
                        "(GET /tenants, POST /tenants/{id}/quota)")
    p.add_argument("--serve-tenant-quantum-us", type=float, default=None,
                   help="[serving] deficit-round-robin quantum: modeled "
                        "dispatch microseconds credited per ring visit "
                        "per unit tenant weight")
    p.add_argument("--gateway", dest="gateway_workers", type=int,
                   default=None, metavar="N",
                   help="[serving] become a front-door process over N "
                        "spawned serve workers (serve/gateway.py): "
                        "/predict routes on a consistent-hash ring keyed "
                        "like the prediction cache (hot keys shard, not "
                        "duplicate), promote fans out two-phase under a "
                        "cluster epoch. Every other serving flag "
                        "forwards to the workers verbatim")
    p.add_argument("--gateway-worker-inflight", type=int, default=None,
                   help="[serving] per-worker in-flight window at the "
                        "gateway; a full window sheds 503 instead of "
                        "spilling an affinity key to a sibling cache")
    p.add_argument("--gateway-vnodes", type=int, default=None,
                   help="[serving] virtual nodes per worker on the "
                        "consistent-hash ring (more = smoother key "
                        "spread)")
    p.add_argument("--serve-autoscale", dest="serve_autoscale",
                   action="store_true", default=None,
                   help="[serving] run the closed-loop autoscaler "
                        "(serve/autoscale.py): a hysteresis controller "
                        "over queue watermark / in-flight depth / shed "
                        "deltas / traced p99 that widens or narrows the "
                        "batcher's in-flight window and bucket ceiling, "
                        "with cooldown anti-flap and hard floor/ceiling "
                        "bounds")
    p.add_argument("--serve-autoscale-floor", type=int, default=None,
                   help="[serving] hard autoscale floor in actuator "
                        "units (window slots; default 1)")
    p.add_argument("--serve-autoscale-ceiling", type=int, default=None,
                   help="[serving] hard autoscale ceiling in actuator "
                        "units (default: the constructed in-flight "
                        "window)")
    p.add_argument("--serve-autoscale-interval-s", type=float,
                   default=None,
                   help="[serving] autoscaler control-tick period in "
                        "seconds (default 0.25)")
    p.add_argument("--serve-autoscale-cooldown-s", type=float,
                   default=None,
                   help="[serving] minimum seconds between actuated "
                        "scale decisions; any decision inside the "
                        "window is suppressed and counted (default 2)")
    p.add_argument("--serve-autoscale-high", type=float, default=None,
                   help="[serving] grow when normalized pressure >= "
                        "this hysteresis band (default 0.75)")
    p.add_argument("--serve-autoscale-low", type=float, default=None,
                   help="[serving] shrink when normalized pressure <= "
                        "this band (default 0.25); must be < high")
    return p


def from_args(args: argparse.Namespace) -> Config:
    preset = getattr(args, "preset", None)
    cfg = PRESETS[preset] if preset else Config()
    overrides = {}
    for f in dataclasses.fields(Config):
        v = getattr(args, f.name, None)
        if v is not None:
            overrides[f.name] = v
    return cfg.replace(**overrides)
