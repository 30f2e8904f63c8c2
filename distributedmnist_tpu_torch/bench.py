"""Benchmark of the port, printed as ONE JSON line on stdout:
`python -m distributedmnist_tpu_torch.bench`.

The port's counterpart of the root bench.py, in its five modes, with
its flag names, defaults and record keys:

- throughput (default): steady-state training images/sec a chip
  (LeNet-5, Adam, global batch 512 by default, rounded up to a multiple
  of the ranks). Steps run in blocks of steps_per_call with at most 16
  blocks in flight, as trainer.fit runs them; the median of --repeats
  timed windows is reported, each window's clock stopped on a value
  fetch of its last loss on every rank, its seconds the slowest rank's.
- time-to-accuracy: wall-clock seconds of trainer.fit to reach
  --target-accuracy on the tuned recipe (tta_config), over --trials
  trials at distinct seeds; the median is reported beside the steps and
  evals each trial needed.
- sweep: the throughput measurement at each per-rank batch of
  --sweep-batches (global batch b x ranks), and from that curve the root
  bench's 8-card prediction (strong and weak scaling, a sensitivity
  band). On one rank the gradient all-reduce is modelled at the bus
  bandwidth NCCL measured among this host's own cards
  (ALLREDUCE_BUS_GBPS); over ranks it is in the measured step, and the
  model is only reported.
- smoke: an end-to-end gate: trainer.fit for 64 steps with evals and
  checkpoints, then a restore that resumes to step 96, held to a 0.85
  test-accuracy floor.
- serve (also `python -m distributedmnist_tpu_torch.bench serve`): the
  in-process load legs of the serving stack. Closed loop at in-flight 1,
  one open-loop point at the lowest rate, closed loop at
  --serve-max-inflight (the headline images/sec), the open-loop Poisson
  sweep, then the ragged-size leg with the batch former off and on. The
  registry boots from --checkpoint-dir's latest checkpoint when given
  (fresh-init otherwise), and --serve-infer-dtype activates a
  parity-gated variant before any measured phase. Every batcher runs
  with the resilience policy wired (bisection and the circuit breaker),
  as the server wires it. Optional legs, the root bench's: --lowlat (one
  client of 1-row requests, coalesced against the fast lane and the fast
  lane on the megakernel variant, with a traced attribution sub-phase),
  --zipf (a hot-key mix with the prediction cache off, then on;
  --zipf-cache-off runs the control only; --serve-cache-capacity sizes
  the cache), --trace (stage attribution of the over-SLO tail under a
  tracer) and --chaos (a seeded fault schedule against bisection, the
  breaker's rollback and the deadline shed; --serve-cache runs it
  through the cache front), --dtype-sweep (float32, bfloat16 and int8
  closed-loop back to back behind the parity gate) and --cascade (the
  cascade's goodput-vs-accuracy frontier: exact, fast, balanced and a
  stressed threshold). With --serve-replicas N >= 2 the router's slot
  holds a fleet (--serve-hedge hedges its tail): the fleet leg measures
  one replica against all N, and --chaos adds a replica kill that
  failover must absorb. --swap-during-load rolls a fresh-init version
  in under closed-loop load (recompiles_after_swap must be 0), and
  --multimodel serves the MLP and LeNet-5 from one process behind the
  global scheduler (serve/tenancy.py): a light tenant's p99 alone and
  under a heavy tenant's burst at the other model, both tenants'
  fairness on one model, and the cross-model contention probe.
  --trace-replay SPEC replays a seeded arrival trace (serve/workload.py)
  open-loop against a static trough-provisioned batcher and, with
  --autoscale, again under the closed-loop autoscaler
  (serve/autoscale.py): SLO attainment, chip-seconds per million
  within-SLO requests, the scale actions and the flap audit.

  --gateway N benches the gateway instead of the in-process legs: it
  boots `python -m distributedmnist_tpu_torch.serve --gateway 1`, then
  `--gateway N`, and drives them over HTTP (scaling efficiency against
  one worker, an open-loop point, the sharded-cache Zipf leg, a promote
  under load, per-worker recompiles and the host contention probe); the
  workers' launch counts go to stderr (`bench: worker launches {...}`).

  The serve record is also written to BENCH_torch_serve_rNN.json, the
  next free round number of that prefix (the JAX package's
  BENCH_serve_rNN.json records are never counted or touched), in
  --artifact-dir (default: the repository root); --no-artifact writes
  none. With --trace the Chrome trace-event file rides beside it
  (`..._trace.json`). --baseline RECORD embeds and prints the delta
  against an earlier record, and refuses (exit 4, before any load
  phase) a record of another device_kind, another infer_dtype, a zipf
  leg of the other cache setting, a trace-replay leg of the other
  autoscale setting, or a gateway record (and a gateway run, a
  single-process record).

The four training modes run data-parallel, one process (rank) a device,
as the root bench runs them over every device of its mesh: by default
one rank a visible card (one on the cpu), --num-devices N asks for N
(ranks beyond the cards share them over gloo, and a shared card counts
as one chip in n_chips). More than one rank starts them here through
parallel/launch.py, inside the supervised worker, as the train CLI
does: rank 0 prints the record, every rank its `[rank r] bench:
launches {...}` line, and a rank that fails ends the run non-zero with
no record. The serve mode stays in one process and serves over the same
cards, as the root bench's engine shards each batch over its mesh: every
batch is split over every visible card (--num-devices N: the first N;
more than are visible fails), --serve-replicas cuts them among the
replicas by the JAX registry's rule (equal slices when they divide,
else logical replicas over all of them), and images/s per chip divides
by the cards served over.

Runs on the card; --device cpu runs on the CPU, and without a card the
bench raises. --dtype bfloat16 trains in bfloat16 (throughput,
time-to-accuracy, sweep, smoke); --data-dir reads MNIST from IDX files or
mnist.npz there instead of the synthetic set. Progress marks go to
stderr, and at the end the kernel launch counts (`bench: launches
{...}`).

As the root bench does, the measurement runs in a supervised worker
process (utils/supervise.py: killed and retried when it goes silent for
--stall-timeout seconds or exits without a record, up to --max-attempts
times); --inline runs it in this process. Unlike the root bench, which
re-runs on the CPU when every attempt fails, the port's bench then
fails: a CPU number is never a result of the card's bench.

    python -m distributedmnist_tpu_torch.bench throughput --model mlp
    python -m distributedmnist_tpu_torch.bench time-to-accuracy
    python -m distributedmnist_tpu_torch.bench sweep --sweep-batches 64,512
    python -m distributedmnist_tpu_torch.bench throughput --device cpu \\
        --num-devices 2 --model mlp
    python -m distributedmnist_tpu_torch.bench smoke --dtype bfloat16
    python -m distributedmnist_tpu_torch.bench serve --model lenet \\
        --checkpoint-dir ckpt --serve-infer-dtype int8
    python -m distributedmnist_tpu_torch.bench serve --model mlp \\
        --serve-replicas 2 --serve-hedge --chaos
    python -m distributedmnist_tpu_torch.bench serve --model mlp \\
        --multimodel --swap-during-load \\
        --baseline BENCH_torch_serve_r01.json
    python -m distributedmnist_tpu_torch.bench serve --model mlp \\
        --trace-replay "square:qps=250,burst=8,duty=0.35,period=3" \\
        --autoscale
    python -m distributedmnist_tpu_torch.bench serve --model mlp \\
        --gateway 2 --serve-infer-dtype megakernel

vs_baseline is null in every record: the root bench's targets
(TARGET_IPS_PER_CHIP, TARGET_WALL_S) were set for a TPU, and no figure
taken on or for a TPU is a baseline for the port.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import sys
import time
from typing import Optional

from distributedmnist_tpu_torch.analysis.locks import make_thread

# The tuned time-to-accuracy recipe's cosine decay horizon, in steps (the
# root bench's TTA_DECAY_STEPS): 20 epochs x 117 steps at batch 512, the
# horizon the recipe's lr was tuned under, pinned so that --max-epochs
# bounds how long a trial may run, not how fast the lr decays.
TTA_DECAY_STEPS = 2340

# The sweep's all-reduce model: NCCL's all-reduce bus bandwidth, GB/s, of
# each model's float32 gradients (grad_bytes_f32: 246,824 and 407,080
# bytes, 48.1 and 51.8 us an all-reduce) among this kind of host's cards,
# measured by `python -m distributedmnist_tpu_torch.allreduce_bw` on four
# NVIDIA H100 80GB HBM3 (power limit 700.00 W each) over NVLink, one rank
# a card (PERF.md §6 names the run). The root bench's figure was a TPU's
# interconnect; none of it is the port's.
ALLREDUCE_BUS_GBPS = {"lenet": 7.6941584720758485, "mlp": 11.78708403662699}

MODES = ("throughput", "time-to-accuracy", "sweep", "smoke", "serve")

# The exit code of a serve run that refuses its --baseline (before any
# load phase): deterministic, so the supervisor does not retry it.
REFUSED = 4

# The port's serve records, numbered apart from the JAX package's
# BENCH_serve_rNN.json.
ARTIFACT_PREFIX = "BENCH_torch_serve_r"
# The fleet leg's replicas-N phase runs at least this many requests a
# replica (32: with 2 clients, 16 or more batches each), and a closed
# loop that runs past its duration for a minimum stops this many seconds
# after it at the latest.
FLEET_LEG_MIN_REQUESTS = 32
CLOSED_LOOP_MAX_S = 60.0
# how long a leg's clients may take to start before the leg fails
CLIENTS_READY_S = 120.0


def _mark(msg: str) -> None:
    """Progress mark on stderr, in one write (as fused.print_launches:
    the `bench: launches {...}` lines it carries are parsed)."""
    sys.stderr.write(f"bench: {msg}\n")
    sys.stderr.flush()


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m distributedmnist_tpu_torch.bench",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("mode_pos", nargs="?", choices=MODES, default=None,
                   metavar="mode", help="positional alias for --mode")
    p.add_argument("--mode", choices=MODES, default=None)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the bench runs (default cuda; cpu only "
                        "when asked)")
    p.add_argument("--model", choices=["mlp", "lenet"], default="lenet")
    p.add_argument("--num-devices", type=int, default=None,
                   help="the first N devices (default: every visible "
                        "card, or 1 on the cpu). Training modes: one "
                        "rank a device, N > 1 starts N local ranks; "
                        "serve: the cards each batch is sharded over "
                        "(cut among --serve-replicas)")
    p.add_argument("--dtype", choices=["float32", "bfloat16"],
                   default="float32",
                   help="training compute dtype (throughput, "
                        "time-to-accuracy, sweep, smoke)")
    p.add_argument("--data-dir", default=None,
                   help="real MNIST IDX/npz dir (default: the synthetic "
                        "set)")
    p.add_argument("--target-accuracy", type=float, default=0.99)
    p.add_argument("--max-epochs", type=int, default=20)
    p.add_argument("--global-batch", type=int, default=None,
                   help="global batch (default 512; sweep mode rejects "
                        "this — it takes --sweep-batches)")
    p.add_argument("--warmup-steps", type=int, default=None,
                   help="[throughput/sweep] warmup steps (default 20)")
    p.add_argument("--bench-steps", type=int, default=None,
                   help="[throughput/sweep] timed steps, >= 1 (default: "
                        "8192 on the card, 64 on the cpu)")
    p.add_argument("--steps-per-call", type=int, default=None,
                   help="steps launched per block (default: 1 on the cpu; "
                        "on the card min(4096, max(256, 1024*512 // b)), b "
                        "the batch a rank, in throughput mode, "
                        "trainer.fit's auto depth in time-to-accuracy "
                        "mode)")
    p.add_argument("--repeats", type=int, default=None,
                   help="[throughput/sweep] timed windows, median reported "
                        "(default: 3 on the card, 1 on the cpu)")
    p.add_argument("--trials", type=int, default=None,
                   help="[time-to-accuracy] full training runs, median "
                        "reported (default: 3 on the card, 1 on the cpu)")
    p.add_argument("--sweep-batches", default="64,128,256,512",
                   help="[sweep] comma-separated per-card batch sizes")
    p.add_argument("--stall-timeout", type=float, default=300.0,
                   help="kill and retry the worker if it is silent this "
                        "long")
    p.add_argument("--max-attempts", type=int, default=3,
                   help="worker attempts before giving up (no CPU re-run)")
    p.add_argument("--inline", action="store_true",
                   help="run in this process (no supervised worker)")
    p.add_argument("--checkpoint-dir", default=None,
                   help="[serve] boot from this directory's latest "
                        "committed checkpoint (fresh-init without one)")
    p.add_argument("--serve-qps", default=None,
                   help="[serve] comma-separated open-loop Poisson rates "
                        "(default: 50,200 on the cpu; 1000,4000,16000 on "
                        "the card)")
    p.add_argument("--serve-duration", type=float, default=None,
                   help="[serve] seconds per load phase (default: 2 on "
                        "the cpu, 10 on the card)")
    p.add_argument("--serve-clients", type=int, default=None,
                   help="[serve] closed-loop clients (default: 8 on the "
                        "cpu, 64 on the card)")
    p.add_argument("--serve-rows", type=int, default=1,
                   help="[serve] images per request (default 1)")
    p.add_argument("--serve-max-batch", type=int, default=None,
                   help="[serve] rows per dispatch cap / top bucket "
                        "(default: 128 on the cpu, 512 on the card)")
    p.add_argument("--serve-max-wait-us", type=int, default=None,
                   help="[serve] coalescing wait bound (default 1000)")
    p.add_argument("--serve-queue-depth", type=int, default=None,
                   help="[serve] backpressure watermark in pending rows "
                        "(default 4096)")
    p.add_argument("--serve-max-inflight", type=int, default=None,
                   help="[serve] dispatch window of the headline phase "
                        "(default 4); the serial phase runs at 1")
    p.add_argument("--serve-slo-ms", type=float, default=None,
                   help="[serve] latency SLO of the adaptive coalescing "
                        "wait (default: none)")
    p.add_argument("--no-adaptive", action="store_true", default=None,
                   help="[serve] pin the static coalescing wait")
    p.add_argument("--serve-infer-dtype", default=None,
                   choices=["float32", "bfloat16", "int8", "megakernel",
                            "auto"],
                   help="[serve] serving precision of the measured phases "
                        "(default float32; megakernel: the MLP's fused "
                        "whole-net kernel); a variant the parity gate "
                        "refuses fails the bench")
    p.add_argument("--lowlat", action="store_true", default=None,
                   help="[serve] the single-request leg: one client of "
                        "1-row requests, coalesced vs the fast lane vs "
                        "the fast lane on the megakernel variant (MLP), "
                        "p50/p99 and the attribution floor")
    p.add_argument("--zipf", action="store_true", default=None,
                   help="[serve] the hot-key leg: a seeded Zipf mix "
                        "closed-loop with the prediction cache off, then "
                        "on; hit ratio, goodput ratio, dispatch counts, "
                        "byte-identity probes")
    p.add_argument("--zipf-cache-off", action="store_true", default=None,
                   help="[serve] run only the --zipf leg's cache-off "
                        "control")
    p.add_argument("--serve-cache", action="store_true", default=None,
                   help="[serve] run the --chaos drill through the "
                        "prediction cache front")
    p.add_argument("--serve-cache-capacity", type=int, default=None,
                   help="[serve] prediction-cache entries of the --zipf "
                        "and --chaos legs (default 4096)")
    p.add_argument("--chaos", action="store_true", default=None,
                   help="[serve] the resilience leg: a seeded fault "
                        "schedule (request-sticky poison + a forced "
                        "breaker trip) driven open-loop; availability, "
                        "p99 under faults, bisection, rollback and "
                        "recompile counts")
    p.add_argument("--serve-replicas", type=int, default=None,
                   help="[serve] engine replicas behind the fleet "
                        "dispatcher (serve/fleet.py); >= 2 adds the "
                        "fleet closed-loop leg (per-replica balance + "
                        "scaling efficiency vs one replica) and, with "
                        "--chaos, a replica-kill storm proving failover "
                        "rescues the killed replica's cohorts "
                        "(default 1)")
    p.add_argument("--serve-hedge", action="store_true", default=None,
                   help="[serve] enable hedged tail dispatch in the "
                        "fleet (duplicate overdue batches on a free "
                        "healthy sibling)")
    p.add_argument("--dtype-sweep", action="store_true", default=None,
                   help="[serve] add the inference fast-path leg: warm "
                        "+ parity-gate bf16 and int8 variants, then "
                        "run f32/bf16/int8 closed-loop back-to-back in "
                        "this process — one record with per-dtype "
                        "img/s/chip, parity metrics, bucket cost "
                        "tables and recompile counts (must stay 0)")
    p.add_argument("--cascade", action="store_true", default=None,
                   help="[serve] add the confidence-gated cascade leg: "
                        "warm + parity-gate int8, calibrate the "
                        "escalation threshold on the held-out batch "
                        "(composed-accuracy gate), then run "
                        "exact/fast/balanced (+ a stressed-threshold "
                        "point) closed-loop back-to-back on one seeded "
                        "stream — the goodput-vs-accuracy frontier with "
                        "measured end-to-end agreement, escalation "
                        "fractions, and recompile counts (must stay 0; "
                        "bars: cascade goodput >= 1.5x f32 at "
                        "agreement >= 0.995)")
    p.add_argument("--trace", action="store_true", default=None,
                   help="[serve] the tracing leg: open-loop traffic under "
                        "a tracer and a stage-attribution row for every "
                        "over-SLO request; with --chaos the chaos leg is "
                        "traced too")
    p.add_argument("--multimodel", action="store_true", default=None,
                   help="[serve] the multi-tenant leg: MLP and LeNet-5 "
                        "in one process behind the global DRR/EDF "
                        "scheduler; the light tenant's p99 alone, then "
                        "under a heavy burst tenant at the other model "
                        "(bar: <= 1.5x solo), both tenants saturating "
                        "LeNet for the dispatch-share/weight-share "
                        "fairness ratios (bar: within [0.8, 1.25]), "
                        "per-tenant SLO attainment, the cross-model "
                        "contention probe and the recompile count (must "
                        "stay 0); bars recorded, not raised")
    p.add_argument("--swap-during-load", action="store_true",
                   default=None,
                   help="[serve] a closed-loop phase with a real model "
                        "roll mid-window: load and warm a fresh-init "
                        "version while clients hammer the live one, "
                        "promote it, and report the window's p99 against "
                        "the steady p99 and the post-warm recompile "
                        "count (must be 0)")
    p.add_argument("--baseline", default=None,
                   metavar="BENCH_torch_serve.json",
                   help="[serve] an earlier serve record to diff "
                        "against: prints a delta table and refuses "
                        "(exit 4, before any load phase) when its "
                        "detail.host.device_kind, infer_dtype or zipf "
                        "cache setting differs, or when it is a gateway "
                        "record")
    p.add_argument("--artifact-dir", default=None,
                   help="[serve] directory for the "
                        "BENCH_torch_serve_rNN.json record (default: the "
                        "repository root)")
    p.add_argument("--no-artifact", action="store_true", default=None,
                   help="[serve] write no BENCH_torch_serve_rNN.json "
                        "record")
    p.add_argument("--trace-replay", default=None, metavar="SPEC",
                   help="[serve] the workload-realism leg: replay a "
                        "seeded arrival trace (serve/workload.py spec, "
                        "e.g. 'square:qps=60,burst=4,period=2,"
                        "duration=4') open-loop against a static "
                        "trough-provisioned batcher, reporting SLO "
                        "attainment and chip-seconds per million "
                        "within-SLO requests; with --autoscale the same "
                        "schedule replays again under the closed-loop "
                        "autoscaler and the record carries both phases, "
                        "the scale-action log and the flap audit")
    p.add_argument("--autoscale", action="store_true", default=None,
                   help="[serve] run the --trace-replay leg's second "
                        "phase under the closed-loop autoscaler "
                        "(serve/autoscale.py window actuator): "
                        "hysteresis and cooldown over the live "
                        "saturation surface, scale moving only along the "
                        "warmed bucket ladder (the recompile bar still "
                        "applies)")
    p.add_argument("--gateway", type=int, default=None, metavar="N",
                   help="[serve] bench the gateway: boot `python -m "
                        "distributedmnist_tpu_torch.serve --gateway 1` "
                        "then `--gateway N` as real multi-process fleets "
                        "and drive them over HTTP: closed-loop scaling "
                        "efficiency (img/s at N workers over N x the "
                        "1-worker run), an open-loop latency point, the "
                        "Zipf sharded-cache leg (each hot key served by "
                        "one worker's cache), a fleet-wide promote under "
                        "load (zero mixed-epoch replies), per-worker "
                        "recompile counts (must be 0) and the host "
                        "contention probe; the in-process legs are "
                        "refused beside it")
    return p


def _parse(argv) -> argparse.Namespace:
    """Parse and validate; a usage error exits 2 before any work."""
    p = _parser()
    args = p.parse_args(argv)
    if args.mode_pos is not None:
        if args.mode is not None and args.mode != args.mode_pos:
            p.error(f"positional mode {args.mode_pos!r} contradicts "
                    f"--mode {args.mode!r}")
        args.mode = args.mode_pos
    args.mode = args.mode or "throughput"
    if args.num_devices is not None and args.num_devices < 1:
        p.error("--num-devices must be >= 1")
    serve_flags = {"--serve-qps": args.serve_qps,
                   "--serve-duration": args.serve_duration,
                   "--serve-clients": args.serve_clients,
                   "--serve-max-batch": args.serve_max_batch,
                   "--serve-max-wait-us": args.serve_max_wait_us,
                   "--serve-queue-depth": args.serve_queue_depth,
                   "--serve-max-inflight": args.serve_max_inflight,
                   "--serve-slo-ms": args.serve_slo_ms,
                   "--no-adaptive": args.no_adaptive,
                   "--serve-infer-dtype": args.serve_infer_dtype,
                   "--checkpoint-dir": args.checkpoint_dir,
                   "--lowlat": args.lowlat, "--zipf": args.zipf,
                   "--zipf-cache-off": args.zipf_cache_off,
                   "--serve-cache": args.serve_cache,
                   "--serve-cache-capacity": args.serve_cache_capacity,
                   "--chaos": args.chaos, "--trace": args.trace,
                   "--serve-replicas": args.serve_replicas,
                   "--serve-hedge": args.serve_hedge,
                   "--dtype-sweep": args.dtype_sweep,
                   "--cascade": args.cascade,
                   "--multimodel": args.multimodel,
                   "--swap-during-load": args.swap_during_load,
                   "--trace-replay": args.trace_replay,
                   "--autoscale": args.autoscale,
                   "--gateway": args.gateway,
                   "--baseline": args.baseline,
                   "--artifact-dir": args.artifact_dir,
                   "--no-artifact": args.no_artifact}
    if args.mode != "serve":
        given = [k for k, v in serve_flags.items() if v is not None]
        if given or args.serve_rows != 1:
            p.error(f"{', '.join(given) or '--serve-rows'} are serve-mode "
                    "flags; rejected rather than silently ignored")
    if args.mode != "sweep" and args.sweep_batches != "64,128,256,512":
        p.error("--sweep-batches is a sweep-mode flag; rejected rather "
                "than silently ignored")
    if args.mode == "serve":
        if (args.warmup_steps is not None or args.bench_steps is not None
                or args.repeats is not None or args.trials is not None
                or args.steps_per_call is not None
                or args.global_batch is not None
                or args.data_dir is not None or args.dtype != "float32"):
            p.error("serve mode takes --model and the --serve-* flags; "
                    "training measurement flags belong to the other modes")
        for flag, v, lo in (("--serve-rows", args.serve_rows, 1),
                            ("--serve-max-batch", args.serve_max_batch, 1),
                            ("--serve-max-wait-us", args.serve_max_wait_us,
                             0),
                            ("--serve-queue-depth", args.serve_queue_depth,
                             1),
                            ("--serve-max-inflight",
                             args.serve_max_inflight, 1),
                            ("--serve-clients", args.serve_clients, 1)):
            if v is not None and v < lo:
                p.error(f"{flag} must be >= {lo}")
        if args.serve_duration is not None and args.serve_duration <= 0:
            p.error("--serve-duration must be > 0")
        if args.serve_slo_ms is not None and args.serve_slo_ms <= 0:
            p.error("--serve-slo-ms must be > 0")
        if args.serve_qps is not None:
            try:
                args.serve_qps = sorted(
                    {float(q) for q in args.serve_qps.split(",")})
            except ValueError:
                p.error("--serve-qps must be comma-separated numbers")
            if not args.serve_qps or args.serve_qps[0] <= 0:
                p.error("--serve-qps targets must be positive")
        if (args.serve_cache_capacity is not None
                and args.serve_cache_capacity < 1):
            p.error("--serve-cache-capacity must be >= 1")
        if args.zipf_cache_off and not args.zipf:
            p.error("--zipf-cache-off modifies the --zipf leg; pass "
                    "--zipf too")
        if args.autoscale and not args.trace_replay:
            p.error("--autoscale modifies the --trace-replay leg; pass "
                    "--trace-replay too (the autoscaler is only "
                    "measurable against a changing arrival rate)")
        if args.trace_replay is not None:
            # a malformed spec is a usage error now: it must never replay
            # something else minutes into a run
            from distributedmnist_tpu_torch.serve.workload import \
                parse_trace_spec
            try:
                parse_trace_spec(args.trace_replay)
            except ValueError as e:
                p.error(f"--trace-replay: {e}")
        if args.serve_cache and not args.chaos:
            p.error("--serve-cache wires the cache front into the "
                    "--chaos drill (the hot-key cache leg is --zipf); "
                    "pass --chaos too")
        if args.serve_replicas is not None and args.serve_replicas < 1:
            p.error("--serve-replicas must be >= 1")
        if args.chaos:
            # the programmatic schedule fails here, at argparse, never
            # minutes into a run
            from distributedmnist_tpu_torch.serve.faults import parse_spec
            for template in (chaos_fault_spec("v0", None),
                             chaos_fault_spec("v0", "r0")):
                try:
                    parse_spec(template)
                except ValueError as e:
                    p.error(f"chaos schedule template is invalid: {e}")
        if args.gateway is not None:
            if args.gateway < 1:
                p.error("--gateway must be >= 1 workers")
            # the gateway bench drives worker processes over HTTP and
            # runs its own zipf, promote and recompile legs; the
            # in-process legs read state this process does not hold
            for flag, val in (("--zipf", args.zipf),
                              ("--zipf-cache-off", args.zipf_cache_off),
                              ("--chaos", args.chaos),
                              ("--trace", args.trace),
                              ("--lowlat", args.lowlat),
                              ("--dtype-sweep", args.dtype_sweep),
                              ("--cascade", args.cascade),
                              ("--multimodel", args.multimodel),
                              ("--swap-during-load",
                               args.swap_during_load),
                              ("--serve-cache", args.serve_cache),
                              ("--serve-hedge", args.serve_hedge),
                              ("--trace-replay", args.trace_replay),
                              ("--autoscale", args.autoscale)):
                if val:
                    p.error(f"{flag} is an in-process serve leg; the "
                            "--gateway fleet bench has its own "
                            "sharded-cache, promote-under-load and "
                            "recompile legs")
            if args.serve_replicas is not None:
                p.error("--serve-replicas multiplies engines INSIDE "
                        "one process; with --gateway the workers are "
                        "the replication axis")
            if args.serve_qps is not None:
                p.error("--gateway picks its open-loop target from "
                        "the measured fleet capacity; --serve-qps "
                        "belongs to the in-process sweep")
        if args.baseline is not None:
            # an unreadable or shapeless baseline is a usage error now;
            # the device_kind refusal waits for the card, in the worker
            try:
                with open(args.baseline) as f:
                    base = json.load(f)
            except (OSError, ValueError) as e:
                p.error(f"--baseline {args.baseline!r}: {e}")
            detail = base.get("detail") if isinstance(base, dict) else None
            host = (detail.get("host") if isinstance(detail, dict)
                    else None)
            kind = (host.get("device_kind") if isinstance(host, dict)
                    else None)
            if not kind:
                p.error(f"--baseline {args.baseline!r} has no "
                        "detail.host.device_kind — not a serve record "
                        "(records without provenance can't be safely "
                        "compared)")
        # last (its mkdir is a side effect): a bad artifact dir fails
        # now, not after the load phases
        if args.artifact_dir is not None and not args.no_artifact:
            if not args.artifact_dir:
                p.error("--artifact-dir needs a non-empty path "
                        "(or use --no-artifact)")
            try:
                os.makedirs(args.artifact_dir, exist_ok=True)
            except OSError as e:
                p.error(f"--artifact-dir {args.artifact_dir!r}: {e}")
    elif args.mode in ("throughput", "sweep"):
        if args.trials is not None:
            p.error("--trials is a time-to-accuracy flag; throughput "
                    "takes --repeats")
        if args.bench_steps is not None and args.bench_steps < 1:
            p.error("--bench-steps must be >= 1")
        if args.repeats is not None and args.repeats < 1:
            p.error("--repeats must be >= 1")
        args.warmup_steps = (20 if args.warmup_steps is None
                             else args.warmup_steps)
        if args.mode == "sweep":
            if args.global_batch is not None:
                p.error("--global-batch is meaningless in sweep mode "
                        "(the curve comes from --sweep-batches); "
                        "rejected rather than silently ignored")
            try:
                args.sweep_batches = sorted(
                    {int(b) for b in args.sweep_batches.split(",")})
            except ValueError:
                p.error("--sweep-batches must be comma-separated ints")
            if not args.sweep_batches or args.sweep_batches[0] < 1:
                p.error("--sweep-batches must be positive")
    elif args.mode == "smoke":
        if (args.warmup_steps is not None or args.bench_steps is not None
                or args.repeats is not None or args.trials is not None
                or args.steps_per_call is not None):
            p.error("smoke mode takes only --model/--dtype/--data-dir/"
                    "--global-batch; measurement flags belong to "
                    "throughput/sweep/time-to-accuracy")
    else:
        if (args.warmup_steps is not None or args.bench_steps is not None
                or args.repeats is not None):
            p.error("--warmup-steps/--bench-steps/--repeats are "
                    "throughput-mode flags; time-to-accuracy takes "
                    "--max-epochs, --trials and --steps-per-call")
        if args.trials is not None and args.trials < 1:
            p.error("--trials must be >= 1")
    if args.global_batch is None:
        args.global_batch = 512
    return args


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = _parse(argv)
    from distributedmnist_tpu_torch.utils import supervise

    if not args.inline and not supervise.is_worker():
        # no fallback_env: when every attempt fails, the bench fails; a
        # refused --baseline is final
        return supervise.run_supervised(
            ["-m", "distributedmnist_tpu_torch.bench", *argv],
            accept=supervise.json_record_acceptor("metric"),
            stall_timeout=args.stall_timeout, attempts=args.max_attempts,
            final_codes=(REFUSED,))
    if args.mode != "serve":
        # one rank a device, as the root bench's mesh spans every device
        # it sees: with more than one, this process starts them (each
        # this command) and waits, rank 0's record passed on
        from distributedmnist_tpu_torch.config import Config
        from distributedmnist_tpu_torch.parallel import launch

        rc = launch.run_ranks(
            "distributedmnist_tpu_torch.bench", argv,
            Config(device=args.device, num_devices=args.num_devices))
        if rc is not None:
            return rc
    run = {"throughput": _throughput, "time-to-accuracy": _time_to_accuracy,
           "sweep": _sweep, "smoke": _smoke,
           "serve": _serve_gateway if args.gateway else _serve}[args.mode]
    from distributedmnist_tpu_torch.ops import fused
    from distributedmnist_tpu_torch.parallel import distributed

    try:
        rc = run(args)
    finally:
        distributed.shutdown()
    _mark("launches " + json.dumps(fused.LAUNCHES))
    return rc


# -- throughput ---------------------------------------------------------------


def _join(args):
    """(this rank's device, the ranks, the distinct devices under them):
    joins the process group when a launcher started this process as a
    rank (parallel/distributed.py), and is one device outside one. The
    root bench's `jax.devices()` and the size of its mesh."""
    from distributedmnist_tpu_torch.parallel import (chip_count,
                                                     distributed,
                                                     get_device)
    from distributedmnist_tpu_torch.utils.device import resolve_device

    distributed.maybe_initialize(None, None, None,
                                 resolve_device(args.device).type)
    device = get_device(args.device, getattr(args, "num_devices", None))
    world = distributed.process_count()
    n_chips = chip_count(device)
    _mark(f"backend up: {world}x {device.type}" + (
        f" on {n_chips} chip(s) over {distributed.topology().backend}"
        if world > 1 else ""))
    return device, world, n_chips


def _emit(record: dict) -> None:
    """The mode's one JSON record, printed by rank 0 only."""
    from distributedmnist_tpu_torch.parallel import distributed

    if distributed.process_index() == 0:
        print(json.dumps(record), flush=True)


class _Runner:
    """This rank's device, data and model for the throughput and sweep
    modes; measure() gives the median images/sec a chip over timed
    windows from a fresh state, the ranks stepping together."""

    def __init__(self, args, data=None):
        from distributedmnist_tpu_torch.data import DeviceDataset, load_mnist
        from distributedmnist_tpu_torch.parallel import distributed

        # An explicit --bench-steps is honoured exactly; the default
        # window scales with the block depth so that the in-flight cap
        # binds within it.
        self.user_bench_steps = args.bench_steps is not None
        self.device, self.world, self.n_chips = _join(args)
        self.rank = distributed.process_index()
        self.on_cpu = self.device.type == "cpu"
        self.model = args.model
        self.dtype = args.dtype
        data = data if data is not None else load_mnist(
            args.data_dir, synthetic=args.data_dir is None, seed=0)
        # the trainer's defaults: packed pixel rows on the device, the
        # whole set on every rank
        self.ds = DeviceDataset(data, self.device, pixel_format="packed")
        # On the CPU every op has finished when it returns: one step a
        # block, one block in flight. The card takes 16, as trainer.fit.
        self.max_inflight = 1 if self.on_cpu else 16

    def stepper(self, gb: int, params=None):
        """run_block(k) -> the last step's loss over this rank's columns
        (a tensor on the device): k Adam steps at lr 1e-3 at global batch
        gb on the device-resident set, from a fresh model (seed-0 init,
        or `params`) and a fresh IndexStream(seed=0). Over ranks the step
        is the trainer's data-parallel one (DDP, the JAX step's 'auto'
        mode), each rank taking its columns of every global batch."""
        from distributedmnist_tpu_torch import models, optim, trainer
        from distributedmnist_tpu_torch.data import IndexStream

        net = models.build(self.model, dtype=self.dtype, device=self.device)
        net.load_state_dict(params if params is not None
                            else models.init_params(self.model, 0))
        optimizer, scheduler = optim.build("adam", net.parameters(),
                                           optim.make_schedule(1e-3))
        step = trainer.data_parallel_step(
            net, optimizer, scheduler, self.ds.pixel_format, 1, "auto",
            self.device, dtype=models.DTYPES[self.dtype])
        stream = IndexStream(self.ds.train_n, gb, seed=0)
        train_x, train_y = self.ds.train_x, self.ds.train_y

        def run_block(k: int):
            idx = stream.next_block(k, self.device, self.rank, self.world)
            for i in range(k):
                loss = step(train_x, train_y, idx[i])
            return loss
        return run_block

    def measure(self, args, gb: int, bench_steps: int) -> dict:
        import torch

        from distributedmnist_tpu_torch.parallel import distributed
        from distributedmnist_tpu_torch.utils import StepTimer
        from distributedmnist_tpu_torch.utils.device import training_numerics

        if args.steps_per_call is not None:
            spc = max(1, args.steps_per_call)
        elif self.on_cpu:
            spc = 1
        else:
            # the root bench's block depth: about 1024 x 512 rows of a
            # rank's batch a block
            spc = min(4096, max(256, 1024 * 512 // max(1, gb // self.world)))
        # The default window spans 32 blocks, twice the in-flight cap, so
        # the cap binds for its second half whatever spc is.
        if not self.user_bench_steps and not self.on_cpu:
            bench_steps = max(bench_steps, 32 * spc)
        inflight: list = []

        def run(run_block, n_steps: int) -> int:
            """>= n_steps steps in blocks of spc, at most max_inflight
            blocks queued (one CUDA event a block, as trainer.fit); the
            clock stops on a value fetch of the last block's loss.
            Returns the steps run."""
            blocks = max(1, -(-n_steps // spc))
            loss = None
            for _ in range(blocks):
                while len(inflight) >= self.max_inflight:
                    StepTimer.barrier(inflight.pop(0))
                loss = run_block(spc)
                if not self.on_cpu:
                    event = torch.cuda.Event()
                    event.record()
                    inflight.append(event)
            loss.item()
            inflight.clear()
            return blocks * spc

        repeats = (args.repeats if args.repeats is not None
                   else (1 if self.on_cpu else 3))
        windows = []
        n_run = 0
        with training_numerics():
            run_block = self.stepper(gb)
            _mark(f"b={gb}: warmup, spc={spc}")
            run(run_block, args.warmup_steps)
            for r in range(repeats):
                t0 = time.perf_counter()
                n_run = run(run_block, bench_steps)
                # a window ends when the last rank has its last loss: one
                # all-reduce after every clock has stopped
                seconds = distributed.max_float(time.perf_counter() - t0,
                                                self.device)
                windows.append(n_run * gb / seconds / self.n_chips)
                _mark(f"b={gb} window {r + 1}/{repeats}: "
                      f"{windows[-1]:.0f} img/s/chip")
        value = statistics.median(windows)
        return {"img_s_chip": value, "windows": windows,
                "bench_steps": n_run, "steps_per_call": spc,
                "step_ms": (1000 * gb / value / self.n_chips
                            if value else None)}


def _throughput(args) -> int:
    from distributedmnist_tpu_torch.utils import round_up

    r = _Runner(args)
    gb = round_up(args.global_batch, r.world)
    if args.bench_steps is None:
        args.bench_steps = 64 if r.on_cpu else 8192
    m = r.measure(args, gb, args.bench_steps)
    value = m["img_s_chip"]
    _emit({
        "metric": "train_images_per_sec_per_chip",
        "value": round(value, 1),
        "unit": "images/sec/chip",
        # the root bench's TARGET_IPS_PER_CHIP is a TPU target: no baseline
        # for the port
        "vs_baseline": None,
        "detail": {
            "model": args.model,
            "data": r.ds.source,
            "global_batch": gb,
            "n_chips": r.n_chips,
            "backend": r.device.type,
            "dtype": args.dtype,
            "bench_steps": m["bench_steps"],
            "steps_per_call": m["steps_per_call"],
            "step_ms": (round(m["step_ms"], 3)
                        if m["step_ms"] is not None else None),
            "windows_img_s_chip": [round(w, 1) for w in m["windows"]],
        },
    })
    return 0


# -- time-to-accuracy ---------------------------------------------------------


def tta_config(args, gb: int):
    """The tuned time-to-accuracy recipe as a Config, the root bench's
    tta_config: LeNet-5 (or --model) with Adam at lr 6e-3, cosine decay
    pinned at TTA_DECAY_STEPS, an eval every 200 steps, on synthetic
    data; a trial runs --max-epochs, never past the decay horizon (where
    the lr has reached 0)."""
    from distributedmnist_tpu_torch.config import Config

    # the cap is the 60k-row task's; a --data-dir of unknown size keeps
    # the plain epochs budget
    steps = None
    if args.data_dir is None:
        steps = min(args.max_epochs * (60_000 // gb), TTA_DECAY_STEPS)
    return Config(model=args.model, optimizer="adam", learning_rate=6e-3,
                  lr_schedule="cosine", lr_decay_steps=TTA_DECAY_STEPS,
                  data_dir=args.data_dir, synthetic=args.data_dir is None,
                  batch_size=gb, epochs=args.max_epochs, steps=steps,
                  eval_every=200, log_every=0,
                  target_accuracy=args.target_accuracy,
                  steps_per_call=args.steps_per_call, device=args.device,
                  dtype=args.dtype)


def _time_to_accuracy(args) -> int:
    import logging

    from distributedmnist_tpu_torch import trainer
    from distributedmnist_tpu_torch.utils import round_up

    logging.basicConfig(level=logging.INFO, stream=sys.stderr)
    # each trial's fit runs data-parallel over the ranks joined here
    device, world, n_chips = _join(args)
    gb = round_up(args.global_batch, world)
    cfg = tta_config(args, gb)
    # Distinct seeds (init and batch order): seed sensitivity is the risk
    # a run-to-target claim carries.
    trials = (args.trials if args.trials is not None
              else (1 if device.type == "cpu" else 3))
    walls, reached_flags, finals, steps_list = [], [], [], []
    trial_results = []
    out = None
    for t in range(trials):
        seed = cfg.seed + t
        out = trainer.fit(cfg.replace(seed=seed))
        wall = out["wall_clock_to_target_s"]
        reached = wall is not None
        # a missed run reports fit()'s own training clock, the same span
        walls.append(wall if reached else out["wall_clock_s"])
        reached_flags.append(reached)
        finals.append(out["test_accuracy"])
        steps_list.append(out["steps"])
        trial_results.append({
            "seed": seed, "wall_s": round(walls[-1], 2),
            "steps": out["steps"], "evals": out["n_evals"],
            "reached": reached,
            "final_accuracy": round(out["test_accuracy"], 4)})
        _mark(f"trial {t + 1}/{trials} (seed {seed}): {walls[-1]:.2f}s "
              f"(reached={reached})")
    value = statistics.median(walls)
    reached_steps = [s for s, r in zip(steps_list, reached_flags) if r]
    _emit({
        "metric": "wall_clock_to_target_accuracy",
        "value": round(value, 2),
        "unit": "seconds",
        # the root bench's TARGET_WALL_S is a TPU target: no baseline for
        # the port
        "vs_baseline": None,
        "detail": {
            "reached_target": all(reached_flags),
            "target_accuracy": args.target_accuracy,
            "trials": trials,
            "trials_s": [round(w, 2) for w in walls],
            # steps and evals to target are properties of the code and
            # the recipe; wall seconds move with the host
            "steps_to_target_median": (int(statistics.median(
                reached_steps)) if reached_steps else None),
            "steps_to_target": reached_steps,
            "evals_to_target": [t["evals"] for t in trial_results
                                if t["reached"]],
            "wall_s_is_weather_dependent": True,
            "trial_results": trial_results,
            "min_s": round(min(walls), 2),
            "max_s": round(max(walls), 2),
            "final_accuracy": round(finals[-1], 4),
            "steps": steps_list[-1],
            "data": out["data"],
            "model": args.model,
            "global_batch": out["global_batch"],
            "n_chips": n_chips,
            "backend": device.type,
            "dtype": args.dtype,
        },
    })
    return 0


# -- sweep and smoke ----------------------------------------------------------


def _sweep(args) -> int:
    """The batch sweep and the root bench's 8-card scaling estimate.

    Each point b of --sweep-batches is a per-rank batch: the global batch
    is b x ranks, so the curve means the same thing on one rank and on
    several. A per-card batch b on 1 card is the same step as global
    batch 8b on 8 cards but for the gradient all-reduce. On one rank the
    estimate adds it as a model: ring all-reduce time
    2 * grad_bytes * (8 - 1) / 8 over the bus bandwidth NCCL measured
    among this host's cards (ALLREDUCE_BUS_GBPS). Over ranks the measured
    step already holds the real all-reduce, so the model is reported
    (allreduce_ms_est) and not added. Strong scaling holds the global
    batch at 8x the smallest per-card batch, weak scaling the per-card
    batch at the curve's peak (and, for a fixed anchor, at the largest);
    the band recomputes the prediction at 1x and 2x the modelled
    all-reduce and 0.8-1.2x the measured step."""
    from distributedmnist_tpu_torch import models

    r = _Runner(args)
    if args.bench_steps is None:
        args.bench_steps = 64 if r.on_cpu else 8192
    curve = {}
    for b in args.sweep_batches:
        m = r.measure(args, b * r.world, args.bench_steps)
        curve[b] = {"img_s_chip": round(m["img_s_chip"], 1),
                    "step_ms": round(m["step_ms"], 4),
                    "steps_per_call": m["steps_per_call"]}

    n_params = sum(math.prod(s)
                   for s in models.full_shapes(args.model).values())
    grad_bytes = n_params * 4
    bus_gbps = ALLREDUCE_BUS_GBPS[args.model]
    allreduce_ms = 2 * grad_bytes * (8 - 1) / 8 / (bus_gbps * 1e9) * 1e3
    # over ranks the all-reduce is in the measured step: adding the model
    # would count it twice
    modeled = r.world == 1
    modeled_ms = allreduce_ms if modeled else 0.0
    smallest, largest = min(curve), max(curve)
    peak = max(curve, key=lambda b: curve[b]["img_s_chip"])
    strong_step_ms = curve[smallest]["step_ms"] + modeled_ms
    strong_img_s_chip = smallest / strong_step_ms * 1e3

    def _weak_block(b: int) -> dict:
        step_ms = curve[b]["step_ms"] + modeled_ms
        img_s_chip = b / step_ms * 1e3
        return {
            "per_chip_batch": b,
            "global_batch_8chip": 8 * b,
            "step_ms": round(step_ms, 4),
            "img_s_chip": round(img_s_chip, 1),
            "global_img_s": round(8 * img_s_chip, 1),
            "efficiency_vs_1chip": round(
                img_s_chip / curve[b]["img_s_chip"], 4),
        }

    def _band(base_ms: float, per_chip_b: int) -> list:
        preds = [per_chip_b / (base_ms * f + ar * modeled_ms) * 1e3
                 for f in (0.8, 1.0, 1.2) for ar in (1, 2)]
        return [round(min(preds), 1), round(max(preds), 1)]

    _emit({
        "metric": "predicted_8chip_images_per_sec_per_chip",
        "value": round(strong_img_s_chip, 1),
        "unit": "images/sec/chip",
        # the root bench's TARGET_IPS_PER_CHIP is a TPU target
        "vs_baseline": None,
        "detail": {
            "model": args.model,
            "backend": r.device.type,
            "dtype": args.dtype,
            "n_chips_measured": r.n_chips,
            "curve_img_s_chip": {str(k): v for k, v in curve.items()},
            "n_params": n_params,
            "grad_bytes_f32": grad_bytes,
            # the root bench's key: here NCCL's measured bus bandwidth
            # among this host's own cards
            "ici_assumed_gbps": bus_gbps,
            "allreduce_ms_est": round(allreduce_ms, 4),
            "allreduce_modeled": modeled,
            "strong_scaling": {
                "per_chip_batch": smallest,
                "global_batch_8chip": 8 * smallest,
                "step_ms": round(strong_step_ms, 4),
                "img_s_chip": round(strong_img_s_chip, 1),
                "global_img_s": round(8 * strong_img_s_chip, 1),
            },
            "weak_scaling": {"anchor": "peak", **_weak_block(peak)},
            "weak_scaling_at_largest": {"anchor": "largest",
                                        **_weak_block(largest)},
            "prediction_range": {
                "strong_img_s_chip": _band(curve[smallest]["step_ms"],
                                           smallest),
                "weak_img_s_chip": _band(curve[peak]["step_ms"], peak),
                "grid": {"allreduce_x": [1, 2],
                         "fixed_cost_x": [0.8, 1.0, 1.2]},
            },
        },
    })
    return 0


SMOKE_STEPS, SMOKE_RESUME_TO, SMOKE_FLOOR = 64, 96, 0.85


def _smoke(args) -> int:
    """The end-to-end gate of the root bench's smoke mode: trainer.fit for
    64 steps (evals and checkpoints every 32), then a restore that
    resumes to step 96, whose test accuracy must reach 0.85 (96 Adam
    steps reach about 0.95 on the synthetic set: a regression that still
    completes must fail). Over ranks both fits run data-parallel on one
    checkpoint directory (rank 0 writes it), and every rank restores."""
    import logging
    import shutil
    import tempfile

    from distributedmnist_tpu_torch import trainer
    from distributedmnist_tpu_torch.config import Config
    from distributedmnist_tpu_torch.parallel import distributed
    from distributedmnist_tpu_torch.utils import round_up

    logging.basicConfig(level=logging.INFO, stream=sys.stderr)
    device, world, n_chips = _join(args)
    gb = round_up(min(args.global_batch, 256), world)
    legs = []
    rank0 = distributed.process_index() == 0
    ckpt_dir = distributed.broadcast_object(
        tempfile.mkdtemp(prefix="bench-smoke-") if rank0 else None, device)
    try:
        cfg = Config(model=args.model, optimizer="adam",
                     learning_rate=1e-3, synthetic=args.data_dir is None,
                     data_dir=args.data_dir, batch_size=gb,
                     steps=SMOKE_STEPS, eval_every=32, log_every=0,
                     target_accuracy=None, checkpoint_dir=ckpt_dir,
                     checkpoint_every=32, dtype=args.dtype,
                     device=args.device)
        out1 = trainer.fit(cfg)
        if out1["steps"] != SMOKE_STEPS:
            raise RuntimeError(f"smoke: the first run ended at step "
                               f"{out1['steps']}: {out1}")
        legs += ["train", "eval", "checkpoint-save"]
        _mark("first run done; restoring and resuming")
        out2 = trainer.fit(cfg.replace(steps=SMOKE_RESUME_TO))
        if not (out2["restored"] and out2["steps"] == SMOKE_RESUME_TO):
            raise RuntimeError(f"smoke: the resume did not restore and "
                               f"reach step {SMOKE_RESUME_TO}: {out2}")
        legs.append("restore-resume")
        if out2["test_accuracy"] < SMOKE_FLOOR:
            raise RuntimeError(f"smoke accuracy floor: "
                               f"{out2['test_accuracy']:.4f} < "
                               f"{SMOKE_FLOOR}")
        legs.append("accuracy-floor")
        # every rank is done with the directory before rank 0 removes it
        distributed.agree_max(0, device)
    finally:
        if rank0:
            shutil.rmtree(ckpt_dir, ignore_errors=True)
    _emit({
        "metric": "smoke",
        "value": 1.0,
        "unit": "ok",
        "vs_baseline": None,
        "detail": {
            "backend": device.type,
            "n_chips": n_chips,
            "model": args.model,
            "data": out2["data"],
            "legs": legs,
            "final_accuracy": round(out2["test_accuracy"], 4),
            # the first run's: a 64-step window broken by evals and
            # checkpoint copies, far below the steady state (throughput
            # mode), as the flags below say
            "images_per_sec_per_chip":
                round(out1["images_per_sec_per_chip"], 1),
            "short_window": True,
            "window_steps": SMOKE_STEPS,
        },
    })
    return 0


# -- serve --------------------------------------------------------------------


def _serve_closed_loop(batcher, metrics, reqs, clients: int,
                       duration: float, min_requests: int = 0) -> dict:
    """Closed loop: each client waits for its result before its next
    submit, so concurrency == clients and the batcher coalesces to its
    natural occupancy. `reqs` is the list of request arrays the clients
    cycle through. An unmeasured ramp absorbs the phase's cold start
    before metrics.reset(). With `min_requests` the clients run on past
    `duration` until that many requests have been answered after the
    ramp (at most CLOSED_LOOP_MAX_S more): a ratio taken over the phase
    then counts enough batches even on a slow host."""
    from distributedmnist_tpu_torch.serve import Rejected

    client_errors: list = []
    answered: list = []              # list.append is atomic: the count
    ramp = min(0.5, duration * 0.2)
    # The window is timed from metrics.reset(), once every client runs:
    # on a busy host starting the clients can outlast ramp + duration,
    # and a clock started before them measured an empty window.
    window = {"measuring": False, "stop_at": float("inf"),
              "give_up": float("inf")}

    def running() -> bool:
        now = time.monotonic()
        return now < window["stop_at"] or (len(answered) < min_requests
                                           and now < window["give_up"])

    def client(offset: int):
        k = offset                  # stagger starts so the size mix
        while running():            # interleaves across clients
            try:
                batcher.submit(reqs[k % len(reqs)]).result(timeout=120)
                k += 1
                if window["measuring"]:
                    answered.append(1)
            except Rejected:
                time.sleep(0.001)   # shed: brief client backoff
            except BaseException as e:
                # a dead client deflates the headline silently: record it
                # and fail the bench after the join
                client_errors.append(e)
                return

    threads = [make_thread(target=client, args=(i,),
                           name=f"bench-client-{i}", daemon=True)
               for i in range(clients)]
    for t in threads:
        t.start()
    time.sleep(ramp)
    metrics.reset()                  # measurement starts post-ramp
    t_reset = time.monotonic()
    window["measuring"] = True
    window["give_up"] = t_reset + duration + CLOSED_LOOP_MAX_S
    window["stop_at"] = t_reset + duration
    for t in threads:
        t.join()
    if client_errors:
        raise RuntimeError(
            f"{len(client_errors)} of {clients} closed-loop clients died; "
            "the capacity headline would be measured against a degraded "
            "pool") from client_errors[0]
    # Clients unblock at set_result, before the completion thread records
    # the batch's metrics: wait for the in-flight count (which drops only
    # after metrics land) so the final batch is in this snapshot.
    _drain_or_die(batcher, timeout=120)
    return metrics.snapshot()


def _drain_or_die(batcher, timeout: float) -> None:
    """Bounded wait for an empty queue and zero batches in flight (every
    future resolved, every metrics record landed). A wedged pipeline
    fails the bench instead of hanging it."""
    deadline = time.monotonic() + timeout
    while batcher.pending_rows() or batcher.inflight_batches():
        if time.monotonic() > deadline:
            raise RuntimeError(
                f"serve pipeline failed to drain within {timeout:g}s "
                f"({batcher.pending_rows()} rows pending, "
                f"{batcher.inflight_batches()} batches in flight) — "
                "wedged dispatch/fetch?")
        time.sleep(0.005)


def _serve_open_loop(batcher, metrics, reqs, qps: float, duration: float,
                     max_wait_us: int) -> tuple[int, dict]:
    """Open loop: Poisson arrivals at `qps`, cycling through `reqs`.
    Submissions do not wait for results, so queue growth and rejections
    show when the rate exceeds capacity. Returns (submitted, the metrics
    snapshot after the pipeline drained)."""
    import random

    from distributedmnist_tpu_torch.serve import Rejected

    arrivals = random.Random(0)
    metrics.reset()
    t_end = time.monotonic() + duration
    next_t = time.monotonic()
    submitted = 0
    while next_t < t_end:
        now = time.monotonic()
        if next_t > now:
            time.sleep(next_t - now)
        try:
            batcher.submit(reqs[submitted % len(reqs)])
            submitted += 1
        except Rejected:
            pass                # recorded by metrics
        next_t += arrivals.expovariate(qps)
    _drain_or_die(batcher, timeout=120 + max_wait_us / 1e6)
    return submitted, metrics.snapshot()


def _serve_ragged_leg(router, metrics, factory, make_batcher,
                      pipelined: int, clients: int, duration: float,
                      qps: float, max_wait_us: int,
                      max_size: int = 20) -> dict:
    """The batch former's leg: one fixed mixed-size request stream (sizes
    uniform on 1..min(20, max_batch), seed 7) replayed closed-loop and
    open-loop at a sub-capacity rate, with the former off (each drain in
    its covering bucket) and on (split where the cost table says
    splitting beats padding), adaptation off in both. Both coalesce for
    one full batch's fitted service time, so that drains hold several
    requests for the former to cut."""
    import numpy as np

    from distributedmnist_tpu_torch.serve.scheduler import fit_dispatch_cost

    max_size = min(max_size, factory.max_batch)
    rng = np.random.default_rng(7)
    sizes = [int(s) for s in rng.integers(1, max_size + 1, 256)]
    reqs = [rng.integers(0, 256, (n, 28, 28, 1), dtype=np.uint8)
            for n in sizes]
    overhead_s, per_row_s = fit_dispatch_cost(router.bucket_costs())
    ragged_wait_us = max(max_wait_us, int(
        (overhead_s + per_row_s * factory.buckets[-1]) * 1e6))

    def phase(split: bool) -> dict:
        tag = "former-on" if split else "former-off"
        b = make_batcher(pipelined, split=split, adaptive=False,
                         wait_us=ragged_wait_us)
        try:
            _mark(f"ragged closed loop [{tag}]: {clients} clients x "
                  f"{duration:g}s, sizes U[1,{max_size}], wait "
                  f"{ragged_wait_us}us")
            closed = _serve_closed_loop(b, metrics, reqs, clients,
                                        duration)
            _mark(f"ragged open loop [{tag}] qps={qps:g}")
            _, openl = _serve_open_loop(b, metrics, reqs, qps, duration,
                                        ragged_wait_us)
        finally:
            b.stop()
        keep = ("rows_per_sec", "requests_per_sec", "latency_ms",
                "padding_waste_ratio", "padded_rows", "dispatched_rows",
                "bucket_dispatches", "mean_rows_per_batch", "batches",
                "rejected_requests")
        return {"closed": {k: closed[k] for k in keep},
                "open": {k: openl[k] for k in keep}}

    off = phase(split=False)
    on = phase(split=True)

    def ratio(a, b):
        return round(a / b, 3) if a is not None and b else None

    leg = {
        "sizes": f"uniform[1..{max_size}]",
        "seed": 7,
        "open_loop_qps": qps,
        "coalesce_wait_us": ragged_wait_us,
        "former_off": off,
        "former_on": on,
        "closed_waste_off": off["closed"]["padding_waste_ratio"],
        "closed_waste_on": on["closed"]["padding_waste_ratio"],
        "closed_waste_reduction_x": ratio(
            off["closed"]["padding_waste_ratio"],
            on["closed"]["padding_waste_ratio"]),
        "closed_goodput_ratio": ratio(on["closed"]["rows_per_sec"],
                                      off["closed"]["rows_per_sec"]),
        "open_waste_off": off["open"]["padding_waste_ratio"],
        "open_waste_on": on["open"]["padding_waste_ratio"],
        "open_waste_reduction_x": ratio(
            off["open"]["padding_waste_ratio"],
            on["open"]["padding_waste_ratio"]),
    }
    _mark(f"ragged: closed waste {leg['closed_waste_off']} -> "
          f"{leg['closed_waste_on']}, goodput ratio "
          f"{leg['closed_goodput_ratio']}; open waste "
          f"{leg['open_waste_off']} -> {leg['open_waste_on']}")
    return leg


class _BuildCounter:
    """The port's compile-event count: kernel-library builds and loads
    plus the tracked factories' engine builds (the HTTP server's
    compiles_total). snapshot() deltas around a window must be 0 in
    steady state."""

    def __init__(self, *factories):
        self.factories = list(factories)

    def track(self, *factories) -> None:
        """Count these factories' engine builds too (a leg's own)."""
        self.factories.extend(factories)

    def snapshot(self) -> int:
        from distributedmnist_tpu_torch.ops import kernel_lib

        return kernel_lib.load_events() + sum(f.engine_builds
                                              for f in self.factories)


def _serve_zipf_leg(router, metrics, factory, make_batcher,
                    pipelined: int, clients: int, duration: float,
                    cache_on: bool = True,
                    cache_capacity: int = 4096) -> dict:
    """The hot-key leg (the root bench's): one seeded Zipf request mix
    (64 keys, s=1.1, seed 29) driven closed-loop with the prediction
    cache front off, then on (LRU + single-flight + intra-batch dedup),
    over the same request sequence. Byte-identity is checked in the leg:
    a fresh probe's computed response and its cached repeat must be the
    same bytes. `cache_on=False` (--zipf-cache-off) runs only the control
    phase."""
    import numpy as np

    from distributedmnist_tpu_torch.serve.cache import (CacheFront,
                                                        PredictionCache)

    n_keys = 64
    zipf_s = 1.1
    rng = np.random.default_rng(29)
    max_rows = min(4, factory.max_batch)
    keys = [rng.integers(0, 256, (int(sz), 28, 28, 1), dtype=np.uint8)
            for sz in rng.integers(1, max_rows + 1, n_keys)]
    weights = 1.0 / np.arange(1, n_keys + 1) ** zipf_s
    weights /= weights.sum()
    order = rng.choice(n_keys, size=2048, p=weights)
    reqs = [keys[i] for i in order]

    def keep(snap: dict) -> dict:
        return {"rows_per_sec": snap["rows_per_sec"],
                "requests_per_sec": snap["requests_per_sec"],
                "latency_ms": snap["latency_ms"],
                "requests": snap["requests"],
                "batches": snap["batches"],
                "dispatched_rows": snap["dispatched_rows"],
                "rejected_requests": snap["rejected_requests"]}

    b = make_batcher(pipelined, adaptive=False)
    try:
        _mark(f"zipf closed loop [cache off]: {clients} clients x "
              f"{duration:g}s, {n_keys} keys, s={zipf_s}")
        off = keep(_serve_closed_loop(b, metrics, reqs, clients, duration))
    finally:
        b.stop()
    leg = {
        "distinct_keys": n_keys,
        "zipf_s": zipf_s,
        "seed": 29,
        "max_rows_per_request": max_rows,
        "clients": clients,
        "duration_s": duration,
        "cache_enabled": cache_on,
        "cache_capacity": cache_capacity if cache_on else None,
        "cache_off": off,
        "cache_on": None,
    }
    if not cache_on:
        _mark(f"zipf [cache off only]: {off['rows_per_sec']:.0f} rows/s, "
              f"p99 {off['latency_ms']['p99']} ms, {off['batches']} "
              "device dispatches")
        return leg

    cache = PredictionCache(cache_capacity)
    b2 = make_batcher(pipelined, adaptive=False, dedup=True)
    front = CacheFront(b2, router, cache, metrics=metrics)
    parity_probes = 0
    parity_ok = True
    try:
        _mark(f"zipf closed loop [cache on]: {clients} clients x "
              f"{duration:g}s (capacity {cache_capacity})")
        on_snap = _serve_closed_loop(front, metrics, reqs, clients,
                                     duration)
        probe_rng = np.random.default_rng(31)
        for _ in range(8):
            probe = probe_rng.integers(0, 256, (2, 28, 28, 1),
                                       dtype=np.uint8)
            computed = front.submit(probe).result(timeout=60)
            cached = front.submit(probe).result(timeout=60)
            parity_probes += 1
            if computed.tobytes() != cached.tobytes():
                parity_ok = False
        _drain_or_die(front, timeout=60)
    finally:
        b2.stop()
    on = keep(on_snap)
    stats = cache.stats()
    hit_ratio = stats["hit_ratio"]
    goodput_x = (round(on["rows_per_sec"] / off["rows_per_sec"], 3)
                 if off["rows_per_sec"] else None)
    leg.update({
        "cache_on": {**on, "cache": stats, "dedup": on_snap["dedup"]},
        # the root bench's bars, unchanged: hit ratio >= 0.5, goodput >=
        # 2x cache-off, fewer device dispatches per request, cached bytes
        # identical to computed ones
        "hit_ratio": hit_ratio,
        "hit_ratio_ok": hit_ratio is not None and hit_ratio >= 0.5,
        "goodput_x": goodput_x,
        "goodput_ok": goodput_x is not None and goodput_x >= 2.0,
        "p99_off_ms": off["latency_ms"]["p99"],
        "p99_on_ms": on["latency_ms"]["p99"],
        "device_dispatches_off": off["batches"],
        "device_dispatches_on": on["batches"],
        "device_dispatches_per_request_off": (
            round(off["batches"] / off["requests"], 4)
            if off["requests"] else None),
        "device_dispatches_per_request_on": (
            round(on["batches"] / on["requests"], 4)
            if on["requests"] else None),
        "device_dispatch_lower": (
            off["requests"] > 0 and on["requests"] > 0
            and (on["batches"] / on["requests"])
            < (off["batches"] / off["requests"])),
        "single_flight_collapsed": stats["collapsed"],
        "parity_probes": parity_probes,
        "parity_ok": parity_ok,
    })
    _mark(f"zipf: hit ratio {hit_ratio} (bar >= 0.5), goodput "
          f"{off['rows_per_sec']:.0f} -> {on['rows_per_sec']:.0f} rows/s "
          f"({goodput_x}x, bar >= 2x), device dispatches "
          f"{off['batches']} -> {on['batches']}, parity "
          f"{'ok' if parity_ok else 'FAILED'} ({parity_probes} probes)")
    return leg


def _serve_lowlat_leg(registry, router, factory, metrics, make_batcher,
                      compiles, duration: float, max_wait_us: int,
                      model: str) -> dict:
    """The single-request leg (the root bench's): ONE closed-loop client
    of 1-row requests through the coalescing path, then through the fast
    lane, then — where the model has it — the fast lane on the
    parity-gated megakernel variant (the one leg that reaches
    mlp_megakernel). An attribution sub-phase runs 64 fast-lane requests
    under a tracer with a 0.5 ms SLO and reports the worst attributed
    fraction of the over-SLO ones. The variant's warmup builds are
    returned for the whole-run recompile exclusion."""
    import numpy as np

    from distributedmnist_tpu_torch.serve import trace as trace_lib
    from distributedmnist_tpu_torch.serve.quantize import variant_supported

    req = np.random.default_rng(11).integers(0, 256, (1, 28, 28, 1),
                                             dtype=np.uint8)
    live = registry.live_version()
    steady_from = compiles.snapshot()
    variant_warmups = 0

    def keep(snap: dict) -> dict:
        return {"requests": snap["requests"],
                "requests_per_sec": snap["requests_per_sec"],
                "latency_ms": snap["latency_ms"],
                "fastpath": snap["fastpath"],
                "staging_ms": snap["staging_ms"],
                "fetch_ms": snap["fetch_ms"]}

    def phase(tag: str, fastlane: bool) -> dict:
        b = make_batcher(1, adaptive=False, fastlane=fastlane)
        try:
            _mark(f"lowlat closed loop [{tag}]: 1 client x {duration:g}s, "
                  f"1-row requests, wait {max_wait_us}us")
            out = keep(_serve_closed_loop(b, metrics, [req], 1, duration))
        finally:
            b.stop()
        _mark(f"lowlat [{tag}]: p50 {out['latency_ms']['p50']} ms, p99 "
              f"{out['latency_ms']['p99']} ms, "
              f"{out['fastpath']['dispatches']} fastpath dispatches over "
              f"{out['requests']} requests")
        return out

    batched = phase("batched", fastlane=False)
    fast = phase("fastlane", fastlane=True)
    mega = None
    mega_parity = None
    if variant_supported(model, "megakernel"):
        _mark("lowlat: warming + gating the megakernel variant")
        before = compiles.snapshot()
        vi = registry.add_variant(live, "megakernel")
        variant_warmups = compiles.snapshot() - before
        mega_parity = vi.parity
        registry.promote(live, infer_dtype="megakernel")
        try:
            mega = phase("fastlane+megakernel", fastlane=True)
        finally:
            registry.promote(live, infer_dtype="float32")

    att_slo_ms = 0.5
    tracer = trace_lib.install(trace_lib.Tracer(capacity=1024, sample=1.0,
                                                slo_ms=att_slo_ms,
                                                seed=23))
    b = make_batcher(1, adaptive=False, fastlane=True)
    try:
        for _ in range(64):
            b.submit(req).result(timeout=60)
        _drain_or_die(b, timeout=60)
    finally:
        b.stop()
        trace_lib.uninstall()
    fracs = [trace_lib.attribute_stages(tr)["attributed_frac"]
             for tr in tracer.traces() if tr["over_slo"]]
    att_min = round(min(fracs), 4) if fracs else None
    census = _span_census(tracer)

    recompiles = compiles.snapshot() - steady_from - variant_warmups
    p50_b = batched["latency_ms"]["p50"]
    p50_f = fast["latency_ms"]["p50"]
    cands = [p for p in (p50_f, (mega or {}).get("latency_ms",
                                                 {}).get("p50"))
             if p is not None]
    improvement = (round(p50_b / p50_f, 3) if p50_b and p50_f else None)
    p99_ok = (fast["latency_ms"]["p99"] is not None
              and batched["latency_ms"]["p99"] is not None
              and fast["latency_ms"]["p99"]
              <= batched["latency_ms"]["p99"])
    leg = {
        "clients": 1,
        "rows_per_request": 1,
        "duration_s": duration,
        "coalesce_wait_us": max_wait_us,
        "batched": batched,
        "fastlane": fast,
        "megakernel": mega,
        "megakernel_parity": mega_parity,
        # the root bench's bars, unchanged: p50 >= 1.5x better, p99 no
        # worse, zero recompiles, >= 0.95 attribution over-SLO
        "p50_batched_ms": p50_b,
        "p50_fastlane_ms": p50_f,
        "p50_best_ms": min(cands) if cands else None,
        "p50_improvement_x": improvement,
        "p50_ok": improvement is not None and improvement >= 1.5,
        "p99_ok": p99_ok,
        "fastpath_dispatches": fast["fastpath"]["dispatches"],
        "fastpath_lane_fraction": fast["fastpath"]["lane_fraction"],
        "recompiles": recompiles,
        "recompiles_ok": recompiles == 0,
        "variant_warmup_compile_events": variant_warmups,
        "attribution": {
            "slo_ms": att_slo_ms,
            "over_slo_requests": len(fracs),
            "min_attributed_frac": att_min,
            "fastpath_spans": census["spans"].get("fastpath", 0),
            "ok": att_min is not None and att_min >= 0.95,
        },
    }
    _mark(f"lowlat: p50 {p50_b} -> {p50_f} ms ({improvement}x, bar >= "
          f"1.5x), p99 {batched['latency_ms']['p99']} -> "
          f"{fast['latency_ms']['p99']} ms, megakernel p50 "
          f"{(mega or {}).get('latency_ms', {}).get('p50')} ms, "
          f"attribution min {att_min} over {len(fracs)} over-SLO "
          f"requests, {recompiles} recompiles")
    return leg


def _trace_attribution_rows(traces: list) -> list:
    """Stage-attribution rows for every given trace, slowest first: total
    wall clock, per-stage blame and the unattributed residue."""
    from distributedmnist_tpu_torch.serve import trace as trace_lib

    rows = []
    for t in sorted(traces, key=lambda t: -t["duration_ms"]):
        att = trace_lib.attribute_stages(t)
        rows.append({
            "trace_id": t["trace_id"],
            "status": t["status"],
            "over_slo": t["over_slo"],
            "total_ms": round(t["duration_ms"], 3),
            "stages_ms": {k: round(v, 3)
                          for k, v in sorted(att["stages_ms"].items())},
            "residue_ms": round(att["residue_ms"], 3),
            "attributed_frac": round(att["attributed_frac"], 4),
        })
    return rows


def _span_census(tracer) -> dict:
    """Distinct-span counts by name across every retained trace, and how
    many of each have a parent."""
    seen: set = set()
    census: dict = {}
    parented: dict = {}
    for t in tracer.traces():
        for s in t["spans"]:
            if s["id"] in seen:
                continue
            seen.add(s["id"])
            census[s["name"]] = census.get(s["name"], 0) + 1
            if s["parent"] is not None:
                parented[s["name"]] = parented.get(s["name"], 0) + 1
    return {"spans": census, "parented": parented}


def _serve_trace_leg(router, metrics, factory, make_batcher,
                     pipelined: int, duration: float, qps: float,
                     chrome_events: list) -> dict:
    """The tail-attribution leg (the root bench's): a seeded mixed-size
    open-loop window under a tracer whose SLO is one coalescing wait plus
    two full-batch service times (from the measured cost table), then a
    stage-attribution row for every over-SLO request (the slowest
    retained ones, labelled, when none is over). The leg's Chrome
    trace events go into `chrome_events`, the file the caller writes
    beside its record."""
    import numpy as np

    from distributedmnist_tpu_torch.serve import trace as trace_lib
    from distributedmnist_tpu_torch.serve.scheduler import fit_dispatch_cost

    overhead_s, per_row_s = fit_dispatch_cost(router.bucket_costs())
    svc_s = overhead_s + per_row_s * factory.buckets[-1]
    wait_us = max(2000, int(3e6 / qps), int(svc_s * 1e6))
    slo_ms = wait_us / 1e3 + 2 * svc_s * 1e3
    tracer = trace_lib.install(trace_lib.Tracer(
        capacity=4096, sample=1.0, slo_ms=slo_ms, seed=17))
    rng = np.random.default_rng(11)
    sizes = [int(s) for s in
             rng.integers(1, min(8, factory.max_batch) + 1, 128)]
    reqs = [rng.integers(0, 256, (n, 28, 28, 1), dtype=np.uint8)
            for n in sizes]
    b = make_batcher(pipelined, adaptive=False, wait_us=wait_us)
    try:
        _mark(f"trace leg: open loop qps={qps:g} x {duration:g}s, slo "
              f"{slo_ms:.1f} ms, wait {wait_us} us")
        _serve_open_loop(b, metrics, reqs, qps, duration, wait_us)
    finally:
        b.stop()
        trace_lib.uninstall()
    traces = tracer.traces()
    over = [t for t in traces if t["over_slo"]]
    basis = "over_slo"
    table_src = over
    if not table_src:
        basis = "slowest"
        table_src = traces
    rows = _trace_attribution_rows(table_src)
    # the bar runs over the whole population; only the table is capped
    min_attr = min((r["attributed_frac"] for r in rows), default=None)
    table = rows[:32]
    snap = tracer.snapshot()
    events = tracer.export_chrome()["traceEvents"]
    chrome_events.extend(events)
    n_events = len(events)
    _mark(f"trace: {len(traces)} retained, {len(over)} over-SLO "
          f"(basis {basis}, {len(rows)} checked); min attributed frac "
          f"{min_attr}; {n_events} Chrome trace events")
    return {
        "slo_ms": round(slo_ms, 3),
        "coalesce_wait_us": wait_us,
        "qps": qps,
        "sample": 1.0,
        "requests_traced": snap["requests_finished"],
        "traces_retained": len(traces),
        "over_slo_requests": len(over),
        "attribution_basis": basis,
        "attribution_checked": len(rows),
        "attribution": table,
        "min_attributed_frac": min_attr,
        # the root bench's bar: >= 95% of each over-SLO request's wall
        # clock attributed to named stages
        "attribution_ok": min_attr is not None and min_attr >= 0.95,
        "open_spans_at_drain": snap["open_spans"],
        "span_census": _span_census(tracer)["spans"],
    }


def _serve_fleet_leg(fleet, metrics, make_batcher, clients: int,
                     duration: float, req) -> dict:
    """The replica-scaling leg (the root bench's): the same fleet
    closed-loop twice, first with every replica but r0 drained (the
    replicas=1 baseline on the same warm engines, the drain/rejoin admin
    path exercised under load), then whole: per-replica dispatch balance
    (the pick must spread within 25%) and scaling efficiency (fleet
    capacity over N x one replica's; below 1 for replicas sharing one
    card, which the record's provenance shows)."""
    ids = fleet.replica_ids()
    for rid in ids[1:]:
        fleet.drain(rid)
    b = make_batcher(fleet.per_replica_inflight)
    try:
        _mark(f"fleet closed loop [1/{len(ids)} replicas]: {clients} "
              f"clients x {duration:g}s")
        single = _serve_closed_loop(b, metrics, [req], clients, duration)
    finally:
        b.stop()
    for rid in ids[1:]:
        fleet.rejoin(rid)
    before = {r["id"]: r["dispatched_batches"]
              for r in fleet.snapshot()["replicas"]}
    b = make_batcher(fleet.max_inflight_total)
    try:
        _mark(f"fleet closed loop [{len(ids)} replicas]: {clients} "
              f"clients x {duration:g}s (at least "
              f"{FLEET_LEG_MIN_REQUESTS * len(ids)} requests)")
        # the balance ratio counts batches: a short phase on a slow host
        # can run a handful a replica, where one batch more is past 1.25
        full = _serve_closed_loop(b, metrics, [req], clients, duration,
                                  min_requests=(FLEET_LEG_MIN_REQUESTS
                                                * len(ids)))
    finally:
        b.stop()
    counts = {r["id"]: r["dispatched_batches"] - before[r["id"]]
              for r in fleet.snapshot()["replicas"]}
    lo, hi = min(counts.values()), max(counts.values())
    balance_ratio = round(hi / lo, 3) if lo else None
    single_rate = single["rows_per_sec"]
    efficiency = (round(full["rows_per_sec"]
                        / (len(ids) * single_rate), 3)
                  if single_rate else None)
    leg = {
        "replicas": len(ids),
        "single_replica_rows_per_sec": single_rate,
        "fleet_rows_per_sec": full["rows_per_sec"],
        "scaling_efficiency": efficiency,
        "per_replica_dispatches": counts,
        "dispatch_balance_ratio": balance_ratio,
        # the root bench's bar: per-replica dispatches within 25%
        "balance_ok": (balance_ratio is not None
                       and balance_ratio <= 1.25),
        "single_latency_ms": single["latency_ms"],
        "fleet_latency_ms": full["latency_ms"],
    }
    _mark(f"fleet: {single_rate:.0f} -> {full['rows_per_sec']:.0f} "
          f"rows/s over {len(ids)} replicas (efficiency {efficiency}), "
          f"dispatch balance {counts} (ratio {balance_ratio})")
    return leg


def _serve_dtype_sweep(registry, router, factory, metrics, make_batcher,
                       compiles, pipelined: int, clients: int,
                       duration: float) -> dict:
    """The inference fast-path leg (the root bench's): warm and gate the
    bfloat16 and int8 variants of the live version, then run float32,
    bfloat16 and int8 closed-loop back to back in this process on one
    seeded mixed-size stream (uniform sizes up to 32) with one
    cost-derived coalescing wait: per-dtype images/s, parity verdicts,
    cost tables and each phase's build count (0: every variant was
    warmed and gated first). A refused variant is reported as skipped
    with its reason, never measured."""
    import numpy as np

    from distributedmnist_tpu_torch.serve.scheduler import fit_dispatch_cost

    version = registry.live_version()
    restore_dtype = router.live_infer_dtype() or "float32"
    max_size = min(32, factory.max_batch)
    rng = np.random.default_rng(11)
    sizes = [int(s) for s in rng.integers(1, max_size + 1, 256)]
    reqs = [rng.integers(0, 256, (n, 28, 28, 1), dtype=np.uint8)
            for n in sizes]
    warmup_events = 0
    skipped = {}
    for dt in ("bfloat16", "int8"):
        # by counter delta around the call: a variant already warmed
        # builds nothing here, a refused one built before its gate ran
        before_compiles = compiles.snapshot()
        try:
            registry.add_variant(version, dt)
        except Exception as e:
            skipped[dt] = f"{type(e).__name__}: {e}"
            _mark(f"dtype sweep: {dt} variant REFUSED ({e})")
        warmup_events += compiles.snapshot() - before_compiles
    overhead_s, per_row_s = fit_dispatch_cost(router.bucket_costs())
    wait_us = max(2000, int(
        (overhead_s + per_row_s * factory.buckets[-1]) * 1e6))
    n_chips = factory.total_chips
    mv = registry.get(version)
    legs = {}
    for dt in ("float32", "bfloat16", "int8"):
        if dt in skipped:
            legs[dt] = {"skipped": skipped[dt]}
            continue
        registry.promote(version, infer_dtype=dt)
        steady = compiles.snapshot()
        b = make_batcher(pipelined, adaptive=False, wait_us=wait_us)
        try:
            _mark(f"dtype sweep closed loop [{dt}]: {clients} clients "
                  f"x {duration:g}s, sizes U[1,{max_size}], wait "
                  f"{wait_us}us")
            closed = _serve_closed_loop(b, metrics, reqs, clients,
                                        duration)
        finally:
            b.stop()
        vi = mv.variants.get(dt)
        legs[dt] = {
            "img_s_chip": round(closed["rows_per_sec"] / n_chips, 1),
            "requests_per_sec": closed["requests_per_sec"],
            "latency_ms": closed["latency_ms"],
            "mean_rows_per_batch": closed["mean_rows_per_batch"],
            "by_dtype": closed["by_dtype"],
            "recompiles_after_warmup": compiles.snapshot() - steady,
            "bucket_cost_ms": {str(bk): round(c * 1e3, 3)
                               for bk, c in sorted(
                                   router.bucket_costs().items())},
            "parity": vi.parity if vi is not None else None,
        }
        _mark(f"dtype sweep [{dt}]: {legs[dt]['img_s_chip']} img/s/chip "
              f"(p99 {closed['latency_ms']['p99']} ms, "
              f"{legs[dt]['recompiles_after_warmup']} recompiles)")
    registry.promote(version, infer_dtype=restore_dtype)
    f32 = legs.get("float32", {}).get("img_s_chip")
    speedups = {dt: (round(leg["img_s_chip"] / f32, 3)
                     if f32 and "img_s_chip" in leg else None)
                for dt, leg in legs.items() if dt != "float32"}
    measured = {dt: v for dt, v in speedups.items() if v is not None}
    best = max(measured, key=measured.get) if measured else None
    leg = {
        "sizes": f"uniform[1..{max_size}]",
        "seed": 11,
        "coalesce_wait_us": wait_us,
        "clients": clients,
        "duration_s": duration,
        "legs": legs,
        "speedup_vs_float32": speedups,
        "best_dtype": best,
        "best_speedup": measured.get(best),
        # the variants' warmup builds, for the run's recompile exclusion
        "variant_warmup_compile_events": warmup_events,
    }
    _mark(f"dtype sweep: speedups vs f32 {speedups} (best {best})")
    return leg


def _serve_cascade_leg(registry, router, factory, metrics, make_batcher,
                       compiles, pipelined: int, clients: int,
                       duration: float) -> dict:
    """The cascade leg (the root bench's): warm and gate int8, calibrate
    the cascade on the held-out batch, then drive one seeded mixed-size
    stream closed-loop through `exact` (the float32 baseline), `fast`
    (the int8 ceiling), `balanced` (the cascade) and a stressed point
    (the threshold overridden to the stream's median cheap-stage margin,
    about half the rows escalating): the goodput-vs-accuracy frontier.
    Each phase has its own batcher and build count (0: escalations ride
    engines warmup built). The end-to-end argmax agreement with float32
    is measured on the stream. A gate refusal is the leg's result
    (skipped, with the reason)."""
    import numpy as np

    from distributedmnist_tpu_torch.serve.cascade import (CascadeFront,
                                                          softmax_margin)
    from distributedmnist_tpu_torch.serve.scheduler import fit_dispatch_cost

    version = registry.live_version()
    restore_dtype = router.live_infer_dtype() or "float32"
    max_size = min(32, factory.max_batch)
    rng = np.random.default_rng(13)
    sizes = [int(s) for s in rng.integers(1, max_size + 1, 256)]
    reqs = [rng.integers(0, 256, (n, 28, 28, 1), dtype=np.uint8)
            for n in sizes]
    before_compiles = compiles.snapshot()
    try:
        registry.add_variant(version, "int8")
        state = registry.enable_cascade(version)
    except Exception as e:
        warmup = compiles.snapshot() - before_compiles
        _mark(f"cascade leg: REFUSED ({e})")
        return {"skipped": f"{type(e).__name__}: {e}",
                "variant_warmup_compile_events": warmup}
    warmup_events = compiles.snapshot() - before_compiles
    calibrated = dict(state.calibration)
    _mark(f"cascade leg: calibrated threshold "
          f"{state.threshold:.6f} (cheap {state.cheap_dtype}, gate "
          f"composed_agreement {calibrated.get('composed_agreement')}, "
          f"escalation {calibrated.get('escalation_fraction')})")
    # the frontier's ceiling on this host: the full-bucket cost ratio of
    # float32 to the cheap stage, from the warmup tables
    top = factory.buckets[-1]
    registry.promote(version, infer_dtype=state.cheap_dtype)
    cheap_costs = dict(router.bucket_costs())
    registry.promote(version, infer_dtype="float32")
    f32_costs = dict(router.bucket_costs())
    compute_ceiling = (round(f32_costs[top] / cheap_costs[top], 3)
                       if cheap_costs.get(top) and f32_costs.get(top)
                       else None)
    overhead_s, per_row_s = fit_dispatch_cost(f32_costs)
    wait_us = max(2000, int(
        (overhead_s + per_row_s * factory.buckets[-1]) * 1e6))
    n_chips = factory.total_chips
    _mark(f"cascade leg: host compute ceiling {compute_ceiling}x "
          f"(f32 {round(f32_costs[top] * 1e3, 3)} ms vs "
          f"{state.cheap_dtype} {round(cheap_costs[top] * 1e3, 3)} ms "
          f"per {top}-row bucket)")

    # measured agreement and the stressed threshold: every probe request
    # through all three classes on one batcher
    probe = reqs[:64]
    agree = {"fast": 0, "balanced": 0}
    total_rows = 0
    margins: list = []
    b = make_batcher(pipelined, adaptive=False, wait_us=wait_us)
    front = CascadeFront(b, b, router, registry, metrics=metrics)
    try:
        for x in probe:
            futs = {cls: front.submit(x, accuracy_class=cls)
                    for cls in ("exact", "fast", "balanced")}
            out = {cls: f.result(timeout=120) for cls, f in futs.items()}
            ref = out["exact"].argmax(axis=1)
            for cls in ("fast", "balanced"):
                agree[cls] += int((out[cls].argmax(axis=1) == ref).sum())
            margins.extend(
                np.asarray(softmax_margin(out["fast"])).tolist())
            total_rows += x.shape[0]
        _drain_or_die(b, timeout=120)
    finally:
        b.stop()
    agreement = {cls: round(n / total_rows, 5) for cls, n in agree.items()}
    stressed_threshold = float(min(0.999999, max(
        1e-9, float(np.median(np.asarray(margins))))))
    _mark(f"cascade agreement vs f32 on {total_rows} rows: "
          f"balanced {agreement['balanced']}, fast {agreement['fast']}; "
          f"median cheap-stage margin {stressed_threshold:.6f}")

    phases = [("exact", None), ("fast", None), ("balanced", None),
              ("balanced_stressed", stressed_threshold)]
    legs = {}
    for name, override in phases:
        cls = "balanced" if name == "balanced_stressed" else name
        if override is not None:
            try:
                # the same composed gate judges it: a refusal is
                # reported, never measured
                registry.set_cascade_threshold(version, override)
            except RuntimeError as e:
                legs[name] = {"skipped": f"{type(e).__name__}: {e}"}
                _mark(f"cascade [{name}]: override REFUSED ({e})")
                continue
        steady = compiles.snapshot()
        b = make_batcher(pipelined, adaptive=False, wait_us=wait_us)
        front = CascadeFront(b, b, router, registry, metrics=metrics,
                             default_class=cls)
        try:
            _mark(f"cascade closed loop [{name}]: {clients} clients x "
                  f"{duration:g}s, sizes U[1,{max_size}], wait "
                  f"{wait_us}us")
            closed = _serve_closed_loop(front, metrics, reqs, clients,
                                        duration)
        finally:
            b.stop()
        ca = closed.get("cascade", {})
        legs[name] = {
            "accuracy_class": cls,
            "threshold": (override if override is not None
                          else state.threshold),
            "img_s_chip": round(closed["rows_per_sec"] / n_chips, 1),
            "requests_per_sec": closed["requests_per_sec"],
            "latency_ms": closed["latency_ms"],
            "mean_rows_per_batch": closed["mean_rows_per_batch"],
            "by_dtype": closed["by_dtype"],
            "stage_rows": ca.get("stage_rows"),
            "escalation_fraction": ca.get("escalation_fraction"),
            "degraded_requests": ca.get("degraded_requests"),
            "recompiles_after_warmup": compiles.snapshot() - steady,
        }
        _mark(f"cascade [{name}]: {legs[name]['img_s_chip']} img/s/chip "
              f"(p99 {closed['latency_ms']['p99']} ms, escalation "
              f"{legs[name]['escalation_fraction']}, "
              f"{legs[name]['recompiles_after_warmup']} recompiles)")
    # back to the calibrated threshold: the stressed override is an
    # operating point of the bench, not state for a later leg
    final_state = registry.enable_cascade(version)
    registry.promote(version, infer_dtype=restore_dtype)

    f32 = legs.get("exact", {}).get("img_s_chip")
    goodput = {name: (round(leg["img_s_chip"] / f32, 3)
                      if f32 and "img_s_chip" in leg else None)
               for name, leg in legs.items() if name != "exact"}
    cascade_goodput = goodput.get("balanced")
    int8_goodput = goodput.get("fast")
    efficiency = (round(cascade_goodput / int8_goodput, 3)
                  if cascade_goodput and int8_goodput else None)
    leg = {
        "sizes": f"uniform[1..{max_size}]",
        "seed": 13,
        "coalesce_wait_us": wait_us,
        "clients": clients,
        "duration_s": duration,
        "cheap_dtype": state.cheap_dtype,
        "calibration": calibrated,
        "stressed_threshold": stressed_threshold,
        "agreement_vs_f32": agreement,
        "agreement_rows": total_rows,
        "legs": legs,
        "goodput_vs_f32": goodput,
        "host_full_bucket_cost_ms": {
            "float32": round(f32_costs[top] * 1e3, 3),
            state.cheap_dtype: round(cheap_costs[top] * 1e3, 3)},
        "host_compute_ceiling": compute_ceiling,
        # the root bench's bars: cascade goodput >= 1.5x float32 at
        # >= 0.995 measured agreement, and >= 0.9x the int8 ceiling
        "goodput_bar": 1.5,
        "goodput_bar_reachable": (compute_ceiling is not None
                                  and compute_ceiling >= 1.5),
        "goodput_ok": (cascade_goodput is not None
                       and cascade_goodput >= 1.5),
        "cascade_efficiency_vs_fast": efficiency,
        "efficiency_ok": efficiency is not None and efficiency >= 0.9,
        "agreement_ok": agreement["balanced"] >= 0.995,
        "final_threshold": final_state.threshold,
        "variant_warmup_compile_events": warmup_events,
    }
    _mark(f"cascade frontier: goodput vs f32 {goodput} "
          f"(agreement {agreement}, goodput_ok {leg['goodput_ok']}, "
          f"efficiency vs fast {efficiency}, "
          f"agreement_ok {leg['agreement_ok']})")
    if not leg["goodput_bar_reachable"]:
        _mark(f"cascade leg: the 1.5x goodput bar is out of reach on "
              f"this host: the {state.cheap_dtype} compute ceiling is "
              f"{compute_ceiling}x f32; goodput_ok reflects the host")
    return leg


def contention_probe(catalog, n: int = 30) -> dict:
    """The cross-model contention ceiling: the median of `n` MLP router
    dispatches of 8 rows alone, then with a LeNet router storm of 16-row
    dispatches on another thread. Router-direct, no queues: the ratio is
    device and host contention that no scheduler can remove. On the card
    it shows whether the catalog's per-model streams keep the MLP off
    LeNet's queue."""
    import numpy as np

    probe_rng = np.random.default_rng(7)
    xm = probe_rng.integers(0, 256, (8, 28, 28, 1), dtype=np.uint8)
    xl = probe_rng.integers(0, 256, (16, 28, 28, 1), dtype=np.uint8)
    mlp_router = catalog.get("mlp").router
    lenet_router = catalog.get("lenet").router

    def median_infer_ms():
        times = []
        for _ in range(n):
            t0 = time.monotonic()
            mlp_router.infer(xm)
            times.append(time.monotonic() - t0)
        return float(np.median(times)) * 1e3

    alone_ms = median_infer_ms()
    storm_stop = [False]

    def storm():
        while not storm_stop[0]:
            lenet_router.infer(xl)

    t = make_thread(target=storm, name="bench-mm-storm", daemon=True)
    t.start()
    try:
        contended_ms = median_infer_ms()
    finally:
        storm_stop[0] = True
        t.join()
    return {"alone_ms": round(alone_ms, 4),
            "contended_ms": round(contended_ms, 4),
            "contention_x": (round(contended_ms / alone_ms, 3)
                             if alone_ms else None)}


def _serve_multimodel_leg(compiles, device: str, duration: float,
                          rows: int, num_devices=None) -> dict:
    """The multi-tenant leg (the root bench's): MLP and LeNet-5 resident
    in one process behind the global DRR/EDF scheduler, on a catalog and
    scheduler of their own (the main single-model stack is untouched).
    Phase A measures the light tenant's p99 alone; phase B adds a heavy
    burst tenant at the other model; phase C saturates both tenants on
    LeNet for the fairness split. Pumps keep windows of requests
    outstanding (always backlogged), so the granted-row split is the
    scheduler's decision, not client pacing. Bars recorded, not raised:
    light mixed p99 <= 1.5x solo, both fairness ratios in [0.8, 1.25],
    zero builds across the three phases. The catalog's two warmups are
    `warmup_compile_events`, which the caller excludes from its
    whole-run count."""
    import collections
    import threading

    import numpy as np

    from distributedmnist_tpu_torch.config import Config
    from distributedmnist_tpu_torch.serve import ServeMetrics
    from distributedmnist_tpu_torch.serve.tenancy import build_tenancy

    weights = {"light": 2.0, "heavy": 1.0}
    # a quantum well below the head costs: DRR's shares converge to the
    # weights only when affording a head takes several credit scans (one
    # that covers every head at once degenerates to round robin)
    cfg = Config(
        model="mlp", device=device, num_devices=num_devices,
        serve_models="mlp,lenet",
        serve_tenants=(f"light:weight={weights['light']:g},"
                       "deadline_ms=5000,model=mlp;"
                       f"heavy:weight={weights['heavy']:g},"
                       "model=lenet"),
        serve_max_batch=16, serve_max_wait_us=500,
        serve_tenant_quantum_us=200.0)
    metrics = ServeMetrics()
    catalog, sched = build_tenancy(cfg, metrics=metrics)
    compiles.track(*[e.factory for e in catalog.entries()])
    boot_from = compiles.snapshot()
    lat = {"solo": [], "light": [], "heavy": []}
    try:
        for name in catalog.names():     # eager residency, as the server
            catalog.ensure_live(name, seed=cfg.seed)
        # the whole boot delta (both models' engines and kernel-library
        # loads), which the whole-run count excludes
        warmup_compiles = compiles.snapshot() - boot_from
        steady_from = compiles.snapshot()
        _mark(f"multimodel leg: {catalog.names()} resident "
              f"({warmup_compiles} warmup builds); light solo "
              f"{duration:g}s then +heavy burst {duration:g}s")
        probe = contention_probe(catalog)
        contention_x = probe["contention_x"]
        _mark(f"multimodel: cross-model contention ceiling "
              f"{contention_x}x (mlp {probe['alone_ms']:.3f} -> "
              f"{probe['contended_ms']:.3f} ms under a lenet storm)")

        errors: list = []
        # the running phase's window: set once its pumps run (on a busy
        # host starting them can outlast the phase, and a stop time set
        # before them left a late pump no window at all)
        current: dict = {}

        def pump(ready, tenant, window, lats, model=None):
            rng = np.random.default_rng(sum(map(ord, tenant)))
            x = rng.integers(0, 256, (rows, 28, 28, 1), dtype=np.uint8)
            outstanding = collections.deque()
            ready.wait()
            stop_at = current["stop_at"]
            while time.monotonic() < stop_at:
                try:
                    while (len(outstanding) < window
                           and time.monotonic() < stop_at):
                        outstanding.append(
                            (time.monotonic(),
                             sched.submit(x, tenant=tenant,
                                          model=model)))
                    t0, fut = outstanding.popleft()
                    fut.result(timeout=120)
                    lats.append(time.monotonic() - t0)
                except BaseException as e:
                    errors.append(e)
                    return
            while outstanding:
                t0, fut = outstanding.popleft()
                try:
                    fut.result(timeout=120)
                    lats.append(time.monotonic() - t0)
                except BaseException as e:
                    errors.append(e)
                    return

        def start_phase():
            """The phase's window and its grant baseline, taken by the
            last of its pumps to be ready (or the caller)."""
            current["granted0"] = {t: s["granted_rows"] for t, s in
                                   sched.snapshot()["tenants"].items()}
            current["stop_at"] = time.monotonic() + duration

        def phase(pumps):
            """Run one pump a spec (tenant, window, latencies[, model])
            over one window of `duration`, timed once they all run;
            returns each tenant's granted rows in it."""
            ready = threading.Barrier(len(pumps) + 1, action=start_phase)
            threads = [make_thread(target=pump, args=(ready, *spec),
                                   name=f"bench-mm-{spec[0]}",
                                   daemon=True)
                       for spec in pumps]
            for t in threads:
                t.start()
            try:
                ready.wait(timeout=CLIENTS_READY_S)
            except threading.BrokenBarrierError:
                raise RuntimeError(
                    f"the multimodel pumps were not all running within "
                    f"{CLIENTS_READY_S:g} s") from None
            for t in threads:
                t.join()
            granted0 = current["granted0"]
            if errors:
                raise RuntimeError(
                    "multimodel pump died; the fairness split would "
                    "be measured against a degraded tenant") \
                    from errors[0]
            return {t: s["granted_rows"] - granted0[t] for t, s in
                    sched.snapshot()["tenants"].items()}

        def p99_ms(samples):
            return (round(float(np.percentile(samples, 99)) * 1e3, 3)
                    if samples else None)

        # Phase A: the light tenant alone, its uncontended p99.
        phase([("light", 8, lat["solo"])])
        solo_p99 = p99_ms(lat["solo"])
        # Phase B: the same light pump plus a heavy burst at the OTHER
        # model, 8x the outstanding window.
        phase([("light", 8, lat["light"]), ("heavy", 64, lat["heavy"])])
        mixed_p99 = p99_ms(lat["light"])
        # Phase C: both tenants saturated on ONE model (LeNet, the
        # expensive one): the pacing cap keeps their backlogs in the
        # per-tenant queues, so every row that reaches the card got there
        # by a DRR grant.
        granted = phase([("light", 64, [], "lenet"),
                         ("heavy", 64, [], "lenet")])
        recompiles = compiles.snapshot() - steady_from
    finally:
        sched.stop()

    backlogged = {t: w for t, w in weights.items() if granted.get(t)}
    total_rows = sum(granted[t] for t in backlogged) or 1
    total_weight = sum(backlogged.values())
    fairness = {}
    for t, w in backlogged.items():
        # one model in phase C: equal per-row cost, so the row share is
        # the service-time share DRR equalizes
        share = granted[t] / total_rows
        weight_share = w / total_weight
        fairness[t] = {
            "granted_rows": granted[t],
            "dispatch_share": round(share, 4),
            "weight_share": round(weight_share, 4),
            "ratio": round(share / weight_share, 3),
        }
    degradation = (round(mixed_p99 / solo_p99, 3)
                   if mixed_p99 and solo_p99 else None)
    bt = metrics.snapshot()["by_tenant"]
    leg = {
        "models": ["mlp", "lenet"],
        "weights": weights,
        "duration_s_per_phase": duration,
        "rows_per_request": rows,
        "light_solo_p99_ms": solo_p99,
        "light_mixed_p99_ms": mixed_p99,
        "heavy_mixed_p99_ms": p99_ms(lat["heavy"]),
        "light_p99_degradation_x": degradation,
        # a heavy burst degrades the light tenant's p99 by at most 1.5x,
        # reachable only where the two models don't contend for the same
        # card and host (host_contention_x)
        "light_p99_bar": 1.5,
        "host_contention_x": contention_x,
        "light_p99_bar_reachable": (contention_x is not None
                                    and contention_x <= 1.5),
        "light_p99_ok": (degradation is not None
                         and degradation <= 1.5),
        "fairness_model": "lenet",
        "fairness": fairness,
        "fairness_ok": all(0.8 <= f["ratio"] <= 1.25
                           for f in fairness.values()),
        "slo_attainment": {t: bt.get(t, {}).get("slo_attainment")
                           for t in weights},
        "max_skip_observed": sched.max_skip_observed,
        "recompiles_after_warmup": recompiles,
        "warmup_compile_events": warmup_compiles,
    }
    _mark(f"multimodel: light p99 {solo_p99} -> {mixed_p99} ms "
          f"({degradation}x, ok {leg['light_p99_ok']}), fairness "
          f"{ {t: f['ratio'] for t, f in fairness.items()} } "
          f"(ok {leg['fairness_ok']}), {recompiles} recompiles")
    if not leg["light_p99_bar_reachable"]:
        _mark(f"multimodel leg: the 1.5x light-p99 bar is out of reach "
              f"here: cross-model contention alone costs {contention_x}x"
              "; light_p99_ok reflects the host, not the scheduler")
    return leg


def _serve_swap_window(registry, factory, batcher, metrics, req,
                       clients: int, duration: float, compiles,
                       seed: int = 101) -> dict:
    """A closed-loop window with a real model roll in the middle (the
    root bench's): after a quarter of the window, load and warm a
    fresh-init version on this thread while the clients keep hammering
    the live one, then promote it. Returns the whole window's snapshot,
    the candidate's warmup cost, and the build count from post-warm to
    drain, `recompiles_after_swap`, which must be 0."""
    import threading

    from distributedmnist_tpu_torch.serve import Rejected

    client_errors: list = []
    stop_evt = threading.Event()

    def client():
        while not stop_evt.is_set():
            try:
                batcher.submit(req).result(timeout=120)
            except Rejected:
                time.sleep(0.001)
            except BaseException as e:
                client_errors.append(e)
                return

    threads = [make_thread(target=client, name=f"bench-swap-client-{i}",
                           daemon=True)
               for i in range(clients)]
    for t in threads:
        t.start()
    time.sleep(min(0.5, duration * 0.2))     # unmeasured ramp
    metrics.reset()
    t_win0 = time.monotonic()
    time.sleep(duration * 0.25)              # steady traffic pre-swap
    version = "v-swap"
    before = compiles.snapshot()
    t_load0 = time.monotonic()
    # load and warm off the dispatch path: the live version keeps serving
    mv = registry.add(factory.init_params(seed), version=version,
                      source="fresh-init")
    warm_events = compiles.snapshot() - before
    steady_from = compiles.snapshot()        # post-warm, pre-promote
    registry.promote(version)
    t_swap = time.monotonic()
    _mark(f"hot-swap: {version} warmed in {t_swap - t_load0:.2f}s "
          f"({warm_events} builds), promoted")
    # the post-swap tail: the new version takes all traffic inside the
    # measured window, so a cold bucket would show in this p99
    time.sleep(max(duration * 0.5, 0.5))
    stop_evt.set()
    for t in threads:
        t.join()
    if client_errors:
        raise RuntimeError(
            f"{len(client_errors)} of {clients} swap-window clients "
            "died — a hot-swap must not fail requests") \
            from client_errors[0]
    _drain_or_die(batcher, timeout=120)
    recompiles = compiles.snapshot() - steady_from
    snap = metrics.snapshot()
    return {
        "version": version,
        "window_s": round(time.monotonic() - t_win0, 3),
        "load_warm_s": round(mv.warmup_s, 3),
        "warmup_compile_events": warm_events,
        "recompiles_after_swap": recompiles,
        "swap_window": snap,
    }


def chaos_fault_spec(live_version: str, kill_target) -> str:
    """The chaos leg's fault schedule, the root bench's: request-sticky
    poison on ~1.5% of dispatches (bisection's food) and a fetch storm
    pinned to `live_version` after 40 clean batches (the forced breaker
    trip; the rollback un-matches the rule, count=200 is the backstop).
    With `kill_target` (a fleet run) two replica-kill bursts on that
    replica ride along: its fetches 3-6 and its dispatches 9-12 fail, and
    failover must rescue every one."""
    spec = ("batch.dispatch:mode=request,p=0.015;"
            f"engine.fetch:p=1,count=200,after=40,version={live_version}")
    if kill_target is not None:
        spec += (f";replica.fetch:p=1,replica={kill_target},"
                 "after=2,count=4"
                 f";replica.dispatch:p=1,replica={kill_target},"
                 "after=8,count=4")
    return spec


def _serve_chaos_leg(registry, router, factory, metrics, make_batcher,
                     compiles, pipelined: int, duration: float, qps: float,
                     cache_capacity: Optional[int] = None) -> dict:
    """The resilience leg (the root bench's): the seeded chaos_fault_spec
    schedule driven open-loop against bisection, the circuit breaker and
    the deadline shed, every request's outcome tracked.

    - poison requests: exactly the injector's poisoned rids must fail
      with the injected dispatch fault (no cohort-mate misblamed, no
      culprit slipping through);
    - the forced trip: the breaker must trip and roll back to the
      healthy fallback loaded up front, which ends the storm;
    - deadline sheds: every 25th request carries an unmeetable budget.

    Availability is counted over the non-injected population. With
    `cache_capacity` (--serve-cache) the drill runs through the cache
    front, with the registry's invalidation hook installed, and the
    poison ledger is held on a leader basis (collapsed followers echo
    their leader's fault without a rid of their own)."""
    import random

    import numpy as np

    from distributedmnist_tpu_torch.serve import (CircuitBreaker,
                                                  DeadlineExceeded,
                                                  Rejected,
                                                  ResiliencePolicy, faults)
    from distributedmnist_tpu_torch.serve.faults import InjectedFault
    from distributedmnist_tpu_torch.serve.scheduler import fit_dispatch_cost

    live = registry.live_version()
    before = compiles.snapshot()
    fallback = registry.add(factory.init_params(202),
                            version="v-chaos-fallback", source="fresh-init")
    fallback_builds = compiles.snapshot() - before
    steady_from = compiles.snapshot()
    # a tight breaker so the trip lands well inside the leg
    breaker = CircuitBreaker(window_s=1.5, min_requests=12,
                             failure_ratio=0.5, cooldown_s=60.0)
    res = ResiliencePolicy(bisect=True, breaker=breaker,
                           registry=registry, metrics=metrics)
    # cohort-sized coalescing: ~3 inter-arrivals at the driven rate, or
    # the full-batch service time if longer
    overhead_s, per_row_s = fit_dispatch_cost(router.bucket_costs())
    wait_us = max(int(3e6 / qps), 2000, int(
        (overhead_s + per_row_s * factory.buckets[-1]) * 1e6))
    chaos_duration = max(3.0 * duration, 6.0)
    fleet = router if getattr(router, "n_replicas", 1) > 1 else None
    kill_target = fleet.replica_ids()[-1] if fleet is not None else None
    spec = chaos_fault_spec(live, kill_target)
    inj = faults.install(faults.FaultInjector.from_spec(spec, seed=23))
    _mark(f"chaos: schedule {spec!r} (seed 23), {chaos_duration:g}s open "
          f"loop at qps={qps:g}, wait {wait_us}us, fallback "
          f"{fallback.version} resident")
    rng = np.random.default_rng(13)
    sizes = [int(s)
             for s in rng.integers(1, min(8, factory.max_batch) + 1, 256)]
    reqs = [rng.integers(0, 256, (n, 28, 28, 1), dtype=np.uint8)
            for n in sizes]
    cache = None
    submitter = None
    outcomes: list = []
    futures: list = []
    poison_echoes = 0
    cache_hits_ok = 0
    try:
        batcher = make_batcher(pipelined, adaptive=False, wait_us=wait_us,
                               resilience=res)
        submitter = batcher
        if cache_capacity is not None:
            from distributedmnist_tpu_torch.serve.cache import (
                CacheFront, PredictionCache)

            cache = PredictionCache(cache_capacity)
            # the real invalidation hook: the forced rollback mid-storm
            # bumps the epoch atomically with the route swap
            registry.set_cache(cache)
            submitter = CacheFront(batcher, router, cache, metrics=metrics)
            _mark(f"chaos: prediction cache front ON (capacity "
                  f"{cache_capacity})")
        metrics.reset()
        arrivals = random.Random(3)
        t_end = time.monotonic() + chaos_duration
        next_t = time.monotonic()
        i = 0
        while next_t < t_end:
            now = time.monotonic()
            if next_t > now:
                time.sleep(next_t - now)
            deadline = None
            if i % 25 == 7:
                deadline = time.monotonic() + 5e-4   # unmeetable
            try:
                futures.append(submitter.submit(reqs[i % len(reqs)],
                                                deadline_s=deadline))
            except DeadlineExceeded:
                outcomes.append("deadline")
            except Rejected:
                outcomes.append("rejected")
            i += 1
            next_t += arrivals.expovariate(qps)
        _drain_or_die(submitter, timeout=120)
        for fut in futures:
            try:
                fut.result(timeout=60)
                outcomes.append("ok")
                if getattr(fut, "cache_hit", False):
                    cache_hits_ok += 1
            except InjectedFault as e:
                outcomes.append(f"injected:{e.point}")
                if (e.point == "batch.dispatch"
                        and getattr(fut, "collapsed", False)):
                    poison_echoes += 1
            except DeadlineExceeded:
                outcomes.append("deadline")
            except Rejected:
                outcomes.append("rejected")
            except Exception:
                outcomes.append("other")
        snap = metrics.snapshot()
    finally:
        faults.uninstall()
        if submitter is not None:
            submitter.stop()
        if cache is not None:
            registry.set_cache(None)

    n = len(outcomes)
    n_ok = outcomes.count("ok")
    n_poison = outcomes.count("injected:batch.dispatch")
    n_fetch = outcomes.count("injected:engine.fetch")
    n_replica = sum(1 for o in outcomes
                    if o.startswith("injected:replica."))
    n_deadline = outcomes.count("deadline")
    n_rejected = outcomes.count("rejected")
    n_other = (n - n_ok - n_poison - n_fetch - n_replica - n_deadline
               - n_rejected)
    availability = n_ok / max(n_ok + n_other, 1)
    poisoned = inj.poisoned()
    n_poison_leaders = n_poison - poison_echoes
    rollbacks = [e for e in registry.events()
                 if e.get("event") == "rollback"]
    recompiles = compiles.snapshot() - steady_from
    resil = snap["resilience"]
    leg = {
        "spec": spec,
        "injector_seed": 23,
        "arrivals_seed": 3,
        "qps": qps,
        "duration_s": round(chaos_duration, 3),
        "coalesce_wait_us": wait_us,
        "requests": n,
        "ok": n_ok,
        "injected_dispatch_faults": n_poison,
        "injected_fetch_faults": n_fetch,
        "injected_replica_faults_surfaced": n_replica,
        "deadline_shed": n_deadline,
        "rejected": n_rejected,
        "other_failures": n_other,
        # the root bench's bars, unchanged: non-injected traffic >= 99%
        # available, every poison isolated exactly, the rollback engaged,
        # no recompile
        "availability_excluding_injected": round(availability, 5),
        "availability_ok": availability >= 0.99,
        "p99_under_faults_ms": snap["latency_ms"]["p99"],
        "poison_unique": len(poisoned),
        "poison_isolated_exact": n_poison_leaders == len(poisoned) > 0,
        "bisect_splits": resil["bisect_splits"],
        "bisect_rescued_requests": resil["bisect_rescued_requests"],
        "deadline_shed_metric": resil["deadline_shed_requests"],
        "breaker_trips": breaker.trips(),
        "rollbacks": len(rollbacks),
        "rollback_events": rollbacks,
        "rollback_engaged": (len(rollbacks) >= 1
                             and registry.live_version()
                             == fallback.version),
        "live_version_after": registry.live_version(),
        "fallback_warmup_compile_events": fallback_builds,
        "recompiles_during_chaos": recompiles,
        # the fleet's rescue counters (0 without --serve-replicas >= 2)
        "failovers": snap["fleet"]["failovers_total"],
        "hedges": snap["fleet"]["hedges"],
    }
    if cache is not None:
        stats = cache.stats()
        leg["cache"] = {
            "enabled": True,
            "capacity": cache_capacity,
            "stats": stats,
            "cache_hits_ok": cache_hits_ok,
            "poison_client_failures": n_poison,
            "poison_follower_echoes": poison_echoes,
            "poison_leaders": n_poison_leaders,
            "ledger_exact": n_poison_leaders == len(poisoned) > 0,
        }
    if fleet is not None:
        kill_fires = sum(
            r["fires"] for r in inj.snapshot()["rules"]
            if r["point"].startswith("replica."))
        surfaced_by_point: dict = {}
        for o in outcomes:
            if o.startswith("injected:replica."):
                surfaced_by_point[o] = surfaced_by_point.get(o, 0) + 1
        leg["replica_kill"] = {
            "target": kill_target,
            "fires": kill_fires,
            "surfaced_failures": n_replica,
            "surfaced_by_point": surfaced_by_point,
            # the storm fired and failover caught every burst: no
            # replica fault reached a client
            "rescued_exactly": kill_fires > 0 and n_replica == 0,
            "failovers": dict(snap["fleet"]["failovers"]),
            "replica_trips": snap["fleet"]["replica_trips"],
            # the fleet's snapshot, and the replica failures its hedge
            # races absorbed: a kill fire that lands in a race is
            # rescued without a failover
            "fleet_after": {**fleet.snapshot(),
                            "hedge_absorbed": fleet.hedge_absorbed()},
        }
    _mark(f"chaos: {n} requests — {n_ok} ok, {n_poison} poison culprits "
          f"(unique {len(poisoned)}, exact isolation "
          f"{leg['poison_isolated_exact']}), {n_fetch} trip victims, "
          f"{n_deadline} deadline-shed, {n_other} OTHER failures; "
          f"availability {availability:.4f}; "
          f"{resil['bisect_rescued_requests']} cohort-mates rescued in "
          f"{resil['bisect_splits']} splits; breaker trips "
          f"{breaker.trips()}, rollback -> {leg['live_version_after']}; "
          f"{recompiles} recompiles")
    return leg


def _serve_trace_replay_leg(router, metrics, factory, make_batcher,
                            spec: str, seed: int, autoscale: bool,
                            slo_ms: float, chaos: bool = False) -> dict:
    """The workload-realism leg (the root bench's): replay one seeded
    arrival schedule (serve/workload.py) open-loop against a static
    trough-provisioned batcher and, with --autoscale, again under the
    closed-loop autoscaler on the identical schedule (same seed, same
    arrivals, same request bytes per key). Headlines: SLO attainment
    (within-SLO completions over all arrivals; sheds are misses) and
    chip-seconds per million within-SLO requests, the autoscaler's
    spend integrated from its own action log.

    The static phase runs at window = floor and the smallest bucket
    covering the trace's largest request: the autoscaler's job is to buy
    the burst capacity that trough provisioning lacks and give it back
    in the quiet phases. Scale moves only along the warmed bucket
    ladder, so the whole-run recompiles_after_warmup bar covers this
    leg. Zero flaps holds by construction (cooldown) and is audited
    from the action log."""
    import hashlib

    import numpy as np

    from distributedmnist_tpu_torch.serve import Rejected, workload
    from distributedmnist_tpu_torch.serve.autoscale import (
        Autoscaler, WindowActuator, batcher_signals)

    legs = workload.parse_trace_spec(spec)
    events = workload.materialize(legs, seed)
    dur = workload.total_duration(legs)
    if not events:
        raise RuntimeError(f"trace spec {spec!r} with seed {seed} "
                           "materialized zero arrivals")
    # (key, rows) -> byte-stable request content: the cache/dedup
    # identity follows the trace's key mix exactly, and a regression
    # run from the recorded seed replays the same bytes.
    pool: dict = {}
    for e in events:
        k = (e.key, e.rows)
        if k not in pool:
            r = np.random.default_rng([seed, e.key, e.rows])
            pool[k] = r.integers(0, 256, (e.rows, 28, 28, 1),
                                 dtype=np.uint8)
    buckets = list(factory.buckets)
    max_rows = max(e.rows for e in events)
    base_idx = next((i for i, b in enumerate(buckets) if b >= max_rows),
                    len(buckets) - 1)
    base_max_batch = buckets[base_idx]
    floor = 1
    # ceiling: one window unit per remaining bucket rung (capped) so
    # every grow step buys a real capacity rung
    ceiling = max(floor + 1,
                  min(8, floor + (len(buckets) - 1 - base_idx)))

    def replay(batcher) -> dict:
        done: list = []             # (latency_s, errored) per completion
        sheds = 0
        lag_max = 0.0
        t0 = time.monotonic()
        for e in events:
            target = t0 + e.t
            now = time.monotonic()
            if target > now:
                time.sleep(target - now)
            else:
                lag_max = max(lag_max, now - target)
            try:
                fut = batcher.submit(pool[(e.key, e.rows)])
            except Rejected:
                sheds += 1
                continue
            ts = time.monotonic()
            fut.add_done_callback(
                lambda f, ts=ts: done.append(
                    (time.monotonic() - ts,
                     f.exception() is not None)))
        _drain_or_die(batcher, timeout=120)
        total = len(events)
        served = sum(1 for _, err in done if not err)
        within = sum(1 for lat, err in done
                     if not err and lat * 1e3 <= slo_ms)
        lats = sorted(lat * 1e3 for lat, err in done if not err)

        def q(p: float):
            return (round(lats[min(len(lats) - 1, int(p * len(lats)))],
                          2) if lats else None)

        return {"arrivals": total, "served": served,
                "shed": sheds + sum(1 for _, err in done if err),
                "within_slo": within,
                "slo_attainment": round(within / total, 4),
                "latency_ms": {"p50": q(0.50), "p90": q(0.90),
                               "p99": q(0.99)},
                "max_submit_lag_ms": round(lag_max * 1e3, 2)}

    def per_m(chip_s: float, within: int):
        # chip-seconds per million WITHIN-SLO requests: spend over
        # goodput, not over arrivals — capacity that missed the SLO
        # earns nothing
        return (round(chip_s / within * 1e6, 1) if within else None)

    leg = {
        "spec": spec, "seed": seed,
        "autoscale_enabled": bool(autoscale),
        "slo_ms": slo_ms,
        "legs": workload.describe(legs),
        "events": len(events),
        "duration_s": round(dur, 3),
        # the replay-determinism receipt: rerunning this spec+seed
        # must materialize a schedule hashing to exactly this
        "schedule_sha256": hashlib.sha256(
            workload.schedule_bytes(events)).hexdigest(),
        "floor_units": floor, "ceiling_units": ceiling,
        "base_max_batch": base_max_batch,
    }

    _mark(f"trace replay [static floor={floor}, "
          f"max_batch={base_max_batch}]: {len(events)} arrivals over "
          f"{dur:.1f}s ({spec})")
    metrics.reset()
    b = make_batcher(floor, max_batch=base_max_batch)
    try:
        static = replay(b)
    finally:
        b.stop()
    static["units"] = floor
    static["chip_seconds"] = round(floor * dur, 3)
    static["chip_seconds_per_m_requests"] = per_m(
        static["chip_seconds"], static["within_slo"])
    leg["static"] = static
    _mark(f"trace replay [static]: attainment "
          f"{static['slo_attainment']:.3f}, "
          f"{static['shed']} shed, p99 {static['latency_ms']['p99']} "
          f"ms, {static['chip_seconds']} chip-s")

    autoscaled = None
    if autoscale:
        _mark(f"trace replay [autoscaled {floor}..{ceiling}]: same "
              "schedule under the closed-loop controller")
        metrics.reset()
        # construction-time window = ceiling (the parked-permit
        # design: the actuator narrows by parking permits, so the
        # semaphore itself never resizes); then start at the SAME
        # trough provisioning the static phase ran
        b = make_batcher(ceiling, max_batch=base_max_batch)
        actuator = WindowActuator(b, floor=floor, ceiling=ceiling,
                                  base_max_batch=base_max_batch)
        actuator.scale_to(floor)
        ctl = Autoscaler(
            actuator,
            batcher_signals(b, metrics=metrics, slo_ms=slo_ms),
            high=0.6, low=0.15,
            cooldown_s=max(0.3, dur / 24), interval_s=0.05,
            metrics=metrics)
        ctl.start()
        try:
            autoscaled = replay(b)
        finally:
            ctl.stop()
            b.stop()
        actions = list(ctl.actions)
        # chip-seconds = integral of scale units over the trace,
        # piecewise-constant from the action log (t_s offsets are
        # from controller start, which immediately precedes replay
        # start; clamped to the trace window)
        chip_s, last_t, units = 0.0, 0.0, float(floor)
        for a in actions:
            t = min(max(a["t_s"], 0.0), dur)
            chip_s += units * max(0.0, t - last_t)
            last_t, units = t, float(a["achieved_units"])
        chip_s += units * max(0.0, dur - last_t)
        autoscaled["chip_seconds"] = round(chip_s, 3)
        autoscaled["chip_seconds_per_m_requests"] = per_m(
            chip_s, autoscaled["within_slo"])
        autoscaled["scale_actions"] = len(actions)
        autoscaled["actions"] = actions
        autoscaled["suppressed"] = ctl.suppressed
        autoscaled["saturated_ticks"] = ctl.saturated_ticks
        autoscaled["controller_errors"] = ctl.errors
        autoscaled["flaps"] = ctl.flaps()
        autoscaled["final_units"] = actuator.current()
        autoscaled["cost_basis"] = actuator.cost_basis
        leg["autoscaled"] = autoscaled
        _mark(f"trace replay [autoscaled]: attainment "
              f"{autoscaled['slo_attainment']:.3f}, "
              f"{len(actions)} scale actions "
              f"({autoscaled['suppressed']} suppressed, "
              f"{autoscaled['flaps']} flaps, "
              f"{autoscaled['saturated_ticks']} saturated ticks), "
              f"{autoscaled['chip_seconds']} chip-s")

        # The acceptance bars, with the honest-miss disclosure: when
        # the static control already attains ~everything (the host
        # outruns the trace), there is no headroom for the autoscaler
        # to buy and the record says so instead of claiming a win.
        reachable = static["slo_attainment"] < 0.995
        st_cpm = static["chip_seconds_per_m_requests"]
        as_cpm = autoscaled["chip_seconds_per_m_requests"]
        leg["bars"] = {
            "slo_bar_reachable": reachable,
            "slo_attainment_improved": (
                autoscaled["slo_attainment"] > static["slo_attainment"]
                if reachable else None),
            "chip_seconds_no_worse": (
                as_cpm is not None and st_cpm is not None
                and as_cpm <= st_cpm * 1.02
                if reachable else None),
            "zero_flaps": autoscaled["flaps"] == 0,
            "scaled_up_under_load": any(
                a["direction"] == "grow" for a in actions),
        }
    # headline fields (the --baseline delta rows read these): the
    # autoscaled phase when it ran, the static control otherwise
    head = autoscaled if autoscaled is not None else static
    leg["slo_attainment"] = head["slo_attainment"]
    leg["chip_seconds_per_m_requests"] = (
        head["chip_seconds_per_m_requests"])
    leg["scale_actions"] = (autoscaled or {}).get("scale_actions", 0)

    if chaos and autoscale:
        # chaos under the trace: the same schedule, autoscaled, with a
        # seeded dispatch-latency and poison schedule installed; the
        # injected latency inflates the saturation surface, so the
        # controller should buy capacity during the storm, and the leg
        # records whether it did
        from distributedmnist_tpu_torch.serve import faults
        fault_spec = "engine.dispatch:p=0.05,latency_ms=5"
        _mark(f"trace replay [autoscaled + chaos {fault_spec!r}]")
        metrics.reset()
        faults.install(faults.FaultInjector.from_spec(fault_spec,
                                                      seed=seed))
        b = make_batcher(ceiling, max_batch=base_max_batch)
        actuator = WindowActuator(b, floor=floor, ceiling=ceiling,
                                  base_max_batch=base_max_batch)
        actuator.scale_to(floor)
        ctl = Autoscaler(
            actuator,
            batcher_signals(b, metrics=metrics, slo_ms=slo_ms),
            high=0.6, low=0.15,
            cooldown_s=max(0.3, dur / 24), interval_s=0.05,
            metrics=metrics)
        ctl.start()
        try:
            under = replay(b)
        finally:
            ctl.stop()
            b.stop()
            faults.uninstall()
        under["scale_actions"] = len(ctl.actions)
        under["grew_during_storm"] = any(
            a["direction"] == "grow" for a in ctl.actions)
        under["flaps"] = ctl.flaps()
        under["fault_spec"] = fault_spec
        leg["chaos"] = under
        _mark(f"trace replay [chaos]: attainment "
              f"{under['slo_attainment']:.3f}, grew_during_storm="
              f"{under['grew_during_storm']}")
    return leg


def _git_provenance() -> dict:
    """Commit hash and dirty flag of the checkout; Nones outside a git
    repository or without git, never a failed bench."""
    import subprocess

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    prov = {"git_commit": None, "git_dirty": None}
    try:
        r = subprocess.run(["git", "rev-parse", "HEAD"], cwd=root,
                           capture_output=True, text=True, timeout=10)
        if r.returncode == 0:
            prov["git_commit"] = r.stdout.strip()
            d = subprocess.run(["git", "status", "--porcelain"], cwd=root,
                               capture_output=True, text=True, timeout=10)
            if d.returncode == 0:
                prov["git_dirty"] = bool(d.stdout.strip())
    except (OSError, subprocess.SubprocessError):
        pass
    return prov


def _power_limit_w():
    """The card's power limit in watts, from nvidia-smi's
    `name,power.limit` query (None if nvidia-smi does not answer)."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.SubprocessError):
        return None
    if out.returncode != 0 or not out.stdout.strip():
        return None
    limit = out.stdout.strip().splitlines()[0].rsplit(",", 1)[-1]
    try:
        return float(limit.strip().split()[0])
    except (ValueError, IndexError):
        return None


def _host_provenance(factory, infer_dtype: str = "float32") -> dict:
    """Which machine, which card, which code and which precision produced
    the serve record."""
    import platform as platform_mod
    import socket

    import torch

    from distributedmnist_tpu_torch.ops import fused

    on_card = factory.device.type == "cuda"
    return {
        "hostname": socket.gethostname(),
        "platform": platform_mod.platform(),
        "machine": platform_mod.machine(),
        "cpu_count": os.cpu_count(),
        "backend": factory.platform,
        "device_kind": (torch.cuda.get_device_name(factory.device)
                        if on_card else "cpu"),
        "power_limit_w": _power_limit_w() if on_card else None,
        "chip_count": factory.total_chips,
        "infer_dtype": infer_dtype,
        "fused_kernels": fused.resolve(factory.device),
        **_git_provenance(),
    }


def _baseline_delta(record: dict, baseline: dict, path: str) -> dict:
    """The --baseline block (the root bench's rows): current against
    prior on the stable serve signals, printed to stderr as a table and
    embedded in the record. Rows whose leg either run lacked are
    None-vs-None; `compile_surface` compares the two records' served
    surfaces (analysis/torchcheck.py's key count and fingerprint-set
    hash)."""
    cur_d, base_d = record["detail"], baseline.get("detail", {})

    def pct(cur, prev):
        return (round(100.0 * (cur - prev) / prev, 1)
                if cur is not None and prev else None)

    def leg(d, name):
        return d.get(name) or {}

    cur_chaos, base_chaos = leg(cur_d, "chaos"), leg(base_d, "chaos")
    rows = {
        "img_s_chip": (record["value"], baseline.get("value")),
        "closed_p99_ms": (
            cur_d["closed_loop"]["latency_ms"]["p99"],
            base_d.get("closed_loop", {}).get("latency_ms", {})
            .get("p99")),
        "ragged_closed_waste": (
            leg(cur_d, "ragged").get("closed_waste_on"),
            leg(base_d, "ragged").get("closed_waste_on")),
        "recompiles_after_warmup": (
            cur_d["recompiles_after_warmup"],
            base_d.get("recompiles_after_warmup")),
        "chaos_availability": (
            cur_chaos.get("availability_excluding_injected"),
            base_chaos.get("availability_excluding_injected")),
        "chaos_p99_under_faults_ms": (
            cur_chaos.get("p99_under_faults_ms"),
            base_chaos.get("p99_under_faults_ms")),
        "chaos_failovers": (cur_chaos.get("failovers"),
                            base_chaos.get("failovers")),
        "dtype_sweep_best_speedup": (
            leg(cur_d, "dtype_sweep").get("best_speedup"),
            leg(base_d, "dtype_sweep").get("best_speedup")),
        "zipf_hit_ratio": (leg(cur_d, "zipf").get("hit_ratio"),
                           leg(base_d, "zipf").get("hit_ratio")),
        "zipf_goodput_x": (leg(cur_d, "zipf").get("goodput_x"),
                           leg(base_d, "zipf").get("goodput_x")),
        "zipf_p99_on_ms": (leg(cur_d, "zipf").get("p99_on_ms"),
                           leg(base_d, "zipf").get("p99_on_ms")),
        "lowlat_p50_improvement_x": (
            leg(cur_d, "lowlat").get("p50_improvement_x"),
            leg(base_d, "lowlat").get("p50_improvement_x")),
        "lowlat_p50_fastlane_ms": (
            leg(cur_d, "lowlat").get("p50_fastlane_ms"),
            leg(base_d, "lowlat").get("p50_fastlane_ms")),
        "cascade_agreement": (
            (leg(cur_d, "cascade").get("agreement_vs_f32")
             or {}).get("balanced"),
            (leg(base_d, "cascade").get("agreement_vs_f32")
             or {}).get("balanced")),
        "cascade_efficiency": (
            leg(cur_d, "cascade").get("cascade_efficiency_vs_fast"),
            leg(base_d, "cascade").get("cascade_efficiency_vs_fast")),
        "cascade_escalation_rate": (
            ((leg(cur_d, "cascade").get("legs")
              or {}).get("balanced") or {}).get("escalation_fraction"),
            ((leg(base_d, "cascade").get("legs")
              or {}).get("balanced") or {}).get("escalation_fraction")),
        "trace_slo_attainment": (
            leg(cur_d, "trace_replay").get("slo_attainment"),
            leg(base_d, "trace_replay").get("slo_attainment")),
        "trace_chip_s_per_m_requests": (
            leg(cur_d, "trace_replay").get("chip_seconds_per_m_requests"),
            leg(base_d, "trace_replay").get(
                "chip_seconds_per_m_requests")),
        "trace_scale_actions": (
            leg(cur_d, "trace_replay").get("scale_actions"),
            leg(base_d, "trace_replay").get("scale_actions")),
        "compile_surface_keys": (
            leg(cur_d, "compile_surface").get("static_keys"),
            leg(base_d, "compile_surface").get("static_keys")),
        "gateway_workers": (leg(cur_d, "gateway").get("workers"),
                            leg(base_d, "gateway").get("workers")),
        "gateway_scaling_efficiency": (
            leg(cur_d, "gateway").get("scaling_efficiency"),
            leg(base_d, "gateway").get("scaling_efficiency")),
        "gateway_shard_hit_ratio": (
            (leg(cur_d, "gateway").get("zipf")
             or {}).get("shard_hit_ratio"),
            (leg(base_d, "gateway").get("zipf")
             or {}).get("shard_hit_ratio")),
    }
    delta = {"path": path,
             "baseline_value": baseline.get("value"),
             "baseline_device_kind": base_d.get("host", {})
             .get("device_kind")}
    _mark(f"baseline delta vs {os.path.basename(path)} "
          f"(device_kind {delta['baseline_device_kind']}):")
    for name, (cur, prev) in rows.items():
        d = pct(cur, prev)
        delta[name] = {"current": cur, "baseline": prev,
                       "delta_pct": d}
        _mark(f"  {name:<24} {prev} -> {cur}"
              f" ({'+' if d is not None and d >= 0 else ''}{d}%)"
              if d is not None else
              f"  {name:<24} {prev} -> {cur}")
    cur_h = leg(cur_d, "compile_surface").get("fingerprint_set_hash")
    base_h = leg(base_d, "compile_surface").get("fingerprint_set_hash")
    delta["compile_surface"] = {
        "current_hash": cur_h,
        "baseline_hash": base_h,
        "match": (cur_h == base_h if cur_h and base_h else None),
    }
    return delta


def _next_serve_artifact(artifact_dir: str) -> str:
    """The next free BENCH_torch_serve_rNN.json path in artifact_dir: one
    record a serve run, counted under the port's own prefix only (the
    JAX package's BENCH_serve_rNN.json records never move the count)."""
    import re

    pat = re.compile(re.escape(ARTIFACT_PREFIX) + r"(\d+)\.json$")
    rounds = [int(m.group(1)) for f in os.listdir(artifact_dir)
              for m in [pat.match(f)] if m]
    n = (max(rounds) if rounds else 0) + 1
    return os.path.join(artifact_dir, f"{ARTIFACT_PREFIX}{n:02d}.json")


def _baseline_refusal(args, baseline: dict, this_kind: str
                      ) -> Optional[str]:
    """Why --baseline's record does not compare with this run, known
    before the warmup (the root bench's refusals: a gateway record, the
    device kind, the zipf leg's cache setting), or None."""
    d = baseline["detail"]
    if d.get("gateway") is not None:
        return (f"it is a --gateway fleet record "
                f"({d['gateway'].get('workers')} workers); this run is "
                "single-process")
    base_kind = d["host"]["device_kind"]
    if base_kind != this_kind:
        return (f"it was measured on device_kind={base_kind!r}, this "
                f"host is {this_kind!r} — cross-silicon serve deltas are "
                "meaningless")
    base_zipf = d.get("zipf")
    if args.zipf and isinstance(base_zipf, dict):
        cur_on = not args.zipf_cache_off
        base_on = bool(base_zipf.get("cache_enabled"))
        if cur_on != base_on:
            return (f"its zipf leg ran cache_enabled={base_on}, this run "
                    f"is cache_enabled={cur_on} — cache-on-vs-cache-off "
                    "serve deltas are meaningless")
    return None


def _serve(args) -> int:
    """The serving load legs (the root bench's _serve, in-process): warmup
    excluded from every window, and a count of kernel-library loads and
    engine builds after warmup that must stay 0."""
    import numpy as np

    from distributedmnist_tpu_torch.config import Config
    from distributedmnist_tpu_torch.serve import (DynamicBatcher,
                                                  ServeMetrics,
                                                  build_resilience,
                                                  build_serving)
    from distributedmnist_tpu_torch.utils.device import resolve_device

    on_cpu = resolve_device(args.device).type == "cpu"
    cfg = Config(model=args.model, device=args.device,
                 num_devices=args.num_devices,
                 checkpoint_dir=args.checkpoint_dir,
                 serve_max_batch=(args.serve_max_batch
                                  or (128 if on_cpu else 512)),
                 serve_replicas=args.serve_replicas or 1,
                 serve_hedge=bool(args.serve_hedge))
    metrics = ServeMetrics()
    registry, router, factory = build_serving(cfg, metrics=metrics)
    compiles = _BuildCounter(factory)
    # --baseline: refused before any load phase when the records do not
    # compare (the root bench's exit 4); the dtype check follows the
    # variant's activation
    baseline_rec = None
    if args.baseline:
        with open(args.baseline) as f:
            baseline_rec = json.load(f)       # shape checked at parse
        why = _baseline_refusal(args, baseline_rec, factory.device_kind)
        if why is not None:
            _mark(f"REFUSING --baseline {args.baseline}: {why}")
            return REFUSED
    # the replica fleet (--serve-replicas >= 2): the fleet leg and the
    # chaos replica kill hang off it. images/s per chip divides by every
    # card the process serves over (--num-devices, default all of them),
    # as the root bench divides by its mesh
    fleet = router if getattr(router, "n_replicas", 1) > 1 else None
    n_chips = factory.total_chips
    _mark(f"backend up: {n_chips}x {factory.platform}, buckets "
          f"{list(factory.buckets)}"
          + (f", {fleet.n_replicas} replicas on "
             f"{[[str(d) for d in g] for g in factory.replica_devices]}"
             if fleet is not None else ""))
    # `is None`, not `or`: an explicit 0 (no coalescing wait) is honoured
    max_wait_us = (cfg.serve_max_wait_us if args.serve_max_wait_us is None
                   else args.serve_max_wait_us)
    queue_depth = (cfg.serve_queue_depth if args.serve_queue_depth is None
                   else args.serve_queue_depth)
    duration = ((2.0 if on_cpu else 10.0) if args.serve_duration is None
                else args.serve_duration)
    clients = ((8 if on_cpu else 64) if args.serve_clients is None
               else args.serve_clients)
    qps_sweep = (([50.0, 200.0] if on_cpu else [1000.0, 4000.0, 16000.0])
                 if args.serve_qps is None else args.serve_qps)
    rows = args.serve_rows
    # The headline phase's window: 4 even on the CPU, since the bench
    # measures the overlap against the serial phase.
    pipelined = (4 if args.serve_max_inflight is None
                 else args.serve_max_inflight)

    _mark(f"warming {len(factory.buckets)} buckets {list(factory.buckets)}")
    boot = registry.bootstrap(seed=cfg.seed)   # load, warm, promote
    warm_builds = boot.warmup_builds
    # An explicitly requested precision whose variant the gate refuses
    # fails the bench: it must never serve.
    if args.serve_infer_dtype and args.serve_infer_dtype != "float32":
        _mark(f"activating inference variant: {args.serve_infer_dtype}")
        registry.activate_infer_dtype(boot.version, args.serve_infer_dtype)
        warm_builds += sum(vi.warmup_builds for vi in
                           registry.get(boot.version).variants.values())
    headline_dtype = router.live_infer_dtype() or "float32"
    if baseline_rec is not None:
        base_dtype = (baseline_rec["detail"]["host"].get("infer_dtype")
                      or "float32")
        if base_dtype != headline_dtype:
            _mark(f"REFUSING --baseline {args.baseline}: it was measured "
                  f"at infer_dtype={base_dtype!r}, this run serves "
                  f"{headline_dtype!r} — cross-dtype serve deltas are "
                  "meaningless (an int8 record must not masquerade as an "
                  "f32 win)")
            return REFUSED
    if baseline_rec is not None:
        # autoscale-on and -off trace-replay records do not compare: a
        # static control must not read as an autoscaler regression, nor
        # an autoscaled round as a static win
        base_tr = baseline_rec["detail"].get("trace_replay")
        if args.trace_replay and isinstance(base_tr, dict):
            cur_as = bool(args.autoscale)
            base_as = bool(base_tr.get("autoscale_enabled"))
            if cur_as != base_as:
                _mark(f"REFUSING --baseline {args.baseline}: its "
                      "trace-replay leg ran autoscale_enabled="
                      f"{base_as}, this run is autoscale_enabled="
                      f"{cur_as} — autoscale-on-vs-off trace deltas "
                      "are meaningless")
                return REFUSED
    # engine builds, counted at the factory: none may happen after warmup
    steady_from = compiles.snapshot()

    rng = np.random.default_rng(0)
    req = rng.integers(0, 256, (rows, 28, 28, 1), dtype=np.uint8)

    # every batcher runs with the resilience stack wired, as the server
    # wires it, so the headline prices it; the chaos leg brings its own
    default_resilience = build_resilience(cfg, registry=registry,
                                          metrics=metrics)

    def make_batcher(max_inflight: int, split: bool = True,
                     adaptive: bool = None, wait_us: int = None,
                     resilience=None, dedup: bool = False,
                     fastlane: bool = False,
                     max_batch: int = None) -> DynamicBatcher:
        if adaptive is None:
            adaptive = not args.no_adaptive
        return DynamicBatcher(router, max_batch=(factory.max_batch
                                                 if max_batch is None
                                                 else max_batch),
                              max_wait_us=(max_wait_us if wait_us is None
                                           else wait_us),
                              queue_depth=queue_depth,
                              max_inflight=max_inflight,
                              slo_ms=args.serve_slo_ms, adaptive=adaptive,
                              split=split,
                              resilience=(default_resilience
                                          if resilience is None
                                          else resilience),
                              dedup=dedup, fastlane=fastlane,
                              metrics=metrics).start()

    # Phase 1: the serial chain (in-flight 1), the denominator of the
    # overlap, and one sub-capacity open-loop point for its latency.
    low_qps = min(qps_sweep)
    serial = make_batcher(1)
    try:
        _mark(f"closed loop [inflight=1]: {clients} clients x "
              f"{duration:g}s")
        closed_serial = _serve_closed_loop(serial, metrics, [req], clients,
                                           duration)
        serial_value = closed_serial["rows_per_sec"] / n_chips
        _mark(f"closed loop [inflight=1]: {serial_value:.0f} img/s "
              f"(p99 {closed_serial['latency_ms']['p99']} ms)")
        _mark(f"open loop [inflight=1] qps={low_qps:g}")
        _, open_serial = _serve_open_loop(serial, metrics, [req], low_qps,
                                          duration, max_wait_us)
    finally:
        serial.stop()

    # Phase 2: the pipelined window, the headline and the rate sweep.
    piped = make_batcher(pipelined)
    try:
        _mark(f"closed loop [inflight={piped.max_inflight}]: {clients} "
              f"clients x {duration:g}s")
        closed = _serve_closed_loop(piped, metrics, [req], clients,
                                    duration)
        value = closed["rows_per_sec"] / n_chips
        speedup = value / max(serial_value, 1e-9)
        _mark(f"closed loop [inflight={piped.max_inflight}]: {value:.0f} "
              f"img/s (p99 {closed['latency_ms']['p99']} ms, "
              f"{speedup:.2f}x serial)")
        table = []
        for qps in qps_sweep:
            submitted, snap = _serve_open_loop(piped, metrics, [req], qps,
                                               duration, max_wait_us)
            table.append({
                "qps_target": qps,
                "qps_submitted": round(submitted / duration, 1),
                "requests_per_sec": snap["requests_per_sec"],
                "img_s_chip": round(snap["rows_per_sec"] / n_chips, 1),
                "latency_ms": snap["latency_ms"],
                "mean_rows_per_batch": snap["mean_rows_per_batch"],
                "batch_occupancy": snap["batch_occupancy"],
                "rejected_requests": snap["rejected_requests"],
                "inflight_mean": snap["inflight_mean"],
                "inflight_max": snap["inflight_max"],
            })
            _mark(f"open loop qps={qps:g}: p50={snap['latency_ms']['p50']}"
                  f" ms, {snap['rejected_requests']} rejected")
    finally:
        piped.stop()

    # Phase 3: the ragged-size leg, former off then on, own batchers.
    ragged = _serve_ragged_leg(router, metrics, factory, make_batcher,
                               pipelined, clients, duration, low_qps,
                               max_wait_us)

    # Phase 4 (fleet runs): the same warm fleet at one active replica and
    # whole, through the admin drain/rejoin path
    fleet_leg = None
    if fleet is not None:
        fleet_leg = _serve_fleet_leg(fleet, metrics, make_batcher,
                                     clients, duration, req)

    # Optional legs, each on batchers of its own, after the headline
    # phases: the dtype sweep, the cascade's frontier, the fast lane, the
    # hot-key cache, tracing, then chaos (so an injected storm cannot
    # touch the clean numbers). The variants' warmups are warmup, not
    # steady-state builds.
    dtype_sweep = None
    if args.dtype_sweep:
        dtype_sweep = _serve_dtype_sweep(registry, router, factory,
                                         metrics, make_batcher, compiles,
                                         pipelined, clients, duration)
    cascade_leg = None
    if args.cascade:
        cascade_leg = _serve_cascade_leg(registry, router, factory,
                                         metrics, make_batcher, compiles,
                                         pipelined, clients, duration)
    lowlat_leg = None
    if args.lowlat:
        lowlat_leg = _serve_lowlat_leg(registry, router, factory, metrics,
                                       make_batcher, compiles, duration,
                                       max_wait_us, args.model)
    zipf_leg = None
    if args.zipf:
        zipf_leg = _serve_zipf_leg(
            router, metrics, factory, make_batcher, pipelined, clients,
            duration, cache_on=not args.zipf_cache_off,
            cache_capacity=args.serve_cache_capacity or 4096)
    trace_leg = None
    chrome_events: list = []
    if args.trace:
        trace_leg = _serve_trace_leg(router, metrics, factory,
                                     make_batcher, pipelined, duration,
                                     low_qps, chrome_events)
    # the workload-realism leg: one seeded trace replayed against a
    # static trough-provisioned batcher and (--autoscale) under the
    # closed-loop autoscaler; scale moves only along the warmed ladder,
    # so the whole-run recompile count below covers it. With --chaos a
    # third phase replays it under a seeded fault storm.
    trace_replay_leg = None
    if args.trace_replay:
        trace_replay_leg = _serve_trace_replay_leg(
            router, metrics, factory, make_batcher, args.trace_replay,
            seed=cfg.seed, autoscale=bool(args.autoscale),
            slo_ms=(args.serve_slo_ms or (25.0 if on_cpu else 10.0)),
            chaos=bool(args.chaos))
    # the model roll under load, on a batcher of its own: the candidate's
    # warmup is excluded from the whole-run count below (it rolls the
    # live version to a fresh-init one, as the root bench's does)
    swap = None
    if args.swap_during_load:
        swap_b = make_batcher(pipelined)
        try:
            _mark(f"swap window [inflight={swap_b.max_inflight}]: "
                  f"{clients} clients, hot-swap mid-window")
            swap = _serve_swap_window(registry, factory, swap_b, metrics,
                                      req, clients, duration, compiles)
        finally:
            swap_b.stop()
        steady_p99 = closed["latency_ms"]["p99"]
        swap_p99 = swap["swap_window"]["latency_ms"]["p99"]
        swap["steady_p99_ms"] = steady_p99
        swap["swap_window_p99_ms"] = swap_p99
        swap["p99_ratio_vs_steady"] = (
            round(swap_p99 / steady_p99, 3)
            if steady_p99 and swap_p99 is not None else None)
        # the new version serves only after the promote: its by_version
        # p99 is the post-swap population alone
        post = swap["swap_window"]["by_version"].get(swap["version"])
        post_p99 = post["latency_ms"]["p99"] if post else None
        swap["post_swap_p99_ms"] = post_p99
        swap["post_swap_p99_ratio_vs_steady"] = (
            round(post_p99 / steady_p99, 3)
            if steady_p99 and post_p99 is not None else None)
        _mark(f"swap window: p99 {swap_p99} ms vs steady {steady_p99} ms"
              f" (ratio {swap['p99_ratio_vs_steady']}; post-swap "
              f"population {post_p99} ms), "
              f"{swap['recompiles_after_swap']} recompiles after swap")
    # the multi-tenant leg, on a catalog and scheduler of its own; its
    # two model warmups are excluded from the whole-run count below
    multimodel_leg = None
    if args.multimodel:
        multimodel_leg = _serve_multimodel_leg(compiles, args.device,
                                               duration, rows,
                                               args.num_devices)
    chaos = None
    if args.chaos:
        from distributedmnist_tpu_torch.serve import trace as trace_lib

        chaos_tracer = None
        if args.trace:
            # traced chaos: bisect splits must show as structured spans
            chaos_tracer = trace_lib.install(trace_lib.Tracer(
                capacity=4096, sample=1.0, slo_ms=args.serve_slo_ms,
                seed=17))
        try:
            chaos = _serve_chaos_leg(
                registry, router, factory, metrics, make_batcher, compiles,
                pipelined, duration, 2 * low_qps,
                cache_capacity=((args.serve_cache_capacity or 4096)
                                if args.serve_cache else None))
        finally:
            if chaos_tracer is not None:
                trace_lib.uninstall()
        if chaos_tracer is not None:
            census = _span_census(chaos_tracer)
            n_bisect = census["spans"].get("bisect.split", 0)
            n_rescue = (census["spans"].get("fleet.failover.fetch", 0)
                        + census["spans"].get("fleet.failover.dispatch",
                                              0))
            n_rescue_parented = (
                census["parented"].get("fleet.failover.fetch", 0)
                + census["parented"].get("fleet.failover.dispatch", 0))
            chrome_events.extend(chaos_tracer.export_chrome(
                pid=2, process_name="distributedmnist-serve-chaos"
            )["traceEvents"])
            trace_leg["chaos"] = {
                "bisect_split_spans": n_bisect,
                "bisect_dispatch_spans":
                    census["spans"].get("bisect.dispatch", 0),
                "failover_rescue_spans": n_rescue,
                "failover_rescue_spans_parented": n_rescue_parented,
                "deadline_shed_spans":
                    census["spans"].get("deadline.shed", 0),
                "bisect_split_ok": n_bisect >= 1,
                # a fleet run must show >= 1 rescue as a child span (the
                # root bench's None on one replica)
                "failover_rescue_ok": (
                    n_rescue_parented >= 1 if fleet is not None
                    else None),
            }
            _mark(f"chaos trace: {n_bisect} bisect.split spans, "
                  f"{n_rescue} failover rescue spans "
                  f"({n_rescue_parented} parented), "
                  f"{trace_leg['chaos']['deadline_shed_spans']} "
                  "deadline.shed spans")

    recompiles = compiles.snapshot() - steady_from
    # the warmups the legs caused off the hot path are warmup, not
    # steady-state builds: the chaos fallback's and the megakernel's
    if chaos is not None:
        recompiles -= chaos["fallback_warmup_compile_events"]
    if lowlat_leg is not None:
        recompiles -= lowlat_leg["variant_warmup_compile_events"]
    if dtype_sweep is not None:
        recompiles -= dtype_sweep["variant_warmup_compile_events"]
    if cascade_leg is not None:
        recompiles -= cascade_leg["variant_warmup_compile_events"]
    if swap is not None:
        recompiles -= swap["warmup_compile_events"]
    if multimodel_leg is not None:
        recompiles -= multimodel_leg["warmup_compile_events"]
    if recompiles:
        _mark(f"WARNING: {recompiles} kernel-library loads or engine "
              "builds after warmup — steady state was to build nothing")
    open_piped_low = next(r for r in table if r["qps_target"] == low_qps)
    # The served surface of this record's geometry at its headline
    # precision (analysis/torchcheck.py, recorded on the CPU basis: the
    # same hash on the card), so a --baseline delta shows when two
    # records' served forwards differ.
    from distributedmnist_tpu_torch.analysis import torchcheck

    compile_surface = torchcheck.compile_surface_summary(
        args.model, factory.buckets, factory.max_batch, headline_dtype,
        n_chips=factory.n_chips)
    _mark(f"compile surface: {compile_surface['static_keys']} static "
          f"keys at {headline_dtype}, fingerprint set "
          f"{compile_surface['fingerprint_set_hash']}")
    record = {
        "metric": "serve_images_per_sec_per_chip",
        "value": round(value, 1),
        "unit": "images/sec/chip",
        # the root bench's TARGET_IPS_PER_CHIP is a TPU target: no baseline
        # for the port
        "vs_baseline": None,
        "detail": {
            "model": args.model,
            "dtype": args.dtype,
            "backend": factory.platform,
            "n_chips": n_chips,
            "host": _host_provenance(factory, infer_dtype=headline_dtype),
            "compile_surface": compile_surface,
            "buckets": list(factory.buckets),
            "max_batch": factory.max_batch,
            "max_wait_us": max_wait_us,
            "queue_depth": queue_depth,
            "max_inflight": piped.max_inflight,
            "rows_per_request": rows,
            "clients": clients,
            "duration_s": duration,
            "params": boot.source,
            "live_version_final": registry.live_version(),
            "warmup_compile_events": warm_builds,
            "recompiles_after_warmup": recompiles,
            "bucket_cost_ms": {str(b): round(c * 1e3, 3)
                               for b, c in sorted(
                                   router.bucket_costs().items())},
            "slo_ms": args.serve_slo_ms,
            "adaptive": not args.no_adaptive,
            "closed_loop": closed,
            "qps_sweep": table,
            "ragged": ragged,
            # the optional legs (None when not asked for)
            "zipf": zipf_leg,
            "lowlat": lowlat_leg,
            "chaos": chaos,
            "trace": trace_leg,
            "dtype_sweep": dtype_sweep,
            "cascade": cascade_leg,
            "swap": swap,
            "multimodel": multimodel_leg,
            "trace_replay": trace_replay_leg,
            # the fleet (None on one replica): which cards each replica
            # owns (an equal slice, or all of them as a logical replica
            # with streams of its own), the scaling leg and the fleet's
            # state at the end
            "replicas": ({
                "count": fleet.n_replicas,
                "per_replica_inflight": fleet.per_replica_inflight,
                "per_replica_chips": factory.n_chips,
                "disjoint_devices": (factory.total_chips
                                     == factory.n_chips
                                     * fleet.n_replicas),
                "provenance": [
                    {"id": rep.rid,
                     "devices": [str(d) for d in factory.replica_devices[i]]}
                    for i, rep in enumerate(fleet.replicas)],
                "fleet_leg": fleet_leg,
                "final": fleet.snapshot(),
            } if fleet is not None else None),
            # the overlap: pipelined capacity over the serial chain, and
            # the sub-capacity open-loop latency at both depths
            "inflight_comparison": {
                "serial_img_s_chip": round(serial_value, 1),
                "pipelined_img_s_chip": round(value, 1),
                "speedup": round(speedup, 3),
                "closed_loop_serial": closed_serial,
                "open_loop_qps": low_qps,
                "open_loop_serial_latency_ms": open_serial["latency_ms"],
                "open_loop_pipelined_latency_ms":
                    open_piped_low["latency_ms"],
            },
        },
    }
    if baseline_rec is not None:
        record["detail"]["baseline"] = _baseline_delta(
            record, baseline_rec, args.baseline)
    print(json.dumps(record), flush=True)
    if not args.no_artifact:
        # best effort: the record is on stdout already, and an unwritable
        # default directory must not turn a finished run into a failure
        artifact_dir = args.artifact_dir or os.path.dirname(
            os.path.dirname(os.path.abspath(__file__)))
        try:
            path = _next_serve_artifact(artifact_dir)
            with open(path, "w") as f:
                json.dump(record, f, indent=1)
                f.write("\n")
            _mark(f"artifact: {path}")
            if args.trace and chrome_events:
                # the Chrome trace-event file beside it, same round:
                # chrome://tracing or ui.perfetto.dev load it
                tpath = path[:-len(".json")] + "_trace.json"
                with open(tpath, "w") as f:
                    json.dump({"traceEvents": chrome_events,
                               "displayTimeUnit": "ms"}, f)
                    f.write("\n")
                _mark(f"trace artifact: {tpath}")
        except OSError as e:
            _mark(f"WARNING: artifact not written ({e}); the record "
                  "above is the only copy")
    return 0


def _gw_http(port: int, method: str, path: str, body=None,
             timeout: float = 60.0) -> tuple:
    """One urllib round-trip to the gateway (or a worker) on 127.0.0.1:
    (status, headers dict, parsed-JSON-or-raw). Non-2xx answers come
    back as values, never exceptions — the harness asserts on status
    codes explicitly."""
    import urllib.error
    import urllib.request

    headers = {}
    if isinstance(body, (bytes, bytearray)):
        headers["Content-Type"] = "application/json"
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=body, method=method,
                                 headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            raw, status, hdrs = r.read(), r.status, dict(r.headers)
    except urllib.error.HTTPError as e:
        raw, status, hdrs = e.read(), e.code, dict(e.headers)
    try:
        return status, hdrs, json.loads(raw)
    except ValueError:
        return status, hdrs, raw


def _gw_lat_ms(lat_s: list) -> dict:
    import numpy as np

    if not lat_s:
        return {"p50": None, "p95": None, "p99": None}
    a = np.asarray(lat_s)
    return {"p50": round(float(np.percentile(a, 50)) * 1e3, 3),
            "p95": round(float(np.percentile(a, 95)) * 1e3, 3),
            "p99": round(float(np.percentile(a, 99)) * 1e3, 3)}


class _GatewayFleet:
    """Handle on a spawned `python -m distributedmnist_tpu_torch.serve
    --gateway N` process tree. The bench process builds no engine and
    touches no card: every number is measured over HTTP as an
    operator's client sees it, and the per-worker cache and compile
    evidence is polled directly on the worker ports the gateway_ready
    line announces. The workers' `serve: launches {...}` exit lines are
    kept (`launches`) after stop()."""

    def __init__(self, args, n_workers: int):
        import subprocess
        import tempfile

        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        argv = [sys.executable, "-m", "distributedmnist_tpu_torch.serve",
                "--model", args.model, "--device", args.device,
                "--gateway", str(n_workers),
                "--serve-cache", "--port", "0", "--metrics-every", "30",
                "--serve-max-batch",
                str(16 if args.serve_max_batch is None
                    else args.serve_max_batch)]
        for flag, val in (("--serve-max-wait-us", args.serve_max_wait_us),
                          ("--serve-queue-depth", args.serve_queue_depth),
                          ("--serve-slo-ms", args.serve_slo_ms),
                          ("--serve-infer-dtype", args.serve_infer_dtype),
                          ("--serve-cache-capacity",
                           args.serve_cache_capacity),
                          ("--checkpoint-dir", args.checkpoint_dir),
                          ("--num-devices", args.num_devices)):
            if val is not None:
                argv += [flag, str(val)]
        if args.no_adaptive:
            argv.append("--no-adaptive")
        self.n = n_workers
        self.launches: list = []
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [repo] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH")
                      else []))
        self._errf = tempfile.NamedTemporaryFile(
            mode="w+", suffix=".gateway.stderr", delete=False)
        self.proc = subprocess.Popen(argv, stdout=subprocess.PIPE,
                                     stderr=self._errf, text=True,
                                     env=env)
        self.port, self.worker_ports = None, []
        deadline = time.monotonic() + 900
        while time.monotonic() < deadline:
            line = self.proc.stdout.readline()
            if not line:
                break
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if rec.get("metric") == "gateway_ready":
                self.port = rec["port"]
                self.worker_ports = list(rec["worker_ports"])
                break
        if self.port is None:
            self.stop()
            raise RuntimeError("gateway never announced readiness; "
                               "stderr tail:\n" + self._stderr_tail())
        make_thread(target=self._drain, name="bench-gw-drain",
                    daemon=True).start()

    def _drain(self):
        # keep reading the gateway's stdout (periodic metrics lines) so
        # the pipe never fills and stalls it
        for _ in self.proc.stdout:
            pass

    def _stderr_tail(self, tail: int = 4000) -> str:
        try:
            self._errf.flush()
            with open(self._errf.name) as f:
                return f.read()[-tail:]
        except OSError:
            return "<unavailable>"

    def wait_healthy(self, want_dtype: str = None,
                     deadline_s: float = 900.0) -> dict:
        deadline = time.monotonic() + deadline_s
        payload = None
        while time.monotonic() < deadline:
            if self.proc.poll() is not None:
                raise RuntimeError(
                    f"gateway exited rc={self.proc.returncode} while "
                    "warming; stderr tail:\n" + self._stderr_tail())
            try:
                st, _, payload = _gw_http(self.port, "GET", "/healthz",
                                          timeout=10.0)
            except OSError:
                st = None
            if st == 200 and isinstance(payload, dict):
                rows = payload.get("workers") or []
                if len(rows) == self.n and all(r.get("ok") for r in rows):
                    # a worker's /healthz is 200 only with its boot
                    # precision live, so another dtype here is a refusal
                    if want_dtype is not None and any(
                            r.get("live_infer_dtype") != want_dtype
                            for r in rows):
                        raise RuntimeError(
                            f"workers went live at another precision "
                            f"than {want_dtype}: {rows}; stderr tail:\n"
                            + self._stderr_tail())
                    return payload
            time.sleep(0.5)
        raise RuntimeError("gateway fleet never became healthy: "
                           f"{payload}; stderr tail:\n"
                           + self._stderr_tail())

    def worker_stats(self) -> dict:
        """Per-worker cache hit/miss + compile counters (the sharded-
        cache and steady-state-recompile evidence is per WORKER — the
        gateway deliberately holds no cache and no engine of its own)."""
        out = {}
        for wp in self.worker_ports:
            st, _, payload = _gw_http(wp, "GET", "/metrics",
                                      timeout=10.0)
            cache = (payload.get("cache") or {}) if st == 200 else {}
            out[wp] = {
                "hits": cache.get("hits", 0),
                "misses": cache.get("misses", 0),
                "compiles_total": (payload.get("compiles_total")
                                   if st == 200 else None)}
        return out

    def stop(self):
        import signal as signal_mod
        import subprocess

        from distributedmnist_tpu_torch.ops import fused
        from distributedmnist_tpu_torch.serve.process import \
            LAUNCHES_PREFIX

        if self.proc.poll() is None:
            self.proc.send_signal(signal_mod.SIGTERM)
            try:
                self.proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                _mark("the gateway did not exit within 60 s of SIGTERM; "
                      "killed")
                self.proc.kill()
                self.proc.wait(timeout=30)
        err = self._stderr_tail(tail=1 << 30)
        self.launches = fused.parse_launches(err, LAUNCHES_PREFIX)
        for counts in self.launches:
            _mark("worker launches " + json.dumps(counts))
        if len(self.launches) != self.n:
            _mark(f"{len(self.launches)} worker launch lines from "
                  f"{self.n} workers; the gateway's stderr ends:\n"
                  + err[-3000:])
        try:
            self._errf.close()
            os.unlink(self._errf.name)
        except OSError:
            pass


def _gw_closed_loop(port: int, clients: int, duration: float,
                    rows: int, seed: int) -> dict:
    """Closed-loop fleet capacity over HTTP: `clients` persistent
    connections, every request a UNIQUE body (capacity must price real
    inference, not cache hits). 503 backpressure is counted and retried
    after a short pause — shed-and-retry is the documented client
    contract. The window is timed once every client runs: each connects,
    then waits at a barrier whose last party sets the window's start and
    end (on a busy host starting the clients can outlast the window, and
    a clock started before them measured an empty one). A request counts
    when it was sent before the end and answered 200; the rates are over
    the window the clients had, from its start to the last answer."""
    import http.client
    import threading

    import numpy as np

    window: dict = {}
    lats, oks, sheds, errs, ends = [], [], [], [], []

    def start_window():
        window["start"] = time.perf_counter()
        window["end"] = window["start"] + duration

    ready = threading.Barrier(clients + 1, action=start_window)

    def drive(tid: int):
        rng = np.random.default_rng(10_000 * seed + tid)
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        my_lat, my_ok, my_shed, my_err = [], 0, 0, 0
        try:
            conn.connect()
        except OSError:
            conn.close()             # the first request connects anew
        ready.wait()
        t_end = window["end"]
        while time.perf_counter() < t_end:
            body = rng.integers(0, 256, rows * 784,
                                dtype=np.uint8).tobytes()
            t0 = time.perf_counter()
            try:
                conn.request("POST", "/predict", body,
                             {"Content-Type":
                              "application/octet-stream"})
                r = conn.getresponse()
                r.read()
                status = r.status
            except (OSError, http.client.HTTPException):
                conn.close()
                conn = http.client.HTTPConnection("127.0.0.1", port,
                                                  timeout=60)
                my_err += 1
                continue
            if status == 200:
                my_ok += 1
                my_lat.append(time.perf_counter() - t0)
            elif status == 503:
                my_shed += 1
                time.sleep(0.002)
            else:
                my_err += 1
        ends.append(time.perf_counter())
        conn.close()
        lats.append(my_lat)
        oks.append(my_ok)
        sheds.append(my_shed)
        errs.append(my_err)

    threads = [make_thread(target=drive, name=f"bench-gw-closed-{i}",
                           daemon=False, args=(i,))
               for i in range(clients)]
    for t in threads:
        t.start()
    try:
        ready.wait(timeout=CLIENTS_READY_S)
    except threading.BrokenBarrierError:
        raise RuntimeError(f"the {clients} closed-loop clients were not "
                           f"all running within {CLIENTS_READY_S:g} s"
                           ) from None
    for t in threads:
        t.join()
    done = sum(oks)
    had = max(ends) - window["start"]
    return {
        "requests_ok": done,
        "requests_per_sec": round(done / had, 1),
        "rows_per_sec": round(done * rows / had, 1),
        "latency_ms": _gw_lat_ms(sorted(
            x for chunk in lats for x in chunk)),
        "shed_503": sum(sheds),
        "transport_errors": sum(errs),
        "clients": clients,
        "duration_s": duration,
    }


def _gw_open_loop(port: int, qps: float, duration: float, rows: int,
                  seed: int, pool: int = 16) -> dict:
    """Open-loop Poisson arrivals at `qps`: latency measured from the
    SCHEDULED arrival (coordinated-omission-safe), a worker pool
    pulling a precomputed arrival schedule."""
    import http.client
    import queue as queue_mod

    import numpy as np

    rng = np.random.default_rng(seed)
    t0 = time.perf_counter() + 0.2
    arrivals = queue_mod.Queue()
    t, n_sched = t0, 0
    for gap in rng.exponential(1.0 / qps, int(qps * duration) + 64):
        t += gap
        if t >= t0 + duration:
            break
        arrivals.put(t)
        n_sched += 1
    lats, oks, sheds, errs = [], [], [], []

    def drive(tid: int):
        body_rng = np.random.default_rng(77_000 * seed + tid)
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        my_lat, my_ok, my_shed, my_err = [], 0, 0, 0
        while True:
            try:
                sched = arrivals.get_nowait()
            except queue_mod.Empty:
                break
            now = time.perf_counter()
            if sched > now:
                time.sleep(sched - now)
            body = body_rng.integers(0, 256, rows * 784,
                                     dtype=np.uint8).tobytes()
            try:
                conn.request("POST", "/predict", body,
                             {"Content-Type":
                              "application/octet-stream"})
                r = conn.getresponse()
                r.read()
                status = r.status
            except (OSError, http.client.HTTPException):
                conn.close()
                conn = http.client.HTTPConnection("127.0.0.1", port,
                                                  timeout=60)
                my_err += 1
                continue
            if status == 200:
                my_ok += 1
                my_lat.append(time.perf_counter() - sched)
            elif status == 503:
                my_shed += 1
            else:
                my_err += 1
        conn.close()
        lats.append(my_lat)
        oks.append(my_ok)
        sheds.append(my_shed)
        errs.append(my_err)

    threads = [make_thread(target=drive, name=f"bench-gw-open-{i}",
                           daemon=False, args=(i,))
               for i in range(pool)]
    for t_ in threads:
        t_.start()
    for t_ in threads:
        t_.join()
    done = sum(oks)
    return {
        "qps_target": round(qps, 1),
        "scheduled": n_sched,
        "requests_ok": done,
        "latency_ms": _gw_lat_ms(sorted(
            x for chunk in lats for x in chunk)),
        "shed_503": sum(sheds),
        "transport_errors": sum(errs),
    }


def _gw_zipf_leg(fleet: "_GatewayFleet", rows: int, n_keys: int = 32,
                 draws: int = 400, alpha: float = 1.1) -> dict:
    """The sharded-cache leg: a Zipf mix over a fixed key set, each key
    a byte-identical body, so the ring's affinity routing turns N
    per-worker caches into one sharded cache. Evidence is per worker:
    every key lands on exactly ONE worker (X-Gateway-Worker is
    single-valued per key — sharded, never duplicated) and the
    hit-ratio delta comes from the workers' own cache counters."""
    import http.client

    import numpy as np

    rng = np.random.default_rng(42)
    bodies = [rng.integers(0, 256, rows * 784, dtype=np.uint8).tobytes()
              for _ in range(n_keys)]
    ranks = np.arange(1, n_keys + 1, dtype=np.float64)
    prob = ranks ** -alpha
    prob /= prob.sum()
    seq = rng.choice(n_keys, size=draws, p=prob)
    before = fleet.worker_stats()
    owners, lat, ok = {}, [], 0
    conn = http.client.HTTPConnection("127.0.0.1", fleet.port,
                                      timeout=60)
    for k in seq:
        t0 = time.perf_counter()
        conn.request("POST", "/predict", bodies[int(k)],
                     {"Content-Type": "application/octet-stream"})
        r = conn.getresponse()
        r.read()
        if r.status == 200:
            ok += 1
            lat.append(time.perf_counter() - t0)
            owners.setdefault(int(k), set()).add(
                r.getheader("X-Gateway-Worker"))
    conn.close()
    after = fleet.worker_stats()
    per_worker, hits, misses = {}, 0, 0
    for wp in fleet.worker_ports:
        dh = after[wp]["hits"] - before[wp]["hits"]
        dm = after[wp]["misses"] - before[wp]["misses"]
        per_worker[str(wp)] = {"hits": dh, "misses": dm}
        hits += dh
        misses += dm
    return {
        "keys": n_keys,
        "draws": draws,
        "alpha": alpha,
        "requests_ok": ok,
        # hits/(hits+misses) over the leg's own window, summed across
        # the per-worker shards
        "shard_hit_ratio": (round(hits / (hits + misses), 4)
                            if hits + misses else None),
        "per_worker_cache": per_worker,
        "every_key_single_worker": all(
            len(s) == 1 for s in owners.values()),
        "workers_serving_keys": sorted(
            {next(iter(s)) for s in owners.values() if len(s) == 1}),
        "p99_ms": _gw_lat_ms(sorted(lat))["p99"],
    }


def _gw_promote_leg(fleet: "_GatewayFleet", rows: int,
                    clients: int = 4, settle_s: float = 0.75) -> dict:
    """A live fleet promote under load: hammer threads keep unique-body
    traffic flowing while the gateway runs its two-phase prepare/flip.
    Every 200 is recorded as (X-Cluster-Epoch, served version); the leg
    reports the epoch->version map — single-valued means zero torn
    replies — alongside the gateway's own mixed_epoch_rejected counter.
    The promote pause sheds 503s by design; the hammer retries them and
    the count is disclosed."""
    import http.client
    import threading

    import numpy as np

    stop = threading.Event()
    pairs, sheds = [], [0]
    lock = threading.Lock()

    def hammer(tid: int):
        rng = np.random.default_rng(31_000 + tid)
        conn = http.client.HTTPConnection("127.0.0.1", fleet.port,
                                          timeout=60)
        my, my_shed = [], 0
        while not stop.is_set():
            body = rng.integers(0, 256, rows * 784,
                                dtype=np.uint8).tobytes()
            try:
                conn.request("POST", "/predict", body,
                             {"Content-Type":
                              "application/octet-stream"})
                r = conn.getresponse()
                raw = r.read()
                if r.status == 200:
                    my.append((r.getheader("X-Cluster-Epoch"),
                               json.loads(raw).get("version")))
                elif r.status == 503:
                    my_shed += 1
                    time.sleep(0.01)
            except (OSError, http.client.HTTPException):
                conn.close()
                conn = http.client.HTTPConnection(
                    "127.0.0.1", fleet.port, timeout=60)
        conn.close()
        with lock:
            pairs.extend(my)
            sheds[0] += my_shed

    threads = [make_thread(target=hammer, name=f"bench-gw-hammer-{i}",
                           daemon=False, args=(i,))
               for i in range(clients)]
    for t in threads:
        t.start()
    time.sleep(settle_s)
    st, _, verdict = _gw_http(
        fleet.port, "POST", "/models/promote",
        json.dumps({"load": {"fresh": {"seed": 7}}}).encode(),
        timeout=600.0)
    time.sleep(settle_s)
    stop.set()
    for t in threads:
        t.join()
    epoch_versions = {}
    for ep, ver in pairs:
        epoch_versions.setdefault(ep, set()).add(ver)
    torn = {ep: sorted(v) for ep, v in epoch_versions.items()
            if len(v) > 1}
    _, _, gw_now = _gw_http(fleet.port, "GET", "/metrics",
                            timeout=10.0)
    gw_now = gw_now if isinstance(gw_now, dict) else {}
    return {
        "promote_status": st,
        "promoted": (verdict.get("promoted")
                     if isinstance(verdict, dict) else None),
        "cluster_epoch": gw_now.get("cluster_epoch"),
        "responses_during_promote": len(pairs),
        "responses_by_epoch": {
            ep: sum(1 for e, _ in pairs if e == ep)
            for ep in epoch_versions},
        "epoch_version_map": {ep: sorted(v)
                              for ep, v in epoch_versions.items()},
        "torn_epochs": torn,
        "mixed_epoch_rejected": gw_now.get("mixed_epoch_rejected"),
        "zero_mixed_epoch": (gw_now.get("mixed_epoch_rejected") == 0
                             and not torn),
        "shed_503_during_promote": sheds[0],
    }


def _gw_contention_probe(n: int) -> dict:
    """The honesty probe behind gateway_scaling_efficiency: N worker
    processes share ONE host's cores, so N-x scaling is only reachable
    when N compute-bound processes don't slow each other down. Times
    the same numpy matmul loop solo vs N-concurrent —
    host_contention_x well above 1 means the scaling bar was NOT
    reachable on this host and the efficiency number must be read
    against that, exactly like the CPU-vs-TPU provenance rule."""
    import subprocess

    probe = ("import time\nimport numpy as np\n"
             "a = np.random.default_rng(0).standard_normal("
             "(384, 384)).astype(np.float32)\n"
             "t0 = time.perf_counter()\n"
             "for _ in range(300):\n"
             "    a = a @ a\n"
             "    a /= (abs(a).max() + 1.0)\n"
             "print(time.perf_counter() - t0)\n")

    def run_n(k: int) -> list:
        procs = [subprocess.Popen([sys.executable, "-c", probe],
                                  stdout=subprocess.PIPE, text=True)
                 for _ in range(k)]
        out = []
        for pr in procs:
            stdout, _ = pr.communicate(timeout=600)
            out.append(float(stdout.strip()))
        return sorted(out)

    run_n(1)                                  # interpreter/BLAS warmup
    solo = sorted(run_n(1)[0] for _ in range(3))[1]
    conc = run_n(n)[n // 2]
    x = conc / max(solo, 1e-9)
    return {"solo_s": round(solo, 3),
            "concurrent_s": round(conc, 3),
            "concurrency": n,
            "host_contention_x": round(x, 3),
            "scaling_bar_reachable": x <= 1.25}


def _serve_gateway(args) -> int:
    """The gateway harness (the root bench's): black-box load against
    `python -m distributedmnist_tpu_torch.serve --gateway N`, a front
    door routing over N full serving processes, measured over HTTP as
    an operator's client sees it. Legs: closed-loop capacity at 1 worker
    then at N (scaling_efficiency = img_s_N / (N * img_s_1), the
    1-worker control running behind the SAME gateway so the routing hop
    is priced in both numerator and denominator), an open-loop Poisson
    point at ~half the measured fleet capacity, the Zipf sharded-cache
    leg (per-key single-owner routing + per-worker hit counters), the
    per-worker steady-state recompile check, a live two-phase promote
    under load (zero mixed-epoch responses), and the host-contention
    probe that says whether the N-x scaling bar was even reachable on
    this host's silicon."""
    n = args.gateway
    rows = args.serve_rows
    duration = (3.0 if args.serve_duration is None
                else args.serve_duration)
    clients = 8 if args.serve_clients is None else args.serve_clients

    baseline_rec = None
    if args.baseline:
        with open(args.baseline) as f:
            baseline_rec = json.load(f)          # shape pre-validated
        if baseline_rec["detail"].get("gateway") is None:
            # symmetric with _serve's refusal: a single-process record
            # is no baseline for an N-process aggregate
            _mark(f"REFUSING --baseline {args.baseline}: it is a "
                  "single-process serve record; this run is a "
                  f"--gateway {n} fleet — aggregate-vs-single deltas "
                  "are meaningless (compare single-process rounds "
                  "with bench serve --baseline <serve record>)")
            return REFUSED

    # Leg 0 — the 1-worker control behind the same front door.
    _mark("gateway fleet [1 worker]: booting the scaling control")
    fleet1 = _GatewayFleet(args, 1)
    try:
        fleet1.wait_healthy()
        _mark(f"gateway fleet [1 worker]: port {fleet1.port} healthy")
        _gw_closed_loop(fleet1.port, clients, min(1.0, duration),
                        rows, seed=1)            # warm the HTTP path
        closed1 = _gw_closed_loop(fleet1.port, clients, duration,
                                  rows, seed=2)
    finally:
        fleet1.stop()
    img_s_1 = closed1["rows_per_sec"]
    _mark(f"gateway fleet [1 worker]: {img_s_1:.0f} img/s "
          f"(p99 {closed1['latency_ms']['p99']} ms)")

    # Legs 1..n — the N-worker fleet.
    want_dtype = (args.serve_infer_dtype
                  if args.serve_infer_dtype in ("bfloat16", "int8",
                                                "megakernel")
                  else None)
    _mark(f"gateway fleet [{n} workers]: booting")
    fleet = _GatewayFleet(args, n)
    try:
        fleet.wait_healthy(want_dtype=want_dtype)
        # worker-reported provenance: the gateway process holds no
        # backend — the workers' own healthz says what silicon answers
        st, _, w0 = _gw_http(fleet.worker_ports[0], "GET", "/healthz",
                             timeout=10.0)
        w0 = w0 if isinstance(w0, dict) else {}
        backend = w0.get("backend")
        device_kind = w0.get("device_kind")
        infer_dtype = w0.get("live_infer_dtype") or "float32"
        if baseline_rec is not None:
            base_kind = baseline_rec["detail"]["host"]["device_kind"]
            if base_kind != device_kind:
                _mark(f"REFUSING --baseline {args.baseline}: it was "
                      f"measured on device_kind={base_kind!r}, these "
                      f"workers report {device_kind!r} — cross-silicon "
                      "serve deltas are meaningless")
                return REFUSED

        _gw_closed_loop(fleet.port, clients, min(1.0, duration), rows,
                        seed=3)                  # warm every worker
        steady_from = fleet.worker_stats()       # compile snapshot
        _mark(f"closed loop [{n} workers]: {clients} clients x "
              f"{duration:.0f}s")
        closed = _gw_closed_loop(fleet.port, clients, duration, rows,
                                 seed=4)
        img_s_n = closed["rows_per_sec"]
        eff = img_s_n / max(n * img_s_1, 1e-9)
        _mark(f"closed loop [{n} workers]: {img_s_n:.0f} img/s "
              f"aggregate (p99 {closed['latency_ms']['p99']} ms), "
              f"scaling efficiency {eff:.2f}")

        qps = max(1.0, 0.5 * closed["requests_per_sec"])
        open_loop = _gw_open_loop(fleet.port, qps, duration, rows,
                                  seed=5)
        _mark(f"open loop qps={qps:.0f}: p99 "
              f"{open_loop['latency_ms']['p99']} ms, "
              f"{open_loop['shed_503']} shed")

        zipf = _gw_zipf_leg(fleet, rows)
        _mark(f"zipf: shard hit ratio {zipf['shard_hit_ratio']}, "
              f"single-owner={zipf['every_key_single_worker']}, "
              f"{len(zipf['workers_serving_keys'])} workers own keys")

        # steady-state recompile check BEFORE the promote leg: the
        # fresh version's warmup compiles are expected; recompiles in
        # the measured steady window are not.
        steady_to = fleet.worker_stats()
        per_worker_recompiles = {
            str(wp): ((steady_to[wp]["compiles_total"] or 0)
                      - (steady_from[wp]["compiles_total"] or 0))
            for wp in fleet.worker_ports}
        recompiles = sum(per_worker_recompiles.values())
        _mark(f"recompiles after warmup: {recompiles} "
              f"({per_worker_recompiles})")

        promote = _gw_promote_leg(fleet, rows)
        _mark(f"promote under load: epoch {promote['cluster_epoch']}, "
              f"{promote['responses_during_promote']} responses, "
              f"mixed-epoch rejected {promote['mixed_epoch_rejected']},"
              f" torn epochs {promote['torn_epochs'] or 'none'}")

        _, _, gw_metrics = _gw_http(fleet.port, "GET", "/metrics",
                                    timeout=10.0)
        gw_metrics = gw_metrics if isinstance(gw_metrics, dict) else {}
    finally:
        fleet.stop()

    contention = _gw_contention_probe(n)
    bar = ("scaling bar reachable"
           if contention["scaling_bar_reachable"]
           else "scaling bar NOT reachable on this host")
    _mark(f"host contention probe: "
          f"{contention['host_contention_x']}x ({bar})")

    import platform as platform_mod
    import socket

    record = {
        "metric": "gateway_images_per_sec",
        "value": round(img_s_n, 1),
        "unit": "images/sec (fleet aggregate)",
        # N worker processes share one host and one card (see
        # gateway.host_contention_x): no per-chip target applies to the
        # fleet aggregate
        "vs_baseline": None,
        "detail": {
            "model": args.model,
            "dtype": args.dtype,
            "backend": backend,
            "n_chips": None,
            "host": {
                "hostname": socket.gethostname(),
                "platform": platform_mod.platform(),
                "machine": platform_mod.machine(),
                "cpu_count": os.cpu_count(),
                "backend": backend,
                "device_kind": device_kind,
                "power_limit_w": (_power_limit_w()
                                  if backend == "cuda" else None),
                # the workers share one card: a chip count here would
                # count it N times
                "chip_count": None,
                "infer_dtype": infer_dtype,
                "fused_kernels": None,
                **_git_provenance(),
            },
            "rows_per_request": rows,
            "clients": clients,
            "duration_s": duration,
            "closed_loop": closed,
            "recompiles_after_warmup": recompiles,
            "gateway": {
                "workers": n,
                "worker_ports": fleet.worker_ports,
                "img_s_1": round(img_s_1, 1),
                "img_s_n": round(img_s_n, 1),
                "scaling_efficiency": round(eff, 3),
                "host_contention_x": contention["host_contention_x"],
                "scaling_bar_reachable":
                    contention["scaling_bar_reachable"],
                "contention_probe": contention,
                "closed_loop_1worker": closed1,
                "open_loop": open_loop,
                "zipf": zipf,
                "promote": promote,
                "per_worker_recompiles": per_worker_recompiles,
                "final_metrics": {k: gw_metrics.get(k) for k in (
                    "requests", "routed_affinity", "routed_balanced",
                    "failovers", "failover_rescued",
                    "backpressure_503", "paused_503",
                    "mixed_epoch_rejected", "worker_deaths",
                    "promotes", "cluster_epoch")},
            },
        },
    }
    if baseline_rec is not None:
        record["detail"]["baseline"] = _baseline_delta(
            record, baseline_rec, args.baseline)
    print(json.dumps(record), flush=True)
    if not args.no_artifact:
        # best-effort, like _serve: the record is already on stdout
        artifact_dir = args.artifact_dir or os.path.dirname(
            os.path.dirname(os.path.abspath(__file__)))
        try:
            path = _next_serve_artifact(artifact_dir)
            with open(path, "w") as f:
                json.dump(record, f, indent=1)
                f.write("\n")
            _mark(f"artifact: {path}")
        except OSError as e:
            _mark(f"WARNING: artifact not written ({e}); the record "
                  "above is the only copy")
    return 0

if __name__ == "__main__":
    sys.exit(main())
