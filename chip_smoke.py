#!/usr/bin/env python3
"""Drive the PyTorch port's MLP serving path, its training paths (one
card, data-parallel and tensor-parallel ranks sharing it, bfloat16, the
streaming pipeline), its LeNet-5 serving path, its HTTP server, its
request path, its replica fleet and cascade, multi-tenant, multi-model
serving, the gateway over worker processes, trace replay and the
autoscaler, its bench, its analysis tools (the serving path run under
the concurrency sanitizer) and serving over a card group on one CUDA
card.

    python3 chip_smoke.py

1. Prints the card's name and power limit (nvidia-smi), builds the three
   hand-written kernels from distributedmnist_tpu_torch/csrc/ (one nvcc
   per source, all at once) and prints each build's -Xptxas -v report;
   meanwhile the fork server comes up and its first child fills the
   bytecode cache with every module of the port.
2. Holds every kernel against its plain PyTorch version on the card at
   the serving path's shapes (buckets 1, 7, 128 and 512) and dense_relu
   at the training paths' (a config-1 step's 64 rows, an eval batch's
   2048, and each data-parallel rank's share of a step and of an eval
   batch in phase 5: 64, 128, 255 and 1024 rows), checks that the split-K kernels give the same bits on two
   calls, and times it with CUDA events beside the plain version, one
   PyTorch library call for the same function (timed here only; the port
   never calls it) and its bound: the larger of bytes over 3.35 TB/s and
   operations over the card's peak for their type. `ms` is device time
   (calls captured in a CUDA graph and replayed); `call_ms` is the time
   per call made one by one from Python, host launch cost included.
   Then 50 MLP SGD steps through the trainer's step with the kernel,
   against the same 50 steps with the plain version, loss by loss and
   the params at the end.
3. Drives the serving path through the port's own entry points, with
   every launch count set to 0 first: bootstrap (fresh-init, float32
   live), a selftest of 256 requests through the dynamic batcher, then a
   fitted version promoted and the bfloat16, int8 and megakernel variants
   added through the registry's parity gate, each serving a burst that
   is checked against the float32 model.
4. Drives the training path through trainer.fit, with every launch
   count set to 0 first, on full-size synthetic MNIST (60,000/10,000):
   config 1 (MLP, SGD, batch 64) for 2000 steps and config 2 (LeNet-5,
   Adam, batch 128) for its 10 epochs (4680 steps), committing
   checkpoints every 1000 steps into a temporary directory, each held to a test-accuracy floor from
   the CPU run of the same recipe; then a run killed by the fault hook
   and resumed from its checkpoint.
5. Drives data-parallel training, with every launch count set to 0
   first, each rank a child process that reports its own counts:
   config 3 at full width (`train --preset mlp-dp2 --synthetic
   --learning-rate 0.02 --steps 1000`: the CLI starts 2 ranks sharing
   the card over gloo), held to the backend line, the topology, an
   accuracy floor from the CPU run of the same command (the summary
   counts one chip for the two processes) and each rank's
   dense_relu launches (its steps and eval batches); 20 steps of config
   3 in both SPMD modes (parallel/mh_smoke.py), auto against explicit
   and 2 ranks against 1; config 5 (`--preset lenet-multihost` over the
   coordinator flags, 2 ranks) killed at step 200 by the fault hook on
   both ranks and restored there, its checkpoint loaded with the LeNet
   template; and NCCL at world size 1 (config 4's LeNet, `--num-devices
   1`), 200 steps. The groups that run at once take distinct ports (one
   launch.free_ports call), and a group whose port was taken before its
   rank 0 bound it is rerun once on a fresh port.
6. Holds the kernels at LeNet's serving shapes (dense_relu bf16 400->120
   and 120->84, quant_dense 400->120, 120->84 and 84->10, buckets 1, 7,
   128 and 512) against their plain versions on the trained weights'
   activations, int8 exact, timed as in 2, and times LeNet's forward per
   precision and bucket.
7. Drives LeNet serving through the port's entry points, with every
   launch count set to 0 first: bootstrap from config 2's checkpoint
   (TF32 turned on before, which the engine must turn off), the float32
   engine against the same params' CPU engine at every bucket, the
   bfloat16 and int8 variants activated through the parity gate (a
   refusal fails the run), two selftest bursts of 256 requests per
   precision through the dynamic batcher, then the lifecycle: the trainer commits a later
   step, the registry loads and promotes it, rolls back from it, and the
   first version must be live again with the rollback event recorded.
8. Drives the port's HTTP server, `python -m distributedmnist_tpu_torch.serve
   --port 0`, one subprocess a server, each on its own launch counts.
   The MLP server boots the fitted weights from a checkpoint at
   --serve-infer-dtype megakernel: /healthz polled to 200, 100
   sequential 1-row /predict calls timed (p50/p99 printed with the
   card's name and power limit), a 512-row /predict held against the
   float32 model on the CPU at the megakernel gate's agreement, a fresh
   version loaded and made a 0.25 canary and another a 0.5 shadow over
   HTTP (/metrics must show both populations and the shadow
   comparisons), a later checkpoint rolled in by SIGHUP (live at
   megakernel again), and SIGTERM (rc 0, a serve_summary line). The
   LeNet-5 server boots config 2's checkpoint at int8: /healthz 200,
   int8 live, 100 timed 1-row calls, a 512-row /predict against the
   float32 engine on the CPU at the int8 gate's agreement, SIGTERM rc 0.
   Each server prints its launch counts on stderr at exit: the MLP
   server must have launched dense_relu and mlp_megakernel, the LeNet
   server quant_dense.
9. Runs the port's bench, `python -m distributedmnist_tpu_torch.bench`,
   one subprocess a run, with short explicit windows: throughput of the
   MLP (batch 64) and of LeNet-5 (batch 512), LeNet-5's
   time-to-accuracy to 0.99 (one trial), and the serve legs of the MLP
   at float32 and of LeNet-5 at bfloat16 and int8 booted from config 2's
   checkpoint. Each must exit 0 and print one record with the root
   bench's keys, a value above 0, the card's name, no kernel-library load
   or engine build after warmup, and the trial must reach its target;
   each record is printed on a `bench` line, and the launches the runs
   report are the `bench` path's. Then, on launch counts of their own
   (the `bench_ranks` path), the bench's training modes over 2 ranks
   (`--num-devices 2`), both runs at once: the MLP's throughput (global
   batch 128, 64 rows a rank) and LeNet-5's time-to-accuracy to 0.99
   (batch 512, one trial). On one card the ranks share it over gloo and
   the record counts one chip; with two or more cards, one a rank over
   NCCL, two chips. Each must print one record with the root bench's
   keys, n_chips and the backend so, the target reached, a launch line
   from every rank, and dense_relu launched in both ranks of the MLP
   run; each run's seconds and record are printed.
10. The rest of training (after phase 5), with every launch count set to
   0 first, children reporting their own: dense_relu f32 at each
   tensor-parallel rank's column shard (N = 64 and 32: the trainer's
   split of config 3's batch and of an eval batch at (world,
   model_parallel) 2x2, 4x2 and 4x4) and bf16 at N = 128 (64, 512 and
   2048 rows) against its plain version in phase 2's checks; the MLP
   (200 steps) and LeNet-5 (20 steps, Adam) at --model-parallel 2 as 2
   ranks sharing the card over gloo (mh_smoke), their losses within
   1e-4 of 1 rank's and each MLP rank's dense_relu launches at least its
   steps and eval batch; both through the train CLI at full width, 500
   steps, beside 1 rank at the same global batch; configs 1 and 2 for
   1000 steps in float32 and bfloat16 (bf16 accuracy floors; the MLP's
   dense_relu launched in bf16); config 2 through --data-pipeline stream
   against the device pipeline under cuDNN's deterministic algorithms
   (losses within 1e-6); IDX files written from the synthetic set, read
   through the native reader (built first, its reads counted), then the
   train CLI on them with --supervise and --profile-dir (a trace file
   must exist). Phase 9 also runs the bench's sweep (LeNet-5, batches 64
   and 512) and smoke (the MLP in bfloat16).
11. The request path (after phase 9), each part on launch counts of its
   own: the fast lane engine by engine (the MLP at float32, bfloat16,
   int8 and megakernel, LeNet-5 at float32, bfloat16 and int8), 1-row
   requests through dispatch_fast and through a batcher with the lane on,
   bit for bit the pooled dispatch's at bucket 1 and at the parity gate's
   thresholds against the same engine on the CPU (the kernels' plain
   versions), all three kernels launched on the fast route; the
   row-staged route priced against the pooled dispatch and held on a
   dirty resident buffer; exact fit against the pooled dispatch and a
   pinned-tensor staging at b = 1;
   the bench's `serve --lowlat --zipf --chaos --trace` on the MLP (the
   root bench's leg keys, an exact chaos ledger, one breaker trip and one
   rollback, nothing built after warmup); and the HTTP server with
   --serve-fastlane --serve-cache --serve-trace against the same without
   the lane (1-row /predict p50/p99 each, a cache hit, X-Trace-Id and
   Server-Timing, GET /trace, a timed Prometheus scrape, /metrics' cache,
   resilience_policy and trace blocks).
12. The fleet and the cascade (after phase 11), each path on launch
   counts of its own: a two-replica MLP fleet in process (both replicas
   on the card, each on a CUDA stream of its own; the fitted weights at
   float32, bfloat16, int8 and megakernel fanned out to both), 256 mixed
   requests of 1-32 rows per precision through the batcher, every batch
   bit for bit a single router's dispatch of the same rows on its
   replica and the dispatches balanced within the root bench's 1.25; a
   kill burst on r1 (replica.fetch, then replica.dispatch) absorbed by
   failover with every request answered, and a latency fault on r0
   raced by the hedge, both bit for bit too, with nothing built after
   warmup; the MLP's cascade in process (exact the float32 route's
   bytes, fast the cheap route's, balanced their composition at the
   parity bar); over HTTP a `--serve-replicas 2 --serve-hedge` server
   (drain r1 200, drain r0 409, rejoin 200, /healthz's replicas,
   /metrics' fleet block and the replica families) and a LeNet-5
   `--serve-cascade` server on config 2's 10-epoch checkpoint (exact
   the float32 route's classes, fast the int8 route's, balanced at the
   parity bar); and the bench's `serve --serve-replicas 2 --serve-hedge
   --chaos` (the replica kill absorbed, availability 1.0 of the
   non-injected requests, failovers and hedges counted) and `serve
   --dtype-sweep --cascade` on LeNet-5 (the frontier), with the root
   bench's keys.
13. Tenancy and the bench's records (after phase 12), on launch counts of
   its own: the MLP and LeNet-5 in one process behind the global
   scheduler (build_tenancy over `mlp,lenet`, each model from its own
   checkpoint subtree: the fitted MLP and config 2's 10-epoch LeNet-5,
   each model's engines on a CUDA stream of its own), tenants `light`
   (weight 2, 5000 ms deadline, the MLP) and `heavy` (weight 1, LeNet-5),
   at float32 and again at megakernel (LeNet-5 refuses it and stays at
   float32); 256 mixed requests of 1-16 rows per tenant, every batch bit
   for bit its model's own router's dispatch of the same rows and every
   answer its slice; a quota shed (429 with retry_after_s), a door
   deadline shed (504, nothing dispatched), a cached answer served over
   quota, the observed skip maximum under drr_skip_bound, nothing built
   after warmup; the cross-model contention probe with the catalog's
   per-model streams and without them. Over HTTP a `--serve-models
   mlp,lenet --serve-tenants ... --serve-infer-dtype int8` server
   (X-Tenant 200 for a class and an unknown tenant, a free tenant's burst
   into 429 with Retry-After, X-Deadline-Ms 0.001 504, GET /tenants,
   the quota route's 200 and 404, /metrics' by_tenant and by_model
   blocks and families, quant_dense launched, SIGTERM rc 0 with the
   summary's tenancy block). The bench's `serve --multimodel
   --swap-during-load` (the root bench's leg keys, fairness ratios, both
   light p99s measured, no build after warmup or after the swap)
   writing BENCH_torch_serve_r01.json into a temporary directory (the
   card's name as device_kind, the commit), a second run diffing
   against it with --baseline, and a --baseline on the JAX package's
   CPU record refused before any load phase (exit 4, not retried).
14. The gateway, trace replay and the autoscaler (after phase 13), each
   child reporting its own launch counts: `python -m
   distributedmnist_tpu_torch.serve --model mlp --checkpoint-dir <the
   fitted MLP's> --serve-infer-dtype int8 --serve-cache --gateway 2
   --port 0` (ServerProcess until gateway_ready; /healthz until both
   workers are live at int8): the gateway holds no CUDA context
   (nvidia-smi's compute-app pids where they are this PID namespace's,
   the processes' /dev/nvidia mappings, and its own
   torch.cuda.is_initialized() line at exit), 100 timed sequential 1-row
   calls, 256 sequential requests of 1-16 rows whose classes are those
   of an in-process int8 router on the card for the same rows (each
   request alone in its worker's batch; the HTTP answer carries classes,
   and int8's per-row products are exact, so this is the logits' argmax
   bit for bit), 64 requests over 8 hot keys each on one worker and
   counted as that worker's cache hits, a fresh version staged and
   promoted fleet-wide (cluster_epoch 1, mixed_epoch_rejected 0), a
   worker SIGKILLed under 32 clients (failovers rescued, the fleet
   answering, only backpressure 503s, retried), SIGTERM (rc 0, one
   gateway_summary, the surviving worker's quant_dense launched). The
   bench's `serve --gateway 2 --serve-infer-dtype megakernel` (the root
   bench's gateway keys, no build after warmup on any worker, every
   worker's mlp_megakernel launched, requests answered in both
   closed-loop windows). The static trace-replay phase's sustained rate
   measured closed-loop in this process, then the bench's
   `serve --trace-replay SPEC --autoscale` at float32 with SPEC peaking
   at twice that rate (schedule_sha256 that of the same spec and seed
   materialized here, no flap, nothing built after warmup, a grow and a
   shrink, dense_relu launched). Prints the gateway's 1-row p50/p99
   beside phase 8's direct server, scaling_efficiency and
   host_contention_x, and the replay's static and autoscaled
   slo_attainment and chip_seconds_per_m_requests, with the card.
15. The analysis tools: the port's concurrency sanitizer is
   installed before anything is built; a two-replica MLP fleet behind
   the prediction cache front and the batcher, the fitted weights live
   at float32, int8 and megakernel, serves 256 requests of 1-16 rows at
   each precision (one at a time, each alone in its batch), and a
   warmed engine on the 8/16 ladder serves 64 one-row requests through
   the fast lane's row-staged route (held bit for bit against its pooled
   dispatch); then wait_drained and assert_clean (no cycle, no blocking
   finding, no leaked thread, every balance 0), each burst launched its
   precision's kernel (the counts are set to 0 once every engine is
   built, gated and warm, and each burst's are taken as a difference),
   and the same requests on the same engines with nothing
   installed give the same logits bit for bit. One engine.fetch under a
   hot sanitized lock records exactly one `engine.fetch device->host
   sync` finding. analysis/torchcheck.py audits the MLP's served
   forwards on the card (TX001-TX004 clean, every fingerprint that of
   the committed CPU snapshot), and `python -m
   distributedmnist_tpu_torch.analysis.explore --smoke` exits 0. Prints
   an `analysis_phases` line: the sanitized and unsanitized rows/s of
   each burst, the explorer's wall time, the audited keys, the card.
16. The multichip dry run, the training fingerprints and the
   calibration, each on launch counts of its own:
   `dryrun.dryrun_multichip(2)` on the card (every leg, JAX's names, the
   2 ranks sharing the card over gloo; serve-reload's float32 MLP engines
   launch dense_relu after warmup, counted as differences over its
   served rounds, and dp:2proc's ranks report theirs);
   torchcheck's CLI, `main(["--device", "cuda", "--models", "lenet"])`
   in this process, returns 0 (LeNet-5's served forwards and both
   training steps on the card, each fingerprint the CPU snapshot's), and
   the training steps recorded again launch dense_relu; and
   the calibration at the set's own point (noise 0.44, jitter 3), both
   models at CALIBRATION_EPOCHS on 60,000 / 10,000 images, each accuracy
   in (0.1, 1]. Prints a `dryrun_phases` line: the legs and each leg's
   seconds, the audit, the calibration row, the launches.
17. Serving over a card group, as the JAX engine shards each batch over
   its 'data' mesh: a registry over the group [cuda:0, cuda:0] (two
   shards on the one card, the ladder 2..512) serves the MLP at float32,
   bfloat16, int8 and the megakernel and LeNet-5 at float32, bfloat16
   and int8, each variant through its gate: row counts from 1 to 512,
   the fast lane's row route and an exact fit, and a batcher burst, each
   against a one-card engine of the same weights (int8 bit for bit, the
   float precisions within a parity gate); every kernel launches, on
   counts of the group's calls only. With two or more cards visible,
   `serve --num-devices 2` answers /predict over HTTP and the bench's
   serve mode runs over every card (n_chips the card count); on one card
   a line says they are skipped. Prints a `card_group_phases` line.
18. Times a child's start by each route (the import probe): `python -c
   pass`, then a child importing torch and numpy started the old way
   (no bytecode cache) twice under `-X importtime`, once afresh on the
   cache, and three times forked.
19. Prints a `kernels` JSON line (launches on each path, the
   `bench_ranks` path among them, with the `fleet`, `cascade`, `tenancy`,
   `gateway`, `replay_autoscale`, `sanitized`, `dryrun`, `train_audit`,
   `calibration` and `card_group` paths also as columns of their own,
   error, times,
   bound; dense_relu's entry lists
   the new shapes, dense_relu's and quant_dense's LeNet's serving
   shapes; each entry's `fastlane` its b = 1 case and fast-route
   launches), a `phase_seconds` line (each phase's wall seconds), a
   `children` line (each phase's children by route: forked, an
   interpreter of its own on the bytecode cache or without it, or a tool
   such as nvidia-smi), an `import_seconds` line (step 18's figures) and,
   last, {"ok": true, "device": {...}}.

Children. Before anything touches CUDA the script makes a bytecode
cache (PYTHONPYCACHEPREFIX, under the git-ignored csrc/build/) and
starts a fork server: a process that imports torch and numpy once,
under the children's environment, and forks every Python child of the
script from there, so none pays a fresh interpreter's `import torch`.
Every child is still a process of its own with its own CUDA context.
The fork server itself, the import probe's children and the children
the port starts itself (a bench's supervised worker, parallel/launch.py's
ranks, the gateway's workers, the dry run's ranks) are interpreters of
their own on the cache. A cache that cannot be made, or a fork server
that is gone or refuses, fails the run with the reason.

Any failure raises and exits nonzero before the last line. Without a
card, or without the rest of the repository beside this file, it exits
nonzero and prints no result.
"""

from __future__ import annotations

import concurrent.futures
import itertools
import json
import os
import runpy
import select
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
import types
from typing import Optional

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float32": 67e12, "bfloat16": 989e12, "int8": 1979e12}
BUCKETS = (1, 7, 128, 512)
TIMED_ROWS = 512
SEED = 0
# the fitted weights' init seed: this recipe leaves every row of the
# held-out parity batch a top-2 logit margin of >= 4% of the logit scale
FIT_SEED = 1
TPU_KERNELS = {
    "dense_relu": "distributedmnist_tpu/ops/fused.py:50",
    "quant_dense": "distributedmnist_tpu/ops/fused.py:160",
    "mlp_megakernel": "distributedmnist_tpu/ops/fused.py:222",
}
# The multichip phase: the dry run's ranks, and the calibration's epochs
# at the set's own point (the JAX script's default depth)
DRYRUN_RANKS = 2
CALIBRATION_POINT = (0.44, 3)
CALIBRATION_EPOCHS = 6
# the serving path's kernels: the ported TPU kernels
SERVING_KERNELS = tuple(TPU_KERNELS)
# kernels that sum across CTAs in a fixed order (K split over a
# thread-block cluster; conv_wgrad_1ch's blocks' partial sums): held to
# give the same bits on two calls
SPLIT_K_KERNELS = ("dense_relu", "mlp_megakernel", "quant_dense",
                   "conv_wgrad_1ch")
# conv_wgrad_1ch's case: the rows of a benchmark training step on one card
CONV_WGRAD_ROWS = 4096
# The training phase: steps of each recipe, eval cadence, and the
# test-accuracy floor each must reach. The floors are below what the CPU
# runs of the same recipes reached (`python -m
# distributedmnist_tpu_torch.train --device cpu --synthetic --preset
# mlp-sgd --learning-rate 0.02 --steps 2000 --eval-every 500`: 0.9582 /
# 0.9663 / 0.9789 / 0.9732 at the four evals; `--preset lenet-adam
# --eval-every 1000 --seed 709 --target-accuracy 1.0`, its 10 epochs:
# 0.9917 / 0.9965 / 0.9980 / 0.9957 / 0.9966), by the margin a
# trajectory summed in another order may drift.
# config 2 runs its published 10 epochs (60,000 / 128 = 468 steps each)
TRAIN_STEPS = {"mlp-sgd": 2000, "lenet-adam": 4680}
EVAL_EVERY = 500
ACCURACY_FLOOR = {"mlp-sgd": 0.95, "lenet-adam": 0.98}
# Config 2 trains on the parity batch's synthetic distribution (seed 709,
# data and init) for its full 10 epochs, with cuDNN's deterministic
# algorithms, and its checkpoint is what LeNet serving boots from. Cut
# short, a trained LeNet keeps a near-tie row on the parity batch (an
# ambiguous image whose top-2 margin is about the int8 variant's logit
# error), and the int8 gate refuses it: 2 of 7 checkpoints of 1000 steps
# through the CLIs on the card. Determinism makes the checkpoint, and
# the gates' verdict on it, the same in every run on the same card and
# software.
# Synthetic templates are drawn per seed: a LeNet trained on seed 0's
# templates has near-tie logits on the held-out parity batch (seed 709's),
# where rounding flips argmaxes and the gates rightly refuse a variant
# (config 2 on seed 0 through the CLIs on the CPU, `train --preset
# lenet-adam --synthetic --steps 1000` then `serve --model lenet
# --serve-infer-dtype int8`: int8 refused at argmax agreement 0.9922).
LENET_SEED = 709
LENET_CHECKPOINT_EVERY = 1000
# steps the trainer adds to config 2's run while LeNet is served: the
# later checkpoint the registry loads, promotes and rolls back from
LIFECYCLE_STEPS = 200
SELFTEST_REQUESTS = 256
# The serving phases' backpressure watermark in pending rows: a selftest
# burst of 256 requests of up to 31 rows (at most 7936 rows) fits under
# it, so no request is refused at the door and the burst measures the
# serving path. The default, 4096, refuses a few whenever a burst is
# submitted faster than it is served.
SELFTEST_QUEUE_DEPTH = 8192
# the LeNet float32 engine on the card against the CPU's, times the
# logits' scale: cuDNN sums in other orders, TF32 off (TF32 would be
# about 1e-3)
LENET_F32_TOL = 1e-4
# Config 1 runs at lr 0.02, not its preset's 0.1: at 0.1 with momentum
# 0.9 the MLP all but dies on synthetic MNIST in both packages (its CPU
# run read 0.1012 at step 500 and 0.2661 at step 2000; the JAX package's
# train.py read 0.0933 at step 300, the port 0.0933 too), so no accuracy
# floor could hold it. The step's work, and so its time, does not depend
# on the rate.
MLP_LR = 0.02
# The data-parallel phase. Config 3 at full width runs at MLP_LR too, its
# floor below what the CPU run of the same command reached
# (`python -m distributedmnist_tpu_torch.train --preset mlp-dp2
# --synthetic --learning-rate 0.02 --steps 1000 --device cpu`: 0.9679 /
# 0.9763 / 0.9823 / 0.9799 / 0.9818 at its five evals)
# by the margin a trajectory summed in another order may drift. Its
# trajectory legs: 2 ranks in auto against explicit (the same sums, one
# by DDP, one by hand: 1e-6), and 2 ranks against 1 at the same global
# batch from the same init (other matmul shapes: losses rtol 1e-4, params
# atol 1e-4, the tolerance of the kernel-against-plain comparison).
DP_STEPS = 1000
DP_ACCURACY_FLOOR = 0.97
TRAJ_STEPS = 20
TRAJ_TOL = {"modes": dict(rtol=1e-6, atol=1e-6),
            "ranks": dict(loss_rtol=1e-4, param_atol=1e-4)}
NCCL_STEPS = 200
DP_TIMEOUT_S = 300
# the kernel-against-plain comparison on the training path
COMPARE_STEPS = 50
COMPARE_TOL = dict(loss_rtol=1e-4, param_atol=1e-4)
# The bench phase: each run's arguments, with windows cut short (the
# default windows take minutes on the card) and serve phases of 0.3 s
# (most of a run's time is its process boot); the supervised worker (the
# bench's default) runs the first, the rest run --inline. The training modes ask for one
# rank (--num-devices 1): on a host with more cards the bench would
# otherwise start a rank a card.
# The serve runs of LeNet-5 boot from a copy of config 2's last
# checkpoint, the one whose gates the LeNet serving phase held.
# The rest-of-training phase. Tensor parallelism: model_parallel 2 as 2
# ranks sharing the card over gloo, on mh_smoke's data, against 1 rank at
# the same global batch (losses rtol 1e-4, as the data-parallel ranks are
# held: other product shapes and sums), and the train CLI's step time at
# full width beside 1 rank's. The MLP runs 200 steps; LeNet-5 runs 20:
# over 200 Adam steps its 2 ranks and 1 rank part by 2e-3 on the CPU
# already (Adam divides by the RMS of the gradient, so rounding residues
# grow), while 20 steps agree within 1e-6 there. bfloat16: configs 1
# and 2 for REST_STEPS each, beside the same runs in float32, held to
# floors under what the first card run reached. The streaming pipeline:
# config 2 under cuDNN's deterministic algorithms, its losses the device
# pipeline's within 1e-6. Layouts of the kernel cases: (world,
# model_parallel).
TP_STEPS = {"mlp": 200, "lenet": 20}
TP_TOL = 1e-4
TP_CLI_STEPS = 200
TP_LAYOUTS = ((2, 2), (4, 2), (4, 4))
REST_STEPS = 1000
# measured on an H100 (PERF.md §6): 0.9729 and 0.9910 in bf16, 0.9713 and
# 0.9902 in f32, after 1000 steps
BF16_ACCURACY_FLOOR = {"mlp-sgd": 0.96, "lenet-adam": 0.98}
STREAM_TOL = 1e-6
BENCH_RUNS = (
    ("throughput", "--model", "mlp", "--global-batch", "64",
     "--steps-per-call", "128", "--warmup-steps", "128", "--bench-steps",
     "256", "--repeats", "2", "--num-devices", "1"),
    ("throughput", "--model", "lenet", "--global-batch", "512",
     "--steps-per-call", "128", "--warmup-steps", "128", "--bench-steps",
     "128", "--repeats", "2", "--num-devices", "1", "--inline"),
    ("time-to-accuracy", "--model", "lenet", "--global-batch", "512",
     "--trials", "1", "--target-accuracy", "0.99", "--num-devices",
     "1", "--inline"),
    ("serve", "--model", "mlp", "--serve-duration", "0.3", "--no-artifact",
     "--inline"),
    ("serve", "--model", "lenet", "--serve-infer-dtype", "bfloat16",
     "--serve-duration", "0.3", "--checkpoint-dir", "{ckpt}",
     "--no-artifact", "--inline"),
    ("serve", "--model", "lenet", "--serve-infer-dtype", "int8",
     "--serve-duration", "0.3", "--checkpoint-dir", "{ckpt}",
     "--no-artifact", "--inline"),
    ("sweep", "--model", "lenet", "--sweep-batches", "64,512",
     "--steps-per-call", "128", "--warmup-steps", "128", "--bench-steps",
     "128", "--repeats", "1", "--num-devices", "1", "--inline"),
    ("smoke", "--model", "mlp", "--dtype", "bfloat16", "--num-devices", "1",
     "--inline"),
)
BENCH_TIMEOUT_S = 300
# The bench over ranks: two training modes with --num-devices 2, a
# process a rank (on one card the two share it over gloo and count as
# one chip; on a host with two or more cards, a card a rank over NCCL),
# both runs at once. The MLP's global batch of 128 gives each rank the
# 64-row step phase 2 holds dense_relu at.
BENCH_RANK_RUNS = (
    ("throughput", "--model", "mlp", "--global-batch", "128",
     "--steps-per-call", "64", "--warmup-steps", "64", "--bench-steps",
     "128", "--repeats", "1", "--num-devices", "2", "--inline"),
    ("time-to-accuracy", "--model", "lenet", "--global-batch", "512",
     "--trials", "1", "--target-accuracy", "0.99", "--num-devices", "2",
     "--inline"),
)
BENCH_RANKS = 2
# The HTTP phase: sequential 1-row /predict calls timed per server, the
# rows of the large /predict held against the CPU's float32 model, and
# how long a server may take to turn /healthz 200 or to roll a SIGHUP.
HTTP_TIMED_CALLS = 100
HTTP_CHECK_ROWS = 512
HTTP_READY_S = 300
# The request-path phase: the fast lane's engines' ladder (its smallest
# rung 1, the exact-fit route), the 1-row requests each engine serves
# through it, the b = 1 staging comparison's calls per route, and the
# record keys of the bench's request legs (the root bench's code; its
# older committed records predate some of them)
REQUEST_MAX_BATCH = 16
FASTLANE_ROWS = 16
FASTLANE_TIMED = 100
REQUEST_LEG_KEYS = {
    "lowlat": {
        "attribution", "batched", "clients", "coalesce_wait_us",
        "duration_s", "fastlane", "fastpath_dispatches",
        "fastpath_lane_fraction", "megakernel", "megakernel_parity",
        "p50_batched_ms", "p50_best_ms", "p50_fastlane_ms",
        "p50_improvement_x", "p50_ok", "p99_ok", "recompiles",
        "recompiles_ok", "rows_per_request",
        "variant_warmup_compile_events"},
    "zipf": {
        "cache_capacity", "cache_enabled", "cache_off", "cache_on",
        "clients", "device_dispatch_lower", "device_dispatches_off",
        "device_dispatches_on", "device_dispatches_per_request_off",
        "device_dispatches_per_request_on", "distinct_keys", "duration_s",
        "goodput_ok", "goodput_x", "hit_ratio", "hit_ratio_ok",
        "max_rows_per_request", "p99_off_ms", "p99_on_ms", "parity_ok",
        "parity_probes", "seed", "single_flight_collapsed", "zipf_s"},
    "chaos": {
        "arrivals_seed", "availability_excluding_injected",
        "availability_ok", "bisect_rescued_requests", "bisect_splits",
        "breaker_trips", "coalesce_wait_us", "deadline_shed",
        "deadline_shed_metric", "duration_s", "failovers",
        "fallback_warmup_compile_events", "hedges",
        "injected_dispatch_faults", "injected_fetch_faults",
        "injected_replica_faults_surfaced", "injector_seed",
        "live_version_after", "ok", "other_failures",
        "p99_under_faults_ms", "poison_isolated_exact", "poison_unique",
        "qps", "recompiles_during_chaos", "rejected", "requests",
        "rollback_engaged", "rollback_events", "rollbacks", "spec"},
    "trace": {
        "attribution", "attribution_basis", "attribution_checked",
        "attribution_ok", "chaos", "coalesce_wait_us",
        "min_attributed_frac", "open_spans_at_drain", "over_slo_requests",
        "qps", "requests_traced", "sample", "slo_ms", "span_census",
        "traces_retained"},
}
# The fleet-and-cascade phase: a two-replica MLP fleet in process (the
# rows of each mixed-size request, up to 32, and the requests of each
# burst), the root bench's dispatch-balance bar, a replica-kill burst on
# r1 that failover must absorb, a latency fault on r0 that the hedge must
# race, and the bench's fleet and frontier runs (the LeNet run boots from
# config 2's last checkpoint).
FLEET_MAX_BATCH = 64
FLEET_MAX_ROWS = 32
FLEET_REQUESTS = 256
FLEET_FAULT_REQUESTS = 128
FLEET_BALANCE_BAR = 1.25
FLEET_SLOW_MS = 20
FLEET_BENCH_RUNS = (
    ("serve", "--model", "mlp", "--serve-duration", "0.5",
     "--serve-replicas", "2", "--serve-hedge", "--chaos", "--inline",
     "--no-artifact"),
    ("serve", "--model", "lenet", "--serve-duration", "0.5",
     "--dtype-sweep", "--cascade", "--checkpoint-dir", "{ckpt}",
     "--inline", "--no-artifact"),
)
CASCADE_ROWS = 512
# the root bench's r07 record's `replicas` keys and r10's `cascade` keys
FLEET_RECORD_KEYS = {
    "replicas": {"count", "disjoint_devices", "final", "fleet_leg",
                 "per_replica_chips", "per_replica_inflight",
                 "provenance"},
    "fleet_leg": {"balance_ok", "dispatch_balance_ratio",
                  "fleet_latency_ms", "fleet_rows_per_sec",
                  "per_replica_dispatches", "replicas",
                  "scaling_efficiency", "single_latency_ms",
                  "single_replica_rows_per_sec"},
    "cascade": {"agreement_ok", "agreement_rows", "agreement_vs_f32",
                "calibration", "cascade_efficiency_vs_fast", "cheap_dtype",
                "clients", "coalesce_wait_us", "duration_s",
                "efficiency_ok", "final_threshold", "goodput_bar",
                "goodput_bar_reachable", "goodput_ok", "goodput_vs_f32",
                "host_compute_ceiling", "host_full_bucket_cost_ms", "legs",
                "seed", "sizes", "stressed_threshold",
                "variant_warmup_compile_events"},
    "dtype_sweep": {"best_dtype", "best_speedup", "clients",
                    "coalesce_wait_us", "duration_s", "legs", "seed",
                    "sizes", "speedup_vs_float32",
                    "variant_warmup_compile_events"},
}
# The root bench's record keys (its THROUGHPUT_r05.json, TTA_r05.json,
# BENCH_serve_r13.json, BENCH_serve_r12.json (the gateway's),
# SWEEP_r05.json and SMOKE_r05.json records; the smoke metric is named
# "smoke")
BENCH_KEYS = {
    "predicted_8chip_images_per_sec_per_chip": {
        "model", "backend", "dtype", "n_chips_measured", "curve_img_s_chip",
        "n_params", "grad_bytes_f32", "ici_assumed_gbps", "allreduce_ms_est",
        "allreduce_modeled", "strong_scaling", "weak_scaling",
        "weak_scaling_at_largest", "prediction_range"},
    "smoke": {
        "backend", "n_chips", "model", "data", "legs", "final_accuracy",
        "images_per_sec_per_chip", "short_window", "window_steps"},
    "train_images_per_sec_per_chip": {
        "model", "data", "global_batch", "n_chips", "backend", "dtype",
        "bench_steps", "steps_per_call", "step_ms", "windows_img_s_chip"},
    "wall_clock_to_target_accuracy": {
        "reached_target", "target_accuracy", "trials", "trials_s",
        "steps_to_target_median", "steps_to_target", "evals_to_target",
        "wall_s_is_weather_dependent", "trial_results", "min_s", "max_s",
        "final_accuracy", "steps", "data", "model", "global_batch",
        "n_chips", "backend", "dtype"},
    "serve_images_per_sec_per_chip": {
        "model", "dtype", "backend", "n_chips", "host", "compile_surface",
        "buckets", "max_batch", "max_wait_us", "queue_depth", "max_inflight",
        "rows_per_request", "clients", "duration_s", "params",
        "live_version_final", "warmup_compile_events",
        "recompiles_after_warmup", "bucket_cost_ms", "slo_ms", "adaptive",
        "closed_loop", "qps_sweep", "ragged", "inflight_comparison",
        "zipf", "lowlat", "chaos", "trace", "dtype_sweep", "cascade",
        "replicas", "swap", "multimodel", "trace_replay"},
    "gateway_images_per_sec": {
        "model", "dtype", "backend", "n_chips", "host", "rows_per_request",
        "clients", "duration_s", "closed_loop", "recompiles_after_warmup",
        "gateway"},
}
# The gateway phase: the front door over 2 worker processes on the card
# (the fitted MLP at int8 with the prediction cache), the requests of
# 1-16 rows held against an in-process int8 router, the hot keys and
# their repeats, the clients hammering through a worker's SIGKILL and
# how long they run after it; the bench's gateway run; and the trace
# replay: the static phase's rows a request and bucket ceiling, the
# closed-loop measurement of its sustained rate, the peak the trace is
# built at (that rate times PEAK_OVER_STATIC) and the bench run around it.
GATEWAY_RECORD_KEYS = {
    "closed_loop_1worker", "contention_probe", "final_metrics",
    "host_contention_x", "img_s_1", "img_s_n", "open_loop",
    "per_worker_recompiles", "promote", "scaling_bar_reachable",
    "scaling_efficiency", "worker_ports", "workers", "zipf"}
GATEWAY_REQUESTS = 256
GATEWAY_MAX_ROWS = 16
GATEWAY_HOT_KEYS = 8
GATEWAY_HOT_REQUESTS = 64
GATEWAY_KILL_CLIENTS = 32
GATEWAY_KILL_AFTER = 100
GATEWAY_AFTER_KILL_S = 1.0
GATEWAY_BENCH_RUN = ("serve", "--model", "mlp", "--gateway", "2",
                     "--serve-infer-dtype", "megakernel",
                     "--serve-duration", "1.5", "--serve-clients", "8",
                     "--inline", "--no-artifact")
REPLAY_ROWS = 4
REPLAY_MAX_BATCH = 32
REPLAY_RATE_CLIENTS = 8
REPLAY_RATE_S = 1.0
PEAK_OVER_STATIC = 2.0
REPLAY_BURST = 8
# The tenancy phase: the in-process catalog's tenants (the root bench's
# multimodel leg's classes), its geometry and traffic, the HTTP server's
# classes (a free tenant whose two tokens refill in 20 s apiece), and
# the bench's runs. The bench writes its records into a temporary
# directory; every other serve run here passes --no-artifact.
TENANCY_TENANTS = ("light:weight=2,deadline_ms=5000,model=mlp;"
                   "heavy:weight=1,model=lenet")
TENANCY_HTTP_TENANTS = ("gold:qps=1000,burst=64,model=mlp;"
                        "free:qps=0.05,burst=2,model=lenet")
TENANCY_MAX_BATCH = 64
TENANCY_MAX_ROWS = 16
TENANCY_REQUESTS = 256
TENANCY_BENCH_RUN = ("serve", "--model", "mlp", "--serve-duration", "0.5",
                     "--multimodel", "--swap-during-load", "--inline")
# the root bench's r11 record's `multimodel` keys and r02's `swap` keys
# phase 17: serving over a card group, two shards sharing the one card
GROUP_MAX_BATCH = 512
GROUP_ROWS = (1, 2, 3, 7, 64, 127, 128, 255, 256, 511, 512)
GROUP_BURST = 64              # batcher requests of 1-8 rows a precision
GROUP_HTTP_ROWS = 64
GROUP_BENCH_RUN = ("serve", "--model", "mlp", "--serve-duration", "0.5",
                   "--serve-qps", "100", "--serve-clients", "4",
                   "--serve-max-batch", "64", "--no-artifact")
TENANCY_RECORD_KEYS = {
    "multimodel": {"duration_s_per_phase", "fairness", "fairness_model",
                   "fairness_ok", "heavy_mixed_p99_ms", "host_contention_x",
                   "light_mixed_p99_ms", "light_p99_bar",
                   "light_p99_bar_reachable", "light_p99_degradation_x",
                   "light_p99_ok", "light_solo_p99_ms", "max_skip_observed",
                   "models", "recompiles_after_warmup", "rows_per_request",
                   "slo_attainment", "warmup_compile_events", "weights"},
    "swap": {"load_warm_s", "p99_ratio_vs_steady", "post_swap_p99_ms",
             "post_swap_p99_ratio_vs_steady", "recompiles_after_swap",
             "steady_p99_ms", "swap_window", "swap_window_p99_ms",
             "version", "warmup_compile_events", "window_s"},
}


def cuda_ms(fn, iters: int = 200, warmup: int = 20) -> float:
    """Mean milliseconds per call of fn over `iters` back-to-back calls,
    by CUDA events, after `warmup` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, calls: int = 20, replays: int = 10) -> float:
    """Device milliseconds per call of fn: `calls` calls captured in one
    CUDA graph, replayed `replays` times between CUDA events, so the
    host's per-call launch cost (Python, ctypes) is not in the time."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (replays * calls)


def bound_ms(nbytes: float, ops: float, kind: str) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[kind]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def fit_params(seed: int) -> dict:
    """MLP weights with real margins, made from a seed on the CPU (so they
    are the same values the CPU tests use): fresh init, then 1000 SGD steps
    on the train split of the parity batch's synthetic distribution.
    Fresh-init weights have near-tie logits that int8/bf16 rounding
    flips, which the parity gate rightly refuses."""
    import torch
    import torch.nn.functional as F

    from distributedmnist_tpu_torch import models
    from distributedmnist_tpu_torch.data import synthetic_mnist
    from distributedmnist_tpu_torch.serve.quantize import PARITY_SEED

    data = synthetic_mnist(seed=PARITY_SEED, train_n=8192, test_n=16)
    net = models.build("mlp", device="cpu")
    net.load_state_dict(models.init_params("mlp", seed))
    opt = torch.optim.SGD(net.parameters(), lr=0.05, momentum=0.9)
    x = torch.from_numpy(data["train_x"])
    y = torch.from_numpy(data["train_y"]).long()
    g = torch.Generator().manual_seed(seed)
    for _ in range(1000):
        idx = torch.randint(0, x.shape[0], (128,), generator=g)
        loss = F.cross_entropy(net(x[idx].float() / 255.0), y[idx])
        opt.zero_grad()
        loss.backward()
        opt.step()
    return {k: v.detach().clone() for k, v in net.state_dict().items()}


def kernel_cases(params: dict, images):
    """(kernel, case, dtype, kernel_fn, plain_fn, library_fn, bytes, ops,
    tolerance) at each checked batch size, on the inputs the serving path
    gives each kernel: the float32 engine's hidden layer, the variants'
    prepared weights (serve/quantize.py) and their activations. Each
    function binds its batch's input as a default argument, so a case
    holds whenever it is called."""
    import torch

    from distributedmnist_tpu_torch.ops import fused
    from distributedmnist_tpu_torch.serve.quantize import (
        center_pixels, prepare_inference, quantize_act_static)

    dev = torch.device("cuda")
    p = {k: v.to(dev) for k, v in params.items()}
    bf16 = {k: v.to(dev) for k, v in
            prepare_inference("mlp", params, "bfloat16")[0].items()}
    q8 = {k: v.to(dev) for k, v in
          prepare_inference("mlp", params, "int8")[0].items()}
    mega = {k: v.to(dev) for k, v in
            prepare_inference("mlp", params, "megakernel")[0].items()}
    k, h, c = 784, 128, 10
    for m in BUCKETS:
        u8 = torch.from_numpy(images[:m].reshape(m, k)).to(dev)
        x32 = u8.float() / 255.0
        xbf = u8.to(torch.bfloat16)
        xq = center_pixels(u8)
        hq = quantize_act_static(
            fused.quant_dense_reference(xq, q8["w1q"], q8["s1"], q8["b1"]),
            q8["act_scale"])
        xraw = u8.float()
        int_mm_ok = m > 16          # torch._int_mm's own shape rule
        yield ("dense_relu", f"f32 b={m}", "float32",
               lambda x=x32: fused.dense_relu_inference(
                   x, p["hidden_kernel"], p["hidden_bias"]),
               lambda x=x32: fused.dense_relu_reference(
                   x, p["hidden_kernel"], p["hidden_bias"]),
               lambda x=x32: torch.relu(torch.addmm(
                   p["hidden_bias"], x, p["hidden_kernel"])),
               4 * (m * k + k * h + h + m * h), 2 * m * k * h + 2 * m * h,
               dict(rtol=1e-5, atol=1e-5))
        yield ("dense_relu", f"bf16 b={m}", "bfloat16",
               lambda x=xbf: fused.dense_relu_inference(x, bf16["w1"],
                                                        bf16["b1"]),
               lambda x=xbf: fused.dense_relu_reference(x, bf16["w1"],
                                                        bf16["b1"]),
               lambda x=xbf: torch.relu(torch.addmm(bf16["b1"], x,
                                                    bf16["w1"])),
               2 * (m * k + k * h + h + m * h), 2 * m * k * h + 2 * m * h,
               # one bf16 rounding step of the output (2**-8 relative)
               dict(rtol=1e-2, atol=1e-2))
        yield ("quant_dense", f"layer1 b={m}", "int8",
               lambda x=xq: fused.quant_dense(x, q8["w1q"], q8["s1"],
                                              q8["b1"]),
               lambda x=xq: fused.quant_dense_reference(x, q8["w1q"],
                                                        q8["s1"], q8["b1"]),
               (lambda x=xq: torch.relu(torch._int_mm(x, q8["w1q"]).float()
                                        * q8["s1"] + q8["b1"]))
               if int_mm_ok else None,
               m * k + k * h + 8 * h + 4 * m * h, 2 * m * k * h + 3 * m * h,
               # exact int32 products, identically rounded epilogue
               dict(rtol=1e-6, atol=0.0))
        yield ("quant_dense", f"layer2 b={m}", "int8",
               lambda x=hq: fused.quant_dense(x, q8["w2q"], q8["s2"],
                                              q8["b2"], relu=False),
               lambda x=hq: fused.quant_dense_reference(
                   x, q8["w2q"], q8["s2"], q8["b2"], relu=False),
               None,        # torch._int_mm needs n % 8 == 0; n is 10
               m * h + h * c + 8 * c + 4 * m * c, 2 * m * h * c + 2 * m * c,
               dict(rtol=1e-6, atol=0.0))
        yield ("mlp_megakernel", f"f32 b={m}", "float32",
               lambda x=xraw: fused.mlp_megakernel(
                   x, mega["w1"], mega["b1"], mega["w2"], mega["b2"]),
               lambda x=xraw: fused.mlp_megakernel_reference(
                   x, mega["w1"], mega["b1"], mega["w2"], mega["b2"]),
               lambda x=xraw: torch.addmm(mega["b2"], torch.relu(torch.addmm(
                   mega["b1"], x, mega["w1"])), mega["w2"]),
               4 * (m * k + k * h + h + h * c + c + m * c),
               2 * m * k * h + 2 * m * h * c + 3 * m * h + m * c,
               dict(rtol=1e-5, atol=1e-5))


def lenet_kernel_cases(params: dict, images):
    """The kernel cases of LeNet's serving path, the same tuple as
    kernel_cases: dense_relu bf16 at fc1 and fc2 and quant_dense at fc1,
    fc2 and logits, each on the activations the variant's own forward
    feeds it (serve/quantize.py) from `params` and uint8 `images`."""
    import torch

    from distributedmnist_tpu_torch.ops import fused
    from distributedmnist_tpu_torch.serve.quantize import (
        lenet_trunk, prepare_inference, quantize_act_static)

    dev = torch.device("cuda")
    bf16 = {k: v.to(dev) for k, v in
            prepare_inference("lenet", params, "bfloat16")[0].items()}
    q8 = {k: v.to(dev) for k, v in
          prepare_inference("lenet", params, "int8")[0].items()}
    bf16_tol = dict(rtol=1e-2, atol=1e-2)   # one bf16 rounding, 2**-8
    exact = dict(rtol=0.0, atol=0.0)        # exact int32, same epilogue
    for m in BUCKETS:
        u8 = torch.from_numpy(images[:m]).to(dev)
        with torch.no_grad():
            xb = lenet_trunk(bf16, u8.to(torch.bfloat16))
            xf = lenet_trunk(q8, u8.float())
        h = xb
        for n, (k, c) in (("fc1", (400, 120)), ("fc2", (120, 84))):
            w, b = bf16[f"{n}.kernel"], bf16[f"{n}.bias"]
            yield ("dense_relu", f"lenet {n} bf16 {k}->{c} b={m}",
                   "bfloat16",
                   lambda x=h, w=w, b=b: fused.dense_relu_inference(x, w, b),
                   lambda x=h, w=w, b=b: fused.dense_relu_reference(x, w, b),
                   lambda x=h, w=w, b=b: torch.relu(torch.addmm(b, x, w)),
                   2 * (m * k + k * c + c + m * c), 2 * m * k * c + 2 * m * c,
                   bf16_tol)
            h = fused.dense_relu_reference(h, w, b)
        h = xf
        for n, (k, c) in (("fc1", (400, 120)), ("fc2", (120, 84)),
                          ("logits", (84, 10))):
            relu = n != "logits"
            xq = quantize_act_static(h, q8[f"{n}.act_scale"])
            w, s, b = q8[f"{n}.q"], q8[f"{n}.scale"], q8[f"{n}.bias"]
            # torch._int_mm needs m > 16 and n % 8 == 0: fc1 only
            library = ((lambda x=xq, w=w, s=s, b=b: torch.relu(
                torch._int_mm(x, w).float() * s + b))
                if m > 16 and c % 8 == 0 else None)
            yield ("quant_dense", f"lenet {n} {k}->{c} b={m}", "int8",
                   lambda x=xq, w=w, s=s, b=b, r=relu: fused.quant_dense(
                       x, w, s, b, relu=r),
                   lambda x=xq, w=w, s=s, b=b, r=relu:
                   fused.quant_dense_reference(x, w, s, b, relu=r),
                   library,
                   m * k + k * c + 8 * c + 4 * m * c,
                   2 * m * k * c + (3 if relu else 2) * m * c, exact)
            h = fused.quant_dense_reference(xq, w, s, b, relu=relu)


def dp_dense_relu_rows() -> list[tuple[str, int]]:
    """The rows of each dense_relu launch on the data-parallel path, as
    the trainer splits them: a rank's share of a step's global batch and
    of an eval batch (min(2048, test images), rounded up to the world),
    for each MLP run of drive_dp_path: config 3 at full size on 2 ranks,
    and the trajectory's 2 ranks and 1 rank on mh_smoke's data."""
    from distributedmnist_tpu_torch.config import PRESETS
    from distributedmnist_tpu_torch.parallel import mh_smoke
    from distributedmnist_tpu_torch.utils import round_up

    batch = PRESETS["mlp-dp2"].batch_size
    smoke_n = mh_smoke.SMOKE_DATA["test_n"]
    rows = set()
    for world, test_n in ((2, 10_000), (2, smoke_n), (1, smoke_n)):
        rows.add(("train", batch // world))
        rows.add(("eval", round_up(min(2048, test_n), world) // world))
    return sorted(rows, key=lambda r: (r[1], r[0]))


def training_cases(data):
    """dense_relu f32 at the training paths' shapes, on their inputs:
    the fresh MLP of the training run, a step's decoded batch (64 rows)
    and an eval batch (2048 rows) on one card, and each rank's share of
    a step and of an eval batch under data parallelism
    (dp_dense_relu_rows); the same tuple as kernel_cases."""
    import torch

    from distributedmnist_tpu_torch import models
    from distributedmnist_tpu_torch.data.packing import normalize
    from distributedmnist_tpu_torch.ops import fused

    dev = torch.device("cuda")
    p = {k: v.to(dev) for k, v in models.init_params("mlp", SEED).items()}
    k, h = 784, 128
    shapes = [("train", 64), ("eval", 2048)] + [
        (f"dp {kind}", m) for kind, m in dp_dense_relu_rows()]
    for kind, m in shapes:
        pixels = data["test_x" if kind.endswith("eval") else "train_x"][:m]
        x32 = normalize(torch.from_numpy(pixels.reshape(m, k)).to(dev))
        yield ("dense_relu", f"f32 {kind} b={m}", "float32",
               lambda x=x32: fused.dense_relu_inference(
                   x, p["hidden_kernel"], p["hidden_bias"]),
               lambda x=x32: fused.dense_relu_reference(
                   x, p["hidden_kernel"], p["hidden_bias"]),
               lambda x=x32: torch.relu(torch.addmm(
                   p["hidden_bias"], x, p["hidden_kernel"])),
               4 * (m * k + k * h + h + m * h), 2 * m * k * h + 2 * m * h,
               dict(rtol=1e-5, atol=1e-5))


def conv_wgrad_cases(data):
    """conv_wgrad_1ch at LeNet's conv1 on CONV_WGRAD_ROWS training images
    and a seeded normal output gradient, beside its plain version (the
    op autograd runs for F.conv2d, on the card cuDNN's) and, as a
    yardstick, cuDNN's weight gradient alone
    (torch.nn.grad.conv2d_weight); the same tuple as kernel_cases. Run it
    under training_numerics(), as training does: cuDNN's deterministic
    algorithms, TF32 off."""
    import numpy as np
    import torch

    from distributedmnist_tpu_torch.data.packing import normalize
    from distributedmnist_tpu_torch.ops import fused

    dev = torch.device("cuda")
    m = CONV_WGRAD_ROWS
    h, w, _ = fused.CONV_WGRAD_IMAGE
    kh, kw, _, f = fused.CONV_WGRAD_KERNEL
    x = normalize(torch.from_numpy(
        data["train_x"][:m].reshape(m, h, w, 1)).to(dev))
    g = torch.from_numpy(np.random.default_rng(SEED).normal(
        size=(m, h, w, f)).astype(np.float32)).to(dev)
    k = torch.zeros(fused.CONV_WGRAD_KERNEL, device=dev)
    yield ("conv_wgrad_1ch", f"conv1 b={m}", "float32",
           lambda: fused.conv_wgrad_1ch(x, g, k),
           lambda: fused.conv_wgrad_1ch_reference(x, g, k),
           lambda: torch.nn.grad.conv2d_weight(
               x.permute(0, 3, 1, 2), (f, 1, kh, kw), g.permute(0, 3, 1, 2),
               padding=kh // 2),
           4 * (m * h * w * (1 + f) + kh * kw * f + f),
           2 * m * h * w * kh * kw * f,
           # f32 sums of 3.2 M terms in another order
           dict(rtol=1e-5, atol=1e-5))


def check_kernels(cases) -> list:
    """Compare and time every kernel case; return one record per case."""
    import torch

    def flat(out):   # conv_wgrad_1ch gives (dW, db)
        return (torch.cat([t.reshape(-1) for t in out])
                if isinstance(out, tuple) else out)

    records = []
    for (name, case, kind, kernel, plain, library, nbytes, ops,
         tol) in cases:
        got, want = flat(kernel()), flat(plain())
        torch.cuda.synchronize()
        if name in SPLIT_K_KERNELS and not torch.equal(got, flat(kernel())):
            raise RuntimeError(f"{name} {case}: two calls on the same "
                               f"inputs differ (the reduction across "
                               f"CTAs must sum in a fixed order)")
        err = float((got.float() - want.float()).abs().max())
        # f32 sums of 784 terms in another order: the error scales with
        # the output's magnitude, so atol is relative to it
        scale = max(1.0, float(want.float().abs().max()))
        torch.testing.assert_close(got.float(), want.float(),
                                   rtol=tol["rtol"],
                                   atol=tol["atol"] * scale,
                                   msg=lambda m: f"{name} {case}: {m}")
        b_ms, b_by = bound_ms(nbytes, ops, kind)
        rec = {"name": name, "case": case, "max_abs_err": err,
               "ms": graph_ms(kernel), "plain_ms": graph_ms(plain),
               "library_ms": (graph_ms(library) if library is not None
                              else None),
               "bound_ms": b_ms, "bound_by": b_by,
               "call_ms": cuda_ms(kernel), "plain_call_ms": cuda_ms(plain),
               "library_call_ms": (cuda_ms(library) if library is not None
                                   else None)}
        records.append(rec)
        print("kernel " + json.dumps(rec), flush=True)
        print(f"  {name} {case}: {rec['ms'] * 1e3:.2f} us on the card, "
              f"{rec['call_ms'] * 1e3:.2f} us a call, bound "
              f"{b_ms * 1e3:.4g} us ({b_by})", flush=True)
    return records


def time_forwards(model: str, params: dict, images, variants) -> None:
    """Print the device time and time per call of each of `model`'s
    serving variants' whole forward (uint8 pixels on the card -> float32
    logits), per bucket."""
    import torch

    from distributedmnist_tpu_torch import models
    from distributedmnist_tpu_torch.serve.quantize import prepare_inference

    dev = torch.device("cuda")
    forwards = {}
    for dt in variants:
        if dt == "float32":
            net = models.build(model, device=dev)
            net.load_state_dict({k: v.to(dev) for k, v in params.items()})
            net.eval()
            forwards[dt] = lambda x, net=net: net(x.to(torch.float32) / 255.0)
        else:
            prep, fwd = prepare_inference(model, params, dt)
            prep = {k: v.to(dev) for k, v in prep.items()}
            forwards[dt] = lambda x, prep=prep, fwd=fwd: fwd(prep, x)
    with torch.inference_mode():
        for m in BUCKETS:
            x = torch.from_numpy(images[:m].reshape(m, 28, 28, 1)).to(dev)
            for dt, fwd in forwards.items():
                print("forward " + json.dumps({
                    "model": model, "variant": dt, "b": m,
                    "ms": graph_ms(lambda: fwd(x)),
                    "call_ms": cuda_ms(lambda: fwd(x))}), flush=True)


def compare_training_step(data) -> dict:
    """COMPARE_STEPS steps of config 1's recipe on the card through the
    trainer's step (the dense_relu kernel forward, its plain-matmul
    backward), then the same steps on the same batches through a step
    whose hidden layer is dense_relu's plain version; the per-step loss
    and the final params must agree at COMPARE_TOL."""
    import torch

    from distributedmnist_tpu_torch import models, optim, trainer
    from distributedmnist_tpu_torch.config import PRESETS
    from distributedmnist_tpu_torch.data import DeviceDataset, IndexStream
    from distributedmnist_tpu_torch.models.mlp import MLP
    from distributedmnist_tpu_torch.ops import fused
    from distributedmnist_tpu_torch.utils.device import training_numerics

    class PlainMLP(MLP):
        def forward(self, x):
            x = x.reshape(x.shape[0], -1).to(torch.float32)
            h = fused.dense_relu_reference(x, self.hidden_kernel,
                                           self.hidden_bias)
            return h @ self.logits_kernel + self.logits_bias

    cfg = PRESETS["mlp-sgd"].replace(learning_rate=MLP_LR, seed=SEED)
    dev = torch.device("cuda")
    ds = DeviceDataset(data, dev, pixel_format=cfg.pixel_format)
    idx = IndexStream(ds.train_n, cfg.batch_size, cfg.seed).next_block(
        COMPARE_STEPS, dev)
    runs = {}
    with training_numerics():
        for name, net in (("kernel", models.build("mlp", device=dev)),
                          ("plain", PlainMLP(device=dev))):
            net.load_state_dict(models.init_params("mlp", cfg.seed))
            opt, sched = optim.build(
                cfg.optimizer, net.parameters(),
                optim.make_schedule(cfg.learning_rate), cfg.momentum)
            step = trainer.make_train_step(net, opt, sched,
                                           cfg.pixel_format)
            losses = torch.stack([step(ds.train_x, ds.train_y, idx[i])
                                  for i in range(COMPARE_STEPS)])
            runs[name] = (losses.cpu(), {k: v.detach().cpu() for k, v in
                                         net.state_dict().items()})
    (lk, pk), (lp, pp) = runs["kernel"], runs["plain"]
    rec = {"steps": COMPARE_STEPS,
           "max_loss_rel_err": float(((lk - lp).abs() / lp.abs()).max()),
           "max_param_abs_err": max(float((pk[k] - pp[k]).abs().max())
                                    for k in pp),
           "first_loss": float(lk[0]), "last_loss": float(lk[-1]),
           **COMPARE_TOL}
    print("train_compare " + json.dumps(rec), flush=True)
    if (rec["max_loss_rel_err"] > COMPARE_TOL["loss_rtol"]
            or rec["max_param_abs_err"] > COMPARE_TOL["param_atol"]):
        raise RuntimeError(f"the training step through the dense_relu "
                           f"kernel left its plain version: {rec}")
    if not rec["last_loss"] < rec["first_loss"]:
        raise RuntimeError(f"{COMPARE_STEPS} steps did not lower the "
                           f"loss: {rec}")
    return rec


def lenet_recipe(checkpoint_dir: str):
    """Config 2 as chip_smoke trains it: on the parity batch's synthetic
    distribution, committing checkpoints into `checkpoint_dir`."""
    from distributedmnist_tpu_torch.config import PRESETS

    return PRESETS["lenet-adam"].replace(
        synthetic=True, steps=TRAIN_STEPS["lenet-adam"],
        eval_every=EVAL_EVERY, seed=LENET_SEED, target_accuracy=None,
        device="cuda", checkpoint_dir=checkpoint_dir,
        checkpoint_every=LENET_CHECKPOINT_EVERY)


def drive_training_path(data, lenet_data, lenet_checkpoint_dir) -> dict:
    """The port's training path, through trainer.fit, on the card: the two
    single-card recipes on full-size synthetic MNIST (config 2's
    checkpoints committed into `lenet_checkpoint_dir`), then the
    checkpoint's kill/resume round trip."""
    import tempfile

    import numpy as np

    from distributedmnist_tpu_torch import trainer
    from distributedmnist_tpu_torch.config import PRESETS
    from distributedmnist_tpu_torch.ops import fused

    recipes = {
        "mlp-sgd": (PRESETS["mlp-sgd"].replace(
            learning_rate=MLP_LR, synthetic=True, steps=TRAIN_STEPS[
                "mlp-sgd"], eval_every=EVAL_EVERY, seed=SEED,
            target_accuracy=None, device="cuda"), data),
        "lenet-adam": (lenet_recipe(lenet_checkpoint_dir), lenet_data)}
    eval_batches = -(-len(data["test_y"]) // 2048)
    phases = {}
    for name, (cfg, recipe_data) in recipes.items():
        before = dict(fused.LAUNCHES)
        out = trainer.fit(cfg, data=recipe_data)
        launched = fused.LAUNCHES["dense_relu"] - before["dense_relu"]
        wgrad = fused.LAUNCHES["conv_wgrad_1ch"] - before["conv_wgrad_1ch"]
        keep = ("images_per_sec", "step_ms", "test_accuracy",
                "wall_clock_s", "elapsed_s", "steps_timed", "steps",
                "n_evals", "final_loss", "global_batch", "pixel_format")
        phases[name] = {k: out[k] for k in keep}
        phases[name]["dense_relu_launches"] = launched
        phases[name]["conv_wgrad_1ch_launches"] = wgrad
        phases[name]["learning_rate"] = cfg.learning_rate
        print(f"train {name}: {out['images_per_sec']:.1f} images/s, step "
              f"{out['step_ms']:.4f} ms, test accuracy "
              f"{out['test_accuracy']:.4f} after {out['steps']} steps, "
              f"wall clock {out['wall_clock_s']:.2f} s, dense_relu "
              f"launches {launched}", flush=True)
        print("train_summary " + json.dumps({"recipe": name, **out}),
              flush=True)
        if out["steps"] != cfg.steps or not np.isfinite(out["final_loss"]):
            raise RuntimeError(f"{name}: bad run {out}")
        if out["test_accuracy"] < ACCURACY_FLOOR[name]:
            raise RuntimeError(
                f"{name}: test accuracy {out['test_accuracy']} under the "
                f"floor {ACCURACY_FLOOR[name]}")
        # conv1's weight gradient: once a LeNet step, never in eval
        if wgrad != (out["steps"] if cfg.model == "lenet" else 0):
            raise RuntimeError(f"{name}: conv_wgrad_1ch launched {wgrad} "
                               f"times in {out['steps']} steps")
        if cfg.model == "mlp":
            want = out["steps"] + out["n_evals"] * eval_batches
            if launched < want:
                raise RuntimeError(
                    f"{name}: dense_relu launched {launched} times, fewer "
                    f"than its {out['steps']} steps and "
                    f"{out['n_evals']} x {eval_batches} eval batches")

    # kill at step 200 through the fault hook, then resume to 300
    cfg = recipes["mlp-sgd"][0].replace(steps=300, eval_every=300,
                                        checkpoint_every=100)
    with tempfile.TemporaryDirectory() as d:
        failed = False
        try:
            trainer.fit(cfg.replace(checkpoint_dir=d, fail_at_step=200),
                        data=data)
        except trainer.SimulatedFailure:
            failed = True
        if not failed:
            raise RuntimeError("fail_at_step=200 raised no SimulatedFailure")
        out = trainer.fit(cfg.replace(checkpoint_dir=d), data=data)
    if not (out["restored"] and out["steps"] == 300):
        raise RuntimeError(f"resume from the checkpoint failed: {out}")
    phases["kill_resume"] = {k: out[k] for k in
                             ("restored", "steps", "test_accuracy")}
    print(f"kill/resume: restored {out['restored']}, {out['steps']} steps, "
          f"test accuracy {out['test_accuracy']:.4f}", flush=True)
    return phases


# -- children ----------------------------------------------------------------
#
# On the card's host a fresh interpreter spends about 10 s in `import
# torch` (PERF.md §6): its torch has no bytecode for this interpreter,
# and reading its ~1,100 modules is slow even from a cache. So every
# Python child of this script is forked from a process that imported
# torch and numpy once (ForkServer), and every interpreter that does
# start afresh (the fork server itself, the import probe's "before", the
# children the port itself starts: a bench's supervised worker,
# parallel/launch.py's ranks, the gateway's workers, the dry run's
# ranks) reads and writes one bytecode cache, PYCACHE.

PYCACHE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "distributedmnist_tpu_torch", "csrc", "build",
                       "pycache")
# the variables an interpreter reads while it starts or loads torch: a
# child whose values differ from the fork server's starts afresh
_START_VARS = ("OMP_", "MKL_", "PYTHON", "TORCH_")
FORK_SERVER_READY_S = 300


def _child_env() -> dict:
    """The environment of every child process of this script: the
    repository first on PYTHONPATH, one CPU thread a process (as torchrun
    gives a rank), and the bytecode cache under PYCACHE, which every
    child reads and writes."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPYCACHEPREFIX=PYCACHE)
    env.pop("PYTHONDONTWRITEBYTECODE", None)
    env["PYTHONPATH"] = here + os.pathsep + env.get("PYTHONPATH", "")
    return env


def use_bytecode_cache() -> None:
    """Make PYCACHE and point this process, and every child that
    inherits its environment, at it. Raises, naming the reason, when the
    directory cannot be made or written: no child starts without it."""
    try:
        os.makedirs(PYCACHE, exist_ok=True)
        tempfile.TemporaryFile(dir=PYCACHE).close()
    except OSError as exc:
        raise RuntimeError(f"the bytecode cache {PYCACHE} cannot be made "
                           f"or written: {exc}") from exc
    os.environ["PYTHONPYCACHEPREFIX"] = PYCACHE
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    sys.pycache_prefix = PYCACHE
    sys.dont_write_bytecode = False


def _start_vars(env) -> dict:
    return {k: v for k, v in env.items() if k.startswith(_START_VARS)}


class ForkServer:
    """A process that imports torch and numpy once, under the children's
    environment (OpenMP reads OMP_NUM_THREADS=1 when torch loads it, so
    the server keeps one thread and can fork), and forks this script's
    Python children from there. A request carries the child's argv after
    the interpreter (`-m module ...` or `-c code ...`), its working
    directory, its environment and its three standard file descriptors;
    the child applies them, restores the default signal handlers and
    runs as `python argv` would. Before each fork the server checks that
    CUDA is not initialized in it and that it runs one thread, and
    refuses otherwise: the request raises, naming the reason. The server
    ends, killing the children it still has, when this process closes
    its socket. `preload` is the statement the server runs first."""

    def __init__(self, env: dict, cwd: str,
                 preload: str = "import numpy, torch"):
        self.env = env
        self._control, theirs = socket.socketpair(socket.AF_UNIX,
                                                  socket.SOCK_SEQPACKET)
        code = (f"import chip_smoke; chip_smoke._fork_server_main("
                f"{theirs.fileno()}, {preload!r})")
        self.proc = subprocess.Popen(
            [sys.executable, "-c", code], cwd=cwd, env=env,
            stdin=subprocess.DEVNULL, stdout=subprocess.DEVNULL,
            pass_fds=[theirs.fileno()])
        theirs.close()
        self._lock = threading.Lock()
        self.ready: Optional[dict] = None

    def _gone(self, what: str) -> RuntimeError:
        return RuntimeError(f"the fork server {what} (exit "
                            f"{self.proc.poll()}): no child starts the "
                            f"ordinary way in its place")

    def _wait_ready(self) -> None:
        if self.ready is None:
            up, _, _ = select.select([self._control], [], [],
                                     FORK_SERVER_READY_S)
            msg = self._control.recv(1 << 16) if up else b""
            if not msg:
                raise self._gone(f"did not come up within "
                                 f"{FORK_SERVER_READY_S}s")
            self.ready = json.loads(msg)

    def request(self, req: dict, fds: list) -> socket.socket:
        """Send one child's request; returns the socket its pid (or the
        refusal) and then its exit code come back on."""
        mine, theirs = socket.socketpair(socket.AF_UNIX,
                                         socket.SOCK_SEQPACKET)
        try:
            with self._lock:
                self._wait_ready()
                try:
                    socket.send_fds(self._control,
                                    [json.dumps(req).encode()],
                                    [theirs.fileno(), *fds])
                except OSError as exc:
                    raise self._gone(f"took no request: {exc}") from exc
        except BaseException:
            mine.close()
            raise
        finally:
            theirs.close()
        return mine

    def popen(self, args, **kw) -> "Forked":
        return Forked(self, args, **kw)

    def close(self) -> None:
        """Stop the server; it kills the children it still has."""
        if self.ready is None:
            self.proc.kill()
        self._control.close()
        try:
            self.proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()


class Forked:
    """A child of the fork server with the part of subprocess.Popen's
    interface this script uses: args, pid, returncode, stdin/stdout/
    stderr, poll, wait, communicate, send_signal, kill and the context
    manager. stdin, stdout and stderr are each None (this process's),
    PIPE or a file."""

    def __init__(self, server: ForkServer, args, stdin=None, stdout=None,
                 stderr=None, text: bool = False, env=None, cwd=None):
        if args[0] != sys.executable or args[1] not in ("-m", "-c"):
            raise ValueError(f"the fork server runs `-m` and `-c` only: "
                             f"{args[:3]}")
        self.args, self.returncode = list(args), None
        self.stdin = self.stdout = self.stderr = None
        self._lock = threading.Lock()
        self._readers: Optional[list] = None
        self._out: dict = {}
        fds, close = [], []
        for i, (name, spec) in enumerate((("stdin", stdin),
                                          ("stdout", stdout),
                                          ("stderr", stderr))):
            if spec is None:
                fd = i
            elif spec == subprocess.PIPE:
                r, w = os.pipe()
                fd, mine = (r, w) if i == 0 else (w, r)
                close.append(fd)
                setattr(self, name, open(mine, ("w" if i == 0 else "r")
                                         + ("" if text else "b")))
            else:
                fd = spec.fileno()
            fds.append(fd)
        try:
            self._conn = server.request({
                "argv": self.args[1:], "cwd": cwd or os.getcwd(),
                "env": dict(env if env is not None else os.environ)}, fds)
            msg = self._receive(FORK_SERVER_READY_S)
        except BaseException:
            self._close_pipes()
            raise
        finally:
            for fd in close:
                os.close(fd)
        if msg is None or "pid" not in msg:
            self._close_pipes()
            self._conn.close()
            raise RuntimeError(f"the fork server refused {self.args[1:3]}: "
                               f"{(msg or {}).get('error', 'no answer')}")
        self.pid = msg["pid"]

    def _close_pipes(self) -> None:
        for f in (self.stdin, self.stdout, self.stderr):
            if f is not None:
                f.close()

    def _receive(self, timeout: Optional[float]) -> Optional[dict]:
        """The server's next message, None if none came in `timeout`."""
        up, _, _ = select.select([self._conn], [], [], timeout)
        if not up:
            return None
        msg = self._conn.recv(1 << 16)
        if not msg:
            raise RuntimeError(f"the fork server closed the line of "
                               f"{self.args[1:3]} before it exited: the "
                               f"server has died")
        return json.loads(msg)

    def _wait(self, timeout: Optional[float]) -> int:
        if self.returncode is None:
            msg = self._receive(timeout)
            if msg is None:
                raise subprocess.TimeoutExpired(self.args, timeout)
            self.returncode = msg["rc"]
            self._conn.close()
        return self.returncode

    def wait(self, timeout: Optional[float] = None) -> int:
        with self._lock:
            return self._wait(timeout)

    def poll(self) -> Optional[int]:
        """The exit code, or None while the child runs (or while another
        thread waits for it, as Popen.poll)."""
        if not self._lock.acquire(blocking=False):
            return None
        try:
            return self._wait(0)
        except subprocess.TimeoutExpired:
            return None
        finally:
            self._lock.release()

    def _drain(self, name: str) -> None:
        f = getattr(self, name)
        self._out[name] = f.read()
        f.close()

    def communicate(self, input=None, timeout: Optional[float] = None):
        if self._readers is None:
            self._readers = [threading.Thread(target=self._drain,
                                              args=(name,), daemon=True)
                             for name in ("stdout", "stderr")
                             if getattr(self, name) is not None]
            for t in self._readers:
                t.start()
            if self.stdin is not None:
                if input:
                    self.stdin.write(input)
                self.stdin.close()
        deadline = None if timeout is None else time.monotonic() + timeout

        def left():
            return None if deadline is None else max(
                0.0, deadline - time.monotonic())

        for t in self._readers:
            t.join(left())
            if t.is_alive():
                raise subprocess.TimeoutExpired(self.args, timeout)
        self.wait(left())
        return self._out.get("stdout"), self._out.get("stderr")

    def send_signal(self, sig: int) -> None:
        if self.poll() is None:
            try:
                os.kill(self.pid, sig)
            except ProcessLookupError:
                pass          # exited, its exit code on its way

    def kill(self) -> None:
        self.send_signal(signal.SIGKILL)

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self._close_pipes()
        self.wait()


def _fork_refusal(torch) -> Optional[str]:
    """Why the fork server must not fork now, or None."""
    if torch.cuda.is_initialized():
        return ("CUDA is initialized in the fork server: a forked child "
                "could not use the card")
    threads = len(os.listdir("/proc/self/task"))
    if threads != 1:
        return (f"the fork server runs {threads} threads: a fork copies "
                f"their locks, not them")
    return None


def _fork_server_main(control_fd: int, preload: str) -> None:
    """The fork server's process (ForkServer): returns in the server when
    this script has gone, and in a forked child once it has run."""
    exec(preload, {})
    import torch

    control = socket.socket(fileno=control_fd)
    try:
        control.send(json.dumps({"pid": os.getpid()}).encode())
    except OSError:
        return                      # this script stopped before it
    server, live, job = os.getpid(), {}, None
    try:
        while job is None:
            if select.select([control], [], [], 0.02)[0]:
                msg, fds, _, _ = socket.recv_fds(control, 1 << 20, 4)
                if not msg:
                    break           # this script has gone
                job = _fork_one(json.loads(msg), fds, live, control, torch)
            while live:
                pid, status = os.waitpid(-1, os.WNOHANG)
                if pid == 0:
                    break
                conn = live.pop(pid)
                _tell(conn, {"rc": os.waitstatus_to_exitcode(status)})
                conn.close()
    finally:
        if os.getpid() == server:
            for pid in live:
                os.kill(pid, signal.SIGKILL)
                os.waitpid(pid, 0)
    if job is not None:
        _run_forked(*job)


def _tell(conn: socket.socket, msg: dict) -> None:
    try:
        conn.send(json.dumps(msg).encode())
    except OSError:
        pass            # the requester has gone; its child is reaped as ever


def _fork_one(req: dict, fds: list, live: dict, control, torch):
    """Fork one child for `req`. In the child returns (req, its three
    descriptors); in the server None."""
    conn, stdio = socket.socket(fileno=fds[0]), fds[1:]
    refusal = _fork_refusal(torch)
    if refusal is None and len(stdio) != 3:
        refusal = f"{len(stdio)} standard descriptors, not 3"
    if refusal is not None:
        _tell(conn, {"error": refusal})
        conn.close()
        for fd in stdio:
            os.close(fd)
        return None
    sys.stdout.flush()
    sys.stderr.flush()
    pid = os.fork()
    if pid == 0:
        control.close()
        conn.close()
        for other in live.values():
            other.close()
        live.clear()            # the server's children, not this one's
        return req, stdio
    for fd in stdio:
        os.close(fd)
    live[pid] = conn
    _tell(conn, {"pid": pid})
    return None


def _run_forked(req: dict, stdio: list) -> None:
    """In a forked child: become `python *req["argv"]` in req's working
    directory and environment, on its descriptors."""
    for target, fd in enumerate(stdio):
        os.dup2(fd, target)
    for fd in set(stdio) - {0, 1, 2}:
        os.close(fd)
    signal.signal(signal.SIGINT, signal.default_int_handler)
    for sig in (signal.SIGTERM, signal.SIGHUP, signal.SIGCHLD):
        signal.signal(sig, signal.SIG_DFL)
    os.chdir(req["cwd"])
    os.environ.clear()
    os.environ.update(req["env"])
    import numpy as np

    np.random.seed()        # fresh entropy, as a new interpreter's
    kind, target, *rest = req["argv"]
    if kind == "-m":
        sys.argv = [target, *rest]      # runpy puts the module's path first
        sys.path[0] = os.getcwd()
        runpy.run_module(target, run_name="__main__", alter_sys=True)
    else:
        sys.argv = ["-c", *rest]
        main = types.ModuleType("__main__")
        sys.modules["__main__"] = main
        exec(compile(target, "<string>", "exec"), main.__dict__)


class Children:
    """Starts this script's children and counts them, by phase and route:
    "fork" (from the fork server), "cache" and "plain" (an interpreter of
    its own, with the bytecode cache or without it) and "tool" (a program
    that is not Python). A Python child forks unless `fresh` asks for a
    new interpreter or its start variables differ from the server's."""

    def __init__(self, server: ForkServer):
        self.server = server
        self.current: dict = {}
        self.phases: dict = {}
        self._count("cache", "the fork server")

    def route(self, args, env=None, fresh: bool = False) -> str:
        if args[0] != sys.executable:
            return "tool"
        env = os.environ if env is None else env
        if not fresh and args[1] in ("-m", "-c") and \
                _start_vars(env) == _start_vars(self.server.env):
            return "fork"
        return "cache" if env.get("PYTHONPYCACHEPREFIX") else "plain"

    def _count(self, route: str, what: str) -> None:
        """A count a route; an interpreter of its own is named."""
        if route in ("cache", "plain"):
            self.current.setdefault(route, []).append(what)
        else:
            self.current[route] = self.current.get(route, 0) + 1

    def popen(self, args, fresh: bool = False, what: str = "", **kw):
        route = self.route(args, kw.get("env"), fresh)
        self._count(route, what or (args[2] if args[1] == "-m"
                                    else " ".join(args[1:3])[:40]))
        if route == "fork":
            return self.server.popen(args, **kw)
        return subprocess.Popen(args, **kw)

    def run(self, args, timeout: Optional[float] = None, check: bool = False,
            capture_output: bool = False,
            **kw) -> subprocess.CompletedProcess:
        """subprocess.run over popen: the child killed past `timeout`."""
        if capture_output:
            kw["stdout"] = kw["stderr"] = subprocess.PIPE
        with self.popen(args, **kw) as proc:
            try:
                out, err = proc.communicate(timeout=timeout)
            except BaseException:
                proc.kill()
                raise
        if check and proc.returncode:
            raise subprocess.CalledProcessError(proc.returncode, args, out,
                                                err)
        return subprocess.CompletedProcess(args, proc.returncode, out, err)

    def lap(self, phase: str) -> None:
        """The children counted since the last lap are `phase`'s."""
        self.phases[phase], self.current = self.current, {}

    def close(self) -> None:
        self.server.close()


CHILDREN: Optional[Children] = None     # main() starts it


# The fork server's first child: imports every module of the port, so
# that their bytecode, and that of the parts of torch they import, is in
# the cache before the children the port starts afresh read it
_FILL_CACHE = """
import pkgutil
import distributedmnist_tpu_torch as pkg
for mod in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    if not mod.name.endswith("__main__"):
        __import__(mod.name)
"""


def _run_timed(argvs, timeout=DP_TIMEOUT_S) -> list:
    """Start one child a command line, all at once, from the repository
    root; wait for all of them, a thread a child (every one killed if any
    outlives the timeout). Returns [(rc, stdout, stderr, seconds from the
    start to its exit)], one a child."""
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    procs = [CHILDREN.popen([sys.executable, *argv], cwd=here,
                            env=_child_env(), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
             for argv in argvs]

    def wait(p):
        out, err = p.communicate(timeout=timeout)
        return p.returncode, out, err, time.perf_counter() - t0

    with concurrent.futures.ThreadPoolExecutor(len(procs)) as pool:
        waits = [pool.submit(wait, p) for p in procs]
        try:
            return [w.result() for w in waits]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()


def _run_ranks(argvs, timeout=DP_TIMEOUT_S) -> list:
    """_run_timed's [(rc, stdout, stderr)], one a child."""
    return [r[:3] for r in _run_timed(argvs, timeout)]


# A child's start, timed: the wall clock once it has imported torch and
# numpy (its parent subtracts the wall clock it asked at), the import's
# own seconds, and its view of the bytecode cache: the flags, and how
# many of torch's sources have the .pyc this interpreter would read
_IMPORT_PROBE = """
import time
t0 = time.perf_counter()
import numpy, torch
import_s, ready = time.perf_counter() - t0, time.time()
import importlib.util, json, os, sys
root = os.path.dirname(torch.__file__)
py = pyc = 0
for d, _, files in os.walk(root):
    for f in files:
        if f.endswith(".py"):
            py += 1
            pyc += os.path.exists(importlib.util.cache_from_source(
                os.path.join(d, f)))
print(json.dumps({
    "ready": ready, "import_s": import_s,
    "dont_write_bytecode": sys.dont_write_bytecode,
    "pycache_prefix": sys.pycache_prefix, "torch_py": py, "torch_pyc": pyc,
    "site_packages_writable": os.access(os.path.dirname(root), os.W_OK)}))
"""


def _importtime(err: str) -> dict:
    """`-X importtime`'s report: the modules, their self seconds summed,
    and the five that took most."""
    rows = []
    for ln in err.splitlines():
        if ln.startswith("import time:") and "|" in ln:
            self_us, _, name = ln[len("import time:"):].split("|")
            if self_us.strip().isdigit():
                rows.append((int(self_us), name.strip()))
    rows.sort(reverse=True)
    return {"modules": len(rows),
            "self_s": sum(us for us, _ in rows) / 1e6,
            "top": [[name, us / 1e6] for us, name in rows[:5]]}


def import_seconds() -> dict:
    """How long a child takes to start, by route: `python -c pass`, then
    a child that imports torch and numpy started the old way (no
    bytecode cache, bytecode not written, as the card's host sets it)
    twice in a row under `-X importtime`, one started afresh on the
    cache, and three forked. `start_s`: from the request to the child
    holding torch and numpy."""
    here = os.path.dirname(os.path.abspath(__file__))
    old = _child_env()
    del old["PYTHONPYCACHEPREFIX"]
    if sys.flags.dont_write_bytecode:
        old["PYTHONDONTWRITEBYTECODE"] = "1"

    def start(args, env, fresh, what=""):
        asked = time.time()     # the clock the child stamps
        proc = CHILDREN.run(args, env=env, cwd=here, capture_output=True,
                            text=True, timeout=300, fresh=fresh, what=what)
        if proc.returncode != 0:
            raise RuntimeError(f"import probe {args[1:3]} exited "
                               f"{proc.returncode}:\n{proc.stderr[-3000:]}")
        rec = json.loads(proc.stdout.splitlines()[-1])
        rec["start_s"] = rec.pop("ready") - asked
        return rec, proc.stderr

    t0 = time.perf_counter()
    CHILDREN.run([sys.executable, "-c", "pass"], env=old, cwd=here,
                 timeout=60, check=True, fresh=True,
                 what="import probe: python -c pass, the old way")
    out: dict = {"pass_s": time.perf_counter() - t0, "plain": []}
    for _ in range(2):
        rec, err = start([sys.executable, "-X", "importtime", "-c",
                          _IMPORT_PROBE], old, True,
                         "import probe: the old way")
        out["plain"].append({**rec, "importtime": _importtime(err)})
    out["cache"] = start([sys.executable, "-c", _IMPORT_PROBE],
                         _child_env(), True, "import probe: on the cache")[0]
    out["fork"] = [start([sys.executable, "-c", _IMPORT_PROBE],
                         _child_env(), False)[0] for _ in range(3)]
    out["fork_median_start_s"] = sorted(r["start_s"]
                                        for r in out["fork"])[1]
    return out


def _summary(out: str) -> dict:
    lines = [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]
    if len(lines) != 1:
        raise RuntimeError(f"{len(lines)} summary lines, not 1:\n{out}")
    return lines[0]


def _train_launches(err: str) -> list:
    """Each `train: launches {...}` line a rank printed on stderr."""
    from distributedmnist_tpu_torch.ops import fused

    return fused.parse_launches(err, "train: launches ")


def _coordinated(port: int, n: int, *args) -> list:
    """The train CLI as n ranks started with the coordinator flags."""
    return [["-m", "distributedmnist_tpu_torch.train", *args,
             "--coordinator-address", f"localhost:{port}",
             "--num-processes", str(n), "--process-id", str(i)]
            for i in range(n)]


def _run_groups(groups) -> list:
    """Run coordinated groups at once: `groups` is a list of functions,
    each giving a group's argvs (one a rank) for its rendezvous port.
    The ports come from one launch.free_ports call, so no two groups
    share one. A group that failed with a bind failure in a rank's
    stderr (launch.BIND_FAILURES: its port was taken before its rank 0
    bound it) is rerun once on a fresh port, as the dry run's
    _run_group_retry does; any other failure is the caller's to judge.
    Returns _run_ranks's [(rc, stdout, stderr)], a list a group."""
    from distributedmnist_tpu_torch.parallel import launch

    def run(makes):
        argvs = [make(p) for make, p in zip(makes,
                                           launch.free_ports(len(makes)))]
        results = iter(_run_ranks([a for g in argvs for a in g]))
        return [[next(results) for _ in g] for g in argvs]

    out = run(groups)
    again = [i for i, res in enumerate(out)
             if any(rc != 0 for rc, _, _ in res)
             and any(launch.bind_failure(err) for _, _, err in res)]
    if again:
        print(f"coordinated groups {again}: a rendezvous port was taken; "
              f"rerunning them once on fresh ports", flush=True)
        for i, res in zip(again, run([groups[i] for i in again])):
            out[i] = res
    return out


def drive_dp_path(card: str) -> tuple[dict, dict]:
    """Data-parallel training through the port's entry points on the
    card, every rank a child process: config 3 at full width as 2 ranks
    sharing the card over gloo (the train CLI starts them), config 3's
    trajectory in both SPMD modes against 1 rank, config 5's
    checkpoint/restore over the coordinator flags, and NCCL at world size
    1. Returns (phases, the kernel launches the ranks report, summed)."""
    import numpy as np

    from distributedmnist_tpu_torch import checkpoint, models
    from distributedmnist_tpu_torch.ops import fused
    from distributedmnist_tpu_torch.parallel import mh_smoke

    phases: dict = {}
    launches = dict.fromkeys(fused.LAUNCHES, 0)

    def add(counts: dict) -> None:
        for k, n in counts.items():
            launches[k] = launches.get(k, 0) + n

    # 1. config 3 at full width: 2 ranks on the card, the CLI's launcher,
    # alone on the card (its step time is a figure PERF.md keeps)
    t0 = time.perf_counter()
    [(rc, out, err)] = _run_ranks([[
        "-m", "distributedmnist_tpu_torch.train", "--preset", "mlp-dp2",
        "--synthetic", "--learning-rate", str(MLP_LR), "--steps",
        str(DP_STEPS)]])
    took = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"config 3 exited {rc}:\n{err[-4000:]}")
    s = _summary(out)
    ranks = _train_launches(err)
    eval_batches = -(-10_000 // 2048)
    want = s["steps"] + s["n_evals"] * eval_batches
    bad = []
    if (s["n_chips"], s["n_processes"], s["spmd_mode"], s["steps"]) != (
            1, 2, "auto", DP_STEPS):
        bad.append("topology or steps")
    if "dist: backend gloo, 2 ranks on 1 card(s)" not in err:
        bad.append("no gloo backend line")
    if len(ranks) != 2 or any(r["dense_relu"] < want for r in ranks):
        bad.append(f"dense_relu launches {ranks}, want >= {want} a rank")
    if s["test_accuracy"] < DP_ACCURACY_FLOOR:
        bad.append(f"test accuracy under {DP_ACCURACY_FLOOR}")
    if bad:
        raise RuntimeError(f"config 3: {bad}: {s}\n{err[-3000:]}")
    for r in ranks:
        add(r)
    phases["config3"] = {**{k: s[k] for k in (
        "images_per_sec", "images_per_sec_per_chip", "step_ms",
        "test_accuracy", "steps", "n_evals", "wall_clock_s", "n_chips",
        "spmd_mode")}, "dense_relu_launches": [r["dense_relu"]
                                               for r in ranks],
        "process_s": took}
    print(f"dp config 3: 2 ranks sharing the card over gloo, "
          f"{s['step_ms']:.4f} ms a step, {s['images_per_sec']:.1f} "
          f"images/s ({s['images_per_sec'] / 2:.1f} a rank), test "
          f"accuracy {s['test_accuracy']:.4f} after {s['steps']} steps, "
          f"dense_relu launches {[r['dense_relu'] for r in ranks]} on "
          f"{card}", flush=True)
    print("dp_summary " + json.dumps({"run": "config3", **s}), flush=True)

    with tempfile.TemporaryDirectory() as d:
        # 2. the trajectory (2 ranks in both modes, beside 1 rank), 4.
        # NCCL at world size 1 and 3. config 5's killed run, all at once
        runs = [{"spmd_mode": mode, "learning_rate": MLP_LR,
                 "steps_per_call": 1, "checkpoint_dir": f"{d}/{mode}"}
                for mode in ("auto", "explicit")]
        ck = f"{d}/config5"
        c5 = ("--preset", "lenet-multihost", "--synthetic", "--steps",
              "300", "--checkpoint-every", "100", "--checkpoint-dir", ck)
        t0 = time.perf_counter()
        results = [r for group in _run_groups([
            lambda port: [[
                "-m", "distributedmnist_tpu_torch.parallel.mh_smoke",
                str(r), "2", str(port), "--device", "cuda", "--preset",
                "mlp-dp2", "--steps", str(TRAJ_STEPS), "--runs",
                json.dumps(runs)] for r in range(2)],
            lambda port: _coordinated(port, 1, "--preset", "lenet-dp8",
                                      "--synthetic", "--num-devices", "1",
                                      "--steps", str(NCCL_STEPS)),
            lambda port: _coordinated(port, 2, *c5, "--fail-at-step",
                                      "200")]) for r in group]
        phases["concurrent_s"] = time.perf_counter() - t0
        for rc, out, err in results[:3]:
            if rc != 0:
                raise RuntimeError(f"a rank exited {rc}:\n{err[-4000:]}")
        recs = [[json.loads(ln.split(" ", 1)[1]) for ln in out.splitlines()
                 if ln.startswith("MHSMOKE ")] for _, out, _ in results[:2]]
        one = mh_smoke.run(mh_smoke.smoke_config(
            "mlp-dp2", device="cuda", steps=TRAJ_STEPS,
            learning_rate=MLP_LR, steps_per_call=1,
            checkpoint_dir=f"{d}/one"), mh_smoke.smoke_data())
        auto, explicit = recs[0]
        for rank in recs:
            for rec, first in zip(rank, recs[0]):
                if (rec["losses"] != first["losses"]
                        or (rec["n_chips"], rec["n_processes"]) != (1, 2)
                        or rec["backend"] != "gloo"
                        or len(rec["losses"]) != TRAJ_STEPS):
                    raise RuntimeError(f"ranks disagree: {rec} {first}")
                add(rec["launches"])
        np.testing.assert_allclose(explicit["losses"], auto["losses"],
                                   **TRAJ_TOL["modes"])
        np.testing.assert_allclose(auto["losses"], one["losses"],
                                   rtol=TRAJ_TOL["ranks"]["loss_rtol"])
        p2, _ = checkpoint.restore_latest_params(f"{d}/auto")
        p1, _ = checkpoint.restore_latest_params(f"{d}/one")
        param_err = max(float((p2[k] - p1[k]).abs().max()) for k in p1)
        if param_err > TRAJ_TOL["ranks"]["param_atol"]:
            raise RuntimeError(f"2 ranks' params {param_err} from 1 rank's")
        mode_err = max(abs(a - b) for a, b in zip(auto["losses"],
                                                  explicit["losses"]))
        rank_err = max(abs(a - b) / abs(b) for a, b in zip(auto["losses"],
                                                           one["losses"]))
        phases["trajectory"] = {"steps": TRAJ_STEPS, "auto_vs_explicit":
                                mode_err, "two_vs_one_rank_rtol": rank_err,
                                "param_max_abs": param_err}
        print(f"dp trajectory: {TRAJ_STEPS} steps, auto vs explicit "
              f"{mode_err:.3g}, 2 ranks vs 1 (rel) {rank_err:.3g}, params "
              f"{param_err:.3g}", flush=True)
        rc, out, err = results[2]
        s = _summary(out)
        if ("dist: backend nccl, 1 ranks on 1 card(s)" not in err
                or s["steps"] != NCCL_STEPS
                or not np.isfinite(s["final_loss"])):
            raise RuntimeError(f"NCCL at world size 1: {s}\n{err[-3000:]}")
        for r in _train_launches(err):
            add(r)
        phases["nccl_world1"] = {k: s[k] for k in (
            "steps", "final_loss", "test_accuracy", "n_chips", "multihost")}
        print(f"dp NCCL at world size 1: config 4's LeNet, {s['steps']} "
              f"steps, final loss {s['final_loss']:.4f}", flush=True)

        # 3. config 5, killed at step 200 on both ranks above: restored
        for rc, _, err in results[3:]:
            if rc == 0 or "SimulatedFailure: injected failure at step 200" \
                    not in err:
                raise RuntimeError(f"config 5 was not killed at step 200 "
                                   f"(rc {rc}):\n{err[-3000:]}")
        t0 = time.perf_counter()
        [resumed] = _run_groups([lambda port: _coordinated(port, 2, *c5)])
        phases["config5_resume_s"] = time.perf_counter() - t0
        for rc, out, err in resumed:
            s = _summary(out) if rc == 0 else {}
            if (rc != 0 or not s["restored"] or s["steps"] != 300
                    or "restored checkpoint at step 200" not in err
                    or (s["n_chips"], s["n_processes"], s["multihost"])
                    != (1, 2, True)):
                raise RuntimeError(f"config 5 resume (rc {rc}): {s}\n"
                                   f"{err[-3000:]}")
            for r in _train_launches(err):
                add(r)
        params, step = checkpoint.restore_latest_params(
            ck, template=models.init_params("lenet", 0))
        if step != 300:
            raise RuntimeError(f"config 5's checkpoint is at step {step}")
        phases["config5"] = {"killed_at": 200, "restored_at": 200,
                             "steps": s["steps"],
                             "test_accuracy": s["test_accuracy"],
                             "committed": checkpoint.committed_steps(ck)}
        print(f"dp config 5: both ranks killed at step 200, restored it, "
              f"ended at {s['steps']}; the checkpoint loads with the LeNet "
              f"template (step {step})", flush=True)
    return phases, launches


def tp_dense_relu_shapes() -> list[tuple[str, int, int]]:
    """(kind, rows, columns) of each dense_relu launch under tensor
    parallelism, as the trainer splits them, for each (world,
    model_parallel) of TP_LAYOUTS: a rank's share of config 3's global
    batch over its data index, and of an eval batch (min(2048, test
    images) rounded up to the data-parallel size), on its 128/mp hidden
    columns."""
    from distributedmnist_tpu_torch.config import PRESETS
    from distributedmnist_tpu_torch.parallel.mesh import make_mesh
    from distributedmnist_tpu_torch.utils import round_up

    batch = PRESETS["mlp-dp2"].batch_size
    out = set()
    for world, mp in TP_LAYOUTS:
        mesh = make_mesh(world, mp)
        n = 128 // mp
        out.add(("tp train", batch // mesh.dp, n))
        out.add(("tp eval", round_up(min(2048, 10_000), mesh.dp) // mesh.dp,
                 n))
    return sorted(out, key=lambda r: (-r[2], r[1], r[0]))


# the rows of bfloat16 training's dense_relu launches: config 1's step,
# the bench's batch, an eval batch
BF16_ROWS = (("train step", 64), ("bench step", 512), ("train eval", 2048))


def rest_cases(params: dict, data):
    """dense_relu at the rest-of-training shapes, on the fitted MLP's
    weights (fit_params: its hidden bias is non-zero, where a fresh
    init's is all zero and would leave the bias epilogue unchecked) and
    the data's pixels: f32 at each tensor-parallel rank's column shard
    (tp_dense_relu_shapes), and bf16 at N=128 (BF16_ROWS), decoded
    straight to bf16 as the trainer does. The same tuple as
    kernel_cases."""
    import torch

    from distributedmnist_tpu_torch.data.packing import normalize
    from distributedmnist_tpu_torch.ops import fused

    dev = torch.device("cuda")
    p = {k: v.to(dev) for k, v in params.items()}
    k = 784
    shapes = [(kind, m, n, torch.float32)
              for kind, m, n in tp_dense_relu_shapes()]
    shapes += [(kind, m, 128, torch.bfloat16) for kind, m in BF16_ROWS]
    for kind, m, n, dt in shapes:
        pixels = data["test_x" if kind.endswith("eval") else "train_x"][:m]
        x = normalize(torch.from_numpy(pixels.reshape(m, k)).to(dev), dt)
        w = p["hidden_kernel"][:, :n].to(dt).contiguous()
        b = p["hidden_bias"][:n].to(dt).contiguous()
        if int((b != 0).sum()) < n // 2:
            raise RuntimeError(f"rest_cases: the bias of 784->{n} is "
                               f"mostly zero; the epilogue goes unchecked")
        size = x.element_size()
        f32 = dt == torch.float32
        yield ("dense_relu", f"{'f32' if f32 else 'bf16'} {kind} "
               f"784->{n} b={m}", "float32" if f32 else "bfloat16",
               lambda x=x, w=w, b=b: fused.dense_relu_inference(x, w, b),
               lambda x=x, w=w, b=b: fused.dense_relu_reference(x, w, b),
               lambda x=x, w=w, b=b: torch.relu(torch.addmm(b, x, w)),
               size * (m * k + k * n + n + m * n), 2 * m * k * n + 2 * m * n,
               dict(rtol=1e-5, atol=1e-5) if f32
               # one bf16 rounding step of the output (2**-8 relative)
               else dict(rtol=1e-2, atol=1e-2))


def _write_idx(directory: str, data: dict) -> None:
    """`data`'s four arrays as the MNIST distribution's raw IDX files."""
    import struct

    import numpy as np

    for name, arr in (("train-images-idx3-ubyte", data["train_x"][..., 0]),
                      ("train-labels-idx1-ubyte", data["train_y"]),
                      ("t10k-images-idx3-ubyte", data["test_x"][..., 0]),
                      ("t10k-labels-idx1-ubyte", data["test_y"])):
        with open(os.path.join(directory, name), "wb") as f:
            f.write(struct.pack(f">I{arr.ndim}I", 0x0800 | arr.ndim,
                                *arr.shape))
            f.write(np.ascontiguousarray(arr, dtype=np.uint8).tobytes())


def _fit_record(name: str, out: dict, launched: int) -> dict:
    rec = {k: out[k] for k in (
        "images_per_sec", "step_ms", "test_accuracy", "steps", "n_evals",
        "final_loss", "global_batch", "model_parallel", "data_pipeline",
        "pixel_format", "n_processes")}
    rec["dense_relu_launches"] = launched
    print(f"rest {name}: {out['step_ms']:.4f} ms a step, "
          f"{out['images_per_sec']:.1f} images/s, test accuracy "
          f"{out['test_accuracy']:.4f} after {out['steps']} steps, "
          f"dense_relu launches {launched}", flush=True)
    return rec


def drive_rest_of_training(card: str, data: dict) -> tuple[dict, dict]:
    """The rest of training through the port's entry points on the card:
    model_parallel 2 (2 ranks sharing the card over gloo: mh_smoke's
    trajectories against 1 rank, the train CLI's step time at full width
    against 1 rank's), bfloat16 configs 1 and 2 against float32, the
    streaming pipeline against the device pipeline, and --data-dir read
    by the native IDX reader with --supervise and --profile-dir. Returns
    (phases, the kernel launches of this process and its children)."""
    import numpy as np

    from distributedmnist_tpu_torch import trainer
    from distributedmnist_tpu_torch.config import PRESETS
    from distributedmnist_tpu_torch.data import load_mnist, native
    from distributedmnist_tpu_torch.ops import fused
    from distributedmnist_tpu_torch.parallel import mh_smoke
    from distributedmnist_tpu_torch.utils import MetricsLogger

    phases: dict = {}
    children = dict.fromkeys(fused.LAUNCHES, 0)

    def add(counts: dict) -> None:
        for k, n in counts.items():
            children[k] = children.get(k, 0) + n

    # 1. TP trajectories: 2 ranks at model_parallel 2 against 1 rank
    runs = {"mlp": {"learning_rate": MLP_LR},
            "lenet": {"model": "lenet", "optimizer": "adam",
                      "learning_rate": 1e-3}}
    specs = [{"model_parallel": 2, "steps_per_call": 1,
              "steps": TP_STEPS[n], **r} for n, r in runs.items()]
    [results] = _run_groups([lambda port: [[
        "-m", "distributedmnist_tpu_torch.parallel.mh_smoke", str(r), "2",
        str(port), "--device", "cuda", "--preset", "mlp-dp2", "--runs",
        json.dumps(specs)] for r in range(2)]])
    recs = []
    for rc, out, err in results:
        if rc != 0:
            raise RuntimeError(f"a TP rank exited {rc}:\n{err[-4000:]}")
        recs.append([json.loads(ln.split(" ", 1)[1])
                     for ln in out.splitlines() if ln.startswith("MHSMOKE ")])
    eval_batches = 1                      # mh_smoke's 255 test images
    for (name, run), spec, *ranks in zip(runs.items(), specs, *recs):
        one = mh_smoke.run(mh_smoke.smoke_config(
            "mlp-dp2", device="cuda", steps_per_call=1,
            steps=TP_STEPS[name], **run), mh_smoke.smoke_data())
        for rec in ranks:
            bad = []
            if rec["losses"] != ranks[0]["losses"]:
                bad.append("the ranks disagree")
            if (rec["model_parallel"], rec["n_processes"], rec["n_chips"],
                    rec["backend"]) != (2, 2, 1, "gloo"):
                bad.append("topology")
            if name == "mlp" and rec["launches"]["dense_relu"] < (
                    TP_STEPS[name] + eval_batches):
                bad.append(f"dense_relu launches {rec['launches']}")
            if bad:
                raise RuntimeError(f"TP {name}: {bad}: {rec}")
            add(rec["launches"])
        got, want = np.array(ranks[0]["losses"]), np.array(one["losses"])
        err = float(np.max(np.abs(got - want) / np.abs(want)))
        if len(got) != TP_STEPS[name] or err > TP_TOL:
            raise RuntimeError(f"TP {name}: 2 ranks at model_parallel 2 "
                               f"vs 1 rank: {err} over {len(got)} steps")
        phases[f"tp_{name}_trajectory"] = {
            "steps": TP_STEPS[name], "max_loss_rtol": err,
            "launches": [r["launches"]["dense_relu"] for r in ranks],
            "test_accuracy": ranks[0]["test_accuracy"]}
        print(f"tp {name}: {TP_STEPS[name]} steps, 2 ranks at "
              f"model_parallel 2 vs 1 rank: losses {err:.3g} apart "
              f"(rel), dense_relu launches "
              f"{[r['launches']['dense_relu'] for r in ranks]}", flush=True)

    # 2. TP at full width through the train CLI (its launcher starts the
    # 2 ranks), each beside 1 rank at the same global batch in this
    # process: per-rank figures of a shared card, no scaling figure
    cli = {"mlp": ("--preset", "mlp-dp2", "--learning-rate", str(MLP_LR)),
           "lenet": ("--preset", "lenet-dp8", "--num-devices", "2",
                     "--batch-size", "128")}
    for name, args in cli.items():
        [(rc, out, err)] = _run_ranks([[
            "-m", "distributedmnist_tpu_torch.train", *args, "--synthetic",
            "--model-parallel", "2", "--steps", str(TP_CLI_STEPS)]])
        if rc != 0:
            raise RuntimeError(f"TP {name} CLI exited {rc}:\n{err[-4000:]}")
        s = _summary(out)
        ranks = _train_launches(err)
        want = s["steps"] + s["n_evals"] * (-(-10_000 // 2048))
        if ((s["model_parallel"], s["n_processes"], s["n_chips"])
                != (2, 2, 1) or len(ranks) != 2
                or (name == "mlp" and any(r["dense_relu"] < want
                                          for r in ranks))):
            raise RuntimeError(f"TP {name} CLI: {s} {ranks}")
        for r in ranks:
            add(r)
        preset = PRESETS["mlp-dp2" if name == "mlp" else "lenet-dp8"]
        before = fused.LAUNCHES["dense_relu"]
        one = trainer.fit(preset.replace(
            synthetic=True, num_devices=1, batch_size=s["global_batch"],
            learning_rate=MLP_LR if name == "mlp" else preset.learning_rate,
            steps=TP_CLI_STEPS, device="cuda"), data=data)
        phases[f"tp_{name}_cli"] = {
            "mp2": {**{k: s[k] for k in ("step_ms", "images_per_sec",
                                         "test_accuracy", "steps")},
                    "dense_relu_launches": [r["dense_relu"] for r in ranks]},
            "one_rank": _fit_record(f"{name} 1 rank", one,
                                    fused.LAUNCHES["dense_relu"] - before)}
        print(f"tp {name} CLI: model_parallel 2, 2 ranks sharing the card "
              f"over gloo, {s['step_ms']:.4f} ms a step "
              f"({s['images_per_sec']:.1f} images/s), test accuracy "
              f"{s['test_accuracy']:.4f}; 1 rank {one['step_ms']:.4f} ms "
              f"on {card}", flush=True)

    # 3. bfloat16 against float32, configs 1 and 2
    recipes = {"mlp-sgd": PRESETS["mlp-sgd"].replace(learning_rate=MLP_LR),
               "lenet-adam": PRESETS["lenet-adam"]}
    for name, base in recipes.items():
        for dt in ("float32", "bfloat16"):
            # blocks of 100 steps: the first is the timer's warm-up
            cfg = base.replace(synthetic=True, steps=REST_STEPS,
                               eval_every=REST_STEPS, seed=SEED,
                               target_accuracy=None, device="cuda", dtype=dt,
                               steps_per_call=100)
            before = fused.LAUNCHES["dense_relu"]
            out = trainer.fit(cfg, data=data)
            launched = fused.LAUNCHES["dense_relu"] - before
            phases[f"{name}_{dt}"] = _fit_record(f"{name} {dt}", out,
                                                 launched)
            if not np.isfinite(out["final_loss"]) or out["steps"] != \
                    REST_STEPS:
                raise RuntimeError(f"{name} {dt}: bad run {out}")
            if dt == "bfloat16" and out["test_accuracy"] < \
                    BF16_ACCURACY_FLOOR[name]:
                raise RuntimeError(f"{name} bfloat16: test accuracy "
                                   f"{out['test_accuracy']} under "
                                   f"{BF16_ACCURACY_FLOOR[name]}")
            if name == "mlp-sgd" and launched < REST_STEPS + 5:
                raise RuntimeError(f"{name} {dt}: dense_relu launched "
                                   f"{launched} times")

    # 4. the streaming pipeline against the device pipeline, config 2
    losses = {}
    for pipe in ("device", "stream"):
        cfg = PRESETS["lenet-adam"].replace(
            synthetic=True, steps=REST_STEPS, eval_every=REST_STEPS,
            seed=SEED, target_accuracy=None, device="cuda",
            data_pipeline=pipe, steps_per_call=100, log_every=100)
        mlog = MetricsLogger()
        out = trainer.fit(cfg, data=data, log=mlog)
        losses[pipe] = [r["loss"] for r in mlog.history if "loss" in r]
        phases[f"lenet-adam_{pipe}"] = _fit_record(f"lenet-adam {pipe}",
                                                   out, 0)
    np.testing.assert_allclose(losses["stream"], losses["device"],
                               rtol=STREAM_TOL, atol=STREAM_TOL)
    phases["stream_vs_device_max_abs"] = float(np.max(np.abs(
        np.array(losses["stream"]) - np.array(losses["device"]))))

    # 5. --data-dir through the native reader, --supervise, --profile-dir
    with tempfile.TemporaryDirectory() as d:
        idx_dir, prof = os.path.join(d, "idx"), os.path.join(d, "prof")
        os.makedirs(idx_dir)
        _write_idx(idx_dir, data)
        if not native.ensure_built(force=True):
            raise RuntimeError("the native IDX reader did not build")
        before = native.READS[0]
        real = load_mnist(idx_dir)
        if native.READS[0] - before != 4 or real["source"] != "real" or \
                not all(np.array_equal(real[k], data[k]) for k in (
                    "train_x", "train_y", "test_x", "test_y")):
            raise RuntimeError("--data-dir was not read by the native "
                               "reader as the synthetic set")
        [(rc, out, err)] = _run_ranks([[
            "-m", "distributedmnist_tpu_torch.train", "--preset", "mlp-sgd",
            "--learning-rate", str(MLP_LR), "--data-dir", idx_dir,
            "--steps", "200", "--eval-every", "200", "--supervise",
            "--stall-timeout", "120", "--profile-dir", prof]])
        if rc != 0:
            raise RuntimeError(f"--data-dir --supervise exited {rc}:\n"
                               f"{err[-4000:]}")
        s = _summary(out)
        traces = os.listdir(prof) if os.path.isdir(prof) else []
        if s["data"] != "real" or s["steps"] != 200 or not traces:
            raise RuntimeError(f"--data-dir run: {s}, traces {traces}")
        for r in _train_launches(err):
            add(r)
        phases["data_dir"] = {"native_reads": native.READS[0] - before,
                              "test_accuracy": s["test_accuracy"],
                              "trace_files": traces,
                              "trace_bytes": os.path.getsize(
                                  os.path.join(prof, traces[0]))}
        print(f"--data-dir: 4 IDX files read natively; the supervised CLI "
              f"trained 200 steps on them (data {s['data']}, test accuracy "
              f"{s['test_accuracy']:.4f}) and wrote {traces}", flush=True)
    return phases, children


def drive_serving_path(params: dict) -> dict:
    """The port's serving path, through its entry points, on the card."""
    import numpy as np
    import torch

    from distributedmnist_tpu_torch import models
    from distributedmnist_tpu_torch.bench import _drain_or_die
    from distributedmnist_tpu_torch.config import Config
    from distributedmnist_tpu_torch.ops import fused
    from distributedmnist_tpu_torch.data import synthetic_mnist
    from distributedmnist_tpu_torch.serve import (PARITY_GATES,
                                                  DynamicBatcher,
                                                  InferenceEngine,
                                                  ServeMetrics,
                                                  build_serving)
    from distributedmnist_tpu_torch.serve.__main__ import selftest
    from distributedmnist_tpu_torch.serve.quantize import PARITY_SEED
    from distributedmnist_tpu_torch.utils import logit_parity, parity_check

    cfg = Config(model="mlp", device="cuda", seed=SEED,
                 serve_queue_depth=SELFTEST_QUEUE_DEPTH)
    metrics = ServeMetrics()
    registry, router, factory = build_serving(cfg)
    batcher = DynamicBatcher(router, max_batch=cfg.serve_max_batch,
                             max_wait_us=cfg.serve_max_wait_us,
                             queue_depth=cfg.serve_queue_depth,
                             metrics=metrics).start()
    phases = {}
    try:
        t0 = time.perf_counter()
        boot = registry.bootstrap(seed=SEED)
        before = dict(fused.LAUNCHES)
        summary = selftest(batcher, metrics, 256, factory.max_batch)
        if summary["rejected_at_submit"] or summary["requests"] != 256:
            raise RuntimeError(f"selftest incomplete: {summary}")
        phases["float32"] = {
            "batches": summary["batches"],
            "launches": {k: fused.LAUNCHES[k] - before[k]
                         for k in before},
            "latency_ms": summary["latency_ms"],
            "warmup_builds": boot.warmup_builds}
        print(f"selftest float32: {summary['requests']} requests, "
              f"{summary['batches']} batches, latency_ms "
              f"{summary['latency_ms']}, boot {time.perf_counter() - t0:.2f}s",
              flush=True)

        # the float32 engine on the card against the CPU model
        fitted = registry.add(params, version="fitted")
        registry.promote("fitted")
        net = models.build("mlp", device="cpu")
        net.load_state_dict(params)
        # held-out images of the distribution the weights were fit on
        burst = synthetic_mnist(seed=PARITY_SEED, train_n=16,
                                test_n=64)["test_x"].reshape(64, 784)
        with torch.no_grad():
            cpu_ref = net(torch.from_numpy(burst).float() / 255.0).numpy()
        got = fitted.engine.infer(burst[:8])
        np.testing.assert_allclose(got, cpu_ref[:8], rtol=1e-4, atol=1e-4)

        for dt in ("bfloat16", "int8", "megakernel"):
            vi = registry.add_variant("fitted", dt)
            registry.promote("fitted", infer_dtype=dt)
            metrics.reset()
            before = dict(fused.LAUNCHES)
            futs = [batcher.submit(burst[i:i + 4]) for i in range(0, 64, 4)]
            out = np.concatenate([f.result(timeout=120) for f in futs])
            # futures resolve before their batch's metrics land: drain,
            # so `batches` counts every batch of the burst
            _drain_or_die(batcher, timeout=120)
            snap = metrics.snapshot()
            if out.shape != (64, 10) or not np.all(np.isfinite(out)):
                raise RuntimeError(f"{dt}: bad logits {out.shape}")
            # the same variant through its plain versions on the CPU
            plain = InferenceEngine("mlp", params, device="cpu",
                                    max_batch=64, infer_dtype=dt)
            rep = parity_check(plain.infer(burst), out, *PARITY_GATES[dt])
            if not rep["passed"]:
                raise RuntimeError(f"{dt} on the card vs its plain "
                                   f"version: {rep['why']}")
            phases[dt] = {
                "batches": snap["batches"],
                "launches": {k: fused.LAUNCHES[k] - before[k]
                             for k in before},
                "gate": {k: vi.parity[k] for k in
                         ("argmax_agreement", "max_rel_logit_diff")},
                "burst_vs_plain": {k: rep[k] for k in
                                   ("argmax_agreement",
                                    "max_abs_logit_diff")},
                "burst_vs_f32": {k: v for k, v in logit_parity(
                    cpu_ref, out).items()
                    if k in ("argmax_agreement", "max_rel_logit_diff")},
                "latency_ms": snap["latency_ms"]}
            print(f"variant {dt}: gate {phases[dt]['gate']}, burst "
                  f"{snap['requests']} requests in {snap['batches']} "
                  f"batches, vs plain {phases[dt]['burst_vs_plain']}, vs "
                  f"f32 {phases[dt]['burst_vs_f32']}",
                  flush=True)
    finally:
        batcher.stop()
    return phases


def drive_lenet_serving_path(checkpoint_dir: str, lenet_data) -> dict:
    """LeNet serving through the port's entry points, on the card, booted
    from the checkpoint config 2's training committed."""
    import numpy as np
    import torch

    from distributedmnist_tpu_torch import checkpoint, trainer
    from distributedmnist_tpu_torch.config import Config
    from distributedmnist_tpu_torch.data import synthetic_mnist
    from distributedmnist_tpu_torch.ops import fused
    from distributedmnist_tpu_torch.serve import (PARITY_GATES,
                                                  DynamicBatcher,
                                                  InferenceEngine,
                                                  ServeMetrics,
                                                  build_serving)
    from distributedmnist_tpu_torch.serve.__main__ import selftest
    from distributedmnist_tpu_torch.serve.quantize import PARITY_SEED
    from distributedmnist_tpu_torch.utils import logit_parity, parity_check

    # the engine must turn TF32 off itself: the float32 engine is the
    # reference of both parity gates
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    cfg = Config(model="lenet", device="cuda", seed=SEED,
                 checkpoint_dir=checkpoint_dir,
                 serve_queue_depth=SELFTEST_QUEUE_DEPTH)
    metrics = ServeMetrics()
    registry, router, factory = build_serving(cfg)
    batcher = DynamicBatcher(router, max_batch=cfg.serve_max_batch,
                             max_wait_us=cfg.serve_max_wait_us,
                             queue_depth=cfg.serve_queue_depth,
                             metrics=metrics).start()
    phases = {}
    try:
        t0 = time.perf_counter()
        first = registry.bootstrap()
        boot_s = time.perf_counter() - t0
        if (first.source != f"checkpoint {checkpoint_dir}"
                or first.step != TRAIN_STEPS["lenet-adam"]
                or registry.live_version() != first.version):
            raise RuntimeError(f"bootstrap did not serve config 2's last "
                               f"checkpoint: {first.describe()}")
        if (torch.backends.cudnn.allow_tf32
                or torch.backends.cuda.matmul.allow_tf32):
            raise RuntimeError("the serving engine left TF32 on")
        params, _ = checkpoint.restore_latest_params(checkpoint_dir,
                                                     step=first.step)

        # the float32 engine on the card against the CPU's, every bucket,
        # on held-out images of the distribution the weights were fit on
        held = synthetic_mnist(seed=PARITY_SEED, train_n=16,
                               test_n=factory.max_batch)["test_x"]
        cpu = InferenceEngine("lenet", params, device="cpu",
                              max_batch=factory.max_batch)
        worst = 0.0
        for b in factory.buckets:
            got, want = first.engine.infer(held[:b]), cpu.infer(held[:b])
            scale = max(1.0, float(np.abs(want).max()))
            worst = max(worst, float(np.abs(got - want).max()) / scale)
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=LENET_F32_TOL * scale)
        phases["f32_vs_cpu"] = {"buckets": list(factory.buckets),
                                "max_abs_err_over_scale": worst,
                                "tol": LENET_F32_TOL, "boot_s": boot_s}
        print(f"lenet float32 on the card vs the CPU: max |err| / scale "
              f"{worst:.3g} over buckets {list(factory.buckets)}, boot "
              f"{boot_s:.2f}s", flush=True)

        burst = held[:64]
        for dt in ("float32", "bfloat16", "int8"):
            rec = {}
            if dt != "float32":
                # a refusal raises ParityRefused and fails the run
                registry.activate_infer_dtype(first.version, dt)
                vi = registry.get(first.version).variants[dt]
                rec["gate"] = {k: vi.parity[k] for k in
                               ("argmax_agreement", "max_rel_logit_diff")}
            if router.live_infer_dtype() != dt:
                raise RuntimeError(f"{dt} is not live: "
                                   f"{router.live_infer_dtype()}")
            # two bursts: the first meets a new engine's staging pool
            # empty (pinned buffers allocated), the second finds it warm
            before = dict(fused.LAUNCHES)
            for burst_name in ("cold", "warm"):
                metrics.reset()
                summary = selftest(batcher, metrics, SELFTEST_REQUESTS,
                                   factory.max_batch)
                if (summary["rejected_at_submit"]
                        or summary["requests"] != SELFTEST_REQUESTS):
                    raise RuntimeError(f"lenet {dt} selftest incomplete: "
                                       f"{summary}")
                rec[burst_name] = {k: summary[k] for k in (
                    "requests", "batches", "requests_per_sec",
                    "rows_per_sec", "latency_ms", "staging_ms")}
            rec["launches"] = {k: fused.LAUNCHES[k] - before[k]
                               for k in before}
            futs = [batcher.submit(burst[i:i + 4])
                    for i in range(0, 64, 4)]
            out = np.concatenate([f.result(timeout=120) for f in futs])
            if out.shape != (64, 10) or not np.all(np.isfinite(out)):
                raise RuntimeError(f"lenet {dt}: bad logits {out.shape}")
            if dt != "float32":
                plain = InferenceEngine("lenet", params, device="cpu",
                                        max_batch=64, infer_dtype=dt)
                rep = parity_check(plain.infer(burst), out,
                                   *PARITY_GATES[dt])
                if not rep["passed"]:
                    raise RuntimeError(f"lenet {dt} on the card vs its "
                                       f"plain version: {rep['why']}")
                rec["burst_vs_plain"] = {k: rep[k] for k in (
                    "argmax_agreement", "max_abs_logit_diff")}
                rec["burst_vs_f32"] = {
                    k: v for k, v in logit_parity(cpu.infer(burst),
                                                  out).items()
                    if k in ("argmax_agreement", "max_rel_logit_diff")}
            phases[dt] = rec
            print(f"lenet {dt}: " + json.dumps(rec), flush=True)

        # the lifecycle: training goes on and commits a later step (LeNet
        # training launches none of the serving kernels, only
        # conv_wgrad_1ch), the registry loads and promotes it, then rolls
        # back from it
        more = lenet_recipe(checkpoint_dir).replace(
            steps=TRAIN_STEPS["lenet-adam"] + LIFECYCLE_STEPS)
        trained = trainer.fit(more, data=lenet_data)
        second = registry.load_latest()
        if second.step != more.steps or second.version == first.version:
            raise RuntimeError(f"load_latest did not load step "
                               f"{more.steps}: {second.describe()}")
        registry.promote(second.version)
        if registry.live_version() != second.version:
            raise RuntimeError(f"{second.version} is not live")
        back = registry.rollback(second.version, "chip_smoke rollback")
        event = registry.events()[-1]
        if (back is None or back.version != first.version
                or registry.live_version() != first.version
                or router.live_infer_dtype() != "float32"
                or event["event"] != "rollback"
                or (event["from"], event["to"]) != (second.version,
                                                   first.version)):
            raise RuntimeError(f"rollback did not restore {first.version}: "
                               f"{registry.describe()}")
        check = first.engine.infer(burst[:8])
        np.testing.assert_allclose(check, cpu.infer(burst[:8]), rtol=0,
                                   atol=LENET_F32_TOL * max(
                                       1.0, float(np.abs(check).max())))
        phases["lifecycle"] = {
            "first": first.version, "second": second.version,
            "resumed_training_accuracy": trained["test_accuracy"],
            "live_after_rollback": registry.live_version(),
            "event": event,
            "versions": {v["version"]: v["state"]
                         for v in registry.describe()["versions"]}}
        print("lenet lifecycle: " + json.dumps(phases["lifecycle"]),
              flush=True)
    finally:
        batcher.stop()
    return phases


def start_server(args, env, cwd):
    """`python -m distributedmnist_tpu_torch.serve --port 0` with the given
    flags on the card, read until its serve_ready line."""
    from distributedmnist_tpu_torch.serve.process import ServerProcess

    return ServerProcess(
        [sys.executable, "-m", "distributedmnist_tpu_torch.serve",
         "--port", "0", "--metrics-every", "5", *args],
        env=env, cwd=cwd, ready_timeout=HTTP_READY_S, popen=CHILDREN.popen)


def healthy(srv) -> dict:
    return srv.wait_for("/healthz 200", srv.healthy_payload,
                        timeout=HTTP_READY_S)


def timed_predicts(srv, images) -> dict:
    """Sequential 1-row /predict calls, one per image, on the client's
    clock: first a new connection a call (urllib), with the server's own
    enqueue-to-result latency of those calls from /metrics; then the same
    calls on one keep-alive connection, and as many /healthz calls on it
    (HTTP without inference). p50/p99/mean ms each."""
    import http.client

    import numpy as np

    def stats(lat):
        return {"p50_ms": float(np.percentile(lat, 50)),
                "p99_ms": float(np.percentile(lat, 99)),
                "mean_ms": float(np.mean(lat))}

    def timed(fn):
        lat = []
        for row in images:
            t0 = time.perf_counter()
            fn(np.ascontiguousarray(row).tobytes())
            lat.append((time.perf_counter() - t0) * 1e3)
        return stats(lat)

    rec = {"calls": len(images),
           **timed(lambda body: srv.ok("/predict", data=body))}
    rec["server_latency_ms"] = srv.ok("/metrics")["latency_ms"]
    conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=120)

    def keepalive(method, path, body=None):
        conn.request(method, path, body=body)
        r = conn.getresponse()
        r.read()
        if r.status != 200:
            raise RuntimeError(f"{method} {path}: {r.status}")

    try:
        rec["keepalive"] = timed(
            lambda body: keepalive("POST", "/predict", body))
        rec["healthz_keepalive"] = timed(
            lambda body: keepalive("GET", "/healthz"))
    finally:
        conn.close()
    return rec


def stop_server(srv) -> tuple[dict, dict]:
    """SIGTERM: (the serve_summary record, the launch counts it reported);
    raises unless it exits 0 with both."""
    done = srv.stop()
    summaries = [r for r in done.records
                 if r.get("metric") == "serve_summary"]
    if done.rc != 0 or len(summaries) != 1 or len(done.launches) != 1:
        raise RuntimeError(f"server exited {done.rc} with {len(summaries)} "
                           f"summaries and {len(done.launches)} launch "
                           f"lines:\n{done.stderr}")
    return summaries[0], done.launches[0]


def print_latency(name: str, rec: dict, card: str) -> None:
    def ms(r):
        return f"p50 {r['p50_ms']:.3f} ms p99 {r['p99_ms']:.3f} ms"

    print(f"http {name}: {rec['calls']} sequential 1-row /predict {ms(rec)} "
          f"(in the server {rec['server_latency_ms']['p50']} / "
          f"{rec['server_latency_ms']['p99']} ms; one keep-alive "
          f"connection {ms(rec['keepalive'])}, /healthz on it "
          f"{ms(rec['healthz_keepalive'])}) on {card}", flush=True)


def drive_http_path(params: dict, lenet_checkpoint_dir: str,
                    card: str) -> tuple[dict, dict]:
    """The port's HTTP server on the card, one subprocess a server: the
    MLP at megakernel (canary, shadow, SIGHUP) and LeNet-5 at int8.
    Returns (phases, {path: launch counts of that server})."""
    import shutil
    import signal

    import numpy as np
    import torch

    from distributedmnist_tpu_torch import models
    from distributedmnist_tpu_torch.checkpoint import Checkpointer
    from distributedmnist_tpu_torch.data import synthetic_mnist
    from distributedmnist_tpu_torch.serve import PARITY_GATES, InferenceEngine
    from distributedmnist_tpu_torch.serve.quantize import PARITY_SEED

    here = os.path.dirname(os.path.abspath(__file__))
    env = _child_env()
    held = synthetic_mnist(seed=PARITY_SEED, train_n=16,
                           test_n=HTTP_CHECK_ROWS)["test_x"]
    rows = held.reshape(HTTP_CHECK_ROWS, 784)
    phases, launches = {}, {}

    def agreement(classes, want) -> float:
        return float(np.mean(np.asarray(classes) == want))

    with tempfile.TemporaryDirectory() as ckpt:
        def commit(step):
            ck = Checkpointer(ckpt)
            ck.save(step, {"params": params, "optimizer": {},
                           "scheduler": {}})
            ck.close()

        commit(1)
        net = models.build("mlp", device="cpu")
        net.load_state_dict(params)
        with torch.no_grad():
            want = net(torch.from_numpy(rows).float() / 255.0).argmax(
                -1).numpy()
        srv = start_server(["--model", "mlp", "--checkpoint-dir", ckpt,
                             "--serve-infer-dtype", "megakernel"], env, here)
        try:
            t0 = time.perf_counter()
            health = healthy(srv)
            rec = {"ready_s": time.perf_counter() - t0}
            if (health["live_version"] != "step-1"
                    or health["live_infer_dtype"] != "megakernel"
                    or health["backend"] != "cuda"
                    or health["device_kind"] != torch.cuda.get_device_name(0)):
                raise RuntimeError(f"MLP server healthz: {health}")
            rec["predict_1row"] = timed_predicts(srv, rows[:HTTP_TIMED_CALLS])
            print_latency("mlp megakernel", rec["predict_1row"], card)
            got = srv.ok("/predict", data=rows.tobytes())
            agree = agreement(got["classes"], want)
            if (got["n"] != HTTP_CHECK_ROWS or got["version"] != "step-1"
                    or agree < PARITY_GATES["megakernel"][0]):
                raise RuntimeError(f"512-row /predict: n {got['n']}, "
                                   f"version {got['version']}, agreement "
                                   f"{agree} with the CPU float32 model")
            rec["agreement_512"] = agree

            canary = srv.ok("/models/load", json_body={"fresh": {"seed": 1}})
            shadow = srv.ok("/models/load", json_body={"fresh": {"seed": 2}})
            srv.ok("/models/promote", json_body={
                "version": canary["version"], "mode": "canary",
                "fraction": 0.25})
            routes = srv.ok("/models/promote", json_body={
                "version": shadow["version"], "mode": "shadow",
                "fraction": 0.5})
            for row in rows[:100]:
                srv.ok("/predict", data=np.ascontiguousarray(row).tobytes())
            pair = f"step-1->{shadow['version']}"
            m = srv.wait_for("the shadow comparisons", lambda: (
                lambda m: m if m["shadow"].get(pair, {}).get("rows")
                else None)(srv.ok("/metrics")))
            by_v = m["by_version"]
            if not (by_v.get("step-1", {}).get("requests")
                    and by_v.get(canary["version"], {}).get("requests")):
                raise RuntimeError(f"by_version lacks a population: {by_v}")
            rec["canary_shadow"] = {
                "routes": {k: routes[k] for k in ("live", "canary",
                                                  "shadow")},
                "by_version_requests": {v: s["requests"]
                                        for v, s in by_v.items()},
                "shadow": m["shadow"], "shadow_dropped": m["shadow_dropped"],
                "shadow_errors": m["shadow_errors"],
                "compiles_total": m["compiles_total"]}

            commit(2)
            srv.proc.send_signal(signal.SIGHUP)
            t0 = time.perf_counter()
            srv.wait_for("SIGHUP's step-2 at megakernel", lambda: (
                lambda d: d["routes"]["live"] == "step-2"
                and d["live_infer_dtype"] == "megakernel")(
                    srv.ok("/models")))
            rec["sighup_s"] = time.perf_counter() - t0
            got = srv.ok("/predict", data=rows[:8].tobytes())
            if got["version"] not in ("step-2", canary["version"]):
                raise RuntimeError(f"after SIGHUP: {got}")
        finally:
            summary, counts = stop_server(srv)
        rec["summary_requests"] = summary["requests"]
        rec["launches"] = counts
        phases["mlp"] = rec
        launches["http_mlp"] = counts
        print("http mlp: " + json.dumps(rec), flush=True)
        if counts["dense_relu"] <= 0 or counts["mlp_megakernel"] <= 0:
            raise RuntimeError(f"the MLP server did not launch dense_relu "
                               f"and mlp_megakernel: {counts}")

    with tempfile.TemporaryDirectory() as ckpt:
        step = str(TRAIN_STEPS["lenet-adam"])
        shutil.copytree(os.path.join(lenet_checkpoint_dir, step),
                        os.path.join(ckpt, step))
        from distributedmnist_tpu_torch import checkpoint

        lenet_params, _ = checkpoint.restore_latest_params(ckpt)
        want = InferenceEngine("lenet", lenet_params, device="cpu",
                               max_batch=HTTP_CHECK_ROWS).infer(
            held).argmax(-1)
        srv = start_server(["--model", "lenet", "--checkpoint-dir", ckpt,
                             "--serve-infer-dtype", "int8"], env, here)
        try:
            t0 = time.perf_counter()
            health = healthy(srv)
            rec = {"ready_s": time.perf_counter() - t0}
            if (health["live_version"] != f"step-{step}"
                    or health["live_infer_dtype"] != "int8"):
                raise RuntimeError(f"LeNet server healthz: {health}")
            rec["predict_1row"] = timed_predicts(srv, rows[:HTTP_TIMED_CALLS])
            print_latency("lenet int8", rec["predict_1row"], card)
            got = srv.ok("/predict", data=rows.tobytes())
            agree = agreement(got["classes"], want)
            if agree < PARITY_GATES["int8"][0]:
                raise RuntimeError(f"LeNet int8 512-row /predict agrees "
                                   f"{agree} with the CPU float32 engine")
            rec["agreement_512"] = agree
        finally:
            summary, counts = stop_server(srv)
        rec["summary_requests"] = summary["requests"]
        rec["launches"] = counts
        phases["lenet"] = rec
        launches["http_lenet"] = counts
        print("http lenet: " + json.dumps(rec), flush=True)
        if counts["quant_dense"] <= 0:
            raise RuntimeError(f"the LeNet server did not launch "
                               f"quant_dense: {counts}")
    return phases, launches


def _bench_record(run, rc: int, out: str, err: str, card: str) -> dict:
    """The one record of a bench run that exited `rc`, held to the root
    bench's keys, a value above 0, the card and, for time-to-accuracy,
    the target reached."""
    if rc != 0:
        raise RuntimeError(f"bench {' '.join(run)} exited {rc}:\n"
                           f"{err[-4000:]}")
    lines = [ln for ln in out.splitlines() if ln.startswith("{")]
    if len(lines) != 1:
        raise RuntimeError(f"bench {' '.join(run)} printed "
                           f"{len(lines)} JSON lines, not 1")
    rec = json.loads(lines[0])
    want = BENCH_KEYS.get(rec.get("metric"))
    detail = rec.get("detail", {})
    bad = []
    if set(rec) != {"metric", "value", "unit", "vs_baseline",
                    "detail"} or set(detail) != want:
        bad.append("keys differ from the root bench's")
    if not rec["value"] > 0 or rec["vs_baseline"] is not None:
        bad.append(f"value {rec['value']}, vs_baseline "
                   f"{rec['vs_baseline']}")
    if detail.get("backend") != "cuda":
        bad.append(f"backend {detail.get('backend')}")
    if rec["metric"] == "serve_images_per_sec_per_chip":
        if detail["recompiles_after_warmup"] != 0:
            bad.append(f"{detail['recompiles_after_warmup']} "
                       "builds after warmup")
        if detail["host"]["device_kind"] != card:
            bad.append(f"device_kind {detail['host']['device_kind']}")
    if (rec["metric"] == "wall_clock_to_target_accuracy"
            and not detail["reached_target"]):
        bad.append("the trial did not reach its target")
    if bad:
        raise RuntimeError(f"bench {' '.join(run)}: {bad}: "
                           f"{lines[0][:2000]}")
    return rec


def drive_bench_path(lenet_checkpoint_dir: str) -> dict:
    """The port's bench, one subprocess a run (each mode in a process of
    its own, so no mode's TF32 or allocator state leaks into the next).
    Returns the kernel launches the runs report, summed."""
    import shutil

    import torch

    from distributedmnist_tpu_torch.ops import fused

    here = os.path.dirname(os.path.abspath(__file__))
    env = _child_env()
    card = torch.cuda.get_device_name(0)
    launches: dict = {}
    with tempfile.TemporaryDirectory() as ckpt:
        step = str(TRAIN_STEPS["lenet-adam"])
        shutil.copytree(os.path.join(lenet_checkpoint_dir, step),
                        os.path.join(ckpt, step))
        for run in BENCH_RUNS:
            argv = [a.format(ckpt=ckpt) for a in run]
            t0 = time.perf_counter()
            proc = CHILDREN.run(
                [sys.executable, "-m", "distributedmnist_tpu_torch.bench",
                 *argv], cwd=here, env=env, capture_output=True, text=True,
                timeout=BENCH_TIMEOUT_S)
            took = time.perf_counter() - t0
            rec = _bench_record(run, proc.returncode, proc.stdout,
                                proc.stderr, card)
            counts = fused.parse_launches(proc.stderr, "bench: launches ")
            if len(counts) != 1:
                raise RuntimeError(f"bench {' '.join(run)} reported no "
                                   "launch counts")
            for k, n in counts[0].items():
                launches[k] = launches.get(k, 0) + n
            print(f"bench {' '.join(run[:3])}: {rec['metric']} "
                  f"{rec['value']} {rec['unit']} in {took:.1f}s, launches "
                  f"{counts[0]}", flush=True)
            print("bench " + json.dumps(rec), flush=True)
    return launches


def drive_bench_ranks_path(card: str) -> dict:
    """The bench's training modes over BENCH_RANKS ranks (BENCH_RANK_RUNS,
    both runs at once, each bench process starting its ranks): each run
    one record (rank 0's) with the root bench's keys, n_chips the cards
    the ranks run on (one, counted once, when they share it), the
    backend the topology calls for, and a launch line from every rank,
    dense_relu launched in every rank of the MLP run. Prints each run's
    seconds and record; returns the kernel launches the ranks report,
    summed."""
    import torch

    from distributedmnist_tpu_torch.ops import fused

    chips = min(BENCH_RANKS, torch.cuda.device_count())
    backend = "nccl" if chips == BENCH_RANKS else "gloo"
    results = _run_timed([["-m", "distributedmnist_tpu_torch.bench", *run]
                          for run in BENCH_RANK_RUNS], BENCH_TIMEOUT_S)
    launches: dict = {}
    for run, (rc, out, err, took) in zip(BENCH_RANK_RUNS, results):
        rec = _bench_record(run, rc, out, err, card)
        bad = []
        if rec["detail"]["n_chips"] != chips:
            bad.append(f"n_chips {rec['detail']['n_chips']}, not {chips}")
        up = (f"bench: backend up: {BENCH_RANKS}x cuda on {chips} chip(s) "
              f"over {backend}")
        by_rank = [fused.parse_launches(err, f"[rank {r}] bench: launches ")
                   for r in range(BENCH_RANKS)]
        for r, counts in enumerate(by_rank):
            if f"[rank {r}] {up}" not in err:
                bad.append(f"rank {r} did not come up as {up!r}")
            if len(counts) != 1:
                bad.append(f"rank {r} reported {len(counts)} launch lines")
            elif run[2] == "mlp" and counts[0]["dense_relu"] <= 0:
                bad.append(f"rank {r} never launched dense_relu")
        if bad:
            raise RuntimeError(f"bench {' '.join(run)}: {bad}:\n"
                               f"{err[-3000:]}")
        for counts in by_rank:
            for k, n in counts[0].items():
                launches[k] = launches.get(k, 0) + n
        print(f"bench ranks {' '.join(run[:3])}: {rec['metric']} "
              f"{rec['value']} {rec['unit']}, {BENCH_RANKS} ranks on "
              f"{chips} card(s) over {backend}, ended {took:.1f}s after "
              f"both runs started, launches by rank "
              f"{[c[0] for c in by_rank]} on {card}", flush=True)
        print("bench " + json.dumps(rec), flush=True)
    return launches


def _fast_engines(params: dict, lenet_params: dict, device: str):
    """(label, engine) for every serving engine the fast lane can reach:
    the MLP at float32, bfloat16, int8 and megakernel, LeNet-5 at
    float32, bfloat16 and int8, on the ladder REQUEST_MAX_BATCH gives
    (its smallest rung 1: the exact-fit route), each warmed."""
    from distributedmnist_tpu_torch.serve import InferenceEngine

    out = []
    for model, p, dtypes in (
            ("mlp", params, ("float32", "bfloat16", "int8", "megakernel")),
            ("lenet", lenet_params, ("float32", "bfloat16", "int8"))):
        for dt in dtypes:
            eng = InferenceEngine(model, p, device=device,
                                  max_batch=REQUEST_MAX_BATCH,
                                  version=f"{model}-{dt}", infer_dtype=dt)
            eng.warmup(cost_samples=3)
            out.append((f"{model} {dt}", eng))
    return out


def drive_fastlane(params: dict, lenet_params: dict, mlp_rows,
                   lenet_rows) -> tuple[dict, dict]:
    """The fast lane on the card, engine by engine: FASTLANE_ROWS 1-row
    requests through dispatch_fast (the exact-fit route) and through a
    DynamicBatcher with the lane on, each held bit for bit against the
    same engine's pooled dispatch at bucket 1, and the batch against the
    same engine on the CPU (the kernels' plain versions) at the parity
    gate's thresholds. Launches are counted over the fast-route calls
    only (the pooled and CPU references run before the counts are set
    to 0). Then the row-staged route on a ladder whose smallest rung is
    8: priced at warmup against the pooled dispatch, held on a dirty
    resident buffer (turned on for the check if warmup turned it off);
    and exact fit against the pooled dispatch and against staging
    through a pinned tensor at b = 1, dispatch and fetch on the host's
    clock, in turns. Returns (phases, launch counts)."""
    import numpy as np
    import torch

    from distributedmnist_tpu_torch.ops import fused
    from distributedmnist_tpu_torch.serve import (PARITY_GATES,
                                                  DynamicBatcher,
                                                  InferenceEngine)
    from distributedmnist_tpu_torch.utils import parity_check

    gates = {**PARITY_GATES, "float32": (1.0, 1e-4)}
    card = _fast_engines(params, lenet_params, "cuda")
    cpu = dict(_fast_engines(params, lenet_params, "cpu"))
    rows = {"mlp": mlp_rows[:FASTLANE_ROWS], "lenet": lenet_rows[:FASTLANE_ROWS]}
    pooled, plain = {}, {}
    for label, eng in card:
        x = rows[label.split()[0]]
        pooled[label] = np.stack([eng.infer(x[i:i + 1])[0]
                                  for i in range(len(x))])
        plain[label] = cpu[label].infer(x)
    fused.reset_launches()
    phases = {}
    for label, eng in card:
        x = rows[label.split()[0]]
        fast = []
        for i in range(len(x)):
            h = eng.dispatch_fast(x[i:i + 1])
            if h is None or not h.resident:
                raise RuntimeError(f"{label}: dispatch_fast declined a "
                                   "1-row request on a ladder from 1")
            fast.append(eng.fetch(h)[0])
        b = DynamicBatcher(eng, fastlane=True, max_inflight=4).start()
        try:
            lane = np.stack([b.submit(x[i:i + 1]).result(timeout=60)[0]
                             for i in range(len(x))])
        finally:
            b.stop()
        fast = np.stack(fast)
        if not (np.array_equal(fast, pooled[label])
                and np.array_equal(lane, pooled[label])):
            raise RuntimeError(
                f"{label}: fast-lane logits differ from the pooled "
                f"dispatch at bucket 1 (max "
                f"{float(np.abs(fast - pooled[label]).max())})")
        agree, rel = gates[label.split()[1]]
        par = parity_check(plain[label], fast, min_agreement=agree,
                           max_rel_diff=rel)
        if not par["passed"]:
            raise RuntimeError(f"{label}: fast lane against the CPU's "
                               f"plain versions: {par['why']}")
        phases[label] = {"bit_equal_pooled_b1": True,
                         "max_rel_logit_diff_vs_cpu":
                             par["max_rel_logit_diff"]}
    counts = dict(fused.LAUNCHES)
    print("fastlane launches " + json.dumps(counts), flush=True)
    missing = [k for k in SERVING_KERNELS if counts[k] <= 0]
    if missing:
        raise RuntimeError(f"kernels never launched on the fast route: "
                           f"{missing}")

    # the row-staged route, priced and held on a dirty resident buffer
    eng = InferenceEngine("mlp", params, device="cuda", max_batch=32,
                          buckets=(8, 16, 32), version="row")
    eng.warmup(cost_samples=10)
    x = mlp_rows[:1]
    want = eng.infer(x)
    eng._fast_row_buf[1:] = torch.randint(
        0, 256, eng._fast_row_buf[1:].shape, dtype=torch.uint8,
        device="cuda")
    enabled = eng._fast_row_ok
    eng._fast_row_ok = True       # held whichever way warmup priced it
    h = eng.dispatch_fast(x)
    if h is None or not np.array_equal(eng.fetch(h), want):
        raise RuntimeError("row-staged route on a dirty buffer differs "
                           "from the pooled dispatch")
    phases["row_route"] = {
        "bucket": 8, "row_ms": eng.fast_row_cost() * 1e3,
        "pooled_ms": eng.bucket_costs()[8] * 1e3,
        "enabled": enabled, "dirty_buffer_equal": True}

    # exact fit against the pooled dispatch at b = 1, dispatch + fetch on
    # the host's clock, in turns
    eng = card[0][1]
    x = mlp_rows[:1]
    out = torch.empty((1, 10), dtype=torch.float32, pin_memory=True)

    def pinned():
        # the exact fit's other design: staging through a pinned tensor
        # of torch's caching host allocator (timed here only)
        host = torch.empty(x.shape, dtype=torch.uint8, pin_memory=True)
        host.numpy()[:] = x
        with torch.inference_mode():
            eng._launch(host.to("cuda", non_blocking=True),
                        out).synchronize()
        return out.numpy()[:1].copy()

    times = {"exact_fit": [], "pooled": [], "exact_fit_pinned": []}
    for _ in range(FASTLANE_TIMED):
        for route, fn in (
                ("exact_fit", lambda: eng.fetch(eng.dispatch_fast(x))),
                ("pooled", lambda: eng.fetch(eng.dispatch([x]))),
                ("exact_fit_pinned", pinned)):
            t0 = time.perf_counter()
            fn()
            times[route].append((time.perf_counter() - t0) * 1e3)
    phases["b1_staging_ms"] = {
        r: {"p50": float(np.percentile(t, 50)),
            "p99": float(np.percentile(t, 99))} for r, t in times.items()}
    print("fastlane " + json.dumps(phases), flush=True)
    return phases, counts


def drive_request_bench() -> tuple[dict, dict]:
    """`bench serve --lowlat --zipf --chaos --trace` on the MLP, one
    subprocess: the records carry the root bench's leg keys, the chaos
    ledger is exact (every request failed by the injected dispatch fault
    is one the injector poisoned), the breaker trips and rolls back once,
    and no leg builds anything after warmup. Returns (the legs' figures,
    the run's launch counts)."""
    from distributedmnist_tpu_torch.ops import fused

    here = os.path.dirname(os.path.abspath(__file__))
    env = _child_env()
    argv = ["serve", "--model", "mlp", "--serve-duration", "0.5",
            "--serve-qps", "200", "--serve-clients", "8", "--lowlat",
            "--zipf", "--chaos", "--trace", "--inline", "--no-artifact"]
    t0 = time.perf_counter()
    proc = CHILDREN.run(
        [sys.executable, "-m", "distributedmnist_tpu_torch.bench", *argv],
        cwd=here, env=env, capture_output=True, text=True,
        timeout=BENCH_TIMEOUT_S)
    took = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"bench {' '.join(argv)} exited "
                           f"{proc.returncode}:\n{proc.stderr[-4000:]}")
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    rec = json.loads(lines[-1])
    d = rec["detail"]
    bad = []
    if set(d) != BENCH_KEYS["serve_images_per_sec_per_chip"]:
        bad.append("keys differ from the root bench's")
    for leg, keys in REQUEST_LEG_KEYS.items():
        if set(d[leg] or {}) != keys:
            bad.append(f"{leg} keys differ from the root bench's")
    chaos = d["chaos"]
    if not chaos["poison_isolated_exact"]:
        bad.append("the chaos poison ledger is not exact")
    if chaos["breaker_trips"] != 1 or chaos["rollbacks"] != 1:
        bad.append(f"breaker trips {chaos['breaker_trips']}, rollbacks "
                   f"{chaos['rollbacks']}")
    if d["recompiles_after_warmup"] != 0:
        bad.append(f"{d['recompiles_after_warmup']} builds after warmup")
    if d["zipf"]["parity_ok"] is not True:
        bad.append("cached bytes differ from computed ones")
    # every lone request of the lowlat leg took the lane, and its window
    # counts each lane dispatch with its request
    lane = d["lowlat"]["fastlane"]
    if d["lowlat"]["fastpath_lane_fraction"] != 1.0:
        bad.append(f"lowlat lane fraction "
                   f"{d['lowlat']['fastpath_lane_fraction']}, not 1.0")
    if lane["fastpath"]["dispatches"] != lane["requests"]:
        bad.append(f"fastlane phase: {lane['fastpath']['dispatches']} lane "
                   f"dispatches for {lane['requests']} requests")
    if bad:
        raise RuntimeError(f"bench {' '.join(argv)}: {bad}: "
                           f"{lines[-1][:3000]}")
    counts = fused.parse_launches(proc.stderr, "bench: launches ")
    low, zipf, tr = d["lowlat"], d["zipf"], d["trace"]
    figures = {
        "took_s": took,
        "lowlat": {k: low[k] for k in (
            "p50_batched_ms", "p50_fastlane_ms", "p50_best_ms",
            "p50_improvement_x", "p50_ok", "p99_ok", "recompiles",
            "fastpath_dispatches", "fastpath_lane_fraction")},
        "lowlat_p99_ms": {
            "batched": low["batched"]["latency_ms"]["p99"],
            "fastlane": low["fastlane"]["latency_ms"]["p99"],
            "megakernel": (low["megakernel"] or {}).get(
                "latency_ms", {}).get("p99")},
        "lowlat_attribution": low["attribution"],
        "zipf": {k: zipf[k] for k in (
            "hit_ratio", "hit_ratio_ok", "goodput_x", "goodput_ok",
            "device_dispatches_off", "device_dispatches_on",
            "single_flight_collapsed")},
        "zipf_rows_per_sec": {"off": zipf["cache_off"]["rows_per_sec"],
                              "on": zipf["cache_on"]["rows_per_sec"]},
        "trace": {k: tr[k] for k in (
            "over_slo_requests", "min_attributed_frac", "attribution_ok",
            "open_spans_at_drain")},
        "chaos": {k: chaos[k] for k in (
            "requests", "ok", "availability_excluding_injected",
            "availability_ok", "p99_under_faults_ms", "poison_unique",
            "poison_isolated_exact", "bisect_splits",
            "bisect_rescued_requests", "breaker_trips", "rollbacks",
            "recompiles_during_chaos", "deadline_shed")},
    }
    print("request bench " + json.dumps(figures), flush=True)
    return figures, counts[0]


def drive_request_http(params: dict, card: str) -> tuple[dict, dict]:
    """The HTTP server with the request path on: the MLP (fitted weights
    from a checkpoint, float32) with --serve-fastlane --serve-cache
    --serve-trace, and the same without the lane, one subprocess each:
    HTTP_TIMED_CALLS sequential 1-row /predict calls of distinct rows
    (no cache hit) timed on each; then, on the lane's server, a repeat
    that must hit the cache, X-Trace-Id on the response and Server-Timing
    on one that asks, GET /trace (Chrome trace events), a timed scrape of
    /metrics?format=prometheus with HELP and TYPE lines, and /metrics with
    real cache, resilience_policy and trace blocks. Returns (phases,
    {path: launch counts})."""
    import urllib.request

    import numpy as np

    from distributedmnist_tpu_torch.checkpoint import Checkpointer
    from distributedmnist_tpu_torch.data import synthetic_mnist

    here = os.path.dirname(os.path.abspath(__file__))
    env = _child_env()
    rows = synthetic_mnist(seed=SEED + 3, train_n=16,
                           test_n=HTTP_TIMED_CALLS)["test_x"].reshape(-1, 784)
    phases, launches = {}, {}
    with tempfile.TemporaryDirectory() as ckpt:
        ck = Checkpointer(ckpt)
        ck.save(1, {"params": params, "optimizer": {}, "scheduler": {}})
        ck.close()
        for tag, lane in (("fastlane", ["--serve-fastlane"]),
                          ("batched", [])):
            srv = start_server(["--model", "mlp", "--checkpoint-dir", ckpt,
                                "--serve-cache", "--serve-trace", *lane],
                               env, here)
            try:
                healthy(srv)
                rec = {"predict_1row": timed_predicts(srv, rows)}
                print_latency(f"mlp request path [{tag}]",
                              rec["predict_1row"], card)
                if tag == "fastlane":
                    # a row no timed call sent: its trace has the
                    # pipeline's stages, not a cache hit's
                    body = np.ascontiguousarray(255 - rows[0]).tobytes()
                    req = urllib.request.Request(
                        srv.base + "/predict", data=body,
                        headers={"X-Server-Timing": "1"})
                    with urllib.request.urlopen(req, timeout=60) as r:
                        hdrs = dict(r.headers)
                    if "X-Trace-Id" not in hdrs or \
                            "Server-Timing" not in hdrs:
                        raise RuntimeError(f"/predict headers: {hdrs}")
                    rec["server_timing"] = hdrs["Server-Timing"]
                    trace = srv.ok("/trace")
                    if not trace["traceEvents"]:
                        raise RuntimeError("GET /trace has no events")
                    rec["trace_events"] = len(trace["traceEvents"])
                    t0 = time.perf_counter()
                    with urllib.request.urlopen(
                            srv.base + "/metrics?format=prometheus",
                            timeout=60) as r:
                        text = r.read().decode()
                    rec["prometheus_scrape_ms"] = (
                        (time.perf_counter() - t0) * 1e3)
                    rec["prometheus_lines"] = len(text.splitlines())
                    for fam in ("dmnist_serve_fastpath_dispatches_total",
                                "dmnist_serve_cache_hits_total",
                                "dmnist_serve_stage_duration_ms"):
                        if f"# HELP {fam} " not in text or \
                                f"# TYPE {fam} " not in text:
                            raise RuntimeError(f"the exposition lacks {fam}")
                    m = srv.ok("/metrics")
                    if (m["cache"] is None or m["trace"] is None
                            or m["resilience_policy"] is None
                            or not m["cache"]["hits"]
                            or not m["fastpath"]["dispatches"]):
                        raise RuntimeError(
                            f"/metrics blocks: cache {m['cache']}, "
                            f"fastpath {m['fastpath']}")
                    rec["cache_hits"] = m["cache"]["hits"]
                    rec["fastpath"] = m["fastpath"]
            finally:
                summary, counts = stop_server(srv)
            rec["launches"] = counts
            phases[tag] = rec
            launches[f"http_request_{tag}"] = counts
            if counts["dense_relu"] <= 0:
                raise RuntimeError(f"the {tag} server did not launch "
                                   f"dense_relu: {counts}")
    print("request http " + json.dumps(phases), flush=True)
    return phases, launches


def _fault_spec(point: str, **fields) -> str:
    """A one-rule fault schedule (serve/faults.py's spec grammar)."""
    return point + ":" + ",".join(f"{k}={v}" for k, v in fields.items())


def _fleet_burst(fleet, reqs, seen: list) -> list:
    """Serve `reqs` through a batcher over `fleet`, appending each batch
    the fleet fetched to `seen` as (replica, the parts, the logits);
    returns the answers in request order."""
    from distributedmnist_tpu_torch.serve import DynamicBatcher

    fetch = fleet.fetch

    def recording_fetch(fh):
        out = fetch(fh)
        seen.append((fh.replica, fh.x, out))
        return out

    fleet.fetch = recording_fetch
    b = DynamicBatcher(fleet, max_wait_us=2000,
                       queue_depth=SELFTEST_QUEUE_DEPTH,
                       metrics=fleet.metrics).start()
    try:
        futs = [b.submit(x) for x in reqs]
        return [f.result(timeout=120) for f in futs]
    finally:
        b.stop()
        del fleet.fetch


def drive_fleet(params: dict) -> tuple[dict, list, object]:
    """A two-replica MLP fleet in process on the card (build_serving with
    serve_replicas 2: both replicas on this card, each engine on its
    replica's own stream), the fitted weights warmed and gated at
    float32, bfloat16, int8 and megakernel on both replicas. Each
    precision serves FLEET_REQUESTS mixed requests through the batcher,
    its dispatches balanced within the root bench's bar; then a kill
    burst on r1 at fetch and at dispatch, which failover must absorb,
    and a latency fault on r0 with the hedge on, which must fire; no
    engine or kernel library is built after warmup. Returns (figures,
    the bursts to check against single routers once the launch counts
    are read, the fleet's engine factory)."""
    import numpy as np

    from distributedmnist_tpu_torch.config import Config
    from distributedmnist_tpu_torch.ops import kernel_lib
    from distributedmnist_tpu_torch.serve import ServeMetrics, build_serving
    from distributedmnist_tpu_torch.serve import faults

    t0 = time.perf_counter()
    metrics = ServeMetrics()
    registry, fleet, factory = build_serving(Config(
        model="mlp", device="cuda", serve_max_batch=FLEET_MAX_BATCH,
        serve_replicas=2), metrics=metrics)
    registry.add(params, version="fit")
    registry.promote("fit")
    for dt in ("bfloat16", "int8", "megakernel"):
        registry.add_variant("fit", dt)        # a refusal fails the run
    engines = registry.get("fit").engines
    streams = [e.stream for e in engines]
    if (None in streams or streams[0].cuda_stream == streams[1].cuda_stream
            or len(set(map(tuple, factory.replica_devices))) != 1):
        raise RuntimeError(f"fleet placement: devices "
                           f"{factory.replica_devices}, streams {streams}")
    figures = {"warm_s": time.perf_counter() - t0}

    def builds():
        return kernel_lib.load_events() + factory.engine_builds

    steady = builds()
    rng = np.random.default_rng(SEED + 11)
    reqs = [rng.integers(0, 256, (int(n), 28, 28, 1), dtype=np.uint8)
            for n in rng.integers(1, FLEET_MAX_ROWS + 1, FLEET_REQUESTS)]
    bursts = []
    for dt in ("float32", "bfloat16", "int8", "megakernel"):
        registry.promote("fit", infer_dtype=dt)
        live = {rep.rid: rep.router._live.engine for rep in fleet.replicas}
        seen: list = []
        t1 = time.perf_counter()
        outs = _fleet_burst(fleet, reqs, seen)
        took = time.perf_counter() - t1
        counts = {rid: sum(1 for r, _, _ in seen if r == rid)
                  for rid in live}
        lo, hi = min(counts.values()), max(counts.values())
        ratio = hi / lo if lo else None
        if ratio is None or ratio > FLEET_BALANCE_BAR:
            raise RuntimeError(f"fleet {dt}: dispatches {counts} not "
                               f"balanced within {FLEET_BALANCE_BAR}")
        bursts.append((dt, live, seen, reqs, outs))
        figures[dt] = {"batches": counts, "balance_ratio": ratio,
                       "s": took,
                       "rows_per_s": sum(x.shape[0] for x in reqs) / took}
    # the kill burst: r1 dies at fetch for 4 of its batches, then at
    # dispatch for 4 more; every request must still be answered
    live = {rep.rid: rep.router._live.engine for rep in fleet.replicas}
    kill = ";".join([
        _fault_spec("replica.fetch", p=1, replica="r1", count=4),
        _fault_spec("replica.dispatch", p=1, replica="r1", after=8,
                    count=4)])
    inj = faults.install(faults.FaultInjector.from_spec(kill, seed=SEED))
    seen = []
    try:
        outs = _fleet_burst(fleet, reqs[:FLEET_FAULT_REQUESTS], seen)
    finally:
        faults.uninstall()
    snap = fleet.snapshot()
    fires = [r["fires"] for r in inj.snapshot()["rules"]]
    if snap["failovers"]["fetch"] < 1 or snap["failovers"]["dispatch"] < 1:
        raise RuntimeError(f"the kill burst was not absorbed by failover: "
                           f"{snap['failovers']}, fires {fires}")
    bursts.append(("kill", live, seen, reqs[:FLEET_FAULT_REQUESTS], outs))
    figures["kill"] = {"fires": fires, "failovers": snap["failovers"],
                       "failures": {r["id"]: r["failures"]
                                    for r in snap["replicas"]}}
    # a slow replica: r0's fetches take FLEET_SLOW_MS more; the batches
    # queued behind them pass the hedge threshold and race a duplicate
    fleet.hedge = True
    slow = _fault_spec("replica.fetch", p=1, replica="r0",
                       latency_ms=FLEET_SLOW_MS)
    faults.install(faults.FaultInjector.from_spec(slow, seed=SEED))
    seen = []
    try:
        outs = _fleet_burst(fleet, reqs[:FLEET_FAULT_REQUESTS], seen)
    finally:
        faults.uninstall()
        fleet.hedge = False
    hedges = fleet.snapshot()["hedges"]
    if hedges["fired"] < 1:
        raise RuntimeError(f"no hedge fired against a {FLEET_SLOW_MS} ms "
                           f"slow replica: {fleet.snapshot()}")
    bursts.append(("hedge", live, seen, reqs[:FLEET_FAULT_REQUESTS], outs))
    figures["hedge"] = hedges
    rebuilt = builds() - steady
    if rebuilt:
        raise RuntimeError(f"{rebuilt} engine or kernel-library builds "
                           "after the fleet's warmup")
    figures["builds_after_warmup"] = rebuilt
    figures["metrics_fleet"] = metrics.snapshot()["fleet"]
    figures["by_replica"] = metrics.snapshot()["by_replica"]
    return figures, bursts, factory


def check_fleet_bursts(factory, bursts) -> int:
    """Every batch a burst recorded, bit for bit a single Router's
    dispatch of the same rows on the engine of the replica that computed
    it, and every answer its request's slice of its batch. Returns the
    batches checked."""
    checked = 0
    for label, live, seen, reqs, outs in bursts:
        singles = {}
        for rid, eng in live.items():
            r = factory.make_router()
            r.set_live(eng, "fit")
            singles[rid] = r
        rows = {}
        for rid, parts, out in seen:
            if singles[rid].infer(parts).tobytes() != out.tobytes():
                raise RuntimeError(f"fleet {label}: a batch of {rid} is "
                                   "not the single router's dispatch")
            off = 0
            for p in parts:
                rows[id(p)] = out[off:off + p.shape[0]]
                off += p.shape[0]
            checked += 1
        for x, got in zip(reqs, outs):
            if got.tobytes() != rows[id(x)].tobytes():
                raise RuntimeError(f"fleet {label}: an answer is not its "
                                   "batch's rows")
    return checked


def drive_cascade(params: dict) -> tuple[dict, list]:
    """The MLP's cascade in process on the card: the fitted weights with
    their int8 and megakernel variants gated, the cascade calibrated on
    the cheapest ('auto'), then CASCADE_ROWS held-out rows through the
    CascadeFront at exact, fast and balanced, at the calibrated threshold
    and again at the median cheap-stage margin (about half the rows
    escalating: the bench's stressed point). Returns (figures, what
    check_cascade holds each pass's answers to)."""
    import numpy as np

    from distributedmnist_tpu_torch.serve.cascade import softmax_margin

    from distributedmnist_tpu_torch.config import Config
    from distributedmnist_tpu_torch.data import synthetic_mnist
    from distributedmnist_tpu_torch.serve import (DynamicBatcher,
                                                  ServeMetrics,
                                                  build_serving)
    from distributedmnist_tpu_torch.serve.cascade import CascadeFront
    from distributedmnist_tpu_torch.serve.quantize import PARITY_SEED

    metrics = ServeMetrics()
    registry, router, _ = build_serving(Config(
        model="mlp", device="cuda", serve_max_batch=CASCADE_ROWS),
        metrics=metrics)
    registry.add(params, version="fit")
    registry.promote("fit")
    for dt in ("int8", "megakernel"):
        registry.add_variant("fit", dt)
    state = registry.enable_cascade("fit")
    x = synthetic_mnist(seed=PARITY_SEED + 1, train_n=16,
                        test_n=CASCADE_ROWS)["test_x"]
    b = DynamicBatcher(router, max_wait_us=500,
                       queue_depth=SELFTEST_QUEUE_DEPTH,
                       metrics=metrics).start()
    front = CascadeFront(b, b, router, registry, metrics=metrics)
    mv = registry.get("fit")
    cheap = mv.variants[state.cheap_dtype].engine
    passes = []
    try:
        threshold = state.threshold
        for _ in range(2):
            got = {c: front.submit(x, accuracy_class=c).result(timeout=120)
                   for c in ("exact", "fast", "balanced")}
            passes.append((mv.engine, cheap, threshold, x, got))
            threshold = float(np.median(softmax_margin(got["fast"])))
            registry.set_cascade_threshold("fit", threshold)
    finally:
        b.stop()
    figures = {"cheap_dtype": state.cheap_dtype,
               "threshold": state.threshold,
               "stressed_threshold": passes[1][2],
               "calibration": state.calibration,
               "cascade": metrics.snapshot()["cascade"]}
    return figures, passes


def check_cascade(f32, cheap, threshold, x, got) -> dict:
    """exact is the float32 engine's bytes, fast the cheap engine's,
    balanced the two composed row by row (an escalated row is float32's
    dispatch of the escalated rows), agreeing with exact at the parity
    bar."""
    import numpy as np

    from distributedmnist_tpu_torch.serve import PARITY_GATES
    from distributedmnist_tpu_torch.serve.cascade import softmax_margin

    if got["exact"].tobytes() != f32.infer(x).tobytes():
        raise RuntimeError("cascade exact is not the float32 route")
    if got["fast"].tobytes() != cheap.infer(x).tobytes():
        raise RuntimeError("cascade fast is not the cheap route")
    esc = softmax_margin(got["fast"]) < threshold
    if got["balanced"][~esc].tobytes() != got["fast"][~esc].tobytes():
        raise RuntimeError("a confident balanced row is not the cheap one")
    if esc.any() and (got["balanced"][esc].tobytes()
                      != f32.infer(x[esc]).tobytes()):
        raise RuntimeError("an escalated balanced row is not float32's")
    agree = float(np.mean(got["balanced"].argmax(-1)
                          == got["exact"].argmax(-1)))
    bar = PARITY_GATES["int8"][0]
    if agree < bar:
        raise RuntimeError(f"balanced agrees with exact on {agree} < {bar}")
    return {"escalated_rows": int(esc.sum()), "agreement": agree}


def drive_fleet_cascade_http(params: dict, lenet_checkpoint_dir: str,
                             card: str) -> tuple[dict, dict, dict]:
    """The HTTP server on the card, one subprocess a server: the MLP with
    --serve-replicas 2 --serve-hedge (drain r1 200, drain r0 409 as the
    last active replica, rejoin 200, /healthz's replicas, /metrics' fleet
    block and the replica families), and LeNet-5 with --serve-cascade on
    config 2's 10-epoch checkpoint (exact the float32 route's classes,
    fast the int8 route's, balanced agreeing with float32 at the parity
    bar). Returns (figures, the fleet server's launches, the cascade
    server's launches)."""
    import shutil
    import urllib.request

    import numpy as np

    from distributedmnist_tpu_torch.checkpoint import Checkpointer
    from distributedmnist_tpu_torch.config import Config
    from distributedmnist_tpu_torch.data import synthetic_mnist
    from distributedmnist_tpu_torch.serve import PARITY_GATES, build_serving
    from distributedmnist_tpu_torch.serve.quantize import PARITY_SEED

    here = os.path.dirname(os.path.abspath(__file__))
    env = _child_env()
    held = synthetic_mnist(seed=PARITY_SEED, train_n=16,
                           test_n=CASCADE_ROWS)["test_x"]
    rows = np.ascontiguousarray(held.reshape(CASCADE_ROWS, 784))
    figures = {}
    with tempfile.TemporaryDirectory() as ckpt:
        ck = Checkpointer(ckpt)
        ck.save(1, {"params": params, "optimizer": {}, "scheduler": {}})
        ck.close()
        srv = start_server(["--model", "mlp", "--checkpoint-dir", ckpt,
                            "--serve-replicas", "2", "--serve-hedge"],
                           env, here)
        try:
            health = healthy(srv)
            if [r["id"] for r in health.get("replicas", [])] != ["r0",
                                                                 "r1"]:
                raise RuntimeError(f"/healthz replicas: {health}")
            first = srv.ok("/predict", data=rows[:64].tobytes())
            codes = {}
            for name, path in (("drain r1", "/replicas/r1/drain"),
                               ("drain r0", "/replicas/r0/drain"),
                               ("predict drained", "/predict"),
                               ("rejoin r1", "/replicas/r1/rejoin")):
                data = (rows[:64].tobytes() if path == "/predict"
                        else b"{}")
                codes[name], body = srv.call(path, data=data)
                if name == "predict drained" and (
                        body.get("classes") != first["classes"]):
                    raise RuntimeError("a drained fleet answered other "
                                       "classes")
            want = {"drain r1": 200, "drain r0": 409,
                    "predict drained": 200, "rejoin r1": 200}
            if codes != want:
                raise RuntimeError(f"replica admin codes {codes}, want "
                                   f"{want}")
            metrics = srv.ok("/metrics")
            with urllib.request.urlopen(
                    srv.base + "/metrics?format=prometheus",
                    timeout=60) as r:
                prom = r.read().decode()
            if (metrics.get("fleet") is None
                    or metrics["fleet"]["n_replicas"] != 2
                    or "dmnist_serve_replica_batches_total" not in prom):
                raise RuntimeError(f"/metrics fleet: {metrics.get('fleet')}")
            figures["fleet_server"] = {
                "codes": codes, "healthz_replicas": health["replicas"],
                "by_replica": metrics["by_replica"]}
        finally:
            _, fleet_launches = stop_server(srv)
    with tempfile.TemporaryDirectory() as ckpt:
        # config 2's 10 epochs (the later lifecycle step left out)
        step = str(TRAIN_STEPS["lenet-adam"])
        shutil.copytree(os.path.join(lenet_checkpoint_dir, step),
                        os.path.join(ckpt, step))
        ref_registry, _, _ = build_serving(Config(
            model="lenet", device="cuda", serve_max_batch=CASCADE_ROWS,
            checkpoint_dir=ckpt))
        mv = ref_registry.load_latest()
        cheap = ref_registry.add_variant(mv.version, "int8").engine
        want = {"exact": mv.engine.infer(rows).argmax(-1).tolist(),
                "fast": cheap.infer(rows).argmax(-1).tolist()}
        srv = start_server(["--model", "lenet", "--checkpoint-dir", ckpt,
                            "--serve-cascade"], env, here)
        try:
            health = srv.wait_for(
                "a calibrated cascade",
                lambda: (srv.healthy_payload() or {}).get("cascade"),
                timeout=HTTP_READY_S)
            got = {}
            for cls in ("exact", "fast", "balanced"):
                got[cls] = srv.ok("/predict", data=rows.tobytes(),
                                  headers={"X-Accuracy-Class": cls})
            code, _ = srv.call("/predict", data=rows[:1].tobytes(),
                               headers={"X-Accuracy-Class": "bogus"})
            cascade_metrics = srv.ok("/metrics")["cascade"]
        finally:
            _, cascade_launches = stop_server(srv)
    bar = PARITY_GATES["int8"][0]
    agree = float(np.mean(np.asarray(got["balanced"]["classes"])
                          == np.asarray(want["exact"])))
    bad = []
    if health["cheap_dtype"] != "int8":
        bad.append(f"cheap stage {health['cheap_dtype']}")
    if got["exact"]["classes"] != want["exact"]:
        bad.append("exact is not the float32 route's classes")
    if got["fast"]["classes"] != want["fast"]:
        bad.append("fast is not the int8 route's classes")
    if agree < bar:
        bad.append(f"balanced agreement {agree} < {bar}")
    if code != 400:
        bad.append(f"an unknown class answered {code}")
    if bad:
        raise RuntimeError(f"LeNet cascade server: {bad}")
    figures["cascade_server"] = {
        "threshold": health["threshold"],
        "calibration": health["calibration"],
        "balanced_agreement": agree, "metrics": cascade_metrics}
    return figures, fleet_launches, cascade_launches


def drive_fleet_cascade_bench(lenet_checkpoint_dir: str) -> tuple:
    """The bench's fleet run (`serve --serve-replicas 2 --serve-hedge
    --chaos`: the non-injected requests all answered, the replica kill
    absorbed by failover, failovers and hedges counted) and its frontier
    run (`serve --dtype-sweep --cascade` on LeNet-5's checkpoint), each
    with the root bench's keys and values above 0. Returns (figures, the
    fleet run's launches, the frontier run's launches)."""
    import shutil

    from distributedmnist_tpu_torch.ops import fused

    here = os.path.dirname(os.path.abspath(__file__))
    env = _child_env()
    figures, launches = {}, []
    with tempfile.TemporaryDirectory() as ckpt:
        step = str(TRAIN_STEPS["lenet-adam"])
        shutil.copytree(os.path.join(lenet_checkpoint_dir, step),
                        os.path.join(ckpt, step))
        for run in FLEET_BENCH_RUNS:
            argv = [a.format(ckpt=ckpt) for a in run]
            t0 = time.perf_counter()
            proc = CHILDREN.run(
                [sys.executable, "-m", "distributedmnist_tpu_torch.bench",
                 *argv], cwd=here, env=env, capture_output=True,
                text=True, timeout=BENCH_TIMEOUT_S)
            took = time.perf_counter() - t0
            if proc.returncode != 0:
                raise RuntimeError(f"bench {' '.join(argv)} exited "
                                   f"{proc.returncode}:\n"
                                   f"{proc.stderr[-4000:]}")
            lines = [ln for ln in proc.stdout.splitlines()
                     if ln.startswith("{")]
            rec = json.loads(lines[-1])
            d = rec["detail"]
            bad = []
            if set(d) != BENCH_KEYS["serve_images_per_sec_per_chip"]:
                bad.append("keys differ from the root bench's")
            if not rec["value"] > 0 or d["recompiles_after_warmup"] != 0:
                bad.append(f"value {rec['value']}, "
                           f"{d['recompiles_after_warmup']} builds")
            if d["replicas"] is not None:
                rep, ch = d["replicas"], d["chaos"]
                if (set(rep) != FLEET_RECORD_KEYS["replicas"]
                        or set(rep["fleet_leg"])
                        != FLEET_RECORD_KEYS["fleet_leg"]):
                    bad.append("replicas keys differ from the root bench's")
                if not rep["fleet_leg"]["fleet_rows_per_sec"] > 0:
                    bad.append("the fleet leg served nothing")
                if (ch["availability_excluding_injected"] != 1.0
                        or not ch["replica_kill"]["rescued_exactly"]
                        or not isinstance(ch["failovers"], int)
                        or not isinstance(ch["hedges"], int)
                        or ch["failovers"] < 1):
                    bad.append("the replica kill was not absorbed")
                figures["fleet"] = {
                    "took_s": took, "value": rec["value"],
                    "fleet_leg": rep["fleet_leg"],
                    "chaos": {k: ch[k] for k in (
                        "requests", "ok", "availability_excluding_injected",
                        "failovers", "hedges", "p99_under_faults_ms",
                        "recompiles_during_chaos")},
                    "replica_kill": {k: ch["replica_kill"][k] for k in (
                        "target", "fires", "rescued_exactly",
                        "failovers")}}
            else:
                ca, sw = d["cascade"], d["dtype_sweep"]
                if (set(ca) != FLEET_RECORD_KEYS["cascade"]
                        or set(sw) != FLEET_RECORD_KEYS["dtype_sweep"]):
                    raise RuntimeError(
                        f"bench {' '.join(argv)}: cascade or dtype_sweep "
                        f"keys differ from the root bench's: cascade "
                        f"{str(ca)[:1500]}, dtype_sweep keys {sorted(sw)}")
                # every point measured; the bars (agreement on the leg's
                # random-pixel probes, goodput) are the root bench's,
                # reported as it computes them
                unmeasured = [
                    f"{leg} {name}: {point}"
                    for leg, points in (("dtype_sweep", sw["legs"]),
                                        ("cascade", ca["legs"]))
                    for name, point in points.items()
                    if not point.get("img_s_chip", 0) > 0]
                if unmeasured:
                    bad.append(f"frontier points not measured: "
                               f"{unmeasured}")
                figures["frontier"] = {
                    "took_s": took,
                    "speedup_vs_float32": sw["speedup_vs_float32"],
                    "dtype_img_s_chip": {dt: leg.get("img_s_chip")
                                         for dt, leg in sw["legs"].items()},
                    "cheap_dtype": ca["cheap_dtype"],
                    "goodput_vs_f32": ca["goodput_vs_f32"],
                    "agreement_vs_f32": ca["agreement_vs_f32"],
                    "agreement_ok": ca["agreement_ok"],
                    "escalation_fraction": {
                        name: leg.get("escalation_fraction")
                        for name, leg in ca["legs"].items()},
                    "cascade_img_s_chip": {
                        name: leg.get("img_s_chip")
                        for name, leg in ca["legs"].items()},
                    "host_compute_ceiling": ca["host_compute_ceiling"]}
            if bad:
                raise RuntimeError(f"bench {' '.join(argv)}: {bad}: "
                                   f"{lines[-1][:3000]}")
            counts = fused.parse_launches(proc.stderr, "bench: launches ")
            launches.append(counts[0])
            print("bench " + lines[-1], flush=True)
    return figures, launches[0], launches[1]


def drive_fleet_and_cascade(params: dict, lenet_checkpoint_dir: str,
                            card: str) -> tuple[dict, dict]:
    """The fleet-and-cascade phase: each path on launch counts set to 0
    just before it and read just after (the server and bench children
    report their own), the comparisons with single routers and routes
    made after the counts are read. Returns (figures, {"fleet": counts,
    "cascade": counts})."""
    from distributedmnist_tpu_torch.ops import fused

    t0 = time.perf_counter()
    fused.reset_launches()
    fleet_figures, bursts, factory = drive_fleet(params)
    fleet_counts = dict(fused.LAUNCHES)
    fused.reset_launches()
    cascade_figures, answers = drive_cascade(params)
    cascade_counts = dict(fused.LAUNCHES)
    fleet_figures["batches_checked"] = check_fleet_bursts(factory, bursts)
    cascade_figures["checked"] = [check_cascade(*a) for a in answers]
    if cascade_figures["checked"][1]["escalated_rows"] < 1:
        raise RuntimeError("the stressed cascade escalated nothing")
    http, fleet_srv, cascade_srv = drive_fleet_cascade_http(
        params, lenet_checkpoint_dir, card)
    bench, fleet_bench, cascade_bench = drive_fleet_cascade_bench(
        lenet_checkpoint_dir)
    launches = {
        "fleet": {k: fleet_counts[k] + fleet_srv.get(k, 0)
                  + fleet_bench.get(k, 0) for k in fleet_counts},
        "cascade": {k: cascade_counts[k] + cascade_srv.get(k, 0)
                    + cascade_bench.get(k, 0) for k in cascade_counts}}
    missing = [f"{path} {k}" for path, n in launches.items()
               for k in SERVING_KERNELS if n[k] <= 0]
    if missing:
        raise RuntimeError(f"kernels never launched on their path: "
                           f"{missing}")
    figures = {"fleet": fleet_figures, "cascade": cascade_figures,
               "http": http, "bench": bench,
               "launches_in_process": {"fleet": fleet_counts,
                                       "cascade": cascade_counts},
               "phase_s": time.perf_counter() - t0}
    print(f"fleet and cascade on {card}: " + json.dumps(figures),
          flush=True)
    return figures, launches


def _tenancy_base(base: str, params: dict,
                  lenet_checkpoint_dir: str) -> None:
    """A checkpoint base for the catalog, one subtree a model: the fitted
    MLP under mlp/, config 2's 10-epoch LeNet-5 under lenet/."""
    import shutil

    from distributedmnist_tpu_torch.checkpoint import Checkpointer

    ck = Checkpointer(os.path.join(base, "mlp"))
    ck.save(1, {"params": params, "optimizer": {}, "scheduler": {}})
    ck.close()
    step = str(TRAIN_STEPS["lenet-adam"])
    shutil.copytree(os.path.join(lenet_checkpoint_dir, step),
                    os.path.join(base, "lenet", step))


def _tenancy_config(base: str, **kw):
    from distributedmnist_tpu_torch.config import Config

    return Config(model="mlp", device="cuda", serve_models="mlp,lenet",
                  serve_tenants=TENANCY_TENANTS, checkpoint_dir=base,
                  serve_max_batch=TENANCY_MAX_BATCH,
                  serve_queue_depth=SELFTEST_QUEUE_DEPTH, **kw)


def _record_batches(catalog, seen: list) -> None:
    """Wrap each catalog model's router so every batch it computes is
    appended to `seen` as (model, engine, version, the parts, the
    logits); _unwrap_batches undoes it."""
    for entry in catalog.entries():
        router = entry.router
        dispatch, fetch = router.dispatch, router.fetch

        def recording_dispatch(x, *a, _dispatch=dispatch, **kw):
            rh = _dispatch(x, *a, **kw)
            rh.parts = x
            return rh

        def recording_fetch(rh, _fetch=fetch, _name=entry.name):
            out = _fetch(rh)
            seen.append((_name, rh.engine, rh.version, rh.parts, out))
            return out

        router.dispatch, router.fetch = recording_dispatch, recording_fetch


def _unwrap_batches(catalog) -> None:
    for entry in catalog.entries():
        entry.router.__dict__.pop("dispatch", None)
        entry.router.__dict__.pop("fetch", None)


def drive_tenancy_in_process(base: str) -> tuple[dict, list]:
    """The catalog and the global scheduler in process on the card, at
    float32 and again at megakernel (see the module docstring's phase
    13). Returns (figures, each run's recorded batches and answers, to
    be checked against single routers once the launch counts are
    read)."""
    import numpy as np

    from distributedmnist_tpu_torch.ops import kernel_lib
    from distributedmnist_tpu_torch.serve import ServeMetrics, build_tenancy
    from distributedmnist_tpu_torch.serve import scheduler as policy

    figures, runs = {}, []
    rng = np.random.default_rng(SEED + 13)
    reqs = [(tenant, rng.integers(0, 256, (int(n), 28, 28, 1),
                                  dtype=np.uint8))
            for n in rng.integers(1, TENANCY_MAX_ROWS + 1,
                                  TENANCY_REQUESTS)
            for tenant in ("light", "heavy")]
    for dt in ("float32", "megakernel"):
        t0 = time.perf_counter()
        metrics = ServeMetrics()
        # the float32 run fronts each model with its prediction cache,
        # for the cache-aware shed
        catalog, sched = build_tenancy(
            _tenancy_config(base, serve_infer_dtype=dt,
                            serve_cache=dt == "float32"), metrics=metrics)
        seen: list = []
        try:
            for name in catalog.names():
                catalog.ensure_live(name, infer_dtype=dt)
            desc = catalog.describe()
            want_dtype = {"mlp": dt, "lenet": "float32"}
            got_dtype = {m: d["live_infer_dtype"] for m, d in desc.items()}
            if got_dtype != want_dtype:
                raise RuntimeError(f"tenancy {dt}: live {got_dtype}, want "
                                   f"{want_dtype}")
            sources = {m: e.registry.get(e.router.live_version()).source
                       for m, e in zip(catalog.names(), catalog.entries())}
            if sources != {m: f"checkpoint {base}/{m}"
                           for m in ("mlp", "lenet")}:
                raise RuntimeError(f"tenancy sources {sources}")
            streams = [e.factory.replica_streams[0][0]
                       for e in catalog.entries()]
            if (None in streams
                    or streams[0].cuda_stream == streams[1].cuda_stream):
                raise RuntimeError(f"catalog streams {streams}")
            warm_s = time.perf_counter() - t0

            def builds():
                return kernel_lib.load_events() + sum(
                    e.factory.engine_builds for e in catalog.entries())

            steady = builds()
            _record_batches(catalog, seen)
            t1 = time.perf_counter()
            futs = [(tenant, x, sched.submit(x, tenant=tenant))
                    for tenant, x in reqs]
            outs = [(tenant, x, f.result(timeout=120))
                    for tenant, x, f in futs]
            took = time.perf_counter() - t1
            snap = sched.snapshot()
            bound = policy.drr_skip_bound(
                len(snap["tenants"]), sched._max_head_cost_s,
                sched.quantum_s,
                min(c.weight for c in sched.classes().values()))
            if snap["max_skip_observed"] > bound:
                raise RuntimeError(f"tenancy {dt}: max skip "
                                   f"{snap['max_skip_observed']} > {bound}")
            rec = {"warm_s": warm_s, "s": took,
                   "rows_per_s": sum(x.shape[0] for _, x in reqs) / took,
                   "granted_rows": {t: v["granted_rows"] for t, v
                                    in snap["tenants"].items()},
                   "max_skip_observed": snap["max_skip_observed"],
                   "skip_bound": bound,
                   "batches": {m: sum(1 for b in seen if b[0] == m)
                               for m in catalog.names()},
                   "latency_ms": {t: v["latency_ms"] for t, v in
                                  metrics.snapshot()["by_tenant"].items()}}
            if dt == "float32":
                rec["sheds"] = _tenancy_sheds(sched, catalog, metrics, rng)
            rebuilt = builds() - steady
            if rebuilt:
                raise RuntimeError(f"tenancy {dt}: {rebuilt} builds after "
                                   "warmup")
            rec["builds_after_warmup"] = rebuilt
        finally:
            sched.stop()          # raises if the grant thread died
            _unwrap_batches(catalog)
        runs.append((dt, catalog, seen, outs))
        figures[dt] = rec
    return figures, runs


def _tenancy_sheds(sched, catalog, metrics, rng) -> dict:
    """The scheduler's sheds on the float32 catalog: a door deadline shed
    (504, nothing dispatched), a quota shed (429 with retry_after_s), and
    a cached answer served over quota."""
    import numpy as np

    from distributedmnist_tpu_torch.serve import (DeadlineExceeded,
                                                  QuotaExceeded)

    batches = metrics.snapshot()["batches"]
    x = rng.integers(0, 256, (3, 28, 28, 1), dtype=np.uint8)
    try:
        sched.submit(x, tenant="light", deadline_s=time.monotonic() - 1e-3)
        raise RuntimeError("an expired deadline was admitted")
    except DeadlineExceeded:
        pass
    if metrics.snapshot()["batches"] != batches:
        raise RuntimeError("a door deadline shed dispatched")
    sched.set_quota("heavy", qps=0.01, burst=1)
    first = sched.submit(x, tenant="heavy").result(timeout=120)
    hit = sched.submit(x, tenant="heavy").result(timeout=10)
    if hit.tobytes() != first.tobytes():
        raise RuntimeError("the cache-aware shed served other bytes")
    try:
        sched.submit(x[:1], tenant="heavy")
        raise RuntimeError("an over-quota miss was admitted")
    except QuotaExceeded as e:
        retry = e.retry_after_s
    if not retry > 0:
        raise RuntimeError(f"a 429 with retry_after_s {retry}")
    bt = metrics.snapshot()["by_tenant"]
    if (bt["heavy"]["cache_hits"] != 1 or bt["heavy"]["quota_sheds"] != 1
            or bt["light"]["deadline_sheds"] != 1):
        raise RuntimeError(f"shed accounting {bt}")
    return {"retry_after_s": retry,
            "cache": catalog.get("lenet").cache.stats()["hits"],
            "by_tenant": {t: {k: v[k] for k in (
                "deadline_sheds", "quota_sheds", "cache_hits")}
                for t, v in bt.items()}}


def check_tenancy_runs(runs) -> int:
    """Every batch a run recorded, bit for bit a single router's dispatch
    of the same rows on the engine that computed it, and every answer its
    request's slice of its batch. Returns the batches checked."""
    checked = 0
    for dt, catalog, seen, outs in runs:
        singles = {}
        rows = {}
        for name, engine, version, parts, out in seen:
            key = id(engine)
            if key not in singles:
                r = catalog.get(name).factory.make_router()
                r.set_live(engine, version)
                singles[key] = r
            if singles[key].infer(parts).tobytes() != out.tobytes():
                raise RuntimeError(f"tenancy {dt}: a {name} batch is not "
                                   "its router's dispatch")
            off = 0
            for p in (parts if isinstance(parts, list) else [parts]):
                rows[id(p)] = out[off:off + p.shape[0]]
                off += p.shape[0]
            checked += 1
        for tenant, x, got in outs:
            if got.tobytes() != rows[id(x)].tobytes():
                raise RuntimeError(f"tenancy {dt}: a {tenant} answer is "
                                   "not its batch's rows")
    return checked


def contention_figures(base: str) -> dict:
    """The bench's cross-model contention probe on the float32 catalog,
    with each model's engines on a stream of their own and with both on
    the default stream."""
    from distributedmnist_tpu_torch.bench import contention_probe
    from distributedmnist_tpu_torch.serve import build_catalog

    out = {}
    for label, own in (("streams_on", True), ("streams_off", False)):
        catalog = build_catalog(_tenancy_config(base), own_streams=own)
        try:
            for name in catalog.names():
                catalog.ensure_live(name)
            out[label] = contention_probe(catalog)
        finally:
            catalog.stop()
    return out


def _http(srv, path, data=None, headers=None, json_body=None):
    """(status, JSON body, headers) of one request to a child server."""
    import urllib.error
    import urllib.request

    headers = dict(headers or {})
    if json_body is not None:
        data = json.dumps(json_body).encode()
        headers["Content-Type"] = "application/json"
    req = urllib.request.Request(srv.base + path, data=data,
                                 headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


def drive_tenancy_http(base: str, card: str) -> tuple[dict, dict]:
    """A `--serve-models mlp,lenet --serve-tenants ... --serve-infer-dtype
    int8` server on the card (see the module docstring's phase 13).
    Returns (figures, its launches)."""
    import urllib.request

    import numpy as np

    here = os.path.dirname(os.path.abspath(__file__))
    env = _child_env()
    x = np.random.default_rng(SEED + 14).integers(
        0, 256, (4, 784), dtype=np.uint8).tobytes()
    srv = start_server(["--model", "mlp", "--checkpoint-dir", base,
                        "--serve-models", "mlp,lenet", "--serve-tenants",
                        TENANCY_HTTP_TENANTS, "--serve-infer-dtype",
                        "int8", "--serve-max-batch",
                        str(TENANCY_MAX_BATCH)], env, here)
    codes, headers = {}, {}
    try:
        healthy(srv)
        for name, path, kw in (
                ("gold", "/predict", {"data": x,
                                      "headers": {"X-Tenant": "gold"}}),
                ("unknown tenant", "/predict",
                 {"data": x, "headers": {"X-Tenant": "nobody"}}),
                ("free 1", "/predict", {"data": x,
                                        "headers": {"X-Tenant": "free"}}),
                ("free 2", "/predict", {"data": x,
                                        "headers": {"X-Tenant": "free"}}),
                ("free over quota", "/predict",
                 {"data": x, "headers": {"X-Tenant": "free"}}),
                ("deadline", "/predict",
                 {"data": x, "headers": {"X-Tenant": "gold",
                                         "X-Deadline-Ms": "0.001"}}),
                ("tenants", "/tenants", {}),
                ("quota", "/tenants/free/quota",
                 {"json_body": {"qps": 100, "burst": 10}}),
                ("quota unknown", "/tenants/nobody/quota",
                 {"json_body": {"qps": 1}}),
                ("free after", "/predict",
                 {"data": x, "headers": {"X-Tenant": "free"}})):
            codes[name], body, headers[name] = _http(srv, path, **kw)
            if name == "tenants":
                tenants = body
        metrics = srv.ok("/metrics")
        with urllib.request.urlopen(srv.base + "/metrics?format=prometheus",
                                    timeout=60) as r:
            prom = r.read().decode()
    finally:
        summary, launches = stop_server(srv)
    want = {"gold": 200, "unknown tenant": 200, "free 1": 200,
            "free 2": 200, "free over quota": 429, "deadline": 504,
            "tenants": 200, "quota": 200, "quota unknown": 404,
            "free after": 200}
    bad = []
    if codes != want:
        bad.append(f"codes {codes}")
    retry = headers["free over quota"].get("Retry-After")
    if retry is None or int(retry) < 1:
        bad.append(f"the 429's Retry-After {retry}")
    models = tenants.get("models", {})
    if ({m: v.get("live_infer_dtype") for m, v in models.items()}
            != {"mlp": "int8", "lenet": "int8"}):
        bad.append(f"/tenants models {models}")
    if set(tenants.get("tenants", {})) != {"gold", "free", "default"}:
        bad.append(f"/tenants tenants {tenants.get('tenants')}")
    if (set(metrics["by_tenant"]) != {"gold", "free", "default"}
            or set(metrics["by_model"]) != {"mlp", "lenet"}
            or metrics["tenancy"] is None):
        bad.append(f"/metrics blocks by_tenant {metrics['by_tenant']}, "
                   f"by_model {metrics['by_model']}")
    for fam in ("dmnist_serve_tenant_requests_total",
                "dmnist_serve_tenant_sheds_total",
                "dmnist_serve_model_dispatched_rows_total"):
        if f"# TYPE {fam} " not in prom:
            bad.append(f"family {fam} missing")
    if launches.get("quant_dense", 0) <= 0:
        bad.append(f"the int8 server launched {launches}")
    if "tenancy" not in summary:
        bad.append("the summary has no tenancy block")
    if bad:
        raise RuntimeError(f"tenancy server: {bad}")
    return {"codes": codes, "retry_after": retry,
            "by_model": metrics["by_model"],
            "by_tenant": {t: {k: v[k] for k in ("requests", "quota_sheds",
                                                "deadline_sheds")}
                          for t, v in metrics["by_tenant"].items()},
            "compiles_total": metrics["compiles_total"]}, launches


def _bench_run(argv, env, cwd) -> tuple:
    """One bench subprocess: (rc, its record or None, stderr)."""
    proc = CHILDREN.run(
        [sys.executable, "-m", "distributedmnist_tpu_torch.bench", *argv],
        cwd=cwd, env=env, capture_output=True, text=True,
        timeout=BENCH_TIMEOUT_S)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    return (proc.returncode, json.loads(lines[-1]) if lines else None,
            proc.stderr)


def _bench_launches(err: str) -> dict:
    from distributedmnist_tpu_torch.ops import fused

    counts = fused.parse_launches(err, "bench: launches ")
    if len(counts) != 1:
        raise RuntimeError("a bench run reported no launch counts")
    return counts[0]


def drive_tenancy_bench(card: str) -> tuple[dict, dict]:
    """The bench's multimodel and swap legs with its records (see the
    module docstring's phase 13). Returns (figures, the launches of the
    runs that served)."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = _child_env()
    launches: dict = {}
    figures = {}
    with tempfile.TemporaryDirectory() as out:
        t0 = time.perf_counter()
        rc, rec, err = _bench_run([*TENANCY_BENCH_RUN, "--artifact-dir",
                                   out], env, here)
        if rc != 0 or rec is None:
            raise RuntimeError(f"bench {TENANCY_BENCH_RUN} exited {rc}:\n"
                               f"{err[-4000:]}")
        d = rec["detail"]
        mm, sw = d["multimodel"], d["swap"]
        bad = []
        if set(d) != BENCH_KEYS["serve_images_per_sec_per_chip"]:
            bad.append("keys differ from the root bench's")
        for leg in ("multimodel", "swap"):
            if set(d[leg]) != TENANCY_RECORD_KEYS[leg]:
                bad.append(f"{leg} keys differ from the root bench's")
        if (d["recompiles_after_warmup"] != 0
                or mm["recompiles_after_warmup"] != 0
                or sw["recompiles_after_swap"] != 0):
            bad.append(f"builds after warmup {d['recompiles_after_warmup']}"
                       f", multimodel {mm['recompiles_after_warmup']}, "
                       f"after the swap {sw['recompiles_after_swap']}")
        if set(mm["fairness"]) != {"light", "heavy"}:
            bad.append(f"fairness {mm['fairness']}")
        empty = [k for k in ("light_solo_p99_ms", "light_mixed_p99_ms")
                 if mm[k] is None]
        if empty:
            bad.append(f"an empty multimodel window: {empty} None")
        path = os.path.join(out, "BENCH_torch_serve_r01.json")
        if not os.path.isfile(path):
            bad.append(f"no record file: {os.listdir(out)}")
        else:
            with open(path) as f:
                saved = json.load(f)
            host = saved["detail"]["host"]
            if host["device_kind"] != card.split(",")[0].strip():
                bad.append(f"the record's device_kind {host['device_kind']}")
            try:
                head = CHILDREN.run(["git", "rev-parse", "HEAD"],
                                      cwd=here, capture_output=True,
                                      text=True, timeout=60)
                commit = (head.stdout.strip() if head.returncode == 0
                          else None)
            except OSError:
                commit = None     # no git here: the record says None too
            if "git_commit" not in host or host["git_commit"] != commit:
                bad.append(f"the record's commit {host.get('git_commit')}, "
                           f"the checkout's {commit}")
        if bad:
            raise RuntimeError(f"tenancy bench: {bad}: {str(rec)[:3000]}")
        launches = _bench_launches(err)
        figures["multimodel"] = {k: mm[k] for k in sorted(
            TENANCY_RECORD_KEYS["multimodel"])}
        figures["swap"] = {k: sw[k] for k in sorted(
            TENANCY_RECORD_KEYS["swap"]) if k != "swap_window"}
        figures["record"] = {"file": os.path.basename(path),
                             "device_kind": host["device_kind"],
                             "git_commit": host["git_commit"],
                             "power_limit_w": host["power_limit_w"]}
        figures["took_s"] = time.perf_counter() - t0
        # a second run diffs against the first record
        rc, rec2, err2 = _bench_run(
            ["serve", "--model", "mlp", "--serve-duration", "0.5",
             "--inline", "--baseline", path, "--artifact-dir", out], env,
            here)
        if (rc != 0 or rec2 is None or "baseline" not in rec2["detail"]
                or "baseline delta vs BENCH_torch_serve_r01.json"
                not in err2
                or sorted(os.listdir(out)) != [
                    "BENCH_torch_serve_r01.json",
                    "BENCH_torch_serve_r02.json"]):
            raise RuntimeError(f"the --baseline run exited {rc}:\n"
                               f"{err2[-4000:]}")
        for k, n in _bench_launches(err2).items():
            launches[k] = launches.get(k, 0) + n
        figures["baseline_delta"] = {
            k: rec2["detail"]["baseline"][k]
            for k in ("img_s_chip", "closed_p99_ms",
                      "recompiles_after_warmup")}
        # the JAX package's CPU record: refused before any load phase,
        # and not retried by the supervisor
        rc, rec3, err3 = _bench_run(
            ["serve", "--model", "mlp", "--no-artifact", "--baseline",
             os.path.join(here, "BENCH_serve_r13.json")], env, here)
        if (rc != 4 or rec3 is not None or "REFUSING --baseline" not in err3
                or "closed loop" in err3 or "not retried" not in err3):
            raise RuntimeError(f"the CPU baseline was not refused (exit "
                               f"{rc}):\n{err3[-4000:]}")
        figures["refused"] = [ln for ln in err3.splitlines()
                              if "REFUSING" in ln][0]
    return figures, launches


def drive_tenancy(params: dict, lenet_checkpoint_dir: str,
                  card: str) -> tuple[dict, dict]:
    """The tenancy phase: the in-process catalog, the HTTP server and the
    bench, launch counts set to 0 just before the in-process path and
    read just after (the server and bench children report their own);
    the comparisons with single routers and the contention probes made
    after the counts are read. Returns (figures, {"tenancy": counts})."""
    from distributedmnist_tpu_torch.ops import fused

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as base:
        _tenancy_base(base, params, lenet_checkpoint_dir)
        fused.reset_launches()
        in_process, runs = drive_tenancy_in_process(base)
        counts = dict(fused.LAUNCHES)
        in_process["batches_checked"] = check_tenancy_runs(runs)
        in_process["contention"] = contention_figures(base)
        http, http_launches = drive_tenancy_http(base, card)
    bench, bench_launches = drive_tenancy_bench(card)
    launches = {"tenancy": {k: counts[k] + http_launches.get(k, 0)
                            + bench_launches.get(k, 0) for k in counts}}
    missing = [k for k in SERVING_KERNELS if launches["tenancy"][k] <= 0]
    if missing:
        raise RuntimeError(f"kernels never launched on the tenancy path: "
                           f"{missing}")
    figures = {"in_process": in_process, "http": http, "bench": bench,
               "launches_in_process": counts,
               "phase_s": time.perf_counter() - t0}
    print(f"tenancy on {card}: " + json.dumps(figures, default=str),
          flush=True)
    return figures, launches


def _children_of(pid: int) -> list:
    """The pids whose parent is `pid` (field 4 of /proc/<pid>/stat)."""
    kids = []
    for p in os.listdir("/proc"):
        if not p.isdigit():
            continue
        try:
            with open(f"/proc/{p}/stat") as f:
                if f.read().rsplit(")", 1)[1].split()[1] == str(pid):
                    kids.append(int(p))
        except OSError:
            continue
    return sorted(kids)


def _maps_card(pid: int) -> bool:
    """Whether the process has a card's device file mapped (a CUDA
    context maps /dev/nvidia*)."""
    try:
        with open(f"/proc/{pid}/maps") as f:
            return "/dev/nvidia" in f.read()
    except OSError:
        return False


def check_gateway_context(gateway_pid: int, workers: list) -> dict:
    """The gateway process holds no CUDA context and its workers do:
    nvidia-smi's compute-app pids (when they are this PID namespace's)
    and each process's device-file mappings."""
    out = CHILDREN.run(
        ["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    listed = {int(t) for t in out.stdout.split() if t.strip().isdigit()}
    rec = {"gateway_pid": gateway_pid, "worker_pids": workers,
           "nvidia_smi_pids": sorted(listed),
           "maps_card": {str(p): _maps_card(p)
                         for p in [gateway_pid, *workers]}}
    rec["nvidia_smi_lists_workers"] = set(workers) <= listed
    if rec["nvidia_smi_lists_workers"] and gateway_pid in listed:
        raise RuntimeError(f"nvidia-smi lists the gateway: {rec}")
    if (all(rec["maps_card"][str(p)] for p in workers)
            and rec["maps_card"][str(gateway_pid)]):
        raise RuntimeError(f"the gateway maps the card: {rec}")
    if not (rec["nvidia_smi_lists_workers"]
            or all(rec["maps_card"][str(p)] for p in workers)):
        print("gateway: neither nvidia-smi's pids nor the workers' maps "
              "show the workers' contexts here; the gateway's own "
              "torch.cuda.is_initialized() line decides", flush=True)
    return rec


def _hammer(srv, clients: int, kill) -> dict:
    """`clients` threads of 1-row requests (unique bodies, one keep-alive
    connection each) through the gateway; once GATEWAY_KILL_AFTER answers
    are in, kill() runs, and the clients go on GATEWAY_AFTER_KILL_S more.
    A 503 is shed-and-retry (its reason counted); any other non-200 or a
    transport error is a failure."""
    import http.client
    import threading

    import numpy as np

    lock = threading.Lock()
    stats = {"ok": 0, "ok_after_kill": 0, "shed": {}, "errors": [],
             "transport_errors": 0}
    killed = threading.Event()
    stop = threading.Event()

    def client(i: int):
        rng = np.random.default_rng(40_000 + i)
        conn = http.client.HTTPConnection("127.0.0.1", srv.port,
                                          timeout=120)
        while not stop.is_set():
            body = rng.integers(0, 256, 784, dtype=np.uint8).tobytes()
            try:
                conn.request("POST", "/predict", body)
                r = conn.getresponse()
                raw = r.read()
            except (OSError, http.client.HTTPException):
                conn.close()
                conn = http.client.HTTPConnection("127.0.0.1", srv.port,
                                                  timeout=120)
                with lock:
                    stats["transport_errors"] += 1
                continue
            with lock:
                if r.status == 200:
                    stats["ok"] += 1
                    if killed.is_set():
                        stats["ok_after_kill"] += 1
                elif r.status == 503:
                    reason = json.loads(raw).get("reason")
                    stats["shed"][reason] = stats["shed"].get(reason, 0) + 1
                else:
                    stats["errors"].append((r.status, raw[:200].decode()))
            if r.status == 503:
                time.sleep(0.002)
        conn.close()

    from distributedmnist_tpu_torch.analysis.locks import make_thread

    threads = [make_thread(target=client, name=f"smoke-hammer-{i}",
                           daemon=False, args=(i,)) for i in range(clients)]
    for t in threads:
        t.start()
    try:
        deadline = time.monotonic() + 120
        while stats["ok"] < GATEWAY_KILL_AFTER:
            if time.monotonic() > deadline:
                raise RuntimeError(f"the gateway answered too little: "
                                   f"{stats}")
            time.sleep(0.01)
        kill()
        killed.set()
        time.sleep(GATEWAY_AFTER_KILL_S)
    finally:
        stop.set()
        for t in threads:
            t.join(180)
    return stats


def _gateway_latency(srv, rows) -> dict:
    """Sequential 1-row /predict calls through the gateway on the
    client's clock, one new connection a call: p50/p99/mean ms."""
    import numpy as np

    lat = []
    for row in rows:
        t0 = time.perf_counter()
        srv.ok("/predict", data=np.ascontiguousarray(row).tobytes())
        lat.append((time.perf_counter() - t0) * 1e3)
    return {"calls": len(rows), "p50_ms": float(np.percentile(lat, 50)),
            "p99_ms": float(np.percentile(lat, 99)),
            "mean_ms": float(np.mean(lat))}


def drive_gateway_http(params: dict, card: str) -> tuple[dict, dict]:
    """`python -m distributedmnist_tpu_torch.serve --gateway 2` over the
    fitted MLP at int8 with the cache (see the module docstring's phase
    14). Returns (figures, the launch counts its workers reported)."""
    import signal

    import numpy as np

    from distributedmnist_tpu_torch.checkpoint import Checkpointer
    from distributedmnist_tpu_torch.config import Config
    from distributedmnist_tpu_torch.serve import build_serving
    from distributedmnist_tpu_torch.serve.process import ServerProcess

    here = os.path.dirname(os.path.abspath(__file__))
    env = _child_env()
    rng = np.random.default_rng(SEED + 14)
    reqs = [rng.integers(0, 256, (int(n), 784), dtype=np.uint8)
            for n in rng.integers(1, GATEWAY_MAX_ROWS + 1,
                                  GATEWAY_REQUESTS)]
    timed_rows = rng.integers(0, 256, (HTTP_TIMED_CALLS, 784),
                              dtype=np.uint8)
    hot = [rng.integers(0, 256, (1, 784), dtype=np.uint8)
           for _ in range(GATEWAY_HOT_KEYS)]
    rec = {}
    with tempfile.TemporaryDirectory() as ckpt:
        ck = Checkpointer(ckpt)
        ck.save(1, {"params": params, "optimizer": {}, "scheduler": {}})
        ck.close()
        t0 = time.perf_counter()
        srv = ServerProcess(
            [sys.executable, "-m", "distributedmnist_tpu_torch.serve",
             "--model", "mlp", "--checkpoint-dir", ckpt,
             "--serve-infer-dtype", "int8", "--serve-cache", "--gateway",
             "2", "--port", "0", "--metrics-every", "30"],
            env=env, cwd=here, ready_timeout=HTTP_READY_S,
            ready_metric="gateway_ready", popen=CHILDREN.popen)
        try:
            def fleet_int8():
                code, body = srv.call("/healthz")
                rows = body.get("workers") or []
                return body if (code == 200 and len(rows) == 2 and all(
                    r.get("ok") and r.get("live_infer_dtype") == "int8"
                    for r in rows)) else None

            health = srv.wait_for("both workers live at int8", fleet_int8,
                                  timeout=HTTP_READY_S)
            rec["ready_s"] = time.perf_counter() - t0
            workers = _children_of(srv.proc.pid)
            if len(workers) != 2:
                raise RuntimeError(f"the gateway has {len(workers)} "
                                   "children, not 2 workers")
            rec["context"] = check_gateway_context(srv.proc.pid, workers)
            rec["predict_1row"] = _gateway_latency(srv, timed_rows)
            got = [srv.ok("/predict", data=x.tobytes()) for x in reqs]
            # hot keys: each on one worker, its repeats that worker's
            # cache hits
            hits0 = {p: _worker_get(p, "/metrics")["cache"]["hits"]
                     for p in srv.ready["worker_ports"]}
            owners: dict = {}
            for i in range(GATEWAY_HOT_REQUESTS):
                k = i % GATEWAY_HOT_KEYS
                code, hdrs, body = srv.exchange("/predict",
                                                data=hot[k].tobytes())
                if code != 200:
                    raise RuntimeError(f"hot key {k}: {code} {body}")
                owners.setdefault(k, set()).add(hdrs["X-Gateway-Worker"])
            hits = {p: _worker_get(p, "/metrics")["cache"]["hits"]
                    - hits0[p] for p in srv.ready["worker_ports"]}
            if any(len(o) != 1 for o in owners.values()):
                raise RuntimeError(f"a hot key reached two workers: "
                                   f"{owners}")
            if sum(hits.values()) != GATEWAY_HOT_REQUESTS - GATEWAY_HOT_KEYS:
                raise RuntimeError(f"hot-key cache hits {hits}")
            by_worker = {w: sum(1 for o in owners.values() if w in o)
                         for w in ("w0", "w1")}
            rec["hot_keys"] = {"owners": by_worker, "worker_hits": {
                str(p): n for p, n in hits.items()}}
            # a fresh version staged on both workers, then promoted
            staged = srv.ok("/models/load",
                            json_body={"fresh": {"seed": 5}})
            promoted = srv.ok("/models/promote",
                              json_body={"version": staged["version"]})
            snap = srv.ok("/metrics")
            if (promoted["cluster_epoch"] != 1
                    or snap["cluster_epoch"] != 1
                    or snap["mixed_epoch_rejected"] != 0):
                raise RuntimeError(f"promote: {promoted}, {snap}")
            code, hdrs, body = srv.exchange("/predict",
                                            data=reqs[0].tobytes())
            if code != 200 or hdrs.get("X-Cluster-Epoch") != "1" \
                    or body["version"] != staged["version"]:
                raise RuntimeError(f"after the promote: {code} {hdrs} "
                                   f"{body}")
            rec["promote"] = {"version": staged["version"],
                              "cluster_epoch": snap["cluster_epoch"]}
            # a worker SIGKILLed under 32 clients
            before = srv.ok("/metrics")
            storm = _hammer(srv, GATEWAY_KILL_CLIENTS,
                            lambda: os.kill(workers[0], signal.SIGKILL))
            after = srv.ok("/metrics")
            rec["kill"] = {"clients": storm, "failovers": after["failovers"]
                           - before["failovers"],
                           "failover_rescued": after["failover_rescued"]
                           - before["failover_rescued"],
                           "worker_deaths": after["worker_deaths"],
                           "workers_active": after["workers_active"],
                           "mixed_epoch_rejected":
                               after["mixed_epoch_rejected"]}
            bad_sheds = {k: v for k, v in storm["shed"].items()
                         if k != "backpressure"}
            if (storm["errors"] or storm["transport_errors"] or bad_sheds
                    or not storm["ok_after_kill"]
                    or rec["kill"]["failovers"] < 1
                    or rec["kill"]["failover_rescued"] < 1
                    or after["worker_deaths"] != 1
                    or after["workers_active"] != 1
                    or after["mixed_epoch_rejected"] != 0):
                raise RuntimeError(f"the worker kill: {rec['kill']}")
        finally:
            done = srv.stop()
        summaries = [r for r in done.records
                     if r.get("metric") == "gateway_summary"]
        if done.rc != 0 or len(summaries) != 1:
            raise RuntimeError(f"gateway exited {done.rc} with "
                               f"{len(summaries)} summaries:\n{done.stderr}")
        if "gateway: cuda initialized False" not in done.stderr:
            raise RuntimeError(f"the gateway made a CUDA context:\n"
                               f"{done.stderr}")
        if len(done.launches) != 1 or done.launches[0]["quant_dense"] <= 0:
            raise RuntimeError(f"the surviving worker's launches: "
                               f"{done.launches}")
        rec["launches"] = done.launches
        # the same rows through an in-process int8 router on the card:
        # each request was alone in its worker's batch, at the same ladder
        registry, router, _ = build_serving(Config(
            model="mlp", device="cuda", checkpoint_dir=ckpt))
        mv = registry.bootstrap(promote=False)
        if registry.go_live(mv.version, "int8") != "int8":
            raise RuntimeError("the in-process int8 variant was refused")
        mismatched = [i for i, (x, g) in enumerate(zip(reqs, got))
                      if router.infer(x.reshape(-1, 28, 28, 1)).argmax(
                          -1).tolist() != g["classes"]
                      or g["n"] != x.shape[0]]
        if mismatched:
            raise RuntimeError(f"{len(mismatched)} gateway answers differ "
                               f"from the in-process int8 router: "
                               f"{mismatched[:8]}")
        rec["requests_checked"] = len(reqs)
    counts = {k: sum(n[k] for n in done.launches)
              for k in done.launches[0]}
    print(f"gateway http on {card}: " + json.dumps(rec, default=str),
          flush=True)
    return rec, counts


def _worker_get(port: int, path: str) -> dict:
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=60) as r:
        return json.loads(r.read())


def drive_gateway_bench(params: dict, card: str) -> tuple[dict, dict]:
    """The bench's `serve --gateway 2 --serve-infer-dtype megakernel` on
    the fitted MLP. Returns (figures, the launches its workers
    reported)."""
    import torch

    from distributedmnist_tpu_torch.checkpoint import Checkpointer
    from distributedmnist_tpu_torch.ops import fused

    here = os.path.dirname(os.path.abspath(__file__))
    env = _child_env()
    with tempfile.TemporaryDirectory() as ckpt:
        ck = Checkpointer(ckpt)
        ck.save(1, {"params": params, "optimizer": {}, "scheduler": {}})
        ck.close()
        t0 = time.perf_counter()
        rc, rec, err = _bench_run([*GATEWAY_BENCH_RUN, "--checkpoint-dir",
                                   ckpt], env, here)
    if rc != 0 or rec is None:
        raise RuntimeError(f"bench {GATEWAY_BENCH_RUN} exited {rc}:\n"
                           f"{err[-4000:]}")
    d = rec["detail"]
    g = d["gateway"]
    workers = fused.parse_launches(err, "bench: worker launches ")
    bad = []
    if (rec["metric"] != "gateway_images_per_sec"
            or set(d) != BENCH_KEYS["gateway_images_per_sec"]
            or set(g) != GATEWAY_RECORD_KEYS):
        bad.append("keys differ from the root bench's")
    if d["recompiles_after_warmup"] != 0 or any(
            g["per_worker_recompiles"].values()):
        bad.append(f"builds after warmup {g['per_worker_recompiles']}")
    if d["host"]["device_kind"] != torch.cuda.get_device_name(0) \
            or d["host"]["infer_dtype"] != "megakernel":
        bad.append(f"host {d['host']}")
    if not (g["zipf"]["every_key_single_worker"]
            and g["promote"]["zero_mixed_epoch"]):
        bad.append("a hot key on two workers or a mixed-epoch reply")
    if len(workers) != 3 or any(w["mlp_megakernel"] <= 0 for w in workers):
        bad.append(f"worker launches {workers}")
    empty = [k for k, leg in (("closed_loop", d["closed_loop"]),
                              ("closed_loop_1worker",
                               g["closed_loop_1worker"]))
             if leg["requests_ok"] <= 0]
    if empty:
        bad.append(f"an empty closed-loop window: {empty}")
    if bad:
        raise RuntimeError(f"bench {GATEWAY_BENCH_RUN}: {bad}\n"
                           f"record: {json.dumps(rec)[:3000]}\n"
                           f"stderr tail:\n{err[-4000:]}")
    figures = {k: g[k] for k in ("img_s_1", "img_s_n", "scaling_efficiency",
                                 "host_contention_x",
                                 "scaling_bar_reachable",
                                 "per_worker_recompiles")}
    figures.update(open_loop=g["open_loop"], zipf=g["zipf"],
                   promote=g["promote"], closed_loop=d["closed_loop"],
                   closed_loop_1worker=g["closed_loop_1worker"],
                   run_s=time.perf_counter() - t0, worker_launches=workers)
    print(f"bench gateway on {card}: " + json.dumps(figures, default=str),
          flush=True)
    counts = {k: sum(w[k] for w in workers) for k in workers[0]}
    return figures, counts


def static_replay_rate() -> dict:
    """The trace replay's static phase as the bench builds it (window 1,
    the bucket covering REPLAY_ROWS rows, the bench's batcher settings),
    closed loop on the card: its sustained requests a second."""
    import numpy as np

    from distributedmnist_tpu_torch.bench import _serve_closed_loop
    from distributedmnist_tpu_torch.config import Config
    from distributedmnist_tpu_torch.serve import (DynamicBatcher,
                                                  ServeMetrics,
                                                  build_resilience,
                                                  build_serving)

    cfg = Config(model="mlp", device="cuda",
                 serve_max_batch=REPLAY_MAX_BATCH)
    metrics = ServeMetrics()
    registry, router, factory = build_serving(cfg, metrics=metrics)
    registry.bootstrap(seed=cfg.seed)
    bucket = next(b for b in factory.buckets if b >= REPLAY_ROWS)
    b = DynamicBatcher(router, max_batch=bucket,
                       max_wait_us=cfg.serve_max_wait_us,
                       queue_depth=cfg.serve_queue_depth, max_inflight=1,
                       adaptive=True,
                       resilience=build_resilience(cfg, registry=registry,
                                                   metrics=metrics),
                       metrics=metrics).start()
    req = np.random.default_rng(SEED).integers(
        0, 256, (REPLAY_ROWS, 28, 28, 1), dtype=np.uint8)
    try:
        closed = _serve_closed_loop(b, metrics, [req], REPLAY_RATE_CLIENTS,
                                    REPLAY_RATE_S)
    finally:
        b.stop()
    return {"requests_per_sec": closed["requests_per_sec"],
            "bucket": bucket, "clients": REPLAY_RATE_CLIENTS,
            "duration_s": REPLAY_RATE_S,
            "latency_ms": closed["latency_ms"]}


def replay_spec(rate: float) -> str:
    """A square train then a spike, both peaking at PEAK_OVER_STATIC x
    the static phase's sustained rate and resting at its 1/REPLAY_BURST
    share."""
    qps = round(PEAK_OVER_STATIC * rate / REPLAY_BURST, 1)
    return (f"square:qps={qps},burst={REPLAY_BURST},duty=0.35,period=2,"
            f"duration=6,rows={REPLAY_ROWS},keys=32;"
            f"spike:qps={qps},mag={REPLAY_BURST},at=1,width=1,duration=3,"
            f"rows={REPLAY_ROWS},keys=32")


def drive_replay_bench(card: str) -> tuple[dict, dict]:
    """The static phase's sustained rate measured in this process, then
    the bench's `serve --trace-replay SPEC --autoscale` on the card at a
    spec built from it. Returns (figures, the bench run's launches)."""
    import hashlib

    from distributedmnist_tpu_torch.serve import workload

    rate = static_replay_rate()
    spec = replay_spec(rate["requests_per_sec"])
    peak = max(workload._peak_rate(leg.shape, leg.params)
               for leg in workload.parse_trace_spec(spec))
    print(f"trace replay on {card}: static phase sustains "
          f"{rate['requests_per_sec']} req/s of {REPLAY_ROWS} rows "
          f"(window 1, bucket {rate['bucket']}); spec peak {peak} req/s: "
          f"{spec}", flush=True)
    here = os.path.dirname(os.path.abspath(__file__))
    env = _child_env()
    run = ("serve", "--model", "mlp", "--serve-duration", "0.5",
           "--serve-qps", "1000", "--serve-clients", "8",
           "--serve-max-batch", str(REPLAY_MAX_BATCH), "--trace-replay",
           spec, "--autoscale", "--inline", "--no-artifact")
    t0 = time.perf_counter()
    rc, rec, err = _bench_run(run, env, here)
    if rc != 0 or rec is None:
        raise RuntimeError(f"bench {run} exited {rc}:\n{err[-4000:]}")
    d = rec["detail"]
    leg = d["trace_replay"]
    want = hashlib.sha256(workload.schedule_bytes(workload.materialize(
        workload.parse_trace_spec(spec), leg["seed"]))).hexdigest()
    launches = _bench_launches(err)
    dirs = [a["direction"] for a in leg["autoscaled"]["actions"]]
    bad = []
    if set(d) != BENCH_KEYS["serve_images_per_sec_per_chip"]:
        bad.append("keys differ from the root bench's")
    if leg["schedule_sha256"] != want:
        bad.append(f"schedule_sha256 {leg['schedule_sha256']} != {want}")
    if leg["autoscaled"]["flaps"] != 0 or d["recompiles_after_warmup"]:
        bad.append(f"flaps {leg['autoscaled']['flaps']}, builds after "
                   f"warmup {d['recompiles_after_warmup']}")
    if "grow" not in dirs or "shrink" not in dirs:
        bad.append(f"scale actions {dirs}")
    if launches.get("dense_relu", 0) <= 0:
        bad.append(f"launches {launches}")
    if bad:
        raise RuntimeError(f"bench trace replay: {bad}\n"
                           f"leg: {json.dumps(leg)[:3000]}")
    figures = {
        "static_rate": rate, "spec": spec, "peak_qps": peak,
        "schedule_sha256": want, "events": leg["events"],
        "static": {k: leg["static"][k] for k in (
            "slo_attainment", "chip_seconds_per_m_requests", "shed",
            "latency_ms", "max_submit_lag_ms")},
        "autoscaled": {k: leg["autoscaled"][k] for k in (
            "slo_attainment", "chip_seconds_per_m_requests", "shed",
            "latency_ms", "max_submit_lag_ms", "scale_actions",
            "suppressed", "saturated_ticks", "flaps", "final_units")},
        "directions": dirs, "bars": leg["bars"], "slo_ms": leg["slo_ms"],
        "run_s": time.perf_counter() - t0}
    print(f"trace replay on {card}: " + json.dumps(figures), flush=True)
    return figures, launches


def drive_gateway(params: dict, card: str, direct: dict
                  ) -> tuple[dict, dict]:
    """The gateway phase (see the module docstring's phase 14): the
    gateway over HTTP, the bench's gateway run and its trace replay, each
    child reporting its own launch counts. `direct` is phase 8's MLP
    server's 1-row figures. Returns (figures, {"gateway": counts,
    "replay_autoscale": counts})."""
    t0 = time.perf_counter()
    http, http_counts = drive_gateway_http(params, card)
    bench, bench_counts = drive_gateway_bench(params, card)
    replay, replay_counts = drive_replay_bench(card)
    launches = {
        "gateway": {k: http_counts[k] + bench_counts[k]
                    for k in http_counts},
        "replay_autoscale": replay_counts}
    for path, kernel in (("gateway", "quant_dense"),
                         ("gateway", "mlp_megakernel"),
                         ("replay_autoscale", "dense_relu")):
        if launches[path].get(kernel, 0) <= 0:
            raise RuntimeError(f"{kernel} never launched on the {path} "
                               f"path: {launches[path]}")
    g, d = http["predict_1row"], direct

    def ms(r):
        return f"p50 {r['p50_ms']:.3f} ms p99 {r['p99_ms']:.3f} ms"

    print(f"gateway figures on {card}: 1-row /predict through the gateway "
          f"(2 int8 workers) {ms(g)}; phase 8's direct MLP server "
          f"(megakernel) {ms(d)}; scaling_efficiency "
          f"{bench['scaling_efficiency']} (img/s {bench['img_s_1']} -> "
          f"{bench['img_s_n']}), host_contention_x "
          f"{bench['host_contention_x']}; trace replay slo_attainment "
          f"static {replay['static']['slo_attainment']} autoscaled "
          f"{replay['autoscaled']['slo_attainment']}, "
          f"chip_seconds_per_m_requests static "
          f"{replay['static']['chip_seconds_per_m_requests']} autoscaled "
          f"{replay['autoscaled']['chip_seconds_per_m_requests']}",
          flush=True)
    figures = {"http": http, "bench": bench, "replay": replay,
               "phase_s": time.perf_counter() - t0}
    return figures, launches


ANALYSIS_REQUESTS = 256
ANALYSIS_MAX_ROWS = 16
ANALYSIS_ROW_REQUESTS = 64
ANALYSIS_DTYPES = ("float32", "int8", "megakernel")
ANALYSIS_HOT_LOCK = "chip_smoke.hot"


def _analysis_burst(front, reqs) -> tuple[list, float]:
    """`reqs` one at a time through `front` (each request alone in its
    batch, so a rerun stages every request at the same bucket and its
    logits can be held bit for bit); (answers, rows/s)."""
    t0 = time.perf_counter()
    outs = [front.submit(x).result(timeout=60) for x in reqs]
    took = time.perf_counter() - t0
    return outs, sum(x.shape[0] for x in reqs) / took


def _analysis_front(fleet, metrics):
    """A batcher over `fleet` behind a fresh prediction cache front (its
    stop() stops the batcher)."""
    from distributedmnist_tpu_torch.serve import (CacheFront,
                                                  DynamicBatcher,
                                                  PredictionCache)

    b = DynamicBatcher(fleet, max_wait_us=500, metrics=metrics).start()
    return CacheFront(b, fleet, PredictionCache(4096), metrics=metrics)


def drive_analysis(params: dict, card: str) -> tuple[dict, dict]:
    """Phase 15: the port's analysis tools on the card (see the module
    docstring). Returns (figures, {"analysis": the sanitized serving
    path's launch counts})."""
    import numpy as np

    from distributedmnist_tpu_torch.analysis import locks, sanitize
    from distributedmnist_tpu_torch.analysis import torchcheck as tc
    from distributedmnist_tpu_torch.config import Config
    from distributedmnist_tpu_torch.ops import fused
    from distributedmnist_tpu_torch.serve import (DynamicBatcher,
                                                  InferenceEngine,
                                                  ServeMetrics,
                                                  build_serving)

    t_phase = time.perf_counter()
    figures: dict = {}
    rng = np.random.default_rng(SEED + 15)
    reqs = [rng.integers(0, 256, (int(n), 28, 28, 1), dtype=np.uint8)
            for n in rng.integers(1, ANALYSIS_MAX_ROWS + 1,
                                  ANALYSIS_REQUESTS)]
    rows = [rng.integers(0, 256, (1, 28, 28, 1), dtype=np.uint8)
            for _ in range(ANALYSIS_ROW_REQUESTS)]

    # 1. the sanitized serving path: installed before anything is built
    san = sanitize.install_sanitizer()
    try:
        metrics = ServeMetrics()
        registry, fleet, _ = build_serving(Config(
            model="mlp", device="cuda", serve_max_batch=ANALYSIS_MAX_ROWS,
            serve_replicas=2), metrics=metrics)
        registry.add(params, version="fit")
        registry.promote("fit")
        for dt in ANALYSIS_DTYPES[1:]:
            registry.add_variant("fit", dt)    # a refusal fails the run
        # the fast lane's engine: a ladder whose smallest rung is 8, so a
        # one-row request takes the row-staged route
        lane = InferenceEngine("mlp", params, device="cuda",
                               max_batch=ANALYSIS_MAX_ROWS,
                               buckets=(8, ANALYSIS_MAX_ROWS))
        lane.warmup(cost_samples=3)
        row_priced_on = lane._fast_row_ok
        lane._fast_row_ok = True   # held even where warmup priced it off
        staged = []
        stage_row = lane._stage_row
        lane._stage_row = lambda host: staged.append(1) or stage_row(host)
        # every engine is built, gated and warm: from here on the counts
        # are the bursts' own, each burst's taken as a difference
        fused.reset_launches()
        sanitized: dict = {}
        rates: dict = {}
        burst_launches: dict = {}
        for dt in ANALYSIS_DTYPES:
            registry.promote("fit", infer_dtype=dt)
            front = _analysis_front(fleet, metrics)
            try:
                before = dict(fused.LAUNCHES)
                sanitized[dt], rates[dt] = _analysis_burst(front, reqs)
                burst_launches[dt] = {k: fused.LAUNCHES[k] - before[k]
                                      for k in before}
            finally:
                front.stop()
        # 64 one-row requests through the row-staged route, held to the
        # pooled path below
        lb = DynamicBatcher(lane, fastlane=True, max_inflight=4).start()
        try:
            before = dict(fused.LAUNCHES)
            lane_out = [lb.submit(x).result(timeout=60) for x in rows]
            burst_launches["fastlane"] = {k: fused.LAUNCHES[k] - before[k]
                                          for k in before}
        finally:
            lb.stop()
            del lane._stage_row
        counts = {k: sum(b[k] for b in burst_launches.values())
                  for k in fused.LAUNCHES}
        if not san.wait_drained(timeout_s=10.0):
            raise RuntimeError(f"sanitized path never drained: "
                               f"{san.balances()}")
        report = san.report()
        san.assert_clean()
    finally:
        sanitize.uninstall_sanitizer()
    # each burst through its own kernel: float32 (and the float32 lane)
    # dense_relu, int8 quant_dense, megakernel mlp_megakernel
    missing = [f"{path}: {k}" for path, k in (
        ("float32", "dense_relu"), ("int8", "quant_dense"),
        ("megakernel", "mlp_megakernel"), ("fastlane", "dense_relu"))
        if burst_launches[path][k] <= 0]
    if missing:
        raise RuntimeError(f"kernels never launched by the sanitized "
                           f"bursts: {missing} ({burst_launches})")
    if len(staged) != ANALYSIS_ROW_REQUESTS:
        raise RuntimeError(f"{len(staged)} of {ANALYSIS_ROW_REQUESTS} lane "
                           "requests took the row-staged route")
    for i, x in enumerate(rows):
        if not np.array_equal(lane_out[i], lane.infer(x)):
            raise RuntimeError(f"row-staged lane request {i} differs from "
                               "the pooled dispatch at bucket 8")
    # the same requests, the same engines, nothing installed
    unsanitized_rates: dict = {}
    for dt in ANALYSIS_DTYPES:
        registry.promote("fit", infer_dtype=dt)
        front = _analysis_front(fleet, ServeMetrics())
        try:
            outs, unsanitized_rates[dt] = _analysis_burst(front, reqs)
        finally:
            front.stop()
        for i, (a, o) in enumerate(zip(sanitized[dt], outs)):
            if not np.array_equal(a, o):
                raise RuntimeError(
                    f"{dt}: request {i}'s logits differ between the "
                    f"sanitized and the unsanitized run (max "
                    f"{float(np.abs(a - o).max())})")
    figures["serving"] = {
        "requests": ANALYSIS_REQUESTS, "row_requests": ANALYSIS_ROW_REQUESTS,
        "row_route_priced_on": row_priced_on, "report": report,
        "burst_launches": burst_launches,
        "sanitized_rows_per_s": rates,
        "unsanitized_rows_per_s": unsanitized_rates,
        "sanitized_over_unsanitized": {
            dt: rates[dt] / unsanitized_rates[dt] for dt in rates},
        "bit_equal": True}

    # 2. the declared hook is live on the card: one fetch under a hot lock
    san = sanitize.install_sanitizer()
    try:
        eng = registry.get("fit").engines[0]
        h = eng.dispatch(reqs[0])
        with locks.make_lock(ANALYSIS_HOT_LOCK):
            eng.fetch(h)
        hook = san.blocking_findings()
    finally:
        sanitize.uninstall_sanitizer()
    if [(f["kind"], f["locks"]) for f in hook] != [
            ("engine.fetch device->host sync", [ANALYSIS_HOT_LOCK])]:
        raise RuntimeError(f"the fetch hook under a hot lock: {hook}")
    figures["hook_findings"] = len(hook)

    # 3. the compile surface on the card, against the CPU snapshot
    t0 = time.perf_counter()
    targets = [t for t in tc.default_targets() if t.model == "mlp"]
    audit = tc.run_audit(targets, "cuda", with_train=False, partial=True)
    if audit["findings"] or audit["warnings"]:
        raise RuntimeError("torchcheck on the card: " + "; ".join(
            [f.format() for f in audit["findings"]] + audit["warnings"]))
    keys = sum(len(v) for v in audit["fingerprints"].values())
    figures["torchcheck"] = {"keys": keys,
                             "static_keys": audit["static_keys_total"],
                             "s": time.perf_counter() - t0}

    # 4. the explorer's smoke gate
    t0 = time.perf_counter()
    proc = CHILDREN.run(
        [sys.executable, "-m", "distributedmnist_tpu_torch.analysis.explore",
         "--smoke"], capture_output=True, text=True, timeout=300,
        cwd=os.path.dirname(os.path.abspath(__file__)), env=_child_env())
    explore_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"explore --smoke rc {proc.returncode}:\n"
                           + proc.stdout[-3000:] + proc.stderr[-2000:])
    figures["explore_s"] = explore_s
    figures["phase_s"] = time.perf_counter() - t_phase
    print("analysis_phases " + json.dumps({
        "card": card,
        "sanitized_rows_per_s": rates,
        "unsanitized_rows_per_s": unsanitized_rates,
        "explore_s": explore_s, "audited_keys": keys,
        "launches": counts, "burst_launches": burst_launches,
        "phase_s": figures["phase_s"]}), flush=True)
    print(f"analysis on {card}: " + json.dumps(figures, default=str),
          flush=True)
    return figures, {"analysis": counts}


def drive_multichip(card: str) -> tuple[dict, dict]:
    """Phase 16: the multichip dry run, torchcheck's training audit on
    the card and one calibration point, each on launch counts of its
    own."""
    from distributedmnist_tpu_torch import calibrate_synthetic, dryrun
    from distributedmnist_tpu_torch.analysis import torchcheck as tc
    from distributedmnist_tpu_torch.ops import fused

    t_phase = time.perf_counter()
    figures: dict = {"card": card}
    launches: dict = {}

    # 1. the dry run: every leg, JAX's names
    t0 = time.perf_counter()
    rec = dryrun.dryrun_multichip(DRYRUN_RANKS)
    if rec["legs"] != dryrun.dryrun_legs(DRYRUN_RANKS):
        raise RuntimeError(f"dry run legs {rec['legs']}")
    if rec["launches"]["serve-reload"]["dense_relu"] <= 0:
        raise RuntimeError("serve-reload launched no dense_relu: "
                           f"{rec['launches']}")
    launches["dryrun"] = {k: sum(n.get(k, 0)
                                 for n in rec["launches"].values())
                          for k in fused.LAUNCHES}
    figures["dryrun"] = {k: rec[k] for k in ("legs", "seconds", "losses",
                                             "launches", "backend")}
    figures["dryrun"]["s"] = time.perf_counter() - t0

    # 2. torchcheck on the card: LeNet-5's served forwards (phase 15 holds
    # the MLP's) and both training steps, against the CPU snapshot
    t0 = time.perf_counter()
    argv = ["--device", "cuda", "--models", "lenet"]
    rc = tc.main(argv)
    if rc != 0:
        raise RuntimeError(f"torchcheck {' '.join(argv)} exited {rc} (its "
                           "findings are printed above)")
    fused.reset_launches()
    fps, findings = tc.train_step_fingerprints("cuda")
    launches["train_audit"] = dict(fused.LAUNCHES)
    snap = tc.load_snapshot()["fingerprints"][tc.TRAIN_LABEL]
    if findings or fps != snap:
        raise RuntimeError(f"train fingerprints on the card {fps} against "
                           f"{snap}: {[f.format() for f in findings]}")
    if launches["train_audit"]["dense_relu"] <= 0:
        raise RuntimeError("the MLP's train step launched no dense_relu")
    figures["torchcheck"] = {"cli": argv, "rc": rc,
                             "train_fingerprints": fps,
                             "s": time.perf_counter() - t0}

    # 3. the calibration at the set's own constants
    t0 = time.perf_counter()
    fused.reset_launches()
    rows = calibrate_synthetic.calibrate(
        [CALIBRATION_POINT], ["mlp", "lenet"], CALIBRATION_EPOCHS, 60_000,
        10_000, "cuda")
    launches["calibration"] = dict(fused.LAUNCHES)
    print(calibrate_synthetic.format_table(rows, ["mlp", "lenet"]),
          flush=True)
    accs = rows[0]["accuracy"]
    if not all(0.1 < a <= 1.0 for a in accs.values()):
        raise RuntimeError(f"calibration accuracies {accs}")
    if launches["calibration"]["dense_relu"] <= 0:
        raise RuntimeError("the MLP's calibration fit launched no "
                           "dense_relu")
    figures["calibration"] = {"row": rows[0], "s": time.perf_counter() - t0}
    figures["launches"] = launches
    figures["phase_s"] = time.perf_counter() - t_phase
    print("dryrun_phases " + json.dumps(figures), flush=True)
    return figures, launches


def _group_gate(model: str, dt: str, ref, got) -> dict:
    """The two-shard engine against the one-card engine on the same rows:
    int8 bit for bit (exact products); float32 at the card tests'
    tolerance (rtol 1e-5, atol 1e-5 x the largest logit, 1e-4 x for
    LeNet-5: cuDNN may pick another algorithm at another row count), so
    a shard that computed in a lower precision fails; bfloat16 and the
    megakernel within their parity gates."""
    import numpy as np

    from distributedmnist_tpu_torch.serve import PARITY_GATES
    from distributedmnist_tpu_torch.utils import parity_check

    if ref.shape != got.shape:
        raise RuntimeError(f"card group {model} {dt}: shape {got.shape}, "
                           f"want {ref.shape}")
    if dt == "int8":
        if ref.tobytes() != got.tobytes():
            raise RuntimeError(f"card group {model} int8: not bit for bit "
                               "the one-card engine's")
        return {"bitwise": True}
    if dt == "float32":
        err = np.abs(got - ref)
        atol = ((1e-4 if model == "lenet" else 1e-5)
                * max(1.0, float(np.abs(ref).max())))
        if not (np.isfinite(got).all()
                and (err <= atol + 1e-5 * np.abs(ref)).all()):
            raise RuntimeError(f"card group {model} float32: max abs "
                               f"logit diff {float(err.max())} over atol "
                               f"{atol} + rtol 1e-5")
        return {"bitwise": ref.tobytes() == got.tobytes(),
                "max_abs_logit_diff": float(err.max()), "atol": atol}
    rep = parity_check(ref, got, *PARITY_GATES[dt])
    if not rep["passed"]:
        raise RuntimeError(f"card group {model} {dt}: {rep['why']}")
    return {"bitwise": ref.tobytes() == got.tobytes(),
            **{k: rep[k] for k in ("argmax_agreement",
                                   "max_rel_logit_diff",
                                   "max_abs_logit_diff")}}


def drive_card_group(params: dict, lenet_params: dict,
                     card: str) -> tuple[dict, dict]:
    """Phase 17: serving over a card group, as the JAX engine shards each
    batch over its 'data' mesh. On the one card, a registry whose factory
    is the group [cuda:0, cuda:0] (two shards, each half of every bucket
    on the card) serves the MLP at float32, bfloat16, int8 and the
    megakernel and LeNet-5 at float32, bfloat16 and int8, each variant
    through its parity gate: the live engine at GROUP_ROWS row counts,
    its fast lane (a 1-row request on the row route, a 2-row exact fit)
    and a batcher burst, each held against a one-card engine of the same
    weights. The counts are the group's calls only, taken as
    differences: every kernel must launch. With two or more cards,
    `serve --num-devices 2` answers /predict and the bench's serve mode
    runs over every card (n_chips the card count); on one card they are
    skipped, and a line says so."""
    import numpy as np
    import torch

    from distributedmnist_tpu_torch.bench import _drain_or_die
    from distributedmnist_tpu_torch.data import synthetic_mnist
    from distributedmnist_tpu_torch.ops import fused
    from distributedmnist_tpu_torch.serve import (DynamicBatcher,
                                                  EngineFactory,
                                                  InferenceEngine,
                                                  ModelRegistry,
                                                  ServeMetrics)
    from distributedmnist_tpu_torch.serve.quantize import PARITY_SEED

    t_phase = time.perf_counter()
    group = [torch.device("cuda", 0)] * 2
    launched = {k: 0 for k in fused.LAUNCHES}
    figures: dict = {"card": card, "devices": [str(d) for d in group]}
    rng = np.random.default_rng(SEED + 17)
    # held-out digits of the distribution both models were fit on (the
    # parity batch's): random pixels leave near-tie logits, which a
    # bfloat16 sum in another order flips
    x = np.asarray(synthetic_mnist(seed=PARITY_SEED, train_n=16,
                                   test_n=GROUP_MAX_BATCH)["test_x"])

    def counted(fn):
        before = dict(fused.LAUNCHES)
        out = fn()
        for k in launched:
            launched[k] += fused.LAUNCHES[k] - before[k]
        return out

    for model, p, dtypes in (
            ("mlp", params, ("float32", "bfloat16", "int8", "megakernel")),
            ("lenet", lenet_params, ("float32", "bfloat16", "int8"))):
        factory = EngineFactory(model, device="cuda",
                                max_batch=GROUP_MAX_BATCH, devices=group)
        if factory.n_chips != 2 or factory.buckets[0] != 2:
            raise RuntimeError(f"card group {model}: n_chips "
                               f"{factory.n_chips}, buckets "
                               f"{factory.buckets}")
        metrics = ServeMetrics()
        router = factory.make_router(metrics=metrics)
        registry = ModelRegistry(factory, router)
        batcher = DynamicBatcher(router, max_batch=GROUP_MAX_BATCH,
                                 max_wait_us=500, metrics=metrics).start()
        try:
            registry.add(p, version="v1")
            registry.promote("v1")
            for dt in dtypes:
                t0 = time.perf_counter()
                if dt != "float32":
                    registry.add_variant("v1", dt)   # a refusal fails
                registry.promote("v1", infer_dtype=dt)
                mv = registry.get("v1")
                eng = mv.engine if dt == "float32" else \
                    mv.variants[dt].engine
                if eng.n_chips != 2 or eng.devices != group:
                    raise RuntimeError(f"card group {model} {dt}: engine "
                                       f"over {eng.devices}")
                one = InferenceEngine(model, p, device="cuda",
                                      max_batch=GROUP_MAX_BATCH,
                                      infer_dtype=dt)
                rows = {}
                for n in GROUP_ROWS:
                    got = counted(lambda: eng.infer(x[:n]))
                    rows[n] = _group_gate(model, dt, one.infer(x[:n]),
                                          got)
                # the fast lane: the row route (priced at warmup; forced
                # on here, so that it is driven) and an exact fit
                row_ok = eng._fast_row_ok
                eng._fast_row_ok = True
                try:
                    h = counted(lambda: eng.dispatch_fast(x[:1]))
                    if h is None:
                        raise RuntimeError(f"card group {model} {dt}: the "
                                           "row route did not serve")
                    lane = {"row": _group_gate(
                        model, dt, one.infer(x[:1]), eng.fetch(h))}
                finally:
                    eng._fast_row_ok = row_ok
                h = counted(lambda: eng.dispatch_fast(x[:2]))
                if h is None:
                    raise RuntimeError(f"card group {model} {dt}: no "
                                       "exact-fit route for 2 rows")
                lane["exact"] = _group_gate(model, dt, one.infer(x[:2]),
                                            eng.fetch(h))
                # the batcher over the router, as a server drives it
                sizes = rng.integers(1, 9, GROUP_BURST)
                offs = np.concatenate([[0], np.cumsum(sizes)[:-1]])

                def burst():
                    futs = [batcher.submit(x[o:o + n])
                            for o, n in zip(offs, sizes)]
                    out = np.concatenate([f.result(timeout=120)
                                          for f in futs])
                    _drain_or_die(batcher, timeout=120)
                    return out

                got = counted(burst)
                want = np.concatenate([one.infer(x[o:o + n])
                                       for o, n in zip(offs, sizes)])
                figures[f"{model} {dt}"] = {
                    "rows": rows[GROUP_MAX_BATCH], "rows_1": rows[1],
                    "fastlane": lane,
                    "fast_row_priced_on": row_ok,
                    "burst": _group_gate(model, dt, want, got),
                    "bucket_cost_ms": {
                        str(b): round(c * 1e3, 4)
                        for b, c in sorted(eng.bucket_costs().items())},
                    "s": time.perf_counter() - t0}
                print(f"card group {model} {dt}: "
                      f"{json.dumps(figures[f'{model} {dt}'])}",
                      flush=True)
        finally:
            batcher.stop()
    missing = [k for k in SERVING_KERNELS if launched[k] <= 0]
    if missing:
        raise RuntimeError(f"kernels never launched on the card group: "
                           f"{missing}")

    n_cards = torch.cuda.device_count()
    if n_cards >= 2:
        figures["cards"] = drive_card_group_cards(n_cards, launched)
    else:
        print("card group: one card visible; serve --num-devices 2 and "
              "the bench over every card are skipped", flush=True)
    figures["launches"] = dict(launched)
    figures["phase_s"] = time.perf_counter() - t_phase
    print("card_group_phases " + json.dumps(figures), flush=True)
    return figures, {"card_group": launched}


def drive_card_group_cards(n_cards: int, launched: dict) -> dict:
    """With two or more cards: `serve --num-devices 2` over HTTP (its
    /models names both cards; a 64-row /predict and single rows answer,
    the classes those of a one-card engine of the same fresh-init
    weights on 99% of rows or more), then the bench's serve mode over
    every card (n_chips the card count). Their launch counts add to
    `launched`."""
    import numpy as np

    from distributedmnist_tpu_torch import models
    from distributedmnist_tpu_torch.ops import fused
    from distributedmnist_tpu_torch.serve import InferenceEngine

    here = os.path.dirname(os.path.abspath(__file__))
    env = _child_env()
    out: dict = {"visible": n_cards}
    srv = start_server(["--model", "mlp", "--num-devices", "2",
                        "--serve-max-batch", str(GROUP_HTTP_ROWS)],
                       env, here)
    try:
        healthy(srv)
        desc = srv.ok("/models")
        if desc.get("devices") != ["cuda:0", "cuda:1"]:
            raise RuntimeError(f"serve --num-devices 2: devices "
                               f"{desc.get('devices')}")
        rng = np.random.default_rng(SEED + 18)
        x = rng.integers(0, 256, (GROUP_HTTP_ROWS, 784), dtype=np.uint8)
        want = InferenceEngine("mlp", models.init_params("mlp", SEED),
                               device="cuda", max_batch=GROUP_HTTP_ROWS
                               ).infer(x).argmax(axis=1)
        got = np.asarray(srv.ok("/predict", data=x.tobytes())["classes"])
        singles = [srv.ok("/predict", data=x[i].tobytes())["classes"][0]
                   for i in range(4)]
        agree = float(np.mean(got == want))
        if got.shape != (GROUP_HTTP_ROWS,) or agree < 0.99 \
                or singles != list(got[:4]):
            raise RuntimeError(f"serve --num-devices 2: classes agree "
                               f"{agree}, singles {singles}")
        out["serve_2"] = {"devices": desc["devices"], "agreement": agree}
    finally:
        summary, counts = stop_server(srv)
    for k in launched:
        launched[k] += counts[k]
    rc, rec, err = _bench_run(list(GROUP_BENCH_RUN), env, here)
    if rc != 0 or rec is None:
        raise RuntimeError(f"bench serve over every card exited {rc}:\n"
                           f"{err[-4000:]}")
    if rec["detail"]["n_chips"] != n_cards:
        raise RuntimeError(f"bench serve over every card: n_chips "
                           f"{rec['detail']['n_chips']}, {n_cards} visible")
    for k, n in fused.parse_launches(err, "bench: launches ")[-1].items():
        launched[k] += n
    out["bench"] = {"n_chips": rec["detail"]["n_chips"],
                    "value": rec["value"],
                    "buckets": rec["detail"]["buckets"]}
    print(f"card group over {n_cards} cards: {json.dumps(out)}", flush=True)
    return out


def main() -> int:
    """The bytecode cache and the fork server first, before anything
    touches CUDA; then every phase, the fork server stopped at the end
    whatever happened."""
    global CHILDREN
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    import distributedmnist_tpu_torch  # noqa: F401  (the repository here)

    use_bytecode_cache()
    CHILDREN = Children(ForkServer(_child_env(), here))
    try:
        return run_phases()
    finally:
        CHILDREN.close()


def run_phases() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this "
              "script needs a CUDA card", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    import numpy as np

    from distributedmnist_tpu_torch import checkpoint
    from distributedmnist_tpu_torch.data import synthetic_mnist
    from distributedmnist_tpu_torch.ops import fused, kernel_lib
    from distributedmnist_tpu_torch.utils.device import training_numerics

    card = CHILDREN.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase_s: dict = {}
    t_mark = [time.perf_counter()]

    def lap(name: str) -> None:
        now = time.perf_counter()
        phase_s[name] = now - t_mark[0]
        t_mark[0] = now
        CHILDREN.lap(name)

    # the kernels build while the fork server comes up and a child of it
    # fills the bytecode cache with the port's modules
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        build = pool.submit(kernel_lib.build_all, force=True)
        fill = CHILDREN.run([sys.executable, "-c", _FILL_CACHE], cwd=here,
                            env=_child_env(), capture_output=True,
                            text=True, timeout=FORK_SERVER_READY_S)
        fill_s = time.perf_counter() - t0
        reports = build.result()
    if fill.returncode != 0:
        raise RuntimeError(f"filling the bytecode cache exited "
                           f"{fill.returncode}:\n{fill.stderr[-3000:]}")
    print(f"built {len(reports)} kernel libraries in "
          f"{time.perf_counter() - t0:.1f}s; the fork server up and the "
          f"bytecode cache filled in {fill_s:.1f}s", flush=True)
    for source, report in sorted(reports.items()):
        for line in report.splitlines():
            if ("ptxas" in line or "spill" in line
                    or "error" in line.lower()):
                print(f"{source}: {line.strip()}", flush=True)
    lap("1 build")

    params = fit_params(FIT_SEED)
    images = synthetic_mnist(seed=SEED, train_n=16,
                             test_n=max(BUCKETS))["test_x"]
    t0 = time.perf_counter()
    data = synthetic_mnist(seed=SEED)      # full size: 60,000 / 10,000
    lenet_data = synthetic_mnist(seed=LENET_SEED)
    print(f"synthetic MNIST {data['train_x'].shape[0]}/"
          f"{data['test_x'].shape[0]}, twice (seeds {SEED} and "
          f"{LENET_SEED}), made in {time.perf_counter() - t0:.1f}s",
          flush=True)
    records = check_kernels(itertools.chain(
        kernel_cases(params, np.asarray(images)), training_cases(data),
        rest_cases(params, data)))
    with training_numerics():
        records += check_kernels(conv_wgrad_cases(data))
    time_forwards("mlp", params, np.asarray(images),
                  ("float32", "bfloat16", "int8", "megakernel"))
    compare_training_step(data)
    lap("2 kernels")

    fused.reset_launches()
    phases = drive_serving_path(params)
    launches = {"serving": dict(fused.LAUNCHES)}
    print("phases " + json.dumps(phases), flush=True)
    missing = [k for k in SERVING_KERNELS if launches["serving"][k] <= 0]
    if missing:
        raise RuntimeError(f"kernels never launched on the serving path: "
                           f"{missing}")
    lap("3 serving")

    with tempfile.TemporaryDirectory() as lenet_ckpt:
        fused.reset_launches()
        phases = drive_training_path(data, lenet_data, lenet_ckpt)
        launches["training"] = dict(fused.LAUNCHES)
        print("train_phases " + json.dumps(phases), flush=True)
        if launches["training"]["dense_relu"] <= 0:
            raise RuntimeError("dense_relu never launched on the training "
                               "path")
        lap("4 training")

        fused.reset_launches()
        phases, launches["dp_training"] = drive_dp_path(card)
        print("dp_phases " + json.dumps(phases), flush=True)
        if launches["dp_training"]["dense_relu"] <= 0:
            raise RuntimeError("dense_relu never launched on the "
                               "data-parallel training path")
        lap("5 data parallel")

        fused.reset_launches()
        t0 = time.perf_counter()
        phases, children = drive_rest_of_training(card, data)
        launches["rest_training"] = {k: fused.LAUNCHES[k] + children[k]
                                     for k in fused.LAUNCHES}
        phases["phase_s"] = time.perf_counter() - t0
        print("rest_phases " + json.dumps(phases), flush=True)
        if launches["rest_training"]["dense_relu"] <= 0:
            raise RuntimeError("dense_relu never launched on the rest of "
                               "the training path")
        lap("10 rest of training")

        lenet_params, _ = checkpoint.restore_latest_params(lenet_ckpt)
        held = synthetic_mnist(seed=LENET_SEED, train_n=16,
                               test_n=max(BUCKETS))["test_x"]
        records += check_kernels(lenet_kernel_cases(lenet_params, held))
        time_forwards("lenet", lenet_params, held,
                      ("float32", "bfloat16", "int8"))
        lap("6 lenet kernels")

        fused.reset_launches()
        phases = drive_lenet_serving_path(lenet_ckpt, lenet_data)
        launches["lenet_serving"] = dict(fused.LAUNCHES)
        print("lenet_phases " + json.dumps(phases), flush=True)
        missing = [k for k in ("dense_relu", "quant_dense")
                   if launches["lenet_serving"][k] <= 0]
        if missing:
            raise RuntimeError(f"kernels never launched on the LeNet "
                               f"serving path: {missing}")
        lap("7 lenet serving")

        http_phases, http_launches = drive_http_path(params, lenet_ckpt,
                                                     card)
        launches.update(http_launches)
        print("http_phases " + json.dumps(http_phases), flush=True)
        lap("8 http")

        fused.reset_launches()
        launches["bench"] = drive_bench_path(lenet_ckpt)
        missing = [k for k in ("dense_relu", "quant_dense")
                   if launches["bench"].get(k, 0) <= 0]
        if missing:
            raise RuntimeError(f"kernels never launched on the bench "
                               f"path: {missing}")
        fused.reset_launches()
        launches["bench_ranks"] = drive_bench_ranks_path(card)
        if launches["bench_ranks"].get("dense_relu", 0) <= 0:
            raise RuntimeError("dense_relu never launched on the bench's "
                               "path over ranks")
        lap("9 bench")

        from distributedmnist_tpu_torch.serve.quantize import PARITY_SEED

        t0 = time.perf_counter()
        parity_rows = np.asarray(synthetic_mnist(
            seed=PARITY_SEED, train_n=16, test_n=FASTLANE_ROWS)["test_x"])
        request_phases, launches["fastlane"] = drive_fastlane(
            params, lenet_params, parity_rows, parity_rows)
        fused.reset_launches()
        request_phases["bench"], launches["bench_request"] = \
            drive_request_bench()
        request_phases["http"], http_launches = drive_request_http(params,
                                                                   card)
        launches.update(http_launches)
        request_phases["phase_s"] = time.perf_counter() - t0
        print("request_phases " + json.dumps(request_phases), flush=True)
        lap("11 request path")

        _, fleet_launches = drive_fleet_and_cascade(params, lenet_ckpt,
                                                    card)
        launches.update(fleet_launches)
        lap("12 fleet and cascade")

        _, tenancy_launches = drive_tenancy(params, lenet_ckpt, card)
        launches.update(tenancy_launches)
        lap("13 tenancy")

        _, gateway_launches = drive_gateway(
            params, card, http_phases["mlp"]["predict_1row"])
        launches.update(gateway_launches)
        lap("14 gateway")

    _, analysis_launches = drive_analysis(params, card)
    launches.update(analysis_launches)
    lap("15 analysis")

    _, multichip_launches = drive_multichip(card)
    launches.update(multichip_launches)
    lap("16 multichip")

    _, group_launches = drive_card_group(params, lenet_params, card)
    launches.update(group_launches)
    lap("17 card group")

    starts = import_seconds()
    lap("18 import probe")

    line = []
    for name in SERVING_KERNELS:
        timed = next(r for r in records if r["name"] == name
                     and r["case"].endswith(f"b={TIMED_ROWS}"))
        line.append({
            "name": name, "route": "cuda",
            "source": f"distributedmnist_tpu_torch/csrc/{name}.cu",
            "replaces": TPU_KERNELS[name],
            "launches": sum(n[name] for n in launches.values()),
            "launches_by_path": {path: n[name]
                                 for path, n in launches.items()},
            "fleet": launches["fleet"][name],
            "cascade": launches["cascade"][name],
            "tenancy": launches["tenancy"][name],
            "gateway": launches["gateway"][name],
            "replay_autoscale": launches["replay_autoscale"][name],
            "sanitized": launches["analysis"][name],
            "dryrun": launches["dryrun"][name],
            "train_audit": launches["train_audit"][name],
            "calibration": launches["calibration"][name],
            "card_group": launches["card_group"][name],
            "max_abs_err": max(r["max_abs_err"] for r in records
                               if r["name"] == name),
            "ms": timed["ms"], "plain_ms": timed["plain_ms"],
            "bound_ms": timed["bound_ms"], "bound_by": timed["bound_by"],
            "library_ms": timed["library_ms"], "case": timed["case"]})
        # the fast route's shape (b = 1) beside its bound and library
        b1 = next(r for r in records if r["name"] == name
                  and r["case"].endswith(" b=1"))
        line[-1]["fastlane"] = {
            "launches": launches["fastlane"][name],
            **{k: b1[k] for k in ("case", "ms", "plain_ms", "bound_ms",
                                  "bound_by", "library_ms",
                                  "max_abs_err")}}
    # LeNet's dense shapes on its serving path, each beside its bound
    for entry in line:
        lenet = [{k: r[k] for k in ("case", "ms", "plain_ms", "bound_ms",
                                    "bound_by", "library_ms",
                                    "max_abs_err")}
                 for r in records if r["name"] == entry["name"]
                 and r["case"].startswith("lenet ")]
        if lenet:
            entry["lenet_shapes"] = lenet
    # LeNet's conv1 weight gradient, a kernel of training alone
    name = "conv_wgrad_1ch"
    timed = next(r for r in records if r["name"] == name)
    line.append({
        "name": name, "route": "cuda",
        "source": f"distributedmnist_tpu_torch/csrc/{name}.cu",
        "replaces": None,
        "launches": sum(n.get(name, 0) for n in launches.values()),
        "launches_by_path": {path: n.get(name, 0)
                             for path, n in launches.items()},
        **{k: timed[k] for k in ("case", "max_abs_err", "ms", "plain_ms",
                                 "bound_ms", "bound_by", "library_ms")}})
    # the rest of training's new shapes, each case beside its bound
    line[0]["new_shapes"] = [
        {k: r[k] for k in ("case", "ms", "plain_ms", "bound_ms", "bound_by",
                           "library_ms", "max_abs_err")}
        for r in records if r["case"].startswith(("f32 tp", "bf16 train",
                                                  "bf16 bench"))]
    print(json.dumps({"kernels": line}), flush=True)
    phase_s["total"] = sum(phase_s.values())
    print("phase_seconds " + json.dumps(phase_s), flush=True)
    print("children " + json.dumps(CHILDREN.phases), flush=True)
    print("import_seconds " + json.dumps(starts), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception as exc:
        # a phase's message may end in a long child log or record: the
        # reason (its first line) goes last, where a log's tail shows it
        import traceback

        traceback.print_exc()
        head = (str(exc).splitlines() or [""])[0]
        print(f"chip_smoke FAILED: {type(exc).__name__}: {head[:1500]}",
              file=sys.stderr, flush=True)
        sys.exit(1)
