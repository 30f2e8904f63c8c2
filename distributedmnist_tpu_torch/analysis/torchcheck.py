"""Compile-surface auditor for the port: prove the serving fleet's key
universe closed, transfer-clean and fully warmed, and pin every served
forward's op sequence — the counterpart of the JAX package's
analysis/jaxcheck.py.

The port's engines run eager PyTorch over three prebuilt CUDA kernels:
there is no jit cache, but there is still a key universe. One engine
serves one (model, infer_dtype) forward at each rung of its bucket
ladder, plus the fast lane's row-staged program (engine.fast_row_bucket)
where the ladder has one; a rung that warmup never ran pays its first
kernel-library load, its first cuBLAS/cuDNN plan and its first caching-
allocator growth on the hot path. Five rules, mirroring JX001-JX005:

1. **Closed key universe** (TX001/TX002). The REACHABLE side is the
   image of bucket_for over every admissible size 1..max_batch, plus the
   row rung; the WARMED side comes from running the real
   `InferenceEngine.warmup` (the fast lane's `_warm_fastlane` included)
   against a shape-recording probe, so a warmup edit that skips a rung
   is caught, not assumed away. The dtype set mirrors what the
   registry's go_live / activate_infer_dtype warms (registry.PARITY_GATES,
   filtered by quantize.variant_supported).
2. **Transfer hygiene** (TX003). Each served forward is recorded by a
   TorchDispatchMode: an op argument that is neither the staged input,
   a tensor the engine placed at construction (its parameters or
   prepared weights), nor the output of an earlier op of the same
   forward is host data captured by the forward — on the card an
   implicit host->device copy outside the engine's staging. A tensor
   made from host data inside the forward (torch.tensor -> lift_fresh)
   is one too, and on the card so is any non-scalar CPU tensor argument.
3. **float64** (TX004) anywhere in a served forward's recorded ops.
4. **Op-sequence fingerprints** (TX005). Each forward's canonical op
   sequence — aten op names with their arguments' shapes, dtypes and
   scalar values, no device and no data — is hashed and held against the
   committed snapshot (analysis/graph_fingerprints.json). Each
   ops/fused.py kernel wrapper is recorded as ONE op named after its
   kernel (kernel.dense_relu, kernel.quant_dense, kernel.mlp_megakernel)
   and its plain version's interior is not recorded, so one key gives
   one fingerprint on the CPU basis and on the card, where the wrapper
   launches the kernel. Refresh the snapshot with
   `--update-snapshots --reason '...'`.

The training step is audited too (train_step_fingerprints, the
counterpart of jaxcheck's): one call of trainer.make_train_step for each
model's preset optimizer at JAX's canonical geometry, its forward,
backward and optimizer update recorded by the same dispatch mode under
TX003-TX005, in the snapshot's `train` label.

(JX004's weak-type half has no eager counterpart: a Python scalar is a
value, not a cache key — see lint.INAPPLICABLE.)

CLI: `python -m distributedmnist_tpu_torch.analysis.torchcheck` — exit 0
on a closed, clean, snapshot-matching surface; 1 on findings; 2 on an
internal error. `--emit` writes an ANALYSIS_torch_r*.json round record.
It audits on the card unless given `--device cpu`, the snapshot's basis
(and the only device `--update-snapshots` writes from); without a card
and without `--device cpu` it exits 2.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import hashlib
import json
import os
import sys
import threading
from typing import Optional, Sequence

import numpy as np

RULES = {
    "TX001": (
        "reachable-but-unwarmed serving key",
        "a bucket rung (or the fast lane's row rung) a live request "
        "could land in that warmup never ran: the first request to hit "
        "it pays the first kernel-library load, cuBLAS/cuDNN plan and "
        "caching-allocator growth on the hot path — the tail-latency "
        "poison the warmup contract exists to prevent"),
    "TX002": (
        "warmed-but-unreachable serving key",
        "a rung warmup runs that no admissible request size can reach: "
        "dead warmup cost on every version load and swap"),
    "TX003": (
        "implicit host->device copy in a served forward",
        "the forward uses host data — a tensor it captured rather than "
        "took as its staged input or the engine's resident weights, a "
        "tensor made from host data inside it, or (on the card) a CPU "
        "tensor argument — so bytes bypass the engine's pooled pinned "
        "staging and move on every call (lint DML012 is the AST-level "
        "sibling in serve/)"),
    "TX004": (
        "float64 in a served forward",
        "the served precisions are float32, bfloat16 and int8: a "
        "float64 value anywhere in the forward is silent precision and "
        "bandwidth drift (on the card, float64 runs at a fraction of "
        "the float32 rate)"),
    "TX005": (
        "op-sequence fingerprint drift vs the committed snapshot",
        "a served forward changed without the snapshot being "
        "regenerated: either an intended forward edit missing its "
        "`--update-snapshots --reason` paper trail, or an unintended "
        "graph change riding along in a refactor — both must fail "
        "until stated"),
}

SNAPSHOT_BASENAME = "graph_fingerprints.json"
_IMAGE_SHAPE = (28, 28, 1)
# ops/fused.py's kernel wrappers, recorded as one op each
_KERNEL_WRAPPERS = {"dense_relu_inference": "kernel.dense_relu",
                    "quant_dense": "kernel.quant_dense",
                    "mlp_megakernel": "kernel.mlp_megakernel"}
_KEY_COMPONENTS = ("model", "infer_dtype", "bucket")
# the training audit: each model's preset optimizer and rate (configs 1
# and 2), and JAX's canonical geometry (a device-resident set of
# TRAIN_N packed rows, one index block of TRAIN_BATCH, one step a call)
TRAIN_PRESETS = {"mlp": ("sgd", 0.1), "lenet": ("adam", 1e-3)}
TRAIN_N, TRAIN_BATCH = 2048, 512
TRAIN_LABEL = "train"


def snapshot_path() -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        SNAPSHOT_BASENAME)


@dataclasses.dataclass
class Finding:
    rule: str
    key: str          # the serving key / snapshot key the finding names
    message: str

    def format(self) -> str:
        return f"{self.rule} [{self.key}] {self.message}"


def key_str(model: str, infer_dtype: str, bucket) -> str:
    return f"{model}/{infer_dtype}/b{bucket}"


# -- the audited deployment shape ------------------------------------------


@dataclasses.dataclass(frozen=True)
class AuditTarget:
    """One deployment shape: the knobs that decide which forwards the
    registry could ever serve. `buckets` overrides the ladder
    make_buckets(serve_max_batch, n_chips) would give. With n_chips > 1
    the engine is a group engine (data-parallel over n_chips devices,
    as jaxcheck's n_chips mesh): each rung b runs n_chips shard forwards
    of b / n_chips rows, and the audit records that shard forward."""

    model: str
    serve_max_batch: int = 512
    serve_infer_dtype: str = "auto"
    buckets: Optional[tuple] = None
    n_chips: int = 1

    def ladder(self) -> tuple:
        from distributedmnist_tpu_torch.serve.engine import make_buckets

        return (tuple(sorted(set(self.buckets))) if self.buckets
                else make_buckets(self.serve_max_batch, self.n_chips))

    def label(self) -> str:
        lad = "" if not self.buckets else (
            "-b" + "_".join(str(b) for b in self.ladder()))
        chips = f"-c{self.n_chips}" if self.n_chips > 1 else ""
        return (f"{self.model}-mb{self.serve_max_batch}{chips}"
                f"-{self.serve_infer_dtype}{lad}")


def default_targets() -> list:
    """The gate's audit set: both models at the canonical ladder
    (1..512) over the full auto dtype universe, and the MLP on a ladder
    whose smallest rung is 8, so the fast lane's row-staged program is
    audited and fingerprinted too (chip_smoke.py serves that one)."""
    return [AuditTarget(model="mlp"), AuditTarget(model="lenet"),
            AuditTarget(model="mlp", serve_max_batch=16,
                        buckets=(8, 16))]


def dtype_universe(serve_infer_dtype: str) -> tuple:
    """Every serving precision the registry could route for this
    setting: float32 always (bootstrap promotes it, and a refused
    variant demotes back to it) plus the gated variant set —
    registry.PARITY_GATES is read live, so a new variant widens the
    audited universe automatically."""
    from distributedmnist_tpu_torch.serve.registry import PARITY_GATES

    if serve_infer_dtype == "auto":
        return ("float32",) + tuple(sorted(PARITY_GATES))
    if serve_infer_dtype == "float32":
        return ("float32",)
    if serve_infer_dtype not in PARITY_GATES:
        raise ValueError(
            f"unknown serve_infer_dtype {serve_infer_dtype!r} (known: "
            f"float32, auto, {sorted(PARITY_GATES)})")
    return ("float32", serve_infer_dtype)


def served_dtypes(model: str, serve_infer_dtype: str) -> tuple:
    """dtype_universe filtered by what the model can build (the
    megakernel exists for the MLP only; the registry's activation skips
    an unsupported variant, so the audit does too)."""
    from distributedmnist_tpu_torch.serve.quantize import variant_supported

    return tuple(dt for dt in dtype_universe(serve_infer_dtype)
                 if variant_supported(model, dt))


# -- key universe: reachable vs warmed -------------------------------------


def reachable_buckets(buckets: Sequence[int], max_batch: int) -> set:
    """Rungs an admissible request could land in: the image of
    bucket_for over sizes 1..max_batch, plus the fast lane's row rung as
    the string '<rung>-row' when the ladder has one (derived from the
    engine's own fast_row_bucket, so it cannot drift from what
    dispatch_fast routes)."""
    from distributedmnist_tpu_torch.serve.engine import fast_row_bucket

    ladder = sorted(set(buckets))
    out: set = set()
    for n in range(1, max_batch + 1):
        for b in ladder:
            if b >= n:
                out.add(b)
                break
    rb = fast_row_bucket(buckets)
    if rb is not None:
        out.add(f"{rb}-row")
    return out


class _WarmupProbe:
    """A shape-recording engine double the REAL InferenceEngine.warmup
    and _warm_fastlane run against: the engine's own bucketing, row-host
    pool and row staging, with infer() and _launch() recording the rung
    they would serve instead of computing. The warmed set is derived
    from the warmup CODE, not from a model of it."""

    def __init__(self, buckets: Sequence[int], infer_dtype: str,
                 n_chips: int = 1):
        import torch

        from distributedmnist_tpu_torch.serve.engine import (
            InferenceEngine, fast_row_bucket)

        self.buckets = tuple(sorted(set(buckets)))
        self.infer_dtype = infer_dtype
        self.device = torch.device("cpu")
        self.devices = [self.device] * n_chips
        self.n_chips = n_chips
        self.streams = [None] * n_chips
        self.stream = None
        self._pin = False
        self.warmed: set = set()
        self._bucket_cost: dict = {}
        self._bucket_cost_p95: dict = {}
        self._staging_lock = threading.Lock()
        self._fast_out_pool = {b: [] for b in self.buckets}
        self._fast_row_hosts: list = []
        self._fast_row_b = fast_row_bucket(self.buckets)
        self._fast_row_buf = None
        self._fast_row_lock = threading.Lock()
        self._fast_row_ok = False
        self._fast_row_cost = None
        eng = InferenceEngine
        for name in ("bucket_for", "_warm_fastlane", "_on_stream",
                     "_fast_out_take", "_fast_out_put", "_row_host_take",
                     "_row_host_put", "_stage_row", "_launch_row"):
            setattr(self, name, getattr(eng, name).__get__(self))

    def infer(self, x) -> None:
        self.warmed.add(self.bucket_for(np.asarray(x).shape[0]))

    def _launch(self, x_dev, out) -> None:
        if x_dev is self._fast_row_buf:
            self.warmed.add(f"{self._fast_row_b}-row")
        else:
            self.warmed.add(self.bucket_for(x_dev.shape[0]))
        return None


def warmed_buckets(buckets: Sequence[int], infer_dtype: str,
                   n_chips: int = 1) -> set:
    """The rungs `InferenceEngine.warmup` actually runs for one engine
    of this ladder over n_chips devices (module-level so tests can plant
    a regression)."""
    from distributedmnist_tpu_torch.serve.engine import InferenceEngine

    probe = _WarmupProbe(buckets, infer_dtype, n_chips)
    InferenceEngine.warmup(probe, cost_samples=1)
    return probe.warmed


def crosscheck_keys(model: str, static: dict, warmed: dict,
                    max_batch: int) -> list:
    """TX001/TX002: reachable vs warmed key sets, both given as
    {infer_dtype: set(rungs)}."""
    findings = []
    for dt in sorted(set(static) | set(warmed)):
        reach = static.get(dt, set())
        warm = warmed.get(dt, set())
        for b in sorted(reach - warm, key=str):
            findings.append(Finding(
                "TX001", key_str(model, dt, b),
                f"rung {b} is reachable (requests of <= {max_batch} "
                "rows can land in it) but warmup never runs it — the "
                "first such request pays its first load on the hot "
                "path"))
        for b in sorted(warm - reach, key=str):
            findings.append(Finding(
                "TX002", key_str(model, dt, b),
                f"rung {b} is warmed but no admissible request size "
                f"(1..{max_batch}) can reach it — dead warmup cost on "
                "every load and swap"))
    return findings


# -- recording a served forward --------------------------------------------


def _describe(a) -> str:
    """Canonical text of one op argument: tensors by shape and dtype,
    containers element-wise, scalars by value; never a device, an
    address or data."""
    import torch

    if isinstance(a, torch.Tensor):
        return f"T{tuple(a.shape)}:{str(a.dtype).replace('torch.', '')}"
    if isinstance(a, (list, tuple)):
        return "[" + ",".join(_describe(x) for x in a) + "]"
    if isinstance(a, torch.dtype):
        return str(a).replace("torch.", "")
    if isinstance(a, (torch.device, torch.layout, torch.memory_format)):
        return type(a).__name__
    return repr(a)


def _tensors(tree) -> list:
    import torch

    out = []
    stack = [tree]
    while stack:
        a = stack.pop()
        if isinstance(a, torch.Tensor):
            out.append(a)
        elif isinstance(a, (list, tuple)):
            stack.extend(a)
        elif isinstance(a, dict):
            stack.extend(a.values())
    return out


class _Recording:
    """One forward's record: the canonical op lines and the hazards seen
    (TX003/TX004), fed by the dispatch mode and the kernel wrappers."""

    def __init__(self, known, device_type: str, staging=(),
                 host_scalars_ok: bool = False):
        self.lines: list = []
        self.hazards: list = []        # (rule, message)
        self.known = {id(t) for t in known}
        self._keep = list(known) + list(staging)   # ids stay valid
        # the engine's own host staging buffers: their copy to the card
        # IS the staging path
        self.staging = {id(t) for t in staging}
        self.known |= self.staging
        self.device_type = device_type
        # a training step's host scalars: torch's non-capturable Adam
        # keeps its step counts on the host and lifts its increment with
        # torch.tensor each step; a 0-d CPU tensor reaches a CUDA kernel
        # as a value, never as a copy
        self.host_scalars_ok = host_scalars_ok
        self.suspended = 0

    def host_scalar(self, t) -> bool:
        return (self.host_scalars_ok and t.dim() == 0
                and t.device.type == "cpu")

    def note(self, name: str, args, kwargs, out) -> None:
        ins = _tensors((args, kwargs))
        if (name == "aten::_local_scalar_dense"
                and any(t.device.type != "cpu" for t in ins)):
            self.hazards.append((
                "TX003", f"{name} reads a value back from the "
                f"{self.device_type} (a device->host sync)"))
        for t in ins:
            if id(t) not in self.known and self.host_scalar(t):
                self.known.add(id(t))
                self._keep.append(t)
            if id(t) not in self.known:
                self.hazards.append((
                    "TX003",
                    f"{name} reads a {tuple(t.shape)} {t.dtype} tensor "
                    "the forward captured (not its staged input, the "
                    "engine's resident weights, or an earlier op's "
                    "output)"))
                self.known.add(id(t))
                self._keep.append(t)
            if (self.device_type != "cpu" and t.device.type == "cpu"
                    and t.numel() > 1 and id(t) not in self.staging):
                self.hazards.append((
                    "TX003",
                    f"{name} reads a host tensor {tuple(t.shape)} on the "
                    f"{self.device_type} forward — a copy outside the "
                    "engine's staging on every call"))
        outs = _tensors(out)
        for t in ins + outs:
            if str(t.dtype) == "torch.float64":
                self.hazards.append((
                    "TX004", f"{name} carries a float64 value"))
                break
        for t in outs:
            self.known.add(id(t))
            self._keep.append(t)
        arg_txt = ",".join(_describe(a) for a in args)
        kw_txt = ",".join(f"{k}={_describe(v)}"
                          for k, v in sorted(kwargs.items()))
        self.lines.append(f"{name}({arg_txt};{kw_txt})->"
                          f"{_describe(out)}")


def _dispatch_mode(rec: _Recording):
    from torch.utils._python_dispatch import TorchDispatchMode

    class _Mode(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            name = func.name()
            # the optimizer's profiler ranges carry no computation (and
            # print an address)
            if not rec.suspended and not name.startswith("profiler::"):
                if (name.startswith("aten::lift_fresh")
                        and not rec.host_scalar(args[0])):
                    rec.hazards.append((
                        "TX003", "a tensor made from host data inside "
                        "the forward (torch.tensor -> lift_fresh)"))
                rec.note(name, args, kwargs, out)
            return out

    return _Mode()


@contextlib.contextmanager
def _kernels_as_ops(rec: _Recording):
    """Swap ops/fused.py's kernel wrappers for recorders of one op each
    (named after the kernel); the wrapped call runs with the dispatch
    record suspended, so the plain version's interior on the CPU and
    the kernel's allocations on the card leave the same trace."""
    from distributedmnist_tpu_torch.ops import fused

    real = {name: getattr(fused, name) for name in _KERNEL_WRAPPERS}

    def wrap(name, fn):
        def recorded(*args, **kwargs):
            rec.suspended += 1
            try:
                out = fn(*args, **kwargs)
            finally:
                rec.suspended -= 1
            if not rec.suspended:
                rec.note(_KERNEL_WRAPPERS[name], args, kwargs, out)
            return out
        return recorded

    for name, fn in real.items():
        setattr(fused, name, wrap(name, fn))
    try:
        yield
    finally:
        for name, fn in real.items():
            setattr(fused, name, fn)


def _resident_tensors(engine) -> list:
    """The tensors the engine placed at construction: its parameters,
    and what its forward reaches through closures — a module's
    parameters and buffers, a dict of prepared variant weights. A tensor
    a forward closes over bare is NOT resident: it is data captured
    beside the engine's placement (TX003)."""
    import torch

    found = list(engine.params.values())
    stack, seen = [engine._forward], set()
    while stack:
        fn = stack.pop()
        if id(fn) in seen:
            continue
        seen.add(id(fn))
        for cell in getattr(fn, "__closure__", None) or ():
            v = cell.cell_contents
            if isinstance(v, torch.nn.Module):
                found.extend(v.parameters())
                found.extend(v.buffers())
            elif isinstance(v, dict):
                found.extend(t for t in v.values()
                             if isinstance(t, torch.Tensor))
            elif callable(v) and not isinstance(v, torch.Tensor):
                stack.append(v)
    return found


def record_forward(engine, bucket: int, row: bool = False) -> _Recording:
    """Record the engine's served forward at one rung: the pooled
    program (x staged as the whole bucket) or, with `row`, the fast
    lane's row-staged program (one row copied into row 0 of the resident
    buffer, then the same forward). A group engine's rung runs one
    forward a shard, each of bucket / n_chips rows, and the same program
    on every device: the first device's is recorded."""
    import torch

    x = torch.zeros((bucket // engine.n_chips, *_IMAGE_SHAPE),
                    dtype=torch.uint8, device=engine.device)
    known = _resident_tensors(engine) + [x]
    staging = []
    if row:
        # a pinned one-row host buffer, as the engine's _row_host_take
        host = torch.zeros((1, *_IMAGE_SHAPE), dtype=torch.uint8,
                           pin_memory=engine.device.type == "cuda")
        staging.append(host)
    rec = _Recording(known, engine.device.type, staging)
    if row:
        # x is the resident buffer: the engine's own row staging
        engine._fast_row_buf = x
    with torch.inference_mode(), engine._on_stream(), \
            _kernels_as_ops(rec), _dispatch_mode(rec):
        engine._forward(engine._stage_row(host) if row else x)
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    return rec


def fingerprint(lines: Sequence[str]) -> str:
    """Stable hash of a canonical op sequence."""
    return hashlib.sha256("\n".join(lines).encode()).hexdigest()[:16]


def audit_recording(rec: _Recording, key: str) -> tuple:
    """(fingerprint, findings) of one recorded forward."""
    findings = []
    seen = set()
    for rule, msg in rec.hazards:
        if (rule, msg) not in seen:
            seen.add((rule, msg))
            findings.append(Finding(rule, key, msg))
    return fingerprint(rec.lines), findings


def fingerprint_set_hash(fps: dict) -> str:
    """One hash over a whole {key: fingerprint} table — the compile-
    surface provenance stamp bench records carry."""
    canon = ";".join(f"{k}={v}" for k, v in sorted(fps.items()))
    return hashlib.sha256(canon.encode()).hexdigest()[:16]


# -- per-target audit ------------------------------------------------------


def build_engine(model: str, infer_dtype: str, buckets: Sequence[int],
                 device, n_chips: int = 1):
    """A real InferenceEngine of this (model, dtype, ladder) over the
    seed-0 fresh-init weights (fingerprints never depend on values); with
    n_chips > 1 a group engine of n_chips shards on `device`."""
    from distributedmnist_tpu_torch import models
    from distributedmnist_tpu_torch.serve.engine import InferenceEngine

    return InferenceEngine(model, models.init_params(model, seed=0),
                           devices=[device] * n_chips,
                           max_batch=max(buckets),
                           infer_dtype=infer_dtype, buckets=buckets)


def audit_target(target: AuditTarget, device) -> dict:
    """The audit of one deployment shape: record every (dtype, rung)
    forward through a real engine, scan and fingerprint it, and cross-
    check the reachable key universe against the warmup-derived one."""
    from distributedmnist_tpu_torch.serve.engine import fast_row_bucket

    buckets = target.ladder()
    dtypes = served_dtypes(target.model, target.serve_infer_dtype)
    reach = reachable_buckets(buckets, target.serve_max_batch)
    static = {dt: set(reach) for dt in dtypes}
    warmed = {dt: warmed_buckets(buckets, dt, target.n_chips)
              for dt in dtypes}
    findings = crosscheck_keys(target.model, static, warmed,
                               target.serve_max_batch)
    fps: dict = {}
    row_b = fast_row_bucket(buckets)
    for dt in dtypes:
        engine = build_engine(target.model, dt, buckets, device=device,
                              n_chips=target.n_chips)
        rungs = [(b, False) for b in buckets]
        if row_b is not None:
            rungs.append((row_b, True))
        for b, row in rungs:
            k = key_str(target.model, dt, f"{b}-row" if row else b)
            try:
                fp, fnd = audit_recording(record_forward(engine, b, row),
                                          k)
            except Exception as e:
                findings.append(Finding(
                    "TX003", k, "recording the forward failed: "
                    f"{type(e).__name__}: {e}"))
                continue
            fps[k] = fp
            findings.extend(fnd)
    return {
        "label": target.label(),
        "model": target.model,
        "n_chips": target.n_chips,
        "buckets": list(buckets),
        "max_batch": target.serve_max_batch,
        "infer_dtypes": list(dtypes),
        "static_keys": sum(len(v) for v in static.values()),
        "warmed_keys": sum(len(v) for v in warmed.values()),
        "fingerprints": fps,
        "findings": findings,
    }


# -- the training step -----------------------------------------------------


def train_step_key(model: str) -> str:
    opt = TRAIN_PRESETS[model][0]
    return f"{model}/train/{opt}/packed-b{TRAIN_BATCH}x1"


def record_train_step(model_name: str, device) -> _Recording:
    """Record one call of trainer.make_train_step for `model_name` with
    its preset optimizer: a fresh model (seed-0 init) and optimizer at a
    constant rate, the first step, packed pixels, in fit's numerics
    (float32 with TF32 off, cuDNN's deterministic algorithms). Its forward, backward and optimizer update are
    recorded; the set, its labels and the index block are the step's
    inputs, the parameters its state."""
    import torch

    from distributedmnist_tpu_torch import models, optim, trainer
    from distributedmnist_tpu_torch.utils.device import training_numerics

    opt, lr = TRAIN_PRESETS[model_name]
    device = torch.device(device)
    model = models.build(model_name, device=device)
    model.load_state_dict(models.init_params(model_name, seed=0))
    optimizer, scheduler = optim.build(opt, model.parameters(),
                                       optim.make_schedule(lr), flat=True)
    step = trainer.make_train_step(model, optimizer, scheduler, "packed")
    train_x = torch.zeros((TRAIN_N, 196), dtype=torch.int32, device=device)
    train_y = torch.zeros((TRAIN_N,), dtype=torch.int64, device=device)
    idx = torch.zeros((TRAIN_BATCH,), dtype=torch.int64, device=device)
    rec = _Recording(list(model.parameters()) + [train_x, train_y, idx],
                     device.type, host_scalars_ok=True)
    with training_numerics(), _kernels_as_ops(rec), _dispatch_mode(rec):
        step(train_x, train_y, idx)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return rec


def train_step_fingerprints(device) -> tuple:
    """({key: fp}, findings): the training steps configs 1 and 2 run —
    the MLP with SGD, LeNet-5 with Adam — recorded at JAX's canonical
    geometry under jaxcheck's keys, so a training-step edit shows up in
    the snapshot gate exactly like a served forward's."""
    fps: dict = {}
    findings: list = []
    for model_name in TRAIN_PRESETS:
        k = train_step_key(model_name)
        try:
            fp, fnd = audit_recording(record_train_step(model_name, device),
                                      k)
        except Exception as e:
            findings.append(Finding(
                "TX003", k, "recording the train step failed: "
                f"{type(e).__name__}: {e}"))
            continue
        fps[k] = fp
        findings.extend(fnd)
    return fps, findings


# -- snapshot gate ---------------------------------------------------------


def _describe_key_delta(k: str, pool: Sequence[str]) -> str:
    """Name the changed component when `k` differs from some key in
    `pool` in exactly one of (model, infer_dtype, bucket)."""
    parts = k.split("/")
    for other in pool:
        op = other.split("/")
        if len(op) != len(parts):
            continue
        diffs = [i for i, (a, b) in enumerate(zip(parts, op)) if a != b]
        if len(diffs) == 1:
            i = diffs[0]
            name = (_KEY_COMPONENTS[i] if i < len(_KEY_COMPONENTS)
                    else f"component {i}")
            return (f" (differs from {other} in {name}: "
                    f"{op[i]} -> {parts[i]})")
    return ""


def diff_fingerprints(current: dict, snapshot: dict) -> list:
    """TX005 findings for every divergence between two {key: fp}
    tables."""
    findings = []
    for k in sorted(set(current) - set(snapshot)):
        findings.append(Finding(
            "TX005", k,
            "new key not in the snapshot"
            + _describe_key_delta(k, sorted(snapshot))
            + " — regenerate with --update-snapshots --reason '...'"))
    for k in sorted(set(snapshot) - set(current)):
        findings.append(Finding(
            "TX005", k,
            "snapshot key no longer produced by the audit"
            + _describe_key_delta(k, sorted(current))
            + " — regenerate with --update-snapshots --reason '...'"))
    for k in sorted(set(current) & set(snapshot)):
        if current[k] != snapshot[k]:
            findings.append(Finding(
                "TX005", k,
                f"served forward changed (fingerprint {snapshot[k]} -> "
                f"{current[k]}) — regenerate with --update-snapshots "
                "--reason '...' stating why"))
    return findings


def load_snapshot(path: Optional[str] = None) -> Optional[dict]:
    path = path or snapshot_path()
    if not os.path.exists(path):
        return None
    with open(path, "r", encoding="utf-8") as fh:
        return json.load(fh)


def write_snapshot(all_fps: dict, reason: str,
                   path: Optional[str] = None) -> str:
    """Persist {target label: {key: fp}} with the stated reason."""
    import torch

    path = path or snapshot_path()
    record = {"torch_version": torch.__version__.split("+")[0],
              "reason": reason, "fingerprints": all_fps}
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(record, fh, indent=2, sort_keys=True)
        fh.write("\n")
    return path


# -- the whole audit -------------------------------------------------------


def run_audit(targets: Optional[list], device, with_train: bool = True,
              snapshot: str = "compare",
              snapshot_file: Optional[str] = None,
              partial: bool = False) -> dict:
    """The full gate pass on `device`. `targets` None audits
    default_targets(); `with_train` adds the training steps under the
    `train` label. `snapshot` in {'compare', 'skip'}: a missing snapshot
    file is a warning (first bootstrap); a present one that diverges is
    TX005 findings. `partial` marks a deliberately narrowed audit (a
    --models subset, --no-train): snapshot labels it never produced are
    then skipped instead of read as removed keys."""
    import torch

    targets = default_targets() if targets is None else targets
    per_target = [audit_target(t, device=device) for t in targets]
    findings = [f for r in per_target for f in r["findings"]]
    all_fps = {r["label"]: r["fingerprints"] for r in per_target}
    if with_train:
        train_fps, train_findings = train_step_fingerprints(device)
        all_fps[TRAIN_LABEL] = train_fps
        findings.extend(train_findings)
    warnings: list = []
    if snapshot == "compare":
        snap = load_snapshot(snapshot_file)
        if snap is None:
            warnings.append(
                "no fingerprint snapshot found — bootstrap with "
                "--update-snapshots --reason 'initial snapshot'")
        else:
            snap_fps = snap.get("fingerprints", {})
            labels = (sorted(all_fps) if partial
                      else sorted(set(all_fps) | set(snap_fps)))
            for label in labels:
                findings.extend(diff_fingerprints(
                    all_fps.get(label, {}), snap_fps.get(label, {})))
    return {
        "kind": "torchcheck",
        "torch_version": torch.__version__,
        "device": str(device),
        "targets": [{k: v for k, v in r.items() if k != "findings"}
                    for r in per_target],
        "static_keys_total": sum(r["static_keys"] for r in per_target),
        "warmed_keys_total": sum(r["warmed_keys"] for r in per_target),
        "fingerprint_set_hash": fingerprint_set_hash(
            {f"{lbl}:{k}": v for lbl, fps in all_fps.items()
             for k, v in fps.items()}),
        "fingerprints": all_fps,
        "findings": findings,
        "warnings": warnings,
        "closed": not findings,
    }


def compile_surface_summary(model: str, buckets: Sequence[int],
                            max_batch: int, infer_dtype: str,
                            n_chips: int = 1) -> dict:
    """The compile-surface provenance block the bench's serve record
    carries: static key count + fingerprint-set hash for ONE deployment
    geometry (its ladder over n_chips devices) at its headline serving
    precision, enough for --baseline to show when two records' served
    surfaces differ. The forwards run on the CPU whatever device the
    record was measured on (`basis`): a hash of the served op sequences,
    not a measurement of the card (chip_smoke.py holds the card's
    fingerprints to the same snapshot)."""
    import torch

    r = audit_target(AuditTarget(
        model=model, serve_max_batch=max_batch,
        serve_infer_dtype=infer_dtype, buckets=tuple(buckets),
        n_chips=n_chips), device="cpu")
    return {
        "static_keys": r["static_keys"],
        "fingerprint_set_hash": fingerprint_set_hash(r["fingerprints"]),
        "infer_dtypes": r["infer_dtypes"],
        "basis": "cpu",
        "torch_version": torch.__version__,
        "findings": len(r["findings"]),
    }


# -- CLI -------------------------------------------------------------------


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m distributedmnist_tpu_torch.analysis.torchcheck",
        description="Compile-surface auditor: record every forward the "
                    "serving registry could dispatch, prove the key "
                    "universe closed (warmed == reachable), transfer-"
                    "clean and float64-free, and gate the op-sequence "
                    "fingerprints against the committed snapshot. Exit "
                    "0 clean, 1 findings, 2 internal error.")
    p.add_argument("--models", default="mlp,lenet",
                   help="comma-separated models to audit (default both)")
    p.add_argument("--device", default="cuda",
                   help="where the forwards and train steps run "
                        "(default cuda: the card's engines and steps "
                        "against the committed snapshot; cpu is the "
                        "snapshot's basis, the one --update-snapshots "
                        "writes from)")
    p.add_argument("--list-rules", action="store_true",
                   help="print the TX rule table and exit")
    p.add_argument("--no-train", action="store_true",
                   help="skip the training-step fingerprints")
    p.add_argument("--no-snapshot", action="store_true",
                   help="skip the fingerprint snapshot gate")
    p.add_argument("--update-snapshots", action="store_true",
                   help="regenerate analysis/graph_fingerprints.json "
                        "from this audit (requires --reason)")
    p.add_argument("--reason", default=None,
                   help="[--update-snapshots] WHY the served surface "
                        "changed — recorded in the snapshot")
    p.add_argument("--emit", action="store_true",
                   help="write an ANALYSIS_torch_r*.json round artifact")
    args = p.parse_args(argv)

    if args.list_rules:
        for rule, (summary, why) in sorted(RULES.items()):
            print(f"{rule}  {summary}\n        {why}")
        return 0
    if args.update_snapshots and not args.reason:
        print("torchcheck: --update-snapshots requires --reason '...' — "
              "a regenerated surface without a stated why is exactly "
              "the silent drift the gate exists to catch",
              file=sys.stderr)
        return 2
    if args.update_snapshots and args.device != "cpu":
        print("torchcheck: --update-snapshots requires --device cpu — the "
              "snapshot's basis; the card's fingerprints are held to it, "
              "never written into it", file=sys.stderr)
        return 2
    models = [m.strip() for m in args.models.split(",") if m.strip()]
    unknown = [m for m in models if m not in ("mlp", "lenet")]
    if unknown:
        print(f"torchcheck: unknown model(s) {unknown}", file=sys.stderr)
        return 2
    targets = [t for t in default_targets() if t.model in models]
    partial = args.no_train or set(models) != {"mlp", "lenet"}
    from distributedmnist_tpu_torch.utils.device import resolve_device

    try:
        device = resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        print(f"torchcheck: {e}", file=sys.stderr)
        return 2
    try:
        report = run_audit(
            targets, device, with_train=not args.no_train, partial=partial,
            snapshot="skip" if (args.no_snapshot
                                or args.update_snapshots) else "compare")
    except Exception as e:     # a broken auditor must never read clean
        print(f"torchcheck: internal error: {type(e).__name__}: {e}",
              file=sys.stderr)
        return 2

    if args.update_snapshots:
        fps = report["fingerprints"]
        if partial:
            merged = dict((load_snapshot() or {}).get("fingerprints", {}))
            merged.update(fps)
            fps = merged
        path = write_snapshot(fps, args.reason)
        print(f"torchcheck: snapshot regenerated at {path} "
              f"(reason: {args.reason})")

    for w in report["warnings"]:
        print(f"torchcheck: WARNING: {w}", file=sys.stderr)
    for f in sorted(report["findings"], key=lambda f: (f.rule, f.key)):
        print(f.format())
    n = len(report["findings"])
    n_train = len(report["fingerprints"].get(TRAIN_LABEL, {}))
    print(f"torchcheck: {len(report['targets'])} target(s) on "
          f"{report['device']}, {report['static_keys_total']} static "
          f"keys / {report['warmed_keys_total']} warmed, {n_train} train "
          f"step(s), fingerprint "
          f"set {report['fingerprint_set_hash']} — "
          f"{'CLOSED, 0 findings' if n == 0 else f'{n} finding(s)'}",
          file=sys.stderr)
    if args.emit:
        from distributedmnist_tpu_torch.analysis import report as report_mod

        payload = dict(report)
        payload["findings"] = [dataclasses.asdict(f)
                               for f in report["findings"]]
        path = report_mod.emit_analysis(payload)
        print(f"torchcheck: artifact written to {path}")
    return 1 if report["findings"] else 0


if __name__ == "__main__":
    # runpy runs this file as __main__: delegate to the canonical module
    # so the kernel wrappers are swapped on the one ops.fused module
    from distributedmnist_tpu_torch.analysis import torchcheck as _canonical

    sys.exit(_canonical.main())
