"""The port's multichip gate and its single-card entry — the counterpart
of the root __graft_entry__.py.

- entry(): LeNet-5 built on the card, a forward function and its
  example arguments (the parameters, eight zero images in the port's
  NHWC layout): the single-card check.
- dryrun_multichip(n): the multichip gate. Every parallel mechanism runs
  once at tiny shapes across n ranks, under JAX's leg names:
  `dp:auto:packed+flat` and `dp:explicit:u8` (LeNet, Adam 1e-3 flat,
  global batch 8n, one block of 2 steps, each SPMD mode with one pixel
  format), `dp x tp2` (model_parallel 2, even n), `dp+ga2` (gradient
  accumulation), `dp+ckpt` (a checkpointed fit, then a second fit that
  restores it), `dp+stream` (the streaming host pipeline),
  `serve-reload` (the registry's hot swap to a pre-warmed version
  through the batcher, nothing built after warmup) and `dp:2proc` (n
  ranks joined through the coordinator flags, as config 5's hosts are,
  save, then a fresh group restores; even n). It ends with
  `dryrun_multichip(n): ok (<legs>)`.

In the port one rank is one process. The in-group legs run in n ranks
started once through parallel/launch.py, each rank running them in
order in one process group (as parallel/mh_smoke.py's --runs does) and
writing its record to a file; serve-reload runs in the calling process;
dp:2proc starts two groups of parallel/mh_smoke.py ranks. On one card
the n ranks share it over gloo; with n cards visible each rank takes one
over NCCL; with device "cpu" the ranks are CPU processes over gloo, the
counterpart of JAX's n virtual CPU devices. Nothing falls back: a rank
that fails stops the run with its output tail.

    python -m distributedmnist_tpu_torch.dryrun N [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from typing import Optional

from distributedmnist_tpu_torch.parallel.launch import bind_failure

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# a rank's wait for its group (rendezvous, fits, restore)
RANK_TIMEOUT_S = 600


def _even(n: int) -> bool:
    return n >= 2 and n % 2 == 0


def dryrun_legs(n: int) -> list:
    """The legs dryrun_multichip(n) runs, in order, under JAX's names:
    `dp x tp2` and `dp:2proc` only for an even n >= 2."""
    legs = ["dp:auto:packed+flat", "dp:explicit:u8"]
    if _even(n):
        legs.append("dp x tp2")
    legs += ["dp+ga2", "dp+ckpt", "dp+stream", "serve-reload"]
    if _even(n):
        legs.append("dp:2proc")
    return legs


def entry(device=None):
    """(forward, (params, x)): LeNet-5 on `device` (default the card),
    forward(params, x) its logits for NHWC images x."""
    import torch
    from torch.func import functional_call

    from distributedmnist_tpu_torch import models
    from distributedmnist_tpu_torch.utils.device import resolve_device

    dev = resolve_device("cuda" if device is None else device)
    model = models.build("lenet", device=dev)
    params = {k: v.to(dev) for k, v in
              models.init_params("lenet", seed=0).items()}

    def forward(params, x):
        return functional_call(model, params, (x,))

    return forward, (params, torch.zeros((8, 28, 28, 1), device=dev))


# -- the in-group legs (one rank each) -------------------------------------


def leg_data(n: int) -> dict:
    """JAX's dry-run set: synthetic MNIST, seed 0, max(256, 8n) train and
    64 test images."""
    from distributedmnist_tpu_torch.data import synthetic_mnist

    return synthetic_mnist(seed=0, train_n=max(256, 8 * n), test_n=64)


def group_legs(n: int, ckpt_dir: str) -> list:
    """[(leg, [Config overrides, one fit each])] of the in-group legs for
    n ranks, on top of leg_config's base."""
    step = dict(batch_size=8 * n, steps_per_call=2, steps=2, eval_every=2)
    small = dict(batch_size=2 * n, steps_per_call=1, steps=2, eval_every=2)
    legs = [
        ("dp:auto:packed+flat", [dict(step, spmd_mode="auto",
                                      pixel_format="packed")]),
        ("dp:explicit:u8", [dict(step, spmd_mode="explicit",
                                 pixel_format="u8")]),
    ]
    if _even(n):
        legs.append(("dp x tp2", [dict(small, model_parallel=2, steps=1,
                                       eval_every=1)]))
    legs.append(("dp+ga2", [dict(step, grad_accum=2, steps_per_call=1,
                                 steps=1, eval_every=1)]))
    ckpt = dict(small, checkpoint_dir=ckpt_dir, checkpoint_every=2)
    legs.append(("dp+ckpt", [ckpt, dict(ckpt, steps=4)]))
    legs.append(("dp+stream", [dict(small, data_pipeline="stream")]))
    return legs


def leg_config(n: int, device: str, **overrides):
    """The in-group legs' Config: LeNet, Adam 1e-3 with the flat update,
    synthetic data, n ranks, no early stop, nothing logged."""
    from distributedmnist_tpu_torch.config import Config

    return Config(device=device, num_devices=n, model="lenet",
                  optimizer="adam", learning_rate=1e-3, flat_optimizer=True,
                  synthetic=True, log_every=0, target_accuracy=None,
                  **overrides)


def _check_leg(leg: str, outs: list) -> None:
    """JAX's assertions on one leg's fits."""
    last = outs[-1]
    if not math.isfinite(last["final_loss"]):
        raise RuntimeError(f"{leg}: loss {last['final_loss']}")
    want = {"dp x tp2": {"model_parallel": 2, "steps": 1},
            "dp+ga2": {"steps": 1},
            "dp+ckpt": {"restored": True, "steps": 4},
            "dp+stream": {"data_pipeline": "stream", "steps": 2}}.get(
                leg, {"steps": 2})
    bad = {k: last[k] for k, v in want.items() if last[k] != v}
    if leg == "dp+ckpt" and outs[0]["steps"] != 2:
        bad["first fit's steps"] = outs[0]["steps"]
    if bad:
        raise RuntimeError(f"{leg}: expected {want}, got {bad}")


def run_rank(n: int, device: str, out_dir: str, ckpt_dir: str,
             init_npz: Optional[str] = None) -> None:
    """One rank of the in-group legs, in one process group: fit each
    leg's runs in order, check them, and write this rank's record to
    out_dir/rank<r>.json. `init_npz` (port-format LeNet params) starts
    the step legs (dp:auto, dp:explicit, dp+ga2) from those parameters
    instead of the seed's init, as JAX's start from init_state."""
    import numpy as np
    import torch

    from distributedmnist_tpu_torch import trainer
    from distributedmnist_tpu_torch.parallel import distributed

    init = None
    if init_npz:
        with np.load(init_npz) as z:
            init = {k: torch.from_numpy(z[k]) for k in z.files}
    data = leg_data(n)
    rec = {"legs": {}}
    try:
        for leg, runs in group_legs(n, ckpt_dir):
            t0 = time.perf_counter()
            start = init if leg in ("dp:auto:packed+flat", "dp:explicit:u8",
                                    "dp+ga2") else None
            outs = [trainer.fit(leg_config(n, device, **run), data=data,
                                init_params=start) for run in runs]
            _check_leg(leg, outs)
            rec["legs"][leg] = {
                "seconds": time.perf_counter() - t0,
                "loss": outs[-1]["final_loss"],
                "steps": [o["steps"] for o in outs],
                "n_processes": outs[-1]["n_processes"],
                "n_chips": outs[-1]["n_chips"]}
        rec["rank"] = distributed.process_index()
        rec["backend"] = distributed.topology().backend
    finally:
        distributed.shutdown()
    with open(os.path.join(out_dir, f"rank{rec['rank']}.json"), "w") as fh:
        json.dump(rec, fh)
    return rec




def run_group_legs(n: int, device: str, work_dir: str,
                   init_npz: Optional[str] = None) -> list:
    """Start n ranks of run_rank through parallel/launch.py and return
    each rank's record. A rank that fails stops the others (launch), and
    this raises."""
    from distributedmnist_tpu_torch.parallel import launch

    out_dir = os.path.join(work_dir, "ranks")
    os.makedirs(out_dir, exist_ok=True)
    argv = [sys.executable, "-m", "distributedmnist_tpu_torch.dryrun",
            str(n), "--device", device, "--rank-out", out_dir,
            "--ckpt-dir", os.path.join(work_dir, "ckpt")]
    if init_npz:
        argv += ["--init-npz", init_npz]
    rc = launch.launch(argv, n, cwd=REPO_ROOT)
    if rc != 0:
        raise RuntimeError(
            f"dryrun_multichip({n}): the in-group legs failed (launch rc "
            f"{rc}; the failing rank's last lines are on stderr above)")
    recs = []
    for r in range(n):
        with open(os.path.join(out_dir, f"rank{r}.json")) as fh:
            recs.append(json.load(fh))
    for leg in recs[0]["legs"]:
        losses = {rec["legs"][leg]["loss"] for rec in recs}
        if len(losses) != 1:
            raise RuntimeError(f"{leg}: the ranks' global losses differ: "
                               f"{sorted(losses)}")
    return recs


# -- serve-reload (this process) -------------------------------------------


def serve_group(n: int, device: str) -> list:
    """The n devices of JAX's serve-reload mesh: the first n visible
    cards, a card taking several shards when fewer are visible, or n
    logical shards on the one cpu device."""
    from distributedmnist_tpu_torch.parallel.mesh import get_devices

    visible = get_devices(device)
    return [visible[i % len(visible)] for i in range(n)]


def serve_reload(n: int, device: str) -> dict:
    """The registry's hot swap through the real batcher and router: the
    MLP float32 engines at max_batch 2n, data-parallel over n devices
    (serve_group) as JAX's engines are over its n-device mesh, v1
    promoted and served 1, n and 2n rows, v2 added (warmed off the hot
    path), promoted and served again. Nothing is built across the swap
    (serve.server.compiles_total grows by 0) and v2 is live. Returns the
    kernels' launches during the two served rounds (after every engine
    is warm)."""
    import numpy as np

    from distributedmnist_tpu_torch.ops import fused
    from distributedmnist_tpu_torch.serve import (DynamicBatcher,
                                                  EngineFactory,
                                                  ModelRegistry,
                                                  ServeMetrics)
    from distributedmnist_tpu_torch.serve.server import compiles_total

    factory = EngineFactory("mlp", device=device, max_batch=2 * n,
                            devices=serve_group(n, device))
    metrics = ServeMetrics()
    router = factory.make_router(metrics=metrics)
    registry = ModelRegistry(factory, router)
    batcher = DynamicBatcher(router, max_wait_us=500,
                             metrics=metrics).start()
    rng = np.random.default_rng(0)
    launched = {k: 0 for k in fused.LAUNCHES}

    def selftest() -> None:
        before = dict(fused.LAUNCHES)
        futs = [(rows, batcher.submit(rng.integers(0, 256, (rows, 784),
                                                   dtype=np.uint8)))
                for rows in (1, n, 2 * n)]
        for rows, f in futs:
            shape = f.result(timeout=120).shape
            if shape != (rows, 10):
                raise RuntimeError(f"serve-reload: {rows} rows gave "
                                   f"{shape}")
        for k in launched:
            launched[k] += fused.LAUNCHES[k] - before[k]

    try:
        registry.promote(registry.add(factory.init_params(0), version="v1",
                                      source="fresh-init").version)
        selftest()
        v2 = registry.add(factory.init_params(1), version="v2",
                          source="fresh-init")
        built = compiles_total(factory)
        registry.promote(v2.version)
        selftest()
        grew = compiles_total(factory) - built
    finally:
        batcher.stop()
    if grew != 0:
        raise RuntimeError(f"serve-reload: the hot swap to a pre-warmed "
                           f"version built {grew} time(s)")
    if registry.live_version() != "v2":
        raise RuntimeError(f"serve-reload: live version "
                           f"{registry.live_version()!r}, not 'v2'")
    return launched


# -- dp:2proc (fresh process groups) ---------------------------------------


def _run_group(n: int, device: str, steps: int, ckpt_dir: str,
               work_dir: str) -> list:
    """n ranks of parallel/mh_smoke.py joined through the coordinator
    flags, fitting `steps` steps with a checkpoint every steps // 2;
    their MHSMOKE records. Output goes to files; every rank still
    running when this returns is killed."""
    from distributedmnist_tpu_torch.parallel import launch

    port = launch.free_port()
    runs = json.dumps([{"checkpoint_dir": ckpt_dir,
                        "checkpoint_every": max(1, steps // 2)}])
    env = dict(os.environ)
    env.setdefault("OMP_NUM_THREADS", "1")
    ranks = []
    try:
        for r in range(n):
            base = os.path.join(work_dir, f"mh-{port}-{r}")
            with open(base + ".out", "w") as fo, \
                    open(base + ".err", "w") as fe:
                proc = subprocess.Popen(
                    [sys.executable, "-m",
                     "distributedmnist_tpu_torch.parallel.mh_smoke", str(r),
                     str(n), str(port), "--device", device, "--steps",
                     str(steps), "--runs", runs],
                    stdout=fo, stderr=fe, env=env, cwd=REPO_ROOT)
            ranks.append((proc, base))
        for proc, _ in ranks:
            proc.wait(timeout=RANK_TIMEOUT_S)
    finally:
        for proc, _ in ranks:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    recs = []
    for proc, base in ranks:
        with open(base + ".out") as fo, open(base + ".err") as fe:
            out, err = fo.read(), fe.read()
        lines = [ln for ln in out.splitlines() if ln.startswith("MHSMOKE ")]
        if proc.returncode != 0 or not lines:
            raise RuntimeError(f"mh_smoke rank failed (rc "
                               f"{proc.returncode}):\n{err[-3000:]}")
        recs.append(json.loads(lines[0][len("MHSMOKE "):]))
    return recs


def _run_group_retry(n: int, device: str, steps: int, ckpt_dir: str,
                     work_dir: str) -> list:
    """_run_group, retried once on a coordinator bind failure: the free
    port is picked bind-then-close, so another process can take it
    before rank 0 binds it. Any other failure raises at once."""
    try:
        return _run_group(n, device, steps, ckpt_dir, work_dir)
    except RuntimeError as e:
        if not bind_failure(str(e)):
            raise
        return _run_group(n, device, steps, ckpt_dir, work_dir)


def two_groups(n: int, device: str, work_dir: str) -> dict:
    """dp:2proc: a group of n ranks fits 6 steps with a checkpoint, then
    a fresh group restores it and runs to step 9. Every rank reports
    the same accuracy, at steps 6 then 9, the second group restored."""
    ckpt_dir = os.path.join(work_dir, "ckpt-2proc")
    launches: dict = {}
    for steps, restored in ((6, False), (9, True)):
        recs = _run_group_retry(n, device, steps, ckpt_dir, work_dir)
        bad = [r for r in recs
               if not (r["multihost"] and r["n_processes"] == n
                       and r["steps"] == steps
                       and r["restored"] is restored)]
        accs = {r["test_accuracy"] for r in recs}
        if bad or len(accs) != 1:
            raise RuntimeError(f"dp:2proc at {steps} steps: {recs}")
        for r in recs:
            for k, v in r["launches"].items():
                launches[k] = launches.get(k, 0) + v
    return launches


# -- the gate --------------------------------------------------------------


def dryrun_multichip(n: int, device=None) -> dict:
    """Run every leg of dryrun_legs(n) on `device` (default the card),
    print `dryrun_multichip(n): ok (<legs>)` and return the record:
    the legs, each leg's wall seconds (the in-group legs' as rank 0
    timed them, `launch_s` the whole launch of the n ranks), the step
    legs' global losses and each path's kernel launches."""
    from distributedmnist_tpu_torch.utils.device import resolve_device

    if n < 1:
        raise ValueError(f"dryrun_multichip needs n >= 1, got {n}")
    dev = resolve_device("cuda" if device is None else device).type
    seconds: dict = {}
    launches: dict = {}
    with tempfile.TemporaryDirectory(prefix="dryrun-") as work:
        t0 = time.perf_counter()
        recs = run_group_legs(n, dev, work)
        seconds["launch_s"] = time.perf_counter() - t0
        legs = list(recs[0]["legs"])
        seconds.update({leg: recs[0]["legs"][leg]["seconds"]
                        for leg in legs})
        losses = {leg: recs[0]["legs"][leg]["loss"] for leg in legs}

        t0 = time.perf_counter()
        launches["serve-reload"] = serve_reload(n, dev)
        seconds["serve-reload"] = time.perf_counter() - t0
        legs.append("serve-reload")

        if _even(n):
            t0 = time.perf_counter()
            launches["dp:2proc"] = two_groups(n, dev, work)
            seconds["dp:2proc"] = time.perf_counter() - t0
            legs.append("dp:2proc")
    if legs != dryrun_legs(n):
        raise RuntimeError(f"ran legs {legs}, expected {dryrun_legs(n)}")
    print(f"dryrun_multichip({n}): ok ({', '.join(legs)})", flush=True)
    return {"n": n, "device": dev, "legs": legs, "seconds": seconds,
            "losses": losses, "launches": launches,
            "backend": recs[0]["backend"]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m distributedmnist_tpu_torch.dryrun",
        description="The multichip dry run: every parallel mechanism "
                    "once at tiny shapes across N ranks.")
    p.add_argument("n", type=int, help="ranks (devices) to run across")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--rank-out", default=None,
                   help="run as one rank of the in-group legs (started by "
                        "dryrun_multichip) and write its record here")
    p.add_argument("--ckpt-dir", default=None,
                   help="[--rank-out] the dp+ckpt leg's checkpoint dir")
    p.add_argument("--init-npz", default=None,
                   help="[--rank-out] port-format LeNet params the step "
                        "legs start from")
    args = p.parse_args(argv)
    if args.rank_out:
        run_rank(args.n, args.device, args.rank_out, args.ckpt_dir,
                 args.init_npz)
        return 0
    record = dryrun_multichip(args.n, args.device)
    print("dryrun_seconds " + json.dumps(record["seconds"]), file=sys.stderr,
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
