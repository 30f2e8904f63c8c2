"""Training traffic: the window is one trainer.fit call per rank.

Each rank (one process a card; with one chip, the benchmark's own
process) drives the port's entry, `trainer.fit`, on data and initial
weights made from the seed and handed in as `data=` and `init_params=`.
The calls share one checkpoint directory, through which the program's
own resume hands each call's state to the next:

1. the checked steps, through the window's own call and feed: the first
   step alone (a block of one, whose optimizer state gives the first
   gradient), then `check_blocks` blocks of the cell's `steps_per_call`
   steps with the window's in-flight depth. Each block's last loss and
   mean loss are kept; the first step's optimizer state and the
   parameters after the last block are read back for the comparison;
2. warm-up: `warm_blocks` blocks more, which also time a step;
3. the window: enough whole blocks to fill `--seconds`, no periodic
   evals and no periodic checkpoints; fit's closing eval and final save
   are part of it.

With chips > 1 the ranks start through the port's launcher
(parallel/launch.py), as the train CLI starts them, and join its
process group (DDP over NCCL); the window runs from the last rank's
start to the last rank's return. Rank results travel through JSON files
in the run's temporary directory; each rank also reports the forbidden
modules (env.FORBIDDEN) it holds once its window has closed.

The window's rate, all its images over its whole time over the chips,
is reported under the mix's `rate_metric`.

After the window, and after the ranks have ended, the reference follows
the checked steps from the same data and weights (reference/), and
compare.py judges the program's readings against it.
"""

from __future__ import annotations

import json
import math
import os
import sys
import time

NEVER = 1 << 40      # an eval or checkpoint cadence no run reaches


class _Log:
    """fit's log hook (`log=`): keeps each logged block's last loss and
    mean loss when `keep`, and in
    a traced window traces two slices at block boundaries: the device
    alone over `slice_blocks` blocks (the metrics), then one block with
    the host's operations too (the names of the idle gaps). It never
    makes the host wait for the card otherwise."""

    def __init__(self, keep: bool = False, slice_at=None, slice_blocks=0,
                 out_dir=None, device_type="cuda"):
        self.keep, self.losses, self.calls = keep, [], 0
        self.slice_at, self.slice_blocks = slice_at, slice_blocks
        self.out_dir, self.device_type = out_dir, device_type
        self.slice = self.summary = None
        self.step0 = 0

    def _start(self, step: int, host_ops: bool) -> None:
        from benchmark.harness import devtrace

        self.slice = devtrace.Slice(self.out_dir, self.device_type,
                                    host_ops=host_ops)
        self.slice.start()
        self.step0 = step

    def step(self, step: int, scalars: dict) -> None:
        self.calls += 1
        if self.keep:
            self.losses.append((float(scalars["loss"]),
                                float(scalars["loss_mean"])))
        if self.slice_at is None:
            return
        if self.calls == self.slice_at:
            self._start(step, host_ops=False)
        elif self.calls == self.slice_at + self.slice_blocks:
            self.summary = self.slice.stop()
            self.summary["steps"] = step - self.step0
            self._start(step, host_ops=True)
        elif self.calls == self.slice_at + self.slice_blocks + 1:
            named = self.slice.stop()
            self.slice = None
            self.summary["idle_gaps"] = named["idle_gaps"]
            self.summary["named_slice_s"] = named["window_s"]

    def eval(self, step: int, accuracy: float) -> None:
        pass

    def close(self) -> None:
        """Stop a slice the window ended before its last block."""
        if self.slice is not None:
            self.slice.stop()
            self.slice = None


def _config(spec: dict, world: int, **kw):
    from distributedmnist_tpu_torch.config import Config

    cf, tr = spec["config"], spec["traffic"]
    base = dict(model=cf["model"], optimizer=cf["optimizer"],
                learning_rate=cf["learning_rate"], dtype=cf["dtype"],
                spmd_mode=cf["layout"]["spmd_mode"],
                batch_size=tr["global_batch"], seed=spec["seed"],
                device=spec["device"], num_devices=world,
                target_accuracy=None, eval_every=NEVER,
                checkpoint_every=NEVER,
                checkpoint_dir=os.path.join(spec["run_dir"], "ckpt"),
                steps_per_call=tr["steps_per_call"],
                log_every=tr["steps_per_call"])
    base.update(kw)
    return Config(**base)


def checked_steps(traffic: dict) -> int:
    """How many steps the checked steps are: one, then the blocks."""
    return 1 + traffic["check_blocks"] * traffic["steps_per_call"]


def _checked_steps(spec: dict, world: int, rank: int, data, init,
                   run_dir: str, tag: str = "") -> None:
    """The checked steps (the module's docstring, 1.); rank 0 keeps the
    losses, the first step's optimizer state and the last parameters in
    check<tag>.pt."""
    import torch

    from distributedmnist_tpu_torch import trainer

    ckpt = os.path.join(run_dir, "ckpt" + tag)
    first, blocks = _Log(keep=True), _Log(keep=True)
    trainer.fit(_config(spec, world, steps=1, steps_per_call=1, log_every=1,
                        checkpoint_dir=ckpt),
                data=data, init_params=init, log=first)
    n = checked_steps(spec["traffic"])
    trainer.fit(_config(spec, world, steps=n, checkpoint_dir=ckpt),
                data=data, log=blocks)
    if rank == 0:
        state = torch.load(os.path.join(ckpt, "1", "train_state.pt"),
                           map_location="cpu", weights_only=True)
        params = torch.load(os.path.join(ckpt, str(n), "params.pt"),
                            map_location="cpu", weights_only=True)
        torch.save({"losses": [first.losses[0][0]]
                    + [x for pair in blocks.losses for x in pair],
                    "exp_avg": [s["exp_avg"] for _, s in sorted(
                        state["optimizer"]["state"].items())],
                    "params": params},
                   os.path.join(run_dir, f"check{tag}.pt"))


def block_losses(losses: list, spc: int) -> list:
    """The reference's per-step losses in the order the program keeps
    them: the first step's, then each block's last and mean."""
    out = [losses[0]]
    for b in range(1, len(losses), spc):
        block = losses[b:b + spc]
        out += [block[-1], sum(block) / len(block)]
    return out


def rank_main(spec: dict) -> dict:
    """One rank's fit calls; returns (and with several ranks writes) its
    result. With spec["seeds"], a list of [seed, fault or None], only the
    checked steps, once a seed, each with its fault planted for its
    steps alone (calibrate.py)."""
    import contextlib

    import torch
    import torch.distributed as dist

    from benchmark.harness import devtrace, env, seeded
    from benchmark.tests import faults
    from distributedmnist_tpu_torch import trainer

    world = int(os.environ.get("WORLD_SIZE", "1"))
    rank = int(os.environ.get("RANK", "0"))
    local = int(os.environ.get("LOCAL_RANK", "0"))
    if os.environ.get("BM_FAULT"):
        faults.plant(os.environ["BM_FAULT"])
    cuda = spec["device"] == "cuda"
    device = torch.device("cuda", local) if cuda else torch.device("cpu")
    if cuda:
        torch.cuda.set_device(device)
    tr, seed = spec["traffic"], spec["seed"]
    spc = tr["steps_per_call"]
    if spec.get("seeds"):
        for s, fault in spec["seeds"]:
            one = {**spec, "seed": s}
            with (faults.planted(fault) if fault
                  else contextlib.nullcontext()):
                _checked_steps(one, world, rank,
                               seeded.mnist(s, device, tr["train_n"],
                                            tr["test_n"]),
                               seeded.lenet_params(s, device),
                               spec["run_dir"], tag=f"-{s}")
        if world > 1:
            dist.destroy_process_group()
        return {}
    data = seeded.mnist(seed, device, tr["train_n"], tr["test_n"])

    # 1. the checked steps
    _checked_steps(spec, world, rank, data, seeded.lenet_params(seed, device),
                   spec["run_dir"])

    # 2. warm-up, which also times a step; every rank takes the slowest
    start = checked_steps(tr) + tr["warm_blocks"] * spc
    s = trainer.fit(_config(spec, world, steps=start), data=data,
                    log=_Log())
    step_s = max(s["step_ms"] / 1e3, 1e-6)
    blocks = max(1, math.ceil(spec["seconds"] / step_s / spc))
    if world > 1:
        agreed = torch.tensor([blocks], device=device)
        dist.all_reduce(agreed, op=dist.ReduceOp.MAX)
        blocks = int(agreed.item())
    n = blocks * spc

    # 3. the window
    log = _Log()
    if spec["trace"]:
        devtrace.warm(spec["device"])
        at = max(1, min(blocks // 3, blocks - tr["trace_blocks"] - 1))
        log = _Log(slice_at=at, slice_blocks=tr["trace_blocks"],
                   out_dir=spec["run_dir"], device_type=spec["device"])
    if world > 1:
        dist.barrier()
    t0 = time.monotonic()
    s = trainer.fit(_config(spec, world, steps=start + n), data=data,
                    log=log)
    t1 = time.monotonic()
    log.close()
    out = {"rank": rank, "t0": t0, "t1": t1, "steps": n,
           "fit_steps": s["steps"], "accuracy": s["test_accuracy"],
           "memory_peak_bytes": (torch.cuda.max_memory_allocated(device)
                                 if cuda else 0),
           "trace": log.summary, "loaded": env.forbidden_loaded()}
    if world > 1:
        with open(os.path.join(spec["run_dir"], f"rank{rank}.json"),
                  "w") as f:
            json.dump(out, f)
        dist.destroy_process_group()
    return out


def run_ranks(spec: dict, chips: int) -> list[dict]:
    """rank_main in `chips` rank processes started by the port's launcher;
    their results, rank by rank."""
    from benchmark.harness.env import ROOT
    from distributedmnist_tpu_torch.parallel import launch

    path = os.path.join(spec["run_dir"], "spec.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    rc = launch.launch([sys.executable, "-m", "benchmark.traffic.train_fit",
                        path], chips, cwd=ROOT)
    if rc != 0:
        raise RuntimeError(f"the {chips} ranks exited {rc}")
    if spec.get("seeds"):
        return []
    out = []
    for r in range(chips):
        with open(os.path.join(spec["run_dir"], f"rank{r}.json")) as f:
            out.append(json.load(f))
    return out


def reference(spec: dict, device, control: bool = False,
              witness: bool = False) -> tuple:
    """(the program's readings, the reference's, the initial weights,
    with `control` the control's: the reference in TF32, and with
    `witness` the reference's in float64): the checked steps, every side
    from the seed's data and weights, the batches gathered a step at a
    time."""
    import torch

    from benchmark.harness import seeded
    from benchmark.reference import lenet5, stream

    tr, seed = spec["traffic"], spec["seed"]
    chk = torch.load(os.path.join(spec["run_dir"], spec.get("check",
                                                            "check.pt")),
                     map_location="cpu", weights_only=True)
    beta1 = 0.9
    prog = {"losses": chk["losses"],
            "grads": {k: m / (1 - beta1) for k, m in zip(lenet5.NAMES,
                                                        chk["exp_avg"])},
            "params": chk["params"]}
    data = seeded.mnist_tensors(seed, device, tr["train_n"], tr["test_n"])
    init = seeded.lenet_params(seed, device)
    x, y = data["train_x"], data["train_y"]

    def batches():
        for step in range(checked_steps(tr)):
            idx = torch.from_numpy(stream.batch_indices(
                tr["train_n"], tr["global_batch"], seed, step)).to(device)
            yield x[idx], y[idx]

    def follow(tf32: bool, dtype=torch.float32) -> dict:
        with lenet5.numerics(tf32=tf32):
            out = lenet5.adam_run({k: v.to(dtype) for k, v in init.items()},
                                  batches(),
                                  lr=spec["config"]["learning_rate"])
        return {"losses": block_losses(out["losses"], tr["steps_per_call"]),
                "grads": _cpu(out["grads"]), "params": _cpu(out["params"])}
    return (prog, follow(False), _cpu(init),
            follow(True) if control else None,
            follow(False, torch.float64) if witness else None)


def _cpu(tree: dict) -> dict:
    return {k: v.detach().cpu() for k, v in tree.items()}


def run(ctx: dict) -> dict:
    """Drive the cell once; the outcome run.py turns into its line."""
    from benchmark.harness import compare, window, work

    chips = ctx["chips"]
    spec = {k: ctx[k] for k in ("config", "traffic", "seed", "seconds",
                                "trace", "device", "run_dir")}
    if chips == 1:
        results = [rank_main(spec)]
    else:
        results = run_ranks(spec, chips)
    import torch

    device = (torch.device("cuda", 0) if ctx["device"] == "cuda"
              else torch.device("cpu"))
    if ctx["device"] == "cuda":
        torch.cuda.empty_cache()
    tr = ctx["traffic"]
    t0 = max(r["t0"] for r in results)
    t1 = max(r["t1"] for r in results)
    steps = results[0]["steps"]
    t_ref = time.monotonic()
    prog, ref, init, _, _ = reference(spec, device)
    readings = compare.train_readings(prog, ref, init)
    t_ref = time.monotonic() - t_ref
    traces = [r["trace"] for r in results if r["trace"]]
    rows = tr["global_batch"] // chips
    return {
        "end_to_end": {
            tr["rate_metric"]: window.rate(steps * tr["global_batch"], t0,
                                           t1, chips),
            "setup_s": t0 - ctx["t_start"]},
        "attempted": steps, "failed": 0,
        "readings": readings,
        "memory_peak_bytes": max(r["memory_peak_bytes"] for r in results),
        "traces": traces,
        "loaded": sorted({m for r in results for m in r["loaded"]}),
        "obs": {"kind": "train", "traces": traces, "world": chips,
                "rows_per_step": rows,
                "flops_per_row": work.flops(1, train=True),
                "bound_s_per_step": work.step_bound_s(rows, train=True),
                "peak_flops": work.PEAK_FLOPS_F32},
        "notes": {"window_s": t1 - t0, "steps": steps,
                  "reference_s": t_ref,
                  "test_accuracy": results[0]["accuracy"],
                  "leaves": readings.get("_leaves")},
    }


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    from benchmark.harness import env

    env.prepare()
    with open(sys.argv[1]) as f:
        rank_main(json.load(f))
