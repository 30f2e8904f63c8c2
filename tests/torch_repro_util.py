"""Shared test helper: one training run of the port, recorded so that two
runs can be compared bit for bit, in this process or in a child. Imports
no jax, so the card's tests (run without tests/conftest.py) use it too.

    python tests/torch_repro_util.py OUT --preset lenet-adam \\
        [--dtype float32] [--pipeline device] [--steps 468] [--seed 709] \\
        [--device cuda] [--deterministic-algorithms]

writes the run's record (`fit_record`) to OUT with torch.save. With
--deterministic-algorithms the child first calls
torch.use_deterministic_algorithms(True), so that any op without a
deterministic implementation raises instead of running; cuBLAS reads
its workspace setting when its handle is created, so the caller sets
CUBLAS_WORKSPACE_CONFIG in the child's environment before torch is
imported, and the child refuses to run without it.
"""

import argparse
import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CUBLAS_WORKSPACE = ":4096:8"
CHILD_TIMEOUT_S = 600


def fit_record(preset: str, *, steps: int, seed: int, device: str,
               dtype: str = "float32", pipeline: str = "device",
               data: dict = None) -> dict:
    """trainer.fit of `preset` for `steps` steps at `seed`, with a loss
    logged every block, one eval at the end and a checkpoint of the last
    step: {"losses": [(step, loss, loss_mean)], "params": {name: CPU
    tensor}, "test_accuracy", "final_loss"}. `data` defaults to the
    full synthetic set at `seed`."""
    from distributedmnist_tpu_torch import checkpoint, trainer
    from distributedmnist_tpu_torch.config import PRESETS
    from distributedmnist_tpu_torch.data import synthetic_mnist
    from distributedmnist_tpu_torch.utils import MetricsLogger

    if data is None:
        data = synthetic_mnist(seed=seed)
    with tempfile.TemporaryDirectory() as ckpt:
        cfg = PRESETS[preset].replace(
            synthetic=True, steps=steps, seed=seed, dtype=dtype,
            data_pipeline=pipeline, device=device, target_accuracy=None,
            log_every=1, eval_every=steps, checkpoint_dir=ckpt,
            checkpoint_every=steps)
        mlog = MetricsLogger()
        out = trainer.fit(cfg, data=data, log=mlog)
        params, step = checkpoint.restore_latest_params(ckpt)
    if step != steps or out["steps"] != steps:
        raise RuntimeError(f"{preset}: ran {out['steps']} steps, "
                           f"checkpoint at {step}, asked {steps}")
    return {"losses": [(r["step"], r["loss"], r["loss_mean"])
                       for r in mlog.history if "loss" in r],
            "params": params, "test_accuracy": out["test_accuracy"],
            "final_loss": out["final_loss"]}


def differences(a: dict, b: dict) -> list:
    """What differs between two fit_records, bit for bit; [] if none."""
    import torch

    diff = [k for k in ("losses", "test_accuracy", "final_loss")
            if a[k] != b[k]]
    if set(a["params"]) != set(b["params"]):
        return diff + ["params: names"]
    return diff + [f"params: {k}" for k in sorted(a["params"])
                   if not torch.equal(a["params"][k], b["params"][k])]


def run_child(out: str, *args: str, deterministic_algorithms=False,
              timeout=CHILD_TIMEOUT_S):
    """Run this file as a child process writing its record to `out`
    (`args`: its flags), its output to files beside `out`, never to a
    pipe; killed on the timeout. Returns (exit code, stderr text)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    argv = [sys.executable, os.path.abspath(__file__), out, *args]
    if deterministic_algorithms:
        env["CUBLAS_WORKSPACE_CONFIG"] = CUBLAS_WORKSPACE
        argv.append("--deterministic-algorithms")
    with open(out + ".out", "w") as fo, open(out + ".err", "w") as fe:
        proc = subprocess.Popen(argv, stdout=fo, stderr=fe, env=env,
                                cwd=REPO)
        try:
            rc = proc.wait(timeout=timeout)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    with open(out + ".err") as fe:
        return rc, fe.read()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="tests/torch_repro_util.py")
    p.add_argument("out")
    p.add_argument("--preset", default="lenet-adam")
    p.add_argument("--dtype", default="float32")
    p.add_argument("--pipeline", default="device")
    p.add_argument("--steps", type=int, default=468)
    p.add_argument("--seed", type=int, default=709)
    p.add_argument("--device", default="cuda")
    p.add_argument("--deterministic-algorithms", action="store_true")
    args = p.parse_args(argv)
    if (args.deterministic_algorithms
            and os.environ.get("CUBLAS_WORKSPACE_CONFIG")
            != CUBLAS_WORKSPACE):
        print(f"--deterministic-algorithms needs CUBLAS_WORKSPACE_CONFIG="
              f"{CUBLAS_WORKSPACE} in the environment before torch is "
              "imported", file=sys.stderr)
        return 2
    import torch

    if args.deterministic_algorithms:
        torch.use_deterministic_algorithms(True)
    rec = fit_record(args.preset, steps=args.steps, seed=args.seed,
                     device=args.device, dtype=args.dtype,
                     pipeline=args.pipeline)
    torch.save(rec, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
