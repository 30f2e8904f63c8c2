"""Calibrate the synthetic set's difficulty against canonical MNIST — the
port of scripts/calibrate_synthetic.py.

Canonical MNIST test accuracies: a 784-128-10 MLP about 97.5-98.4%,
LeNet-5 about 99.0-99.3%. The synthetic set (data/mnist.py
synthetic_mnist) should keep that profile, the MLP below 0.99 and
LeNet-5 above it, so that time to 0.99 on it meets the same capability
cliff as on real MNIST. This sweeps (noise, jitter), trains each model
on each point through the port's trainer.fit with the JAX script's
recipe (Adam 2e-3, cosine schedule, batch 512, --epochs, one eval at
the end), prints one JSON line a point on stdout, then the JAX script's
table.

    python -m distributedmnist_tpu_torch.calibrate_synthetic \\
        [--grid 0.44:3] [--epochs 6] [--device cpu]

It runs on the card unless given --device cpu.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def parse_grid(spec: str) -> list:
    """'noise:jitter,...' -> [(noise, jitter), ...]."""
    out = []
    for item in spec.split(","):
        noise, jitter = item.split(":")
        out.append((float(noise), int(jitter)))
    return out


def calibration_config(model: str, epochs: int, device: str):
    """The JAX script's Config for one fit."""
    from distributedmnist_tpu_torch.config import Config

    return Config(device=device, model=model, optimizer="adam",
                  learning_rate=2e-3, lr_schedule="cosine", synthetic=True,
                  batch_size=512, epochs=epochs, eval_every=10 ** 9,
                  log_every=0, target_accuracy=None)


def calibrate(points, models, epochs: int, train_n: int, test_n: int,
              device: str) -> list:
    """Fit every model on every (noise, jitter) point; one JSON line a
    point on stdout as it finishes. Returns the rows: noise, jitter,
    each model's test accuracy and fit seconds."""
    from distributedmnist_tpu_torch import trainer
    from distributedmnist_tpu_torch.data import synthetic_mnist

    rows = []
    for noise, jitter in points:
        data = synthetic_mnist(seed=0, train_n=train_n, test_n=test_n,
                               noise=noise, jitter=jitter)
        row = {"noise": noise, "jitter": jitter, "epochs": epochs,
               "train_n": train_n, "test_n": test_n, "device": device,
               "accuracy": {}, "fit_s": {}}
        for model in models:
            t0 = time.perf_counter()
            res = trainer.fit(calibration_config(model, epochs, device),
                              data=data)
            row["fit_s"][model] = time.perf_counter() - t0
            row["accuracy"][model] = res["test_accuracy"]
            print(f"noise={noise} jitter={jitter} {model}: "
                  f"{res['test_accuracy']:.4f}", file=sys.stderr,
                  flush=True)
        print("calibration " + json.dumps(row), flush=True)
        rows.append(row)
    return rows


def format_table(rows, models) -> str:
    """The JAX script's table."""
    lines = [f"{'noise':>6} {'jitter':>6} "
             + " ".join(f"{m:>8}" for m in models)]
    for r in rows:
        lines.append(f"{r['noise']:>6} {r['jitter']:>6} "
                     + " ".join(f"{r['accuracy'][m]:>8.4f}" for m in models))
    return "\n".join(lines)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m distributedmnist_tpu_torch.calibrate_synthetic",
        description="Sweep the synthetic set's (noise, jitter) and train "
                    "the MLP and LeNet-5 on each point.")
    p.add_argument("--epochs", type=int, default=6)
    p.add_argument("--train-n", type=int, default=60_000)
    p.add_argument("--test-n", type=int, default=10_000)
    p.add_argument("--grid", default="0.35:3,0.45:4,0.55:4,0.65:4,0.55:5")
    p.add_argument("--models", default="mlp,lenet")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = p.parse_args(argv)

    from distributedmnist_tpu_torch.utils.device import resolve_device

    resolve_device(args.device)
    models = args.models.split(",")
    rows = calibrate(parse_grid(args.grid), models, args.epochs,
                     args.train_n, args.test_n, args.device)
    print(format_table(rows, models), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
