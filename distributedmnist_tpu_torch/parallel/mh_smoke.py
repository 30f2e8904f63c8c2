"""One rank of a small localhost data-parallel run — the port of
distributedmnist_tpu/parallel/mh_smoke.py.

    python -m distributedmnist_tpu_torch.parallel.mh_smoke RANK WORLD PORT \\
        [--device cuda|cpu] [--preset mlp-dp2] [--steps 6] [--runs JSON]

Every rank joins the process group at localhost:PORT through the
coordinator flags, runs trainer.fit on tiny synthetic MNIST (1024 train
images, 255 test images, so that an eval batch rounded up to the world
holds masked padding), and prints one `MHSMOKE {json}` line a run: its
summary's topology, the loss of every logged step, the test accuracy and
whether the fault hook fired. It runs on the card (raising without
one) unless given --device cpu. `--runs` is a JSON list of Config
overrides, each one more fit in the same process group (default: one
plain run); a run's "init_npz" key names an .npz of port-format params
to start from instead of the seed's init (a test carries the JAX
package's init across through interop.py). A run's final params are its
checkpoint's, which only rank 0 writes. The tests and chip_smoke.py
drive it; world 1 runs in-process through `run`.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
from typing import Optional

SMOKE_DATA = {"seed": 3, "train_n": 1024, "test_n": 255}


def smoke_data() -> dict:
    from distributedmnist_tpu_torch.data import synthetic_mnist

    return synthetic_mnist(**SMOKE_DATA)


def smoke_config(preset: Optional[str] = None, **overrides):
    """The smoke run's Config: a preset (default: the JAX smoke worker's
    MLP/SGD at lr 0.05, batch 64) cut to a few steps on the smoke data,
    every step logged, one eval at the end, no early stop."""
    from distributedmnist_tpu_torch.config import PRESETS, Config

    base = PRESETS[preset] if preset else Config(
        model="mlp", optimizer="sgd", learning_rate=0.05, batch_size=64)
    cfg = base.replace(synthetic=True, log_every=1, target_accuracy=None,
                       num_devices=None, **{"steps": 6, **overrides})
    if "eval_every" not in overrides:
        cfg = cfg.replace(eval_every=cfg.steps)
    return cfg


def run(cfg, data: dict, init_params: Optional[dict] = None) -> dict:
    """fit() one run; its MHSMOKE record."""
    from distributedmnist_tpu_torch import trainer
    from distributedmnist_tpu_torch.parallel import distributed
    from distributedmnist_tpu_torch.utils import MetricsLogger

    mlog = MetricsLogger()
    rec = {"failed": None}
    try:
        out = trainer.fit(cfg, data=data, log=mlog, init_params=init_params)
    except trainer.SimulatedFailure as e:
        rec["failed"] = str(e)
        return rec
    finally:
        rec["process_id"] = distributed.process_index()
    rec.update({k: out[k] for k in (
        "multihost", "n_processes", "n_chips", "spmd_mode", "steps",
        "restored", "preempted", "test_accuracy", "final_loss",
        "global_batch", "model_parallel", "data_pipeline",
        "pixel_format")})
    rec["backend"] = distributed.topology().backend
    rec["checkpoint_dir"] = cfg.checkpoint_dir
    rec["losses"] = [r["loss"] for r in mlog.history if "loss" in r]
    return rec


def main(argv=None) -> int:
    from distributedmnist_tpu_torch.config import PRESETS

    p = argparse.ArgumentParser(
        prog="python -m distributedmnist_tpu_torch.parallel.mh_smoke")
    p.add_argument("process_id", type=int)
    p.add_argument("num_processes", type=int)
    p.add_argument("port")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--preset", choices=sorted(PRESETS), default=None)
    p.add_argument("--steps", type=int, default=6)
    p.add_argument("--runs", default="[{}]",
                   help="JSON list of Config overrides, one fit each; "
                        "\"init_npz\": an .npz of port-format params "
                        "to start from")
    args = p.parse_args(argv)
    logging.basicConfig(
        level=logging.INFO, stream=sys.stderr,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")

    import numpy as np
    import torch

    from distributedmnist_tpu_torch.ops import fused
    from distributedmnist_tpu_torch.parallel import distributed

    data = smoke_data()
    base = dict(device=args.device, steps=args.steps,
                coordinator_address=f"localhost:{args.port}",
                num_processes=args.num_processes,
                process_id=args.process_id)
    try:
        for overrides in json.loads(args.runs):
            init = None
            if "init_npz" in overrides:
                with np.load(overrides.pop("init_npz")) as z:
                    init = {k: torch.from_numpy(z[k]) for k in z.files}
            fused.reset_launches()
            cfg = smoke_config(args.preset, **{**base, **overrides})
            rec = run(cfg, data, init)
            rec["launches"] = dict(fused.LAUNCHES)
            rec["jax_loaded"] = any(
                m == "jax" or m.startswith(("jax.", "distributedmnist_tpu."))
                or m == "distributedmnist_tpu" for m in sys.modules)
            print("MHSMOKE " + json.dumps(rec), flush=True)
    finally:
        distributed.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
