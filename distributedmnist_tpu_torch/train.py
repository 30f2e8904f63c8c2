"""Train through the port: `python -m distributedmnist_tpu_torch.train`.

The port of the JAX package's train.py for one card. Runs on the card
unless given --device cpu (and raises without a card). Prints one JSON
summary line, with the JAX summary's keys, on stdout.

    python -m distributedmnist_tpu_torch.train --preset mlp-sgd --synthetic
    python -m distributedmnist_tpu_torch.train --preset lenet-adam \\
        --synthetic --steps 1000 --checkpoint-dir ckpt
    python -m distributedmnist_tpu_torch.train --preset mlp-sgd \\
        --synthetic --device cpu --steps 200
"""

from __future__ import annotations

import argparse
import logging
import os
import signal
import sys

from distributedmnist_tpu_torch import config as config_lib


def main(argv=None) -> int:
    logging.basicConfig(
        level=logging.INFO, stream=sys.stderr,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    p = argparse.ArgumentParser(
        prog="python -m distributedmnist_tpu_torch.train",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    config_lib.add_args(p)
    cfg = config_lib.from_args(p.parse_args(argv))

    from distributedmnist_tpu_torch import trainer
    summary = trainer.fit(cfg)
    print(trainer.MetricsLogger.summary_line(summary), flush=True)
    if summary["preempted"]:
        # fit() absorbed a SIGTERM to force-save the checkpoint; at the
        # CLI boundary the signal is delivered again after the summary
        # line, so an orchestrator sees a process terminated by SIGTERM.
        # fit() restored the prior disposition, which a parent may have
        # left at SIG_IGN: pin the default first.
        signal.signal(signal.SIGTERM, signal.SIG_DFL)
        sys.stdout.flush()
        os.kill(os.getpid(), signal.SIGTERM)
    return 0


if __name__ == "__main__":
    sys.exit(main())
