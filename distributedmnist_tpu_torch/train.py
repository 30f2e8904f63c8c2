"""Train through the port: `python -m distributedmnist_tpu_torch.train`.

The port of the JAX package's train.py. Runs on the card unless given
--device cpu (and raises without a card). Prints one JSON summary line,
with the JAX summary's keys, on stdout, and its kernel launch counts as
`train: launches {...}` on stderr at exit.

Data parallelism runs one process (rank) per device. With --num-devices
N > 1 (or a preset that sets it: mlp-dp2, lenet-dp8) and no coordinator
flags, this CLI starts N ranks of itself on this host
(parallel/launch.py) and passes on rank 0's summary line; with no
--num-devices, every visible card gets a rank (one on the cpu). A
multi-host run (lenet-multihost) starts one process a rank with
--coordinator-address HOST:PORT --num-processes N --process-id I.

    python -m distributedmnist_tpu_torch.train --preset mlp-sgd --synthetic
    python -m distributedmnist_tpu_torch.train --preset lenet-adam \\
        --synthetic --steps 1000 --checkpoint-dir ckpt
    python -m distributedmnist_tpu_torch.train --preset mlp-dp2 \\
        --synthetic --device cpu --steps 50 [--spmd-mode explicit]
    # config 5 on one host, one shell a rank:
    python -m distributedmnist_tpu_torch.train --preset lenet-multihost \\
        --synthetic --device cpu --coordinator-address localhost:29500 \\
        --num-processes 2 --process-id 0      # and --process-id 1
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import signal
import sys

from distributedmnist_tpu_torch import config as config_lib


def main(argv=None) -> int:
    logging.basicConfig(
        level=logging.INFO, stream=sys.stderr,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    argv = sys.argv[1:] if argv is None else list(argv)
    p = argparse.ArgumentParser(
        prog="python -m distributedmnist_tpu_torch.train",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    config_lib.add_args(p)
    cfg = config_lib.from_args(p.parse_args(argv))

    from distributedmnist_tpu_torch.parallel import launch
    rc = launch.run_ranks("distributedmnist_tpu_torch.train", argv, cfg)
    if rc is not None:
        return rc

    from distributedmnist_tpu_torch import trainer
    from distributedmnist_tpu_torch.ops import fused
    from distributedmnist_tpu_torch.parallel import distributed
    try:
        summary = trainer.fit(cfg)
    finally:
        print("train: launches " + json.dumps(fused.LAUNCHES),
              file=sys.stderr, flush=True)
        distributed.shutdown()
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
