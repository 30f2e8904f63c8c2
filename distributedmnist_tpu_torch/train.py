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

--supervise runs the whole command (the launcher and its ranks) in a
watchdog-supervised worker process (utils/supervise.py): a worker silent
for --stall-timeout seconds, or one that exits without a summary line,
is killed and started again, up to --max-attempts times, and the summary
line is passed on.

    python -m distributedmnist_tpu_torch.train --preset mlp-sgd --synthetic
    python -m distributedmnist_tpu_torch.train --preset lenet-adam \\
        --synthetic --steps 1000 --checkpoint-dir ckpt
    python -m distributedmnist_tpu_torch.train --preset mlp-dp2 \\
        --synthetic --device cpu --steps 50 [--spmd-mode explicit]
    # tensor parallelism: 2 ranks split the hidden layer's columns
    python -m distributedmnist_tpu_torch.train --preset mlp-dp2 \\
        --synthetic --device cpu --steps 50 --model-parallel 2
    # bfloat16, the streaming pipeline, a profiler trace, supervised
    python -m distributedmnist_tpu_torch.train --preset mlp-sgd \\
        --synthetic --dtype bfloat16 --data-pipeline stream \\
        --profile-dir prof --supervise
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
    p.add_argument("--supervise", action="store_true",
                   help="run training in a watchdog-supervised worker "
                        "process, retried if it goes silent or exits "
                        "without a summary; the summary JSON line is "
                        "forwarded")
    p.add_argument("--stall-timeout", type=float, default=300.0,
                   help="[--supervise] kill and retry the worker if it is "
                        "silent this long")
    p.add_argument("--max-attempts", type=int, default=3,
                   help="[--supervise] worker attempts before giving up")
    args = p.parse_args(argv)
    cfg = config_lib.from_args(args)

    from distributedmnist_tpu_torch.utils import supervise
    if args.supervise and not supervise.is_worker():
        return supervise.run_supervised(
            ["-m", "distributedmnist_tpu_torch.train",
             *[a for a in argv if a != "--supervise"]],
            accept=supervise.json_record_acceptor("test_accuracy"),
            stall_timeout=args.stall_timeout, attempts=args.max_attempts)

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
