"""Serve the MLP or LeNet-5 through the port:
`python -m distributedmnist_tpu_torch.serve`.

Selftest mode (the only mode ported so far; the HTTP server waits):
bootstrap a model version — the latest checkpoint that the train CLI
committed in --checkpoint-dir, or fresh-init parameters without one —
warm it, promote it, optionally activate a parity-gated inference
variant, drive N synthetic requests through the dynamic batcher, and
print one JSON summary line ({"metric": "serve_selftest", ...}, each
version with its checkpoint step) on stdout. Runs on the card; pass
--device cpu to run on the CPU.

    python -m distributedmnist_tpu_torch.train --preset lenet-adam \\
        --synthetic --steps 1000 --checkpoint-dir ckpt
    python -m distributedmnist_tpu_torch.serve --model lenet \\
        --checkpoint-dir ckpt --selftest 256 --serve-infer-dtype int8
    python -m distributedmnist_tpu_torch.serve --model mlp --selftest 256
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
import time

import numpy as np

from distributedmnist_tpu_torch import config as config_lib

log = logging.getLogger("distributedmnist_tpu_torch")

IMAGE_BYTES = 28 * 28


def selftest(batcher, metrics, n_requests: int, max_batch: int) -> dict:
    """Submit n_requests seeded random requests of 1..min(max_batch, 32)-1
    rows, wait for all of them, and summarize."""
    from distributedmnist_tpu_torch.serve import Rejected

    rng = np.random.default_rng(0)
    sizes = [int(rng.integers(1, max(2, min(max_batch, 32))))
             for _ in range(n_requests)]
    futures = []
    rejected = 0
    for n in sizes:
        x = rng.integers(0, 256, (n, IMAGE_BYTES), dtype=np.uint8)
        try:
            futures.append((n, batcher.submit(x)))
        except Rejected:
            rejected += 1
    for n, f in futures:
        out = f.result(timeout=120)
        if out.shape != (n, 10) or not np.all(np.isfinite(out)):
            raise RuntimeError(
                f"bad logits for a {n}-row request: shape {out.shape}, "
                f"finite {bool(np.all(np.isfinite(out)))}")
    return {"metric": "serve_selftest", "requests_driven": n_requests,
            "rejected_at_submit": rejected, **metrics.snapshot()}


def main(argv=None) -> int:
    logging.basicConfig(
        level=logging.INFO, stream=sys.stderr,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    p = argparse.ArgumentParser(
        prog="python -m distributedmnist_tpu_torch.serve",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    config_lib.add_args(p)
    p.add_argument("--selftest", type=int, default=None, metavar="N",
                   help="run N synthetic requests through the batcher "
                        "and exit (default N=256)")
    args = p.parse_args(argv)
    if args.serve_max_inflight is not None and args.serve_max_inflight < 1:
        p.error("--serve-max-inflight must be >= 1")
    if args.serve_slo_ms is not None and args.serve_slo_ms <= 0:
        p.error("--serve-slo-ms must be > 0")
    if args.selftest is not None and args.selftest < 1:
        p.error("--selftest must be >= 1")
    if args.serve_max_versions is not None and args.serve_max_versions < 2:
        p.error("--serve-max-versions must be >= 2")
    cfg = config_lib.from_args(args)

    from distributedmnist_tpu_torch.serve import (DynamicBatcher,
                                                  ParityRefused,
                                                  ServeMetrics,
                                                  build_serving)

    metrics = ServeMetrics()
    registry, router, factory = build_serving(cfg)
    batcher = DynamicBatcher(router, max_batch=cfg.serve_max_batch,
                             max_wait_us=cfg.serve_max_wait_us,
                             queue_depth=cfg.serve_queue_depth,
                             max_inflight=cfg.serve_max_inflight,
                             slo_ms=cfg.serve_slo_ms,
                             adaptive=cfg.serve_adaptive,
                             metrics=metrics).start()
    log.info("dispatch pipeline depth: %d; buckets %s; device %s",
             batcher.max_inflight, list(factory.buckets), factory.device)
    try:
        t0 = time.perf_counter()
        mv = registry.bootstrap(seed=cfg.seed)
        log.info("bootstrap %s (%s) warmed in %.2fs; live: %s",
                 mv.version, mv.source, time.perf_counter() - t0,
                 registry.live_version())
        if cfg.serve_infer_dtype != "float32":
            # float32 is live already; a variant the parity gate refuses
            # leaves it serving, loudly. A variant that fails to build or
            # launch is an error.
            try:
                pick = registry.activate_infer_dtype(
                    mv.version, cfg.serve_infer_dtype)
                log.info("inference variant %s is live (%s)", pick,
                         "auto-picked" if cfg.serve_infer_dtype == "auto"
                         else "requested")
            except ParityRefused:
                log.exception("--serve-infer-dtype %s refused; float32 "
                              "stays live", cfg.serve_infer_dtype)
        summary = selftest(batcher, metrics, args.selftest or 256,
                           factory.max_batch)
    finally:
        batcher.stop()
    summary["device"] = str(factory.device)
    summary["live_infer_dtype"] = router.live_infer_dtype()
    summary["versions"] = registry.describe()["versions"]
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
