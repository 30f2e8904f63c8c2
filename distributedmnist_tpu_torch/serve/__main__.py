"""Serve the MLP or LeNet-5 through the port:
`python -m distributedmnist_tpu_torch.serve`.

Both modes bootstrap a model version — the latest checkpoint that the
train CLI committed in --checkpoint-dir, or fresh-init parameters
without one — warm it, promote it and optionally activate a
parity-gated inference variant (--serve-infer-dtype).

- selftest (default, --selftest N): drive N synthetic requests through
  the dynamic batcher and print one JSON summary line ({"metric":
  "serve_selftest", ...}, each version with its checkpoint step).
- --port P: serve HTTP on P (0 = an ephemeral port, announced as
  {"metric": "serve_ready", "port": ...}); serve/server.py has the
  routes. SIGHUP rolls to the latest checkpoint, SIGTERM/SIGINT drain
  and print {"metric": "serve_summary", ...}. The launch count of each
  hand-written kernel goes to stderr at exit (`serve: launches {...}`).

Both modes wire the root serve.py's request path: the resilience policy
(bisection, --no-bisect; the circuit breaker, --serve-breaker-*), a
fault-injection schedule (--serve-faults), the tracer (--serve-trace,
--serve-trace-sample, --serve-trace-capacity), the prediction cache in
front of the batcher (--serve-cache, --serve-cache-capacity,
--serve-cache-ttl-s), intra-batch dedup (--serve-dedup), the fast lane
(--serve-fastlane), the replica fleet (--serve-replicas N,
--serve-replica-inflight, --serve-hedge; serve/fleet.py) and the
confidence cascade in front of the cache (--serve-cascade,
--serve-cascade-threshold; serve/cascade.py), calibrated once the first
version is live. The cascade needs one replica: on a fleet its gate is
refused and every accuracy class serves the live route.

--serve-autoscale runs the closed-loop autoscaler over the batcher
(serve/autoscale.py: the window actuator, --serve-autoscale-floor,
-ceiling, -interval-s, -cooldown-s, -high, -low); it does not compose
with tenancy or --gateway, and in selftest mode the summary carries its
`autoscale` record.

--gateway N makes this process the front door over N worker processes
(serve/gateway.py, --gateway-worker-inflight, --gateway-vnodes), each
this CLI with the same flags and --port 0; it needs --port and announces
{"metric": "gateway_ready", "port": ..., "worker_ports": [...]}. The
gateway creates no CUDA context: the branch is taken before any engine
is built.

--serve-tenants / --serve-models turn on multi-tenant, multi-model
serving (serve/tenancy.py): one serving stack a catalog model, each from
its own checkpoint subtree <checkpoint-dir>/<model>, every model made
live at boot, and every request admitted and dispatched by the global
scheduler (X-Tenant picks the SLO class; GET /tenants, POST
/tenants/{id}/quota; --serve-tenant-quantum-us sets the DRR quantum).
It does not compose with --serve-cascade, --serve-replicas above 1 or
--serve-fastlane, and runs without the resilience policy, as the root
serve.py does.

Runs on the card; pass --device cpu to run on the CPU. On the card it
serves over every visible card, each batch sharded over all of them as
the JAX engine shards it over its 'data' mesh; --num-devices N serves
over the first N (more than are visible is refused). --serve-replicas
cuts those cards among the replicas: equal slices when the replicas
divide them, else every replica over all of them. On the CPU it serves
over the one CPU device. A --gateway worker is this CLI with the same
flags, so each worker serves over the same cards.

    python -m distributedmnist_tpu_torch.train --preset lenet-adam \\
        --synthetic --steps 1000 --checkpoint-dir ckpt
    python -m distributedmnist_tpu_torch.serve --model lenet \\
        --checkpoint-dir ckpt --selftest 256 --serve-infer-dtype int8
    python -m distributedmnist_tpu_torch.serve --model mlp --port 8000 \\
        --serve-replicas 2 --serve-hedge
    python -m distributedmnist_tpu_torch.serve --port 8000 \\
        --serve-models mlp,lenet --checkpoint-dir ckpts \\
        --serve-tenants "gold:qps=100,burst=8,model=mlp;free:qps=5"
    python -m distributedmnist_tpu_torch.serve --model mlp --gateway 2 \\
        --serve-cache --port 0
"""

from __future__ import annotations

import argparse
import json
import logging
import signal
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


def parser() -> argparse.ArgumentParser:
    """The serve CLI's flags: the config's, and the root serve.py's
    --port, --selftest, --metrics-every and --request-timeout."""
    p = argparse.ArgumentParser(
        prog="python -m distributedmnist_tpu_torch.serve",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    config_lib.add_args(p)
    p.add_argument("--port", type=int, default=None,
                   help="serve HTTP on this port (0 = ephemeral, "
                        "announced on stdout); omit for selftest mode")
    p.add_argument("--selftest", type=int, default=None, metavar="N",
                   help="run N synthetic requests through the batcher "
                        "and exit (default mode, N=256)")
    p.add_argument("--metrics-every", type=float, default=10.0,
                   help="seconds between serve_stats heartbeat lines")
    p.add_argument("--request-timeout", type=float, default=60.0,
                   help="seconds an HTTP request may wait on its result "
                        "before a 504 (bounds handler-thread lifetime "
                        "when the pipeline wedges)")
    return p


def main(argv=None) -> int:
    logging.basicConfig(
        level=logging.INFO, stream=sys.stderr,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    p = parser()
    args = p.parse_args(argv)
    if args.port is not None and args.selftest is not None:
        p.error("--port and --selftest are mutually exclusive")
    if args.request_timeout <= 0:
        p.error("--request-timeout must be > 0")
    # the gateway is the fleet's front door: it spawns N full workers and
    # routes, so the in-process single-server modes do not apply to it
    if args.gateway_workers is not None and args.gateway_workers < 1:
        p.error("--gateway must be >= 1 workers")
    if (args.gateway_worker_inflight is not None
            and args.gateway_worker_inflight < 1):
        p.error("--gateway-worker-inflight must be >= 1")
    if args.gateway_vnodes is not None and args.gateway_vnodes < 1:
        p.error("--gateway-vnodes must be >= 1")
    if args.gateway_workers:
        if args.selftest is not None:
            p.error("--gateway serves HTTP; it does not compose with "
                    "--selftest")
        if args.port is None:
            p.error("--gateway requires --port (0 = ephemeral, "
                    "announced as gateway_ready on stdout)")
    if (args.serve_retry_after_cap_s is not None
            and args.serve_retry_after_cap_s < 1):
        p.error("--serve-retry-after-cap-s must be >= 1")
    if args.serve_max_inflight is not None and args.serve_max_inflight < 1:
        p.error("--serve-max-inflight must be >= 1")
    if args.serve_slo_ms is not None and args.serve_slo_ms <= 0:
        p.error("--serve-slo-ms must be > 0")
    if args.selftest is not None and args.selftest < 1:
        p.error("--selftest must be >= 1")
    if args.serve_max_versions is not None and args.serve_max_versions < 2:
        p.error("--serve-max-versions must be >= 2")
    if (args.serve_breaker_window_s is not None
            and args.serve_breaker_window_s <= 0):
        p.error("--serve-breaker-window-s must be > 0")
    if (args.serve_breaker_min_requests is not None
            and args.serve_breaker_min_requests < 1):
        p.error("--serve-breaker-min-requests must be >= 1")
    if (args.serve_breaker_ratio is not None
            and not 0 < args.serve_breaker_ratio <= 1):
        p.error("--serve-breaker-ratio must be in (0, 1]")
    if (args.serve_trace_sample is not None
            and not 0.0 <= args.serve_trace_sample <= 1.0):
        p.error("--serve-trace-sample must be in [0, 1]")
    if (args.serve_trace_capacity is not None
            and args.serve_trace_capacity < 1):
        p.error("--serve-trace-capacity must be >= 1")
    if (args.serve_autoscale_floor is not None
            and args.serve_autoscale_floor < 1):
        p.error("--serve-autoscale-floor must be >= 1")
    if (args.serve_autoscale_ceiling is not None
            and args.serve_autoscale_ceiling < 1):
        p.error("--serve-autoscale-ceiling must be >= 1")
    if (args.serve_autoscale_floor is not None
            and args.serve_autoscale_ceiling is not None
            and args.serve_autoscale_ceiling < args.serve_autoscale_floor):
        p.error("--serve-autoscale-ceiling must be >= "
                "--serve-autoscale-floor")
    if (args.serve_autoscale_interval_s is not None
            and args.serve_autoscale_interval_s <= 0):
        p.error("--serve-autoscale-interval-s must be > 0")
    if (args.serve_autoscale_cooldown_s is not None
            and args.serve_autoscale_cooldown_s < 0):
        p.error("--serve-autoscale-cooldown-s must be >= 0")
    dflt = config_lib.Config()
    as_high = (dflt.serve_autoscale_high if args.serve_autoscale_high is None
               else args.serve_autoscale_high)
    as_low = (dflt.serve_autoscale_low if args.serve_autoscale_low is None
              else args.serve_autoscale_low)
    if not 0.0 <= as_low < as_high:
        p.error("autoscale hysteresis bands need 0 <= low < high, got "
                f"low={as_low} high={as_high}")
    if args.serve_autoscale:
        if args.serve_tenants or args.serve_models:
            p.error("--serve-autoscale does not compose with "
                    "multi-tenant serving yet (the global scheduler "
                    "owns the dispatch surface)")
        if args.gateway_workers:
            p.error("--serve-autoscale under --gateway is not wired "
                    "into the front door yet; the fleet actuator is "
                    "driven through serve/autoscale.GatewayActuator "
                    "(see bench.py serve --trace-replay)")
    if (args.serve_cache_capacity is not None
            and args.serve_cache_capacity < 1):
        p.error("--serve-cache-capacity must be >= 1")
    if args.serve_cache_ttl_s is not None and args.serve_cache_ttl_s <= 0:
        p.error("--serve-cache-ttl-s must be > 0")
    if args.serve_replicas is not None and args.serve_replicas < 1:
        p.error("--serve-replicas must be >= 1")
    if (args.serve_replica_inflight is not None
            and args.serve_replica_inflight < 1):
        p.error("--serve-replica-inflight must be >= 1")
    if args.serve_cascade_threshold is not None:
        if not args.serve_cascade:
            p.error("--serve-cascade-threshold requires --serve-cascade")
        if not 0.0 <= args.serve_cascade_threshold <= 1.0:
            # nan fails both comparisons and lands here too
            p.error("--serve-cascade-threshold must be in [0, 1]")
    if args.serve_tenants or args.serve_models:
        # a malformed class table is a usage error now: it must never
        # boot a server that silently rate-limits nobody; the single-
        # model fronts don't compose with the scheduler that owns every
        # dispatch, so their flags are refused, never ignored
        if args.serve_tenants:
            from distributedmnist_tpu_torch.serve.tenancy import \
                parse_tenants
            try:
                parse_tenants(args.serve_tenants)
            except ValueError as e:
                p.error(f"--serve-tenants: {e}")
        if (args.serve_tenant_quantum_us is not None
                and args.serve_tenant_quantum_us <= 0):
            p.error("--serve-tenant-quantum-us must be > 0")
        if args.serve_models:
            for name in (s.strip()
                         for s in args.serve_models.split(",")):
                if name not in ("mlp", "lenet"):
                    p.error(f"--serve-models: unknown model {name!r} "
                            "(expected mlp|lenet)")
        if args.serve_cascade:
            p.error("--serve-cascade does not compose with multi-tenant "
                    "serving (the global scheduler owns dispatch)")
        if args.serve_replicas is not None and args.serve_replicas > 1:
            p.error("--serve-replicas does not compose with multi-tenant "
                    "serving yet")
        if args.serve_fastlane:
            p.error("--serve-fastlane does not compose with multi-tenant "
                    "serving (every dispatch is a scheduler grant)")
    if args.serve_faults is not None:
        # a malformed schedule is a usage error now: it must never boot
        # a server that silently injects nothing
        from distributedmnist_tpu_torch.serve.faults import parse_spec
        try:
            parse_spec(args.serve_faults)
        except ValueError as e:
            p.error(f"--serve-faults: {e}")
    cfg = config_lib.from_args(args)

    # the gateway branches before any engine is built or torch.cuda is
    # touched: the workers own the card, the front door stays a cheap
    # process with no CUDA context
    if cfg.gateway_workers:
        from distributedmnist_tpu_torch.serve.gateway import run_gateway
        gw_args = argparse.Namespace(
            gateway_workers=cfg.gateway_workers,
            gateway_worker_inflight=cfg.gateway_worker_inflight,
            gateway_vnodes=cfg.gateway_vnodes,
            serve_cache=cfg.serve_cache,
            serve_trace=cfg.serve_trace,
            serve_trace_capacity=cfg.serve_trace_capacity,
            serve_trace_sample=cfg.serve_trace_sample,
            serve_slo_ms=cfg.serve_slo_ms,
            seed=cfg.seed,
            port=args.port,
            metrics_every=args.metrics_every)
        return run_gateway(
            gw_args, list(sys.argv[1:] if argv is None else argv))

    from distributedmnist_tpu_torch.serve import (DynamicBatcher,
                                                  ServeMetrics,
                                                  build_cache_front,
                                                  build_resilience,
                                                  build_serving,
                                                  build_tenancy, faults)
    from distributedmnist_tpu_torch.serve import trace as trace_lib

    metrics = ServeMetrics()
    # multi-tenant mode: the catalog and the global scheduler; the
    # single-model path below stays as it is
    catalog = scheduler = None
    if cfg.serve_tenants or cfg.serve_models:
        catalog, scheduler = build_tenancy(cfg, metrics=metrics)
        entry = catalog.get(catalog.default())
        registry, router, factory = (entry.registry, entry.router,
                                     entry.factory)
        batcher = entry.batcher
        log.info("multi-tenant serving on: models %s, tenants %s "
                 "(quantum %.1f ms); X-Tenant picks the SLO class, GET "
                 "/tenants shows the scheduler's view", catalog.names(),
                 sorted(scheduler.classes()),
                 cfg.serve_tenant_quantum_us / 1e3)
    else:
        registry, router, factory = build_serving(cfg, metrics=metrics)
    if cfg.serve_faults:
        faults.install(faults.FaultInjector.from_spec(cfg.serve_faults,
                                                      seed=cfg.seed))
        log.warning("FAULT INJECTION ACTIVE (--serve-faults %r, seed %d): "
                    "this process is a chaos target", cfg.serve_faults,
                    cfg.seed)
    if cfg.serve_trace:
        trace_lib.install(trace_lib.Tracer(
            capacity=cfg.serve_trace_capacity,
            sample=cfg.serve_trace_sample, slo_ms=cfg.serve_slo_ms,
            seed=cfg.seed))
        log.info("request tracing on (capacity %d, sample %.2f, slo %s "
                 "ms): GET /trace, X-Trace-Id on /predict",
                 cfg.serve_trace_capacity, cfg.serve_trace_sample,
                 cfg.serve_slo_ms)
    if scheduler is not None:
        # every submit goes through the scheduler; the default model's
        # cache backs the cache-aware shed, the per-model fronts live in
        # the catalog
        front, cache = scheduler, catalog.get(catalog.default()).cache
    else:
        resilience = build_resilience(cfg, registry=registry,
                                      metrics=metrics)
        batcher = DynamicBatcher(router, max_batch=cfg.serve_max_batch,
                                 max_wait_us=cfg.serve_max_wait_us,
                                 queue_depth=cfg.serve_queue_depth,
                                 max_inflight=cfg.serve_max_inflight,
                                 slo_ms=cfg.serve_slo_ms,
                                 adaptive=cfg.serve_adaptive,
                                 resilience=resilience,
                                 dedup=cfg.serve_dedup,
                                 fastlane=cfg.serve_fastlane,
                                 metrics=metrics).start()
        # the submit target: the cache front when --serve-cache (the
        # registry then invalidates it on every live-route change),
        # wrapped by the cascade front when --serve-cascade (until warm()
        # has calibrated it, every class degrades to the live route,
        # counted)
        front, cache = build_cache_front(cfg, batcher, router, registry,
                                         metrics=metrics)
        if cfg.serve_cascade:
            from distributedmnist_tpu_torch.serve.cascade import \
                CascadeFront

            front = CascadeFront(front, batcher, router, registry,
                                 metrics=metrics, cache=cache)
    # the autoscaler over this batcher, built after every front wrapper:
    # the loop reads and actuates the batcher, never the submit path
    autoscaler = None
    if cfg.serve_autoscale:
        from distributedmnist_tpu_torch.serve import \
            autoscale as autoscale_lib
        actuator = autoscale_lib.WindowActuator(
            batcher, floor=cfg.serve_autoscale_floor,
            ceiling=(batcher.max_inflight
                     if cfg.serve_autoscale_ceiling is None
                     else cfg.serve_autoscale_ceiling))
        autoscaler = autoscale_lib.Autoscaler(
            actuator,
            autoscale_lib.batcher_signals(batcher, metrics=metrics,
                                          slo_ms=cfg.serve_slo_ms,
                                          tracer=trace_lib.active()),
            high=cfg.serve_autoscale_high, low=cfg.serve_autoscale_low,
            cooldown_s=cfg.serve_autoscale_cooldown_s,
            interval_s=cfg.serve_autoscale_interval_s,
            metrics=metrics).start()
        log.info("autoscaler on (window actuator): floor %d ceiling %d, "
                 "bands [%.2f, %.2f], cooldown %.1fs, tick %.2fs; scale "
                 "moves only along the warmed bucket ladder",
                 autoscaler.floor, autoscaler.ceiling, autoscaler.low,
                 autoscaler.high, autoscaler.cooldown_s,
                 autoscaler.interval_s)
    log.info("dispatch pipeline depth: %d; buckets %s; devices %s; "
             "replicas %d%s; fast lane %s; cache %s; dedup %s; cascade "
             "%s", batcher.max_inflight, list(factory.buckets),
             [[str(d) for d in g] for g in factory.replica_devices],
             cfg.serve_replicas,
             " (hedged)" if cfg.serve_hedge else "",
             "on" if cfg.serve_fastlane else "off",
             "on" if cache is not None else "off",
             "on" if cfg.serve_dedup else "off",
             "on" if cfg.serve_cascade else "off")
    def boot():
        if catalog is not None:
            warm_catalog(catalog, cfg)
        else:
            warm(registry, cfg)

    try:
        if args.port is None:
            boot()
            summary = selftest(front, metrics, args.selftest or 256,
                               factory.max_batch)
            summary["device"] = str(factory.device)
            summary["devices"] = [str(d) for d in factory.devices]
            summary["live_infer_dtype"] = router.live_infer_dtype()
            summary["versions"] = registry.describe()["versions"]
            if scheduler is not None:
                summary["tenancy"] = scheduler.snapshot()
            if autoscaler is not None:
                summary["autoscale"] = autoscaler.describe()
        else:
            summary = http_serve(args, cfg, batcher, metrics, registry,
                                 front=front, cache=cache, boot=boot,
                                 scheduler=scheduler)
        if cache is not None:
            summary["cache"] = cache.stats()
    finally:
        # the autoscaler stops before the batcher: batcher.stop() returns
        # the permits it parked, and a live loop could park them again
        if autoscaler is not None:
            autoscaler.stop()
        if scheduler is not None:
            scheduler.stop()     # drains every catalog batcher too
        else:
            batcher.stop()
        faults.uninstall()
        trace_lib.uninstall()
    summary.update(_sanitizer_block())
    print(json.dumps(summary), flush=True)
    return 0


def _sanitizer_block() -> dict:
    """The concurrency sanitizer's findings for the summary line, when
    one is installed (DMNIST_SANITIZE=1): a run that tripped a lock-order
    cycle or leaked a staging buffer says so in its exit record."""
    from distributedmnist_tpu_torch.analysis import sanitize

    san = sanitize.active_sanitizer()
    if san is None:
        return {}
    # assert_clean's contract is "after drain": the last future resolves
    # before the completion thread recycles its buffers
    san.wait_drained(timeout_s=2.0)
    rep = san.report()
    clean = not any(rep.values())
    if not clean:
        log.warning("concurrency sanitizer findings: %s",
                    {k: v for k, v in rep.items() if v})
    return {"sanitizer": {"clean": clean, **rep}}


def warm(registry, cfg):
    """Bootstrap the first version and put it live at the configured
    precision (registry.go_live: a gate refusal goes live at float32,
    loudly; a variant that fails to build or launch raises, and then
    nothing goes live) — unless a version went live while it warmed (the
    operator's newer choice wins)."""
    t0 = time.perf_counter()
    mv = registry.bootstrap(seed=cfg.seed, promote=False)
    log.info("bootstrap %s (%s) warmed in %.2fs", mv.version, mv.source,
             time.perf_counter() - t0)
    live = registry.live_version()
    if live is not None and live != mv.version:
        log.info("bootstrap: %s went live during warmup; leaving it (%s "
                 "stays ready)", live, mv.version)
        return mv
    pick = registry.go_live(mv.version, cfg.serve_infer_dtype)
    log.info("%s is live at %s (--serve-infer-dtype %s)", mv.version, pick,
             cfg.serve_infer_dtype)
    if cfg.serve_cascade:
        # the cheap variant, the calibrated threshold and the composed
        # gate; a refusal leaves every class on the plain live route,
        # loudly (the verdict is in GET /models)
        try:
            st = registry.enable_cascade(
                mv.version, threshold=cfg.serve_cascade_threshold)
            log.info("confidence cascade ACTIVE on %s: cheap stage %s, "
                     "threshold %.4g (%s)", mv.version, st.cheap_dtype,
                     st.threshold,
                     st.calibration.get("source", "calibrated"))
        except Exception:
            log.exception("--serve-cascade refused on %s; every accuracy "
                          "class serves the plain live route",
                          mv.version)
    return mv


def warm_catalog(catalog, cfg) -> None:
    """Make every catalog model live at the configured precision (a
    refused variant keeps float32 live, logged): a server boot warms the
    whole catalog, so /healthz's 200 means every advertised model answers
    with no build on the hot path."""
    t0 = time.perf_counter()
    for name in catalog.names():
        catalog.ensure_live(name, seed=cfg.seed,
                            infer_dtype=cfg.serve_infer_dtype)
    log.info("catalog warmed in %.2fs: %s", time.perf_counter() - t0,
             catalog.describe())


def http_serve(args, cfg, batcher, metrics, registry, front=None,
               cache=None, boot=None, scheduler=None) -> dict:
    """Serve HTTP until SIGTERM/SIGINT; SIGHUP rolls the model. Returns
    the serve_summary record; the kernels' launch counts go to stderr."""
    from distributedmnist_tpu_torch.ops import fused
    from distributedmnist_tpu_torch.serve.process import LAUNCHES_PREFIX
    from distributedmnist_tpu_torch.serve.server import (HTTPServer,
                                                         ServerState)

    server = HTTPServer(batcher, metrics, registry, ServerState(),
                        port=args.port,
                        request_timeout=args.request_timeout,
                        retry_after_cap_s=cfg.serve_retry_after_cap_s,
                        infer_dtype_choice=cfg.serve_infer_dtype,
                        front=front, cache=cache,
                        cascade=cfg.serve_cascade,
                        cascade_threshold=cfg.serve_cascade_threshold,
                        scheduler=scheduler)
    signal.signal(signal.SIGTERM, lambda signum, frame: server.shutdown())
    signal.signal(signal.SIGINT, lambda signum, frame: server.shutdown())
    signal.signal(signal.SIGHUP, lambda signum, frame: server.reload())
    try:
        return server.serve(boot or (lambda: warm(registry, cfg)),
                            metrics_every=args.metrics_every)
    finally:
        fused.print_launches(LAUNCHES_PREFIX)


if __name__ == "__main__":
    sys.exit(main())
