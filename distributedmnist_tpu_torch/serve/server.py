"""The HTTP front door of the port's serving stack (the counterpart of
the root serve.py's ServerState, shed_retry_after_s and _http_serve):
`python -m distributedmnist_tpu_torch.serve --port P`.

    POST /predict          body = raw uint8 pixels, n*784 bytes ->
                           {"classes": [...], "n": n, "version": ...},
                           `version` the one that computed the batch
                           (under a canary, not always the live one).
                           400 on a malformed body, 413 past max_batch
                           rows, 503 + Retry-After when the queue is past
                           its watermark or nothing is live yet, 504 when
                           the optional X-Deadline-Ms budget expires
                           before dispatch (zero device work) or a wait
                           passes --request-timeout or the budget
    GET  /healthz          {"ok", "state": warming|running|draining|
                           failed, "live_version", ...}; 200 only once a
                           warmed version is live
    GET  /models           the registry: versions and the routing table
    POST /models/load      {} | {"dir"?, "version"?} | {"fresh": {"seed"?,
                           "version"?}} — restore (or fresh-init) and
                           warm a version off the hot path; promotable,
                           not live
    POST /models/promote   {"version", "mode"?: live|canary|shadow,
                           "fraction"?, "infer_dtype"? (live only),
                           "cascade_threshold"? (live only: the cascade
                           judged again at it first; 409 when refused)}
    POST /replicas/{id}/drain|rejoin
                           (--serve-replicas >= 2) take a replica out of
                           the fleet's pick set, its batches in flight
                           finishing, or bring it back with a fresh
                           health slate; 409 on a single-replica server
                           and on draining the last active replica
    GET  /tenants          (--serve-tenants / --serve-models) the global
                           scheduler's view: each tenant's class and
                           accounting, the catalog's residency; 409
                           without the tenancy layer
    POST /tenants/{id}/quota
                           {"qps"?, "burst"?} update one tenant's token
                           bucket live; 400 on a malformed number or a
                           value the class refuses, 404 on an unknown
                           tenant, 409 without the tenancy layer
    GET  /metrics          the ServeMetrics record plus the queue gauges,
                           the adaptive controller, the cache's counters,
                           the breaker's windows (`resilience_policy`),
                           the tracer's counters and histograms, and
                           compiles_total, and under tenancy the
                           scheduler's `tenancy` block;
                           ?format=prometheus (or a
                           text/plain Accept) answers the same as
                           Prometheus text
    GET  /trace            (--serve-trace) the retained request traces as
                           Chrome trace-event JSON; 409 without a tracer.
                           With one, every /predict response carries
                           X-Trace-Id, and a request sent with
                           `X-Server-Timing: 1` gets a Server-Timing
                           stage breakdown

SIGHUP loads the latest checkpoint of --checkpoint-dir and puts it live
at the configured --serve-infer-dtype, as at boot; SIGTERM/SIGINT
drain (healthz 503), stop the server and print a serve_summary line.
The server prints {"metric": "serve_ready", "port": P} first, warms the
first version on a thread (a failure leaves the server up and /healthz
503 "failed") and writes a serve_stats heartbeat line every
--metrics-every seconds.

/predict submits through the cascade front (--serve-cascade), then the
prediction cache's front (--serve-cache): a hit comes back resolved,
version-tagged and metered. `X-Accuracy-Class: fast|balanced|exact`
picks the request's place on the cascade's frontier; an unknown class,
or any class on a server without the cascade, is a 400. /healthz carries
the live version's `cascade` state and, on a fleet, `replicas` and
`failovers`; /metrics its `fleet` block.

Under tenancy every /predict goes through the global scheduler
(serve/tenancy.py): `X-Tenant` names the SLO class (an unknown name
falls into "default"), a quota breach is a 429 with the bucket's own
Retry-After (capped as every Retry-After is), and the other routes read
the catalog's default model. X-Tenant sent to a server without the
layer is a 400, as the JAX server answers.

POST /cluster/epoch needs the gateway, which the port has not got: 501
naming it (ROADMAP §1 item 2). Signal handlers are installed by the
caller (serve/__main__.py), so tests can run a server in-process.
"""

from __future__ import annotations

import concurrent.futures
import datetime
import json
import logging
import math
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional
from urllib.parse import parse_qs, urlsplit

import numpy as np

from distributedmnist_tpu_torch.analysis.locks import make_lock, make_thread
from distributedmnist_tpu_torch.ops import kernel_lib
from distributedmnist_tpu_torch.serve import trace as trace_lib
from distributedmnist_tpu_torch.serve.batcher import Rejected
from distributedmnist_tpu_torch.serve.cascade import ACCURACY_CLASSES
from distributedmnist_tpu_torch.serve.metrics import prometheus_exposition
from distributedmnist_tpu_torch.serve.quantize import INFER_DTYPES
from distributedmnist_tpu_torch.serve.resilience import DeadlineExceeded
from distributedmnist_tpu_torch.serve.router import NoLiveModel
from distributedmnist_tpu_torch.serve.tenancy import QuotaExceeded

log = logging.getLogger("distributedmnist_tpu_torch")

IMAGE_BYTES = 28 * 28
GATEWAY_UNPORTED = "ROADMAP §1 item 2"
TENANCY_OFF = ("multi-tenant serving is off; --serve-tenants/"
               "--serve-models enables it")


class ServerState:
    """The serving process's lifecycle phase, reported by /healthz:
    warming -> running -> draining, and "failed" when the first version's
    load or warmup died (the server stays up to say why). Every
    transition takes the lock; draining is terminal."""

    def __init__(self):
        self._lock = make_lock("serve.state")
        self.phase = "warming"
        # lint: allow[DML004] wall-clock birth stamp for the ISO healthz field only
        self.started_at = time.time()
        self._started_mono = time.monotonic()

    def mark_running(self) -> None:
        """warming/failed -> running (no-op from draining)."""
        with self._lock:
            if self.phase in ("warming", "failed"):
                self.phase = "running"

    def mark_failed(self) -> None:
        """warming -> failed (no-op once running or draining)."""
        with self._lock:
            if self.phase == "warming":
                self.phase = "failed"

    def begin_drain(self) -> None:
        with self._lock:
            self.phase = "draining"

    def healthz(self, registry, batcher) -> tuple[int, dict]:
        live = registry.live_version()
        events = (registry.events() if hasattr(registry, "events")
                  else [])
        attempts = [e for e in events
                    if e.get("event", "").startswith("rollback")]
        rollbacks = [e for e in attempts if e.get("event") == "rollback"]
        # a version going live by any path (the warm thread, an admin
        # load and promote, SIGHUP) recovers warming/failed; draining
        # stays terminal
        if live is not None:
            self.mark_running()
        with self._lock:
            phase = self.phase
        ok = phase == "running" and live is not None
        desc = registry.describe()
        payload = {
            "ok": ok,
            "state": phase,
            "started_at": datetime.datetime.fromtimestamp(
                self.started_at,
                datetime.timezone.utc).isoformat(timespec="seconds"),
            "uptime_s": round(time.monotonic() - self._started_mono, 3),
            "live_version": live,
            "live_infer_dtype": desc.get("live_infer_dtype"),
            "pending_rows": batcher.pending_rows(),
            "inflight_batches": batcher.inflight_batches(),
            "versions": len(desc["versions"]),
            "rollbacks": len(rollbacks),
            "last_rollback": attempts[-1] if attempts else None,
            # no gateway assigns an epoch (the JAX server's None when
            # standalone)
            "cluster_epoch": None,
        }
        factory = getattr(registry, "factory", None)
        if factory is not None:
            payload["backend"] = factory.platform
            payload["device_kind"] = factory.device_kind
        # the live version's cascade (cheap dtype, threshold, the gate's
        # record), None while warming or without one
        live_desc = next((v for v in desc["versions"]
                          if isinstance(v, dict)
                          and v.get("version") == live), None)
        payload["cascade"] = (live_desc or {}).get("cascade")
        # on a fleet, each replica's state and the failover counters
        fleet = getattr(registry, "router", None)
        if getattr(fleet, "n_replicas", 1) > 1:
            snap = fleet.snapshot()
            payload["replicas"] = snap["replicas"]
            payload["failovers"] = snap["failovers"]
        return (200 if ok else 503), payload


def shed_retry_after_s(batcher, cap_s: float = 30.0) -> int:
    """Retry-After for every shed response (watermark 503, no live model
    503, deadline 504), from the pipeline's state: the effective
    coalescing wait plus the in-flight depth (and the request itself)
    priced at the measured full-batch cost. Integer seconds (RFC 9110),
    at least 1, at most `cap_s`."""
    wait_s = (batcher.controller.effective_wait_s()
              if batcher.controller is not None else batcher.max_wait_s)
    costs_fn = getattr(batcher.engine, "bucket_costs", None)
    costs = costs_fn() if callable(costs_fn) else {}
    svc_s = max(costs.values()) if costs else 0.0
    depth = batcher.inflight_batches()
    cap = max(1, int(cap_s))
    return max(1, min(cap, math.ceil(wait_s + (depth + 1) * svc_s)))


def compiles_total(*factories) -> int:
    """Kernel-library builds and loads plus the factories' engine builds
    (every catalog model's under tenancy) in this process: the count the
    bench holds to 0 after warmup (`recompiles_after_warmup`)."""
    return kernel_lib.load_events() + sum(f.engine_builds
                                          for f in factories)


class HTTPServer:
    """The HTTP server over one batcher, metrics and registry, bound at
    construction (port 0 = an ephemeral port, `self.port`). serve() runs
    it until shutdown() and returns the summary; reload() is SIGHUP's
    model roll."""

    def __init__(self, batcher, metrics, registry, state: ServerState,
                 port: int = 0, request_timeout: float = 60.0,
                 retry_after_cap_s: float = 30.0,
                 infer_dtype_choice: str = "float32", front=None,
                 cache=None, cascade: bool = False,
                 cascade_threshold: Optional[float] = None,
                 scheduler=None):
        self.batcher = batcher
        # the submit target: the cascade front, the cache front, or the
        # batcher itself; the queue gauges always read the batcher
        self.front = front if front is not None else batcher
        self.cache = cache
        self.metrics = metrics
        self.registry = registry
        # the fleet when serving one (drain/rejoin, the /metrics block)
        self.fleet = (registry.router
                      if getattr(registry.router, "n_replicas", 1) > 1
                      else None)
        # SIGHUP calibrates the cascade again on the new version
        self.cascade = cascade
        self.cascade_threshold = cascade_threshold
        # the global scheduler under tenancy (every /predict goes through
        # it; `registry` and `batcher` are then the default model's)
        self.scheduler = scheduler
        # set once the boot warm has ended, either way
        self.warmed = threading.Event()
        self.state = state
        self.request_timeout = request_timeout
        self.retry_after_cap_s = retry_after_cap_s
        self.infer_dtype_choice = infer_dtype_choice
        self.max_batch = registry.factory.max_batch
        # serializes the admin mutations of HTTP and SIGHUP threads,
        # held across restores and warmups (never by the dispatch path)
        self.admin_lock = make_lock("serve.admin")
        self.httpd = ThreadingHTTPServer(("127.0.0.1", port),
                                         _handler_class(self))
        self.port = self.httpd.server_address[1]

    def prometheus_text(self) -> str:
        """GET /metrics?format=prometheus: the metrics snapshot, the
        trace stage histograms, the queue gauges and the cache's
        counters as Prometheus text."""
        tracer = trace_lib.active()
        return prometheus_exposition(
            self.metrics.snapshot(),
            trace_stages=(tracer.snapshot()["stages"]
                          if tracer is not None else None),
            gauges={"pending_rows": self.batcher.pending_rows(),
                    "inflight_batches": self.batcher.inflight_batches()},
            cache=self.cache.stats() if self.cache is not None else None)

    def retry_after(self) -> dict:
        return {"Retry-After": str(
            shed_retry_after_s(self.batcher, self.retry_after_cap_s))}

    # -- lifecycle ---------------------------------------------------------

    def serve(self, warm: Callable[[], None],
              metrics_every: float = 10.0) -> dict:
        """Announce the port, warm on a thread, beat, serve until
        shutdown(); returns the serve_summary record."""
        print(json.dumps({"metric": "serve_ready", "port": self.port}),
              flush=True)

        def _warm():
            try:
                warm()
                self.state.mark_running()
            except Exception:
                self.state.mark_failed()
                log.exception("initial model load/warm failed; serving "
                              "503s until an admin load succeeds")
            finally:
                self.warmed.set()

        warm_thread = make_thread(target=_warm, name="serve-warm",
                                  daemon=True)
        warm_thread.start()
        stop = threading.Event()

        def _beat():
            while not stop.wait(metrics_every):
                print(self.metrics.heartbeat_line(), flush=True)

        make_thread(target=_beat, name="serve-heartbeat",
                    daemon=True).start()
        try:
            self.httpd.serve_forever(poll_interval=0.2)
        finally:
            stop.set()
            self.httpd.server_close()
            # a boot warm still building engines must end before the
            # interpreter does (a thread inside torch at exit aborts it)
            warm_thread.join(timeout=self.request_timeout)
        summary = {"metric": "serve_summary", "port": self.port,
                   "live_version": self.registry.live_version(),
                   **self.metrics.snapshot()}
        if self.cache is not None:
            summary["cache"] = self.cache.stats()
        if self.scheduler is not None:
            summary["tenancy"] = self.scheduler.snapshot()
        return summary

    def shutdown(self) -> None:
        """SIGTERM/SIGINT: healthz turns 503 while in-flight work ends;
        serve_forever() stops from another thread."""
        self.state.begin_drain()
        make_thread(target=self.httpd.shutdown, name="serve-shutdown",
                    daemon=True).start()

    def reload(self) -> threading.Thread:
        """SIGHUP: on a thread, load the latest checkpoint and put it live
        at the configured precision, as at boot (registry.go_live). A gate
        refusal puts it live at float32, loudly; any other failure leaves
        the version that was live, at its precision, and logs an error."""
        t = make_thread(target=self._reload, name="serve-reload",
                        daemon=True)
        t.start()
        return t

    def _reload(self) -> None:
        try:
            with self.admin_lock:
                mv = self.registry.load_latest()
                pick = self.registry.go_live(mv.version,
                                             self.infer_dtype_choice)
            log.info("SIGHUP reload: %s is live at %s", mv.version, pick)
        except Exception:
            log.exception("SIGHUP reload FAILED; %s stays live at %s",
                          self.registry.live_version(),
                          self.registry.router.live_infer_dtype())
            return
        if self.cascade:
            # the new parameters calibrate from scratch: a checkpoint
            # roll never carries a stale threshold forward
            try:
                with self.admin_lock:
                    st = self.registry.enable_cascade(
                        mv.version, threshold=self.cascade_threshold)
                log.info("SIGHUP reload: cascade re-gated on %s (cheap "
                         "%s, threshold %.4g)", mv.version,
                         st.cheap_dtype, st.threshold)
            except Exception:
                log.exception("SIGHUP reload: cascade refused on %s; "
                              "accuracy classes degrade to the plain "
                              "live route", mv.version)

    # -- GET ---------------------------------------------------------------

    def metrics_payload(self) -> dict:
        """GET /metrics: the metrics record plus the pipeline's gauges,
        the adaptive controller's state, the cache's counters, the
        breaker's windows, the fleet's snapshot, the tracer's snapshot,
        the scheduler's snapshot and compiles_total; a block is None when
        its layer is off (the fleet's on one replica, tenancy's on a
        single-model server)."""
        b = self.batcher
        payload = self.metrics.record()
        payload["queue"] = {
            "pending_rows": b.pending_rows(),
            "inflight_batches": b.inflight_batches(),
            "max_inflight": b.max_inflight,
            "queue_depth_watermark": b.queue_depth,
        }
        payload["adaptive"] = (b.controller.snapshot()
                               if b.controller is not None else None)
        payload["cache"] = (self.cache.stats()
                            if self.cache is not None else None)
        payload["resilience_policy"] = (b.resilience.snapshot()
                                        if b.resilience is not None
                                        else None)
        payload["fleet"] = (self.fleet.snapshot()
                            if self.fleet is not None else None)
        tracer = trace_lib.active()
        payload["trace"] = (tracer.snapshot() if tracer is not None
                            else None)
        payload["tenancy"] = (self.scheduler.snapshot()
                              if self.scheduler is not None else None)
        payload["compiles_total"] = compiles_total(*(
            [e.factory for e in self.scheduler.catalog.entries()]
            if self.scheduler is not None else [self.registry.factory]))
        return payload


def _handler_class(server: HTTPServer):
    registry, batcher, front = server.registry, server.batcher, server.front
    max_body = server.max_batch * IMAGE_BYTES

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        # TCP_NODELAY: a response goes out in two writes (headers, body),
        # and on a keep-alive connection Nagle holds the second until the
        # client's delayed ACK of the first, about 40 ms a request
        disable_nagle_algorithm = True

        def log_message(self, fmt, *args):   # requests are metered, not
            pass                             # logged line by line

        def _send(self, code: int, payload: dict,
                  extra: Optional[dict] = None) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for k, v in (extra or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _send_text(self, code: int, text: str) -> None:
            body = text.encode()
            self.send_response(code)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _content_length(self) -> Optional[int]:
            """The request's Content-Length (0 when absent), or None when
            it is not a non-negative integer: read as is, a negative
            length would read until the client hangs up."""
            try:
                length = int(self.headers.get("Content-Length", 0))
            except ValueError:
                return None
            return length if length >= 0 else None

        def _json_body(self) -> dict:
            length = self._content_length()
            if length is None:
                raise ValueError("bad Content-Length")
            if length == 0:
                return {}
            raw = self.rfile.read(length)
            body = json.loads(raw) if raw.strip() else {}
            if not isinstance(body, dict):
                raise ValueError("body must be a JSON object")
            return body

        def _wants_prometheus(self) -> bool:
            q = parse_qs(urlsplit(self.path).query)
            if q.get("format", [None])[0] == "prometheus":
                return True
            accept = self.headers.get("Accept", "")
            return ("text/plain" in accept
                    and "application/json" not in accept)

        def do_GET(self):
            if self.path == "/healthz":
                code, payload = server.state.healthz(registry, batcher)
                if (server.scheduler is not None
                        and not server.warmed.is_set()):
                    # under tenancy the default model can be live while
                    # the boot warms the others: 200 waits for them all
                    code, payload["ok"] = 503, False
                    payload["state"] = "warming"
                self._send(code, payload)
            elif self.path == "/trace" or self.path.startswith("/trace?"):
                tracer = trace_lib.active()
                if tracer is None:
                    self._send(409, {
                        "error": "tracing is not enabled; restart with "
                                 "--serve-trace"})
                else:
                    # loads in chrome://tracing and Perfetto
                    self._send(200, tracer.export_chrome())
            elif (self.path == "/metrics"
                  or self.path.startswith("/metrics?")):
                if self._wants_prometheus():
                    self._send_text(200, server.prometheus_text())
                else:
                    self._send(200, server.metrics_payload())
            elif self.path == "/models":
                self._send(200, registry.describe())
            elif self.path == "/tenants":
                if server.scheduler is None:
                    self._send(409, {"error": TENANCY_OFF})
                else:
                    self._send(200, server.scheduler.snapshot())
            else:
                self._send(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            if self.path == "/predict":
                self._predict()
            elif self.path == "/models/load":
                self._models_load()
            elif self.path == "/models/promote":
                self._models_promote()
            elif self.path == "/cluster/epoch":
                self._send(501, {"error": "cluster epochs belong to the "
                                          "gateway, not ported yet "
                                          f"({GATEWAY_UNPORTED})"})
            elif self.path.startswith("/replicas/"):
                self._replicas_admin()
            elif self.path.startswith("/tenants/"):
                self._tenants_admin()
            else:
                self._send(404, {"error": f"unknown path {self.path}"})

        # -- admin: tenant quotas -----------------------------------------

        def _tenants_admin(self):
            """POST /tenants/{id}/quota {"qps", "burst"}: 404 on another
            shape or an unknown tenant, 409 without the tenancy layer,
            400 on a malformed number or one the class refuses."""
            parts = self.path.strip("/").split("/")
            if len(parts) != 3 or parts[2] != "quota":
                self._send(404, {"error": "want POST /tenants/{id}/"
                                          "quota"})
                return
            scheduler = server.scheduler
            if scheduler is None:
                self._send(409, {"error": TENANCY_OFF})
                return
            _, tenant, _ = parts
            try:
                body = self._json_body()
            except (ValueError, json.JSONDecodeError) as e:
                self._send(400, {"error": f"bad JSON body: {e}"})
                return
            for k in ("qps", "burst"):
                v = body.get(k)
                if v is not None and (not isinstance(v, (int, float))
                                      or isinstance(v, bool)
                                      or not math.isfinite(v)):
                    self._send(400, {"error": f"{k!r} must be a finite "
                                              f"number, got {v!r}"})
                    return
            try:
                with server.admin_lock:
                    cls = scheduler.set_quota(tenant,
                                              qps=body.get("qps"),
                                              burst=body.get("burst"))
                self._send(200, {"tenant": tenant, "qps": cls.qps,
                                 "burst": cls.burst,
                                 "weight": cls.weight,
                                 "deadline_ms": cls.deadline_ms})
            except KeyError as e:
                self._send(404, {"error": str(e)})
            except ValueError as e:
                # the class refused the values (e.g. qps <= 0)
                self._send(400, {"error": str(e)})
            except Exception as e:
                self._send(500, {"error": f"{type(e).__name__}: {e}"})

        # -- admin: the replica fleet -------------------------------------

        def _replicas_admin(self):
            """POST /replicas/{id}/drain|rejoin: 404 on another shape or
            an unknown replica, 409 on a single-replica server and on
            draining the last active replica."""
            parts = self.path.strip("/").split("/")
            if len(parts) != 3 or parts[2] not in ("drain", "rejoin"):
                self._send(404, {"error": "want POST /replicas/{id}/"
                                          "drain or /replicas/{id}/"
                                          "rejoin"})
                return
            _, rid, action = parts
            fleet = server.fleet
            if fleet is None:
                self._send(409, {"error": "this server runs a single "
                                          "replica; --serve-replicas "
                                          ">= 2 enables the fleet"})
                return
            try:
                with server.admin_lock:
                    snap = (fleet.drain(rid) if action == "drain"
                            else fleet.rejoin(rid))
                self._send(200, {"action": action, "replica": snap})
            except KeyError as e:
                self._send(404, {"error": str(e)})
            except RuntimeError as e:
                # draining the last active replica: the rules refuse it
                self._send(409, {"error": str(e)})
            except Exception as e:
                self._send(500, {"error": f"{type(e).__name__}: {e}"})

        # -- admin: model lifecycle ---------------------------------------

        def _models_load(self):
            try:
                body = self._json_body()
            except (ValueError, json.JSONDecodeError) as e:
                self._send(400, {"error": f"bad JSON body: {e}"})
                return
            fresh = body.get("fresh")
            if fresh is not None and not isinstance(fresh, dict):
                self._send(400, {"error": "'fresh' must be a JSON "
                                          f"object, got {fresh!r}"})
                return
            if fresh is not None:
                seed = fresh.get("seed", 0)
                if not isinstance(seed, int) or isinstance(seed, bool):
                    self._send(400, {"error": "'fresh.seed' must be an "
                                              f"integer, got {seed!r}"})
                    return
            try:
                # load and warm on this handler thread: the dispatch
                # thread goes on serving the live version
                with server.admin_lock:
                    if fresh is not None:
                        mv = registry.add_fresh(
                            version=fresh.get("version"),
                            seed=fresh.get("seed", 0))
                    else:
                        mv = registry.load_latest(
                            directory=body.get("dir"),
                            version=body.get("version"))
                self._send(200, mv.describe())
            except FileNotFoundError as e:
                self._send(404, {"error": str(e)})
            except ValueError as e:
                self._send(400, {"error": str(e)})
            except RuntimeError as e:
                # a lifecycle conflict (e.g. registry full)
                self._send(409, {"error": str(e)})
            except Exception as e:
                self._send(500, {"error": f"{type(e).__name__}: {e}"})

        def _models_promote(self):
            try:
                body = self._json_body()
            except (ValueError, json.JSONDecodeError) as e:
                self._send(400, {"error": f"bad JSON body: {e}"})
                return
            version = body.get("version")
            mode = body.get("mode", "live")
            if not version:
                self._send(400, {"error": "missing 'version'"})
                return
            if mode not in ("live", "shadow", "canary"):
                self._send(400, {"error": f"unknown mode {mode!r}"})
                return
            # malformed input is a 400, decided before the lifecycle
            # block, whose ValueError means "the rules refused it" (409)
            try:
                fraction = float(body.get("fraction", 0.1))
            except (TypeError, ValueError):
                self._send(400, {"error": "'fraction' must be a number, "
                                          f"got {body.get('fraction')!r}"})
                return
            infer_dtype = body.get("infer_dtype")
            if infer_dtype is not None:
                if mode != "live":
                    self._send(400, {"error": "'infer_dtype' only "
                                              "applies to mode 'live'"})
                    return
                if infer_dtype not in INFER_DTYPES:
                    self._send(400, {"error": f"unknown infer_dtype "
                                              f"{infer_dtype!r}; one of "
                                              f"{list(INFER_DTYPES)}"})
                    return
            cascade_threshold = body.get("cascade_threshold")
            if cascade_threshold is not None:
                if mode != "live":
                    self._send(400, {"error": "'cascade_threshold' only "
                                              "applies to mode 'live'"})
                    return
                try:
                    cascade_threshold = float(cascade_threshold)
                except (TypeError, ValueError):
                    self._send(400, {
                        "error": "'cascade_threshold' must be a number, "
                                 f"got {body.get('cascade_threshold')!r}"})
                    return
                if (not math.isfinite(cascade_threshold)
                        or not 0.0 <= cascade_threshold <= 1.0):
                    self._send(400, {
                        "error": "'cascade_threshold' must be a finite "
                                 "number in [0, 1], got "
                                 f"{cascade_threshold!r}"})
                    return
            try:
                with server.admin_lock:
                    if mode == "live":
                        mv = registry.promote(
                            version, infer_dtype=infer_dtype,
                            cascade_threshold=cascade_threshold)
                    elif mode == "shadow":
                        mv = registry.set_shadow(version, fraction)
                    else:
                        mv = registry.set_canary(version, fraction)
                self._send(200, {"promoted": mv.version, "mode": mode,
                                 **registry.describe()["routes"]})
            except KeyError as e:
                self._send(404, {"error": str(e)})
            except (ValueError, RuntimeError) as e:
                # an unwarmed version, a bad fraction: the lifecycle
                # rules refuse it
                self._send(409, {"error": str(e)})
            except Exception as e:
                self._send(500, {"error": f"{type(e).__name__}: {e}"})

        # -- data path ----------------------------------------------------

        def _predict(self):
            length = self._content_length()
            if length is None:
                self._send(400, {"error": "Content-Length must be a "
                                          "non-negative integer"})
                return
            if length == 0 or length % IMAGE_BYTES:
                self._send(400, {"error": "body must be n*784 raw "
                                          "uint8 pixel bytes"})
                return
            if length > max_body:
                self._send(413, {"error": f"at most {server.max_batch} "
                                          "images per request"})
                return
            # X-Deadline-Ms: the client's latency budget. It rides the
            # request into the batcher, which sheds it before dispatch if
            # it expires while queued, and bounds this handler's wait.
            hdr = self.headers.get("X-Deadline-Ms")
            budget_s = deadline_s = None
            if hdr is not None:
                try:
                    budget_s = float(hdr) / 1e3
                except ValueError:
                    self._send(400, {"error": "X-Deadline-Ms must be a "
                                              f"number, got {hdr!r}"})
                    return
                if not math.isfinite(budget_s) or budget_s <= 0:
                    # nan passes a bare <= 0 check and would disable the
                    # deadline silently
                    self._send(400, {"error": "X-Deadline-Ms must be a "
                                              "finite number > 0"})
                    return
                deadline_s = time.monotonic() + budget_s
            # X-Accuracy-Class: fast = the cheap variant, balanced = the
            # cascade, exact = float32; sent to a server without the
            # cascade it is a client's error, never served at another
            # precision than asked
            acc_hdr = self.headers.get("X-Accuracy-Class")
            accuracy_class = None
            if acc_hdr is not None:
                accuracy_class = acc_hdr.strip().lower()
                if accuracy_class not in ACCURACY_CLASSES:
                    self._send(400, {
                        "error": "X-Accuracy-Class must be one of "
                                 f"{'|'.join(ACCURACY_CLASSES)}, got "
                                 f"{acc_hdr!r}"})
                    return
                if not getattr(front, "is_cascade_front", False):
                    self._send(400, {
                        "error": "X-Accuracy-Class requires the "
                                 "confidence cascade; restart with "
                                 "--serve-cascade"})
                    return
            # X-Tenant names the request's SLO class; sent to a
            # single-model server it is a client's error, as loud as an
            # X-Accuracy-Class the server cannot honour
            tenant_hdr = self.headers.get("X-Tenant")
            if tenant_hdr is not None and server.scheduler is None:
                self._send(400, {
                    "error": "X-Tenant requires multi-tenant serving; "
                             "restart with --serve-tenants"})
                return
            raw = self.rfile.read(length)
            x = np.frombuffer(raw, np.uint8).reshape(-1, IMAGE_BYTES)
            fut = None

            def trace_headers() -> dict:
                """X-Trace-Id on every response whose request entered
                the pipeline, plus a Server-Timing stage breakdown when
                the request asked for it (`X-Server-Timing: 1`): the
                batcher finishes a trace before it resolves the
                future, so the breakdown is there to read."""
                tid = getattr(fut, "trace_id", None)
                if tid is None:
                    return {}
                hdrs = {"X-Trace-Id": tid}
                opt = (self.headers.get("X-Server-Timing") or "")
                if opt.strip().lower() in ("1", "true", "yes", "on"):
                    tracer = trace_lib.active()
                    st = (tracer.server_timing(tid)
                          if tracer is not None else None)
                    if st:
                        hdrs["Server-Timing"] = st
                return hdrs

            try:
                # through the cascade and cache fronts when there are
                # any: a hit comes back resolved, a collapsed miss shares
                # its leader's
                if server.scheduler is not None:
                    fut = server.scheduler.submit(x, tenant=tenant_hdr,
                                                  deadline_s=deadline_s)
                elif accuracy_class is not None:
                    fut = front.submit(x, deadline_s=deadline_s,
                                       accuracy_class=accuracy_class)
                else:
                    fut = front.submit(x, deadline_s=deadline_s)
                # bounded: a wedged pipeline sheds its waiters instead of
                # holding handler threads forever
                logits = fut.result(timeout=(
                    server.request_timeout if budget_s is None
                    else min(server.request_timeout, budget_s)))
            except QuotaExceeded as e:
                # over the tenant's token bucket: the bucket's own refill
                # time, capped like every Retry-After this server sends
                self._send(429, {"error": str(e)}, extra={
                    "Retry-After": str(max(1, min(
                        int(math.ceil(e.retry_after_s)),
                        int(server.retry_after_cap_s))))})
                return
            except Rejected:
                self._send(503, {"error": "overloaded; retry"},
                           extra=server.retry_after())
                return
            except NoLiveModel:
                self._send(503, {"error": "no warmed model is live yet"},
                           extra={**server.retry_after(),
                                  **trace_headers()})
                return
            except DeadlineExceeded as e:
                self._send(504, {"error": str(e)},
                           extra={**server.retry_after(),
                                  **trace_headers()})
                return
            except concurrent.futures.TimeoutError:
                if (deadline_s is not None
                        and time.monotonic() >= deadline_s):
                    self._send(504, {"error": "deadline expired while "
                                              "awaiting inference"},
                               extra={**server.retry_after(),
                                      **trace_headers()})
                else:
                    self._send(504, {
                        "error": "inference timed out after "
                                 f"{server.request_timeout:g}s"},
                        extra=trace_headers())
                return
            except Exception as e:
                self._send(500, {"error": f"{type(e).__name__}: {e}"},
                           extra=trace_headers())
                return
            self._send(200, {"classes": logits.argmax(-1).tolist(),
                             "n": int(x.shape[0]),
                             "version": getattr(fut, "version", None)},
                       extra=trace_headers())

    return Handler
