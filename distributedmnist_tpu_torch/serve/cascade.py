"""The confidence-gated cascade: int8 goodput at float32 accuracy (the
port of the JAX package's serve/cascade.py, same names, calibration rule
and counters).

The cheap variant (int8, or the megakernel where it is the cheapest gated
one) answers every request first. Rows whose softmax margin (top-1 minus
top-2 probability) clears a CALIBRATED threshold are served as they are;
the rest are submitted again to float32 through the normal coalescing
path, so an escalation is just a request: batching, the in-flight window,
the cache's keys and bisection all hold. Both stages run engines warmup
has already built, so a cascade builds nothing.

The threshold is not a knob: `calibrate` sets it per version on the
registry's held-out parity batch, as the smallest escalation set whose
composed answer (escalated rows by float32, the rest by the cheap
variant) agrees with float32 within the parity bar, with every row the
cheap stage got wrong escalated. That is the cascade's gate: a cascade
serves only when the composition passes. `threshold_of` is the one
accessor of the calibrated value.

Request surface (the HTTP server's `X-Accuracy-Class`):

    fast      the cheap variant only
    balanced  the cascade: the cheap stage, float32 for uncertain rows
    exact     float32 only

CascadeFront sits in front of the CacheFront (or the bare batcher),
submit-shaped. Composed answers are cached under `cascade:<dtype>`, and
the stages under their own dtypes, so a cheap-only answer is never
served to an `exact` request.
"""

from __future__ import annotations

import dataclasses
import time
from concurrent.futures import Future
from typing import Optional

import numpy as np

from distributedmnist_tpu_torch.serve import trace

# the classes X-Accuracy-Class selects (400 on anything else)
ACCURACY_CLASSES = ("fast", "balanced", "exact")

# composed results are cached under this route-label prefix, apart from
# every single-dtype label
CASCADE_LABEL_PREFIX = "cascade:"


def cascade_label(cheap_dtype: str) -> str:
    """The prediction-cache route label composed results live under."""
    return CASCADE_LABEL_PREFIX + cheap_dtype


def softmax_margin(logits) -> np.ndarray:
    """Per-row confidence margin, softmax(top-1) - softmax(top-2), as
    float64 in [0, 1], on the host from fetched logits."""
    z = np.asarray(logits, dtype=np.float64)
    z = z - z.max(axis=-1, keepdims=True)
    p = np.exp(z)
    p /= p.sum(axis=-1, keepdims=True)
    top2 = np.partition(p, -2, axis=-1)[..., -2:]
    return top2[..., 1] - top2[..., 0]


def _composed(margins, agree, threshold: float) -> tuple:
    """(composed agreement, escalation fraction) at `threshold`: rows
    below it are answered by the reference (agreeing by definition), the
    rest keep the cheap answer."""
    esc = margins < threshold
    composed = float(np.mean(np.where(esc, True, agree)))
    return composed, float(np.mean(esc))


def calibrate(ref_logits, cheap_logits, min_agreement: float,
              threshold: Optional[float] = None,
              max_escalation: float = 0.5) -> dict:
    """Calibrate (or, given `threshold`, judge) the cascade's threshold
    on the held-out parity batch.

    Rows sorted by cheap-stage margin: escalating the k lowest gives a
    composed agreement of (k + agreements among the rest) / n. k is the
    smallest that clears `min_agreement` AND escalates every row the
    cheap stage got wrong, capped at `max_escalation` * n (past half the
    batch the cascade is slower than float32). The threshold is the
    midpoint of the k-th and (k+1)-th sorted margins (the k-th itself on
    a tie), and the record is measured again at that threshold.
    passed=False, with why, when nothing under the cap reaches the bar.
    A given `threshold` (a promote-time override) skips the search and
    faces the same gate."""
    ref = np.asarray(ref_logits)
    cheap = np.asarray(cheap_logits)
    if ref.shape != cheap.shape:
        raise ValueError(
            f"logit shapes differ: reference {ref.shape} vs cheap "
            f"{cheap.shape}")
    n = ref.shape[0]
    margins = softmax_margin(cheap)
    agree = ref.argmax(-1) == cheap.argmax(-1)
    base = float(np.mean(agree))
    source = "calibrated"
    if threshold is None:
        order = np.argsort(margins, kind="stable")
        ms = margins[order]
        ag = agree[order]
        # composed_k[k]: agreement with exactly the k lowest escalated
        suffix = np.concatenate([np.cumsum(ag[::-1])[::-1], [0.0]])
        composed_k = (np.arange(n + 1) + suffix) / n
        meets = np.nonzero(composed_k >= min_agreement)[0]
        k_bar = int(meets[0]) if meets.size else n
        wrong = np.nonzero(~ag)[0]
        k_full = int(wrong[-1]) + 1 if wrong.size else 0
        k_cap = int(np.floor(max_escalation * n))
        k = min(max(k_bar, k_full), k_cap)
        if k <= 0:
            threshold = 0.0
        elif k >= n:
            threshold = float(np.nextafter(ms[-1], np.inf))
        elif ms[k - 1] == ms[k]:
            # a tie across the cut: `< threshold` cannot split it
            threshold = float(ms[k])
        else:
            threshold = float((ms[k - 1] + ms[k]) / 2.0)
    else:
        source = "override"
        threshold = float(threshold)
    composed, esc_frac = _composed(margins, agree, threshold)
    why = None
    if composed < min_agreement:
        why = (f"composed argmax agreement {composed:.4f} < "
               f"{min_agreement} at threshold {threshold:.4f} "
               f"(escalating {esc_frac:.1%} of {n} rows, cap "
               f"{max_escalation:.0%}; cheap-only agreement {base:.4f})")
    return {
        "passed": why is None,
        "why": why,
        "threshold": threshold,
        "rows": int(n),
        "base_agreement": round(base, 6),
        "composed_agreement": round(composed, 6),
        "escalation_fraction": round(esc_frac, 6),
        "min_agreement": min_agreement,
        "max_escalation": max_escalation,
        "source": source,
    }


@dataclasses.dataclass
class CascadeState:
    """A version's calibrated cascade: the cheap variant that answers
    first, the threshold, and the gate's calibration record."""

    cheap_dtype: str
    threshold: float
    calibration: dict

    def describe(self) -> dict:
        return {
            "cheap_dtype": self.cheap_dtype,
            "threshold": round(self.threshold, 6),
            "calibration": self.calibration,
        }


def threshold_of(state: CascadeState) -> float:
    """The calibrated threshold: every margin comparison reads it here,
    so the escalation rule cannot drift from the gate that proved the
    composition."""
    return float(state.threshold)


class CascadeFront:
    """Submit-shaped cascade over the CacheFront (or the bare batcher):
    splits cheap-stage results by margin and submits the uncertain rows
    again to float32. Stage 2 is submitted inside stage 1's
    done-callback, which the batcher runs before stage 1's segment leaves
    its in-flight count, so "nothing pending and nothing in flight" still
    means drained.

    With no calibrated cascade on the live version (warming, or a promote
    to a version without one) every class degrades to the plain live
    route, counted in metrics, never an error."""

    # the HTTP handler accepts X-Accuracy-Class only on this marker
    is_cascade_front = True

    def __init__(self, inner, batcher, router, registry, metrics=None,
                 cache=None, default_class: str = "balanced"):
        from distributedmnist_tpu_torch.serve.cache import CacheFront

        if default_class not in ACCURACY_CLASSES:
            raise ValueError(
                f"unknown default accuracy class {default_class!r} "
                f"(expected one of {ACCURACY_CLASSES})")
        self.inner = inner
        self.batcher = batcher
        self.router = router
        self.registry = registry
        self.metrics = metrics
        self.cache = cache
        self.default_class = default_class
        self._inner_labeled = isinstance(inner, CacheFront)

    # -- engine-shaped proxies (the bench's drain predicate, the server) ---

    def pending_rows(self) -> int:
        return self.inner.pending_rows()

    def inflight_batches(self) -> int:
        return self.inner.inflight_batches()

    def stop(self, drain: bool = True) -> None:
        self.inner.stop(drain=drain)

    # -- submission --------------------------------------------------------

    def _plan(self):
        """(live version, CascadeState) when the live version has a
        calibrated cascade, else None."""
        plan = getattr(self.registry, "cascade_plan", None)
        return plan() if callable(plan) else None

    def _inner_submit(self, x, deadline_s, route, label) -> Future:
        """A stage through the inner layer: the CacheFront keys it under
        `label`, a bare batcher just pins the route."""
        if self._inner_labeled:
            return self.inner.submit(x, deadline_s=deadline_s,
                                     route=route, route_label=label)
        return self.inner.submit(x, deadline_s=deadline_s, route=route)

    def submit(self, x, deadline_s: Optional[float] = None,
               accuracy_class: Optional[str] = None) -> Future:
        cls = accuracy_class or self.default_class
        if cls not in ACCURACY_CLASSES:
            raise ValueError(
                f"unknown accuracy class {cls!r} (expected one of "
                f"{ACCURACY_CLASSES})")
        plan = self._plan()
        if self.metrics is not None:
            self.metrics.record_cascade_submit(cls, degraded=plan is None)
        if plan is None:
            return self.inner.submit(x, deadline_s=deadline_s)
        version, state = plan
        if cls == "exact":
            return self._inner_submit(x, deadline_s, "float32", "float32")
        if cls == "fast":
            return self._inner_submit(x, deadline_s, state.cheap_dtype,
                                      state.cheap_dtype)
        return self._balanced(x, deadline_s, version, state)

    def _balanced(self, x, deadline_s, version: str,
                  state: CascadeState) -> Future:
        x = self.router._as_images(x)
        n = x.shape[0]
        t0 = time.monotonic()
        label = cascade_label(state.cheap_dtype)
        rid = self.batcher.next_rid()
        out: Future = Future()
        tr = trace.active()
        tid = None
        if tr is not None:
            tid = tr.start_request(rid, rows=n, deadline_s=deadline_s,
                                   t0=t0)
            out.trace_id = tid
        key = epoch = None
        if self.cache is not None:
            from distributedmnist_tpu_torch.serve.cache import content_key

            key = content_key(version, label, x)
            t_lk = time.monotonic()
            cached = self.cache.lookup(key)
            trace.add_span("cache.lookup", t_lk, time.monotonic(),
                           rids=(rid,), hit=cached is not None)
            if cached is not None:
                t_hit = time.monotonic()
                trace.add_span("cache.hit", t0, t_hit, rids=(rid,))
                if tr is not None:
                    tr.finish_request(rid, t_end=t_hit)
                if self.metrics is not None:
                    self.metrics.record_cache_hit(
                        t_hit - t0, rows=n, version=version,
                        infer_dtype=label)
                out.version = version
                out.set_result(cached)
                return out
            epoch = self.cache.epoch()
        ctx = {"x": x, "n": n, "t0": t0, "rid": rid, "tid": tid,
               "version": version, "state": state, "key": key,
               "epoch": epoch, "deadline_s": deadline_s, "out": out,
               "label": label}
        try:
            f1 = self._inner_submit(x, deadline_s, state.cheap_dtype,
                                    state.cheap_dtype)
        except BaseException:
            # never admitted: nothing will finish this trace
            if tr is not None:
                tr.abort_request(rid)
            raise
        f1.add_done_callback(lambda f: self._stage1_done(ctx, f))
        return out

    def _stage1_done(self, ctx: dict, f1: Future) -> None:
        try:
            logits1 = f1.result()
        except BaseException as e:
            self._finish(ctx, error=e)
            return
        t1 = time.monotonic()
        state = ctx["state"]
        rid = ctx["rid"]
        margins = softmax_margin(logits1)
        esc = margins < threshold_of(state)
        n_esc = int(esc.sum())
        trace.add_span("cascade.stage", ctx["t0"], t1, rids=(rid,),
                       stage=state.cheap_dtype, rows=ctx["n"],
                       escalated=n_esc)
        if self.metrics is not None:
            self.metrics.record_cascade_first_stage(state.cheap_dtype,
                                                    ctx["n"], n_esc)
        v1 = getattr(f1, "version", None)
        if n_esc == 0:
            self._finish(ctx, logits=np.asarray(logits1), v1=v1, v2=v1)
            return
        trace.add_span("cascade.escalate", t1, t1, rids=(rid,),
                       rows=n_esc, threshold=round(threshold_of(state),
                                                   6))
        idx = np.nonzero(esc)[0]
        try:
            # the escalation keeps the request's deadline: under deadline
            # pressure it is shed like any request
            f2 = self._inner_submit(ctx["x"][idx], ctx["deadline_s"],
                                    "float32", "float32")
        except BaseException as e:
            self._finish(ctx, error=e)
            return
        f2.add_done_callback(
            lambda f: self._stage2_done(ctx, np.asarray(logits1), idx,
                                        v1, t1, f))

    def _stage2_done(self, ctx: dict, logits1, idx, v1, t1,
                     f2: Future) -> None:
        try:
            logits2 = f2.result()
        except BaseException as e:
            self._finish(ctx, error=e)
            return
        t2 = time.monotonic()
        # rows are independent through every engine forward, so an
        # escalated row's bytes are exactly the float32 route's
        composed = np.array(logits1)
        composed[idx] = logits2
        trace.add_span("cascade.stage", t1, t2, rids=(ctx["rid"],),
                       stage="float32", rows=int(len(idx)))
        if self.metrics is not None:
            self.metrics.record_cascade_stage("float32", int(len(idx)))
        self._finish(ctx, logits=composed, v1=v1,
                     v2=getattr(f2, "version", None))

    def _finish(self, ctx: dict, logits=None, v1=None, v2=None,
                error=None) -> None:
        """Resolve the composed request: the trace finishes before the
        future resolves, and the composed bytes are cached only when both
        stages ran the version this request was keyed under (the cache
        checks the epoch again under its lock)."""
        out = ctx["out"]
        version = v1 if v1 == v2 else None
        if (error is None and ctx["key"] is not None
                and version is not None
                and version == ctx["version"]):
            self.cache.insert(ctx["key"], logits, version,
                              ctx["label"], epoch=ctx["epoch"])
        tr = trace.active()
        if tr is not None and ctx["tid"] is not None:
            tr.finish_request(ctx["rid"], error=error)
        if error is not None:
            out.set_exception(error)
            return
        out.version = version
        out.set_result(logits)
