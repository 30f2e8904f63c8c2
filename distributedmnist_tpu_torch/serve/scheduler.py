"""Cost-model bucket packing and the adaptive coalescing wait (the port
of the JAX package's serve/scheduler.py, pure policy: no torch, no
threads of its own).

- **plan_segments** — the batch former. Padding a whole drain to its
  covering bucket can burn much of a dispatch on padding (9 rows run the
  16-row program). Engine warmup measures each bucket's cost, and
  plan_segments cuts one FIFO drain at request boundaries into several
  bucket-shaped dispatches whenever that cost table says splitting beats
  padding (20 rows -> 16 + 4 instead of 32): an exact dynamic program
  over the cut points, O(requests x buckets).
- **AdaptiveController** — AIMD on the coalescing wait: multiplicative
  step down on every SLO violation, small additive step up after a
  window of comfortably-under-SLO requests, never above the configured
  max_wait; plus an arrival-rate EWMA that caps the wait at the time the
  current rate needs to fill max_batch rows.
- **fastlane_eligible** — the fast lane's admission rule.
- **estimate_dispatch_s, edf_pick, drr_grant, drr_charge,
  drr_skip_bound** — the tenancy layer's pricing and grant policy
  (serve/tenancy.py calls them under its own lock with plain dicts).
"""

from __future__ import annotations

import math
import time
from bisect import bisect_right
from typing import Mapping, Optional, Sequence

from distributedmnist_tpu_torch.analysis.locks import make_lock


def fit_dispatch_cost(costs: Mapping[int, float]) -> tuple[float, float]:
    """Least-squares affine fit of a measured bucket-cost ladder:
    cost(b) ~= overhead + per_row * b, both clamped non-negative. Pooling
    the ladder keeps split-vs-pad decisions off the timing noise of
    single entries. Returns (overhead_s, per_row_s)."""
    bs = sorted(costs)
    n = len(bs)
    if n == 0:
        raise ValueError("empty cost table")
    ys = [max(costs[b], 0.0) for b in bs]
    if n == 1:
        return ys[0], 0.0
    mx = sum(bs) / n
    my = sum(ys) / n
    sxx = sum((x - mx) ** 2 for x in bs)
    sxy = sum((x - mx) * (y - my) for x, y in zip(bs, ys))
    per_row = max(sxy / sxx, 0.0) if sxx else 0.0
    overhead = max(my - per_row * mx, 0.0)
    return overhead, per_row


# One-slot fit memo: the cost table changes only by whole-reference swap
# (warmup, a promote), while plan_segments runs once per drain. A racing
# read just recomputes (one atomic tuple assignment).
_fit_memo = None   # (costs_obj, buckets_tuple, (overhead_s, per_row_s))


def _fitted(costs: Mapping[int, float],
            buckets: Sequence[int]) -> tuple[float, float]:
    global _fit_memo
    memo = _fit_memo
    bkey = tuple(buckets)
    if memo is not None and memo[0] is costs and memo[1] == bkey:
        return memo[2]
    fit = fit_dispatch_cost({b: costs[b] for b in buckets})
    _fit_memo = (costs, bkey, fit)
    return fit


def plan_segments(sizes: Sequence[int], buckets: Sequence[int],
                  costs: Mapping[int, float],
                  pad_bias: float = 2.0) -> list[int]:
    """Partition a FIFO drain into contiguous dispatch segments.

    `sizes` are the per-request row counts in queue order, `buckets` the
    ascending ladder, `costs` the measured seconds per dispatch of each
    bucket. A dispatch into bucket b carrying r real rows is priced
    overhead + per_row * (r + pad_bias * (b - r)) off the affine fit: a
    padded row costs pad_bias x a real row, leaning near-ties toward less
    padding. Returns request counts per segment (sum == len(sizes));
    [len(sizes)] means "don't split". dp[j] is the least cost of the first
    j requests; from request i each bucket only needs its furthest fill.
    Ties break toward fewer segments."""
    k = len(sizes)
    if k <= 1:
        return [k] if k else []
    if any(b not in costs for b in buckets):
        return [k]            # no complete cost model: don't split
    overhead, per_row = _fitted(costs, buckets)
    prefix = [0]
    for s in sizes:
        prefix.append(prefix[-1] + s)
    INF = (math.inf, math.inf)
    dp: list[tuple] = [INF] * (k + 1)     # (cost, n_segments)
    back = [0] * (k + 1)
    dp[0] = (0.0, 0)
    for i in range(k):
        if dp[i] is INF:
            continue
        cost_i, segs_i = dp[i]
        for b in buckets:
            j = bisect_right(prefix, prefix[i] + b) - 1
            if j <= i:
                continue                  # bucket can't carry request i
            rows = prefix[j] - prefix[i]
            seg_cost = overhead + per_row * (
                rows + pad_bias * (b - rows))
            cand = (cost_i + seg_cost, segs_i + 1)
            if cand < dp[j]:
                dp[j] = cand
                back[j] = i
    if dp[k] is INF:
        return [k]            # a request larger than the top bucket
    cuts = []
    j = k
    while j > 0:
        cuts.append(j)
        j = back[j]
    cuts.append(0)
    cuts.reverse()
    return [b - a for a, b in zip(cuts, cuts[1:])]


def fastlane_eligible(enabled: bool, pending_rows: int) -> bool:
    """The fast lane's admission rule: a submit may skip the coalescing
    path only when the lane is on AND the queue is EMPTY (a non-empty
    queue is traffic worth coalescing with, and jumping it would reorder
    FIFO service). The other half of the decision, a free in-flight slot,
    is a semaphore try-acquire the batcher makes under the same queue
    lock."""
    return enabled and pending_rows == 0


# -- multi-tenant WFQ / EDF policy (serve/tenancy.py) -----------------------


def estimate_dispatch_s(rows: int, buckets: Sequence[int],
                        costs: Mapping[int, float],
                        default_per_row_s: float = 1e-3) -> float:
    """Price a prospective dispatch of `rows` real rows against a model's
    measured bucket-cost ladder: the affine fit at the covering bucket
    (padding included: the engine runs the whole bucket). With no
    complete cost table, a row-proportional unit price, so the policy
    stays total rather than guessing zero."""
    if rows <= 0:
        return 0.0
    if costs and buckets and all(b in costs for b in buckets):
        overhead, per_row = _fitted(costs, buckets)
        b = next((x for x in buckets if x >= rows), buckets[-1])
        return overhead + per_row * max(b, rows)
    return default_per_row_s * rows


def edf_pick(heads: Sequence[tuple], now: float) -> tuple:
    """Earliest-feasible-deadline selection across model queues.

    `heads` holds one (key, deadline, est_cost_s) per non-empty queue:
    the head's ABSOLUTE deadline (None = best-effort) and the modeled
    cost of dispatching it now. Returns (pick, infeasible): `pick` is the
    key with the earliest deadline among heads that can still make it
    (best-effort heads rank after every deadlined head; ties break by
    input order), or None; `infeasible` lists the keys whose head cannot
    meet its deadline even if dispatched now (shed them with 504)."""
    infeasible = []
    feas = []
    for i, (key, deadline, cost_s) in enumerate(heads):
        if deadline is not None and now + cost_s > deadline:
            infeasible.append(key)
        else:
            feas.append((deadline if deadline is not None else math.inf,
                         i, key))
    if not feas:
        return None, infeasible
    feas.sort()
    return feas[0][2], infeasible


def drr_grant(ring: Sequence, cursor: int, deficits: dict,
              weights: Mapping, quantum: float, head_costs: Mapping,
              max_rounds: int = 1024) -> tuple:
    """One weighted deficit-round-robin grant decision.

    `ring` is the fixed visit order of flows (tenants), `cursor` the ring
    index of the LAST granted flow, `deficits` the per-flow credit
    (mutated in place; the caller holds the scheduler lock), `head_costs`
    each BACKLOGGED flow's head cost (absent = idle). Each visit credits
    a flow `quantum * weight` and grants the first flow whose balance
    covers its head; idle flows' balances reset to zero. Returns (flow,
    new_cursor, rounds_scanned), or (None, cursor, 0) when nothing is
    backlogged. Raises RuntimeError after `max_rounds` full scans (a
    quantum no head can ever afford)."""
    if not ring or not head_costs:
        return None, cursor, 0
    n = len(ring)
    for f in ring:
        if f not in head_costs:
            deficits[f] = 0.0
    pos = cursor % n
    for rounds in range(max_rounds):
        for _ in range(n):
            pos = (pos + 1) % n
            f = ring[pos]
            if f not in head_costs:
                continue
            deficits[f] = (deficits.get(f, 0.0)
                           + quantum * weights.get(f, 1.0))
            if deficits[f] >= head_costs[f] - 1e-12:
                return f, pos, rounds
    raise RuntimeError(
        f"drr_grant: no flow affordable after {max_rounds} full scans "
        f"(quantum={quantum}, heads={dict(head_costs)}) — quantum is "
        "misconfigured relative to the cost model")


def drr_charge(deficits: dict, flow, cost: float) -> None:
    """Debit a granted flow's balance by the work dispatched, clamped at
    zero (carrying debt forward would punish the flow twice)."""
    deficits[flow] = max(deficits.get(flow, 0.0) - cost, 0.0)


def drr_skip_bound(n_flows: int, max_cost: float, quantum: float,
                   min_weight: float) -> int:
    """Closed-form starvation bound for drr_grant: a backlogged flow is
    granted within this many consecutive grants to other flows. Each
    full ring scan credits it quantum*weight; it needs at most
    ceil(max_cost / that) scans, and between scans at most n_flows-1
    other grants interleave."""
    per_scan = max(quantum * min_weight, 1e-12)
    scans = max(int(math.ceil(max_cost / per_scan)), 1)
    return max(n_flows, 1) * (scans + 1)


class AdaptiveController:
    """AIMD effective-wait controller + arrival-rate EWMA (thread-safe).

    `on_arrival` is called by every accepted submit, `on_latency` with
    every request's end-to-end latency; `effective_wait_s` is read once
    per drain. With no SLO the AIMD half is inert and the wait is the
    static max_wait_s, capped by the fill time."""

    def __init__(self, max_wait_s: float, slo_s: Optional[float] = None,
                 max_batch: Optional[int] = None, headroom: float = 0.8,
                 decrease: float = 0.5, increase_frac: float = 0.05,
                 window: int = 32, rate_tau_s: float = 1.0):
        if max_wait_s < 0:
            raise ValueError(f"max_wait_s must be >= 0, got {max_wait_s}")
        if slo_s is not None and slo_s <= 0:
            raise ValueError(f"slo_s must be > 0, got {slo_s}")
        if not 0 < decrease < 1:
            raise ValueError(f"decrease must be in (0,1), got {decrease}")
        self.max_wait_s = float(max_wait_s)
        self.slo_s = slo_s
        self.max_batch = max_batch
        self.headroom = headroom
        self.decrease = decrease
        self.increase_s = increase_frac * self.max_wait_s
        self.window = window
        self.rate_tau_s = rate_tau_s
        self._lock = make_lock("scheduler.aimd")
        self._wait_s = self.max_wait_s
        self._rate = 0.0                  # rows/sec EWMA
        self._t_last: Optional[float] = None
        self._win_n = 0                   # under-SLO samples this window
        self._win_max = 0.0
        self._violations = 0
        self._increases = 0
        self._fastpath = 0                # fast-lane dispatches seen

    def on_arrival(self, rows: int = 1, now: Optional[float] = None,
                   coalesced: bool = True) -> None:
        """One accepted request of `rows` rows; feeds the arrival-rate
        EWMA (irregular-interval exponential decay, tau=rate_tau_s).
        `coalesced=False` marks a fast-lane request: counted, but kept
        out of the EWMA, which prices how fast the QUEUE fills."""
        if now is None:
            now = time.monotonic()
        with self._lock:
            if not coalesced:
                self._fastpath += 1
                return
            if self._t_last is None:
                self._t_last = now
                return
            dt = max(now - self._t_last, 1e-9)
            self._t_last = now
            decay = math.exp(-dt / self.rate_tau_s)
            self._rate = decay * self._rate + (1.0 - decay) * (rows / dt)

    def on_latency(self, seconds: float) -> None:
        """One request's end-to-end latency: a violation halves the wait;
        `window` under-SLO samples below headroom*SLO earn one additive
        step back up, never past max_wait_s."""
        if self.slo_s is None:
            return
        with self._lock:
            if seconds > self.slo_s:
                self._wait_s *= self.decrease
                self._violations += 1
                self._win_n = 0
                self._win_max = 0.0
                return
            self._win_n += 1
            self._win_max = max(self._win_max, seconds)
            if self._win_n >= self.window:
                if self._win_max < self.headroom * self.slo_s:
                    self._wait_s = min(self.max_wait_s,
                                       self._wait_s + self.increase_s)
                    self._increases += 1
                self._win_n = 0
                self._win_max = 0.0

    def effective_wait_s(self) -> float:
        """The AIMD point, capped by the time the current arrival rate
        needs to fill max_batch rows, clamped into [0, max_wait_s]."""
        with self._lock:
            w = self._wait_s
            if self.max_batch and self._rate > 0:
                w = min(w, self.max_batch / self._rate)
            return min(max(w, 0.0), self.max_wait_s)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "slo_ms": (round(self.slo_s * 1e3, 3)
                           if self.slo_s is not None else None),
                "max_wait_us": round(self.max_wait_s * 1e6, 1),
                "aimd_wait_us": round(self._wait_s * 1e6, 1),
                "arrival_rate_rows_per_sec": round(self._rate, 1),
                "violations": self._violations,
                "increases": self._increases,
                "fastpath_dispatches": self._fastpath,
            }
