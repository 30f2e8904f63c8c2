"""Config-driven fault injection for the serving stack (the port of the
JAX package's serve/faults.py, same names, specs and draws).

Named failpoints are woven through the serving layers:

    engine.dispatch    InferenceEngine.dispatch / dispatch_fast
    engine.fetch       InferenceEngine.fetch (ctx: version)
    batch.dispatch     the batcher's dispatch site (ctx: rids, the
                       request-sticky point poison faults key on)
    router.shadow      the shadow duplicate dispatch in Router
    registry.restore   ModelRegistry.load_latest's checkpoint restore
    registry.warmup    ModelRegistry.add's engine build + warmup
    registry.variant   ModelRegistry.add_variant's build + gate
    replica.dispatch   ReplicaSet's per-replica dispatch (ctx replica)
    replica.fetch      ReplicaSet's per-replica fetch (ctx replica)

each a single call to failpoint(name, **ctx). With no injector installed
that call is one module-global None check.

An installed FaultInjector holds FaultRules parsed from a spec string
(--serve-faults, the chaos bench's schedule):

    point:key=val,key=val;point2:...

keys: p (probability, default 1), mode (call|request), error (message;
the rule raises InjectedFault), latency_ms (a sleep before any error),
count (max fires), after (skip the first N matching evaluations); any
other key=val is a ctx equality filter (version=v1 fires only there).

- **call** mode draws from a seeded per-rule random.Random per crossing.
- **request** mode draws sha256(f"{seed}:{point}:{rid}") per request id
  in ctx["rids"] and fires iff the crossing covers a poison request: the
  same request fails every dispatch that contains it, which is what the
  batcher's bisection needs to isolate it. The draw hashes the same
  string as the JAX package's, so one spec and seed poison the same
  requests in both packages.
"""

from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Optional

from distributedmnist_tpu_torch.analysis.locks import make_lock


# Every failpoint woven through the serving stack, by name. parse_spec
# refuses names outside this set: a typo'd point would otherwise
# install a schedule that silently injects nothing — and a chaos drill
# that injected nothing "proves" resilience it never exercised. Keep in
# lockstep with the failpoint() call sites (tests assert each name
# fires).
KNOWN_FAILPOINTS = frozenset((
    "engine.dispatch", "engine.fetch", "batch.dispatch",
    "router.shadow", "registry.restore", "registry.warmup",
    "registry.variant", "replica.dispatch", "replica.fetch"))


class InjectedFault(RuntimeError):
    """An error produced by a FaultRule. Carries the failpoint name so
    harnesses can attribute each failed request to the injection that
    caused it (500 semantics at the HTTP surface, like any engine
    error)."""

    status = 500

    def __init__(self, point: str, detail: str):
        super().__init__(f"injected fault at {point}: {detail}")
        self.point = point


@dataclasses.dataclass
class FaultRule:
    """One failpoint behavior. `match` entries are compared as strings
    against the failpoint's ctx (a rule with version=v1 only evaluates
    when ctx['version'] == 'v1')."""

    point: str
    probability: float = 1.0
    mode: str = "call"                # "call" | "request"
    error: Optional[str] = None       # None + latency_ms==0 -> error too
    latency_ms: float = 0.0
    count: Optional[int] = None       # max fires; None = unlimited
    after: int = 0                    # skip first N matching evaluations
    match: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if not self.point:
            raise ValueError("fault rule needs a failpoint name")
        if not 0.0 < self.probability <= 1.0:
            raise ValueError(
                f"fault probability must be in (0, 1], "
                f"got {self.probability}")
        if self.mode not in ("call", "request"):
            raise ValueError(f"fault mode must be call|request, "
                             f"got {self.mode!r}")
        if self.latency_ms < 0:
            raise ValueError(
                f"latency_ms must be >= 0, got {self.latency_ms}")
        if self.count is not None and self.count < 1:
            raise ValueError(f"count must be >= 1, got {self.count}")
        if self.after < 0:
            raise ValueError(f"after must be >= 0, got {self.after}")
        if self.error is None:
            if self.mode == "request":
                # a request-mode rule exists to FAIL poisoned requests
                self.error = "poison request"
            elif self.latency_ms == 0:
                # a rule with no error AND no latency would fire
                # invisibly — surely a mistake; default to an error.
                # Latency-only rules (latency_ms set, error unset)
                # stay non-raising slow-downs.
                self.error = "injected error"

    def describe(self) -> dict:
        return {"point": self.point, "p": self.probability,
                "mode": self.mode, "error": self.error,
                "latency_ms": self.latency_ms, "count": self.count,
                "after": self.after, "match": dict(self.match)}


def parse_spec(spec: str) -> list[FaultRule]:
    """`point:k=v,k=v;point:...` -> FaultRules. Raises ValueError with
    the offending fragment on any malformed piece (a chaos schedule
    must fail loudly at install, never silently inject nothing)."""
    rules = []
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        point, _, body = part.partition(":")
        point = point.strip()
        if point not in KNOWN_FAILPOINTS:
            raise ValueError(
                f"unknown failpoint {point!r} in {part!r}; known: "
                f"{sorted(KNOWN_FAILPOINTS)}")
        kw: dict = {"point": point, "match": {}}
        for item in (body.split(",") if body.strip() else []):
            key, sep, val = item.partition("=")
            key, val = key.strip(), val.strip()
            if not sep or not key or not val:
                raise ValueError(
                    f"bad fault spec item {item!r} in {part!r} "
                    "(want key=value)")
            try:
                if key == "p":
                    kw["probability"] = float(val)
                elif key == "latency_ms":
                    kw["latency_ms"] = float(val)
                elif key in ("count", "after"):
                    kw[key] = int(val)
                elif key == "mode":
                    kw["mode"] = val
                elif key == "error":
                    kw["error"] = val
                else:
                    kw["match"][key] = val
            except ValueError as e:
                raise ValueError(
                    f"bad fault spec value {item!r} in {part!r}: {e}"
                ) from None
        try:
            rules.append(FaultRule(**kw))
        except ValueError as e:
            raise ValueError(f"bad fault rule {part!r}: {e}") from None
    if not rules:
        raise ValueError(f"fault spec {spec!r} contains no rules")
    return rules


def _hash_draw(seed: int, point: str, rid: int) -> float:
    """Deterministic uniform [0,1) from (seed, point, rid): the same
    request gets the same verdict in every dispatch that contains it —
    the stickiness bisection needs (a plain RNG would re-roll on each
    retry and let the culprit slip through a split)."""
    h = hashlib.sha256(f"{seed}:{point}:{rid}".encode()).digest()
    return int.from_bytes(h[:8], "big") / 2.0 ** 64


class FaultInjector:
    """An installed set of FaultRules evaluated at every failpoint
    crossing. Thread-safe; all draws are seeded (call-mode rules from a
    per-rule RNG sequence, request-mode from a content hash), so a
    schedule replays deterministically."""

    def __init__(self, rules: list[FaultRule], seed: int = 0):
        import random

        if not rules:
            raise ValueError("FaultInjector needs at least one rule")
        self.rules = list(rules)
        self.seed = seed
        self._lock = make_lock("faults.injector")
        self._rngs = [random.Random(f"{seed}:{i}")
                      for i in range(len(rules))]
        self._evals = [0] * len(rules)
        self._fires = [0] * len(rules)
        self._poisoned: set[int] = set()    # rids decided poison

    @classmethod
    def from_spec(cls, spec: str, seed: int = 0) -> "FaultInjector":
        return cls(parse_spec(spec), seed=seed)

    def fire(self, point: str, **ctx) -> None:
        """Evaluate every rule bound to `point`. May sleep
        (latency_ms) and/or raise InjectedFault. The latency sleep runs
        OUTSIDE the lock so a slow-fault rule on one thread cannot
        stall every other failpoint crossing."""
        delay = 0.0
        raising: Optional[str] = None
        with self._lock:
            for i, rule in enumerate(self.rules):
                if rule.point != point:
                    continue
                if any(str(ctx.get(k)) != v
                       for k, v in rule.match.items()):
                    continue
                self._evals[i] += 1
                if self._evals[i] <= rule.after:
                    continue
                if rule.count is not None and self._fires[i] >= rule.count:
                    continue
                if rule.mode == "request":
                    rids = ctx.get("rids") or ()
                    poison = [r for r in rids
                              if _hash_draw(self.seed, point, r)
                              < rule.probability]
                    if not poison:
                        continue
                    self._poisoned.update(poison)
                else:
                    if self._rngs[i].random() >= rule.probability:
                        continue
                self._fires[i] += 1
                delay = max(delay, rule.latency_ms / 1e3)
                if rule.error is not None and raising is None:
                    raising = rule.error
        if delay:
            time.sleep(delay)
        if raising is not None:
            raise InjectedFault(point, raising)

    def poisoned(self) -> set:
        """Request ids this injector has (so far) decided are poison —
        the chaos bench's ground truth for 'every culprit was isolated,
        no cohort-mate was misblamed'."""
        with self._lock:
            return set(self._poisoned)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "seed": self.seed,
                "rules": [
                    {**r.describe(), "evaluations": self._evals[i],
                     "fires": self._fires[i]}
                    for i, r in enumerate(self.rules)],
                "poisoned_requests": len(self._poisoned),
            }


# The module-global active injector. None (the default, and the state
# every production process runs in) makes failpoint() a single
# attribute read + None test — the woven failpoints are free when chaos
# is off.
_active: Optional[FaultInjector] = None


def install(injector: FaultInjector) -> FaultInjector:
    """Activate `injector` process-wide. Refuses to stack: two
    schedules silently combined would make neither reproducible."""
    global _active
    if _active is not None:
        raise RuntimeError(
            "a FaultInjector is already installed; uninstall() it first")
    _active = injector
    return injector


def uninstall() -> None:
    global _active
    _active = None


def active() -> Optional[FaultInjector]:
    return _active


def failpoint(point: str, **ctx) -> None:
    """The woven hook: evaluate the active injector's rules at `point`.
    Inert (one None check) when nothing is installed."""
    inj = _active
    if inj is not None:
        inj.fire(point, **ctx)
