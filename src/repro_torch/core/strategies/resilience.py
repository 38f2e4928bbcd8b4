"""Resilience aspect: fault injection + recovery policies for serving.

The ANTAREX position (PAPER.md; also the AOP building-block argument of
arXiv:2203.13431) is that *extra-functional* properties — performance,
precision, power, and here **resilience** — are woven at named join points
rather than entangled with application logic.  `Server.serve_continuous`
exposes the serving join points

    admit          a request enters the pool (admission control + prefill)
    paged_prefill  the direct-to-pool prefill / re-score dispatch
    decode_step    a plain one-token batched decode step
    verify_step    a widened-q speculative verify step
    draft_step     one draft-model proposal step
    cow            copy-on-write splits before a step's pool writes
    rollback       speculative-misprediction page rollback
    retire         a request's pages return to the pool

and consults the woven `FaultInjector` at each of them.  The injector is
deterministic and seedable: a scheduled `FaultSpec` fires on the N-th
visit of its join point (or at a seeded per-visit rate), raising
(`raise` / `pool_exhausted`), poisoning logits (`nan_logits`), or forcing
a request past its SLO (`deadline`).  The server's recovery machinery —
per-request quarantine, structured rejection, speculation degradation,
bounded retry, deadline retirement — is what the injected faults exercise;
with no injector woven, serving is bit-identical to the fault-free path.

`ResilienceAspect` is the LARA-style aspect that binds an injector and the
recovery *policy* (per-request deadline, step watchdog deadline, retry
budget/backoff, speculation patience, pool auditing) into the weave state
(`fault_injector` / `serve_resilience` extras) without the serving loop
ever knowing where the schedule came from.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Iterable, Sequence

import numpy as np

from repro_torch.core.weaver import Aspect, Weaver

JOIN_POINTS = ("admit", "paged_prefill", "decode_step", "verify_step",
               "draft_step", "cow", "rollback", "retire")
# fleet-level join points (the reference's runtime/fleet.ServingFleet, not
# ported yet: ROADMAP Queue 1 item 8b): one routing decision, one replica
# dispatch, one drain check.  Kept separate from JOIN_POINTS so the
# within-replica fault sweep keeps its exact 8-point matrix.
FLEET_JOIN_POINTS = ("route", "replica_loss", "drain")
ALL_JOIN_POINTS = JOIN_POINTS + FLEET_JOIN_POINTS
FAULT_KINDS = ("raise", "nan_logits", "pool_exhausted", "deadline")

# default recovery policy the server falls back to when no ResilienceAspect
# was woven and the ServerConfig leaves the knobs unset
DEFAULT_POLICY: dict[str, Any] = {
    "deadline_s": None,        # per-request SLO (None: no deadline)
    "step_deadline_s": None,   # Watchdog deadline per target step
    "retries": 2,              # bounded retry around transient step faults
    "backoff_s": 0.0,          # base backoff between retries (doubles)
    "spec_patience": None,     # all-reject verify rounds before degrading
    #                            speculation (None: never — a mispredicting
    #                            foreign draft is legal and still makes one
    #                            token of progress per round, so degradation
    #                            is an opt-in latency policy, not a default)
    "pool_audit": False,       # PoolAuditor at retire/rollback barriers
}


class FaultError(RuntimeError):
    """Base class for faults the serving loop isolates per-request."""


class InjectedFault(FaultError):
    """A `raise`-kind injected fault (carries the resolved FaultSpec)."""

    def __init__(self, msg: str, *, spec: "FaultSpec | None" = None):
        super().__init__(msg)
        self.spec = spec


class NonFiniteLogits(FaultError):
    """NaN/Inf logits detected at admission — the victim is rejected."""


@dataclasses.dataclass
class FaultSpec:
    """One scheduled fault: fire `kind` on the `at`-th visit (0-based,
    counting retries) of join point `point`.  `rid` pins the victim
    request; None resolves to the request at the join point (admission)
    or the first request of the current batch.  `repeat` fires the spec
    on `repeat` consecutive visits starting at `at`."""

    point: str
    kind: str
    at: int = 0
    rid: Any = None
    repeat: int = 1

    def __post_init__(self):
        if self.point not in ALL_JOIN_POINTS:
            raise ValueError(f"unknown join point {self.point!r}; "
                             f"one of {ALL_JOIN_POINTS}")
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"one of {FAULT_KINDS}")


class FaultInjector:
    """Deterministic, seedable fault schedule over the serving join points.

    Two modes, composable:
      * scheduled — explicit `FaultSpec`s (or (point, kind[, at[, rid]])
        tuples) fire on exact visit counts;
      * seeded-random — with `rate` > 0, every visit draws from a
        `np.random.default_rng(seed)` stream and fires a random kind from
        `kinds` with probability `rate` (deterministic given the visit
        sequence).

    `fire(point, ...)` is the weave hook the server calls at each join
    point: it raises for `raise` / `pool_exhausted` kinds (the caller's
    recovery path catches them) and *returns* the resolved spec for
    `nan_logits` / `deadline` (the caller applies the poison / SLO
    overrun).  Every fired fault is recorded in `events`.
    """

    def __init__(self, faults: Iterable[FaultSpec | tuple | dict] = (), *,
                 seed: int | None = None, rate: float = 0.0,
                 kinds: Sequence[str] = FAULT_KINDS):
        self._seed = seed
        self.rate = float(rate)
        self.kinds = tuple(kinds)
        for k in self.kinds:
            if k not in FAULT_KINDS:
                raise ValueError(f"unknown fault kind {k!r}")
        self._schedule: list[FaultSpec] = [self._coerce(f) for f in faults]
        self._remaining: list[int] = [s.repeat for s in self._schedule]
        self._rng = np.random.default_rng(seed)
        self.visits: dict[str, int] = {p: 0 for p in ALL_JOIN_POINTS}
        self.events: list[dict[str, Any]] = []

    @staticmethod
    def _coerce(f) -> FaultSpec:
        if isinstance(f, FaultSpec):
            return f
        if isinstance(f, dict):
            return FaultSpec(**f)
        return FaultSpec(*f)

    @classmethod
    def single(cls, point: str, kind: str, *, at: int = 0,
               rid: Any = None) -> "FaultInjector":
        """One fault, once — the bench/test sweep's unit schedule."""
        return cls([FaultSpec(point, kind, at=at, rid=rid)])

    @property
    def armed(self) -> bool:
        """True while any fault can still fire (the server bypasses the
        memo table for armed serves — injected results must never be
        memoized, and memo hits would skip the join points entirely)."""
        return self.rate > 0.0 or any(r > 0 for r in self._remaining)

    def reset(self) -> None:
        """Restore the full schedule and reseed the random stream — the
        same injector replays the same fault sequence."""
        self._remaining = [s.repeat for s in self._schedule]
        self._rng = np.random.default_rng(self._seed)
        self.visits = {p: 0 for p in ALL_JOIN_POINTS}
        self.events = []

    def _match(self, point: str, visit: int) -> FaultSpec | None:
        for i, spec in enumerate(self._schedule):
            if (spec.point == point and self._remaining[i] > 0
                    and spec.at <= visit < spec.at + spec.repeat):
                self._remaining[i] -= 1
                return spec
        return None

    def fire(self, point: str, *, rid: Any = None,
             rids: Sequence[Any] | None = None) -> FaultSpec | None:
        """Visit a join point.  Returns None (no fault), raises
        InjectedFault / PoolExhausted (`raise` / `pool_exhausted` kinds),
        or returns the resolved FaultSpec (`nan_logits` / `deadline`) for
        the caller to apply.  Visits count retries, so a retried step that
        consumed its one-shot fault passes clean on the next visit."""
        from repro_torch.runtime.pages import PoolExhausted

        if point not in ALL_JOIN_POINTS:
            raise ValueError(f"unknown join point {point!r}")
        visit = self.visits[point]
        self.visits[point] = visit + 1
        spec = self._match(point, visit)
        if spec is None and self.rate > 0.0:
            if float(self._rng.random()) < self.rate:
                spec = FaultSpec(point, self.kinds[
                    int(self._rng.integers(len(self.kinds)))], at=visit)
        if spec is None:
            return None
        victim = spec.rid
        if victim is None:
            victim = rid if rid is not None else (
                rids[0] if rids else None)
        fired = FaultSpec(point=point, kind=spec.kind, at=visit, rid=victim)
        self.events.append({"point": point, "kind": spec.kind,
                            "visit": visit, "rid": victim})
        if spec.kind == "raise":
            raise InjectedFault(
                f"injected fault at {point} (visit {visit})", spec=fired)
        if spec.kind == "pool_exhausted":
            raise PoolExhausted(
                f"injected pool exhaustion at {point} (visit {visit})")
        return fired

    def stats(self) -> dict[str, Any]:
        by_point: dict[str, int] = {}
        by_kind: dict[str, int] = {}
        for ev in self.events:
            by_point[ev["point"]] = by_point.get(ev["point"], 0) + 1
            by_kind[ev["kind"]] = by_kind.get(ev["kind"], 0) + 1
        return {"fired": len(self.events), "by_point": by_point,
                "by_kind": by_kind, "visits": dict(self.visits),
                "armed": self.armed}


class ResilienceAspect(Aspect):
    """Weave fault tolerance into continuous serving.

    Binds a `FaultInjector` (optional — production serves weave only the
    policy) and the recovery policy knobs into the weave state:

      * `fault_injector`   consulted by the serving join points;
      * `serve_resilience` {deadline_s, step_deadline_s, retries,
                            backoff_s, spec_patience, pool_audit} — the
                            degradation/deadline policy the server applies
                            (explicit ServerConfig fields still win).

    The analysis pass selects the attention joinpoints (the page pool
    hosts their K/V — resilience guards exactly the state those blocks
    own), mirroring how the cache-dtype and kernel aspects account their
    weaving metrics.
    """

    name = "Resilience"

    def __init__(self, injector: FaultInjector | None = None, *,
                 deadline_s: float | None = None,
                 step_deadline_s: float | None = None,
                 retries: int = 2, backoff_s: float = 0.0,
                 spec_patience: int | None = 3, pool_audit: bool = False):
        self.injector = injector
        self.policy = {
            "deadline_s": deadline_s,
            "step_deadline_s": step_deadline_s,
            "retries": int(retries),
            "backoff_s": float(backoff_s),
            "spec_patience": None if spec_patience is None else int(spec_patience),
            "pool_audit": bool(pool_audit),
        }

    def apply(self, weaver: Weaver) -> None:
        for jp in weaver.select("*", kind="attention"):
            jp.attr("kind")
        if self.injector is not None:
            weaver.set_extra("fault_injector", self.injector)
        weaver.set_extra("serve_resilience", dict(self.policy))


# default fleet recovery policy (the reference's runtime/fleet.ServingFleet
# falls back to this when no FleetResilienceAspect was woven and the
# constructor leaves the knobs unset; the fleet is ROADMAP Queue 1 item 8b)
DEFAULT_FLEET_POLICY: dict[str, Any] = {
    "retries": 2,              # re-dispatches per request after replica loss
    "backoff_s": 0.0,          # base backoff before a re-dispatch (doubles)
    "deadline_s": None,        # per-request fleet SLO (None: no deadline)
    "affinity": True,          # prefix-affinity routing (else least-loaded)
    "wave_size": 4,            # requests routed to one replica per round
    "dead_after_rounds": 1.5,  # missed-beat rounds before a replica is dead
    "straggler_factor": 2.0,   # HeartbeatMonitor straggler threshold
    "straggler_patience": 3,   # consecutive slow rounds before flagging
}


class FleetResilienceAspect(Aspect):
    """Weave the fleet-level serving policy (the reference's
    `runtime/fleet.ServingFleet`).

    Copied with the rest of this module, but nothing in this package
    reads the `fleet_injector` / `fleet_resilience` extras yet: the serving
    fleet is ported with ROADMAP Queue 1 item 8b, and until then weaving
    this aspect only records the policy.

    The same AOP argument one level up: replica placement, prefix-affinity
    routing, replica-loss re-dispatch and graceful drain are extra-
    functional concerns of the *fleet*, woven as extras rather than
    hard-coded into the router:

      * `fleet_injector`    consulted at the fleet join points
                            (`route`, `replica_loss`, `drain`);
      * `fleet_resilience`  {retries, backoff_s, deadline_s, affinity,
                            wave_size, dead_after_rounds, straggler_factor,
                            straggler_patience} — explicit ServingFleet
                            constructor arguments still win.

    The analysis pass selects the attention join points exactly like
    `ResilienceAspect`: the fleet's unit of placement is a replica whose
    page pool hosts attention K/V — the state replica loss puts at risk.
    """

    name = "FleetResilience"

    def __init__(self, injector: FaultInjector | None = None, *,
                 retries: int = 2, backoff_s: float = 0.0,
                 deadline_s: float | None = None, affinity: bool = True,
                 wave_size: int = 4, dead_after_rounds: float = 1.5,
                 straggler_factor: float = 2.0, straggler_patience: int = 3):
        self.injector = injector
        self.policy = {
            "retries": int(retries),
            "backoff_s": float(backoff_s),
            "deadline_s": deadline_s,
            "affinity": bool(affinity),
            "wave_size": int(wave_size),
            "dead_after_rounds": float(dead_after_rounds),
            "straggler_factor": float(straggler_factor),
            "straggler_patience": int(straggler_patience),
        }

    def apply(self, weaver: Weaver) -> None:
        for jp in weaver.select("*", kind="attention"):
            jp.attr("kind")
        if self.injector is not None:
            weaver.set_extra("fleet_injector", self.injector)
        weaver.set_extra("fleet_resilience", dict(self.policy))
