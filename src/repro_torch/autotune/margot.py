"""mARGOt dynamic autotuner (paper §2.5, Fig. 10) — MAPE-K over operating
points.

Knowledge: `OperatingPoint`s (knob values -> expected metric mean/std),
derived at deploy time (DSE) or refined at runtime.  Goals are LE/GE
constraints on metrics; a `State` is a constrained optimization problem
(maximize/minimize one metric subject to goals) that can be switched at
runtime.  Adaptation is both:

  reactive  — an error coefficient per metric (observed / expected on the
              current op point) rescales *all* expectations, so the tuner
              reacts to context drift (paper: "runtime observations as
              feedback information");
  proactive — optional input-feature clustering: per-feature knowledge
              bases selected by the nearest feature vector (paper: "features
              of the actual input to adapt in a more proactive fashion").
"""

from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import Any, Callable, Iterable

LE, GE = "le", "ge"


@dataclasses.dataclass(frozen=True)
class OperatingPoint:
    knobs: dict[str, Any]
    metrics: dict[str, tuple[float, float]]  # name -> (mean, std)

    def mean(self, metric: str) -> float:
        return self.metrics[metric][0]

    def key(self) -> tuple:
        return tuple(sorted(self.knobs.items()))


@dataclasses.dataclass(frozen=True)
class Goal:
    name: str
    metric: str
    op: str  # le | ge
    value: float
    confidence: float = 0.0  # sigmas of margin

    def satisfied(self, mean: float, std: float = 0.0) -> bool:
        margin = self.confidence * std
        if self.op == LE:
            return mean + margin <= self.value
        return mean - margin >= self.value

    def violation(self, mean: float, std: float = 0.0) -> float:
        margin = self.confidence * std
        if self.op == LE:
            return max(0.0, mean + margin - self.value)
        return max(0.0, self.value - (mean - margin))


@dataclasses.dataclass
class State:
    name: str
    objective_metric: str
    maximize: bool = True
    constraints: list[Goal] = dataclasses.field(default_factory=list)

    def subject_to(self, goal: Goal) -> "State":
        self.constraints.append(goal)
        return self


class KnowledgeBase:
    def __init__(self, ops: Iterable[OperatingPoint] = ()):
        self.ops: list[OperatingPoint] = list(ops)

    def add(self, op: OperatingPoint) -> None:
        self.ops = [o for o in self.ops if o.key() != op.key()] + [op]

    def __len__(self):
        return len(self.ops)

    @staticmethod
    def from_dse(results: list[dict], knob_names: list[str],
                 metric_names: list[str]) -> "KnowledgeBase":
        ops = []
        for row in results:
            knobs = {k: row["knobs"][k] for k in knob_names}
            metrics = {m: tuple(row["metrics"][m]) for m in metric_names}
            ops.append(OperatingPoint(knobs, metrics))
        return KnowledgeBase(ops)


class Margot:
    """The MAPE-K loop.  monitor: observe(); analyze+plan: inside update();
    execute: the caller applies the returned knob configuration."""

    def __init__(self, kb: KnowledgeBase, states: list[State],
                 active_state: str | None = None, *, window: int = 32,
                 feature_kbs: dict[tuple, KnowledgeBase] | None = None):
        self.kb = kb
        self.states = {s.name: s for s in states}
        self.active = active_state or next(iter(self.states))
        self.window = window
        self._obs: dict[str, deque] = {}
        self._error_coef: dict[str, float] = {}
        self.current: OperatingPoint | None = None
        self.feature_kbs = feature_kbs or {}
        self.switches = 0

    # -- Monitor ---------------------------------------------------------------

    def observe(self, metric: str, value: float) -> None:
        """Record one observation of `metric`.

        The per-metric history is a sliding window (`deque(maxlen=window)`),
        not an unbounded list: a long-running managed application — e.g. a
        `serve_stream` session observing every wave — stays O(window)
        memory, and the reactive error coefficient in `_analyze` tracks
        *recent* load instead of averaging the whole session's history.
        Non-finite values are dropped (a poisoned observation would wedge
        the error coefficient at NaN for a full window)."""
        value = float(value)
        if not math.isfinite(value):
            return
        window = self._obs.get(metric)
        if window is None or window.maxlen != self.window:
            # (re)build on first use or after a live `self.window` resize,
            # keeping the most recent tail of what was already observed
            window = deque(window or (), maxlen=self.window)
            self._obs[metric] = window
        window.append(value)

    # -- Analyze: reactive error coefficients -------------------------------------

    def _analyze(self) -> None:
        if self.current is None:
            return
        for metric, values in self._obs.items():
            if metric not in self.current.metrics or not values:
                continue
            expected = self.current.mean(metric)
            observed = sum(values) / len(values)
            if expected > 1e-12 and observed > 1e-12:
                self._error_coef[metric] = observed / expected

    def adjusted(self, op: OperatingPoint, metric: str) -> tuple[float, float]:
        mean, std = op.metrics[metric]
        coef = self._error_coef.get(metric, 1.0)
        return mean * coef, std * coef

    # -- Plan: constrained selection ------------------------------------------------

    def _select_kb(self, features: tuple | None) -> KnowledgeBase:
        if features is None or not self.feature_kbs:
            return self.kb
        best = min(
            self.feature_kbs,
            key=lambda f: sum((a - b) ** 2 for a, b in zip(f, features)),
        )
        return self.feature_kbs[best]

    def update(self, features: tuple | None = None) -> OperatingPoint:
        self._analyze()
        state = self.states[self.active]
        kb = self._select_kb(features)
        valid: list[OperatingPoint] = []
        for op in kb.ops:
            ok = all(
                g.satisfied(*self.adjusted(op, g.metric)) for g in state.constraints
                if g.metric in op.metrics
            )
            if ok:
                valid.append(op)
        if valid:
            sign = 1.0 if state.maximize else -1.0
            best = max(valid, key=lambda op: sign * self.adjusted(op, state.objective_metric)[0])
        else:  # relax: minimize total violation (paper: requirements may be unsatisfiable)
            best = min(
                kb.ops,
                key=lambda op: sum(
                    g.violation(*self.adjusted(op, g.metric))
                    for g in state.constraints
                    if g.metric in op.metrics
                ),
            )
        if self.current is None or best.key() != self.current.key():
            self.switches += 1
        self.current = best
        return best

    def switch_state(self, name: str) -> None:
        if name not in self.states:
            raise KeyError(name)
        self.active = name
