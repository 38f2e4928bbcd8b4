"""The Weaver — Clava's role in the ANTAREX tool flow, for PyTorch programs.

Aspects call `select(...)` to query joinpoints and action methods
(`def_policy`, `set_impl`, `set_rule`, `set_extra`, `add_tap`, `add_knob`,
`add_variant`, `wrap_step`) to transform the weave state.  The weaver
records the paper's static/dynamic weaving metrics (Tables 1–2): selects
issued, joinpoint attributes analysed, actions taken, and inserts
(actions that add code to the woven program rather than only analysing).

The output is a `WovenProgram`: the untouched functional Program plus the
final WeaveState, named variants (for libVC multi-versioning), the knob
space (for mARGOt) and the metrics report.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

from repro_torch.core.joinpoint import JoinPoint, Selector, build_joinpoints
from repro_torch.core.knob import Knob, KnobSpace
from repro_torch.core.program import Program, WeaveState
from repro_torch.nn.dtypes import DTypePolicy


@dataclasses.dataclass
class AspectMetrics:
    name: str
    selects: int = 0
    attributes: int = 0
    actions: int = 0
    inserts: int = 0


@dataclasses.dataclass
class WeaveReport:
    per_aspect: list[AspectMetrics] = dataclasses.field(default_factory=list)

    def totals(self) -> AspectMetrics:
        t = AspectMetrics("TOTAL")
        for m in self.per_aspect:
            t.selects += m.selects
            t.attributes += m.attributes
            t.actions += m.actions
            t.inserts += m.inserts
        return t

    def table(self) -> str:
        rows = [f"{'Aspect':28s} {'Selects':>8s} {'Attrs':>8s} {'Actions':>8s} {'Inserts':>8s}"]
        for m in self.per_aspect + [self.totals()]:
            rows.append(
                f"{m.name:28s} {m.selects:8d} {m.attributes:8d} {m.actions:8d} {m.inserts:8d}"
            )
        return "\n".join(rows)


@dataclasses.dataclass
class WovenProgram:
    program: Program
    state: WeaveState
    variants: dict[str, WeaveState]
    knobs: KnobSpace
    report: WeaveReport

    def variant_state(self, name: str | None) -> WeaveState:
        if name is None or name == "__default__":
            return self.state
        return self.variants[name]


class Weaver:
    def __init__(self, program: Program):
        self.program = program
        self.state = WeaveState()
        self.variants: dict[str, WeaveState] = {}
        self.knobs = KnobSpace()
        self.report = WeaveReport()
        self._joinpoints = build_joinpoints(program.model)
        self._attr_counter = [0]
        for jp in self._joinpoints:
            jp._access_counter = self._attr_counter
        self._current: AspectMetrics | None = None

    # -- select ------------------------------------------------------------------

    def select(self, pattern: str | None = None, *, kind: str | None = None) -> Selector:
        if self._current is not None:
            self._current.selects += 1
        sel = Selector(self._joinpoints, self._count_select)
        if kind is not None:
            sel = sel.kind(kind)
        if pattern is not None:
            sel = sel.path(pattern)
        return sel

    def _count_select(self, n: int) -> None:
        if self._current is not None:
            self._current.selects += n

    # -- actions -----------------------------------------------------------------

    def _action(self, inserts: int = 0) -> None:
        if self._current is not None:
            self._current.actions += 1
            self._current.inserts += inserts

    def def_policy(self, target: "JoinPoint | str", policy: DTypePolicy | str) -> None:
        pattern = target.path + "*" if isinstance(target, JoinPoint) else target
        self.state.policies.override(pattern, policy)
        self._action()

    def set_impl(self, target: "JoinPoint | str", op_kind: str, impl: str) -> None:
        pattern = target.path + "*" if isinstance(target, JoinPoint) else target
        self.state.impls.append((pattern, op_kind, impl))
        self._action(inserts=1)

    def set_rule(self, logical_axis: str, mesh_axes: Any) -> None:
        self.state.rules[logical_axis] = mesh_axes
        self._action()

    def set_extra(self, key: str, value: Any) -> None:
        self.state.extra[key] = value
        self._action()

    def add_tap(self, pattern: str) -> None:
        self.state.taps.append(pattern)
        self._action(inserts=1)

    def add_knob(self, knob: Knob) -> None:
        self.knobs.add(knob)
        self._action(inserts=1)

    def wrap_step(self, wrapper: Callable) -> None:
        """Host-level instrumentation around the step (timers, sensors...)."""
        self.state.step_wrappers.append(wrapper)
        self._action(inserts=1)

    def set_priority(self, priority: int) -> None:
        self.state.priority = priority
        self._action()

    def add_variant(self, name: str, mutate: Callable[[WeaveState], None]) -> None:
        """Clone the current weave state, apply `mutate` — the function-clone
        + type-change idiom (CreateFloatVersion) at weave-state granularity."""
        st = self.state.copy()
        mutate(st)
        self.variants[name] = st
        self._action(inserts=1)

    # -- aspect application --------------------------------------------------------

    def apply(self, aspect: "Aspect") -> None:
        metrics = AspectMetrics(aspect.name)
        self._current = metrics
        before = self._attr_counter[0]
        aspect.apply(self)
        metrics.attributes = self._attr_counter[0] - before
        self.report.per_aspect.append(metrics)
        self._current = None

    def weave(self, aspects: list["Aspect"]) -> WovenProgram:
        for a in aspects:
            self.apply(a)
        return WovenProgram(
            program=self.program,
            state=self.state,
            variants=self.variants,
            knobs=self.knobs,
            report=self.report,
        )


class Aspect:
    """Base class for ANTAREX aspects (LARA aspectdef analogue)."""

    name = "aspect"

    def apply(self, weaver: Weaver) -> None:
        raise NotImplementedError


def weave(program: Program, aspects: list[Aspect]) -> WovenProgram:
    return Weaver(program).weave(aspects)
