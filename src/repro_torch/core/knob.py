"""Software knobs — the k_1..k_n of the paper's parametric-function view
(o = f(i, k_1, ..., k_n)), exposed by aspects and tuned by mARGOt.

Knobs are either *static* (change the compiled program: precision policy,
kernel impl, remat, sharding layout — dispatched through libVC variants) or
*dynamic* (plain runtime values: capacity factor used at trace time still
counts as static; request batch size etc. are dynamic).
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Iterable, Sequence


@dataclasses.dataclass(frozen=True)
class Knob:
    name: str
    values: tuple[Any, ...]
    default: Any = None
    static: bool = True  # requires recompilation (libVC variant switch)

    def __post_init__(self):
        if self.default is None:
            object.__setattr__(self, "default", self.values[0])
        if self.default not in self.values:
            raise ValueError(f"default {self.default!r} not in values for {self.name}")


class KnobSpace:
    def __init__(self, knobs: Iterable[Knob] = ()):
        self._knobs: dict[str, Knob] = {}
        for k in knobs:
            self.add(k)

    def add(self, knob: Knob) -> None:
        self._knobs[knob.name] = knob

    def __contains__(self, name: str) -> bool:
        return name in self._knobs

    def __getitem__(self, name: str) -> Knob:
        return self._knobs[name]

    def __iter__(self):
        return iter(self._knobs.values())

    def __len__(self):
        return len(self._knobs)

    def names(self) -> list[str]:
        return list(self._knobs)

    def defaults(self) -> dict[str, Any]:
        return {k.name: k.default for k in self}

    def grid(self, subset: Sequence[str] | None = None) -> list[dict[str, Any]]:
        """Full factorial over (a subset of) knobs; other knobs at default."""
        names = list(subset) if subset is not None else self.names()
        axes = [self._knobs[n].values for n in names]
        out = []
        for combo in itertools.product(*axes):
            point = self.defaults()
            point.update(dict(zip(names, combo)))
            out.append(point)
        return out

    def neighbors(self, point: dict[str, Any]) -> list[dict[str, Any]]:
        """One-knob-changed neighbourhood (hill-climbing moves)."""
        out = []
        for k in self:
            for v in k.values:
                if v != point.get(k.name, k.default):
                    p = dict(point)
                    p[k.name] = v
                    out.append(p)
        return out

    def validate(self, point: dict[str, Any]) -> None:
        for name, value in point.items():
            if name not in self._knobs:
                raise KeyError(f"unknown knob {name!r}")
            if value not in self._knobs[name].values:
                raise ValueError(f"value {value!r} invalid for knob {name!r}")
