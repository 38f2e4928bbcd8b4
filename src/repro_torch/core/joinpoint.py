"""Joinpoint model — the PyTorch analogue of Clava's C/C++ AST joinpoints.

A `Program` (core/program.py) exposes a tree of joinpoints: one per module
in the model tree plus synthetic program-level points (the step functions).
Selectors (LARA `select`) query them; aspects (LARA `apply`) act on them
through the Weaver, which records analysis/transformation metrics exactly in
the spirit of the paper's Tables 1–2 (selects, attributes, actions,
inserts).
"""

from __future__ import annotations

import dataclasses
import fnmatch
from typing import Any, Callable, Iterable

from repro_torch.nn.module import Module


@dataclasses.dataclass
class JoinPoint:
    path: str  # e.g. "yi_6b/blocks0/block/attn"
    kind: str  # module kind: attention | mlp | moe | norm | ... | step | model
    module: Module | None = None
    _attrs: dict[str, Any] = dataclasses.field(default_factory=dict)
    _access_counter: list[int] | None = None  # shared counter from the weaver

    def attr(self, name: str, default: Any = None) -> Any:
        """Attribute access (counted — the paper's 'Attributes' metric)."""
        if self._access_counter is not None:
            self._access_counter[0] += 1
        return self._attrs.get(name, default)

    def attrs(self) -> dict[str, Any]:
        if self._access_counter is not None:
            self._access_counter[0] += len(self._attrs)
        return dict(self._attrs)

    @property
    def name(self) -> str:
        return self.path.rsplit("/", 1)[-1]

    def matches(self, pattern: str) -> bool:
        return fnmatch.fnmatch(self.path, pattern) or fnmatch.fnmatch(
            self.name, pattern
        )

    def __repr__(self):
        return f"JoinPoint({self.path!r}, kind={self.kind!r})"


def build_joinpoints(model: Module, step_kinds: Iterable[str] = ("train_step", "serve_step")) -> list[JoinPoint]:
    jps: list[JoinPoint] = []
    for path, mod in model.walk():
        jps.append(JoinPoint(path=path, kind=mod.kind, module=mod, _attrs=mod.attrs()))
    root = model.name
    for sk in step_kinds:
        jps.append(JoinPoint(path=f"{root}/{sk}", kind="step", _attrs={"step": sk}))
    return jps


class Selector:
    """LARA-style `select`: filter joinpoints by kind / path pattern / predicate.

    Chainable:  sel.kind("attention").where(lambda jp: jp.attr("kv_heads") < 4)
    Every evaluation is counted by the weaver ("Selects" in Table 2).
    """

    def __init__(self, joinpoints: list[JoinPoint], on_select: Callable[[int], None] | None = None):
        self._jps = joinpoints
        self._on_select = on_select or (lambda n: None)

    def _derive(self, jps: list[JoinPoint]) -> "Selector":
        self._on_select(1)
        return Selector(jps, self._on_select)

    def all(self) -> list[JoinPoint]:
        return list(self._jps)

    def kind(self, kind: str) -> "Selector":
        return self._derive([j for j in self._jps if j.kind == kind])

    def path(self, pattern: str) -> "Selector":
        return self._derive([j for j in self._jps if j.matches(pattern)])

    def where(self, pred: Callable[[JoinPoint], bool]) -> "Selector":
        return self._derive([j for j in self._jps if pred(j)])

    def __iter__(self):
        return iter(self._jps)

    def __len__(self):
        return len(self._jps)
