"""libVC (paper §2.3, [14]): dynamic generation, versioning and dispatch
of multiple compiled versions of the same compute kernel/step.

A `Version` = (variant name -> factory) built once and cached by variant
name; PyTorch runs eagerly, so a factory returns a plain closure over the
variant's weave state.  The dispatcher switches versions at call time from
a knob value — the woven replacement for the paper's generated C switch
(Fig. 6) — with no rebuild on the hot path.  Error strategies mirror libVC:
"exit" raises, "fallback" silently uses the default version.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable


@dataclasses.dataclass
class CompiledVersion:
    name: str
    fn: Callable
    compile_seconds: float
    meta: dict = dataclasses.field(default_factory=dict)


class LibVC:
    def __init__(
        self,
        factory: Callable[[str], Callable],
        *,
        default: str = "__default__",
        error_strategy: str = "exit",  # exit | fallback
        log: Callable[[str], None] | None = None,
    ):
        """factory(variant_name) -> ready-to-call (already compiled) callable,
        or a callable to be wrapped lazily."""
        self._factory = factory
        self.default = default
        self.error_strategy = error_strategy
        self._log = log or (lambda msg: None)
        self.versions: dict[str, CompiledVersion] = {}
        self.dispatch_counts: dict[str, int] = {}

    # -- compilation --------------------------------------------------------------

    def compile(self, name: str) -> CompiledVersion:
        if name in self.versions:
            return self.versions[name]
        t0 = time.perf_counter()
        try:
            fn = self._factory(name)
        except Exception as e:
            self._log(f"libvc: compile failed for {name!r}: {e}")
            if self.error_strategy == "fallback" and name != self.default:
                return self.compile(self.default)
            raise
        dt = time.perf_counter() - t0
        cv = CompiledVersion(name, fn, dt)
        self.versions[name] = cv
        self._log(f"libvc: compiled {name!r} in {dt:.2f}s")
        return cv

    def compile_all(self, names) -> None:
        for n in names:
            self.compile(n)

    # -- dispatch --------------------------------------------------------------------

    def __call__(self, version: str | None, *args, **kw):
        name = version or self.default
        if name not in self.versions:
            cv = self.compile(name)
        else:
            cv = self.versions[name]
        self.dispatch_counts[cv.name] = self.dispatch_counts.get(cv.name, 0) + 1
        return cv.fn(*args, **kw)

    def get(self, version: str | None) -> Callable:
        return self.compile(version or self.default).fn

    def stats(self) -> dict:
        return {
            "versions": {n: v.compile_seconds for n, v in self.versions.items()},
            "dispatch_counts": dict(self.dispatch_counts),
        }
