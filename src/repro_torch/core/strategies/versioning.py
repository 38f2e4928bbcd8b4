"""Code-versioning aspects (paper §2.3, Figs. 5–7).

`Multiversion` weaves a runtime switch between the default weave and named
variants, keyed by an autotuner knob — the paper's generated C `switch`
(Fig. 6) becomes a libVC dispatcher over step closures built per variant, with
per-version timing (the paper's Timer.time on both calls) provided by the
monitoring wrapper.

`SpecializeCall` is SimpleLibVC (Fig. 7): build a specialized version with
runtime-discovered constants baked into its weave state (+ compile
options), and replace the call.
"""

from __future__ import annotations

from typing import Any, Mapping, Sequence

from repro_torch.core.knob import Knob
from repro_torch.core.weaver import Aspect, Weaver


class Multiversion(Aspect):
    name = "Multiversion"

    def __init__(self, knob_name: str, variants: Sequence[str] | None = None,
                 *, time_versions: bool = True):
        self.knob_name = knob_name
        self.variants = variants
        self.time_versions = time_versions

    def apply(self, weaver: Weaver) -> None:
        # identify the step call joinpoint (the paper identifies the call by
        # name and type signature)
        steps = weaver.select(kind="step").all()
        if not steps:
            raise ValueError("program exposes no step joinpoints")
        names = list(self.variants if self.variants is not None else weaver.variants)
        values = tuple(["__default__"] + [n for n in names if n != "__default__"])
        weaver.add_knob(Knob(self.knob_name, values, "__default__"))
        if self.time_versions:
            from repro_torch.monitor.sensors import timing_wrapper

            weaver.wrap_step(timing_wrapper(label_from_knob=self.knob_name))


class SpecializeCall(Aspect):
    """Bake runtime constants into a dedicated variant (libVC specialize)."""

    name = "SimpleLibVC"

    def __init__(self, version_name: str, constants: Mapping[str, Any],
                 compile_options: Mapping[str, Any] | None = None):
        self.version_name = version_name
        self.constants = dict(constants)
        self.compile_options = dict(compile_options or {})

    def apply(self, weaver: Weaver) -> None:
        consts, opts = self.constants, self.compile_options

        def mutate(state):
            for k, v in consts.items():
                state.extra[k] = v
            state.extra.setdefault("compile_options", {}).update(opts)

        weaver.add_variant(self.version_name, mutate)
