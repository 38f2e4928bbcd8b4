"""Precision-tuning aspects (paper §2.2).

`ChangePrecision` is Fig. 2: change the numeric type of everything inside a
selected region.  `CreateLowPrecVersion` is Fig. 4 (clone + change types of
the clone — here: a named weave-state variant).  `MixedPrecisionVersions`
is Fig. 3 (HalfPrecisionOpenCL): enumerate per-region precision-mix
combinations, filtered, capped at max_versions, each becoming a selectable
variant for runtime evaluation.
"""

from __future__ import annotations

import itertools
from typing import Callable, Sequence

from repro_torch.core.knob import Knob
from repro_torch.core.weaver import Aspect, Weaver
from repro_torch.nn.dtypes import DTypePolicy


class ChangePrecision(Aspect):
    name = "ChangePrecision"

    def __init__(self, pattern: str, policy: str | DTypePolicy, *, kind: str | None = None):
        self.pattern = pattern
        self.policy = policy
        self.jp_kind = kind

    def apply(self, weaver: Weaver) -> None:
        policy = (DTypePolicy.make(self.policy)
                  if isinstance(self.policy, str) else self.policy)
        if policy.cache_dtype is not None or self.jp_kind == "cache":
            # the "cache" kind retypes KV-cache *storage*, not compute:
            # the attention joinpoints are selected for analysis (the pool
            # hosts their K/V; their compute policy stays untouched) and
            # the dtype is woven as the "flash_cache_dtype" extra the
            # serving runtime and the tuned kernels resolve
            for jp in weaver.select(self.pattern, kind="attention"):
                jp.attr("kind")
            weaver.set_extra("flash_cache_dtype", policy.cache_dtype)
            return
        sel = weaver.select(self.pattern, kind=self.jp_kind)
        for jp in sel:
            # analysis: skip norm joinpoints — they pin fp32 params (the
            # paper's "library functions related to the type" caveat).
            if jp.attr("kind", jp.kind) == "norm":
                continue
            weaver.def_policy(jp, self.policy)


class CreateLowPrecVersion(Aspect):
    """Clone the program's weave under `suffix` with a lower-precision policy."""

    name = "CreateFloatVersion"

    def __init__(self, pattern: str = "*", policy: str = "half", suffix: str = "_f"):
        self.pattern, self.policy, self.suffix = pattern, policy, suffix

    def apply(self, weaver: Weaver) -> None:
        n = len(weaver.select(self.pattern).all())
        if n == 0:
            raise ValueError(f"no joinpoints match {self.pattern!r}")
        pattern, policy = self.pattern, self.policy

        def mutate(state):
            state.policies.override(pattern, policy)

        weaver.add_variant(self.suffix.strip("_") or "lowprec", mutate)


class MixedPrecisionVersions(Aspect):
    """Generate up to max_versions precision-mix variants over N regions."""

    name = "HalfPrecisionVersions"

    def __init__(
        self,
        patterns: Sequence[str],
        policies: Sequence[str] = ("float", "half"),
        *,
        max_versions: int | None = None,
        combination_filter: Callable[[tuple[str, ...]], bool] | None = None,
        knob_name: str = "precision_mix",
    ):
        self.patterns = list(patterns)
        self.policies = list(policies)
        self.max_versions = max_versions
        self.combination_filter = combination_filter
        self.knob_name = knob_name

    def apply(self, weaver: Weaver) -> None:
        for p in self.patterns:  # analysis pass (counted as selects/attrs)
            for jp in weaver.select(p):
                jp.attr("kind")
        names = []
        count = 0
        for combo in itertools.product(self.policies, repeat=len(self.patterns)):
            if self.combination_filter and not self.combination_filter(combo):
                continue
            if self.max_versions is not None and count >= self.max_versions:
                break
            vname = "mix_" + "_".join(c[0] for c in combo)  # e.g. mix_f_h_h

            def mutate(state, combo=combo):
                for pattern, policy in zip(self.patterns, combo):
                    pol = (DTypePolicy.make(policy)
                           if isinstance(policy, str) else policy)
                    if pol.cache_dtype is not None:
                        # cache policies retype pool storage, not compute
                        state.extra["flash_cache_dtype"] = pol.cache_dtype
                    else:
                        state.policies.override(pattern, policy)

            weaver.add_variant(vname, mutate)
            names.append(vname)
            count += 1
        weaver.add_knob(
            Knob(self.knob_name, tuple(["__default__"] + names), "__default__")
        )
        self.generated = names
