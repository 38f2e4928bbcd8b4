"""QoS aspect: weave the serving operating-point control plane.

The same AOP argument `ResilienceAspect` makes for fault tolerance applies
to QoS (the ANTAREX position — PAPER.md §3–4): which batch size, prefill
chunk, draft length and DVFS point a serve runs at is an *extra-functional*
property, woven as weave-state extras rather than hard-coded into the
event loop:

  * `serve_qos`      the policy dict `runtime/qos.QoSGovernor` is built
                     from (knob grids, SLOs, objective, power cap) — a
                     fresh governor per serve, the common case;
  * `qos_governor`   a pre-built QoSGovernor instance, when state (the
                     energy ledger, the capper's task table, Margot's
                     error coefficients) must persist across serves —
                     e.g. a fleet replica serving a request stream.

Explicit `serve_stream(qos=...)` / SLO arguments still win, and `qos=False`
forces the plane off regardless of what was woven.  Composes with
`ResilienceAspect` (fault isolation wraps every wave the governor paces)
and with the fleet aspects.
"""

from __future__ import annotations

from typing import Any

from repro_torch.core.weaver import Aspect, Weaver


class QoSAspect(Aspect):
    name = "QoS"

    def __init__(self, policy: dict[str, Any] | None = None, *,
                 governor=None, **knobs: Any):
        self.policy = {**(policy or {}), **knobs}
        self.governor = governor

    def apply(self, weaver: Weaver) -> None:
        # the analysis pass selects the attention join points, like the
        # resilience/cache-dtype aspects: the operating point paces the
        # waves that read/write exactly the state those blocks own
        for jp in weaver.select("*", kind="attention"):
            jp.attr("kind")
        if self.governor is not None:
            weaver.set_extra("qos_governor", self.governor)
        weaver.set_extra("serve_qos", dict(self.policy))
