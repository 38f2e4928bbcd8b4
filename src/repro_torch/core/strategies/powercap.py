"""Power-capping aspect (paper §2.7): attach a task priority and register
the step with the PowerCapper runtime, which allocates the node power budget
across tasks by priority (application-aware, unlike plain RAPL)."""

from __future__ import annotations

from repro_torch.core.weaver import Aspect, Weaver


class PowerPriority(Aspect):
    name = "PowerPriority"

    def __init__(self, priority: int, capper=None):
        self.priority = priority
        self.capper = capper

    def apply(self, weaver: Weaver) -> None:
        weaver.set_priority(self.priority)
        if self.capper is not None:
            from repro_torch.monitor.sensors import powercap_wrapper

            weaver.wrap_step(powercap_wrapper(self.capper, self.priority))
