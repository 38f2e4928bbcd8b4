"""A modeled power curve for the step sensors and the power capper.

Power is modeled, not measured: per-card power = idle + dynamic *
utilization * f^3 (the DVFS cube law), with performance scaling ~f for
compute-bound phases and ~1 for memory / IO-slack phases — the slack the
paper exploits.  `peak_flops` is an H100's published dense bf16 rate and
`idle_watts + dynamic_watts` its 700 W board limit; the split between the
two is an assumption of the model, not a reading of any card.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class RAPLModel:
    idle_watts: float = 100.0
    dynamic_watts: float = 600.0  # at util=1, f=1
    peak_flops: float = 989e12  # bf16 dense, one H100 SXM
    f_min: float = 0.5
    f_max: float = 1.0

    def power(self, utilization: float, freq: float = 1.0) -> float:
        utilization = min(max(utilization, 0.0), 1.0)
        freq = min(max(freq, self.f_min), self.f_max)
        return self.idle_watts + self.dynamic_watts * utilization * freq**3

    def perf_scale(self, freq: float, compute_bound_frac: float = 1.0) -> float:
        """Relative performance at frequency f: compute-bound scales with f,
        memory/IO-bound phases don't (the application-aware opportunity)."""
        freq = min(max(freq, self.f_min), self.f_max)
        return compute_bound_frac * freq + (1.0 - compute_bound_frac)

    def energy(self, utilization: float, freq: float, seconds: float) -> float:
        return self.power(utilization, freq) * seconds
