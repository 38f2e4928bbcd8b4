"""PowerCapper (paper §2.7): application-aware power capping with per-task
priorities.

Unlike RAPL (application-agnostic, uniform throttling), the capper allocates
the node budget by priority: when over budget it throttles the *lowest*
priority tasks first; when under budget it restores the *highest* first.
A deadband avoids oscillation.  `agnostic=True` reproduces the RAPL
baseline (uniform scaling) for the comparison experiment.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading

from repro_torch.power.rapl import RAPLModel


@dataclasses.dataclass
class _Task:
    task_id: int
    name: str
    priority: int
    freq: float = 1.0
    power: float = 0.0


class PowerCapper:
    def __init__(self, cap_watts: float, *, model: RAPLModel | None = None,
                 step: float = 0.05, deadband: float = 0.02, agnostic: bool = False):
        self.cap_watts = cap_watts
        self.model = model or RAPLModel()
        self.step = step
        self.deadband = deadband
        self.agnostic = agnostic
        self._tasks: dict[int, _Task] = {}
        self._ids = itertools.count()
        self._lock = threading.Lock()

    # -- API used by the woven wrapper ----------------------------------------

    def register(self, name: str, priority: int) -> int:
        with self._lock:
            tid = next(self._ids)
            self._tasks[tid] = _Task(tid, name, priority)
            return tid

    def frequency(self, task_id: int) -> float:
        with self._lock:
            return self._tasks[task_id].freq

    def report(self, task_id: int, power_watts: float) -> None:
        with self._lock:
            self._tasks[task_id].power = power_watts
            self._control_locked()

    def set_cap(self, cap_watts: float) -> None:
        """Move the node budget at runtime (a QoS governor reconfiguring
        under a new power envelope) and re-run the control step against
        the last reported powers, under the same lock `report` holds."""
        with self._lock:
            self.cap_watts = float(cap_watts)
            self._control_locked()

    # -- control loop ------------------------------------------------------------

    def total_power(self) -> float:
        with self._lock:
            return sum(t.power for t in self._tasks.values())

    def _control_locked(self) -> None:
        tasks = list(self._tasks.values())
        if not tasks:
            return
        total = sum(t.power for t in tasks)
        lo, hi = self.cap_watts * (1 - self.deadband), self.cap_watts * (1 + self.deadband)
        f_min, f_max = self.model.f_min, self.model.f_max
        if total > hi:
            if self.agnostic:
                for t in tasks:
                    t.freq = max(f_min, t.freq - self.step)
            else:
                order = sorted(tasks, key=lambda t: t.priority)  # lowest first
                for t in order:
                    if t.freq > f_min:
                        t.freq = max(f_min, t.freq - self.step)
                        break
                else:
                    for t in order:
                        t.freq = f_min
        elif total < lo:
            if self.agnostic:
                for t in tasks:
                    t.freq = min(f_max, t.freq + self.step)
            else:
                order = sorted(tasks, key=lambda t: -t.priority)  # highest first
                for t in order:
                    if t.freq < f_max:
                        t.freq = min(f_max, t.freq + self.step)
                        break

    def snapshot(self) -> list[dict]:
        """Point-in-time copy of the task table.  Holds the same lock as
        `report`/`_control_locked`/`set_cap`: a snapshot taken during a
        concurrent control step sees either the pre- or post-step
        frequencies, never a half-applied throttle order — the rows are
        deep-copied dicts, so the caller can't race later mutations
        either."""
        with self._lock:
            return [dataclasses.asdict(t) for t in self._tasks.values()]
