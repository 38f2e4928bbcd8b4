"""LAT-style design-space exploration (paper §4.1, Fig. 13).

Explores knob combinations (full grid or random sample), evaluates each with
user-provided metric callables, repeats `num_tests` times, aggregates
mean/std, and exports CSV — the exploration whose output "can be fed to the
autotuner" (paper Fig. 14), via KnowledgeBase.from_dse.
"""

from __future__ import annotations

import csv
import random
import time
from typing import Any, Callable, Mapping, Sequence

from repro_torch.core.knob import KnobSpace


class Lat:
    def __init__(self, name: str):
        self.name = name
        self.num_tests = 1
        self._vars: dict[str, Sequence[Any]] = {}
        self._metrics: dict[str, Callable[..., float]] = {}
        self.results: list[dict] = []

    # -- design space -----------------------------------------------------------

    def add_var(self, name: str, values: Sequence[Any]) -> "Lat":
        self._vars[name] = list(values)
        return self

    def add_var_range(self, name: str, start: int, stop: int, step: int = 1,
                      transform: Callable[[int], Any] | None = None) -> "Lat":
        vals = [transform(x) if transform else x for x in range(start, stop, step)]
        self._vars[name] = vals
        return self

    def from_knob_space(self, space: KnobSpace) -> "Lat":
        for k in space:
            self._vars[k.name] = list(k.values)
        return self

    # -- metrics -----------------------------------------------------------------

    def add_metric(self, name: str, fn: Callable[..., float]) -> "Lat":
        """fn(**knobs) -> value; called num_tests times per point."""
        self._metrics[name] = fn
        return self

    def set_num_tests(self, n: int) -> "Lat":
        self.num_tests = n
        return self

    # -- exploration -----------------------------------------------------------------

    def _points(self, sample: int | None, seed: int) -> list[dict]:
        names = list(self._vars)
        grid: list[dict] = [{}]
        for n in names:
            grid = [dict(p, **{n: v}) for p in grid for v in self._vars[n]]
        if sample is not None and sample < len(grid):
            rng = random.Random(seed)
            grid = rng.sample(grid, sample)
        return grid

    def tune(self, *, sample: int | None = None, seed: int = 0) -> list[dict]:
        self.results = []
        for point in self._points(sample, seed):
            metrics: dict[str, tuple[float, float]] = {}
            for mname, fn in self._metrics.items():
                vals = [float(fn(**point)) for _ in range(self.num_tests)]
                mean = sum(vals) / len(vals)
                var = sum((v - mean) ** 2 for v in vals) / max(len(vals) - 1, 1)
                metrics[mname] = (mean, var**0.5)
            self.results.append({"knobs": point, "metrics": metrics})
        return self.results

    # -- export -----------------------------------------------------------------------

    def to_csv(self, path: str) -> None:
        if not self.results:
            return
        knob_names = list(self.results[0]["knobs"])
        metric_names = list(self.results[0]["metrics"])
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(knob_names + [f"{m}_{s}" for m in metric_names for s in ("mean", "std")])
            for row in self.results:
                vals = [row["knobs"][k] for k in knob_names]
                for m in metric_names:
                    vals += list(row["metrics"][m])
                w.writerow(vals)
