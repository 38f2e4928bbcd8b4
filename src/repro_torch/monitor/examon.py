"""ExaMon (paper §2.6): pub/sub monitoring broker.

Sensors publish (topic, value, timestamp); the broker fans messages out to
subscribers; `ExamonCollector` keeps a windowed internal state queryable
asynchronously (get / mean / max / p50 / p95) — the Collector API the LARA
aspects embed.  Multi-host aggregation tags topics with the process index
(`topic/@hostN`), mirroring the paper's sensing agents + broker topology.
"""

from __future__ import annotations

import fnmatch
import threading
import time
from collections import deque
from typing import Any, Callable


class ExamonBroker:
    def __init__(self):
        self._subs: list[tuple[str, Callable[[str, float, float], None]]] = []
        self._lock = threading.Lock()
        self.messages = 0

    def publish(self, topic: str, value: float, timestamp: float | None = None) -> None:
        ts = time.monotonic() if timestamp is None else timestamp
        with self._lock:
            subs = list(self._subs)
            self.messages += 1
        for pattern, cb in subs:
            if fnmatch.fnmatch(topic, pattern):
                cb(topic, float(value), ts)

    def subscribe(self, pattern: str, callback: Callable[[str, float, float], None]) -> None:
        with self._lock:
            self._subs.append((pattern, callback))

    def unsubscribe(self, callback) -> None:
        with self._lock:
            self._subs = [(p, cb) for p, cb in self._subs if cb is not callback]


_DEFAULT_BROKER: ExamonBroker | None = None


def get_default_broker() -> ExamonBroker:
    global _DEFAULT_BROKER
    if _DEFAULT_BROKER is None:
        _DEFAULT_BROKER = ExamonBroker()
    return _DEFAULT_BROKER


class ExamonCollector:
    """Windowed stats over one topic pattern (the Collector API)."""

    def __init__(self, name: str, topic: str, *, window: int = 256):
        self.name = name
        self.topic = topic
        self.window = window
        self._values: deque[float] = deque(maxlen=window)
        self._times: deque[float] = deque(maxlen=window)
        self._lock = threading.Lock()
        self._broker: ExamonBroker | None = None
        self._cb = self._on_message  # stable bound-method identity

    # lifecycle (paper: init/start/end/clean woven around the function body)
    def init(self, broker: ExamonBroker) -> "ExamonCollector":
        self._broker = broker
        return self

    def start(self) -> None:
        assert self._broker is not None, "init() first"
        self._broker.subscribe(self.topic, self._cb)

    def end(self) -> None:
        if self._broker is not None:
            self._broker.unsubscribe(self._cb)

    def clean(self) -> None:
        with self._lock:
            self._values.clear()
            self._times.clear()

    def _on_message(self, topic: str, value: float, ts: float) -> None:
        with self._lock:
            self._values.append(value)
            self._times.append(ts)

    # queries
    def get(self, default: float = 0.0) -> float:
        with self._lock:
            return self._values[-1] if self._values else default

    def get_mean(self) -> float:
        with self._lock:
            return sum(self._values) / len(self._values) if self._values else 0.0

    def get_max(self) -> float:
        with self._lock:
            return max(self._values) if self._values else 0.0

    def get_percentile(self, q: float) -> float:
        with self._lock:
            if not self._values:
                return 0.0
            vals = sorted(self._values)
            idx = min(int(q / 100.0 * len(vals)), len(vals) - 1)
            return vals[idx]

    def count(self) -> int:
        with self._lock:
            return len(self._values)
