"""Fault tolerance: watchdog, heartbeats/straggler detection, preemption
handling, and a fleet simulator that exercises the full
fail -> checkpoint-restore -> continue loop (tested; CPU container stands in
for the pod fleet).

Straggler policy (1000+-node posture): every host publishes step heartbeats
to ExaMon (`fleet/heartbeat/@hostN`); a host whose step time exceeds
`factor` x fleet-median for `patience` consecutive steps is flagged and the
mitigation callback fires (on a real fleet: demote to hot spare / re-slice;
in the simulator: replace the worker).
"""

from __future__ import annotations

import dataclasses
import signal
import threading
import time
from collections import defaultdict, deque
from typing import Any, Callable

from repro_torch.monitor.examon import ExamonBroker


# ---------------------------------------------------------------------------
# Watchdog: per-step deadline
# ---------------------------------------------------------------------------


class Watchdog:
    """Per-step deadline on a single reused timer thread.

    `beat()` re-arms one monotonic deadline instead of spawning a fresh
    `threading.Timer` per step (the old shape leaked a thread per beat and
    left a cancel/fire race: a Timer already past `cancel()`'s check could
    still run `_fire` and count a phantom timeout).  Here the expiry test,
    the timeout count and every re-arm/cancel happen under one lock, so a
    beat or cancel that lands before expiry always wins — a late wake-up
    observes the moved/cleared deadline and goes back to waiting.  The
    callback runs outside the lock (it may beat/cancel re-entrantly).
    """

    def __init__(self, deadline_s: float, on_timeout: Callable[[], None]):
        self.deadline_s = deadline_s
        self.on_timeout = on_timeout
        self.timeouts = 0
        self._cond = threading.Condition()
        self._deadline: float | None = None  # monotonic; None = disarmed
        self._closed = False
        self._thread: threading.Thread | None = None

    def beat(self) -> None:
        with self._cond:
            if self._closed:
                raise RuntimeError("watchdog is closed")
            self._deadline = time.monotonic() + self.deadline_s
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._run, name="watchdog", daemon=True)
                self._thread.start()
            self._cond.notify()

    def cancel(self) -> None:
        with self._cond:
            self._deadline = None
            self._cond.notify()

    def close(self) -> None:
        """Disarm and stop the timer thread (idempotent)."""
        with self._cond:
            self._deadline = None
            self._closed = True
            self._cond.notify()
        if self._thread is not None and self._thread is not threading.current_thread():
            self._thread.join(timeout=1.0)

    def _run(self) -> None:
        while True:
            with self._cond:
                if self._closed:
                    return
                if self._deadline is None:
                    self._cond.wait()
                    continue
                wait = self._deadline - time.monotonic()
                if wait > 0:
                    self._cond.wait(wait)
                    continue
                # expired while holding the lock: no beat/cancel can have
                # moved the deadline between the check and the count
                self._deadline = None
                self.timeouts += 1
                cb = self.on_timeout
            cb()


# ---------------------------------------------------------------------------
# Preemption: SIGTERM -> graceful checkpoint request
# ---------------------------------------------------------------------------


class PreemptionHandler:
    def __init__(self, install: bool = True):
        self.requested = threading.Event()
        if install:
            try:
                signal.signal(signal.SIGTERM, self._on_signal)
            except ValueError:  # non-main thread (tests)
                pass

    def _on_signal(self, signum, frame) -> None:
        self.requested.set()

    def request(self) -> None:  # manual trigger (tests / simulator)
        self.requested.set()

    @property
    def pending(self) -> bool:
        return self.requested.is_set()


# ---------------------------------------------------------------------------
# Heartbeats + straggler detection
# ---------------------------------------------------------------------------


class HeartbeatMonitor:
    """Straggler + liveness detection over `fleet/heartbeat/@host<i>` beats.

    Liveness runs on ONE clock: beats are stamped at *arrival* with the
    monitor's own `clock` (default `time.monotonic`), never with the
    broker-delivered publish timestamp — `ExamonBroker.publish` defaults to
    `time.monotonic()` but accepts any explicit `timestamp` (epoch seconds,
    logical step counters), so trusting it would compare timestamps across
    clock domains and mis-declare liveness.  A caller living in a different
    time domain (e.g. the serving fleet's round counter) passes its own
    `clock` and gets consistent `check_liveness` semantics for free.
    """

    def __init__(self, broker: ExamonBroker, *, factor: float = 2.0,
                 patience: int = 3, window: int = 16,
                 on_straggler: Callable[[int], None] | None = None,
                 on_dead: Callable[[int], None] | None = None,
                 dead_after_s: float = 30.0,
                 clock: Callable[[], float] | None = None):
        self.factor = factor
        self.patience = patience
        self.dead_after_s = dead_after_s
        self.on_straggler = on_straggler or (lambda host: None)
        self.on_dead = on_dead or (lambda host: None)
        self._clock = clock or time.monotonic
        self._times: dict[int, deque] = defaultdict(lambda: deque(maxlen=window))
        self._last_seen: dict[int, float] = {}
        self._strikes: dict[int, int] = defaultdict(int)
        self.flagged: set[int] = set()
        self.dead: set[int] = set()
        self.malformed_beats = 0
        broker.subscribe("fleet/heartbeat/*", self._on_beat)

    @staticmethod
    def _host_of(topic: str) -> int | None:
        """Host index from `...@host<i>`, or None for a malformed topic —
        a beat without the suffix (or with a non-numeric one) must be
        dropped and counted, never crash the broker's subscriber fan-out."""
        parts = topic.rsplit("@host", 1)
        if len(parts) != 2 or not parts[1].isdigit():
            return None
        return int(parts[1])

    def _on_beat(self, topic: str, step_time: float, ts: float) -> None:
        host = self._host_of(topic)
        if host is None:
            self.malformed_beats += 1
            return
        self._times[host].append(step_time)
        self._last_seen[host] = self._clock()
        # a beat from a declared-dead slot means a replacement took it over
        # (hot spare): the slot is live again
        self.dead.discard(host)
        self._check(host)

    def _median_all(self) -> float:
        means = [sum(v) / len(v) for v in self._times.values() if v]
        if not means:
            return 0.0
        means.sort()
        return means[len(means) // 2]

    def _check(self, host: int) -> None:
        med = self._median_all()
        if med <= 0 or len(self._times) < 2:
            return
        mine = sum(self._times[host]) / len(self._times[host])
        if mine > self.factor * med:
            self._strikes[host] += 1
            if self._strikes[host] >= self.patience and host not in self.flagged:
                self.flagged.add(host)
                self.on_straggler(host)
        else:
            self._strikes[host] = 0
            self.flagged.discard(host)

    def check_liveness(self, now: float | None = None) -> None:
        """Declare hosts dead after `dead_after_s` of silence.  `now`
        defaults to the monitor's own clock — the same one that stamped the
        beats — so the comparison never crosses clock domains."""
        now = self._clock() if now is None else now
        for host, last in list(self._last_seen.items()):
            if now - last > self.dead_after_s and host not in self.dead:
                self.dead.add(host)
                self.on_dead(host)

    def forget(self, host: int) -> None:
        """Drop all state for a retired host slot (e.g. after its in-flight
        work was re-dispatched), so a stale entry can't re-trigger on_dead."""
        self._times.pop(host, None)
        self._last_seen.pop(host, None)
        self._strikes.pop(host, None)
        self.flagged.discard(host)
        self.dead.discard(host)


# ---------------------------------------------------------------------------
# Fleet simulator (exercises restart/elastic logic without hardware)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SimWorker:
    host: int
    speed: float = 1.0  # steps per tick
    alive: bool = True


class FleetSim:
    """Simulates a data-parallel fleet around a real train-step callable.

    One 'tick' = one global step attempt: every live worker must heartbeat;
    a failed worker kills the step (the pod goes down), the trainer restores
    from the last checkpoint and continues — restore counts and straggler
    flags are observable for tests.
    """

    def __init__(self, num_hosts: int, broker: ExamonBroker, *, seed: int = 0):
        import random

        self.rng = random.Random(seed)
        self.broker = broker
        self.workers = [SimWorker(h) for h in range(num_hosts)]
        self.monitor = HeartbeatMonitor(
            broker, factor=2.0, patience=2,
            on_straggler=self._replace_worker,
        )
        self.replacements: list[int] = []
        self.failures: list[int] = []

    def _replace_worker(self, host: int) -> None:
        self.replacements.append(host)
        self.workers[host].speed = 1.0  # hot spare swapped in

    def inject_failure(self, host: int) -> None:
        self.workers[host].alive = False

    def inject_straggler(self, host: int, slowdown: float = 4.0) -> None:
        self.workers[host].speed = 1.0 / slowdown

    def tick(self, base_step_time: float = 0.01) -> bool:
        """Returns True if the global step succeeded (all workers alive)."""
        ok = True
        for w in self.workers:
            if not w.alive:
                self.failures.append(w.host)
                w.alive = True  # restarted by the launcher for the next tick
                ok = False
                continue
            step_time = base_step_time / w.speed
            self.broker.publish(f"fleet/heartbeat/@host{w.host}", step_time)
        return ok
