"""Monitoring aspects (paper §2.6, Fig. 11 — SimpleExamon).

Weaves ExaMon collectors into the program: taps (activation
statistics on selected joinpoints) and host-level step sensors (time,
throughput, modeled power) published to the ExaMon broker under the given
topic.  The Collector API can then be queried asynchronously — e.g. by
mARGOt or the PowerCapper.
"""

from __future__ import annotations

from repro_torch.core.weaver import Aspect, Weaver


class ExamonMonitor(Aspect):
    name = "SimpleExamon"

    def __init__(self, topic: str, *, tap_patterns: tuple[str, ...] = (),
                 broker=None, sensors: tuple[str, ...] = ("time", "throughput", "power")):
        self.topic = topic
        self.tap_patterns = tap_patterns
        self.broker = broker
        self.sensors = sensors

    def apply(self, weaver: Weaver) -> None:
        from repro_torch.monitor.examon import ExamonBroker, get_default_broker
        from repro_torch.monitor.sensors import sensor_wrapper

        broker = self.broker or get_default_broker()
        for pattern in self.tap_patterns:
            for jp in weaver.select(pattern):
                jp.attr("kind")
                weaver.add_tap(f"{jp.path}/*")
        weaver.set_extra("examon_topic", self.topic)
        weaver.wrap_step(sensor_wrapper(broker, self.topic, self.sensors))
