"""Host-level step sensors + the step-wrapper combinators the aspects weave.

A step wrapper has signature  wrap(step_fn, info) -> step_fn  where `info`
is a mutable dict the runtime shares with wrappers and the autotuner:
  tokens_per_step, flops_per_step, knobs (current values), timings, ...
Wrappers compose in weave order (innermost first).

PyTorch returns before the card has finished, so a wrapper that times a
step first waits for the card (`_block`): `step_time` is the device's time
for the step, not the time to issue its launches.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Mapping

import torch


def _cuda_devices(out, found: set) -> set:
    if isinstance(out, torch.Tensor):
        if out.is_cuda:
            found.add(out.device)
    elif isinstance(out, Mapping):
        for v in out.values():
            _cuda_devices(v, found)
    elif isinstance(out, (list, tuple)):
        for v in out:
            _cuda_devices(v, found)
    return found


def _block(out):
    """Wait until every card that holds a tensor of `out` is done."""
    for device in _cuda_devices(out, set()):
        torch.cuda.synchronize(device)
    return out


def sensor_wrapper(broker, topic: str, sensors=("time", "throughput", "power")):
    """Publish step time / throughput / modeled power to the ExaMon broker."""

    def wrap(step_fn: Callable, info: dict[str, Any]) -> Callable:
        from repro_torch.power.rapl import RAPLModel

        model: RAPLModel = info.setdefault("rapl_model", RAPLModel())

        def wrapped(*args, **kw):
            t0 = time.perf_counter()
            out = _block(step_fn(*args, **kw))
            dt = time.perf_counter() - t0
            host = info.get("host", 0)
            if "time" in sensors:
                broker.publish(f"{topic}/step_time/@host{host}", dt)
            if "throughput" in sensors and info.get("tokens_per_step"):
                broker.publish(f"{topic}/throughput/@host{host}",
                               info["tokens_per_step"] / dt)
            if "power" in sensors:
                flops = info.get("flops_per_step", 0.0)
                util = min((flops / dt) / model.peak_flops, 1.0) if flops else 0.3
                freq = float(info.get("freq", 1.0))
                broker.publish(f"{topic}/power/@host{host}", model.power(util, freq))
            info["last_step_time"] = dt
            return out

        return wrapped

    return wrap


def timing_wrapper(label_from_knob: str | None = None):
    """Per-version timing (the paper's Timer.time around each switch case)."""

    def wrap(step_fn: Callable, info: dict[str, Any]) -> Callable:
        timings = info.setdefault("timings", {})

        def wrapped(*args, **kw):
            t0 = time.perf_counter()
            out = _block(step_fn(*args, **kw))
            dt = time.perf_counter() - t0
            label = "step"
            if label_from_knob:
                label = str(info.get("knobs", {}).get(label_from_knob, "__default__"))
            timings.setdefault(label, []).append(dt)
            return out

        return wrapped

    return wrap


def memo_wrapper(table):
    """Request-level memoization for pure serve steps (paper Fig. 8)."""

    def wrap(step_fn: Callable, info: dict[str, Any]) -> Callable:
        def wrapped(*args, **kw):
            if not table.running:
                return step_fn(*args, **kw)
            key = (args, tuple(sorted(kw.items())) if kw else ())
            hit, value = table.lookup(key)
            if hit:
                info["memo_hit"] = True
                return value
            info["memo_hit"] = False
            out = step_fn(*args, **kw)
            table.update(key, out)
            return out

        return wrapped

    return wrap


def powercap_wrapper(capper, priority: int):
    """Register with the PowerCapper; apply its frequency decision as a
    modeled slowdown (CPU container: DVFS is simulated, control loop real)."""

    def wrap(step_fn: Callable, info: dict[str, Any]) -> Callable:
        task_id = capper.register(info.get("task_name", "step"), priority)

        def wrapped(*args, **kw):
            freq = capper.frequency(task_id)
            info["freq"] = freq
            t0 = time.perf_counter()
            out = _block(step_fn(*args, **kw))
            dt = (time.perf_counter() - t0) / max(freq, 1e-3)  # modeled DVFS slowdown
            from repro_torch.power.rapl import RAPLModel

            model: RAPLModel = info.setdefault("rapl_model", RAPLModel())
            flops = info.get("flops_per_step", 0.0)
            util = min((flops / dt) / model.peak_flops, 1.0) if flops else 0.3
            capper.report(task_id, model.power(util, freq))
            info["modeled_step_time"] = dt
            return out

        return wrapped

    return wrap


def apply_wrappers(step_fn: Callable, wrappers, info: dict[str, Any]) -> Callable:
    for w in wrappers:
        step_fn = w(step_fn, info)
    return step_fn
