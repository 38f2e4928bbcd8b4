"""QoS control plane for streaming serving (paper §2.5, §2.7): the serving
operating point as a mARGOt application.

`Server.serve_stream` is the managed application; its operating point —
``max_batch × prefill_chunk × draft_len × freq`` (the DVFS/power knob) —
is a mARGOt `KnowledgeBase` whose per-OP metric expectations come from an
analytic wave-cost model (cost and power are modeled, not read from the
card, exactly like `power/rapl`).  Per-request latency SLOs (TTFT and
per-token) are `Goal` constraints; tokens/s or tokens/joule is the
objective (`State` "throughput" / "efficiency"); observed wave latencies
feed `Margot.observe`, whose reactive error coefficient rescales every
expectation — so the model only has to be *relatively* right across OPs,
the feedback loop calibrates the absolute scale.  Load (waiting + active
requests) is the proactive input feature: per-load-bucket knowledge bases
are selected by nearest feature vector, so the governor plans against the
queue it actually has.

Power closes the loop through `power/capper.PowerCapper`: each wave's
modeled power is `report`ed (the capper throttles by priority when the
node is over budget) and the capper's frequency clamps the governor's own
freq knob — the serving loop then divides its pace by
`RAPLModel.perf_scale`, which is what makes tokens/joule a real tradeoff
rather than bookkeeping.

Every knob move only changes *scheduling* (when work runs), never the
tokens: emitted output stays a target argmax chain, bit-identical to an
ungoverned serve.
"""

from __future__ import annotations

import itertools
import math
from typing import Any, Iterable

from repro_torch.autotune.margot import (
    LE,
    Goal,
    KnowledgeBase,
    Margot,
    OperatingPoint,
    State,
)
from repro_torch.power.capper import PowerCapper
from repro_torch.power.rapl import RAPLModel

# Knob grids: a tuple/list is a governed knob (the OP space), a scalar is
# a fixed value, None leaves the knob ungoverned (the server's own
# argument/config value stays in force).  SLOs of None mean "no Goal".
DEFAULT_QOS_POLICY: dict[str, Any] = {
    "enabled": True,
    "max_batch": (1, 2, 4, 8),     # concurrent decode slots
    "prefill_chunk": (0, 32, 128),  # tokens per admission wave (0: one-shot)
    "draft_len": None,             # speculative k (None: ungoverned)
    "freq": None,                  # DVFS knob (None: ungoverned)
    "objective": "tokens_per_s",   # or "tokens_per_joule"
    "slo_ttft_s": None,            # Goal: time to first token
    "slo_tok_s": None,             # Goal: worst inter-token gap
    "power_cap_w": None,           # Goal + PowerCapper node budget
    "reselect_every": 4,           # waves between Margot.update calls
    "reactive": True,              # feed observed latencies to Margot
    #   (False: plan purely from the analytic model + load feature — a
    #   deterministic policy for benches scored on a modeled clock, where
    #   wall-clock noise must not steer CI-asserted OP choices)
    "load_buckets": (1, 2, 4, 8, 16, 32),  # proactive feature clusters
    # analytic wave-cost model (relative costs; the reactive error
    # coefficient calibrates the absolute scale from observed waves)
    "s0": 2e-3,                    # fixed per-wave overhead, seconds
    "s_tok": 2e-4,                 # per processed token, seconds
    "accept": 0.8,                 # expected draft acceptance rate
    "compute_bound_frac": 0.6,     # RAPLModel.perf_scale phase mix
    "typical_prompt": 64,          # tokens, for admission-cost modeling
}

_KNOB_NAMES = ("max_batch", "prefill_chunk", "draft_len", "freq")
_METRIC_NAMES = ("wave_s", "tok_s", "ttft_s", "tokens_per_s",
                 "power_w", "tokens_per_joule")


class QoSGovernor:
    """MAPE-K governor over the serving operating point.

    The serve loop calls three hooks:

      * ``decide(wave=, waiting=, active=)`` every ``reselect_every``
        waves — Margot plans against the current load feature and returns
        the knob dict to apply (only governed knobs appear);
      * ``observe_wave(dt_s, batch=, emitted=, prefill_tokens=, wave=)``
        at every wave boundary — feeds the reactive error coefficient,
        accounts energy, reports power to the capper;
      * ``observe(metric, value)`` for per-request metrics (TTFT).

    ``stats()`` reports switches / distinct OPs / the OP history plus the
    energy ledger — what the qos bench and the fleet aggregate.
    """

    def __init__(self, policy: dict[str, Any] | None = None, *,
                 broker=None, capper: PowerCapper | None = None,
                 model: RAPLModel | None = None):
        pol = dict(DEFAULT_QOS_POLICY)
        if policy:
            pol.update(policy)
        self.policy = pol
        self.model = model or RAPLModel()
        self.broker = broker
        self.reselect_every = max(1, int(pol["reselect_every"]))
        self.capper = capper
        if self.capper is None and pol.get("power_cap_w"):
            self.capper = PowerCapper(float(pol["power_cap_w"]),
                                      model=self.model)
        self._task_id = None
        if self.capper is not None:
            self._task_id = self.capper.register("serve_stream", priority=1)
        # capacity normalizer for the utilization model: the most decode
        # tokens any OP can put in one wave
        bs = self.knob_values("max_batch") or (1,)
        ks = self.knob_values("draft_len") or (0,)
        self._peak_tokens = max(bs) * (1 + max(ks))
        self.margot = self._build_margot()
        self.current_knobs: dict[str, Any] = {}
        self.op_history: list[dict[str, Any]] = []  # wave + knobs per switch
        self.energy_j = 0.0
        self.tokens = 0
        self.waves = 0

    # -- knob space -----------------------------------------------------------

    def knob_values(self, name: str) -> tuple:
        """The governed grid for one knob (empty when ungoverned) — the
        server sizes verify slack and the draft pool from
        ``knob_values("draft_len")``."""
        v = self.policy.get(name)
        if v is None:
            return ()
        if not isinstance(v, (tuple, list)):
            v = (v,)
        return tuple(x for x in v if x is not None)

    def _grid(self) -> Iterable[dict[str, Any]]:
        names = [n for n in _KNOB_NAMES if self.knob_values(n)]
        for combo in itertools.product(
                *[self.knob_values(n) for n in names]):
            yield dict(zip(names, combo))

    # -- analytic model -------------------------------------------------------

    def _metrics(self, knobs: dict[str, Any],
                 load: float) -> dict[str, tuple[float, float]]:
        pol = self.policy
        b = int(knobs.get("max_batch", max(self.knob_values("max_batch")
                                           or (8,))))
        chunk = int(knobs.get("prefill_chunk", 0) or 0)
        kd = int(knobs.get("draft_len", 0) or 0)
        freq = float(knobs.get("freq", 1.0) or 1.0)
        s0, s_tok = float(pol["s0"]), float(pol["s_tok"])
        acc = float(pol["accept"])
        s_typ = max(1, int(pol["typical_prompt"]))
        scale = self.model.perf_scale(freq, float(pol["compute_bound_frac"]))

        b_eff = max(1.0, min(load, b))
        queued = max(load - b, 0.0)
        decode_tok = b_eff * (1 + kd)
        admit_tok = min(chunk, s_typ) if chunk else s_typ
        prefill_waves = math.ceil(s_typ / chunk) if chunk else 1
        wave_s = (s0 + s_tok * decode_tok) / scale
        # a wave that also hosts admission work (the one-shot prompt, or
        # one chunk of it) — the worst inter-token gap survivors see
        wave_admit_s = (s0 + s_tok * (decode_tok + admit_tok)) / scale
        tok_mean = 1 + kd * acc  # emitted per request per wave
        tokens_per_s = b_eff * tok_mean / wave_admit_s
        queue_waves = math.ceil(queued / b) if queued else 0
        ttft_s = queue_waves * wave_s + prefill_waves * wave_admit_s
        util = min(1.0, decode_tok / self._peak_tokens)
        power_w = self.model.power(util, freq)
        tokens_per_joule = tokens_per_s / power_w
        out = {"wave_s": wave_s, "tok_s": wave_admit_s, "ttft_s": ttft_s,
               "tokens_per_s": tokens_per_s, "power_w": power_w,
               "tokens_per_joule": tokens_per_joule}
        return {k: (v, 0.1 * v) for k, v in out.items()}

    def _build_margot(self) -> Margot:
        pol = self.policy
        goals = []
        if pol.get("slo_ttft_s") is not None:
            goals.append(Goal("slo_ttft", "ttft_s", LE,
                              float(pol["slo_ttft_s"])))
        if pol.get("slo_tok_s") is not None:
            goals.append(Goal("slo_tok", "tok_s", LE,
                              float(pol["slo_tok_s"])))
        if pol.get("power_cap_w") is not None:
            goals.append(Goal("power_cap", "power_w", LE,
                              float(pol["power_cap_w"])))
        states = [
            State("throughput", "tokens_per_s", maximize=True,
                  constraints=list(goals)),
            State("efficiency", "tokens_per_joule", maximize=True,
                  constraints=list(goals)),
        ]
        active = ("efficiency" if pol["objective"] == "tokens_per_joule"
                  else "throughput")
        feature_kbs = {}
        for bucket in pol["load_buckets"]:
            ops = [OperatingPoint(knobs, self._metrics(knobs, float(bucket)))
                   for knobs in self._grid()]
            feature_kbs[(float(bucket),)] = KnowledgeBase(ops)
        base = feature_kbs.get(
            (float(pol["load_buckets"][0]),), KnowledgeBase(
                [OperatingPoint(knobs, self._metrics(knobs, 1.0))
                 for knobs in self._grid()]))
        return Margot(base, states, active, feature_kbs=feature_kbs)

    # -- MAPE hooks the serve loop calls --------------------------------------

    def decide(self, *, wave: int, waiting: int, active: int) -> dict:
        """Analyze + plan: re-select the OP for the current load feature.
        Returns the knob dict to apply (the serve loop clamps each knob to
        its own static limits)."""
        load = float(max(1, waiting + active))
        op = self.margot.update(features=(load,))
        knobs = dict(op.knobs)
        if self.capper is not None and self._task_id is not None:
            # the node power budget wins over the planned DVFS point: a
            # throttled task runs at the capper's frequency even if the
            # governor's objective wanted more
            f_cap = self.capper.frequency(self._task_id)
            knobs["freq"] = min(float(knobs.get("freq", 1.0) or 1.0), f_cap)
        if not self.op_history \
                or self.op_history[-1]["knobs"] != dict(op.knobs):
            self.op_history.append({"wave": int(wave), "load": load,
                                    "knobs": dict(op.knobs)})
        self.current_knobs = knobs
        if self.broker is not None:
            self.broker.publish("serve/qos/load", load)
        return knobs

    def observe(self, metric: str, value: float) -> None:
        """Per-request observation (the serve loop feeds TTFT here)."""
        if self.policy.get("reactive", True):
            self.margot.observe(metric, float(value))

    def observe_wave(self, dt_s: float, *, batch: int, emitted: int,
                     prefill_tokens: int = 0, wave: int = 0) -> None:
        """Monitor: one wave boundary.  Feeds the reactive error
        coefficient (observed wave latency vs the current OP's
        expectation), accounts modeled energy, and reports power to the
        capper's priority control loop."""
        dt_s = float(dt_s)
        if not math.isfinite(dt_s) or dt_s < 0:
            return
        freq = float(self.current_knobs.get("freq", 1.0) or 1.0)
        if self.policy.get("reactive", True):
            self.margot.observe("wave_s", dt_s)
            if prefill_tokens or self.margot.current is None:
                self.margot.observe("tok_s", dt_s)
        self.waves += 1
        self.tokens += int(emitted)
        kd = int(self.current_knobs.get("draft_len", 0) or 0)
        util = min(1.0, batch * (1 + kd) / self._peak_tokens)
        p = self.model.power(util, freq)
        self.energy_j += p * dt_s
        if self.capper is not None and self._task_id is not None:
            self.capper.report(self._task_id, p)
        if self.broker is not None:
            self.broker.publish("serve/qos/wave_s", dt_s)
            self.broker.publish("serve/qos/power_w", p)

    # -- runtime reconfiguration ----------------------------------------------

    def set_power_cap(self, watts: float) -> None:
        """Move the node power budget at runtime: the capper's cap and the
        Margot power Goal both move, so planning and throttling agree."""
        watts = float(watts)
        self.policy["power_cap_w"] = watts
        if self.capper is not None:
            self.capper.set_cap(watts)
        else:
            self.capper = PowerCapper(watts, model=self.model)
            self._task_id = self.capper.register("serve_stream", priority=1)
        for state in self.margot.states.values():
            state.constraints = [
                Goal("power_cap", "power_w", LE, watts)
                if g.name == "power_cap" else g
                for g in state.constraints]
            if not any(g.name == "power_cap" for g in state.constraints):
                state.constraints.append(
                    Goal("power_cap", "power_w", LE, watts))

    def stats(self) -> dict[str, Any]:
        distinct = {tuple(sorted(h["knobs"].items()))
                    for h in self.op_history}
        return {
            "switches": self.margot.switches,
            "distinct_ops": len(distinct),
            "op_history": list(self.op_history),
            "current": dict(self.current_knobs),
            "objective": self.margot.active,
            "waves": self.waves,
            "tokens": self.tokens,
            "energy_j": self.energy_j,
            "tokens_per_joule": (self.tokens / self.energy_j
                                 if self.energy_j > 0 else None),
            "power": (self.capper.snapshot()
                      if self.capper is not None else None),
        }
