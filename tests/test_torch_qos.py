"""PyTorch port: the QoS governor, mARGOt, the power capper, LAT and the
ANTAREX strategies of the QoS slice, against the reference.

Framework-free units, fed the same inputs in both packages and compared
exactly: `QoSGovernor` (`tests/test_qos.py::TestQoSGovernor`: its
`decide` knobs, `stats()` — `op_history`, `switches`, `energy_j` — and the
capper's `snapshot`), `Margot` (`tests/test_runtime_services.py::TestMargot`
and `tests/test_qos.py::TestMargotWindow`), `PowerCapper`
(`TestPowerCapper`, `TestCapperConcurrency`) and `Lat` (`TestLat`).  The
port's `RAPLModel` models a 700 W card; the comparisons hand both packages
the reference's model parameters.

The governed serve: the head_dim-64 variant of reduced yi-6b, weights
carried across, policy `double`, `serve_continuous` with `reactive: False`,
SLOs, `arrival_waves` and a `draft_len` grid gives the reference's tokens,
`op_history` and `last_spec_stats`, and the tokens of the ungoverned serve;
`qos=False` leaves `last_qos_stats` None; a woven `QoSAspect` (or a
governor instance) resolves.  The weave strategies of the slice
(`PowerPriority`, `MemoizeStep`, `find_memoizable`, `Multiversion`,
`SpecializeCall`) weave what the reference's weave."""

import dataclasses
import threading

import numpy as np
import pytest
import torch

from repro.autotune import dse as jdse
from repro.autotune import margot as jmargot
from repro.power import capper as jcapper
from repro.power.rapl import RAPLModel as JRAPL
from repro.runtime import qos as jqos
from repro_torch.autotune import dse as tdse
from repro_torch.autotune import margot as tmargot
from repro_torch.power import capper as tcapper
from repro_torch.power.rapl import RAPLModel as TRAPL
from repro_torch.runtime import qos as tqos

from test_torch_serve import _servers

torch.set_num_threads(1)

# both sides: the power model with the reference's parameters
PKGS = {
    "reference": dict(qos=jqos, margot=jmargot, capper=jcapper, dse=jdse,
                      model=lambda: JRAPL()),
    "port": dict(qos=tqos, margot=tmargot, capper=tcapper, dse=tdse,
                 model=lambda: TRAPL(**dataclasses.asdict(JRAPL()))),
}


def _both(scenario):
    """`scenario` run on each package's modules; returns (reference, port)."""
    return scenario(PKGS["reference"]), scenario(PKGS["port"])


def _gov_trace(pkg, policy, steps, capper_cap=None):
    """A governor under `policy` driven through `steps`: ("decide", waiting,
    active), ("wave", dt, batch, emitted, prefill_tokens), ("ttft", s),
    ("cap", watts).  Returns every decision and the final stats."""
    model = pkg["model"]()
    capper = (pkg["capper"].PowerCapper(capper_cap, model=model)
              if capper_cap is not None else None)
    gov = pkg["qos"].QoSGovernor(policy, capper=capper, model=model)
    out = []
    for w, step in enumerate(steps):
        if step[0] == "decide":
            out.append(gov.decide(wave=w, waiting=step[1], active=step[2]))
        elif step[0] == "wave":
            gov.observe_wave(step[1], batch=step[2], emitted=step[3],
                             prefill_tokens=step[4], wave=w)
        elif step[0] == "ttft":
            gov.observe("ttft_s", step[1])
        else:
            gov.set_power_cap(step[1])
    st = gov.stats()
    goals = {name: [(g.name, g.metric, g.op, g.value) for g in s.constraints]
             for name, s in gov.margot.states.items()}
    return {"decisions": out, "stats": st, "goals": goals,
            "knob_values": {k: gov.knob_values(k) for k in tqos._KNOB_NAMES},
            "peak_tokens": gov._peak_tokens,
            "error_coef": dict(gov.margot._error_coef)}


def _ramp(n=24, dt=0.01):
    """A load ramp up and down with a wave observed after each decision."""
    steps = []
    for w in range(n):
        load = [1, 2, 4, 8, 16, 30, 8, 3][w % 8]
        steps.append(("decide", max(0, load - 4), min(load, 4)))
        steps.append(("wave", dt * (1 + 0.3 * (w % 3)), min(load, 8), min(load, 8),
                      32 if w % 4 == 0 else 0))
        if w % 5 == 0:
            steps.append(("ttft", 0.05 + 0.01 * w))
    return steps


GOVERNOR_CASES = {
    "defaults": ({}, _ramp(), None),
    "slo_tok": ({"slo_tok_s": 0.05}, _ramp(), None),
    "slo_both_unreactive_draft": ({"slo_ttft_s": 0.02, "slo_tok_s": 0.01, "reactive": False,
                                   "draft_len": (0, 2, 4)}, _ramp(), None),
    "slo_reactive_draft": ({"slo_ttft_s": 0.02, "slo_tok_s": 0.01,
                            "draft_len": (0, 2, 4)}, _ramp(), None),
    "efficiency_freq": ({"objective": "tokens_per_joule", "freq": (0.5, 0.75, 1.0)},
                        _ramp(), None),
    "power_cap_freq": ({"power_cap_w": 150.0, "freq": (0.5, 1.0)}, _ramp(), None),
    "capper_clamps": ({"freq": (1.0,)}, [("decide", 0, 1)]
                      + [("wave", 0.01, 1, 1, 0)] * 30 + [("decide", 0, 1)], 10.0),
    "set_power_cap": ({"power_cap_w": 500.0}, _ramp(8) + [("cap", 120.0)] + _ramp(8), None),
    "non_finite_dropped": ({}, [("decide", 0, 2), ("wave", float("nan"), 2, 99, 0),
                                ("wave", -1.0, 2, 99, 0), ("wave", 0.01, 2, 2, 0)], None),
}


@pytest.mark.parametrize("name", list(GOVERNOR_CASES))
def test_governor_decisions_and_stats_equal_reference(name):
    policy, steps, cap = GOVERNOR_CASES[name]
    ref, port = _both(lambda pkg: _gov_trace(pkg, dict(policy), steps, cap))
    assert port == ref


def test_governor_contract():
    """What tests/test_qos.py asserts of the governor, on the port's."""
    gov = tqos.QoSGovernor({"max_batch": (1, 4), "draft_len": None})
    assert gov.knob_values("max_batch") == (1, 4) and gov.knob_values("draft_len") == ()
    assert gov.knob_values("prefill_chunk") == tuple(tqos.DEFAULT_QOS_POLICY["prefill_chunk"])
    gov = tqos.QoSGovernor({"slo_tok_s": 0.05})
    low = gov.decide(wave=0, waiting=0, active=1)
    high = gov.decide(wave=4, waiting=30, active=8)
    assert high["max_batch"] == max(tqos.DEFAULT_QOS_POLICY["max_batch"]) >= low["max_batch"]
    assert gov.stats()["distinct_ops"] >= 2 and gov.margot.switches >= 2
    gov = tqos.QoSGovernor({"power_cap_w": 150.0, "freq": (0.5, 1.0)})
    gov.decide(wave=0, waiting=0, active=2)
    for w in range(8):
        gov.observe_wave(0.01, batch=2, emitted=2, wave=w)
    s = gov.stats()
    assert s["tokens"] == 16 and s["waves"] == 8 and s["energy_j"] > 0
    assert s["tokens_per_joule"] == pytest.approx(16 / s["energy_j"])
    assert len(s["power"]) == 1
    gov.set_power_cap(120.0)
    assert gov.capper.cap_watts == 120.0
    capper = tcapper.PowerCapper(10.0, model=TRAPL())
    gov = tqos.QoSGovernor({"freq": (1.0,)}, capper=capper)
    gov.decide(wave=0, waiting=0, active=1)
    for w in range(30):
        gov.observe_wave(0.01, batch=1, emitted=1, wave=w)
    assert gov.decide(wave=30, waiting=0, active=1)["freq"] < 1.0


# -- mARGOt --------------------------------------------------------------------


def _kb(m):
    return m.KnowledgeBase([
        m.OperatingPoint({"knob": "fast"}, {"throughput": (100.0, 5.0), "error": (0.05, 0.01)}),
        m.OperatingPoint({"knob": "accurate"}, {"throughput": (40.0, 2.0),
                                                "error": (0.01, 0.002)}),
        m.OperatingPoint({"knob": "balanced"}, {"throughput": (70.0, 3.0),
                                                "error": (0.025, 0.005)}),
    ])


def _margot_constrained(m):
    mg = m.Margot(_kb(m), [m.State("s", "throughput", True, [m.Goal("err", "error", m.LE, 0.03)])])
    return mg.update().knobs, mg.switches


def _margot_relaxed(m):
    mg = m.Margot(_kb(m), [m.State("s", "throughput", True,
                                   [m.Goal("err", "error", m.LE, 0.001)])])
    return mg.update().knobs


def _margot_reactive(m):
    mg = m.Margot(_kb(m), [m.State("s", "throughput", True, [m.Goal("err", "error", m.LE, 0.03)])])
    picks = [mg.update().knobs]
    for _ in range(8):
        mg.observe("error", 0.075)
    picks.append(mg.update().knobs)
    return picks, mg.switches, dict(mg._error_coef)


def _margot_state_switch(m):
    s1 = m.State("quality", "throughput", True, [m.Goal("e", "error", m.LE, 0.03)])
    s2 = m.State("speed", "throughput", True, [])
    mg = m.Margot(_kb(m), [s1, s2], "quality")
    first = mg.update().knobs
    mg.switch_state("speed")
    return first, mg.update().knobs


def _margot_features(m):
    small = m.KnowledgeBase([m.OperatingPoint({"knob": "a"}, {"t": (1.0, 0)})])
    big = m.KnowledgeBase([m.OperatingPoint({"knob": "b"}, {"t": (1.0, 0)})])
    mg = m.Margot(_kb(m), [m.State("s", "t", True)],
                  feature_kbs={(10.0,): small, (1000.0,): big})
    return mg.update(features=(12.0,)).knobs, mg.update(features=(900.0,)).knobs


def _margot_window(m):
    mg = m.Margot(m.KnowledgeBase([]), [m.State("s", "m")], window=32)
    for i in range(1000):
        mg.observe("latency", float(i))
    bounded = list(mg._obs["latency"])
    mg.observe("latency", float("nan"))
    mg.observe("latency", float("inf"))
    mg.window = 4
    mg.observe("latency", 8.0)
    return bounded, list(mg._obs["latency"])


def _margot_ge_confidence(m):
    g = m.Goal("t", "throughput", m.GE, 60.0, confidence=2.0)
    return [(g.satisfied(mean, std), g.violation(mean, std))
            for mean, std in ((70.0, 3.0), (70.0, 6.0), (50.0, 1.0))]


MARGOT_CASES = [_margot_constrained, _margot_relaxed, _margot_reactive,
                _margot_state_switch, _margot_features, _margot_window,
                _margot_ge_confidence]


@pytest.mark.parametrize("scenario", MARGOT_CASES, ids=lambda f: f.__name__[8:])
def test_margot_equals_reference(scenario):
    ref, port = _both(lambda pkg: scenario(pkg["margot"]))
    assert port == ref


def test_margot_contract():
    assert _margot_constrained(tmargot)[0] == {"knob": "balanced"}
    assert _margot_relaxed(tmargot) == {"knob": "accurate"}
    picks, switches, _ = _margot_reactive(tmargot)
    assert picks[1] == {"knob": "accurate"} and switches == 2
    assert _margot_state_switch(tmargot) == ({"knob": "balanced"}, {"knob": "fast"})
    assert _margot_features(tmargot) == ({"knob": "a"}, {"knob": "b"})
    bounded, resized = _margot_window(tmargot)
    assert len(bounded) == 32 and bounded[0] == 968.0
    assert resized == [997.0, 998.0, 999.0, 8.0]


# -- PowerCapper ---------------------------------------------------------------


def _capper_converges(pkg, agnostic=False):
    model = pkg["model"]()
    capper = pkg["capper"].PowerCapper(cap_watts=300.0, model=model, agnostic=agnostic)
    t1 = capper.register("train", priority=10)
    t2 = capper.register("background", priority=1)
    trace = []
    for _ in range(60):
        for tid in (t1, t2):
            capper.report(tid, model.power(0.9, capper.frequency(tid)))
        trace.append(capper.snapshot())
    return trace, capper.total_power()


def _capper_set_cap(pkg):
    capper = pkg["capper"].PowerCapper(1000.0, model=pkg["model"](), step=0.5)
    lo = capper.register("lo", priority=0)
    hi = capper.register("hi", priority=9)
    capper.report(lo, 100.0)
    capper.report(hi, 100.0)
    before = capper.snapshot()
    capper.set_cap(50.0)
    return before, capper.snapshot(), capper.frequency(lo), capper.frequency(hi)


@pytest.mark.parametrize("scenario", [
    _capper_converges, lambda pkg: _capper_converges(pkg, agnostic=True), _capper_set_cap,
], ids=["priority", "agnostic", "set_cap"])
def test_capper_snapshots_equal_reference(scenario):
    ref, port = _both(scenario)
    assert port == ref


def test_capper_contract():
    pkg = PKGS["port"]
    trace, total = _capper_converges(pkg)
    snap = {s["name"]: s for s in trace[-1]}
    assert total <= 300.0 * 1.05 and snap["train"]["freq"] >= snap["background"]["freq"]
    trace, _ = _capper_converges(pkg, agnostic=True)
    snap = {s["name"]: s for s in trace[-1]}
    assert snap["train"]["freq"] == pytest.approx(snap["background"]["freq"], abs=0.051)
    _, _, f_lo, f_hi = _capper_set_cap(pkg)
    assert f_lo < 1.0 and f_hi == 1.0


def test_capper_snapshot_consistent_under_report_storm():
    capper = tcapper.PowerCapper(100.0, model=TRAPL())
    tids = [capper.register(f"t{i}", priority=i) for i in range(4)]
    stop = threading.Event()
    errors: list[BaseException] = []

    def hammer(tid, seed):
        rng = np.random.default_rng(seed)
        try:
            while not stop.is_set():
                capper.report(tid, float(rng.uniform(10.0, 80.0)))
        except BaseException as e:  # pragma: no cover
            errors.append(e)

    threads = [threading.Thread(target=hammer, args=(t, i), daemon=True)
               for i, t in enumerate(tids)]
    for t in threads:
        t.start()
    model = capper.model
    try:
        for i in range(300):
            snap = capper.snapshot()
            assert len(snap) == 4
            for row in snap:
                assert model.f_min <= row["freq"] <= model.f_max
            if i % 50 == 25:
                capper.set_cap(60.0 if i % 100 == 25 else 140.0)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=5)
    assert not errors


# -- LAT -----------------------------------------------------------------------


def _lat_explore(pkg, tmp_path):
    d = pkg["dse"]
    lat = d.Lat("t").add_var("threads", [1, 2, 4]).add_var_range(
        "size", 0, 2, 1, lambda x: 10 ** x)
    lat.add_metric("time", lambda threads, size: size / threads)
    lat.set_num_tests(2)
    results = lat.tune()
    path = tmp_path / f"{id(d)}.csv"
    lat.to_csv(str(path))
    sampled = d.Lat("s").add_var("a", range(5)).add_var("b", range(4))
    sampled.add_metric("m", lambda a, b: float(a * b))
    kb = pkg["margot"].KnowledgeBase.from_dse(sampled.tune(sample=7, seed=3), ["a", "b"], ["m"])
    return results, path.read_text(), [(op.knobs, op.metrics) for op in kb.ops]


def test_lat_equals_reference(tmp_path):
    ref, port = _both(lambda pkg: _lat_explore(pkg, tmp_path))
    assert port == ref
    assert len(port[0]) == 6 and port[1].count("\n") == 7 and len(port[2]) == 7


def test_lat_reads_a_knob_space():
    from repro_torch.core.knob import Knob, KnobSpace

    lat = tdse.Lat("k").from_knob_space(KnobSpace([Knob("x", (1, 2, 3), 1)]))
    lat.add_metric("y", lambda x: 2.0 * x)
    assert [r["metrics"]["y"][0] for r in lat.tune()] == [2.0, 4.0, 6.0]


# -- the governed serve --------------------------------------------------------

_RNG = np.random.default_rng(7)
PROMPTS = [_RNG.integers(1, 50, (s,)).astype(np.int32) for s in (21, 5, 17, 9, 13, 6)]
ARRIVALS = [0, 0, 0, 0, 2, 4]
# SLOs on the analytic model's scale (reactive off: the Goals meet the
# modeled metrics alone), tight enough that the draft length moves with load
GOVERNED = dict(page_size=4, arrival_waves=ARRIVALS, slo_ttft_s=0.02, slo_tok_s=0.01,
                qos={"reselect_every": 1, "reactive": False, "draft_len": (0, 2, 4)})
SPEC_INTS = ("draft_len", "rounds", "request_rounds", "proposed", "accepted",
             "emitted_spec", "draft_steps", "verify_steps", "decode_steps", "target_steps")


@pytest.fixture(scope="module")
def pair():
    jsrv, tsrv = _servers("yi-6b", head_dim=64)
    jsrv.cfg.max_cache_len = tsrv.cfg.max_cache_len = 40
    return jsrv, tsrv


@pytest.fixture(scope="module")
def governed_reference(pair):
    jsrv, _ = pair
    toks = jsrv.serve_continuous(PROMPTS, **GOVERNED)
    return toks, jsrv.last_qos_stats, jsrv.last_spec_stats


def test_governed_serve_equals_reference(pair, governed_reference, monkeypatch):
    """Tokens, the operating points chosen and the speculative stats of a
    governed serve with a draft-length grid equal the reference's; the
    draft length falls to 0 under load and rises again, so the draft is
    replayed (`_draft_sync`) before a later verify round."""
    _, tsrv = pair
    want, want_qos, want_spec = governed_reference
    replays = []
    sync = tsrv._draft_sync

    def counted(draft_srv, dmanager, rids, active, outputs, lengths):
        before = sum(int(dmanager._meta[r]["length"]) for r in rids)
        sync(draft_srv, dmanager, rids, active, outputs, lengths)
        replays.append(sum(int(dmanager._meta[r]["length"]) for r in rids) - before)

    monkeypatch.setattr(tsrv, "_draft_sync", counted)
    got = tsrv.serve_continuous(PROMPTS, **GOVERNED)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    q = tsrv.last_qos_stats
    assert q["op_history"] == want_qos["op_history"]
    assert (q["switches"], q["distinct_ops"], q["waves"], q["tokens"]) == \
        (want_qos["switches"], want_qos["distinct_ops"], want_qos["waves"], want_qos["tokens"])
    assert {k: tsrv.last_spec_stats[k] for k in SPEC_INTS} == \
        {k: want_spec[k] for k in SPEC_INTS}
    ks = [h["knobs"]["draft_len"] for h in q["op_history"]]
    assert 0 in ks and ks[-1] > 0 and sum(replays) > 0
    assert all(o["status"] == "ok" for o in tsrv.last_outcomes)


def test_governed_serve_equals_ungoverned(pair):
    """Knob moves change scheduling only; every wave event carries the
    operating point in force, and a pool sized for the largest draft length
    passes its audits at every wave."""
    _, tsrv = pair
    base = tsrv.serve_continuous(PROMPTS, page_size=4, arrival_waves=ARRIVALS)
    assert tsrv.last_qos_stats is None
    events = []
    gen = tsrv.serve_stream(PROMPTS, pool_audit=True, **GOVERNED)
    while True:
        try:
            events.append(next(gen))
        except StopIteration as stop:
            out = stop.value
            break
    for a, b in zip(base, out):
        np.testing.assert_array_equal(a, b)
    waves = [e for e in events if e["event"] == "wave"]
    assert waves and all(set(e["op"]) == {"max_batch", "chunk", "k", "freq"} for e in waves)
    assert tsrv.last_fault_stats["audits"] >= len(waves) // 2
    assert {e["k"] for e in waves} >= {0} and max(e["k"] for e in waves) > 0


def test_qos_false_forces_off(pair):
    from repro_torch.core.strategies.qos import QoSAspect
    from repro_torch.core.weaver import weave

    _, tsrv = pair
    tsrv.serve_continuous(PROMPTS[:3], page_size=8, qos=False)
    assert tsrv.last_qos_stats is None
    woven = weave(tsrv.woven.program, [QoSAspect({"reselect_every": 2})])
    woven.state.policies = tsrv.woven.state.policies
    from repro_torch.runtime.server import Server

    srv = Server(woven, tsrv.cfg, params=tsrv.params)
    srv.serve_continuous(PROMPTS[:3], page_size=8, qos=False)
    assert srv.last_qos_stats is None


@pytest.mark.parametrize("how", ["aspect", "governor"])
def test_woven_qos_resolves(pair, how):
    """A woven QoSAspect (a policy, or a governor whose state persists
    across serves) governs `serve_continuous` with no argument; the tokens
    are the ungoverned serve's."""
    from repro_torch.core.strategies.qos import QoSAspect
    from repro_torch.core.weaver import weave
    from repro_torch.runtime.server import Server

    _, tsrv = pair
    gov = tqos.QoSGovernor({"reselect_every": 1}) if how == "governor" else None
    aspect = QoSAspect({"reselect_every": 2}, governor=gov, slo_tok_s=0.05)
    woven = weave(tsrv.woven.program, [aspect])
    woven.state.policies = tsrv.woven.state.policies
    srv = Server(woven, tsrv.cfg, params=tsrv.params)
    base = tsrv.serve_continuous(PROMPTS[:3], page_size=4)
    waves = []
    for _ in range(2 if gov else 1):
        out = srv.serve_continuous(PROMPTS[:3], page_size=4)
        for a, b in zip(base, out):
            np.testing.assert_array_equal(a, b)
        waves.append(srv.last_qos_stats["waves"])
    assert waves[0] > 0
    assert woven.state.extra["serve_qos"] == {"reselect_every": 2, "slo_tok_s": 0.05}
    if gov is not None:  # one governor, its ledger carried over both serves
        assert waves == [waves[0], 2 * waves[0]] == [waves[0], gov.waves]


# -- the slice's weave strategies ----------------------------------------------


def test_strategies_weave_as_the_reference_does(pair):
    from repro.core.strategies import memoization as jmemo
    from repro.core.strategies import powercap as jpow
    from repro.core.strategies import versioning as jver
    from repro.core.weaver import Weaver as JWeaver
    from repro_torch.core.strategies import memoization as tmemo
    from repro_torch.core.strategies import powercap as tpow
    from repro_torch.core.strategies import versioning as tver
    from repro_torch.core.weaver import Weaver as TWeaver

    jsrv, tsrv = pair

    def woven(weaver_cls, mods, program):
        memo, pow_, ver = mods
        weaver = weaver_cls(program)
        out = weaver.weave([
            pow_.PowerPriority(7),
            memo.MemoizeStep(tsize=16, approx_bits=4),
            ver.SpecializeCall("spec", {"cache_max_len": 16}, {"opt": 1}),
            ver.Multiversion("version", time_versions=False),
        ])
        variant = out.variant_state("spec")
        return {"priority": out.state.priority,
                "memo_size": out.state.extra["memo_table"].size,
                "wrappers": len(out.state.step_wrappers),
                "knob": (out.knobs["version"].values, out.knobs["version"].default),
                "variant_extra": (variant.extra["cache_max_len"],
                                  variant.extra["compile_options"]),
                "memoizable": memo.find_memoizable(weaver)}

    ref = woven(JWeaver, (jmemo, jpow, jver), jsrv.woven.program)
    port = woven(TWeaver, (tmemo, tpow, tver), tsrv.woven.program)
    assert port == ref and port["memoizable"]


def test_memoize_step_table_serves_the_server(pair):
    """The table `MemoizeStep` weaves is the server's memo table: a second
    identical serve hits it."""
    from repro_torch.core.strategies.memoization import MemoizeStep
    from repro_torch.core.weaver import weave
    from repro_torch.runtime.server import Server

    _, tsrv = pair
    woven = weave(tsrv.woven.program, [MemoizeStep(tsize=8)])
    woven.state.policies = tsrv.woven.state.policies
    srv = Server(woven, tsrv.cfg, params=tsrv.params)
    a = srv.serve_continuous(PROMPTS[:2], page_size=8)
    b = srv.serve_continuous(PROMPTS[:2], page_size=8)
    assert srv.memo is woven.state.extra["memo_table"] and srv.memo.hits == 1
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
