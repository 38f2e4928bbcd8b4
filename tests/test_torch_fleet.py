"""PyTorch port: the serving fleet (`runtime/fleet.py`, `launch/fleet.py`)
against the reference's (`tests/test_fleet.py::TestServingFleet`,
`TestFleetWeave`).

Both fleets serve the reduced yi-6b with the reference server's weights
carried across, policy `double`: every scenario — clean, a replica lost
mid-wave, a requested and an injected drain, routing faults, a fleet
deadline, an exhausted re-dispatch budget, affinity off — gives the
reference's per-request outcomes (status, replica, attempts, tokens), event
kinds, re-dispatch count, affinity hits and tokens.  The reference's runs
are computed once per module.  Inside the port: the fleet equals one
`Server`'s `serve_continuous`, replicas built by `replica_factory` share one
param tree, the fleet weave resolves, and both launchers serve on the CPU."""

import numpy as np
import pytest
import torch

from repro.runtime.fleet import ServingFleet as JFleet
from repro.runtime.server import Server as JServer
from repro.runtime.server import ServerConfig as JServerConfig
from repro.core.strategies.resilience import FaultInjector as JInjector
from repro.core.strategies.resilience import FaultSpec as JSpec
from repro_torch.core.strategies.resilience import (
    ALL_JOIN_POINTS,
    FLEET_JOIN_POINTS,
    JOIN_POINTS,
    FaultInjector,
    FaultSpec,
    FleetResilienceAspect,
)
from repro_torch.runtime.fleet import ServingFleet, _PollPreemption, replica_factory
from repro_torch.runtime.server import Server, ServerConfig

from _torch_fleet_cases import CFG, SCENARIOS, _fleet_prompts, _run
from test_torch_serve import _servers

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pair():
    return _servers("yi-6b")


@pytest.fixture(scope="module")
def reference(pair):
    """Every scenario on the reference fleet, once.  Its replicas share the
    first server's compiled steps (as one image's processes share a compile
    cache), which only saves compile time: the arithmetic is the same."""
    jsrv, _ = pair

    def make():
        srv = JServer(jsrv.woven, JServerConfig(**CFG))
        for name in ("prefill_vc", "decode_vc", "probe_vc", "paged_prefill_vc", "rescore_vc"):
            setattr(srv, name, getattr(jsrv, name))
        srv.params = jsrv.params
        return srv

    runs = {name: _run(JFleet, JInjector, JSpec, make, name) for name in SCENARIOS}
    runs["single"] = [np.asarray(o).tolist()
                      for o in make().serve_continuous(_fleet_prompts(), decode_tokens=4)]
    return runs


@pytest.fixture(scope="module")
def factory(pair):
    _, tsrv = pair
    return lambda: Server(tsrv.woven, ServerConfig(**CFG), params=tsrv.params)


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_fleet_scenario_equals_reference(reference, factory, name):
    got = _run(ServingFleet, FaultInjector, FaultSpec, factory, name)
    assert got == reference[name]


def test_fleet_scenarios_hold_the_reference_contract(reference, factory):
    """What tests/test_fleet.py asserts of each scenario, on the port's runs:
    full recovery, the loss / drain / spare events, the fleet equal to one
    server wherever every request completed."""
    runs = {name: _run(ServingFleet, FaultInjector, FaultSpec, factory, name)
            for name in ("clean", "kill_midwave", "drain_midwave", "deadline",
                         "retry_exhausted", "affinity_off")}
    single = Server(factory().woven, ServerConfig(**CFG), params=factory().params) \
        .serve_continuous(_fleet_prompts(), decode_tokens=4)
    assert [o.tolist() for o in single] == reference["single"]
    for name in ("clean", "kill_midwave", "drain_midwave", "affinity_off"):
        assert runs[name]["by_status"] == {"ok": 8}, name
        assert runs[name]["tokens"] == reference["single"], name
    assert runs["clean"]["events"] == [] and runs["clean"]["affinity_hits"] > 0
    assert len(runs["clean"]["prefix_hit_replicas"]) >= 2
    kinds = [k for k, _ in runs["kill_midwave"]["events"]]
    assert {"replica_loss", "declared_dead", "spare_in"} <= set(kinds)
    assert runs["kill_midwave"]["redispatched"] >= 1
    assert runs["kill_midwave"]["spares_left"] == 0
    assert ("drain", 0) in runs["drain_midwave"]["events"]
    assert runs["affinity_off"]["affinity_hits"] == 0
    assert runs["deadline"]["by_status"].get("deadline_exceeded", 0) >= 1
    assert runs["deadline"]["by_status"].get("ok", 0) >= 1
    assert runs["retry_exhausted"]["by_status"].get("failed", 0) >= 1


def test_replica_factory_shares_one_param_tree(pair):
    """Replicas and spares from one factory hold the first replica's
    tensors, not copies; each gets its own config."""
    _, tsrv = pair
    cfg = ServerConfig(**CFG)
    fleet = ServingFleet(replica_factory(tsrv.woven, cfg), replicas=2, spares=1)
    servers = [r.server for r in fleet.replicas] + [r.server for r in fleet.spares]
    for srv in servers[1:]:
        assert srv.params is servers[0].params
        assert srv.cfg is not servers[0].cfg and srv.cfg == cfg
    outs = fleet.serve(_fleet_prompts(4), decode_tokens=4)
    assert fleet.last_fleet_stats["outcomes"] == {"ok": 4} and len(outs) == 4


def test_join_point_split():
    assert set(FLEET_JOIN_POINTS) == {"route", "replica_loss", "drain"}
    assert not set(FLEET_JOIN_POINTS) & set(JOIN_POINTS)
    assert set(ALL_JOIN_POINTS) == set(JOIN_POINTS) | set(FLEET_JOIN_POINTS)


def test_fleet_specs_validate_and_fire():
    inj = FaultInjector([FaultSpec("replica_loss", "raise", at=1)])
    assert inj.fire("replica_loss", rid=0) is None
    with pytest.raises(Exception):
        inj.fire("replica_loss", rid=1)
    with pytest.raises(ValueError):
        FaultSpec("not_a_point", "raise")


def test_fleet_resolves_woven_policy_as_the_reference_does(pair):
    """A woven FleetResilienceAspect sets the fleet's policy and injector;
    explicit constructor arguments win; the resolved policy equals the
    reference fleet's for the same weave."""
    from repro.core.strategies.resilience import FleetResilienceAspect as JAspect
    from repro.core.weaver import weave as jweave
    from repro_torch.core.weaver import weave

    jsrv, tsrv = pair
    inj = FaultInjector()
    woven = weave(tsrv.woven.program, [FleetResilienceAspect(inj, retries=7, wave_size=2)])
    fleet = ServingFleet(lambda: Server(woven, ServerConfig(**CFG), params=tsrv.params),
                         replicas=1)
    assert fleet.policy["retries"] == 7 and fleet.policy["wave_size"] == 2
    assert fleet.injector is inj
    fleet2 = ServingFleet(lambda: Server(woven, ServerConfig(**CFG), params=tsrv.params),
                          replicas=1, retries=1)
    assert fleet2.policy["retries"] == 1

    jwoven = jweave(jsrv.woven.program, [JAspect(JInjector(), retries=7, wave_size=2)])
    jfleet = JFleet(lambda: JServer(jwoven, JServerConfig(**CFG)), replicas=1)
    assert fleet.policy == jfleet.policy


def test_poll_preemption_semantics():
    pre = _PollPreemption(after=1)
    assert pre.pending is False
    assert pre.pending is True and pre.pending is True


def test_launchers_serve_a_fleet_on_cpu(capsys):
    from repro_torch.launch import fleet as fleet_launcher
    from repro_torch.launch import serve as serve_launcher

    assert fleet_launcher.main(["--device", "cpu", "--kill-at", "1"]) == 0
    out = capsys.readouterr().out
    assert "outcomes: {'ok': 8}" in out and "replica_loss" in out and "spare_in" in out
    assert serve_launcher.main(["--device", "cpu", "--fleet", "2", "--requests", "3",
                                "--prompt-len", "6", "--decode-tokens", "3"]) == 0
    out = capsys.readouterr().out
    assert "fleet of 2: {'ok': 3}" in out and out.count(": ok ") == 3
