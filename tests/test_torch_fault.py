"""PyTorch port, `distributed/fault.FleetSim` against the reference's: a
simulated data-parallel fleet driven through the same failures, restarts
and stragglers in both packages (twin of `tests/test_substrate.py::
TestFaultTolerance::test_fleet_sim_failure_and_straggler`), with the same
tick outcomes, failure log and hot-spare replacements."""

import pytest

from repro.distributed.fault import FleetSim as JFleetSim
from repro.monitor.examon import ExamonBroker as JBroker
from repro_torch.distributed.fault import FleetSim
from repro_torch.monitor.examon import ExamonBroker


def _drive(sim, fail_host, straggler, slowdown):
    """The reference test's script: three clean ticks, a failure (the step
    is lost), the restarted worker's tick, then six ticks with a straggler."""
    outcomes = [sim.tick() for _ in range(3)]
    sim.inject_failure(fail_host)
    outcomes += [sim.tick(), sim.tick()]
    sim.inject_straggler(straggler, slowdown=slowdown)
    outcomes += [sim.tick() for _ in range(6)]
    return outcomes


def test_fleet_sim_failure_and_straggler():
    """The reference test's assertions, on the port's `FleetSim`."""
    sim = FleetSim(4, ExamonBroker())
    outcomes = _drive(sim, 1, 3, 6.0)
    assert all(outcomes[:3])
    assert outcomes[3] is False  # global step lost
    assert outcomes[4] is True  # worker restarted
    assert 3 in sim.replacements
    assert sim.failures == [1]


@pytest.mark.parametrize("hosts,fail_host,straggler,slowdown", [
    (4, 1, 3, 6.0), (4, 0, 0, 4.0), (8, 5, 2, 3.0), (2, 1, 0, 1.5)])
def test_fleet_sim_matches_the_reference(hosts, fail_host, straggler, slowdown):
    """The same script on both fleets: the same outcomes, failures,
    replacements and worker speeds."""
    ours, theirs = FleetSim(hosts, ExamonBroker()), JFleetSim(hosts, JBroker())
    got = _drive(ours, fail_host, straggler, slowdown)
    want = _drive(theirs, fail_host, straggler, slowdown)
    assert got == want
    assert ours.failures == theirs.failures == [fail_host]
    assert ours.replacements == theirs.replacements
    assert [w.speed for w in ours.workers] == [w.speed for w in theirs.workers]
    assert [w.alive for w in ours.workers] == [w.alive for w in theirs.workers]
