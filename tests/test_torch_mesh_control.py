"""PyTorch port on a live mesh: the serving control plane.  Gloo ranks on the
CPU (`run_on_mesh`, one thread each) run the port's servers and fleets,
each rank on its shard, held against the reference on the same numpy
weights and inputs, and against rank 0.  Every host decision is rank 0's.

(a) the QoS governor: `tests/test_torch_qos.py`'s `GOVERNED` serve
(planned, a draft-length grid, arrivals) of reduced yi-6b at head_dim 64 on
(1, 2) and (2, 2) gives the reference's tokens, `op_history`, switches,
distinct operating points, waves and speculative counts, bit for bit the
ungoverned meshed serve's tokens, and on every rank rank 0's operating
points, events and stats; in reactive mode, with rank 1's clock running
fast so that its own waves read otherwise, every rank still takes rank 0's
operating points; a modeled power cap brings `freq` below 1, as the
unmeshed port's governor does; a woven `QoSAspect` resolves.  (b) the
fleet: every scenario of `tests/test_torch_fleet.py` (`_torch_fleet_cases`)
on replicas of a (1, 2) mesh gives the reference's outcomes, events and
tokens on every rank, the clean fleet one meshed server's tokens, and
`replica_factory` hands every replica and spare one tree of the rank's
shards.  (c) the drain: a preemption that reaches one rank only drains every
rank alike, by rank 0's reading.  (d) the tuner's feedback: a refine writes
the cache once, from rank 0's observation, and every rank returns rank 0's
knobs.  (e) the memo table: a watchdog overrun on one rank alone leaves
every rank's table holding the same keys (the store is rank 0's
decision), and a repeat of the serve hits on every rank.  The rank bodies are in `_torch_control_ranks.py`."""

import functools
import json

import numpy as np
import pytest
import torch

import _torch_control_ranks as ranks
from _torch_fleet_cases import CFG, SCENARIOS, _fleet_prompts, _run
from repro_torch.launch.mesh import run_on_mesh
from test_torch_qos import ARRIVALS, GOVERNED, PROMPTS, SPEC_INTS

torch.set_num_threads(1)

TIMEOUT_S = 120
MESHES = [(1, 2), (2, 2)]
PLAIN = {"page_size": GOVERNED["page_size"], "arrival_waves": ARRIVALS}
SLOS = {"slo_ttft_s": GOVERNED["slo_ttft_s"], "slo_tok_s": GOVERNED["slo_tok_s"]}
# `chip_smoke.py`'s QOS_POWER: a modeled 350 W node budget, `freq` governed
POWER = {"reselect_every": 1, "reactive": False, "draft_len": (0, 2, 4),
         "power_cap_w": 350.0, "freq": (0.5, 0.75, 1.0)}
RUNS = {"power": (POWER, {}),
        "reactive": ({**GOVERNED["qos"], "reactive": True}, SLOS)}


def on_mesh(fn, shape):
    return run_on_mesh(fn, shape, backend="gloo", device="cpu", threads=1,
                       timeout_s=TIMEOUT_S)


def _shape_id(shape):
    return f"{shape[0]}x{shape[1]}"


@pytest.fixture(scope="module")
def reference():
    """The reference's weights as numpy and its `GOVERNED` serve."""
    from _torch_port import np_tree
    from test_torch_serve import _servers

    jsrv, _ = _servers("yi-6b", head_dim=64)
    jsrv.cfg.max_cache_len = ranks.SERVE["max_cache_len"]
    toks = jsrv.serve_continuous(PROMPTS, **GOVERNED)
    return np_tree(jsrv.params), {"tokens": [list(map(int, t)) for t in toks],
                                  "qos": jsrv.last_qos_stats, "spec": jsrv.last_spec_stats}


@pytest.fixture(scope="module")
def control(reference, tmp_path_factory):
    path = tmp_path_factory.mktemp("tuner") / "tuner.json"
    got = on_mesh(functools.partial(ranks.control, reference[0], PROMPTS, GOVERNED, RUNS,
                                    str(path)), (1, 2))
    return got, path


@pytest.fixture(scope="module")
def governed(reference, control):
    """{mesh shape: each rank's ungoverned and governed serves}."""
    return {(1, 2): control[0]["governed"],
            (2, 2): on_mesh(functools.partial(ranks.governor, reference[0], PROMPTS,
                                              GOVERNED), (2, 2))}


# -- (a) the QoS governor ---------------------------------------------------------------


@pytest.mark.parametrize("shape", MESHES, ids=_shape_id)
def test_a_governed_serve_on_the_mesh_equals_the_reference(reference, governed, shape):
    _, want = reference
    for r in governed[shape]:
        got = r["governed"]
        assert got["tokens"] == want["tokens"]
        assert got["outcomes"] == ["ok"] * len(PROMPTS)
        q, wq = got["qos"], want["qos"]
        assert q["op_history"] == wq["op_history"]
        assert (q["switches"], q["distinct_ops"], q["waves"], q["tokens"]) == \
            (wq["switches"], wq["distinct_ops"], wq["waves"], wq["tokens"])
        assert {k: got["spec"][k] for k in SPEC_INTS} == {k: want["spec"][k] for k in SPEC_INTS}


@pytest.mark.parametrize("shape", MESHES, ids=_shape_id)
def test_a_governed_serve_on_the_mesh_is_the_ungoverned_one(governed, shape):
    for r in governed[shape]:
        assert r["plain"]["qos"] is None
        assert r["governed"]["tokens"] == r["plain"]["tokens"]


@pytest.mark.parametrize("shape", MESHES, ids=_shape_id)
def test_a_every_rank_takes_rank_zeros_operating_points(governed, shape):
    """One broadcast a re-selection: the operating point in force at every
    wave, the events, the step counts and the governor's stats are rank
    0's on every rank; the draft length falls to 0 and rises again."""
    runs = [r["governed"] for r in governed[shape]]
    for got in runs[1:]:
        for key in ("ops", "events", "steps", "qos", "tokens"):
            assert got[key] == runs[0][key], key
    ks = [h["knobs"]["draft_len"] for h in runs[0]["qos"]["op_history"]]
    assert 0 in ks and ks[-1] > 0
    assert {k for _, _, k in runs[0]["ops"]} >= {0} and max(k for _, _, k in runs[0]["ops"]) > 0


def test_a_reactive_mode_follows_rank_zeros_clock(control):
    """Rank 1's clock runs `FAST` times fast, so its own waves read far
    longer than rank 0's (the ranks step in lockstep); every rank still
    takes rank 0's operating points, and the tokens are the ungoverned
    serve's."""
    got, _ = control
    zero, one = got["reactive"]
    assert np.mean(one["dt_s"]) > ranks.FAST / 4 * np.mean(zero["dt_s"])
    assert zero["qos"]["waves"] > 0 and zero["qos"]["op_history"]
    for key in ("ops", "qos", "events", "steps", "tokens", "outcomes"):
        assert one[key] == zero[key], key
    assert zero["tokens"] == got["governed"][0]["plain"]["tokens"]


def test_a_power_cap_lowers_freq_as_on_one_device(reference, control):
    """`POWER`'s governor on the mesh and on the unmeshed port over the same
    weights: the same operating points; `freq` below 1 in force at some
    wave; the capper's modeled snapshot rank 0's on every rank."""
    got, _ = control
    runs = got["power"]
    w = ranks.woven({})
    one = ranks.served(ranks.server(w, ranks.rank_params(w, reference[0], None), None),
                       PROMPTS, qos=POWER, **PLAIN)
    for r in runs:
        assert r["outcomes"] == ["ok"] * len(PROMPTS)
        assert min(op["freq"] for _, op, _ in r["ops"]) < 1.0
        assert r["qos"] == runs[0]["qos"] and r["ops"] == runs[0]["ops"]
        assert r["tokens"] == one["tokens"]
    assert runs[0]["qos"]["op_history"] == one["qos"]["op_history"]
    assert runs[0]["ops"] == one["ops"]
    assert runs[0]["qos"]["power"] is not None


def test_a_woven_governor_resolves_on_the_mesh(control):
    got, _ = control
    for r in got["woven"]:
        assert r["serve_qos"] == {"reselect_every": 2, "slo_tok_s": 0.05}
        assert r["woven"]["qos"]["waves"] > 0 and r["plain"]["qos"] is None
        assert r["woven"]["tokens"] == r["plain"]["tokens"]
        assert r["woven"]["qos"] == got["woven"][0]["woven"]["qos"]


# -- (b) the fleet -------------------------------------------------------------------------


@pytest.fixture(scope="module")
def fleet_reference():
    """Every scenario on the reference fleet (as `tests/test_torch_fleet.py`
    runs it) and one reference server's serve, and the weights as numpy."""
    from _torch_port import np_tree
    from repro.core.strategies.resilience import FaultInjector as JInjector
    from repro.core.strategies.resilience import FaultSpec as JSpec
    from repro.runtime.fleet import ServingFleet as JFleet
    from repro.runtime.server import Server as JServer
    from repro.runtime.server import ServerConfig as JServerConfig
    from test_torch_serve import _servers

    jsrv, _ = _servers("yi-6b")

    def make():
        srv = JServer(jsrv.woven, JServerConfig(**CFG))
        for name in ("prefill_vc", "decode_vc", "probe_vc", "paged_prefill_vc", "rescore_vc"):
            setattr(srv, name, getattr(jsrv, name))
        srv.params = jsrv.params
        return srv

    runs = {name: _run(JFleet, JInjector, JSpec, make, name) for name in SCENARIOS}
    runs["single"] = [list(map(int, o))
                      for o in make().serve_continuous(_fleet_prompts(), decode_tokens=4)]
    return np_tree(jsrv.params), runs


@pytest.fixture(scope="module")
def fleet_runs(fleet_reference):
    return on_mesh(functools.partial(ranks.fleet, fleet_reference[0]), (1, 2))


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_b_fleet_scenario_on_the_mesh_equals_the_reference(fleet_reference, fleet_runs, name):
    _, want = fleet_reference
    got = fleet_runs[name]
    assert len(got) == 2
    for r in got:
        assert r == want[name]


def test_b_the_meshed_fleet_is_one_meshed_server(fleet_reference, fleet_runs):
    _, want = fleet_reference
    for r in fleet_runs["single"]:
        assert r == want["single"]
    assert fleet_runs["clean"][0]["tokens"] == want["single"]
    assert fleet_runs["clean"][0]["by_status"] == {"ok": 8}


def test_b_replica_factory_shares_one_shard_tree_on_the_mesh(fleet_runs):
    """Two replicas and a spare swapped in after a loss hold the tree of the
    rank's shards the factory was given: wq's heads split over `model`."""
    for r in fleet_runs["sharing"]:
        assert r["shared"] and r["servers"] == 3
        assert {"replica_loss", "declared_dead", "spare_in"} <= set(r["events"])
        assert r["wq_shape"] == (2, 64, 32)


def test_b_a_fleet_across_meshes_is_refused(fleet_runs):
    """A replica off the fleet's live mesh would step out of its lockstep."""
    assert fleet_runs["mixed"].startswith("ValueError: the replicas of a fleet on a live "
                                          "mesh must all be on that mesh"), fleet_runs["mixed"]


# -- (c) the drain ------------------------------------------------------------------------


@pytest.mark.parametrize("rank", [0, 1], ids=["reaches_rank0", "reaches_rank1"])
def test_c_a_preemption_seen_by_one_rank_drains_every_rank_alike(control, rank):
    """Every rank polls its own handler as often as the others (a counting
    poller keeps one count) and takes rank 0's reading: a preemption that
    reaches rank 0 drains the same requests at the same waves on every rank;
    one that reaches rank 1 alone drains none.  The run ends either way."""
    got, _ = control
    runs = got["drain"][rank]
    for r in runs:
        assert r == runs[0]
    drained = runs[0]["drained"]
    if rank == 0:
        assert drained and "ok" in runs[0]["outcomes"]
        assert runs[0]["outcomes"].count("drained") == len(drained)
    else:
        assert not drained and runs[0]["outcomes"] == ["ok"] * len(PROMPTS)


# -- (d) the tuner's feedback ----------------------------------------------------------------


@pytest.mark.parametrize("kind,want", [("paged", {"page_size": 32}),
                                       ("speculative", {"draft_len": 4})])
def test_d_refine_writes_once_and_gives_rank_zeros_knobs(control, kind, want):
    """Rank 0 refines from its own observation and writes the cache; every
    rank returns its knobs (the seeded rows' largest knob, all of them within
    the budget)."""
    got, path = control
    runs = got["tuner"][kind]
    assert [r["puts"] for r in runs] == [1, 0]
    assert all(r["knobs"] == want for r in runs)
    entry = json.loads(path.read_text())[runs[0]["key"]]
    assert entry["runtime"]["observed"] == runs[0]["observed"]


# -- (e) the memo table ------------------------------------------------------------------


def test_e_the_memo_tables_stay_equal_after_a_watchdog_overrun_on_one_rank(control):
    """Rank 1's decode steps overrun its `step_deadline_s`, rank 0's do not:
    the overrun is recorded on rank 1 alone, yet both ranks store the
    result (rank 0's reading of a clean serve), so their tables hold the
    same keys and the repeat hits each rank's own table."""
    zero, one = control[0]["memo"]
    assert zero["fired"] == (0, [])
    assert one["fired"][0] > 0 and set(one["fired"][1]) == {"watchdog_overrun"}
    assert len(zero["keys"]) == 1 and one["keys"] == zero["keys"]
    for r in (zero, one):
        assert (r["hits"], r["misses"]) == (1, 1) and r["same"]
