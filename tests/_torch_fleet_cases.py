"""The serving fleet's scenarios, shared by `tests/test_torch_fleet.py` (both
packages' fleets on one device) and `tests/_torch_control_ranks.py` (the
port's fleet on each rank of a live mesh).  Numpy only: a spawned rank
imports it, and the fleet, injector and spec classes are the caller's."""

import numpy as np

CFG = dict(max_cache_len=24, decode_tokens=4, max_batch=2, page_size=8)


def _fleet_prompts(n=8, shared=8, tail=3, seed=0):
    """A shared-system-prompt workload: every prompt opens with the same
    `shared` tokens (page-aligned at page_size=8), distinct tails."""
    rng = np.random.default_rng(seed)
    sys_prompt = rng.integers(1, 90, shared)
    return [np.concatenate([sys_prompt, rng.integers(1, 90, tail)]).astype(np.int64)
            for _ in range(n)]


# name -> (fleet kwargs, fault specs as (point, kind, at, repeat), drain host, prompts)
SCENARIOS = {
    "clean": (dict(replicas=2, wave_size=3), [], None, 8),
    "kill_midwave": (dict(replicas=2, spares=1, wave_size=3),
                     [("replica_loss", "raise", 1, 1)], None, 8),
    "drain_midwave": (dict(replicas=2, spares=1, wave_size=4), [], 0, 8),
    "injected_drain": (dict(replicas=2, wave_size=4), [("drain", "raise", 0, 1)], None, 8),
    "route_fault": (dict(replicas=2, wave_size=3), [("route", "raise", 0, 3)], None, 8),
    "deadline": (dict(replicas=2, wave_size=3, deadline_s=0.0),
                 [("replica_loss", "raise", 1, 1)], None, 8),
    "retry_exhausted": (dict(replicas=1, wave_size=2, retries=1, kill_step=0),
                        [("replica_loss", "raise", 0, 64)], None, 2),
    "affinity_off": (dict(replicas=2, wave_size=3, affinity=False), [], None, 8),
}


def _run(fleet_cls, inj_cls, spec_cls, factory, name):
    kw, specs, drain, n = SCENARIOS[name]
    inj = inj_cls([spec_cls(p, k, at=at, repeat=rep) for p, k, at, rep in specs]) \
        if specs else None
    fleet = fleet_cls(factory, injector=inj, **kw)
    if drain is not None:
        fleet.request_drain(drain)
    outs = fleet.serve(_fleet_prompts(n), decode_tokens=4)
    st = fleet.last_fleet_stats
    return {
        "tokens": [np.asarray(o).tolist() for o in outs],
        "outcomes": [{k: o[k] for k in ("status", "replica", "attempts", "tokens")}
                     for o in fleet.last_outcomes],
        "by_status": st["outcomes"],
        "events": [(e["kind"], e.get("host")) for e in st["events"]],
        "injected": [e["point"] for e in st["injected_events"]],
        "redispatched": st["redispatched"],
        "affinity_hits": st["affinity_hits"],
        "prefix_hit_replicas": st["replicas_with_prefix_hits"],
        "spares_left": st["spares_left"],
    }
