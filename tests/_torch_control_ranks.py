"""Rank bodies of `tests/test_torch_mesh_control.py`.  `run_on_mesh` spawns
each rank and imports this module there, so it imports the port and torch
only; every function takes the rank's live mesh last and returns host
values (rank 0's reach the test), most of them each rank's, gathered."""

import time

import numpy as np
import torch.distributed as dist

from repro_torch.configs.base import SHAPES
from repro_torch.convert import load_jax_params
from repro_torch.core.program import Program
from repro_torch.distributed.fault import PreemptionHandler
from repro_torch.distributed.sharding import local_shard, param_shardings, tree_shards
from repro_torch.launch.weave import cuda_kernel_aspects, default_weave
from repro_torch.models.registry import build_model, reduced_config
from repro_torch.nn.dtypes import PolicyResolver
from repro_torch.nn.module import init_params

from _torch_fleet_cases import CFG, SCENARIOS, _fleet_prompts, _run

# the weave and server of tests/test_torch_serve.py's `_servers` (policy
# `double`), at tests/test_torch_qos.py's cache length
OVERRIDES = {"flash_block_q": 32, "flash_block_kv": 32, "flash_block_kv_dec": 16}
SERVE = {"max_cache_len": 40, "decode_tokens": 4}
FAST = 20.0  # how fast rank 1's clock runs in the reactive run


def woven(mesh_axes, head_dim=64, aspects=()):
    """Reduced yi-6b (head_dim 64: the kernels' plain versions run; None: the
    reduced 16), every kernel aspect, `double`, the layout AutoShard picks
    for `mesh_axes`."""
    cfg = reduced_config("yi-6b")
    if head_dim:
        cfg = cfg.replace(head_dim=head_dim)
    program = Program(model=build_model(cfg), cfg=cfg, kind="serve", device="cpu")
    w = default_weave(program, SHAPES["prefill_32k"], dict(mesh_axes),
                      overrides={"tuned_kernels": False, **OVERRIDES},
                      extra_aspects=[*aspects, *cuda_kernel_aspects()])
    w.state.policies = PolicyResolver.default("double")
    return w


def rank_params(w, np_params, mesh):
    """This rank's blocks of the reference's weights (all of them off a
    mesh)."""
    init_params(w.program.model, 0, w.state.policies, "cpu")
    whole = load_jax_params(w.program.model, np_params)
    if mesh is None:
        return whole
    return tree_shards(whole, param_shardings(w.program.model, mesh, w.state.rules),
                       local_shard)


def server(w, params, mesh, **cfg):
    from repro_torch.runtime.server import Server, ServerConfig

    return Server(w, ServerConfig(**{**SERVE, **cfg}), mesh=mesh, device="cpu",
                  params=params)


def every_rank(obj, mesh) -> list:
    out = [None] * mesh.size
    dist.all_gather_object(out, obj)
    return out


def served(srv, prompts, **kw) -> dict:
    """`serve_continuous` of `prompts`: the tokens, the governor's, spec and
    fault stats, the step counts, the outcomes, the events but their
    clock stamps, and each wave's operating point, draft length and
    latency on this rank's clock."""
    events = []
    toks = srv.serve_continuous(prompts, on_event=events.append, **kw)
    waves = [e for e in events if e["event"] == "wave"]
    return {"tokens": [list(map(int, t)) for t in toks],
            "qos": srv.last_qos_stats, "spec": srv.last_spec_stats,
            "steps": dict(srv.last_step_counts),
            "outcomes": [o["status"] for o in srv.last_outcomes],
            "events": [{k: v for k, v in e.items() if k not in ("t", "dt_s")}
                       for e in events],
            "ops": [(e["wave"], e["op"], e["k"]) for e in waves],
            "dt_s": [e["dt_s"] for e in waves]}


class FastClock:
    """The `time` module as a server reads it on a rank whose clock runs
    `FAST` times fast: the ranks step in lockstep (each waits for the other
    in every collective), so a rank's own clock reads otherwise only if it
    runs at another rate."""

    def __init__(self):
        self.t0 = time.perf_counter()

    def perf_counter(self) -> float:
        return self.t0 + FAST * (time.perf_counter() - self.t0)

    def monotonic(self) -> float:
        return self.perf_counter()

    def sleep(self, s: float) -> None:
        time.sleep(s)


class RankPreemption(PreemptionHandler):
    """A SIGTERM that reaches rank `rank` alone: its `pending` turns true
    there after `after` polls; every rank counts its polls."""

    def __init__(self, rank, after, mesh):
        super().__init__(install=False)
        self.mine, self.after, self.polls = mesh.rank == rank, after, 0

    @property
    def pending(self) -> bool:
        self.polls += 1
        if self.mine and self.polls > self.after:
            self.request()
        return self.requested.is_set()


# -- the governor --------------------------------------------------------------------


def governed(np_params, prompts, kw, mesh):
    """`prompts` ungoverned and under `kw`'s governor on this rank."""
    w = woven(mesh.shape)
    srv = server(w, rank_params(w, np_params, mesh), mesh)
    plain = {k: kw[k] for k in ("page_size", "arrival_waves")}
    return every_rank({"plain": served(srv, prompts, **plain),
                       "governed": served(srv, prompts, **kw)}, mesh), srv


def governor(np_params, prompts, kw, mesh):
    """`governed` alone (the (2, 2) mesh's spawn)."""
    return governed(np_params, prompts, kw, mesh)[0]


def control(np_params, prompts, kw, runs, tuner_path, mesh):
    """The (1, 2) mesh's spawn: `governed`, then `runs` ({tag: (qos policy,
    the serve's other options)}; tag "reactive" is served with rank 1's
    clock running `FAST` times fast), the woven governor, the drain and the
    tuner's feedback."""
    from repro_torch.core.strategies.qos import QoSAspect
    from repro_torch.runtime import server as server_mod

    ranks, srv = governed(np_params, prompts, kw, mesh)
    out = {"governed": ranks}
    plain = {k: kw[k] for k in ("page_size", "arrival_waves")}
    for tag, (qos, extra) in runs.items():
        if tag == "reactive" and mesh.rank == 1:
            server_mod.time = FastClock()
        try:
            out[tag] = every_rank(served(srv, prompts, qos=qos, **plain, **extra), mesh)
        finally:
            server_mod.time = time
    aspect = QoSAspect({"reselect_every": 2}, slo_tok_s=0.05)
    w = woven(mesh.shape, aspects=[aspect])
    wsrv = server(w, srv.params, mesh)
    out["woven"] = every_rank({"plain": served(srv, prompts[:3], page_size=4),
                               "woven": served(wsrv, prompts[:3], page_size=4),
                               "serve_qos": w.state.extra["serve_qos"]}, mesh)
    out["drain"] = {rank: drain(srv, prompts, plain, rank, mesh) for rank in (0, 1)}
    out["tuner"] = tuner(srv, prompts, tuner_path, mesh)
    out["memo"] = memo_overrun(srv.params, prompts[:3], mesh)
    return out


# -- the memo table after a watchdog overrun on one rank -------------------------------

# `step_deadline_s` by rank: rank 1's decode steps, slowed past its deadline
# (`SLOW_S` after each), overrun it; rank 0's never do
DEADLINES = (60.0, 0.01)
SLOW_S = 0.05


def memo_overrun(params, prompts, mesh):
    """A server with a memo table serves `prompts` with rank 1's watchdog
    firing on its decode steps alone, then serves them again: each rank's
    watchdog timeouts, the keys its table holds after the first serve, and
    its own hits and misses after the second."""
    from repro_torch.memo.table import MemoTable

    w = woven(mesh.shape)
    w.state.extra["serve_resilience"] = {"step_deadline_s": DEADLINES[mesh.rank]}
    srv = server(w, params, mesh)
    srv.memo = MemoTable()
    real = srv.decode_vc

    def slowed(*a, **k):
        out = real(*a, **k)
        time.sleep(SLOW_S)
        return out

    if mesh.rank == 1:
        srv.decode_vc = slowed
    first = srv.serve_continuous(prompts, page_size=8)
    fired = (srv.last_fault_stats["watchdog_timeouts"],
             [a["kind"] for a in srv.last_fault_stats["actions"]])
    keys = sorted(srv.memo._data)
    srv.decode_vc = real
    second = srv.serve_continuous(prompts, page_size=8)
    return every_rank({"fired": fired, "keys": keys, "hits": srv.memo.hits,
                       "misses": srv.memo.misses,
                       "same": [list(map(int, t)) for t in first]
                       == [list(map(int, t)) for t in second]}, mesh)


# -- the drain ----------------------------------------------------------------------


def drain(srv, prompts, plain, rank, mesh):
    """`prompts` at their arrival waves, two at a time, with a preemption
    that reaches rank `rank` alone after three polls: each rank's
    outcomes, the waves its `drained` outcomes came at and its polls."""
    pre = RankPreemption(rank, 3, mesh)
    run = served(srv, prompts, preemption=pre, max_batch=2, **plain)
    drained = [(e["rid"], e["wave"]) for e in run["events"]
               if e["event"] == "outcome" and e["status"] == "drained"]
    return every_rank({"outcomes": run["outcomes"], "tokens": run["tokens"],
                       "drained": drained, "polls": pre.polls}, mesh)


# -- the tuner's feedback -------------------------------------------------------------


def seed_rows(tuner, sig, knob, values, extra=None):
    """One row a value of `knob` at `sig`, every row 1 ms and under the
    shared-memory budget (`tests/test_torch_continuous.py`'s rows)."""
    ops = [{"knobs": {knob: v}, "metrics": {"latency_s": [1e-3, 0.0], "smem_bytes": [1.0, 0.0],
                                            **(extra(v) if extra else {})}}
           for v in values]
    tuner.cache.put(tuner._key(sig), {"knobs": dict(ops[1]["knobs"]),
                                      "metrics": dict(ops[1]["metrics"]), "ops": ops})


def tuner(srv, prompts, path, mesh):
    """`refine_kernel_tuner` after a plain serve and `refine_speculative`
    after a self-drafted one, every rank with a tuner over the file at
    `path` (rank 0 seeds the rows first): each rank's knobs, the cache
    writes its refine made and its own observations."""
    from repro_torch.autotune import kernel_tuner as kt

    out = {}
    for kind in ("paged", "speculative"):
        tn = kt.KernelTuner(path, device="cpu")
        if kind == "paged":
            srv.serve_continuous(prompts, page_size=8)
            lat = srv._step_lat_by_batch
            batch = max(lat, key=lambda b: len(lat[b]))
            observed = {"latency_s": float(np.mean(lat[batch]))}
            sig = srv._paged_signature(batch=batch, dtype=srv._paged_dtype)
            seed = (tn, sig, "page_size", (8, 16, 32))
        else:
            srv.serve_continuous(prompts, page_size=8, draft_len=2)
            st = srv.last_spec_stats
            batch = max(1, round(st["request_rounds"] / max(st["rounds"], 1)))
            observed = {"tokens_per_step": float(st["mean_tokens_per_verify"]),
                        "latency_s": float(st["verify_latency_s"])}
            cfg = srv.woven.program.cfg
            sig = kt.speculative_signature(batch, srv.cfg.max_cache_len, cfg.n_heads,
                                           cfg.kv_heads, cfg.resolved_head_dim,
                                           srv._paged_dtype)
            seed = (tn, sig, "draft_len", (1, 2, 4),
                    lambda v: {"tokens_per_step": [float(v + 1), 0.0]})
        if mesh.rank == 0:
            seed_rows(*seed)
        dist.barrier()
        puts = []
        put = tn.cache.put
        tn.cache.put = lambda key, entry: (puts.append(key), put(key, entry))
        refine = srv.refine_kernel_tuner if kind == "paged" else srv.refine_speculative
        knobs = refine(latency_budget=10.0, tuner=tn)
        out[kind] = every_rank({"knobs": knobs, "puts": len(puts), "observed": observed,
                                "key": tn._key(sig)}, mesh)
    return out


# -- the fleet ----------------------------------------------------------------------


def fleet(np_params, mesh):
    """Every scenario of `SCENARIOS` on a fleet of this rank's replicas
    (`replica_factory` over the rank's shards), one meshed server's
    `serve_continuous` of the same prompts, and a fleet whose replica is
    lost, its spare swapped in: whether every replica and spare holds the
    one shard tree the factory was given; and a fleet of a meshed and an
    unmeshed replica, refused."""
    from repro_torch.core.strategies.resilience import FaultInjector, FaultSpec
    from repro_torch.runtime.fleet import ServingFleet, replica_factory
    from repro_torch.runtime.server import ServerConfig

    w = woven(mesh.shape, head_dim=None)
    params = rank_params(w, np_params, mesh)
    factory = replica_factory(w, ServerConfig(**CFG), params=params, mesh=mesh)
    out = {name: every_rank(_run(ServingFleet, FaultInjector, FaultSpec, factory, name), mesh)
           for name in SCENARIOS}
    single = factory().serve_continuous(_fleet_prompts(), decode_tokens=4)
    out["single"] = every_rank([list(map(int, o)) for o in single], mesh)
    lossy = ServingFleet(factory, replicas=2, spares=1, wave_size=3,
                         injector=FaultInjector([FaultSpec("replica_loss", "raise", at=1)]))
    lossy.serve(_fleet_prompts(), decode_tokens=4)
    servers = [r.server for r in lossy.replicas] + [r.server for r in lossy.spares]
    out["sharing"] = every_rank({
        "shared": all(s.params is params for s in servers),
        "servers": len(servers),
        "events": [e["kind"] for e in lossy.last_fleet_stats["events"]],
        "wq_shape": tuple(params["blocks0"]["block"]["attn"]["wq"].shape)}, mesh)
    mixed = iter([factory(), server(woven({}, head_dim=None), None, None, **CFG)])
    try:
        ServingFleet(lambda: next(mixed), replicas=2)
        out["mixed"] = "did not raise"
    except ValueError as e:
        out["mixed"] = f"ValueError: {e}"
    return out
