"""Fault-tolerant multi-replica serving fleet.

One host caps out fast at millions of users; the fleet layer places N
`Server` replicas and treats each replica's `serve_continuous` as a unit
that degrades into structured per-request outcomes instead of dying.  The extra-functional concerns live here, one level up
from the server, and are woven (FleetResilienceAspect) rather than
hard-coded:

  routing       prefix-affinity first — a request whose prompt shares
                blake2b page-boundary digests (`runtime/pages._prefix_digests`)
                with prompts a replica already served routes there, so the
                prefix cache composes across the fleet; least-loaded
                otherwise.  `wave_size` caps a replica's per-round intake,
                so hot prefixes spill and warm a second replica.
  replica loss  replicas publish `fleet/heartbeat/@host<i>` step beats;
                a fleet-level `HeartbeatMonitor` (same logical round
                clock on both sides) declares a silent replica dead, and
                every incomplete request it held re-dispatches to
                survivors — completed outputs are kept, only incomplete
                work replays, with bounded retry + doubling backoff and a
                per-request fleet deadline retiring overdue requests with
                partial output as `deadline_exceeded`.
  graceful drain SIGTERM (PreemptionHandler semantics) stops a replica's
                admissions mid-wave: in-flight requests finish, the
                undrained remainder hands off to peers, a hot spare swaps
                into the slot.
  fault weave   the `FaultInjector` fleet join points (`route`,
                `replica_loss`, `drain`) schedule deterministic kill /
                drain / routing faults, so a kill-a-replica-mid-wave
                scenario can be held to 100% recovery with survivor
                parity against a single-server baseline.

Replica death is simulated deterministically: a wave whose `replica_loss`
join point fires runs with an internal chaos injector that raises at
every decode step past `kill_step`, exhausting the server's retry budget
— the server's step-abort path then returns completed requests as `ok`
(kept) and in-flight ones as `failed` with partial output, exactly the
structured-outcome contract the re-dispatch consumes.

Every replica is a `Server` over one woven program; a factory made by
`replica_factory` hands each replica the first one's param tree, so the
fleet holds one copy of the weights and one page pool per replica (each
`serve_continuous` allocates its own).  On a live mesh every rank runs the
same fleet in lockstep over replicas on that mesh, each holding this
rank's shards (one copy of them, shared as on one card): the routing, the
heartbeats on the round clock, the straggler demotion, the injected faults
and the re-dispatches are the same on every rank by construction, and what
reads a clock or a signal — the fleet deadline, a replica's drain — is
rank 0's reading, broadcast.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Callable

import numpy as np

from repro_torch.core.strategies.resilience import (
    DEFAULT_FLEET_POLICY,
    FaultError,
    FaultInjector,
    FaultSpec,
)
from repro_torch.distributed.collectives import broadcast_object
from repro_torch.distributed.fault import HeartbeatMonitor
from repro_torch.monitor.examon import ExamonBroker
from repro_torch.runtime.pages import PoolExhausted, _prefix_digests
from repro_torch.launch.mesh import is_live
from repro_torch.runtime.server import Server


def replica_factory(woven, cfg, *, params=None, mesh=None) -> Callable[[], Server]:
    """A `ServingFleet` factory over one woven program.  Every replica shares
    one param tree: `params` (another server's, on the same device and
    mesh) when given, else the one the first replica draws from `cfg.seed`
    — replicas and spares built after a loss hold no copy of their own.
    On a live `mesh` that tree is this rank's shards.  Each replica gets its
    own `ServerConfig` copy (a knob moved on one stays there)."""
    shared = [params] if params is not None else []

    def make() -> Server:
        srv = Server(woven, dataclasses.replace(cfg), mesh=mesh,
                     params=shared[0] if shared else None)
        if not shared:
            shared.append(srv.params)
        return srv

    return make


class _PollPreemption:
    """SIGTERM arriving mid-wave: `pending` flips True after `after`
    polls.  `serve_continuous` polls at admission boundaries, so `after=1`
    lets the initial admission cohort through (it finishes normally) and
    drains everything still waiting — the synchronous-sim equivalent of a
    signal landing while the wave is decoding."""

    def __init__(self, after: int = 1):
        self.after = int(after)
        self.polls = 0

    @property
    def pending(self) -> bool:
        self.polls += 1
        return self.polls > self.after


@dataclasses.dataclass
class Replica:
    host: int
    server: Server
    alive: bool = True
    draining: bool = False
    drain_polls: int = 1      # admission polls before a requested drain bites
    slowdown: float = 1.0     # published step-time multiplier (straggler sim)
    waves: int = 0
    served: int = 0           # requests completed here
    prefix_hits: int = 0      # pool-level prefix-index hits, accumulated
    affinity_hits: int = 0    # requests routed here by digest affinity
    digests: set = dataclasses.field(default_factory=set)

    def snapshot(self) -> dict[str, Any]:
        return {"host": self.host, "alive": self.alive,
                "draining": self.draining, "waves": self.waves,
                "served": self.served, "prefix_hits": self.prefix_hits,
                "affinity_hits": self.affinity_hits}


class ServingFleet:
    """Places `replicas` Server replicas (+ `spares` hot spares), routes
    with prefix affinity, and survives replica loss and drain.

    `factory` builds one replica's Server (`replica_factory` makes one
    whose replicas share one woven program and one copy of the weights,
    which is what N processes from one image would hold).  Its replicas
    may sit on one live mesh (`replica_factory(..., mesh=)`): every rank
    then builds and runs the same fleet in lockstep, each replica serving
    on this rank's shards, and the fleet's outcomes, events and tokens are
    the same on every rank.  Policy knobs left None resolve from the
    woven `fleet_resilience` extras (FleetResilienceAspect), then from
    `DEFAULT_FLEET_POLICY`; an explicit `injector` (or the woven
    `fleet_injector`) arms the fleet join points.
    """

    def __init__(self, factory: Callable[[], Server], *,
                 replicas: int = 2, spares: int = 0,
                 injector: FaultInjector | None = None,
                 broker: ExamonBroker | None = None,
                 retries: int | None = None,
                 backoff_s: float | None = None,
                 deadline_s: float | None = None,
                 affinity: bool | None = None,
                 wave_size: int | None = None,
                 dead_after_rounds: float | None = None,
                 kill_step: int | None = None,
                 digest_page_size: int = 8):
        if replicas < 1:
            raise ValueError("a fleet needs at least one replica")
        self.factory = factory
        # on a live mesh every rank builds the same replicas and spares here,
        # in the same order: a meshed Server's construction is a collective
        self.replicas = [Replica(h, factory()) for h in range(replicas)]
        self.spares = deque(Replica(replicas + j, factory())
                            for j in range(spares))
        meshes = [r.server.mesh for r in [*self.replicas, *self.spares]]
        self.mesh = next((m for m in meshes if is_live(m)), None)
        if self.mesh is not None and any(m is not self.mesh for m in meshes):
            raise ValueError("the replicas of a fleet on a live mesh must all be "
                             "on that mesh")
        probe = self.replicas[0].server.woven.state.extra
        pol = dict(DEFAULT_FLEET_POLICY)
        pol.update(probe.get("fleet_resilience", {}))
        for key, val in (("retries", retries), ("backoff_s", backoff_s),
                         ("deadline_s", deadline_s), ("affinity", affinity),
                         ("wave_size", wave_size),
                         ("dead_after_rounds", dead_after_rounds)):
            if val is not None:
                pol[key] = val
        self.policy = pol
        self.injector = injector if injector is not None \
            else probe.get("fleet_injector")
        self.kill_step = kill_step
        self.digest_page_size = int(digest_page_size)
        self.broker = broker or ExamonBroker()
        self._round = 0
        self._newly_dead: list[int] = []
        self._next_host = replicas + spares
        # both sides of liveness run on the fleet's logical round counter:
        # beats are arrival-stamped with this clock and check_liveness
        # compares against it — no wall-clock/publish-ts domain crossing
        self.monitor = HeartbeatMonitor(
            self.broker,
            factor=float(pol["straggler_factor"]),
            patience=int(pol["straggler_patience"]),
            dead_after_s=float(pol["dead_after_rounds"]),
            clock=lambda: float(self._round),
            on_straggler=self._on_straggler,
            on_dead=self._on_dead,
        )
        self.events: list[dict[str, Any]] = []
        self.last_fleet_stats: dict[str, Any] | None = None
        self.last_outcomes: list[dict[str, Any]] | None = None

    # -- monitor callbacks -------------------------------------------------

    def _on_dead(self, host: int) -> None:
        self._newly_dead.append(host)

    def _on_straggler(self, host: int) -> None:
        # FleetSim's mitigation pattern one level up: a flagged replica is
        # demoted and a hot spare takes its traffic (the straggler keeps
        # its in-flight wave — demotion is not loss)
        self.events.append({"kind": "straggler", "host": host,
                            "round": self._round})
        rep = self._by_host(host)
        if rep is not None and not rep.draining:
            self.request_drain(host)

    def _by_host(self, host: int) -> Replica | None:
        for rep in self.replicas:
            if rep.host == host:
                return rep
        return None

    def _live(self) -> list[Replica]:
        return [r for r in self.replicas if r.alive]

    def _qos_rollup(self) -> dict[str, Any] | None:
        """Aggregate per-replica QoS-governor stats (replicas serving
        under a woven QoSAspect populate `server.last_qos_stats`): total
        OP switches, the distinct OPs seen fleet-wide, and the summed
        energy ledger.  None when no replica ran governed."""
        per: list[dict[str, Any]] = []
        for rep in self.replicas:
            q = getattr(rep.server, "last_qos_stats", None)
            if q is not None:
                per.append({"host": rep.host, "switches": q["switches"],
                            "distinct_ops": q["distinct_ops"],
                            "tokens": q["tokens"],
                            "energy_j": q["energy_j"]})
        if not per:
            return None
        energy = sum(p["energy_j"] for p in per)
        tokens = sum(p["tokens"] for p in per)
        return {"replicas": per,
                "switches": sum(p["switches"] for p in per),
                "energy_j": energy,
                "tokens": tokens,
                "tokens_per_joule": tokens / energy if energy > 0 else None}

    # -- drain / spare management -----------------------------------------

    def request_drain(self, host: int, *, after_polls: int = 1) -> None:
        """Gracefully drain replica `host` (SIGTERM semantics): its next
        wave finishes whatever it admits, hands the rest to peers, and
        the replica retires (a hot spare fills the slot if available)."""
        rep = self._by_host(host)
        if rep is None or not rep.alive:
            return
        rep.draining = True
        rep.drain_polls = int(after_polls)

    def _swap_in_spare(self, lost_host: int) -> None:
        if not self.spares:
            return
        spare = self.spares.popleft()
        self.replicas.append(spare)
        self.events.append({"kind": "spare_in", "host": spare.host,
                            "for": lost_host, "round": self._round})

    # -- fleet join points -------------------------------------------------

    def _fire(self, point: str, *, rid: Any = None) -> tuple[bool, Any]:
        """Visit a fleet join point; returns (fired, spec).  `raise`-family
        kinds are absorbed here — at fleet level every fired fault maps to
        the point's recovery action, never to an escaping exception."""
        if self.injector is None:
            return False, None
        try:
            spec = self.injector.fire(point, rid=rid)
        except (FaultError, PoolExhausted):
            spec = self.injector.events[-1]
            return True, spec
        if spec is not None:
            return True, spec
        return False, None

    def _publish_faults(self, since: int) -> list[dict]:
        fired = (list(self.injector.events[since:])
                 if self.injector is not None else [])
        for ev in fired:
            point = ev["point"] if isinstance(ev, dict) else ev.point
            kind = ev["kind"] if isinstance(ev, dict) else ev.kind
            self.broker.publish(f"fleet/fault/{point}/{kind}", 1.0)
        return [dict(ev) if isinstance(ev, dict)
                else {"point": ev.point, "kind": ev.kind} for ev in fired]

    # -- routing -----------------------------------------------------------

    def _digests(self, prompt) -> list[bytes]:
        toks = np.asarray(prompt, np.int64).reshape(-1)
        bounds, whole = _prefix_digests(toks, self.digest_page_size)
        return bounds + [whole]

    def _route(self, rid: int, prompt,
               room: dict[int, int]) -> Replica | None:
        """Pick a live replica with room: deepest digest overlap first
        (prefix affinity), least-loaded fallback.  A fired `route` fault
        degrades this request to least-loaded — a routing fault must never
        lose a request."""
        # a draining replica is still routable for its final wave — the
        # SIGTERM bites mid-wave and hands the remainder back
        cands = [r for r in self._live() if room.get(r.host, 0) > 0]
        if not cands:
            return None
        fired, _ = self._fire("route", rid=rid)
        use_affinity = self.policy["affinity"] and not fired
        digs = self._digests(prompt)
        best, overlap = None, 0
        if use_affinity:
            for rep in cands:
                hits = sum(1 for d in digs if d in rep.digests)
                if hits > overlap:
                    best, overlap = rep, hits
        if best is not None:
            best.affinity_hits += 1
        else:
            best = min(cands, key=lambda r: (-room[r.host], r.host))
        best.digests.update(digs)
        room[best.host] -= 1
        return best

    # -- the serve ---------------------------------------------------------

    def serve(self, prompts: list[np.ndarray], *,
              decode_tokens: int | None = None) -> list[np.ndarray]:
        """Serve `prompts` across the fleet; returns per-request token
        arrays in submission order, bit-identical per request to a
        single-server fault-free `serve_continuous` (routing only changes
        *where* a request decodes, never what it emits).  Structured
        per-request outcomes land in `last_outcomes`, fleet economics in
        `last_fleet_stats`."""
        n_req = len(prompts)
        if n_req == 0:
            self.last_outcomes = []
            self.last_fleet_stats = {"rounds": 0, "events": [],
                                     "injected_events": [], "outcomes": {}}
            return []
        first = self.replicas[0].server
        n = decode_tokens or first.cfg.decode_tokens
        kill_at = self.kill_step if self.kill_step is not None \
            else max(1, n - 1)
        wave = max(1, int(self.policy["wave_size"]))
        retries_max = int(self.policy["retries"])
        backoff_s = float(self.policy["backoff_s"])
        deadline_s = self.policy["deadline_s"]

        pending = deque(range(n_req))
        limbo: dict[int, list[int]] = {}   # dead-suspect host -> held rids
        outputs: dict[int, np.ndarray] = {}
        outcome = {r: {"status": "queued", "reason": None, "replica": None}
                   for r in range(n_req)}
        attempts = {r: 0 for r in range(n_req)}
        redispatched = 0
        t0 = time.monotonic()
        inj_seen = len(self.injector.events) if self.injector else 0
        ev_seen = len(self.events)
        self._round = 0
        # bounded by construction: every round either completes requests,
        # advances a liveness countdown, or re-dispatches — but a hard cap
        # keeps an unforeseen stall from spinning forever
        max_rounds = 4 * (n_req + len(self.replicas) + 8)

        # join beats: every replica announces liveness before the first
        # wave, so a replica lost in its very first wave still has a
        # last-seen entry for the monitor to declare dead against
        for rep in self._live():
            self.broker.publish(f"fleet/heartbeat/@host{rep.host}",
                                0.001 * rep.slowdown,
                                timestamp=float(self._round))

        def _keep_best(rid: int, toks: np.ndarray) -> None:
            if len(toks) > len(outputs.get(rid, ())):
                outputs[rid] = np.asarray(toks, np.int64)

        def _retire_overdue() -> None:
            if deadline_s is None:
                return
            # rank 0's clock decides for every rank of a live mesh
            if not broadcast_object(time.monotonic() - t0 > deadline_s, self.mesh):
                return
            stuck = list(pending) + [r for rs in limbo.values() for r in rs]
            pending.clear()
            limbo.clear()
            for rid in stuck:
                outcome[rid] = {"status": "deadline_exceeded",
                                "reason": "fleet deadline exceeded before "
                                          "completion", "replica": None}
                self.events.append({"kind": "deadline", "rid": rid,
                                    "round": self._round,
                                    "partial": len(outputs.get(rid, ()))})

        while pending or limbo:
            self._round += 1
            if self._round > max_rounds:
                for rid in list(pending) + [r for rs in limbo.values()
                                            for r in rs]:
                    outcome[rid] = {"status": "failed",
                                    "reason": "fleet made no progress",
                                    "replica": None}
                break
            if not self._live() and not limbo:
                # every replica is gone and no death declaration is
                # pending: the backlog fails structurally, never raises
                for rid in pending:
                    outcome[rid] = {"status": "failed",
                                    "reason": "no live replicas left",
                                    "replica": None}
                pending.clear()
                break

            # route this round's wave (wave_size per replica; affinity
            # spill is what warms a second replica with a hot prefix)
            room = {r.host: wave for r in self._live()}
            assign: dict[int, list[int]] = {r.host: [] for r in self._live()}
            while pending:
                rid = pending[0]
                rep = self._route(rid, prompts[rid], room)
                if rep is None:
                    break
                pending.popleft()
                assign[rep.host].append(rid)

            for rep in list(self._live()):
                rids = assign.get(rep.host, [])
                if not rids and not rep.draining:
                    # idle replicas still beat — alive is alive
                    self.broker.publish(
                        f"fleet/heartbeat/@host{rep.host}",
                        0.001 * rep.slowdown, timestamp=float(self._round))
                    continue
                killed, _ = self._fire("replica_loss", rid=rep.host)
                drain_now, drain_polls = rep.draining, rep.drain_polls
                if not killed and not drain_now:
                    fired, _ = self._fire("drain", rid=rep.host)
                    if fired:
                        drain_now, drain_polls = True, 1
                chaos = None
                if killed:
                    # deterministic mid-wave death: decode steps past
                    # kill_at raise until the retry budget exhausts, so
                    # the wave drains via _StepAbort — completed requests
                    # stay "ok", in-flight ones return partial "failed"
                    chaos = FaultInjector([FaultSpec(
                        "decode_step", "raise", at=kill_at, repeat=1 << 20)])
                preempt = _PollPreemption(drain_polls) if drain_now else None
                outs: list[np.ndarray] = []
                per: list[dict] = []
                if rids:
                    outs = rep.server.serve_continuous(
                        [prompts[r] for r in rids], decode_tokens=n,
                        fault_injector=chaos, preemption=preempt)
                    rep.waves += 1
                    pool = rep.server.last_pool_stats or {}
                    rep.prefix_hits += int(pool.get("prefix_hits", 0) or 0)
                    per = rep.server.last_outcomes or []
                handoff: list[int] = []
                incomplete: list[int] = []
                for i, rid in enumerate(rids):
                    status = per[i]["status"] if i < len(per) else "failed"
                    if status == "ok":
                        outputs[rid] = np.asarray(outs[i], np.int64)
                        outcome[rid] = {"status": "ok", "reason": None,
                                        "replica": rep.host}
                        rep.served += 1
                    elif status == "drained":
                        handoff.append(rid)
                    elif killed:
                        _keep_best(rid, outs[i])
                        incomplete.append(rid)
                    else:
                        # terminal per-request outcome on a healthy
                        # replica (oversized, quarantined, ...)
                        _keep_best(rid, outs[i])
                        outcome[rid] = {"status": status,
                                        "reason": per[i]["reason"],
                                        "replica": rep.host}
                if killed:
                    rep.alive = False
                    limbo[rep.host] = incomplete
                    self.events.append({
                        "kind": "replica_loss", "host": rep.host,
                        "round": self._round,
                        "kept": sum(1 for r in rids
                                    if outcome[r]["status"] == "ok"),
                        "held": len(incomplete)})
                    continue  # a dead replica beats no more
                if drain_now:
                    # the undrained queue hands off to peers — no attempt
                    # penalty, these requests never started decoding
                    pending.extend(handoff)
                    rep.alive = False
                    rep.draining = False
                    self.events.append({"kind": "drain", "host": rep.host,
                                        "round": self._round,
                                        "finished": sum(
                                            1 for r in rids
                                            if outcome[r]["status"] == "ok"),
                                        "handoff": len(handoff)})
                    self.monitor.forget(rep.host)
                    self._swap_in_spare(rep.host)
                    continue
                self.broker.publish(
                    f"fleet/heartbeat/@host{rep.host}",
                    0.001 * rep.slowdown, timestamp=float(self._round))

            # liveness: the monitor is the authority on death — limbo'd
            # requests only re-dispatch once it declares the host dead
            self.monitor.check_liveness()
            for host in self._newly_dead:
                held = limbo.pop(host, [])
                self.monitor.forget(host)
                self.events.append({"kind": "declared_dead", "host": host,
                                    "round": self._round,
                                    "redispatch": len(held)})
                for rid in held:
                    attempts[rid] += 1
                    if attempts[rid] > retries_max:
                        outcome[rid] = {
                            "status": "failed",
                            "reason": f"re-dispatch budget exhausted "
                                      f"({retries_max} retries)",
                            "replica": None}
                        continue
                    if backoff_s:
                        time.sleep(backoff_s * (2 ** (attempts[rid] - 1)))
                    pending.append(rid)
                    redispatched += 1
                self._swap_in_spare(host)
            self._newly_dead.clear()
            # deadline sweep last: requests that served this round are
            # already done, so what retires here keeps its partial output
            _retire_overdue()

        injected = self._publish_faults(inj_seen)
        by_status: dict[str, int] = {}
        for r in range(n_req):
            s = outcome[r]["status"]
            by_status[s] = by_status.get(s, 0) + 1
        self.last_outcomes = [
            {"rid": r, "status": outcome[r]["status"],
             "reason": outcome[r]["reason"],
             "replica": outcome[r]["replica"],
             "attempts": attempts[r],
             "tokens": len(outputs.get(r, ()))}
            for r in range(n_req)]
        self.last_fleet_stats = {
            "rounds": self._round,
            "replicas": [rep.snapshot() for rep in self.replicas],
            "spares_left": len(self.spares),
            "redispatched": redispatched,
            "events": list(self.events[ev_seen:]),
            "injected_events": injected,
            "outcomes": by_status,
            "malformed_beats": self.monitor.malformed_beats,
            "replicas_with_prefix_hits": sorted(
                rep.host for rep in self.replicas if rep.prefix_hits > 0),
            "affinity_hits": sum(r.affinity_hits for r in self.replicas),
            # QoS plane rollup: replicas serving under a woven QoSAspect
            # report per-replica OP switches and the fleet energy ledger
            # (None when no replica ran governed)
            "qos": self._qos_rollup(),
        }
        return [outputs.get(r, np.asarray([], np.int64))
                for r in range(n_req)]
