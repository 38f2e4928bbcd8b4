"""PyTorch port: the woven resilience layer of `serve_stream` (the ports of
`tests/test_resilience.py` and of the drain cases of `tests/test_fleet.py`,
and parity with the reference).

Every serving join point x fault kind, injected one at a time into a
speculative serve with a foreign draft, must never escape `serve_continuous`
as an exception; survivors stay bit-identical to the fault-free serve,
victims get structured outcomes, and every PoolAuditor barrier passes.
Besides: the FaultInjector's determinism, the PoolAuditor's corruption
detection (the device-side scale-sentinel check included), the Watchdog,
each recovery policy, graceful drain under preemption, and a seeded fault
churn.  Against the reference (reduced yi-6b drafted by reduced gemma-2b,
weights carried across): every cell of the sweep gives the same tokens,
outcomes, fault counts and recovery actions."""

import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.configs.base import SHAPES
from repro_torch.core.program import Program
from repro_torch.core.strategies.resilience import (
    DEFAULT_POLICY,
    FAULT_KINDS,
    JOIN_POINTS,
    FaultInjector,
    FaultSpec,
    FleetResilienceAspect,
    InjectedFault,
    NonFiniteLogits,
    ResilienceAspect,
)
from repro_torch.distributed.fault import PreemptionHandler, Watchdog
from repro_torch.launch.weave import default_weave
from repro_torch.monitor.examon import ExamonBroker
from repro_torch.runtime import server as server_mod
from repro_torch.runtime.pages import (
    PagedCacheManager,
    PagePool,
    PoolAuditor,
    PoolExhausted,
    PoolInvariantError,
    audit_pool,
)
from repro_torch.runtime.server import Server, ServerConfig

from _torch_port import np_tree

torch.set_num_threads(1)

PROMPTS = [np.ones((5,), np.int32),
           (np.arange(7) % 13 + 1).astype(np.int32),
           (np.arange(4) % 11 + 2).astype(np.int32)]
VICTIM_STATUSES = ("rejected", "quarantined", "deadline_exceeded", "failed", "oversized")


def _server(arch="yi-6b", *, extra_aspects=None, **cfg_kw):
    program = Program.from_arch(arch, kind="serve", reduced=True, device="cpu")
    woven = default_weave(program, SHAPES["prefill_32k"], {},
                          extra_aspects=extra_aspects or [])
    cfg_kw.setdefault("max_cache_len", 24)
    cfg_kw.setdefault("decode_tokens", 4)
    return Server(woven, ServerConfig(**cfg_kw))


def _statuses(srv):
    return {o["rid"]: o["status"] for o in srv.last_outcomes}


def _equal(a, b):
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


# ---------------------------------------------------------------------------
# FaultInjector: determinism + schedule semantics
# ---------------------------------------------------------------------------


def test_scheduled_fires_on_exact_visit():
    inj = FaultInjector([FaultSpec("decode_step", "raise", at=2)])
    assert inj.fire("decode_step") is None
    assert inj.fire("decode_step") is None
    with pytest.raises(InjectedFault):
        inj.fire("decode_step")
    assert inj.fire("decode_step") is None  # one-shot: consumed
    assert not inj.armed


def test_returned_kinds_resolve_victim():
    spec = FaultInjector([FaultSpec("verify_step", "nan_logits")]).fire(
        "verify_step", rids=[7, 8])
    assert spec.kind == "nan_logits" and spec.rid == 7
    spec = FaultInjector([FaultSpec("admit", "deadline", rid=9)]).fire("admit", rid=3)
    assert spec.rid == 9  # a pinned victim wins over the call site's


def test_pool_exhausted_kind_raises_the_port_pool_error():
    with pytest.raises(PoolExhausted):
        FaultInjector.single("cow", "pool_exhausted").fire("cow")
    assert issubclass(NonFiniteLogits, server_mod.FaultError)
    assert server_mod.NonFiniteLogits is NonFiniteLogits  # the server's own


def test_seeded_random_stream_is_deterministic():
    a = FaultInjector(seed=7, rate=0.5, kinds=("nan_logits",))
    b = FaultInjector(seed=7, rate=0.5, kinds=("nan_logits",))
    seq_a = [a.fire("decode_step") is not None for _ in range(32)]
    seq_b = [b.fire("decode_step") is not None for _ in range(32)]
    assert seq_a == seq_b and any(seq_a) and not all(seq_a)
    a.reset()
    assert [a.fire("decode_step") is not None for _ in range(32)] == seq_a


def test_events_and_stats():
    inj = FaultInjector([FaultSpec("retire", "deadline", at=1)])
    inj.fire("retire", rid=0)
    inj.fire("retire", rid=1)
    s = inj.stats()
    assert s["fired"] == 1 and s["by_point"] == {"retire": 1}
    assert inj.events[0]["rid"] == 1


def test_validation():
    with pytest.raises(ValueError):
        FaultSpec("nope", "raise")
    with pytest.raises(ValueError):
        FaultSpec("admit", "nope")
    with pytest.raises(ValueError):
        FaultInjector(rate=0.1, kinds=("bogus",))


def test_injector_matches_the_reference_module():
    """The module is a copy: the same join points, kinds, default policy,
    and the same seeded stream."""
    from repro.core.strategies import resilience as ref

    assert (JOIN_POINTS, FAULT_KINDS, DEFAULT_POLICY) == \
        (ref.JOIN_POINTS, ref.FAULT_KINDS, ref.DEFAULT_POLICY)
    a = FaultInjector(seed=3, rate=0.3)
    b = ref.FaultInjector(seed=3, rate=0.3)

    def seq(inj, raised):
        out = []
        for i in range(40):
            try:
                got = inj.fire(JOIN_POINTS[i % 8], rid=i)
                out.append(None if got is None else got.kind)
            except raised as e:
                out.append(type(e).__name__)
        return out

    from repro.runtime.pages import PoolExhausted as RefPoolExhausted

    assert seq(a, (InjectedFault, PoolExhausted)) == \
        seq(b, (ref.InjectedFault, RefPoolExhausted))


# ---------------------------------------------------------------------------
# Watchdog: single reused timer thread
# ---------------------------------------------------------------------------


def test_watchdog_single_thread_across_beats():
    fired = []
    wd = Watchdog(10.0, lambda: fired.append(1))
    before = threading.active_count()
    for _ in range(50):
        wd.beat()
    assert threading.active_count() <= before + 1  # one reused thread
    wd.cancel()
    wd.close()
    assert not fired and wd.timeouts == 0


def test_watchdog_fires_after_deadline_and_rearms():
    fired = []
    wd = Watchdog(0.05, lambda: fired.append(1))
    wd.beat()
    time.sleep(0.15)
    assert wd.timeouts == 1 and fired == [1]
    wd.beat()  # re-arm on the same thread
    time.sleep(0.15)
    assert wd.timeouts == 2
    wd.close()


def test_watchdog_cancel_before_deadline_never_counts():
    wd = Watchdog(0.08, lambda: None)
    for _ in range(5):
        wd.beat()
        wd.cancel()
    time.sleep(0.2)
    assert wd.timeouts == 0
    wd.close()


def test_watchdog_close_is_idempotent_and_rejects_beat():
    wd = Watchdog(1.0, lambda: None)
    wd.beat()
    wd.close()
    wd.close()
    with pytest.raises(RuntimeError):
        wd.beat()


def test_step_watchdog_counts_overruns_in_the_serve():
    """A woven step deadline below one step's time: every beat times out,
    the serve goes on, and the overruns are counted and recorded."""
    srv = _server(extra_aspects=[ResilienceAspect(step_deadline_s=1e-9)])
    base = _server().serve_continuous(PROMPTS, page_size=8)
    out = srv.serve_continuous(PROMPTS, page_size=8)
    _equal(base, out)
    time.sleep(0.05)
    fs = srv.last_fault_stats
    assert fs["watchdog_timeouts"] >= 1
    assert any(a["kind"] == "watchdog_overrun" for a in fs["actions"])


# ---------------------------------------------------------------------------
# PoolAuditor: invariants hold on real flows, corruption is caught
# ---------------------------------------------------------------------------


def test_audit_clean_pool_and_manager_pass():
    pool = PagePool(8, 4)
    pool.alloc("a", 3)
    pool.alloc("b", 2, shared=pool.tables["a"][:2])
    summary = audit_pool(pool)
    assert summary["requests"] == 2 and summary["live_pages"] == 3


def test_audit_refcount_corruption_detected():
    pool = PagePool(8, 4)
    pool.alloc("a", 2)
    pool._refs[pool.tables["a"][0]] += 1  # a phantom reference
    with pytest.raises(PoolInvariantError, match="refcount"):
        audit_pool(pool)


def test_audit_double_free_detected():
    pool = PagePool(8, 4)
    pool.alloc("a", 2)
    pool._free.append(pool.tables["a"][0])  # freed while referenced
    with pytest.raises(PoolInvariantError, match="free and referenced"):
        audit_pool(pool)


def test_audit_leak_detected():
    pool = PagePool(8, 4)
    pool.alloc("a", 2)
    page = pool.tables["a"].pop()  # an entry lost, its refcount kept
    pool._refs[page] = 0           # ...then the refcount zeroed too
    with pytest.raises(PoolInvariantError, match="leak|conservation"):
        audit_pool(pool)


def test_audit_manager_meta_mismatch_detected():
    mgr = PagedCacheManager(4, 8, max_len=24)
    mgr.pool.alloc("ghost", 1)  # a table with no admission meta
    with pytest.raises(PoolInvariantError):
        PoolAuditor(mgr).audit()


def test_abort_is_idempotent_and_restores_free_pages():
    mgr = PagedCacheManager(4, 8, max_len=24)
    mgr.pool.alloc("r", 2)
    mgr._meta["r"] = {"length": 8, "final_len": 16}
    mgr.abort("r")
    mgr.abort("r")  # a second abort is a no-op
    assert len(mgr.pool._free) == 4 and not mgr.pool.tables
    audit_pool(mgr)


def test_audit_device_sidecars_and_reservations():
    """`check_device`: a free page whose int8 scale row left the 0.0
    sentinel is caught on the device; a table grown past its final_len
    reservation and a prefix key naming a dead page are caught on the host."""
    srv = _server(cache_dtype="int8")
    srv._begin()
    mgr = PagedCacheManager(8, 4, max_len=24, cache_dtype="int8")
    srv._paged_admit(mgr, 0, np.arange(1, 8, dtype=np.int32), 10, None)
    summary = PoolAuditor(mgr, check_device=True).audit()
    assert summary["checks"] == 4 + 3 + 1 and summary["live_pages"] == 2
    ksc = next(iter(mgr._pools.values()))["ksc"]
    free = mgr.pool._free[0]
    ksc[..., free, :] = 0.5
    PoolAuditor(mgr).audit()  # the host-side checks do not read the device
    with pytest.raises(PoolInvariantError, match="sidecar"):
        PoolAuditor(mgr, check_device=True).audit()
    ksc[..., free, :] = 0.0
    mgr.pool.grow_to(0, 4)  # past final_len 10's three pages
    with pytest.raises(PoolInvariantError, match="reservation"):
        audit_pool(mgr)
    mgr.pool.truncate(0, 2)
    mgr._prefix_index[("full", 9, b"x")] = mgr.pool._free[0]
    with pytest.raises(PoolInvariantError, match="dead page"):
        audit_pool(mgr)


# ---------------------------------------------------------------------------
# Serving fault sweep: every join point x fault kind, with a draft
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def swept():
    """One server with a foreign draft and its fault-free baseline, shared
    across the sweep (the pools are rebuilt per serve)."""
    srv = _server(retries=2, pool_audit=True)
    srv.draft = _server("gemma-2b")
    baseline = srv.serve_continuous(PROMPTS, page_size=8, draft_len=2)
    return srv, baseline


def _check_fault_serve(srv, out, baseline):
    statuses = _statuses(srv)
    assert set(statuses) == {0, 1, 2}
    for r, s in statuses.items():
        if s == "ok":
            np.testing.assert_array_equal(out[r], baseline[r])
        else:
            # victims keep a (possibly empty) prefix of the baseline
            assert s in VICTIM_STATUSES
            np.testing.assert_array_equal(out[r], baseline[r][:out[r].size])
    assert srv.last_pool_stats["live_pages"] == 0  # every page came home


@pytest.mark.parametrize("point", JOIN_POINTS)
@pytest.mark.parametrize("kind", FAULT_KINDS)
def test_single_fault_never_escapes_and_survivors_match(swept, point, kind):
    srv, baseline = swept
    inj = FaultInjector.single(point, kind, at=1)
    out = srv.serve_continuous(PROMPTS, page_size=8, draft_len=2, fault_injector=inj)
    _check_fault_serve(srv, out, baseline)
    fs = srv.last_fault_stats
    if fs["events"]:  # the scheduled fault fired
        assert fs["events"] == 1
        assert fs["injected_events"][0]["point"] == point
    # the PoolAuditor ran at every post-fault barrier and passed
    assert fs["audits"] >= 1


def test_sweep_covers_all_points(swept):
    """Speculative and plain serving together visit every join point at
    least twice, so `at=1` exists for each."""
    srv, _ = swept
    inj = FaultInjector()  # unarmed: a pure visit counter
    srv.serve_continuous(PROMPTS, page_size=8, draft_len=2, fault_injector=inj)
    draft, srv.draft = srv.draft, None
    try:
        srv.serve_continuous(PROMPTS, page_size=8, fault_injector=inj)
    finally:
        srv.draft = draft
    assert all(inj.visits[p] >= 2 for p in JOIN_POINTS), inj.visits


# ---------------------------------------------------------------------------
# Recovery policies
# ---------------------------------------------------------------------------


def test_injection_off_is_bit_identical_with_zero_events():
    srv = _server()
    baseline = srv.serve_continuous(PROMPTS, page_size=8)
    fs = srv.last_fault_stats
    assert fs["events"] == 0 and not fs["actions"] and fs["outcomes"] == {"ok": 3}
    _equal(baseline, srv.serve_continuous(PROMPTS, page_size=8,
                                          fault_injector=FaultInjector()))
    assert srv.last_fault_stats["events"] == 0


def test_transient_raise_is_retried_to_full_output():
    srv = _server()
    baseline = srv.serve_continuous(PROMPTS, page_size=8)
    inj = FaultInjector.single("decode_step", "raise", at=1)
    _equal(baseline, srv.serve_continuous(PROMPTS, page_size=8, fault_injector=inj))
    fs = srv.last_fault_stats
    assert fs["retries"] == 1 and fs["outcomes"] == {"ok": 3}


def test_verify_step_raise_is_retried_to_the_same_tokens():
    srv = _server(pool_audit=True)
    baseline = srv.serve_continuous(PROMPTS, page_size=8, draft_len=2)
    inj = FaultInjector.single("verify_step", "raise", at=0)
    _equal(baseline, srv.serve_continuous(PROMPTS, page_size=8, draft_len=2,
                                          fault_injector=inj))
    fs = srv.last_fault_stats
    assert fs["retries"] == 1 and fs["outcomes"] == {"ok": 3} and fs["audits"] >= 1
    assert srv.last_step_counts["verify"] == srv.last_spec_stats["verify_steps"]


def test_retry_budget_exhaustion_fails_structurally():
    srv = _server(retries=1)
    inj = FaultInjector([FaultSpec("decode_step", "raise", at=1, repeat=10)])
    out = srv.serve_continuous(PROMPTS, page_size=8, fault_injector=inj)
    fs = srv.last_fault_stats
    assert fs["failed"] == 3 and all(o.size >= 1 for o in out)
    assert all(s == "failed" for s in _statuses(srv).values())
    assert srv.last_pool_stats["live_pages"] == 0  # drained, not leaked


@pytest.mark.parametrize("point,k", [("decode_step", 0), ("verify_step", 2)])
def test_nan_quarantines_only_victim(point, k):
    srv = _server(pool_audit=True)
    baseline = srv.serve_continuous(PROMPTS, page_size=8, decode_tokens=6)
    inj = FaultInjector.single(point, "nan_logits", at=1)
    out = srv.serve_continuous(PROMPTS, page_size=8, decode_tokens=6, draft_len=k,
                               fault_injector=inj)
    statuses = _statuses(srv)
    victims = [r for r, s in statuses.items() if s == "quarantined"]
    assert len(victims) == 1
    for r in statuses:
        want = baseline[r][:out[r].size] if r in victims else baseline[r]
        np.testing.assert_array_equal(out[r], want)


def test_injected_deadline_retires_with_partial_output():
    srv = _server()
    baseline = srv.serve_continuous(PROMPTS, page_size=8)
    inj = FaultInjector.single("decode_step", "deadline", at=1, rid=1)
    out = srv.serve_continuous(PROMPTS, page_size=8, fault_injector=inj)
    assert _statuses(srv)[1] == "deadline_exceeded"
    assert 0 < out[1].size < baseline[1].size
    np.testing.assert_array_equal(out[1], baseline[1][:out[1].size])
    for r in (0, 2):
        np.testing.assert_array_equal(out[r], baseline[r])


def test_wall_clock_deadline_marks_overdue():
    srv = _server()
    out = srv.serve_continuous(PROMPTS, page_size=8, deadline_s=0.0)
    # a 0-second SLO: every request is overdue after its first round
    assert all(s == "deadline_exceeded" for s in _statuses(srv).values())
    assert all(o.size >= 1 for o in out)  # partial output survives


def test_draft_fault_degrades_to_plain_decode():
    srv = _server()
    srv.draft = _server("gemma-2b")
    baseline = srv.serve_continuous(PROMPTS, page_size=8)
    inj = FaultInjector.single("draft_step", "raise", at=0)
    _equal(baseline, srv.serve_continuous(PROMPTS, page_size=8, draft_len=2,
                                          fault_injector=inj))
    fs = srv.last_fault_stats
    assert fs["degraded"] and fs["outcomes"] == {"ok": 3}
    assert srv.last_spec_stats["decode_steps"] > 0  # plain rounds ran


def test_repeated_mismatch_degrades_under_patience_policy():
    srv = _server()
    srv.draft = _server("gemma-2b")
    baseline = srv.serve_continuous(PROMPTS, page_size=8, decode_tokens=8)
    srv.woven.state.extra["serve_resilience"] = dict(DEFAULT_POLICY, spec_patience=1)
    out = srv.serve_continuous(PROMPTS, page_size=8, draft_len=2, decode_tokens=8)
    _equal(baseline, out)
    # a foreign draft that all-rejects a round trips patience=1 and the
    # serve finishes on plain rounds; the tokens held either way
    if srv.last_fault_stats["degraded"]:
        assert srv.last_spec_stats["decode_steps"] > 0


def test_woven_resilience_aspect_carries_policy_and_injector():
    inj = FaultInjector.single("decode_step", "nan_logits", at=1)
    srv = _server(extra_aspects=[ResilienceAspect(inj, retries=5, pool_audit=True),
                                 FleetResilienceAspect()])
    assert srv.woven.state.extra["fleet_resilience"]["wave_size"] == 4
    srv.serve_continuous(PROMPTS, page_size=8)
    fs = srv.last_fault_stats
    assert fs["events"] == 1 and fs["quarantined"] == 1
    assert fs["audits"] >= 1  # the woven pool_audit knob was honoured


def test_examon_fault_topics_published():
    broker = ExamonBroker()
    seen = []
    broker.subscribe("serve/fault/*", lambda t, v, ts: seen.append(t))
    srv = _server()
    srv.broker = broker
    inj = FaultInjector.single("decode_step", "raise", at=1)
    srv.serve_continuous(PROMPTS, page_size=8, fault_injector=inj)
    assert "serve/fault/decode_step/raise@host0" in seen


def test_armed_injector_bypasses_memo():
    from repro_torch.memo.table import MemoTable

    srv = _server()
    srv.memo = MemoTable(size=8)
    a = srv.serve_continuous(PROMPTS[:2], page_size=8)
    inj = FaultInjector.single("decode_step", "raise", at=1)
    b = srv.serve_continuous(PROMPTS[:2], page_size=8, fault_injector=inj)
    # the armed serve really ran (a memo hit would clear the fault stats)
    assert srv.last_fault_stats is not None and srv.last_fault_stats["events"] == 1
    _equal(a, b)
    c = srv.serve_continuous(PROMPTS[:2], page_size=8, draft_len=2)
    assert srv.last_spec_stats is not None  # spec serves key separately
    _equal(a, c)


def test_oversized_prompt_rejected_up_front():
    srv = _server()
    big = (np.arange(30) % 9 + 1).astype(np.int32)  # > max_cache_len=24
    out = srv.serve_continuous([big] + PROMPTS[:1], page_size=8)
    assert _statuses(srv)[0] == "oversized" and out[0].size == 0
    assert _statuses(srv)[1] == "ok"


def test_draft_admission_fault_keeps_target_request():
    """A draft-pool admission fault degrades speculation and the request
    serves plain, with no page leak."""
    srv = _server()
    srv.draft = _server("gemma-2b")
    baseline = srv.serve_continuous(PROMPTS, page_size=8)
    # the draft admits in lockstep right after its target: visit 0 is
    # request 0's target admission, visit 1 its draft admission
    inj = FaultInjector.single("paged_prefill", "raise", at=1)
    out = srv.serve_continuous(PROMPTS, page_size=8, draft_len=2,
                               fault_injector=inj, pool_audit=True)
    fs = srv.last_fault_stats
    assert fs["degraded"], fs
    assert _statuses(srv) == {0: "ok", 1: "ok", 2: "ok"}
    _equal(baseline, out)
    assert srv.last_pool_stats["live_pages"] == 0


# ---------------------------------------------------------------------------
# Graceful drain under preemption
# ---------------------------------------------------------------------------


DRAIN_PROMPTS = [(np.arange(4 + i) % 13 + 1 + i).astype(np.int32) for i in range(5)]


def test_pending_from_start_drains_everything():
    srv = _server()
    pre = PreemptionHandler(install=False)
    pre.request()  # SIGTERM before the first wave
    outs = srv.serve_continuous(DRAIN_PROMPTS[:3], preemption=pre)
    assert all(len(o) == 0 for o in outs)
    assert {o["status"] for o in srv.last_outcomes} == {"drained"}
    assert srv.last_fault_stats["drained"] == 3


def test_midwave_sigterm_finishes_inflight_drains_waiting():
    """SIGTERM during an active wave: the admitted cohort finishes its full
    decode (bit-identical to an unpreempted serve), nothing new is admitted,
    the rest returns structured drained outcomes."""
    base = _server(max_batch=2, page_size=8).serve_continuous(DRAIN_PROMPTS)

    class _SigtermAfterFirstPoll(PreemptionHandler):
        def __init__(self):
            super().__init__(install=False)
            self.polls = 0

        @property
        def pending(self):
            self.polls += 1
            if self.polls > 1:
                self.request()
            return super().pending

    srv = _server(max_batch=2, page_size=8)
    outs = srv.serve_continuous(DRAIN_PROMPTS, preemption=_SigtermAfterFirstPoll(),
                                draft_len=2)
    statuses = _statuses(srv)
    finished = [r for r, s in statuses.items() if s == "ok"]
    drained = [r for r, s in statuses.items() if s == "drained"]
    assert len(finished) == 2 and len(drained) == 3
    for r in finished:
        np.testing.assert_array_equal(outs[r], base[r])
    assert all(len(outs[r]) == 0 for r in drained)
    assert srv.last_fault_stats["drained"] == 3


def test_preemption_without_request_keeps_parity():
    a = _server().serve_continuous(DRAIN_PROMPTS[:3])
    b = _server().serve_continuous(DRAIN_PROMPTS[:3],
                                   preemption=PreemptionHandler(install=False))
    _equal(a, b)


# ---------------------------------------------------------------------------
# Seeded fault churn: one random fault, invariants always hold
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def churn():
    srv = _server(pool_audit=True)
    srv.draft = _server("gemma-2b")
    plain = srv.serve_continuous(PROMPTS, page_size=8)
    spec = srv.serve_continuous(PROMPTS, page_size=8, draft_len=2)
    return srv, plain, spec


@pytest.mark.parametrize("case", range(12))
def test_fault_churn_property(churn, case):
    """The reference's seeded fallback sample of (point, kind, visit, spec
    on/off): pool conservation and no double free at every barrier (the
    audits raise otherwise), survivor bit-parity, structured outcomes for
    any victim, and an empty pool at the end."""
    srv, plain, specb = churn
    rng = np.random.default_rng(1234 + case)
    point_i, kind_i = int(rng.integers(len(JOIN_POINTS))), int(rng.integers(len(FAULT_KINDS)))
    at, spec_on = int(rng.integers(7)), bool(rng.integers(2))
    inj = FaultInjector.single(JOIN_POINTS[point_i], FAULT_KINDS[kind_i], at=at)
    out = srv.serve_continuous(PROMPTS, page_size=8, draft_len=2 if spec_on else 0,
                               fault_injector=inj)
    _check_fault_serve(srv, out, specb if spec_on else plain)
    assert srv.last_fault_stats["audits"] >= 1


# ---------------------------------------------------------------------------
# Against the reference
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ref_pair():
    """Reduced yi-6b drafted by reduced gemma-2b in both packages, the
    port's weights carried over from the reference's."""
    from repro.configs.base import SHAPES as JSHAPES
    from repro.core.program import Program as JProgram
    from repro.launch.weave import default_weave as jweave
    from repro.runtime.server import Server as JServer
    from repro.runtime.server import ServerConfig as JServerConfig
    from repro_torch.convert import load_jax_params

    def both(arch):
        jprog = JProgram.from_arch(arch, kind="serve", reduced=True)
        jsrv = JServer(jweave(jprog, JSHAPES["prefill_32k"], {}),
                       JServerConfig(max_cache_len=24, decode_tokens=4, pool_audit=True))
        tsrv = _server(arch, pool_audit=True)
        load_jax_params(tsrv.woven.program.model, np_tree(jsrv.params))
        return jsrv, tsrv

    (jsrv, tsrv), (jdraft, tdraft) = both("yi-6b"), both("gemma-2b")
    jsrv.draft, tsrv.draft = jdraft, tdraft
    return jsrv, tsrv


FAULT_INTS = ("events", "retries", "quarantined", "rejected", "deadline_exceeded",
              "failed", "audits")


@pytest.mark.parametrize("point", JOIN_POINTS)
@pytest.mark.parametrize("kind", FAULT_KINDS)
def test_fault_cells_equal_reference(ref_pair, point, kind):
    """The 8 x 4 sweep's cells (visit 1, speculation on) in both packages:
    the same tokens, outcomes and reasons, fault counts, recovery actions
    and whether speculation degraded."""
    jsrv, tsrv = ref_pair
    at = 1
    res = {}
    for tag, srv, inj_cls in (("ref", jsrv, None), ("port", tsrv, FaultInjector)):
        if inj_cls is None:
            from repro.core.strategies.resilience import FaultInjector as inj_cls
        out = srv.serve_continuous(PROMPTS, page_size=8, draft_len=2,
                                   fault_injector=inj_cls.single(point, kind, at=at))
        fs = srv.last_fault_stats
        res[tag] = ([o.tolist() for o in out],
                    [(o["status"], o["reason"]) for o in srv.last_outcomes],
                    {key: fs[key] for key in FAULT_INTS}, bool(fs["degraded"]),
                    [(a["point"], a["kind"]) for a in fs["actions"]])
    assert res["port"] == res["ref"]
