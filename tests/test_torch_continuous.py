"""PyTorch port, the slice as a whole: paged continuous serving.

Against the reference: the reduced yi-6b in its head_dim-64 variant (the
attention reaches the kernels' plain versions in the port and the Pallas
kernels in interpret mode in the reference), weights carried across,
policy `double`: greedy tokens of `serve_continuous` are equal for the
unquantized pool and the int8 pool, sharing on and off, and `last_pool_stats`
agree on prefix hits, copy-on-write splits and the live / mapped peaks.  The
reference's outputs are computed once per module.

Inside the port, held exactly: stream == continuous == batch, shared ==
unshared (int8 too), chunked == one-shot, logical-clock arrivals, the
admission-control and copy-on-write cases of `tests/test_paged_serving.py`,
and every option of a later slice raises `NotImplementedError` naming it."""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.base import SHAPES
from repro_torch.core.program import Program
from repro_torch.kernels.flash_attention.ops import flash_attention, flash_decode
from repro_torch.launch.weave import default_weave
from repro_torch.memo.table import MemoTable
from repro_torch.models.registry import build_model, reduced_config
from repro_torch.runtime.pages import PagedCacheManager
from repro_torch.runtime.server import Server, ServerConfig

from test_torch_serve import _servers

torch.set_num_threads(1)

BASE16 = np.arange(1, 17, dtype=np.int32)  # two full pages at page_size=8
PI = np.array([3, 1, 4, 1, 5], np.int32)   # S % page_size != 0
# two sharers of a 16-token prefix, an unrelated short request, and three
# identical prompts (a prefill, a full-prompt re-score, a grouped admission)
PROMPTS = [np.concatenate([BASE16, [21, 22, 23]]).astype(np.int32),
           np.concatenate([BASE16, [31, 32]]).astype(np.int32),
           np.full((3,), 7, np.int32), PI, PI.copy(), PI.copy()]
RUNS = [(dt, share) for dt in (None, "int8") for share in (True, False)]
STATS = ("prefix_hits", "cow_splits", "peak_live_pages", "peak_mapped_pages",
         "grouped_admissions")


def _drain(gen, events=None):
    while True:
        try:
            ev = next(gen)
        except StopIteration as stop:
            return stop.value
        if events is not None:
            events.append(ev)


@pytest.fixture(scope="module")
def pair():
    jsrv, tsrv = _servers("yi-6b", head_dim=64)
    jsrv.cfg.max_cache_len = tsrv.cfg.max_cache_len = 40
    return jsrv, tsrv


@pytest.fixture(scope="module")
def reference_runs(pair):
    """The reference's tokens and pool stats, once per module."""
    jsrv, _ = pair
    out = {}
    for dt, share in RUNS:
        jsrv.cfg.cache_dtype = dt
        toks = jsrv.serve_continuous(PROMPTS, page_size=8, prefix_sharing=share)
        out[dt, share] = (toks, {k: jsrv.last_pool_stats[k] for k in STATS})
    jsrv.cfg.cache_dtype = None
    return out


@pytest.mark.parametrize("dt,share", RUNS, ids=[f"{d or 'fp'}-{'shared' if s else 'unshared'}"
                                                 for d, s in RUNS])
def test_continuous_tokens_and_pool_stats_equal_reference(pair, reference_runs, dt, share):
    _, tsrv = pair
    want, want_stats = reference_runs[dt, share]
    tsrv.cfg.cache_dtype = dt
    try:
        got = tsrv.serve_continuous(PROMPTS, page_size=8, prefix_sharing=share)
    finally:
        tsrv.cfg.cache_dtype = None
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert {k: tsrv.last_pool_stats[k] for k in STATS} == want_stats
    assert tsrv.last_pool_stats["cache_dtype"] == dt
    if share:
        assert want_stats["prefix_hits"] >= 3 and want_stats["cow_splits"] >= 1
        assert want_stats["grouped_admissions"] == 1
        assert tsrv.last_step_counts["rescore"] == 1
        assert tsrv.last_step_counts["suffix_prefill"] == 1


def test_kernel_path_shared_equals_unshared_int8(pair):
    """head_dim 64: the suffix prefill goes through the widened-q decode
    kernel's plain version over the int8 pool; sharing changes no token."""
    _, tsrv = pair
    tsrv.cfg.cache_dtype = "int8"
    try:
        before = (flash_attention.launches, flash_decode.launches)
        a = tsrv.serve_continuous(PROMPTS, page_size=8)
        b = tsrv.serve_continuous(PROMPTS, page_size=8, prefix_sharing=False)
        assert (flash_attention.launches, flash_decode.launches) == before  # CPU: none
    finally:
        tsrv.cfg.cache_dtype = None
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


# ---------------------------------------------------------------------------
# Inside the port: the reduced configuration's own path (head_dim 16)
# ---------------------------------------------------------------------------


def _server(arch="yi-6b", *, woven_extra=None, model_cfg=None, **cfg_kw):
    program = Program.from_arch(arch, kind="serve", reduced=True, device="cpu")
    if model_cfg is not None:
        program = dataclasses.replace(program, cfg=model_cfg, model=build_model(model_cfg))
    woven = default_weave(program, SHAPES["prefill_32k"], {})
    woven.state.extra.update(woven_extra or {})
    cfg_kw.setdefault("max_cache_len", 24)
    cfg_kw.setdefault("decode_tokens", 4)
    return Server(woven, ServerConfig(**cfg_kw))


@pytest.fixture(scope="module")
def srv():
    return _server()


SMALL = [np.ones((5,), np.int32), (np.arange(1, 9) % 50).astype(np.int32),
         np.full((3,), 7, np.int32)]
SHARED = [PROMPTS[0], PROMPTS[1], PROMPTS[2]]


def test_stream_equals_continuous_and_batch(srv):
    batched = srv.serve_batch(SMALL)
    cont = srv.serve_continuous(SMALL, page_size=8)
    events = []
    streamed = _drain(srv.serve_stream(SMALL, page_size=8), events)
    toks: dict[int, list] = {}
    for ev in events:
        if ev["event"] == "token":
            assert ev["index"] == len(toks.setdefault(ev["rid"], []))
            toks[ev["rid"]].append(ev["token"])
    for r, (b, c, s) in enumerate(zip(batched, cont, streamed)):
        np.testing.assert_array_equal(b, c)
        np.testing.assert_array_equal(c, s)
        np.testing.assert_array_equal(c, srv.serve(SMALL[r][None])[0])
        assert toks[r] == list(s)
    kinds = {ev["event"] for ev in events}
    assert kinds == {"admit", "token", "outcome", "wave"}
    assert srv.decode_step_latencies and srv.last_step_counts["decode"] == 3


@pytest.mark.parametrize("dt", [None, "int8", "float8_e4m3fn"])
def test_shared_prefix_equals_unshared_and_batch(srv, dt):
    srv.cfg.cache_dtype = dt
    try:
        shared = srv.serve_continuous(SHARED, page_size=8)
        stats = srv.last_pool_stats
        unshared = srv.serve_continuous(SHARED, page_size=8, prefix_sharing=False)
        assert srv.last_pool_stats["prefix_hits"] == 0
    finally:
        srv.cfg.cache_dtype = None
    for s, u in zip(shared, unshared):
        np.testing.assert_array_equal(s, u)
    if dt is None:
        for s, b in zip(shared, srv.serve_batch(SHARED)):
            np.testing.assert_array_equal(s, b)
    assert stats["prefix_hits"] >= 2 and stats["cache_dtype"] == dt
    assert stats["peak_live_pages"] < stats["peak_mapped_pages"]


@pytest.mark.parametrize("dt", [None, "int8"])
def test_chunked_prefill_equals_one_shot(dt):
    srv = _server(max_cache_len=40, cache_dtype=dt)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, 50, (21,)).astype(np.int32),
               rng.integers(1, 50, (5,)).astype(np.int32),
               rng.integers(1, 50, (17,)).astype(np.int32)]
    base = srv.serve_continuous(prompts, page_size=4)
    events = []
    chunked = srv.serve_continuous(prompts, page_size=4, prefill_chunk=8,
                                   on_event=events.append)
    for b, c in zip(base, chunked):
        np.testing.assert_array_equal(b, c)
    res: dict[int, int] = {}
    for ev in events:
        if ev["event"] == "prefill_chunk":
            assert ev["resident"] > res.get(ev["rid"], 0) and ev["resident"] % 4 == 0
            res[ev["rid"]] = ev["resident"]
    assert res and srv.last_step_counts["suffix_prefill"] >= 2
    arr = srv.serve_continuous(prompts, page_size=4, arrival_waves=[0, 3, 6])
    for b, a in zip(base, arr):
        np.testing.assert_array_equal(b, a)
    for o in srv.last_outcomes:
        assert o["status"] == "ok" and o["ttft_s"] >= 0 and o["ttft_waves"] >= 0
        assert o["tok_gap_max_s"] is not None
    with pytest.raises(ValueError):
        _drain(srv.serve_stream(prompts, page_size=4, arrival_waves=[0, 1]))


def test_chunked_churn_case_stays_equal_to_one_shot():
    """The churn case `tests/test_qos.py`'s property draws at seed 143
    (chunk 4, max_batch 2): the reference's chunked tokens part from its
    one-shot ones there; the port's stay equal, and no live wave starves."""
    srv = _server(max_cache_len=40)
    rng = np.random.default_rng(143)
    prompts = [rng.integers(1, 50, (int(rng.integers(3, 25)),)).astype(np.int32)
               for _ in range(4)]
    base = srv.serve_continuous(prompts, page_size=4)
    events = []
    out = _drain(srv.serve_stream(prompts, page_size=4, prefill_chunk=4, max_batch=2),
                 events)
    for b, c in zip(base, out):
        np.testing.assert_array_equal(b, c)
    assert all(ev["emitted"] >= 1 for ev in events
               if ev["event"] == "wave" and ev["batch"] > 0)


def test_interleaved_and_page_constrained_admission(srv):
    batched = srv.serve_batch(SMALL)
    for kw in (dict(max_batch=1), dict(max_batch=2), dict(pool_pages=4)):
        for b, c in zip(batched, srv.serve_continuous(SMALL, page_size=8, **kw)):
            np.testing.assert_array_equal(b, c)


def test_unfittable_and_oversized_requests_get_structured_rejections(srv):
    roomy = srv.serve_continuous(SMALL, page_size=8)
    out = srv.serve_continuous(SMALL, page_size=8, pool_pages=1)
    st = {o["rid"]: o["status"] for o in srv.last_outcomes}
    assert st[1] == "rejected" and out[1].size == 0
    assert "page pool too small" in srv.last_outcomes[1]["reason"]
    for r in (0, 2):
        assert st[r] == "ok"
        np.testing.assert_array_equal(out[r], roomy[r])
    big = np.arange(30, dtype=np.int32) % 9 + 1
    out = srv.serve_continuous([big, SMALL[0]], page_size=8)
    assert srv.last_outcomes[0]["status"] == "oversized" and out[0].size == 0
    np.testing.assert_array_equal(out[1], roomy[0])
    assert srv.last_fault_stats["oversized"] == 1


def test_first_admission_capacity_checked():
    srv = _server()
    big = (np.arange(12) % 9 + 1).astype(np.int32)  # final 15 -> 2 pages
    out = srv.serve_continuous([big], page_size=8, pool_pages=1)
    assert out[0].size == 0 and srv.last_outcomes[0]["status"] == "rejected"
    for vc in (srv.prefill_vc, srv.probe_vc, srv.paged_prefill_vc, srv.rescore_vc):
        assert not vc.dispatch_counts  # nothing was prefilled


def test_clipped_final_len_interleaves_safely(srv):
    """Past-the-end decode writes of a request clipped at max_cache_len are
    dropped exactly as the dense cache drops them."""
    long_p = (np.arange(20) % 40 + 1).astype(np.int32)
    pr = [long_p, np.full((4,), 9, np.int32), np.full((4,), 11, np.int32)]
    batched = srv.serve_batch(pr, decode_tokens=8)
    cont = srv.serve_continuous(pr, decode_tokens=8, page_size=8, pool_pages=5)
    for b, c in zip(batched, cont):
        np.testing.assert_array_equal(b, c)


def test_sharer_jumps_queue_behind_blocked_nonsharer(srv):
    donor, sharer = SHARED[0], SHARED[1]
    blocker = (np.arange(19) % 37 + 60).astype(np.int32)
    pr = [donor, blocker, sharer]
    batched = srv.serve_batch(pr)
    cont = srv.serve_continuous(pr, page_size=8, pool_pages=5)
    for b, c in zip(batched, cont):
        np.testing.assert_array_equal(b, c)
    assert srv.last_pool_stats["prefix_hits"] >= 2


def test_identical_prompts_rescore_cow_and_group(srv):
    out = srv.serve_continuous([PI, PI, PI], page_size=8, pool_pages=6)
    solo = srv.serve(PI[None])[0]
    for o in out:
        np.testing.assert_array_equal(o, solo)
    stats = srv.last_pool_stats
    assert stats["prefix_hits"] >= 1 and stats["cow_splits"] >= 1
    assert stats["grouped_admissions"] == 1 and srv.last_step_counts["rescore"] == 1


def test_long_prompt_full_share_falls_back_to_suffix_prefill():
    srv = _server(woven_extra={"eager_attn_block": 2})  # S=5 > 2*block
    out = srv.serve_continuous([PI, PI], page_size=2)
    solo = srv.serve(PI[None])[0]
    for o in out:
        np.testing.assert_array_equal(o, solo)
    assert not srv.rescore_vc.dispatch_counts  # the gate held
    assert srv.last_pool_stats["prefix_hits"] >= 2


def test_cow_divergence_isolates_requests(srv):
    """Two requests sharing a whole prompt then forced apart never see each
    other's tokens: each stream's logits equal its own dense run exactly."""
    srv._begin()
    manager = PagedCacheManager(8, 8, max_len=24, window=None)
    first = [srv._paged_admit(manager, rid, PI, 12, None) for rid in (0, 1)]
    assert first[0] == first[1] and manager.prefix_hits >= 1
    shared_page = manager.pool.tables[0][0]
    forced = {0: [5, 6], 1: [9, 10]}
    paged = {0: [], 1: []}
    for step in range(2):
        cache = manager.batch([0, 1])
        tok = torch.tensor([[forced[0][step]], [forced[1][step]]], dtype=torch.int32)
        logits, new_cache = srv.decode_vc(
            None, srv.params, {"tokens": tok, "positions": torch.full((2, 1), 5 + step,
                                                                      dtype=torch.int32)},
            cache)
        manager.absorb([0, 1], new_cache)
        paged[0].append(logits[0])
        paged[1].append(logits[1])
    assert manager.cow_splits >= 1
    t0, t1 = manager.pool.tables[0], manager.pool.tables[1]
    assert t0[0] != t1[0] and shared_page in (t0[0], t1[0])
    for rid in (0, 1):
        _, cache = srv.prefill_vc(None, srv.params,
                                  {"tokens": torch.tensor(PI[None], dtype=torch.int32)})
        for step in range(2):
            logits, cache = srv.decode_vc(
                None, srv.params,
                {"tokens": torch.tensor([[forced[rid][step]]], dtype=torch.int32),
                 "positions": torch.full((1, 1), 5 + step, dtype=torch.int32)}, cache)
            assert torch.equal(paged[rid][step], logits[0])


def test_memoized_continuous_and_cache_dtype_knobs():
    srv = _server(cache_dtype="float16")  # an fp name keeps the fp pool
    srv.serve_continuous(SMALL, page_size=8)
    assert srv.last_pool_stats["cache_dtype"] is None
    srv.cfg.cache_dtype = None
    srv.woven.state.extra["flash_cache_dtype"] = "int8"  # the woven knob
    srv.memo = MemoTable(size=8)
    a = srv.serve_continuous(SMALL[:2], page_size=8)
    assert srv.last_pool_stats["cache_dtype"] == "int8"
    b = srv.serve_continuous(SMALL[:2], page_size=8)
    assert srv.memo.hits >= 1 and srv.last_pool_stats is None
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert srv.serve_continuous([]) == [] and _drain(srv.serve_stream([])) == []


def test_paged_prefill_and_decode_logits_equal_dense():
    """The model's paged branches against its dense ones on one prompt: the
    paged prefill's logits and a paged decode step's equal the dense path's
    bit for bit (policy double), for a shared and an exclusive prefix."""
    srv = _server(model_cfg=reduced_config("yi-6b").replace(attn_softcap=30.0))
    srv._begin()
    toks = torch.tensor(SHARED[0][None], dtype=torch.int32)
    want, cache = srv.prefill_vc(None, srv.params, {"tokens": toks})
    pos = torch.full((1, 1), toks.shape[1], dtype=torch.int32)
    want2, _ = srv.decode_vc(None, srv.params, {"tokens": toks[:, :1], "positions": pos}, cache)
    manager = PagedCacheManager(16, 8, max_len=24)
    for rid, prompt in enumerate((SHARED[1], SHARED[0])):  # the second shares 2 pages
        tok = srv._paged_admit(manager, rid, prompt, 23, None)
    assert manager.prefix_hits == 2 and tok == int(want[0, -1].argmax())
    logits, _ = srv.decode_vc(None, srv.params, {"tokens": toks[:, :1], "positions": pos},
                              manager.batch([1]))
    assert torch.equal(logits, want2)


@pytest.mark.parametrize("kw,item", [
    (dict(qos={}), "item 8b"), (dict(qos=True), "item 8b"),
    (dict(slo_ttft_s=0.5), "item 8b"), (dict(slo_tok_s=0.1), "item 8b"),
    (dict(qos={}, slo_ttft_s=0.5), "item 8b"),
])
def test_options_of_later_slices_raise(srv, kw, item):
    """Only the QoS governor and its SLOs are refused now (speculative
    decoding and the resilience layer are ported: their options serve)."""
    with pytest.raises(NotImplementedError, match=item):
        srv.serve_continuous(SMALL, page_size=8, **kw)


@pytest.mark.parametrize("extra", ["serve_qos", "qos_governor"])
def test_woven_qos_extras_raise(extra):
    srv = _server(woven_extra={extra: {}})
    with pytest.raises(NotImplementedError, match="item 8b"):
        srv.serve_continuous(SMALL, page_size=8)


@pytest.mark.parametrize("kw", [
    dict(draft_len=2), dict(deadline_s=60.0), dict(pool_audit=True),
    dict(preemption="handler"), dict(fault_injector="unarmed"),
])
def test_options_of_ported_slices_serve(srv, kw):
    """The options items 6 and 8a brought: each serves the same tokens."""
    from repro_torch.core.strategies.resilience import FaultInjector
    from repro_torch.distributed.fault import PreemptionHandler

    kw = {k: {"handler": PreemptionHandler(install=False),
              "unarmed": FaultInjector()}.get(v, v) for k, v in kw.items()}
    base = srv.serve_continuous(SMALL, page_size=8)
    for a, b in zip(base, srv.serve_continuous(SMALL, page_size=8, **kw)):
        np.testing.assert_array_equal(a, b)
    assert all(o["status"] == "ok" for o in srv.last_outcomes)


@pytest.mark.parametrize("field,value,item", [
    ("slo_ttft_s", 0.5, "item 8b"), ("slo_tok_s", 0.1, "item 8b"),
])
def test_config_fields_of_later_slices_raise(field, value, item):
    srv = _server(**{field: value})
    with pytest.raises(NotImplementedError, match=item):
        _drain(srv.serve_stream(SMALL, page_size=8))


@pytest.mark.parametrize("field,value", [
    ("draft_len", 2), ("retries", 1), ("deadline_s", 60.0), ("pool_audit", False),
])
def test_config_fields_of_ported_slices_serve(srv, field, value):
    base = srv.serve_continuous(SMALL, page_size=8)
    other = _server(**{field: value})
    for a, b in zip(base, other.serve_continuous(SMALL, page_size=8)):
        np.testing.assert_array_equal(a, b)
    assert (other.last_spec_stats is not None) == (field == "draft_len")


def test_ring_pools_raise_naming_their_slice():
    """A sliding-window model whose prompts ring the pool needs the ring
    page pool of a later slice."""
    cfg = reduced_config("yi-6b").replace(attn_window=4)
    srv = _server(model_cfg=cfg)
    with pytest.raises(NotImplementedError, match="item 10"):
        srv.serve_continuous([np.arange(1, 9, dtype=np.int32)], page_size=4)


@pytest.mark.gpu
def test_continuous_serving_launches_the_kernels_on_the_card():
    """On the card the paged path launches flash decode (its quantized mode
    for an int8 pool) once per layer per decode step, suffix prefill and
    re-score, and — the int8 pool's first prefills attend over its codes —
    per first prefill; `python3 chip_smoke.py` holds the counts at full
    width."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    from repro_torch.launch.serve import build_server

    server = build_server("yi-6b", reduced=True, device="cuda",
                          cfg=ServerConfig(max_cache_len=40, decode_tokens=4,
                                           cache_dtype="int8"))
    layers = server.woven.program.cfg.num_layers
    before = (flash_attention.launches, flash_decode.launches,
              flash_decode.quantized_launches)
    out = server.serve_continuous(PROMPTS, page_size=8)
    steps = server.last_step_counts
    assert all(o.shape == (4,) for o in out)
    got = tuple(a - b for a, b in zip((flash_attention.launches, flash_decode.launches,
                                       flash_decode.quantized_launches), before))
    k2 = layers * (steps["decode"] + steps["suffix_prefill"] + steps["rescore"]
                   + steps["prefill"])
    assert got == (layers * steps["probe"], k2, k2)


def test_cache_policies_weave_the_pool_dtype_as_the_reference():
    """`cache_<dtype>` policies retype the pool, not the compute: woven by
    `ChangePrecision` (and as `MixedPrecisionVersions` variants) into the
    "flash_cache_dtype" extra, which a server then serves from — with the
    same weave report as the reference's."""
    from repro.core.program import Program as JProgram
    from repro.core.strategies.precision import ChangePrecision as JChangePrecision
    from repro.core.weaver import Weaver as JWeaver
    from repro_torch.core.strategies.precision import (
        ChangePrecision,
        MixedPrecisionVersions,
    )
    from repro_torch.core.weaver import Weaver
    from repro_torch.nn.dtypes import DTypePolicy

    assert DTypePolicy.make("cache_int8").cache_dtype == "int8"
    assert DTypePolicy.make("half").cache_dtype is None
    program = Program.from_arch("yi-6b", kind="serve", reduced=True, device="cpu")
    woven = Weaver(program).weave([ChangePrecision("*", "cache_int8")])
    assert woven.state.extra["flash_cache_dtype"] == "int8"
    assert len(woven.state.policies.entries) == 1  # storage only: no compute override
    jwoven = JWeaver(JProgram.from_arch("yi-6b", kind="serve", reduced=True)).weave(
        [JChangePrecision("*", "cache_int8")])
    assert [dataclasses.astuple(m) for m in woven.report.per_aspect] == \
        [dataclasses.astuple(m) for m in jwoven.report.per_aspect]
    aspect = MixedPrecisionVersions(["*"], policies=("float", "cache_int8"))
    mixed = Weaver(program).weave([aspect])
    cached = [n for n in aspect.generated
              if mixed.variant_state(n).extra.get("flash_cache_dtype") == "int8"]
    assert cached
    srv = Server(woven, ServerConfig(max_cache_len=24, decode_tokens=4))
    srv.serve_continuous(SMALL, page_size=8)
    assert srv.last_pool_stats["cache_dtype"] == "int8"
