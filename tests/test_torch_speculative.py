"""PyTorch port: speculative decoding in `serve_stream` (the ports of
`tests/test_speculative.py`, and parity with the reference).

Inside the port, on the reduced configurations (head_dim 16, the plain
attention path): greedy speculative `serve_continuous` is bit-identical to
plain greedy — self-draft at k in {1, 2, 4} with exactly
ceil((n-1)/(k+1)) target steps, a cross-model draft, the woven
"speculative_draft_len" knob, a windowed linear pool, the int8 pool — and
the rollback primitives keep the pool's invariants with no page copy.

Against the reference: the head_dim-64 variant of reduced yi-6b (the
attention reaches the kernels' plain versions in the port and the Pallas
kernels in interpret mode in the reference), weights carried across, policy
`double`: the speculative serve gives the reference's tokens and equal
`last_spec_stats` integers, a verify step's logits match
`build_verify_step`'s within 1e-4, and a draft whose vocabulary is larger
than the target's gives the reference's outcomes (its out-of-vocabulary
proposals quarantine the request) without any out-of-range id reaching
`F.embedding`."""

import dataclasses
import math

import numpy as np
import pytest
import torch

from repro_torch.configs.base import SHAPES
from repro_torch.core.program import Program
from repro_torch.launch.weave import default_weave
from repro_torch.models.registry import build_model, draft_for, reduced_config
from repro_torch.runtime import pages as pages_mod
from repro_torch.runtime.pages import PagedCacheManager, PagePool, PoolExhausted
from repro_torch.runtime.server import Server, ServerConfig

from _torch_port import np_tree, to_np
from test_torch_serve import _servers

torch.set_num_threads(1)

PROMPTS = [np.ones((5,), np.int32),
           (np.arange(1, 9) % 50).astype(np.int32),
           np.full((3,), 7, np.int32)]
PI = np.array([3, 1, 4, 1, 5], np.int32)  # S % page_size != 0: a shared tail page
SPEC_INTS = ("draft_len", "rounds", "request_rounds", "proposed", "accepted",
             "emitted_spec", "draft_steps", "verify_steps", "decode_steps",
             "target_steps")


def _server(arch="yi-6b", *, model_cfg=None, **cfg_kw):
    program = Program.from_arch(arch, kind="serve", reduced=True, device="cpu")
    if model_cfg is not None:
        program = dataclasses.replace(program, cfg=model_cfg, model=build_model(model_cfg))
    woven = default_weave(program, SHAPES["prefill_32k"], {})
    cfg_kw.setdefault("max_cache_len", 24)
    cfg_kw.setdefault("decode_tokens", 4)
    return Server(woven, ServerConfig(**cfg_kw))


def _equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


@pytest.fixture(scope="module")
def srv():
    return _server()


# ---------------------------------------------------------------------------
# Inside the port: speculative == plain greedy
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [1, 2, 4])
def test_self_draft_bit_exact_and_fewer_target_steps(srv, k):
    plain = srv.serve_continuous(PROMPTS, page_size=8)
    assert srv.last_spec_stats is None  # a plain serve leaves no stats
    spec = srv.serve_continuous(PROMPTS, page_size=8, draft_len=k)
    _equal(plain, spec)
    stats = srv.last_spec_stats
    assert stats["draft_len"] == k and stats["verify_steps"] >= 1
    assert stats["acceptance"] == 1.0  # the draft IS the target
    plain_steps = srv.cfg.decode_tokens - 1
    assert stats["target_steps"] == math.ceil(plain_steps / (k + 1)) < plain_steps
    steps = srv.last_step_counts
    # a self-draft's calls are the target server's own: k+1 draft steps a
    # round (k proposals and the write-only catch-up), one verify step
    assert steps["verify"] == stats["verify_steps"] and steps["decode"] == 0
    assert steps["draft"] == stats["draft_steps"] == (k + 1) * stats["rounds"]


def test_registry_cross_model_draft_bit_exact(srv):
    assert draft_for("yi-6b") == "gemma-2b"
    target = _server()
    target.draft = _server(draft_for("yi-6b"))
    plain = target.serve_continuous(PROMPTS, page_size=8)
    spec = target.serve_continuous(PROMPTS, page_size=8, draft_len=2)
    _equal(plain, spec)
    stats = target.last_spec_stats
    # a foreign draft mispredicts freely: correctness must not depend on
    # acceptance, only the step count does
    assert 0.0 <= stats["acceptance"] <= 1.0
    assert stats["draft_steps"] == 3 * stats["rounds"]  # k+1 per round
    assert stats["emitted_spec"] + len(PROMPTS) == target.cfg.decode_tokens * len(PROMPTS)
    assert target.draft.last_step_counts["draft"] == stats["draft_steps"]
    assert target.last_step_counts["draft"] == 0


def test_knob_driven_draft_len():
    """A woven "speculative_draft_len" extra turns speculation on without an
    explicit argument; an explicit draft_len=0 overrides the knob off."""
    s = _server()
    batched = s.serve_batch(PROMPTS)
    s.woven.state.extra["speculative_draft_len"] = 2
    _equal(batched, s.serve_continuous(PROMPTS, page_size=8))
    assert s.last_spec_stats["draft_len"] == 2
    assert s.last_spec_stats["verify_steps"] >= 1
    s.serve_continuous(PROMPTS, page_size=8, draft_len=0)
    assert s.last_spec_stats is None


def test_windowed_linear_spec_parity():
    """A sliding-window arch with prompts inside the window (a linear pool):
    the widened per-row window mask stays bit-exact."""
    s = _server(model_cfg=reduced_config("yi-6b").replace(attn_window=16))
    plain = s.serve_continuous(PROMPTS, page_size=8)
    _equal(plain, s.serve_continuous(PROMPTS, page_size=8, draft_len=2))
    assert s.last_spec_stats["verify_steps"] >= 1
    assert s.last_spec_stats["acceptance"] == 1.0


@pytest.mark.parametrize("dt", ["int8", "float8_e4m3fn"])
def test_quantized_pool_spec_equals_plain(dt):
    """The quantized pool: the draft pool is quantized too, and a verify
    block's slots take the page's first-write scale as single tokens do."""
    s = _server(cache_dtype=dt, decode_tokens=7)
    plain = s.serve_continuous(PROMPTS, page_size=4)
    assert s.last_pool_stats["cache_dtype"] == dt
    for k in (1, 3):
        _equal(plain, s.serve_continuous(PROMPTS, page_size=4, draft_len=k))
        assert s.last_spec_stats["target_steps"] == math.ceil(6 / (k + 1))


def test_chunked_shared_prefix_spec_equals_plain(srv):
    """Speculation beside prefix sharing (CoW splits of the verify block's
    pages), chunked admission and logical-clock arrivals."""
    base = np.arange(1, 17, dtype=np.int32)
    prompts = [np.concatenate([base, [21, 22, 23]]).astype(np.int32),
               np.concatenate([base, [31, 32]]).astype(np.int32),
               np.full((3,), 7, np.int32), PI, PI.copy()]
    s = _server(max_cache_len=40, decode_tokens=6)
    plain = s.serve_continuous(prompts, page_size=4)
    for kw in (dict(), dict(prefill_chunk=8), dict(arrival_waves=[0, 1, 1, 3, 3]),
               dict(max_batch=2)):
        _equal(plain, s.serve_continuous(prompts, page_size=4, draft_len=2, **kw))
        assert s.last_spec_stats["verify_steps"] >= 1
        if not kw:
            assert s.last_pool_stats["prefix_hits"] >= 4
            assert s.last_pool_stats["cow_splits"] >= 1


def test_stream_events_carry_the_verify_rounds(srv):
    events = []
    out = srv.serve_continuous(PROMPTS, page_size=8, draft_len=2,
                               on_event=events.append)
    toks: dict[int, list] = {}
    for ev in events:
        if ev["event"] == "token":
            assert ev["index"] == len(toks.setdefault(ev["rid"], []))
            toks[ev["rid"]].append(ev["token"])
    for r, o in enumerate(out):
        assert toks[r] == list(o)
    waves = [ev for ev in events if ev["event"] == "wave"]
    assert [w["k"] for w in waves] == [2] * srv.last_spec_stats["rounds"]


def test_draft_sync_replays_emitted_tokens():
    """`_draft_sync` restores the lockstep invariant: a draft pool left
    behind the target's accepted length is replayed token by token, and its
    cache then equals a draft that decoded in lockstep."""
    s = _server()
    s._begin()
    lengths = [len(p) for p in PROMPTS]
    outputs = {0: [11, 12, 13], 1: [21, 22], 2: [31]}
    active = {r: {"tok": outputs[r][-1], "pos": lengths[r] + len(outputs[r]) - 1}
              for r in outputs}
    behind = PagedCacheManager(16, 4, max_len=24, prefix_sharing=False)
    lockstep = PagedCacheManager(16, 4, max_len=24, prefix_sharing=False)
    for r, p in enumerate(PROMPTS):
        for m in (behind, lockstep):
            s._paged_admit(m, r, p, 20, None)
    for r in outputs:  # the lockstep draft decodes each emitted token
        for j, t in enumerate(outputs[r][:-1]):
            tok_pos = torch.tensor([[t, lengths[r] + j]], dtype=torch.int32)
            _, new = s.decode_vc(None, s.params, {"tokens": tok_pos[:, :1],
                                                  "positions": tok_pos[:, 1:]},
                                 lockstep.batch([r]))
            lockstep.absorb([r], new)
    s._steps["draft"] = 0
    Server._draft_sync(s, behind, [0, 1, 2], active, outputs, lengths)
    assert s._steps["draft"] == 2 + 1 + 0
    for r in outputs:
        assert behind._meta[r]["length"] == active[r]["pos"] == lockstep._meta[r]["length"]
    rids = [0, 1, 2]
    a, b = behind.batch(rids), lockstep.batch(rids)
    tok_pos = torch.tensor([[active[r]["tok"], active[r]["pos"]] for r in rids],
                           dtype=torch.int32)
    inputs = {"tokens": tok_pos[:, :1], "positions": tok_pos[:, 1:]}
    la, _ = s.decode_vc(None, s.params, inputs, a)
    lb, _ = s.decode_vc(None, s.params, inputs, b)
    assert torch.equal(la, lb)
    Server._draft_sync(s, behind, rids, active, outputs, lengths)  # in step: no-op
    assert s._steps["draft"] == 3


# ---------------------------------------------------------------------------
# Rollback (TestRollback of the reference)
# ---------------------------------------------------------------------------


def test_pool_truncate_refcount_semantics():
    pool = PagePool(8, 8)
    a = pool.alloc("a", 3)
    b = pool.alloc("b", 4, shared=a[:2])
    free_before = pool.free_pages
    assert pool.truncate("b", 3) == [b[3]]  # an exclusive tail page frees
    assert pool.free_pages == free_before + 1
    assert pool.truncate("b", 1) == [b[2]]  # b[2] frees; shared a[1] stays
    assert pool.refcount(a[1]) == 1 and pool.refcount(a[0]) == 2
    assert pool.tables["b"] == [a[0]] and pool.tables["a"] == a
    assert pool.truncate("b", 1) == []  # idempotent at the target
    with pytest.raises(ValueError):
        pool.truncate("b", -1)


def test_manager_rollback_rewinds_length_pages_and_kv_pos(srv):
    srv._begin()
    manager = PagedCacheManager(8, 8, max_len=24, window=None)
    srv._paged_admit(manager, 0, np.array([3, 1, 4, 1, 5], np.int32), 12, None)
    for _ in range(2):  # two identity verify rounds: past a page boundary
        cache = manager.batch([0], tokens=3)
        manager.absorb([0], cache, advance=3)
    assert manager._meta[0]["length"] == 11 and len(manager.pool.tables[0]) == 2
    ar = torch.arange(24, dtype=torch.int32)
    manager._meta[0]["kv_pos"] = torch.where(ar < 11, ar, -1)
    freed = manager.rollback(0, 6)
    assert len(freed) == 1 and len(manager.pool.tables[0]) == 1
    assert manager._meta[0]["length"] == 6
    np.testing.assert_array_equal(to_np(manager._meta[0]["kv_pos"]),
                                  np.where(np.arange(24) < 6, np.arange(24), -1))
    with pytest.raises(ValueError):
        manager.rollback(0, 7)  # beyond the live length
    with pytest.raises(ValueError):
        manager.rollback(0, -1)


def test_rollback_returns_freed_pages_scales_to_the_sentinel():
    """A rolled-back int8 page leaves the pool with its scale rows at the
    0.0 free-page sentinel, as retire leaves them."""
    s = _server(cache_dtype="int8")
    s._begin()
    manager = PagedCacheManager(8, 4, max_len=24, cache_dtype="int8")
    s._paged_admit(manager, 0, np.arange(1, 8, dtype=np.int32), 20, None)
    cache = manager.batch([0], tokens=5)  # slots 7..11: a fresh page
    toks = torch.arange(5, dtype=torch.int32)[None] + 3
    pos = torch.arange(7, 12, dtype=torch.int32)[None]
    _, new = s.decode_vc(None, s.params, {"tokens": toks, "positions": pos}, cache)
    manager.absorb([0], new, advance=5)
    tail = manager.pool.tables[0][-1]
    ksc = next(iter(manager._pools.values()))["ksc"]
    assert bool((ksc[..., tail, :] > 0).all())
    assert manager.rollback(0, 8) == [tail]
    assert bool((ksc[..., tail, :] == 0).all())
    pages_mod.PoolAuditor(manager, check_device=True).audit()


def test_rollback_across_cow_boundary_leaves_donor_pages(srv):
    """A verify round that split a shared page and grew a fresh tail, then
    rejected everything: rollback returns the fresh page, keeps the private
    copy, and leaves the donor's table, refcounts and bytes untouched."""
    srv._begin()
    manager = PagedCacheManager(8, 2, max_len=24, window=None)
    p = np.array([3, 1, 4, 1, 5], np.int32)
    for rid in (0, 1):  # a full-prompt hit: rid 1 maps rid 0's pages
        srv._paged_admit(manager, rid, p, 12, None)
    donor = list(manager.pool.tables[0])
    assert manager.pool.tables[1] == donor
    donor_bytes = {n: pools["pk"][..., donor[2], :, :, :].clone()
                   for n, pools in manager._pools.items()}
    cache = manager.batch([1], tokens=3)  # writes slots 5..7
    assert manager.cow_splits >= 1
    split = manager.pool.tables[1][2]
    assert split != donor[2]
    manager.absorb([1], cache, advance=3)
    assert len(manager.rollback(1, 5)) == 1  # only the grown tail page
    assert manager.pool.tables[1] == donor[:2] + [split]
    assert manager.pool.tables[0] == donor and manager.pool.refcount(donor[2]) == 1
    for n, pools in manager._pools.items():
        assert torch.equal(pools["pk"][..., donor[2], :, :, :], donor_bytes[n])
    pool = manager.pool
    refs = [pool.refcount(q) for q in range(pool.num_pages)]
    assert sum(refs) == sum(len(t) for t in pool.tables.values()) == pool.mapped_pages


def test_speculative_rollback_performs_no_page_copies(monkeypatch):
    """A rejection-heavy cross-model speculative serve (every round rolls
    back) never runs the device page copy inside rollback."""
    copies = {"n": 0, "in_rollback": 0}
    real_copy = pages_mod._copy_pool_page
    real_rollback = pages_mod.PagedCacheManager.rollback

    def spy(pool, src, dst):
        copies["n"] += 1
        return real_copy(pool, src, dst)

    def wrapped(self, rid, new_length):
        before = copies["n"]
        out = real_rollback(self, rid, new_length)
        copies["in_rollback"] += copies["n"] - before
        return out

    monkeypatch.setattr(pages_mod, "_copy_pool_page", spy)
    monkeypatch.setattr(pages_mod.PagedCacheManager, "rollback", wrapped)
    s = _server()
    s.draft = _server("gemma-2b")
    plain = s.serve_continuous(PROMPTS, page_size=8)
    _equal(plain, s.serve_continuous(PROMPTS, page_size=8, draft_len=2))
    assert s.last_spec_stats["verify_steps"] >= 1
    assert s.last_spec_stats["accepted"] < s.last_spec_stats["proposed"]
    assert copies["in_rollback"] == 0


def _churn_ops(seed):
    rng = np.random.default_rng(seed)
    return [(int(rng.integers(0, 6)), int(rng.integers(1, 6)))
            for _ in range(int(rng.integers(1, 81)))]


@pytest.mark.parametrize("seed", range(12))
def test_invariants_under_truncate_churn(seed):
    """Random alloc / grow / release / share / cow / truncate sequences keep
    the refcounted pool's invariants: freed pages are exactly the dropped
    entries whose refcount hit zero, and a shared page dropped by one holder
    stays live for the others."""
    pool = PagePool(24, 8)
    rid = 0
    for op, arg in _churn_ops(seed):
        live = list(pool.tables)
        if op == 0:
            try:
                pool.alloc(rid, arg)
            except PoolExhausted:
                assert pool.free_pages < arg
            rid += 1
        elif op == 1 and live:
            try:
                pool.grow_to(live[0], len(pool.tables[live[0]]) + arg)
            except PoolExhausted:
                assert pool.free_pages < arg
        elif op == 2 and live:
            pool.release(live[0])
        elif op == 3 and live:
            prefix = pool.tables[live[arg % len(live)]][: max(1, arg)]
            extra = arg % 3
            try:
                assert pool.alloc(rid, len(prefix) + extra,
                                  shared=prefix)[: len(prefix)] == prefix
            except PoolExhausted:
                assert pool.free_pages < extra
            rid += 1
        elif op == 4 and live:
            target = live[arg % len(live)]
            if pool.tables[target]:  # truncate-to-zero leaves empties
                try:
                    pool.cow(target, arg % len(pool.tables[target]))
                except PoolExhausted:
                    assert pool.free_pages == 0
        elif op == 5 and live:  # speculative rollback
            target = live[arg % len(live)]
            table = pool.tables[target]
            keep = max(0, len(table) - arg)
            dropped = table[keep:]
            elsewhere = {q for q in dropped if pool.refcount(q) > dropped.count(q)}
            freed = pool.truncate(target, keep)
            assert set(freed) <= set(dropped) and not (set(freed) & elsewhere)
            assert len(pool.tables[target]) == keep
        entries = [q for t in pool.tables.values() for q in t]
        refs = [pool.refcount(q) for q in range(pool.num_pages)]
        referenced = {q for q in range(pool.num_pages) if refs[q] > 0}
        free = set(pool._free)
        assert all(pool.refcount(q) >= 1 for q in entries)
        assert not (free & referenced)
        assert len(free) + len(referenced) == pool.num_pages
        assert set(entries) == referenced
        assert sum(refs) == len(entries) == pool.mapped_pages
        assert all(len(t) == len(set(t)) for t in pool.tables.values())
    pages_mod.audit_pool(pool)


# ---------------------------------------------------------------------------
# Embedding: out-of-vocabulary ids as the reference's `jnp.take` gives them
# ---------------------------------------------------------------------------


def test_embedding_out_of_range_ids_give_nan_rows_and_never_reach_f_embedding(monkeypatch):
    from repro_torch.nn.blocks import Embedding
    from repro_torch.nn.module import Ctx, init_params

    seen = []
    real = torch.nn.functional.embedding

    def spy(ids, table, *a, **k):
        seen.append((int(ids.min()), int(ids.max())))
        return real(ids, table, *a, **k)

    emb = Embedding("embed", 16, 8, scale_by_dim=True)
    params = {k: v for k, v in init_params(emb, 0, None, "cpu").items()}
    ctx = Ctx()
    inside = torch.tensor([[0, 3, 15, 7]], dtype=torch.int32)
    want = emb(params, inside, ctx=ctx)
    monkeypatch.setattr(torch.nn.functional, "embedding", spy)
    ids = torch.tensor([[0, 3, 15, 16, 400, -1, -16, -17]], dtype=torch.int32)
    got = emb(params, ids, ctx=ctx)
    assert all(0 <= lo and hi < 16 for lo, hi in seen)
    assert torch.equal(got[0, :3], want[0, :3])          # in range: same bits
    assert torch.isnan(got[0, 3:5]).all()                 # >= vocab: NaN rows
    assert torch.equal(got[0, 5], want[0, 2])             # -1 counts from the end
    assert torch.equal(got[0, 6], want[0, 0])             # -vocab is row 0
    assert torch.isnan(got[0, 7]).all()                   # < -vocab: NaN


# ---------------------------------------------------------------------------
# Against the reference
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pair():
    return _servers("yi-6b", head_dim=64)


@pytest.fixture(scope="module")
def draft_pair():
    return _servers("gemma-2b", head_dim=64)


@pytest.mark.parametrize("k", [1, 2, 4])
def test_speculative_tokens_and_stats_equal_reference(pair, k):
    jsrv, tsrv = pair
    want = jsrv.serve_continuous(PROMPTS, page_size=8, draft_len=k)
    got = tsrv.serve_continuous(PROMPTS, page_size=8, draft_len=k)
    _equal(got, want)
    assert {key: tsrv.last_spec_stats[key] for key in SPEC_INTS} == \
        {key: jsrv.last_spec_stats[key] for key in SPEC_INTS}
    assert tsrv.last_spec_stats["acceptance"] == jsrv.last_spec_stats["acceptance"] == 1.0


def test_cross_model_draft_equals_reference(pair, draft_pair):
    (jsrv, tsrv), (jdraft, tdraft) = pair, draft_pair
    want = jsrv.serve_continuous(PROMPTS, page_size=8, draft_len=2, draft=jdraft)
    got = tsrv.serve_continuous(PROMPTS, page_size=8, draft_len=2, draft=tdraft)
    _equal(got, want)
    assert {key: tsrv.last_spec_stats[key] for key in SPEC_INTS} == \
        {key: jsrv.last_spec_stats[key] for key in SPEC_INTS}


def test_verify_step_logits_match_reference(pair):
    """One verify step (S = 3) over a paged pool holding the prompts, in
    both packages from the same pool contents: logits within 1e-4."""
    import jax.numpy as jnp
    from repro.runtime.pages import PagedCacheManager as JManager

    jsrv, tsrv = pair
    jsrv.woven.variant_state(None).extra["cache_max_len"] = 24
    tsrv._begin()
    jm, tm = JManager(16, 8, max_len=24), PagedCacheManager(16, 8, max_len=24)
    for r, p in enumerate(PROMPTS):
        jsrv._paged_admit(jm, r, p, 20, None)
        tsrv._paged_admit(tm, r, p, 20, None)
    rids = [0, 1, 2]
    fed = np.random.default_rng(5).integers(0, 512, (3, 3)).astype(np.int32)
    pos = (np.array([len(p) for p in PROMPTS])[:, None] + np.arange(3)).astype(np.int32)
    want, _ = jsrv._verify_step(None, 2)(
        jsrv.params, {"tokens": jnp.asarray(fed), "positions": jnp.asarray(pos)},
        jm.batch(rids, tokens=3))
    got, _ = tsrv._verify_step(None, 2)(
        tsrv.params, {"tokens": torch.from_numpy(fed), "positions": torch.from_numpy(pos)},
        tm.batch(rids, tokens=3))
    want = np_tree(want)
    assert got.shape == want.shape == (3, 3, 512) and got.dtype == torch.float32
    np.testing.assert_allclose(to_np(got), want, atol=1e-4, rtol=0)


def test_out_of_vocabulary_draft_gives_the_reference_outcomes(monkeypatch):
    """Reduced yi-6b (vocab 512) drafted by reduced gemma-2b at vocab 4096:
    the reference feeds the draft's argmax unchanged, `jnp.take` turns an id
    past the target's vocabulary into a NaN row, and the request is
    quarantined.  The port gives the same tokens and outcomes, and no
    out-of-range id reaches `F.embedding`."""
    from repro.configs.base import SHAPES as JSHAPES
    from repro.core.program import Program as JProgram
    from repro.launch.weave import default_weave as jweave
    from repro.models.registry import build_model as jbuild
    from repro.models.registry import reduced_config as jreduced
    from repro.runtime.server import Server as JServer
    from repro.runtime.server import ServerConfig as JServerConfig
    from repro_torch.convert import load_jax_params

    def both(arch, **repl):
        jcfg, tcfg = jreduced(arch).replace(**repl), reduced_config(arch).replace(**repl)
        jprog = JProgram(model=jbuild(jcfg), cfg=jcfg, kind="serve")
        tprog = Program(model=build_model(tcfg), cfg=tcfg, kind="serve", device="cpu")
        jsrv = JServer(jweave(jprog, JSHAPES["prefill_32k"], {}),
                       JServerConfig(max_cache_len=24, decode_tokens=4))
        tsrv = Server(default_weave(tprog, SHAPES["prefill_32k"], {}),
                      ServerConfig(max_cache_len=24, decode_tokens=4))
        load_jax_params(tprog.model, np_tree(jsrv.params))
        return jsrv, tsrv

    (jy, ty), (jg, tg) = both("yi-6b"), both("gemma-2b", vocab=4096)
    jy.draft, ty.draft = jg, tg
    want = jy.serve_continuous(PROMPTS, page_size=8, draft_len=2)
    want_outcomes = [(o["status"], o["reason"]) for o in jy.last_outcomes]
    ranges = []
    real = torch.nn.functional.embedding

    def spy(ids, table, *a, **k):
        ranges.append((int(ids.min()), int(ids.max()), table.shape[0]))
        return real(ids, table, *a, **k)

    monkeypatch.setattr(torch.nn.functional, "embedding", spy)
    got = ty.serve_continuous(PROMPTS, page_size=8, draft_len=2)
    _equal(got, want)
    assert [(o["status"], o["reason"]) for o in ty.last_outcomes] == want_outcomes
    assert ("quarantined", "non-finite verify logits") in want_outcomes
    assert {key: ty.last_spec_stats[key] for key in SPEC_INTS} == \
        {key: jy.last_spec_stats[key] for key in SPEC_INTS}
    assert ranges and all(0 <= lo and hi < rows for lo, hi, rows in ranges)
    assert any(rows == 512 for _, _, rows in ranges)


# ---------------------------------------------------------------------------
# The speculative tuner space (twins of tests/test_speculative.py's
# TestSpeculativeTuning)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_speculative_space_and_smem_model(dtype):
    """The reference's draft lengths; the FMA route (fp32) adds its decode
    block, the tensor-core route's verify tile is compiled in."""
    from repro.autotune import kernel_tuner as jkt
    from repro_torch.autotune import kernel_tuner as tkt

    sig = tkt.speculative_signature(2, 128, 4, 2, 16, dtype)
    space = tkt.design_space(sig)
    assert space["draft_len"] == [1, 2, 4, 8] == \
        jkt.design_space(jkt.speculative_signature(2, 128, 4, 2, 16, dtype))["draft_len"]
    assert set(space) == ({"draft_len"} if dtype == "bfloat16"
                          else {"draft_len", "block_kv_dec"})
    assert 0 < tkt.config_smem_bytes(sig, {"draft_len": 8, "block_kv_dec": 16}) \
        <= tkt.DEFAULT_SMEM_BUDGET
    assert tkt.design_space(tkt.speculative_signature(2, 4, 4, 2, 16, dtype))[
        "draft_len"] == [1, 2]  # the draft block fits under the cache


def test_tune_records_acceptance_prior_and_lookup(tmp_path, monkeypatch):
    from repro_torch.autotune import kernel_tuner as tkt

    path = str(tmp_path / "kt.json")
    monkeypatch.setenv("REPRO_TORCH_TUNER_CACHE", path)
    tuner = tkt.KernelTuner(path, device="cpu")
    sig = tkt.speculative_signature(1, 64, 4, 2, 16, "float32")
    knobs = tuner.tune(sig, lambda **kn: kn["draft_len"] + kn["block_kv_dec"] / 64)
    assert knobs == {"draft_len": 1, "block_kv_dec": 16}
    for row in tuner.cache.get(sig.key())["ops"]:
        assert row["metrics"]["tokens_per_step"][0] == row["knobs"]["draft_len"] + 1
    assert tkt.tuned_speculative_knobs(1, 64, 4, 2, 16, "float32", device="cpu") == knobs
    assert tkt.tuned_speculative_knobs(1, 64, 4, 2, 16, "float32", device="cuda") == {}


def test_refine_speculative_equals_reference(pair, tmp_path, monkeypatch):
    """The served acceptance rescales the cached tokens_per_step priors by
    the reference's coefficient, and draft_len is re-selected as there."""
    from repro.autotune import kernel_tuner as jkt
    from repro_torch.autotune import kernel_tuner as tkt

    monkeypatch.setenv("REPRO_TUNER_CACHE", str(tmp_path / "ref_default.json"))
    monkeypatch.setenv("REPRO_TORCH_TUNER_CACHE", str(tmp_path / "port_default.json"))
    jsrv, tsrv = pair
    assert tsrv.refine_speculative(latency_budget=1.0) is None  # no spec yet
    jsrv.serve_continuous(PROMPTS, page_size=8, draft_len=2, decode_tokens=8)
    tsrv.serve_continuous(PROMPTS, page_size=8, draft_len=2, decode_tokens=8)
    stats = tsrv.last_spec_stats
    assert stats["verify_steps"] >= 2
    assert stats["mean_tokens_per_verify"] == jsrv.last_spec_stats["mean_tokens_per_verify"]

    batch = max(1, round(stats["request_rounds"] / max(stats["rounds"], 1)))
    sigs, tuners = [], []
    for kt, srv, constraint in ((jkt, jsrv, "vmem_bytes"), (tkt, tsrv, "smem_bytes")):
        cfg = srv.woven.program.cfg
        sig = kt.speculative_signature(batch, srv.cfg.max_cache_len, cfg.n_heads,
                                       cfg.kv_heads, cfg.resolved_head_dim,
                                       srv._paged_dtype, window=cfg.attn_window)
        path = str(tmp_path / f"{constraint}.json")
        tuner = kt.KernelTuner(path) if kt is jkt else kt.KernelTuner(path, device="cpu")
        ops = [{"knobs": {"draft_len": dl}, "metrics": {
            "latency_s": [1e-3, 0.0], "tokens_per_step": [float(dl + 1), 0.0],
            constraint: [1.0, 0.0]}} for dl in (1, 2, 4)]
        tuner.cache.put(sig.key(), {"knobs": {"draft_len": 2},
                                    "metrics": {"latency_s": [1e-3, 0.0],
                                                "tokens_per_step": [3.0, 0.0]},
                                    "ops": ops})
        sigs.append(sig)
        tuners.append(tuner)
    assert sigs[0].key() == sigs[1].key()
    want = jsrv.refine_speculative(latency_budget=10.0, tuner=tuners[0])
    got = tsrv.refine_speculative(latency_budget=10.0, tuner=tuners[1])
    assert got == want == {"draft_len": 4}  # maximized
    coefs = [t.cache.get(s.key())["runtime"]["error_coef"]["tokens_per_step"]
             for t, s in zip(tuners, sigs)]
    assert coefs[1] == coefs[0] == pytest.approx(stats["mean_tokens_per_verify"] / 3.0)
