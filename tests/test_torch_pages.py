"""PyTorch port, the page pool (`repro_torch.runtime.pages`): `PagePool` and
`PagedCacheManager` driven by one operation sequence beside the reference's,
with the same tables, refcounts, free lists and `stats()` on both sides and
the same pool bytes (int8 codes and fp32 scale sidecars included); plus the
reference's model-free cases of `tests/test_paged_serving.py` and
`tests/test_quantized_cache.py`, retargeted to the port.  The reference's
property tests become seeded random churn here."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.runtime import pages as jpages
from repro_torch.runtime import pages as tpages
from repro_torch.runtime.pages import (
    PagePool,
    PagedCacheManager,
    PoolExhausted,
    build_linear_pool,
    cdiv,
    paged_compatible,
    quantize_linear_pool,
)

from _torch_port import t, to_np

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# PagePool: one op sequence through both packages
# ---------------------------------------------------------------------------


def _pool_state(pool):
    return (dict(pool.tables), list(pool._free), list(pool._refs), pool.peak_live,
            pool.peak_mapped, pool.live_pages, pool.mapped_pages)


def _apply(pool, op, rid, arg):
    """One pool operation; returns its result or the exception's type."""
    try:
        live = list(pool.tables)
        if op == "alloc":
            return pool.alloc(rid, arg)
        if not live:
            return None
        target = live[arg % len(live)]
        if op == "grow":
            return pool.grow_to(target, len(pool.tables[target]) + arg % 3 + 1)
        if op == "release":
            return pool.release(target)
        if op == "share":
            prefix = pool.tables[target][: max(1, arg % 4)]
            return pool.alloc(rid, len(prefix) + arg % 3, shared=prefix)
        if op == "cow":
            table = pool.tables[target]
            return pool.cow(target, arg % len(table)) if table else None
        if op == "truncate":
            return pool.truncate(target, arg % (len(pool.tables[target]) + 1))
        return pool.table_rows(live, 8).tolist()
    except (PoolExhausted, jpages.PoolExhausted, KeyError, ValueError) as e:
        return type(e).__name__


@pytest.mark.parametrize("seed", range(4))
def test_page_pool_matches_reference_under_one_op_sequence(seed):
    rng = np.random.default_rng(seed)
    ops = ["alloc", "grow", "release", "share", "cow", "truncate", "rows"]
    jp, tp = jpages.PagePool(24, 8), PagePool(24, 8)
    for step in range(200):
        op = ops[int(rng.integers(len(ops)))]
        arg = int(rng.integers(1, 6))
        assert _apply(tp, op, step, arg) == _apply(jp, op, step, arg), (step, op)
        assert _pool_state(tp) == _pool_state(jp), (step, op)


def test_pages_for_and_digests_match_reference():
    pool, jpool = PagePool(4, 16), jpages.PagePool(4, 16)
    assert [pool.pages_for(n) for n in range(40)] == [jpool.pages_for(n) for n in range(40)]
    toks = np.arange(37) % 11
    for ps in (4, 8, 16, 64):
        assert tpages._prefix_digests(toks, ps) == jpages._prefix_digests(toks, ps)


# -- the reference's TestPagePool / TestRefcountedPool, retargeted ------------


def test_alloc_release_roundtrip():
    pool = PagePool(8, 16)
    a = pool.alloc("a", 3)
    b = pool.alloc("b", 2)
    assert len(set(a) | set(b)) == 5
    assert pool.free_pages == 3
    pool.release("a")
    assert pool.free_pages == 6
    c = pool.alloc("c", 4)
    assert set(c) & set(a) and not (set(c) & set(b))


def test_lifo_reuse_keeps_working_set_compact():
    pool = PagePool(16, 8)
    first = pool.alloc("a", 2)
    pool.release("a")
    assert set(pool.alloc("b", 2)) == set(first)


def test_exhaustion_raises_and_rolls_back_nothing():
    pool = PagePool(4, 8)
    pool.alloc("a", 3)
    with pytest.raises(PoolExhausted):
        pool.alloc("b", 2)
    assert pool.free_pages == 1 and "b" not in pool.tables


def test_grow_appends_at_tail_and_double_alloc_rejected():
    pool = PagePool(8, 8)
    start = list(pool.alloc("a", 2))
    new = pool.grow_to("a", 4)
    assert pool.tables["a"][:2] == start and pool.tables["a"][2:] == new
    assert pool.grow_to("a", 3) == []
    with pytest.raises(KeyError):
        pool.alloc("a", 1)


def test_table_rows_pads_with_valid_page():
    pool = PagePool(8, 8)
    pool.alloc("a", 2)
    pool.alloc("b", 3)
    rows = pool.table_rows(["a", "b"], width=4)
    assert rows.shape == (2, 4) and rows.dtype == np.int32
    assert (rows >= 0).all() and (rows < 8).all()
    assert list(rows[1, :3]) == pool.tables["b"]


def test_shared_alloc_release_and_stale_share():
    pool = PagePool(8, 8)
    a = pool.alloc("a", 3)
    free_before = pool.free_pages
    b = pool.alloc("b", 4, shared=a[:2])
    assert b[:2] == a[:2] and pool.free_pages == free_before - 2
    assert all(pool.refcount(p) == 2 for p in a[:2])
    assert pool.live_pages == 5 and pool.mapped_pages == 7
    assert pool.release("a") == [a[2]]  # b still maps the shared two
    assert set(pool.release("b")) == set(b)
    with pytest.raises(ValueError, match="stale"):
        pool.alloc("c", 1, shared=a[:1])


def test_cow_splits_shared_and_skips_exclusive():
    pool = PagePool(8, 8)
    a = pool.alloc("a", 2)
    pool.alloc("b", 2, shared=a)
    assert pool.cow("a", 0) is not None
    assert pool.tables["a"][0] != pool.tables["b"][0] and pool.tables["b"][0] == a[0]
    assert pool.refcount(a[0]) == 1
    assert pool.cow("a", 0) is None and pool.cow("a", 1) is not None
    small = PagePool(2, 8)
    s = small.alloc("a", 2)
    small.alloc("b", 2, shared=s)
    with pytest.raises(PoolExhausted):
        small.cow("b", 0)


@pytest.mark.parametrize("seed", range(3))
def test_refcount_invariants_under_shared_churn(seed):
    """Seeded alloc/grow/release/share/cow churn keeps the refcounted-pool
    invariants (the reference's property test)."""
    rng = np.random.default_rng(100 + seed)
    pool = PagePool(24, 8)
    ops = ["alloc", "grow", "release", "share", "cow"]
    for step in range(150):
        _apply(pool, ops[int(rng.integers(5))], step, int(rng.integers(1, 6)))
        entries = [p for tb in pool.tables.values() for p in tb]
        refs = [pool.refcount(p) for p in range(pool.num_pages)]
        referenced = {p for p in range(pool.num_pages) if refs[p] > 0}
        free = set(pool._free)
        assert all(pool.refcount(p) >= 1 for p in entries)
        assert not (free & referenced)
        assert len(free) + len(referenced) == pool.num_pages
        assert set(entries) == referenced
        assert sum(refs) == len(entries) == pool.mapped_pages
        assert all(len(tb) == len(set(tb)) for tb in pool.tables.values())


def test_build_linear_pool_packs_prefixes_and_matches_reference():
    ks = [np.arange(l * 2 * 4, dtype=np.float32).reshape(l, 2, 4) for l in (5, 12)]
    pk, pv, tables, pool = build_linear_pool([t(k) for k in ks], [t(k) for k in ks], 4,
                                             max_len=16)
    assert pool.live_pages == cdiv(5, 4) + cdiv(12, 4)
    for i, l in enumerate((5, 12)):
        np.testing.assert_array_equal(to_np(pk[tables[i].long()]).reshape(-1, 2, 4)[:l], ks[i])
    jpk, _, jtables, _ = jpages.build_linear_pool(ks, ks, 4, max_len=16)
    np.testing.assert_array_equal(to_np(pk), np.asarray(jpk))
    np.testing.assert_array_equal(to_np(tables), np.asarray(jtables))


@pytest.mark.parametrize("dtype", ["int8", "float8_e4m3fn"])
def test_quantize_linear_pool_matches_reference(dtype):
    rng = np.random.default_rng(2)
    ks = [rng.standard_normal((l, 2, 16)).astype(np.float32) for l in (7, 19)]
    pk, pv, _, _ = build_linear_pool([t(k) for k in ks], [t(k) for k in ks], 8, max_len=24,
                                     num_pages=5)
    jpk, jpv, _, _ = jpages.build_linear_pool(ks, ks, 8, max_len=24, num_pages=5)
    qk, _, ksc, _ = quantize_linear_pool(pk, pv, dtype)
    jqk, _, jksc, _ = jpages.quantize_linear_pool(jpk, jpv, dtype)
    np.testing.assert_allclose(to_np(ksc), np.asarray(jksc), rtol=1e-6, atol=0)
    assert not to_np(ksc)[-1].any()  # the all-zero tail page keeps the sentinel
    code_diff = np.abs(to_np(qk) - np.asarray(jqk.astype(jnp.float32)))
    assert code_diff.max() <= (1 if dtype == "int8" else 0)


# ---------------------------------------------------------------------------
# PagedCacheManager: one sequence of admissions beside the reference's
# ---------------------------------------------------------------------------

_PS, _MAXLEN, _K, _D, _N = 8, 32, 2, 4, 2  # page, capacity, heads, head_dim, layers


def _dense_cache(rng, L):
    """A per-request prefill cache of a two-layer scanned stack (numpy)."""
    k = rng.standard_normal((_N, 1, _MAXLEN, _K, _D)).astype(np.float32)
    v = rng.standard_normal((_N, 1, _MAXLEN, _K, _D)).astype(np.float32)
    k[:, :, L:] = 0.0
    v[:, :, L:] = 0.0
    ar = np.arange(_MAXLEN, dtype=np.int32)
    return {"blocks0": {"k": k, "v": v, "index": np.full((_N,), L, np.int32)},
            "kv_pos": np.where(ar < L, ar, -1)[None]}


def _jax_tree(c):
    return {"blocks0": {k: jnp.asarray(v) for k, v in c["blocks0"].items()},
            "kv_pos": jnp.asarray(c["kv_pos"])}


def _torch_tree(c):
    return {"blocks0": {k: t(v) for k, v in c["blocks0"].items()}, "kv_pos": t(c["kv_pos"])}


def _assert_managers_agree(tm, jm):
    assert dict(tm.pool.tables) == dict(jm.pool.tables)
    assert list(tm.pool._refs) == list(jm.pool._refs)
    assert list(tm.pool._free) == list(jm.pool._free)
    assert tm.stats() == jm.stats()
    assert {r: m["length"] for r, m in tm._meta.items()} == \
        {r: m["length"] for r, m in jm._meta.items()}
    for key, val in jm._pools["blocks0"].items():
        got = tm._pools["blocks0"][key]
        if key in ("ksc", "vsc"):
            np.testing.assert_allclose(to_np(got), np.asarray(val), rtol=1e-6, atol=0)
        else:
            diff = np.abs(to_np(got) - np.asarray(val.astype(jnp.float32)))
            assert diff.max() <= (1 if val.dtype == jnp.int8 else 0), key


@pytest.mark.parametrize("cache_dtype", [None, "int8"])
def test_manager_matches_reference_under_one_op_sequence(cache_dtype):
    """admit / admit_shared / batch (grow + copy-on-write) / absorb / retire
    / abort, in one order, through both managers: same tables, refcounts,
    free lists, stats() and pool bytes after every operation."""
    jm = jpages.PagedCacheManager(16, _PS, max_len=_MAXLEN, cache_dtype=cache_dtype)
    tm = PagedCacheManager(16, _PS, max_len=_MAXLEN, cache_dtype=cache_dtype)
    rng = np.random.default_rng(7)
    seq = [("admit", "a", 13, 20), ("admit", "b", 8, 12), ("share", "c", "a", 20),
           ("step", ["a", "b", "c"]), ("step", ["a", "c"]), ("retire", "b"),
           ("admit", "d", 19, 24), ("step", ["c", "d"]), ("abort", "a"),
           ("step", ["c", "d"]), ("retire", "c"), ("retire", "d")]
    for op in seq:
        if op[0] == "admit":
            c = _dense_cache(rng, op[2])
            assert tm.can_admit(op[3]) == jm.can_admit(op[3])
            jm.admit(op[1], _jax_tree(c), final_len=op[3])
            tm.admit(op[1], _torch_tree(c), final_len=op[3])
        elif op[0] == "share":
            L = jm._meta[op[2]]["length"]
            pages = list(jm.pool.tables[op[2]])[:cdiv(L, _PS)]
            toks = np.ones((L,), np.int64)
            jm.admit_shared(op[1], toks, final_len=op[3], pages=pages)
            tm.admit_shared(op[1], toks, final_len=op[3], pages=pages)
        elif op[0] == "step":
            jc, tc = jm.batch(op[1]), tm.batch(op[1])
            np.testing.assert_array_equal(to_np(tc["block_tables"]), np.asarray(jc["block_tables"]))
            np.testing.assert_array_equal(to_np(tc["kv_pos"]), np.asarray(jc["kv_pos"]))
            np.testing.assert_array_equal(to_np(tc["blocks0"]["index"]),
                                          np.asarray(jc["blocks0"]["index"]))
            jm.absorb(op[1], jc)
            tm.absorb(op[1], tc)
        else:
            getattr(jm, op[0])(op[1])
            getattr(tm, op[0])(op[1])
        _assert_managers_agree(tm, jm)
    assert tm.cow_splits == jm.cow_splits >= 1 and tm.prefix_hits == jm.prefix_hits >= 2


def test_prefix_index_matches_reference():
    """Registered prompts resolve to the same pages and shared lengths."""
    jm = jpages.PagedCacheManager(16, 4, max_len=24)
    tm = PagedCacheManager(16, 4, max_len=24)
    probe = _dense_cache(np.random.default_rng(0), 1)
    jm.init_structure(_jax_tree(probe))
    tm.init_structure(_torch_tree(probe))
    base = np.arange(1, 11)
    for rid, toks in enumerate([base, np.concatenate([base[:8], [40, 41]]), base[:6]]):
        jp, jl = jm.match_prefix(toks)
        assert tm.match_prefix(toks) == (jp, jl)
        jm.admit_begin(rid, toks, final_len=14, shared_pages=jp[: jl // 4],
                       shared_len=(jl // 4) * 4 if jl < len(toks) else 0)
        tm.admit_begin(rid, toks, final_len=14, shared_pages=jp[: jl // 4],
                       shared_len=(jl // 4) * 4 if jl < len(toks) else 0)
        jm._register_prefix(rid, toks)
        tm._register_prefix(rid, toks)
        _assert_managers_agree_tables(tm, jm)
    for toks in (base, base[:8], base[:5], np.arange(3)):
        assert tm.match_prefix(toks) == jm.match_prefix(toks)


def _assert_managers_agree_tables(tm, jm):
    assert dict(tm.pool.tables) == dict(jm.pool.tables)
    assert tm._prefix_index == jm._prefix_index
    assert tm.stats() == jm.stats()


def test_manager_roundtrip_and_paged_compatible():
    """The reference's admit -> batch -> absorb -> retire round trip, on a
    hand-built two-layer cache."""
    manager = PagedCacheManager(num_pages=12, page_size=8)
    rng = np.random.default_rng(1)
    for rid, S in enumerate((3, 7)):
        cache = _torch_tree(_dense_cache(rng, S))
        assert paged_compatible(cache)
        assert rid == 0 or manager.can_admit(S + 4)
        manager.admit(rid, cache, final_len=S + 4)
    cache = manager.batch([0, 1])
    assert "block_tables" in cache and "kv_pos" in cache
    assert cache["blocks0"]["index"].shape == (2, 2)
    assert to_np(cache["blocks0"]["index"])[:, 0].tolist() == [3, 3]
    manager.absorb([0, 1], cache)
    assert manager._meta[0]["length"] == 4
    manager.retire(0)
    assert manager.pool.free_pages > 0
    assert manager.batch([1])["block_tables"].shape[0] == 1
    assert not paged_compatible({"blocks0": {"time": torch.zeros(1)}})
    with pytest.raises(ValueError):
        PagedCacheManager(4, 8).admit(0, {"blocks0": {"time": torch.zeros(1)}}, final_len=8)


# -- the reference's TestManagerSidecars, retargeted --------------------------


def _admit_cache(rng, L):
    k = rng.standard_normal((1, _MAXLEN, _K, _D))
    v = rng.standard_normal((1, _MAXLEN, _K, _D))
    k[:, L:] = 0.0
    v[:, L:] = 0.0
    return {"layers": {"k": t(k, torch.float32), "v": t(v, torch.float32),
                       "index": torch.full((1,), L, dtype=torch.int32)}}


def _assert_sidecar_invariants(mgr):
    """A page's scale rows live exactly as long as the page."""
    free = set(mgr.pool._free)
    pools = mgr._pools.get("layers")
    if not pools or "ksc" not in pools:
        return
    ksc, vsc = to_np(pools["ksc"]), to_np(pools["vsc"])
    for p in range(mgr.pool.num_pages):
        if p in free:
            assert not ksc[p].any() and not vsc[p].any(), p
        else:
            assert (ksc[p] > 0).all() and (vsc[p] > 0).all(), p


def test_sidecar_rows_live_with_their_page():
    mgr = PagedCacheManager(8, _PS, max_len=_MAXLEN, cache_dtype="int8")
    mgr.admit("a", _admit_cache(np.random.default_rng(1), 19), final_len=19)
    pools = mgr._pools["layers"]
    assert pools["pk"].dtype == torch.int8
    assert all((to_np(pools["ksc"])[p] > 0).all() for p in mgr.pool.tables["a"])
    _assert_sidecar_invariants(mgr)
    mgr.retire("a")
    assert not to_np(mgr._pools["layers"]["ksc"]).any()


def test_cow_copies_the_donor_scale_row():
    mgr = PagedCacheManager(8, _PS, max_len=_MAXLEN, cache_dtype="int8")
    mgr.admit("a", _admit_cache(np.random.default_rng(2), 13), final_len=16)
    tail = mgr.pool.tables["a"][-1]
    mgr.admit_shared("b", np.ones((13,), np.int64), final_len=16,
                     pages=list(mgr.pool.tables["a"]))
    before = to_np(mgr._pools["layers"]["ksc"])[tail].copy()
    pk_before = to_np(mgr._pools["layers"]["pk"])[tail].copy()
    mgr._cow_for_write("b")
    assert mgr.cow_splits == 1
    new_tail = mgr.pool.tables["b"][-1]
    assert new_tail != tail
    after = to_np(mgr._pools["layers"]["ksc"])
    np.testing.assert_array_equal(after[new_tail], before)  # copied
    np.testing.assert_array_equal(after[tail], before)      # untouched
    np.testing.assert_array_equal(to_np(mgr._pools["layers"]["pk"])[new_tail], pk_before)
    _assert_sidecar_invariants(mgr)


def test_ring_groups_stay_fp_and_stats_report_dtype_aware_bytes():
    mgr = PagedCacheManager(8, _PS, max_len=_MAXLEN, window=16, cache_dtype="int8")
    assert mgr._quant_dtype({"ring": True}) is None
    assert mgr._quant_dtype({"ring": False}) == torch.int8
    stats = {}
    for name, dt in (("fp", None), ("q", "int8")):
        m = PagedCacheManager(8, _PS, max_len=_MAXLEN, cache_dtype=dt)
        m.admit("a", _admit_cache(np.random.default_rng(6), 19), final_len=19)
        stats[name] = m.stats()
    fp, q = stats["fp"], stats["q"]
    assert fp["cache_dtype"] is None and q["cache_dtype"] == "int8"
    assert q["page_hbm_bytes"] == 2 * _PS * _K * _D + 2 * _K * 4
    assert fp["page_hbm_bytes"] == 2 * _PS * _K * _D * 4
    assert q["pool_hbm_bytes"] == q["live_pages"] * q["page_hbm_bytes"]
    assert q["peak_pool_hbm_bytes"] == q["peak_live_pages"] * q["page_hbm_bytes"]


@pytest.mark.parametrize("seed", range(4))
def test_sidecar_invariants_under_churn(seed):
    """Seeded admit / share / CoW / retire churn against an int8 pool keeps
    every scale row alive exactly as long as its page (the reference's
    churn, without rollback: that belongs to speculative decoding)."""
    rng = np.random.default_rng(42 + seed)
    mgr = PagedCacheManager(24, _PS, max_len=_MAXLEN, cache_dtype="int8")
    live, shared, next_rid = {}, set(), 0
    for _ in range(20):
        op = ("admit", "share", "cow", "retire")[int(rng.integers(4))]
        arg = int(rng.integers(0, 10 ** 6))
        if op == "admit":
            L = 3 + arg % (_MAXLEN - 3)
            if mgr.can_admit(L):
                mgr.admit(next_rid, _admit_cache(rng, L), final_len=L)
                live[next_rid] = L
                next_rid += 1
        elif op == "share" and live:
            donor = sorted(live)[arg % len(live)]
            L = live[donor]
            pages = list(mgr.pool.tables[donor])[:cdiv(L, _PS)]
            mgr.admit_shared(next_rid, np.ones((L,), np.int64), final_len=L, pages=pages)
            live[next_rid] = L
            shared.add(next_rid)
            next_rid += 1
        elif op == "cow" and shared:
            rid = sorted(shared)[arg % len(shared)]
            L = mgr._meta[rid]["length"]
            if L % _PS and L < _MAXLEN and mgr.pool.free_pages:
                mgr._cow_for_write(rid)
        elif op == "retire" and live:
            rid = sorted(live)[arg % len(live)]
            mgr.retire(rid)
            del live[rid]
            shared.discard(rid)
        _assert_sidecar_invariants(mgr)


def test_admit_matches_reference_quantized_bytes():
    """The legacy admit of one dense cache writes the same int8 codes (at
    most one code apart where the fp32 quotients straddle a rounding
    boundary) and the same scales in both packages."""
    c = _dense_cache(np.random.default_rng(3), 21)
    jm = jpages.PagedCacheManager(8, _PS, max_len=_MAXLEN, cache_dtype="int8")
    tm = PagedCacheManager(8, _PS, max_len=_MAXLEN, cache_dtype="int8")
    jm.admit("r", _jax_tree(c), final_len=24)
    tm.admit("r", _torch_tree(c), final_len=24)
    _assert_managers_agree(tm, jm)
