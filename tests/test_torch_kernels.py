"""PyTorch port, kernel modules: the plain versions (what the CUDA kernels are
held against on the card, and what runs on the CPU) against the reference's
Pallas kernels in interpret mode, fp32, atol = rtol = 1e-5 (both sides do
fp32 math; only the summation order differs).  Inputs come from numpy."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import decode as jdec
from repro.kernels.flash_attention import kernel as jker
from repro.kernels.flash_attention import ops as jops
from repro.kernels.rmsnorm.ops import rmsnorm as jax_rmsnorm
from repro_torch.kernels.flash_attention import decode as tdec
from repro_torch.kernels.flash_attention import kernel as tker
from repro_torch.kernels.flash_attention import ops as tops
from repro_torch.kernels.flash_attention.ref import decode_ref
from repro_torch.kernels.rmsnorm.ops import rmsnorm

from _torch_port import t, to_np

torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-5)


def _qkv(seed, B, S, T, H, K, D):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, D)).astype(np.float32),
            rng.standard_normal((B, T, K, D)).astype(np.float32),
            rng.standard_normal((B, T, K, D)).astype(np.float32))


# ---------------------------------------------------------------------------
# K1: flash attention forward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,S,T,H,K,kw", [
    ("causal", 64, 64, 4, 2, dict(causal=True)),
    ("sliding_window", 64, 64, 4, 2, dict(causal=True, window=24)),
    ("softcap", 64, 64, 4, 2, dict(causal=True, softcap=30.0)),
    ("mqa", 64, 64, 8, 1, dict(causal=True)),
    ("ragged_seq", 50, 50, 4, 2, dict(causal=True, window=20)),
    ("s_ne_t_full", 32, 80, 4, 2, dict(causal=False)),
    ("s_ne_t_causal", 32, 80, 4, 4, dict(causal=True)),
])
def test_attention_ref_matches_pallas(name, S, T, H, K, kw):
    q, k, v = _qkv(1, 2, S, T, H, K, 64)
    want = jops.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block_q=32, block_kv=32,
        block_q_bwd=32, block_kv_bwd=32, interpret=True, **kw)
    got = tops.flash_attention(t(q), t(k), t(v), **kw)
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)


def test_fully_masked_rows_yield_zero():
    """A row that sees nothing is 0 (l = 0), as in the kernels — not the
    uniform average a plain softmax over -1e30 gives."""
    q, k, v = _qkv(2, 1, 1, 8, 2, 2, 64)
    out = decode_ref(t(q), t(k), t(v), torch.tensor([20]), window=4)
    # index 20 on an 8-slot linear cache under window 4: slots 17..20 are
    # past the end, so no slot is live
    assert torch.count_nonzero(out) == 0


# ---------------------------------------------------------------------------
# K2: flash decode
# ---------------------------------------------------------------------------


def _jax_decode(q, k, v, idx, **kw):
    return np.asarray(jops.flash_decode(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(idx, jnp.int32), interpret=True, **kw))


@pytest.mark.parametrize("name,HK,T,idx,window,softcap,bkv", [
    ("linear_growth", (4, 2), 128, [0, 63, 127], None, None, 32),
    ("ring_past_wrap", (4, 2), 48, [7, 47, 1000], None, None, 16),
    ("linear_window", (4, 2), 128, [3, 64, 127], 48, None, 32),
    ("ragged_index_gqa8", (8, 1), 100, [5, 40, 99], 24, 30.0, 32),
])
def test_decode_ref_matches_pallas(name, HK, T, idx, window, softcap, bkv):
    H, K = HK
    q, k, v = _qkv(3, len(idx), 1, T, H, K, 64)
    want = _jax_decode(q, k, v, idx, window=window, softcap=softcap, block_kv=bkv)
    got = tops.flash_decode(t(q), t(k), t(v), torch.tensor(idx, dtype=torch.int32),
                            window=window, softcap=softcap, block_kv=bkv)
    np.testing.assert_allclose(to_np(got), want, **TOL)


def test_decode_scalar_index_broadcasts():
    q, k, v = _qkv(4, 2, 1, 64, 4, 2, 64)
    a = tops.flash_decode(t(q), t(k), t(v), torch.tensor(17, dtype=torch.int32))
    b = tops.flash_decode(t(q), t(k), t(v), torch.tensor([17, 17], dtype=torch.int32))
    assert torch.equal(a, b)


@pytest.mark.parametrize("window", [None, 20])
def test_widened_q_matches_pallas_and_sequential_singles(window):
    """q_span = 4: row-wise equal to four single-token calls, token s at
    index + s, against the same (fully written) cache."""
    idx = [10, 59]
    q, k, v = _qkv(5, 2, 4, 64, 4, 2, 64)
    want = _jax_decode(q, k, v, idx, window=window, block_kv=16)
    index = torch.tensor(idx, dtype=torch.int32)
    got = tops.flash_decode(t(q), t(k), t(v), index, window=window, block_kv=16)
    np.testing.assert_allclose(to_np(got), want, **TOL)
    for s in range(4):
        single = tops.flash_decode(t(q[:, s:s + 1]), t(k), t(v), index + s,
                                   window=window, block_kv=16)
        np.testing.assert_allclose(to_np(got[:, s:s + 1]), to_np(single), **TOL)


def _pool_from_dense(k, v, ps, seed=3):
    """Scatter a dense (B, T, K, D) cache into a page pool with a *shuffled*
    page assignment; two spare pages stay unmapped."""
    B, T = k.shape[0], k.shape[1]
    nb = -(-T // ps)
    pad = ((0, 0), (0, nb * ps - T), (0, 0), (0, 0))
    kp = np.pad(k, pad).reshape(B * nb, ps, *k.shape[2:])
    vp = np.pad(v, pad).reshape(B * nb, ps, *k.shape[2:])
    perm = np.random.default_rng(seed).permutation(B * nb + 2)[:B * nb].astype(np.int32)
    pk = np.zeros((B * nb + 2, *kp.shape[1:]), np.float32)
    pv = np.zeros_like(pk)
    pk[perm], pv[perm] = kp, vp
    return pk, pv, perm.reshape(B, nb)


@pytest.mark.parametrize("name,T,idx,window,ps,bkv,S", [
    ("linear", 160, [4, 80, 159], None, 32, 32, 1),
    ("subblock_window", 128, [3, 64, 127], 48, 64, 16, 1),
    ("ragged_kvlen_block_gt_page", 100, [0, 37, 99], None, 32, 512, 1),
    ("widened_q", 96, [5, 40, 90], None, 32, 32, 3),
])
def test_paged_equals_dense_with_poisoned_dead_pages(name, T, idx, window, ps, bkv, S):
    """Paged == dense bit for bit on the same logical cache, through shuffled
    tables, with every page the schedule does not name poisoned with NaN —
    and both agree with the reference's paged kernel."""
    q, k, v = _qkv(6, len(idx), S, T, 4, 2, 64)
    index = torch.tensor(idx, dtype=torch.int32)
    eff = tdec.page_block_kv(min(bkv, 64), ps)
    dense = tops.flash_decode(t(q), t(k), t(v), index, window=window, block_kv=eff)
    pk, pv, tables = _pool_from_dense(k, v, ps)
    want = _jax_decode(q, pk, pv, idx, window=window, block_kv=bkv,
                       tables=jnp.asarray(tables), kv_len=T)
    live = set()
    for b, i in enumerate(idx):
        live |= {p for p, _ in tdec.paged_decode_schedule(
            T, i, bkv, ps, tables[b], window=window, q_span=S)}
    dead = [p for p in range(pk.shape[0]) if p not in live]
    assert dead
    pk[dead], pv[dead] = np.nan, np.nan
    paged = tops.flash_decode(t(q), t(pk), t(pv), index, window=window,
                              block_kv=bkv, tables=t(tables), kv_len=T)
    assert torch.equal(dense, paged)
    np.testing.assert_allclose(to_np(paged), want, **TOL)


def test_decode_ref_touches_only_scheduled_blocks():
    """Poison every dense-cache block outside `decode_schedule`: nothing
    changes, bit for bit."""
    T, bkv, idx, window = 128, 32, 70, 40
    q, k, v = _qkv(7, 1, 1, T, 4, 2, 64)
    index = torch.tensor([idx], dtype=torch.int32)
    out = tops.flash_decode(t(q), t(k), t(v), index, window=window, block_kv=bkv)
    sched = tdec.decode_schedule(T, idx, bkv, window=window)
    dead = [b for b in range(T // bkv) if b not in sched]
    assert dead
    for b in dead:
        k[:, b * bkv:(b + 1) * bkv] = np.nan
        v[:, b * bkv:(b + 1) * bkv] = np.nan
    out2 = tops.flash_decode(t(q), t(k), t(v), index, window=window, block_kv=bkv)
    assert torch.equal(out, out2)


def test_fold_unfold_and_paged_gather_match_reference():
    q, k, v = _qkv(8, 2, 3, 64, 8, 2, 64)
    folded = tops._fold_decode_q(t(q), 2)
    np.testing.assert_array_equal(to_np(folded), np.asarray(jops._fold_decode_q(jnp.asarray(q), 2)))
    assert torch.equal(tops._unfold_decode_o(folded, 2, 3, 8, 64, 2), t(q))
    pk, pv, tables = _pool_from_dense(k, v, 16)
    gk, gv = tops.paged_gather_kv(t(pk), t(pv), t(tables), 64)
    jk, jv = jops.paged_gather_kv(jnp.asarray(pk), jnp.asarray(pv), jnp.asarray(tables), 64)
    np.testing.assert_array_equal(to_np(gk), np.asarray(jk))
    np.testing.assert_array_equal(to_np(gv), np.asarray(jv))
    np.testing.assert_array_equal(to_np(gk), k)


# ---------------------------------------------------------------------------
# K4: rmsnorm
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("plus_one", [False, True])
def test_rmsnorm_ref_matches_pallas(plus_one):
    rng = np.random.default_rng(9)
    x = rng.standard_normal((3, 10, 256)).astype(np.float32)
    w = rng.standard_normal(256).astype(np.float32) * 0.1
    if plus_one:
        w = w + 1.0
    want = jax_rmsnorm(jnp.asarray(x), jnp.asarray(w), eps=1e-6, block_rows=8,
                       interpret=True)
    got = rmsnorm(t(x), t(w), eps=1e-6)
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)


# ---------------------------------------------------------------------------
# schedule oracles: the port's copies equal the reference's
# ---------------------------------------------------------------------------


def test_prefill_schedule_oracles_equal_reference():
    grid = itertools.product([1, 50, 128, 200], [64, 200], [16, 64], [16, 32, 64],
                             [True, False], [None, 8, 70], [True, False])
    n = 0
    for S, T, bq, bkv, causal, window, pruned in grid:
        kw = dict(causal=causal, window=window, pruned=pruned)
        assert tker.kv_schedule(S, T, bq, bkv, **kw) == jker.kv_schedule(S, T, bq, bkv, **kw)
        assert tker.kv_steps_for(S, T, bq, bkv, causal, window) == \
            jker.kv_steps_for(S, T, bq, bkv, causal, window)
        for iq, ik in [(0, 0), (1, 0), (2, 5), (0, 3)]:
            mk = dict(kv_len=T, causal=causal, window=window)
            assert tker.block_fully_masked(iq, ik, bq, bkv, **mk) == \
                jker.block_fully_masked(iq, ik, bq, bkv, **mk)
        n += 1
    assert n == 4 * 2 * 2 * 3 * 2 * 3 * 2


def test_decode_schedule_oracles_equal_reference():
    table = list(np.random.default_rng(0).permutation(64))
    grid = itertools.product([48, 100, 256], [0, 1, 47, 99, 255, 1000], [16, 64, 512],
                             [None, 8, 70], [True, False], [1, 4])
    for T, index, bkv, window, pruned, q_span in grid:
        kw = dict(window=window, pruned=pruned, q_span=q_span)
        assert tdec.decode_schedule(T, index, bkv, **kw) == \
            jdec.decode_schedule(T, index, bkv, **kw)
        assert tdec.decode_steps_for(T, bkv, window, q_span) == \
            jdec.decode_steps_for(T, bkv, window, q_span)
        for ps in (16, 96):
            assert tdec.page_block_kv(bkv, ps) == jdec.page_block_kv(bkv, ps)
            assert tdec.paged_decode_schedule(T, index, bkv, ps, table, **kw) == \
                jdec.paged_decode_schedule(T, index, bkv, ps, table, **kw)


# ---------------------------------------------------------------------------
# K2d: flash decode over an int8 / fp8 pool (the quantized mode)
# ---------------------------------------------------------------------------


def _codes(arr):
    """Reference codes (int8, or ml_dtypes fp8) -> a tensor of the same bytes."""
    a = np.asarray(arr)
    if a.dtype.kind == "i":
        return torch.tensor(a)
    return torch.from_numpy(a.view(np.uint8).copy()).view(getattr(torch, a.dtype.name))


def _quant_pool(dtype, lengths, ps=8, K=2, D=64, seed=11):
    """A linear pool built and quantized by the reference: both packages read
    the very same codes and scales."""
    from repro.runtime.pages import build_linear_pool, quantize_linear_pool

    rng = np.random.default_rng(seed)
    ks = [rng.standard_normal((L, K, D)).astype(np.float32) for L in lengths]
    vs = [rng.standard_normal((L, K, D)).astype(np.float32) for L in lengths]
    pk, pv, tables, _ = build_linear_pool(ks, vs, ps, max_len=max(lengths))
    qpk, qpv, ksc, vsc = quantize_linear_pool(pk, pv, dtype)
    return qpk, qpv, np.asarray(ksc), np.asarray(vsc), np.asarray(tables)


def _rms_close(got, want, rel):
    err = np.abs(got - want).max()
    assert err <= rel * np.sqrt(np.mean(want ** 2)), (err, rel)


@pytest.mark.parametrize("dtype,S,qdt,rel", [
    ("int8", 1, torch.float32, 1e-4),
    ("float8_e4m3fn", 1, torch.float32, 1e-4),
    ("int8", 4, torch.float32, 1e-4),
    ("int8", 1, torch.bfloat16, 2e-2),
    ("float8_e4m3fn", 4, torch.bfloat16, 2e-2),
])
def test_quantized_paged_decode_ref_matches_pallas(dtype, S, qdt, rel):
    lengths = (13, 27, 40)
    qpk, qpv, ksc, vsc, tables = _quant_pool(dtype, lengths)
    B, H, D = len(lengths), 4, qpk.shape[-1]
    q = np.random.default_rng(1).standard_normal((B, S, H, D)).astype(np.float32)
    if qdt == torch.bfloat16:
        q = np.asarray(jnp.asarray(q, jnp.bfloat16).astype(jnp.float32))
    idx = [L - S for L in lengths]
    want = np.asarray(jops.flash_decode(
        jnp.asarray(q, jnp.float32 if qdt == torch.float32 else jnp.bfloat16), qpk, qpv,
        jnp.asarray(idx, jnp.int32), tables=jnp.asarray(tables), kv_len=max(lengths),
        block_kv=8, k_scale=jnp.asarray(ksc), v_scale=jnp.asarray(vsc),
        interpret=True).astype(jnp.float32))
    got = tops.flash_decode(t(q, qdt), _codes(qpk), _codes(qpv),
                            torch.tensor(idx, dtype=torch.int32), tables=t(tables),
                            kv_len=max(lengths), block_kv=8, k_scale=t(ksc), v_scale=t(vsc))
    assert got.dtype == qdt
    _rms_close(to_np(got), want, rel)


@pytest.mark.parametrize("dtype", ["int8", "float8_e4m3fn"])
def test_quantized_dense_decode_ref_matches_pallas_and_paged(dtype):
    """A dense (B, T, K, D) cache of codes with (B, NP, K) scales, one row per
    `scale_page` slots, equals the reference kernel — and, bit for bit, the
    paged walk over the same codes and scales with every dead page poisoned."""
    B, T, H, K, D, sp = 2, 64, 4, 2, 64, 16
    rng = np.random.default_rng(5)
    k = rng.standard_normal((B, T, K, D)).astype(np.float32)
    v = rng.standard_normal((B, T, K, D)).astype(np.float32)
    q = rng.standard_normal((B, 1, H, D)).astype(np.float32)
    jdt = jops.resolve_cache_dtype(dtype)
    nk, nv = jnp.asarray(k).reshape(B, T // sp, sp, K, D), jnp.asarray(v).reshape(B, T // sp, sp, K, D)
    ksc = jops.kv_scale_from_absmax(jnp.max(jnp.abs(nk), axis=(2, 4)), jdt)
    vsc = jops.kv_scale_from_absmax(jnp.max(jnp.abs(nv), axis=(2, 4)), jdt)
    qk = jops.quantize_kv_write(nk, ksc[:, :, None, :], jdt).reshape(B, T, K, D)
    qv = jops.quantize_kv_write(nv, vsc[:, :, None, :], jdt).reshape(B, T, K, D)
    idx = [T - 1, T - 9]
    want = np.asarray(jops.flash_decode(
        jnp.asarray(q), qk, qv, jnp.asarray(idx, jnp.int32), block_kv=16,
        k_scale=ksc, v_scale=vsc, scale_page=sp, interpret=True))
    index = torch.tensor(idx, dtype=torch.int32)
    got = tops.flash_decode(t(q), _codes(qk), _codes(qv), index, block_kv=16,
                            k_scale=t(np.asarray(ksc)), v_scale=t(np.asarray(vsc)),
                            scale_page=sp)
    _rms_close(to_np(got), want, 1e-4)
    # the same codes as a shuffled pool of sp-slot pages; dead pages poisoned
    nb = T // sp
    perm = np.random.default_rng(3).permutation(B * nb + 2)[:B * nb]
    pk = torch.zeros((B * nb + 2, sp, K, D), dtype=_codes(qk).dtype)
    pv = torch.zeros_like(pk)
    pks = torch.full((B * nb + 2, K), float("nan"))
    pvs = torch.full_like(pks, float("nan"))
    pk[perm] = _codes(qk).reshape(B * nb, sp, K, D)
    pv[perm] = _codes(qv).reshape(B * nb, sp, K, D)
    pks[perm] = t(np.asarray(ksc)).reshape(B * nb, K)
    pvs[perm] = t(np.asarray(vsc)).reshape(B * nb, K)
    tables = t(perm.reshape(B, nb).astype(np.int32))
    paged = tops.flash_decode(t(q), pk, pv, index, block_kv=16, tables=tables, kv_len=T,
                              k_scale=pks, v_scale=pvs)
    assert torch.equal(got, paged)


@pytest.mark.parametrize("dtype", sorted(tops.CACHE_QMAX))
def test_quant_primitives_match_reference(dtype):
    """Scales within 1e-6 relative; codes equal, save int8 codes one apart
    where the two fp32 quotients x / s differ by an ulp; dequant equal."""
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((16, 2, 8)) * 3).astype(np.float32)
    absmax = np.abs(x).max(axis=(0, 2))
    jdt = jops.resolve_cache_dtype(dtype)
    tdt = tops.resolve_cache_dtype(dtype)
    assert str(tdt) == f"torch.{dtype}"
    jsc = np.asarray(jops.kv_scale_from_absmax(jnp.asarray(absmax), jdt))
    tsc = to_np(tops.kv_scale_from_absmax(t(absmax), tdt))
    np.testing.assert_allclose(tsc, jsc, rtol=1e-6, atol=0)
    jq = jops.quantize_kv_write(jnp.asarray(x), jnp.asarray(jsc)[None, :], jdt)
    tq = tops.quantize_kv_write(t(x), t(jsc)[None, :], tdt)
    jcode = np.asarray(jq.astype(jnp.float32))
    tcode = to_np(tq)
    if dtype == "int8":
        diff = np.abs(jcode - tcode)
        assert diff.max() <= 1
        quot = x / jsc[None, :, None]
        off = diff > 0
        # only where the quotient sits within an ulp of a rounding boundary
        assert np.all(np.abs(np.abs(quot[off] - np.floor(quot[off])) - 0.5)
                      <= np.spacing(np.abs(quot[off])))
    else:
        np.testing.assert_array_equal(tcode, jcode)
    np.testing.assert_array_equal(
        to_np(tops.dequantize_kv(_codes(jq), t(jsc)[None, :])),
        np.asarray(jops.dequantize_kv(jq, jnp.asarray(jsc)[None, :])))
    assert tops.cache_qmax(tdt) == jops.cache_qmax(dtype)
    zero = tops.quantize_kv_write(t(x), torch.zeros(16, 2), tdt)  # free-page sentinel
    assert torch.isfinite(zero.float()).all()
    assert tops.resolve_cache_dtype("float16") is None and tops.resolve_cache_dtype(None) is None


def test_quantized_gather_dequantizes_like_reference():
    qpk, qpv, ksc, vsc, tables = _quant_pool("int8", (5, 19, 32), D=16)
    gk, gv = tops.paged_gather_kv(_codes(qpk), _codes(qpv), t(tables), 32,
                                  k_scale=t(ksc), v_scale=t(vsc))
    jk, jv = jops.paged_gather_kv(qpk, qpv, jnp.asarray(tables), 32,
                                  k_scale=jnp.asarray(ksc), v_scale=jnp.asarray(vsc))
    np.testing.assert_array_equal(to_np(gk), np.asarray(jk))
    np.testing.assert_array_equal(to_np(gv), np.asarray(jv))
