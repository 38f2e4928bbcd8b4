"""K2's block mode, without a mesh: a rank's share of a sequence-split cache
(`decode_ref(..., block=(sub, span, phase))`, `decode.share_count`) returns
its partial attention and lse, and the shares merged in rank order
(`collectives.merge_attention`) give the whole cache's attention.

For a dense linear, a windowed and a ring cache, a paged pool (shuffled
tables) and a paged ring, an int8 and an e4m3 pool, a widened q of three
tokens and a cross-attention at index T - 1, cut into n = 2 and n = 4
shares: the merge equals the whole call within 1e-6 (fp32); each share's
lse matches a float64 log-sum-exp over the slots it holds and sees, and a
row that sees none of them gives o = 0 and lse = -inf exactly; the merge
matches the reference's `flash_decode` on the whole cache (its Pallas
kernel in interpret mode) within 1e-5; the whole-cache call is bit for bit
a frozen copy of the plain version as it stood before the block mode."""

import math

import numpy as np
import pytest
import torch

from repro_torch.distributed.collectives import merge_attention
from repro_torch.kernels.flash_attention.decode import (decode_schedule, page_block_kv,
                                                        share_count, share_slots)
from repro_torch.kernels.flash_attention.kernel import MAX_BLOCK_KV
from repro_torch.kernels.flash_attention.ref import _masked_softmax_pv, decode_ref

B, H, K, D, T, PS = 3, 4, 2, 16, 64, 8
MODES = ["dense", "window", "ring", "paged", "paged_ring", "int8", "e4m3", "widened_s3",
         "cross"]
SHARES = [2, 4]


def _codes(arr):
    """Reference codes (int8, or ml_dtypes fp8) -> a tensor of the same bytes."""
    a = np.asarray(arr)
    if a.dtype.kind == "i":
        return torch.tensor(a)
    return torch.from_numpy(a.view(np.uint8).copy()).view(getattr(torch, a.dtype.name))


def case(mode):
    """(q, k, v, index, kwargs, logical (B, T, K, D) float64 K and V, the
    live mask of each (request, token) over the logical slots, and the
    reference's arrays) for one mode, from a seed."""
    rng = np.random.default_rng(MODES.index(mode))
    S = 3 if mode == "widened_s3" else 1
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    window, ring = (12 if mode == "window" else None), mode in ("ring", "paged_ring")
    Tc = 32 if ring or mode == "cross" else T
    idx = {"ring": [7, 31, 100], "paged_ring": [5, 40, 33], "cross": [Tc - 1] * B,
           "widened_s3": [0, 30, T - 3]}.get(mode, [2, 40, T - 1])
    if mode in ("int8", "e4m3"):
        from repro.runtime.pages import build_linear_pool, quantize_linear_pool

        dt = "int8" if mode == "int8" else "float8_e4m3fn"
        ks = [rng.standard_normal((i + 1, K, D)).astype(np.float32) for i in idx]
        vs = [rng.standard_normal((i + 1, K, D)).astype(np.float32) for i in idx]
        pk, pv, tables, _ = build_linear_pool(ks, vs, PS, max_len=T)
        qpk, qpv, ksc, vsc = quantize_linear_pool(pk, pv, dt)
        tables, ksc, vsc = (np.asarray(x) for x in (tables, ksc, vsc))
        k, v = _codes(qpk), _codes(qpv)
        kw = dict(tables=torch.tensor(tables), kv_len=T, k_scale=torch.tensor(ksc),
                  v_scale=torch.tensor(vsc))
        order = torch.tensor(tables, dtype=torch.long)
        lk = (k.double() * kw["k_scale"].double()[:, None, :, None])[order]
        lv = (v.double() * kw["v_scale"].double()[:, None, :, None])[order]
        lk, lv = lk.reshape(B, -1, K, D)[:, :T], lv.reshape(B, -1, K, D)[:, :T]
        ref = dict(k=qpk, v=qpv, tables=tables, k_scale=ksc, v_scale=vsc, kv_len=T)
    else:
        lk = torch.tensor(rng.standard_normal((B, Tc, K, D)), dtype=torch.float64)
        lv = torch.tensor(rng.standard_normal((B, Tc, K, D)), dtype=torch.float64)
        k, v = lk.float(), lv.float()
        kw = dict(window=window)
        ref = dict(k=k.numpy(), v=v.numpy(), window=window)
        if mode in ("paged", "paged_ring"):  # shuffled pages, four spare
            nb = Tc // PS
            perm = rng.permutation(B * nb + 4)[:B * nb]
            pool_k = torch.zeros((B * nb + 4, PS, K, D))
            pool_v = torch.zeros_like(pool_k)
            pool_k[perm] = k.reshape(B * nb, PS, K, D)
            pool_v[perm] = v.reshape(B * nb, PS, K, D)
            tables = torch.tensor(perm.reshape(B, nb), dtype=torch.int32)
            k, v = pool_k, pool_v
            kw = dict(tables=tables, kv_len=Tc)
            ref = dict(k=k.numpy(), v=v.numpy(), tables=tables.numpy(), kv_len=Tc)
    slots = np.arange(lk.shape[1])
    live = np.zeros((B, S, lk.shape[1]), bool)
    for b, i in enumerate(idx):
        for s in range(S):
            p = i + s
            if ring:
                live[b, s] = slots < min(Tc, p + 1)
            elif mode == "cross":
                live[b, s] = True
            else:
                live[b, s] = (slots <= p) & ((slots > p - window) if window else True)
    return (torch.tensor(q), k, v, torch.tensor(idx, dtype=torch.int32), kw, lk, lv,
            live, ref)


def shares(k, v, kw, n):
    """Each rank's share of n: its cache or pool slots, kwargs and block."""
    span = k.shape[1]  # the page, or the dense cache
    sub = span // n
    return [(k[:, r * sub:(r + 1) * sub].contiguous(), v[:, r * sub:(r + 1) * sub].contiguous(),
             kw, (sub, span, r * sub)) for r in range(n)]


def _merged(mode, n):
    q, k, v, idx, kw, *_ = case(mode)
    parts = [decode_ref(q, ks, vs, idx, block=blk, **skw)
             for ks, vs, skw, blk in shares(k, v, kw, n)]
    return merge_attention(torch.stack([o for o, _ in parts]),
                           torch.stack([lse for _, lse in parts]))


@pytest.mark.parametrize("n", SHARES)
@pytest.mark.parametrize("mode", MODES)
def test_merged_shares_equal_the_whole_call(mode, n):
    q, k, v, idx, kw, *_ = case(mode)
    whole = decode_ref(q, k, v, idx, **kw)
    torch.testing.assert_close(_merged(mode, n), whole, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("n", SHARES)
@pytest.mark.parametrize("mode", MODES)
def test_each_shares_lse_is_the_float64_log_sum_exp_of_what_it_holds(mode, n):
    q, k, v, idx, kw, lk, _, live, _ = case(mode)
    S, Tl = q.shape[1], lk.shape[1]
    qf = q.double().reshape(B, S, K, H // K, D)
    scores = torch.einsum("bskgd,btkd->bskgt", qf, lk) / math.sqrt(D)
    empty = 0
    for ks, vs, skw, blk in shares(k, v, kw, n):
        o, lse = decode_ref(q, ks, vs, idx, block=blk, **skw)
        held = share_slots(share_count(Tl - 1, blk), blk).numpy()
        mine = np.zeros(Tl, bool)
        mine[held] = True
        for b in range(B):
            for s in range(S):
                sees = torch.tensor(live[b, s] & mine)
                row = lse[b, s].reshape(K, H // K)
                if not sees.any():  # the share holds none of the row's slots
                    assert bool((o[b, s] == 0).all())
                    assert bool((lse[b, s] == -math.inf).all())
                    empty += 1
                    continue
                want = torch.logsumexp(scores[b, s][..., sees], dim=-1)
                np.testing.assert_allclose(row.numpy(), want.numpy(), rtol=0, atol=1e-5)
    if mode != "cross" and (mode, n) != ("paged_ring", 2):
        assert empty > 0  # request 0's few slots lie in the first shares


@pytest.mark.parametrize("mode", MODES)
def test_the_merge_matches_the_reference_on_the_whole_cache(mode):
    import jax.numpy as jnp
    from repro.kernels.flash_attention import ops as jops

    q, _, _, idx, _, _, _, _, ref = case(mode)
    jkw = {key: (jnp.asarray(val) if isinstance(val, np.ndarray) else val)
           for key, val in ref.items() if key not in ("k", "v")}
    want = np.asarray(jops.flash_decode(jnp.asarray(q.numpy()), ref["k"], ref["v"],
                                        jnp.asarray(idx.numpy()), block_kv=PS,
                                        interpret=True, **jkw))
    np.testing.assert_allclose(_merged(mode, 2).numpy(), want, rtol=1e-5, atol=1e-5)


def _frozen_decode_ref(q, k_cache, v_cache, index, *, window=None, softcap=None,
                       block_kv=MAX_BLOCK_KV, pruned=True, tables=None, kv_len=None,
                       k_scale=None, v_scale=None, scale_page=None):
    """The plain version's whole-cache decode as it stood before the block
    mode (kept here as the oracle of the whole-cache call's bits)."""
    B_, S, H_, D_ = q.shape
    K_ = k_cache.shape[2]
    G = H_ // K_
    paged, quant = tables is not None, k_scale is not None
    if paged:
        T_, page_size = int(kv_len), k_cache.shape[1]
        bkv = page_block_kv(min(int(block_kv), MAX_BLOCK_KV), page_size)
    else:
        T_ = k_cache.shape[1]
        bkv = max(1, min(int(block_kv), MAX_BLOCK_KV, T_))
        if quant:
            bkv = page_block_kv(bkv, scale_page)
    idx = [int(i) for i in torch.as_tensor(index).reshape(-1).expand(B_).tolist()]
    scale = 1.0 / math.sqrt(D_)
    acc = torch.float64 if q.dtype == torch.float64 else torch.float32
    off = torch.arange(S)[:, None]
    outs = []
    for b in range(B_):
        blocks = decode_schedule(T_, idx[b], bkv, window=window, pruned=pruned, q_span=S)
        slots = torch.arange(blocks[0] * bkv, min((blocks[-1] + 1) * bkv, T_))
        if paged:
            page = tables[b].to(torch.long)[slots // page_size]
            kb, vb = k_cache[page, slots % page_size], v_cache[page, slots % page_size]
            if quant:
                kb = kb.to(torch.float32) * k_scale[page][..., None]
                vb = vb.to(torch.float32) * v_scale[page][..., None]
        else:
            kb, vb = k_cache[b, slots], v_cache[b, slots]
            if quant:
                row = slots // scale_page
                kb = kb.to(torch.float32) * k_scale[b, row][..., None]
                vb = vb.to(torch.float32) * v_scale[b, row][..., None]
        qf = q[b].to(acc).reshape(S, K_, G, D_)
        s_ = torch.einsum("skgd,tkd->kgst", qf, kb.to(acc)) * scale
        if softcap is not None:
            s_ = torch.tanh(s_ / softcap) * softcap
        live = torch.clamp(idx[b] + off + 1, 1, T_)
        mask = slots[None, :] < live
        if window is not None:
            mask = mask & (slots[None, :] > idx[b] + off - window)
        pv, l, _ = _masked_softmax_pv(s_, mask, vb.to(acc), "kgst,tkd->kgsd")
        out = pv / torch.clamp(l, min=1e-30)
        outs.append(out.permute(2, 0, 1, 3).reshape(S, H_, D_))
    return torch.stack(outs).to(q.dtype)


@pytest.mark.parametrize("mode", MODES)
def test_the_whole_cache_call_keeps_its_bits(mode):
    q, k, v, idx, kw, *_ = case(mode)
    assert torch.equal(decode_ref(q, k, v, idx, **kw), _frozen_decode_ref(q, k, v, idx, **kw))
    assert torch.equal(decode_ref(q, k, v, idx, block=None, **kw),
                       decode_ref(q, k, v, idx, **kw))
