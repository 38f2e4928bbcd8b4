"""PyTorch port, the tensor-core route of K1 and K3: which route each type
pair takes, the tiles a requested block maps to, the split of the dk / dv
pass's GQA group across blocks (its schedule against the reference's
transposed oracle, the choice of `n_split`, the ordered reduce of the
partials), and the schedules at the route's tiles against the reference's
oracles — all framework-free and run on the CPU — and the float64 plain
version of K2's widened q.  The `gpu`-marked tests hold the kernels
themselves against their plain versions on the card, and K2's tensor-core
mode to K1's rows bit for bit
(`python3 chip_smoke.py` does so at the main path's shapes); without a card
they skip.  The reference package is imported inside the CPU tests only, so
that the card's run needs no JAX."""

import itertools

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import kernel as tker
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import attention_ref, flash_attention_bwd_ref

# worst error of a bf16 kernel output, as a share of the plain output's RMS
# (chip_smoke.py's gate), and of an fp32 one
BF16_TOL, FP32_TOL = 5e-2, 1e-4

SCHEDULE_CASES = [  # S, T, causal, window, pruned
    (1024, 1024, True, None, True),
    (1024, 1024, True, 256, True),
    (1000, 1000, True, None, True),   # ragged
    (1000, 1000, True, 130, True),    # ragged and windowed
    (640, 640, True, None, False),    # streamed, computed where reachable
    (512, 512, False, None, True),    # non-causal
]


def _reference_kernel():
    from repro.kernels.flash_attention import kernel as jker

    return jker


# ---------------------------------------------------------------------------
# routes and tiles
# ---------------------------------------------------------------------------


def test_route_for_each_type_pair():
    bf16, f32 = torch.bfloat16, torch.float32
    assert tker.attention_route(bf16, bf16) == "tc"
    assert tker.attention_route(f32, f32) == "fma"
    assert tker.attention_route(bf16, f32) == "fma"  # a dequantized page pool


@pytest.mark.parametrize("req", [(1, 1), (16, 32), (64, 64), (128, 128), (512, 1024)])
def test_requested_blocks_map_to_the_route_tiles(req):
    assert tker.route_blocks("tc", *req) == (tker.TC_BLOCK_Q, tker.TC_BLOCK_KV)
    assert tker.route_blocks("tc", *req, backward=True) == \
        (tker.TC_BLOCK_Q_BWD, tker.TC_BLOCK_KV_BWD)
    # the FMA route keeps the request, clamped to its capacity
    assert tker.route_blocks("fma", *req) == \
        (min(req[0], tker.MAX_BLOCK_Q), min(req[1], tker.MAX_BLOCK_KV))
    assert tker.route_blocks("fma", *req, backward=True) == \
        (min(req[0], tker.MAX_BLOCK_Q_BWD), min(req[1], tker.MAX_BLOCK_KV_BWD))
    assert tker.route_blocks("fma", 0, -3) == (1, 1)


@pytest.mark.parametrize("B,K,T,G,want", [
    (2, 1, 1024, 8, 8),    # gemma-2b's microbatch: 32 blocks a split, never 264
    (1, 4, 2048, 8, 4),    # yi-6b at S 2048: 128 -> 512 blocks
    (1, 1, 3000, 10, 10),  # recurrentgemma-2b's local attention
    (8, 8, 4096, 4, 1),    # enough blocks already
    (1, 1, 64, 1, 1),      # no group to split
    (1, 2, 1024, 6, 6),    # 32 blocks: 6 gives 192, the most there is
    (4, 1, 1024, 6, 6),
    (4, 2, 1024, 6, 3),    # 128 blocks: 2 gives 256, 3 gives 384
])
def test_n_split_is_the_smallest_divisor_that_fills_the_card(B, K, T, G, want):
    sms = 132
    got = tker.dkv_n_split(B, K, T, G, sms)
    assert got == want and G % got == 0
    blocks = B * K * tker.cdiv(T, tker.TC_BLOCK_KV_BWD)
    target = tker.TC_DKV_BLOCKS_PER_SM * sms
    smaller = [n for n in range(1, got) if G % n == 0]
    assert all(blocks * n < target for n in smaller)
    assert blocks * got >= target or got == G


# ---------------------------------------------------------------------------
# the split dk / dv walk
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("G", [1, 2, 8])
@pytest.mark.parametrize("S,T,causal,window,pruned", SCHEDULE_CASES)
def test_dkv_split_schedule_covers_each_live_triple_once(S, T, causal, window, pruned, G):
    jker = _reference_kernel()
    bq, bkv = tker.TC_BLOCK_Q_BWD, tker.TC_BLOCK_KV_BWD
    nq, nk = tker.cdiv(S, bq), tker.cdiv(T, bkv)
    oracle = jker.q_schedule(S, T, bq, bkv, causal=causal, window=window, pruned=pruned)
    for n_split in [n for n in range(1, G + 1) if G % n == 0]:
        sched = tker.dkv_split_schedule(S, T, G, n_split, bq, bkv, causal=causal,
                                        window=window, pruned=pruned)
        assert len(sched) == nk and all(len(row) == n_split for row in sched)
        for ik in range(nk):
            seen = [pair for split in sched[ik] for pair in split]
            assert len(seen) == len(set(seen))  # no pair walked twice
            # each split walks whole heads, each over the oracle's q blocks
            # from the last back to the first
            heads = [sorted({g for g, _ in split}) for split in sched[ik]]
            assert sorted(h for hs in heads for h in hs) == list(range(G))
            assert all(len(hs) == G // n_split for hs in heads)
            for g in range(G):
                assert [iq for gg, iq in seen if gg == g] == oracle[ik][::-1]
            # every live (q head, q block, KV block) triple is covered once
            for g, iq in itertools.product(range(G), range(nq)):
                live = not tker.block_fully_masked(
                    iq, ik, bq, bkv, kv_len=T, causal=causal, window=window)
                if live:
                    assert seen.count((g, iq)) == 1


@pytest.mark.parametrize("S,T,causal,window,pruned", SCHEDULE_CASES)
def test_schedules_at_the_tensor_core_tiles_equal_the_reference(S, T, causal, window,
                                                                pruned):
    jker = _reference_kernel()
    kw = dict(causal=causal, window=window, pruned=pruned)
    bq, bkv = tker.TC_BLOCK_Q, tker.TC_BLOCK_KV  # the forward's tiles
    assert tker.kv_schedule(S, T, bq, bkv, **kw) == jker.kv_schedule(S, T, bq, bkv, **kw)
    bq, bkv = tker.TC_BLOCK_Q_BWD, tker.TC_BLOCK_KV_BWD
    assert tker.kv_schedule(S, T, bq, bkv, **kw) == jker.kv_schedule(S, T, bq, bkv, **kw)
    assert tker.q_schedule(S, T, bq, bkv, **kw) == jker.q_schedule(S, T, bq, bkv, **kw)


@pytest.mark.parametrize("HK,n_split", [((8, 1), 8), ((8, 1), 2), ((8, 2), 4), ((6, 3), 2)])
def test_ordered_split_reduce_equals_the_unsplit_sum(HK, n_split):
    """The kernel's reduce, emulated: each split's fp32 partial dk / dv is
    the plain backward over its share of every group's q heads; added in
    split order they give the unsplit group sum within fp32 rounding."""
    H, K = HK
    G = H // K
    per = G // n_split
    rng = np.random.default_rng(3)
    B, S, D = 2, 96, 32
    q, out, do = (torch.tensor(rng.standard_normal((B, S, H, D)), dtype=torch.float32)
                  for _ in range(3))
    k, v = (torch.tensor(rng.standard_normal((B, S, K, D)), dtype=torch.float32)
            for _ in range(2))
    kw = dict(causal=True, window=40, softcap=20.0)
    _, lse = attention_ref(q, k, v, return_lse=True, **kw)
    _, dk, dv = flash_attention_bwd_ref(q, k, v, out, lse, do, **kw)
    sk = sv = None
    for s in range(n_split):
        heads = [kh * G + g for kh in range(K) for g in range(s * per, (s + 1) * per)]
        _, pk, pv = flash_attention_bwd_ref(q[:, :, heads], k, v, out[:, :, heads],
                                            lse[:, heads], do[:, :, heads], **kw)
        sk = pk if sk is None else sk + pk
        sv = pv if sv is None else sv + pv
    torch.testing.assert_close(sk, dk, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(sv, dv, rtol=1e-5, atol=1e-5)


def test_entry_point_route_codes():
    import ctypes

    from repro_torch.kernels import build

    assert build.route_out().value == -1  # nothing launched yet
    assert build.route_name(ctypes.c_int(1)) == "tc"
    assert build.route_name(ctypes.c_int(0)) == "fma"
    with pytest.raises(KeyError):
        build.route_name(ctypes.c_int(-1))


@pytest.mark.parametrize("P,S,window,ps", [(64, 150, None, 64), (100, 173, 40, 32)])
def test_widened_decode_plain_version_in_float64_is_the_prefill_rows(P, S, window, ps):
    """The float64 plain version `chip_smoke.py` holds K2's tensor-core mode
    to: widened decode over a shuffled page pool keeps float64 and gives the
    whole-prompt attention's rows P.. (the identity the tensor-core mode
    keeps bit for bit)."""
    from repro_torch.kernels.flash_attention.ref import decode_ref

    rng = np.random.default_rng(3)
    H, K, D = 4, 2, 16
    q = torch.tensor(rng.standard_normal((1, S, H, D)))
    k, v = (torch.tensor(rng.standard_normal((1, S, K, D))) for _ in range(2))
    nb = -(-S // ps)
    perm = torch.tensor(rng.permutation(nb + 3)[:nb])
    pk = torch.full((nb + 3, ps, K, D), float("nan"), dtype=torch.float64)
    pv = pk.clone()
    pad = torch.zeros((1, nb * ps - S, K, D), dtype=torch.float64)
    pk[perm] = torch.cat([k, pad], 1).reshape(nb, ps, K, D)
    pv[perm] = torch.cat([v, pad], 1).reshape(nb, ps, K, D)
    tables = perm[None].to(torch.int32)
    got = decode_ref(q[:, P:], pk, pv, torch.tensor([P]), window=window, tables=tables,
                     kv_len=S)
    want = attention_ref(q, k, v, causal=True, window=window)[:, P:]
    assert got.dtype == torch.float64
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


def test_cpu_tensors_count_no_route():
    before = (ops.flash_attention.tc_launches, ops.flash_attention.fma_launches,
              ops.flash_attention_bwd.tc_launches, ops.flash_attention_bwd.fma_launches)
    q = torch.randn(1, 16, 2, 16, dtype=torch.bfloat16, requires_grad=True)
    k = torch.randn(1, 16, 1, 16, dtype=torch.bfloat16, requires_grad=True)
    out = ops.flash_attention(q, k, k)
    out.float().sum().backward()
    assert (ops.flash_attention.tc_launches, ops.flash_attention.fma_launches,
            ops.flash_attention_bwd.tc_launches, ops.flash_attention_bwd.fma_launches) == before


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    return gen


def _exact(fn, tensors, dtypes, **kw):
    """The plain version in float64, each output rounded once to its type
    (as chip_smoke.py holds the tensor-core route)."""
    out = fn(*(x.double() for x in tensors), **kw)
    return tuple(o.to(d) for o, d in zip(out, dtypes)) if isinstance(out, tuple) \
        else out.to(dtypes)


def _close(name, got, want, tol):
    assert got.shape == want.shape and got.dtype == want.dtype, name
    assert torch.isfinite(got).all(), f"{name}: not finite"
    err = (got.float() - want.float()).abs().max().item()
    rms = want.float().pow(2).mean().sqrt().item()
    assert err <= tol * rms, f"{name}: max abs error {err} over {tol} of RMS {rms}"


FWD_CARD_CASES = [  # B, S, T, H, K, D, kw
    (1, 300, 300, 4, 2, 64, dict(causal=True)),
    (2, 257, 257, 8, 1, 256, dict(causal=True)),
    (1, 200, 200, 6, 3, 128, dict(causal=True, window=70)),
    (1, 190, 190, 4, 1, 16, dict(causal=True)),           # reduced head_dim, padded
    (1, 130, 130, 2, 2, 96, dict(causal=True, softcap=5.0)),
    (1, 170, 170, 4, 2, 128, dict(causal=True, pruned=False)),
    (1, 100, 150, 4, 2, 64, dict(causal=False)),
    (1, 230, 40, 2, 1, 64, dict(causal=True, window=50)),  # rows past T + window: masked
]


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,T,H,K,D,kw", FWD_CARD_CASES)
def test_tensor_core_forward_matches_the_plain_version_on_the_card(B, S, T, H, K, D, kw):
    gen = _card()
    q = torch.randn((B, S, H, D), generator=gen, device="cuda").to(torch.bfloat16)
    k, v = (torch.randn((B, T, K, D), generator=gen, device="cuda").to(torch.bfloat16)
            for _ in range(2))
    ref_kw = {a: b for a, b in kw.items() if a != "pruned"}
    before = (ops.flash_attention.tc_launches, ops.flash_attention.fma_launches)
    out, lse = tker.flash_attention_fwd(q, k, v, return_lse=True, **kw)
    got = ops.flash_attention(q, k, v, **kw)
    assert (ops.flash_attention.tc_launches - before[0],
            ops.flash_attention.fma_launches - before[1]) == (1, 0)
    want, want_lse = _exact(attention_ref, (q, k, v), (q.dtype, torch.float32),
                            return_lse=True, **ref_kw)
    torch.cuda.synchronize()
    assert torch.equal(out, got)
    _close("out", out, want, BF16_TOL)
    live = want_lse > -1e29  # fully masked rows: output 0, lse at -1e30
    torch.testing.assert_close(lse[live], want_lse[live], rtol=1e-4, atol=1e-4)
    assert torch.equal(out.transpose(1, 2)[~live], torch.zeros_like(out.transpose(1, 2)[~live]))
    assert (lse[~live] < -1e29).all()


BWD_CARD_CASES = [  # B, S, H, K, D, kw: n_split at 132 SMs is the group, 8 / 2 / 1 / 3
    (2, 200, 8, 1, 256, dict(causal=True)),
    (1, 300, 4, 2, 128, dict(causal=True, window=70)),
    (1, 150, 4, 4, 64, dict(causal=True, softcap=5.0)),
    (1, 130, 6, 2, 16, dict(causal=True)),              # reduced head_dim, padded
    (1, 160, 4, 2, 96, dict(causal=False)),
    (1, 190, 2, 1, 128, dict(causal=True, pruned=False)),
]


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,H,K,D,kw", BWD_CARD_CASES)
def test_tensor_core_backward_matches_the_plain_version_on_the_card(B, S, H, K, D, kw):
    gen = _card()
    q, do = (torch.randn((B, S, H, D), generator=gen, device="cuda").to(torch.bfloat16)
             for _ in range(2))
    k, v = (torch.randn((B, S, K, D), generator=gen, device="cuda").to(torch.bfloat16)
            for _ in range(2))
    ref_kw = {a: b for a, b in kw.items() if a != "pruned"}
    out, lse = tker.flash_attention_fwd(q, k, v, return_lse=True, **kw)
    got = tker.flash_attention_bwd(q, k, v, out, lse, do, **kw)
    again = tker.flash_attention_bwd(q, k, v, out, lse, do, **kw)
    want = _exact(flash_attention_bwd_ref, (q, k, v, out, lse, do), (q.dtype,) * 3, **ref_kw)
    torch.cuda.synchronize()
    for name, a, b, w in zip(("dq", "dk", "dv"), got, again, want):
        assert torch.equal(a, b), f"{name}: two calls differ"
        _close(name, a, w, BF16_TOL)


@pytest.mark.gpu
def test_fp32_and_mixed_types_take_the_fma_route_on_the_card():
    gen = _card()
    q32 = torch.randn((1, 100, 4, 64), generator=gen, device="cuda")
    k32, v32 = (torch.randn((1, 100, 2, 64), generator=gen, device="cuda") for _ in range(2))
    before = (ops.flash_attention.tc_launches, ops.flash_attention.fma_launches)
    for q in (q32, q32.to(torch.bfloat16)):
        got = ops.flash_attention(q, k32, v32, causal=True)
        _close("fma", got, attention_ref(q, k32, v32, causal=True),
               FP32_TOL if q.dtype == torch.float32 else BF16_TOL)
    assert (ops.flash_attention.tc_launches - before[0],
            ops.flash_attention.fma_launches - before[1]) == (0, 2)


WIDENED_CARD_CASES = [  # prompt S, prefix P, H, K, D, window, page (None: dense)
    (1224, 1024, 8, 2, 128, None, 128),
    (1000, 613, 4, 1, 256, None, 64),    # a suffix off the 64-row grid
    (700, 300, 6, 3, 64, 200, 32),       # windowed, pages smaller than a tile
    (260, 190, 4, 2, 16, None, None),    # reduced head_dim, padded; dense cache
]


@pytest.mark.gpu
@pytest.mark.parametrize("S,P,H,K,D,window,ps", WIDENED_CARD_CASES)
def test_widened_decode_rows_equal_the_prefill_rows_on_the_card(S, P, H, K, D, window, ps):
    """K2's tensor-core mode (bf16 q over bf16 values, S > 1 tokens) runs
    K1's body: its rows of a suffix over a resident prefix equal K1's rows of
    the whole prompt bit for bit, so a prefix-shared and an unshared
    admission write the same rows.  Both entry points report the tensor-core
    route; a single token takes the split route."""
    from repro_torch.kernels.flash_attention.decode import flash_decode_fwd
    from repro_torch.kernels.flash_attention.ops import flash_decode
    from repro_torch.runtime.pages import build_linear_pool

    gen = _card()
    q = torch.randn((1, S, H, D), generator=gen, device="cuda").to(torch.bfloat16)
    k, v = (torch.randn((S, K, D), generator=gen, device="cuda").to(torch.bfloat16)
            for _ in range(2))
    index = torch.tensor([P], dtype=torch.int32, device="cuda")
    full = ops.flash_attention(q, k[None], v[None], causal=True, window=window)
    assert tker.flash_attention_fwd.last_route == "tc"
    before = ops.flash_decode.tc_launches
    if ps is None:
        suffix = flash_decode(q[:, P:], k[None], v[None], index, window=window)
    else:
        pk, pv, tables, _ = build_linear_pool([k], [v], ps, max_len=S,
                                              num_pages=-(-S // ps) + 4)
        suffix = flash_decode(q[:, P:], pk, pv, index, window=window, tables=tables,
                              kv_len=S)
    assert flash_decode_fwd.last_route == "tc"
    assert ops.flash_decode.tc_launches == before + 1
    torch.cuda.synchronize()
    assert torch.equal(full[:, P:], suffix)
    one = flash_decode(q[:, P:P + 1], k[None], v[None], index, window=window)
    assert flash_decode_fwd.last_route == "tc_split" and ops.flash_decode.tc_launches == before + 1
    _close("single token", one, full[:, P:P + 1], BF16_TOL)
