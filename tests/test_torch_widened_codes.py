"""PyTorch port, flash decode's tensor-core mode over int8 / fp8 codes (S > 1
bf16 tokens: a prefix-shared suffix over a quantized pool, and that pool's
first prefill at index 0): the plain twin of its arithmetic (64-row q
blocks over 64-slot tiles, the dequant scales factored out of the products,
P in three bf16 parts) against `decode_ref` and against the reference's
quantized Pallas decode in interpret mode, the route it reports, and the
dispatch of a quantized pool's first prefill — all on the CPU.  The
`gpu`-marked tests hold the kernel itself against its twin and its plain
version on the card, paged against dense bit for bit, and a suffix's rows
against the whole prompt's (`python3 chip_smoke.py` does so at the main
path's shapes); without a card they skip.  The reference package is
imported inside the tests only, so that the card's run needs no JAX."""

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import decode as tdec
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import decode_ref, decode_widened_codes_ref
from repro_torch.nn import attention as tattn
from repro_torch.nn.dtypes import PolicyResolver as TPolicies
from repro_torch.nn.module import Ctx as TCtx

# the twin and decode_ref both sum in fp32, in other orders (and the twin
# scales codes after the products, and splits P into parts): what is left
# is fp32 rounding
TOL = dict(atol=1e-5, rtol=1e-5)
# worst error of a bf16 kernel output, as a share of the plain output's RMS
# (chip_smoke.py's gate)
BF16_TOL = 5e-2


def _codes(arr):
    """Reference codes (int8, or ml_dtypes fp8) -> a tensor of the same bytes."""
    a = np.asarray(arr)
    if a.dtype.kind == "i":
        return torch.tensor(a)
    return torch.from_numpy(a.view(np.uint8).copy()).view(getattr(torch, a.dtype.name))


def _reference_pool(dtype, ps, lengths, K, D, seed):
    """A page pool built and quantized by the reference (the very same codes
    and scales for both packages); skips an fp8 type the JAX build lacks."""
    from repro.runtime.pages import build_linear_pool, quantize_linear_pool

    rng = np.random.default_rng(seed)
    ks = [rng.standard_normal((L, K, D)).astype(np.float32) for L in lengths]
    vs = [rng.standard_normal((L, K, D)).astype(np.float32) for L in lengths]
    pk, pv, tables, _ = build_linear_pool(ks, vs, ps, max_len=max(lengths))
    try:
        qpk, qpv, ksc, vsc = quantize_linear_pool(pk, pv, dtype)
    except (KeyError, AttributeError, TypeError) as err:
        pytest.skip(f"the reference's JAX build has no {dtype}: {err}")
    return qpk, qpv, np.asarray(ksc), np.asarray(vsc), np.asarray(tables)


CASES = [  # dtype, page, S, lengths, kw
    ("int8", 16, 40, (45, 300, 530), {}),
    ("int8", 128, 130, (200, 531), dict(window=90, softcap=4.0)),
    ("float8_e4m3fn", 16, 70, (71, 333), dict(window=200)),
    ("float8_e5m2", 128, 65, (66, 500), dict(softcap=5.0)),
    ("int8", 16, 40, (45, 300), dict(pruned=False)),
]


@pytest.mark.parametrize("dtype,ps,S,lengths,kw", CASES)
def test_twin_over_codes_matches_decode_ref_and_the_reference(dtype, ps, S, lengths, kw):
    """S new tokens per request at ragged positions (the first request's
    tokens start at 5: a suffix over a 5-slot prefix), a pool of several
    pages a request: the twin's factored scales against the plain version's
    dequantize-first arithmetic and against the reference's quantized
    Pallas decode in interpret mode; the same codes as a dense cache with
    one scale row per page agree with the pool bit for bit."""
    import jax.numpy as jnp
    from repro.kernels.flash_attention import ops as jops

    H, K, D = 8, 2, 64
    qpk, qpv, ksc, vsc, tables = _reference_pool(dtype, ps, lengths, K, D, seed=S)
    rng = np.random.default_rng(S + 1)
    q = torch.tensor(rng.standard_normal((len(lengths), S, H, D))).to(torch.bfloat16)
    idx = [L - S for L in lengths]
    T = max(lengths)
    pool = dict(tables=torch.tensor(tables), kv_len=T, k_scale=torch.tensor(ksc),
                v_scale=torch.tensor(vsc))
    index = torch.tensor(idx, dtype=torch.int32)
    tk, tv = _codes(qpk), _codes(qpv)
    got = decode_widened_codes_ref(q, tk, tv, index, **pool, **kw)
    assert got.dtype == torch.bfloat16
    want = decode_ref(q.float(), tk, tv, index, **pool, **kw)
    twin32 = decode_widened_codes_ref(q.float(), tk, tv, index, **pool, **kw)
    torch.testing.assert_close(twin32, want, **TOL)
    # a bf16 output: within a bf16 step of the plain version's
    torch.testing.assert_close(got.float(), want, atol=1e-2, rtol=1e-2)
    ref = np.asarray(jops.flash_decode(
        jnp.asarray(q.float().numpy()), qpk, qpv, jnp.asarray(idx, jnp.int32),
        tables=jnp.asarray(tables), kv_len=T, block_kv=min(ps, 64),
        k_scale=jnp.asarray(ksc), v_scale=jnp.asarray(vsc), interpret=True, **kw))
    np.testing.assert_allclose(twin32.numpy(), ref, **TOL)
    # dense: each request's pages in logical order, one scale row per page
    nb = tables.shape[1]
    order = torch.tensor(tables, dtype=torch.long)
    dk = tk[order].reshape(len(lengths), nb * ps, K, D)
    dv = tv[order].reshape(len(lengths), nb * ps, K, D)
    dense = decode_widened_codes_ref(q, dk, dv, index, k_scale=torch.tensor(ksc)[order],
                                     v_scale=torch.tensor(vsc)[order], scale_page=ps, **kw)
    assert torch.equal(dense, got)


def test_twin_rows_at_an_offset_equal_the_whole_prompts_rows():
    """The identity the route keeps by construction: the rows of a call at
    index P (a multiple of the 64-row q block) equal rows P.. of the whole
    prompt's call at index 0 over the same codes, bit for bit."""
    rng = np.random.default_rng(5)
    S, P, H, K, D, ps = 200, 128, 4, 1, 64, 16
    q = torch.tensor(rng.standard_normal((1, S, H, D))).to(torch.bfloat16)
    codes = [torch.tensor(rng.integers(-127, 128, (1, S, K, D)), dtype=torch.int8)
             for _ in range(2)]
    scales = [torch.tensor(rng.uniform(0.001, 0.02, (1, S // ps + 1, K)),
                           dtype=torch.float32) for _ in range(2)]
    kw = dict(k_scale=scales[0], v_scale=scales[1], scale_page=ps, window=150)
    whole = decode_widened_codes_ref(q, *codes, torch.tensor([0]), **kw)
    suffix = decode_widened_codes_ref(q[:, P:], *codes, torch.tensor([P]), **kw)
    assert torch.equal(whole[:, P:], suffix)


def test_fully_masked_row_yields_zero_in_the_twin():
    q = torch.randn(1, 3, 2, 64).to(torch.bfloat16)
    k = torch.randint(-127, 128, (1, 8, 2, 64), dtype=torch.int8)
    sc = torch.full((1, 1, 2), 0.01)
    # tokens at 20..22 on an 8-slot linear cache under window 4: no slot is live
    out = decode_widened_codes_ref(q, k, k, torch.tensor([20]), window=4, k_scale=sc,
                                   v_scale=sc, scale_page=8)
    assert torch.count_nonzero(out) == 0


def test_widened_q_over_codes_takes_the_tensor_cores():
    bf16, f32 = torch.bfloat16, torch.float32
    for kv in (torch.int8, getattr(torch, "float8_e4m3fn", torch.int8),
               getattr(torch, "float8_e5m2", torch.int8), bf16):
        assert tdec.decode_route(bf16, kv, 4) == "tc"
        assert tdec.decode_route(bf16, kv, 512) == "tc"
        assert tdec.decode_route(f32, kv if kv != bf16 else f32, 4) == "fma"


# ---------------------------------------------------------------------------
# a quantized pool's first prefill
# ---------------------------------------------------------------------------


def _quantized_pool(P, ps, K, D):
    return {"pk": torch.zeros((P, ps, K, D), dtype=torch.int8),
            "pv": torch.zeros((P, ps, K, D), dtype=torch.int8),
            "ksc": torch.zeros((P, K)), "vsc": torch.zeros((P, K)),
            "index": torch.zeros((1,), dtype=torch.int32)}


def _prefill(attn, impl, cache, tables, q, kv, start):
    """`_prefill_paged` of one request whose K / V projections are `kv`
    (a row's K / V depend on its own row only), from slot `start`."""
    ctx = TCtx(policies=TPolicies.default("half"), impls=[("*", "attention", impl)])
    attn._proj = lambda params, x, name, heads, policy: x[name]
    S = q.shape[1]
    positions = torch.arange(start, start + S, dtype=torch.int32)[None]
    return attn._prefill_paged({}, q, kv, positions, ctx, ctx.policy(), cache, tables,
                               start)


def test_quantized_first_prefill_dispatches_to_the_widened_decode(monkeypatch):
    """Under the `cuda` impl a quantized pool's unshared prefill attends over
    the pool's codes through `flash_decode` at index 0 (over the whole
    prompt, its block table and its scales); its rows equal a prefix-shared
    admission's suffix rows bit for bit in the twin.  The `eager` impl still
    attends through `_attend_dense` over the dequantized values."""
    rng = np.random.default_rng(9)
    S, P, H, K, D, ps = 100, 64, 4, 2, 64, 16
    attn = tattn.Attention("attn", H * D, H, K, D)
    q = torch.tensor(rng.standard_normal((1, S, H, D))).to(torch.bfloat16)
    kv = {n: torch.tensor(rng.standard_normal((1, S, K, D))).to(torch.bfloat16)
          for n in ("k", "v")}
    calls = []

    def spy(q, pk, pv, index, **kw):
        calls.append(dict(index=index.tolist(), **kw))
        kw = {n: x for n, x in kw.items() if n != "block_kv"}
        return decode_widened_codes_ref(q, pk, pv, index, **kw)

    monkeypatch.setattr(tattn, "flash_decode", spy)
    cache = _quantized_pool(12, ps, K, D)
    whole_tables = torch.arange(7, dtype=torch.int32)[None]
    whole, new = _prefill(attn, "cuda", cache, whole_tables, q, kv, 0)
    assert len(calls) == 1 and calls[0]["index"] == [0] and calls[0]["kv_len"] == S
    assert calls[0]["tables"] is whole_tables and calls[0]["k_scale"] is cache["ksc"]
    assert new["index"].tolist() == [S]
    # a sharer of the first 64 slots: prefix pages 0..3, its suffix on fresh pages
    shared_tables = torch.tensor([[0, 1, 2, 3, 7, 8, 9]], dtype=torch.int32)
    suffix, _ = _prefill(attn, "cuda", cache, shared_tables, q[:, P:],
                         {n: x[:, P:] for n, x in kv.items()}, P)
    assert len(calls) == 2 and calls[1]["index"] == [P] and calls[1]["kv_len"] == S
    assert torch.equal(cache["pk"][7:10], cache["pk"][4:7])
    assert torch.equal(whole[:, P:], suffix)

    dense = []
    monkeypatch.setattr(attn, "_attend_dense",
                        lambda *a, **k: dense.append(a[1].dtype) or torch.zeros_like(a[0]))
    _prefill(attn, "eager", _quantized_pool(12, ps, K, D), whole_tables, q, kv, 0)
    assert len(calls) == 2 and dense == [torch.float32]  # over the dequantized values


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    return gen


def _close(name, got, want, tol):
    assert got.shape == want.shape and got.dtype == want.dtype, name
    assert torch.isfinite(got).all(), f"{name}: not finite"
    err = (got.float() - want.float()).abs().max().item()
    rms = want.float().pow(2).mean().sqrt().item()
    assert err <= tol * rms, f"{name}: max abs error {err} over {tol} of RMS {rms}"


CARD_CASES = [  # indices, S, T, H, K, D, code type, page, kw
    ([1024], 512, 1536, 32, 4, 128, "int8", 128, {}),
    ([0, 300], 200, 640, 8, 1, 256, "float8_e4m3fn", 16, dict(window=150)),
    ([5, 100], 70, 256, 4, 2, 64, "float8_e5m2", 64, dict(softcap=5.0)),
    ([40, 200], 33, 256, 4, 2, 16, "int8", 32, dict(pruned=False)),   # head_dim 16
]


@pytest.mark.gpu
@pytest.mark.parametrize("idx,S,T,H,K,D,kv,ps,kw", CARD_CASES)
def test_widened_codes_on_the_card(idx, S, T, H, K, D, kv, ps, kw):
    """The tensor-core mode over codes against its twin and its plain
    version, paged == dense bit for bit with spare pages poisoned, and the
    suffix rows of the first request equal to its whole prompt's rows."""
    gen = _card()
    B = len(idx)
    dt = getattr(torch, kv)
    q = torch.randn((B, S, H, D), generator=gen, device="cuda").to(torch.bfloat16)
    codes, scales = [], []
    for _ in range(2):
        x = torch.randn((B, T // ps, ps, K, D), generator=gen, device="cuda")
        sc = ops.kv_scale_from_absmax(x.abs().amax(dim=(2, 4)), dt)
        codes.append(ops.quantize_kv_write(x, sc[:, :, None, :], dt).reshape(B, T, K, D))
        scales.append(sc)
    index = torch.tensor(idx, dtype=torch.int32, device="cuda")
    dense_kw = dict(kw, k_scale=scales[0], v_scale=scales[1], scale_page=ps)
    before = ops.flash_decode.tc_launches
    got = ops.flash_decode(q, *codes, index, **dense_kw)
    assert tdec.flash_decode_fwd.last_route == "tc"
    assert ops.flash_decode.tc_launches == before + 1
    nb, P = T // ps, B * (T // ps) + 4
    perm = torch.randperm(P, generator=gen, device="cuda")[:B * nb]
    pooled = []
    for c in codes:
        pool = torch.full((P, ps, K, D), 0x7f, dtype=torch.int8, device="cuda")
        pool[perm] = c.view(torch.int8).reshape(B * nb, ps, K, D)
        pooled.append(pool.view(dt))
    psc = []
    for sc in scales:
        x = torch.full((P, K), float("nan"), device="cuda")
        x[perm] = sc.reshape(B * nb, K)
        psc.append(x)
    paged = ops.flash_decode(q, *pooled, index, tables=perm.reshape(B, nb).to(torch.int32),
                             kv_len=T, k_scale=psc[0], v_scale=psc[1], **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, paged), "paged differs from dense"
    _close("kernel vs twin", got, decode_widened_codes_ref(q, *codes, index, **dense_kw),
           BF16_TOL)
    _close("kernel vs plain", got, decode_ref(q, *codes, index, **dense_kw), BF16_TOL)
    # request 0's whole prompt at index 0 (zero q rows before its suffix)
    i0 = idx[0]
    one = {n: (x[:1] if n in ("k_scale", "v_scale") else x) for n, x in dense_kw.items()}
    whole_q = torch.cat([q.new_zeros((1, i0, H, D)), q[:1]], dim=1)
    whole = ops.flash_decode(whole_q, codes[0][:1], codes[1][:1],
                             torch.zeros(1, dtype=torch.int32, device="cuda"), **one)
    torch.cuda.synchronize()
    assert torch.equal(whole[:, i0:], got[:1]), "suffix rows differ from the whole prompt"
