"""PyTorch port, flash decode's split route (one bf16 token over bf16 values
or int8 / fp8 codes): its chunk schedule against the decode schedule of the
port and of the reference, the plain twin of its arithmetic (chunks of
fixed slots, warps and chunks merged in order, dequant scales factored out
of the products) against `decode_ref` and against the reference's
`flash_decode` in interpret mode, the exactness of every code in bf16, and
the route codes — all on the CPU.  The `gpu`-marked tests hold the kernel
itself against its plain version on the card, paged against dense bit for
bit, a request's rows against the same request alone, and two calls against
each other (`python3 chip_smoke.py` does so at the main path's shapes);
without a card they skip.  The reference package is imported inside the
tests only, so that the card's run needs no JAX."""

import ctypes
import itertools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import decode as tdec
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import decode_ref, decode_split_ref

# the twin and decode_ref both sum in fp32, in other orders (and the twin
# scales codes after the products): what is left is fp32 rounding
TOL = dict(atol=1e-5, rtol=1e-5)
# worst error of a bf16 kernel output, as a share of the plain output's RMS
# (chip_smoke.py's gate)
BF16_TOL = 5e-2

SCHEDULE_GRID = list(itertools.product(
    [48, 100, 256, 1000, 4096],                         # T (a ring when index >= T)
    [0, 1, 63, 64, 255, 256, 257, 999, 4095, 70000],   # index
    [None, 8, 70, 512],                                 # window (linear caches)
    [True, False]))                                     # pruned


def _reference_decode():
    from repro.kernels.flash_attention import decode as jdec

    return jdec


# ---------------------------------------------------------------------------
# the chunk schedule
# ---------------------------------------------------------------------------


def test_split_schedule_partitions_the_decode_schedule():
    """The chunks' tiles, in chunk order, are exactly the decode schedule at
    64-slot tiles — the port's and the reference's — for dense, ring,
    windowed and unpruned walks: each walked tile in exactly one chunk, and
    chunk c holds only tiles of its own fixed slot range."""
    jdec = _reference_decode()
    per = tdec.SPLIT_CHUNK // tdec.SPLIT_TILE
    for T, index, window, pruned in SCHEDULE_GRID:
        kw = dict(window=window, pruned=pruned)
        chunks = tdec.split_decode_schedule(T, index, **kw)
        tiles = [jb for _, jbs in chunks for jb in jbs]
        want = tdec.decode_schedule(T, index, tdec.SPLIT_TILE, **kw)
        assert want == jdec.decode_schedule(T, index, tdec.SPLIT_TILE, **kw)
        assert tiles == want and len(set(tiles)) == len(tiles)
        ids = [c for c, _ in chunks]
        assert ids == list(range(ids[0], ids[0] + len(ids)))
        for c, jbs in chunks:
            assert jbs and all(c * per <= jb < (c + 1) * per for jb in jbs)


@pytest.mark.parametrize("chunk", [64, 256, 1024])
def test_split_schedule_ignores_batch_and_paging(chunk):
    """A request's partition is a function of its own (index, kv_len,
    window, pruned): the same alone and inside a batch of eight, and the
    same over a paged pool as over a dense cache — where the pages its
    chunks read are exactly the pages the reference's paged schedule
    streams (live slots only)."""
    jdec = _reference_decode()
    T = 1000
    batch = [0, 63, 64, 255, 256, 500, 998, 999]
    rng = np.random.default_rng(0)
    for window, pruned, ps in itertools.product([None, 70], [True, False], [16, 64, 128]):
        kw = dict(window=window, pruned=pruned, chunk=chunk)
        in_batch = [tdec.split_decode_schedule(T, i, **kw) for i in batch]
        for i, plan in zip(batch, in_batch):
            assert plan == tdec.split_decode_schedule(T, i, **kw)
            table = list(rng.permutation(-(-T // ps) + 3))
            lo = max(0, i + 1 - window) if (pruned and window) else 0
            hi = max(1, min(T, i + 1)) if pruned else T
            read = {table[s // ps] for _, jbs in plan for jb in jbs
                    for s in range(jb * 64, jb * 64 + 64) if lo <= s < hi}
            bkv = jdec.page_block_kv(64, ps)
            streamed = {table[(jb * bkv + r) // ps]
                        for jb in jdec.decode_schedule(T, i, bkv, window=window, pruned=pruned)
                        for r in range(bkv) if lo <= jb * bkv + r < hi}
            assert read == streamed


def test_split_chunk_matches_the_compiled_chunk_and_the_binding():
    src = (Path(build.CSRC) / "decode_split.cuh").read_text()
    assert int(re.search(r"constexpr int kSplitChunk = (\d+);", src).group(1)) == \
        tdec.SPLIT_CHUNK
    assert tdec.SPLIT_CHUNK % tdec.SPLIT_TILE == 0
    assert [tdec.split_step_slots(D) for D in (16, 64, 96, 128, 256)] == [32, 32, 16, 16, 16]
    # the entry point's arguments: 8 pointers, 10 ints, 15 strides, then
    # scale_page, window, softcap, scale, block_kv, pruned, part, tickets,
    # split_chunk, the block mode's sub, span, phase, lse and its two
    # strides, route, stream
    assert len(build.SIGNATURES["repro_torch_flash_decode"]) == 50


# ---------------------------------------------------------------------------
# the plain twin of the split arithmetic
# ---------------------------------------------------------------------------


def _bf16_exact(x):
    """fp32 values that bf16 holds exactly (the kernel's operands)."""
    return torch.tensor(np.asarray(x)).to(torch.bfloat16).float()


TWIN_CASES = [  # name, B-lengths / indices, T, H, K, D, kw
    ("dense_ragged", [0, 63, 255, 256, 700], 701, 4, 2, 64, {}),
    ("window", [5, 300, 700], 701, 4, 2, 64, dict(window=100)),
    ("softcap_gqa8", [200, 513, 600], 601, 8, 1, 64, dict(softcap=5.0)),
    ("ring_wrapped", [7, 511, 512, 5000], 512, 4, 2, 64, {}),
    ("unpruned_window", [40, 599], 600, 4, 2, 32, dict(window=60, pruned=False)),
    ("head_dim16_g10", [3, 300], 320, 10, 1, 16, {}),
]


@pytest.mark.parametrize("name,idx,T,H,K,D,kw", TWIN_CASES)
def test_split_twin_matches_decode_ref_and_the_reference(name, idx, T, H, K, D, kw):
    """bf16-exact values, fp32 arithmetic: the split twin against the plain
    version and against the reference's Pallas decode in interpret mode."""
    import jax.numpy as jnp
    from repro.kernels.flash_attention import ops as jops

    rng = np.random.default_rng(7)
    B = len(idx)
    q = _bf16_exact(rng.standard_normal((B, 1, H, D)))
    k = _bf16_exact(rng.standard_normal((B, T, K, D)))
    v = _bf16_exact(rng.standard_normal((B, T, K, D)))
    index = torch.tensor(idx, dtype=torch.int32)
    got = decode_split_ref(q, k, v, index, **kw)
    torch.testing.assert_close(got, decode_ref(q, k, v, index, **kw), **TOL)
    want = np.asarray(jops.flash_decode(
        jnp.asarray(q.numpy()), jnp.asarray(k.numpy()), jnp.asarray(v.numpy()),
        jnp.asarray(idx, jnp.int32), block_kv=64, interpret=True, **kw))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def _codes(arr):
    """Reference codes (int8, or ml_dtypes fp8) -> a tensor of the same bytes."""
    a = np.asarray(arr)
    if a.dtype.kind == "i":
        return torch.tensor(a)
    return torch.from_numpy(a.view(np.uint8).copy()).view(getattr(torch, a.dtype.name))


@pytest.mark.parametrize("dtype,ps,kw", [
    ("int8", 32, {}),
    ("int8", 16, dict(window=90, softcap=4.0)),
    ("float8_e4m3fn", 64, {}),
    ("float8_e5m2", 128, dict(window=200)),
])
def test_split_twin_over_codes_matches_decode_ref_and_the_reference(dtype, ps, kw):
    """A pool built and quantized by the reference (the very same codes and
    scales for both packages), several chunks a request: the twin's factored
    scales against the plain version's dequantize-first arithmetic and
    against the reference's quantized Pallas decode in interpret mode; the
    same codes as a dense cache with one scale row per page agree with the
    pool bit for bit."""
    import jax.numpy as jnp
    from repro.kernels.flash_attention import ops as jops
    from repro.runtime.pages import build_linear_pool, quantize_linear_pool

    rng = np.random.default_rng(11)
    lengths, H, K, D = (37, 300, 530), 8, 2, 64
    ks = [rng.standard_normal((L, K, D)).astype(np.float32) for L in lengths]
    vs = [rng.standard_normal((L, K, D)).astype(np.float32) for L in lengths]
    pk, pv, tables, _ = build_linear_pool(ks, vs, ps, max_len=max(lengths))
    qpk, qpv, ksc, vsc = quantize_linear_pool(pk, pv, dtype)
    ksc, vsc, tables = np.asarray(ksc), np.asarray(vsc), np.asarray(tables)
    q = rng.standard_normal((len(lengths), 1, H, D)).astype(np.float32)
    idx = [L - 1 for L in lengths]
    T = max(lengths)
    pool = dict(tables=torch.tensor(tables), kv_len=T, k_scale=torch.tensor(ksc),
                v_scale=torch.tensor(vsc))
    index = torch.tensor(idx, dtype=torch.int32)
    tq, tk, tv = torch.tensor(q), _codes(qpk), _codes(qpv)
    got = decode_split_ref(tq, tk, tv, index, **pool, **kw)
    torch.testing.assert_close(got, decode_ref(tq, tk, tv, index, **pool, **kw), **TOL)
    want = np.asarray(jops.flash_decode(
        jnp.asarray(q), qpk, qpv, jnp.asarray(idx, jnp.int32), tables=jnp.asarray(tables),
        kv_len=T, block_kv=min(ps, 64), k_scale=jnp.asarray(ksc), v_scale=jnp.asarray(vsc),
        interpret=True, **kw))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # dense: each request's pages in logical order, one scale row per page
    nb = tables.shape[1]
    order = torch.tensor(tables, dtype=torch.long)
    dk = tk[order].reshape(len(lengths), nb * ps, K, D)
    dv = tv[order].reshape(len(lengths), nb * ps, K, D)
    dense = decode_split_ref(tq, dk, dv, index, k_scale=torch.tensor(ksc)[order],
                             v_scale=torch.tensor(vsc)[order], scale_page=ps, **kw)
    assert torch.equal(dense, got)


def test_split_twin_is_batch_invariant_and_paged_equals_dense():
    """A request's rows do not depend on its neighbours, and a shuffled pool
    with poisoned dead pages gives the dense cache's bits."""
    rng = np.random.default_rng(3)
    B, T, H, K, D, ps = 5, 640, 4, 2, 64, 32
    q = _bf16_exact(rng.standard_normal((B, 1, H, D)))
    k = _bf16_exact(rng.standard_normal((B, T, K, D)))
    v = _bf16_exact(rng.standard_normal((B, T, K, D)))
    idx = [0, 100, 256, 511, 639]
    index = torch.tensor(idx, dtype=torch.int32)
    full = decode_split_ref(q, k, v, index, window=300)
    for b in (0, B - 1):
        alone = decode_split_ref(q[b:b + 1], k[b:b + 1], v[b:b + 1], index[b:b + 1],
                                 window=300)
        assert torch.equal(alone, full[b:b + 1])
    nb = T // ps
    perm = torch.tensor(rng.permutation(B * nb + 4)[:B * nb])
    pk = torch.full((B * nb + 4, ps, K, D), float("nan"))
    pv = torch.full_like(pk, float("nan"))
    pk[perm] = k.reshape(B * nb, ps, K, D)
    pv[perm] = v.reshape(B * nb, ps, K, D)
    tables = perm.reshape(B, nb).to(torch.int32)
    live = {int(tables[b, s // ps]) for b, i in enumerate(idx)
            for s in range(max(0, i - 299), i + 1)}
    dead = [p for p in range(pk.shape[0]) if p not in live]
    pk[dead] = float("nan")
    pv[dead] = float("nan")
    paged = decode_split_ref(q, pk, pv, index, window=300, tables=tables, kv_len=T)
    assert torch.equal(paged, full)


def test_fully_masked_row_yields_zero_in_the_twin():
    q = torch.randn(1, 1, 2, 64)
    k = torch.randn(1, 8, 2, 64)
    # index 20 on an 8-slot linear cache under window 4: no slot is live
    assert torch.count_nonzero(decode_split_ref(q, k, k, torch.tensor([20]), window=4)) == 0


# ---------------------------------------------------------------------------
# codes in bf16, routes
# ---------------------------------------------------------------------------


def _widen_like_the_kernel(name, byte):
    """`code_f32` of csrc/decode_split.cuh in numpy: code bytes -> fp32."""
    b = np.asarray(byte, dtype=np.uint32)
    if name == "int8":  # x + 128 below 2^23's fp32 bits, less 2^23 + 128
        u = ((b ^ 0x80) & 0xFF) | np.uint32(0x4B000000)
        return u.view(np.float32) - np.float32(8388736.0)
    v = b << np.uint32(24)
    shift, mask, mul = (4, 0x07F00000, 2.0 ** 120) if name == "float8_e4m3fn" else \
        (3, 0x0FE00000, 2.0 ** 112)
    bits = (v & np.uint32(0x80000000)) | ((v >> np.uint32(shift)) & np.uint32(mask))
    return bits.view(np.float32) * np.float32(mul)


@pytest.mark.parametrize("name", ["int8", "float8_e4m3fn", "float8_e5m2"])
def test_every_code_is_exact_in_bf16(name):
    """Every int8 value and every finite e4m3fn / e5m2 value survives the
    kernel's widening into a bf16 fragment exactly: it is exact in bf16, and
    the kernel's integer-and-fp32 widening (`code_f32`, top 16 bits taken as
    the bf16) gives that value for every one of them."""
    dtype = getattr(torch, name, None)
    if dtype is None:
        pytest.skip(f"this torch has no {name}")
    codes = torch.arange(256, dtype=torch.int32).to(torch.uint8).view(dtype)
    x = codes.float()
    finite = torch.isfinite(x)
    assert int(finite.sum()) == {"int8": 256, "float8_e4m3fn": 254, "float8_e5m2": 248}[name]
    assert torch.equal(x[finite].to(torch.bfloat16).float(), x[finite])
    widened = _widen_like_the_kernel(name, np.arange(256))
    assert not np.any(widened.view(np.uint32) & 0xFFFF)  # its top 16 bits are its bf16
    np.testing.assert_array_equal(widened[finite.numpy()], x[finite].numpy())
    assert np.array_equal(np.signbit(widened[finite.numpy()]), np.signbit(x[finite].numpy()))


def test_routes_by_type_and_token_count():
    bf16, f32 = torch.bfloat16, torch.float32
    for kv in (bf16, torch.int8, getattr(torch, "float8_e4m3fn", torch.int8)):
        assert tdec.decode_route(bf16, kv, 1) == "tc_split"
    assert tdec.decode_route(bf16, bf16, 4) == "tc"
    assert tdec.decode_route(bf16, torch.int8, 4) == "tc"  # codes widened in the tiles
    assert tdec.decode_route(f32, f32, 1) == "fma"
    assert tdec.decode_route(f32, torch.int8, 1) == "fma"
    assert build.route_name(ctypes.c_int(2)) == "tc_split"


def test_cpu_tensors_count_no_route():
    fd = ops.flash_decode
    before = (fd.launches, fd.split_launches, fd.tc_launches, fd.quantized_launches)
    q = torch.randn(2, 1, 4, 16, dtype=torch.bfloat16)
    k = torch.randn(2, 40, 2, 16, dtype=torch.bfloat16)
    out = fd(q, k, k, torch.tensor([3, 39], dtype=torch.int32))
    assert out.shape == q.shape
    assert (fd.launches, fd.split_launches, fd.tc_launches, fd.quantized_launches) == before


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


def _quantize(x, dtype, ps):
    """(B, T, K, D) values -> codes and (B, T / ps, K) scales, one per page."""
    B, T, K, D = x.shape
    pages = x.float().reshape(B, T // ps, ps, K, D)
    scale = ops.kv_scale_from_absmax(pages.abs().amax(dim=(2, 4)), dtype)
    codes = ops.quantize_kv_write(pages, scale[:, :, None, :], dtype)
    return codes.reshape(B, T, K, D), scale


def _pool(gen, k, v, ps, scales=None):
    """The dense cache as a shuffled pool with 4 spare pages; the spare
    pages hold NaN (values) or NaN / garbage codes with NaN scales."""
    B, T, K, D = k.shape
    nb, P = T // ps, B * (T // ps) + 4
    perm = torch.randperm(P, generator=gen, device="cuda")[:B * nb]
    out = []
    for x in (k, v):
        raw = x.view(torch.int8) if x.element_size() == 1 else x
        pool = torch.full((P, ps, K, D), 0x7f if x.element_size() == 1 else float("nan"),
                          dtype=raw.dtype, device="cuda")
        pool[perm] = raw.reshape(B * nb, ps, K, D)
        out.append(pool.view(x.dtype))
    extra = {}
    for name, sc in zip(("k_scale", "v_scale"), scales or ()):
        pooled = torch.full((P, K), float("nan"), device="cuda")
        pooled[perm] = sc.reshape(B * nb, K)
        extra[name] = pooled
    return out[0], out[1], perm.reshape(B, nb).to(torch.int32), extra


CARD_CASES = [  # B indices, T, H, K, D, kv type, page, kw
    ([0, 100, 255, 256, 1000, 1999], 2048, 8, 1, 128, "bf16", 128, {}),
    ([7, 600, 1023, 5000], 1024, 10, 1, 256, "bf16", 64, {}),            # ring, G = 10
    ([3, 250, 700], 768, 4, 2, 16, "bf16", 32, dict(window=100)),      # head_dim 16
    ([40, 511, 512], 512, 40, 2, 64, "bf16", 16, dict(softcap=5.0)),   # G = 20: two row tiles
    ([300, 900], 1024, 8, 2, 64, "bf16", 64, dict(pruned=False)),
    ([0, 130, 1500, 2047], 2048, 32, 4, 128, "int8", 128, {}),
    ([99, 800, 1023], 1024, 8, 1, 256, "float8_e4m3fn", 64, dict(window=300)),
    ([5, 640, 1000], 1024, 4, 2, 64, "float8_e5m2", 32, dict(softcap=4.0)),
]


@pytest.mark.gpu
@pytest.mark.parametrize("idx,T,H,K,D,kv,ps,kw", CARD_CASES)
def test_split_route_on_the_card(idx, T, H, K, D, kv, ps, kw):
    """The split route against its plain version (and its twin), paged ==
    dense bit for bit with dead pages poisoned, each request's rows equal to
    the request alone (the shortest and the longest), and two calls equal."""
    gen = _card()
    B = len(idx)
    q = torch.randn((B, 1, H, D), generator=gen, device="cuda").to(torch.bfloat16)
    k = torch.randn((B, T, K, D), generator=gen, device="cuda").to(torch.bfloat16)
    v = torch.randn((B, T, K, D), generator=gen, device="cuda").to(torch.bfloat16)
    index = torch.tensor(idx, dtype=torch.int32, device="cuda")
    dense_kw = dict(kw)
    scales = None
    if kv != "bf16":
        dt = getattr(torch, kv)
        k, ks = _quantize(k, dt, ps)
        v, vs = _quantize(v, dt, ps)
        scales = (ks, vs)
        dense_kw.update(k_scale=ks, v_scale=vs, scale_page=ps)
    before = (ops.flash_decode.split_launches, ops.flash_decode.launches)
    got = ops.flash_decode(q, k, v, index, **dense_kw)
    assert tdec.flash_decode_fwd.last_route == "tc_split"
    again = ops.flash_decode(q, k, v, index, **dense_kw)
    assert (ops.flash_decode.split_launches - before[0],
            ops.flash_decode.launches - before[1]) == (2, 2)
    pk, pv, tables, pooled = _pool(gen, k, v, ps, scales)
    paged = ops.flash_decode(q, pk, pv, index, tables=tables, kv_len=T, **kw, **pooled)
    torch.cuda.synchronize()
    assert torch.equal(got, again), "two calls differ"
    assert torch.equal(got, paged), "paged differs from dense"
    want = decode_ref(q, k, v, index, **dense_kw)
    _close("kernel vs plain", got, want, BF16_TOL)
    _close("kernel vs twin", got, decode_split_ref(q, k, v, index, **dense_kw), BF16_TOL)
    for b in (int(np.argmin(idx)), int(np.argmax(idx))):
        one = {n: (x[b:b + 1] if n in ("k_scale", "v_scale") else x)
               for n, x in dense_kw.items()}
        alone = ops.flash_decode(q[b:b + 1], k[b:b + 1], v[b:b + 1], index[b:b + 1], **one)
        torch.cuda.synchronize()
        assert torch.equal(alone, got[b:b + 1]), f"request {b} depends on its batch"
