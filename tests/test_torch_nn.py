"""PyTorch port, nn layer: every ported block against its reference
counterpart on the same numpy inputs and the same (converted) weights.

Policy `double` (fp32 everywhere): atol = rtol = 1e-5 — the two frameworks
differ only in summation order.  Policy `half` (bf16): 2e-2 — bf16 keeps 8
bits of mantissa and the frameworks round at different places.  The
reference side runs with its Pallas kernels woven (interpret mode on the
CPU) and head_dim = 64, the smallest width its kernel gate accepts; the
port's side has the CUDA kernels woven, which on CPU tensors take their
plain versions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.nn import attention as jattn
from repro.nn import blocks as jblocks
from repro.nn.dtypes import PolicyResolver as JPolicies
from repro.nn.module import Ctx as JCtx
from repro.nn.module import init_params as jinit
from repro_torch.convert import load_jax_params
from repro_torch.nn import attention as tattn
from repro_torch.nn import blocks as tblocks
from repro_torch.nn.dtypes import PolicyResolver as TPolicies
from repro_torch.nn.module import Ctx as TCtx
from repro_torch.nn.module import init_params as tinit

from _torch_port import assert_tree_close, np_tree, t, to_np

torch.set_num_threads(1)

TOLS = {"double": dict(atol=1e-5, rtol=1e-5), "half": dict(atol=2e-2, rtol=2e-2)}
EXTRA = {"flash_block_q": 32, "flash_block_kv": 32, "flash_block_q_bwd": 32,
         "flash_block_kv_bwd": 32, "flash_block_kv_dec": 16, "rms_block_rows": 8}


def _ctxs(policy, extra=None):
    extra = {**EXTRA, **(extra or {})}
    jctx = JCtx(policies=JPolicies.default(policy), extra=extra,
                impls=[("*", "attention", "pallas"), ("*", "norm", "pallas")])
    tctx = TCtx(policies=TPolicies.default(policy), extra=extra,
                impls=[("*", "attention", "cuda"), ("*", "norm", "cuda")])
    return jctx, tctx


def _pair(jmod, tmod, policy, seed=0):
    """Reference params, and the port's module loaded with the same values."""
    jparams = jinit(jmod, jax.random.PRNGKey(seed), JPolicies.default(policy))
    tinit(tmod, 0, TPolicies.default(policy), "cpu")
    return jparams, load_jax_params(tmod, np_tree(jparams))


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("policy", ["double", "half", "fixed"])
@pytest.mark.parametrize("bias", [False, True])
def test_linear(policy, bias):
    kw = dict(axes=("embed", "mlp"), bias=bias)
    jparams, tparams = _pair(jblocks.Linear("lin", 64, 96, **kw),
                             tblocks.Linear("lin", 64, 96, **kw), policy)
    jctx, tctx = _ctxs(policy)
    x = _x((2, 5, 64))
    want = jblocks.Linear("lin", 64, 96, **kw)(jparams, jnp.asarray(x), ctx=jctx)
    got = tblocks.Linear("lin", 64, 96, **kw)(tparams, t(x), ctx=tctx)
    assert got.dtype == {"double": torch.float32}.get(policy, torch.bfloat16)
    np.testing.assert_allclose(to_np(got), np.asarray(want, np.float32),
                               **TOLS.get(policy, TOLS["half"]))


def test_quantize_int8_matches_reference():
    w = _x((64, 48), seed=3)
    w[:, 5] = 0.0  # an all-zero channel keeps scale 1
    jq, jscale = jblocks._quantize_int8(jnp.asarray(w))
    tq, tscale = tblocks._quantize_int8(t(w))
    np.testing.assert_array_equal(to_np(tq), np.asarray(jq))
    np.testing.assert_allclose(to_np(tscale), np.asarray(jscale), rtol=1e-7)


@pytest.mark.parametrize("policy", ["double", "half"])
@pytest.mark.parametrize("scale_by_dim", [False, True])
def test_embedding_and_attend(policy, scale_by_dim):
    jmod = jblocks.Embedding("embed", 128, 64, scale_by_dim=scale_by_dim)
    tmod = tblocks.Embedding("embed", 128, 64, scale_by_dim=scale_by_dim)
    jparams, tparams = _pair(jmod, tmod, policy)
    jctx, tctx = _ctxs(policy)
    tokens = np.random.default_rng(1).integers(0, 128, (2, 7)).astype(np.int32)
    want = jmod(jparams, jnp.asarray(tokens), ctx=jctx)
    got = tmod(tparams, t(tokens), ctx=tctx)
    np.testing.assert_allclose(to_np(got), np.asarray(want, np.float32), **TOLS[policy])
    x = _x((2, 3, 64), seed=2)
    want = jmod.attend(jparams, jnp.asarray(x), ctx=jctx)
    got = tmod.attend(tparams, t(x), ctx=tctx)
    assert got.dtype == torch.float32  # logits come back in the accumulation dtype
    np.testing.assert_allclose(to_np(got), np.asarray(want, np.float32), **TOLS[policy])


@pytest.mark.parametrize("policy", ["double", "half"])
@pytest.mark.parametrize("plus_one", [False, True])
@pytest.mark.parametrize("impl", ["kernel", "plain"])
def test_rmsnorm(policy, plus_one, impl):
    jmod = jblocks.RMSNorm("norm", 64, plus_one=plus_one)
    tmod = tblocks.RMSNorm("norm", 64, plus_one=plus_one)
    jparams, tparams = _pair(jmod, tmod, policy)
    w = _x((64,), seed=4) * 0.2
    jparams = {"w": jnp.asarray(w)}
    load_jax_params(tmod, {"w": w})
    jctx, tctx = _ctxs(policy)
    if impl == "plain":
        jctx.impls, tctx.impls = [], []
    x = _x((2, 9, 64), seed=5)
    if policy == "half":
        x = np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)
    dt_j, dt_t = (jnp.bfloat16, torch.bfloat16) if policy == "half" else (jnp.float32, torch.float32)
    want = jmod(jparams, jnp.asarray(x, dt_j), ctx=jctx)
    got = tmod(tparams, t(x, dt_t), ctx=tctx)
    np.testing.assert_allclose(to_np(got), np.asarray(want, np.float32), **TOLS[policy])


@pytest.mark.parametrize("policy", ["double", "half"])
@pytest.mark.parametrize("activation,gated", [("silu", True), ("gelu", True), ("relu2", False)])
def test_mlp(policy, activation, gated):
    kw = dict(activation=activation, gated=gated)
    jmod, tmod = jblocks.MLP("ffn", 64, 128, **kw), tblocks.MLP("ffn", 64, 128, **kw)
    jparams, tparams = _pair(jmod, tmod, policy)
    jctx, tctx = _ctxs(policy)
    x = _x((2, 5, 64))
    want = jmod(jparams, jnp.asarray(x), ctx=jctx)
    got = tmod(tparams, t(x), ctx=tctx)
    np.testing.assert_allclose(to_np(got), np.asarray(want, np.float32), **TOLS[policy])


def test_rope():
    pos = np.stack([np.arange(12), np.arange(100, 112)]).astype(np.int32)
    jsin, jcos = jblocks.rope_angles(jnp.asarray(pos), 64, 5e6)
    tsin, tcos = tblocks.rope_angles(t(pos), 64, 5e6)
    np.testing.assert_allclose(to_np(tsin), np.asarray(jsin), atol=1e-5)
    np.testing.assert_allclose(to_np(tcos), np.asarray(jcos), atol=1e-5)
    x = _x((2, 12, 4, 64))
    want = jblocks.apply_rope(jnp.asarray(x), jsin, jcos)
    got = tblocks.apply_rope(t(x), tsin, tcos)
    np.testing.assert_allclose(to_np(got), np.asarray(want), atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

D_MODEL, HEADS, KV, HD = 64, 4, 2, 64


def _attn_pair(policy, **kw):
    jmod = jattn.Attention("attn", D_MODEL, HEADS, KV, HD, **kw)
    tmod = tattn.Attention("attn", D_MODEL, HEADS, KV, HD, **kw)
    return (jmod, tmod) + _pair(jmod, tmod, policy)


@pytest.mark.parametrize("policy", ["double", "half"])
@pytest.mark.parametrize("name,kw", [
    ("causal", {}),
    ("sliding", dict(mask="sliding", window=8)),
    ("softcap_bias", dict(softcap=20.0, bias=True)),
    ("full", dict(mask="full", use_rope=False)),
])
def test_attention_dense(policy, name, kw):
    jmod, tmod, jparams, tparams = _attn_pair(policy, **kw)
    jctx, tctx = _ctxs(policy)
    x = _x((2, 24, D_MODEL))
    want, _ = jmod(jparams, jnp.asarray(x), ctx=jctx)
    got, none = tmod(tparams, t(x), ctx=tctx)
    assert none is None
    np.testing.assert_allclose(to_np(got), np.asarray(want, np.float32), **TOLS[policy])


@pytest.mark.parametrize("policy", ["double", "half"])
@pytest.mark.parametrize("name,kw,S,max_len", [
    ("linear", {}, 10, 16),
    ("linear_window", dict(mask="sliding", window=12), 10, 16),
    ("ring", dict(mask="sliding", window=8), 12, 16),
])
def test_attention_prefill_then_decode(policy, name, kw, S, max_len):
    """Prefill builds the cache (linear, or ring when window < S); three
    decode steps then run from it — past the ring's wrap — comparing the
    output and the whole cache after each."""
    jmod, tmod, jparams, tparams = _attn_pair(policy, **kw)
    jctx, tctx = _ctxs(policy, {"cache_max_len": max_len})
    tol = TOLS[policy]
    x = _x((2, S, D_MODEL))
    want, jcache = jmod(jparams, jnp.asarray(x), ctx=jctx, mode="prefill")
    got, tcache = tmod(tparams, t(x), ctx=tctx, mode="prefill")
    np.testing.assert_allclose(to_np(got), np.asarray(want, np.float32), **tol)
    assert_tree_close(tcache, np_tree(jcache), **tol)
    assert ("pos" in tcache) == (name == "ring")
    for step in range(3):
        xs = _x((2, 1, D_MODEL), seed=10 + step)
        pos = np.full((2, 1), S + step, np.int32)
        want, jcache = jmod(jparams, jnp.asarray(xs), ctx=jctx, mode="decode",
                            cache=jcache, positions=jnp.asarray(pos))
        got, tcache = tmod(tparams, t(xs), ctx=tctx, mode="decode",
                           cache=tcache, positions=t(pos))
        np.testing.assert_allclose(to_np(got), np.asarray(want, np.float32), **tol)
        assert_tree_close(tcache, np_tree(jcache), **tol)


def _stack(caches, lib):
    """Two batch-1 single-layer caches -> the per-request serving layout."""
    cat, stack = (jnp.concatenate, jnp.stack) if lib == "jax" else (torch.cat, torch.stack)
    out = {"k": cat([c["k"] for c in caches], 0), "v": cat([c["v"] for c in caches], 0),
           "index": stack([c["index"] for c in caches], 0)}
    if "pos" in caches[0]:
        out["pos"] = stack([c["pos"] for c in caches], 0)
    return out


@pytest.mark.parametrize("policy", ["double", "half"])
@pytest.mark.parametrize("name,kw,lens", [
    ("linear", {}, (5, 11)),
    ("ring", dict(mask="sliding", window=8), (9, 14)),
])
def test_attention_decode_per_request_index(policy, name, kw, lens):
    jmod, tmod, jparams, tparams = _attn_pair(policy, **kw)
    jctx, tctx = _ctxs(policy, {"cache_max_len": 16})
    tol = TOLS[policy]
    jcs, tcs = [], []
    for i, n in enumerate(lens):
        x = _x((1, n, D_MODEL), seed=20 + i)
        jcs.append(jmod(jparams, jnp.asarray(x), ctx=jctx, mode="prefill")[1])
        tcs.append(tmod(tparams, t(x), ctx=tctx, mode="prefill")[1])
    jcache, tcache = _stack(jcs, "jax"), _stack(tcs, "torch")
    assert tcache["index"].shape == (2,)
    for step in range(3):
        xs = _x((2, 1, D_MODEL), seed=30 + step)
        pos = (np.asarray(lens, np.int32) + step)[:, None]
        want, jcache = jmod(jparams, jnp.asarray(xs), ctx=jctx, mode="decode",
                            cache=jcache, positions=jnp.asarray(pos))
        got, tcache = tmod(tparams, t(xs), ctx=tctx, mode="decode",
                           cache=tcache, positions=t(pos))
        np.testing.assert_allclose(to_np(got), np.asarray(want, np.float32), **tol)
        assert_tree_close(tcache, np_tree(jcache), **tol)


@pytest.mark.parametrize("policy", ["double", "half"])
@pytest.mark.parametrize("name,kw", [("linear", {}), ("ring", dict(mask="sliding", window=8))])
def test_attention_decode_block_of_tokens(policy, name, kw):
    """S = 3 new tokens in one decode call (widened q; unrolled on a ring)."""
    jmod, tmod, jparams, tparams = _attn_pair(policy, **kw)
    jctx, tctx = _ctxs(policy, {"cache_max_len": 16})
    tol = TOLS[policy]
    x = _x((2, 10, D_MODEL))
    _, jcache = jmod(jparams, jnp.asarray(x), ctx=jctx, mode="prefill")
    _, tcache = tmod(tparams, t(x), ctx=tctx, mode="prefill")
    xs = _x((2, 3, D_MODEL), seed=40)
    pos = np.broadcast_to(np.arange(10, 13, dtype=np.int32), (2, 3)).copy()
    want, jcache = jmod(jparams, jnp.asarray(xs), ctx=jctx, mode="decode",
                        cache=jcache, positions=jnp.asarray(pos))
    got, tcache = tmod(tparams, t(xs), ctx=tctx, mode="decode",
                       cache=tcache, positions=t(pos))
    np.testing.assert_allclose(to_np(got), np.asarray(want, np.float32), **tol)
    assert_tree_close(tcache, np_tree(jcache), **tol)


@pytest.mark.parametrize("per_request", [False, True])
def test_decode_on_a_full_cache_writes_as_the_reference(per_request):
    """Out-of-bounds writes: the reference's scatter drops them (per-request
    index) and its dynamic_update_slice clamps the start (scalar index).
    The port must land the same cache instead of raising."""
    jmod, tmod, jparams, tparams = _attn_pair("double")
    jctx, tctx = _ctxs("double", {"cache_max_len": 8})
    # the plain path masks from positions, so a full cache stays well defined
    jctx.impls, tctx.impls = [], []
    x = _x((2, 8, D_MODEL))
    _, jcache = jmod(jparams, jnp.asarray(x), ctx=jctx, mode="prefill")
    _, tcache = tmod(tparams, t(x), ctx=tctx, mode="prefill")
    if per_request:
        jcache = dict(jcache, index=jnp.asarray([8, 8], jnp.int32))
        tcache = dict(tcache, index=torch.tensor([8, 8], dtype=torch.int32))
    xs = _x((2, 1, D_MODEL), seed=50)
    pos = np.full((2, 1), 8, np.int32)
    want, jcache = jmod(jparams, jnp.asarray(xs), ctx=jctx, mode="decode",
                        cache=jcache, positions=jnp.asarray(pos))
    got, tcache = tmod(tparams, t(xs), ctx=tctx, mode="decode",
                       cache=tcache, positions=t(pos))
    assert_tree_close(tcache, np_tree(jcache), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(to_np(got), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_empty_caches_match_reference():
    want = np_tree(jattn.init_cache(2, 8, 2, 64))
    assert_tree_close(tattn.init_cache(2, 8, 2, 64), want, atol=0, rtol=0)
    want = np_tree(jattn.init_ring_cache(2, 8, 2, 64))
    got = tattn.init_ring_cache(2, 8, 2, 64)
    assert_tree_close(got, want, atol=0, rtol=0)
    assert got["k"].dtype == torch.bfloat16 and got["pos"].dtype == torch.int32
    spec = tattn.cache_spec(2, 8, 2, 64, ring=True)
    assert {k: tuple(v.shape) for k, v in got.items()} == {k: s for k, (s, _) in spec.items()}


def test_eager_attention_blocked_matches_reference():
    rng = np.random.default_rng(60)
    q = rng.standard_normal((2, 40, 4, 64)).astype(np.float32)
    k = rng.standard_normal((2, 40, 2, 64)).astype(np.float32)
    v = rng.standard_normal((2, 40, 2, 64)).astype(np.float32)
    pos = np.broadcast_to(np.arange(40, dtype=np.int32), (2, 40)).copy()
    kw = dict(mask_kind="sliding", window=12, softcap=25.0, block=16)
    want = jattn.xla_attention_blocked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                       jnp.asarray(pos), jnp.asarray(pos), **kw)
    got = tattn.eager_attention_blocked(t(q), t(k), t(v), t(pos), t(pos), **kw)
    np.testing.assert_allclose(to_np(got), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_kernel_gate_is_the_reference_gate():
    for hd in (16, 64, 96, 128, 256, 384):
        j = jattn.Attention("a", 64, 4, 2, hd)._pallas_ok()
        assert tattn.Attention("a", 64, 4, 2, hd)._kernel_ok() == j
    assert not tattn.Attention("a", 64, 3, 2, 64)._kernel_ok()


@pytest.mark.parametrize("hd", [16, 64])
def test_cpu_tensors_keep_the_reference_gate_under_the_cuda_impl(hd):
    """`_use_kernel` consults the head_dim gate for CPU tensors only (the
    branch the reference takes); the plain impl never reaches a wrapper."""
    attn = tattn.Attention("a", 64, 4, 2, hd)
    q = torch.zeros((1, 2, 4, hd))
    woven = TCtx(impls=[("*", "attention", "cuda")])
    assert attn._use_kernel(woven, q) == attn._kernel_ok() == (hd == 64)
    assert not attn._use_kernel(TCtx(), q)
