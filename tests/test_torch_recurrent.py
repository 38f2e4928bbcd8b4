"""PyTorch port, the recurrent families' kernels and modules: recurrentgemma-2b
(RG-LRU, kernel K5) and rwkv6-3b (WKV, kernel K6) against the reference.

- the kernels' plain versions against the reference's oracles and its Pallas
  kernels in interpret mode (K5 within 1e-4; K6 within the reference test's
  own scale-aware 5e-3, which strong decays need);
- every module of the slice at the `double` policy (fp32 everywhere) within
  1e-4, on the same numpy inputs and the same (converted) weights.
The whole models and their servers are `test_torch_recurrent_model.py`.  The
port's side has the CUDA kernels woven; on CPU tensors their wrappers take
the plain versions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rglru.ops import rglru_pallas
from repro.kernels.rglru.ref import rglru_assoc as j_rglru_assoc
from repro.kernels.rglru.ref import rglru_scan as j_rglru_scan
from repro.kernels.rwkv6.ops import wkv_pallas
from repro.kernels.rwkv6.ref import wkv_chunked as j_wkv_chunked
from repro.kernels.rwkv6.ref import wkv_scan as j_wkv_scan
from repro.nn import blocks as jblocks
from repro.nn import rglru as jrglru
from repro.nn import rwkv as jrwkv
from repro.nn.dtypes import PolicyResolver as JPolicies
from repro.nn.module import Ctx as JCtx
from repro.nn.module import init_params as jinit
from repro_torch.convert import cache_from_numpy, load_jax_params
from repro_torch.kernels.rglru.ops import rglru
from repro_torch.kernels.rglru.ref import rglru_assoc, rglru_scan
from repro_torch.kernels.rwkv6.ops import wkv
from repro_torch.kernels.rwkv6.ref import wkv_chunked, wkv_scan
from repro_torch.nn import blocks as tblocks
from repro_torch.nn import rglru as trglru
from repro_torch.nn import rwkv as trwkv
from repro_torch.nn.dtypes import PolicyResolver as TPolicies
from repro_torch.nn.module import Ctx as TCtx
from repro_torch.nn.module import init_params as tinit
from repro_torch.nn.module import param_tree

from _torch_port import assert_tree_close, np_tree, perturbed, t, to_np

torch.set_num_threads(1)

TOL = dict(atol=1e-4, rtol=1e-4)  # fp32 everywhere; reordered sums only
JIMPLS = [("*", "attention", "pallas"), ("*", "norm", "pallas"),
          ("*", "rglru", "pallas"), ("*", "wkv", "pallas")]
TIMPLS = [("*", "attention", "cuda"), ("*", "norm", "cuda"),
          ("*", "rglru", "cuda"), ("*", "wkv", "cuda")]
EXTRA = {"rglru_block_d": 8, "rglru_chunk": 16, "wkv_chunk": 16, "cache_max_len": 24}


def _rng(seed):
    return np.random.default_rng(seed)


def _x(shape, seed=0, scale=1.0):
    return (scale * _rng(seed).standard_normal(shape)).astype(np.float32)


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


# ---------------------------------------------------------------------------
# K5 and K6: plain versions against the reference's oracles and kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("S", [17, 64, 100])
@pytest.mark.parametrize("D", [8, 24, 64])
def test_rglru_plain_versions_match_reference(S, D):
    B = 2
    a = _sigmoid(_x((B, S, D), seed=S * D))
    b = _x((B, S, D), seed=S * D + 1)
    h0 = _x((B, D), seed=S * D + 2)
    ja, jb, jh = (jnp.asarray(v) for v in (a, b, h0))
    want = [j_rglru_scan(ja, jb, jh), j_rglru_assoc(ja, jb, jh),
            rglru_pallas(ja, jb, jh, block_d=8, chunk=16, interpret=True)]
    got = [rglru_scan(t(a), t(b), t(h0)), rglru_assoc(t(a), t(b), t(h0)),
           rglru(t(a), t(b), t(h0))]
    for y, h_last in got:
        assert y.dtype == h_last.dtype == torch.float32
        for wy, wh in want:
            np.testing.assert_allclose(to_np(y), np.asarray(wy), atol=1e-4, rtol=0)
            np.testing.assert_allclose(to_np(h_last), np.asarray(wh), atol=1e-4, rtol=0)


def _wkv_inputs(B, S, H, C, decay_scale, seed):
    r, k, v = (_x((B, S, H, C), seed=seed + i) for i in range(3))
    w = np.exp(-np.exp(_x((B, S, H, C), seed=seed + 3) * decay_scale)).astype(np.float32)
    u = _x((H, C), seed=seed + 4)
    s0 = _x((B, H, C, C), seed=seed + 5)
    return r, k, v, w, u, s0


@pytest.mark.parametrize("S,C,chunk", [(32, 8, 16), (64, 16, 32), (100, 16, 32)])
@pytest.mark.parametrize("decay_scale", [0.5, 3.0])  # strong decays too
def test_wkv_plain_versions_match_reference(S, C, chunk, decay_scale):
    arrays = _wkv_inputs(2, S, 2, C, decay_scale, seed=S * C + chunk)
    jargs = [jnp.asarray(x) for x in arrays]
    targs = [t(x) for x in arrays]
    want = [j_wkv_scan(*jargs), j_wkv_chunked(*jargs, chunk=chunk),
            wkv_pallas(*jargs, chunk=chunk, interpret=True)]
    got = [wkv_scan(*targs), wkv_chunked(*targs, chunk=chunk), wkv(*targs)]
    # strong decays amplify fp32 ordering differences: the reference test's
    # scale-aware tolerance
    scale = float(np.max(np.abs(np.asarray(want[0][0])))) + 1.0
    for y, s_last in got:
        assert y.dtype == torch.float32 and s_last.dtype == torch.float32
        for wy, ws in want:
            np.testing.assert_allclose(to_np(y), np.asarray(wy), rtol=5e-3,
                                       atol=5e-3 * scale)
            np.testing.assert_allclose(to_np(s_last), np.asarray(ws), rtol=5e-3, atol=5e-3)


def test_wkv_keeps_the_input_dtype_and_fp32_state():
    r, k, v, w, u, s0 = _wkv_inputs(1, 9, 2, 8, 0.5, seed=3)
    args = [t(r, torch.bfloat16), t(k, torch.bfloat16), t(v, torch.bfloat16),
            t(w), t(u), t(s0)]
    for fn in (wkv, wkv_scan, wkv_chunked):
        y, s_last = fn(*args)
        assert y.dtype == torch.bfloat16 and s_last.dtype == torch.float32


# ---------------------------------------------------------------------------
# Modules of the slice (policy `double`)
# ---------------------------------------------------------------------------


def _ctxs(impls=True, extra=None):
    pol = "double"
    jctx = JCtx(policies=JPolicies.default(pol), extra={**EXTRA, **(extra or {})},
                impls=JIMPLS if impls else [])
    tctx = TCtx(policies=TPolicies.default(pol), extra={**EXTRA, **(extra or {})},
                impls=TIMPLS if impls else [])
    return jctx, tctx


def _pair(jmod, tmod, seed=0):
    jparams = jinit(jmod, jax.random.PRNGKey(seed), JPolicies.default("double"))
    jparams = perturbed(jparams, seed)
    tinit(tmod, 0, TPolicies.default("double"), "cpu")
    tparams = load_jax_params(tmod, jparams)
    return jax.tree.map(jnp.asarray, jparams), tparams


def _close(got, want):
    np.testing.assert_allclose(to_np(got), np.asarray(want, np.float32), **TOL)


def test_layernorm_and_groupnorm():
    x = _x((2, 5, 64), seed=1, scale=3.0) + 1.5
    for jmod, tmod in ((jblocks.LayerNorm("ln", 64), tblocks.LayerNorm("ln", 64)),
                       (jblocks.GroupNorm("gn", 4, 64), tblocks.GroupNorm("gn", 4, 64))):
        jparams, tparams = _pair(jmod, tmod)
        jctx, tctx = _ctxs()
        want = jmod(jparams, jnp.asarray(x), ctx=jctx)
        got = tmod(tparams, t(x), ctx=tctx)
        assert got.dtype == torch.float32
        _close(got, want)


def test_layernorm_stays_plain_under_the_norm_kernel_weave(monkeypatch):
    """`"norm" -> "cuda"` is read by RMSNorm alone: LayerNorm and GroupNorm
    never reach the RMSNorm kernel, which computes another function."""
    from repro_torch.kernels.rmsnorm import ops as norm_ops

    def forbidden(*a, **k):
        raise AssertionError("a LayerNorm / GroupNorm reached the RMSNorm kernel")

    monkeypatch.setattr(norm_ops, "rmsnorm", forbidden)
    monkeypatch.setattr(norm_ops, "rmsnorm_ref", forbidden)
    _, tctx = _ctxs()
    assert tctx.impl("norm", "eager") == "cuda"
    x = t(_x((2, 3, 64), seed=2))
    for mod in (tblocks.LayerNorm("ln", 64), tblocks.GroupNorm("gn", 4, 64)):
        tinit(mod, 0, None, "cpu")
        y = mod(param_tree(mod), x, ctx=tctx)
        xf = x.reshape(2, 3, -1, 64 if isinstance(mod, tblocks.LayerNorm) else 16)
        want = (xf - xf.mean(-1, keepdim=True)) / torch.sqrt(
            xf.var(-1, unbiased=False, keepdim=True) + 1e-5)
        torch.testing.assert_close(y, want.reshape(2, 3, 64), atol=1e-5, rtol=1e-5)
    rms = tblocks.RMSNorm("rms", 64)
    tinit(rms, 0, None, "cpu")
    with pytest.raises(AssertionError, match="reached the RMSNorm kernel"):
        rms({"w": torch.ones(64)}, x, ctx=tctx)


def test_block_diagonal_linear():
    jmod = jrglru.BlockDiagonalLinear("gate_a", 64, 4)
    tmod = trglru.BlockDiagonalLinear("gate_a", 64, 4)
    jparams, tparams = _pair(jmod, tmod, seed=1)
    jctx, tctx = _ctxs()
    x = _x((2, 7, 64), seed=3)
    _close(tmod(tparams, t(x), ctx=tctx), jmod(jparams, jnp.asarray(x), ctx=jctx))


@pytest.mark.parametrize("impl", ["assoc", "scan", "cuda"])
def test_rglru_prefill_then_decode_with_state(impl):
    jmod, tmod = jrglru.RGLRU("rglru", 64, 4), trglru.RGLRU("rglru", 64, 4)
    jparams, tparams = _pair(jmod, tmod, seed=2)
    jimpl = {"cuda": "pallas"}.get(impl, impl)
    jctx = JCtx(policies=JPolicies.default("double"), extra=EXTRA,
                impls=[("*", "rglru", jimpl)])
    tctx = TCtx(policies=TPolicies.default("double"), extra=EXTRA,
                impls=[("*", "rglru", impl)])
    x = _x((2, 19, 64), seed=4)
    h0 = _x((2, 64), seed=5)
    want, jstate = jmod(jparams, jnp.asarray(x), ctx=jctx, state=jnp.asarray(h0),
                        mode="prefill")
    got, tstate = tmod(tparams, t(x), ctx=tctx, state=t(h0), mode="prefill")
    assert tstate.dtype == torch.float32
    _close(got, want)
    _close(tstate, jstate)
    for step in range(3):
        xd = _x((2, 1, 64), seed=10 + step)
        want, jstate = jmod(jparams, jnp.asarray(xd), ctx=jctx, state=jstate, mode="decode")
        got, tstate = tmod(tparams, t(xd), ctx=tctx, state=tstate, mode="decode")
        _close(got, want)
        _close(tstate, jstate)


def test_conv1d_with_state():
    jmod, tmod = jrglru.Conv1D("conv", 64), trglru.Conv1D("conv", 64)
    jparams, tparams = _pair(jmod, tmod, seed=3)
    jctx, tctx = _ctxs()
    for S, with_state in ((9, False), (2, True), (1, True)):
        x = _x((2, S, 64), seed=S)
        st = _x((2, 3, 64), seed=S + 1) if with_state else None
        want, jst = jmod(jparams, jnp.asarray(x), ctx=jctx,
                         state=None if st is None else jnp.asarray(st))
        got, tst = tmod(tparams, t(x), ctx=tctx, state=None if st is None else t(st))
        _close(got, want)
        _close(tst, jst)
        assert tst.shape == (2, 3, 64) and tst.is_contiguous()


def test_recurrent_block_prefill_then_decode():
    jmod = jrglru.RecurrentBlock("rec", 32, 64, 4)
    tmod = trglru.RecurrentBlock("rec", 32, 64, 4)
    jparams, tparams = _pair(jmod, tmod, seed=4)
    jctx, tctx = _ctxs()
    x = _x((2, 11, 32), seed=6)
    want, jst = jmod(jparams, jnp.asarray(x), ctx=jctx, mode="prefill")
    got, tst = tmod(tparams, t(x), ctx=tctx, mode="prefill")
    _close(got, want)
    assert_tree_close(tst, np_tree(jst), **TOL)
    for step in range(3):
        xd = _x((2, 1, 32), seed=20 + step)
        want, jst = jmod(jparams, jnp.asarray(xd), ctx=jctx, state=jst, mode="decode")
        got, tst = tmod(tparams, t(xd), ctx=tctx, state=tst, mode="decode")
        _close(got, want)
        assert_tree_close(tst, np_tree(jst), **TOL)
    assert_tree_close(tmod.init_state(2, device="cpu"), np_tree(jmod.init_state(2)),
                      atol=0, rtol=0)
    specs = trglru.RecurrentBlock.state_spec(2, 64)
    for key, sds in jrglru.RecurrentBlock.state_spec(2, 64).items():
        assert specs[key][0] == sds.shape
        assert str(specs[key][1]).split(".")[-1] == str(sds.dtype)


@pytest.mark.parametrize("S", [1, 6])
def test_token_shift_with_x_prev(S):
    x = _x((2, S, 16), seed=7)
    prev = _x((2, 16), seed=8)
    for p in (None, prev):
        want = jrwkv._token_shift(jnp.asarray(x), None if p is None else jnp.asarray(p))
        got = trwkv._token_shift(t(x), None if p is None else t(p))
        np.testing.assert_array_equal(to_np(got), np.asarray(want))


@pytest.mark.parametrize("impl", ["chunked", "scan", "cuda", "proj_only"])
def test_time_mix_prefill_then_decode(impl):
    jmod, tmod = jrwkv.TimeMix("time_mix", 64, 16), trwkv.TimeMix("time_mix", 64, 16)
    jparams, tparams = _pair(jmod, tmod, seed=5)
    jimpl = {"cuda": "pallas"}.get(impl, impl)
    jctx = JCtx(policies=JPolicies.default("double"), extra=EXTRA,
                impls=[("*", "wkv", jimpl)])
    tctx = TCtx(policies=TPolicies.default("double"), extra=EXTRA,
                impls=[("*", "wkv", impl)])
    x = _x((2, 21, 64), seed=9)
    state = {"x_prev": _x((2, 64), seed=10), "wkv": _x((2, 4, 16, 16), seed=11)}
    want, jst = jmod(jparams, jnp.asarray(x), ctx=jctx,
                     state=jax.tree.map(jnp.asarray, state), mode="prefill")
    got, tst = tmod(tparams, t(x), ctx=tctx, state=cache_from_numpy(state), mode="prefill")
    _close(got, want)
    assert_tree_close(tst, np_tree(jst), **TOL)
    for step in range(2):
        xd = _x((2, 1, 64), seed=30 + step)
        want, jst = jmod(jparams, jnp.asarray(xd), ctx=jctx, state=jst, mode="decode")
        got, tst = tmod(tparams, t(xd), ctx=tctx, state=tst, mode="decode")
        _close(got, want)
        assert_tree_close(tst, np_tree(jst), **TOL)


def test_channel_mix_with_state():
    jmod, tmod = jrwkv.ChannelMix("channel_mix", 64, 96), trwkv.ChannelMix("channel_mix", 64, 96)
    jparams, tparams = _pair(jmod, tmod, seed=6)
    jctx, tctx = _ctxs()
    x = _x((2, 5, 64), seed=12)
    prev = {"x_prev": _x((2, 64), seed=13)}
    for st in (None, prev):
        want, jst = jmod(jparams, jnp.asarray(x), ctx=jctx,
                         state=None if st is None else jax.tree.map(jnp.asarray, st))
        got, tst = tmod(tparams, t(x), ctx=tctx,
                        state=None if st is None else cache_from_numpy(st))
        _close(got, want)
        assert_tree_close(tst, np_tree(jst), **TOL)


def test_rwkv_state_spec_matches_reference():
    want = jrwkv.rwkv_state_spec(3, 64, 16)
    got = trwkv.rwkv_state_spec(3, 64, 16)
    for group in want:
        for key, sds in want[group].items():
            shape, dtype = got[group][key]
            assert shape == sds.shape and dtype == torch.float32
