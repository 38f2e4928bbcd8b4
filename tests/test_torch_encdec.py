"""PyTorch port, the encoder-decoder family (whisper-small) against the
reference: `sinusoidal_positions`, cross-attention (the twins of
`tests/test_flash_decode.py::TestCrossDecode`), `EncoderBlock`,
`DecoderXBlock`, reduced `EncDecLM` whole (dense, prefill, its cache and
encoder states, eight greedy decode steps), the decode-vs-dense identity of
`tests/test_models_smoke.py::test_decode_matches_dense`, one fp32 train
step, and `Server.serve`'s refusal (it takes no frames) in both packages.

Weights come from the reference's init through `convert.load_jax_params`;
inputs from a seeded numpy generator.  Tolerances: fp32 policy 1e-4 on
logits (the reference's Pallas kernels run in interpret mode at head_dim
64, the port's kernels' plain versions), 1e-3 on a kernel's plain version
against the reference's kernel; bf16 2e-2.  `sinusoidal_positions`: two
fp32 steps of the largest angle (see its test)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import SHAPES as JSHAPES
from repro.core.program import Program as JProgram
from repro.core.strategies.kernels import KernelAspect as JKernelAspect
from repro.launch.weave import default_weave as jweave
from repro.models.encdec import DecoderXBlock as JDecoderXBlock
from repro.models.encdec import EncoderBlock as JEncoderBlock
from repro.models.registry import build_model as jbuild
from repro.models.registry import get_config as jget
from repro.models.registry import reduced_config as jreduced
from repro.nn.attention import Attention as JAttention
from repro.nn.blocks import sinusoidal_positions as jsinusoidal
from repro.nn.dtypes import PolicyResolver as JPolicies
from repro.nn.module import Ctx as JCtx
from repro.nn.module import init_params as jinit
from repro.optim import adamw as jadamw
from repro.optim import schedule as jsched
from repro.runtime.server import Server as JServer
from repro.runtime.server import ServerConfig as JServerConfig
from repro.runtime.steps import build_train_step as jbuild_train_step
from repro_torch.configs.base import SHAPES
from repro_torch.convert import load_jax_params
from repro_torch.core.program import Program
from repro_torch.core.strategies.kernels import KernelAspect
from repro_torch.launch.weave import default_weave
from repro_torch.models.encdec import DecoderXBlock, EncDecLM, EncoderBlock
from repro_torch.models.registry import build_model, get_config, reduced_config
from repro_torch.nn.attention import Attention
from repro_torch.nn.blocks import sinusoidal_positions
from repro_torch.nn.dtypes import PolicyResolver as TPolicies
from repro_torch.nn.module import Ctx, init_params
from repro_torch.optim import adamw, schedule
from repro_torch.runtime.server import Server, ServerConfig
from repro_torch.runtime.steps import build_decode_step, build_prefill_step, build_train_step

from _torch_port import (assert_tree_close, assert_tree_is_the_reference_tree, np_tree,
                         perturbed, t, to_np)

torch.set_num_threads(1)

TOL = dict(atol=1e-4, rtol=1e-4)
EXTRA = {"flash_block_q": 32, "flash_block_kv": 32, "flash_block_kv_dec": 16,
         "cache_max_len": 24}
B, T_ENC, S = 2, 20, 5


def _rng(seed):
    return np.random.default_rng(seed)


def _ctxs(impl: bool, policy="double", extra=EXTRA):
    jctx = JCtx(policies=JPolicies.default(policy), extra=dict(extra),
                impls=[("*", "attention", "pallas")] if impl else [])
    tctx = Ctx(policies=TPolicies.default(policy), extra=dict(extra),
               impls=[("*", "attention", "cuda")] if impl else [])
    return jctx, tctx


def _jitted(jmodel, jctx):
    """The reference model as one compiled function per mode: op-by-op
    dispatch compiles every op anew for every sequence length."""
    fns = {}

    def run(params, inputs, *, mode, cache=None):
        if mode not in fns:
            fns[mode] = jax.jit(lambda p, i, c, _m=mode: jmodel(p, i, ctx=jctx, mode=_m, cache=c))
        return fns[mode](params, inputs, cache)

    return run


# ---------------------------------------------------------------------------
# sinusoidal positions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("positions", [np.arange(1501), np.array([0, 1, 31999, 32767, 32768])],
                         ids=["0..1500", "32k"])
@pytest.mark.parametrize("dim", [768, 64, 2])
def test_sinusoidal_positions_match_reference(positions, dim):
    """fp32 angles in both packages.  XLA's and PyTorch's fp32 `exp` differ
    by one ulp on some frequencies, which moves an angle p * f by up to one
    fp32 step of p (1.2e-4 rad at 1500, 3.9e-3 at 32k): the embeddings are
    held within two such steps, and each package's sin / cos within 1e-6 of
    the exact sin / cos of its own fp32 angles."""
    pos = positions.astype(np.int32)[None]
    want = np.asarray(jsinusoidal(jnp.asarray(pos), dim))
    got = sinusoidal_positions(t(pos), dim)
    assert got.dtype == torch.float32 and got.shape == (1, len(positions), dim)
    step = float(np.spacing(np.float32(positions.max())))
    np.testing.assert_allclose(to_np(got), want, atol=2 * step, rtol=0)
    # the port's own fp32 angles, from its own frequencies
    half = dim // 2
    f = torch.exp(-torch.arange(half, dtype=torch.float32) *
                  np.float32(np.log(10000.0) / max(half - 1, 1))).numpy()
    ang = (positions.astype(np.float32)[:, None] * f).astype(np.float64)
    exact = np.concatenate([np.sin(ang), np.cos(ang)], -1)
    np.testing.assert_allclose(to_np(got)[0], exact, atol=1e-6, rtol=0)


# ---------------------------------------------------------------------------
# cross-attention: twins of TestCrossDecode
# ---------------------------------------------------------------------------


def _cross_pair(softcap=None, d=64, H=4, K=2, D=64):
    jattn = JAttention("cross", d, H, K, D, use_rope=False, mask="full", cross=True,
                       softcap=softcap)
    tattn = Attention("cross", d, H, K, D, use_rope=False, mask="full", cross=True,
                      softcap=softcap)
    jparams = jinit(jattn, jax.random.PRNGKey(4), JPolicies.default("double"))
    init_params(tattn, 0, TPolicies.default("double"), "cpu")
    tparams = load_jax_params(tattn, np_tree(jparams))
    return jattn, tattn, jparams, tparams


@pytest.mark.parametrize("softcap", [None, 25.0])
def test_cross_decode_matches_reference_kernel(softcap):
    """A single-token decode over the cached encoder K/V: the port's `cuda`
    impl on the CPU (`flash_decode`'s plain version at index T - 1) against
    the reference's Pallas decode (interpret mode) and its XLA path; the
    cross cache comes back as the same object, unwritten."""
    jattn, tattn, jparams, tparams = _cross_pair(softcap)
    rng = _rng(0)
    kv_src = rng.standard_normal((B, 96, 64)).astype(np.float32)
    xq = rng.standard_normal((B, 1, 64)).astype(np.float32)
    x4 = rng.standard_normal((B, 4, 64)).astype(np.float32)
    jx, tx = _ctxs(False, extra={"flash_block_kv_dec": 32})
    jp, tp = _ctxs(True, extra={"flash_block_kv_dec": 32})
    _, jcache = jattn(jparams, jnp.asarray(x4), ctx=jx, kv_src=jnp.asarray(kv_src))
    _, tcache = tattn(tparams, t(x4), ctx=tx, kv_src=t(kv_src))
    assert set(tcache) == {"ck", "cv"} and tcache["ck"].dtype == torch.float32
    assert_tree_close(tcache, np_tree(jcache), **TOL)
    snapshot = {k: v.clone() for k, v in tcache.items()}

    want_pallas, _ = jattn(jparams, jnp.asarray(xq), ctx=jp, mode="decode", cache=jcache)
    want_xla, _ = jattn(jparams, jnp.asarray(xq), ctx=jx, mode="decode", cache=jcache)
    got, c_p = tattn(tparams, t(xq), ctx=tp, mode="decode", cache=tcache)
    got_x, c_x = tattn(tparams, t(xq), ctx=tx, mode="decode", cache=tcache)
    np.testing.assert_allclose(to_np(got), np.asarray(want_pallas), atol=1e-3, rtol=1e-3)
    np.testing.assert_allclose(to_np(got), np.asarray(want_pallas), **TOL)
    np.testing.assert_allclose(to_np(got_x), np.asarray(want_xla), **TOL)
    assert c_p is tcache and c_x is tcache
    for k in snapshot:
        assert torch.equal(tcache[k], snapshot[k])


def test_cross_decode_launches_flash_decode_at_the_last_slot(monkeypatch):
    """Under the `cuda` impl a single-token cross decode goes through
    `flash_decode` at index T - 1 over the dense K/V; a multi-token call
    does not."""
    from repro_torch.nn import attention as attn_mod

    _, tattn, _, tparams = _cross_pair()
    rng = _rng(1)
    kv_src = t(rng.standard_normal((B, 33, 64)).astype(np.float32))
    calls = []
    real = attn_mod.flash_decode
    monkeypatch.setattr(attn_mod, "flash_decode",
                        lambda q, k, v, index, **kw: calls.append((k.shape, index.tolist(), kw))
                        or real(q, k, v, index, **kw))
    _, tp = _ctxs(True)
    _, cache = tattn(tparams, t(rng.standard_normal((B, 6, 64)).astype(np.float32)), ctx=tp,
                     mode="prefill", kv_src=kv_src)
    assert calls == []
    tattn(tparams, t(rng.standard_normal((B, 1, 64)).astype(np.float32)), ctx=tp,
          mode="decode", cache=cache)
    assert len(calls) == 1
    shape, index, kw = calls[0]
    assert shape == (B, 33, 2, 64) and index == [32, 32] and "window" not in kw


@pytest.mark.parametrize("impl", [False, True], ids=["plain", "cuda"])
def test_multi_token_cross_matches_reference_xla_path(impl):
    """A multi-token (prefill / dense) cross call takes the plain attention
    under either impl, and equals the reference's XLA path (its Pallas impl
    keeps the XLA path too, `test_prefill_keeps_xla_path`)."""
    jattn, tattn, jparams, tparams = _cross_pair()
    rng = _rng(2)
    kv_src = rng.standard_normal((B, 64, 64)).astype(np.float32)
    x = rng.standard_normal((B, 6, 64)).astype(np.float32)
    jx, _ = _ctxs(False)
    _, tctx = _ctxs(impl)
    want, _ = jattn(jparams, jnp.asarray(x), ctx=jx, kv_src=jnp.asarray(kv_src))
    got, cache = tattn(tparams, t(x), ctx=tctx, kv_src=t(kv_src))
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)
    plain, _ = tattn(tparams, t(x), ctx=_ctxs(False)[1], kv_src=t(kv_src))
    assert torch.equal(got, plain)


def test_cross_needs_a_source_or_a_cache():
    _, tattn, _, tparams = _cross_pair()
    with pytest.raises(ValueError, match="kv_src"):
        tattn(tparams, torch.zeros(1, 1, 64, dtype=torch.float64), ctx=_ctxs(False)[1])


# ---------------------------------------------------------------------------
# the blocks
# ---------------------------------------------------------------------------


def _block_pair(jcls, tcls, head_dim):
    jcfg = jreduced("whisper-small").replace(head_dim=head_dim)
    tcfg = reduced_config("whisper-small").replace(head_dim=head_dim)
    jblock, tblock = jcls("block", jcfg), tcls("block", tcfg)
    jparams = perturbed(jinit(jblock, jax.random.PRNGKey(1), JPolicies.default("double")), 3)
    init_params(tblock, 0, TPolicies.default("double"), "cpu")
    tparams = load_jax_params(tblock, jparams)
    return jblock, tblock, jax.tree.map(jnp.asarray, jparams), tparams


@pytest.mark.parametrize("head_dim", [16, 64])
def test_encoder_block_matches_reference(head_dim):
    """Non-causal self-attention (K1's plain version at head_dim 64, the
    reference's Pallas kernel in interpret mode), LayerNorm's biased
    variance, the tanh GELU MLP with bias."""
    jblock, tblock, jparams, tparams = _block_pair(JEncoderBlock, EncoderBlock, head_dim)
    x = _rng(3).standard_normal((B, T_ENC, 64)).astype(np.float32)
    for impl in (False, True):
        jctx, tctx = _ctxs(impl)
        want, _ = jax.jit(lambda p, x_: jblock(p, x_, ctx=jctx))(jparams, jnp.asarray(x))
        got, none = tblock(tparams, t(x), ctx=tctx)
        assert none is None
        np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("head_dim", [16, 64])
def test_decoder_x_block_matches_reference(head_dim):
    """Prefill (the self cache and the cross {ck, cv} built from kv_src),
    then a decode step over them: outputs and caches against the
    reference's; the cross cache comes back unwritten."""
    jblock, tblock, jparams, tparams = _block_pair(JDecoderXBlock, DecoderXBlock, head_dim)
    rng = _rng(4)
    x = rng.standard_normal((B, S, 64)).astype(np.float32)
    enc = rng.standard_normal((B, T_ENC, 64)).astype(np.float32)
    xd = rng.standard_normal((B, 1, 64)).astype(np.float32)
    pos = np.full((B, 1), S, np.int32)
    for impl in (False, True):
        jctx, tctx = _ctxs(impl)
        want, jcache = jax.jit(lambda p, x_, e: jblock(p, x_, ctx=jctx, mode="prefill",
                                                       kv_src=e))(
            jparams, jnp.asarray(x), jnp.asarray(enc))
        got, tcache = tblock(tparams, t(x), ctx=tctx, mode="prefill", kv_src=t(enc))
        np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)
        assert_tree_close(tcache, np_tree(jcache), **TOL)
        cross = tcache["cross"]
        want, jcache = jax.jit(lambda p, x_, c, q: jblock(p, x_, ctx=jctx, mode="decode",
                                                          cache=c, positions=q))(
            jparams, jnp.asarray(xd), jcache, jnp.asarray(pos))
        got, tcache = tblock(tparams, t(xd), ctx=tctx, mode="decode", cache=tcache,
                             positions=t(pos))
        np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)
        assert_tree_close(tcache, np_tree(jcache), **TOL)
        assert tcache["cross"] is cross


# ---------------------------------------------------------------------------
# EncDecLM whole
# ---------------------------------------------------------------------------


def _models(head_dim, impl=True):
    jcfg = jreduced("whisper-small").replace(head_dim=head_dim)
    tcfg = reduced_config("whisper-small").replace(head_dim=head_dim)
    jmodel, tmodel = jbuild(jcfg), build_model(tcfg)
    assert isinstance(tmodel, EncDecLM)
    jparams = perturbed(jinit(jmodel, jax.random.PRNGKey(0), JPolicies.default("double")), 5)
    init_params(tmodel, 0, TPolicies.default("double"), "cpu")
    tparams = load_jax_params(tmodel, jparams)
    jctx, tctx = _ctxs(impl)
    return _jitted(jmodel, jctx), tmodel, jax.tree.map(jnp.asarray, jparams), tparams, tctx


def _inputs(seed, S_=S, T=T_ENC):
    rng = _rng(seed)
    return (rng.integers(0, 512, (B, S_)).astype(np.int32),
            rng.standard_normal((B, T, 64)).astype(np.float32))


@pytest.mark.parametrize("head_dim,impl", [(16, False), (64, True), (64, False)],
                         ids=["16-plain", "64-kernels", "64-plain"])
def test_encdec_logits_caches_and_greedy_decode_match_reference(head_dim, impl):
    """Dense logits, prefill logits, the prefill cache (self, cross, `enc`),
    then eight greedy decode steps: logits within 1e-4, caches after every
    step, and the greedy tokens equal.  (At head_dim 16 neither package
    reaches a kernel, and whisper has no RMSNorm: the kernel impls run the
    plain path there.)"""
    jmodel, tmodel, jparams, tparams, tctx = _models(head_dim, impl)
    tokens, frames = _inputs(6)
    jin = {"tokens": jnp.asarray(tokens), "frames": jnp.asarray(frames)}
    tin = {"tokens": t(tokens), "frames": t(frames)}

    want, _ = jmodel(jparams, jin, mode="dense")
    got, none = tmodel(tparams, tin, ctx=tctx, mode="dense")
    assert none is None and got.shape == (B, S, 512)
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)

    want, jcache = jmodel(jparams, jin, mode="prefill")
    got, tcache = tmodel(tparams, tin, ctx=tctx, mode="prefill")
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)
    assert set(tcache) == {"decoder", "enc"}
    assert tcache["enc"].shape == (B, T_ENC, 64)
    assert tcache["decoder"]["cross"]["ck"].shape == (2, B, T_ENC, 2, head_dim)
    assert tcache["decoder"]["self"]["k"].shape == (2, B, 24, 2, head_dim)
    assert_tree_close(tcache, np_tree(jcache), **TOL)

    jtoks, ttoks = [], []
    for step in range(8):
        jtok = np.argmax(np.asarray(want, np.float32)[:, -1], -1)[:, None].astype(np.int32)
        ttok = torch.argmax(got[:, -1], dim=-1)[:, None].to(torch.int32)
        jtoks.append(jtok)
        ttoks.append(to_np(ttok))
        pos = np.full((B, 1), S + step, np.int32)
        cross = tcache["decoder"]["cross"]
        want, jcache = jmodel(jparams, {"tokens": jnp.asarray(jtok), "positions": jnp.asarray(pos)},
                              mode="decode", cache=jcache)
        got, tcache = tmodel(tparams, {"tokens": ttok, "positions": t(pos)}, ctx=tctx,
                             mode="decode", cache=tcache)
        np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)
        assert_tree_close(tcache, np_tree(jcache), **TOL)
        assert tcache["decoder"]["cross"]["ck"] is cross["ck"]
        assert tcache["decoder"]["cross"]["cv"] is cross["cv"]
    np.testing.assert_array_equal(np.concatenate(ttoks, 1), np.concatenate(jtoks, 1))


def test_encdec_bf16_logits_match_reference():
    """The serving policy (bf16 compute): prefill and one decode step within
    2e-2 of the reference's."""
    jcfg = jreduced("whisper-small").replace(head_dim=64)
    jmodel, tmodel = jbuild(jcfg), build_model(reduced_config("whisper-small")
                                               .replace(head_dim=64))
    jparams = jinit(jmodel, jax.random.PRNGKey(2))
    init_params(tmodel, 0, None, "cpu")
    tparams = load_jax_params(tmodel, np_tree(jparams))
    jctx, tctx = _ctxs(True, policy="half")
    jrun = _jitted(jmodel, jctx)
    tokens, frames = _inputs(7)
    want, jcache = jrun(jparams, {"tokens": jnp.asarray(tokens),
                                  "frames": jnp.asarray(frames, jnp.bfloat16)}, mode="prefill")
    got, tcache = tmodel(tparams, {"tokens": t(tokens), "frames": t(frames, torch.bfloat16)},
                         ctx=tctx, mode="prefill")
    np.testing.assert_allclose(to_np(got), np.asarray(want, np.float32), atol=2e-2, rtol=2e-2)
    tok = np.argmax(np.asarray(want, np.float32)[:, -1], -1)[:, None].astype(np.int32)
    pos = np.full((B, 1), S, np.int32)
    want, _ = jrun(jparams, {"tokens": jnp.asarray(tok), "positions": jnp.asarray(pos)},
                   mode="decode", cache=jcache)
    got, _ = tmodel(tparams, {"tokens": t(tok), "positions": t(pos)}, ctx=tctx,
                    mode="decode", cache=tcache)
    np.testing.assert_allclose(to_np(got), np.asarray(want, np.float32), atol=2e-2, rtol=2e-2)


def test_decode_matches_dense():
    """Prefill 16 tokens over 16 frames, decode the 17th: its logits are the
    dense forward's last row (the reference's test and tolerance)."""
    cfg = reduced_config("whisper-small")
    model = build_model(cfg)
    params = init_params(model, 0, None, "cpu")
    rng = _rng(8)
    toks = t(rng.integers(0, cfg.vocab, (B, 17)).astype(np.int32))
    frames = t(rng.standard_normal((B, 16, cfg.d_model)).astype(np.float32), torch.bfloat16)
    ctx = Ctx(extra={"cache_max_len": 20})
    _, cache = model(params, {"tokens": toks[:, :16], "frames": frames}, ctx=ctx,
                     mode="prefill")
    dec, _ = model(params, {"tokens": toks[:, 16:], "positions": torch.full((B, 1), 16)},
                   ctx=ctx, mode="decode", cache=cache)
    full, _ = model(params, {"tokens": toks, "frames": frames}, ctx=ctx, mode="dense")
    np.testing.assert_allclose(to_np(full[:, -1:]), to_np(dec), atol=0.08, rtol=0.05)


def test_woven_steps_decode_greedily_like_the_reference():
    """The reference's path for whisper: `build_prefill_step` /
    `build_decode_step` of the woven program in a greedy loop (head_dim 64,
    the kernels' plain versions on the CPU), tokens equal to the
    reference's woven steps'."""
    from repro.runtime.steps import build_decode_step as jdecode_step
    from repro.runtime.steps import build_prefill_step as jprefill_step

    jcfg = jreduced("whisper-small").replace(head_dim=64)
    tcfg = reduced_config("whisper-small").replace(head_dim=64)
    over = {"tuned_kernels": False}
    jw = jweave(JProgram(model=jbuild(jcfg), cfg=jcfg, kind="serve"), JSHAPES["prefill_32k"],
                {}, overrides=dict(over),
                extra_aspects=[JKernelAspect("*", "attention", "pallas")])
    tw = default_weave(Program(model=build_model(tcfg), cfg=tcfg, kind="serve",
                               device="cpu"),
                       SHAPES["prefill_32k"], {}, overrides=dict(over),
                       extra_aspects=[KernelAspect("*", "attention", "cuda")])
    jw.state.policies = JPolicies.default("double")
    tw.state.policies = TPolicies.default("double")
    jparams = perturbed(jinit(jw.program.model, jax.random.PRNGKey(3), jw.state.policies), 9)
    init_params(tw.program.model, 0, tw.state.policies, "cpu")
    tparams = load_jax_params(tw.program.model, jparams)
    jparams = jax.tree.map(jnp.asarray, jparams)
    tokens, frames = _inputs(10, S_=4)
    jpre = jax.jit(jprefill_step(jw, cache_max_len=16))
    jdec = jax.jit(jdecode_step(jw))
    tpre, tdec = build_prefill_step(tw, cache_max_len=16), build_decode_step(tw)
    jl, jc = jpre(jparams, {"tokens": jnp.asarray(tokens), "frames": jnp.asarray(frames)})
    tl, tc = tpre(tparams, {"tokens": t(tokens), "frames": t(frames)})
    jout, tout = [], []
    for i in range(8):
        np.testing.assert_allclose(to_np(tl), np.asarray(jl), **TOL)
        jt = jnp.argmax(jl[:, -1], -1)[:, None].astype(jnp.int32)
        tt = torch.argmax(tl[:, -1], -1)[:, None].to(torch.int32)
        jout.append(np.asarray(jt))
        tout.append(to_np(tt))
        pos = np.full((B, 1), 4 + i, np.int32)
        jl, jc = jdec(jparams, {"tokens": jt, "positions": jnp.asarray(pos)}, jc)
        tl, tc = tdec(tparams, {"tokens": tt, "positions": t(pos)}, tc)
    np.testing.assert_array_equal(np.concatenate(tout, 1), np.concatenate(jout, 1))


def test_cache_specs_and_init_cache_match_reference():
    jmodel = jbuild(jreduced("whisper-small"))
    tmodel = build_model(reduced_config("whisper-small"))
    jspecs = jmodel.cache_specs(3, 24, enc_len=40)
    tspecs = tmodel.cache_specs(3, 24, enc_len=40)
    flat_j = jax.tree_util.tree_flatten_with_path(jspecs)[0]
    want = {"/".join(str(k.key) for k in p): (tuple(s.shape), str(s.dtype)) for p, s in flat_j}

    def flat(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from flat(v, f"{prefix}{k}/")
            else:
                yield f"{prefix}{k}", (tuple(v[0]), str(v[1]).removeprefix("torch."))

    assert dict(flat(tspecs)) == want
    jc = jmodel.init_cache(3, 24, index=5, enc_len=40)
    tc = tmodel.init_cache(3, 24, index=5, enc_len=40)
    assert_tree_close(tc, np_tree(jc), atol=0, rtol=0)


# ---------------------------------------------------------------------------
# training and serving
# ---------------------------------------------------------------------------


def test_train_step_matches_the_reference():
    """One fp32 `build_train_step` step of reduced whisper-small at head_dim
    64 (the reference's Pallas forward and backward in interpret mode, the
    port's plain versions of K1 and K3): loss, accuracy and gradient norm."""
    jcfg = jreduced("whisper-small").replace(head_dim=64)
    tcfg = reduced_config("whisper-small").replace(head_dim=64)
    over = {"accum_steps": 1, "remat": "full", "tuned_kernels": False,
            "flash_block_q": 32, "flash_block_kv": 32}
    jw = jweave(JProgram(model=jbuild(jcfg), cfg=jcfg, kind="train"), JSHAPES["train_4k"],
                {}, overrides=dict(over),
                extra_aspects=[JKernelAspect("*", "attention", "pallas")])
    tw = default_weave(Program(model=build_model(tcfg), cfg=tcfg, kind="train",
                               device="cpu"),
                       SHAPES["train_4k"], {}, overrides=dict(over),
                       extra_aspects=[KernelAspect("*", "attention", "cuda")])
    jw.state.policies = JPolicies.default("f32")
    tw.state.policies = TPolicies.default("f32")
    jparams = jinit(jw.program.model, jax.random.PRNGKey(0), jw.state.policies)
    jopt = jadamw.init_state(jparams, jadamw.AdamWConfig())
    init_params(tw.program.model, 0, tw.state.policies, "cpu")
    tparams = load_jax_params(tw.program.model, np_tree(jparams))
    topt = adamw.init_state(tparams, adamw.AdamWConfig())
    rng = _rng(11)
    batch = {"tokens": rng.integers(0, 512, (2, 12)).astype(np.int32),
             "labels": rng.integers(0, 512, (2, 12)).astype(np.int32),
             "frames": rng.standard_normal((2, 16, 64)).astype(np.float32)}
    jstep = jax.jit(jbuild_train_step(jw, lr_fn=lambda s: jsched.constant(s, peak=1e-3)))
    tstep = build_train_step(tw, lr_fn=lambda s: schedule.constant(s, peak=1e-3))
    _, _, jm = jstep(jparams, jopt, jax.tree.map(jnp.asarray, batch), jnp.asarray(0, jnp.int32))
    _, _, tm = tstep(tparams, topt, {k: t(v) for k, v in batch.items()}, 0)
    for k in ("loss", "accuracy", "grad_norm"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def test_launcher_refuses_encdec_training_on_the_card():
    """The launcher's token pipeline makes no `frames`, so it refuses the
    encoder-decoder on either device and names that reason."""
    from repro_torch.launch import train as launch_train

    for device in ("cuda", "cpu"):
        with pytest.raises(NotImplementedError, match="makes no `frames`"):
            launch_train.build_trainer("whisper-small", reduced=True, device=device,
                                       batch=2, seq=8)


def test_server_serve_fails_without_frames_in_both_packages():
    """`Server.serve` takes tokens only: neither package's server can hand
    frames to the encoder, so both fail at the prefill."""
    jprog = JProgram.from_arch("whisper-small", kind="serve", reduced=True)
    tprog = Program.from_arch("whisper-small", kind="serve", reduced=True, device="cpu")
    jsrv = JServer(jweave(jprog, JSHAPES["prefill_32k"], {}),
                   JServerConfig(max_cache_len=16, decode_tokens=2))
    tsrv = Server(default_weave(tprog, SHAPES["prefill_32k"], {}),
                  ServerConfig(max_cache_len=16, decode_tokens=2))
    prompt = np.ones((1, 4), np.int32)
    with pytest.raises(KeyError, match="frames"):
        jsrv.serve(prompt)
    with pytest.raises(KeyError, match="frames"):
        tsrv.serve(prompt)


def test_full_config_builds_at_published_size():
    """whisper-small's published dimensions; `param_count` and the built
    tree's paths and shapes are the reference's (shapes only)."""
    cfg = get_config("whisper-small")
    assert (cfg.enc_layers, cfg.num_layers, cfg.d_model, cfg.n_heads, cfg.kv_heads,
            cfg.resolved_head_dim, cfg.d_ff, cfg.vocab) == (12, 12, 768, 12, 12, 64, 3072, 51865)
    assert cfg.param_count() == jget("whisper-small").param_count()
    n = assert_tree_is_the_reference_tree("whisper-small")
    assert 0.2e9 < n < 0.3e9
