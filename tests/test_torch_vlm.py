"""PyTorch port, the vision-language family (internvl2-1b) against the
reference: the image prefix (`inputs["embeds"]`, cast to the token
embeddings' dtype and put before them) through dense, prefill and eight
greedy decode steps at positions S + P, the decode-vs-dense identity of
`tests/test_models_smoke.py::test_decode_matches_dense`, one fp32 train
step with the prefix (the loss over the last `T_label` positions), and the
text-only requests through `Server.serve_continuous`, whose tokens and pool
stats equal the reference server's.

Weights come from the reference's init through `convert.load_jax_params`;
inputs from a seeded numpy generator.  Tolerances: fp32 policy 1e-4 on
logits (head_dim 64: the reference's Pallas kernels in interpret mode, the
port's kernels' plain versions), bf16 2e-2."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import SHAPES as JSHAPES
from repro.core.program import Program as JProgram
from repro.core.strategies.kernels import KernelAspect as JKernelAspect
from repro.launch.weave import default_weave as jweave
from repro.models.registry import build_model as jbuild
from repro.models.registry import get_config as jget
from repro.models.registry import reduced_config as jreduced
from repro.nn.dtypes import PolicyResolver as JPolicies
from repro.nn.module import Ctx as JCtx
from repro.nn.module import init_params as jinit
from repro.optim import adamw as jadamw
from repro.optim import schedule as jsched
from repro.runtime.steps import build_train_step as jbuild_train_step
from repro_torch.configs.base import SHAPES
from repro_torch.convert import load_jax_params
from repro_torch.core.program import Program
from repro_torch.core.strategies.kernels import KernelAspect
from repro_torch.launch.weave import default_weave
from repro_torch.models.lm import TransformerLM
from repro_torch.models.registry import build_model, get_config, reduced_config
from repro_torch.nn.dtypes import PolicyResolver as TPolicies
from repro_torch.nn.module import Ctx, init_params
from repro_torch.optim import adamw, schedule
from repro_torch.runtime.steps import build_train_step

from _torch_port import (assert_tree_close, assert_tree_is_the_reference_tree, np_tree,
                         perturbed, t, to_np)
from test_torch_serve import _servers

torch.set_num_threads(1)

ARCH = "internvl2-1b"
TOL = dict(atol=1e-4, rtol=1e-4)
EXTRA = {"flash_block_q": 32, "flash_block_kv": 32, "flash_block_kv_dec": 16,
         "rms_block_rows": 8, "cache_max_len": 32}
B, S, P = 2, 6, 8  # P: the reduced config's num_image_tokens


def _rng(seed):
    return np.random.default_rng(seed)


def _models(head_dim, impl=True, policy="double", seed=5):
    jcfg = jreduced(ARCH).replace(head_dim=head_dim)
    tcfg = reduced_config(ARCH).replace(head_dim=head_dim)
    assert jcfg.num_image_tokens == tcfg.num_image_tokens == P
    jmodel, tmodel = jbuild(jcfg), build_model(tcfg)
    assert isinstance(tmodel, TransformerLM)
    jparams = jinit(jmodel, jax.random.PRNGKey(0), JPolicies.default(policy))
    jparams = perturbed(jparams, seed) if policy == "double" else np_tree(jparams)
    init_params(tmodel, 0, TPolicies.default(policy), "cpu")
    tparams = load_jax_params(tmodel, jparams)
    impls = [("*", "attention", "pallas"), ("*", "norm", "pallas")] if impl else []
    jctx = JCtx(policies=JPolicies.default(policy), extra=dict(EXTRA), impls=impls)
    tctx = Ctx(policies=TPolicies.default(policy), extra=dict(EXTRA),
               impls=[(a, b, "cuda") for a, b, _ in impls])
    fns = {}

    def jrun(params, inputs, *, mode, cache=None):
        if mode not in fns:
            fns[mode] = jax.jit(lambda p, i, c, _m=mode: jmodel(p, i, ctx=jctx, mode=_m, cache=c))
        return fns[mode](params, inputs, cache)

    return jrun, tmodel, jax.tree.map(jnp.asarray, jparams), tparams, tctx


def _inputs(seed, dtype=np.float32):
    rng = _rng(seed)
    return (rng.integers(0, 512, (B, S)).astype(np.int32),
            rng.standard_normal((B, P, 64)).astype(dtype))


@pytest.mark.parametrize("impl", [True, False], ids=["kernels", "plain"])
@pytest.mark.parametrize("head_dim", [16, 64])
def test_image_prefix_logits_caches_and_greedy_decode_match_reference(head_dim, impl):
    """Dense logits over the P + S positions, prefill logits and cache, then
    eight greedy decode steps at positions S + P + i: logits within 1e-4,
    caches after every step, and the greedy tokens equal."""
    jrun, tmodel, jparams, tparams, tctx = _models(head_dim, impl)
    tokens, embeds = _inputs(1)
    jin = {"tokens": jnp.asarray(tokens), "embeds": jnp.asarray(embeds)}
    tin = {"tokens": t(tokens), "embeds": t(embeds)}

    want, _ = jrun(jparams, jin, mode="dense")
    got, none = tmodel(tparams, tin, ctx=tctx, mode="dense")
    assert none is None and got.shape == (B, P + S, 512)
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)

    want, jcache = jrun(jparams, jin, mode="prefill")
    got, tcache = tmodel(tparams, tin, ctx=tctx, mode="prefill")
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)
    assert int(tcache["blocks0"]["index"][0]) == P + S
    assert_tree_close(tcache, np_tree(jcache), **TOL)

    jtoks, ttoks = [], []
    for step in range(8):
        jtok = np.argmax(np.asarray(want, np.float32)[:, -1], -1)[:, None].astype(np.int32)
        ttok = torch.argmax(got[:, -1], dim=-1)[:, None].to(torch.int32)
        jtoks.append(jtok)
        ttoks.append(to_np(ttok))
        pos = np.full((B, 1), S + P + step, np.int32)
        want, jcache = jrun(jparams, {"tokens": jnp.asarray(jtok), "positions": jnp.asarray(pos)},
                            mode="decode", cache=jcache)
        got, tcache = tmodel(tparams, {"tokens": ttok, "positions": t(pos)}, ctx=tctx,
                             mode="decode", cache=tcache)
        np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)
        assert_tree_close(tcache, np_tree(jcache), **TOL)
    np.testing.assert_array_equal(np.concatenate(ttoks, 1), np.concatenate(jtoks, 1))


def test_bf16_embeds_are_cast_and_match_reference():
    """The serving policy: bf16 image embeddings under a bf16 compute dtype,
    prefill and one decode step within 2e-2 of the reference's; fp32 embeds
    are cast to the token embeddings' dtype first."""
    jrun, tmodel, jparams, tparams, tctx = _models(64, policy="half")
    tokens, embeds = _inputs(2)
    for dtype, jdtype in ((torch.bfloat16, jnp.bfloat16), (torch.float32, jnp.float32)):
        want, jcache = jrun(jparams, {"tokens": jnp.asarray(tokens),
                                      "embeds": jnp.asarray(embeds, jdtype)}, mode="prefill")
        got, tcache = tmodel(tparams, {"tokens": t(tokens), "embeds": t(embeds, dtype)},
                             ctx=tctx, mode="prefill")
        assert got.dtype == torch.float32
        np.testing.assert_allclose(to_np(got), np.asarray(want, np.float32), atol=2e-2,
                                   rtol=2e-2)
        tok = np.argmax(np.asarray(want, np.float32)[:, -1], -1)[:, None].astype(np.int32)
        pos = np.full((B, 1), S + P, np.int32)
        want, _ = jrun(jparams, {"tokens": jnp.asarray(tok), "positions": jnp.asarray(pos)},
                       mode="decode", cache=jcache)
        got, _ = tmodel(tparams, {"tokens": t(tok), "positions": t(pos)}, ctx=tctx,
                        mode="decode", cache=tcache)
        np.testing.assert_allclose(to_np(got), np.asarray(want, np.float32), atol=2e-2,
                                   rtol=2e-2)


def test_decode_matches_dense():
    """Prefill 16 tokens after the P image embeddings, decode the 17th at
    position 16 + P: its logits are the dense forward's last row (the
    reference's test and tolerance)."""
    cfg = reduced_config(ARCH)
    model = build_model(cfg)
    params = init_params(model, 0, None, "cpu")
    rng = _rng(3)
    toks = t(rng.integers(0, cfg.vocab, (B, 17)).astype(np.int32))
    embeds = t(rng.standard_normal((B, P, cfg.d_model)).astype(np.float32), torch.bfloat16)
    ctx = Ctx(extra={"cache_max_len": 16 + P + 4})
    _, cache = model(params, {"tokens": toks[:, :16], "embeds": embeds}, ctx=ctx,
                     mode="prefill")
    dec, _ = model(params, {"tokens": toks[:, 16:], "positions": torch.full((B, 1), 16 + P)},
                   ctx=ctx, mode="decode", cache=cache)
    full, _ = model(params, {"tokens": toks, "embeds": embeds}, ctx=ctx, mode="dense")
    assert full.shape == (B, P + 17, cfg.vocab)
    np.testing.assert_allclose(to_np(full[:, -1:]), to_np(dec), atol=0.08, rtol=0.05)


def test_text_only_is_the_dense_path():
    """Without `embeds` a VLM is a dense text model: its logits are those of
    the same weights under the dense family."""
    cfg = reduced_config(ARCH)
    vlm, dense = build_model(cfg), build_model(cfg.replace(family="dense"))
    params = init_params(vlm, 0, None, "cpu")
    tokens = t(_rng(4).integers(0, 512, (B, S)).astype(np.int32))
    a, _ = vlm(params, {"tokens": tokens}, ctx=Ctx(), mode="dense")
    b, _ = dense(params, {"tokens": tokens}, ctx=Ctx(), mode="dense")
    assert torch.equal(a, b)


def test_train_step_with_image_prefix_matches_the_reference():
    """One fp32 `build_train_step` step with the image prefix at head_dim 64
    (the reference's Pallas forward and backward in interpret mode, the
    port's plain K1 / K3): the loss over the last `T_label` positions,
    accuracy and gradient norm."""
    jcfg = jreduced(ARCH).replace(head_dim=64)
    tcfg = reduced_config(ARCH).replace(head_dim=64)
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
    rng = _rng(6)
    batch = {"tokens": rng.integers(0, 512, (2, 12)).astype(np.int32),
             "labels": rng.integers(0, 512, (2, 12)).astype(np.int32),
             "embeds": rng.standard_normal((2, P, 64)).astype(np.float32)}
    jstep = jax.jit(jbuild_train_step(jw, lr_fn=lambda s: jsched.constant(s, peak=1e-3)))
    tstep = build_train_step(tw, lr_fn=lambda s: schedule.constant(s, peak=1e-3))
    _, _, jm = jstep(jparams, jopt, jax.tree.map(jnp.asarray, batch), jnp.asarray(0, jnp.int32))
    _, _, tm = tstep(tparams, topt, {k: t(v) for k, v in batch.items()}, 0)
    for k in ("loss", "accuracy", "grad_norm"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=k)


@pytest.fixture(scope="module")
def vlm64():
    return _servers(ARCH, head_dim=64)


PROMPTS = [np.ones((5,), np.int32), (np.arange(1, 9) % 50).astype(np.int32),
           np.full((3,), 7, np.int32), (np.arange(11) % 13 + 3).astype(np.int32)]
POOL_STATS = ("prefix_hits", "cow_splits", "peak_live_pages", "peak_mapped_pages",
              "grouped_admissions")


@pytest.mark.parametrize("kw", [{}, {"max_batch": 2}], ids=["batch4", "batch2"])
def test_text_only_serve_continuous_matches_reference_server(vlm64, kw):
    """internvl2-1b's text-only requests through `serve_continuous` (the
    dense family's paged path at G = 2 here, G = 7 at full width): tokens
    and pool stats equal the reference server's, and `serve_batch`'s
    inside the port."""
    jsrv, tsrv = vlm64
    want = jsrv.serve_continuous(PROMPTS, page_size=8, **kw)
    got = tsrv.serve_continuous(PROMPTS, page_size=8, **kw)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert {k: tsrv.last_pool_stats[k] for k in POOL_STATS} == \
        {k: jsrv.last_pool_stats[k] for k in POOL_STATS}
    for a, b in zip(tsrv.serve_batch(PROMPTS), got):
        np.testing.assert_array_equal(a, b)


def test_full_config_at_published_size():
    """internvl2-1b's published backbone: 24 layers, d_model 896, 14 q and 2
    KV heads of 64 (G = 7), 256 image tokens; `param_count` and the built
    tree's paths and shapes are the reference's."""
    cfg = get_config(ARCH)
    assert (cfg.num_layers, cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.resolved_head_dim,
            cfg.num_image_tokens) == (24, 896, 14, 2, 64, 256)
    assert cfg.param_count() == jget(ARCH).param_count()
    assert_tree_is_the_reference_tree(ARCH)
