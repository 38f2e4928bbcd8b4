"""PyTorch port, the remaining decoder-only families: the capacity-routed
MoE (mixtral-8x22b with its sliding window, grok-1-314b with its logit
soft-cap), the dense qwen2-72b (QKV bias) and nemotron-4-340b (LayerNorm,
squared-ReLU), and the ring page pool a sliding-window model is served from
once a prompt passes its window.

Twins of the reference's tests on the port: `test_models_smoke.py`'s
forward / decode-vs-dense / published-dimension tests for the four reduced
architectures, with logits against the reference within 1e-4 in fp32
(head_dim 64, so that the reference runs its Pallas kernels in interpret
mode and the port the kernels' plain versions); the paged ring mode of
`test_flash_decode.py` on the plain path; and the ring, MoE and softcap
serving cases of `test_paged_serving.py`, `test_speculative.py` and
`test_quantized_cache.py`, whose served tokens, `last_spec_stats` and pool
stats equal the reference server's on the same reduced configs, weights
and prompts."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_decode as jflash_decode
from repro.models.registry import build_model as jbuild
from repro.models.registry import get_config as jget
from repro.models.registry import reduced_config as jreduced
from repro.nn.attention import Attention as JAttention
from repro.nn.dtypes import PolicyResolver as JPolicies
from repro.nn.module import Ctx as JCtx
from repro.nn.module import init_params as jinit
from repro.runtime import pages as jpages
from repro_torch.configs.base import SHAPES
from repro_torch.convert import load_jax_params
from repro_torch.core.program import Program
from repro_torch.kernels.flash_attention.ops import flash_decode
from repro_torch.launch.weave import default_weave
from repro_torch.models.registry import ARCHS, build_model, get_config, reduced_config
from repro_torch.nn.attention import Attention
from repro_torch.nn.dtypes import PolicyResolver as TPolicies
from repro_torch.nn.module import Ctx, flatten_specs, init_params
from repro_torch.runtime.pages import PagedCacheManager, cdiv
from repro_torch.runtime.server import Server, ServerConfig

from _torch_port import assert_tree_close, np_tree, t, to_np
from test_torch_serve import _servers

torch.set_num_threads(1)

NEW_ARCHS = ["mixtral-8x22b", "grok-1-314b", "qwen2-72b", "nemotron-4-340b"]
EXTRA = {"flash_block_q": 32, "flash_block_kv": 32, "flash_block_kv_dec": 16,
         "rms_block_rows": 8, "cache_max_len": 28}


# ---------------------------------------------------------------------------
# The four architectures: twins of tests/test_models_smoke.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_forward_shapes_finite(arch):
    cfg = reduced_config(arch)
    model = build_model(cfg)
    params = init_params(model, 0, None, "cpu")
    tokens = torch.randint(0, cfg.vocab, (2, 24), generator=torch.Generator().manual_seed(0))
    logits, _ = model(params, {"tokens": tokens}, ctx=Ctx(), mode="dense")
    assert logits.shape == (2, 24, cfg.vocab)
    assert bool(torch.isfinite(logits.float()).all())


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_decode_matches_dense(arch):
    """Prefill 16 tokens, decode the 17th: its logits are the dense forward's
    last row (mixtral's window of 16 rings the cache), as the reference's
    test holds them."""
    cfg = reduced_config(arch)
    model = build_model(cfg)
    params = init_params(model, 0, None, "cpu")
    B, S = 2, 16
    toks = torch.randint(0, cfg.vocab, (B, S + 1), generator=torch.Generator().manual_seed(1))
    ctx = Ctx(extra={"cache_max_len": S + 4, "moe_capacity_factor": 16.0})
    _, cache = model(params, {"tokens": toks[:, :S]}, ctx=ctx, mode="prefill")
    dec, _ = model(params, {"tokens": toks[:, S:], "positions": torch.full((B, 1), S)},
                   ctx=ctx, mode="decode", cache=cache)
    full, _ = model(params, {"tokens": toks}, ctx=ctx, mode="dense")
    np.testing.assert_allclose(to_np(full[:, -1:]), to_np(dec), atol=0.08, rtol=0.05)


def test_exact_configs_match_assignment():
    """The port's ten registered configs carry the published dimensions,
    field for field the reference's."""
    expect = {
        "yi-6b": (32, 4096, 32, 4, 11008, 64000),
        "gemma-2b": (18, 2048, 8, 1, 16384, 256000),
        "qwen2-72b": (80, 8192, 64, 8, 29568, 152064),
        "nemotron-4-340b": (96, 18432, 96, 8, 73728, 256000),
        "whisper-small": (12, 768, 12, 12, 3072, 51865),
        "internvl2-1b": (24, 896, 14, 2, 4864, 151655),
        "mixtral-8x22b": (56, 6144, 48, 8, 16384, 32768),
        "grok-1-314b": (64, 6144, 48, 8, 32768, 131072),
        "recurrentgemma-2b": (26, 2560, 10, 1, 7680, 256000),
        "rwkv6-3b": (32, 2560, 40, 40, 8960, 65536),
    }
    assert set(ARCHS) == set(expect)
    for arch, (L, d, H, K, ff, V) in expect.items():
        cfg = get_config(arch)
        assert (cfg.num_layers, cfg.d_model, cfg.n_heads, cfg.kv_heads,
                cfg.d_ff, cfg.vocab) == (L, d, H, K, ff, V), arch
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jget(arch)), arch
        assert dataclasses.asdict(reduced_config(arch)) == \
            dataclasses.asdict(jreduced(arch)), arch


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_param_tree_paths_and_shapes_match_reference(arch):
    """At the published size (shapes only, nothing allocated): every leaf
    path and shape of the port's tree is the reference's — the stacked
    experts `(L, E, d_model, d_ff)` under the layer stack included."""
    jmodel = jbuild(jget(arch))
    shapes = jax.eval_shape(lambda: jinit(jmodel, jax.random.PRNGKey(0)))
    want = {"/".join(str(k.key) for k in path): tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    tmodel = build_model(get_config(arch))
    prefix = tmodel.name + "/"
    got = {p[len(prefix):]: tuple(s.shape) for p, s in flatten_specs(tmodel).items()}
    assert got == want
    cfg = get_config(arch)
    if cfg.family == "moe":
        L = cfg.groups()[0]
        assert got["blocks0/block/ffn/wi"] == (L, cfg.num_experts, cfg.d_model, cfg.d_ff)
        assert got["blocks0/block/ffn/wo"] == (L, cfg.num_experts, cfg.d_ff, cfg.d_model)
        assert got["blocks0/block/ffn/router"] == (L, cfg.d_model, cfg.num_experts)


def _models(arch):
    jcfg = jreduced(arch).replace(head_dim=64)
    tcfg = reduced_config(arch).replace(head_dim=64)
    jmodel, tmodel = jbuild(jcfg), build_model(tcfg)
    jparams = jinit(jmodel, jax.random.PRNGKey(0), JPolicies.default("double"))
    init_params(tmodel, 0, TPolicies.default("double"), "cpu")
    tparams = load_jax_params(tmodel, np_tree(jparams))
    jctx = JCtx(policies=JPolicies.default("double"), extra=EXTRA,
                impls=[("*", "attention", "pallas"), ("*", "norm", "pallas")])
    tctx = Ctx(policies=TPolicies.default("double"), extra=EXTRA,
               impls=[("*", "attention", "cuda"), ("*", "norm", "cuda")])
    return jmodel, tmodel, jparams, tparams, jctx, tctx


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_logits_and_caches_match_reference(arch):
    """fp32, head_dim 64: dense, prefill (24 tokens: past mixtral's reduced
    window of 16, a ring cache) and three decode steps within 1e-4; the
    caches agree after each call."""
    jmodel, tmodel, jparams, tparams, jctx, tctx = _models(arch)
    tol = dict(atol=1e-4, rtol=1e-4)
    tokens = np.random.default_rng(0).integers(0, 512, (2, 24)).astype(np.int32)

    want, _ = jmodel(jparams, {"tokens": jnp.asarray(tokens)}, ctx=jctx, mode="dense")
    got, _ = tmodel(tparams, {"tokens": t(tokens)}, ctx=tctx, mode="dense")
    np.testing.assert_allclose(to_np(got), np.asarray(want), **tol)
    want, jcache = jmodel(jparams, {"tokens": jnp.asarray(tokens)}, ctx=jctx, mode="prefill")
    got, tcache = tmodel(tparams, {"tokens": t(tokens)}, ctx=tctx, mode="prefill")
    np.testing.assert_allclose(to_np(got), np.asarray(want), **tol)
    assert_tree_close(tcache, np_tree(jcache), **tol)
    assert ("pos" in tcache["blocks0"]) == (arch == "mixtral-8x22b")
    for step in range(3):
        tok = np.argmax(np.asarray(want)[:, -1], -1)[:, None].astype(np.int32)
        pos = np.full((2, 1), 24 + step, np.int32)
        want, jcache = jmodel(jparams, {"tokens": jnp.asarray(tok), "positions": jnp.asarray(pos)},
                              ctx=jctx, mode="decode", cache=jcache)
        got, tcache = tmodel(tparams, {"tokens": t(tok), "positions": t(pos)},
                             ctx=tctx, mode="decode", cache=tcache)
        np.testing.assert_allclose(to_np(got), np.asarray(want), **tol)
        assert_tree_close(tcache, np_tree(jcache), **tol)


def test_stacked_experts_carry_across_layer_by_layer():
    """Each layer's slice of the stacked expert leaves, run through that
    layer's MoE feed-forward in both packages at a capacity factor that
    drops tokens, gives the same output and the same `moe_drop_frac` tap
    (taps are off inside a layer stack, as in the reference)."""
    jmodel, tmodel, jparams, tparams, _, _ = _models("grok-1-314b")
    x = np.random.default_rng(3).standard_normal((1, 24, 64)).astype(np.float32)
    extra = {"moe_capacity_factor": 0.5}
    jffn, tffn = jmodel.trunk[0].block.ffn, tmodel.trunk[0].template.ffn
    for layer in range(2):
        jp = jax.tree.map(lambda a: a[layer], jparams["blocks0"]["block"]["ffn"])
        tp = {k: v[layer] for k, v in tparams["blocks0"]["block"]["ffn"].items()}
        jctx = JCtx(policies=JPolicies.default("double"), extra=extra, taps_enabled=["*"])
        tctx = Ctx(policies=TPolicies.default("double"), extra=extra, taps_enabled=["*"])
        want = jffn(jp, jnp.asarray(x), ctx=jctx)
        got = tffn(tp, t(x), ctx=tctx)
        np.testing.assert_allclose(to_np(got), np.asarray(want), atol=1e-5, rtol=1e-5)
        assert float(tctx.taps["ffn/moe_drop_frac"]) == \
            float(jctx.taps["ffn/moe_drop_frac"]) > 0


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "grok-1-314b"])
def test_moe_trains_on_the_cpu_and_refuses_the_card(arch, capsys, monkeypatch):
    """A MoE model trains on the host through autograd over the one-hot
    products (the reference's `test_train_step_no_nans` case); asked for
    the card, the launcher no longer refuses the family: with the device
    check stood in for, it builds the trainer with the attention kernels
    woven."""
    from repro_torch.core import program as program_mod
    from repro_torch.launch import train as launch_train

    assert launch_train.main(["--device", "cpu", "--reduced", "--arch", arch, "--steps", "2",
                              "--batch", "2", "--seq", "16"]) == 0
    assert "over 2 steps on cpu" in capsys.readouterr().out
    monkeypatch.setattr(program_mod, "resolve_device", lambda device: torch.device("cpu"))
    trainer = launch_train.build_trainer(arch, reduced=True, device="cuda", batch=2, seq=8)
    assert trainer.woven.program.cfg.family == "moe"


# ---------------------------------------------------------------------------
# The paged ring mode: twins of tests/test_flash_decode.py
# ---------------------------------------------------------------------------


def _pool_from_dense(k, v, ps, seed=3):
    """A dense (B, T, K, D) cache scattered into a page pool with a
    shuffled page assignment (numpy): (pk, pv, tables)."""
    B, T = k.shape[0], k.shape[1]
    nb = cdiv(T, ps)
    widths = ((0, 0), (0, nb * ps - T), (0, 0), (0, 0))
    kp = np.pad(k, widths).reshape(B * nb, ps, *k.shape[2:])
    vp = np.pad(v, widths).reshape(B * nb, ps, *k.shape[2:])
    perm = np.random.default_rng(seed).permutation(B * nb).astype(np.int32)
    pk, pv = np.zeros_like(kp), np.zeros_like(vp)
    pk[perm], pv[perm] = kp, vp
    return pk, pv, perm.reshape(B, nb)


def test_paged_ring_wrapped():
    """Ring-layout pool (logical length W, a wrapped stream): the paged
    plain version equals the dense ring mode bit for bit, and the
    reference's Pallas kernel (interpret mode) within 1e-5."""
    B, H, K, D, W = 3, 4, 2, 64, 48
    rng = np.random.default_rng(0)
    q = rng.standard_normal((B, 1, H, D)).astype(np.float32)
    k = rng.standard_normal((B, W, K, D)).astype(np.float32)
    v = rng.standard_normal((B, W, K, D)).astype(np.float32)
    idx = np.asarray([7, 47, 1000], np.int32)  # a deep wrap among them
    dense = flash_decode(t(q), t(k), t(v), t(idx), block_kv=16)
    pk, pv, tables = _pool_from_dense(k, v, 16)
    paged = flash_decode(t(q), t(pk), t(pv), t(idx), block_kv=16, tables=t(tables), kv_len=W)
    assert torch.equal(dense, paged)
    want = jflash_decode(jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv), jnp.asarray(idx),
                         block_kv=16, tables=jnp.asarray(tables), kv_len=W, interpret=True)
    np.testing.assert_allclose(to_np(paged), np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("impl", ["eager", "cuda"])
def test_ring_paged_matches_stacked(impl):
    """`Attention` decode over a ring pool equals the stacked ring cache bit
    for bit (outputs and the `pos` rows), at mixed wrap levels per request,
    on the plain attention (`eager`) and the kernel's plain version
    (`cuda`, CPU tensors); and equals the reference module within 1e-5."""
    B, W, ps = 3, 12, 4
    pol = JPolicies.default("double")
    jattn = JAttention("attn", 64, 4, 2, 64, mask="sliding", window=W)
    attn = Attention("attn", 64, 4, 2, 64, mask="sliding", window=W)
    jparams = jinit(jattn, jax.random.PRNGKey(2), pol)
    init_params(attn, 0, TPolicies.default("double"), "cpu")
    params = load_jax_params(attn, np_tree(jparams))
    indices = [5, 12, 42]
    posm = np.full((B, W), -1, np.int32)
    for b, idx in enumerate(indices):  # pos[s] = the last p < idx with p % W == s
        for s in range(W):
            p = ((idx - 1 - s) // W) * W + s
            if 0 <= p < idx:
                posm[b, s] = p
    rng = np.random.default_rng(4)
    k = rng.standard_normal((B, W, 2, 64)).astype(np.float32)
    v = rng.standard_normal((B, W, 2, 64)).astype(np.float32)
    x = rng.standard_normal((B, 1, 64)).astype(np.float32)
    idx = np.asarray(indices, np.int32)
    ctx = Ctx(policies=TPolicies.default("double"), impls=[("*", "attention", impl)],
              extra={"flash_block_kv_dec": ps})
    cache = {"k": t(k), "v": t(v), "pos": t(posm), "index": t(idx)}
    y_d, c_d = attn(params, t(x), ctx=ctx, positions=t(idx[:, None]), mode="decode",
                    cache=cache)
    pk, pv, tables = _pool_from_dense(k, v, ps)
    pcache = {"pk": t(pk), "pv": t(pv), "pos": t(posm), "index": t(idx)}
    y_p, c_p = attn(params, t(x), ctx=ctx, positions=t(idx[:, None]), mode="decode",
                    cache=pcache, block_tables=t(tables))
    assert torch.equal(y_d, y_p)
    assert torch.equal(c_d["pos"], c_p["pos"]) and torch.equal(c_d["index"], c_p["index"])
    # the write landed on the ring slot of each request, through the table
    k_log = c_p["pk"][t(tables).long()].reshape(B, -1, 2, 64)[:, :W]
    assert torch.equal(k_log, c_d["k"])
    jctx = JCtx(policies=pol, impls=[("*", "attention", "xla")])
    jcache = {"pk": jnp.asarray(pk), "pv": jnp.asarray(pv), "pos": jnp.asarray(posm),
              "index": jnp.asarray(idx)}
    want, jc = jattn(jparams, jnp.asarray(x), ctx=jctx, positions=jnp.asarray(idx[:, None]),
                     mode="decode", cache=jcache, block_tables=jnp.asarray(tables))
    np.testing.assert_allclose(to_np(y_p), np.asarray(want), atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(to_np(c_p["pos"]), np.asarray(jc["pos"]))


def test_ring_pool_refuses_widened_q_and_rescore():
    attn = Attention("attn", 64, 4, 2, 64, mask="sliding", window=8)
    params = init_params(attn, 0, TPolicies.default("double"), "cpu")
    pcache = {"pk": torch.zeros(4, 4, 2, 64), "pv": torch.zeros(4, 4, 2, 64),
              "pos": torch.full((1, 8), -1, dtype=torch.int32),
              "index": torch.tensor([9], dtype=torch.int32)}
    tables = torch.tensor([[0, 1]], dtype=torch.int32)
    ctx = Ctx(policies=TPolicies.default("double"))
    with pytest.raises(ValueError, match="one token at a time"):
        attn(params, torch.zeros(1, 2, 64), ctx=ctx, positions=torch.tensor([[9, 10]]),
             mode="decode", cache=dict(pcache), block_tables=tables)
    with pytest.raises(ValueError, match="never share"):
        attn(params, torch.zeros(1, 1, 64), ctx=ctx, positions=torch.tensor([[9]]),
             mode="decode", cache=dict(pcache), block_tables=tables,
             skip_cache_write=True)


# ---------------------------------------------------------------------------
# The ring pool's bookkeeping: runtime/pages.py against the reference
# ---------------------------------------------------------------------------

_L, _PS, _W, _K, _D = 2, 4, 12, 2, 8


def _ring_cache(rng, S):
    """A per-request ring prefill cache of a two-layer stack (numpy): the
    last W positions of an S-token prompt at slot = position % W."""
    k = np.zeros((_L, 1, _W, _K, _D), np.float32)
    v = np.zeros((_L, 1, _W, _K, _D), np.float32)
    pos = np.full((_L, _W), -1, np.int32)
    for p in range(max(0, S - _W), S):
        k[:, 0, p % _W] = rng.standard_normal((_L, _K, _D))
        v[:, 0, p % _W] = rng.standard_normal((_L, _K, _D))
        pos[:, p % _W] = p
    return {"blocks0": {"k": k, "v": v, "pos": pos, "index": np.full((_L,), S, np.int32)}}


def test_ring_manager_matches_reference_under_one_op_sequence():
    """Ring groups through both managers — admission (clamped to the
    window), batches, absorbed decode steps that wrap the ring, retirement:
    the same tables, free lists, stats, pool bytes and `pos` rows after
    every operation; a ring pool never shares."""
    jm = jpages.PagedCacheManager(16, _PS, max_len=40, window=_W)
    tm = PagedCacheManager(16, _PS, max_len=40, window=_W)
    assert tm._slots_needed(30, prompt_len=20) == jm._slots_needed(30, prompt_len=20) \
        == cdiv(_W, _PS)
    assert tm._slots_needed(30, prompt_len=8) == jm._slots_needed(30, prompt_len=8)
    rng = np.random.default_rng(5)
    seq = [("admit", "a", 20), ("admit", "b", 15), ("step", ["a", "b"]), ("step", ["a", "b"]),
           ("retire", "a"), ("admit", "c", 30), ("step", ["b", "c"]), ("step", ["c"]),
           ("retire", "b"), ("retire", "c")]
    toks = np.arange(1, 21)
    for op in seq:
        if op[0] == "admit":
            c = _ring_cache(rng, op[2])
            jm.admit(op[1], jax.tree.map(jnp.asarray, c), final_len=op[2] + 8)
            tm.admit(op[1], jax.tree.map(t, c), final_len=op[2] + 8)
            assert tm.match_prefix(toks) == jm.match_prefix(toks)
        elif op[0] == "step":
            jc, tc = jm.batch(op[1]), tm.batch(op[1])
            np.testing.assert_array_equal(to_np(tc["block_tables"]),
                                          np.asarray(jc["block_tables"]))
            for key in ("pos", "index"):
                np.testing.assert_array_equal(to_np(tc["blocks0"][key]),
                                              np.asarray(jc["blocks0"][key]))
            # a decode step's bookkeeping: slot index % W now holds index
            idx = np.asarray(jc["blocks0"]["index"])
            pos = np.array(jc["blocks0"]["pos"])
            for b in range(idx.shape[-1]):
                pos[:, b, idx[0, b] % _W] = idx[0, b]
            jc["blocks0"]["pos"], jc["blocks0"]["index"] = jnp.asarray(pos), jnp.asarray(idx + 1)
            tc["blocks0"]["pos"].copy_(t(pos))
            tc["blocks0"]["index"] = t(idx + 1)
            jm.absorb(op[1], jc)
            tm.absorb(op[1], tc)
        else:
            getattr(jm, op[0])(op[1])
            getattr(tm, op[0])(op[1])
        assert dict(tm.pool.tables) == dict(jm.pool.tables)
        assert list(tm.pool._free) == list(jm.pool._free)
        assert tm.stats() == jm.stats()
        assert {r: m["length"] for r, m in tm._meta.items()} == \
            {r: m["length"] for r, m in jm._meta.items()}
        for key, val in jm._pools["blocks0"].items():
            np.testing.assert_array_equal(to_np(tm._pools["blocks0"][key]), np.asarray(val))
    assert tm.prefix_hits == jm.prefix_hits == 0


def test_ring_groups_stay_fp():
    mgr = PagedCacheManager(8, _PS, max_len=40, window=16, cache_dtype="int8")
    assert mgr._quant_dtype({"ring": True}) is None
    assert mgr._quant_dtype({"ring": False}) == torch.int8


def test_rejects_mixed_cache_families():
    """Prompts on both sides of the window would mix ring and linear
    layouts in one pool: the manager refuses, as the reference's does."""
    cfg = reduced_config("mixtral-8x22b")  # window 16
    model = build_model(cfg)
    params = init_params(model, 0, TPolicies.default("double"), "cpu")
    ctx = Ctx(policies=TPolicies.default("double"), extra={"cache_max_len": 24})
    caches = [model(params, {"tokens": torch.ones((1, S), dtype=torch.int32)}, ctx=ctx,
                    mode="prefill")[1] for S in (3, 20)]
    manager = PagedCacheManager(num_pages=16, page_size=8)
    manager.admit(0, caches[0], final_len=8)
    with pytest.raises(ValueError, match="family mismatch"):
        manager.admit(1, caches[1], final_len=23)


# ---------------------------------------------------------------------------
# Serving: twins of tests/test_paged_serving.py and tests/test_speculative.py
# ---------------------------------------------------------------------------

PROMPTS = [np.ones((5,), np.int32), (np.arange(1, 9) % 50).astype(np.int32),
           np.full((3,), 7, np.int32)]
RING_PROMPTS = [(np.arange(20) % 50 + 1).astype(np.int32),
                (np.arange(18) % 31 + 2).astype(np.int32)]
BASE16 = np.arange(1, 17, dtype=np.int32)
SHARED_PROMPTS = [np.concatenate([BASE16, np.array([21, 22, 23], np.int32)]),
                  np.concatenate([BASE16, np.array([31, 32], np.int32)]),
                  np.full((3,), 7, np.int32)]
POOL_STATS = ("prefix_hits", "cow_splits", "peak_live_pages", "peak_mapped_pages",
              "grouped_admissions")


@pytest.fixture(scope="module")
def pairs():
    """Reference and port servers over the same weights (fp32), built once."""
    return {"mixtral-8x22b": _servers("mixtral-8x22b"),
            "grok-1-314b": _servers("grok-1-314b"),
            "windowed": _servers("yi-6b", attn_window=16),
            "softcap-gqa": _servers("yi-6b", attn_softcap=30.0)}


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def _both(pair, prompts, **kw):
    """The same `serve_continuous` through both servers: tokens, pool stats
    and speculative stats agree; returns the port's tokens."""
    jsrv, tsrv = pair
    want = jsrv.serve_continuous(prompts, page_size=8, **kw)
    got = tsrv.serve_continuous(prompts, page_size=8, **kw)
    _same(got, want)
    assert {k: tsrv.last_pool_stats[k] for k in POOL_STATS} == \
        {k: jsrv.last_pool_stats[k] for k in POOL_STATS}
    if jsrv.last_spec_stats is None:
        assert tsrv.last_spec_stats is None
    else:
        for key in ("verify_steps", "decode_steps", "draft_steps", "proposed", "accepted"):
            assert tsrv.last_spec_stats[key] == jsrv.last_spec_stats[key], key
    return got


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "grok-1-314b"])
def test_continuous_equals_batch_solo_and_reference(pairs, arch):
    """serve_continuous == serve_batch == solo serve inside the port, and
    the reference's tokens and pool stats (linear pools: the prompts fit
    the window)."""
    jsrv, tsrv = pairs[arch]
    cont = _both(pairs[arch], PROMPTS)
    _same(tsrv.serve_batch(PROMPTS), cont)
    for p, c in zip(PROMPTS, cont):
        np.testing.assert_array_equal(tsrv.serve(p[None])[0], c)


def test_ring_family_paged_prefill_parity(pairs):
    """Prompts past mixtral's window ring the pool: prefix sharing stays
    off, and the direct-to-pool ring prefill serves the batch path's and
    the reference's tokens."""
    _, tsrv = pairs["mixtral-8x22b"]
    cont = _both(pairs["mixtral-8x22b"], RING_PROMPTS)
    _same(tsrv.serve_batch(RING_PROMPTS), cont)
    assert tsrv.last_pool_stats is not None
    tsrv.serve_continuous(RING_PROMPTS, page_size=8)
    stats = tsrv.last_pool_stats
    assert stats["prefix_hits"] == 0
    # a ring group holds at most ceil(W / page) pages a request
    assert stats["peak_live_pages"] <= len(RING_PROMPTS) * cdiv(16, 8)


def test_moe_family_keeps_sharing_off_and_matches(pairs):
    """grok (MoE + softcap + GQA): no prefix page is shared or split, and the
    tokens are the batch path's and the reference's."""
    _, tsrv = pairs["grok-1-314b"]
    cont = _both(pairs["grok-1-314b"], SHARED_PROMPTS)
    _same(tsrv.serve_batch(SHARED_PROMPTS), cont)
    assert tsrv.last_pool_stats["prefix_hits"] == 0
    assert tsrv.last_pool_stats["cow_splits"] == 0


def test_moe_capacity_routing_gates_speculation_off(pairs):
    _, tsrv = pairs["mixtral-8x22b"]
    plain = tsrv.serve_continuous(PROMPTS, page_size=8)
    spec = _both(pairs["mixtral-8x22b"], PROMPTS, draft_len=2)
    _same(plain, spec)
    assert tsrv.last_spec_stats is None
    assert tsrv.last_step_counts["verify"] == tsrv.last_step_counts["draft"] == 0


def test_moe_gates_chunked_prefill_off():
    """A chunked prefill would route a prompt's tokens in other groups:
    under MoE the chunk is ignored (no `prefill_chunk` event, one-shot
    tokens), whether asked for by argument or by the QoS governor."""
    program = Program.from_arch("mixtral-8x22b", kind="serve", reduced=True, device="cpu")
    srv = Server(default_weave(program, SHAPES["prefill_32k"], {}),
                 ServerConfig(max_cache_len=24, decode_tokens=4))
    base = srv.serve_continuous(PROMPTS, page_size=4)
    events = []
    chunked = srv.serve_continuous(PROMPTS, page_size=4, prefill_chunk=2,
                                   on_event=events.append)
    _same(base, chunked)
    assert not [e for e in events if e["event"] == "prefill_chunk"]
    assert srv.last_step_counts["suffix_prefill"] == 0
    gen = srv.serve_stream(PROMPTS, page_size=4, qos={"prefill_chunk": (2,),
                                                      "draft_len": (2,)})
    while True:
        try:
            ev = next(gen)
        except StopIteration as stop:
            governed = stop.value
            break
        assert ev["event"] != "prefill_chunk"
    _same(base, governed)
    assert srv.last_spec_stats is None


def test_softcap_gqa_shared_prefix_bit_identical(pairs):
    """Dense GQA with grok's soft-cap: shared == unshared == batch, and the
    reference's tokens and pool stats."""
    _, tsrv = pairs["softcap-gqa"]
    shared = _both(pairs["softcap-gqa"], SHARED_PROMPTS)
    assert tsrv.last_pool_stats["prefix_hits"] >= 2
    assert tsrv.last_pool_stats["peak_live_pages"] < tsrv.last_pool_stats["peak_mapped_pages"]
    unshared = _both(pairs["softcap-gqa"], SHARED_PROMPTS, prefix_sharing=False)
    assert tsrv.last_pool_stats["prefix_hits"] == 0
    _same(shared, unshared)
    _same(tsrv.serve_batch(SHARED_PROMPTS), shared)


def test_ring_pool_gates_speculation_off(pairs):
    """Prompts past the window ring the pool: the server falls back to plain
    decode rounds (no verify step, decode steps counted), with the
    reference's tokens and stats."""
    _, tsrv = pairs["windowed"]
    plain = tsrv.serve_continuous(RING_PROMPTS, page_size=8)
    spec = _both(pairs["windowed"], RING_PROMPTS, draft_len=2)
    _same(plain, spec)
    stats = tsrv.last_spec_stats
    assert stats["verify_steps"] == 0 and stats["decode_steps"] > 0
